"""The port's ExtendEngine against the JAX ExtendEngine on the CPU.

The port runs on ``device="cpu"`` (the kernel's plain version on the
engine's own route: buckets, one staged upload, left launches, right
launches with h0 gathered from the left scores, one fetch, concurrent
native host fallback past the caps); the JAX engine runs its XLA route.
Records are exact, against the JAX engine, ``extend_seed_oracle`` and the
BWA-SW golden record file, and the ``stats`` counters equal.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from acc_genomics_tpu.config import ExtendConfig as JaxExtendConfig
from acc_genomics_tpu.engine.extend_engine import ExtendEngine as JaxEngine
from acc_genomics_tpu.io import bwasw_records as br
from acc_genomics_tpu.ops.extend.reference import extend_seed_oracle
from acc_genomics_tpu_torch.config import ExtendConfig
from acc_genomics_tpu_torch.engine import extend_engine as engine_module
from acc_genomics_tpu_torch.engine.extend_engine import ExtendEngine
from acc_genomics_tpu_torch.ops.extend import kernel as K

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _seeds(rng, n_reads=6, read_len=101, flank=60, err=0.05):
    """Seeds of reads sampled from a random genome with point errors, each
    with its reference span (the BwaMemSeeding layout)."""
    genome = rng.integers(0, 4, 4000).astype(np.uint8)
    seeds = []
    for _ in range(n_reads):
        pos = int(rng.integers(200, len(genome) - 400))
        read = genome[pos: pos + read_len].copy()
        mut = rng.random(read_len) < err
        read[mut] = (read[mut] + 1) % 4
        lo, hi = pos - flank, pos + read_len + flank
        for _ in range(3):
            qb = int(rng.integers(0, read_len - 20))
            ln = int(rng.integers(15, min(25, read_len - qb) + 1))
            read[qb: qb + ln] = genome[pos + qb: pos + qb + ln]
            seeds.append(dict(read=read, rseq=genome[lo:hi], qbeg=qb,
                              rbeg_off=qb + flank, len=ln))
    return seeds


def _degenerate(rng):
    """test_extend.py:92's edge seeds: no left side, no right side,
    whole-read seed."""
    genome = rng.integers(0, 4, 1000).astype(np.uint8)
    pos, lo = 300, 260
    read = genome[pos: pos + 60].copy()
    rseq = genome[lo: pos + 100]
    return [dict(read=read, rseq=rseq, qbeg=0, rbeg_off=pos - lo, len=20),
            dict(read=read, rseq=rseq, qbeg=40, rbeg_off=pos + 40 - lo, len=20),
            dict(read=read, rseq=rseq, qbeg=0, rbeg_off=pos - lo, len=60)]


def _oracle(s):
    return extend_seed_oracle(s["read"], s["rseq"], s["qbeg"], s["rbeg_off"], s["len"])


CASES = {
    "seeds": (lambda rng: _seeds(rng), ExtendConfig()),
    "degenerate": (_degenerate, ExtendConfig()),
    # small caps: the longer spans run on the native host engine
    "host_fallback": (lambda rng: _seeds(rng, flank=30), ExtendConfig(max_qlen=64, max_tlen=96)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_extend_seeds_matches_jax_engine_and_oracle(case, rng):
    make, cfg = CASES[case]
    seeds = make(rng)
    port = ExtendEngine(cfg, device="cpu")
    jax_eng = JaxEngine(JaxExtendConfig(**dataclasses.asdict(cfg)))
    got = port.extend_seeds(seeds)
    assert got == jax_eng.extend_seeds(seeds)
    assert port.stats == jax_eng.stats
    for s, g in zip(seeds, got):
        assert g == _oracle(s)
    if case == "host_fallback":
        assert 0 < port.stats["host_fallback"] < len(seeds)


def test_bwasw_records_fixture():
    """The reference driver's protocol (main_cl.cpp:191-247): the binary
    task dump through run_tasks, exact against the golden result records."""
    genome = np.load(os.path.join(FIX, "bwasw_genome.npy"))
    tasks = br.read_task_file(os.path.join(FIX, "bwasw_tasks0.bin"))
    want = br.read_results(os.path.join(FIX, "bwasw_results0.bin"))
    got = br.run_tasks(ExtendEngine(device="cpu"), genome, tasks)
    assert len(got) == len(want)
    by_idx = {r["seed_index"]: r for r in got}
    for w in want:
        assert by_idx[w["seed_index"]] == w


def test_left_launches_before_right_and_one_fetch(monkeypatch, rng):
    """Every left group launches before any right group, each right h0 is
    the left score of its seed, and nothing is fetched in between."""
    seeds = _seeds(rng)
    calls = []
    real = engine_module.sw_extend_rows

    def spy(q, t, qlen, tlen, h0, *a):
        out = real(q, t, qlen, tlen, h0, *a)
        calls.append((h0.clone(), out))
        return out

    monkeypatch.setattr(engine_module, "sw_extend_rows", spy)
    eng = ExtendEngine(device="cpu")
    lres, rres = eng.extend_both(*_tasks(seeds))
    n_left = len(set(zip(*eng._buckets(*_tasks(seeds)[:2]))))
    assert len(calls) == eng.stats["device_calls"] > n_left
    left_h0 = torch.cat([h0 for h0, _ in calls[:n_left]])
    assert sorted(left_h0.tolist()) == sorted(s["len"] for s in seeds)
    right_h0 = sorted(torch.cat([h0 for h0, _ in calls[n_left:]]).tolist())
    assert right_h0 == sorted(lres["score"].tolist())
    assert eng.anatomy["h2d_bytes"] > 0 and eng.anatomy["d2h_bytes"] == 4 * 7 * 2 * len(seeds)


def _tasks(seeds):
    lq, lt, rq, rt = engine_module.seed_tasks(seeds)
    return lq, lt, [s["len"] for s in seeds], rq, rt


def test_empty_and_bucket_ladders():
    eng = ExtendEngine(device="cpu")
    assert eng.extend_seeds([]) == []
    assert eng.q_buckets == (32, 64, 128, 256)
    assert eng.t_buckets == (64, 128, 256, 512, 1024)
    bq, bt = eng._buckets([np.zeros(0), np.zeros(257), np.zeros(40)],
                          [np.zeros(300), np.zeros(3), np.zeros(1025)])
    assert bq.tolist() == [32, -1, -1] and bt.tolist() == [512, -1, -1]


def test_engine_raises_without_native_or_card(monkeypatch):
    monkeypatch.setattr(engine_module, "ensure_native", lambda: False)
    with pytest.raises(RuntimeError, match="native"):
        ExtendEngine(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ExtendEngine(device="cuda")


def test_cpu_engine_never_launches(rng):
    before = dict(K.LAUNCHES)
    ExtendEngine(device="cpu").extend_seeds(_degenerate(rng))
    assert dict(K.LAUNCHES) == before
