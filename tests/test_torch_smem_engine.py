"""The port's SmemEngine against the JAX SmemEngine on the CPU.

The port runs on ``device="cpu"`` (the kernel's plain version on the
engine's own route: length buckets, batches cut at ``batch_size``, every
batch launched before one counts fetch and one live-interval fetch, one
retry of long and flagged reads at wide caps).  Its interval
lists equal the oracle's in order, and the JAX engine's (whose multi-read
route the small ``batch_size`` cases take) as sets.
"""

import dataclasses

import numpy as np
import pytest
import torch

from acc_genomics_tpu.config import SmemConfig as JaxSmemConfig
from acc_genomics_tpu.engine.smem_engine import SmemEngine as JaxEngine
from acc_genomics_tpu.io.synth import gen_reference_with_repeats, gen_smem_reads
from acc_genomics_tpu.ops.smem.index import FMIndex as JaxFMIndex
from acc_genomics_tpu.ops.smem.reference import mem_collect_intv_oracle
from acc_genomics_tpu_torch.config import SmemConfig
from acc_genomics_tpu_torch.engine import smem_engine as engine_module
from acc_genomics_tpu_torch.engine.smem_engine import SmemEngine
from acc_genomics_tpu_torch.ops.smem import kernel as K
from acc_genomics_tpu_torch.ops.smem.index import FMIndex


def _canon(z):
    return sorted((i["x0"], i["x1"], i["s"], i["start"], i["end"]) for i in z)


def _multiread(rng):
    """test_smem_machine.py's multi-read case: Ns, a short read, the text's
    two ends, an all-N read; batches of 8."""
    genome = gen_reference_with_repeats(rng, 4000)
    reads = gen_smem_reads(rng, genome, 37, read_len=80)
    reads[0][33] = 4
    reads[5] = reads[5][:25].copy()
    reads[9] = genome[:80].copy()
    reads[10] = genome[-80:].copy()
    reads.append(np.full(30, 4, np.uint8))
    return genome, reads, SmemConfig(batch_size=8, read_buckets=(96,), seq_length=96)


def _buckets_and_long(rng):
    """Reads in two buckets and two past seq_length (host)."""
    genome = gen_reference_with_repeats(rng, 3000)
    reads = [gen_smem_reads(rng, genome, 1, read_len=n)[0]
             for n in (30, 60, 64, 65, 90, 100, 120, 150)]
    return genome, reads, SmemConfig(read_buckets=(64, 128), seq_length=128)


def _busts(rng):
    """Tandem-repeat genome with tight caps: many reads flag and rerun."""
    motif = rng.integers(0, 4, 8).astype(np.uint8)
    genome = np.tile(motif, 1500)
    mut = rng.random(len(genome)) < 0.02
    genome[mut] = (genome[mut] + rng.integers(1, 4, mut.sum())) % 4
    reads = gen_smem_reads(rng, genome, 18, read_len=90, error_rate=0.01)
    return genome, reads, SmemConfig(batch_size=4, read_buckets=(96,), seq_length=96,
                                     curr_cap=4, mem_cap=8)


CASES = {"multiread": _multiread, "buckets_and_long": _buckets_and_long, "busts": _busts}


@pytest.mark.parametrize("case", sorted(CASES))
def test_collect_matches_jax_engine_and_oracle(case, rng):
    genome, reads, cfg = CASES[case](rng)
    port = SmemEngine(FMIndex.build(genome), cfg, device="cpu")
    got = port.collect(reads)
    jax_fm, jax_cfg = JaxFMIndex.build(genome), JaxSmemConfig(**dataclasses.asdict(cfg))
    want_jax = JaxEngine(jax_fm, jax_cfg).collect(reads)
    for k, r in enumerate(reads):
        assert got[k] == mem_collect_intv_oracle(jax_fm, r, jax_cfg.params()), k
        assert _canon(got[k]) == _canon(want_jax[k]), k
    assert port.stats["reads"] == len(reads)
    if case == "busts":
        assert port.stats["overflow_reruns"] > 0
    if case != "buckets_and_long":
        assert port.stats["probe_iters"] > 0


def test_collect_arrays_no_intervals(rng):
    """All-N and empty reads: zero counts, no gather, both through one
    batch and through several."""
    fm = FMIndex.build(gen_reference_with_repeats(rng, 2000))
    n = 10
    seq = np.full((96, n), 4, np.uint8)
    lens = np.full(n, 60, np.int32)
    lens[-2:] = 0
    for cfg in (SmemConfig(batch_size=64, seq_length=96), SmemConfig(batch_size=4, seq_length=96)):
        eng = SmemEngine(fm, cfg, device="cpu")
        flat, nn, ovf = eng.collect_arrays(seq, lens)
        assert nn.shape == (n,) and not nn.any() and not ovf.any()
        assert flat.shape == (0, 5)
        assert eng.anatomy["d2h_bytes"] == 3 * 4 * n  # the counts only


def test_collect_arrays_matches_collect(rng):
    genome = gen_reference_with_repeats(rng, 3000)
    fm = FMIndex.build(genome)
    reads = gen_smem_reads(rng, genome, 26, read_len=70)
    seq = np.full((96, len(reads)), 4, np.uint8)
    lens = np.array([len(r) for r in reads], np.int32)
    for k, r in enumerate(reads):
        seq[: len(r), k] = r
    eng = SmemEngine(fm, SmemConfig(batch_size=8, seq_length=96), device="cpu")
    flat, nn, ovf = eng.collect_arrays(seq, lens)
    assert flat.shape == (int(nn.sum()), 5) and flat.dtype == nn.dtype == np.int64
    want = eng.collect(reads)
    assert ovf.sum() < len(reads) // 4
    starts = np.cumsum(nn) - nn
    for k in range(len(reads)):
        if ovf[k]:  # flagged: no intervals here, collect retried it
            assert nn[k] == 0
            continue
        got = [dict(zip(("x0", "x1", "s", "start", "end"), row))
               for row in flat[starts[k]: starts[k] + nn[k]].tolist()]
        assert got == want[k]


def test_engine_raises_without_native_or_card(monkeypatch, rng):
    fm = FMIndex.build(gen_reference_with_repeats(rng, 500))
    monkeypatch.setattr(engine_module, "ensure_native", lambda: False)
    with pytest.raises(RuntimeError, match="native"):
        SmemEngine(fm, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        SmemEngine(fm, device="cuda")


def test_cpu_engine_never_launches_and_empty(rng):
    genome = gen_reference_with_repeats(rng, 800)
    fm = FMIndex.build(genome)
    eng = SmemEngine(fm, device="cpu")
    before = dict(K.LAUNCHES)
    assert eng.collect([]) == []
    reads = gen_smem_reads(rng, genome, 3, read_len=50)
    assert eng.collect(reads) == [mem_collect_intv_oracle(fm, r) for r in reads]
    assert dict(K.LAUNCHES) == before
