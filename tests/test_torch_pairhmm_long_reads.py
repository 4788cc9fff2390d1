"""PairHMM pairs whose read is past the default buckets' 255 bases, on the CPU.

Long-read data (PacBio HiFi) hard-clipped to GATK's padded assembly
windows gives reads as long as the window.  The engine built from the
``gatk_hc_hifi28x`` configuration's ``engine`` block (read buckets up to
576 rows) runs them on its device route, here the kernel's plain PyTorch
version, and is held to the plain float64 forward of
``port_bench/reference/pairhmm.py`` (no JAX, nothing of the port) and to
the native float64 host forward.  The gap allowed, 1e-3 in log10, is the
configuration's ``lik_log10_gap``: float32 against float64 over a pair's
summed path probabilities, with room for the longest reads' rounding.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from acc_genomics_tpu_torch import native
from acc_genomics_tpu_torch.config import engine_config_from_dict
from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
from acc_genomics_tpu_torch.engine.pairhmm_engine import PairHMMEngine
from acc_genomics_tpu_torch.models.haplotype_caller import LONG_READ, HaplotypeCallerCore
from acc_genomics_tpu_torch.ops.pairhmm import kernel as K
from acc_genomics_tpu_torch.ops.pairhmm.context import PairHMMContext
from acc_genomics_tpu_torch.ops.pairhmm.convert import context_tables, quals_to_torch
from acc_genomics_tpu_torch.ops.pairhmm.pack import pack_pairhmm_quals
from port_bench.gen.regions import make_regions
from port_bench.reference import pairhmm as ref_pairhmm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "port_bench", "configs", "gatk_hc_hifi28x.json")) as f:
    HIFI = json.load(f)
GAP = HIFI["limits"]["lik_log10_gap"]
READ_LENS = (256, 257, 288, 511, 512, 575)


def _pairhmm_config(extra_rows=()):
    cfg = engine_config_from_dict(HIFI["engine"]).pairhmm
    return dataclasses.replace(cfg, read_buckets=cfg.read_buckets + tuple(extra_rows))


def _pairs(rng, read_lens, hap_len, n_haps=2):
    """Testcases of reads of ``read_lens`` against ``n_haps`` haplotypes
    of about ``hap_len`` bases: each read a slice of one haplotype with
    0.2% substitutions, HiFi-like qualities (capped at 60)."""
    base = rng.integers(0, 4, hap_len).astype(np.uint8)
    haps = [base]
    for _ in range(n_haps - 1):
        h = base.copy()
        snp = rng.random(hap_len) < 0.003
        h[snp] = (h[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
        haps.append(np.delete(h, slice(hap_len // 2, hap_len // 2 + 2)))
    tcs = []
    for ln in read_lens:
        fit = [h for h in haps if len(h) >= ln]
        src = fit[int(rng.integers(0, len(fit)))]
        off = int(rng.integers(0, len(src) - ln + 1))
        rs = src[off:off + ln].copy()
        err = rng.random(ln) < 0.002
        rs[err] = (rs[err] + 1) % 4
        q = rng.choice(np.array([60, 40, 20, 10], np.uint8), ln, p=[0.9, 0.05, 0.03, 0.02])
        read = dict(rs=rs, q=q, i=np.full(ln, 45, np.uint8), d=np.full(ln, 45, np.uint8),
                    c=np.full(ln, 10, np.uint8))
        tcs += [dict(hap=h, **read) for h in haps]
    return tcs


def _flat(tcs):
    cat = lambda key: np.concatenate([np.asarray(t[key], np.uint8) for t in tcs])
    return (cat("rs"), cat("q"), cat("i"), cat("d"), cat("c"),
            np.array([len(t["rs"]) for t in tcs], np.int32), cat("hap"),
            np.array([len(t["hap"]) for t in tcs], np.int32))


def _reference(tcs):
    """The plain float64 forward, log10 likelihoods."""
    R = max(len(t["rs"]) for t in tcs)
    H = max(len(t["hap"]) for t in tcs)
    mats = {}
    for key in ("rs", "q", "i", "d", "c"):
        m = np.zeros((len(tcs), R), np.uint8)
        for k, t in enumerate(tcs):
            m[k, :len(t[key])] = t[key]
        mats[key] = m
    hap = np.zeros((len(tcs), H), np.uint8)
    for k, t in enumerate(tcs):
        hap[k, :len(t["hap"])] = t["hap"]
    lens = [len(t["rs"]) for t in tcs]
    hlens = [len(t["hap"]) for t in tcs]
    return ref_pairhmm.forward_loglik(mats["rs"], mats["q"], mats["i"], mats["d"], mats["c"],
                                      lens, hap, hlens)


def _native64(tcs):
    ctx = PairHMMContext(np.float64)
    return np.log10(native.pairhmm_forward(tcs, np.float64)) - ctx.log10_initial_constant


def _assert_close(got, tcs):
    want = _reference(tcs)
    assert np.all(np.isfinite(want))
    assert np.max(np.abs(got - want)) <= GAP
    assert np.max(np.abs(got - _native64(tcs))) <= GAP


@pytest.mark.parametrize("extra_rows,read_lens,hap_len", [
    ((), READ_LENS, 620),
    ((1024,), (1023, 600), 1024),
], ids=["hifi_buckets", "1024_bucket"])
def test_engine_runs_long_reads_on_the_device_route(extra_rows, read_lens, hap_len):
    """Every pair on the device route (no host fallback), each long read
    in the smallest configured bucket that holds it, within the gap of
    the float64 references."""
    rng = np.random.default_rng(len(read_lens))
    tcs = _pairs(rng, read_lens, hap_len)
    eng = PairHMMEngine(_pairhmm_config(extra_rows), device="cpu")
    launched = []
    real = K.pairhmm_forward_from_quals

    def spy(q, *a, **kw):
        launched.append(q.shape[0])
        return real(q, *a, **kw)

    import acc_genomics_tpu_torch.engine.pairhmm_engine as engine_module

    engine_module.pairhmm_forward_from_quals = spy
    try:
        got = eng.compute_pairs_flat(*_flat(tcs))
    finally:
        engine_module.pairhmm_forward_from_quals = real
    assert eng.stats.get("host_fallback", 0) == 0
    buckets = eng.config.read_buckets
    want_rows = {next(b for b in buckets if ln < b) for ln in read_lens}
    assert sorted(launched) == sorted(want_rows)
    _assert_close(got, tcs)


@pytest.mark.parametrize("expand", ["arith", "gather"])
def test_tall_bucket_short_read_and_inert_lanes(expand):
    """A 576-row pack holding a read of 40 bases beside reads of 300 and
    575, an empty read, and the pack's padding lanes: the short and long
    reads within the gap of the reference, the inert lanes exactly 0."""
    rng = np.random.default_rng(7)
    tcs = _pairs(rng, (40, 300, 575), 600, n_haps=1)
    empty = {k: np.asarray(v)[:0] for k, v in tcs[0].items() if k != "hap"}
    tcs.append(dict(hap=tcs[0]["hap"], **empty))
    pack = pack_pairhmm_quals(tcs, rows=576, cols=1024)
    ctx = PairHMMContext(np.float32)
    ph2pr, m2m, _ = context_tables(ctx, torch.device("cpu"))
    raw = K.pairhmm_forward_from_quals(*quals_to_torch(pack, "cpu"), ph2pr, m2m,
                                       float(ctx.initial_constant), expand=expand).numpy()
    assert raw.shape[0] > len(tcs)  # padding lanes
    assert np.all(raw[len(tcs) - 1:] == 0.0)
    got = np.log10(raw[:3].astype(np.float64)) - np.float64(ctx.log10_initial_constant)
    _assert_close(got, tcs[:3])


def _hifi_regions(n):
    cfg = json.loads(json.dumps(HIFI))
    cfg["region"].update(active_min=20, active_max=140, coverage=3)
    cfg["variants"]["max_haplotypes"] = 4
    return make_regions(np.random.default_rng(18), cfg, n)


def test_haplotype_caller_scores_hifi_regions_on_the_device_route():
    """HaplotypeCallerCore on generated HiFi regions (reads of 13.5 kb
    clipped to windows of 220-340 bases): every likelihood within the gap
    of the plain float64 forward, ``long_pairs`` the count of pairs whose
    read is past 255 bases, ``host_pairs`` 0."""
    regions = _hifi_regions(3)
    core = HaplotypeCallerCore(GenomicsEngine(engine_config_from_dict(HIFI["engine"]), "cpu"),
                               int(HIFI["overhang_strategy"]))
    out = core.process_regions(regions)
    tcs = [dict(hap=h, **r) for _, haps, reads in regions for r in reads for h in haps]
    n_long = sum(len(t["rs"]) > LONG_READ for t in tcs)
    assert LONG_READ == 255 and n_long > 0
    assert core.anatomy["long_pairs"] == n_long
    assert core.anatomy["host_pairs"] == 0
    got = np.concatenate([res.likelihoods.reshape(-1) for res in out])
    assert np.max(np.abs(got - _reference(tcs))) <= GAP
    core.reset_anatomy()
    assert core.anatomy["long_pairs"] == core.anatomy["host_pairs"] == 0


def test_default_buckets_send_long_reads_to_the_host_and_count_them():
    """Under the default buckets (up to 256 rows) the same regions' long
    reads go to the native host forward: ``host_pairs`` counts them and
    ``long_pairs`` stays 0; the answers are the same within the gap."""
    regions = _hifi_regions(2)
    engine_cfg = {k: v for k, v in HIFI["engine"].items() if k != "pairhmm"}
    core = HaplotypeCallerCore(GenomicsEngine(engine_config_from_dict(engine_cfg), "cpu"),
                               int(HIFI["overhang_strategy"]))
    out = core.process_regions(regions)
    tcs = [dict(hap=h, **r) for _, haps, reads in regions for r in reads for h in haps]
    n_long = sum(len(t["rs"]) > LONG_READ for t in tcs)
    assert n_long > 0
    assert core.anatomy["host_pairs"] == n_long and core.anatomy["long_pairs"] == 0
    got = np.concatenate([res.likelihoods.reshape(-1) for res in out])
    assert np.max(np.abs(got - _reference(tcs))) <= GAP
