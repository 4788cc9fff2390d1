"""The port's BwaMemSeeding on its two CPU engines against the JAX
BwaMemSeeding on ``GenomicsEngine()`` and against the oracle chain
(SMEM oracle -> suffix-array positions -> ``extend_seed_oracle``, the
seed enumeration of drivers/bwamem_driver.py).  Whole SeedHit lists are
compared exactly, read by read and in order.
"""

import dataclasses

import numpy as np
import pytest

from acc_genomics_tpu.engine.genomics_engine import GenomicsEngine
from acc_genomics_tpu.io.synth import gen_reference_with_repeats, gen_smem_reads
from acc_genomics_tpu.models import BwaMemSeeding as JaxSeeding
from acc_genomics_tpu.ops.extend.reference import extend_seed_oracle
from acc_genomics_tpu.ops.smem.reference import mem_collect_intv_oracle
from acc_genomics_tpu_torch.engine.extend_engine import ExtendEngine
from acc_genomics_tpu_torch.engine.smem_engine import SmemEngine
from acc_genomics_tpu_torch.models import BwaEngines, BwaMemSeeding, SeedHit
from acc_genomics_tpu_torch.ops.smem.index import FMIndex


def oracle_hits(fm, read, max_occ, flank):
    """drivers/bwamem_driver.py's oracle chain for one read (interval
    order, occurrences in suffix-array row order, at most max_occ)."""
    out = []
    for iv in mem_collect_intv_oracle(fm, read):
        slen = iv["end"] - iv["start"]
        for pos in fm.sa[iv["x0"]: iv["x0"] + min(iv["s"], max_occ)]:
            pos = int(pos)
            span_lo = max(0, pos - iv["start"] - flank)
            span_hi = min(fm.seq_len, pos + slen + (len(read) - iv["end"]) + flank)
            res = extend_seed_oracle(read, fm.text[span_lo:span_hi], iv["start"],
                                     pos - span_lo, slen)
            out.append((res["qBeg"], iv["end"] + res["qEnd"], pos + res["rBeg"],
                        pos + slen + res["rEnd"], res["score"], res["trueScore"],
                        res["width"], iv["s"]))
    return out


def _hits(hits):
    return [dataclasses.astuple(h) for h in hits]


@pytest.fixture(scope="module")
def case():
    """One genome, its reads and both sides' engines for every case."""
    rng = np.random.default_rng(0)
    genome = gen_reference_with_repeats(rng, 5000)
    reads = gen_smem_reads(rng, genome, 6, read_len=101)
    reads.append(genome[1000:1300].copy())  # past seq_length and max_qlen: host
    reads.append(np.full(40, 4, np.uint8))  # no interval
    jax_eng = GenomicsEngine()
    fm = jax_eng.load_reference(genome)
    engines = BwaEngines(SmemEngine(FMIndex.build(genome), device="cpu"),
                         ExtendEngine(device="cpu"))
    return reads, jax_eng, fm, engines


@pytest.mark.parametrize("max_occ,flank", [(4, 100), (8, 30)])
def test_map_reads_matches_jax_and_oracle(max_occ, flank, case):
    reads, jax_eng, fm, engines = case
    want = JaxSeeding(jax_eng, max_occ=max_occ, flank=flank).map_reads(reads)
    got = BwaMemSeeding(engines, max_occ=max_occ, flank=flank).map_reads(reads)
    assert [_hits(h) for h in got] == [_hits(h) for h in want]
    assert all(isinstance(h, SeedHit) for hs in got for h in hs)
    assert got[-1] == [] and sum(len(h) for h in got) > len(reads)
    assert engines.extend.stats["host_fallback"] > 0
    for k in (0, 3, len(reads) - 2):
        assert [h[1:] for h in _hits(got[k])] == oracle_hits(fm, reads[k], max_occ, flank)
        assert all(h.read_id == k for h in got[k])
