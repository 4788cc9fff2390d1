"""The port's SMEM probe table and plain SMEM machine against the JAX
package, on the same inputs.

The cases are test_smem_machine.py's (same genomes, reads and buckets, so
the JAX machine compiles the shapes it already does there).  The port
runs its plain PyTorch version (CPU tensors); the JAX side runs
``smem_batch_machine``.  Intervals are integers and compared exactly: in
the oracle's push order against ``mem_collect_intv_oracle``, and as sets
against the JAX machine.  Reads the port flags are held to the contract
instead: what they pushed before the stop is a prefix of the oracle's
list.  The CUDA kernel is held against the plain version in
test_torch_gpu.py, which needs a card.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from acc_genomics_tpu.io.synth import gen_reference_with_repeats, gen_smem_reads
from acc_genomics_tpu.ops.smem.index import FMIndex as JaxFMIndex
from acc_genomics_tpu.ops.smem.machine import device_index_fused, smem_batch_machine
from acc_genomics_tpu.ops.smem.reference import (
    DEFAULT_SMEM_PARAMS,
    SmemParams,
    mem_collect_intv_oracle,
)
from acc_genomics_tpu.io.bwa_index import load_bwa_index
from acc_genomics_tpu_torch.ops.smem import kernel as K
from acc_genomics_tpu_torch.ops.smem.index import FMIndex
from acc_genomics_tpu_torch.ops.smem.table import DeviceIndex, probe_table

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
FIELDS = ("x0", "x1", "s", "start", "end")


def _tuples(ivs):
    return [tuple(i[f] for f in FIELDS) for i in ivs]


def _plain(fm, reads, seq_len, params=DEFAULT_SMEM_PARAMS):
    seq = np.full((seq_len, len(reads)), 4, np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for k, r in enumerate(reads):
        seq[: len(r), k] = r
        lens[k] = len(r)
    idx = DeviceIndex.build(fm, "cpu")
    mem, n, flag, probes = K.smem_collect(idx, torch.from_numpy(seq),
                                         torch.from_numpy(lens), params)
    mem, n, flag, probes = (x.numpy() for x in (mem, n, flag, probes))
    out = [[tuple(int(v) for v in mem[:, j, k]) for j in range(n[k])]
           for k in range(len(reads))]
    return out, flag.astype(bool), probes


def _exact_parity(rng):
    genome = gen_reference_with_repeats(rng, 2500)
    reads = gen_smem_reads(rng, genome, 12, read_len=80)
    r = reads[0].copy()
    r[7] = 4
    r[50:55] = 4
    reads += [r, reads[1][:3].copy(), np.full(20, 4, np.uint8)]
    return genome, reads, 96, DEFAULT_SMEM_PARAMS


def _mixed_lengths(rng):
    genome = gen_reference_with_repeats(rng, 1500)
    reads = [gen_smem_reads(rng, genome, 1, read_len=n)[0] for n in (21, 40, 64, 80, 95)]
    return genome, reads, 96, DEFAULT_SMEM_PARAMS


def _tandem_repeat(rng):
    """test_smem_machine.py's overflow probe: a tandem-repeat genome and
    read."""
    motif = rng.integers(0, 4, 12).astype(np.uint8)
    return np.tile(motif, 300), [np.tile(motif, 8)[:90].copy()], 96, DEFAULT_SMEM_PARAMS


def _mem_bust(rng):
    """Three output rows: most reads push past them."""
    genome, reads, seq_len, _ = _exact_parity(rng)
    return genome, reads, seq_len, SmemParams(mem_cap=3)


def _chain_bust(rng):
    """test_smem_machine.py's tight chain cap: normal reads bust it."""
    genome = gen_reference_with_repeats(rng, 2000)
    reads = gen_smem_reads(rng, genome, 4, read_len=60, error_rate=0.05)
    return genome, reads, 64, SmemParams(curr_cap=2)


CASES = {"exact_parity": _exact_parity, "mixed_lengths": _mixed_lengths,
         "tandem_repeat": _tandem_repeat, "mem_bust": _mem_bust,
         "chain_bust": _chain_bust}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_oracle_and_jax_machine(case, rng):
    genome, reads, seq_len, params = CASES[case](rng)
    got, flags, probes = _plain(FMIndex.build(genome), reads, seq_len, params)
    jax_fm = JaxFMIndex.build(genome)
    jax_got, jax_ovf, _ = smem_batch_machine(jax_fm, reads, seq_len=seq_len, params=params)
    for k, r in enumerate(reads):
        want = _tuples(mem_collect_intv_oracle(jax_fm, r, params))
        if flags[k]:
            assert got[k] == want[: len(got[k])], k
            continue
        assert got[k] == want, k
        if not jax_ovf[k]:
            assert sorted(got[k]) == sorted(_tuples(jax_got[k])), k
        assert probes[k] > 0 or not want
    if case == "chain_bust":
        assert flags.any() and jax_ovf.any()
    elif case == "mem_bust":
        assert flags.any()
    else:
        assert not flags.any()


def test_probe_table_matches_device_index_fused(rng):
    genome = gen_reference_with_repeats(rng, 1000)
    fm = FMIndex.build(genome)
    want = device_index_fused(JaxFMIndex.build(genome))
    idx = DeviceIndex.build(fm, "cpu")
    np.testing.assert_array_equal(probe_table(fm), np.asarray(want["tbl"]))
    np.testing.assert_array_equal(idx.tbl.numpy(), np.asarray(want["tbl"]))
    np.testing.assert_array_equal(idx.l2.numpy(), np.asarray(want["l2"]))
    assert idx.l2_values == tuple(int(v) for v in fm.L2)
    assert idx.primary == int(want["primary"])


def test_plain_on_bwa_index_fixture():
    """The frozen ``bwa index`` files, read through the JAX package's
    reader into the port's FMIndex: the port's table from them gives the
    oracle's intervals."""
    genome = np.load(os.path.join(FIX, "bwaidx_genome.npy"))
    loaded, _ = load_bwa_index(os.path.join(FIX, "bwaidx"))
    fm = FMIndex(**{f.name: getattr(loaded, f.name) for f in dataclasses.fields(loaded)})
    rng = np.random.default_rng(3)
    reads = [genome[p: p + 60].copy() for p in rng.integers(0, len(genome) - 60, 4)]
    reads += gen_smem_reads(rng, genome, 4, read_len=60)
    got, flags, _ = _plain(fm, reads, 64)
    assert not flags.any()
    fresh = JaxFMIndex.build(genome)
    for g, r in zip(got, reads):
        assert g == _tuples(mem_collect_intv_oracle(fresh, r))


def test_caps_and_dispatch(rng):
    assert K.caps(DEFAULT_SMEM_PARAMS, 128) == (24, 24)
    assert K.caps(SmemParams(curr_cap=96, mem_cap=512), 128) == (96, 256)
    assert K.caps(SmemParams(curr_cap=K.CHAIN_MAX), 256) == (K.CHAIN_MAX, 24)
    with pytest.raises(ValueError, match="CHAIN_MAX"):
        K.caps(SmemParams(curr_cap=K.CHAIN_MAX + 1), 128)
    fm = FMIndex.build(gen_reference_with_repeats(rng, 600))
    idx = DeviceIndex.build(fm, "cpu")
    seq = torch.full((32, 2), 4, dtype=torch.uint8)
    lens = torch.tensor([0, 20], dtype=torch.int32)
    before = dict(K.LAUNCHES)
    mem, n, flag, probes = K.smem_collect(idx, seq, lens)
    assert dict(K.LAUNCHES) == before  # CPU tensors: the plain version
    assert mem.shape == (5, 24, 2) and mem.dtype == torch.int32
    assert n.tolist() == [0, 0] and flag.tolist() == [0, 0] and probes.tolist() == [0, 0]
    with pytest.raises(ValueError, match="mixed"):
        K.smem_collect(idx, seq.to("meta"), lens)
