"""The port's own copies of the JAX package's framework-free modules give
the same results as their originals from the same numpy seeds: configs
and their params, the PairHMM context tables, both packers, the four
oracles, FMIndex.build, the generators, the corpus readers, and the
port's native host library against the oracles.

The JAX originals run with their native library switched off (their
NumPy paths, which the originals hold bit-identical to the native ones),
so these tests never start the JAX package's in-tree ``make``.
"""

import dataclasses
import os

import numpy as np
import pytest

import acc_genomics_tpu.native as jax_native
from acc_genomics_tpu import config as jax_config
from acc_genomics_tpu.io import bwa_index as jax_bwa
from acc_genomics_tpu.io import bwasw_records as jax_br
from acc_genomics_tpu.io import pairhmm_text as jax_text
from acc_genomics_tpu.io import synth as jax_synth
from acc_genomics_tpu.ops.extend import reference as jax_extend_ref
from acc_genomics_tpu.ops.pairhmm import context as jax_context
from acc_genomics_tpu.ops.pairhmm import pack as jax_pack
from acc_genomics_tpu.ops.pairhmm import reference as jax_pairhmm_ref
from acc_genomics_tpu.ops.smem import index as jax_index
from acc_genomics_tpu.ops.smem import reference as jax_smem_ref
from acc_genomics_tpu.ops.sw import reference as jax_sw_ref
from acc_genomics_tpu.utils import convert as jax_convert
from acc_genomics_tpu_torch import config, native
from acc_genomics_tpu_torch.io import bwa_index as bwa
from acc_genomics_tpu_torch.io import bwasw_records as br
from acc_genomics_tpu_torch.io import pairhmm_text as text
from acc_genomics_tpu_torch.io import synth
from acc_genomics_tpu_torch.ops.extend import reference as extend_ref
from acc_genomics_tpu_torch.ops.pairhmm import context
from acc_genomics_tpu_torch.ops.pairhmm import pack
from acc_genomics_tpu_torch.ops.pairhmm import reference as pairhmm_ref
from acc_genomics_tpu_torch.ops.smem import index
from acc_genomics_tpu_torch.ops.smem import reference as smem_ref
from acc_genomics_tpu_torch.ops.sw import reference as sw_ref
from acc_genomics_tpu_torch.utils import convert

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture
def jax_native_off(monkeypatch):
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)


def _same(a, b):
    """Equal values, field by field for dataclasses and dicts."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    else:
        assert a == b


@pytest.mark.parametrize(
    "name", ["PairHMMConfig", "SmemConfig", "SWConfig", "ExtendConfig", "EngineConfig"])
def test_config_defaults_and_params(name):
    mine, theirs = getattr(config, name)(), getattr(jax_config, name)()
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    if hasattr(theirs, "params"):
        p, q = mine.params(), theirs.params()
        assert type(p).__name__ == type(q).__name__ and p._fields == q._fields
        assert tuple(p) == tuple(q)
    raw = {"smem": {"curr_cap": 6, "read_buckets": [64, 128]}, "mesh_shape": [2, 1]}
    assert (dataclasses.asdict(config.engine_config_from_dict(raw))
            == dataclasses.asdict(jax_config.engine_config_from_dict(raw)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pairhmm_context_tables(dtype):
    _same(vars(context.PairHMMContext(dtype)), vars(jax_context.PairHMMContext(dtype)))


@pytest.mark.parametrize("sort_by_haplen", [False, True])
@pytest.mark.parametrize("packer", ["pack_pairhmm_batch", "pack_pairhmm_quals"])
def test_packers(packer, sort_by_haplen, jax_native_off):
    pairs = synth.gen_pairhmm_pairs(np.random.default_rng(1), 40, max_read_len=60,
                                    max_hap_len=120)
    got = getattr(pack, packer)(pairs, rows=64, cols=128, sort_by_haplen=sort_by_haplen)
    want = getattr(jax_pack, packer)(pairs, rows=64, cols=128,
                                     sort_by_haplen=sort_by_haplen)
    _same(got, want)


def test_pairhmm_oracle():
    pairs = synth.gen_pairhmm_pairs(np.random.default_rng(2), 8, max_read_len=50,
                                    max_hap_len=100)
    for dtype in (np.float32, np.float64):
        for t in pairs:
            args = (t["rs"], t["q"], t["i"], t["d"], t["c"], t["hap"])
            assert (pairhmm_ref.pairhmm_loglik_oracle(*args, dtype=dtype)
                    == jax_pairhmm_ref.pairhmm_loglik_oracle(*args, dtype=dtype))


@pytest.mark.parametrize("strategy", [0, 1, 2, 3])
def test_sw_oracle(strategy):
    ref, alts = synth.gen_sw_batch(np.random.default_rng(3), 6, ref_len=90)
    for alt in alts:
        assert (sw_ref.sw_align_oracle(ref, alt, strategy)
                == jax_sw_ref.sw_align_oracle(ref, alt, strategy))


def _extend_cases(rng, n=12):
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    out = []
    for _ in range(n):
        pos = int(rng.integers(200, 2500))
        read = genome[pos: pos + 80].copy()
        err = rng.random(80) < 0.05
        read[err] = (read[err] + 1) % 4
        qbeg = int(rng.integers(0, 50))
        read[qbeg: qbeg + 20] = genome[pos + qbeg: pos + qbeg + 20]
        out.append((read, genome[pos - 100: pos + 180], qbeg, 100 + qbeg, 20))
    return out


def test_extend_oracles():
    for read, rseq, qbeg, off, slen in _extend_cases(np.random.default_rng(4)):
        assert (extend_ref.extend_seed_oracle(read, rseq, qbeg, off, slen)
                == jax_extend_ref.extend_seed_oracle(read, rseq, qbeg, off, slen))
        q, t = read[qbeg + slen:], rseq[off + slen:]
        assert (extend_ref.sw_extend_oracle(q, t, 25)
                == jax_extend_ref.sw_extend_oracle(q, t, 25))


def _genome(seed=5, n=4000):
    return synth.gen_reference_with_repeats(np.random.default_rng(seed), n)


def test_fmindex_build(jax_native_off):
    genome = _genome()
    _same(index.FMIndex.build(genome), jax_index.FMIndex.build(genome))


def test_smem_oracle(jax_native_off):
    genome = _genome(6)
    fm, jfm = index.FMIndex.build(genome), jax_index.FMIndex.build(genome)
    reads = synth.gen_smem_reads(np.random.default_rng(7), genome, 8, read_len=101)
    for params in (smem_ref.SmemParams(), smem_ref.SmemParams(min_seed_len=15)):
        for r in reads:
            assert (smem_ref.mem_collect_intv_oracle(fm, r, params)
                    == jax_smem_ref.mem_collect_intv_oracle(jfm, r,
                                                            jax_smem_ref.SmemParams(*params)))


@pytest.mark.parametrize("derived", [False, True])
def test_generators(derived):
    mk = lambda: np.random.default_rng(8)
    _same(synth.gen_pairhmm_input(mk(), 5, 3, max_read_len=60, max_hap_len=120,
                                  derived=derived),
          jax_synth.gen_pairhmm_input(mk(), 5, 3, max_read_len=60, max_hap_len=120,
                                      derived=derived))
    _same(synth.gen_pairhmm_pairs(mk(), 6), jax_synth.gen_pairhmm_pairs(mk(), 6))
    _same(synth.gen_sw_batch(mk(), 5, ref_len=80), jax_synth.gen_sw_batch(mk(), 5, ref_len=80))
    g = synth.gen_reference_with_repeats(mk(), 5000)
    _same(g, jax_synth.gen_reference_with_repeats(mk(), 5000))
    _same(synth.gen_smem_reads(mk(), g, 7, read_len=90),
          jax_synth.gen_smem_reads(mk(), g, 7, read_len=90))


def test_corpus_readers_and_codes():
    _same(text.read_pairhmm_input(os.path.join(FIXTURES, "pairhmm_input0")),
          jax_text.read_pairhmm_input(os.path.join(FIXTURES, "pairhmm_input0")))
    _same(text.read_pairhmm_output(os.path.join(FIXTURES, "pairhmm_output0")),
          jax_text.read_pairhmm_output(os.path.join(FIXTURES, "pairhmm_output0")))
    _same(br.read_task_file(os.path.join(FIXTURES, "bwasw_tasks0.bin")),
          jax_br.read_task_file(os.path.join(FIXTURES, "bwasw_tasks0.bin")))
    _same(br.read_results(os.path.join(FIXTURES, "bwasw_results0.bin")),
          jax_br.read_results(os.path.join(FIXTURES, "bwasw_results0.bin")))
    _same(convert.encode_bases("ACGTNacgtx"), jax_convert.encode_bases("ACGTNacgtx"))
    assert convert.decode_bases([0, 1, 2, 3, 4]) == jax_convert.decode_bases([0, 1, 2, 3, 4])
    assert (convert.BASE_N, convert.HAP_PAD) == (jax_convert.BASE_N, jax_convert.HAP_PAD)


def _write_fasta(path, contigs):
    with open(path, "w") as f:
        for name, codes in contigs:
            f.write(f">{name} synthetic\n")
            s = "".join("ACGTN"[c] for c in codes)
            for j in range(0, len(s), 60):
                f.write(s[j: j + 60] + "\n")


BWA_FILES = (".pac", ".bwt", ".sa", ".ann", ".amb")


@pytest.mark.parametrize("source", ["fasta", "index"])
def test_bwa_index_files_and_loads(source, tmp_path, jax_native_off):
    """Both packages write byte-identical .pac/.bwt/.sa/.ann/.amb files
    (from a FASTA with N holes and two contigs, or from a built FMIndex),
    and load and validate them to the same index and annotations."""
    rng = np.random.default_rng(11)
    prefixes = [str(tmp_path / "port"), str(tmp_path / "jax")]
    if source == "fasta":
        g2 = rng.integers(0, 4, 301).astype(np.uint8)
        g2[20:25] = 4  # an N hole: lrand48 bases from srand48(11)
        g2[260] = 4
        fa = tmp_path / "ref.fa"
        _write_fasta(fa, [("chr1", _genome(12, 1200)), ("chr2", g2)])
        _same(bwa.read_fasta(str(fa)), jax_bwa.read_fasta(str(fa)))
        mine = bwa.build_index_from_fasta(str(fa), prefix=prefixes[0])
        theirs = jax_bwa.build_index_from_fasta(str(fa), prefix=prefixes[1])
        _same(mine, theirs)
        assert len(mine[1].holes) == 2
    else:
        genome = _genome(13, 1600)
        bwa.save_bwa_index(prefixes[0], index.FMIndex.build(genome), sa_intv=16)
        jax_bwa.save_bwa_index(prefixes[1], jax_index.FMIndex.build(genome), sa_intv=16)
    for ext in BWA_FILES:
        with open(prefixes[0] + ext, "rb") as a, open(prefixes[1] + ext, "rb") as b:
            assert a.read() == b.read(), ext
    _same(bwa.load_bwa_index(prefixes[0]), jax_bwa.load_bwa_index(prefixes[1]))
    raw = bytearray(open(prefixes[0] + ".sa", "rb").read())
    raw[-4] ^= 0xFF  # a corrupt SA sample: validation rejects it
    open(prefixes[0] + ".sa", "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="sa samples"):
        bwa.load_bwa_index(prefixes[0], validate=True)


def test_bwa_lrand48_and_pac(tmp_path):
    mine, theirs = bwa._LRand48(11), jax_bwa._LRand48(11)
    assert [mine() for _ in range(64)] == [theirs() for _ in range(64)]
    genome = _genome(14, 403)
    for n in (400, 401, 403):  # l % 4 == 0 appends a zero byte
        a, b = str(tmp_path / f"a{n}.pac"), str(tmp_path / f"b{n}.pac")
        bwa.write_pac(a, genome[:n])
        jax_bwa.write_pac(b, genome[:n])
        assert open(a, "rb").read() == open(b, "rb").read()
        _same(bwa.read_pac(a, n), genome[:n])


def test_port_native_against_oracles():
    assert native.available()
    rng = np.random.default_rng(9)
    ref, alts = synth.gen_sw_batch(rng, 8, ref_len=120)
    for strategy in (0, 1, 2, 3):
        assert (native.sw_align_host([ref] * len(alts), alts, strategy)
                == [sw_ref.sw_align_oracle(ref, a, strategy) for a in alts])
    genome = _genome(10)
    fm = index.FMIndex.build(genome)
    reads = synth.gen_smem_reads(rng, genome, 10, read_len=101)
    assert native.smem_collect_host(fm, reads) == [
        jax_smem_ref.mem_collect_intv_oracle(fm, r) for r in reads]
    cases = _extend_cases(rng)
    qs = [read[qbeg + slen:] for read, _, qbeg, _, slen in cases]
    ts = [rseq[off + slen:] for _, rseq, _, off, slen in cases]
    got = native.sw_extend_host(qs, ts, [25] * len(qs))
    for k, (q, t) in enumerate(zip(qs, ts)):
        want = jax_extend_ref.sw_extend_oracle(q, t, 25)
        assert {key: int(got[key][k]) for key in got} == {key: want[key] for key in got}
    pairs = synth.gen_pairhmm_pairs(rng, 16, max_read_len=60, max_hap_len=150)
    np.testing.assert_allclose(native.pairhmm_forward(pairs, np.float64),
                               jax_pairhmm_ref.pairhmm_batch_oracle(pairs, np.float64),
                               rtol=1e-12)
