"""The port's drivers (``acc_genomics_tpu_torch/drivers``) and entry check
(``acc_genomics_tpu_torch/entry.py``) on ``device="cpu"`` at small sizes.

Each driver's ``main`` returns 0 on tiny inputs checked against the
oracles, and non-zero when one result of the engine it drives is
corrupted.  ``entry()`` is held to the JAX ``__graft_entry__.entry()``'s
forward on the same pack (rtol 1e-5), and ``dryrun_multichip(4)`` runs
on a mesh of four CPU devices.
"""

import dataclasses
import functools
import importlib
import os
import shutil

import numpy as np
import pytest

from acc_genomics_tpu_torch import entry as port_entry
from acc_genomics_tpu_torch.drivers import (
    bwamem_driver,
    extend_driver,
    fuzz_driver,
    hc_driver,
    pairhmm_driver,
    scaling_driver,
    smem_driver,
    sw_driver,
)
from acc_genomics_tpu_torch.engine.extend_engine import ExtendEngine
from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
from acc_genomics_tpu_torch.engine.pairhmm_engine import PairHMMEngine
from acc_genomics_tpu_torch.engine.smem_engine import SmemEngine
from acc_genomics_tpu_torch.engine.sw_engine import SWEngine
from acc_genomics_tpu_torch.models.bwa_mem import BwaMemDevicePipeline, BwaMemSeeding
from acc_genomics_tpu_torch.models.haplotype_caller import HaplotypeCallerCore

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
CPU = ["--device", "cpu"]


def _corrupt(monkeypatch, cls, name, spoil):
    """Wrap ``cls.name`` so that its result passes through ``spoil``."""
    orig = getattr(cls, name)

    def wrapped(self, *a, **k):
        return spoil(orig(self, *a, **k))

    monkeypatch.setattr(cls, name, wrapped)


def _bump_matrix(lik):
    lik = lik.copy()
    lik.flat[0] += 1.0
    return lik


def _bump_first_cigar(out):
    (cigar, off), *rest = out
    return [(cigar, off + 1), *rest]


def _bump_first_record(out):
    return [dict(out[0], score=out[0]["score"] + 1), *out[1:]]


def _bump_first_interval(out):
    out = [list(ivs) for ivs in out]
    k = next(k for k, ivs in enumerate(out) if ivs)
    out[k][0] = dict(out[k][0], x0=out[k][0]["x0"] + 1)
    return out


def _bump_first_hit(hits):
    hits = [list(h) for h in hits]
    k = next(k for k, h in enumerate(hits) if h)
    hits[k][0] = dataclasses.replace(hits[k][0], score=hits[k][0].score + 1)
    return hits


def _bump_region(results):
    res = results[0]
    return [dataclasses.replace(res, likelihoods=res.likelihoods + 1.0), *results[1:]]


# (driver, argv, class, method, corruption)
CASES = {
    "pairhmm": (pairhmm_driver, ["--syn", "1", "--check-frac", "0.25"], PairHMMEngine,
                "compute_matrix_flat", _bump_matrix),
    "sw": (sw_driver, ["--ref-len", "40", "--max-batch", "4"], SWEngine, "align",
           _bump_first_cigar),
    "extend": (extend_driver, ["--tasks", "12"], ExtendEngine, "extend_seeds",
               _bump_first_record),
    "smem": (smem_driver, ["--genome", "6000", "--reads", "16", "--read-len", "60",
                           "--batches", "1", "--check", "8"], SmemEngine, "collect",
             _bump_first_interval),
    "bwamem": (bwamem_driver, ["--genome", "4000", "--reads", "6", "--read-len", "60",
                               "--batches", "1", "--check", "3"], BwaMemDevicePipeline, "map_reads",
               _bump_first_hit),
    "hc": (hc_driver, ["--regions", "2", "--reads-per-region", "6"], HaplotypeCallerCore,
           "process_regions", _bump_region),
    "fuzz": (fuzz_driver, ["--seeds", "3"], SWEngine, "align", _bump_first_cigar),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_driver_passes_and_fails_on_a_corrupt_result(name, monkeypatch):
    driver, argv, cls, method, spoil = CASES[name]
    assert driver.main(argv + CPU) == 0
    _corrupt(monkeypatch, cls, method, spoil)
    assert driver.main(argv + CPU) != 0


def test_pairhmm_driver_corpus_and_stream(tmp_path, monkeypatch):
    """--real reads the reference corpus through io/pairhmm_text.py against
    its golden output; --big streams batches (here of 8 x 2 pairs)."""
    shutil.copy(os.path.join(FIXTURES, "pairhmm_input0"), tmp_path / "input0")
    shutil.copy(os.path.join(FIXTURES, "pairhmm_output0"), tmp_path / "output0")
    assert pairhmm_driver.main(["--real", str(tmp_path)] + CPU) == 0
    monkeypatch.setattr(pairhmm_driver, "run_big", functools.partial(
        pairhmm_driver.run_big, n_reads=8, n_haps=2))
    assert pairhmm_driver.main(["--big", "2"] + CPU) == 0
    _corrupt(monkeypatch, PairHMMEngine, "compute_pairs_flat_stream",
             lambda outs: [o + 1.0 for o in outs])
    assert pairhmm_driver.main(["--big", "2"] + CPU) != 0


def test_bwamem_driver_host_model_and_smem_index_sources(tmp_path, monkeypatch):
    """bwamem_driver's --host-model (BwaMemSeeding); smem_driver's --save-npz,
    --npz, --index (a saved BWA index) and --fasta sources."""
    argv = ["--genome", "4000", "--reads", "4", "--read-len", "50", "--batches", "1",
            "--check", "2"]
    assert bwamem_driver.main(argv + ["--host-model"] + CPU) == 0
    _corrupt(monkeypatch, BwaMemSeeding, "map_reads", _bump_first_hit)
    assert bwamem_driver.main(argv + ["--host-model"] + CPU) != 0

    from acc_genomics_tpu_torch.io.bwa_index import save_bwa_index
    from acc_genomics_tpu_torch.ops.smem.index import FMIndex

    small = ["--reads", "4", "--read-len", "40", "--batches", "1", "--check", "2"] + CPU
    npz = str(tmp_path / "g.fm.npz")
    assert smem_driver.main(["--genome", "3000", "--save-npz", npz] + small) == 0
    assert smem_driver.main(["--npz", npz] + small) == 0
    fm = FMIndex.load(npz)
    save_bwa_index(str(tmp_path / "idx"), fm)
    assert smem_driver.main(["--index", str(tmp_path / "idx")] + small) == 0
    fa = tmp_path / "g.fa"
    seq = "".join("ACGT"[c] for c in fm.text[: fm.seq_len // 2])
    fa.write_text(">g\n" + "\n".join(seq[j: j + 60] for j in range(0, len(seq), 60)) + "\n")
    reads = tmp_path / "reads.txt"
    reads.write_text(seq[100:180] + "\n" + seq[2000:2101] + "\nACGTNNACGT\n")
    assert smem_driver.main(["--fasta", str(fa), "--reads-file", str(reads)] + small) == 0


def test_fuzz_mesh_fails_on_a_corrupt_meshed_result(monkeypatch):
    assert fuzz_driver.fuzz_mesh(2, "cpu") == 0
    orig = GenomicsEngine.smem_collect

    def spoil_meshed(self, reads):
        out = orig(self, reads)
        return _bump_first_interval(out) if self.mesh is not None else out

    monkeypatch.setattr(GenomicsEngine, "smem_collect", spoil_meshed)
    assert fuzz_driver.fuzz_mesh(2, "cpu") == 1


def test_entry_matches_jax_entry(monkeypatch):
    monkeypatch.syspath_prepend(ROOT)
    graft = importlib.import_module("__graft_entry__")
    jax_fn, jax_args = graft.entry()
    fn, args = port_entry.entry("cpu")
    assert len(args) == len(jax_args) == 11
    for a, b in zip(args, jax_args):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(fn(*args).numpy(), np.asarray(jax_fn(*jax_args)), rtol=1e-5)


def test_dryrun_multichip_on_cpu_devices(capsys):
    assert port_entry.main(["--devices", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "entry(): pairhmm_forward on 11 tensors -> (256,)" in out
    assert "dryrun_multichip OK: mesh {'data': 2, 'seq': 2}" in out


def test_scaling_driver_on_a_repeated_cpu_device(capsys, monkeypatch):
    """--devices 4 repeats the CPU: the shared-device note, each d's result
    exact against d = 1; a corrupted sharded result exits 1."""
    argv = ["--devices", "4", "--pairs", "64"] + CPU
    assert scaling_driver.main(argv) == 0
    out = capsys.readouterr().out
    assert "share 1 device(s)" in out and "no speedup can show" in out
    assert [line.split(":")[0] for line in out.splitlines() if "GCUPS" in line] == \
        ["1 device(s)", "2 device(s)", "4 device(s)"]
    real = scaling_driver.pairhmm_forward_dp

    def spoiled(mesh, *arrays):
        out = real(mesh, *arrays)
        if mesh.shape["data"] == 4:
            out = out.clone()
            out[0] += 1e-3 * out[0]
        return out

    monkeypatch.setattr(scaling_driver, "pairhmm_forward_dp", spoiled)
    assert scaling_driver.main(argv) == 1
    bad = [line for line in capsys.readouterr().out.splitlines() if "MISMATCH" in line]
    assert len(bad) == 1 and bad[0].startswith("4 device(s)")
