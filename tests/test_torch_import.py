"""Import hygiene and explicit-device contract of the PyTorch port."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from acc_genomics_tpu_torch.config import PairHMMConfig
from acc_genomics_tpu_torch import build
from acc_genomics_tpu_torch.device import resolve_device, same_device
from acc_genomics_tpu_torch.engine.pairhmm_engine import PairHMMEngine
from acc_genomics_tpu_torch.ops.pairhmm import kernel as K

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "acc_genomics_tpu_torch"


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + [
    "chip_smoke.py"
]
PORT_MODULES = sorted(
    p[:-len(".py")].replace("/__init__", "").replace("/", ".")
    for p in PORT_FILES if p.startswith("acc_genomics_tpu_torch/")
)


def test_port_imports_without_jax():
    """This process has jax and the JAX package loaded (conftest, the
    imports above), so import every port module in a fresh one, run the
    paths that import lazily (FMIndex.build's suffix array, the native
    quals pack, a native call, the mesh forms on CPU devices), then read
    sys.modules."""
    code = "import sys\n" + "".join(f"import {m}\n" for m in PORT_MODULES) + """
import numpy as np
from acc_genomics_tpu_torch import native
from acc_genomics_tpu_torch.config import SmemConfig, SWConfig, ExtendConfig
from acc_genomics_tpu_torch.io.synth import gen_pairhmm_pairs, gen_reference_with_repeats
from acc_genomics_tpu_torch.ops.pairhmm.pack import pack_pairhmm_batch, pack_pairhmm_quals
from acc_genomics_tpu_torch.ops.smem.index import FMIndex
rng = np.random.default_rng(0)
fm = FMIndex.build(gen_reference_with_repeats(rng, 3000))
assert fm.sa.shape == (fm.seq_len + 1,)
pairs = gen_pairhmm_pairs(rng, 4)
pack_pairhmm_quals(pairs, rows=64, cols=128)
pk = pack_pairhmm_batch(pairs, rows=64, cols=128)
import torch
from acc_genomics_tpu_torch.parallel import make_mesh, pairhmm_forward_dp, pairhmm_forward_dpsp
mesh = make_mesh((2, 2), devices=["cpu"] * 4)
args = [torch.from_numpy(a) for a in pk.arrays()]
assert torch.allclose(pairhmm_forward_dpsp(mesh, *args), pairhmm_forward_dp(mesh, *args), rtol=1e-5)
SmemConfig().params(); SWConfig().params(); ExtendConfig().params()
assert native.available()
assert native.sw_align_host([np.zeros(8, np.uint8)], [np.zeros(8, np.uint8)], 0)
import tempfile
from acc_genomics_tpu_torch.io.bwa_index import load_bwa_index, save_bwa_index
from acc_genomics_tpu_torch.utils.timer import device_trace
with tempfile.TemporaryDirectory() as tmp:
    save_bwa_index(tmp + "/idx", fm)
    assert load_bwa_index(tmp + "/idx")[0].primary == fm.primary
    with device_trace(tmp + "/trace", "cpu"):
        torch.arange(4).sum()
from acc_genomics_tpu_torch.ops.pairhmm.context import PairHMMContext
ctx = PairHMMContext(np.float32)
flat = native._flat_pairs(pairs, 64, 128, 0)[:10]
assert native.pairhmm_pack_flat_f32(*flat, 64, 128, ctx.ph2pr, ctx.match_to_match,
                                    ctx.initial_constant)[0].shape == (513, 4)
print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')
             or m == 'acc_genomics_tpu' or m.startswith('acc_genomics_tpu.')))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert "acc_genomics_tpu_torch.native" in PORT_MODULES
    assert "acc_genomics_tpu_torch.engine.genomics_engine" in PORT_MODULES
    assert {"acc_genomics_tpu_torch.parallel", "acc_genomics_tpu_torch.parallel.mesh",
            "acc_genomics_tpu_torch.parallel.sharded",
            "acc_genomics_tpu_torch.parallel.sharded_kernels",
            "acc_genomics_tpu_torch.ops.pairhmm.band_kernel"} <= set(PORT_MODULES)
    assert {"acc_genomics_tpu_torch.parallel.service", "acc_genomics_tpu_torch.io.bwa_index",
            "acc_genomics_tpu_torch.entry"} | {
        f"acc_genomics_tpu_torch.drivers.{d}_driver"
        for d in ("pairhmm", "sw", "extend", "smem", "bwamem", "hc", "fuzz")
    } <= set(PORT_MODULES)


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_jax_import_statement(path):
    text = (ROOT / path).read_text()
    assert not re.search(r"^\s*(import jax|from jax)\b", text, re.M), path


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_reference_package_import(path):
    """No port module and not chip_smoke.py imports the JAX package, not
    even a module of it that does not import jax: the port keeps its own
    copies."""
    text = (ROOT / path).read_text()
    assert not re.search(
        r"^\s*(import|from)\s+acc_genomics_tpu(\.|\s)", text, re.M
    ), path


def test_engine_raises_without_native(monkeypatch):
    import acc_genomics_tpu_torch.engine.pairhmm_engine as engine_module

    monkeypatch.setattr(engine_module, "ensure_native", lambda: False)
    with pytest.raises(RuntimeError, match="native"):
        PairHMMEngine(device="cpu")


def test_cuda_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        PairHMMEngine(device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_mixed_or_unsupported_devices_raise():
    cpu = torch.zeros(4, dtype=torch.float32)
    meta = torch.empty(4, dtype=torch.float32, device="meta")
    assert same_device(cpu, cpu) == torch.device("cpu")
    with pytest.raises(ValueError, match="mixed"):
        same_device(cpu, meta)
    planes = [torch.empty((8, 4), device="meta") for _ in range(8)]
    rs = torch.empty((8, 4), dtype=torch.int32, device="meta")
    hap = torch.empty((24, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported"):
        K.pairhmm_forward(*planes, rs, hap, meta)
    with pytest.raises(ValueError, match="mixed"):
        K.pairhmm_forward(*planes, rs, hap, cpu)


def test_engine_rejects_f32_upload_and_unknown_expand():
    with pytest.raises(ValueError):
        PairHMMEngine(PairHMMConfig(quals_expand="table"), device="cpu")


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    src = tmp_path / "broken.cu"
    src.write_text("this is not CUDA\n")
    fake_nvcc = tmp_path / "nvcc"
    fake_nvcc.write_text("#!/bin/sh\necho 'broken.cu: error: expected a declaration' >&2\nexit 2\n")
    fake_nvcc.chmod(0o755)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(fake_nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="expected a declaration"):
        build.load_library("broken", [str(src)])


def test_chip_smoke_fails_without_cuda():
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT,
        env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails_with_reason(tmp_path):
    """Run alone, in a directory that holds chip_smoke.py and nothing else
    of the repository, the script names what is missing and exits 1
    before it looks for a card; from a checkout, run from another working
    directory, it finds the port (and here stops at the card check)."""
    alone = tmp_path / "alone"
    alone.mkdir()
    (alone / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=alone,
                         env=dict(os.environ, PYTHONPATH=""), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 1 and out.stdout == ""
    assert "no acc_genomics_tpu_torch package" in out.stderr
    elsewhere = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120)
    assert elsewhere.returncode == 1 and '"ok"' not in elsewhere.stdout
    assert "is_available() is False" in elsewhere.stderr
