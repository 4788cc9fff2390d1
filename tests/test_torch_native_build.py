"""The port's build of the native host library is safe across processes.

Four processes start at once and build into one empty directory: exactly
one compiles, the others wait on the lock and load the finished file, and
every one of them then has the library.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from acc_genomics_tpu_torch import build

ROOT = pathlib.Path(__file__).resolve().parent.parent

CHILD = """
import json, sys
from acc_genomics_tpu_torch import build
from acc_genomics_tpu_torch import native
res = build.build_native(sys.argv[1])
ok = build.ensure_native(sys.argv[1])
print(json.dumps(dict(built=res.built, path=res.path, available=ok,
                      loaded=native._LIB_PATH)))
"""


def test_four_processes_build_once(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    build_dir = tmp_path / "_build"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", CHILD, str(build_dir)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(4)
    ]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        results.append(json.loads(out.strip().splitlines()[-1]))
    assert sum(r["built"] for r in results) == 1
    paths = {r["path"] for r in results}
    assert len(paths) == 1
    path = paths.pop()
    assert os.path.dirname(path) == str(build_dir)
    assert all(r["available"] and r["loaded"] == path for r in results)
    # nothing half-written is left behind
    assert sorted(p.name for p in build_dir.iterdir()) == sorted(
        [os.path.basename(path), "native.lock"])


def test_failed_native_build_raises_with_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "cxx"
    fake.write_text("#!/bin/sh\necho 'accnative.cpp: error: no OpenMP' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no OpenMP"):
        build.build_native(str(tmp_path / "_build"))
    assert not any(p.suffix == ".tmp" for p in (tmp_path / "_build").iterdir())
