"""The work counts of the rooflines against brute force at tiny sizes."""

import importlib.util
import os

import numpy as np

from conftest import BENCH
from port_bench.reference import extend as ref_extend
from port_bench.reference import fm as ref_fm


def _metric(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(BENCH, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Counted(float):
    """A float that counts the arithmetic done on it: each operator one
    operation; a multiply whose product is then added counts as the two
    of an FMA."""

    ops = [0]

    def _op(self, other, f):
        Counted.ops[0] += 1
        return Counted(f(float(self), float(other)))

    def __add__(self, o):
        return self._op(o, lambda a, b: a + b)

    __radd__ = __add__

    def __mul__(self, o):
        return self._op(o, lambda a, b: a * b)

    __rmul__ = __mul__


def _forward_scalar(rl, hl):
    """GATK's forward recurrence over (rl + 1) x (hl + 1) in scalars,
    counting the operations of every real cell."""
    z = Counted(0.0)
    M = [[z] * (hl + 1) for _ in range(rl + 1)]
    X = [[z] * (hl + 1) for _ in range(rl + 1)]
    Y = [[Counted(1.0 / hl)] * (hl + 1)] + [[z] * (hl + 1) for _ in range(rl)]
    p = Counted(0.9)
    Counted.ops[0] = 0
    for r in range(1, rl + 1):
        for c in range(1, hl + 1):
            M[r][c] = p * (M[r - 1][c - 1] * p + (X[r - 1][c - 1] + Y[r - 1][c - 1]) * p)
            X[r][c] = M[r - 1][c] * p + X[r - 1][c] * p
            Y[r][c] = M[r][c - 1] * p + Y[r][c - 1] * p
    return Counted.ops[0]


def test_pairhmm_work_is_the_recurrence_count():
    m = _metric("pairhmm_forward_roofline")
    lens, hlens = [3, 5, 7], [4, 9, 2]
    brute = sum(_forward_scalar(a, b) for a, b in zip(lens, hlens))
    ops, nbytes = m.work(lens, hlens)
    assert ops == brute  # 11 a cell: each operator of the three states once
    assert nbytes == sum(5 * a + b + 4 for a, b in zip(lens, hlens))


class _CountingQuery:
    """A query whose element reads are counted: the extension's inner
    loop reads query[j] once a band cell."""

    def __init__(self, arr):
        self.arr, self.reads = arr, 0

    def __len__(self):
        return len(self.arr)

    def __getitem__(self, j):
        self.reads += 1
        return self.arr[j]


def test_extension_cells_are_the_inner_loop_count():
    rng = np.random.default_rng(4)
    for _ in range(20):
        t = rng.integers(0, 4, int(rng.integers(10, 120))).astype(np.uint8)
        q = t[: int(rng.integers(1, len(t)))].copy()
        q[rng.random(len(q)) < 0.05] = 1
        cq = _CountingQuery(q)
        got = ref_extend.sw_extend_oracle(cq, t, int(rng.integers(5, 40)))
        assert got["cells"] == cq.reads


def test_smem_extensions_are_counted_once_each():
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 20000).astype(np.uint8)
    g[5000:5300] = g[100:400]
    idx = ref_fm.RefIndex.build(g)
    calls = []
    orig = idx.extend
    idx.extend = lambda ik, b: (calls.append(1), orig(ik, b))[1]
    reads = [g[s:s + 150].copy() for s in (50, 4990, 12000)]
    before = idx.extensions
    for r in reads:
        ref_fm.mem_collect_intv(idx, r)
    assert idx.extensions - before == len(calls) > 0
