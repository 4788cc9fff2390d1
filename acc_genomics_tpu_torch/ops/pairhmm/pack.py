"""Dense batch packing for the PairHMM kernels.

The reference feeds its device a flat bit-packed bundle with per-PU
trip-count load balancing (pairhmm/interface/PairHMMFpgaInterface.cpp:
pack_fpga_input / dist_reads_to_pu).  The TPU analog is a dense padded
batch of per-row transition/emission coefficients, shaped for the VPU:

* reads are padded to a bucketed row count R with **absorbing rows**
  (pMM=pGapM=pMY=pYY=0, pMX=pXX=1).  An absorbing row turns X into a
  column-wise collector:  X[r+1][c] = M[r][c] + X[r][c], and further
  absorbing rows propagate it unchanged — so for *any* read length
  < R the final row's X holds exactly the last real row's M+X, and the
  forward result is sum(X[R]) regardless of per-pair length.  This
  removes every per-pair gather from the hot loop.
* haps are padded to a bucketed column count H with the sentinel
  HAP_PAD; emission probability is forced to 0 there, so padded columns
  contribute exactly nothing (M stays 0, X stays 0 down the column).

All per-row arrays are laid out **time-major (R, B)** on the host: the
row scan and the Pallas diagonal kernel both consume (rows, lanes)
blocks directly, so no transposes ever run on the device (XLA TPU
transposes of these shapes measured ~30x the kernel cost).  The batch
is padded to a multiple of 128 lanes with inert pairs (all-absorbing
rows, y0 = 0 -> result 0).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from acc_genomics_tpu_torch.ops.pairhmm.context import PairHMMContext
from acc_genomics_tpu_torch.utils.convert import HAP_PAD

LANES = 128


@dataclasses.dataclass
class PackedPairHMMBatch:
    # (R, B) per-row coefficients, absorbing rows applied, time-major
    p_mm: np.ndarray
    p_gapm: np.ndarray
    p_mx: np.ndarray
    p_xx: np.ndarray
    p_my: np.ndarray
    p_yy: np.ndarray
    em_match: np.ndarray
    em_mis: np.ndarray
    rs: np.ndarray  # (R, B) int32 base codes (0..4; padding rows hold 0)
    # (R + H, B) int32: hap codes per diagonal step, HAP_PAD beyond haplen
    hap_ext: np.ndarray
    y0: np.ndarray  # (B,) initial Y row value = INITIAL_CONSTANT / haplen
    rslen: np.ndarray  # (B,) int32 (0 for batch-padding lanes)
    haplen: np.ndarray  # (B,) int32
    n_real: int  # lanes that hold real pairs
    # perm[k] = original testcase index packed into lane k (None if the
    # batch is in input order); results unsort via result[inv_perm]
    perm: np.ndarray = None

    @property
    def batch(self) -> int:
        return self.rs.shape[1]

    @property
    def rows(self) -> int:
        return self.rs.shape[0]

    @property
    def cols(self) -> int:
        return self.hap_ext.shape[0] - self.rs.shape[0]

    @property
    def cells(self) -> int:
        """Effective (unpadded) cell count — the GCUPS numerator."""
        return int((self.rslen.astype(np.int64) * self.haplen).sum())

    def arrays(self):
        return (
            self.p_mm, self.p_gapm, self.p_mx, self.p_xx, self.p_my,
            self.p_yy, self.em_match, self.em_mis, self.rs, self.hap_ext,
            self.y0,
        )

    def unsort(self, results: np.ndarray) -> np.ndarray:
        """Map per-lane results back to input testcase order."""
        results = np.asarray(results)
        if self.perm is None:
            return results[: self.n_real]
        out = np.empty(self.n_real, results.dtype)
        out[self.perm] = results[: self.n_real]
        return out


def pack_pairhmm_batch(
    testcases: Sequence[dict],
    rows: int,
    cols: int,
    dtype=np.float32,
    pad_lanes: bool = True,
    sort_by_haplen: bool = False,
    lane_multiple: int = LANES,
) -> PackedPairHMMBatch:
    """Pack testcase dicts (rs,q,i,d,c,hap arrays) into a dense batch.

    Requires max(rslen) < rows (>= 1 absorbing row) and max(haplen) <= cols.

    sort_by_haplen groups pairs of similar haplotype length into the same
    128-lane block so per-block dynamic diagonal counts stay tight (the
    reference sorts reads by padded rows for the same reason,
    FalconPairHMM.cpp:268-365); results unsort via pack.unsort().
    """
    perm = None
    if sort_by_haplen and testcases:
        perm = np.argsort([-len(t["hap"]) for t in testcases], kind="stable")
        testcases = [testcases[j] for j in perm]  # lane k holds input perm[k]
    dt = np.dtype(dtype).type
    ctx = PairHMMContext(dtype)
    n_real = len(testcases)

    if np.dtype(dtype) == np.float32:
        # native C++ packer (pack_fpga_input analog) — bit-identical to the
        # Python loop below (asserted in tests), ~30x faster on big batches
        from acc_genomics_tpu_torch import native

        b_pad = n_real
        if pad_lanes and b_pad % lane_multiple:
            b_pad += lane_multiple - b_pad % lane_multiple
        packed = native.pairhmm_pack_native(
            testcases, rows, cols, ctx.ph2pr, ctx.match_to_match,
            ctx.initial_constant, pad_to=b_pad,
        )
        if packed is not None:
            arrs, rs_out, hap_ext, y0, rslen, haplen = packed
            return PackedPairHMMBatch(
                *arrs, rs_out, hap_ext, y0, rslen, haplen, n_real, perm
            )
    b = n_real
    if pad_lanes and b % lane_multiple:
        b += lane_multiple - b % lane_multiple
    shape = (rows, b)
    p_mm = np.zeros(shape, dtype)
    p_gapm = np.zeros(shape, dtype)
    p_mx = np.ones(shape, dtype)
    p_xx = np.ones(shape, dtype)
    p_my = np.zeros(shape, dtype)
    p_yy = np.zeros(shape, dtype)
    em_match = np.zeros(shape, dtype)
    em_mis = np.zeros(shape, dtype)
    rs = np.zeros(shape, np.int32)
    hap_ext = np.full((rows + cols, b), HAP_PAD, np.int32)
    y0 = np.zeros(b, dtype)
    rslen = np.zeros(b, np.int32)
    haplen = np.zeros(b, np.int32)

    for k, tc in enumerate(testcases):
        r = len(tc["rs"])
        h = len(tc["hap"])
        if r >= rows:
            raise ValueError(f"read length {r} needs bucket > {rows} rows")
        if h > cols:
            raise ValueError(f"hap length {h} exceeds bucket cols {cols}")
        t = ctx.transitions(tc["i"], tc["d"], tc["c"])
        p_mm[:r, k], p_gapm[:r, k], p_mx[:r, k], p_xx[:r, k], p_my[:r, k], p_yy[:r, k] = t
        em_match[:r, k], em_mis[:r, k] = ctx.emissions(tc["q"])
        rs[:r, k] = np.asarray(tc["rs"], dtype=np.int32)
        hap_ext[:h, k] = np.asarray(tc["hap"], dtype=np.int32)
        y0[k] = ctx.initial_constant / dt(h)
        rslen[k] = r
        haplen[k] = h

    return PackedPairHMMBatch(
        p_mm, p_gapm, p_mx, p_xx, p_my, p_yy,
        em_match, em_mis, rs, hap_ext, y0, rslen, haplen, n_real, perm,
    )


@dataclasses.dataclass
class PackedPairHMMQuals:
    """Byte-plane packing for device-side coefficient computation.

    The 8 fp32 coefficient planes of PackedPairHMMBatch are pure
    per-base table lookups (ctx.transitions/emissions), so the device
    can compute them from the raw qual bytes — uploading 5 uint8 planes
    (~1/8 the bytes of the fp32 coefficients) and gathering from the
    128-entry ph2pr / triangular matchToMatch tables in HBM.
    """

    q: np.ndarray  # (R, B) uint8
    i: np.ndarray
    d: np.ndarray
    c: np.ndarray
    rs: np.ndarray  # (R, B) uint8 base codes
    hap_ext: np.ndarray  # (R + H, B) uint8
    rslen: np.ndarray  # (B,) int32
    haplen: np.ndarray  # (B,) int32
    n_real: int
    perm: np.ndarray = None

    @property
    def batch(self) -> int:
        return self.rs.shape[1]

    @property
    def rows(self) -> int:
        return self.rs.shape[0]

    @property
    def cells(self) -> int:
        return int((self.rslen.astype(np.int64) * self.haplen).sum())

    def unsort(self, results: np.ndarray) -> np.ndarray:
        results = np.asarray(results)
        if self.perm is None:
            return results[: self.n_real]
        out = np.empty(self.n_real, results.dtype)
        out[self.perm] = results[: self.n_real]
        return out


def pack_pairhmm_quals(
    testcases: Sequence[dict],
    rows: int,
    cols: int,
    pad_lanes: bool = True,
    sort_by_haplen: bool = False,
    lane_multiple: int = LANES,
) -> PackedPairHMMQuals:
    """Byte-plane packing (no host coefficient math; see PackedPairHMMQuals)."""
    perm = None
    if sort_by_haplen and testcases:
        perm = np.argsort([-len(t["hap"]) for t in testcases], kind="stable")
        testcases = [testcases[j] for j in perm]
    n_real = len(testcases)
    b = n_real
    if pad_lanes and b % lane_multiple:
        b += lane_multiple - b % lane_multiple
    # native memcpy/transpose packer (bit-identical to the loop below,
    # asserted in tests) — the Python per-pair loop is the measured
    # engine-e2e bottleneck at large batches (PERF_NOTES host/runtime)
    from acc_genomics_tpu_torch import native

    packed = native.pairhmm_pack_quals_native(
        testcases, rows, cols, HAP_PAD, pad_to=b
    )
    if packed is not None:
        q, i_, d, c, rs, hap_ext, rslen, haplen = packed
        return PackedPairHMMQuals(
            q, i_, d, c, rs, hap_ext, rslen, haplen, n_real, perm
        )
    shape = (rows, b)
    q = np.zeros(shape, np.uint8)
    i_ = np.zeros(shape, np.uint8)
    d = np.zeros(shape, np.uint8)
    c = np.zeros(shape, np.uint8)
    rs = np.zeros(shape, np.uint8)
    hap_ext = np.full((rows + cols, b), HAP_PAD, np.uint8)
    rslen = np.zeros(b, np.int32)
    haplen = np.zeros(b, np.int32)
    for k, tc in enumerate(testcases):
        r = len(tc["rs"])
        h = len(tc["hap"])
        if r >= rows:
            raise ValueError(f"read length {r} needs bucket > {rows} rows")
        if h > cols:
            raise ValueError(f"hap length {h} exceeds bucket cols {cols}")
        q[:r, k] = tc["q"]
        i_[:r, k] = tc["i"]
        d[:r, k] = tc["d"]
        c[:r, k] = tc["c"]
        rs[:r, k] = tc["rs"]
        hap_ext[:h, k] = tc["hap"]
        rslen[k] = r
        haplen[k] = h
    return PackedPairHMMQuals(
        q, i_, d, c, rs, hap_ext, rslen, haplen, n_real, perm
    )
