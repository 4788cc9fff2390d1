"""FM-index (BWT) construction and layout for the SMEM engine.

Replaces the reference's external dependency on libbwa's ``bwa_idx_load``
(smem/main.cpp:434) with a self-contained construction:

* the indexed text is forward + reverse-complement of the genome (the
  bidirectional-BWT convention BWA uses, so one index serves both
  strands and ``x[1]`` tracks the complement interval),
* the suffix array is built by prefix doubling (NumPy, O(n log^2 n));
  the C++ SA-IS construction in native/ handles large genomes,
* ``primary`` is the BWT row of the full-text suffix (where the virtual
  sentinel would be); the stored BWT skips it, exactly like BWA's
  bwt_t, so occ(k) applies ``k -= (k >= primary)``,
* device layout: occ checkpoints every OCC_INTERVAL=64 bases plus 2-bit
  packed BWT words — a flattened SoA version of the reference's
  interleaved 64-byte blocks (smem/host/baseline.cpp bwt_occ_intv),
  sized so one interval fits a single 32-byte gather.

Coordinates follow BWA: intervals are (x0, x1, s) with 1-based x0 over
the suffix-array rank space including the sentinel row.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

OCC_INTERVAL = 64


def _suffix_array(text: np.ndarray) -> np.ndarray:
    """Prefix-doubling suffix array over small integer alphabet."""
    n = len(text)
    rank = text.astype(np.int64)
    sa = np.argsort(rank, kind="stable")
    k = 1
    tmp = np.empty(n, dtype=np.int64)
    while True:
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        sa = order
        tmp[sa[0]] = 0
        r_prev = rank[sa[:-1]]
        r_cur = rank[sa[1:]]
        k2_prev = key2[sa[:-1]]
        k2_cur = key2[sa[1:]]
        newr = np.cumsum((r_cur != r_prev) | (k2_cur != k2_prev))
        tmp[sa[1:]] = newr
        rank = tmp.copy()
        if rank[sa[-1]] == n - 1:
            break
        k <<= 1
    return sa


def revcomp(seq: np.ndarray) -> np.ndarray:
    """nt4 reverse complement (A<->T, C<->G; N stays N)."""
    out = seq[::-1].copy()
    mask = out < 4
    out[mask] = 3 - out[mask]
    return out


@dataclasses.dataclass
class FMIndex:
    bwt: np.ndarray  # (2l,) uint8 BWT symbols ($ removed)
    text: np.ndarray  # (2l,) uint8 indexed text (fwd + revcomp) — the
    # on-host copy of the reference's pac preload (BWAOCLEnv)
    primary: int  # sentinel row
    L2: np.ndarray  # (5,) int64 cumulative symbol counts
    seq_len: int  # 2l
    sa: np.ndarray  # (2l+1,) suffix array incl. sentinel row (row 0)
    # device layout
    occ_ckpt: np.ndarray  # (nblk+1, 4) int64 counts before each block
    bwt_packed: np.ndarray  # (nblk, 4) uint32, 16 bases per word, MSB-first

    @classmethod
    def build(cls, genome: np.ndarray) -> "FMIndex":
        genome = np.asarray(genome, dtype=np.uint8)
        if genome.max(initial=0) > 3:
            raise ValueError("index genome must be N-free (codes 0..3)")
        text = np.concatenate([genome, revcomp(genome)])
        n = len(text)
        from acc_genomics_tpu_torch import native

        sa_inner = native.suffix_array(text)  # linear-time SA-IS (C++)
        if sa_inner is None:
            sa_inner = _suffix_array(text)  # NumPy fallback
        # full SA over n+1 rotations with sentinel: sentinel suffix (empty)
        # sorts first -> row 0; remaining rows follow sa_inner order
        sa = np.empty(n + 1, dtype=np.int64)
        sa[0] = n
        sa[1:] = sa_inner
        # BWT of row r = text[sa[r]-1]; the row with sa == 0 would emit the
        # sentinel: that's `primary`; it is skipped in the stored bwt
        primary = int(np.flatnonzero(sa == 0)[0])
        prev_idx = sa - 1
        keep = prev_idx >= 0
        bwt = text[prev_idx[keep]].astype(np.uint8)
        counts = np.bincount(text, minlength=4)[:4]
        L2 = np.zeros(5, dtype=np.int64)
        L2[1:] = np.cumsum(counts)

        nblk = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
        # per-block base counts -> cumulative checkpoints, fully vectorized
        # (a per-block Python loop costs ~1 min/20 Mb at genome scale)
        pad_n = nblk * OCC_INTERVAL - n
        bwt_pad = np.concatenate([bwt, np.full(pad_n, 4, np.uint8)])
        blocks = bwt_pad.reshape(nblk, OCC_INTERVAL)
        per_blk = np.stack(
            [(blocks == c).sum(axis=1, dtype=np.int64) for c in range(4)], axis=1
        )
        occ_ckpt = np.zeros((nblk + 1, 4), dtype=np.int64)
        np.cumsum(per_blk, axis=0, out=occ_ckpt[1:])
        # pack 2-bit codes, 16 per uint32, base j of word at bits (30-2j..)
        pad = nblk * OCC_INTERVAL - n
        codes = np.concatenate([bwt, np.zeros(pad, np.uint8)]).astype(np.uint32)
        codes = codes.reshape(-1, 16)
        shifts = (30 - 2 * np.arange(16, dtype=np.uint32))
        words = (codes << shifts[None, :]).sum(axis=1, dtype=np.uint32)
        bwt_packed = words.reshape(nblk, 4)
        return cls(bwt, text, primary, L2, n, sa, occ_ckpt, bwt_packed)

    # -- persistence (the reference's only durable state is the loaded
    # index; kernels themselves are stateless request/response) ----------

    def save(self, path: str, compress: bool = False) -> None:
        # uncompressed by default: at 100 Mbp the arrays are ~2 GB and
        # zlib costs minutes on one core for a local scratch cache;
        # np.load reads either form
        d = os.path.dirname(path)
        if d:  # scratch dirs (data/) may not exist yet
            os.makedirs(d, exist_ok=True)
        writer = np.savez_compressed if compress else np.savez
        writer(
            path, bwt=self.bwt, text=self.text,
            primary=np.int64(self.primary), L2=self.L2,
            seq_len=np.int64(self.seq_len), sa=self.sa,
            occ_ckpt=self.occ_ckpt, bwt_packed=self.bwt_packed,
        )

    @classmethod
    def load(cls, path: str) -> "FMIndex":
        with np.load(path, allow_pickle=False) as z:
            return cls(
                z["bwt"], z["text"], int(z["primary"]), z["L2"],
                int(z["seq_len"]), z["sa"], z["occ_ckpt"], z["bwt_packed"],
            )

    # -- counting --------------------------------------------------------

    def occ4(self, k: int) -> np.ndarray:
        """Counts of each base among the first k+1 BWT rows (sentinel row
        excluded), k in rank space; k == -1 -> zeros."""
        if k == -1:
            return np.zeros(4, dtype=np.int64)
        k = int(k)
        k -= k >= self.primary
        blk, off = divmod(k, OCC_INTERVAL)
        cnt = self.occ_ckpt[blk].copy()
        seg = self.bwt[blk * OCC_INTERVAL : blk * OCC_INTERVAL + off + 1]
        cnt += np.bincount(seg, minlength=4)[:4]
        return cnt

    def set_intv(self, c: int):
        """Initial interval of single base c (bwt_set_intv)."""
        return (
            int(self.L2[c]) + 1,
            int(self.L2[3 - c]) + 1,
            int(self.L2[c + 1] - self.L2[c]),
        )

    def extend(self, ik, is_back: int):
        """Bidirectional extension: ik = (x0, x1, s) -> ok[c] for c in 0..3
        (bwt_extend semantics, smem/host/baseline.cpp:87-100).

        The *counted* rank coordinate is x[1-is_back] (x1 when extending
        forward, x0 when extending backward); the other coordinate is
        assigned cumulatively in complement order T,G,C,A.
        """
        cnt = 1 - is_back
        oth = is_back
        xf = int(ik[cnt])
        s = int(ik[2])
        tk = self.occ4(xf - 1)
        tl = self.occ4(xf - 1 + s)
        ok = [[0, 0, 0] for _ in range(4)]
        for c in range(4):
            ok[c][cnt] = int(self.L2[c]) + 1 + int(tk[c])
            ok[c][2] = int(tl[c] - tk[c])
        span = int(xf <= self.primary and xf + s - 1 >= self.primary)
        acc = int(ik[oth]) + span
        for c in (3, 2, 1, 0):
            ok[c][oth] = acc
            acc += ok[c][2]
        return [tuple(o) for o in ok]
