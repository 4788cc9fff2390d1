"""Plain FM-index and SMEM collection (BWA's mem_collect_intv).

The index is built here from the text alone: a suffix array by prefix
doubling in NumPy (21 bases a key at 3 bits a base, then the ties sorted
again by the rank of the suffix ``h`` bases on, ``h`` doubling), the BWT
with the sentinel row skipped as BWA's ``bwt_t`` does, and occurrence
counts every 64 BWT rows.  Conventions follow BWA: the indexed text is
the genome then its reverse complement, intervals are (x0, x1, s) with a
1-based x0 over the suffix-array ranks that include the sentinel row 0.

The SMEM search (``mem_collect_intv``: all SMEMs, the re-seed of long
SMEMs with few occurrences from their middle, the LAST-like third pass)
and the FM-index's count and extension functions are frozen copies of
the oracle the port was written against (BWA's ``bwt_smem1a``,
``bwt_seed_strategy1``, ``bwt_extend`` semantics).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple

import numpy as np

OCC_INTERVAL = 64
_KEY_BASES = 21  # 3 bits a base (code + 1; 0 past the end) in a uint64


def revcomp(seq: np.ndarray) -> np.ndarray:
    """nt4 reverse complement (A<->T, C<->G; N stays N)."""
    out = seq[::-1].copy()
    mask = out < 4
    out[mask] = 3 - out[mask]
    return out


def suffix_array(text: np.ndarray) -> np.ndarray:
    """(n,) int64 suffix array of ``text`` (codes 0..3), a suffix that
    ends sorting before every longer one that it prefixes."""
    n = len(text)
    t1 = text.astype(np.uint64) + np.uint64(1)
    key = np.zeros(n, np.uint64)
    for k in range(_KEY_BASES):
        key <<= np.uint64(3)
        if k < n:
            key[: n - k] |= t1[k:]
    sa = np.argsort(key)
    ks = key[sa]
    del key, t1
    new = np.ones(n, bool)
    new[1:] = ks[1:] != ks[:-1]
    del ks
    # rank of a suffix = the SA slot where its group of equal prefixes starts
    head = np.maximum.accumulate(np.where(new, np.arange(n), 0))
    rank = np.empty(n, np.int64)
    rank[sa] = head
    h = _KEY_BASES
    while True:
        # slots in groups of more than one suffix
        size = np.diff(np.append(np.flatnonzero(new), n))
        starts = np.flatnonzero(new)
        multi = size > 1
        if not multi.any():
            return sa
        g_start = starts[multi]
        g_size = size[multi]
        slots = np.repeat(g_start, g_size) + (
            np.arange(g_size.sum()) - np.repeat(np.cumsum(g_size) - g_size, g_size))
        pos = sa[slots]
        nxt = pos + h
        r2 = np.where(nxt < n, rank[np.minimum(nxt, n - 1)], -1)
        grp = rank[pos]
        order = np.lexsort((r2, grp))
        pos, r2, grp = pos[order], r2[order], grp[order]
        sa[slots] = pos
        brk = np.ones(len(slots), bool)
        brk[1:] = (grp[1:] != grp[:-1]) | (r2[1:] != r2[:-1])
        new[slots] = brk
        rank[pos] = np.maximum.accumulate(np.where(brk, slots, 0))
        h <<= 1


@dataclasses.dataclass
class RefIndex:
    text: np.ndarray  # (2l,) uint8: genome then its reverse complement
    sa: np.ndarray  # (2l + 1,) int64 with the sentinel row 0
    bwt: np.ndarray  # (2l,) uint8, the sentinel's row skipped
    primary: int
    L2: np.ndarray  # (5,) int64
    occ_ckpt: np.ndarray  # (nblk + 1, 4) int64 counts before each block
    extensions: int = 0  # bidirectional extensions taken, a count of the work

    @classmethod
    def build(cls, genome: np.ndarray, sa_inner: np.ndarray | None = None) -> "RefIndex":
        """Index of ``genome`` (N-free); ``sa_inner``, the suffix array of
        the text without the sentinel, when one was kept from before."""
        genome = np.asarray(genome, np.uint8)
        if genome.max(initial=0) > 3:
            raise ValueError("index genome must be N-free (codes 0..3)")
        text = np.concatenate([genome, revcomp(genome)])
        n = len(text)
        if sa_inner is None:
            sa_inner = suffix_array(text)
        sa = np.empty(n + 1, np.int64)
        sa[0] = n
        sa[1:] = sa_inner
        primary = int(np.flatnonzero(sa == 0)[0])
        prev = sa - 1
        bwt = text[prev[prev >= 0]].astype(np.uint8)
        L2 = np.zeros(5, np.int64)
        L2[1:] = np.cumsum(np.bincount(text, minlength=4)[:4])
        nblk = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
        pad = np.concatenate([bwt, np.full(nblk * OCC_INTERVAL - n, 4, np.uint8)])
        blocks = pad.reshape(nblk, OCC_INTERVAL)
        per = np.stack([(blocks == c).sum(1, dtype=np.int64) for c in range(4)], 1)
        occ = np.zeros((nblk + 1, 4), np.int64)
        np.cumsum(per, axis=0, out=occ[1:])
        return cls(text, sa, bwt, primary, L2, occ)

    @property
    def seq_len(self) -> int:
        return len(self.text)

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
        self.extensions += 1
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


class SmemParams(NamedTuple):
    """bwa mem's seeding options (``-k 19``, ``-r 1.5`` as split_len 28,
    split_width 10, ``-y 20``)."""

    min_seed_len: int = 19
    split_len: int = 28
    split_width: int = 10
    max_mem_intv: int = 20


DEFAULT_SMEM_PARAMS = SmemParams()


def _iv(x0, x1, s, start, end):
    return dict(x0=int(x0), x1=int(x1), s=int(s), start=int(start), end=int(end))


def smem1a_fwdback(
    fm: RefIndex, seq: np.ndarray, x: int, min_intv: int, mem: List[Dict],
    params: SmemParams = DEFAULT_SMEM_PARAMS,
) -> int:
    """One seeding round starting at position x; appends SMEMs to mem and
    returns the next start position (bwt_smem1a_new semantics with
    max_intv = 0, its production setting)."""
    MIN_SEED_LEN = params.min_seed_len
    ln = len(seq)
    if seq[x] > 3:
        return x + 1
    min_intv = max(min_intv, 1)

    # forward pass: collect intervals at every size change
    x0, x1, s = fm.set_intv(int(seq[x]))
    ik = _iv(x0, x1, s, 0, x + 1)  # start field unused here; end = info
    curr: List[Dict] = []
    i = x + 1
    while i < ln:
        if seq[i] < 4:
            c = 3 - int(seq[i])
            ok = fm.extend((ik["x0"], ik["x1"], ik["s"]), 0)
            if ok[c][2] != ik["s"]:
                curr.append(dict(ik))
                if ok[c][2] < min_intv:
                    break
            ik = _iv(ok[c][0], ok[c][1], ok[c][2], 0, i + 1)
        else:
            curr.append(dict(ik))
            break
        i += 1
    if i == ln:
        curr.append(dict(ik))
    ret = curr[-1]["end"]

    # backward passes
    back_intv: List[Dict] = []
    start = x
    stop = x
    temp: Dict | None = None
    i = 0
    while i < len(curr):
        ik = dict(curr[i])
        ik["start"] = x
        if not back_intv or stop - start >= 3:
            # backenlarge: fresh backward chain from scratch
            back_intv = [dict(ik)]
            k = x - 1
            while k >= -1:
                c = -1 if k < 0 else (int(seq[k]) if seq[k] < 4 else -1)
                if c >= 0:
                    ok = fm.extend((ik["x0"], ik["x1"], ik["s"]), 1)
                    if ok[c][2] < min_intv:
                        break
                    ik = _iv(ok[c][0], ok[c][1], ok[c][2], k, curr[i]["end"])
                    back_intv.append(dict(ik))
                else:
                    break
                k -= 1
            start = curr[i]["end"]
            stop = curr[i + 1]["end"] if i < len(curr) - 1 else ln
            if i == 0:
                temp = dict(ik)
            elif (
                ik["start"] > temp["start"]
                and temp["end"] - temp["start"] >= MIN_SEED_LEN
            ):
                mem.append(dict(temp))
                temp = dict(ik)
            else:
                temp = dict(ik)
        else:
            # forwardenlarge: extend a previous backward chain forward
            stop = curr[i]["end"]
            isbreak = False
            for k in range(len(back_intv) - 1, -1, -1):
                ik = dict(back_intv[k])
                for m in range(start + 1, stop + 1):
                    c = 3 - int(seq[m - 1])
                    ok = fm.extend((ik["x0"], ik["x1"], ik["s"]), 0)
                    if ok[c][2] < min_intv:
                        break
                    ik = _iv(ok[c][0], ok[c][1], ok[c][2], ik["start"], ik["end"])
                    if m == stop:
                        ik["start"] = x - k
                        ik["end"] = curr[i]["end"]
                        isbreak = True
                if isbreak:
                    if (
                        (x - k) > temp["start"]
                        and temp["end"] - temp["start"] >= MIN_SEED_LEN
                    ):
                        mem.append(dict(temp))
                        temp = dict(ik)
                    else:
                        temp = dict(ik)
                    break
        i += 1
        # skip intervals that cannot produce a long-enough seed
        if i < len(curr):
            max_len = temp["start"] + curr[i]["end"]
            while max_len < MIN_SEED_LEN and i < len(curr):
                i += 1
                if i < len(curr):
                    stop = curr[i]["end"]
                max_len = temp["start"] + stop
        if i >= len(curr) and temp["end"] - temp["start"] >= MIN_SEED_LEN:
            mem.append(dict(temp))
    return ret


def seed_strategy1(
    fm: RefIndex, seq: np.ndarray, x: int, min_len: int, max_intv: int
):
    """3rd-pass LAST-like seed: first extension whose interval drops below
    max_intv after min_len bases.  Returns (next_x, interval or None)."""
    ln = len(seq)
    if seq[x] > 3:
        return x + 1, None
    x0, x1, s = fm.set_intv(int(seq[x]))
    ik = (x0, x1, s)
    for i in range(x + 1, ln):
        if seq[i] < 4:
            c = 3 - int(seq[i])
            ok = fm.extend(ik, 0)
            if ok[c][2] < max_intv and i - x >= min_len:
                iv = _iv(ok[c][0], ok[c][1], ok[c][2], x, i + 1)
                return i + 1, iv
            ik = (ok[c][0], ok[c][1], ok[c][2])
        else:
            return i + 1, None
    return ln, None


def mem_collect_intv(
    fm: RefIndex, seq: np.ndarray,
    params: SmemParams = DEFAULT_SMEM_PARAMS,
) -> List[Dict]:
    """3-pass SMEM collection (mem_collect_intv_new)."""
    seq = np.asarray(seq)
    ln = len(seq)
    mem: List[Dict] = []
    # pass 1: all SMEMs
    x = 0
    while x < ln:
        if seq[x] < 4:
            x = smem1a_fwdback(fm, seq, x, 1, mem, params)
        else:
            x += 1
    # pass 2: re-seed long low-occurrence SMEMs from their midpoint
    old_n = len(mem)
    for k in range(old_n):
        p = mem[k]
        if p["end"] - p["start"] < params.split_len or p["s"] > params.split_width:
            continue
        smem1a_fwdback(fm, seq, (p["start"] + p["end"]) >> 1, p["s"] + 1, mem,
                       params)
    # pass 3: LAST-like
    x = 0
    while x < ln:
        if seq[x] < 4:
            x, iv = seed_strategy1(
                fm, seq, x, params.min_seed_len, params.max_mem_intv
            )
            if iv is not None and iv["s"] > 0:
                mem.append(iv)
        else:
            x += 1
    return mem
