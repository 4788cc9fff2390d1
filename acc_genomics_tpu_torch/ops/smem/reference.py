"""NumPy oracle for SMEM collection over the FM-index.

Implements the behavioural contract of the reference's restructured SMEM
search (smem/host/baseline.cpp):

* ``smem1a_fwdback`` — forward extension collecting break intervals,
  then per-interval backward "backenlarge" passes with a forward
  "forwardenlarge" shortcut when the previous backward chain can be
  reused (bwt_smem1a_new, baseline.cpp:180-304),
* ``seed_strategy1`` — the 3rd-pass LAST-like seeding
  (bwt_seed_strategy1, baseline.cpp:306-327),
* ``mem_collect_intv_oracle`` — the 3-pass production pipeline
  (mem_collect_intv_new, baseline.cpp:387-422): all SMEMs; re-seed of
  long low-occurrence SMEMs from their midpoint; LAST-like pass.

Intervals are dicts (x0, x1, s, start, end); ``info`` packing
(start<<32|end) is available via ``pack_info`` for wire parity.
Production parameters: min_seed_len 19, split_len 28, split_width 10,
max_mem_intv 20, max_intv 0 (smem/common/common.h, baseline.cpp:391-394).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np

from acc_genomics_tpu_torch.ops.smem.index import FMIndex


class SmemParams(NamedTuple):
    """Runtime SMEM options — the mem_opt_t analog
    (smem/host/host_types.h:9-47, baseline.cpp:391-394).  Hashable so the
    jitted state machine takes it as a static argument."""

    min_seed_len: int = 19
    split_len: int = 28
    split_width: int = 10
    max_mem_intv: int = 20
    max_intv_alloc: int = 256  # per-read output interval cap (MAX_INTV_ALLOC)
    # device-machine cap on the curr/back break-interval chains (rows of
    # the while-carry buffers, the dominant HBM cost); chains that
    # outgrow it flag the lane for host rerun.  Ignored by the oracle.
    curr_cap: int = 24
    # device-machine cap on the OUTPUT interval buffer rows carried
    # through the while loop.  Real reads produce ~6 intervals at 101 bp
    # (p99 == 6 measured at 100 Mbp, benchmarks/smem_probe_stats.py), so
    # carrying max_intv_alloc=256 rows paid 8x the masked-write cost for
    # nothing.  Lanes that push past the cap flag for host rerun — the
    # same graceful-degradation contract as interval overflow.  Ignored
    # by the oracle.
    mem_cap: int = 24


DEFAULT_SMEM_PARAMS = SmemParams()

MIN_SEED_LEN = DEFAULT_SMEM_PARAMS.min_seed_len
SPLIT_LEN = DEFAULT_SMEM_PARAMS.split_len
SPLIT_WIDTH = DEFAULT_SMEM_PARAMS.split_width
MAX_MEM_INTV = DEFAULT_SMEM_PARAMS.max_mem_intv


def pack_info(iv: Dict) -> int:
    return (int(iv["start"]) << 32) | int(iv["end"])


def _iv(x0, x1, s, start, end):
    return dict(x0=int(x0), x1=int(x1), s=int(s), start=int(start), end=int(end))


def smem1a_fwdback(
    fm: FMIndex, seq: np.ndarray, x: int, min_intv: int, mem: List[Dict],
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
    fm: FMIndex, seq: np.ndarray, x: int, min_len: int, max_intv: int
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


def mem_collect_intv_oracle(
    fm: FMIndex, seq: np.ndarray,
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


def smem_batch_oracle(
    fm: FMIndex, reads: List[np.ndarray],
    params: SmemParams = DEFAULT_SMEM_PARAMS,
) -> List[List[Dict]]:
    return [mem_collect_intv_oracle(fm, r, params) for r in reads]
