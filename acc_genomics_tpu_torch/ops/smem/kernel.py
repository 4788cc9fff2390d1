"""BWA-MEM SMEM collection: the CUDA kernel's wrapper and its plain PyTorch
twin.

Counterpart of the JAX package's ``ops/smem/machine.py``
(``smem_collect_machine``, single-read lanes).  Contract of both versions:

  seq (L, B)        uint8 base codes, time-major, 4 = N (pads too)
  lens (B,)         int32 read lengths (at most L)
  index             a ``table.DeviceIndex`` on the tensors' device
  ->
  mem (5, mem_cap, B) int32   intervals x0, x1, s, start, end in the
                              oracle's push order: pass 1, then pass 2,
                              then pass 3; rows past a read's count are 0
  mem_n (B,) int32            intervals written
  flag (B,) int32             1 where a read pushed past ``chain_cap``
                              forward or backward break intervals or past
                              ``mem_cap`` intervals: it stopped at that
                              push and must be rerun (at wider caps, or
                              on the host)
  probes (B,) int32           FM-index extensions (two occ probes each)

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches csrc/smem_collect.cu on the current stream and adds one to
``LAUNCHES["smem_collect"]``.  Tensors on mixed devices raise.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Dict, Tuple

import torch

from acc_genomics_tpu_torch import build
from acc_genomics_tpu_torch.device import check_tensor, same_device
from acc_genomics_tpu_torch.ops.smem.table import DeviceIndex
from acc_genomics_tpu_torch.ops.smem.reference import DEFAULT_SMEM_PARAMS, SmemParams

# kChainMax of csrc/smem_collect.cu: the largest chain cap, the one whose
# chains and reads of 256 fit a 32-lane block's shared memory
CHAIN_MAX = 250
# kBlockSmem of csrc/smem_collect.cu, the dynamic shared memory a block
# may take on sm_90: per lane, 7 int32 chain rows a cap and the read's L
# bytes
BLOCK_SMEM = 227 * 1024

# kernel launches per wrapper (CUDA tensors only); callers reset with clear()
LAUNCHES: collections.Counter = collections.Counter()

_SOURCES = ("ops/smem/csrc/smem_collect.cu",)
_P = ctypes.c_void_p
_I = ctypes.c_int

# states of the plain version's machine (the JAX machine's numbering;
# its retired states 4 and 5 are folded into their neighbours there too)
S_P1_NEXTX, S_FWD, S_BSTART, S_BACK = 0, 1, 2, 3
S_FWDE_M, S_SKIP, S_P2_NEXT, S_P3_NEXTX, S_P3_EXT, S_DONE = 6, 7, 8, 9, 10, 11


def build_kernels() -> Dict[str, build.BuiltLibrary]:
    """Build (at first use) and load the SMEM library, with the C entry
    point's argument types set."""
    built = build.load_library("smem_collect", _SOURCES)
    fn = built.lib.smem_collect
    if fn.argtypes is None:
        fn.argtypes = [_P] + [_I] * 6 + [_P] * 2 + [_I] * 9 + [_P] * 6
        fn.restype = ctypes.c_int
    return {"smem_collect": built}


def caps(params: SmemParams, L: int) -> Tuple[int, int]:
    """(chain_cap, mem_cap) of a launch at read width L: the parameters'
    curr_cap, at most ``chain_room(L)`` (past it raises: the chains would
    not fit a block, and the entry point refuses them too), and mem_cap
    within max_intv_alloc."""
    room = chain_room(L)
    if params.curr_cap > room:
        raise ValueError(f"curr_cap {params.curr_cap} > {room}, the most a block holds "
                         f"beside reads of {L} (CHAIN_MAX {CHAIN_MAX})")
    return (max(1, params.curr_cap), max(1, min(params.mem_cap, params.max_intv_alloc)))


def chain_room(L: int) -> int:
    """The largest chain cap a 32-lane block holds beside reads of width
    L: CHAIN_MAX up to L = 256, less past it (0 where no chain fits)."""
    return max(0, min(CHAIN_MAX, (BLOCK_SMEM // 32 - L) // 28))


# -- plain PyTorch version ---------------------------------------------------


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _occ4(index: DeviceIndex, k: torch.Tensor) -> torch.Tensor:
    """(N, 4) counts of each base among the first k + 1 BWT rows (int64);
    zeros where k < 0.  One table row per position, masked popcount."""
    kk = torch.clamp(k - (k >= index.primary).long(), min=0)
    row = index.tbl.index_select(0, kk >> 6).long()
    off = (kk & 63)[:, None]
    words = row[:, 4:] & 0xFFFFFFFF
    m_idx = torch.arange(4, device=k.device)[None, :]
    keep = torch.clamp(off + 1 - 16 * m_idx, 0, 16)
    mask = torch.where(keep == 0, 0, (0xFFFFFFFF << (32 - 2 * keep)) & 0xFFFFFFFF)
    cnt = []
    for c in range(4):
        nx = ~(words ^ (0x55555555 * c)) & 0xFFFFFFFF
        y = nx & (nx >> 1) & 0x55555555 & mask
        cnt.append(row[:, c] + _popcount32(y).sum(1))
    return torch.where((k >= 0)[:, None], torch.stack(cnt, 1), 0)


def _extend(index, l2, x0, x1, s, is_back):
    """bwt_extend for all four bases, per-lane direction: (o0, o1, osz),
    each (B, 4)."""
    xf = torch.where(is_back, x0, x1)
    xo = torch.where(is_back, x1, x0)
    bsz = xf.shape[0]
    occ = _occ4(index, torch.cat([xf - 1, xf - 1 + s]))
    tk, tl = occ[:bsz], occ[bsz:]
    oks = tl - tk
    coord = l2[None, :4] + 1 + tk
    span = ((xf <= index.primary) & (xf + s - 1 >= index.primary)).long()
    # suffix-inclusive sums in complement order T, G, C, A
    suff = oks.flip(1).cumsum(1).flip(1)
    oth = (xo + span)[:, None] + suff - oks
    ib = is_back[:, None]
    return torch.where(ib, coord, oth), torch.where(ib, oth, coord), oks


def _pick(c, arr4):
    return arr4.gather(1, c.clamp(0, 3)[:, None])[:, 0]


def smem_collect_plain(index: DeviceIndex, seq, lens,
                       params: SmemParams = DEFAULT_SMEM_PARAMS):
    """The JAX machine's single-read transitions, vectorised over reads:
    every step takes one FM-index extension (two occ probes) for every
    read, whatever its pass and stage, then one masked transition.  The
    chains and the output are (rows + 1, B) planes read and written one
    row a read by gather and scatter (the last row takes the writes of
    reads that write nothing).  A read that pushes past a cap is flagged
    and parks at that push, as the kernel's thread stops."""
    min_seed, split_len = params.min_seed_len, params.split_len
    split_width, max_mem_intv = params.split_width, params.max_mem_intv
    L, bsz = seq.shape
    chain_cap, mem_cap = caps(params, L)
    dev = seq.device
    i64 = torch.int64
    seq = seq.long()
    ln = lens.long().clamp(0, L)
    l2 = index.l2.long()
    zb = torch.zeros(bsz, dtype=i64, device=dev)
    false = torch.zeros(bsz, dtype=torch.bool, device=dev)

    def planes(k, rows):
        return [torch.zeros((rows + 1, bsz), dtype=i64, device=dev) for _ in range(k)]

    cu = planes(4, chain_cap)  # x0, x1, s, end
    bk = planes(5, chain_cap)  # x0, x1, s, start, end
    mm = planes(5, mem_cap)
    s = dict(st=torch.where(ln > 0, S_P1_NEXTX, S_DONE).long(),
             mode=zb + 1, min_intv=zb + 1, skip_first=false, bust=false)
    for key in ("x", "i", "ic", "k", "m", "p2_k", "p2_old_n", "curr_n", "back_n",
                "mem_n", "start", "stop", "ret", "ik0", "ik1", "iks", "ikst",
                "iken", "t0", "t1", "t2", "t3", "t4", "probes"):
        s[key] = zb
    lanes = torch.arange(bsz, device=dev)

    def read(plane, row):
        rows = plane.shape[0] - 1
        got = plane.gather(0, row.clamp(0, rows - 1)[None])[0]
        return torch.where((row >= 0) & (row < rows), got, 0)

    def write(plane, row, val, mask):
        rows = plane.shape[0] - 1
        plane[torch.where(mask, row.clamp(0, rows - 1), rows), lanes] = val

    def seq_at(pos):
        got = seq.gather(0, pos.clamp(0, L - 1)[None])[0]
        return torch.where((pos >= 0) & (pos < ln), got, 4)

    # a guard against a machine that never ends: a trinucleotide repeat of
    # 150 takes ~20k extensions at chain caps past its length
    max_steps = (64 + 4 * chain_cap) * L + 4096
    step = 0
    while True:
        if step % 8 == 0 and not bool((s["st"] != S_DONE).any()):
            break
        if step > max_steps:
            raise RuntimeError(f"SMEM machine still running after {max_steps} steps")
        step += 1
        st = s["st"]
        is_p1x, is_p2 = st == S_P1_NEXTX, st == S_P2_NEXT
        is_fwd, is_bst, is_bck = st == S_FWD, st == S_BSTART, st == S_BACK
        is_fem, is_skp = st == S_FWDE_M, st == S_SKIP
        is_p3x, is_p3e = st == S_P3_NEXTX, st == S_P3_EXT

        # -- reads of the chains and the output (before any write) ----------
        # BACK reads curr[ic + 1]: its stop step needs the next end
        curr_row = torch.where(is_bck, s["ic"] + 1, s["ic"])
        c_x0, c_x1, c_s, c_end = (read(p, curr_row) for p in cu)
        b_row = torch.where(is_bst | is_skp, s["back_n"] - 1,
                            torch.where(is_fem, s["k"] - 1, s["k"]))
        b_x0, b_x1, b_s, b_st, b_en = (read(p, b_row) for p in bk)
        p_s, p_st, p_en = (read(p, s["p2_k"]) for p in mm[2:])
        mid = (p_st + p_en) >> 1

        pos = torch.where(is_fwd | is_p3e, s["i"], s["x"])
        pos = torch.where(is_bck, s["k"], pos)
        pos = torch.where(is_fem, s["m"] - 1, pos)
        pos = torch.where(is_p2, mid, pos)
        rd = seq_at(pos)
        rd_is_base = rd < 4

        # -- the one extension of every read ---------------------------------
        o0, o1, osz = _extend(index, l2, s["ik0"], s["ik1"], s["iks"], is_bck)
        c_fwd = 3 - rd
        oc0f, oc1f, ocsf = _pick(c_fwd, o0), _pick(c_fwd, o1), _pick(c_fwd, osz)
        oc0b, oc1b, ocsb = _pick(rd, o0), _pick(rd, o1), _pick(rd, osz)
        rdc = rd.clamp(0, 3)
        ix0 = l2[rdc] + 1
        ix1 = l2[3 - rdc] + 1
        isz = l2[rdc + 1] - l2[rdc]

        n = dict(s)
        bust = false

        def upd(key, mask, val):
            n[key] = torch.where(mask, val, n[key])

        # -- S_P1_NEXTX -------------------------------------------------------
        p1_done = is_p1x & (s["x"] >= ln)
        p1_enter = is_p1x & (s["x"] < ln) & rd_is_base
        p1_step = is_p1x & (s["x"] < ln) & ~rd_is_base
        upd("st", p1_done, S_P2_NEXT)
        upd("p2_old_n", p1_done, s["mem_n"])
        upd("p2_k", p1_done, zb)
        upd("st", p1_enter, S_FWD)
        upd("min_intv", p1_enter, 1)
        upd("mode", p1_enter, 1)
        upd("x", p1_step, s["x"] + 1)

        # -- S_P2_NEXT: re-seed long low-occurrence SMEMs from midpoints -----
        p2_done = is_p2 & (s["p2_k"] >= s["p2_old_n"])
        p2_live = is_p2 & (s["p2_k"] < s["p2_old_n"])
        qual = (p_en - p_st >= split_len) & (p_s <= split_width)
        p2_enter = p2_live & qual & rd_is_base  # rd = seq[mid]
        p2_step = p2_live & ~(qual & rd_is_base)
        upd("st", p2_done, S_P3_NEXTX)
        for key in ("x", "i", "ik0", "ik1", "iks"):
            upd(key, p2_done, zb)
        upd("st", p2_enter, S_FWD)
        upd("x", p2_enter, mid)
        upd("min_intv", p2_enter, p_s + 1)
        upd("mode", p2_enter, 2)
        upd("p2_k", p2_enter | p2_step, s["p2_k"] + 1)
        enter = p1_enter | p2_enter
        new_x = torch.where(p2_enter, mid, s["x"])
        upd("i", enter, new_x + 1)
        upd("curr_n", enter, zb)
        upd("back_n", enter, zb)
        upd("ik0", enter, ix0)
        upd("ik1", enter, ix1)
        upd("iks", enter, isz)
        upd("ikst", enter, zb)
        upd("iken", enter, new_x + 1)
        upd("start", enter, new_x)
        upd("stop", enter, new_x)

        # -- S_FWD: forward extension collecting break intervals -------------
        fwd_end = is_fwd & ((s["i"] >= ln) | ~rd_is_base)
        fwd_ext = is_fwd & (s["i"] < ln) & rd_is_base
        changed = ocsf != s["iks"]
        fwd_brk = fwd_ext & changed & (ocsf < s["min_intv"])
        fwd_go = fwd_ext & ~fwd_brk
        push = fwd_end | (fwd_ext & changed)
        over = push & (s["curr_n"] >= chain_cap)
        bust = bust | over
        for p, v in zip(cu, (s["ik0"], s["ik1"], s["iks"], s["iken"])):
            write(p, s["curr_n"], v, push & ~over)
        upd("curr_n", push, s["curr_n"] + 1)
        upd("ret", push, s["iken"])
        upd("ik0", fwd_go, oc0f)
        upd("ik1", fwd_go, oc1f)
        upd("iks", fwd_go, ocsf)
        upd("iken", fwd_go, s["i"] + 1)
        upd("i", fwd_go, s["i"] + 1)
        to_back = fwd_end | fwd_brk
        upd("st", to_back, S_BSTART)
        upd("ic", to_back, zb)

        # -- S_SKIP masks (its exits run BSTART's work on the same step) -----
        skp_done = is_skp & (s["ic"] >= s["curr_n"])
        skp_live = is_skp & ~skp_done
        skp_more = skp_live & (s["t3"] + c_end < min_seed)
        skp_exit = skp_live & ~skp_more
        stop_eff = torch.where(is_skp & ~s["skip_first"], c_end, s["stop"])

        # -- S_BSTART: backenlarge or forwardenlarge for interval ic ---------
        bst_any = is_bst | skp_exit
        use_back = (s["back_n"] == 0) | (stop_eff - s["start"] >= 3)
        bst_back = bst_any & use_back
        bst_fwde = bst_any & ~use_back
        upd("ik0", bst_any, torch.where(bst_fwde, b_x0, c_x0))
        upd("ik1", bst_any, torch.where(bst_fwde, b_x1, c_x1))
        upd("iks", bst_any, torch.where(bst_fwde, b_s, c_s))
        upd("ikst", bst_any, torch.where(bst_fwde, b_st, s["x"]))
        upd("iken", bst_any, torch.where(bst_fwde, b_en, c_end))
        upd("back_n", bst_back, zb + 1)
        upd("k", bst_back, s["x"] - 1)
        upd("st", bst_back, S_BACK)
        upd("stop", bst_fwde, c_end)
        upd("k", bst_fwde, s["back_n"] - 1)
        upd("m", bst_fwde, s["start"] + 1)
        upd("st", bst_fwde, S_FWDE_M)

        # -- S_BACK: the backward chain; its stop step closes the interval ---
        can = rd_is_base & (s["k"] >= 0) & (ocsb >= s["min_intv"])
        bck_ok = is_bck & can
        bck_stop = is_bck & ~can
        upd("ik0", bck_ok, oc0b)
        upd("ik1", bck_ok, oc1b)
        upd("iks", bck_ok, ocsb)
        upd("ikst", bck_ok, s["k"])
        over = bck_ok & (s["back_n"] >= chain_cap)
        bust = bust | over
        bk_row = torch.where(bst_back, zb, s["back_n"])
        bk_vals = ((c_x0, oc0b), (c_x1, oc1b), (c_s, ocsb), (s["x"], s["k"]),
                   (c_end, s["iken"]))
        for p, (a, b) in zip(bk, bk_vals):
            write(p, bk_row, torch.where(bst_back, a, b), (bst_back | bck_ok) & ~over)
        upd("back_n", bck_ok, s["back_n"] + 1)
        upd("k", bck_ok, s["k"] - 1)
        upd("start", bck_stop, s["iken"])
        upd("stop", bck_stop, torch.where(s["ic"] < s["curr_n"] - 1, c_end, ln))
        t_len = s["t4"] - s["t3"]
        bpo_push = bck_stop & (s["ic"] > 0) & (s["ikst"] > s["t3"]) & (t_len >= min_seed)
        for tk, ik in (("t0", "ik0"), ("t1", "ik1"), ("t2", "iks"),
                       ("t3", "ikst"), ("t4", "iken")):
            upd(tk, bck_stop, s[ik])
        upd("ic", bck_stop, s["ic"] + 1)
        upd("skip_first", bck_stop, True)
        upd("st", bck_stop, S_SKIP)

        # -- S_FWDE_M: forwardenlarge's inner loop ---------------------------
        fem_fail = is_fem & (ocsf < s["min_intv"])
        fem_ok = is_fem & ~(ocsf < s["min_intv"])
        at_stop = fem_ok & (s["m"] == s["stop"])
        fail_go = fem_fail & (s["k"] >= 1)
        fail_done = fem_fail & (s["k"] < 1)
        upd("k", fail_go, s["k"] - 1)
        upd("ik0", fail_go, b_x0)
        upd("ik1", fail_go, b_x1)
        upd("iks", fail_go, b_s)
        upd("ikst", fail_go, b_st)
        upd("iken", fail_go, b_en)
        upd("m", fail_go, s["start"] + 1)
        upd("ic", fail_done, s["ic"] + 1)
        upd("skip_first", fail_done, True)
        upd("st", fail_done, S_SKIP)
        upd("ik0", fem_ok, oc0f)
        upd("ik1", fem_ok, oc1f)
        upd("iks", fem_ok, ocsf)
        upd("m", fem_ok & ~at_stop, s["m"] + 1)
        nw_st = s["x"] - s["k"]
        upd("ikst", at_stop, nw_st)
        upd("iken", at_stop, s["stop"])
        fem_push = at_stop & (nw_st > s["t3"]) & (t_len >= min_seed)
        upd("t0", at_stop, oc0f)
        upd("t1", at_stop, oc1f)
        upd("t2", at_stop, ocsf)
        upd("t3", at_stop, nw_st)
        upd("t4", at_stop, s["stop"])
        upd("ic", at_stop, s["ic"] + 1)
        upd("skip_first", at_stop, True)
        upd("st", at_stop, S_SKIP)

        # -- S_SKIP: skip intervals that cannot give a long enough seed ------
        fin_push = skp_done & (t_len >= min_seed)
        back_p1 = skp_done & (s["mode"] == 1)
        upd("x", back_p1, s["ret"])
        upd("st", back_p1, S_P1_NEXTX)
        upd("st", skp_done & (s["mode"] == 2), S_P2_NEXT)
        upd("stop", skp_live & ~s["skip_first"], c_end)
        upd("ic", skp_more, s["ic"] + 1)
        upd("skip_first", skp_more, False)

        # -- S_P3_NEXTX / S_P3_EXT: the LAST-like scan -----------------------
        p3_done = is_p3x & (s["x"] >= ln)
        p3_enter = is_p3x & (s["x"] < ln) & rd_is_base
        upd("st", p3_done, S_DONE)
        upd("st", p3_enter, S_P3_EXT)
        upd("ik0", p3_enter, ix0)
        upd("ik1", p3_enter, ix1)
        upd("iks", p3_enter, isz)
        upd("i", p3_enter, s["x"] + 1)
        upd("x", is_p3x & (s["x"] < ln) & ~rd_is_base, s["x"] + 1)
        p3_out = is_p3e & (s["i"] >= ln)
        p3_n = is_p3e & (s["i"] < ln) & ~rd_is_base
        p3_base = is_p3e & (s["i"] < ln) & rd_is_base
        hit = p3_base & (ocsf < max_mem_intv) & (s["i"] - s["x"] >= min_seed)
        p3_go = p3_base & ~hit
        upd("x", p3_out, ln)
        upd("x", p3_n | hit, s["i"] + 1)
        upd("st", p3_out | p3_n | hit, S_P3_NEXTX)
        upd("ik0", p3_go, oc0f)
        upd("ik1", p3_go, oc1f)
        upd("iks", p3_go, ocsf)
        upd("i", p3_go, s["i"] + 1)
        p3_push = hit & (ocsf > 0)

        # -- the one output push (its sites are exclusive) --------------------
        push = bpo_push | fem_push | fin_push | p3_push
        over = push & (s["mem_n"] >= mem_cap)
        bust = bust | over
        vals = (torch.where(p3_push, oc0f, s["t0"]), torch.where(p3_push, oc1f, s["t1"]),
                torch.where(p3_push, ocsf, s["t2"]), torch.where(p3_push, s["x"], s["t3"]),
                torch.where(p3_push, s["i"] + 1, s["t4"]))
        for p, v in zip(mm, vals):
            write(p, s["mem_n"], v, push & ~over)
        upd("mem_n", push & ~over, s["mem_n"] + 1)

        probe = fwd_ext | (is_bck & rd_is_base & (s["k"] >= 0)) | is_fem | p3_base
        n["probes"] = s["probes"] + probe.long()
        n["bust"] = s["bust"] | bust
        upd("st", bust, S_DONE)
        s = n

    i32 = torch.int32
    mem = torch.stack([p[:mem_cap] for p in mm]).to(i32)
    return mem, s["mem_n"].to(i32), s["bust"].to(i32), s["probes"].to(i32)


# -- kernel wrapper ----------------------------------------------------------


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def smem_collect(index: DeviceIndex, seq, lens,
                 params: SmemParams = DEFAULT_SMEM_PARAMS):
    """(mem, mem_n, flag, probes) of a batch of reads (contract above)."""
    dev = same_device(index.tbl, index.l2, seq, lens)
    if dev.type == "cpu":
        return smem_collect_plain(index, seq, lens, params)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if seq.dim() != 2:
        raise ValueError("seq must be (L, B)")
    L, bsz = seq.shape
    if L == 0:
        raise ValueError("empty read bucket")
    check_tensor(seq, "seq", torch.uint8, (L, bsz))
    check_tensor(lens, "lens", torch.int32, (bsz,))
    check_tensor(index.tbl, "tbl", torch.int32, (index.tbl.shape[0], 8))
    chain_cap, mem_cap = caps(params, L)
    # one zeroed buffer: the intervals (rows past a read's count stay 0),
    # the counts, and the kernel's read queue
    n_mem = 5 * mem_cap * bsz
    buf = torch.zeros(n_mem + 3 * bsz + 1, dtype=torch.int32, device=dev)
    mem = buf[:n_mem].view(5, mem_cap, bsz)
    counts = buf[n_mem:n_mem + 3 * bsz].view(3, bsz)
    # the kernel's layout: read-major rows of a multiple of 16 bytes
    stride = -(-L // 16) * 16
    rows = seq.new_full((bsz, stride), 4)
    rows[:, :L] = seq.t()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = build_kernels()["smem_collect"].lib.smem_collect(
            _ptr(index.tbl), index.primary, *index.l2_values, _ptr(rows), _ptr(lens), L,
            stride, bsz,
            params.min_seed_len, params.split_len, params.split_width,
            params.max_mem_intv, chain_cap, mem_cap, _ptr(mem), _ptr(counts[0]),
            _ptr(counts[1]), _ptr(counts[2]), _ptr(buf[-1:]), ctypes.c_void_p(stream))
        LAUNCHES["smem_collect"] += 1
    if err != 0:
        raise RuntimeError(f"smem_collect: CUDA launch failed with error {err}")
    return mem, counts[0], counts[1], counts[2]
