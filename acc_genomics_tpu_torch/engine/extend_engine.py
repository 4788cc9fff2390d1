"""Single-card BWA-MEM seed-extension engine: left and right extension of
every seed, then the clip resolution.

The port of ``acc_genomics_tpu/engine/extend_engine.py`` on its
single-device route (the dependent two-step loop of the reference's
seed_proc, bwa-sw/sdaccel/smithwaterman.cpp:511-672, as two dense
batches):

* each direction's tasks group by (query, target) bucket on the engine's
  power-of-two ladders up to ``config.max_qlen`` / ``config.max_tlen``;
  a seed with either direction past the caps runs both directions on the
  native host engine, on a worker thread concurrent with the launches;
* every group of both directions is packed into one pinned buffer and
  goes up in one H2D copy; the left groups launch first, the right
  groups' ``h0`` (the left scores) is gathered on the card from the
  concatenated left results, so no result goes back to the host in
  between; all results come back in one D2H copy;
* ``extend_seeds`` resolves each seed's record against ``pen_clip``;
* with a ``mesh``, each launch's tasks run data-parallel over its "data"
  axis (``parallel/sharded_kernels.sw_extend_dp``).

On ``device="cpu"`` the same route runs the kernel's plain version.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from acc_genomics_tpu_torch.build import ensure_native
from acc_genomics_tpu_torch.device import resolve_device
from acc_genomics_tpu_torch.engine.packing import pack_tm
from acc_genomics_tpu_torch.ops.extend.kernel import KEYS, sw_extend_rows
from acc_genomics_tpu_torch import native
from acc_genomics_tpu_torch.config import ExtendConfig
from acc_genomics_tpu_torch.parallel.sharded_kernels import sw_extend_dp
from acc_genomics_tpu_torch.utils.timer import Timer


def _bucket_ladder(start: int, cap: int) -> Tuple[int, ...]:
    """Power-of-two ladder from start up to (and including) cap."""
    out = []
    b = start
    while b < cap:
        out.append(b)
        b *= 2
    out.append(cap)
    return tuple(out)


def resolve_seeds(seeds: Sequence[dict], lres: Dict[str, np.ndarray],
                  rres: Dict[str, np.ndarray], pen_clip: int) -> List[dict]:
    """Seed records from the left and right extension results (seed_proc's
    gscore-vs-clip resolution, smithwaterman.cpp:636-659), vectorised."""
    qb = np.array([s["qbeg"] for s in seeds], np.int64)
    rq_len = np.array([len(s["read"][s["qbeg"] + s["len"]:]) for s in seeds], np.int64)
    lsc, rsc = lres["score"], rres["score"]
    l_clip = (lres["gscore"] <= 0) | (lres["gscore"] <= lsc - pen_clip)
    q_beg = np.where(l_clip, qb - lres["qle"], 0)
    r_beg = np.where(l_clip, -lres["tle"], -lres["gtle"])
    true_l = np.where(l_clip, lsc, lres["gscore"])
    r_clip = (rres["gscore"] <= 0) | (rres["gscore"] <= rsc - pen_clip)
    q_end = np.where(r_clip, rres["qle"], rq_len)
    r_end = np.where(r_clip, rres["tle"], rres["gtle"])
    true_score = true_l + np.where(r_clip, rsc, rres["gscore"]) - lsc
    width = np.maximum(lres["w"], rres["w"])
    cols = (np.asarray(x).tolist() for x in (q_beg, q_end, r_beg, r_end, rsc,
                                              true_score, width))
    return [dict(qBeg=a, qEnd=b, rBeg=c, rEnd=d, score=e, trueScore=f, width=g)
            for a, b, c, d, e, f, g in zip(*cols)]


def seed_tasks(seeds: Sequence[dict]):
    """(left_q, left_t, right_q, right_t): the reversed left spans and the
    right spans of each seed, as views (no copies)."""
    lq, lt, rq, rt = [], [], [], []
    for s in seeds:
        read, rseq = s["read"], s["rseq"]
        qb, ro, sl = s["qbeg"], s["rbeg_off"], s["len"]
        lq.append(read[:qb][::-1])
        lt.append(rseq[:ro][::-1])
        rq.append(read[qb + sl:])
        rt.append(rseq[ro + sl:])
    return lq, lt, rq, rt


class ExtendEngine:
    """Extends seeds to alignment records, exact."""

    def __init__(self, config: ExtendConfig = ExtendConfig(), device="cuda", mesh=None):
        self.config = config
        self.device = resolve_device(device)
        self.mesh = mesh
        if not ensure_native():
            raise RuntimeError(
                "the native host library (acc_genomics_tpu_torch/native) is "
                "unavailable: the host fallback needs it"
            )
        self.q_buckets = _bucket_ladder(32, config.max_qlen)
        self.t_buckets = _bucket_ladder(64, config.max_tlen)
        self.params = config.params()
        self.stats = {"seeds": 0, "device_calls": 0, "host_fallback": 0}
        # the bytes each call moves over the link
        self.anatomy = dict(h2d_bytes=0, d2h_bytes=0)

    def reset_anatomy(self):
        for k in self.anatomy:
            self.anatomy[k] = 0

    def _buckets(self, qs, ts):
        """(bq, bt) bucket arrays of tasks; -1 where past the caps."""
        lens = lambda seqs: np.fromiter((len(x) for x in seqs), np.int64, len(seqs))
        ql, tl = np.maximum(lens(qs), 1), np.maximum(lens(ts), 1)
        qb, tb = np.asarray(self.q_buckets), np.asarray(self.t_buckets)
        over = (ql > qb[-1]) | (tl > tb[-1])
        bq = np.where(over, -1, qb[np.minimum(np.searchsorted(qb, ql), len(qb) - 1)])
        bt = np.where(over, -1, tb[np.minimum(np.searchsorted(tb, tl), len(tb) - 1)])
        return bq, bt

    def _extend(self, q, t, qlen, tlen, h0):
        """One launch: both caps at the query length, as the engine runs it."""
        if self.mesh is not None:
            return sw_extend_dp(self.mesh, q, t, qlen, tlen, h0, qlen, qlen, self.params)
        return sw_extend_rows(q, t, qlen, tlen, h0, qlen, qlen, self.params)

    def _host(self, lq, lt, h0l, rq, rt, idx, out_l, out_r):
        """Both directions of tasks ``idx`` on the native host engine."""
        h0s = [int(h0l[k]) for k in idx]
        hl = native.sw_extend_host([lq[k] for k in idx], [lt[k] for k in idx],
                                   h0s, self.params)
        hr = native.sw_extend_host([rq[k] for k in idx], [rt[k] for k in idx],
                                   [int(v) for v in hl["score"]], self.params)
        ia = np.asarray(idx, np.int64)
        for key in KEYS:
            out_l[key][ia] = hl[key]
            out_r[key][ia] = hr[key]

    def extend_both(self, lq, lt, h0l, rq, rt):
        """Left tasks (lq, lt, h0l), then right tasks (rq, rt) with h0 = the
        left score of the same index.  Returns (left, right): dicts of (n,)
        int64 arrays by ``KEYS``."""
        with Timer("extend.bucket"):
            n = len(lq)
            out_l = {k: np.zeros(n, np.int64) for k in KEYS}
            out_r = {k: np.zeros(n, np.int64) for k in KEYS}
            groups: List[Dict[Tuple[int, int], List[int]]] = []
            (lbq, lbt), (rbq, rbt) = self._buckets(lq, lt), self._buckets(rq, rt)
            host = (lbq < 0) | (rbq < 0)  # the host runs both directions
            host_idx = np.flatnonzero(host).tolist()
            for bq, bt in ((lbq, lbt), (rbq, rbt)):
                shapes = np.unique(np.stack([bq, bt], 1)[~host], axis=0).tolist()
                groups.append({(a, b): np.flatnonzero(~host & (bq == a) & (bt == b)).tolist()
                               for a, b in shapes})

            host_thread, host_err = None, []
            if host_idx:
                # the ctypes call releases the GIL: the host runs beside the card
                self.stats["host_fallback"] += len(host_idx)

                def host_work():
                    try:
                        with Timer("extend.host"):
                            self._host(lq, lt, h0l, rq, rt, host_idx, out_l, out_r)
                    except BaseException as e:  # re-raised after join
                        host_err.append(e)

                host_thread = threading.Thread(target=host_work)
                host_thread.start()

        with Timer("extend.pack"):
            # staged layout: every group's int32 (qlen, tlen, side) first,
            # then its uint8 query and target planes
            metas, i32_parts, u8_parts = [], [], []
            pos_l = np.zeros(n, np.int64)  # task -> column of the left results
            col_l = 0
            for d, (qs, ts) in enumerate(((lq, lt), (rq, rt))):
                for (bq, bt), idxs in groups[d].items():
                    m = len(idxs)
                    q_tm, qlen = pack_tm([qs[k] for k in idxs], bq, m)
                    t_tm, tlen = pack_tm([ts[k] for k in idxs], bt, m)
                    if d == 0:
                        side = np.fromiter((h0l[k] for k in idxs), np.int64, m)
                        pos_l[idxs] = col_l + np.arange(m)
                        col_l += m
                    else:
                        side = pos_l[idxs]  # index into the left scores
                    i32_parts += [qlen, tlen, side.astype(np.int32)]
                    u8_parts += [q_tm.reshape(-1), t_tm.reshape(-1)]
                    metas.append((d, idxs, bq, bt))
                    self.stats["device_calls"] += 1
            if metas:
                n32 = sum(len(p) for p in i32_parts)
                n8 = sum(len(p) for p in u8_parts)
                staged = torch.empty(4 * n32 + n8, dtype=torch.uint8,
                                     pin_memory=self.device.type == "cuda")
                hv = staged.numpy()
                hv[: 4 * n32].view(np.int32)[:] = np.concatenate(i32_parts)
                hv[4 * n32:] = np.concatenate(u8_parts)

        with Timer("extend.launch"):
            if metas:
                dev = staged.to(self.device, non_blocking=True)
                self.anatomy["h2d_bytes"] += staged.numel()
                d32 = dev[: 4 * n32].view(torch.int32)
                o32, o8 = 0, 4 * n32
                left, pending = [], []
                for d, idxs, bq, bt in metas:
                    m = len(idxs)
                    qlen, tlen, side = d32[o32: o32 + 3 * m].view(3, m)
                    o32 += 3 * m
                    q = dev[o8: o8 + bq * m].view(bq, m)
                    t = dev[o8 + bq * m: o8 + (bq + bt) * m].view(bt, m)
                    o8 += (bq + bt) * m
                    if d == 0:
                        left.append(self._extend(q, t, qlen, tlen, side))
                    else:
                        pending.append((q, t, qlen, tlen, side))
                scores_l = torch.cat([r[0] for r in left])
                right = [
                    self._extend(q, t, qlen, tlen, scores_l.index_select(0, side.long()))
                    for q, t, qlen, tlen, side in pending
                ]
                results = torch.cat(left + right, 1)

        # the one D2H copy waits for the card; then each group's columns
        with Timer("extend.fetch"):
            if metas:
                allres = results.cpu().numpy()
                self.anatomy["d2h_bytes"] += allres.nbytes
                col = 0
                for d, idxs, _, _ in metas:
                    tgt = out_l if d == 0 else out_r
                    ia = np.asarray(idxs, np.int64)
                    block = allres[:, col: col + len(idxs)]
                    col += len(idxs)
                    for r, key in enumerate(KEYS):
                        tgt[key][ia] = block[r]
        with Timer("extend.host_join"):
            if host_thread is not None:
                host_thread.join()
                if host_err:
                    raise host_err[0]
        return out_l, out_r

    def extend_seeds(self, seeds: Sequence[dict]) -> List[dict]:
        """Each seed: read, rseq, qbeg, rbeg_off, len -> resolved record
        (qBeg/qEnd/rBeg/rEnd/score/trueScore/width), seed_proc semantics."""
        self.stats["seeds"] += len(seeds)
        with Timer("extend.prep"):
            lq, lt, rq, rt = seed_tasks(seeds)
            h0 = [s["len"] for s in seeds]
        lres, rres = self.extend_both(lq, lt, h0, rq, rt)
        with Timer("extend.resolve"):
            return resolve_seeds(seeds, lres, rres, self.params.pen_clip)
