"""Single-card HTC Smith-Waterman engine: bucket -> fill and walk kernels
-> decode.

The port of ``acc_genomics_tpu/engine/sw_engine.py`` on its device route
(the redesign of the reference's FalconSWFPGA_run dispatch gate):

* pairs group by (bucket(reflen), bucket(altlen)) over
  ``config.seq_buckets`` and launch in chunks of at most
  ``config.max_batch`` pairs, fewer where a chunk's backtrack matrix would
  pass ``BTRACK_BUDGET_BYTES``;
* pairs with a sequence past the largest bucket, and pairs with an empty
  ref or alt, run on the native host engine, on a worker thread
  concurrent with the launches (an empty side aligns to ``([], 0)``, the
  JAX engine's answer on its XLA route);
* every chunk is packed, then every chunk launched, before anything is
  fetched, and the packed element buffers of all chunks come back in one
  D2H copy; the backtrack matrices never leave the card;
* pairs whose CIGAR overflows an element buffer rerun on the oracle;
* with a ``mesh``, each chunk's pairs run data-parallel over its "data"
  axis (``parallel/sharded_kernels.sw_device_dp``).

On ``device="cpu"`` the same route runs the kernels' plain versions.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from acc_genomics_tpu_torch.build import ensure_native
from acc_genomics_tpu_torch.device import resolve_device
from acc_genomics_tpu_torch.ops.sw.batch import (
    sw_align_batch_decode,
    sw_align_batch_launch,
    sw_align_batch_stage,
)
from acc_genomics_tpu_torch import native
from acc_genomics_tpu_torch.config import SWConfig
from acc_genomics_tpu_torch.ops.sw.reference import sw_align_oracle
from acc_genomics_tpu_torch.utils.timer import Timer

# Device bytes one chunk's int16 backtrack matrix may take: (rows + cols -
# 1) x rows codes a pair, 0.41 MB at 320 x 320 and 9.4 MB at 1536 x 1536,
# so a 1536-bucket chunk holds 455 pairs, not max_batch.
BTRACK_BUDGET_BYTES = 4 << 30


def chunk_pairs(rows: int, cols: int, max_batch: int) -> int:
    """Pairs per launch in a (rows, cols) bucket."""
    per_pair = 2 * rows * (rows + cols - 1)
    return max(1, min(int(max_batch), BTRACK_BUDGET_BYTES // per_pair))


class SWEngine:
    """Aligns (ref, alt) pairs: [(cigar, offset)] per pair, exact."""

    def __init__(self, config: SWConfig = SWConfig(), device="cuda", mesh=None):
        self.config = config
        self.device = resolve_device(device)
        self.mesh = mesh
        if not ensure_native():
            raise RuntimeError(
                "the native host library (acc_genomics_tpu_torch/native) is "
                "unavailable: the host fallback needs it"
            )
        self.params = config.params()
        self.stats = {"pairs": 0, "host_fallback": 0, "cells": 0}

    def _bucket(self, n: int) -> Optional[int]:
        for b in self.config.seq_buckets:
            if n <= b:
                return b
        return None

    def align(
        self,
        refs: Sequence[np.ndarray],
        alts: Sequence[np.ndarray],
        strategy: int,
    ) -> List[Tuple[list, int]]:
        """Batch alignment -> [(cigar, offset)] in input order."""
        with Timer("sw.group"):
            n = len(refs)
            self.stats["pairs"] += n
            out: List = [None] * n
            groups = {}
            host_idx = []
            for k, (r, a) in enumerate(zip(refs, alts)):
                br = self._bucket(len(r))
                ba = self._bucket(len(a))
                if br is None or ba is None or len(r) == 0 or len(a) == 0:
                    host_idx.append(k)
                    continue
                groups.setdefault((br, ba), []).append(k)

            host_thread, host_err = None, []
            if host_idx:
                # the native host engine on a worker thread, concurrent with
                # the launches below (the ctypes call releases the GIL)
                self.stats["host_fallback"] += len(host_idx)

                def host_work():
                    try:
                        with Timer("sw.host_align"):
                            walked = native.sw_align_host(
                                [refs[k] for k in host_idx], [alts[k] for k in host_idx],
                                strategy, self.params,
                                max_elems=max(self.config.max_seq_len, 1536),
                            )
                            for j, k in enumerate(host_idx):
                                res = walked[j]
                                if res is None:  # element overflow
                                    res = sw_align_oracle(
                                        refs[k], alts[k], strategy, params=self.params
                                    )
                                out[k] = res
                    except BaseException as e:  # re-raised after join
                        host_err.append(e)

                host_thread = threading.Thread(target=host_work)
                host_thread.start()

            chunks = []
            for (rows, cols), idxs in groups.items():
                seg = chunk_pairs(rows, cols, self.config.max_batch)
                for lo in range(0, len(idxs), seg):
                    part = idxs[lo : lo + seg]
                    chunks.append((rows, cols, part, [refs[k] for k in part],
                                   [alts[k] for k in part]))
        with Timer("sw.pack"):
            staged = [sw_align_batch_stage(grefs, galts, rows, cols, self.device.type == "cuda")
                      for rows, cols, _, grefs, galts in chunks]
        with Timer("sw.launch"):
            pend = []
            for (rows, cols, idxs, grefs, galts), st in zip(chunks, staged):
                launched = sw_align_batch_launch(
                    grefs, galts, strategy, rows, cols, self.device, self.params,
                    mesh=self.mesh, staged=st,
                )
                pend.append((idxs, grefs, galts, launched))
                self.stats["cells"] += sum(len(r) * len(a) for r, a in zip(grefs, galts))
        with Timer("sw.fetch"):
            allpacked = (torch.cat([p[3].packed for p in pend], 1).cpu().numpy()
                         if pend else None)
        with Timer("sw.decode"):
            col = 0
            for idxs, grefs, galts, _ in pend:
                walked = sw_align_batch_decode(
                    allpacked[:, col : col + len(idxs)], grefs, galts,
                    strategy, self.params,
                )
                col += len(idxs)
                for j, k in enumerate(idxs):
                    out[k] = walked[j]
        with Timer("sw.host_join"):
            if host_thread is not None:
                host_thread.join()
                if host_err:
                    raise host_err[0]
        return out

    def align_one_ref(self, ref: np.ndarray, alts: Sequence[np.ndarray], strategy: int):
        """SWPairwiseAlignmentMultiBatch analog: one ref vs many alts."""
        return self.align([ref] * len(alts), alts, strategy)
