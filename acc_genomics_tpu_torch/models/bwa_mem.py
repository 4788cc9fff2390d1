"""BWA-MEM seeding and extension composed on the host over the port's two
engines.

The port of ``acc_genomics_tpu/models/bwa_mem.py``'s ``BwaMemSeeding``
(which cannot be imported without JAX): SMEM intervals of every read
(``SmemEngine.collect``), then the seeds each interval names (its first
``max_occ`` suffix-array rows, in row order), each with its reference
span of the read's length plus ``flank`` on both sides, then left and
right extension of every seed in one call (``ExtendEngine.extend_seeds``).
Chaining and pairing stay with the caller.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence

import numpy as np


@dataclasses.dataclass
class SeedHit:
    read_id: int
    qbeg: int
    qend: int
    rbeg: int  # text coordinate of the alignment's start
    rend: int
    score: int
    true_score: int
    width: int
    occ: int  # occurrence count of the originating SMEM


class BwaEngines(NamedTuple):
    """The two engines ``BwaMemSeeding`` needs (any objects with
    ``collect`` and ``extend_seeds``; ``smem.fm`` is the index)."""

    smem: object
    extend: object


class BwaMemSeeding:
    def __init__(self, engine, max_occ: int = 8, flank: int = 100):
        """``engine``: anything with ``.smem`` and ``.extend`` (``BwaEngines``)."""
        self.engine = engine
        self.max_occ = max_occ
        self.flank = flank

    def _positions(self, fm, iv) -> np.ndarray:
        """Text positions of an interval's first ``max_occ`` occurrences."""
        return fm.sa[iv["x0"]: iv["x0"] + min(iv["s"], self.max_occ)]

    def map_reads(self, reads: Sequence[np.ndarray]) -> List[List[SeedHit]]:
        fm = self.engine.smem.fm
        intervals = self.engine.smem.collect(list(reads))
        tasks, meta = [], []
        text_len = fm.seq_len
        for rid, (read, ivs) in enumerate(zip(reads, intervals)):
            for iv in ivs:
                slen = iv["end"] - iv["start"]
                for pos in self._positions(fm, iv):
                    pos = int(pos)
                    span_lo = max(0, pos - iv["start"] - self.flank)
                    span_hi = min(text_len,
                                  pos + slen + (len(read) - iv["end"]) + self.flank)
                    tasks.append(dict(read=read, rseq=fm.text[span_lo:span_hi],
                                      qbeg=iv["start"], rbeg_off=pos - span_lo,
                                      len=slen))
                    meta.append((rid, iv, pos))
        results = self.engine.extend.extend_seeds(tasks) if tasks else []
        out: List[List[SeedHit]] = [[] for _ in reads]
        for (rid, iv, pos), res in zip(meta, results):
            out[rid].append(SeedHit(
                read_id=rid,
                qbeg=res["qBeg"],
                qend=iv["end"] + res["qEnd"],
                rbeg=pos + res["rBeg"],
                rend=pos + (iv["end"] - iv["start"]) + res["rEnd"],
                score=res["score"],
                true_score=res["trueScore"],
                width=res["width"],
                occ=iv["s"],
            ))
        return out
