"""BWA-SW serialized task/result record formats.

The reference's bwa-sw host program consumes binary dumps of (read, chain,
seed) records and compares against 5-int result records
(bwa-sw/sdaccel/main_cl.cpp:74-90 record walk, smithwaterman.cpp:276-510
``data_parse`` field semantics, 666-671 result packing).  This module
reads and writes those exact int32 layouts so dumps produced for the
reference run here unchanged.

Task file (little-endian int32 stream), per read record:

  [next_idx]                     absolute word index of the NEXT record
  [read_len]
  (read_len+7)/8 words           read bases, 4 bits each, MSB-first
                                 nibbles (smithwaterman.cpp:716-719)
  [chain_num]
  per chain:
    [rmax0_lo][rmax0_hi]         64-bit chain reference-span begin
    [rmax1_lo][rmax1_hi]         64-bit chain reference-span end
    [seed_num]
    per seed:
      [seed_index][rbeg_lo][rbeg_hi][qbeg][len]

Result file, 5 int32 words per task (smithwaterman.cpp:666-671):

  [seed_index]
  [qBeg & 0xFFFF | qEnd << 16]   16-bit two's-complement fields
  [rBeg & 0xFFFF | rEnd << 16]
  [score & 0xFFFF | trueScore << 16]
  [width & 0xFFFF]
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class Seed:
    index: int
    rbeg: int  # absolute reference coordinate
    qbeg: int
    length: int


@dataclasses.dataclass
class Chain:
    rmax0: int  # reference span [rmax0, rmax1)
    rmax1: int
    seeds: List[Seed]


@dataclasses.dataclass
class ReadTask:
    read: np.ndarray  # nt4 codes
    chains: List[Chain]


def _pack_read_4bit(read: np.ndarray) -> np.ndarray:
    n = len(read)
    nw = (n + 7) // 8
    ext = np.zeros(nw * 8, np.uint32)
    ext[:n] = np.asarray(read, np.uint32) & 0xF
    shifts = 28 - 4 * np.arange(8, dtype=np.uint32)
    words = (ext.reshape(-1, 8) << shifts[None, :]).sum(axis=1, dtype=np.uint32)
    return words.view(np.int32)


def _unpack_read_4bit(words: np.ndarray, n: int) -> np.ndarray:
    shifts = 28 - 4 * np.arange(8, dtype=np.uint32)
    v = ((words.view(np.uint32)[:, None] >> shifts[None, :]) & 0xF).reshape(-1)
    return v[:n].astype(np.uint8)


def write_task_file(path: str, tasks: List[ReadTask]) -> None:
    out: List[int] = []
    for t in tasks:
        rec: List[int] = []
        rec.append(len(t.read))
        rec.extend(int(w) for w in _pack_read_4bit(t.read))
        rec.append(len(t.chains))
        for ch in t.chains:
            rec.extend(
                [
                    ch.rmax0 & 0xFFFFFFFF, (ch.rmax0 >> 32) & 0xFFFFFFFF,
                    ch.rmax1 & 0xFFFFFFFF, (ch.rmax1 >> 32) & 0xFFFFFFFF,
                ]
            )
            rec.append(len(ch.seeds))
            for s in ch.seeds:
                rec.extend(
                    [
                        s.index,
                        s.rbeg & 0xFFFFFFFF, (s.rbeg >> 32) & 0xFFFFFFFF,
                        s.qbeg, s.length,
                    ]
                )
        next_idx = len(out) + 1 + len(rec)
        out.append(next_idx)
        out.extend(rec)
    arr = np.array(out, np.int64)
    arr32 = (arr & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    with open(path, "wb") as f:
        arr32.tofile(f)


def read_task_file(path: str) -> List[ReadTask]:
    with open(path, "rb") as f:
        a = np.fromfile(f, "<i4")
    au = a.view(np.uint32)
    tasks: List[ReadTask] = []
    k = 0
    size = len(a)
    while k < size:
        k += 1  # next_idx (validated by total walk)
        read_len = int(a[k]); k += 1
        nw = (read_len + 7) // 8
        read = _unpack_read_4bit(a[k : k + nw], read_len)
        k += nw
        chain_num = int(a[k]); k += 1
        chains: List[Chain] = []
        for _ in range(chain_num):
            rmax0 = int(au[k]) | (int(au[k + 1]) << 32)
            rmax1 = int(au[k + 2]) | (int(au[k + 3]) << 32)
            k += 4
            seed_num = int(a[k]); k += 1
            seeds: List[Seed] = []
            for _ in range(seed_num):
                idx = int(a[k])
                rbeg = int(au[k + 1]) | (int(au[k + 2]) << 32)
                qbeg = int(a[k + 3])
                slen = int(a[k + 4])
                k += 5
                seeds.append(Seed(idx, rbeg, qbeg, slen))
            chains.append(Chain(rmax0, rmax1, seeds))
        tasks.append(ReadTask(read, chains))
    return tasks


def count_tasks(path: str) -> int:
    """Total seed count, by the reference's record walk (main_cl.cpp:74-90)."""
    return sum(len(c.seeds) for t in read_task_file(path) for c in t.chains)


def _s16(v: int) -> int:
    v &= 0xFFFF
    return v - 0x10000 if v & 0x8000 else v


def write_results(path: str, results: List[dict]) -> None:
    """results: dicts with seed_index,qBeg,qEnd,rBeg,rEnd,score,trueScore,width."""
    out = np.zeros((len(results), 5), np.int32)
    for j, r in enumerate(results):
        w1 = (r["qBeg"] & 0xFFFF) | ((r["qEnd"] & 0xFFFF) << 16)
        w2 = (r["rBeg"] & 0xFFFF) | ((r["rEnd"] & 0xFFFF) << 16)
        w3 = (r["score"] & 0xFFFF) | ((r["trueScore"] & 0xFFFF) << 16)
        out[j] = [
            r["seed_index"],
            w1 - 0x100000000 if w1 & 0x80000000 else w1,
            w2 - 0x100000000 if w2 & 0x80000000 else w2,
            w3 - 0x100000000 if w3 & 0x80000000 else w3,
            r["width"] & 0xFFFF,
        ]
    with open(path, "wb") as f:
        out.astype("<i4").tofile(f)


def read_results(path: str) -> List[dict]:
    with open(path, "rb") as f:
        a = np.fromfile(f, "<i4").reshape(-1, 5)
    au = a.view(np.uint32)
    out = []
    for j in range(len(a)):
        out.append(
            dict(
                seed_index=int(a[j, 0]),
                qBeg=_s16(int(au[j, 1]) & 0xFFFF),
                qEnd=_s16(int(au[j, 1]) >> 16),
                rBeg=_s16(int(au[j, 2]) & 0xFFFF),
                rEnd=_s16(int(au[j, 2]) >> 16),
                score=_s16(int(au[j, 3]) & 0xFFFF),
                trueScore=_s16(int(au[j, 3]) >> 16),
                width=_s16(int(au[j, 4]) & 0xFFFF),
            )
        )
    return out


def run_tasks(engine, genome: np.ndarray, tasks: List[ReadTask]) -> List[dict]:
    """Execute a task file against the extension engine.

    genome: forward nt4 reference (the pac analog, preloaded once like
    BWAOCLEnv).  Returns result dicts in task order with absolute
    coordinates resolved the way seed_proc does (left/right extension
    around each seed within its chain's rmax span)."""
    seeds = []
    metas = []
    for t in tasks:
        for ch in t.chains:
            rseq = np.asarray(genome[ch.rmax0 : ch.rmax1], np.uint8)
            for s in ch.seeds:
                seeds.append(
                    dict(
                        read=t.read,
                        rseq=rseq,
                        qbeg=s.qbeg,
                        rbeg_off=s.rbeg - ch.rmax0,
                        len=s.length,
                    )
                )
                metas.append(s.index)
    res = engine.extend_seeds(seeds) if seeds else []
    out = []
    for idx, r in zip(metas, res):
        rec = dict(seed_index=idx)
        rec.update(r)
        out.append(rec)
    return out
