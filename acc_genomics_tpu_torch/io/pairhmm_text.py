"""Reference-format PairHMM corpus IO.

Reads/writes the text formats of the reference test programs so the same
corpora can be run through both frameworks:

* input%d  (GetInputs, pairhmm/xlnx/pairhmm_test.cpp:91-175):
    line 1: "<tag> <numReads> <tag> <numHaps>"
    per read: length line, a skipped line, then 5 value lines (bases as
    ASCII codes, q, i, d, c), each preceded by a skipped line
    after reads: one skipped line, then per hap: length line, a skipped
    line, and the bases as a raw character line.
* output%d (GetOutputs, pairhmm_test.cpp:177-195): per pair one decimal
  double and the same double as a raw int64 (bit pattern) — the int64 is
  authoritative.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from acc_genomics_tpu_torch.utils.convert import encode_bases


def read_pairhmm_input(path: str) -> Tuple[List[dict], List[np.ndarray]]:
    with open(path) as f:
        lines = f.read().splitlines()
    pos = 0
    header = lines[pos].split()
    pos += 1
    num_reads, num_haps = int(header[1]), int(header[3])
    reads = []
    for _ in range(num_reads):
        ln = int(lines[pos].split()[0])
        pos += 1
        fields = {}
        for key in ("bases", "q", "i", "d", "c"):
            pos += 1  # skipped line
            vals = [int(tok) for tok in lines[pos].split()[:ln]]
            fields[key] = vals
            pos += 1
        reads.append(
            dict(
                rs=encode_bases(bytes(fields["bases"])),
                q=np.array(fields["q"], np.uint8),
                i=np.array(fields["i"], np.uint8),
                d=np.array(fields["d"], np.uint8),
                c=np.array(fields["c"], np.uint8),
            )
        )
    pos += 1  # skipped line
    haps = []
    for _ in range(num_haps):
        ln = int(lines[pos].split()[0])
        pos += 1
        pos += 1  # skipped line
        haps.append(encode_bases(lines[pos][:ln]))
        pos += 1
    return reads, haps


def write_pairhmm_input(path: str, reads: List[dict], haps: List[np.ndarray]):
    from acc_genomics_tpu_torch.utils.convert import decode_bases

    out = [f"numReads {len(reads)} numHaplotypes {len(haps)}"]
    for r in reads:
        ln = len(r["rs"])
        out.append(str(ln))
        bases = decode_bases(r["rs"])
        out.append("bases:")
        out.append(" ".join(str(ord(ch)) for ch in bases))
        for key in ("q", "i", "d", "c"):
            out.append(f"{key}:")
            out.append(" ".join(str(int(v)) for v in r[key]))
    out.append("haps:")
    for h in haps:
        out.append(str(len(h)))
        out.append("bases:")
        out.append(decode_bases(h))
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


def read_pairhmm_output(path: str) -> np.ndarray:
    """Golden log-likelihoods; the raw-int64 token is authoritative."""
    toks = open(path).read().split()
    vals = []
    for k in range(0, len(toks) - 1, 2):
        vals.append(struct.unpack("<d", struct.pack("<q", int(toks[k + 1])))[0])
    return np.array(vals, np.float64)


def write_pairhmm_output(path: str, likelihoods: np.ndarray):
    with open(path, "w") as f:
        for v in likelihoods:
            bits = struct.unpack("<q", struct.pack("<d", float(v)))[0]
            f.write(f"{float(v):.17g} {bits}\n")
