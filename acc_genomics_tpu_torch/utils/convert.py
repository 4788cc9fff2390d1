"""Base-character encodings.

Two encodings exist in the reference and we keep both:

* PairHMM order  A=0 C=1 T=2 G=3 N=4  (ConvertChar,
  pairhmm/xlnx/host/host_type.h:123-143)
* BWA nt4 order  A=0 C=1 G=2 T=3 N>=4 (nst_nt4_table, used by smem/main.cpp)

``HAP_PAD`` marks padded haplotype columns; the PairHMM kernels emit a zero
match probability there so padded columns contribute nothing to the
likelihood (the dense-batch analog of the reference's variable-length
device loops).
"""

from __future__ import annotations

import numpy as np

BASE_A, BASE_C, BASE_T, BASE_G, BASE_N = 0, 1, 2, 3, 4
HAP_PAD = 5

_PAIRHMM_TABLE = np.full(256, BASE_N, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("T", 2), ("G", 3), ("N", 4)):
    _PAIRHMM_TABLE[ord(_ch)] = _code
    _PAIRHMM_TABLE[ord(_ch.lower())] = _code

_PAIRHMM_DECODE = np.frombuffer(b"ACTGN?", dtype=np.uint8).copy()

_NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _NT4_TABLE[ord(_ch)] = _code
    _NT4_TABLE[ord(_ch.lower())] = _code


def encode_bases(s) -> np.ndarray:
    """ASCII/str -> PairHMM codes (A0 C1 T2 G3 N4)."""
    if isinstance(s, str):
        s = s.encode()
    buf = np.frombuffer(bytes(s), dtype=np.uint8)
    return _PAIRHMM_TABLE[buf]


def decode_bases(codes) -> str:
    codes = np.asarray(codes, dtype=np.uint8)
    return _PAIRHMM_DECODE[np.minimum(codes, 5)].tobytes().decode()


def encode_nt4(s) -> np.ndarray:
    """ASCII/str -> nt4 codes (A0 C1 G2 T3, ambiguous 4)."""
    if isinstance(s, str):
        s = s.encode()
    buf = np.frombuffer(bytes(s), dtype=np.uint8)
    return _NT4_TABLE[buf]
