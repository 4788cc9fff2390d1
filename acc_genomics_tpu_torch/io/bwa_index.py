"""BWA on-disk index formats (.pac/.bwt/.sa/.ann/.amb) + FASTA.

The reference's SMEM driver leans on libbwa's ``bwa_idx_load``
(smem/main.cpp:434, smem/Makefile:37-38 links -lbwa) to obtain the
BWT/suffix array built by ``bwa index``.  This module provides that
interop without the C dependency: it reads and writes the BWA 0.7.x
byte formats, DESIGNED so an existing ``bwa index`` directory loads
straight into :class:`~acc_genomics_tpu_torch.ops.smem.index.FMIndex` and an
index built here can be consumed by stock BWA.

Validation status: the byte layouts are implemented from bwa 0.7.x
sources (bwt.c/bntseq.c, cited per format below) and validated by
writer<->reader round-trips plus the lrand48 LCG bit-parity test
(tests/test_bwa_index.py, on the JAX package's original; this copy writes
the same bytes, tests/test_torch_copies.py).  No file produced by an actual ``bwa
index`` binary has been loaded in this environment (bwa is not
installed and there is no network); treat cross-tool byte identity as
designed-for until a genuine bwa-built fixture is vendored.

Format notes (all little-endian, validated by round-trip tests):

* ``.pac``  — forward strand only, 2-bit packed, base ``i`` in byte
  ``i>>2`` at bit offset ``(~i & 3) << 1`` (MSB-first); if ``l % 4 == 0``
  an extra zero byte is appended, then one trailing byte holding
  ``l % 4`` (bntseq.c ``bns_fasta2bntseq``).
* ``.bwt``  — over the 2L text (forward + reverse complement):
  ``primary`` (u64), ``L2[1..4]`` (4×u64), then the occ-interleaved BWT:
  per 128-base block, 4×u64 cumulative counts followed by 2-bit packed
  words (16 bases per u32, MSB-first), plus one trailing count block
  (bwt.c ``bwt_bwtupdate_core`` / ``bwt_dump_bwt``).
* ``.sa``   — ``primary`` (u64), ``L2[1..4]``, ``sa_intv``, ``seq_len``,
  then ``sa[k]`` for ranks ``k = intv, 2*intv, ...`` (rank 0's entry is
  stored as ``(u64)-1``; its true value is ``seq_len``)
  (bwt.c ``bwt_dump_sa``).
* ``.ann`` / ``.amb`` — text: contig annotations and ambiguous-base
  holes (bntseq.c ``bns_dump``).

Ambiguous FASTA bases are replaced by ``lrand48() & 3`` with
``srand48(11)`` — the bit-compatible LCG BWA uses (verified against
the POSIX lrand48 definition in tests) — so the .pac produced here is
designed to be byte-identical to ``bwa index`` output for the same
FASTA.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from acc_genomics_tpu_torch.ops.smem.index import FMIndex

BWA_SEED = 11
SA_INTV_DEFAULT = 32
FILE_OCC_INTERVAL = 128  # BWA's OCC_INTERVAL (bwt.h), vs 64 in our layout

# nst_nt4_table semantics: ACGT -> 0..3 (case-insensitive), else 4
_NT4 = np.full(256, 4, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _NT4[_b] = _i
    _NT4[_b + 32] = _i
_NT4_CHR = np.frombuffer(b"ACGTN", np.uint8)


class _LRand48:
    """glibc lrand48: X' = (0x5DEECE66D*X + 0xB) mod 2^48, returns X'>>17."""

    def __init__(self, seed: int = BWA_SEED):
        self.x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def __call__(self) -> int:
        self.x = (0x5DEECE66D * self.x + 0xB) & 0xFFFFFFFFFFFF
        return self.x >> 17


@dataclasses.dataclass
class ContigAnn:
    name: str
    comment: str
    offset: int
    length: int
    n_ambs: int


@dataclasses.dataclass
class AmbHole:
    offset: int
    length: int
    base: str  # the ambiguity character, e.g. 'N'


@dataclasses.dataclass
class BwaAnnotations:
    """The bntseq_t analog: contig table + ambiguity holes."""

    l_pac: int
    seed: int
    contigs: List[ContigAnn]
    holes: List[AmbHole]

    def position_to_contig(self, pos: int) -> Tuple[int, int]:
        """(contig index, offset within contig) for a forward-pac position
        (bns_pos2rid analog)."""
        for j, c in enumerate(self.contigs):
            if c.offset <= pos < c.offset + c.length:
                return j, pos - c.offset
        raise ValueError(f"position {pos} outside all contigs")


# ---------------------------------------------------------------------------
# FASTA


def read_fasta(path: str) -> List[Tuple[str, str, np.ndarray]]:
    """[(name, comment, nt4 codes with 4 = ambiguous)] per contig."""
    out = []
    name, comment, chunks = None, "", []
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip()
            if line.startswith(b">"):
                if name is not None:
                    out.append((name, comment, _codes(chunks)))
                hdr = line[1:].split(None, 1)
                name = hdr[0].decode() if hdr else ""
                comment = hdr[1].decode() if len(hdr) > 1 else ""
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        out.append((name, comment, _codes(chunks)))
    return out


def _codes(chunks: List[bytes]) -> np.ndarray:
    raw = np.frombuffer(b"".join(chunks), np.uint8)
    return _NT4[raw]


def contigs_to_genome(
    contigs: Sequence[Tuple[str, str, np.ndarray]], seed: int = BWA_SEED
) -> Tuple[np.ndarray, BwaAnnotations]:
    """Concatenate contigs into one forward pac-style genome, replacing
    ambiguous bases via BWA's lrand48 stream and recording holes
    (bns_fasta2bntseq semantics: one lrand48 call per ambiguous base)."""
    rng = _LRand48(seed)
    anns: List[ContigAnn] = []
    holes: List[AmbHole] = []
    parts = []
    off = 0
    for name, comment, codes in contigs:
        codes = np.asarray(codes, np.uint8).copy()
        n_amb_in_contig = 0
        open_hole: Optional[AmbHole] = None
        for j in np.flatnonzero(codes >= 4):
            j = int(j)
            if open_hole is not None and open_hole.offset + open_hole.length == off + j:
                open_hole.length += 1
            else:
                open_hole = AmbHole(off + j, 1, "N")
                holes.append(open_hole)
                n_amb_in_contig += 1
            codes[j] = rng() & 3
        anns.append(ContigAnn(name, comment, off, len(codes), n_amb_in_contig))
        parts.append(codes)
        off += len(codes)
    genome = (
        np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    )
    return genome, BwaAnnotations(off, seed, anns, holes)


# ---------------------------------------------------------------------------
# .pac


def write_pac(path: str, genome: np.ndarray) -> None:
    genome = np.asarray(genome, np.uint8)
    l = len(genome)
    pad = (-l) % 4
    codes = np.concatenate([genome, np.zeros(pad, np.uint8)]).reshape(-1, 4)
    shifts = np.array([6, 4, 2, 0], np.uint8)
    pac = (codes << shifts[None, :]).sum(axis=1).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(pac.tobytes())
        if l % 4 == 0:
            f.write(b"\x00")
        f.write(bytes([l % 4]))


def read_pac(path: str, l_pac: int) -> np.ndarray:
    with open(path, "rb") as f:
        raw = np.frombuffer(f.read(), np.uint8)
    nbytes = (l_pac + 3) // 4
    pac = raw[:nbytes]
    shifts = np.array([6, 4, 2, 0], np.uint8)
    codes = ((pac[:, None] >> shifts[None, :]) & 3).reshape(-1)
    return codes[:l_pac].astype(np.uint8)


# ---------------------------------------------------------------------------
# .ann / .amb


def write_ann(path: str, anns: BwaAnnotations) -> None:
    with open(path, "w") as f:
        f.write(f"{anns.l_pac} {len(anns.contigs)} {anns.seed}\n")
        for c in anns.contigs:
            f.write(f"0 {c.name} {c.comment if c.comment else '(null)'}\n")
            f.write(f"{c.offset} {c.length} {c.n_ambs}\n")


def write_amb(path: str, anns: BwaAnnotations) -> None:
    with open(path, "w") as f:
        f.write(f"{anns.l_pac} {len(anns.contigs)} {len(anns.holes)}\n")
        for h in anns.holes:
            f.write(f"{h.offset} {h.length} {h.base}\n")


def read_ann_amb(prefix: str) -> BwaAnnotations:
    contigs: List[ContigAnn] = []
    with open(prefix + ".ann") as f:
        l_pac, n_seqs, seed = (int(x) for x in f.readline().split())
        for _ in range(n_seqs):
            hdr = f.readline().split(None, 2)
            name = hdr[1]
            comment = hdr[2].strip() if len(hdr) > 2 else ""
            if comment == "(null)":
                comment = ""
            off, ln, namb = (int(x) for x in f.readline().split())
            contigs.append(ContigAnn(name, comment, off, ln, namb))
    holes: List[AmbHole] = []
    if os.path.exists(prefix + ".amb"):
        with open(prefix + ".amb") as f:
            _, _, n_holes = (int(x) for x in f.readline().split())
            for _ in range(n_holes):
                parts = f.readline().split()
                holes.append(AmbHole(int(parts[0]), int(parts[1]), parts[2]))
    return BwaAnnotations(l_pac, seed, contigs, holes)


# ---------------------------------------------------------------------------
# .bwt (occ-interleaved, over the 2L bidirectional text)


def _pack_words(codes: np.ndarray) -> np.ndarray:
    """2-bit pack, 16 bases per u32, base 0 in the top bits (bwt_B00)."""
    pad = (-len(codes)) % 16
    ext = np.concatenate([codes, np.zeros(pad, np.uint8)]).astype(np.uint32)
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32))
    return (ext.reshape(-1, 16) << shifts[None, :]).sum(axis=1, dtype=np.uint32)


def _unpack_words(words: np.ndarray, n: int) -> np.ndarray:
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32))
    codes = ((words[:, None] >> shifts[None, :]) & 3).reshape(-1)
    return codes[:n].astype(np.uint8)


def write_bwt(path: str, fm: FMIndex) -> None:
    n = fm.seq_len
    bwt = fm.bwt
    onehot = np.zeros((n, 4), np.uint64)
    onehot[np.arange(n), bwt] = 1
    csum = np.zeros((n + 1, 4), np.uint64)
    csum[1:] = onehot.cumsum(axis=0)
    words = _pack_words(bwt)
    n_words = (n + 15) // 16
    with open(path, "wb") as f:
        np.array([fm.primary], "<u8").tofile(f)
        np.asarray(fm.L2[1:5], "<u8").tofile(f)
        nblk = (n + FILE_OCC_INTERVAL - 1) // FILE_OCC_INTERVAL
        for b in range(nblk):
            base = b * FILE_OCC_INTERVAL
            csum[base].astype("<u8").tofile(f)
            w0 = base // 16
            w1 = min(w0 + FILE_OCC_INTERVAL // 16, n_words)
            words[w0:w1].astype("<u4").tofile(f)
        csum[n].astype("<u8").tofile(f)  # trailing total-count block


def read_bwt(path: str) -> Tuple[int, np.ndarray, np.ndarray]:
    """-> (primary, L2[0..4], bwt symbol array of length seq_len)."""
    with open(path, "rb") as f:
        head = np.fromfile(f, "<u8", 5)
        body = np.fromfile(f, "<u4")
    primary = int(head[0])
    L2 = np.zeros(5, np.int64)
    L2[1:] = head[1:].astype(np.int64)
    n = int(L2[4])
    n_words = (n + 15) // 16
    nblk = (n + FILE_OCC_INTERVAL - 1) // FILE_OCC_INTERVAL
    data = []
    pos = 0
    for b in range(nblk):
        pos += 8  # skip 4x u64 occ counts
        w = min(FILE_OCC_INTERVAL // 16, n_words - b * (FILE_OCC_INTERVAL // 16))
        data.append(body[pos : pos + w])
        pos += w
    words = np.concatenate(data) if data else np.zeros(0, np.uint32)
    return primary, L2, _unpack_words(words, n)


# ---------------------------------------------------------------------------
# .sa


def write_sa(path: str, fm: FMIndex, sa_intv: int = SA_INTV_DEFAULT) -> None:
    n = fm.seq_len
    n_sa = (n + sa_intv) // sa_intv
    sampled = fm.sa[np.arange(1, n_sa) * sa_intv].astype("<u8")
    with open(path, "wb") as f:
        np.array([fm.primary], "<u8").tofile(f)
        np.asarray(fm.L2[1:5], "<u8").tofile(f)
        np.array([sa_intv, n], "<u8").tofile(f)
        sampled.tofile(f)


def read_sa(path: str) -> Tuple[int, int, int, np.ndarray]:
    """-> (primary, sa_intv, seq_len, sampled sa over ranks intv, 2*intv, ...)."""
    with open(path, "rb") as f:
        head = np.fromfile(f, "<u8", 7)
        sampled = np.fromfile(f, "<u8")
    return int(head[0]), int(head[5]), int(head[6]), sampled.astype(np.int64)


# ---------------------------------------------------------------------------
# top level (bwa_idx_load / bwa_idx_build analogs)


def save_bwa_index(
    prefix: str,
    fm: FMIndex,
    anns: Optional[BwaAnnotations] = None,
    sa_intv: int = SA_INTV_DEFAULT,
) -> None:
    genome = fm.text[: fm.seq_len // 2]
    if anns is None:
        anns = BwaAnnotations(
            len(genome), BWA_SEED, [ContigAnn("ref", "", 0, len(genome), 0)], []
        )
    write_pac(prefix + ".pac", genome)
    write_ann(prefix + ".ann", anns)
    write_amb(prefix + ".amb", anns)
    write_bwt(prefix + ".bwt", fm)
    write_sa(prefix + ".sa", fm, sa_intv)


def build_index_from_fasta(
    fasta_path: str, prefix: Optional[str] = None
) -> Tuple[FMIndex, BwaAnnotations]:
    """bwa_idx_build analog: FASTA -> FMIndex (+ on-disk dump if prefix)."""
    genome, anns = contigs_to_genome(read_fasta(fasta_path))
    fm = FMIndex.build(genome)
    if prefix is not None:
        save_bwa_index(prefix, fm, anns)
    return fm, anns


def load_bwa_index(prefix: str, validate: bool = True) -> Tuple[FMIndex, BwaAnnotations]:
    """bwa_idx_load analog: read a ``bwa index`` directory into an FMIndex.

    The FM-index device layout (occ checkpoints every 64 bases) is
    rebuilt from the forward pac; when ``validate`` is set the rebuilt
    BWT is cross-checked field-by-field against the .bwt/.sa files, so a
    foreign (stock-BWA-produced) index is verified on load.
    """
    anns = read_ann_amb(prefix)
    genome = read_pac(prefix + ".pac", anns.l_pac)
    fm = FMIndex.build(genome)
    if validate:
        primary, L2, bwt = read_bwt(prefix + ".bwt")
        if primary != fm.primary or not np.array_equal(L2, fm.L2):
            raise ValueError(f"{prefix}.bwt header disagrees with pac-derived BWT")
        if not np.array_equal(bwt, fm.bwt):
            raise ValueError(f"{prefix}.bwt body disagrees with pac-derived BWT")
        sa_primary, sa_intv, seq_len, sampled = read_sa(prefix + ".sa")
        if sa_primary != fm.primary or seq_len != fm.seq_len:
            raise ValueError(f"{prefix}.sa header disagrees with pac-derived BWT")
        ranks = np.arange(1, len(sampled) + 1) * sa_intv
        if not np.array_equal(fm.sa[ranks], sampled):
            raise ValueError(f"{prefix}.sa samples disagree with pac-derived SA")
    return fm, anns
