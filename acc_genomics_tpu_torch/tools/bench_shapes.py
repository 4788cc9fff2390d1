"""The inputs the kernels are checked and timed at, shared by
``chip_smoke.py``, ``tools/kernel_ab.py`` and the tests: the SW fill's
edge batches, the extension kernel's batches and edges, the fused seed
extension's edge batches, ExtendEngine's seeds, the PairHMM kernel's
benchmark pairs, engine batches and edge packs, the byte-plane gather's
cases and the HC cells' PairHMM batches, a genome and reads that
overflow the SMEM caps, all made from numpy seeds, and a recorder of a
wrapper's calls."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from acc_genomics_tpu_torch.ops.extend.reference import ExtendParams

EXTEND_SEEDS = 4096  # bench_extend_engine's seeds


@contextlib.contextmanager
def capture_calls(module, name: str, calls: list, keep=None):
    """Record a copy of the arguments of every call of ``module.<name>``
    while the block runs, or of the calls whose index is in ``keep`` (the
    copies are taken on the caller's stream)."""
    real = getattr(module, name)
    seen = [0]

    def recorder(*args, **kw):
        if keep is None or seen[0] in keep:
            calls.append(([a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args], dict(kw)))
        seen[0] += 1
        return real(*args, **kw)

    setattr(module, name, recorder)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def _edge_tasks(rng, n, qmax, tmax, qlens):
    """Query-like targets (95% identity, a 7-base insertion after 20 query
    bases in every fourth, ambiguous bases in every fifth), qlen cycling
    through ``qlens``, tlen up to tmax, h0 0-39 and 0 in every sixth."""
    q = np.full((qmax, n), 4, np.uint8)
    t = np.full((tmax, n), 4, np.uint8)
    ql = np.resize(np.asarray(qlens, np.int32), n)
    tl = rng.integers(1, tmax + 1, n).astype(np.int32)
    for b in range(n):
        qq = rng.integers(0, 4, ql[b]).astype(np.uint8)
        tt = rng.integers(0, 4, tl[b]).astype(np.uint8)
        src = qq if b % 4 else np.concatenate([qq[:20], rng.integers(0, 4, 7), qq[20:]])
        m = min(len(src), tl[b])
        tt[:m] = np.where(rng.random(m) < 0.95, src[:m], tt[:m])
        if b % 5 == 0:
            tt[::9] = 4
        q[: ql[b], b] = qq
        t[: tl[b], b] = tt
    h0 = rng.integers(0, 40, n).astype(np.int32)
    h0[::6] = 0
    return q, t, ql, tl, h0


def _gap_tasks(rng, n, qmax, tmax):
    """Targets with a gap of 3-39 bases near query column 256, the first
    shared-memory tile boundary: extra bases in the query (the in-row F
    chain crosses the boundary) in even tasks, bases missing from it in
    odd ones; 98% identity elsewhere, qlen and tlen up to 20 and 30 short
    of the caps, h0 10-59."""
    q = np.full((qmax, n), 4, np.uint8)
    t = np.full((tmax, n), 4, np.uint8)
    ql = np.zeros(n, np.int32)
    tl = np.zeros(n, np.int32)
    for b in range(n):
        base = rng.integers(0, 4, tmax + qmax).astype(np.uint8)
        at, gap = int(rng.integers(240, 262)), int(rng.integers(3, 40))
        if b % 2 == 0:
            qq = np.concatenate([base[:at], rng.integers(0, 4, gap), base[at:]])
        else:
            qq = np.concatenate([base[:at], base[at + gap:]])
        qq = np.where(rng.random(len(qq)) < 0.98, qq, (qq + 1) % 4)[:qmax]
        ql[b] = qmax - int(rng.integers(0, 20))
        tl[b] = tmax - int(rng.integers(0, 30))
        q[: ql[b], b] = qq[: ql[b]]
        t[: tl[b], b] = base[: tl[b]]
    return q, t, ql, tl, rng.integers(10, 60, n).astype(np.int32)


def extend_batches(dev):
    """The extension kernel's batches as dicts (name, q (Q, B), t (T, B),
    qlen, tlen, h0, max_ins = max_del, params) on ``dev``.

    bench_extend's (seed 0, 2048 tasks, Q 128, T 256, qlen 101, tlen 160,
    h0 25); a batch where round 2 runs (an 80-base insertion after 20
    query bases: the first round's best cell is 80 >= 3/4 of the band off
    the diagonal; h0 100, enough to cross the 86-point gap); the bench
    batch with 5% ambiguous bases; 512 tasks at the caps (qlen 256, tlen
    1024).  Then the edges of the one-warp-a-task design, 512 tasks each:
    qlen 0, 1, 31, 32 in a 32-column bucket (one column a lane), 31, 32,
    33 in a 33-column bucket (two), 0, 1, 255, 256 at the 256 cap (eight);
    band 8, where beg and end move every row and round 2 runs; max_ins =
    max_del = 5, below the band; h0 0 everywhere.  Then the tiles past
    256 query columns: qlen 255, 256, 257, 300 in a 300-column bucket with
    band 300 (row 0 spans both tiles); gaps at column 256 in 520-column
    buckets, band 100 and band 16 (round 2); 128 tasks at Q 1536 (six
    tiles, past 48 KB of shared memory a block) and 8 at Q 25,600 (the
    cap: one warp a block)."""
    out = []

    def on(name, q, t, ql, tl, h0, cap=None, params=ExtendParams()):
        q, t, ql, tl, h0 = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                            for x in (q.astype(np.uint8), t.astype(np.uint8), ql, tl, h0))
        mi = ql if cap is None else torch.clamp(ql, max=cap)
        out.append(dict(name=name, q=q, t=t, qlen=ql, tlen=tl, h0=h0, max_ins=mi,
                        params=params))

    rng = np.random.default_rng(0)
    bsz, qmax, tmax = 2048, 128, 256
    q = rng.integers(0, 4, (qmax, bsz))
    t = rng.integers(0, 4, (tmax, bsz))
    t[:qmax] = np.where(rng.random((qmax, bsz)) < 0.95, q, t[:qmax])
    full = lambda v: np.full(bsz, v, np.int32)
    on("bench", q, t, full(101), full(160), full(25))

    rng = np.random.default_rng(1)
    q2 = rng.integers(0, 4, (256, bsz))
    t2 = np.concatenate([q2[:20], rng.integers(0, 4, (80, bsz)), q2[20:], q2[:156]])
    on("round2", q2, t2, full(200), full(280), full(100))

    amb_q, amb_t = q.copy(), t.copy()
    amb_q[rng.random(q.shape) < 0.05] = 4
    amb_t[rng.random(t.shape) < 0.05] = 4
    on("ambiguous", amb_q, amb_t, full(101), full(160), full(25))

    n = 512
    q4 = rng.integers(0, 4, (256, n))
    t4 = rng.integers(0, 4, (1024, n))
    t4[:256] = np.where(rng.random((256, n)) < 0.97, q4, t4[:256])
    on("caps", q4, t4, np.full(n, 256, np.int32), np.full(n, 1024, np.int32),
       np.full(n, 19, np.int32))

    rng = np.random.default_rng(2)
    on("qlen 0/1/31/32, Q 32", *_edge_tasks(rng, n, 32, 64, [0, 1, 31, 32]))
    on("qlen 31/32/33, Q 33", *_edge_tasks(rng, n, 33, 64, [31, 32, 33]))
    on("qlen 0/1/255/256, Q 256", *_edge_tasks(rng, n, 256, 320, [0, 1, 255, 256]))
    on("band 8", *_edge_tasks(rng, n, 96, 128, [90, 64, 40]), params=ExtendParams(w=8))
    on("max_ins 5 < band 8", *_edge_tasks(rng, n, 96, 128, [90, 64, 40]), cap=5,
       params=ExtendParams(w=8))
    qh, th, qlh, tlh, _ = _edge_tasks(rng, n, 128, 160, [101, 60])
    on("h0 0", qh, th, qlh, tlh, np.zeros(n, np.int32))

    rng = np.random.default_rng(3)
    on("qlen 255/256/257/300, Q 300, band 300",
       *_edge_tasks(rng, n, 300, 64, [255, 256, 257, 300]), params=ExtendParams(w=300))
    on("gaps at column 256, Q 520", *_gap_tasks(rng, n, 520, 600))
    on("gaps at column 256, Q 520, band 16", *_gap_tasks(rng, n, 520, 600),
       params=ExtendParams(w=16))
    on("Q 1536", *_edge_tasks(rng, 128, 1536, 1600, [1536, 1400, 1300, 257]))
    on("Q 25600", *_edge_tasks(rng, 8, 25_600, 600, [25_600, 300, 20_000, 1]))
    return out


SW_BENCH_PAIRS = 8192  # bench.py bench_sw: one ref of 286 vs 8192 alts
SMEM_GENOME = 100_000_000  # bases: drivers/smem_driver.py's genome scale
SMEM_READS = 65536  # bench_smem's lane count, reads of 101
BWA_READS = 2048  # bench_bwamem's reads (max_occ 4, flank 100)


def sw_bench_chunks(dev):
    """bench.py bench_sw's batch (seed 0, one ref of 286 vs 8192 alts) as
    SWEngine cuts it: (ref, alts, [(ref (B, R), alt (B, C), reflen, altlen)
    a chunk]) in the 320 x 320 bucket, chunks of ``chunk_pairs``."""
    from acc_genomics_tpu_torch.config import SWConfig
    from acc_genomics_tpu_torch.engine.sw_engine import chunk_pairs
    from acc_genomics_tpu_torch.io.synth import gen_sw_batch
    from acc_genomics_tpu_torch.ops.sw.batch import pack_planes

    ref, alts = gen_sw_batch(np.random.default_rng(0), SW_BENCH_PAIRS, ref_len=286)
    cfg = SWConfig()
    bucket = lambda n: next(b for b in cfg.seq_buckets if b >= n)
    rows, cols = bucket(len(ref)), bucket(max(len(a) for a in alts))
    seg = chunk_pairs(rows, cols, cfg.max_batch)
    chunks = []
    for lo in range(0, len(alts), seg):
        part = alts[lo:lo + seg]
        ref_p = np.empty((len(part), rows), np.uint8)
        alt_p = np.empty((len(part), cols), np.uint8)
        rl = pack_planes([ref] * len(part), rows, ref_p)
        al = pack_planes(part, cols, alt_p)
        chunks.append(tuple(torch.from_numpy(x).to(dev) for x in (ref_p, alt_p, rl, al)))
    return ref, alts, chunks


def smem_index_and_reads():
    """chip_smoke.py phases 12-14's genome (gen_reference_with_repeats of
    SMEM_GENOME bases, seed 0), its FMIndex, phase 12's SMEM_READS reads
    of 101 and the BWA_READS reads of 101 drawn after them: (genome, fm,
    smem_reads, bwa_reads).  The index build takes about a minute (the
    native suffix array)."""
    from acc_genomics_tpu_torch.io.synth import gen_reference_with_repeats, gen_smem_reads
    from acc_genomics_tpu_torch.ops.smem.index import FMIndex

    rng = np.random.default_rng(0)
    genome = gen_reference_with_repeats(rng, SMEM_GENOME)
    fm = FMIndex.build(genome)
    smem_reads = gen_smem_reads(rng, genome, SMEM_READS, read_len=101)
    return genome, fm, smem_reads, gen_smem_reads(rng, genome, BWA_READS, read_len=101)


def smem_repeat_genome(rng, length: int) -> np.ndarray:
    """A genome whose reads overflow the SMEM kernel's default caps:
    random bases, a 300-base family whose copies diverge by 2-20% over a
    tenth of it (many SMEMs a read), and homopolymer runs and
    microsatellites of units of 2-3 bases, 12-170 bases long, over a
    fiftieth (forward and backward chains past 32 rows)."""
    genome = rng.integers(0, 4, length).astype(np.uint8)
    unit = rng.integers(0, 4, 300).astype(np.uint8)
    for pos in rng.integers(0, length - 300, int(0.1 * length / 300)).tolist():
        copy = unit.copy()
        mut = rng.random(300) < rng.uniform(0.02, 0.2)
        copy[mut] = (copy[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        genome[pos:pos + 300] = copy if rng.random() < 0.5 else 3 - copy[::-1]
    for pos in rng.integers(0, length - 170, int(0.02 * length / 90)).tolist():
        n = int(rng.integers(12, 171))
        motif = rng.integers(0, 4, int(rng.choice([1, 2, 3]))).astype(np.uint8)
        genome[pos:pos + n] = np.resize(motif, n)
    return genome


def smem_retry_reads(rng, genome: np.ndarray, n: int, read_len: int = 150):
    """``n`` reads of ``read_len`` drawn uniformly from ``genome`` with
    0.2% errors and 0.1% N (the BWA cell's rates), then three whose
    chains outgrow 32 rows on ``smem_repeat_genome``: a homopolymer, a
    dinucleotide repeat and a homopolymer with one mismatch."""
    from acc_genomics_tpu_torch.io.synth import gen_smem_reads

    reads = gen_smem_reads(rng, genome, n, read_len=read_len, error_rate=0.002,
                           ambig_rate=0.001)
    poly = np.zeros(read_len, np.uint8)
    kinked = poly.copy()
    kinked[read_len // 2] = 3
    return reads + [poly, np.resize(np.array([1, 0], np.uint8), read_len), kinked]


def pipeline_fused_args(dev):
    """The arguments of the one ``extend_seeds_fused`` launch of a
    ``BwaMemDevicePipeline`` call (max_occ 4, flank 100) on
    ``smem_index_and_reads()``' BWA reads: chip_smoke.py phase 14's seeds."""
    import acc_genomics_tpu_torch.models.bwa_mem as bwa_module
    from acc_genomics_tpu_torch.build import ensure_native
    from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
    from acc_genomics_tpu_torch.models import BwaMemDevicePipeline

    ensure_native()
    _, fm, _, reads = smem_index_and_reads()
    eng = GenomicsEngine(device=dev)
    eng.set_index(fm)
    calls = []
    with capture_calls(bwa_module, "extend_seeds_fused", calls):
        BwaMemDevicePipeline(eng, max_occ=4, flank=100).map_reads_arrays(reads)
    return calls[0]


def _sw_pair(rng, rlen: int, alen: int):
    """A ref of rlen random codes and an alt of alen: the ref with 10%
    substitutions, a 3-base deletion and a 2-base insertion, repeated or
    cut to alen."""
    ref = rng.integers(0, 4, rlen).astype(np.uint8)
    alt = ref.copy()
    mut = rng.random(rlen) < 0.10
    alt[mut] = (alt[mut] + rng.integers(1, 4, mut.sum())) % 4
    if rlen > 20:
        alt = np.concatenate([alt[:8], alt[11:15], rng.integers(0, 4, 2), alt[15:]])
    return ref, np.resize(alt, alen).astype(np.uint8)


def sw_fill_batches(dev, big: bool = True):
    """The SW fill's edges as (name, ref (B, R), alt (B, C), reflen, altlen)
    on ``dev``: reflen 1, 31, 32, 33, 63, 64, 65 and 97 (one and two lanes'
    rows, one and two chunks of 64 rows, full and with one row over, and
    the whole of an odd bucket, whose diagonals leave two codes unaligned)
    against altlen 1 and the bucket's 96 columns in a 97 x 96 bucket;
    batches of 1, 5 and 13 pairs (a block holds four) of mixed lengths in
    a 64 x 64 bucket; with ``big``, a bucket of 1536 rows filled by reflen
    1536 against altlen 1 and 1536, and 1535 against 1000."""
    from acc_genomics_tpu_torch.ops.sw.batch import pack_planes

    rng = np.random.default_rng(9)
    out = []

    def on(name, pairs, rows, cols):
        ref = np.empty((len(pairs), rows), np.uint8)
        alt = np.empty((len(pairs), cols), np.uint8)
        rl = pack_planes([r for r, _ in pairs], rows, ref)
        al = pack_planes([a for _, a in pairs], cols, alt)
        out.append((name, *(torch.from_numpy(x).to(dev) for x in (ref, alt, rl, al))))

    on("reflen 1-97 x altlen 1/96, 97 x 96",
       [_sw_pair(rng, r, a) for r in (1, 31, 32, 33, 63, 64, 65, 97) for a in (1, 96)],
       97, 96)
    for n in (1, 5, 13):
        on(f"{n} pairs, 64 x 64",
           [_sw_pair(rng, int(rng.integers(1, 65)), int(rng.integers(1, 65)))
            for _ in range(n)], 64, 64)
    if big:
        on("reflen 1536 x altlen 1/1536, 1535 x 1000, 1536 x 1536",
           [_sw_pair(rng, 1536, 1), _sw_pair(rng, 1536, 1536), _sw_pair(rng, 1535, 1000)],
           1536, 1536)
    return out


WALK_GAP_PAIRS = 4096  # the gap-heavy walk batch: one SWEngine chunk

# Found by a search over random sequences of two or three letters: pairs
# whose last row holds its maxima on both sides of j = reflen (the last
# two across 32-cell chunks), as (ref, alt) digit strings.
_LAST_ROW_TIES = [
    ("0210220", "0101201112012220210"),
    ("222010102", "2122102220211"),
    ("01133", "203120220012203111122"),
    ("10001", "11011100"),
    ("01111", "00010000001"),
    ("1011101", "00001000"),
    ("0122", "0010001"),
    ("01010", "0110000011111101100111"),
    ("0001100111010001101001111011100100111110001110",
     "01010111011101111011100001111000111011001111000100100000"),
    ("110010111001111100011011101001010111001100011001101111110100110",
     "10000001100011001010010000101000011110111111001001000110111011000000"),
]
# Found the same way: prefixes of (ref, alt) before a shared core after
# which the walk's last step is a gap that lands on row 0 or column 0.
_EDGE_GAP_PREFIXES = [("111", "0221320003"), ("11", "0322332"), ("0020", "31")]


def _codes(digits: str) -> np.ndarray:
    return np.frombuffer(digits.encode(), np.uint8) - ord("0")


def _one_base_gaps(rng, ref, every: int, kinds: str, lead: int = 0) -> np.ndarray:
    """ref with a one-base gap after every ``every`` bases, ``kinds``
    cycling "I" (a base unlike both neighbours inserted) and "D" (a ref
    base left out), after ``lead`` random bases."""
    alt, n = list(rng.integers(0, 4, lead)), 0
    for p, b in enumerate(ref):
        if p and p % every == 0:
            kind = kinds[n % len(kinds)]
            n += 1
            if kind == "D":
                continue
            alt.append(next(x for x in range(4) if x != b and x != ref[p - 1]))
        alt.append(b)
    return np.asarray(alt, np.uint8)


def _gap_heavy(rng, n: int, width: int = 320):
    """n pairs of a random ref of 280-300 bases and an alt with an indel of
    1-3 bases every 10-30 bases (insertions and deletions alike), both cut
    to ``width``."""
    pairs = []
    for _ in range(n):
        ref = rng.integers(0, 4, int(rng.integers(280, 301))).astype(np.uint8)
        parts, at = [], 0
        while at < len(ref):
            step = int(rng.integers(10, 31))
            parts.append(ref[at:at + step])
            at += step
            k = int(rng.integers(1, 4))
            if rng.random() < 0.5:
                parts.append(rng.integers(0, 4, k).astype(np.uint8))
            else:
                at += k
        pairs.append((ref[:width], np.concatenate(parts)[:width]))
    return pairs


def sw_walk_batches(dev, gap_pairs: int = WALK_GAP_PAIRS):
    """The SW walk's edges as (name, ref (B, R), alt (B, C), reflen, altlen)
    on ``dev``, for the warp design that consumes a diagonal's match run
    32 cells a round: match runs of exactly 31, 32, 33 and 64 cells before
    a 3-base deletion or insertion, and alone to the corner; gaps of 40
    and 70 (past a round's reach), a gap as the first step (a tail
    insertion or deletion, under INDEL) and as the last one (landing on row
    0 or column 0), walks ending on row 0, column 0 and the corner; reflen
    or altlen 1; start-cell ties (tandem repeats with maxima at many cells
    of the last alt column and of the last row past j = reflen,
    homopolymers, and ``_LAST_ROW_TIES``); 47, 48, 49 and 53 elements (one
    slot short, full, one past and well past the 48 shipped); and
    ``gap_pairs`` gap-heavy pairs in a 320 x 320 bucket (an indel every
    10-30 bases), the timing batch."""
    from acc_genomics_tpu_torch.ops.sw.batch import pack_planes

    rng = np.random.default_rng(11)
    rand = lambda n: rng.integers(0, 4, n).astype(np.uint8)
    unlike = lambda x: ((x + rng.integers(1, 4, len(x))) % 4).astype(np.uint8)
    out = []

    def on(name, pairs, rows, cols):
        ref = np.empty((len(pairs), rows), np.uint8)
        alt = np.empty((len(pairs), cols), np.uint8)
        rl = pack_planes([r for r, _ in pairs], rows, ref)
        al = pack_planes([a for _, a in pairs], cols, alt)
        out.append((name, *(torch.from_numpy(x).to(dev) for x in (ref, alt, rl, al))))

    pairs = []
    for run in (31, 32, 33, 64):
        ref = rand(96 + run)
        at = len(ref) - run  # the run: ref[at:] against the alt's last bases
        if ref[at] == ref[at - 3]:  # a deletion that cannot slide
            ref[at] = (ref[at] + 1) % 4
        if ref[at - 4] == ref[at - 1]:
            ref[at - 1] = next(x for x in range(4) if x not in (ref[at - 4], ref[at]))
        pairs.append((ref, np.concatenate([ref[:at - 3], ref[at:]])))
        ins = next(x for x in range(4) if x not in (ref[at - 1], ref[at]))
        pairs.append((ref, np.concatenate([ref[:at], np.full(3, ins, np.uint8), ref[at:]])))
        pairs.append((ref[at:], ref[at:].copy()))
    on("match runs of 31/32/33/64 before a gap and to the corner, 176 x 176", pairs, 176, 176)

    core = rand(80)
    pairs = []
    for g in (40, 70):
        ref = rand(120 + g)
        pairs.append((ref, np.concatenate([ref[:60], ref[60 + g:]])))
        pairs.append((ref[:120], np.concatenate([ref[:60], rand(g), ref[60:120]])))
    pairs += [(core, np.concatenate([core, rand(5)])), (np.concatenate([core, rand(5)]), core)]
    pairs += [(np.concatenate([_codes(r), core[:40]]), np.concatenate([_codes(a), core[:40]]))
              for r, a in _EDGE_GAP_PREFIXES]
    pairs += [(core, np.concatenate([rand(5), core])), (np.concatenate([rand(5), core]), core),
              (core, core.copy())]
    on("gaps of 40/70, gaps first and last, ends on row 0/column 0/corner, 192 x 192",
       pairs, 192, 192)

    base = rand(48)
    on("reflen or altlen 1, 48 x 48",
       [(base[:1], base[:1]), (base[:1], unlike(base[:1])), (base[:1], base[:40]),
        (base[:40], base[5:6]), (base[:1], base), (base, base[47:])], 48, 48)

    per = np.tile(np.array([0, 1], np.uint8), 20)
    tri = np.tile(np.array([0, 1, 1], np.uint8), 20)
    pairs = [(tri, tri[:24]), (per, np.tile(per, 2)[:68]), (np.zeros(18, np.uint8),
             np.zeros(22, np.uint8)), (np.zeros(70, np.uint8), np.zeros(45, np.uint8)),
             (per, np.roll(per, 1))]
    pairs += [(_codes(r), _codes(a)) for r, a in _LAST_ROW_TIES]
    on("start-cell ties, 72 x 72", pairs, 72, 72)

    pairs = []
    for length, lead, kinds in ((96, 0, "I"), (96, 1, "I"), (100, 0, "I"), (140, 0, "ID")):
        ref = rand(length)
        pairs.append((ref, _one_base_gaps(rng, ref, 4, kinds, lead)))
    on("47/48/49/53 elements, 144 x 160", pairs, 144, 160)

    if gap_pairs:
        on(f"gap-heavy, {gap_pairs} pairs, 320 x 320", _gap_heavy(rng, gap_pairs), 320, 320)
    return out


def _fused_case(rng, n, width, qbegs, text_len=20_000, ends=False, gap=0):
    """Seeds planted in a random text: read b spans text[pos - qbeg:] (95%
    identity outside the seed, an N in every fifth read) with its seed of
    slen 15-24 bases (fewer where the width leaves less) at qbeg, which
    cycles through ``qbegs``; rlen up to the width; with ``ends``, every
    fourth seed at the text's first position and every fourth at its last;
    with ``gap``, that many bases inserted into (even seeds) or deleted
    from (odd seeds) the read 10 bases past the seed.  Returns (text,
    reads (n, width), rlens, pos, qbeg, slen)."""
    text = rng.integers(0, 4, text_len).astype(np.uint8)
    reads = np.full((n, width), 4, np.uint8)
    rlens = np.zeros(n, np.int32)
    pos, qbeg, slen = (np.zeros(n, np.int32) for _ in range(3))
    for b in range(n):
        qb = min(int(qbegs[b % len(qbegs)]), width - 1)
        sl = max(1, min(int(rng.integers(15, 25)), width - qb))
        p = int(rng.integers(0, text_len - sl + 1))
        if ends and b % 4 == 0:
            p = 0
        elif ends and b % 4 == 1:
            p = text_len - sl
        k = np.arange(p - qb, p - qb + width + gap)
        read = np.where((k >= 0) & (k < text_len), text[np.clip(k, 0, text_len - 1)],
                        rng.integers(0, 4, len(k))).astype(np.uint8)
        mut = rng.random(len(read)) < 0.05
        mut[qb: qb + sl] = False
        read[mut] = (read[mut] + rng.integers(1, 4, mut.sum())) % 4
        at = qb + sl + 10
        if gap and b % 2 == 0:
            read = np.concatenate([read[:at], rng.integers(0, 4, gap).astype(np.uint8),
                                   read[at:]])
        elif gap:
            read = np.concatenate([read[:at], read[at + gap:]])
        if b % 5 == 0:
            read[int(rng.integers(0, len(read)))] = 4
        rl = int(rng.integers(qb + sl, width + 1))
        reads[b, :rl] = read[:rl]
        reads[b, qb: qb + sl] = text[p: p + sl]  # the seed matches exactly
        rlens[b], pos[b], qbeg[b], slen[b] = rl, p, qb, sl
    return text, reads, rlens, pos, qbeg, slen


def fused_batches(dev, n: int = 256):
    """The fused seed extension's edges as dicts (name and the arguments
    of ``extend_seeds_fused``: sa, text, reads, rlens, rows, qbeg, slen,
    readid, flank, params) on ``dev``, n seeds each (one read a seed; the
    suffix array maps seed b's row b to its position): left queries of
    length 0, 1, 31, 32 and 33 at width 256 (one, two and eight columns a
    lane at the boundaries), reads of width 32 and 33 (one and two
    columns a lane), seeds at the text's first and last positions with
    flank 100 and 300, a batch where round 2 runs (band 8, 7-base gaps
    past the seed) and reads of width 300 (the shared-memory tiles)."""
    rng = np.random.default_rng(10)
    out = []

    def on(name, case, flank=100, params=ExtendParams()):
        text, reads, rlens, pos, qbeg, slen = case
        m = len(pos)
        sa = np.zeros(len(text) + 1, np.int32)
        sa[:m] = pos
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        idx = np.arange(m, dtype=np.int32)
        out.append(dict(name=name, sa=t(sa), text=t(text), reads=t(reads), rlens=t(rlens),
                        rows=t(idx), qbeg=t(qbeg), slen=t(slen), readid=t(idx),
                        flank=flank, params=params))

    on("left 0/1/31/32/33, W 256", _fused_case(rng, n, 256, (0, 1, 31, 32, 33)))
    on("W 32", _fused_case(rng, n, 32, (0, 1, 10, 31)))
    on("W 33", _fused_case(rng, n, 33, (0, 1, 31, 32)))
    on("text ends, flank 100", _fused_case(rng, n, 128, (0, 5, 40, 90), text_len=3000,
                                           ends=True))
    on("text ends, flank 300", _fused_case(rng, n, 128, (0, 5, 40, 90), text_len=3000,
                                           ends=True), flank=300)
    on("round 2, band 8", _fused_case(rng, n, 128, (20, 40, 60), gap=7),
       params=ExtendParams(w=8))
    on("W 300 (tiles)", _fused_case(rng, max(n // 4, 1), 300, (0, 33, 150, 260)))
    return out


def extend_bench_seeds(n: int = EXTEND_SEEDS):
    """bench_extend_engine's seeds: seed 0, a 20 kbp genome, reads of 101
    with 4% errors, a planted 19-24 base seed, 150-base flanks."""
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, 20_000).astype(np.uint8)
    seeds = []
    for _ in range(n):
        pos = int(rng.integers(200, len(genome) - 400))
        read = genome[pos: pos + 101].copy()
        err = rng.random(101) < 0.04
        read[err] = (read[err] + rng.integers(1, 4, err.sum())) % 4
        qbeg = int(rng.integers(5, 101 - 30))
        slen = int(rng.integers(19, 25))
        read[qbeg: qbeg + slen] = genome[pos + qbeg: pos + qbeg + slen]
        seeds.append(dict(read=read, rseq=genome[pos - 150: pos + 101 + 150],
                          qbeg=qbeg, rbeg_off=150 + qbeg, len=slen))
    return genome, seeds


def flat_matrix_args(reads, haps):
    """``PairHMMEngine.compute_matrix_flat`` arguments of reads x haps."""
    cat = lambda key: np.concatenate([np.asarray(r[key], np.uint8) for r in reads])
    return (
        cat("rs"), cat("q"), cat("i"), cat("d"), cat("c"),
        np.array([len(r["rs"]) for r in reads], np.int32),
        np.concatenate([np.asarray(h, np.uint8) for h in haps]),
        np.array([len(h) for h in haps], np.int32),
    )


def pairhmm_bench_groups(cols: int = 384, row_buckets=(64, 96, 128, 152)):
    """bench.py's PairHMM kernel batch (seed 0, 8192 pairs, reads up to
    150, haps up to 384) split into the row buckets: {rows: pairs}."""
    from acc_genomics_tpu_torch.io.synth import gen_pairhmm_pairs

    tcs = gen_pairhmm_pairs(np.random.default_rng(0), 8192, max_read_len=150,
                            max_hap_len=cols)
    groups = {b: [] for b in row_buckets}
    for t in tcs:
        for b in row_buckets:
            if len(t["rs"]) < b:
                groups[b].append(t)
                break
    return {b: g for b, g in groups.items() if g}


def pairhmm_engine_batches(n: int = 1):
    """The engine batches of chip_smoke.py's phase 4 (seed 1; each 1024
    derived reads of up to 150 x 16 haps of up to 380) as (reads, haps)."""
    from acc_genomics_tpu_torch.io.synth import gen_pairhmm_input

    rng = np.random.default_rng(1)
    return [gen_pairhmm_input(rng, 1024, 16, max_read_len=150, max_hap_len=380,
                              derived=True) for _ in range(n)]


# the byte-plane gather's cases: read lengths, haplotype lengths and the
# (rows, cols) buckets; every read meets every haplotype, as in
# HaplotypeCallerCore, lengths 0 and each bucket's edges among them
GATHER_CASES = {
    "illumina": ((0, 1, 31, 32, 63, 95, 127, 150, 191, 255) + (100,) * 60 + (150,) * 60,
                 (0, 1, 128, 250, 256, 400, 512),
                 [(r, c) for r in (32, 64, 96, 128, 192, 256) for c in (128, 256, 512)]),
    "hifi": ((0, 255, 256, 300, 319, 360, 468, 521, 575, 1023) + (360,) * 30,
             (0, 1, 500, 700, 1024),
             [(r, c) for r in (320, 576, 1024) for c in (512, 1024)]),
    "empty": ((0, 0, 0), (0, 0), [(32, 128)]),
}


def gather_case(rng, read_lens, hap_lens, buckets):
    """Flat streams of reads of ``read_lens`` against haplotypes of
    ``hap_lens``, every read with every haplotype, and the engine's launch
    groups over ``buckets`` ((rows, cols); each pair in the first that
    holds it, read shorter than rows and haplotype within cols): lanes in
    a shuffled order sorted by haplotype length, longest first.  Returns
    ((q, i, d, c, rs, hap), offs, lens, hoffs, hlens, [(sel, rows, cols)])."""
    rl = np.asarray(read_lens, np.int32)
    hl = np.asarray(hap_lens, np.int32)
    q, i, d, c, rs = (rng.integers(0, 128, int(rl.sum()), dtype=np.uint8) for _ in range(5))
    hap = rng.integers(0, 5, int(hl.sum()), dtype=np.uint8)
    starts = lambda n: np.concatenate([[0], np.cumsum(n)[:-1]]).astype(np.int64)
    offs, lens = np.repeat(starts(rl), len(hl)), np.repeat(rl, len(hl))
    hoffs, hlens = np.tile(starts(hl), len(rl)), np.tile(hl, len(rl))
    order = rng.permutation(len(lens))
    home = np.array([next(b for b, (rows, cols) in enumerate(buckets)
                          if lens[k] < rows and hlens[k] <= cols) for k in order])
    groups = []
    for b, (rows, cols) in enumerate(buckets):
        sel = order[home == b]
        if len(sel):
            groups.append((sel[np.argsort(-hlens[sel], kind="stable")], rows, cols))
    return (q, i, d, c, rs, hap), offs, lens, hoffs, hlens, groups


def native_planes(streams, offs, lens, hoffs, hlens, groups) -> np.ndarray:
    """The native host pack of every group's byte planes
    (``native.pairhmm_pack_quals_flat``), back to back in launch order."""
    from acc_genomics_tpu_torch import native
    from acc_genomics_tpu_torch.utils.convert import HAP_PAD

    q, i, d, c, rs, hap = streams
    out = [native.pairhmm_pack_quals_flat(rs, q, i, d, c, offs[sel], lens[sel], hap,
                                          hoffs[sel], hlens[sel], rows, cols, HAP_PAD)[0].base
           for sel, rows, cols in groups]
    return np.concatenate([o.reshape(-1) for o in out]) if out else np.zeros(0, np.uint8)


def hc_flat_batch(regions):
    """``PairHMMEngine.compute_pairs_flat`` arguments of HC ``regions``
    ([(reference window, haplotypes, reads)], each read a dict of rs, q,
    i, d, c): every read against every haplotype of its region, the
    streams concatenated once, as HaplotypeCallerCore sends them.
    Returns (positional args, offs and hoffs keywords)."""
    reads = [r for _, _, rs in regions for r in rs]
    haps = [h for _, hs, _ in regions for h in hs]
    starts = lambda n: np.concatenate([[0], np.cumsum(n)[:-1]]).astype(np.int64)
    rl = np.array([len(r["rs"]) for r in reads], np.int32)
    hl = np.array([len(h) for h in haps], np.int32)
    r_idx, h_idx, ri, hi = [], [], 0, 0
    for _, hs, rs in regions:
        r_idx.append(np.repeat(np.arange(ri, ri + len(rs)), len(hs)))
        h_idx.append(np.tile(np.arange(hi, hi + len(hs)), len(rs)))
        ri, hi = ri + len(rs), hi + len(hs)
    r_idx, h_idx = np.concatenate(r_idx), np.concatenate(h_idx)
    cat = lambda key: np.concatenate([r[key] for r in reads])
    args = (cat("rs"), cat("q"), cat("i"), cat("d"), cat("c"), rl[r_idx],
            np.concatenate(haps), hl[h_idx])
    return args, dict(offs=starts(rl)[r_idx], hoffs=starts(hl)[h_idx])


def pairhmm_edge_packs(dev):
    """The PairHMM kernel's edges (chip_smoke.py phase 3), as (label,
    coefficient pack, byte-plane pack) on ``dev``: 256 derived pairs a
    bucket of 1, 8, 9 (C = 8 and 16), 31, 32, 33, 34 (one and two chunks of
    32), 255, 257, 288 (nine chunks), 512, 576 (long reads, 16 and 18
    chunks) and 1024 rows (32 chunks, the row cap), every haplotype
    exactly the bucket's columns, 1 and 1024 among them.  Reads fill the
    rows but the absorbing one (a byte-plane pack needs it); the
    coefficient pack runs every row.  A
    one-row bucket holds no read: every lane is inert.  Then packs without
    lane padding whose last warp is only partly filled: 1, 5 and 13 pairs
    at rows 8 and 16 (C = 8 and 16: four and two segments a warp) and 3
    pairs at rows 40 (C = 32, the block's last warps empty), haplotypes of
    mixed lengths, the second pair of each pack inert (an empty read)."""
    from acc_genomics_tpu_torch.io.synth import gen_pairhmm_input
    from acc_genomics_tpu_torch.ops.pairhmm.convert import batch_to_torch, quals_to_torch
    from acc_genomics_tpu_torch.ops.pairhmm.pack import pack_pairhmm_batch, pack_pairhmm_quals

    rng = np.random.default_rng(4)
    out = []
    for rows, cols in ((1, 64), (8, 64), (9, 64), (31, 96), (32, 96), (33, 96), (34, 96),
                       (255, 400), (40, 1), (151, 1024), (257, 400), (288, 512),
                       (512, 600), (576, 640), (1024, 1024)):
        reads, haps = gen_pairhmm_input(rng, 64, 4, max_read_len=max(rows - 1, 1),
                                        max_hap_len=max(cols, 64), derived=True)
        haps = [np.concatenate([h, rng.integers(0, 4, cols)])[:cols].astype(np.uint8)
                for h in haps]  # every haplotype exactly `cols` long
        tcs = [dict(hap=h, **r) for r in reads for h in haps]
        if rows == 1:
            for tc in tcs:
                for k in ("rs", "q", "i", "d", "c"):
                    tc[k] = np.asarray(tc[k])[:0]
        out.append((f"rows {rows} cols {cols}",
                    batch_to_torch(pack_pairhmm_batch(tcs, rows=rows, cols=cols), dev),
                    quals_to_torch(pack_pairhmm_quals(tcs, rows=rows, cols=cols), dev)))
    for rows, cols, n in ((8, 64, 1), (8, 64, 5), (8, 64, 13), (16, 96, 1), (16, 96, 5),
                          (16, 96, 13), (40, 200, 3)):
        reads, haps = gen_pairhmm_input(rng, n, 2, max_read_len=rows - 1, max_hap_len=cols,
                                        derived=True)
        tcs = [dict(hap=haps[k % 2], **r) for k, r in enumerate(reads)]
        if n > 1:
            for k in ("rs", "q", "i", "d", "c"):
                tcs[1][k] = np.asarray(tcs[1][k])[:0]
        kw = dict(rows=rows, cols=cols, pad_lanes=False)
        out.append((f"rows {rows} cols {cols}, {n} pairs unpadded",
                    batch_to_torch(pack_pairhmm_batch(tcs, **kw), dev),
                    quals_to_torch(pack_pairhmm_quals(tcs, **kw), dev)))
    return out
