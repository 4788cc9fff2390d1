// Banded BWA-MEM seed extension (ksw_extend2 semantics) for Hopper (sm_90a).
//
// Replaces the Pallas kernel acc_genomics_tpu/ops/extend/kernel.py
// `_extend_kernel` (launched by `sw_extend_pallas`).  What it computes is
// the reference's sw_extend (bwa-sw/sdaccel/smithwaterman.cpp:75-273), as
// the native host engine transcribes it (native/accnative.cpp:774-878,
// `sw_extend_batch_native`), because the results are compared as exact
// integers:
//   * the adaptive band: beg/end clipped to i -/+ aw1 each target row,
//     aw1 = min(w << k, max_ins, max_del);
//   * the `m <= h` rule: the row's max column mj is the LAST argmax;
//   * the lead and trail zero runs of (H(i, j-1) == 0 && E == 0) narrow
//     the band for the next row;
//   * eh[end] = (h1, 0) after each row;
//   * gscore is tested when the row's loop ended at j == qlen;
//   * a row whose max m is 0 breaks the round;
//   * round 2 (band doubled) runs unless round 1's score equals h0's or
//     max_off < 3/4 of the band; the eh rows are NOT reset between the two
//     rounds, and `w` reports the band of the last round that ran.
// Outputs, (7, B) int32: score, qle, tle, gtle, gscore, max_off, w.
//
// `sw_extend` (the TPU kernel's contract): one warp per task, a row's
// columns computed in parallel across the query.  This is the lockstep
// row formulation of the TPU kernel and the plain version
// (ops/extend/kernel.py `sw_extend_plain`), run by the 32 lanes of a warp
// for one task instead of by one TPU lane per task:
//   * lane l owns query columns l*K .. l*K + K - 1 (K = ceil(Q / 32) <= 8,
//     a template parameter); their codes and eh_h / eh_e state live in
//     registers for the whole task, across both rounds (column qlen, which
//     eh[end] may name, is never read, so Q columns suffice);
//   * past 256 columns (Q <= 25,600) the query runs in tiles of 256, K = 8:
//     the codes and eh rows of every tile sit in the warp's dynamic shared
//     memory (2,304 bytes a tile; fewer warps a block when four do not
//     fit), each column touched only by its own lane, and a row visits the
//     tiles its band touches in order, carrying the F running max and H of
//     the tile's left neighbour column from one tile to the next;
//   * a row: the score, M, E and the insertion term t_ins of every column;
//     F as a max-plus prefix scan of t_ins(k) + k * e_ins (serial over the
//     lane's K columns, a 5-step __shfl_up_sync ladder over the lane
//     totals, then the fix-up); H; H(i, j-1) from the column to the left
//     (a shuffle at the lane's first column); then warp reductions
//     (__reduce_max_sync / __reduce_min_sync) for m, its last argmax mj
//     and the first and last column outside the zero runs;
//   * beg, end, gscore, the m == 0 break and the round-2 test are uniform
//     across the warp, so each warp runs its own trip count;
//   * the warp loads the task's target codes 32 rows at once, one a lane,
//     a tile ahead, and hands them out by shuffle.
// Bound on this card: instruction issue, and the dependent chain of a row
// (the scan's seven shuffles and four reductions, about 12 cross-lane
// steps; two more shuffles a tile in the tiled form); the band is at most
// 2w + 1 columns, and no scratch goes to device memory.
//
// `extend_warp` is the file's one transcription of ksw_extend2.  It reads
// the task's codes through accessors: `Strided` for the time-major
// contract of `sw_extend` (query (Q, B), target (T, B), so the 32 rows of
// a load are strided by B), `Forward` / `Reversed` for the second front
// end, `sw_extend_fused`, which replaces the device program
// acc_genomics_tpu/models/bwa_mem.py `_extend_seeds_fused` (which reaches
// the Pallas kernel through `sw_extend_pallas`): per seed, the SA lookup,
// both extensions read in place from the resident reads and text (a load
// of 32 target rows is 32 consecutive bytes, forwards or backwards), and
// the clip resolution, into (8, N) int32.  It runs a warp a seed: the
// left extension, then the right one on fresh eh rows, K from the read
// width (tiles past 256 columns, as in `sw_extend`).
// Codes of 4 (or above) are ambiguous.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Params {
  int o_del, e_del, o_ins, e_ins, w, sc_match, sc_mismatch, sc_ambig;
};

// Task readers: code of query column j / target row i.
struct Strided {  // p[j * stride]: the time-major (Q, B) / (T, B) contract
  const uint8_t* p;
  int64_t stride;
  __device__ int operator()(int j) const { return p[j * stride]; }
};
struct Forward {  // p[j]
  const uint8_t* p;
  __device__ int operator()(int j) const { return p[j]; }
};
struct Reversed {  // p[-j]: a left extension reads its sequence backwards
  const uint8_t* p;
  __device__ int operator()(int j) const { return p[-j]; }
};

struct Extension {
  int score, qle, tle, gtle, gscore, max_off, w;
};

constexpr int kWarps = 4;  // warps (tasks) a block
constexpr int kMaxK = 8;   // query columns a lane in registers: Q <= 256
constexpr int kTile = 32 * kMaxK;  // query columns a tile past that
constexpr int kTileBytes = kTile * 9;  // a tile's eh_h, eh_e and codes
constexpr int kMaxTiles = 100;  // one warp's tiles fill 227 KB of shared
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = -(1 << 29);
constexpr int kNone = 1 << 30;

// A row's work on the lane's K columns j0 .. j0 + K - 1 of one tile (of
// the whole query when it fits in registers): score, M, E out and H, the
// eh rows of the band's columns, and the lane's share of the row's max,
// last argmax (lm, lj), first and last column outside the zero runs (lf,
// ll) and H at column end - 1 (at_last).  carry_run is the running max of
// t_ins(k) + k e_ins over the band's columns left of the tile and carry_h
// H of the column just left of it; the tiled form reads and updates them.
template <int K, bool kTiled>
__device__ __forceinline__ void row_tile(const int (&qc)[K], int (&eh_h)[K],
                                         int (&eh_e)[K], int j0, int beg,
                                         int end, int h1s, int t_i,
                                         const Params& p, int lane,
                                         int& carry_run, int& carry_h, int& lm,
                                         int& lj, int& lf, int& ll,
                                         int& at_last) {
  const int oe_del = p.o_del + p.e_del, oe_ins = p.o_ins + p.e_ins;
  // M, E out, and the running max of t_ins(k) + k e_ins over the lane's
  // band columns
  int mv[K], ev[K], pre[K];
  int run = kNeg;
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int j = j0 + kk;
    const bool in = j >= beg && j < end;
    const int sc = (t_i >= 4 || qc[kk] >= 4)
                       ? p.sc_ambig
                       : (t_i == qc[kk] ? p.sc_match : p.sc_mismatch);
    const int m = eh_h[kk] != 0 ? eh_h[kk] + sc : 0;
    mv[kk] = m;
    ev[kk] = max(eh_e[kk] - p.e_del, max(m - oe_del, 0));
    run = max(run, in ? max(m - oe_ins, 0) + j * p.e_ins : kNeg);
    pre[kk] = run;
  }
  // the running max over the columns of the lanes below
  int below = __shfl_up_sync(kFull, run, 1);
  if (lane == 0) below = kNeg;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, below, d);
    if (lane >= d) below = max(below, v);
  }
  if constexpr (kTiled) below = max(below, carry_run);
  // F(j) = max_{beg <= k < j} t_ins(k) - (j - 1 - k) e_ins (0 at beg)
  int hv[K];
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int j = j0 + kk;
    const bool in = j >= beg && j < end;
    const int left = kk == 0 ? below : max(below, pre[kk - 1]);
    const int f = max(left - (j - 1) * p.e_ins, 0);
    const int h = max(max(mv[kk], eh_e[kk]), f);
    hv[kk] = in ? h : 0;
  }
  // H(i, j - 1), the eh rows of the band, the row's max and zero runs
  int h_prev_lane = __shfl_up_sync(kFull, hv[K - 1], 1);
  if constexpr (kTiled) {
    if (lane == 0) h_prev_lane = carry_h;
    carry_run = __shfl_sync(kFull, max(below, run), 31);
    carry_h = __shfl_sync(kFull, hv[K - 1], 31);
  }
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int j = j0 + kk;
    const bool in = j >= beg && j < end;
    int h_left = kk == 0 ? h_prev_lane : hv[kk - 1];
    if (j == beg) h_left = h1s;
    if (in) {
      if (hv[kk] >= lm) {
        lm = hv[kk];
        lj = j;
      }
      if ((h_left | ev[kk]) != 0) {
        lf = min(lf, j);
        ll = j;
      }
      eh_h[kk] = h_left;
      eh_e[kk] = ev[kk];
    }
    if (j == end - 1) at_last = hv[kk];
  }
}

// ksw_extend2 of one task on the 32 lanes of a warp (every lane returns
// the same result): query codes q(j) for j < qlen, target codes t(i) for
// i < tlen, read through the accessors above.  kTiled (K = kMaxK): the query runs in tiles of
// kTile columns, their codes and eh rows in the warp's shared memory sm
// (n_tiles * kTileBytes), each column read and written by its own lane
// only; a row visits the tiles its band touches, in order.
template <int K, bool kTiled, class QA, class TA>
__device__ Extension extend_warp(QA q, TA t, int qlen, int tlen, int h0,
                                 int max_ins, int max_del, const Params& p,
                                 int lane, int n_tiles, unsigned char* sm) {
  const int oe_ins = p.o_ins + p.e_ins;
  const int j0 = lane * K;
  int qc[K], eh_h[K], eh_e[K];
  // a tile's column j0 + kk at [(tl * K + kk) * 32 + lane]
  int32_t* const sm_h = (int32_t*)sm;
  int32_t* const sm_e = sm_h + n_tiles * kTile;
  uint8_t* const sm_q = (uint8_t*)(sm_e + n_tiles * kTile);
  auto slot = [&](int tl, int kk) { return ((tl * K + kk) << 5) + lane; };
  if constexpr (kTiled) {
    for (int tl = 0; tl < n_tiles; ++tl) {
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        const int j = tl * kTile + j0 + kk;
        sm_q[slot(tl, kk)] = j < qlen ? q(j) : 4;
        sm_h[slot(tl, kk)] = 0;
        sm_e[slot(tl, kk)] = 0;
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const int j = j0 + kk;
      qc[kk] = j < qlen ? q(j) : 4;
      eh_h[kk] = 0;
      eh_e[kk] = 0;
    }
  }
  // target rows base .. base + 31, one a lane
  auto load_rows = [&](int base) {
    const int i = base + lane;
    return i < tlen ? t(i) : 4;
  };

  int max_score = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
  int max_off = 0, reg_score = h0, band_w = p.w;
  for (int k = 0; k < 2; ++k) {
    const int prev = reg_score;
    band_w = p.w << k;
    const int aw1 = min(band_w, min(max_ins, max_del));
    int beg = 0, end = qlen;
    int h1_init = h0 - p.o_del;
    {  // row 0 reads (M, E) = (h0, then max(h0 - oe_ins - (j-1) e_ins, 0);
       // 0) in place of the eh rows: put them into its band's columns, all
       // of which it overwrites
      const int row0_h = max(h0 - oe_ins, 0);
      const int b0 = max(0, -aw1), e0 = min(qlen, aw1 + 1);
      auto row0 = [&](int j) {
        return j == 0 ? h0 : max(row0_h - (j - 1) * p.e_ins, 0);
      };
      if constexpr (kTiled) {
        for (int tl = 0; tl < n_tiles; ++tl) {
#pragma unroll
          for (int kk = 0; kk < K; ++kk) {
            const int j = tl * kTile + j0 + kk;
            if (j >= b0 && j < e0) {
              sm_h[slot(tl, kk)] = row0(j);
              sm_e[slot(tl, kk)] = 0;
            }
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < K; ++kk) {
          const int j = j0 + kk;
          if (j >= b0 && j < e0) {
            eh_h[kk] = row0(j);
            eh_e[kk] = 0;
          }
        }
      }
    }
    int tcur = load_rows(0), tnext = load_rows(32);
    for (int i = 0; i < tlen; ++i) {
      if ((i & 31) == 0 && i > 0) {
        tcur = tnext;
        tnext = load_rows(i + 32);
      }
      const int t_i = __shfl_sync(kFull, tcur, i & 31);
      if (beg < i - aw1) beg = i - aw1;
      if (end > i + aw1 + 1) end = i + aw1 + 1;
      if (end > qlen) end = qlen;
      int h1s = 0;  // H(i, beg - 1)
      if (beg == 0) {
        h1_init -= p.e_del;
        h1s = max(h1_init, 0);
      }
      int lm = -1, lj = -1, lf = kNone, ll = -1, at_last = 0;
      int carry_run = kNeg, carry_h = 0;
      int h1;
      if constexpr (kTiled) {
        const int t_lo = beg / kTile, t_hi = end > beg ? (end - 1) / kTile : t_lo - 1;
        for (int tl = t_lo; tl <= t_hi; ++tl) {
#pragma unroll
          for (int kk = 0; kk < K; ++kk) {
            qc[kk] = sm_q[slot(tl, kk)];
            eh_h[kk] = sm_h[slot(tl, kk)];
            eh_e[kk] = sm_e[slot(tl, kk)];
          }
          row_tile<K, true>(qc, eh_h, eh_e, tl * kTile + j0, beg, end, h1s, t_i,
                            p, lane, carry_run, carry_h, lm, lj, lf, ll,
                            at_last);
#pragma unroll
          for (int kk = 0; kk < K; ++kk) {
            sm_h[slot(tl, kk)] = eh_h[kk];
            sm_e[slot(tl, kk)] = eh_e[kk];
          }
        }
        h1 = __shfl_sync(kFull, at_last, (max(end - 1, 0) % kTile) / K);
        if (end <= beg) h1 = h1s;
        const int jt = end % kTile;  // eh[end] = (h1, 0), by end's lane
        if (end < n_tiles * kTile && lane == jt / K) {
          const int at = (((end / kTile) * K + jt % K) << 5) + lane;
          sm_h[at] = h1;
          sm_e[at] = 0;
        }
      } else {
        row_tile<K, false>(qc, eh_h, eh_e, j0, beg, end, h1s, t_i, p, lane,
                           carry_run, carry_h, lm, lj, lf, ll, at_last);
        h1 = __shfl_sync(kFull, at_last, max(end - 1, 0) / K);
        if (end <= beg) h1 = h1s;
#pragma unroll
        for (int kk = 0; kk < K; ++kk) {
          if (j0 + kk == end) {
            eh_h[kk] = h1;
            eh_e[kk] = 0;
          }
        }
      }
      const int m = max(__reduce_max_sync(kFull, lm), 0);
      const int mj = __reduce_max_sync(kFull, lm == m ? lj : -1);
      const int first_nz = __reduce_min_sync(kFull, lf);
      const int last_nz = __reduce_max_sync(kFull, ll);
      int lead_zeros = 0, trail_zeros = 0;
      if (end > beg) {
        lead_zeros = min(first_nz, end) - beg;
        trail_zeros = end - 1 - max(last_nz, beg - 1);
      }
      trail_zeros = h1 == 0 ? trail_zeros + 1 : 0;
      if (end == qlen && gscore <= h1) {
        max_ie = i;
        gscore = h1;
      }
      if (m == 0) break;
      if (m > max_score) {
        max_score = m;
        max_i = i;
        max_j = mj;
        max_off = max(max_off, abs(mj - i));
      }
      beg += lead_zeros;
      end = min(end - trail_zeros + 2, qlen);
    }
    reg_score = max_score;
    if (max_score == prev || max_off < ((band_w >> 1) + (band_w >> 2))) break;
  }
  return Extension{reg_score, max_j + 1, max_i + 1, max_ie + 1, gscore,
                   max_off, band_w};
}

template <int K, bool kTiled>
__global__ void __launch_bounds__(kWarps * 32)
    sw_extend_kernel(const uint8_t* __restrict__ query,
                     const uint8_t* __restrict__ target,
                     const int32_t* __restrict__ qlens,
                     const int32_t* __restrict__ tlens,
                     const int32_t* __restrict__ h0s,
                     const int32_t* __restrict__ max_inss,
                     const int32_t* __restrict__ max_dels, int qcap, int tcap,
                     int batch, Params p, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char sw_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = (int)(threadIdx.x >> 5);
  const int b = blockIdx.x * (int)(blockDim.x >> 5) + warp;
  if (b >= batch) return;  // the whole warp
  const int64_t B = batch;
  const int qlen = min(max(qlens[b], 0), qcap);
  const int tlen = min(max(tlens[b], 0), tcap);
  const int n_tiles = kTiled ? (qcap + kTile - 1) / kTile : 0;
  const Extension r = extend_warp<K, kTiled>(
      Strided{query + b, B}, Strided{target + b, B}, qlen, tlen, h0s[b],
      max_inss[b], max_dels[b], p, lane, n_tiles,
      sw_smem + (int64_t)warp * n_tiles * kTileBytes);
  if (lane == 0) {
    out[0 * B + b] = r.score;
    out[1 * B + b] = r.qle;
    out[2 * B + b] = r.tle;
    out[3 * B + b] = r.gtle;
    out[4 * B + b] = r.gscore;
    out[5 * B + b] = r.max_off;
    out[6 * B + b] = r.w;
  }
}

// The fused seed-extension step (acc_genomics_tpu/models/bwa_mem.py
// `_extend_seeds_fused`), one warp a seed: the suffix-array lookup, the
// left extension (read[qbeg-1-j] against text[pos-1-j], h0 = the seed
// length), the right extension (read[qbeg+slen+j] against
// text[pos+slen+j], h0 = the left score), both with max_ins = max_del =
// the query length and each on fresh eh rows, then the pen_clip
// resolution (uniform across the warp; lane 0 writes the outputs).  The
// warp reads the resident read matrix and text in place and only below
// each length, so no span is copied and no guard flank is needed.
// read_cap is the read matrix's width: K = ceil(read_cap / 32) columns a
// lane, tiles past 256.
template <int K, bool kTiled>
__global__ void __launch_bounds__(kWarps * 32) sw_extend_fused_kernel(
    const int32_t* __restrict__ sa, const uint8_t* __restrict__ text,
    int text_len, const uint8_t* __restrict__ reads, int read_cap,
    const int32_t* __restrict__ rlens, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ qbegs, const int32_t* __restrict__ slens,
    const int32_t* __restrict__ readids, int n, int flank, Params p,
    int pen_clip, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char sw_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = (int)(threadIdx.x >> 5);
  const int b = blockIdx.x * (int)(blockDim.x >> 5) + warp;
  if (b >= n) return;  // the whole warp
  const int64_t B = n;
  const int pos = sa[rows[b]];
  const int rid = readids[b];
  const int qbeg = qbegs[b], slen = slens[b];
  const int lq_len = qbeg;
  const int rq_len = rlens[rid] - qbeg - slen;
  const int lt_len = min(pos, qbeg + flank);
  const int rt_len = min(text_len - pos - slen, rq_len + flank);
  const uint8_t* read = reads + (int64_t)rid * read_cap;
  const int n_tiles = kTiled ? (read_cap + kTile - 1) / kTile : 0;
  unsigned char* const sm = sw_smem + (int64_t)warp * n_tiles * kTileBytes;
  const Extension l = extend_warp<K, kTiled>(
      Reversed{read + qbeg - 1}, Reversed{text + pos - 1},
      min(max(lq_len, 0), read_cap), max(lt_len, 0), slen, lq_len, lq_len, p,
      lane, n_tiles, sm);
  const Extension r = extend_warp<K, kTiled>(
      Forward{read + qbeg + slen}, Forward{text + pos + slen},
      min(max(rq_len, 0), read_cap), max(rt_len, 0), l.score, rq_len, rq_len,
      p, lane, n_tiles, sm);
  if (lane != 0) return;
  const bool l_clip = l.gscore <= 0 || l.gscore <= l.score - pen_clip;
  const bool r_clip = r.gscore <= 0 || r.gscore <= r.score - pen_clip;
  const int true_l = l_clip ? l.score : l.gscore;
  out[0 * B + b] = l_clip ? qbeg - l.qle : 0;
  out[1 * B + b] = r_clip ? r.qle : rq_len;
  out[2 * B + b] = l_clip ? -l.tle : -l.gtle;
  out[3 * B + b] = r_clip ? r.tle : r.gtle;
  out[4 * B + b] = r.score;
  out[5 * B + b] = true_l + (r_clip ? r.score : r.gscore) - l.score;
  out[6 * B + b] = max(l.w, r.w);
  out[7 * B + b] = pos;
}

// Launches `kernel` over `tasks` warps whose query bucket is qcap columns:
// four warps a block, or, in the tiled form, as many as the warps' tiles
// leave room for in shared memory.
template <bool kTiled, class Kernel, class... Args>
int launch_warps(Kernel kernel, int qcap, int tasks, void* stream,
                 Args... args) {
  int warps = kWarps, smem = 0;
  if constexpr (kTiled) {
    const int per_warp = (qcap + kTile - 1) / kTile * kTileBytes;
    warps = max(1, min(kWarps, kMaxTiles * kTileBytes / per_warp));
    smem = warps * per_warp;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
  }
  kernel<<<(tasks + warps - 1) / warps, warps * 32, smem,
           (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// K = ceil(qcap / 32) columns a lane in registers up to kMaxK, tiles past
// that: launch.run<K, kTiled>()
template <class Launch>
int dispatch_k(int qcap, const Launch& launch) {
  switch (min((qcap + 31) / 32, kMaxK + 1)) {
    case 1: return launch.template run<1, false>();
    case 2: return launch.template run<2, false>();
    case 3: return launch.template run<3, false>();
    case 4: return launch.template run<4, false>();
    case 5: return launch.template run<5, false>();
    case 6: return launch.template run<6, false>();
    case 7: return launch.template run<7, false>();
    case 8: return launch.template run<8, false>();
    default: return launch.template run<kMaxK, true>();
  }
}

struct ExtendLaunch {
  const uint8_t* query;
  const uint8_t* target;
  const int32_t *qlen, *tlen, *h0, *max_ins, *max_del;
  int qcap, tcap, batch;
  Params p;
  int32_t* out;
  void* stream;
  template <int K, bool kTiled>
  int run() const {
    return launch_warps<kTiled>(sw_extend_kernel<K, kTiled>, qcap, batch,
                                stream, query, target, qlen, tlen, h0, max_ins,
                                max_del, qcap, tcap, batch, p, out);
  }
};

struct FusedLaunch {
  const int32_t* sa;
  const uint8_t* text;
  int text_len;
  const uint8_t* reads;
  int read_cap;
  const int32_t *rlens, *rows, *qbeg, *slen, *readid;
  int n, flank;
  Params p;
  int pen_clip;
  int32_t* out;
  void* stream;
  template <int K, bool kTiled>
  int run() const {
    return launch_warps<kTiled>(sw_extend_fused_kernel<K, kTiled>, read_cap,
                                n, stream, sa, text, text_len, reads, read_cap,
                                rlens, rows, qbeg, slen, readid, n, flank, p,
                                pen_clip, out);
  }
};

}  // namespace

extern "C" {

// query (Q, B) and target (T, B) uint8, Q <= kMaxTiles * kTile; qlen,
// tlen, h0, max_ins, max_del (B,) int32; out (7, B) int32.  Returns a
// cudaError_t (0 on success).
int sw_extend(const uint8_t* query, const uint8_t* target,
              const int32_t* qlen, const int32_t* tlen, const int32_t* h0,
              const int32_t* max_ins, const int32_t* max_del, int qcap,
              int tcap, int batch, int o_del, int e_del, int o_ins,
              int e_ins, int w, int sc_match, int sc_mismatch, int sc_ambig,
              int32_t* out, void* stream) {
  if (qcap <= 0 || qcap > kMaxTiles * kTile || tcap <= 0 || batch < 0 || w < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const Params p{o_del, e_del, o_ins, e_ins, w, sc_match, sc_mismatch, sc_ambig};
  return dispatch_k(qcap, ExtendLaunch{query, target, qlen, tlen, h0, max_ins,
                                       max_del, qcap, tcap, batch, p, out,
                                       stream});
}

// sa (text_len + 1,) int32 suffix array; text (text_len,) uint8; reads
// (n_reads, read_cap) uint8, read-major, read_cap <= kMaxTiles * kTile;
// rlens (n_reads,) int32; rows, qbeg, slen, readid (n,) int32 per seed;
// out (8, n) int32: qBeg, qEndRel, rBeg, rEndRel, score, trueScore,
// width, pos.  Returns a cudaError_t (0 on success).
int sw_extend_fused(const int32_t* sa, const uint8_t* text, int text_len,
                    const uint8_t* reads, int read_cap, const int32_t* rlens,
                    const int32_t* rows, const int32_t* qbeg,
                    const int32_t* slen, const int32_t* readid, int n,
                    int flank, int o_del, int e_del, int o_ins, int e_ins,
                    int w, int sc_match, int sc_mismatch, int sc_ambig,
                    int pen_clip, int32_t* out, void* stream) {
  if (read_cap <= 0 || read_cap > kMaxTiles * kTile || n < 0 || w < 0 ||
      text_len < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Params p{o_del, e_del, o_ins, e_ins, w, sc_match, sc_mismatch, sc_ambig};
  return dispatch_k(read_cap, FusedLaunch{sa, text, text_len, reads, read_cap,
                                          rlens, rows, qbeg, slen, readid, n,
                                          flank, p, pen_clip, out, stream});
}

}  // extern "C"
