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
//   * a task's target codes are strided by B: the warp loads 32 rows at
//     once, one a lane, a tile ahead, and hands them out by shuffle.
// Bound on this card: instruction issue, and the dependent chain of a row
// (the scan's seven shuffles and four reductions, about 12 cross-lane
// steps; two more shuffles a tile in the tiled form); the band is at most
// 2w + 1 columns, and no scratch goes to device memory.
//
// A second front end, `sw_extend_fused`, replaces the device program
// acc_genomics_tpu/models/bwa_mem.py `_extend_seeds_fused` (which reaches
// the Pallas kernel through `sw_extend_pallas`): per seed, the SA lookup,
// both extensions read in place from the resident reads and text, and the
// clip resolution, into (8, N) int32.  It runs one thread per seed on the
// scalar transcription `extend_one`, statement for statement, with the eh
// rows in a global scratch laid out (2, W + 2, N).
// Inputs are time-major like the JAX contract: query (Q, B) and target
// (T, B) uint8 codes, code 4 (or above) ambiguous.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Params {
  int o_del, e_del, o_ins, e_ins, w, sc_match, sc_mismatch, sc_ambig;
};

// Task readers of the fused front end: code of query column j / target
// row i.
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

// ksw_extend2 of one task: query codes q(0..qlen-1), target codes
// t(0..tlen-1); eh_h / eh_e are the task's scratch rows with stride B.
template <class Q, class T>
__device__ Extension extend_one(Q q, T t, int qlen, int tlen, int h0,
                                int max_ins, int max_del, const Params& p,
                                int32_t* eh_h, int32_t* eh_e, int64_t B) {
  const int oe_del = p.o_del + p.e_del, oe_ins = p.o_ins + p.e_ins;
  for (int j = 0; j <= qlen + 1; ++j) {
    eh_h[j * B] = 0;
    eh_e[j * B] = 0;
  }

  int max_score = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
  int max_off = 0, reg_score = h0, band_w = p.w;
  for (int k = 0; k < 2; ++k) {
    const int prev = reg_score;
    band_w = p.w << k;
    const int aw1 = min(band_w, min(max_ins, max_del));
    int beg = 0, end = qlen;
    int row0_h = max(h0 - oe_ins, 0);
    int h1_init = h0 - p.o_del;
    for (int i = 0; i < tlen; ++i) {
      int f = 0, m = 0, mj = -1;
      const int t_i = t(i);
      if (beg < i - aw1) beg = i - aw1;
      if (end > i + aw1 + 1) end = i + aw1 + 1;
      if (end > qlen) end = qlen;
      int h1;
      if (beg == 0) {
        h1_init -= p.e_del;
        h1 = max(h1_init, 0);
      } else {
        h1 = 0;
      }
      int trail_zeros = 0, lead_zeros = 0;
      bool lead_run_over = false;
      for (int j = beg; j < end; ++j) {
        const int q_j = q(j);
        int e, M;
        if (i == 0) {
          e = 0;
          if (j == 0) {
            M = h0;
          } else if (j == 1) {
            M = row0_h;
          } else {
            row0_h = max(row0_h - p.e_ins, 0);
            M = row0_h;
          }
        } else {
          e = eh_e[j * B];
          M = eh_h[j * B];
        }
        const int h_left = h1;
        const int sc = (t_i >= 4 || q_j >= 4) ? p.sc_ambig
                       : (t_i == q_j ? p.sc_match : p.sc_mismatch);
        M = M != 0 ? M + sc : 0;
        const int h = max(max(M, e), f);
        h1 = h;
        e = max(e - p.e_del, max(M - oe_del, 0));
        f = max(f - p.e_ins, max(M - oe_ins, 0));
        eh_e[j * B] = e;
        eh_h[j * B] = h_left;
        if (m <= h) {
          mj = j;
          m = h;
        }
        const bool zero = h_left == 0 && e == 0;
        if (!lead_run_over) {
          if (zero) ++lead_zeros;
          else lead_run_over = true;
        }
        trail_zeros = zero ? trail_zeros + 1 : 0;
      }
      eh_h[end * B] = h1;
      eh_e[end * B] = 0;
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
// the same result): query codes q[j * B] for j < qlen, target codes
// t[i * B] for i < tlen.  kTiled (K = kMaxK): the query runs in tiles of
// kTile columns, their codes and eh rows in the warp's shared memory sm
// (n_tiles * kTileBytes), each column read and written by its own lane
// only; a row visits the tiles its band touches, in order.
template <int K, bool kTiled>
__device__ Extension extend_warp(const uint8_t* __restrict__ q,
                                 const uint8_t* __restrict__ t, int64_t B,
                                 int qlen, int tlen, int h0, int max_ins,
                                 int max_del, const Params& p, int lane,
                                 int n_tiles, unsigned char* sm) {
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
        sm_q[slot(tl, kk)] = j < qlen ? q[j * B] : 4;
        sm_h[slot(tl, kk)] = 0;
        sm_e[slot(tl, kk)] = 0;
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const int j = j0 + kk;
      qc[kk] = j < qlen ? q[j * B] : 4;
      eh_h[kk] = 0;
      eh_e[kk] = 0;
    }
  }
  // target rows base .. base + 31, one a lane
  auto load_rows = [&](int base) {
    const int i = base + lane;
    return i < tlen ? (int)t[i * B] : 4;
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
      query + b, target + b, B, qlen, tlen, h0s[b], max_inss[b], max_dels[b],
      p, lane, n_tiles, sw_smem + (int64_t)warp * n_tiles * kTileBytes);
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

template <int K, bool kTiled>
int launch_rows(const uint8_t* query, const uint8_t* target,
                const int32_t* qlen, const int32_t* tlen, const int32_t* h0,
                const int32_t* max_ins, const int32_t* max_del, int qcap,
                int tcap, int batch, const Params& p, int32_t* out,
                void* stream) {
  int warps = kWarps, smem = 0;
  if constexpr (kTiled) {
    const int per_warp = (qcap + kTile - 1) / kTile * kTileBytes;
    warps = max(1, min(kWarps, kMaxTiles * kTileBytes / per_warp));
    smem = warps * per_warp;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          sw_extend_kernel<K, kTiled>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
  }
  sw_extend_kernel<K, kTiled><<<(batch + warps - 1) / warps, warps * 32, smem,
                                (cudaStream_t)stream>>>(
      query, target, qlen, tlen, h0, max_ins, max_del, qcap, tcap, batch, p,
      out);
  return (int)cudaGetLastError();
}

// The fused seed-extension step (acc_genomics_tpu/models/bwa_mem.py
// `_extend_seeds_fused`), one thread a seed: the suffix-array lookup,
// the left extension (read[qbeg-1-j] against text[pos-1-j], h0 = the seed
// length), the right extension (read[qbeg+slen+j] against
// text[pos+slen+j], h0 = the left score), both with max_ins = max_del =
// the query length, then the pen_clip resolution.  The thread reads the
// resident read matrix and text in place and only below each length, so
// no span is copied and no guard flank is needed.
__global__ void sw_extend_fused_kernel(
    const int32_t* __restrict__ sa, const uint8_t* __restrict__ text,
    int text_len, const uint8_t* __restrict__ reads, int read_cap,
    const int32_t* __restrict__ rlens, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ qbegs, const int32_t* __restrict__ slens,
    const int32_t* __restrict__ readids, int n, int flank, Params p,
    int pen_clip, int32_t* __restrict__ eh, int32_t* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  const int64_t B = n;
  const int pos = sa[rows[b]];
  const int rid = readids[b];
  const int qbeg = qbegs[b], slen = slens[b];
  const int lq_len = qbeg;
  const int rq_len = rlens[rid] - qbeg - slen;
  const int lt_len = min(pos, qbeg + flank);
  const int rt_len = min(text_len - pos - slen, rq_len + flank);
  const uint8_t* read = reads + (int64_t)rid * read_cap;
  int32_t* eh_h = eh + b;
  int32_t* eh_e = eh + (int64_t)(read_cap + 2) * B + b;
  const Extension l = extend_one(
      Reversed{read + qbeg - 1}, Reversed{text + pos - 1},
      min(max(lq_len, 0), read_cap), max(lt_len, 0), slen, lq_len, lq_len, p,
      eh_h, eh_e, B);
  const Extension r = extend_one(
      Forward{read + qbeg + slen}, Forward{text + pos + slen},
      min(max(rq_len, 0), read_cap), max(rt_len, 0), l.score, rq_len, rq_len,
      p, eh_h, eh_e, B);
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

}  // namespace

extern "C" {

// query (Q, B) and target (T, B) uint8, Q <= kMaxTiles * kTile; qlen,
// tlen, h0, max_ins, max_del (B,) int32; out (7, B) int32.  eh is the
// scratch of the thread-per-task kernel this one replaced, kept so that
// the C interface did not change; it is not read and may be null.
// Returns a cudaError_t (0 on success).
int sw_extend(const uint8_t* query, const uint8_t* target,
              const int32_t* qlen, const int32_t* tlen, const int32_t* h0,
              const int32_t* max_ins, const int32_t* max_del, int qcap,
              int tcap, int batch, int o_del, int e_del, int o_ins,
              int e_ins, int w, int sc_match, int sc_mismatch, int sc_ambig,
              int32_t* eh, int32_t* out, void* stream) {
  (void)eh;
  if (qcap <= 0 || qcap > kMaxTiles * kTile || tcap <= 0 || batch < 0 || w < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const Params p{o_del, e_del, o_ins, e_ins, w, sc_match, sc_mismatch, sc_ambig};
  switch (min((qcap + 31) / 32, kMaxK + 1)) {
#define SW_EXTEND_K(K)                                                     \
  case K:                                                                  \
    return launch_rows<K, false>(query, target, qlen, tlen, h0, max_ins,   \
                                 max_del, qcap, tcap, batch, p, out, stream);
    SW_EXTEND_K(1) SW_EXTEND_K(2) SW_EXTEND_K(3) SW_EXTEND_K(4)
    SW_EXTEND_K(5) SW_EXTEND_K(6) SW_EXTEND_K(7) SW_EXTEND_K(8)
#undef SW_EXTEND_K
    default:  // past the registers: tiles of kTile columns in shared memory
      return launch_rows<kMaxK, true>(query, target, qlen, tlen, h0, max_ins,
                                      max_del, qcap, tcap, batch, p, out,
                                      stream);
  }
}

// sa (text_len + 1,) int32 suffix array; text (text_len,) uint8; reads
// (n_reads, read_cap) uint8, read-major; rlens (n_reads,) int32; rows,
// qbeg, slen, readid (n,) int32 per seed; eh (2, read_cap + 2, n) int32
// scratch; out (8, n) int32: qBeg, qEndRel, rBeg, rEndRel, score,
// trueScore, width, pos.  Returns a cudaError_t (0 on success).
int sw_extend_fused(const int32_t* sa, const uint8_t* text, int text_len,
                    const uint8_t* reads, int read_cap, const int32_t* rlens,
                    const int32_t* rows, const int32_t* qbeg,
                    const int32_t* slen, const int32_t* readid, int n,
                    int flank, int o_del, int e_del, int o_ins, int e_ins,
                    int w, int sc_match, int sc_mismatch, int sc_ambig,
                    int pen_clip, int32_t* eh, int32_t* out, void* stream) {
  if (read_cap <= 0 || n < 0 || w < 0 || text_len < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Params p{o_del, e_del, o_ins, e_ins, w, sc_match, sc_mismatch, sc_ambig};
  const int threads = 128;
  sw_extend_fused_kernel<<<(n + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(
      sa, text, text_len, reads, read_cap, rlens, rows, qbeg, slen, readid, n,
      flank, p, pen_clip, eh, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
