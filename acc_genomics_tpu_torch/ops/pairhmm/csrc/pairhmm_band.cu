// Chunked PairHMM band kernel for Hopper (sm_90a): the local body of the
// DP x SP pipeline (acc_genomics_tpu_torch/parallel/sharded.py).
//
// Replaces the TPU kernel acc_genomics_tpu/ops/pairhmm/band_kernel.py
// `_make_band_kernel` (launched by `pairhmm_band_chunk`).
//
// What it computes: one chunk of C read rows across one shard's slab of hc
// haplotype columns, for every (slot, lane) problem; a slot is one mesh
// position (a data group's shard) and a lane one (read, hap) pair.  The
// cell arithmetic is pairhmm_forward.cu's (and the JAX band kernel's):
//     M(i,j) = distm(i,j) * (pMM(i) M(i-1,j-1) + pGapM(i) S(i-1,j-1))
//     X(i,j) = pMX(i) M(i-1,j) + pXX(i) X(i-1,j)
//     Y(i,j) = pMY(i) M(i,j-1) + pYY(i) Y(i,j-1),   S = X + Y.
// The boundaries arrive as streams instead of masks:
//   top   (hc + 1 positions): position k holds the previous chunk's bottom
//         row at column k - 1; position 0 is the corner (r0 - 1, c0 - 1);
//   edge  (C + 1 positions): position k holds the left neighbour's column
//         at row r0 - 1 + k (position 0 is the row above the chunk).
// Outputs: the chunk's bottom row (M, X, S) at columns 0 .. hc - 1 and its
// right edge (M, Y, S) at column hc - 1, rows 0 .. C - 1.
//
// Design: C is 8, 16 or 32, so one chunk fits in a segment of C lanes of a
// warp; a 128-thread block holds 128 / C problems, neighbouring problems on
// neighbouring lanes of the batch (coalesced stream loads and stores).
// Lane li of a segment owns chunk row li and walks the anti-diagonals
// t = li + j.  What row li needs from row li - 1 (its cell at column j,
// written one step earlier, and at column j - 1, two steps earlier) and
// the haplotype mask of column j (row li - 1's mask one step earlier) pass
// between lanes with __shfl_up_sync, the wavefront register shift that
// pairhmm_forward.cu names as its later design: no shared memory and no
// barrier, where a block per problem would idle 24 of 32 lanes at C = 8.
// Row 0 reads the top streams, prefetched one step ahead; the left-edge
// values of row li are read once, before the loop.
//
// Numerics: built without fast math (-ftz=false -prec-div=true), as the
// other PairHMM kernel; no division.
//
// Bound on this card: latency.  Every step is a dependent chain of five
// shuffles and three products per lane, hc + C - 1 steps a chunk; at the
// main path's 4 slots x 2048 lanes the grid is 512 blocks, about 16 warps
// an SM, too few to hide that chain.  Bytes ((9C + 7 steps) x 4 a lane)
// and operations (13 fp32 a cell) are far below the card's rates.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBaseN = 4;
constexpr uint32_t kPadMask = 16;
constexpr unsigned kFull = 0xffffffffu;

struct BandArgs {
  const float* coef;   // (S, 8, C, B): p_mm p_gapm p_mx p_xx p_my p_yy em_m em_x
  const int32_t* rs;   // (S, C, B) read codes of the chunk rows
  const int32_t* hap;  // (S, hc, B) one-hot hap masks of the slab
  const float* top_m;  // (S, hc + 1, B)
  const float* top_x;
  const float* top_s;
  const float* edge_m;  // (S, C + 1, B)
  const float* edge_y;
  const float* edge_s;
  float* bot_m;  // (S, hc, B)
  float* bot_x;
  float* bot_s;
  float* red_m;  // (S, C, B)
  float* red_y;
  float* red_s;
  int slots, hc, batch;
};

template <int C>
__global__ void __launch_bounds__(kThreads) pairhmm_band_kernel(BandArgs a) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int li = (int)(g % C);
  const int64_t p = g / C;  // problem = slot * batch + lane
  const int64_t B = a.batch;
  const int hc = a.hc;
  const bool valid = p < (int64_t)a.slots * B;
  const int64_t s = valid ? p / B : 0;
  const int64_t b = valid ? p % B : 0;

  float p_mm = 0.f, p_gapm = 0.f, p_mx = 0.f, p_xx = 0.f, p_my = 0.f,
        p_yy = 0.f, em_m = 0.f, em_x = 0.f;
  uint32_t rmask = 0;
  float e_dm = 0.f, e_ds = 0.f, e_lm = 0.f, e_ly = 0.f;  // column -1 values
  const int64_t tb = s * (hc + 1) * B + b;  // top stream, position 0
  const int64_t hb = s * hc * B + b;        // hap masks and bottom row, column 0
  float t_dm = 0.f, t_ds = 0.f, t_um = 0.f, t_ux = 0.f;  // row 0's prefetch
  uint32_t t_h = kPadMask;
  if (valid) {
    const float* cf = a.coef + (s * 8 * C + li) * B + b;
    p_mm = cf[0 * C * B];
    p_gapm = cf[1 * C * B];
    p_mx = cf[2 * C * B];
    p_xx = cf[3 * C * B];
    p_my = cf[4 * C * B];
    p_yy = cf[5 * C * B];
    em_m = cf[6 * C * B];
    em_x = cf[7 * C * B];
    const int r = a.rs[(s * C + li) * B + b];
    rmask = r == kBaseN ? 15u : (1u << (r & 31));
    const int64_t eb = (s * (C + 1) + li) * B + b;
    e_dm = a.edge_m[eb];
    e_ds = a.edge_s[eb];
    e_lm = a.edge_m[eb + B];
    e_ly = a.edge_y[eb + B];
    if (li == 0) {
      t_dm = a.top_m[tb];
      t_ds = a.top_s[tb];
      t_um = a.top_m[tb + B];
      t_ux = a.top_x[tb + B];
      t_h = (uint32_t)a.hap[hb];
    }
  }

  // this lane's cells one step (column j - 1) and two steps (j - 2) ago
  float m1 = 0.f, x1 = 0.f, y1 = 0.f, s1 = 0.f, m2 = 0.f, s2 = 0.f;
  uint32_t hd = kPadMask;
  const int n_steps = hc + C - 1;
  for (int t = 0; t < n_steps; ++t) {
    // row li - 1: its cell at column j (up) and j - 1 (diagonal)
    float up_m = __shfl_up_sync(kFull, m1, 1, C);
    float up_x = __shfl_up_sync(kFull, x1, 1, C);
    float dg_m = __shfl_up_sync(kFull, m2, 1, C);
    float dg_s = __shfl_up_sync(kFull, s2, 1, C);
    const uint32_t hd_up = __shfl_up_sync(kFull, hd, 1, C);
    if (li == 0) {
      up_m = t_um;
      up_x = t_ux;
      dg_m = t_dm;
      dg_s = t_ds;
      hd = t_h;
      if (valid) {  // step t + 1 reads positions t + 1 and t + 2
        t_dm = t_um;
        t_ds = t + 1 <= hc ? a.top_s[tb + (t + 1) * B] : 0.f;
        t_um = t + 2 <= hc ? a.top_m[tb + (t + 2) * B] : 0.f;
        t_ux = t + 2 <= hc ? a.top_x[tb + (t + 2) * B] : 0.f;
        t_h = t + 1 < hc ? (uint32_t)a.hap[hb + (t + 1) * B] : kPadMask;
      }
    } else {
      hd = hd_up;
    }
    const int j = t - li;
    float m = 0.f, x = 0.f, y = 0.f;
    if (j >= 0 && j < hc) {
      float left_m = m1, left_y = y1;
      if (j == 0) {  // column -1 is the left edge
        dg_m = e_dm;
        dg_s = e_ds;
        left_m = e_lm;
        left_y = e_ly;
      }
      const float distm =
          hd >= kPadMask ? 0.0f : ((hd & rmask) ? em_m : em_x);
      m = distm * (p_mm * dg_m + p_gapm * dg_s);
      x = p_mx * up_m + p_xx * up_x;
      y = p_my * left_m + p_yy * left_y;
      if (valid) {
        if (li == C - 1) {
          a.bot_m[hb + j * B] = m;
          a.bot_x[hb + j * B] = x;
          a.bot_s[hb + j * B] = x + y;
        }
        if (j == hc - 1) {
          const int64_t rb = (s * C + li) * B + b;
          a.red_m[rb] = m;
          a.red_y[rb] = y;
          a.red_s[rb] = x + y;
        }
      }
    }
    m2 = m1;
    s2 = s1;
    m1 = m;
    x1 = x;
    y1 = y;
    s1 = x + y;
  }
}

template <int C>
int launch(const BandArgs& a, void* stream) {
  const int64_t threads = (int64_t)a.slots * a.batch * C;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  pairhmm_band_kernel<C>
      <<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pairhmm_band_chunk(const float* coef, const int32_t* rs,
                       const int32_t* hap, const float* top_m,
                       const float* top_x, const float* top_s,
                       const float* edge_m, const float* edge_y,
                       const float* edge_s, float* bot_m, float* bot_x,
                       float* bot_s, float* red_m, float* red_y, float* red_s,
                       int slots, int chunk_rows, int hc, int batch,
                       void* stream) {
  if (slots < 0 || batch < 0 || hc < 1) return (int)cudaErrorInvalidValue;
  if (slots == 0 || batch == 0) return 0;
  const BandArgs a{coef,  rs,    hap,   top_m, top_x, top_s, edge_m, edge_y,
                   edge_s, bot_m, bot_x, bot_s, red_m, red_y, red_s,
                   slots, hc,    batch};
  switch (chunk_rows) {
    case 8:
      return launch<8>(a, stream);
    case 16:
      return launch<16>(a, stream);
    case 32:
      return launch<32>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
