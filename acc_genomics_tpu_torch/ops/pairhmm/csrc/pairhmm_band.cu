// PairHMM band kernel for Hopper (sm_90a): one superstep of the DP x SP
// pipeline (acc_genomics_tpu_torch/parallel/sharded.py) on one device.
//
// Replaces the TPU kernel acc_genomics_tpu/ops/pairhmm/band_kernel.py
// `_make_band_kernel` (launched by `pairhmm_band_chunk`).
//
// What it computes: for every active slot (a mesh position: shard k of a
// data group) and every lane (a (read, hap) pair) of the slot, chunk
// c = t - k of C read rows across the shard's slab of hc haplotype
// columns.  The cell arithmetic is pairhmm_forward.cu's:
//     M(i,j) = distm(i,j) * (pMM(i) M(i-1,j-1) + pGapM(i) S(i-1,j-1))
//     X(i,j) = pMX(i) M(i-1,j) + pXX(i) X(i-1,j)
//     Y(i,j) = pMY(i) M(i,j-1) + pYY(i) Y(i,j-1),   S = X + Y.
// Boundaries and the pipeline state live on the device between launches:
//   tops  (2, 3, slots, bd, hc): the row above the chunk (M, X, S) at each
//         slab column, lane-major; superstep t reads buffer t % 2 and
//         writes its bottom row into the other, so no copy is needed;
//         chunk 0 reads nothing and takes row -1 (0, 0, y0);
//   edges (3, cols, bd, rows + 1): each slot's right-edge column (M, Y, S),
//         position r + 1 holding row r; a slot reads its left neighbour's
//         column (position r0 + k is row r0 - 1 + k), shard 0 reads zeros,
//         and position 0 of chunk 0 is the corner (0, 0, y0);
//   res   (slots, bd): the last chunk's bottom-row X summed in column
//         order, the shard's share of the forward probability.
// Front ends (template parameter): kCoef reads the eight fp32 coefficient
// planes, int32 codes and y0 of a pack.py pack (absorbing rows packed);
// kQualsArith / kQualsGather read uint8 q, i, d, c and code planes and
// expand each row once a chunk as pairhmm_forward.cu does (rows past rslen
// absorbing), with y0 = initial_constant / haplen.  Both take the
// haplotype as uint8 codes, lane-major, and build the match masks here.
//
// Design: C is 8, 16 or 32 and a chunk is one segment of C lanes of a
// warp; lane li owns chunk row li and walks the anti-diagonals t = li + j.
// M, X and S of row li - 1 reach row li by __shfl_up_sync (the diagonal
// term is the value received one step earlier), so there is no barrier.
//   * Streams a tile ahead: the segment loads 32 slab columns of the top
//     row and the haplotype codes at once, coalesced, into registers, and
//     stores them into a 4-tile ring in shared memory one tile later (the
//     masks made then); row 0 reads its top cell and every row its match
//     mask from the ring, so a load's latency hides behind 32 steps of
//     arithmetic.  The 32 steps of a tile in the slab's interior are
//     unrolled, without the checks of its edges.
//   * Bottom row out C columns at a time: lane C - 1 stages its cells in
//     shared memory and the segment stores them coalesced, straight into
//     the next superstep's top buffer.
//
// Numerics: built without fast math (-ftz=false -prec-div=true), as the
// other PairHMM kernel.
//
// Bound on this card: instruction issue and the shared-memory pipe.  An
// interior step is about 26 instructions a warp for one cell a lane, five
// of them shuffles and shared loads and stores; bytes (the top row in and the
// bottom row out, 24 a column a lane) and operations (13 fp32 a cell) are
// below the card's rates.  At C = 8 a superstep has a quarter of the
// warps of C = 32, too few to hide the step's dependent chain.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "pairhmm_common.cuh"

namespace {

using namespace pairhmm;

constexpr int kThreads = 128;
constexpr int kTile = 32;          // slab columns a segment loads at once
constexpr int kRing = 4 * kTile;   // ring entries a problem
constexpr unsigned kFull = 0xffffffffu;

struct BandArgs {
  const void* plane[8];  // kCoef: 8 fp32 planes; quals: q, i, d, c (uint8)
  const void* rs;        // (rows, lanes) codes: int32 (kCoef) or uint8
  const float* y0;       // (lanes,) kCoef only
  const int32_t* rslen;  // (lanes,) quals only
  const int32_t* haplen;
  const float* ph2pr;  // gather only
  const float* m2m;
  float ic;
  const uint8_t* hap;     // (lanes, cols) codes
  const int32_t* slots;   // (n_slots, 3): shard, lane offset, left column
  float* tops;            // (2, 3, n_slots, bd, hc)
  float* edges;           // (3, n_cols, bd, rows + 1)
  float* res;             // (n_slots, bd)
  int n_slots, n_cols, first, t, rows, cols, hc, lanes, bd, n_chunks;
};

template <int C, int FE>
__global__ void __launch_bounds__(kThreads) pairhmm_band_kernel(BandArgs a) {
  constexpr int P = kThreads / C;  // problems (lanes of the batch) a block
  constexpr int K = kTile / C;     // columns a lane loads a tile
  __shared__ float4 ring[P][kRing];   // the top row's (M, X, S); row 0 reads it
  __shared__ uint32_t hmask[P][kRing];  // the match masks; every row reads them
  __shared__ float4 stage[P][2 * C];

  const int li = threadIdx.x % C;
  const int pl = threadIdx.x / C;
  const int slot = a.first + blockIdx.y;
  const int shard = a.slots[3 * slot];
  const int left = a.slots[3 * slot + 2];
  const int c = a.t - shard;
  const int r0 = c * C;
  const int b = blockIdx.x * P + pl;
  const bool valid = b < a.bd;
  const int64_t lane = (int64_t)a.slots[3 * slot + 1] + (valid ? b : 0);
  const int64_t bb = valid ? b : 0;
  const bool first_chunk = c == 0, last_chunk = c == a.n_chunks - 1;
  const int hc = a.hc;

  // this lane's chunk row
  RowCoef cf = absorbing_row();
  float y0 = 0.0f;
  if (valid) {
    const int64_t at = (int64_t)(r0 + li) * a.lanes + lane;
    if constexpr (FE == kCoef) {
      cf.p_mm = ((const float*)a.plane[0])[at];
      cf.p_gapm = ((const float*)a.plane[1])[at];
      cf.p_mx = ((const float*)a.plane[2])[at];
      cf.p_xx = ((const float*)a.plane[3])[at];
      cf.p_my = ((const float*)a.plane[4])[at];
      cf.p_yy = ((const float*)a.plane[5])[at];
      cf.em_m = ((const float*)a.plane[6])[at];
      cf.em_x = ((const float*)a.plane[7])[at];
      cf.rmask = read_code_mask(((const int32_t*)a.rs)[at]);
      y0 = a.y0[lane];
    } else {
      if (r0 + li < a.rslen[lane])
        cf = expand_quals_row<FE>(
            ((const uint8_t*)a.plane[0])[at], ((const uint8_t*)a.plane[1])[at],
            ((const uint8_t*)a.plane[2])[at], ((const uint8_t*)a.plane[3])[at],
            ((const uint8_t*)a.rs)[at], a.ph2pr, a.m2m);
      const int hl = a.haplen[lane];
      y0 = hl > 0 ? __fdiv_rn(a.ic, (float)hl) : 0.0f;
    }
  }

  // the left edge of row li: column -1 at rows r0 - 1 + li and r0 + li
  const int64_t col_len = a.rows + 1;
  const int64_t eq = (int64_t)a.n_cols * a.bd * col_len;  // stream stride
  float e_dm = 0.0f, e_ds = 0.0f, e_lm = 0.0f, e_ly = 0.0f;
  if (valid && left >= 0) {
    const float* e = a.edges + ((int64_t)left * a.bd + bb) * col_len + r0 + li;
    e_dm = e[0];
    e_ds = e[2 * eq];
    e_lm = e[1];
    e_ly = e[eq + 1];
  }
  if (first_chunk && li == 0) {  // the corner (-1, -1): row -1's S
    e_dm = 0.0f;
    e_ds = y0;
  }

  // the top row (buffer t % 2) and the bottom row (the other buffer)
  const int64_t tq = (int64_t)a.n_slots * a.bd * hc;  // stream stride
  const int par = a.t & 1;
  const int64_t tb = ((int64_t)slot * a.bd + bb) * hc;
  const float* top_in = a.tops + par * 3 * tq + tb;
  float* top_out = a.tops + (par ^ 1) * 3 * tq + tb;
  const uint8_t* hp = a.hap + lane * a.cols + (int64_t)shard * hc;

  // a tile's loads go into registers and are first used (masks made,
  // stored into the ring) one tile later, so no step waits on them
  float tm[K], tx[K], ts[K];
  int tcode[K];
  auto load_tile = [&](int v) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const int col = v * kTile + kk * C + li;
      const bool in = valid && col < hc;
      tm[kk] = tx[kk] = 0.0f;
      ts[kk] = in && first_chunk ? y0 : 0.0f;  // row -1: M = X = 0, S = y0
      tcode[kk] = kHapPad;
      if (in) {
        tcode[kk] = hp[col];
        if (!first_chunk) {
          tm[kk] = top_in[col];
          tx[kk] = top_in[tq + col];
          ts[kk] = top_in[2 * tq + col];
        }
      }
    }
  };
  float4* const my_ring = ring[pl];
  uint32_t* const my_mask = hmask[pl];
  auto store_tile = [&](int v) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const int at = (v * kTile + kk * C + li) & (kRing - 1);
      my_ring[at] = make_float4(tm[kk], tx[kk], ts[kk], 0.0f);
      my_mask[at] = hap_code_mask(tcode[kk]);
    }
  };
  load_tile(0);
  store_tile(0);
  load_tile(1);

  float4* const my_stage = stage[pl];
  float* const redge = a.edges + ((int64_t)slot * a.bd + bb) * col_len + r0 + li + 1;
  const bool bottom_lane = li == C - 1;
  const bool sums = bottom_lane && last_chunk;
  float m1 = 0.0f, x1 = 0.0f, y1 = 0.0f, s1 = 0.0f;  // own cell, step t - 1
  float pu_m = 0.0f, pu_s = 0.0f;  // the cell above, received at step t - 1
  float acc = 0.0f;
  const int n_steps = hc + C - 1;

  // step t of the chunk, s = t mod kTile (a tile starts at a multiple of
  // kTile, so of C).  EDGE: the tile may hold column -1 (j == 0), columns
  // past the slab, the right edge or the last bottom columns; in a tile
  // without them (all but two or three of a chunk) those checks are left
  // out of the unrolled steps.
  auto step = [&](auto edge, int t, int s) {
    constexpr bool EDGE = decltype(edge)::value;
    const int j = t - li;
    const uint32_t hd = my_mask[j & (kRing - 1)];
    float up_m = __shfl_up_sync(kFull, m1, 1, C);
    float up_x = __shfl_up_sync(kFull, x1, 1, C);
    float up_s = __shfl_up_sync(kFull, s1, 1, C);
    if (li == 0) {  // row 0: the top row at column j
      const float4 e = my_ring[t & (kRing - 1)];
      up_m = e.x;
      up_x = e.y;
      up_s = e.z;
    }
    float dg_m = pu_m, dg_s = pu_s;  // the cell above at column j - 1
    pu_m = up_m;
    pu_s = up_s;
    float left_m = m1, left_y = y1;
    if (EDGE && j == 0) {  // column -1 is the left edge
      dg_m = e_dm;
      dg_s = e_ds;
      left_m = e_lm;
      left_y = e_ly;
    }
    const Cell cl = cell(cf, hd, dg_m, dg_s, up_m, up_x, left_m, left_y);
    float m = cl.m, x = cl.x, y = cl.y;
    if (EDGE && (j < 0 || j >= hc)) m = x = y = 0.0f;  // outside the slab
    const float sxy = __fadd_rn(x, y);
    if (EDGE && j == hc - 1 && valid) {  // the right edge, into this slot's column
      redge[0] = m;
      redge[eq] = y;
      redge[2 * eq] = sxy;
    }
    const int jb = t - (C - 1);  // the bottom row's column, on every lane
    if (bottom_lane && (!EDGE || jb >= 0)) my_stage[jb & (2 * C - 1)] = make_float4(m, x, sxy, 0.0f);
    if (sums && (!EDGE || jb >= 0)) acc = __fadd_rn(acc, x);
    m1 = m;
    x1 = x;
    y1 = y;
    s1 = sxy;
    // the bottom row out C columns at a time
    if ((!EDGE || jb >= 0) &&
        (((s - (C - 1)) & (C - 1)) == C - 1 || (EDGE && jb == hc - 1))) {
      __syncwarp();
      const int col = jb - (jb & (C - 1)) + li;
      if (valid && (!EDGE || col <= jb)) {
        const float4 o = my_stage[col & (2 * C - 1)];
        top_out[col] = o.x;
        top_out[tq + col] = o.y;
        top_out[2 * tq + col] = o.z;
      }
    }
  };

  for (int t0 = 0; t0 < n_steps; t0 += kTile) {
    // ring: tile v is read during tiles v and v + 1; tile v + 1 goes in
    // now (loaded one tile ago), tile v + 2 is loaded for the next tile
    const int v = t0 / kTile;
    __syncwarp();
    store_tile(v + 1);
    load_tile(v + 2);
    if (t0 >= C && t0 + kTile < hc) {  // j in [1, hc - 2] on every lane
#pragma unroll
      for (int s = 0; s < kTile; ++s) step(std::false_type{}, t0 + s, s);
    } else {
      const int n = min(kTile, n_steps - t0);
      for (int s = 0; s < n; ++s) step(std::true_type{}, t0 + s, s);
    }
  }
  if (valid && sums) a.res[(int64_t)slot * a.bd + b] = acc;
}

template <int C, int FE>
int launch(const BandArgs& a, int n_active, void* stream) {
  constexpr int P = kThreads / C;
  const dim3 grid((unsigned)((a.bd + P - 1) / P), (unsigned)n_active);
  pairhmm_band_kernel<C, FE><<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <int C>
int launch_front(int front, const BandArgs& a, int n_active, void* stream) {
  switch (front) {
    case kCoef:
      return launch<C, kCoef>(a, n_active, stream);
    case kQualsArith:
      return launch<C, kQualsArith>(a, n_active, stream);
    case kQualsGather:
      return launch<C, kQualsGather>(a, n_active, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One superstep on one device: slots first .. first + n_active - 1 run
// their chunk t - shard.  planes: 8 device pointers (kCoef: the fp32
// coefficient planes; quals: q, i, d, c and 4 unused).  Returns a
// cudaError_t (0 on success).
int pairhmm_band_superstep(int front, int chunk_rows, const void* const* planes,
                           const void* rs, const float* y0,
                           const int32_t* rslen, const int32_t* haplen,
                           const float* ph2pr, const float* m2m, float ic,
                           const uint8_t* hap, const int32_t* slots,
                           float* tops, float* edges, float* res, int n_slots,
                           int n_cols, int first, int n_active, int t,
                           int rows, int cols, int hc, int lanes, int bd,
                           int n_chunks, void* stream) {
  if (n_active < 0 || first < 0 || first + n_active > n_slots || hc < 1 ||
      bd < 0 || n_cols < n_slots || chunk_rows < 1 || rows % chunk_rows ||
      n_active > 65535)
    return (int)cudaErrorInvalidValue;
  if (n_active == 0 || bd == 0) return 0;
  BandArgs a;
  for (int k = 0; k < 8; ++k) a.plane[k] = planes[k];
  a.rs = rs;
  a.y0 = y0;
  a.rslen = rslen;
  a.haplen = haplen;
  a.ph2pr = ph2pr;
  a.m2m = m2m;
  a.ic = ic;
  a.hap = hap;
  a.slots = slots;
  a.tops = tops;
  a.edges = edges;
  a.res = res;
  a.n_slots = n_slots;
  a.n_cols = n_cols;
  a.first = first;
  a.t = t;
  a.rows = rows;
  a.cols = cols;
  a.hc = hc;
  a.lanes = lanes;
  a.bd = bd;
  a.n_chunks = n_chunks;
  switch (chunk_rows) {
    case 8:
      return launch_front<8>(front, a, n_active, stream);
    case 16:
      return launch_front<16>(front, a, n_active, stream);
    case 32:
      return launch_front<32>(front, a, n_active, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
