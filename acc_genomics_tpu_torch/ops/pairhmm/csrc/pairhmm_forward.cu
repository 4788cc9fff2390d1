// Batched fp32 PairHMM forward pass for Hopper (sm_90a).
//
// Replaces the TPU kernel acc_genomics_tpu/ops/pairhmm/kernel.py
// `_pairhmm_diag_kernel` (launched by `pairhmm_forward_pallas` and, with
// the quals expansion of `pairhmm_forward_pallas_from_quals` in front of
// it, by the engine's byte-plane route).
//
// What it computes (reference.py, GATK 3.7 semantics): the M/X/Y forward
// recurrence over a (read x hap) matrix (pairhmm_common.cuh `cell`):
//     M(i,j) = distm(i,j) * (pMM(i) M(i-1,j-1) + pGapM(i) (X+Y)(i-1,j-1))
//     X(i,j) = pMX(i) M(i-1,j) + pXX(i) X(i-1,j)
//     Y(i,j) = pMY(i) M(i,j-1) + pYY(i) Y(i,j-1)
// Row -1 holds M = X = 0 and Y = initial_constant / haplen; column -1 is 0.
// The result is the sum over j of M + X in the last read row, summed in
// column order (the TPU kernel reaches the same value through the
// absorbing collector rows of pack.py).
//
// Design: a segment of C lanes (C = 8, 16 or 32, the smallest that holds
// the launch's rows, at most 32) takes one pair, with the wavefront of the
// band kernel (pairhmm_band.cu) run over the whole pair:
//   * lane li owns row c*C + li of chunk c and walks the anti-diagonals:
//     at step t of a chunk it computes column j = t - li.  M, X and S of
//     the row above arrive by __shfl_up_sync (the diagonal term is the
//     value received one step earlier), and so does the column's match
//     mask, so no step waits on a barrier;
//   * the chunks of a pair run one after another in the segment, each
//     C + haplen - 1 steps, so a short read in a tall bucket runs only the
//     chunks its rows need; every segment of a warp runs its own pair and
//     trip count, and the warp runs until its longest pair is done;
//   * row 0 of a chunk reads the row above from shared memory: one float4
//     a hap column, (M, X, S) of the previous chunk's bottom row and the
//     column's match mask, made once a pair with row -1 in it.  The bottom
//     lane writes column j at step j + C - 1 and row 0 of the next chunk
//     reads it at its step j, so one buffer a segment, updated in place,
//     is enough.  Only C = 32 has more than one chunk; C = 8 and 16 keep
//     only the masks (one byte a column) and read row -1 as constants.
//     Row 0 loads each column a step ahead, off the step's dependent chain;
//   * steps run in tiles of 8 (a chunk's steps rounded up to whole tiles):
//     a segment changes chunk only between tiles, and a tile in which
//     every lane's column lies inside the haplotype runs unrolled without
//     the edge checks;
//   * the next chunk's row inputs are fetched a chunk ahead, so a chunk
//     change waits on no device-memory load.
//
// Front ends (template parameter):
//   kCoef        8 fp32 coefficient planes, int32 codes, y0 per pair; all
//                `rows` rows run and the last (absorbing) row collects X.
//   kQualsArith  uint8 q/i/d/c/rs/hap planes + rslen/haplen; coefficients
//                are expanded at each chunk's start: ph2pr(q) =
//                exp2(q * -log2(10)/10), pMM = 1 - min(1, ph2pr(i) + ph2pr(d)).
//   kQualsGather the same planes; coefficients from the 128-entry ph2pr
//                table and the triangular matchToMatch table.
//   The quals front ends run rows < rslen only and collect M + X at row
//   rslen - 1, which equals the absorbing row's X bit for bit.  Inert
//   lanes (no rows or no haplotype) give exactly 0.
//
// Numerics: built without fast math (-ftz=false -prec-div=true), so
// denormals survive as on the host, and em_mis = ph2pr(q) / 3 is a true
// division; each cell's rounding is written out (pairhmm_common.cuh).
//
// Bound on this card: instruction issue and, in small launches, the
// latency of a step's chain (a shuffle and three dependent fp32
// operations).  An interior step is about 32 instructions a warp for up
// to one cell a lane, four of them shuffles, one a shared-memory load
// (row 0) and one a store (the bottom row); bytes (the byte planes once)
// and operations (13 fp32 a cell) are far below the card's rates.  Lanes
// idle on the triangles at each chunk's start and end (C - 1 steps of
// C + haplen - 1), on the padding to whole tiles and on rows past the
// read in its last chunk.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "pairhmm_common.cuh"

namespace {

using namespace pairhmm;

constexpr int kMaxRows = 1024;  // a read as long as the longest haplotype
constexpr int kMaxCols = 1024;
constexpr int kThreads = 128;
constexpr int kTile = 8;  // steps between a segment's checks
constexpr int kPad = 48;  // columns a step may read past cols (C + kTile + 8)
constexpr unsigned kFull = 0xffffffffu;

struct CoefPlanes {
  const float* p_mm;
  const float* p_gapm;
  const float* p_mx;
  const float* p_xx;
  const float* p_my;
  const float* p_yy;
  const float* em_m;
  const float* em_x;
  const int32_t* rs;
  const int32_t* hap;  // (rows + cols, batch)
  const float* y0;
};

struct QualPlanes {
  const uint8_t* q;
  const uint8_t* iq;
  const uint8_t* dq;
  const uint8_t* cq;
  const uint8_t* rs;
  const uint8_t* hap;  // (rows + cols, batch)
  const int32_t* rslen;
  const int32_t* haplen;
  const float* ph2pr;  // 128 entries (gather only)
  const float* m2m;    // triangular matchToMatch (gather only)
  float initial_constant;
};

// A read row's inputs, fetched a chunk before the row runs, and its
// coefficients
struct CoefRaw {
  float v[8];
  int code;
};
struct QualRaw {
  int q, i, d, c, code;
};

__device__ __forceinline__ CoefRaw fetch_row(const CoefPlanes& c, int64_t at) {
  return CoefRaw{{c.p_mm[at], c.p_gapm[at], c.p_mx[at], c.p_xx[at], c.p_my[at],
                  c.p_yy[at], c.em_m[at], c.em_x[at]},
                 c.rs[at]};
}
__device__ __forceinline__ QualRaw fetch_row(const QualPlanes& a, int64_t at) {
  return QualRaw{a.q[at], a.iq[at], a.dq[at], a.cq[at], a.rs[at]};
}

template <int FE>
__device__ __forceinline__ RowCoef expand_row(const CoefPlanes&, const CoefRaw& r) {
  RowCoef cf;
  cf.p_mm = r.v[0];
  cf.p_gapm = r.v[1];
  cf.p_mx = r.v[2];
  cf.p_xx = r.v[3];
  cf.p_my = r.v[4];
  cf.p_yy = r.v[5];
  cf.em_m = r.v[6];
  cf.em_x = r.v[7];
  cf.rmask = read_code_mask(r.code);
  return cf;
}
template <int FE>
__device__ __forceinline__ RowCoef expand_row(const QualPlanes& a, const QualRaw& r) {
  return expand_quals_row<FE>(r.q, r.i, r.d, r.c, r.code, a.ph2pr, a.m2m);
}

// dynamic shared memory of a block: per segment cols + kPad float4 (C =
// 32) or mask bytes (C < 32); entries past the haplotype are never
// written, and read only for cells outside it (row 0 loads a step ahead)
template <int C>
constexpr int column_bytes() {
  return C == 32 ? (int)sizeof(float4) : 1;
}

template <int C, int FE, typename Args>
__global__ void __launch_bounds__(kThreads)
    pairhmm_forward_kernel(Args a, int rows, int cols, int batch, float* out) {
  constexpr int kSegs = kThreads / C;
  constexpr bool kChunked = C == 32;  // a pair may have several chunks
  extern __shared__ __align__(16) unsigned char smem[];

  const int li = threadIdx.x % C;
  const int sg = threadIdx.x / C;
  // a warp whose segments all lie past the batch leaves whole
  if (blockIdx.x * kSegs + (threadIdx.x / 32) * (32 / C) >= batch) return;
  const int b = blockIdx.x * kSegs + sg;
  const bool valid = b < batch;
  const int64_t bb = valid ? b : 0;
  float4* const ring = (float4*)smem + (int64_t)sg * (cols + kPad);
  uint8_t* const masks = smem + (int64_t)sg * (cols + kPad);

  // the pair's rows, haplotype length and row -1
  int nrows = 0, haplen = 0;
  float y0 = 0.0f;
  if constexpr (FE == kCoef) {
    int hl = 0;
    for (int j = li; j < cols; j += C)
      if (hap_code_mask(a.hap[(int64_t)j * batch + bb]) != kPadMask) hl = j + 1;
#pragma unroll
    for (int d = 1; d < C; d <<= 1) hl = max(hl, __shfl_xor_sync(kFull, hl, d, C));
    if (valid) {
      nrows = rows;
      haplen = hl;
      y0 = a.y0[b];
    }
  } else {
    if (valid) {
      nrows = min(a.rslen[b], rows);
      haplen = min(a.haplen[b], cols);
      y0 = haplen > 0 ? __fdiv_rn(a.initial_constant, (float)haplen) : 0.0f;
    }
  }
  if (nrows <= 0 || haplen <= 0) nrows = haplen = 0;  // inert: exactly 0
  for (int j = li; j < haplen; j += C) {
    const uint32_t hm = hap_code_mask(a.hap[(int64_t)j * batch + bb]);
    if constexpr (kChunked)
      ring[j] = make_float4(0.0f, 0.0f, y0, __uint_as_float(hm));
    else
      masks[j] = (uint8_t)hm;
  }
  __syncwarp();

  // a chunk runs C + haplen - 1 steps, rounded up to whole tiles
  const int steps = (C + haplen - 1 + kTile - 1) / kTile * kTile;
  const int n_chunks = (nrows + C - 1) / C;
  const int warp_total = __reduce_max_sync(kFull, n_chunks * steps);

  int c = 0, t = 0;
  RowCoef cf = absorbing_row();
  if (li < nrows) cf = expand_row<FE>(a, fetch_row(a, (int64_t)li * batch + bb));
  decltype(fetch_row(a, 0)) next{};  // the row of the next chunk
  if (C + li < nrows) next = fetch_row(a, (int64_t)(C + li) * batch + bb);
  bool collect = li == nrows - 1;  // this lane's row is the last
  float m1 = 0.0f, x1 = 0.0f, y1 = 0.0f, s1 = 0.0f;  // own cell, step t - 1
  uint32_t hd1 = kPadMask;
  // the cell above, received at step t - 1 (for row 0: the corner)
  float pu_m = 0.0f, pu_s = li == 0 ? y0 : 0.0f;
  float acc = 0.0f;
  // row 0's row above (M, X, S and the mask) at column t + s, loaded a
  // step ahead, off the step's dependent chain
  auto row_above = [&](int col) {
    if constexpr (kChunked) return ring[col];
    return make_float4(0.0f, 0.0f, y0, __uint_as_float(masks[col]));
  };
  float4 top = row_above(0);

  // step t + s; EDGE: some lane's column may lie outside [0, haplen)
  auto step = [&](auto edge, int s) {
    constexpr bool EDGE = decltype(edge)::value;
    const int j = t + s - li;
    float up_m = __shfl_up_sync(kFull, m1, 1, C);
    float up_x = __shfl_up_sync(kFull, x1, 1, C);
    float up_s = __shfl_up_sync(kFull, s1, 1, C);
    uint32_t hd = __shfl_up_sync(kFull, hd1, 1, C);
    if (li == 0) {
      up_m = top.x;
      up_x = top.y;
      up_s = top.z;
      hd = __float_as_uint(top.w);
    }
    top = row_above(t + s + 1);  // before this step's store
    const float dg_m = pu_m, dg_s = pu_s;
    pu_m = up_m;
    pu_s = up_s;
    const Cell cl = cell(cf, hd, dg_m, dg_s, up_m, up_x, m1, y1);
    float m = cl.m, x = cl.x, y = cl.y;
    const bool in = !EDGE || (j >= 0 && j < haplen);
    if (!in) m = x = y = 0.0f;  // column -1 and past the haplotype
    const float sxy = __fadd_rn(x, y);
    if (collect && in) acc = __fadd_rn(acc, FE == kCoef ? x : __fadd_rn(m, x));
    if constexpr (kChunked) {
      if (li == C - 1 && in) ring[j] = make_float4(m, x, sxy, __uint_as_float(hd));
    }
    m1 = m;
    x1 = x;
    y1 = y;
    s1 = sxy;
    hd1 = hd;
  };

  for (int t_warp = 0; t_warp < warp_total; t_warp += kTile) {
    if (t == steps) {  // this segment's next chunk
      t = 0;
      ++c;
      const int r = c * C + li;
      if (r < nrows) cf = expand_row<FE>(a, next);
      if (r + C < nrows) next = fetch_row(a, (int64_t)(r + C) * batch + bb);
      collect = r == nrows - 1;
      m1 = x1 = y1 = s1 = 0.0f;
      pu_m = pu_s = 0.0f;
      if constexpr (kChunked) __syncwarp();  // the bottom row is in
      top = row_above(0);
    }
    if (__all_sync(kFull, t >= C - 1 && t + kTile <= haplen)) {
#pragma unroll
      for (int s = 0; s < kTile; ++s) step(std::false_type{}, s);
    } else {
#pragma unroll
      for (int s = 0; s < kTile; ++s) step(std::true_type{}, s);
    }
    t += kTile;
  }
  if (!valid) return;
  if (nrows == 0) {
    if (li == 0) out[b] = 0.0f;
  } else if (li == (nrows - 1) % C) {
    out[b] = acc;
  }
}

template <int C, int FE, typename Args>
int launch_c(const Args& a, int rows, int cols, int batch, float* out,
             void* stream) {
  constexpr int kSegs = kThreads / C;
  const int smem = kSegs * (cols + kPad) * column_bytes<C>();
  auto kernel = pairhmm_forward_kernel<C, FE, Args>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(batch + kSegs - 1) / kSegs, kThreads, smem, (cudaStream_t)stream>>>(
      a, rows, cols, batch, out);
  return (int)cudaGetLastError();
}

template <int FE, typename Args>
int launch(const Args& a, int rows, int cols, int batch, float* out,
           void* stream) {
  if (rows < 0 || rows > kMaxRows || cols < 0 || cols > kMaxCols || batch < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  if (rows <= 8) return launch_c<8, FE>(a, rows, cols, batch, out, stream);
  if (rows <= 16) return launch_c<16, FE>(a, rows, cols, batch, out, stream);
  return launch_c<32, FE>(a, rows, cols, batch, out, stream);
}

}  // namespace

extern "C" {

int pairhmm_forward_coef(const float* p_mm, const float* p_gapm,
                         const float* p_mx, const float* p_xx,
                         const float* p_my, const float* p_yy,
                         const float* em_m, const float* em_x,
                         const int32_t* rs, const int32_t* hap,
                         const float* y0, int rows, int cols, int batch,
                         float* out, void* stream) {
  const CoefPlanes a{p_mm, p_gapm, p_mx, p_xx, p_my, p_yy,
                     em_m, em_x, rs, hap, y0};
  return launch<kCoef>(a, rows, cols, batch, out, stream);
}

int pairhmm_forward_quals(const uint8_t* q, const uint8_t* iq,
                          const uint8_t* dq, const uint8_t* cq,
                          const uint8_t* rs, const uint8_t* hap,
                          const int32_t* rslen, const int32_t* haplen,
                          const float* ph2pr, const float* m2m,
                          float initial_constant, int gather, int rows,
                          int cols, int batch, float* out, void* stream) {
  const QualPlanes a{q, iq, dq, cq, rs, hap, rslen, haplen,
                     ph2pr, m2m, initial_constant};
  if (gather)
    return launch<kQualsGather>(a, rows, cols, batch, out, stream);
  return launch<kQualsArith>(a, rows, cols, batch, out, stream);
}

}  // extern "C"
