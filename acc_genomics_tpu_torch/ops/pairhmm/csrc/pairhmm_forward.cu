// Batched fp32 PairHMM forward pass for Hopper (sm_90a).
//
// Replaces the TPU kernel acc_genomics_tpu/ops/pairhmm/kernel.py
// `_pairhmm_diag_kernel` (launched by `pairhmm_forward_pallas` and, with
// the quals expansion of `pairhmm_forward_pallas_from_quals` in front of
// it, by the engine's byte-plane route).
//
// What it computes (reference.py, GATK 3.7 semantics): the M/X/Y forward
// recurrence over a (read x hap) matrix, walked in anti-diagonals
// d = i + j (i = read row, j = hap column):
//     M(i,j) = distm(i,j) * (pMM(i) M(i-1,j-1) + pGapM(i) (X+Y)(i-1,j-1))
//     X(i,j) = pMX(i) M(i-1,j) + pXX(i) X(i-1,j)
//     Y(i,j) = pMY(i) M(i,j-1) + pYY(i) Y(i,j-1)
// Row -1 holds M = X = 0 and Y = initial_constant / haplen; column -1 is 0.
// The result is the sum over j of M + X in the last read row, summed in
// column order (the TPU kernel reaches the same value through the
// absorbing collector rows of pack.py).
//
// Design (first, simple and correct):
//   * one thread block per pair, thread i owns read row i (blockDim is
//     the row count rounded up to a warp, at most 256);
//   * the pair's coefficients live in registers; the haplotype is staged
//     once in shared memory as one-hot match masks (1 << base, 15 for N,
//     16 for padding, which never matches);
//   * M, X and X+Y of the last three diagonals live in shared memory
//     (triple buffered), so one __syncthreads() per diagonal orders the
//     writes of diagonal d before the reads of diagonal d + 1;
//   * every pair runs its own trip count, rows + haplen - 1 diagonals:
//     blocks are independent, so no per-128-lane-block bound is needed.
//
// Front ends (template parameter):
//   kCoef        8 fp32 coefficient planes, int32 codes, y0 per pair; all
//                `rows` rows run and the last (absorbing) row collects X.
//   kQualsArith  uint8 q/i/d/c/rs/hap planes + rslen/haplen; coefficients
//                are expanded in the prologue: ph2pr(q) = exp2(q * -log2(10)/10),
//                pMM = 1 - min(1, ph2pr(i) + ph2pr(d)).
//   kQualsGather the same planes; coefficients from the 128-entry ph2pr
//                table and the triangular matchToMatch table.
//   The quals front ends run rows < rslen only and collect M + X at row
//   rslen - 1, which equals the absorbing row's X bit for bit.
//
// Numerics: built without fast math (-ftz=false -prec-div=true), so
// denormals survive as on the host, and em_mis = ph2pr(q) / 3 is a true
// division.
//
// Bound on this card: the latency of one block-wide barrier per diagonal
// with a few dozen instructions between barriers, plus the threads that
// idle on the triangular edges of the wavefront (row i is busy only for
// diagonals i .. i + haplen - 1). The later design is gpuPairHMM's: one
// warp per pair, rows striped over the lanes, the wavefront carried
// between lanes with __shfl_up_sync instead of shared memory and barriers.

#include <cstdint>
#include <cuda_runtime.h>

#include "pairhmm_common.cuh"

namespace {

using namespace pairhmm;

constexpr int kMaxRows = 256;
constexpr int kMaxCols = 1024;

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

template <int FE>
__device__ __forceinline__ RowCoef load_quals_row(const QualPlanes& a,
                                                  int64_t at) {
  return expand_quals_row<FE>(a.q[at], a.iq[at], a.dq[at], a.cq[at], a.rs[at],
                              a.ph2pr, a.m2m);
}

template <int FE, typename Args>
__global__ void __launch_bounds__(kMaxRows)
    pairhmm_forward_kernel(Args a, int rows, int cols, int batch, float* out) {
  __shared__ float s_m[3][kMaxRows];
  __shared__ float s_x[3][kMaxRows];
  __shared__ float s_s[3][kMaxRows];  // X + Y
  __shared__ uint8_t s_hap[kMaxCols];
  __shared__ int s_haplen;

  const int b = blockIdx.x;
  const int i = threadIdx.x;

  int nrows, haplen;
  float y0;
  RowCoef cf = {};
  if constexpr (FE == kCoef) {
    const CoefPlanes& c = a;
    if (i == 0) s_haplen = 0;
    __syncthreads();
    for (int j = i; j < cols; j += blockDim.x) {
      const uint32_t hm = hap_code_mask(c.hap[(int64_t)j * batch + b]);
      s_hap[j] = (uint8_t)hm;
      if (hm != kPadMask) atomicMax(&s_haplen, j + 1);
    }
    nrows = rows;
    y0 = c.y0[b];
    if (i < nrows) {
      const int64_t at = (int64_t)i * batch + b;
      cf.p_mm = c.p_mm[at];
      cf.p_gapm = c.p_gapm[at];
      cf.p_mx = c.p_mx[at];
      cf.p_xx = c.p_xx[at];
      cf.p_my = c.p_my[at];
      cf.p_yy = c.p_yy[at];
      cf.em_m = c.em_m[at];
      cf.em_x = c.em_x[at];
      cf.rmask = read_code_mask(c.rs[at]);
    }
    __syncthreads();
    haplen = s_haplen;
  } else {
    const QualPlanes& q = a;
    nrows = min(q.rslen[b], rows);
    haplen = min(q.haplen[b], cols);
    y0 = haplen > 0 ? __fdiv_rn(q.initial_constant, (float)haplen) : 0.0f;
    for (int j = i; j < haplen; j += blockDim.x)
      s_hap[j] = (uint8_t)hap_code_mask(q.hap[(int64_t)j * batch + b]);
    if (i < nrows) cf = load_quals_row<FE>(q, (int64_t)i * batch + b);
  }
  if (nrows <= 0 || haplen <= 0) {  // inert lane: exactly 0
    if (i == 0) out[b] = 0.0f;
    return;
  }

  // cells with j < 0 (column -1 and the not-yet-reached wavefront) are 0
  for (int k = 0; k < 3; ++k) {
    s_m[k][i] = 0.0f;
    s_x[k][i] = 0.0f;
    s_s[k][i] = 0.0f;
  }
  __syncthreads();

  const int last = nrows - 1;
  const int ndiag = nrows + haplen - 1;
  float m_left = 0.0f, y_left = 0.0f, acc = 0.0f;  // own cell at d - 1
  int cur = 0, prv1 = 2, prv2 = 1;                 // slots of d, d-1, d-2
  for (int d = 0; d < ndiag; ++d) {
    if (i < nrows) {
      const int j = d - i;
      float m = 0.0f, x = 0.0f, y = 0.0f;
      if (j >= 0 && j < haplen) {
        float up_m = 0.0f, up_x = 0.0f, dg_m = 0.0f, dg_s = y0;  // row -1
        if (i > 0) {
          up_m = s_m[prv1][i - 1];
          up_x = s_x[prv1][i - 1];
          dg_m = s_m[prv2][i - 1];
          dg_s = s_s[prv2][i - 1];
        }
        const uint32_t hm = s_hap[j];
        const float distm =
            hm >= kPadMask ? 0.0f : ((hm & cf.rmask) ? cf.em_m : cf.em_x);
        m = distm * (cf.p_mm * dg_m + cf.p_gapm * dg_s);
        x = cf.p_mx * up_m + cf.p_xx * up_x;
        y = cf.p_my * m_left + cf.p_yy * y_left;
        if (i == last) acc += FE == kCoef ? x : m + x;
      }
      // cells past haplen are padding: they feed no real cell, store 0
      s_m[cur][i] = m;
      s_x[cur][i] = x;
      s_s[cur][i] = x + y;
      m_left = m;
      y_left = y;
    }
    __syncthreads();
    const int t = prv2;
    prv2 = prv1;
    prv1 = cur;
    cur = t;
  }
  if (i == last) out[b] = acc;
}

template <int FE, typename Args>
int launch(const Args& a, int rows, int cols, int batch, float* out,
           void* stream) {
  if (rows < 0 || rows > kMaxRows || cols < 0 || cols > kMaxCols)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const int threads = rows <= 32 ? 32 : (rows + 31) / 32 * 32;
  pairhmm_forward_kernel<FE, Args>
      <<<batch, threads, 0, (cudaStream_t)stream>>>(a, rows, cols, batch, out);
  return (int)cudaGetLastError();
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
