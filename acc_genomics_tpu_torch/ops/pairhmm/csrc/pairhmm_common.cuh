// Shared by the PairHMM kernels (pairhmm_forward.cu, pairhmm_band.cu): the
// one-hot match masks, the per-row expansion of quality bytes into the
// eight transition and emission coefficients (the quals front end of
// acc_genomics_tpu/ops/pairhmm/kernel.py `pairhmm_forward_pallas_from_quals`)
// and the arithmetic of one cell.

#pragma once

#include <cstdint>

namespace pairhmm {

constexpr int kBaseN = 4;
constexpr int kHapPad = 5;
constexpr uint32_t kPadMask = 16;
// float32(-log2(10) / 10), as the reference front end rounds it
constexpr float kQualToLog2 = (float)(-3.321928094887362 / 10.0);

enum FrontEnd { kCoef = 0, kQualsArith = 1, kQualsGather = 2 };

__device__ __forceinline__ uint32_t hap_code_mask(int code) {
  return code >= kHapPad ? kPadMask
                         : (code == kBaseN ? 15u : (1u << (code & 31)));
}

__device__ __forceinline__ uint32_t read_code_mask(int code) {
  return code == kBaseN ? 15u : (1u << (code & 31));
}

struct RowCoef {
  float p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, em_m, em_x;
  uint32_t rmask;
};

// an absorbing row (past the read): X collects M + X of the row above
__device__ __forceinline__ RowCoef absorbing_row() {
  RowCoef r;
  r.p_mm = r.p_gapm = r.p_my = r.p_yy = r.em_m = r.em_x = 0.0f;
  r.p_mx = r.p_xx = 1.0f;
  r.rmask = read_code_mask(0);
  return r;
}

template <int FE>
__device__ __forceinline__ float qual_prob(int qv, const float* ph2pr) {
  if (FE == kQualsArith) return exp2f((float)qv * kQualToLog2);
  return ph2pr[qv];
}

// One read row from its quality bytes and base code: arith computes
// ph2pr(q) = exp2(q * -log2(10)/10) and pMM = 1 - min(1, ph2pr(i) +
// ph2pr(d)); gather reads the 128-entry ph2pr and triangular matchToMatch
// tables.  em_mis = ph2pr(q) / 3 is a true division (no fast math).
template <int FE>
__device__ __forceinline__ RowCoef expand_quals_row(int q, int i, int d, int c,
                                                    int code,
                                                    const float* ph2pr,
                                                    const float* m2m) {
  const int qq = q & 127, qi = i & 127, qd = d & 127, qc = c & 127;
  const float pe_q = qual_prob<FE>(qq, ph2pr);
  const float pe_i = qual_prob<FE>(qi, ph2pr);
  const float pe_d = qual_prob<FE>(qd, ph2pr);
  const float pe_c = qual_prob<FE>(qc, ph2pr);
  RowCoef r;
  if (FE == kQualsArith) {
    r.p_mm = 1.0f - fminf(1.0f, pe_i + pe_d);
  } else {
    const int lo = qi < qd ? qi : qd, hi = qi < qd ? qd : qi;
    r.p_mm = m2m[((hi * (hi + 1)) >> 1) + lo];
  }
  r.p_gapm = 1.0f - pe_c;
  r.p_mx = pe_i;
  r.p_xx = pe_c;
  r.p_my = pe_d;
  r.p_yy = pe_c;
  r.em_m = 1.0f - pe_q;
  r.em_x = __fdiv_rn(pe_q, 3.0f);
  r.rmask = read_code_mask(code);
  return r;
}

// One cell (i, j) of the recurrence from the row's coefficients, the hap
// column's match mask and the neighbours: the diagonal (M, S) of (i-1, j-1),
// the cell above (M, X) and the cell to the left (M, Y):
//     M = distm * (pMM M(i-1,j-1) + pGapM S(i-1,j-1))
//     X = pMX M(i-1,j) + pXX X(i-1,j)
//     Y = pMY M(i,j-1) + pYY Y(i,j-1)
// The contractions are written out, so that every kernel and every
// instantiation rounds each cell alike.
struct Cell {
  float m, x, y;
};

__device__ __forceinline__ Cell cell(const RowCoef& cf, uint32_t hd, float dg_m,
                                     float dg_s, float up_m, float up_x,
                                     float left_m, float left_y) {
  const float distm =
      hd >= kPadMask ? 0.0f : ((hd & cf.rmask) ? cf.em_m : cf.em_x);
  return Cell{
      __fmul_rn(distm, __fmaf_rn(cf.p_mm, dg_m, __fmul_rn(cf.p_gapm, dg_s))),
      __fmaf_rn(cf.p_mx, up_m, __fmul_rn(cf.p_xx, up_x)),
      __fmaf_rn(cf.p_my, left_m, __fmul_rn(cf.p_yy, left_y))};
}

}  // namespace pairhmm
