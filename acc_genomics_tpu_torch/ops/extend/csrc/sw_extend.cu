// Banded BWA-MEM seed extension (ksw_extend2 semantics) for Hopper (sm_90a).
//
// Replaces the Pallas kernel acc_genomics_tpu/ops/extend/kernel.py
// `_extend_kernel` (launched by `sw_extend_pallas`).  What it computes is
// the reference's sw_extend (bwa-sw/sdaccel/smithwaterman.cpp:75-273), as
// the native host engine transcribes it (native/accnative.cpp:774-878,
// `sw_extend_batch_native`), statement for statement, because the results
// are compared as exact integers:
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
// Design: one thread per task, the scalar loop in registers.  The TPU
// kernel's per-block trip counts, sliding query window and Kogge-Stone F
// ladder exist because 128 lanes run in lockstep; a thread per task needs
// none of them: it runs its own rows and stops at its own break.  The
// eh_h / eh_e rows live in a global scratch laid out (2, Q + 2, B), so the
// threads of a warp that stand at the same query column read neighbouring
// words; neighbouring tasks drift apart in j as their bands narrow, so the
// accesses coalesce only partly and the L1 and L2 caches take the rest.
// Inputs are time-major like the JAX contract: query (Q, B) and target
// (T, B) uint8 codes, code 4 (or above) ambiguous.
// Bound on this card: the dependent chain of a row (each cell needs the
// previous one's f and h1) and the scratch traffic, about 8 bytes read and
// 8 written per cell; the band is at most 2w + 1 wide.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Params {
  int o_del, e_del, o_ins, e_ins, w, sc_match, sc_mismatch, sc_ambig;
};

__global__ void sw_extend_kernel(const uint8_t* __restrict__ query,
                                 const uint8_t* __restrict__ target,
                                 const int32_t* __restrict__ qlens,
                                 const int32_t* __restrict__ tlens,
                                 const int32_t* __restrict__ h0s,
                                 const int32_t* __restrict__ max_inss,
                                 const int32_t* __restrict__ max_dels,
                                 int qcap, int tcap, int batch, Params p,
                                 int32_t* __restrict__ eh,
                                 int32_t* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int64_t B = batch;
  const int qlen = min(max(qlens[b], 0), qcap);
  const int tlen = min(max(tlens[b], 0), tcap);
  const int h0 = h0s[b];
  const int max_ins = max_inss[b], max_del = max_dels[b];
  const int oe_del = p.o_del + p.e_del, oe_ins = p.o_ins + p.e_ins;
  int32_t* eh_h = eh + b;
  int32_t* eh_e = eh + (int64_t)(qcap + 2) * B + b;
  const uint8_t* q = query + b;
  const uint8_t* t = target + b;
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
      const int t_i = t[i * B];
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
        const int q_j = q[j * B];
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
  out[0 * B + b] = reg_score;
  out[1 * B + b] = max_j + 1;
  out[2 * B + b] = max_i + 1;
  out[3 * B + b] = max_ie + 1;
  out[4 * B + b] = gscore;
  out[5 * B + b] = max_off;
  out[6 * B + b] = band_w;
}

}  // namespace

extern "C" {

// query (Q, B) and target (T, B) uint8; qlen, tlen, h0, max_ins, max_del
// (B,) int32; eh (2, Q + 2, B) int32 scratch (the kernel zeroes each task's
// rows itself); out (7, B) int32.  Returns a cudaError_t (0 on success).
int sw_extend(const uint8_t* query, const uint8_t* target,
              const int32_t* qlen, const int32_t* tlen, const int32_t* h0,
              const int32_t* max_ins, const int32_t* max_del, int qcap,
              int tcap, int batch, int o_del, int e_del, int o_ins,
              int e_ins, int w, int sc_match, int sc_mismatch, int sc_ambig,
              int32_t* eh, int32_t* out, void* stream) {
  if (qcap <= 0 || tcap <= 0 || batch < 0 || w < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const Params p{o_del, e_del, o_ins, e_ins, w, sc_match, sc_mismatch, sc_ambig};
  const int threads = 128;
  sw_extend_kernel<<<(batch + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(query, target, qlen, tlen, h0,
                                             max_ins, max_del, qcap, tcap,
                                             batch, p, eh, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
