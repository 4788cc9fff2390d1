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
// A second front end, `sw_extend_fused`, replaces the device program
// acc_genomics_tpu/models/bwa_mem.py `_extend_seeds_fused` (which reaches
// the Pallas kernel through `sw_extend_pallas`): per seed, the SA lookup,
// both extensions read in place from the resident reads and text, and the
// clip resolution, into (8, N) int32.  Both front ends run the one
// transcription below (`extend_one`), templated on how a task's query and
// target codes are read.
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

// Task readers: code of query column j / target row i.
struct Strided {  // time-major (L, B) plane, this task's column
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
  const Extension r = extend_one(
      Strided{query + b, B}, Strided{target + b, B}, qlen, tlen, h0s[b],
      max_inss[b], max_dels[b], p, eh + b, eh + (int64_t)(qcap + 2) * B + b, B);
  out[0 * B + b] = r.score;
  out[1 * B + b] = r.qle;
  out[2 * B + b] = r.tle;
  out[3 * B + b] = r.gtle;
  out[4 * B + b] = r.gscore;
  out[5 * B + b] = r.max_off;
  out[6 * B + b] = r.w;
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
