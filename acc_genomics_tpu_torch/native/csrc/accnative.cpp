// Native host runtime for acc_genomics_tpu.
//
// The reference implements its host runtime in C++ (packers, schedulers,
// OpenCL glue); the TPU framework keeps the device path in XLA/Pallas and
// implements the host hot loops here:
//
//   * sais_build       — SA-IS suffix array construction (linear time),
//                        replacing the O(n log^2 n) NumPy prefix doubling
//                        for genome-scale FM-index builds
//                        (role of the reference's external libbwa index load,
//                        smem/main.cpp bwa_idx_load)
//   * cigar_walk_batch — batch backtrack walk over device-produced btrack
//                        matrices -> CIGAR runs (role of
//                        calculateCigarOneBatch, htc-sw/host/FalconSW_AVX.cpp)
//   * pairhmm_pack     — fill the dense time-major transition/emission
//                        coefficient batch from raw reads
//                        (role of pack_fpga_input,
//                        pairhmm/interface/PairHMMFpgaInterface.cpp)
//
// Exposed with a plain C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#endif
#include <cstdlib>
#include <cstring>
#include <climits>
#include <vector>

// ---------------------------------------------------------------------------
// SA-IS suffix array construction (alphabet size K, text values in [0, K)).
// sa must hold n entries. Internal sentinel handling: we append a virtual
// smallest symbol by treating index n as "$" (rank -1).
// ---------------------------------------------------------------------------

namespace {

// generic SA-IS over int sequence s of length n with alphabet [0, K)
// writes suffix order (of the n real suffixes) into sa.
// Index type I is int32_t when the text fits (halves memory traffic —
// SA construction is bandwidth-bound), int64_t otherwise.
template <typename I>
void sais_core(const I* s, I n, I K, I* sa) {
  if (n == 0) return;
  if (n == 1) { sa[0] = 0; return; }

  std::vector<bool> is_s(n + 1);
  is_s[n] = true;              // sentinel is S-type
  is_s[n - 1] = false;         // last real char is L-type (> sentinel)
  for (int64_t i = n - 2; i >= 0; --i)
    is_s[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && is_s[i + 1]);

  auto is_lms = [&](int64_t i) {
    return i > 0 && is_s[i] && !is_s[i - 1];
  };

  std::vector<I> bkt(K + 1);
  auto bucket_ends = [&](bool ends) {
    std::fill(bkt.begin(), bkt.end(), 0);
    for (I i = 0; i < n; ++i) bkt[s[i] + 1]++;
    for (I i = 1; i <= K; ++i) bkt[i] += bkt[i - 1];
    // bkt[c] = start of bucket c; for ends we need end positions
    if (ends) {
      // shift: end of bucket c = bkt[c+1] ... recompute cumulative ends
      std::vector<I> cnt(K, 0);
      for (I i = 0; i < n; ++i) cnt[s[i]]++;
      I acc = 0;
      for (I c = 0; c < K; ++c) { acc += cnt[c]; bkt[c] = acc; }
    }
  };

  const I EMPTY = -1;
  std::vector<I> SA(n + 1, EMPTY);

  auto induce = [&](const std::vector<I>& lms) {
    std::fill(SA.begin(), SA.end(), EMPTY);
    SA[0] = n;  // sentinel first
    bucket_ends(true);
    for (int64_t i = (int64_t)lms.size() - 1; i >= 0; --i) {
      I p = lms[i];
      if (p < n) SA[--bkt[s[p]] + 1] = p;  // +1 offset: SA[0] is sentinel
    }
    // induce L from left
    bucket_ends(false);
    std::vector<I> heads(bkt.begin(), bkt.end());
    for (I i = 0; i <= n; ++i) {
      I j = SA[i];
      if (j == EMPTY || j <= 0) continue;
      I p = j - 1;
      if (!is_s[p]) SA[heads[s[p]]++ + 1] = p;
    }
    // induce S from right
    bucket_ends(true);
    for (I i = n; i >= 0; --i) {
      I j = SA[i];
      if (j == EMPTY || j <= 0) continue;
      I p = j - 1;
      if (is_s[p]) SA[--bkt[s[p]] + 1] = p;
    }
  };

  // collect LMS positions in text order
  std::vector<I> lms;
  for (I i = 1; i <= n; ++i)
    if (is_lms(i)) lms.push_back(i);

  induce(lms);

  // name LMS substrings in SA order
  std::vector<I> name(n + 1, EMPTY);
  I n_names = 0;
  I prev = EMPTY;
  for (I i = 0; i <= n; ++i) {
    I p = SA[i];
    if (p == EMPTY || !(p == n || is_lms(p))) continue;
    if (prev == EMPTY) {
      name[p] = n_names++;
    } else {
      // compare LMS substrings at prev and p
      bool same = true;
      for (I d = 0;; ++d) {
        I a = prev + d, b = p + d;
        bool ea = a == n, eb = b == n;
        if (ea || eb) { same = ea && eb; break; }
        if (s[a] != s[b] || is_s[a] != is_s[b]) { same = false; break; }
        if (d > 0 && (is_lms(a) || is_lms(b))) { same = is_lms(a) && is_lms(b); break; }
      }
      if (!same) n_names++;
      name[p] = n_names - 1;
    }
    prev = p;
  }

  // build reduced problem in text order of LMS positions
  std::vector<I> reduced;
  reduced.reserve(lms.size());
  for (I p : lms) reduced.push_back(name[p]);

  std::vector<I> lms_order(lms.size());
  if (n_names < (I)lms.size()) {
    std::vector<I> rsa(reduced.size());
    sais_core<I>(reduced.data(), (I)reduced.size(), n_names, rsa.data());
    for (size_t i = 0; i < rsa.size(); ++i) lms_order[i] = lms[rsa[i]];
  } else {
    for (size_t i = 0; i < lms.size(); ++i) lms_order[reduced[i]] = lms[i];
  }

  induce(lms_order);

  // SA[0] is the sentinel; copy the real suffix order
  for (I i = 0; i < n; ++i) sa[i] = SA[i + 1];
}

}  // namespace

extern "C" {

void sais_build(const uint8_t* text, int64_t n, int64_t* sa) {
  if (n < INT32_MAX - 2) {
    std::vector<int32_t> s(n);
    for (int64_t i = 0; i < n; ++i) s[i] = text[i];
    std::vector<int32_t> sa32(n);
    sais_core<int32_t>(s.data(), (int32_t)n, 256, sa32.data());
    for (int64_t i = 0; i < n; ++i) sa[i] = sa32[i];
  } else {
    std::vector<int64_t> s(n);
    for (int64_t i = 0; i < n; ++i) s[i] = text[i];
    sais_core<int64_t>(s.data(), n, 256, sa);
  }
}

// ---------------------------------------------------------------------------
// Batch CIGAR walk (HTC-SW backtrack).  States: 0=M 1=I 2=D 4=S.
// btrack: (B, R, C) int16 (rows 1..R, cols 1..C of the DP matrix)
// sw_lastrow: (B, C+1) int32; sw_altcol: (B, R) int32
// out_elems: (B, max_elems, 2) int32 (length, state); out_n: (B,)
// out_offset: (B,)
// ---------------------------------------------------------------------------

void cigar_walk_batch(
    const int16_t* btrack, const int32_t* sw_lastrow, const int32_t* sw_altcol,
    const int32_t* reflen, const int32_t* altlen, int32_t batch,
    int32_t rows, int32_t cols, int32_t strategy, int32_t max_elems,
    int32_t* out_elems, int32_t* out_n, int32_t* out_offset) {
  const int STRAT_SOFTCLIP = 0, STRAT_INDEL = 1, STRAT_LEADING = 2, STRAT_IGNORE = 3;
  const int SM = 0, SI = 1, SD = 2, SC = 4;
  for (int32_t b = 0; b < batch; ++b) {
    const int16_t* bt = btrack + (int64_t)b * rows * cols;
    const int32_t* lastrow = sw_lastrow + (int64_t)b * (cols + 1);
    const int32_t* altcol = sw_altcol + (int64_t)b * rows;
    int rl = reflen[b], al = altlen[b];
    if (rl <= 0 || al <= 0) {  // batch-padding lane: nothing to walk
      out_n[b] = 0;
      out_offset[b] = 0;
      continue;
    }
    int p1 = 0, p2 = al;
    long seg = 0;
    int n_el = 0;
    int32_t* el = out_elems + (int64_t)b * max_elems * 2;
    auto push = [&](long len, int state) {
      if (n_el < max_elems) { el[2 * n_el] = (int32_t)len; el[2 * n_el + 1] = state; }
      n_el++;
    };
    if (strategy == STRAT_INDEL) {
      p1 = rl; p2 = al;
    } else {
      long maxscore = INT64_MIN;
      for (int i = 1; i <= rl; ++i)
        if (altcol[i - 1] >= maxscore) { p1 = i; maxscore = altcol[i - 1]; }
      if (strategy != STRAT_LEADING) {
        for (int j = 1; j <= al; ++j) {
          long cur = lastrow[j];
          if (cur > maxscore ||
              (cur == maxscore && std::abs(rl - j) < std::abs(p1 - p2))) {
            p1 = rl; p2 = j; maxscore = cur; seg = al - j;
          }
        }
      }
    }
    if (seg > 0 && strategy == STRAT_SOFTCLIP) { push(seg, SC); seg = 0; }
    int state = SM;
    while (true) {
      int btr = bt[(int64_t)(p1 - 1) * cols + (p2 - 1)];
      int new_state, step;
      if (btr > 0) { new_state = SD; step = btr; }
      else if (btr < 0) { new_state = SI; step = -btr; }
      else { new_state = SM; step = 1; }
      if (new_state == SM) { p1--; p2--; }
      else if (new_state == SI) { p2 -= step; }
      else { p1 -= step; }
      if (new_state == state) seg += step;
      else { push(seg, state); seg = step; state = new_state; }
      if (!(p1 > 0 && p2 > 0)) break;
    }
    int offset;
    if (strategy == STRAT_SOFTCLIP) {
      push(seg, state);
      if (p2 > 0) push(p2, SC);
      offset = p1;
    } else if (strategy == STRAT_IGNORE) {
      push(seg + p2, state);
      offset = p1 - p2;
    } else {
      push(seg, state);
      if (p1 > 0) push(p1, SD);
      else if (p2 > 0) push(p2, SI);
      offset = 0;
    }
    // reverse in place
    int lim = n_el < max_elems ? n_el : max_elems;
    for (int i = 0, j = lim - 1; i < j; ++i, --j) {
      std::swap(el[2 * i], el[2 * j]);
      std::swap(el[2 * i + 1], el[2 * j + 1]);
    }
    out_n[b] = n_el;
    out_offset[b] = offset;
  }
}

// ---------------------------------------------------------------------------
// PairHMM dense batch packing (time-major (R, B) float32 outputs).
// Inputs per pair k: rs/q/i/d/c bytes at offs[k]..offs[k]+len[k), hap codes
// at hoffs[k]..; tables: ph2pr (128 floats), m2m triangular (32640 floats
// over 7-bit quals: idx = (hi*(hi+1))/2 + lo).
// Absorbing rows and HAP_PAD handled exactly like ops/pairhmm/pack.py.
// ---------------------------------------------------------------------------

void pairhmm_pack(
    const uint8_t* rs, const uint8_t* q, const uint8_t* iq, const uint8_t* dq,
    const uint8_t* cq, const int64_t* offs, const int32_t* lens,
    const uint8_t* hap, const int64_t* hoffs, const int32_t* hlens,
    int32_t batch, int32_t rows, int32_t cols,
    const float* ph2pr, const float* m2m, float initial_constant,
    float* p_mm, float* p_gapm, float* p_mx, float* p_xx, float* p_my,
    float* p_yy, float* em_match, float* em_mis, int32_t* rs_out,
    int32_t* hap_ext, float* y0) {
  const int32_t HAP_PAD = 5;
  int64_t stride = batch;
  // defaults: absorbing rows
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < rows; ++r) {
    for (int64_t b = 0; b < batch; ++b) {
      int64_t at = r * stride + b;
      p_mm[at] = 0.f; p_gapm[at] = 0.f;
      p_mx[at] = 1.f; p_xx[at] = 1.f;
      p_my[at] = 0.f; p_yy[at] = 0.f;
      em_match[at] = 0.f; em_mis[at] = 0.f;
      rs_out[at] = 0;
    }
  }
  int64_t ndiag = (int64_t)rows + cols;
#pragma omp parallel for schedule(static)
  for (int64_t d = 0; d < ndiag; ++d)
    for (int64_t b = 0; b < batch; ++b) hap_ext[d * stride + b] = HAP_PAD;

#pragma omp parallel for schedule(dynamic, 64)
  for (int32_t b = 0; b < batch; ++b) {
    int32_t len = lens[b];
    const uint8_t* prs = rs + offs[b];
    const uint8_t* pq = q + offs[b];
    const uint8_t* pi = iq + offs[b];
    const uint8_t* pd = dq + offs[b];
    const uint8_t* pc = cq + offs[b];
    for (int32_t r = 0; r < len; ++r) {
      int64_t at = (int64_t)r * stride + b;
      int qi = pi[r] & 127, qd = pd[r] & 127, qc = pc[r] & 127, qq = pq[r] & 127;
      int lo = qi < qd ? qi : qd;
      int hi = qi < qd ? qd : qi;
      p_mm[at] = m2m[(hi * (hi + 1)) / 2 + lo];
      p_gapm[at] = 1.0f - ph2pr[qc];
      p_mx[at] = ph2pr[qi];
      p_xx[at] = ph2pr[qc];
      p_my[at] = ph2pr[qd];
      p_yy[at] = ph2pr[qc];
      em_match[at] = 1.0f - ph2pr[qq];
      em_mis[at] = ph2pr[qq] / 3.0f;
      rs_out[at] = prs[r];
    }
    int32_t hl = hlens[b];
    const uint8_t* ph = hap + hoffs[b];
    for (int32_t hcol = 0; hcol < hl; ++hcol)
      hap_ext[(int64_t)hcol * stride + b] = ph[hcol];
    y0[b] = hl > 0 ? initial_constant / (float)hl : 0.f;
  }
}

// ---------------------------------------------------------------------------
// HTC-SW native host engine: full row-wise fill + backtrack -> CIGAR.
// The production-speed CPU fallback (role of calculateMatrixRowWise +
// calculateCigarOneBatch, htc-sw/host/FalconSW_AVX.cpp:413-2419) — the
// NumPy oracle stays the behavioural contract; results are identical.
// Weights are runtime arguments (the SWConfig/common.h:13-56 analog).
// ---------------------------------------------------------------------------

void sw_align_batch_native(
    const uint8_t* ref, const int64_t* roffs, const int32_t* rlens,
    const uint8_t* alt, const int64_t* aoffs, const int32_t* alens,
    int32_t batch, int32_t strategy,
    int32_t w_match, int32_t w_mismatch, int32_t w_open, int32_t w_extend,
    int32_t max_elems,
    int32_t* out_elems, int32_t* out_n, int32_t* out_offset) {
  const int STRAT_SOFTCLIP = 0, STRAT_INDEL = 1, STRAT_LEADING = 2,
            STRAT_IGNORE = 3;
  const int SM = 0, SI = 1, SD = 2, SC = 4;
  const int32_t MIN_CUTOFF = (int32_t)-1e8;
  const int32_t LOW_INIT = -(1 << 30);
  bool indel_init = strategy == STRAT_INDEL || strategy == STRAT_LEADING;

#pragma omp parallel
  {
    std::vector<int16_t> btr;       // (rl x al), rows 1.., cols 1..
    std::vector<int32_t> sw_prev, sw_cur, bgv, gsv, lastrow, altcol;
#pragma omp for schedule(dynamic, 4)
    for (int32_t b = 0; b < batch; ++b) {
      int rl = rlens[b], al = alens[b];
      int32_t* el = out_elems + (int64_t)b * max_elems * 2;
      if (rl <= 0 || al <= 0) { out_n[b] = 0; out_offset[b] = 0; continue; }
      if (rl > 32767 || al > 32767) {
        // gap-run lengths are stored int16; flag for oracle rerun
        // (callers treat n > max_elems as overflow)
        out_n[b] = max_elems + 1;
        out_offset[b] = 0;
        continue;
      }
      const uint8_t* pr = ref + roffs[b];
      const uint8_t* pa = alt + aoffs[b];
      btr.assign((size_t)rl * al, 0);
      sw_prev.assign(al + 1, 0);
      sw_cur.assign(al + 1, 0);
      bgv.assign(al + 1, LOW_INIT);
      gsv.assign(al + 1, 0);
      lastrow.assign(al + 1, 0);
      altcol.assign(rl, 0);
      if (indel_init)
        for (int j = 1; j <= al; ++j)
          sw_prev[j] = w_open + (j - 1) * w_extend;
      // fill (exact sw_fill_cellwise semantics: priority diag>=right>=down)
      for (int i = 1; i <= rl; ++i) {
        uint8_t a = pr[i - 1];
        int32_t best_gap_h = LOW_INIT;
        int32_t gap_size_h = 0;
        sw_cur[0] = indel_init ? w_open + (i - 1) * w_extend : 0;
        for (int j = 1; j <= al; ++j) {
          uint8_t c = pa[j - 1];
          int32_t step_diag = sw_prev[j - 1] + (a == c ? w_match : w_mismatch);
          int32_t prev_gap = sw_prev[j] + w_open;
          bgv[j] += w_extend;
          if (prev_gap > bgv[j]) { bgv[j] = prev_gap; gsv[j] = 1; }
          else gsv[j]++;
          int32_t step_down = bgv[j];
          int32_t kd = gsv[j];
          prev_gap = sw_cur[j - 1] + w_open;
          best_gap_h += w_extend;
          if (prev_gap > best_gap_h) { best_gap_h = prev_gap; gap_size_h = 1; }
          else gap_size_h++;
          int32_t step_right = best_gap_h;
          int32_t ki = gap_size_h;
          int32_t v; int16_t bcode;
          if (step_diag >= step_down && step_diag >= step_right) {
            v = step_diag; bcode = 0;
          } else if (step_right >= step_down) {
            v = step_right; bcode = (int16_t)-ki;
          } else {
            v = step_down; bcode = (int16_t)kd;
          }
          sw_cur[j] = v > MIN_CUTOFF ? v : MIN_CUTOFF;
          btr[(size_t)(i - 1) * al + (j - 1)] = bcode;
        }
        altcol[i - 1] = sw_cur[al];
        sw_prev.swap(sw_cur);
      }
      for (int j = 0; j <= al; ++j) lastrow[j] = sw_prev[j];

      // start-cell selection + walk (calculateCigarOneBatch semantics)
      int p1 = 0, p2 = al;
      long seg = 0;
      int n_el = 0;
      auto push = [&](long len, int state) {
        if (n_el < max_elems) { el[2 * n_el] = (int32_t)len; el[2 * n_el + 1] = state; }
        n_el++;
      };
      if (strategy == STRAT_INDEL) { p1 = rl; p2 = al; }
      else {
        long maxscore = INT64_MIN;
        for (int i = 1; i <= rl; ++i)
          if (altcol[i - 1] >= maxscore) { p1 = i; maxscore = altcol[i - 1]; }
        if (strategy != STRAT_LEADING) {
          for (int j = 1; j <= al; ++j) {
            long cur = lastrow[j];
            if (cur > maxscore ||
                (cur == maxscore && std::abs(rl - j) < std::abs(p1 - p2))) {
              p1 = rl; p2 = j; maxscore = cur; seg = al - j;
            }
          }
        }
      }
      if (seg > 0 && strategy == STRAT_SOFTCLIP) { push(seg, SC); seg = 0; }
      int state = SM;
      while (true) {
        int bcode = btr[(size_t)(p1 - 1) * al + (p2 - 1)];
        int new_state, step;
        if (bcode > 0) { new_state = SD; step = bcode; }
        else if (bcode < 0) { new_state = SI; step = -bcode; }
        else { new_state = SM; step = 1; }
        if (new_state == SM) { p1--; p2--; }
        else if (new_state == SI) { p2 -= step; }
        else { p1 -= step; }
        if (new_state == state) seg += step;
        else { push(seg, state); seg = step; state = new_state; }
        if (!(p1 > 0 && p2 > 0)) break;
      }
      int offset;
      if (strategy == STRAT_SOFTCLIP) {
        push(seg, state);
        if (p2 > 0) push(p2, SC);
        offset = p1;
      } else if (strategy == STRAT_IGNORE) {
        push(seg + p2, state);
        offset = p1 - p2;
      } else {
        push(seg, state);
        if (p1 > 0) push(p1, SD);
        else if (p2 > 0) push(p2, SI);
        offset = 0;
      }
      int lim = n_el < max_elems ? n_el : max_elems;
      for (int i2 = 0, j2 = lim - 1; i2 < j2; ++i2, --j2) {
        std::swap(el[2 * i2], el[2 * j2]);
        std::swap(el[2 * i2 + 1], el[2 * j2 + 1]);
      }
      out_n[b] = n_el;
      out_offset[b] = offset;
    }
  }
}

// ---------------------------------------------------------------------------
// SMEM native host engine: 3-pass mem_collect_intv over the fused probe
// table — the production-speed CPU fallback for overflow / cap-bust /
// oversize reads (role of the reference's BWA-derived CPU baseline,
// smem/host/baseline.cpp).  Semantics are a direct port of the package's
// own NumPy oracle (ops/smem/reference.py), which remains the contract;
// results are bit-identical and runtime options are arguments.
// Table layout: row b of tbl = [cnt0..3, word0..3], 64 bases per row,
// 16 bases per big-endian-packed u32 (ops/smem/index.py).
// TRANSCRIBED (control flow) from baseline.cpp bwt_smem1a_new/
// bwt_seed_strategy1/mem_collect_intv_new for exactness: the
// backenlarge/forwardenlarge pass structure and interval tie rules are
// results-affecting and compared as exact integers.
// ---------------------------------------------------------------------------

namespace {

struct SmemIdx {
  const int32_t* tbl;
  int64_t nblk;
  int64_t primary;
  const int64_t* l2;  // l2[5]
};

struct Intv {
  int64_t x0, x1, s;
  int32_t start, end;
};

static inline void occ4(const SmemIdx& ix, int64_t k, int64_t cnt[4]) {
  if (k < 0) { cnt[0] = cnt[1] = cnt[2] = cnt[3] = 0; return; }
  if (k >= ix.primary) k -= 1;
  int64_t blk = k >> 6;
  int off = (int)(k & 63);
  const int32_t* row = ix.tbl + blk * 8;
  const uint32_t* w = (const uint32_t*)(row + 4);
  for (int c = 0; c < 4; ++c) {
    uint32_t pat = 0x55555555u * (uint32_t)c;
    // counts are stored int32; seq_len < 2^31 (the bound the machine
    // asserts) keeps them in range
    int64_t acc = row[c];
    for (int m = 0; m < 4; ++m) {
      int keep = off + 1 - 16 * m;
      if (keep <= 0) break;
      if (keep > 16) keep = 16;
      uint32_t nx = ~(w[m] ^ pat);
      uint32_t y = nx & (nx >> 1) & 0x55555555u;
      uint32_t mask = 0xFFFFFFFFu << (32 - 2 * keep);
      acc += __builtin_popcount(y & mask);
    }
    cnt[c] = acc;
  }
}

// bidirectional extension (bwt_extend semantics; mirrors FMIndex.extend)
static inline void smem_extend(const SmemIdx& ix, const Intv& ik, int is_back,
                               Intv ok[4]) {
  int cntc = 1 - is_back, oth = is_back;
  int64_t xf = cntc == 0 ? ik.x0 : ik.x1;
  int64_t xo = oth == 0 ? ik.x0 : ik.x1;
  int64_t tk[4], tl[4];
  occ4(ix, xf - 1, tk);
  occ4(ix, xf - 1 + ik.s, tl);
  int64_t osz[4], coord[4];
  for (int c = 0; c < 4; ++c) {
    osz[c] = tl[c] - tk[c];
    coord[c] = ix.l2[c] + 1 + tk[c];
  }
  int64_t span = (xf <= ix.primary && xf + ik.s - 1 >= ix.primary) ? 1 : 0;
  int64_t acc = xo + span;
  int64_t other[4];
  for (int c = 3; c >= 0; --c) { other[c] = acc; acc += osz[c]; }
  for (int c = 0; c < 4; ++c) {
    ok[c].s = osz[c];
    if (cntc == 0) { ok[c].x0 = coord[c]; ok[c].x1 = other[c]; }
    else { ok[c].x1 = coord[c]; ok[c].x0 = other[c]; }
    ok[c].start = 0; ok[c].end = 0;
  }
}

static inline Intv set_intv(const SmemIdx& ix, int c) {
  Intv iv;
  iv.x0 = ix.l2[c] + 1;
  iv.x1 = ix.l2[3 - c] + 1;
  iv.s = ix.l2[c + 1] - ix.l2[c];
  iv.start = 0; iv.end = 0;
  return iv;
}

// one seeding round (bwt_smem1a_new semantics, max_intv = 0); mirrors
// ops/smem/reference.py smem1a_fwdback exactly
static int smem1a_fwdback_native(
    const SmemIdx& ix, const uint8_t* seq, int ln, int x, int64_t min_intv,
    int min_seed_len, std::vector<Intv>& mem) {
  if (seq[x] > 3) return x + 1;
  if (min_intv < 1) min_intv = 1;
  Intv ik = set_intv(ix, seq[x]);
  ik.start = 0; ik.end = x + 1;
  std::vector<Intv> curr;
  int i = x + 1;
  Intv ok[4];
  for (; i < ln; ++i) {
    if (seq[i] < 4) {
      int c = 3 - seq[i];
      smem_extend(ix, ik, 0, ok);
      if (ok[c].s != ik.s) {
        curr.push_back(ik);
        if (ok[c].s < min_intv) break;
      }
      ik.x0 = ok[c].x0; ik.x1 = ok[c].x1; ik.s = ok[c].s;
      ik.end = i + 1;
    } else {
      curr.push_back(ik);
      break;
    }
  }
  if (i == ln) curr.push_back(ik);
  int ret = curr.back().end;

  std::vector<Intv> back_intv;
  int start = x, stop = x;
  Intv temp;
  bool have_temp = false;
  size_t ci = 0;
  while (ci < curr.size()) {
    ik = curr[ci];
    ik.start = x;
    if (back_intv.empty() || stop - start >= 3) {
      back_intv.clear();
      back_intv.push_back(ik);
      for (int k = x - 1; k >= -1; --k) {
        int c = k < 0 ? -1 : (seq[k] < 4 ? seq[k] : -1);
        if (c < 0) break;
        smem_extend(ix, ik, 1, ok);
        if (ok[c].s < min_intv) break;
        ik.x0 = ok[c].x0; ik.x1 = ok[c].x1; ik.s = ok[c].s;
        ik.start = k; ik.end = curr[ci].end;
        back_intv.push_back(ik);
      }
      start = curr[ci].end;
      stop = ci < curr.size() - 1 ? curr[ci + 1].end : ln;
      if (ci == 0) { temp = ik; have_temp = true; }
      else if (ik.start > temp.start && temp.end - temp.start >= min_seed_len) {
        mem.push_back(temp);
        temp = ik;
      } else temp = ik;
    } else {
      // forwardenlarge
      stop = curr[ci].end;
      bool isbreak = false;
      for (int k = (int)back_intv.size() - 1; k >= 0; --k) {
        ik = back_intv[k];
        for (int m = start + 1; m <= stop; ++m) {
          // bases in (start, stop] are always < 4 (curr intervals end
          // before any N); clamp mirrors the oracle's ok[-1] == ok[3]
          int c = seq[m - 1] < 4 ? 3 - seq[m - 1] : 3;
          smem_extend(ix, ik, 0, ok);
          if (ok[c].s < min_intv) break;
          int32_t st0 = ik.start, en0 = ik.end;
          ik = ok[c];
          ik.start = st0; ik.end = en0;
          if (m == stop) {
            ik.start = x - k;
            ik.end = curr[ci].end;
            isbreak = true;
          }
        }
        if (isbreak) {
          if ((x - k) > temp.start && temp.end - temp.start >= min_seed_len) {
            mem.push_back(temp);
            temp = ik;
          } else temp = ik;
          break;
        }
      }
    }
    ci++;
    if (ci < curr.size()) {
      long max_len = temp.start + curr[ci].end;
      while (max_len < min_seed_len && ci < curr.size()) {
        ci++;
        if (ci < curr.size()) stop = curr[ci].end;
        max_len = temp.start + stop;
      }
    }
    if (ci >= curr.size() && have_temp && temp.end - temp.start >= min_seed_len)
      mem.push_back(temp);
  }
  return ret;
}

// 3rd-pass LAST-like seed (bwt_seed_strategy1 semantics)
static int seed_strategy1_native(
    const SmemIdx& ix, const uint8_t* seq, int ln, int x, int min_len,
    int64_t max_intv, Intv* out, bool* found) {
  *found = false;
  if (seq[x] > 3) return x + 1;
  Intv ik = set_intv(ix, seq[x]);
  Intv ok[4];
  for (int i = x + 1; i < ln; ++i) {
    if (seq[i] < 4) {
      int c = 3 - seq[i];
      smem_extend(ix, ik, 0, ok);
      if (ok[c].s < max_intv && i - x >= min_len) {
        *out = ok[c];
        out->start = x; out->end = i + 1;
        *found = true;
        return i + 1;
      }
      ik.x0 = ok[c].x0; ik.x1 = ok[c].x1; ik.s = ok[c].s;
    } else {
      return i + 1;
    }
  }
  return ln;
}

}  // namespace

extern "C" {

void smem_collect_batch_native(
    const int32_t* tbl, int64_t nblk, int64_t primary, const int64_t* l2,
    const uint8_t* seqs, const int64_t* soffs, const int32_t* slens,
    int32_t batch,
    int32_t min_seed_len, int32_t split_len, int32_t split_width,
    int32_t max_mem_intv, int32_t max_out,
    int64_t* out_mem,  // (batch, max_out, 5): x0 x1 s start end
    int32_t* out_n) {
  SmemIdx ix{tbl, nblk, primary, l2};
#pragma omp parallel
  {
    std::vector<Intv> mem;
#pragma omp for schedule(dynamic, 8)
    for (int32_t b = 0; b < batch; ++b) {
      const uint8_t* seq = seqs + soffs[b];
      int ln = slens[b];
      mem.clear();
      // pass 1: all SMEMs
      int x = 0;
      while (x < ln) {
        if (seq[x] < 4)
          x = smem1a_fwdback_native(ix, seq, ln, x, 1, min_seed_len, mem);
        else x++;
      }
      // pass 2: re-seed long low-occurrence SMEMs from their midpoint
      size_t old_n = mem.size();
      for (size_t k = 0; k < old_n; ++k) {
        Intv p = mem[k];
        if (p.end - p.start < split_len || p.s > split_width) continue;
        smem1a_fwdback_native(ix, seq, ln, (p.start + p.end) >> 1, p.s + 1,
                              min_seed_len, mem);
      }
      // pass 3: LAST-like
      x = 0;
      while (x < ln) {
        if (seq[x] < 4) {
          Intv iv; bool found;
          x = seed_strategy1_native(ix, seq, ln, x, min_seed_len,
                                    max_mem_intv, &iv, &found);
          if (found && iv.s > 0) mem.push_back(iv);
        } else x++;
      }
      int n = (int)mem.size();
      out_n[b] = n;
      int lim = n < max_out ? n : max_out;
      int64_t* om = out_mem + (int64_t)b * max_out * 5;
      for (int j = 0; j < lim; ++j) {
        om[j * 5 + 0] = mem[j].x0;
        om[j * 5 + 1] = mem[j].x1;
        om[j * 5 + 2] = mem[j].s;
        om[j * 5 + 3] = mem[j].start;
        om[j * 5 + 4] = mem[j].end;
      }
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BWA-MEM banded seed extension, native host engine (ksw_extend2 loop —
// the production-speed CPU fallback for the role of the reference's
// sw_extend, bwa-sw/sdaccel/smithwaterman.cpp:75-273).  Scoring is a
// runtime argument; results are bit-identical to the NumPy oracle.
// out: (batch, 7) int32 = score qle tle gtle gscore max_off w.
//
// TRANSCRIBED (control flow, not identifiers) from the reference's
// sw_extend for bit-exactness: the adaptive band narrowing
// (lead_zeros/trail_zeros runs), un-reset eh rows between band rounds,
// and the tie rules are results-affecting and the callers compare exact
// integers, so the loop structure matches statement for statement.
// ---------------------------------------------------------------------------

void sw_extend_batch_native(
    const uint8_t* q, const int64_t* qoffs, const int32_t* qlens,
    const uint8_t* t, const int64_t* toffs, const int32_t* tlens,
    const int32_t* h0s, int32_t batch,
    int32_t o_del, int32_t e_del, int32_t o_ins, int32_t e_ins,
    int32_t w_in, int32_t sc_match, int32_t sc_mismatch, int32_t sc_ambig,
    int32_t* out) {
  int32_t oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
#pragma omp parallel
  {
    std::vector<int32_t> eh_h, eh_e;
#pragma omp for schedule(dynamic, 16)
    for (int32_t b = 0; b < batch; ++b) {
      int qlen = qlens[b], tlen = tlens[b];
      int32_t h0 = h0s[b];
      const uint8_t* pq = q + qoffs[b];
      const uint8_t* pt = t + toffs[b];
      int max_ins = qlen, max_del = qlen;
      eh_h.assign(qlen + 2, 0);
      eh_e.assign(qlen + 2, 0);
      long max_score = h0;
      int max_i = -1, max_j = -1, max_ie = -1;
      long gscore = -1;
      int max_off = 0;
      long reg_score = h0;
      int band_w = w_in;
      for (int k = 0; k < 2; ++k) {
        long prev = reg_score;
        band_w = w_in << k;
        int aw1 = std::min(band_w, std::min(max_ins, max_del));
        int beg = 0, end = qlen;
        long row0_h = std::max((long)h0 - oe_ins, 0L);
        long h1_init = (long)h0 - o_del;
        for (int i = 0; i < tlen; ++i) {
          long f = 0, m = 0;
          int mj = -1;
          uint8_t q_i = pt[i];
          if (beg < i - aw1) beg = i - aw1;
          if (end > i + aw1 + 1) end = i + aw1 + 1;
          if (end > qlen) end = qlen;
          long h1;
          if (beg == 0) { h1_init -= e_del; h1 = std::max(h1_init, 0L); }
          else h1 = 0;
          int trail_zeros = 0, lead_zeros = 0;
          bool lead_run_over = false;
          for (int j = beg; j < end; ++j) {
            uint8_t q_j = pq[j];
            long h_tmp = eh_h[j], e_tmp = eh_e[j];
            long e, h, M;
            if (i == 0) {
              e = 0;
              if (j == 0) h = M = h0;
              else if (j == 1) h = M = row0_h;
              else { row0_h = std::max(row0_h - e_ins, 0L); h = M = row0_h; }
            } else { e = e_tmp; h = M = h_tmp; }
            long h_left = h1;
            long sc = (q_i >= 4 || q_j >= 4) ? sc_ambig
                      : (q_i == q_j ? sc_match : sc_mismatch);
            M = (M != 0) ? M + sc : 0;
            h = std::max(std::max(M, e), f);
            h1 = h;
            long tt = std::max(M - oe_del, 0L);
            e = std::max(e - e_del, tt);
            tt = std::max(M - oe_ins, 0L);
            f = std::max(f - e_ins, tt);
            eh_e[j] = (int32_t)e;
            eh_h[j] = (int32_t)h_left;
            if (m <= h) { mj = j; m = h; }
            if (!lead_run_over) {
              if (h_left == 0 && e == 0) lead_zeros++;
              else lead_run_over = true;
            }
            if (h_left == 0 && e == 0) trail_zeros++;
            else trail_zeros = 0;
          }
          eh_h[end] = (int32_t)h1;
          eh_e[end] = 0;
          if (h1 == 0) trail_zeros++;
          else trail_zeros = 0;
          if (end == qlen) {
            if (gscore <= h1) { max_ie = i; gscore = h1; }
          }
          if (m == 0) break;
          if (m > max_score) {
            max_score = m; max_i = i; max_j = mj;
            if (max_off < std::abs(mj - i)) max_off = std::abs(mj - i);
          }
          beg = beg + lead_zeros;
          end = (end - trail_zeros + 2 < qlen) ? end - trail_zeros + 2 : qlen;
        }
        reg_score = max_score;
        if (max_score == prev || max_off < ((band_w >> 1) + (band_w >> 2)))
          break;
      }
      int32_t* o = out + (int64_t)b * 7;
      o[0] = (int32_t)reg_score;
      o[1] = max_j + 1;
      o[2] = max_i + 1;
      o[3] = max_ie + 1;
      o[4] = (int32_t)gscore;
      o[5] = max_off;
      o[6] = band_w;
    }
  }
}

// ---------------------------------------------------------------------------
// PairHMM byte-plane packing: the engine's TPU path uploads raw uint8
// qual/base planes and computes coefficients on device, so packing is
// pure memcpy + fill — the host side of pack_pairhmm_quals
// (ops/pairhmm/pack.py) without the Python per-pair loop.
// Outputs are time-major (R, B) uint8; hap_ext is (R + C, B).
// ---------------------------------------------------------------------------

#ifdef __SSE2__
// Transpose a 16x16 byte tile: 16 input rows strided by istr -> 16
// output rows strided by ostr (the classic 4-stage unpack network).
static inline void transpose16x16_u8(const uint8_t* in, size_t istr,
                                     uint8_t* out, size_t ostr) {
  __m128i r[16], t[16];
  for (int i = 0; i < 16; ++i)
    r[i] = _mm_loadu_si128((const __m128i*)(in + i * istr));
  for (int i = 0; i < 8; ++i) {
    t[2 * i] = _mm_unpacklo_epi8(r[2 * i], r[2 * i + 1]);
    t[2 * i + 1] = _mm_unpackhi_epi8(r[2 * i], r[2 * i + 1]);
  }
  for (int i = 0; i < 4; ++i) {
    r[4 * i] = _mm_unpacklo_epi16(t[4 * i], t[4 * i + 2]);
    r[4 * i + 1] = _mm_unpackhi_epi16(t[4 * i], t[4 * i + 2]);
    r[4 * i + 2] = _mm_unpacklo_epi16(t[4 * i + 1], t[4 * i + 3]);
    r[4 * i + 3] = _mm_unpackhi_epi16(t[4 * i + 1], t[4 * i + 3]);
  }
  for (int i = 0; i < 2; ++i) {
    t[8 * i] = _mm_unpacklo_epi32(r[8 * i], r[8 * i + 4]);
    t[8 * i + 1] = _mm_unpackhi_epi32(r[8 * i], r[8 * i + 4]);
    t[8 * i + 2] = _mm_unpacklo_epi32(r[8 * i + 1], r[8 * i + 5]);
    t[8 * i + 3] = _mm_unpackhi_epi32(r[8 * i + 1], r[8 * i + 5]);
    t[8 * i + 4] = _mm_unpacklo_epi32(r[8 * i + 2], r[8 * i + 6]);
    t[8 * i + 5] = _mm_unpackhi_epi32(r[8 * i + 2], r[8 * i + 6]);
    t[8 * i + 6] = _mm_unpacklo_epi32(r[8 * i + 3], r[8 * i + 7]);
    t[8 * i + 7] = _mm_unpackhi_epi32(r[8 * i + 3], r[8 * i + 7]);
  }
  for (int i = 0; i < 8; ++i) {
    r[2 * i] = _mm_unpacklo_epi64(t[i], t[i + 8]);
    r[2 * i + 1] = _mm_unpackhi_epi64(t[i], t[i + 8]);
  }
  for (int i = 0; i < 16; ++i)
    _mm_storeu_si128((__m128i*)(out + i * ostr), r[i]);
}
#endif

void pairhmm_pack_quals(
    const uint8_t* rs, const uint8_t* q, const uint8_t* iq, const uint8_t* dq,
    const uint8_t* cq, const int64_t* offs, const int32_t* lens,
    const uint8_t* hap, const int64_t* hoffs, const int32_t* hlens,
    int32_t batch, int32_t rows, int32_t cols, uint8_t hap_pad,
    uint8_t* oq, uint8_t* oi, uint8_t* od, uint8_t* oc, uint8_t* ors,
    uint8_t* ohap) {
  const int64_t stride = batch;
  const int64_t ndiag = (int64_t)rows + cols;
  // stage pair-major (contiguous memcpy per pair), then transpose in
  // tiles — a direct time-major scatter is a cache-line miss per byte
  // at batch-sized strides.  Tiles go through a 16x16 SSE unpack
  // network where available (13x the scalar strided-store loop this
  // replaced: byte stores at batch stride were 18.5 ms/plane, SSE
  // tiles 1.35 ms, memset floor 0.17 — see round-3 PERF_NOTES); the
  // scalar tail/fallback keeps stores contiguous along lanes (7.6x).
  const int TILE = 64;
  struct Plane { const uint8_t* src; uint8_t* dst; int64_t nrow; uint8_t pad; };
  Plane planes[6] = {
      {q, oq, rows, 0}, {iq, oi, rows, 0}, {dq, od, rows, 0},
      {cq, oc, rows, 0}, {rs, ors, rows, 0}, {hap, ohap, ndiag, hap_pad},
  };
#pragma omp parallel
  {
    std::vector<uint8_t> stage;
    for (int p = 0; p < 6; ++p) {
      const bool is_hap = p == 5;
      const int64_t nrow = planes[p].nrow;
      const int64_t srow = (nrow + 15) & ~int64_t(15);  // staged row pitch
      stage.resize((size_t)TILE * srow);
#pragma omp for schedule(dynamic, 1) nowait
      for (int32_t b0 = 0; b0 < batch; b0 += TILE) {
        int bw = std::min((int32_t)TILE, batch - b0);
        std::memset(stage.data(), planes[p].pad, (size_t)bw * srow);
        for (int bb = 0; bb < bw; ++bb) {
          int32_t bidx = b0 + bb;
          int32_t len = is_hap ? hlens[bidx] : lens[bidx];
          const int64_t o = is_hap ? hoffs[bidx] : offs[bidx];
          if (len > 0)
            std::memcpy(stage.data() + (size_t)bb * srow,
                        planes[p].src + o, len);
        }
        // transpose stage (bw, srow) -> dst rows [0, nrow) at cols b0..
        uint8_t* dst = planes[p].dst;
        int64_t r0 = 0;
#ifdef __SSE2__
        for (; r0 + 16 <= nrow; r0 += 16) {
          int bb = 0;
          for (; bb + 16 <= bw; bb += 16)
            transpose16x16_u8(stage.data() + (size_t)bb * srow + r0, srow,
                              dst + r0 * stride + b0 + bb, stride);
          for (; bb < bw; ++bb)  // lane tail (batch not a multiple of 16)
            for (int r = 0; r < 16; ++r)
              dst[(r0 + r) * stride + b0 + bb] =
                  stage[(size_t)bb * srow + r0 + r];
        }
#endif
        for (; r0 < nrow; ++r0) {  // row tail: contiguous stores per row
          uint8_t* drow = dst + r0 * stride + b0;
          const uint8_t* scol = stage.data() + r0;
          for (int bb = 0; bb < bw; ++bb) drow[bb] = scol[(size_t)bb * srow];
        }
      }
#pragma omp barrier
    }
  }
}

// ---------------------------------------------------------------------------
// PairHMM coefficient expansion: time-major uint8 qual planes (from
// pairhmm_pack_quals) -> time-major f32 coefficient planes + int32 code
// planes.  Every stream is read/written SEQUENTIALLY — the original
// per-pair packer's column-scatter writes were a cache miss per element
// at batch-sized strides (measured ~1 s per 16K-pair batch).
// big_f rows: p_mm p_gapm p_mx p_xx p_my p_yy em_match em_mis (8*rows)
// then y0 in row 8*rows.  big_i rows: rs codes (rows) then hap_ext.
// ---------------------------------------------------------------------------

void pairhmm_expand_quals(
    const uint8_t* oq, const uint8_t* oi, const uint8_t* od,
    const uint8_t* oc, const uint8_t* ors, const uint8_t* ohap,
    const int32_t* lens, const int32_t* hlens,
    int32_t rows, int32_t cols, int32_t bp,
    const float* ph2pr, const float* m2m, float initial_constant,
    float* big_f, int32_t* big_i) {
  const int64_t stride = bp;
  const int64_t plane = (int64_t)rows * stride;
  float* p_mm = big_f;
  float* p_gapm = big_f + plane;
  float* p_mx = big_f + 2 * plane;
  float* p_xx = big_f + 3 * plane;
  float* p_my = big_f + 4 * plane;
  float* p_yy = big_f + 5 * plane;
  float* em_m = big_f + 6 * plane;
  float* em_x = big_f + 7 * plane;
  float* y0 = big_f + 8 * plane;
  int32_t* rs_out = big_i;
  int32_t* hap_out = big_i + plane;
#pragma omp parallel for schedule(static)
  for (int32_t r = 0; r < rows; ++r) {
    int64_t off = (int64_t)r * stride;
    for (int64_t b = 0; b < bp; ++b) {
      int64_t at = off + b;
      if (r < lens[b]) {
        int qi = oi[at] & 127, qd = od[at] & 127, qc = oc[at] & 127,
            qq = oq[at] & 127;
        int lo = qi < qd ? qi : qd;
        int hi = qi < qd ? qd : qi;
        p_mm[at] = m2m[((int64_t)hi * (hi + 1) >> 1) + lo];
        p_gapm[at] = 1.0f - ph2pr[qc];
        p_mx[at] = ph2pr[qi];
        p_xx[at] = ph2pr[qc];
        p_my[at] = ph2pr[qd];
        p_yy[at] = ph2pr[qc];
        em_m[at] = 1.0f - ph2pr[qq];
        em_x[at] = ph2pr[qq] / 3.0f;
      } else {  // absorbing row
        p_mm[at] = 0.f; p_gapm[at] = 0.f;
        p_mx[at] = 1.f; p_xx[at] = 1.f;
        p_my[at] = 0.f; p_yy[at] = 0.f;
        em_m[at] = 0.f; em_x[at] = 0.f;
      }
      rs_out[at] = ors[at];
    }
  }
  int64_t ndiag = (int64_t)rows + cols;
#pragma omp parallel for schedule(static)
  for (int64_t k = 0; k < ndiag * stride; ++k) hap_out[k] = ohap[k];
  for (int64_t b = 0; b < bp; ++b)
    y0[b] = hlens[b] > 0 ? initial_constant / (float)hlens[b] : 0.f;
}

}  // extern "C" (reopened below for the PairHMM forward exports)

// ---------------------------------------------------------------------------
// PairHMM forward: the native CPU compute engine — the role of the
// reference's AVX path (pairhmm/xlnx/host/avx-pairhmm-template.h via
// compute_fp_avxs/avxd) for host dispatch and fp64 underflow recompute.
// Row-major M/X/Y recurrence (GATK 3.7 semantics, baseline_impl.cpp):
// M and X rows auto-vectorize; Y is the sequential first-order IIR.
// Tables (ph2pr, triangular matchToMatch) come from the Python context
// so the numeric contract is shared with the device path.
// ---------------------------------------------------------------------------

template <typename T>
static void phmm_forward_one(
    const uint8_t* rs, const uint8_t* q, const uint8_t* iq,
    const uint8_t* dq, const uint8_t* cq, int32_t rlen,
    const uint8_t* hap, int32_t hlen,
    const T* ph2pr, const T* m2m, T initial_constant, T* out) {
  if (hlen <= 0 || rlen <= 0) {
    *out = (T)0;
    return;
  }
  std::vector<T> m_prev(hlen + 1, (T)0), x_prev(hlen + 1, (T)0);
  std::vector<T> y_prev(hlen + 1, initial_constant / (T)hlen);
  std::vector<T> m_cur(hlen + 1), x_cur(hlen + 1), y_cur(hlen + 1);
  for (int32_t r = 0; r < rlen; ++r) {
    int32_t qi = iq[r] & 127, qd = dq[r] & 127, qc = cq[r] & 127,
            qq = q[r] & 127;
    int32_t lo = qi < qd ? qi : qd, hi = qi < qd ? qd : qi;
    T pmm = m2m[((int64_t)hi * (hi + 1) >> 1) + lo];
    T pgapm = (T)1 - ph2pr[qc];
    T pmx = ph2pr[qi], pxx = ph2pr[qc], pmy = ph2pr[qd], pyy = ph2pr[qc];
    T em = (T)1 - ph2pr[qq], ex = ph2pr[qq] / (T)3;
    uint8_t rb = rs[r];
    m_cur[0] = (T)0;
    for (int32_t j = 1; j <= hlen; ++j) {
      uint8_t hb = hap[j - 1];
      T distm = (rb == hb || rb == 4 || hb == 4) ? em : ex;
      m_cur[j] =
          distm * (m_prev[j - 1] * pmm + (x_prev[j - 1] + y_prev[j - 1]) * pgapm);
    }
    for (int32_t j = 0; j <= hlen; ++j)
      x_cur[j] = m_prev[j] * pmx + x_prev[j] * pxx;
    y_cur[0] = (T)0;
    for (int32_t j = 1; j <= hlen; ++j)
      y_cur[j] = m_cur[j - 1] * pmy + y_cur[j - 1] * pyy;
    m_prev.swap(m_cur);
    x_prev.swap(x_cur);
    y_prev.swap(y_cur);
  }
  T acc = (T)0;
  for (int32_t j = 0; j <= hlen; ++j) acc += m_prev[j] + x_prev[j];
  *out = acc;
}

template <typename T>
static void phmm_forward_batch(
    const uint8_t* rs, const uint8_t* q, const uint8_t* iq,
    const uint8_t* dq, const uint8_t* cq, const int64_t* roffs,
    const int32_t* rlens, const uint8_t* hap, const int64_t* hoffs,
    const int32_t* hlens, int64_t n, const T* ph2pr, const T* m2m,
    T initial_constant, T* out) {
#pragma omp parallel
  {
#if defined(__x86_64__) || defined(__i386__)
    // FTZ + DAZ: the fp32 recurrence spends most of its range in
    // denormals otherwise (the reference sets _MM_SET_FLUSH_ZERO_MODE,
    // pairhmm/host/main.cpp:248).  Saved and restored per thread so the
    // caller's float environment is untouched.
    unsigned int saved_csr = _mm_getcsr();
    _mm_setcsr(saved_csr | 0x8040);
#endif
#pragma omp for schedule(dynamic, 8)
  for (int64_t b = 0; b < n; ++b) {
    phmm_forward_one<T>(
        rs + roffs[b], q + roffs[b], iq + roffs[b], dq + roffs[b],
        cq + roffs[b], rlens[b], hap + hoffs[b], hlens[b],
        ph2pr, m2m, initial_constant, out + b);
  }
#if defined(__x86_64__) || defined(__i386__)
    _mm_setcsr(saved_csr);
#endif
  }
}

extern "C" {

void pairhmm_forward_batch_f32(
    const uint8_t* rs, const uint8_t* q, const uint8_t* iq,
    const uint8_t* dq, const uint8_t* cq, const int64_t* roffs,
    const int32_t* rlens, const uint8_t* hap, const int64_t* hoffs,
    const int32_t* hlens, int64_t n, const float* ph2pr, const float* m2m,
    float initial_constant, float* out) {
  phmm_forward_batch<float>(rs, q, iq, dq, cq, roffs, rlens, hap, hoffs,
                            hlens, n, ph2pr, m2m, initial_constant, out);
}

void pairhmm_forward_batch_f64(
    const uint8_t* rs, const uint8_t* q, const uint8_t* iq,
    const uint8_t* dq, const uint8_t* cq, const int64_t* roffs,
    const int32_t* rlens, const uint8_t* hap, const int64_t* hoffs,
    const int32_t* hlens, int64_t n, const double* ph2pr, const double* m2m,
    double initial_constant, double* out) {
  phmm_forward_batch<double>(rs, q, iq, dq, cq, roffs, rlens, hap, hoffs,
                             hlens, n, ph2pr, m2m, initial_constant, out);
}

}  // extern "C"
