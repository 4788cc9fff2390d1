// BWA-MEM SMEM collection (mem_collect_intv, 3 passes) for Hopper (sm_90a).
//
// Replaces the JAX package's device state machine
// acc_genomics_tpu/ops/smem/machine.py `smem_collect_machine` (an XLA
// while loop over a flat 12-state machine; on a GPU in eager PyTorch every
// step of it would be its own launch) and its fetch `smem_flat_gather`.
//
// What it computes, per read, is the native host engine's
// `smem_collect_batch_native` (native/accnative.cpp:509-756), transcribed
// statement for statement because intervals are compared as exact
// integers and their order is the contract:
//   * occ4: the counts of A, C, G, T among the first k + 1 BWT rows from
//     one 32-byte row of the probe table [cnt0..3, word0..3] (ops/smem/
//     table.py), skipping the sentinel row (`k -= k >= primary`) and
//     counting the block's bases with a masked 2-bit popcount;
//   * smem_extend: bidirectional extension of an interval (x0, x1, s);
//   * smem1a_fwdback: the forward pass collecting break intervals, then per
//     interval a backward chain (backenlarge) or the forwardenlarge
//     shortcut over the previous backward chain;
//   * pass 1 (all SMEMs), pass 2 (re-seeding from the midpoints of long
//     low-occurrence SMEMs), pass 3 (the LAST-like seed_strategy1).
// Output, per read b: intervals in the oracle's push order at
// mem[f][row][b] of a (5, mem_cap, B) int32 buffer (f = x0, x1, s, start,
// end), their count, a flag and the number of FM-index probes.
//
// Caps: the forward break intervals (`curr`) and the backward chain
// (`back`) live in per-thread arrays of at most kChainMax rows, of which
// the caller's `chain_cap` are used; the output holds mem_cap rows.  A
// read that would push past either cap stops there with flag = 1 and is
// rerun on the host: never truncated.  Its count and rows up to the stop
// are still written (the plain version stops at the same push).
//
// Design: one thread per read, the native engine's nested loops in
// registers.  The TPU machine's 12-state flattening, multi-read lanes and
// 2-bit read pool exist because TPU lanes run in lockstep and its
// while-loop carry lives in HBM; a thread per read diverges instead.
// Reads are time-major (L, B) uint8, so a warp's reads at one position
// are neighbouring bytes.  Bound on this card: the latency of dependent
// 32-byte gathers from a table of up to 100 MB (each extension needs two
// rows, and the next extension depends on them), hidden only by the other
// threads; the chains sit in local memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChainMax = 32;

struct Index {
  const int4* tbl;  // (nblk, 8) int32 rows as two int4 each
  int primary;
  int l2[5];
};

struct Intv {
  int x0, x1, s, start, end;
};

// per-read output cursor
struct Out {
  int32_t* mem;  // &mem[0][0][b]
  int64_t plane;  // elements between the fields (mem_cap * B)
  int64_t B;
  int cap;
  int n;
  int probes;
  bool bust;
};

__device__ __forceinline__ bool push_mem(Out& o, const Intv& iv) {
  if (o.n >= o.cap) {
    o.bust = true;
    return false;
  }
  int32_t* p = o.mem + (int64_t)o.n * o.B;
  p[0] = iv.x0;
  p[o.plane] = iv.x1;
  p[2 * o.plane] = iv.s;
  p[3 * o.plane] = iv.start;
  p[4 * o.plane] = iv.end;
  ++o.n;
  return true;
}

__device__ __forceinline__ void occ4(const Index& ix, int k, int cnt[4]) {
  if (k < 0) {
    cnt[0] = cnt[1] = cnt[2] = cnt[3] = 0;
    return;
  }
  if (k >= ix.primary) k -= 1;
  const int4* row = ix.tbl + 2 * (int64_t)(k >> 6);
  const int off = k & 63;
  const int4 c4 = __ldg(row);
  const int4 w4 = __ldg(row + 1);
  const unsigned w[4] = {(unsigned)w4.x, (unsigned)w4.y, (unsigned)w4.z,
                         (unsigned)w4.w};
  cnt[0] = c4.x;
  cnt[1] = c4.y;
  cnt[2] = c4.z;
  cnt[3] = c4.w;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    int keep = off + 1 - 16 * m;
    if (keep <= 0) break;
    if (keep > 16) keep = 16;
    const unsigned mask = 0xFFFFFFFFu << (32 - 2 * keep);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned nx = ~(w[m] ^ (0x55555555u * (unsigned)c));
      cnt[c] += __popc(nx & (nx >> 1) & 0x55555555u & mask);
    }
  }
}

// bwt_extend for the one base c that is taken (FMIndex.extend semantics):
// the counted coordinate is x1 forward and x0 backward; the other one is
// assigned cumulatively in the complement order T, G, C, A
__device__ __forceinline__ Intv extend_one(const Index& ix, const Intv& ik,
                                           int is_back, int c) {
  const int xf = is_back ? ik.x0 : ik.x1;
  const int xo = is_back ? ik.x1 : ik.x0;
  int tk[4], tl[4];
  occ4(ix, xf - 1, tk);
  occ4(ix, xf - 1 + ik.s, tl);
  const int span = (xf <= ix.primary && xf + ik.s - 1 >= ix.primary) ? 1 : 0;
  int other = xo + span;
#pragma unroll
  for (int cc = 3; cc > 0; --cc)
    if (cc > c) other += tl[cc] - tk[cc];
  Intv ok;
  ok.s = tl[c] - tk[c];
  const int coord = ix.l2[c] + 1 + tk[c];
  ok.x0 = is_back ? coord : other;
  ok.x1 = is_back ? other : coord;
  ok.start = 0;
  ok.end = 0;
  return ok;
}

__device__ __forceinline__ Intv set_intv(const Index& ix, int c) {
  Intv iv;
  iv.x0 = ix.l2[c] + 1;
  iv.x1 = ix.l2[3 - c] + 1;
  iv.s = ix.l2[c + 1] - ix.l2[c];
  iv.start = 0;
  iv.end = 0;
  return iv;
}

// One seeding round from x (bwt_smem1a_new, max_intv = 0): pushes SMEMs to
// the output and returns the next start, or -1 after a cap bust.
__device__ int smem1a(const Index& ix, const uint8_t* seq, int64_t B, int ln,
                      int x, int min_intv, int min_seed_len, int chain_cap,
                      Intv* curr, Intv* back, Out& o) {
  const int cx = seq[x * B];
  if (cx > 3) return x + 1;
  if (min_intv < 1) min_intv = 1;
  Intv ik = set_intv(ix, cx);
  ik.end = x + 1;
  int nc = 0;
  int i = x + 1;
  for (; i < ln; ++i) {
    const int ci = seq[i * B];
    if (ci < 4) {
      const int c = 3 - ci;
      const Intv ok = extend_one(ix, ik, 0, c);
      ++o.probes;
      if (ok.s != ik.s) {
        if (nc >= chain_cap) {
          o.bust = true;
          return -1;
        }
        curr[nc++] = ik;
        if (ok.s < min_intv) break;
      }
      ik.x0 = ok.x0;
      ik.x1 = ok.x1;
      ik.s = ok.s;
      ik.end = i + 1;
    } else {
      if (nc >= chain_cap) {
        o.bust = true;
        return -1;
      }
      curr[nc++] = ik;
      break;
    }
  }
  if (i == ln) {
    if (nc >= chain_cap) {
      o.bust = true;
      return -1;
    }
    curr[nc++] = ik;
  }
  const int ret = curr[nc - 1].end;

  int nb = 0, start = x, stop = x;
  Intv temp = ik;
  int ci = 0;
  while (ci < nc) {
    ik = curr[ci];
    ik.start = x;
    if (nb == 0 || stop - start >= 3) {
      // backenlarge: a fresh backward chain
      nb = 0;
      back[nb++] = ik;
      for (int k = x - 1; k >= 0; --k) {
        const int c = seq[k * B];
        if (c > 3) break;
        const Intv ok = extend_one(ix, ik, 1, c);
        ++o.probes;
        if (ok.s < min_intv) break;
        ik.x0 = ok.x0;
        ik.x1 = ok.x1;
        ik.s = ok.s;
        ik.start = k;
        ik.end = curr[ci].end;
        if (nb >= chain_cap) {
          o.bust = true;
          return -1;
        }
        back[nb++] = ik;
      }
      start = curr[ci].end;
      stop = ci < nc - 1 ? curr[ci + 1].end : ln;
      if (ci > 0 && ik.start > temp.start &&
          temp.end - temp.start >= min_seed_len && !push_mem(o, temp))
        return -1;
      temp = ik;
    } else {
      // forwardenlarge: extend a previous backward chain forward
      stop = curr[ci].end;
      bool isbreak = false;
      for (int k = nb - 1; k >= 0; --k) {
        ik = back[k];
        for (int m = start + 1; m <= stop; ++m) {
          // bases in (start, stop] are never N (curr intervals end before
          // one); the clamp mirrors the oracle's ok[-1] == ok[3]
          const int sm = seq[(m - 1) * B];
          const Intv ok = extend_one(ix, ik, 0, sm < 4 ? 3 - sm : 3);
          ++o.probes;
          if (ok.s < min_intv) break;
          ik.x0 = ok.x0;
          ik.x1 = ok.x1;
          ik.s = ok.s;
          if (m == stop) {
            ik.start = x - k;
            ik.end = curr[ci].end;
            isbreak = true;
          }
        }
        if (isbreak) {
          if ((x - k) > temp.start && temp.end - temp.start >= min_seed_len &&
              !push_mem(o, temp))
            return -1;
          temp = ik;
          break;
        }
      }
    }
    ++ci;
    // skip intervals that cannot give a long enough seed
    if (ci < nc) {
      int max_len = temp.start + curr[ci].end;
      while (max_len < min_seed_len && ci < nc) {
        ++ci;
        if (ci < nc) stop = curr[ci].end;
        max_len = temp.start + stop;
      }
    }
    if (ci >= nc && temp.end - temp.start >= min_seed_len && !push_mem(o, temp))
      return -1;
  }
  return ret;
}

// pass 3 (bwt_seed_strategy1): the first extension from x whose interval
// drops below max_intv after min_len bases
__device__ int seed_strategy1(const Index& ix, const uint8_t* seq, int64_t B,
                              int ln, int x, int min_len, int max_intv,
                              Intv* out, bool* found, Out& o) {
  *found = false;
  const int cx = seq[x * B];
  if (cx > 3) return x + 1;
  Intv ik = set_intv(ix, cx);
  for (int i = x + 1; i < ln; ++i) {
    const int ci = seq[i * B];
    if (ci > 3) return i + 1;
    const Intv ok = extend_one(ix, ik, 0, 3 - ci);
    ++o.probes;
    if (ok.s < max_intv && i - x >= min_len) {
      *out = ok;
      out->start = x;
      out->end = i + 1;
      *found = true;
      return i + 1;
    }
    ik.x0 = ok.x0;
    ik.x1 = ok.x1;
    ik.s = ok.s;
  }
  return ln;
}

__global__ void __launch_bounds__(128)
smem_collect_kernel(Index ix, const uint8_t* __restrict__ seqs,
                    const int32_t* __restrict__ lens, int L, int batch,
                    int min_seed_len, int split_len, int split_width,
                    int max_mem_intv, int chain_cap, int mem_cap,
                    int32_t* __restrict__ mem, int32_t* __restrict__ mem_n,
                    int32_t* __restrict__ flag, int32_t* __restrict__ probes) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int64_t B = batch;
  const int ln = min(max(lens[b], 0), L);
  const uint8_t* seq = seqs + b;
  Intv curr[kChainMax], back[kChainMax];
  Out o{mem + b, (int64_t)mem_cap * B, B, mem_cap, 0, 0, false};

  // pass 1: all SMEMs
  int x = 0;
  while (x < ln) {
    if (seq[x * B] < 4) {
      x = smem1a(ix, seq, B, ln, x, 1, min_seed_len, chain_cap, curr, back, o);
      if (o.bust) break;
    } else {
      ++x;
    }
  }
  // pass 2: re-seed long low-occurrence SMEMs from their midpoint
  const int old_n = o.n;
  for (int k = 0; k < old_n && !o.bust; ++k) {
    const int32_t* p = o.mem + (int64_t)k * B;
    const int s = p[2 * o.plane], st = p[3 * o.plane], en = p[4 * o.plane];
    if (en - st < split_len || s > split_width) continue;
    smem1a(ix, seq, B, ln, (st + en) >> 1, s + 1, min_seed_len, chain_cap,
           curr, back, o);
  }
  // pass 3: LAST-like
  x = 0;
  while (x < ln && !o.bust) {
    if (seq[x * B] < 4) {
      Intv iv;
      bool found;
      x = seed_strategy1(ix, seq, B, ln, x, min_seed_len, max_mem_intv, &iv,
                         &found, o);
      if (found && iv.s > 0) push_mem(o, iv);
    } else {
      ++x;
    }
  }
  mem_n[b] = o.n;
  flag[b] = o.bust ? 1 : 0;
  probes[b] = o.probes;
}

}  // namespace

extern "C" {

// tbl (nblk, 8) int32; l2 the five cumulative counts; seqs (L, B) uint8
// codes (4 = N), lens (B,) int32; outputs mem (5, mem_cap, B), mem_n, flag
// and probes (B,) int32.  Returns a cudaError_t (0 on success).
int smem_collect(const int32_t* tbl, int primary, int l2_0, int l2_1, int l2_2,
                 int l2_3, int l2_4, const uint8_t* seqs, const int32_t* lens,
                 int L, int batch, int min_seed_len, int split_len,
                 int split_width, int max_mem_intv, int chain_cap, int mem_cap,
                 int32_t* mem, int32_t* mem_n, int32_t* flag, int32_t* probes,
                 void* stream) {
  if (L <= 0 || batch < 0 || chain_cap < 1 || chain_cap > kChainMax ||
      mem_cap < 1)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  Index ix{(const int4*)tbl, primary, {l2_0, l2_1, l2_2, l2_3, l2_4}};
  const int threads = 128;
  smem_collect_kernel<<<(batch + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(
      ix, seqs, lens, L, batch, min_seed_len, split_len, split_width,
      max_mem_intv, chain_cap, mem_cap, mem, mem_n, flag, probes);
  return (int)cudaGetLastError();
}

}  // extern "C"
