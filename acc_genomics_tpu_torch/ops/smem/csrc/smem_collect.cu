// BWA-MEM SMEM collection (mem_collect_intv, 3 passes) for Hopper (sm_90a).
//
// Replaces the JAX package's device state machine
// acc_genomics_tpu/ops/smem/machine.py `smem_collect_machine` (an XLA
// while loop over a flat 12-state machine; on a GPU in eager PyTorch every
// step of it would be its own launch) and its fetch `smem_flat_gather`.
//
// What it computes, per read, is the native host engine's
// `smem_collect_batch_native` (native/accnative.cpp:509-756), step for
// step, because intervals are compared as exact integers and their order
// is the contract:
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
// (`back`) hold at most `chain_cap` rows (<= kChainMax); the output holds
// mem_cap rows.  A read that would push past either cap stops there with
// flag = 1 and is rerun: never truncated.  Its count and rows up to the
// stop are still written (the plain version stops at the same push).
// Neither chain of a read outgrows its length (a forward step pushes at
// most one `curr` row, a backward step one `back` row), so a second
// launch at chain_cap = L + 1 (up to kChainMax) finishes a flagged read
// unless its output passes mem_cap.
//
// Design: a one-probe lockstep machine.  Each lane holds one read's
// machine (the states of the plain version, ops/smem/kernel.py, and of
// the JAX machine) in registers.  An iteration of the warp's loop lets
// every lane run its bookkeeping until its next extension (short, per
// lane), then every lane that has one makes it together: one occ4 pair,
// two 32-byte rows, whatever pass or stage its read is in.  So the lanes
// converge on the table loads, where the one-thread-a-read nested loops
// ran each stage's loads one stage after another.  The warps are
// persistent: the grid is what the card holds at once, and a lane whose
// read ends takes the next read index from an atomic counter, so no warp
// idles behind its longest read.  Outputs stay at the read's own index.
// The chains live in shared memory, row-major over the block's lanes
// (conflict-free): curr (x0, x1, s, end) and back (x0, x1, s) rows; a back
// row's start is x - row and its end the chain's, so neither is stored.
// A lane copies its read there when it takes it (the wrapper hands the
// kernel a read-major copy of the batch, so a read is a few 16-byte loads),
// and the bookkeeping reads bases from shared memory.
//
// Bound on this card: the latency of dependent 32-byte gathers from a
// table of up to 100 MB (each extension needs two rows, and the next one
// depends on them), hidden by the other lanes' extensions in flight.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// the largest chain cap whose chains and read fit a 32-lane block's
// 227 KB of shared memory at L = 256: (7 * 4 * 250 + 256) * 32 bytes
constexpr int kChainMax = 250;
// the dynamic shared memory a block may take on sm_90 (BLOCK_SMEM of
// ops/smem/kernel.py, whose caps() refuses what would not fit)
constexpr size_t kBlockSmem = 227 * 1024;
constexpr int kBlockMax = 64;
constexpr unsigned kFull = 0xffffffffu;

struct Index {
  const int4* tbl;  // (nblk, 8) int32 rows as two int4 each
  int primary;
  int l2[5];
};

struct Params {
  Index ix;
  const uint8_t* seqs;  // (B, stride) read-major, stride a multiple of 16
  const int32_t* lens;
  int L, stride, batch;
  int min_seed_len, split_len, split_width, max_mem_intv, chain_cap, mem_cap;
  int32_t* mem;  // (5, mem_cap, B)
  int32_t* mem_n;
  int32_t* flag;
  int32_t* probes;
  int32_t* next;  // the read queue
};

enum State { kP1, kP2, kP3, kFwd, kBStart, kBack, kFwde, kAfter, kP3Ext, kDone };

// chain fields: curr x0, x1, s, end; back x0, x1, s
enum Field { kCx0, kCx1, kCs, kCend, kBx0, kBx1, kBs };

struct Ext {
  int x0, x1, s;
};

struct Lane {
  int32_t* mem;  // &mem[0][0][b]
  int b, ln;
  int st, n, probes;
  bool bust, has_read;
  int mode, min_intv, x, sx, p2_k, p2_old_n;
  int ik0, ik1, iks, ikst, iken;  // the interval being extended
  int i, nc, ret, nb, start, stop, ci, kb, fk, fm, bend;
  bool isbreak;
  int t0, t1, t2, t3, t4;  // temp: the pending SMEM
  int pdir, pc;            // the requested extension: direction, base
};

// the lane's scratch in shared memory: its chains, then its read (one
// byte a base, position-major over the block's lanes)
struct Chains {
  int* sm;
  uint8_t* seq;
  int cap, width, tid;
  __device__ __forceinline__ int& at(int field, int row) const {
    return sm[(field * cap + row) * width + tid];
  }
  __device__ __forceinline__ int base(int pos) const {
    return seq[pos * width + tid];
  }
};

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

// l2[c] by selects: a dynamic index into the kernel parameters would copy
// them to local memory
__device__ __forceinline__ int l2_at(const Index& ix, int c) {
  return c == 0 ? ix.l2[0] : c == 1 ? ix.l2[1] : c == 2 ? ix.l2[2]
                           : c == 3 ? ix.l2[3] : ix.l2[4];
}

// bwt_extend for the one base c that is taken (FMIndex.extend semantics):
// the counted coordinate is x1 forward and x0 backward; the other one is
// assigned cumulatively in the complement order T, G, C, A
__device__ __forceinline__ Ext extend_one(const Index& ix, int x0, int x1,
                                          int s, int is_back, int c) {
  const int xf = is_back ? x0 : x1;
  const int xo = is_back ? x1 : x0;
  int tk[4], tl[4];
  occ4(ix, xf - 1, tk);
  occ4(ix, xf - 1 + s, tl);
  const int span = (xf <= ix.primary && xf + s - 1 >= ix.primary) ? 1 : 0;
  int other = xo + span;
#pragma unroll
  for (int cc = 3; cc > 0; --cc)
    if (cc > c) other += tl[cc] - tk[cc];
  Ext ok;
  // counts of base c by selects (a dynamic index puts tk, tl on the stack)
  const int tkc = c == 0 ? tk[0] : c == 1 ? tk[1] : c == 2 ? tk[2] : tk[3];
  const int tlc = c == 0 ? tl[0] : c == 1 ? tl[1] : c == 2 ? tl[2] : tl[3];
  ok.s = tlc - tkc;
  const int coord = l2_at(ix, c) + 1 + tkc;
  ok.x0 = is_back ? coord : other;
  ok.x1 = is_back ? other : coord;
  return ok;
}

__device__ __forceinline__ bool push_mem(Lane& s, const Params& p, int x0,
                                         int x1, int sz, int start, int end) {
  if (s.n >= p.mem_cap) {
    s.bust = true;
    s.st = kDone;
    return false;
  }
  const int64_t plane = (int64_t)p.mem_cap * p.batch;
  int32_t* o = s.mem + (int64_t)s.n * p.batch;
  o[0] = x0;
  o[plane] = x1;
  o[2 * plane] = sz;
  o[3 * plane] = start;
  o[4 * plane] = end;
  ++s.n;
  return true;
}

__device__ __forceinline__ bool push_temp(Lane& s, const Params& p) {
  return push_mem(s, p, s.t0, s.t1, s.t2, s.t3, s.t4);
}

__device__ __forceinline__ void take_temp(Lane& s) {
  s.t0 = s.ik0;
  s.t1 = s.ik1;
  s.t2 = s.iks;
  s.t3 = s.ikst;
  s.t4 = s.iken;
}

// one seeding round from x (bwt_smem1a_new, max_intv = 0); seq[x] is a base
__device__ __forceinline__ void begin_round(Lane& s, const Params& p,
                                            const Chains& ch, int x,
                                            int min_intv, int mode) {
  const int cx = ch.base(x);
  s.sx = x;
  s.mode = mode;
  s.min_intv = min_intv < 1 ? 1 : min_intv;
  s.ik0 = l2_at(p.ix, cx) + 1;
  s.ik1 = l2_at(p.ix, 3 - cx) + 1;
  s.iks = l2_at(p.ix, cx + 1) - l2_at(p.ix, cx);
  s.ikst = 0;
  s.iken = x + 1;
  s.nc = 0;
  s.i = x + 1;
  s.st = kFwd;
}

// the forward pass ends: push ik as the last break interval
__device__ __forceinline__ bool push_curr(Lane& s, const Params& p,
                                          const Chains& ch) {
  if (s.nc >= p.chain_cap) {
    s.bust = true;
    s.st = kDone;
    return false;
  }
  ch.at(kCx0, s.nc) = s.ik0;
  ch.at(kCx1, s.nc) = s.ik1;
  ch.at(kCs, s.nc) = s.iks;
  ch.at(kCend, s.nc) = s.iken;
  ++s.nc;
  return true;
}

__device__ __forceinline__ void fwd_end(Lane& s, const Chains& ch) {
  s.ret = ch.at(kCend, s.nc - 1);
  s.nb = 0;
  s.start = s.sx;
  s.stop = s.sx;
  take_temp(s);
  s.ci = 0;
  s.st = kBStart;
}

__device__ __forceinline__ void load_back(Lane& s, const Chains& ch, int row) {
  s.ik0 = ch.at(kBx0, row);
  s.ik1 = ch.at(kBx1, row);
  s.iks = ch.at(kBs, row);
  s.ikst = s.sx - row;
  s.iken = s.bend;
}

// the backward chain stops: close interval ci
__device__ __forceinline__ void back_end(Lane& s, const Params& p,
                                         const Chains& ch) {
  s.start = ch.at(kCend, s.ci);
  s.stop = s.ci < s.nc - 1 ? ch.at(kCend, s.ci + 1) : s.ln;
  if (s.ci > 0 && s.ikst > s.t3 && s.t4 - s.t3 >= p.min_seed_len &&
      !push_temp(s, p))
    return;
  take_temp(s);
  s.st = kAfter;
}

// forwardenlarge: one back row's extension ended (broke or reached stop)
__device__ __forceinline__ void fwde_end(Lane& s, const Params& p,
                                         const Chains& ch) {
  if (s.isbreak) {
    if (s.sx - s.fk > s.t3 && s.t4 - s.t3 >= p.min_seed_len &&
        !push_temp(s, p))
      return;
    take_temp(s);
    s.st = kAfter;
    return;
  }
  if (--s.fk >= 0) {
    load_back(s, ch, s.fk);
    s.fm = s.start + 1;
  } else {
    s.st = kAfter;
  }
}

// run the lane's bookkeeping up to its next extension (true) or to the
// end of its read (false)
__device__ __forceinline__ bool advance(Lane& s, const Params& p, const Chains& ch) {
  for (;;) {
    switch (s.st) {
      case kP1:  // pass 1: all SMEMs
        while (s.x < s.ln && ch.base(s.x) > 3) ++s.x;
        if (s.x < s.ln) {
          begin_round(s, p, ch, s.x, 1, 1);
        } else {
          s.p2_old_n = s.n;
          s.p2_k = 0;
          s.st = kP2;
        }
        break;
      case kP2:  // pass 2: re-seed long low-occurrence SMEMs from the middle
        if (s.p2_k >= s.p2_old_n) {
          s.x = 0;
          s.st = kP3;
        } else {
          const int64_t plane = (int64_t)p.mem_cap * p.batch;
          const int32_t* r = s.mem + (int64_t)s.p2_k * p.batch;
          const int sz = r[2 * plane], st = r[3 * plane], en = r[4 * plane];
          ++s.p2_k;
          const int mid = (st + en) >> 1;
          if (en - st >= p.split_len && sz <= p.split_width &&
              ch.base(mid) <= 3)
            begin_round(s, p, ch, mid, sz + 1, 2);
        }
        break;
      case kP3:  // pass 3: LAST-like
        while (s.x < s.ln && ch.base(s.x) > 3) ++s.x;
        if (s.x >= s.ln) {
          s.st = kDone;
        } else {
          const int cx = ch.base(s.x);
          s.ik0 = l2_at(p.ix, cx) + 1;
          s.ik1 = l2_at(p.ix, 3 - cx) + 1;
          s.iks = l2_at(p.ix, cx + 1) - l2_at(p.ix, cx);
          s.i = s.x + 1;
          s.st = kP3Ext;
        }
        break;
      case kP3Ext:
        if (s.i >= s.ln) {
          s.x = s.ln;
          s.st = kP3;
        } else {
          const int c = ch.base(s.i);
          if (c > 3) {
            s.x = s.i + 1;
            s.st = kP3;
          } else {
            s.pdir = 0;
            s.pc = 3 - c;
            return true;
          }
        }
        break;
      case kFwd:  // the forward pass, collecting break intervals
        if (s.i < s.ln) {
          const int c = ch.base(s.i);
          if (c < 4) {
            s.pdir = 0;
            s.pc = 3 - c;
            return true;
          }
        }
        if (push_curr(s, p, ch)) fwd_end(s, ch);  // the read's end or an N
        break;
      case kBStart:  // interval ci: backenlarge or forwardenlarge
        if (s.ci >= s.nc) {
          if (s.mode == 1) {
            s.x = s.ret;
            s.st = kP1;
          } else {
            s.st = kP2;
          }
          break;
        }
        s.ik0 = ch.at(kCx0, s.ci);
        s.ik1 = ch.at(kCx1, s.ci);
        s.iks = ch.at(kCs, s.ci);
        s.ikst = s.sx;
        s.iken = ch.at(kCend, s.ci);
        if (s.nb == 0 || s.stop - s.start >= 3) {
          ch.at(kBx0, 0) = s.ik0;
          ch.at(kBx1, 0) = s.ik1;
          ch.at(kBs, 0) = s.iks;
          s.nb = 1;
          s.bend = s.iken;
          s.kb = s.sx - 1;
          s.st = kBack;
        } else {
          s.stop = s.iken;
          s.fk = s.nb - 1;
          s.isbreak = false;
          load_back(s, ch, s.fk);
          s.fm = s.start + 1;
          s.st = kFwde;
        }
        break;
      case kBack:
        if (s.kb >= 0) {
          const int c = ch.base(s.kb);
          if (c <= 3) {
            s.pdir = 1;
            s.pc = c;
            return true;
          }
        }
        back_end(s, p, ch);
        break;
      case kFwde:
        if (s.fm <= s.stop) {
          // bases in (start, stop] are never N (curr intervals end before
          // one); the clamp mirrors the oracle's ok[-1] == ok[3]
          const int c = ch.base(s.fm - 1);
          s.pdir = 0;
          s.pc = c < 4 ? 3 - c : 3;
          return true;
        }
        fwde_end(s, p, ch);
        break;
      case kAfter:  // skip intervals that cannot give a long enough seed
        ++s.ci;
        if (s.ci < s.nc) {
          int max_len = s.t3 + ch.at(kCend, s.ci);
          while (max_len < p.min_seed_len && s.ci < s.nc) {
            ++s.ci;
            if (s.ci < s.nc) s.stop = ch.at(kCend, s.ci);
            max_len = s.t3 + s.stop;
          }
        }
        if (s.ci >= s.nc && s.t4 - s.t3 >= p.min_seed_len && !push_temp(s, p))
          break;
        s.st = kBStart;
        break;
      default:  // kDone
        return false;
    }
  }
}

// take the extension's result
__device__ __forceinline__ void apply(Lane& s, const Params& p,
                                      const Chains& ch, const Ext& ok) {
  ++s.probes;
  switch (s.st) {
    case kFwd:
      if (ok.s != s.iks) {
        if (!push_curr(s, p, ch)) return;
        if (ok.s < s.min_intv) {
          fwd_end(s, ch);
          return;
        }
      }
      s.ik0 = ok.x0;
      s.ik1 = ok.x1;
      s.iks = ok.s;
      s.iken = s.i + 1;
      ++s.i;
      return;
    case kBack:
      if (ok.s < s.min_intv) {
        back_end(s, p, ch);
        return;
      }
      s.ik0 = ok.x0;
      s.ik1 = ok.x1;
      s.iks = ok.s;
      s.ikst = s.kb;
      s.iken = s.bend;
      if (s.nb >= p.chain_cap) {
        s.bust = true;
        s.st = kDone;
        return;
      }
      ch.at(kBx0, s.nb) = s.ik0;
      ch.at(kBx1, s.nb) = s.ik1;
      ch.at(kBs, s.nb) = s.iks;
      ++s.nb;
      --s.kb;
      return;
    case kFwde:
      if (ok.s < s.min_intv) {
        fwde_end(s, p, ch);
        return;
      }
      s.ik0 = ok.x0;
      s.ik1 = ok.x1;
      s.iks = ok.s;
      if (s.fm == s.stop) {
        s.ikst = s.sx - s.fk;
        s.iken = ch.at(kCend, s.ci);
        s.isbreak = true;
        fwde_end(s, p, ch);
        return;
      }
      ++s.fm;
      return;
    default:  // kP3Ext
      if (ok.s < p.max_mem_intv && s.i - s.x >= p.min_seed_len) {
        const int start = s.x;
        s.x = s.i + 1;
        s.st = kP3;
        if (ok.s > 0) push_mem(s, p, ok.x0, ok.x1, ok.s, start, s.i + 1);
        return;
      }
      s.ik0 = ok.x0;
      s.ik1 = ok.x1;
      s.iks = ok.s;
      ++s.i;
      return;
  }
}

__device__ __forceinline__ void start_read(Lane& s, const Params& p,
                                           const Chains& ch, int b) {
  s.b = b;
  s.mem = p.mem + b;
  s.ln = min(max(p.lens[b], 0), p.L);
  // 16 bases a load, eight loads in flight
  const int4* src = (const int4*)(p.seqs + (int64_t)b * p.stride);
  for (int c0 = 0; c0 * 16 < s.ln; c0 += 8) {
    int4 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if ((c0 + k) * 16 < s.ln) v[k] = __ldg(src + c0 + k);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int w[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int pos = (c0 + k) * 16 + q;
        if (pos < s.ln) ch.seq[pos * ch.width + ch.tid] = (uint8_t)(w[q >> 2] >> (8 * (q & 3)));
      }
    }
  }
  s.n = 0;
  s.probes = 0;
  s.bust = false;
  s.has_read = true;
  s.x = 0;
  s.st = kP1;
}

__device__ __forceinline__ void finish_read(Lane& s, const Params& p) {
  p.mem_n[s.b] = s.n;
  p.flag[s.b] = s.bust ? 1 : 0;
  p.probes[s.b] = s.probes;
  s.has_read = false;
}

__global__ void __launch_bounds__(kBlockMax) smem_collect_kernel(Params p) {
  extern __shared__ int chain_rows[];
  const int width = blockDim.x;
  const Chains ch{chain_rows, (uint8_t*)(chain_rows + 7 * p.chain_cap * width),
                  p.chain_cap, width, (int)threadIdx.x};
  Lane s;
  s.has_read = false;
  s.st = kDone;
  bool live = true, want = false;
  for (;;) {
    // bookkeeping, lane by lane: finish a read, take the next from the
    // queue, run it up to its next extension
    while (live && !want) {
      if (s.has_read) {
        want = advance(s, p, ch);
        if (want) break;
        finish_read(s, p);
      }
      const int b = atomicAdd(p.next, 1);
      if (b >= p.batch) {
        live = false;
      } else {
        start_read(s, p, ch, b);
      }
    }
    if (!__any_sync(kFull, want)) break;
    if (want) {  // the warp's extensions, all at once
      const Ext ok = extend_one(p.ix, s.ik0, s.ik1, s.iks, s.pdir, s.pc);
      apply(s, p, ch, ok);
      want = false;
    }
  }
}

}  // namespace

extern "C" {

// tbl (nblk, 8) int32; l2 the five cumulative counts; seqs (B, stride)
// uint8 codes (4 = N), read-major, stride a multiple of 16 and >= L; lens
// (B,) int32; outputs mem (5, mem_cap, B), mem_n, flag and probes (B,)
// int32; next one int32, 0 at the launch (the read queue).  Returns a
// cudaError_t (0 on success).
int smem_collect(const int32_t* tbl, int primary, int l2_0, int l2_1, int l2_2,
                 int l2_3, int l2_4, const uint8_t* seqs, const int32_t* lens,
                 int L, int stride, int batch, int min_seed_len, int split_len,
                 int split_width, int max_mem_intv, int chain_cap, int mem_cap,
                 int32_t* mem, int32_t* mem_n, int32_t* flag, int32_t* probes,
                 int32_t* next, void* stream) {
  // per lane, 7 int32 chain rows a cap and the read's L bytes; a 32-lane
  // block has to hold them
  const size_t lane_bytes = (size_t)7 * chain_cap * sizeof(int) + L;
  if (L <= 0 || stride < L || stride % 16 || batch < 0 || chain_cap < 1 ||
      chain_cap > kChainMax || mem_cap < 1 || lane_bytes * 32 > kBlockSmem)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  Params p{{(const int4*)tbl, primary, {l2_0, l2_1, l2_2, l2_3, l2_4}},
           seqs, lens, L, stride, batch, min_seed_len, split_len, split_width,
           max_mem_intv, chain_cap, mem_cap, mem, mem_n, flag, probes, next};
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // persistent warps: as many blocks as the card holds at once, of 64
  // lanes, or of 32 where the batch would not fill one block an SM or
  // where 64 lanes' chains would not fit a block
  int threads = batch < 64 * sms || lane_bytes * kBlockMax > kBlockSmem ? 32 : kBlockMax;
  const size_t smem = lane_bytes * threads;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(smem_collect_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, smem_collect_kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t need = ((int64_t)batch + threads - 1) / threads;
  const int blocks = (int)(need < (int64_t)sms * per_sm ? need : (int64_t)sms * per_sm);
  smem_collect_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
