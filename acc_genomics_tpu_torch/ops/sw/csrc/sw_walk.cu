// Batched Smith-Waterman backtrack walk for Hopper (sm_90a).
//
// Replaces the XLA loop acc_genomics_tpu/ops/sw/walker.py `sw_walk_device`
// (a jitted while loop: on a GPU in eager PyTorch every step of it would
// be its own launch).
//
// What it computes, per pair, from the fill's outputs (sw_fill.cu):
//   * the start cell with GATK's tie-break (calculateCigarOneBatch): the
//     last maximum of the last alt column; then, unless the strategy is
//     INDEL or LEADING_INDEL, the cell of the last row with the smallest
//     key 2|reflen - j| + (j > reflen) among its maxima replaces it when
//     it is strictly greater, or equal and strictly closer to the corner
//     (walker.py's reduction of GATK's sequential chain);
//   * the SOFTCLIP leading clip of the alt columns past the start;
//   * the walk, run-length-encoding elements (length, state) in walk order
//     into 48 slots; past 48 the count keeps growing and the last slot is
//     overwritten, and the host reruns such pairs on the oracle;
//   * the finish of each strategy and the alignment offset.
// Output: one int16 (48 + 2, B) buffer, the layout of walker.py:212-222:
// rows 0..47 hold len | state << 12, row 48 the element count, row 49
// the offset.  Only this buffer leaves the card.
//
// Design: one warp per pair.  The btrack matrix (B, D, R) holds cell
// (i, j) at [b][i + j][i]; a walk step's address depends on the code just
// read, so a walk that reads one cell at a time waits one memory round
// trip a step.  Here every round reads the next 32 cells of the diagonal
// at once, lane l the cell (p1 - l, p2 - l), addresses all known before
// the load issues; a ballot finds the first gap code (or the matrix
// edge), every cell before it is a match step, and the gap cell is taken
// as one step.  A walk of S steps with G gaps costs about S / 32 + G round
// trips.  The start cell comes from warp reductions over the last alt
// column and the last row, read coalesced.  Every lane runs the same walk
// state (only the loads differ); lane s % 32 keeps element slot s in a
// register and the 50 values are written once at the end.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kShipElems = 48;
constexpr int kSoftclip = 0, kIndel = 1, kLeadingIndel = 2, kIgnore = 3;
constexpr int kMatch = 0, kInsertion = 1, kDeletion = 2, kClip = 4;
constexpr int kLow = -(1 << 30);  // the plain version's mask value (LOW_INIT)
constexpr int kBig = 1 << 30;     // its "no eligible cell" key
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 2;

// (largest value, the largest i holding it) of v[0..n) with i = index + 1,
// masked cells counted as kLow when n < width, over the warp: the last
// maximum of the alt column.
__device__ __forceinline__ void last_max(const int32_t* __restrict__ v, int n,
                                         int width, int lane, int& m,
                                         int& at) {
  int best = n < width ? kLow : INT_MIN, where = 0;
  for (int i0 = lane; i0 < n; i0 += 128) {
    int x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      x[k] = i0 + 32 * k < n ? __ldg(v + i0 + 32 * k) : INT_MIN;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i0 + 32 * k < n && x[k] >= best) {
        best = x[k];
        where = i0 + 32 * k + 1;
      }
  }
  m = __reduce_max_sync(kFull, best);
  at = __reduce_max_sync(kFull, best == m ? where : 0);
}

// (largest value, the smallest key 2|rl - j| + (j > rl) among the cells
// holding it) of the last row v[0..n), j = index + 1, masked as above.
__device__ __forceinline__ void nearest_max(const int32_t* __restrict__ v,
                                            int n, int width, int rl,
                                            int lane, int& m, int& kmin) {
  int best = n < width ? kLow : INT_MIN, key = kBig;
  for (int j0 = lane; j0 < n; j0 += 128) {
    int x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      x[k] = j0 + 32 * k < n ? __ldg(v + j0 + 32 * k) : INT_MIN;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + 32 * k + 1;
      if (j > n) continue;
      const int kj = 2 * abs(rl - j) + (j > rl);
      if (x[k] > best) {
        best = x[k];
        key = kj;
      } else if (x[k] == best) {
        key = min(key, kj);
      }
    }
  }
  m = __reduce_max_sync(kFull, best);
  kmin = __reduce_min_sync(kFull, best == m ? key : kBig);
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    sw_walk_kernel(const int16_t* __restrict__ btrack,
                   const int32_t* __restrict__ lastrow,
                   const int32_t* __restrict__ altcol,
                   const int32_t* __restrict__ reflen,
                   const int32_t* __restrict__ altlen, int rows, int cols,
                   int batch, int strategy, int16_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= batch) return;  // the whole warp
  const int rl = max(0, min(reflen[b], rows));
  const int al = max(0, min(altlen[b], cols));

  // lane s % 32 holds element slot s: lo for s < 32, hi for 32 <= s < 48
  int16_t lo = 0, hi = 0;
  auto put = [&](int slot, int len, int state) {
    const int s = min(slot, kShipElems - 1);
    const int16_t v = (int16_t)(len | (state << 12));
    if (lane == (s & 31)) {
      if (s < 32)
        lo = v;
      else
        hi = v;
    }
  };

  // -- start cell ---------------------------------------------------------
  int p1 = rl, p2 = al, seg = 0;
  if (strategy != kIndel) {
    int m1, p1a;
    last_max(altcol + (int64_t)b * rows, rl, rows, lane, m1, p1a);
    p1 = p1a;
    if (strategy != kLeadingIndel) {
      int mlr, kmin;
      nearest_max(lastrow + (int64_t)b * cols, al, cols, rl, lane, mlr, kmin);
      if (mlr > m1 || (mlr == m1 && (kmin >> 1) < abs(p1a - al))) {
        // kmin names its cell: even keys lie at j <= rl, odd ones past it
        const int jstar = kmin & 1 ? rl + (kmin >> 1) : rl - (kmin >> 1);
        p1 = rl;
        p2 = jstar;
        seg = al - jstar;
      }
    }
  }

  int en = 0;
  if (strategy == kSoftclip) {
    if (seg > 0) {
      put(en, seg, kClip);
      en = 1;
    }
    seg = 0;
  }

  // -- walk, 32 cells of the diagonal a round ------------------------------
  const int n_diag = rows + cols - 1;
  const int16_t* bt = btrack + (int64_t)b * n_diag * rows;
  int state = kMatch;
  bool active = p1 > 0 && p2 > 0 && rl > 0 && al > 0;
  while (active) {
    const int i = p1 - lane, j = p2 - lane;
    const bool inside = i > 0 && j > 0;
    const int code = inside ? __ldg(bt + (int64_t)(i + j - 2) * rows + (i - 1)) : 0;
    const unsigned stop = __ballot_sync(kFull, !inside || code != 0);
    const int run = stop ? __ffs(stop) - 1 : 32;  // match steps before the stop
    const int gap = __shfl_sync(kFull, code, run & 31);
    if (run > 0) {
      if (state != kMatch) {
        put(en, seg, state);
        ++en;
        seg = run;
        state = kMatch;
      } else {
        seg += run;
      }
      p1 -= run;
      p2 -= run;
    }
    if (run < 32 && p1 > 0 && p2 > 0) {  // the stop is a gap cell: one step
      const int new_state = gap > 0 ? kDeletion : kInsertion;
      const int step = abs(gap);
      if (new_state != state) {
        put(en, seg, state);
        ++en;
        seg = step;
        state = new_state;
      } else {
        seg += step;
      }
      if (gap > 0)
        p1 -= step;
      else
        p2 -= step;
    }
    active = p1 > 0 && p2 > 0;
  }

  // -- finish ---------------------------------------------------------------
  int offset;
  if (strategy == kSoftclip) {
    put(en, seg, state);
    ++en;
    if (p2 > 0) {
      put(en, p2, kClip);
      ++en;
    }
    offset = p1;
  } else if (strategy == kIgnore) {
    put(en, seg + p2, state);
    ++en;
    offset = p1 - p2;
  } else {
    put(en, seg, state);
    ++en;
    if (p1 > 0) {
      put(en, p1, kDeletion);
      ++en;
    } else if (p2 > 0) {
      put(en, p2, kInsertion);
      ++en;
    }
    offset = 0;
  }
  int16_t* o = out + b;
  o[(int64_t)lane * batch] = lo;
  if (lane < kShipElems - 32) o[(int64_t)(lane + 32) * batch] = hi;
  if (lane == kShipElems - 32) o[(int64_t)kShipElems * batch] = (int16_t)en;
  if (lane == kShipElems - 31) o[(int64_t)(kShipElems + 1) * batch] = (int16_t)offset;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).
int sw_walk(const int16_t* btrack, const int32_t* lastrow,
            const int32_t* altcol, const int32_t* reflen,
            const int32_t* altlen, int rows, int cols, int batch,
            int strategy, int16_t* out, void* stream) {
  if (rows <= 0 || cols <= 0 || strategy < kSoftclip || strategy > kIgnore)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  sw_walk_kernel<<<(batch + kWarpsPerBlock - 1) / kWarpsPerBlock,
                   32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
      btrack, lastrow, altcol, reflen, altlen, rows, cols, batch, strategy,
      out);
  return (int)cudaGetLastError();
}

}  // extern "C"
