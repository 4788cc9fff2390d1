// Batched Smith-Waterman backtrack walk for Hopper (sm_90a).
//
// Replaces the XLA loop acc_genomics_tpu/ops/sw/walker.py `sw_walk_device`
// (a jitted while loop: on a GPU in eager PyTorch every step of it would
// be its own launch).
//
// What it computes, per pair, from the fill's outputs (sw_fill.cu):
//   * the start cell with GATK's tie-break (calculateCigarOneBatch): the
//     last maximum of the last alt column; then, unless the strategy is
//     INDEL or LEADING_INDEL, a cell of the last row replaces it when it is
//     strictly greater, or equal and strictly closer to the corner by
//     |reflen - j| (the sequential chain that walker.py reduces to an
//     argmin of 2|reflen - j| + (j > reflen));
//   * the SOFTCLIP leading clip of the alt columns past the start;
//   * the walk, one btrack cell per step, run-length-encoding elements
//     (length, state) in walk order into 48 slots; past 48 the count keeps
//     growing and the last slot is overwritten, and the host reruns such
//     pairs on the oracle;
//   * the finish of each strategy and the alignment offset.
// Output: one int16 (48 + 2, B) buffer, the layout of walker.py:212-222:
// rows 0..47 hold len | state << 12, row 48 the element count, row 49
// the offset.  Only this buffer leaves the card.
//
// Design: one thread per pair, all state in registers; each step reads one
// int16 of the pair's btrack (B, D, R), cell (i, j) at [b][i + j][i].
// Bound on this card: the latency of one dependent global load per step
// (the next cell depends on the code just read), hidden only by the other
// pairs' threads; a walk is a few hundred steps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kShipElems = 48;
constexpr int kSoftclip = 0, kIndel = 1, kLeadingIndel = 2, kIgnore = 3;
constexpr int kMatch = 0, kInsertion = 1, kDeletion = 2, kClip = 4;

__global__ void sw_walk_kernel(const int16_t* __restrict__ btrack,
                               const int32_t* __restrict__ lastrow,
                               const int32_t* __restrict__ altcol,
                               const int32_t* __restrict__ reflen,
                               const int32_t* __restrict__ altlen, int rows,
                               int cols, int batch, int strategy,
                               int16_t* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int rl = min(reflen[b], rows);
  const int al = min(altlen[b], cols);
  const int n_diag = rows + cols - 1;
  const int16_t* bt = btrack + (int64_t)b * n_diag * rows;

  auto put = [&](int slot, int len, int state) {
    out[(int64_t)min(slot, kShipElems - 1) * batch + b] =
        (int16_t)(len | (state << 12));
  };
  for (int s = 0; s < kShipElems; ++s) out[(int64_t)s * batch + b] = 0;

  // -- start cell ---------------------------------------------------------
  int p1, p2, seg = 0;
  if (strategy == kIndel) {
    p1 = rl;
    p2 = al;
  } else {
    p1 = 0;
    p2 = al;
    int64_t best = -(int64_t(1) << 62);
    const int32_t* col = altcol + (int64_t)b * rows;
    for (int i = 1; i <= rl; ++i) {
      const int32_t v = col[i - 1];
      if (v >= best) {  // the last maximum
        p1 = i;
        best = v;
      }
    }
    if (strategy != kLeadingIndel) {
      const int32_t* row = lastrow + (int64_t)b * cols;
      for (int j = 1; j <= al; ++j) {
        const int32_t v = row[j - 1];
        if (v > best || (v == best && abs(rl - j) < abs(p1 - p2))) {
          p1 = rl;
          p2 = j;
          best = v;
          seg = al - j;
        }
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

  // -- walk ---------------------------------------------------------------
  int state = kMatch;
  bool active = p1 > 0 && p2 > 0 && rl > 0 && al > 0;
  while (active) {
    const int d = min(max(p1 - 1 + p2 - 1, 0), n_diag - 1);
    const int i = min(max(p1 - 1, 0), rows - 1);
    const int code = bt[(int64_t)d * rows + i];
    const int new_state = code > 0 ? kDeletion : (code < 0 ? kInsertion : kMatch);
    const int step = code > 0 ? code : (code < 0 ? -code : 1);
    if (new_state == kDeletion) {
      p1 -= step;
    } else if (new_state == kInsertion) {
      p2 -= step;
    } else {
      p1 -= 1;
      p2 -= 1;
    }
    if (new_state != state) {
      put(en, seg, state);
      ++en;
      seg = step;
      state = new_state;
    } else {
      seg += step;
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
  out[(int64_t)kShipElems * batch + b] = (int16_t)en;
  out[(int64_t)(kShipElems + 1) * batch + b] = (int16_t)offset;
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
  const int threads = 128;
  sw_walk_kernel<<<(batch + threads - 1) / threads, threads, 0,
                   (cudaStream_t)stream>>>(btrack, lastrow, altcol, reflen,
                                           altlen, rows, cols, batch,
                                           strategy, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
