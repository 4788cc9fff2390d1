// Batched HTC Smith-Waterman fill for Hopper (sm_90a).
//
// Replaces the TPU kernel acc_genomics_tpu/ops/sw/kernel.py
// `_sw_diag_kernel` (launched by `sw_fill_pallas`).
//
// What it computes (ops/sw/reference.py, GATK SWPairwiseAlignment): the
// int32 affine-gap fill of one (ref, alt) pair with step-length backtrack
// codes.  Interior cell (i, j) (matrix row i + 1, column j + 1):
//     diag  = sw(i-1, j-1) + (ref[i] == alt[j] ? match : mismatch)
//     down  : the column's tracker bgv, extended by `extend`, or reopened
//             from sw(i-1, j) + open when that is strictly greater; its
//             gap size gsv restarts at 1 or grows by 1
//     right : the row's tracker bgh from sw(i, j-1) + open, likewise
//     sw    = max(MATRIX_MIN_CUTOFF, diag >= down, right ? diag :
//                 right >= down ? right : down)
//     code  = 0 (diag), -gsh (right), +gsv (down)
// Row 0 and column 0 of the matrix are 0, or the ramps open + (k-1)*extend
// for the INDEL and LEADING_INDEL overhang strategies (`indel_init`).
//
// Layouts (the plain version in ops/sw/kernel.py uses the same):
//   ref (B, R) and alt (B, C) uint8 codes, reflen / altlen (B,) int32;
//   btrack (B, D, R) int16, D = R + C - 1, diagonal d = i + j: cell (i, j)
//     sits at [b][i + j][i], so the threads of one diagonal write
//     neighbouring addresses;
//   lastrow (B, C) int32: sw at interior (reflen - 1, j);
//   altcol (B, R) int32: sw at interior (i, altlen - 1).
// Only cells inside each pair's reflen x altlen region are written.
//
// Design (first, simple and correct):
//   * one thread block per pair; thread t owns rows t, t + T, ... (RPT
//     rows per thread, so a 1536-row bucket runs 768 threads of 2 rows);
//   * a row's horizontal tracker, its previous cell and the diagonal input
//     (the "up" value it read one diagonal earlier) live in registers;
//   * sw and the vertical tracker of the previous diagonal live in shared
//     memory, double-buffered, so one __syncthreads() per diagonal orders
//     diagonal d's writes before diagonal d + 1's reads;
//   * each pair runs its own reflen + altlen - 1 diagonals; the TPU's
//     per-128-lane diagonal counts, row windows and DMA groups are not
//     needed on independent blocks.
//
// Bound on this card: the latency of one block-wide barrier per diagonal
// with a few dozen integer instructions between barriers, and the threads
// that idle on the triangular edges of the wavefront.  The btrack stores
// (2 bytes a cell) are coalesced and far below the memory bandwidth.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 2048;
constexpr int kMaxCols = 2048;
constexpr int kMaxThreads = 1024;
constexpr int32_t kLowInit = -(1 << 30);        // reference.LOW_INIT
constexpr int32_t kMinCutoff = -100000000;      // reference.MATRIX_MIN_CUTOFF

struct Weights {
  int32_t match, mismatch, open, extend;
};

// matrix sw[0][jm] (and, by symmetry, sw[jm][0])
__device__ __forceinline__ int32_t ramp(int jm, bool indel, const Weights& w) {
  return (indel && jm > 0) ? w.open + (jm - 1) * w.extend : 0;
}

template <int RPT>
__global__ void __launch_bounds__(kMaxThreads)
    sw_fill_kernel(const uint8_t* __restrict__ ref,
                   const uint8_t* __restrict__ alt,
                   const int32_t* __restrict__ reflen,
                   const int32_t* __restrict__ altlen, int rows, int cols,
                   bool indel, Weights w, int16_t* __restrict__ btrack,
                   int32_t* __restrict__ lastrow,
                   int32_t* __restrict__ altcol) {
  extern __shared__ int32_t smem[];
  int32_t* s_sw = smem;                                   // [2][rows]
  int32_t* s_bgv = smem + 2 * rows;                       // [2][rows]
  int16_t* s_gsv = reinterpret_cast<int16_t*>(smem + 4 * rows);  // [2][rows]
  uint8_t* s_alt = reinterpret_cast<uint8_t*>(s_gsv + 2 * rows);  // [cols]

  const int b = blockIdx.x;
  const int T = blockDim.x;
  const int rl = min(reflen[b], rows);
  const int al = min(altlen[b], cols);
  if (rl <= 0 || al <= 0) return;

  for (int j = threadIdx.x; j < al; j += T)
    s_alt[j] = alt[(int64_t)b * cols + j];
  int32_t r_left[RPT], r_diag[RPT], r_bgh[RPT], r_gsh[RPT];
  uint8_t r_ref[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int i = threadIdx.x + k * T;
    r_ref[k] = i < rl ? ref[(int64_t)b * rows + i] : 0;
    r_left[k] = 0;
    r_diag[k] = 0;
    r_bgh[k] = kLowInit;
    r_gsh[k] = 0;
  }
  __syncthreads();

  const int n_diag = rows + cols - 1;
  int16_t* bt = btrack + (int64_t)b * n_diag * rows;
  const int last = rl + al - 1;
  for (int d = 0; d < last; ++d) {
    const int cur = (d & 1) * rows, prv = rows - cur;
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int i = threadIdx.x + k * T;
      const int j = d - i;
      if (i >= rl || j < 0 || j >= al) continue;
      // row i - 1 at diagonal d - 1: cell (i - 1, j), always filled
      int32_t up, bgv_in, gsv_in;
      if (i == 0) {
        up = ramp(j + 1, indel, w);
        bgv_in = kLowInit;
        gsv_in = 0;
      } else {
        up = s_sw[prv + i - 1];
        bgv_in = s_bgv[prv + i - 1];
        gsv_in = s_gsv[prv + i - 1];
      }
      // own row at diagonal d - 1: cell (i, j - 1), or column 0
      int32_t diag_src, left;
      if (j == 0) {
        diag_src = ramp(i, indel, w);     // matrix sw[i][0]
        left = ramp(i + 1, indel, w);     // matrix sw[i + 1][0]
      } else {
        diag_src = r_diag[k];
        left = r_left[k];
      }
      const int32_t step_diag =
          diag_src + (s_alt[j] == r_ref[k] ? w.match : w.mismatch);

      const int32_t gap_v = up + w.open, ext_v = bgv_in + w.extend;
      const bool take_v = gap_v > ext_v;  // strict: a tie keeps extending
      const int32_t bgv = take_v ? gap_v : ext_v;
      const int32_t gsv = take_v ? 1 : gsv_in + 1;

      const int32_t gap_h = left + w.open, ext_h = r_bgh[k] + w.extend;
      const bool take_h = gap_h > ext_h;
      const int32_t bgh = take_h ? gap_h : ext_h;
      const int32_t gsh = take_h ? 1 : r_gsh[k] + 1;
      r_bgh[k] = bgh;
      r_gsh[k] = gsh;

      // priority diag >= right >= down
      const bool use_diag = step_diag >= bgv && step_diag >= bgh;
      const bool use_right = !use_diag && bgh >= bgv;
      const int32_t val = use_diag ? step_diag : (use_right ? bgh : bgv);
      const int32_t sw = max(kMinCutoff, val);
      const int32_t code = use_diag ? 0 : (use_right ? -gsh : gsv);

      s_sw[cur + i] = sw;
      s_bgv[cur + i] = bgv;
      s_gsv[cur + i] = (int16_t)gsv;
      r_diag[k] = up;  // the diagonal input of cell (i, j + 1)
      r_left[k] = sw;
      bt[(int64_t)d * rows + i] = (int16_t)code;
      if (i == rl - 1) lastrow[(int64_t)b * cols + j] = sw;
      if (j == al - 1) altcol[(int64_t)b * rows + i] = sw;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  Lengths past the bucket are
// clamped to it; the wrapper rejects them before the launch.
int sw_fill(const uint8_t* ref, const uint8_t* alt, const int32_t* reflen,
            const int32_t* altlen, int rows, int cols, int batch,
            int indel_init, int w_match, int w_mismatch, int w_open,
            int w_extend, int16_t* btrack, int32_t* lastrow,
            int32_t* altcol, void* stream) {
  if (rows <= 0 || rows > kMaxRows || cols <= 0 || cols > kMaxCols)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const Weights w{w_match, w_mismatch, w_open, w_extend};
  const size_t shmem = (size_t)rows * (4 * sizeof(int32_t) + 2 * sizeof(int16_t)) + cols;
  cudaStream_t s = (cudaStream_t)stream;
  if (rows <= kMaxThreads) {
    const int threads = (rows + 31) / 32 * 32;
    sw_fill_kernel<1><<<batch, threads, shmem, s>>>(
        ref, alt, reflen, altlen, rows, cols, indel_init != 0, w, btrack,
        lastrow, altcol);
  } else {
    const int threads = ((rows + 1) / 2 + 31) / 32 * 32;
    sw_fill_kernel<2><<<batch, threads, shmem, s>>>(
        ref, alt, reflen, altlen, rows, cols, indel_init != 0, w, btrack,
        lastrow, altcol);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
