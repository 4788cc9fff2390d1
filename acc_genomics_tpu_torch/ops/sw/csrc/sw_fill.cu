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
//     sits at [b][i + j][i], so the lanes of one diagonal write
//     neighbouring addresses;
//   lastrow (B, C) int32: sw at interior (reflen - 1, j);
//   altcol (B, R) int32: sw at interior (i, altlen - 1).
// Only cells inside each pair's reflen x altlen region are written.
//
// Design: a warp takes one pair and runs the shuffle wavefront of the
// PairHMM forward kernel (pairhmm_forward.cu) over the integer recurrence:
//   * lane li owns rows 64 c + 2 li and 64 c + 2 li + 1 of chunk c (R = 2
//     rows a lane); the chunks run in turn, ceil(reflen / 64) of them, each
//     min(64, rows left) + altlen - 1 steps.  At step s row 2 li + r of
//     the chunk computes column j = s - 2 li - r, so all 64 cells of a
//     step lie on diagonal d = 64 c + s and the warp's btrack store is 128
//     contiguous bytes, one 4-byte store a lane (two 2-byte stores where
//     an odd bucket leaves them unaligned).  The SW buckets start at 64
//     rows (config.py SWConfig.seq_buckets), so one segment of 32 lanes is
//     the only size;
//   * row r of a lane reads the cell above from row r - 1's previous step
//     (a register, so the two rows of a step are independent) and row 0
//     from the lane above, by __shfl_up_sync of its row 1: sw, bgv and gsv
//     (packed with the column's alt code, which travels down the rows with
//     it, as the TPU kernel rolls its alt register a row each step).  The
//     diagonal input is the value received one step earlier; each row's
//     tracker (bgh, gsh) and sw(i, j - 1) stay in registers.  No step
//     waits on a barrier;
//   * lane 0 reads the row above from one shared buffer a warp: per
//     column (sw, bgv) and gsv | alt << 16 of the previous chunk's bottom
//     row, made with the matrix's row 0 (the ramps) and the alt codes
//     before chunk 0.  Lane 31's second row writes column j at step j + 63
//     and lane 0 of the next chunk reads it at its step j, so the buffer is
//     updated in place; a __syncwarp at the chunk change orders the two.
//     Lane 0 loads its column a step ahead, off the step's dependent chain;
//   * the steps where every cell is inside the pair and off column 0 and
//     the last column (64 .. altlen - 2 of a full chunk) run without the
//     edge tests; the gap and cell choices use the max with a predicate of
//     Hopper's DPX functions (`__vibmax_s32`);
//   * each pair runs its own trip count from (reflen, altlen); a block
//     holds four warps (pairs), and a warp past the batch leaves whole.
//
// Bound on this card: the integer pipes, which run at half the fp32 rate.
// On the SW bench batch (4,096 pairs a launch, 31 warps an SM) the time
// grows with the warps an SM from two a scheduler up, and stays the same
// with the btrack stores, the shuffles or the shared-buffer traffic taken
// out (tools/sw_fill_ablation.py): the compares, selects and adds of the
// cells set it.  Two rows a lane share a step's shuffles, buffer traffic
// and store, and halve the steps; the edge steps (the triangles at each
// chunk's start and end) cost more than interior ones.  Four rows a lane
// need 94 registers and no longer fit a launch in one wave.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kMaxRows = 2048;
constexpr int kMaxCols = 2048;
constexpr int kWarps = 4;  // pairs a block
constexpr int R = 2;       // rows a lane
constexpr int kChunk = 32 * R;  // rows a chunk
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kLowInit = -(1 << 30);        // reference.LOW_INIT
constexpr int32_t kMinCutoff = -100000000;      // reference.MATRIX_MIN_CUTOFF

struct Weights {
  int32_t match, mismatch, open, extend;
};

// matrix sw[0][jm] (and, by symmetry, sw[jm][0])
__device__ __forceinline__ int32_t ramp(int jm, bool indel, const Weights& w) {
  return (indel && jm > 0) ? w.open + (jm - 1) * w.extend : 0;
}

// dynamic shared memory a warp: (sw, bgv) and gsv | alt << 16 of the row
// above, for cols + kChunk columns (lane 0 loads a step ahead, past the
// pair's last column too)
__host__ __device__ constexpr int warp_bytes(int cols) {
  return (cols + kChunk) * (int)(sizeof(int2) + sizeof(uint32_t));
}

// kAligned: an even bucket of rows, so a lane's two codes of a step are one
// aligned 4-byte word
template <bool kAligned>
__global__ void __launch_bounds__(kWarps * 32)
    sw_fill_kernel(const uint8_t* __restrict__ ref,
                   const uint8_t* __restrict__ alt,
                   const int32_t* __restrict__ reflen,
                   const int32_t* __restrict__ altlen, int rows, int cols,
                   int batch, bool indel, Weights w,
                   int16_t* __restrict__ btrack, int32_t* __restrict__ lastrow,
                   int32_t* __restrict__ altcol) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int li = threadIdx.x & 31;
  const int warp = (int)(threadIdx.x >> 5);
  const int b = blockIdx.x * kWarps + warp;
  if (b >= batch) return;  // the whole warp
  const int rl = min(reflen[b], rows);
  const int al = min(altlen[b], cols);
  if (rl <= 0 || al <= 0) return;

  int2* const above = (int2*)(smem + (int64_t)warp * warp_bytes(cols));
  uint32_t* const above_ga = (uint32_t*)(above + cols + kChunk);
  // the matrix's row 0 above chunk 0, with the alt codes
  for (int j = li; j < al; j += 32) {
    above[j] = make_int2(ramp(j + 1, indel, w), kLowInit);
    above_ga[j] = (uint32_t)alt[(int64_t)b * cols + j] << 16;
  }
  __syncwarp();

  const int64_t n_diag = rows + cols - 1;
  int16_t* const bt = btrack + (int64_t)b * n_diag * rows;
  int32_t* const last_row = lastrow + (int64_t)b * cols;
  int32_t* const alt_col = altcol + (int64_t)b * rows;
  const uint8_t* const ref_b = ref + (int64_t)b * rows;
  const int n_chunks = (rl + kChunk - 1) / kChunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int i0 = c * kChunk + R * li;  // the lane's first row
    // per row r of the lane: its code, column-0 ramps, the cell at the
    // previous step (sw, bgv, gsv | alt << 16), the cell above received
    // at the previous step, and the row's gap tracker
    int ref_r[R], sw1[R], bgv1[R], pu[R], bgh[R], gsh[R];
    uint32_t ga1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ref_r[r] = i0 + r < rl ? ref_b[i0 + r] : 0;
      sw1[r] = 0;
      bgv1[r] = kLowInit;
      ga1[r] = 0;
      pu[r] = 0;
      bgh[r] = kLowInit;
      gsh[r] = 0;
    }
    const int last_r = rl - 1 - i0;  // the lane's row that is the pair's last
    const bool is_bottom = li == 31 && i0 + R - 1 < rl;  // writes the buffer
    int2 top = above[0];
    uint32_t top_ga = above_ga[0];
    int16_t* btp = bt + (int64_t)(c * kChunk) * rows + i0;

    // step s: row i0 + r at column s - R li - r, every cell of the warp on
    // diagonal c kChunk + s.  INTERIOR: every cell lies inside the pair
    // with its column in [1, altlen - 1), so no edge is tested
    auto step = [&](auto interior, int s) {
      constexpr bool INTERIOR = decltype(interior)::value;
      // row 0's inputs from the lane above (its last row at the previous
      // step), or for lane 0 from the buffer
      int32_t up0 = __shfl_up_sync(kFull, sw1[R - 1], 1);
      int32_t bgv0 = __shfl_up_sync(kFull, bgv1[R - 1], 1);
      uint32_t ga0 = __shfl_up_sync(kFull, ga1[R - 1], 1);
      if (li == 0) {
        up0 = top.x;
        bgv0 = top.y;
        ga0 = top_ga;
        top = above[s + 1];  // before the bottom lane's store of this step
        top_ga = above_ga[s + 1];
      }
      int32_t code[R], sw_out[R];
      // rows in descending order: row r reads row r - 1's previous step
#pragma unroll
      for (int r = R - 1; r >= 0; --r) {
        const int j = s - R * li - r;
        const int32_t up = r == 0 ? up0 : sw1[r - 1];
        const int32_t bgv_in = r == 0 ? bgv0 : bgv1[r - 1];
        const uint32_t ga = r == 0 ? ga0 : ga1[r - 1];
        int32_t diag_src = pu[r], left = sw1[r];
        pu[r] = up;
        if (!INTERIOR && j == 0) {  // column 0 of the matrix; the row's
          diag_src = ramp(i0 + r, indel, w);  // tracker starts
          left = ramp(i0 + r + 1, indel, w);
          bgh[r] = kLowInit;
          gsh[r] = 0;
        }
        const int alt_j = (int)(ga >> 16);
        const int32_t step_diag =
            diag_src + (alt_j == ref_r[r] ? w.match : w.mismatch);
        // Hopper's DPX max with a predicate: the gap trackers take the
        // open only when it is strictly greater (a tie keeps extending),
        // and the priority diag >= right >= down picks the cell
        bool ext_v, ext_h, right, diag;
        const int32_t bgv = __vibmax_s32(bgv_in + w.extend, up + w.open, &ext_v);
        const int32_t gsv = ext_v ? (int32_t)(ga & 0xffffu) + 1 : 1;
        bgh[r] = __vibmax_s32(bgh[r] + w.extend, left + w.open, &ext_h);
        gsh[r] = ext_h ? gsh[r] + 1 : 1;
        const int32_t sw = max(
            kMinCutoff, __vibmax_s32(step_diag, __vibmax_s32(bgh[r], bgv, &right), &diag));
        code[r] = diag ? 0 : (right ? -gsh[r] : gsv);
        sw_out[r] = sw;
        sw1[r] = sw;
        bgv1[r] = bgv;
        ga1[r] = ((uint32_t)alt_j << 16) | ((uint32_t)gsv & 0xffffu);
        if (!INTERIOR) {
          if (i0 + r < rl && j >= 0 && j < al) {
            btp[r] = (int16_t)code[r];
            if (j == al - 1) alt_col[i0 + r] = sw;
          }
        }
      }
      if (INTERIOR) {  // both rows' codes in one store where aligned
        if constexpr (kAligned && R == 2) {
          *(uint32_t*)btp = (uint16_t)code[0] | ((uint32_t)(uint16_t)code[R - 1] << 16);
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r) btp[r] = (int16_t)code[r];
        }
      }
      // the pair's last row and the bottom row of the chunk
      if (last_r >= 0 && last_r < R) {
        const int j = s - R * li - last_r;
        if (INTERIOR || (j >= 0 && j < al)) last_row[j] = sw_out[last_r];
      }
      if (is_bottom) {
        const int j = s - R * 31 - (R - 1);
        if (INTERIOR || (j >= 0 && j < al)) {
          above[j] = make_int2(sw1[R - 1], bgv1[R - 1]);
          above_ga[j] = ga1[R - 1];
        }
      }
      btp += rows;
    };

    // a full chunk runs its steps kChunk .. altlen - 2 without the edge
    // tests
    const int n_rows = min(kChunk, rl - c * kChunk);
    const int steps = n_rows + al - 1;
    const int in_hi = n_rows == kChunk ? al - 1 : 0;
    int s = 0;
    for (; s < min(kChunk, steps); ++s) step(std::false_type{}, s);
#pragma unroll 2
    for (; s < in_hi; ++s) step(std::true_type{}, s);
    for (; s < steps; ++s) step(std::false_type{}, s);
    __syncwarp();  // the bottom row is in before the next chunk reads it
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
  if (rows <= 0 || rows > kMaxRows || cols <= 0 || cols > kMaxCols || batch < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const Weights w{w_match, w_mismatch, w_open, w_extend};
  auto kernel = rows % 2 == 0 ? sw_fill_kernel<true> : sw_fill_kernel<false>;
  const int smem = kWarps * warp_bytes(cols);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(batch + kWarps - 1) / kWarps, kWarps * 32, smem, (cudaStream_t)stream>>>(
      ref, alt, reflen, altlen, rows, cols, batch, indel_init != 0, w, btrack, lastrow,
      altcol);
  return (int)cudaGetLastError();
}

}  // extern "C"
