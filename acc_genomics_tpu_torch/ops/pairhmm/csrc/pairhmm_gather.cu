// PairHMM byte-plane gather for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package packs the forward kernel's
// byte planes on the host (ops/pairhmm/pack.py, the native
// pairhmm_pack_quals of native/csrc/accnative.cpp), and so did the port's
// flat route: each (read, haplotype) pair's five read planes and its
// haplotype copied and transposed into a time-major (6*rows + cols, bp)
// region, so a read was copied once for every haplotype it meets.  This
// kernel builds the same regions, byte for byte, on the card, from the
// call's read and haplotype streams uploaded once each.
//
// Inputs (all on the card, ops/pairhmm/gather.py lays them out):
//   q, iq, dq, cq, rs, hap  the flat streams (uint8);
//   offs, hoffs             (lanes,) int64 start of each lane's read and
//                           haplotype in the streams, in launch order;
//   meta                    int32; bucket b's (2, bp) lens and hlens at
//                           2 * lane0(b): what the forward kernel reads;
//   table                   (n_buckets, 5) int64: byte offset of the
//                           bucket's region in `out`, rows, cols, bp and
//                           its first lane.
// Region of bucket b, rows: q, i, d, c, rs (rows each, byte r of the
// lane's read for r < len, else 0), then hap_ext (rows + cols, byte r of
// its haplotype for r < hlen, else hap_pad).
//
// Bound: bytes.  It reads each lane's bytes once (the streams, a few MB,
// stay in L2) and writes every region byte once; no arithmetic.  Design:
// a block per (tile of 64 lanes, bucket, plane), walking the plane's rows
// in chunks of 64.  A chunk is read lane by lane (a warp reads 32
// consecutive bytes of one lane's stream) into shared memory, then
// written row by row (a warp writes 32 consecutive lanes of one row), so
// both sides are coalesced; the shared row pitch of 68 bytes (17 words)
// puts the 32 rows a warp fills in distinct banks.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 64;            // lanes a block
constexpr int kRows = 64;             // rows a chunk
constexpr int kPitch = kLanes + 4;    // shared row pitch, bytes
constexpr int kThreads = 256;
constexpr int kPlanes = 6;            // q, i, d, c, rs, hap
constexpr int kTableCols = 5;         // region, rows, cols, bp, lane0

struct Streams {
  const uint8_t* src[kPlanes];
};

__global__ void __launch_bounds__(kThreads)
pairhmm_gather_kernel(Streams s, const int64_t* __restrict__ offs,
                      const int64_t* __restrict__ hoffs,
                      const int32_t* __restrict__ meta,
                      const int64_t* __restrict__ table, uint8_t hap_pad,
                      uint8_t* __restrict__ out) {
  __shared__ uint8_t tile[kRows * kPitch];
  __shared__ int64_t lane_off[kLanes];
  __shared__ int lane_len[kLanes];

  const int64_t* e = table + (int64_t)blockIdx.y * kTableCols;
  const int rows = (int)e[1], cols = (int)e[2], bp = (int)e[3];
  const int t0 = blockIdx.x * kLanes;
  if (t0 >= bp) return;  // the grid spans the widest bucket
  const int64_t lane0 = e[4];
  const int nl = min(kLanes, bp - t0);
  const int p = blockIdx.z;
  const bool is_hap = p == kPlanes - 1;
  const int nrow = is_hap ? rows + cols : rows;
  const uint8_t pad = is_hap ? hap_pad : 0;
  const uint8_t* __restrict__ src = s.src[p];

  __shared__ int longest_s;  // the tile's longest lane: past it, padding
  if (threadIdx.x == 0) longest_s = 0;
  __syncthreads();
  if (threadIdx.x < kLanes) {
    const int l = threadIdx.x;
    int len = 0;
    int64_t off = 0;
    if (l < nl) {
      len = min(meta[2 * lane0 + (is_hap ? bp : 0) + t0 + l], nrow);
      off = (is_hap ? hoffs : offs)[lane0 + t0 + l];
    }
    lane_len[l] = len;
    lane_off[l] = off;
    atomicMax(&longest_s, len);
  }
  __syncthreads();
  const int longest = longest_s;

  uint8_t* __restrict__ dst = out + e[0] + (int64_t)p * rows * bp + t0;
  for (int r0 = 0; r0 < nrow; r0 += kRows) {
    if (r0 < longest) {
      for (int k = threadIdx.x; k < kLanes * kRows; k += kThreads) {
        const int l = k / kRows, r = k % kRows;
        uint8_t v = pad;
        if (r0 + r < lane_len[l]) v = src[lane_off[l] + r0 + r];
        tile[r * kPitch + l] = v;
      }
      __syncthreads();
    }
    const int nr = min(kRows, nrow - r0);
    for (int k = threadIdx.x; k < kRows * kLanes; k += kThreads) {
      const int r = k / kLanes, l = k % kLanes;
      if (r < nr && l < nl)
        dst[(int64_t)(r0 + r) * bp + l] =
            r0 < longest ? tile[r * kPitch + l] : pad;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int pairhmm_gather(const uint8_t* q, const uint8_t* iq, const uint8_t* dq,
                   const uint8_t* cq, const uint8_t* rs, const uint8_t* hap,
                   const int64_t* offs, const int64_t* hoffs,
                   const int32_t* meta, const int64_t* table, int n_buckets,
                   int max_lanes, int hap_pad, uint8_t* out, void* stream) {
  if (n_buckets < 0 || n_buckets > 65535 || max_lanes < 0 || hap_pad < 0 ||
      hap_pad > 255)
    return (int)cudaErrorInvalidValue;
  if (n_buckets == 0 || max_lanes == 0) return 0;
  const Streams s{{q, iq, dq, cq, rs, hap}};
  const dim3 grid((max_lanes + kLanes - 1) / kLanes, n_buckets, kPlanes);
  pairhmm_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      s, offs, hoffs, meta, table, (uint8_t)hap_pad, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
