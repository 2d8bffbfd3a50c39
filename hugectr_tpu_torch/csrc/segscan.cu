// Segmented inclusive scan over rows sorted by segment.
//
// Replaces: hugectr_tpu/ops/pallas/segscan.py::segmented_sum_sorted (body
// _segscan_kernel), the streaming segmented sum of the sorted-row sparse
// update (embedding/sparse_optimizer.py dedup_rows, scan contract).
//
//   out[i, :] = sum of vals[s .. i, :], s = the last head at or before i
//
// so the TAIL row of each segment holds the segment's full sum. Sums are
// taken in float32 and stored in the type of vals (float32 or bfloat16).
//
// Bound on an H100: memory. The function reads vals and heads once and
// writes out once: (2 * K * E * itemsize + K) bytes at 3.35 TB/s (about
// 135 us for the flagship's K = 442,368 rows of E = 128 float32). Its
// K * E additions are nothing beside that.
//
// Design. The TPU kernel walks one sequential grid and carries a [1, E]
// sum from block to block; GPU blocks run in no order, so the scan takes
// three phases:
//   (a) chunk_scan: one block per (chunk of kChunk rows, 128 columns); each
//       thread owns one column, so every row is one coalesced access. It
//       walks its chunk in order, writes the running sum of every row at or
//       after the chunk's first head, and records the chunk's carry-out and
//       whether the chunk holds a head.
//   (b) carry_scan: per column, a segmented scan over the K / kChunk chunk
//       carries (32 column threads x 32 parts of the chunk list, a short
//       sequential scan over the parts) turns carry-outs into carry-ins.
//   (c) chunk_fixup: each chunk that does not start with a head re-reads the
//       rows before its first head and writes carry-in + running sum.
// vals are read once, plus the head-less prefix of each chunk a second
// time; out is written once. K needs no padding.
#include "common.cuh"

namespace hctr {
namespace {

constexpr int kCols = 128;      // threads (columns) per block in (a) and (c)
constexpr int kScanCols = 32;   // columns per block in (b)
constexpr int kScanParts = 32;  // parts of the chunk list per column in (b)

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

template <typename T>
__global__ void chunk_scan(const T* __restrict__ vals, const uint8_t* __restrict__ heads,
                           T* __restrict__ out, float* __restrict__ carry,
                           uint8_t* __restrict__ has_head, int64_t k, int e, int chunk) {
  const int64_t c = blockIdx.x;
  const int j = blockIdx.y * kCols + threadIdx.x;
  const int64_t r0 = c * chunk;
  const int64_t r1 = min64(r0 + chunk, k);
  float acc = 0.f;
  bool seen = false;
#pragma unroll 8
  for (int64_t r = r0; r < r1; ++r) {
    if (heads[r]) {
      acc = 0.f;
      seen = true;
    }
    if (j < e) {
      acc += to_f32(vals[r * e + j]);
      if (seen) out[r * e + j] = from_f32<T>(acc);
    }
  }
  if (j < e) carry[c * e + j] = acc;
  if (blockIdx.y == 0 && threadIdx.x == 0) has_head[c] = seen ? 1 : 0;
}

__global__ void carry_scan(const float* __restrict__ carry, const uint8_t* __restrict__ has_head,
                           float* __restrict__ carry_in, int64_t nc, int e) {
  __shared__ float part_sum[kScanParts][kScanCols];
  __shared__ int part_head[kScanParts][kScanCols];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int j = blockIdx.x * kScanCols + tx;
  const int64_t per = (nc + kScanParts - 1) / kScanParts;
  const int64_t c0 = min64(ty * per, nc);
  const int64_t c1 = min64(c0 + per, nc);
  float v = 0.f;
  int f = 0;
  if (j < e) {
    for (int64_t c = c0; c < c1; ++c) {
      const float x = carry[c * e + j];
      if (has_head[c]) {
        v = x;
        f = 1;
      } else {
        v += x;
      }
    }
  }
  part_sum[ty][tx] = v;
  part_head[ty][tx] = f;
  __syncthreads();
  if (ty == 0) {
    float run = 0.f;
    for (int p = 0; p < kScanParts; ++p) {
      const float pv = part_sum[p][tx];
      const int pf = part_head[p][tx];
      part_sum[p][tx] = run;  // exclusive: the sum carried into part p
      run = pf ? pv : run + pv;
    }
  }
  __syncthreads();
  if (j < e) {
    float run = part_sum[ty][tx];
    for (int64_t c = c0; c < c1; ++c) {
      carry_in[c * e + j] = run;
      const float x = carry[c * e + j];
      run = has_head[c] ? x : run + x;
    }
  }
}

template <typename T>
__global__ void chunk_fixup(const T* __restrict__ vals, const uint8_t* __restrict__ heads,
                            T* __restrict__ out, const float* __restrict__ carry_in, int64_t k,
                            int e, int chunk) {
  const int64_t c = blockIdx.x;
  const int j = blockIdx.y * kCols + threadIdx.x;
  const int64_t r0 = c * chunk;
  if (heads[r0] || j >= e) return;  // the chunk starts a segment: (a) wrote it all
  const int64_t r1 = min64(r0 + chunk, k);
  float acc = carry_in[c * e + j];
  for (int64_t r = r0; r < r1 && !heads[r]; ++r) {
    acc += to_f32(vals[r * e + j]);
    out[r * e + j] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* vals, const void* heads, void* out, void* carry, void* carry_in,
           void* has_head, int64_t k, int e, int chunk, cudaStream_t stream) {
  const int64_t nc = (k + chunk - 1) / chunk;
  const dim3 grid_rows(static_cast<unsigned>(nc), (e + kCols - 1) / kCols);
  chunk_scan<T><<<grid_rows, kCols, 0, stream>>>(
      static_cast<const T*>(vals), static_cast<const uint8_t*>(heads), static_cast<T*>(out),
      static_cast<float*>(carry), static_cast<uint8_t*>(has_head), k, e, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  carry_scan<<<(e + kScanCols - 1) / kScanCols, dim3(kScanCols, kScanParts), 0, stream>>>(
      static_cast<const float*>(carry), static_cast<const uint8_t*>(has_head),
      static_cast<float*>(carry_in), nc, e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chunk_fixup<T><<<grid_rows, kCols, 0, stream>>>(
      static_cast<const T*>(vals), static_cast<const uint8_t*>(heads), static_cast<T*>(out),
      static_cast<const float*>(carry_in), k, e, chunk);
  return cudaGetLastError();
}

}  // namespace
}  // namespace hctr

// vals [k, e] and out [k, e] of `dtype`; heads [k] uint8 (0/1); carry and
// carry_in [ceil(k / chunk), e] float32 and has_head [ceil(k / chunk)]
// uint8 are scratch. Returns cudaGetLastError().
extern "C" int hctr_segscan(int dtype, const void* vals, const void* heads, void* out,
                            void* carry, void* carry_in, void* has_head, int64_t k, int e,
                            int chunk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == hctr::kF32)
    return hctr::launch<float>(vals, heads, out, carry, carry_in, has_head, k, e, chunk, s);
  if (dtype == hctr::kBF16)
    return hctr::launch<__nv_bfloat16>(vals, heads, out, carry, carry_in, has_head, k, e, chunk,
                                       s);
  return cudaErrorInvalidValue;
}
