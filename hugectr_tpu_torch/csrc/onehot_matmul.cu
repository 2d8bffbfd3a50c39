// Pooled lookup and its weight gradient for the small-table (one-hot) engine.
//
// Replaces: hugectr_tpu/ops/pallas/onehot_matmul.py::onehot_matmul_fwd
// (body _fwd_kernel, tile _onehot_tile) and ::onehot_matmul_bwd (body
// _bwd_kernel). Keys are table-local rows; a key outside [0, V) is padding.
//
//   forward:   out[b, :] = sum_h [0 <= keys[b,h] < V] * table[keys[b,h], :]
//   backward:  grad[v, :] = sum_{b,h} [keys[b,h] == v] * d[b, :]
//              cnt[v]     = sum_{b,h} [keys[b,h] == v]
//
// The TPU kernels build a [B, V] one-hot tile for the matrix unit, which
// costs 2 * B * V * E operations (31 GFLOP for a 7,424-row table at
// B = 16,384, E = 128). On an H100 both directions are row moves instead.
//
// Forward (gather-pool). Bound: memory, the keys (B * h * 4 bytes) and the
// output (B * E * itemsize) plus one read of the table (V * E * itemsize;
// tables of the engine are at most 8,192 rows, 4 MB in float32, and stay in
// the 50 MB L2) at 3.35 TB/s. One warp per sample: each lane owns four
// consecutive columns (one 16-byte float4 at E = 128), walks the sample's
// h keys, skips padding and accumulates in float32, so every table row is
// one coalesced 512-byte read and every output row one coalesced write.
//
// Backward (scatter-add). Bound: memory, the keys, d (B * E * itemsize),
// grad (V * E * itemsize) and cnt (V * 4 bytes). A float32 [V, E] scratch
// and [V] count, zeroed by the wrapper, take one float32 atomicAdd per
// (key, column) from a warp per sample; a last pass casts the scratch to
// bfloat16 when the output is bfloat16 (no copy for float32). Power-law keys
// put thousands of atomics on the few rows of the tiny tables, which
// serializes them in L2: right, and slow there; a privatised or sorted
// design is later work. Atomic order varies from run to run, so results
// agree with a fixed-order sum only to a float32 rounding tolerance.
#include "common.cuh"

namespace hctr {
namespace {

constexpr int kWarps = 8;  // samples per block, one warp each

template <typename T, int kVec>
__global__ void onehot_fwd(const int32_t* __restrict__ keys, const T* __restrict__ table,
                           T* __restrict__ out, int b, int h, int v, int e) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= b) return;
  const int32_t* krow = keys + row * h;
  for (int e0 = lane * kVec; e0 < e; e0 += 32 * kVec) {
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
    for (int t = 0; t < h; ++t) {
      const int key = __ldg(krow + t);
      if (key < 0 || key >= v) continue;
      float x[kVec];
      load_vec<kVec>(table + static_cast<int64_t>(key) * e + e0, x);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] += x[i];
    }
    store_vec<kVec>(out + row * e + e0, acc);
  }
}

template <typename T, int kVec>
__global__ void onehot_bwd(const int32_t* __restrict__ keys, const T* __restrict__ d,
                           float* __restrict__ grad, float* __restrict__ cnt, int b, int h, int v,
                           int e) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= b) return;
  const int32_t* krow = keys + row * h;
  for (int e0 = lane * kVec; e0 < e; e0 += 32 * kVec) {
    float x[kVec];
    load_vec<kVec>(d + row * e + e0, x);
    for (int t = 0; t < h; ++t) {
      const int key = __ldg(krow + t);
      if (key < 0 || key >= v) continue;
      float* g = grad + static_cast<int64_t>(key) * e + e0;
#pragma unroll
      for (int i = 0; i < kVec; ++i) atomicAdd(g + i, x[i]);
    }
  }
  if (lane == 0) {
    for (int t = 0; t < h; ++t) {
      const int key = __ldg(krow + t);
      if (key >= 0 && key < v) atomicAdd(cnt + key, 1.f);
    }
  }
}

__global__ void cast_to_bf16(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                             int64_t n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    dst[i] = __float2bfloat16(src[i]);
  }
}

inline unsigned sample_blocks(int b) { return static_cast<unsigned>((b + kWarps - 1) / kWarps); }

template <typename T>
int fwd(const void* keys, const void* table, void* out, int b, int h, int v, int e, int vec,
        cudaStream_t s) {
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* t = static_cast<const T*>(table);
  auto* o = static_cast<T*>(out);
  if (vec == 4)
    onehot_fwd<T, 4><<<sample_blocks(b), kWarps * 32, 0, s>>>(k, t, o, b, h, v, e);
  else
    onehot_fwd<T, 1><<<sample_blocks(b), kWarps * 32, 0, s>>>(k, t, o, b, h, v, e);
  return cudaGetLastError();
}

template <typename T>
int bwd(const void* keys, const void* d, void* grad32, void* cnt, int b, int h, int v, int e,
        int vec, cudaStream_t s) {
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* dd = static_cast<const T*>(d);
  auto* g = static_cast<float*>(grad32);
  auto* c = static_cast<float*>(cnt);
  if (vec == 4)
    onehot_bwd<T, 4><<<sample_blocks(b), kWarps * 32, 0, s>>>(k, dd, g, c, b, h, v, e);
  else
    onehot_bwd<T, 1><<<sample_blocks(b), kWarps * 32, 0, s>>>(k, dd, g, c, b, h, v, e);
  return cudaGetLastError();
}

}  // namespace
}  // namespace hctr

// keys [b, h] int32; table [v, e] and out [b, e] of `dtype`. `vec` is 4 when
// e % 4 == 0 and both pointers are aligned to 4 elements, else 1.
extern "C" int hctr_onehot_fwd(int dtype, const void* keys, const void* table, void* out, int b,
                               int h, int v, int e, int vec, void* stream) {
  if (b == 0 || e == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == hctr::kF32) return hctr::fwd<float>(keys, table, out, b, h, v, e, vec, s);
  if (dtype == hctr::kBF16) return hctr::fwd<__nv_bfloat16>(keys, table, out, b, h, v, e, vec, s);
  return cudaErrorInvalidValue;
}

// keys [b, h] int32; d [b, e] of `d_dtype`; grad32 [v, e] and cnt [v] float32,
// zeroed by the caller; out_bf16 [v, e] bfloat16 receives the cast of grad32
// when it is not null. `vec` as for hctr_onehot_fwd (d only).
extern "C" int hctr_onehot_bwd(int d_dtype, const void* keys, const void* d, void* grad32,
                               void* cnt, void* out_bf16, int b, int h, int v, int e, int vec,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = cudaSuccess;
  if (b > 0 && e > 0) {
    if (d_dtype == hctr::kF32)
      err = hctr::bwd<float>(keys, d, grad32, cnt, b, h, v, e, vec, s);
    else if (d_dtype == hctr::kBF16)
      err = hctr::bwd<__nv_bfloat16>(keys, d, grad32, cnt, b, h, v, e, vec, s);
    else
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || out_bf16 == nullptr) return err;
  const int64_t n = static_cast<int64_t>(v) * e;
  if (n == 0) return cudaSuccess;
  const int64_t want = (n + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(want < 65535 ? want : 65535);
  hctr::cast_to_bf16<<<blocks, 256, 0, s>>>(static_cast<const float*>(grad32),
                                            static_cast<__nv_bfloat16*>(out_bf16), n);
  return cudaGetLastError();
}
