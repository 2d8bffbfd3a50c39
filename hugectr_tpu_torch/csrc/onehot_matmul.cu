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
// grad (V * E * itemsize) and cnt (V * 4 bytes): about 3.4 us for table 24
// of the flagship (B 16,384, h 40, V 108, float32). Power-law keys put
// ~10^5 adds on each column of the head rows of such a table, so a scatter
// straight into device memory (one float32 atomicAdd per key and column)
// serialises in L2: 3.29 ms at table 24 on an H100 in the first port, 4x
// `index_add_`. The launcher takes one of two routes by shape:
//   * Privatised, when the table fits one block's dynamic shared memory
//     (float32 [V, E] plus an int [V] count; 450 rows at E = 128 on an
//     H100, ~227 KB) and the batch brings at least kHotKeysPerRow keys per
//     row. Each block zeroes its private copy and walks a slice of the
//     samples, kBatch keys at a time per warp: keys add an exact integer
//     count (one shared atomic per distinct row of 32 keys, __match_any),
//     and the warp loads the d rows of kBatch keys at once, then adds them
//     into the table rows with shared float32 atomics, lane-strided columns
//     so no two lanes share a bank. A hot row meets at most the block's 16
//     warps, at shared-memory latency. Then the block adds only its touched
//     rows (count > 0) into the float32 outputs, so each global address
//     takes one add per slice. Slices: one block per SM at least; past that
//     at most one wave of resident blocks and at least kFlushRatio keys per
//     row and slice, in whole waves.
//   * Global atomics, for larger tables and for keys spread thin: each warp
//     takes kBatch keys, loads their d rows at once and adds them straight
//     into grad, lane-strided, so each atomic instruction covers 128
//     consecutive bytes (the first port's float4 lanes covered 512 bytes
//     per instruction, 4x the L2 sectors per key). Counts as above.
// Tables larger than a block's shared memory are not cut into privatised
// tiles: a power-law batch puts nearly all its keys into the first tile,
// whose blocks then do nearly all the work (7.9 ms at V 8,192, h 128 on an
// H100, chip_smoke.py's V8192_h128 case, when such tiles were tried).
// The launcher zeroes grad and cnt with cudaMemsetAsync unless the caller
// accumulates into its own buffers, and a last pass casts the float32 sums
// to bfloat16 when the output is bfloat16. Counts are exact (integers
// below 2^24 per row). Atomic order varies from run to run, so grad agrees
// with a fixed-order sum only to a float32 rounding tolerance.
#include "common.cuh"

namespace hctr {
namespace {

constexpr int kWarps = 8;         // samples per block of the forward, one warp each
constexpr int kBwdWarps = 16;       // warps per block of the privatised backward
constexpr int kGlobalWarps = 8;     // warps per block of the global-atomic backward
constexpr int kBwdCols = 4;         // columns per lane per pass of the backward
constexpr int kBatch = 8;           // keys whose d rows a warp loads at once in the backward
constexpr int kFlushRatio = 16;     // keys per table row of a slice, past one block per SM
constexpr int kHotKeysPerRow = 256; // privatise when B * h >= this * V
constexpr unsigned kFull = 0xffffffffu;

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

// Adds the d rows of the warp's keys marked in `m` (a warp-uniform ballot)
// into rows `row` of dst [*, e], where lane j holds key j's destination row
// and sample. Lane-strided columns: every atomic instruction of the warp
// covers 128 consecutive bytes, and no two lanes share a shared-memory
// bank. The d rows of kBatch keys are loaded before their adds.
template <typename T>
__device__ __forceinline__ void add_rows(unsigned m, int row, long long sample,
                                         const T* __restrict__ d, float* dst, int e, int lane) {
  while (m) {
    int r[kBatch];
    long long s[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const bool ok = m != 0;
      const int j = ok ? __ffs(m) - 1 : 0;
      r[q] = __shfl_sync(kFull, row, j);
      s[q] = __shfl_sync(kFull, sample, j);
      if (!ok) r[q] = -1;
      m &= m - 1;
    }
    for (int c0 = 0; c0 < e; c0 += 32 * kBwdCols) {
      float x[kBatch][kBwdCols];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
#pragma unroll
        for (int i = 0; i < kBwdCols; ++i) {
          const int c = c0 + lane + 32 * i;
          x[q][i] = r[q] >= 0 && c < e ? to_f32(__ldg(d + s[q] * e + c)) : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (r[q] < 0) continue;
        float* drow = dst + static_cast<int64_t>(r[q]) * e;
#pragma unroll
        for (int i = 0; i < kBwdCols; ++i) {
          const int c = c0 + lane + 32 * i;
          if (c < e) atomicAdd(drow + c, x[q][i]);
        }
      }
    }
  }
}

// Privatised backward: the whole table in shared memory; block `slice`
// takes samples [slice * slice_samples, +slice_samples).
template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32)
onehot_bwd(const int32_t* __restrict__ keys, const T* __restrict__ d, float* __restrict__ grad,
           float* __restrict__ cnt, int b, int h, int v, int e, int slice_samples) {
  extern __shared__ float part[];  // [v][e] float32 sums, then [v] int counts
  int* scnt = reinterpret_cast<int*>(part + v * e);
  for (int i = threadIdx.x; i < v * e; i += blockDim.x) part[i] = 0.f;
  for (int i = threadIdx.x; i < v; i += blockDim.x) scnt[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * slice_samples;
  const int64_t s1 = s0 + slice_samples < b ? s0 + slice_samples : b;
  const int64_t f1 = s1 * h;
  for (int64_t g = s0 * h + warp * 32; g < f1; g += kBwdWarps * 32) {
    const int64_t f = g + lane;
    int key = -1;
    if (f < f1) {
      key = __ldg(keys + f);
      if (key < 0 || key >= v) key = -1;
    }
    // one count add per distinct row of the 32 keys
    const unsigned peers = __match_any_sync(kFull, key);
    if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(scnt + key, __popc(peers));
    add_rows<T>(__ballot_sync(kFull, key >= 0), key, f / h, d, part, e, lane);
  }
  __syncthreads();

  for (int r = warp; r < v; r += kBwdWarps) {
    const int n = scnt[r];
    if (n == 0) continue;
    float* grow = grad + static_cast<int64_t>(r) * e;
    for (int c = lane; c < e; c += 32) atomicAdd(grow + c, part[r * e + c]);
    if (lane == 0) atomicAdd(cnt + r, static_cast<float>(n));
  }
}

// Global-atomic backward for tables whose keys spread over many rows: each
// warp takes kBatch keys at a time (lanes 0..kBatch-1 load them, so a batch
// has many warps in flight) and adds their d rows straight into grad.
template <typename T>
__global__ void __launch_bounds__(kGlobalWarps * 32)
onehot_bwd_global(const int32_t* __restrict__ keys, const T* __restrict__ d,
                  float* __restrict__ grad, float* __restrict__ cnt, int b, int h, int v, int e) {
  const int lane = threadIdx.x & 31;
  const int64_t n = static_cast<int64_t>(b) * h;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kGlobalWarps * kBatch;
  for (int64_t g = (static_cast<int64_t>(blockIdx.x) * kGlobalWarps + (threadIdx.x >> 5)) * kBatch;
       g < n; g += stride) {
    const int64_t f = g + lane;
    int key = -1;
    if (lane < kBatch && f < n) {
      key = __ldg(keys + f);
      if (key < 0 || key >= v) key = -1;
    }
    const unsigned peers = __match_any_sync(kFull, key);
    if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(cnt + key, static_cast<float>(__popc(peers)));
    add_rows<T>(__ballot_sync(kFull, key >= 0), key, f / h, d, grad, e, lane);
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

// Most table rows one backward block can hold in shared memory at width e.
int bwd_tile_rows(int e) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin / (e * 4 + 4);
}

// The backward's route for a shape: privatised when the table fits one
// block's shared memory and its keys are many per row, so that a scatter
// straight into device memory would serialise on the rows; else global
// atomics.
inline bool bwd_privatised(int b, int h, int v, int e) {
  return v <= bwd_tile_rows(e) &&
         static_cast<int64_t>(b) * h >= static_cast<int64_t>(kHotKeysPerRow) * v;
}

template <typename T>
int bwd_global(const int32_t* keys, const T* d, float* grad, float* cnt, int b, int h, int v,
               int e, cudaStream_t s) {
  const int64_t groups = (static_cast<int64_t>(b) * h + kBatch - 1) / kBatch;
  const int64_t want = (groups + kGlobalWarps - 1) / kGlobalWarps;
  const unsigned blocks = static_cast<unsigned>(want < 65535 ? want : 65535);
  onehot_bwd_global<T><<<blocks, kGlobalWarps * 32, 0, s>>>(keys, d, grad, cnt, b, h, v, e);
  return cudaGetLastError();
}

template <typename T>
int bwd(const void* keys_, const void* d_, void* grad32, void* cnt_, int b, int h, int v, int e,
        cudaStream_t s) {
  const auto* keys = static_cast<const int32_t*>(keys_);
  const auto* d = static_cast<const T*>(d_);
  auto* grad = static_cast<float*>(grad32);
  auto* cnt = static_cast<float*>(cnt_);
  if (!bwd_privatised(b, h, v, e)) return bwd_global<T>(keys, d, grad, cnt, b, h, v, e, s);
  const size_t smem = static_cast<size_t>(v) * (e * 4 + 4);
  const int threads = kBwdWarps * 32;
  cudaError_t err = cudaFuncSetAttribute(onehot_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, onehot_bwd<T>, threads, smem);
  if (err != cudaSuccess) return err;
  // fill the card once, with a block on every SM at least, but past that
  // keep >= kFlushRatio keys per table row in a slice, in whole waves
  const int64_t wave = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  const int64_t cap = static_cast<int64_t>(b) * h / (static_cast<int64_t>(kFlushRatio) * v);
  int64_t slices = wave < cap ? wave : cap;
  slices = slices < sms ? sms : slices / sms * sms;
  if (slices > b) slices = b;
  if (slices < 1) slices = 1;
  const int slice_samples = static_cast<int>((b + slices - 1) / slices);
  slices = (b + slice_samples - 1) / slice_samples;
  onehot_bwd<T><<<static_cast<unsigned>(slices), threads, smem, s>>>(keys, d, grad, cnt, b, h, v,
                                                                      e, slice_samples);
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

// Most table rows the privatised backward takes at width e on the current device.
extern "C" int hctr_onehot_bwd_tile_rows(int e) { return hctr::bwd_tile_rows(e); }

// The backward's route for [b, h] keys into [v, e]: 1 privatised, 0 global.
extern "C" int hctr_onehot_bwd_privatised(int b, int h, int v, int e) {
  return hctr::bwd_privatised(b, h, v, e) ? 1 : 0;
}

// keys [b, h] int32; d [b, e] of `d_dtype`; grad32 [v, e] and cnt [v]
// float32 receive the sums: added to what they hold when `accumulate` is 1,
// else zeroed first. out_bf16 [v, e] bfloat16 receives the cast of grad32
// when it is not null.
extern "C" int hctr_onehot_bwd(int d_dtype, const void* keys, const void* d, void* grad32,
                               void* cnt, void* out_bf16, int b, int h, int v, int e,
                               int accumulate, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_dtype != hctr::kF32 && d_dtype != hctr::kBF16) return cudaErrorInvalidValue;
  const int64_t n = static_cast<int64_t>(v) * e;
  int err = cudaSuccess;
  if (!accumulate && v > 0) {
    err = cudaMemsetAsync(grad32, 0, n * sizeof(float), s);
    if (err == cudaSuccess) err = cudaMemsetAsync(cnt, 0, v * sizeof(float), s);
    if (err != cudaSuccess) return err;
  }
  if (b > 0 && h > 0 && v > 0 && e > 0) {
    if (d_dtype == hctr::kF32)
      err = hctr::bwd<float>(keys, d, grad32, cnt, b, h, v, e, s);
    else
      err = hctr::bwd<__nv_bfloat16>(keys, d, grad32, cnt, b, h, v, e, s);
  }
  if (err != cudaSuccess || out_bf16 == nullptr || n == 0) return err;
  const int64_t want = (n + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(want < 65535 ? want : 65535);
  hctr::cast_to_bf16<<<blocks, 256, 0, s>>>(static_cast<const float*>(grad32),
                                            static_cast<__nv_bfloat16*>(out_bf16), n);
  return cudaGetLastError();
}
