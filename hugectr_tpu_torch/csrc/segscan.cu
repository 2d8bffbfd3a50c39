// Segmented inclusive scan over rows sorted by segment.
//
// Replaces: hugectr_tpu/ops/pallas/segscan.py::segmented_sum_sorted (body
// _segscan_kernel), the streaming segmented sum of the sorted-row sparse
// update (embedding/sparse_optimizer.py dedup_rows, scan contract).
//
//   out[i, :] = sum of vals[s .. i, :], s = the last head at or before i
//
// so the TAIL row of each segment holds the segment's full sum. Row 0 always
// starts a segment. Sums are taken in float32 and stored as float32 or
// bfloat16, whichever the caller asks (the sorted update of bfloat16 tables
// reads bfloat16 rows and keeps float32 sums, as the JAX package's
// segment_sum route does). K needs no padding.
//
// Bound on an H100: memory. The function reads vals and heads once and
// writes out once: (K * E * (in + out itemsize) + K) bytes at 3.35 TB/s (about
// 135 us for the flagship's K = 442,368 rows of E = 128 float32). Its
// K * E additions are nothing beside that.
//
// Design: one pass with decoupled look-back (Merrill & Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", 2016), with the segmented
// operator. The TPU kernel walks one sequential grid and carries a [1, E]
// sum from block to block; GPU blocks run in no order, so each block
// publishes what it knows and reads what its predecessors published:
//   * A block takes the next tile of kTileRows rows from a counter (tiles
//     are handed out in order, so every tile a block waits for is held by a
//     block that is running or done). Each of its 8 warps loads 16 rows
//     with 16-byte lanes (one warp covers 128 float32 columns per access,
//     all 16 rows in flight at once), scans them in float32 registers and
//     keeps the result in shared memory until the write. (Of 4, 8 or 16
//     warps and 4 to 24 rows per warp, 8 x 16 took the least device time
//     for the flagship's six sorted-route scans on an H100.)
//   * It folds the warps' sums into the tile aggregate A (the sum since the
//     tile's last head) and publishes it: as the tile's inclusive prefix I
//     at once when the tile holds a head, else as an aggregate. The [E]
//     vector goes to L2 (st.cg), then __threadfence, then the status flag
//     with st.release.gpu; readers take the flag with ld.acquire.gpu and the
//     vector with ld.cg.
//   * If its first row is no head, warp 0 looks back over the predecessors'
//     flags, 32 at a time, to the nearest one with an inclusive prefix. The
//     carry C is that I plus the aggregates after it, added in order from
//     the oldest: C[t] = I[t-1] whichever predecessor the look-back stopped
//     at, since every I[p] is C[p] + A[p] (or A[p] for a tile with a head).
//     So the result is bitwise the same from run to run.
//   * A head-less tile publishes I = C + A; then each warp adds its carry-in
//     (C folded with the earlier warps' sums) to its rows before its first
//     head and writes the tile once.
// The status flags and the tile counter are zeroed by segscan_init, one
// small launch before the scan. Scratch: (K / kTileRows) x (4 + 8 E) bytes.
#include "common.cuh"

namespace hctr {
namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 16;
constexpr int kTileRows = kWarps * kRowsPerWarp;
constexpr int kThreads = kWarps * 32;
constexpr int kAggregate = 1;  // status flags; 0 = not yet published
constexpr int kInclusive = 2;
constexpr int kFoldBatch = 16;  // aggregates loaded at once by the look-back's fold
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

struct Scratch {
  int* counter;  // [1] next tile
  int* flags;    // [tiles] status
  float* agg;    // [tiles, e] aggregates of head-less tiles
  float* inc;    // [tiles, e] inclusive prefixes
};

inline int64_t align16(int64_t n) { return (n + 15) / 16 * 16; }

inline int64_t scratch_bytes(int64_t tiles, int e) {
  return align16(4 * (1 + tiles)) + 2 * tiles * e * 4;
}

inline Scratch carve(void* base, int64_t tiles, int e) {
  auto* p = static_cast<char*>(base);
  auto* ints = reinterpret_cast<int*>(p);
  auto* agg = reinterpret_cast<float*>(p + align16(4 * (1 + tiles)));
  return Scratch{ints, ints + 1, agg, agg + tiles * e};
}

inline size_t smem_bytes(int e) {
  // tile [kTileRows, e], warp sums [kWarps, e], tile aggregate [e], carry [e]
  return static_cast<size_t>(kTileRows + kWarps + 2) * e * sizeof(float);
}

__global__ void segscan_init(int* counter_and_flags, int64_t n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    counter_and_flags[i] = 0;
}

template <typename T, typename TO, int kVec>
__global__ void __launch_bounds__(kThreads)
segscan_lookback(const T* __restrict__ vals, const uint8_t* __restrict__ heads,
                 TO* __restrict__ out, Scratch sc, int64_t k, int e) {
  extern __shared__ float sm[];
  float* tile = sm;                         // [kTileRows, e] scanned rows
  float* wsum = tile + kTileRows * e;       // [kWarps, e] sums, then carry-ins
  float* atile = wsum + kWarps * e;         // [e] tile aggregate
  float* carry = atile + e;                 // [e] carry into the tile
  __shared__ int s_tile, s_src;
  __shared__ int s_first[kWarps];  // first head among each warp's rows, kRowsPerWarp if none

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(sc.counter, 1);
  __syncthreads();
  const int t = s_tile;
  const int64_t r0 = static_cast<int64_t>(t) * kTileRows + warp * kRowsPerWarp;

  // 1. each warp scans its rows
  bool hd[kRowsPerWarp];
  int first = kRowsPerWarp;
#pragma unroll
  for (int i = kRowsPerWarp - 1; i >= 0; --i) {
    const int64_t r = r0 + i;
    hd[i] = r < k && (r == 0 || heads[r] != 0);
    if (hd[i]) first = i;
  }
  if (lane == 0) s_first[warp] = first;
  for (int c0 = lane * kVec; c0 < e; c0 += 32 * kVec) {
    float x[kRowsPerWarp][kVec];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (r0 + i < k) {
        load_vec<kVec>(vals + (r0 + i) * e + c0, x[i]);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) x[i][j] = 0.f;
      }
    }
    float acc[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = hd[i] ? x[i][j] : acc[j] + x[i][j];
      store_vec<kVec>(tile + (warp * kRowsPerWarp + i) * e + c0, acc);
    }
    store_vec<kVec>(wsum + warp * e + c0, acc);
  }
  __syncthreads();

  // 2. the tile aggregate, published at once
  bool tile_head = false;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tile_head |= s_first[w] < kRowsPerWarp;
  const bool starts_head = s_first[0] == 0;
  for (int c = threadIdx.x; c < e; c += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float s = wsum[w * e + c];
      a = s_first[w] < kRowsPerWarp ? s : a + s;
    }
    atile[c] = a;
    __stcg((tile_head ? sc.inc : sc.agg) + static_cast<int64_t>(t) * e + c, a);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) store_release(sc.flags + t, tile_head ? kInclusive : kAggregate);

  // 3. look back for the carry into rows before the tile's first head
  if (!starts_head) {
    if (warp == 0) {
      int base = t - 1;
      int src = 0;
      for (;;) {
        const int p = base - lane;
        int f = kInclusive;
        if (p >= 0) {
          do {
            f = load_acquire(sc.flags + p);
          } while (f == 0);
        }
        const unsigned m = __ballot_sync(kFull, f == kInclusive);
        if (m) {
          src = base - (__ffs(m) - 1);
          break;
        }
        base -= 32;
      }
      if (lane == 0) s_src = src;
    }
    __syncthreads();
    const int src = s_src;
    for (int c = threadIdx.x; c < e; c += kThreads) {
      float cv = __ldcg(sc.inc + static_cast<int64_t>(src) * e + c);
      // in order from the oldest; loads in batches so a long chain (a
      // segment over many tiles) costs few L2 round trips
      int p = src + 1;
      for (; p + kFoldBatch <= t; p += kFoldBatch) {
        float a[kFoldBatch];
#pragma unroll
        for (int q = 0; q < kFoldBatch; ++q)
          a[q] = __ldcg(sc.agg + static_cast<int64_t>(p + q) * e + c);
#pragma unroll
        for (int q = 0; q < kFoldBatch; ++q) cv += a[q];
      }
      for (; p < t; ++p) cv += __ldcg(sc.agg + static_cast<int64_t>(p) * e + c);
      carry[c] = cv;
      if (!tile_head) __stcg(sc.inc + static_cast<int64_t>(t) * e + c, cv + atile[c]);
    }
    if (!tile_head) {
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) store_release(sc.flags + t, kInclusive);
    }
  }
  __syncthreads();

  // 4. carry into each warp: the tile's carry folded with the earlier warps
  for (int c = threadIdx.x; c < e; c += kThreads) {
    float run = starts_head ? 0.f : carry[c];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float s = wsum[w * e + c];
      wsum[w * e + c] = run;
      run = s_first[w] < kRowsPerWarp ? s : run + s;
    }
  }
  __syncthreads();

  // 5. write the tile once
  for (int c0 = lane * kVec; c0 < e; c0 += 32 * kVec) {
    float pre[kVec];
    load_vec<kVec>(wsum + warp * e + c0, pre);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (r0 + i >= k) break;
      float y[kVec];
      load_vec<kVec>(tile + (warp * kRowsPerWarp + i) * e + c0, y);
      if (i < first) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) y[j] = pre[j] + y[j];
      }
      store_vec<kVec>(out + (r0 + i) * e + c0, y);
    }
  }
}

template <typename T, typename TO, int kVec>
int launch(const void* vals, const void* heads, void* out, const Scratch& sc, int64_t tiles,
           int e, int64_t k, cudaStream_t stream) {
  const size_t smem = smem_bytes(e);
  auto kernel = segscan_lookback<T, TO, kVec>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(
      static_cast<const T*>(vals), static_cast<const uint8_t*>(heads), static_cast<TO*>(out), sc,
      k, e);
  return cudaGetLastError();
}

}  // namespace
}  // namespace hctr

// Rows per tile of the scan.
extern "C" int hctr_segscan_tile_rows() { return hctr::kTileRows; }

// Bytes of scratch hctr_segscan needs for [k, e] on the current device, or
// -1 when a tile of width e does not fit in a block's shared memory.
extern "C" int64_t hctr_segscan_scratch_bytes(int64_t k, int e) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (hctr::smem_bytes(e) > static_cast<size_t>(optin)) return -1;
  return hctr::scratch_bytes((k + hctr::kTileRows - 1) / hctr::kTileRows, e);
}

// vals [k, e] of `dtype` and out [k, e] of `out_dtype`; heads [k] uint8
// (0/1); scratch of hctr_segscan_scratch_bytes(k, e) bytes, 16-byte aligned,
// any contents. `vec` is 4 when e % 4 == 0 and vals and out are aligned to 4
// elements, else 1. Returns cudaGetLastError().
extern "C" int hctr_segscan(int dtype, int out_dtype, const void* vals, const void* heads,
                            void* out, void* scratch, int64_t k, int e, int vec, void* stream) {
  if (k == 0 || e == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (k + hctr::kTileRows - 1) / hctr::kTileRows;
  const hctr::Scratch sc = hctr::carve(scratch, tiles, e);
  const int64_t n = 1 + tiles;
  const int64_t want = (n + 255) / 256;
  hctr::segscan_init<<<static_cast<unsigned>(want < 1024 ? want : 1024), 256, 0, s>>>(sc.counter, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  using hctr::launch;
  using bf16 = __nv_bfloat16;
  const bool v4 = vec == 4;
  if (dtype == hctr::kF32 && out_dtype == hctr::kF32)
    return v4 ? launch<float, float, 4>(vals, heads, out, sc, tiles, e, k, s)
              : launch<float, float, 1>(vals, heads, out, sc, tiles, e, k, s);
  if (dtype == hctr::kBF16 && out_dtype == hctr::kBF16)
    return v4 ? launch<bf16, bf16, 4>(vals, heads, out, sc, tiles, e, k, s)
              : launch<bf16, bf16, 1>(vals, heads, out, sc, tiles, e, k, s);
  if (dtype == hctr::kBF16 && out_dtype == hctr::kF32)
    return v4 ? launch<bf16, float, 4>(vals, heads, out, sc, tiles, e, k, s)
              : launch<bf16, float, 1>(vals, heads, out, sc, tiles, e, k, s);
  return cudaErrorInvalidValue;
}
