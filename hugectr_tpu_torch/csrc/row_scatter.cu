// Drop-mode row scatters of the fixed-shape sparse update.
//
// The JAX package writes its row updates with XLA scatters in mode="drop":
// an index at or past the table's rows writes nothing
// (hugectr_tpu/embedding/sparse_optimizer.py:408, :486, :705, :746, :788,
// :800). PyTorch has no such mode, and a spare row inside a table or its
// state would change what snapshots and exports hold. These two kernels
// take the key lists at their full, fixed length and skip the entries
// that XLA would drop, so the update needs neither a host sync nor a
// shape that follows the batch.
//
// 1. hctr_scatter_add_rows: dst[idx[i], :] += vals[src[i], :] for every i
//    with 0 <= idx[i] < rows (the dense sweep's gradient buffer, float32 or
//    bfloat16). Atomic adds, as torch's index_add_ on the card: the sums of
//    a row come in no fixed order.
// 2. hctr_adagrad_rows: the AdaGrad or RowWiseAdaGrad update of the unique
//    rows of a sorted key list (the sorted route, sparse_optimizer.py:752):
//    entry i < count (a device int64) that ends its run of equal row ids
//    (a segment tail, which holds the run's float32 sum from the segmented
//    scan) updates row sidx[i]: the accumulator gets g^2 (its row mean for
//    RowWiseAdaGrad), then the table adds -lr g / (sqrt(accum) + eps)
//    rounded to its type. Tails are unique, so no two entries write one row
//    and the result is the same from run to run. Entries past the count
//    (the list's padding, which sorts last) are never read.
//
// Bound on an H100: memory. The scatter reads idx, src and the live rows
// of vals and adds into dst; the update reads the sorted ids up to the
// count, and reads and writes one table row and one accumulator row (and
// reads one gradient row) per unique row.
//
// Design: one warp per entry, in a grid-stride loop over a fixed grid, so
// that a captured launch does the same work as an eager one and only the
// entries up to the count cost anything. The update's arithmetic rounds
// every product and sum on its own (__fmul_rn / __fadd_rn, no contraction
// into fma), in the order torch evaluates the same formula, so that the
// card agrees with the plain version to the last bit for AdaGrad and up to
// the order of the row sum for RowWiseAdaGrad's mean.
#include "common.cuh"

namespace hctr {
namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxBlocks = 4096;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void atomic_add(float* p, float v) { atomicAdd(p, v); }
__device__ __forceinline__ void atomic_add(__nv_bfloat16* p, float v) {
  atomicAdd(p, __float2bfloat16(v));
}

template <typename TS, typename TD>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows(const TS* __restrict__ vals, const int64_t* __restrict__ idx, const int64_t* __restrict__ src,
                 TD* __restrict__ dst, int64_t k, int64_t rows, int e) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5); i < k; i += warps) {
    const int64_t r = idx[i];
    if (r < 0 || r >= rows) continue;
    const int64_t s = src != nullptr ? src[i] : i;
    for (int c = lane; c < e; c += 32) atomic_add(dst + r * e + c, to_f32(vals[s * e + c]));
  }
}

template <typename TT, typename TA, bool kRowwise>
__global__ void __launch_bounds__(kThreads)
adagrad_rows(TT* __restrict__ table, TA* __restrict__ accum, const int64_t* __restrict__ sidx,
             const float* __restrict__ g, const int64_t* __restrict__ count, const void* __restrict__ lr_ptr,
             int lr_bf16, int64_t k, int64_t rows, int e, float eps) {
  const int lane = threadIdx.x & 31;
  int64_t n = *count;
  n = n < 0 ? 0 : (n < k ? n : k);
  const float lr = lr_bf16 ? __bfloat162float(*static_cast<const __nv_bfloat16*>(lr_ptr))
                           : *static_cast<const float*>(lr_ptr);
  const float neg_lr = -lr;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5); i < n; i += warps) {
    const int64_t r = sidx[i];
    // a tail: the last entry of its run (the entry after the count is
    // padding, whose id is at least rows, or the list's end)
    if (i + 1 < k && sidx[i + 1] == r) continue;
    if (r < 0 || r >= rows) continue;
    const float* gi = g + i * e;
    TT* w = table + r * e;
    if constexpr (kRowwise) {
      float ss = 0.f;
      for (int c = lane; c < e; c += 32) ss = __fadd_rn(ss, __fmul_rn(gi[c], gi[c]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(kFull, ss, o));
      const float a = __fadd_rn(to_f32(accum[r]), __fdiv_rn(ss, static_cast<float>(e)));
      const float den = __fadd_rn(__fsqrt_rn(a), eps);
      for (int c = lane; c < e; c += 32) {
        const float d = __fdiv_rn(__fmul_rn(neg_lr, gi[c]), den);
        w[c] = from_f32<TT>(__fadd_rn(to_f32(w[c]), to_f32(from_f32<TT>(d))));
      }
      if (lane == 0) accum[r] = from_f32<TA>(a);
    } else {
      TA* acc = accum + r * e;
      for (int c = lane; c < e; c += 32) {
        const float gc = gi[c];
        const float a = __fadd_rn(to_f32(acc[c]), __fmul_rn(gc, gc));
        const float d = __fdiv_rn(__fmul_rn(neg_lr, gc), __fadd_rn(__fsqrt_rn(a), eps));
        acc[c] = from_f32<TA>(a);
        w[c] = from_f32<TT>(__fadd_rn(to_f32(w[c]), to_f32(from_f32<TT>(d))));
      }
    }
  }
}

inline unsigned grid_for(int64_t k) {
  const int64_t want = (k + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return static_cast<unsigned>(want < kMaxBlocks ? (want > 0 ? want : 1) : kMaxBlocks);
}

template <typename TT, typename TA>
int adagrad_launch(void* table, void* accum, const int64_t* sidx, const float* g, const int64_t* count,
                   const void* lr, int lr_bf16, int64_t k, int64_t rows, int e, float eps, int rowwise,
                   cudaStream_t s) {
  auto* t = static_cast<TT*>(table);
  auto* a = static_cast<TA*>(accum);
  if (rowwise)
    adagrad_rows<TT, TA, true><<<grid_for(k), kThreads, 0, s>>>(t, a, sidx, g, count, lr, lr_bf16, k, rows, e, eps);
  else
    adagrad_rows<TT, TA, false><<<grid_for(k), kThreads, 0, s>>>(t, a, sidx, g, count, lr, lr_bf16, k, rows, e, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace hctr

// dst [rows, e] of `dst_dtype` += vals[src[i]] ([S, e] of `vals_dtype`; src
// null reads row i) at row idx[i] for each of the k entries whose idx is in
// [0, rows); other entries are dropped. Returns cudaGetLastError().
extern "C" int hctr_scatter_add_rows(int vals_dtype, int dst_dtype, const void* vals, const void* idx,
                                     const void* src, void* dst, int64_t k, int64_t rows, int e, void* stream) {
  if (k == 0 || e == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int64_t*>(idx);
  const auto* sx = static_cast<const int64_t*>(src);
  using bf16 = __nv_bfloat16;
  const unsigned grid = hctr::grid_for(k);
  if (vals_dtype == hctr::kF32 && dst_dtype == hctr::kF32)
    hctr::scatter_add_rows<float, float><<<grid, hctr::kThreads, 0, s>>>(
        static_cast<const float*>(vals), ix, sx, static_cast<float*>(dst), k, rows, e);
  else if (vals_dtype == hctr::kBF16 && dst_dtype == hctr::kF32)
    hctr::scatter_add_rows<bf16, float><<<grid, hctr::kThreads, 0, s>>>(
        static_cast<const bf16*>(vals), ix, sx, static_cast<float*>(dst), k, rows, e);
  else if (vals_dtype == hctr::kF32 && dst_dtype == hctr::kBF16)
    hctr::scatter_add_rows<float, bf16><<<grid, hctr::kThreads, 0, s>>>(
        static_cast<const float*>(vals), ix, sx, static_cast<bf16*>(dst), k, rows, e);
  else if (vals_dtype == hctr::kBF16 && dst_dtype == hctr::kBF16)
    hctr::scatter_add_rows<bf16, bf16><<<grid, hctr::kThreads, 0, s>>>(
        static_cast<const bf16*>(vals), ix, sx, static_cast<bf16*>(dst), k, rows, e);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// The AdaGrad (rowwise 0; accum [rows, e]) or RowWiseAdaGrad (rowwise 1;
// accum [rows, 1]) update of table [rows, e] from the sorted row ids sidx
// [k] (int64) and the float32 segmented sums g [k, e], for the segment
// tails among the first *count entries. lr is a device scalar of
// `lr_dtype`. Returns cudaGetLastError().
extern "C" int hctr_adagrad_rows(int table_dtype, int accum_dtype, void* table, void* accum, const void* sidx,
                                 const void* g, const void* count, const void* lr, int lr_dtype, int64_t k,
                                 int64_t rows, int e, float eps, int rowwise, void* stream) {
  if (k == 0 || e == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int64_t*>(sidx);
  const auto* gx = static_cast<const float*>(g);
  const auto* cnt = static_cast<const int64_t*>(count);
  const int lr_bf16 = lr_dtype == hctr::kBF16;
  using bf16 = __nv_bfloat16;
  using hctr::adagrad_launch;
  if (table_dtype == hctr::kF32 && accum_dtype == hctr::kF32)
    return adagrad_launch<float, float>(table, accum, ix, gx, cnt, lr, lr_bf16, k, rows, e, eps, rowwise, s);
  if (table_dtype == hctr::kBF16 && accum_dtype == hctr::kF32)
    return adagrad_launch<bf16, float>(table, accum, ix, gx, cnt, lr, lr_bf16, k, rows, e, eps, rowwise, s);
  if (table_dtype == hctr::kF32 && accum_dtype == hctr::kBF16)
    return adagrad_launch<float, bf16>(table, accum, ix, gx, cnt, lr, lr_bf16, k, rows, e, eps, rowwise, s);
  if (table_dtype == hctr::kBF16 && accum_dtype == hctr::kBF16)
    return adagrad_launch<bf16, bf16>(table, accum, ix, gx, cnt, lr, lr_bf16, k, rows, e, eps, rowwise, s);
  return cudaErrorInvalidValue;
}
