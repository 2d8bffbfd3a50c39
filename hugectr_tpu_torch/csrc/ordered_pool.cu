// Ordered pooling of the owner-partitioned forward over W ranks.
//
// Replaces no Pallas kernel. The JAX package's default forward of a
// model-parallel rowop group at W > 1 (hugectr_tpu/embedding/collection.py
// _mp_fwd_partitioned, :867-936) pools the rows this rank's shard owns with
// a scatter-add in the table's type; XLA adds a scatter's updates in the
// order of the update list and rounds after each add, and the list is
// sorted by row. So the result depends on that order, and index_add_'s
// atomics (an order that changes from run to run) cannot give it.
//
//   out[s, :] = (((0 + table[rows[b]]) + table[rows[b + 1]]) + ...)
//   over j in [b, e) = [offsets[s], offsets[s + 1]) up to the first row id
//   >= R (the keys this rank does not pool; they sort last in a slot), each
//   add taken in float32 and rounded to the table's type (bfloat16: round
//   to nearest even), a slot without rows zero.
//
// Weighted lookups (the JAX package sorts (row, slot, w) with the row as the
// only key, stable, collection.py:884-888, and pools rows * w in the table's
// type, :890-900): with per-pair float32 weights w[j] aligned with rows,
// each row is multiplied by w[j] rounded to the table's type, the product
// rounded to the table's type, then added as above. A bfloat16 product of
// two bfloat16 values is exact in float32 before its rounding, so this is
// XLA's bfloat16 multiply, and the order of the adds is unchanged.
//
// Bound on an H100: memory. The function reads each distinct pooled row
// once (U rows of E elements; power-law keys repeat rows, and L2 serves the
// repeats), the row ids up to each slot's first foreign one (the owned
// rows O and at most one more a slot: I <= O + n_slots) and the offsets,
// and writes the n_slots x E output: (U * E * itemsize + 8 * I + 8 *
// (n_slots + 1) + n_slots * E * itemsize) bytes at 3.35 TB/s; its O x E
// additions are nothing beside that.
//
// Design: one warp per slot, lanes over E (4 consecutive columns a lane
// with 16-byte float32 or 8-byte bfloat16 accesses where the row width and
// the pointers allow, 128 columns a warp per pass). The warp walks its
// slot's rows in order with the sum in float32 registers, rounding after
// each add, and writes the slot once. The order is the list's, so the
// result is bitwise the same from run to run and equal to the plain
// version's. Slot lengths are the lookups' hotness at most (100 in bench.py's
// tables), so a warp's serial chain is short; the many slots of a batch
// fill the card.
#include "common.cuh"

namespace hctr {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T, int kVec, bool kWeighted>
__global__ void __launch_bounds__(kThreads) ordered_pool_kernel(const T* __restrict__ table, int64_t n_rows,
                                                                const int64_t* __restrict__ rows,
                                                                const float* __restrict__ w,
                                                                const int64_t* __restrict__ offsets,
                                                                T* __restrict__ out, int64_t n_slots, int e) {
  const int64_t slot = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (slot >= n_slots) return;
  const int64_t begin = offsets[slot];
  const int64_t end = offsets[slot + 1];
  for (int c = lane * kVec; c < e; c += 32 * kVec) {
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
    for (int64_t j = begin; j < end; ++j) {
      const int64_t r = rows[j];
      if (r >= n_rows) break;  // the rest of the slot is keys this rank does not pool
      float x[kVec];
      load_vec<kVec>(table + r * e + c, x);
      if constexpr (kWeighted) {
        const float wj = round_to(w[j], static_cast<T*>(nullptr));
#pragma unroll
        for (int i = 0; i < kVec; ++i) x[i] = round_to(x[i] * wj, static_cast<T*>(nullptr));
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = round_to(acc[i] + x[i], static_cast<T*>(nullptr));
    }
    store_vec<kVec>(out + slot * e + c, acc);
  }
}

template <typename T, bool kWeighted>
void launch_w(const T* t, int64_t n_rows, const int64_t* r, const float* w, const int64_t* o, T* y,
              int64_t n_slots, int e, int vec, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((n_slots + kWarps - 1) / kWarps);
  if (vec == 4) {
    ordered_pool_kernel<T, 4, kWeighted><<<blocks, kThreads, 0, s>>>(t, n_rows, r, w, o, y, n_slots, e);
  } else {
    ordered_pool_kernel<T, 1, kWeighted><<<blocks, kThreads, 0, s>>>(t, n_rows, r, w, o, y, n_slots, e);
  }
}

template <typename T>
cudaError_t launch(const void* table, int64_t n_rows, const void* rows, const void* weights, const void* offsets,
                   void* out, int64_t n_slots, int e, int vec, cudaStream_t s) {
  const T* t = static_cast<const T*>(table);
  const int64_t* r = static_cast<const int64_t*>(rows);
  const float* w = static_cast<const float*>(weights);
  const int64_t* o = static_cast<const int64_t*>(offsets);
  T* y = static_cast<T*>(out);
  if (w != nullptr) {
    launch_w<T, true>(t, n_rows, r, w, o, y, n_slots, e, vec, s);
  } else {
    launch_w<T, false>(t, n_rows, r, w, o, y, n_slots, e, vec, s);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace hctr

// table [n_rows, e] of `dtype`; rows [K] int64, each slot's rows in order,
// ids >= n_rows last; weights [K] float32 aligned with rows, or null;
// offsets [n_slots + 1] int64; out [n_slots, e] of `dtype`. `vec` is 4 when
// e % 4 == 0 and table and out are aligned to 4 elements, else 1. Returns
// cudaGetLastError().
extern "C" int hctr_ordered_pool(int dtype, const void* table, int64_t n_rows, const void* rows, const void* weights,
                                 const void* offsets, void* out, int64_t n_slots, int e, int vec, void* stream) {
  if (n_slots == 0 || e == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == hctr::kBF16) {
    return hctr::launch<__nv_bfloat16>(table, n_rows, rows, weights, offsets, out, n_slots, e, vec, s);
  }
  return hctr::launch<float>(table, n_rows, rows, weights, offsets, out, n_slots, e, vec, s);
}
