// Ordered pooling of the owner-partitioned forward over W ranks, and of the
// compact forward of a group with a measured valid cap.
//
// Replaces no Pallas kernel. The JAX package's default forward of a
// model-parallel rowop group at W > 1 (hugectr_tpu/embedding/collection.py
// _mp_fwd_partitioned, :867-936) pools the rows this rank's shard owns with
// a scatter-add in the table's type, and its forward of a group with a
// measured valid cap (_dp_fwd_compact, :1496-1564) pools the group's valid
// keys the same way; XLA adds a scatter's updates in the order of the update
// list and rounds after each add, and the list is sorted by row. So the
// result depends on that order, and index_add_'s atomics (an order that
// changes from run to run) cannot give it. A packed table-and-state row is
// longer than E: the kernel reads its first E columns through the row
// stride ld.
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
// What stands between a serial walk and that bound is latency: a slot's
// adds are a chain in list order, and each add needs its row id, then its
// row, two dependent loads. The design never splits a slot's rows (no
// atomics, no reordering) and goes wide over slots and columns instead:
// - A group of `lanes` (8, 16 or 32) lanes of a warp pools one slot; a
//   warp holds 32 / lanes groups, each on its own slot. Each lane holds its
//   columns of the slot's row, kPer accesses of kVec elements at columns
//   lane * kVec + p * lanes * kVec, so one walk of the list covers lanes *
//   kVec * kPer >= E columns (a row wider than 32 accesses takes more
//   walks). Work units follow the slots: where they are long, one access a
//   lane and as many lanes as the row needs; where they are short (a few
//   ids a slot, as a group of hotness-1 lookups gives), 8 lanes a slot
//   with 2 or 4 accesses each, so a warp pools 4 slots at once and their
//   chains overlap.
// - The access is the widest the rows allow (the wrapper's plan): 16 bytes
//   where the table's pointer, the row stride in bytes and E in bytes are
//   multiples of 16. Rows that do not start on 16 bytes, as `rowwise_pack`'s
//   bf16 [R, 129] rows at 258-byte steps, keep 16 bytes a lane and row, read
//   as 4-byte words and funnel-shifted into place, in the same one walk.
//   Other widths take the widest of 8, 4 or 2 bytes.
// - Adds in the table's type on whole 32-bit words: two bfloat16 a word
//   (add.rn.bf16x2), so a bf16 row needs no conversion to float32 and back.
// - Ids a group at a time: each lane loads one of the next `lanes` row
//   ids (and weights) in one coalesced access; a ballot over the group
//   finds the first id that ends the slot (>= R, or past its end), so no
//   row after it is read, and the ids go to the lanes by shuffles. The next
//   batch of ids is loaded before the current batch's rows are pooled.
// - Rows in flight: kDepth rows (4, or 8 for narrow accesses; 2 or 1 with
//   2 or 4 accesses a lane, the same bytes a lane) are loaded before the
//   first of them is added; the adds then take them in list order.
// - A grid-stride loop over slots, with as many groups as stay resident on
//   the card (the occupancy API), and the next slot's offsets loaded ahead.
//   Each of these costs registers, and past 64 a thread the card holds
//   fewer groups: the depths and widths were chosen on the card so that
//   the kernels of the main paths stay within 64.
// The result is bitwise the same from run to run and equal to the plain
// version's (ops/ordered_pool.py: ordered_pool_plain).
#include <algorithm>

#include "common.cuh"

namespace hctr {
namespace {

constexpr int kThreads = 256;

// The raw bits of one access of kBytes bytes.
template <int kBytes>
struct Raw;
template <>
struct Raw<16> { using type = uint4; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<4> { using type = uint32_t; };
template <>
struct Raw<2> { using type = uint16_t; };

__device__ __forceinline__ uint32_t word(const uint4& r, int k) {
  return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
}
__device__ __forceinline__ uint32_t word(const uint2& r, int k) { return k == 0 ? r.x : r.y; }
__device__ __forceinline__ uint32_t word(uint32_t r, int) { return r; }
__device__ __forceinline__ uint32_t word(uint16_t r, int) { return r; }  // the high half +0

// The adds and products, one rounding each to the table's type, on 32-bit
// words: a float32, or two bfloat16 (add.rn.bf16x2 / mul.rn.bf16x2). A
// bfloat16 sum or product of bfloat16 values rounded once is the float32
// one rounded to bfloat16 (float32 carries more than 2 x 8 + 2 bits, so the
// double rounding is innocuous), which is what the plain version and XLA
// compute; the unused high half of a lone bfloat16 stays +0. Every one
// names its rounding (.rn, __fadd_rn, __fmul_rn), which keeps the compiler
// from fusing a product and a sum into one FMA, one rounding.
__device__ __forceinline__ uint32_t add(uint32_t s, uint32_t v, float*) {
  return __float_as_uint(__fadd_rn(__uint_as_float(s), __uint_as_float(v)));
}
__device__ __forceinline__ uint32_t mul(uint32_t v, uint32_t w, float*) {
  return __float_as_uint(__fmul_rn(__uint_as_float(v), __uint_as_float(w)));
}
__device__ __forceinline__ uint32_t add(uint32_t s, uint32_t v, __nv_bfloat16*) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(s), "r"(v));
  return r;
}
__device__ __forceinline__ uint32_t mul(uint32_t v, uint32_t w, __nv_bfloat16*) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(v), "r"(w));
  return r;
}
// A weight rounded to the table's type, in every element of a word.
__device__ __forceinline__ uint32_t weight_word(float w, float*) { return __float_as_uint(w); }
__device__ __forceinline__ uint32_t weight_word(float w, __nv_bfloat16*) {
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(w));
  return b | (b << 16);
}

// One access of a lane: kVec consecutive elements of a row as raw bits
// (`load`), then as kWords 32-bit words of elements (`words`).
template <typename T, int kVec, bool kShift>
struct Access {
  // the elements' own alignment: one access of kVec * itemsize bytes
  using R = typename Raw<kVec * sizeof(T)>::type;
  static constexpr int kWords = kVec * sizeof(T) >= 4 ? kVec * sizeof(T) / 4 : 1;
  static __device__ __forceinline__ R load(const T* p) { return *reinterpret_cast<const R*>(p); }
  static __device__ __forceinline__ void words(const R& r, uint32_t* w) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) w[k] = word(r, k);
  }
};

// 16 bytes at an address aligned to the element only (a row that does not
// start on 16 bytes): four aligned 4-byte loads or, where the address is 2
// bytes past a 4-byte boundary (bfloat16), five, funnel-shifted by 16 bits.
// The fifth word holds a byte of the 16, so the read cannot fault.
template <typename T>
struct Access<T, 16 / sizeof(T), true> {
  struct R {
    uint32_t y[5];
    uint32_t sh;  // bits past the 4-byte boundary: 0 or 16
  };
  static constexpr int kWords = 4;
  static __device__ __forceinline__ R load(const T* p) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const uint32_t* c = reinterpret_cast<const uint32_t*>(a & ~static_cast<uintptr_t>(3));
    R r;
    r.sh = static_cast<uint32_t>(a & 3) * 8;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.y[k] = c[k];
    r.y[4] = r.sh != 0 ? c[4] : 0u;
    return r;
  }
  static __device__ __forceinline__ void words(const R& r, uint32_t* w) {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __funnelshift_r(r.y[k], r.y[k + 1], r.sh);
  }
};

// kWords words of sums back into one access of kVec elements.
template <typename T, int kVec>
__device__ __forceinline__ typename Raw<kVec * sizeof(T)>::type pack(const uint32_t* w) {
  if constexpr (kVec * sizeof(T) == 16) return make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (kVec * sizeof(T) == 8) return make_uint2(w[0], w[1]);
  else if constexpr (kVec * sizeof(T) == 4) return w[0];
  else return static_cast<uint16_t>(w[0]);
}

template <typename T, int kVec, bool kShift, int kPer>
__global__ void __launch_bounds__(kThreads) ordered_pool_kernel(const T* __restrict__ table, int64_t n_rows,
                                                                int64_t ld, const int64_t* __restrict__ rows,
                                                                const float* __restrict__ w,
                                                                const int64_t* __restrict__ offsets,
                                                                T* __restrict__ out, int64_t n_slots, int e,
                                                                int lanes) {
  using A = Access<T, kVec, kShift>;
  using R = typename A::R;
  constexpr int kHeld = A::kWords * kPer;  // words of a row a lane holds
  constexpr int kDepth = kHeld <= 2 ? 8 : kHeld <= 4 ? 4 : kHeld <= 8 ? 2 : 1;  // rows in flight
  T* const type = nullptr;                                                      // picks the table type's arithmetic
  const int lane = threadIdx.x % 32;
  const int l = lane % lanes;  // lane within the group
  const int g0 = lane - l;     // the group's first lane
  const unsigned gmask = lanes == 32 ? 0xffffffffu : ((1u << lanes) - 1u) << g0;
  const int span = lanes * kVec;  // columns of one access of every lane of the group
  const int64_t stride = static_cast<int64_t>(gridDim.x) * (kThreads / lanes);
  int64_t slot = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / lanes;
  if (slot >= n_slots) return;
  int64_t begin = offsets[slot], end = offsets[slot + 1];
  for (; slot < n_slots; slot += stride) {
    // the next slot's offsets, ahead of this slot's loads
    const int64_t next = slot + stride;
    const int64_t next_begin = next < n_slots ? offsets[next] : 0;
    const int64_t next_end = next < n_slots ? offsets[next + 1] : 0;
    // one walk of the slot's rows for each kPer * span columns; this lane's
    // accesses at columns c + p * span
    for (int c = l * kVec; c - l * kVec < e; c += kPer * span) {
      uint32_t acc[kPer][A::kWords];
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
#pragma unroll
        for (int k = 0; k < A::kWords; ++k) acc[p][k] = 0u;  // +0 in either type
      }
      int64_t j = begin + l;
      long long id = j < end ? rows[j] : n_rows;
      uint32_t wt = w != nullptr && j < end ? weight_word(w[j], type) : 0u;
      for (int64_t base = begin; base < end; base += lanes) {
        // the group's first lane whose id ends the slot (past its end, or a
        // key this rank does not pool); ids are owned up to it
        const unsigned stop = __ballot_sync(gmask, id >= n_rows) >> g0;
        const int n_own = stop ? __ffs(stop) - 1 : lanes;
        long long id_next = n_rows;
        uint32_t wt_next = 0u;
        j = base + lanes + l;
        if (!stop && j < end) {
          id_next = rows[j];
          if (w != nullptr) wt_next = weight_word(w[j], type);
        }
        for (int i0 = 0; i0 < n_own; i0 += kDepth) {
          R x[kDepth][kPer];
#pragma unroll
          for (int d = 0; d < kDepth; ++d) {
            if (i0 + d < n_own) {
              const long long r = __shfl_sync(gmask, id, i0 + d, lanes);
#pragma unroll
              for (int p = 0; p < kPer; ++p) x[d][p] = c + p * span < e ? A::load(table + r * ld + c + p * span) : R{};
            }
          }
#pragma unroll
          for (int d = 0; d < kDepth; ++d) {
            if (i0 + d < n_own) {
              const uint32_t wd = w != nullptr ? __shfl_sync(gmask, wt, i0 + d, lanes) : 0u;
#pragma unroll
              for (int p = 0; p < kPer; ++p) {
                uint32_t v[A::kWords];
                A::words(x[d][p], v);
#pragma unroll
                for (int k = 0; k < A::kWords; ++k) {
                  if (w != nullptr) v[k] = mul(v[k], wd, type);
                  acc[p][k] = add(acc[p][k], v[k], type);
                }
              }
            }
          }
        }
        if (stop) break;
        id = id_next;
        wt = wt_next;
      }
      // out is aligned to the access (the wrapper allocates it)
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        if (c + p * span < e) {
          *reinterpret_cast<typename Raw<kVec * sizeof(T)>::type*>(out + slot * e + c + p * span) =
              pack<T, kVec>(acc[p]);
        }
      }
    }
    begin = next_begin;
    end = next_end;
  }
}

template <typename T, int kVec, bool kShift, int kPer>
cudaError_t launch(const void* table, int64_t n_rows, int64_t ld, const void* rows, const void* weights,
                   const void* offsets, void* out, int64_t n_slots, int e, int lanes, cudaStream_t s) {
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ordered_pool_kernel<T, kVec, kShift, kPer>, kThreads, 0);
    return n > 0 ? n : 1;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t groups_a_block = kThreads / lanes;
  const int64_t blocks = std::min<int64_t>((n_slots + groups_a_block - 1) / groups_a_block,
                                           static_cast<int64_t>(per_sm) * (sms > 0 ? sms : 1));
  ordered_pool_kernel<T, kVec, kShift, kPer><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(table), n_rows, ld, static_cast<const int64_t*>(rows),
      static_cast<const float*>(weights), static_cast<const int64_t*>(offsets), static_cast<T*>(out), n_slots, e,
      lanes);
  return cudaGetLastError();
}

// The plans the wrapper makes (ops/ordered_pool.py: pool_plan): vec * itemsize <= 16 bytes, 16 bytes for
// shifted accesses, and 2 or 4 accesses a lane only for aligned 16-byte ones.
template <typename T>
cudaError_t dispatch(int vec, int per, bool shift, const void* table, int64_t n_rows, int64_t ld,
                     const void* rows, const void* weights, const void* offsets, void* out, int64_t n_slots,
                     int e, int lanes, cudaStream_t s) {
  constexpr int kWide = 16 / sizeof(T);  // elements in 16 bytes
  if (shift) {
    if (vec != kWide || per != 1) return cudaErrorInvalidValue;
    return launch<T, kWide, true, 1>(table, n_rows, ld, rows, weights, offsets, out, n_slots, e, lanes, s);
  }
  if (vec == kWide) {
    if (per == 1) return launch<T, kWide, false, 1>(table, n_rows, ld, rows, weights, offsets, out, n_slots, e, lanes, s);
    if (per == 2) return launch<T, kWide, false, 2>(table, n_rows, ld, rows, weights, offsets, out, n_slots, e, lanes, s);
    if (per == 4) return launch<T, kWide, false, 4>(table, n_rows, ld, rows, weights, offsets, out, n_slots, e, lanes, s);
    return cudaErrorInvalidValue;
  }
  if (per != 1) return cudaErrorInvalidValue;
  if (vec == 1) return launch<T, 1, false, 1>(table, n_rows, ld, rows, weights, offsets, out, n_slots, e, lanes, s);
  if (vec == 2) return launch<T, 2, false, 1>(table, n_rows, ld, rows, weights, offsets, out, n_slots, e, lanes, s);
  if constexpr (kWide == 8) {
    if (vec == 4) return launch<T, 4, false, 1>(table, n_rows, ld, rows, weights, offsets, out, n_slots, e, lanes, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace hctr

// table [n_rows, e] of `dtype`, row r at table + r * ld (ld >= e: the
// first e columns of a packed table-and-state row); rows [K] int64, each
// slot's rows in order, ids >= n_rows last; weights [K] float32 aligned with
// rows, or null; offsets [n_slots + 1] int64; out [n_slots, e] of `dtype`.
// The plan (ops/ordered_pool.py: pool_plan): `vec` elements an access (vec *
// itemsize divides 16, out's address and e * itemsize; without `shift` also
// the table's address and ld * itemsize; with it, vec * itemsize is 16),
// `lanes` a slot (8, 16 or 32), `per` accesses a lane in one walk (1; 2 or
// 4 for aligned 16-byte accesses). Returns cudaErrorInvalidValue for a plan
// it does not take, else cudaGetLastError().
extern "C" int hctr_ordered_pool(int dtype, const void* table, int64_t n_rows, int64_t ld, const void* rows,
                                 const void* weights, const void* offsets, void* out, int64_t n_slots, int e,
                                 int vec, int lanes, int per, int shift, void* stream) {
  const int64_t isz = dtype == hctr::kBF16 ? 2 : 4;
  const int64_t bytes = static_cast<int64_t>(vec) * isz;
  const uintptr_t t = reinterpret_cast<uintptr_t>(table);
  const bool aligned = vec > 0 && 16 % bytes == 0 && reinterpret_cast<uintptr_t>(out) % bytes == 0 &&
                       e % vec == 0 &&
                       (shift ? bytes == 16 && t % isz == 0 : t % bytes == 0 && ld * isz % bytes == 0);
  if (!aligned || (lanes != 8 && lanes != 16 && lanes != 32) || ld < e) return cudaErrorInvalidValue;
  if (n_slots == 0 || e == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == hctr::kBF16) {
    return hctr::dispatch<__nv_bfloat16>(vec, per, shift != 0, table, n_rows, ld, rows, weights, offsets, out,
                                         n_slots, e, lanes, s);
  }
  return hctr::dispatch<float>(vec, per, shift != 0, table, n_rows, ld, rows, weights, offsets, out, n_slots, e,
                               lanes, s);
}
