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
//    (the list's padding, which sorts last) update nothing: the last
//    tile's one load of ids reads some of their ids, and no row of theirs
//    is read.
//
// Bound on an H100: memory. The scatter reads idx, src and the live rows
// of vals and adds into dst. The update reads the sorted ids up to the
// count, then for each unique row its gradient row once, its table row
// twice (read and write) and its accumulator twice (a row for AdaGrad, one
// value for RowWiseAdaGrad): (8 n + U (4 E + 2 E t + 2 w a)) bytes at
// 3.35 TB/s, with t and a the table's and the accumulator's item sizes and w
// the accumulator's width.
//
// Design of the scatter: one warp per entry, in a grid-stride loop over a
// fixed grid, so that a captured launch does the same work as an eager one
// and only the entries up to the count cost anything.
//
// Design of the update. At the main path's lists a tail comes every 1.1 to
// 4 entries, and each tail's work is a chain of loads (the id, then the
// rows, then for RowWiseAdaGrad a reduction before the table can be
// written): what stands between a warp and the bound is latency, so the
// design keeps many rows in flight and makes a non-tail entry cheap.
// - Tails are found a tile at a time (`Tails`). A warp loads up to 32
//   consecutive sorted ids in one coalesced access (and the id after the
//   tile), compares each with its neighbour's by a shuffle, and marks the
//   tails, entries i < count whose id differs from the next one's (or that
//   end the list) and lies in [0, rows), with one ballot. A non-tail entry
//   costs only its share of that load. The next tile's ids are loaded while
//   this tile's tails are updated. A count too short to give every warp of
//   the grid 32 ids takes narrower tiles (the kernel reads the count and
//   picks the width), so its tails still spread over all the warps.
// - At E <= 128 where a lane's 4 columns are one 16-byte float32 (8-byte
//   bfloat16) access (vec 4, the wrapper's check of E and the pointers;
//   the main path's rows), each warp streams its tails through a ring of
//   rows in shared memory (`adagrad_rows_ring`): cp.async copies a tail's
//   gradient row, table row and AdaGrad accumulator row in (each lane its
//   own 16 or 8 bytes, which it alone reads back) as many tails ahead as
//   the ring holds (kRingWarpBytes a warp: 2 to 5 rows), and
//   RowWiseAdaGrad's accumulator value is loaded as early; the warp then
//   updates the oldest row from shared memory and refills its slot. Rows
//   in flight are bounded by shared memory, not registers: a first
//   design that kept 8 tails a warp in registers (255 registers, spills)
//   held about 64 rows an SM and ran the bench cold tier 1.27x slower than
//   one warp an entry.
// - Other widths and alignments (the samples' E 1, 11, 18; rows that start
//   off 4 elements; E > 128) take the general kernel (`adagrad_rows`):
//   kDepth (2) tails at a time in registers, all their loads issued before the
//   first one's arithmetic, one column a lane (vec 1) or four.
// - RowWiseAdaGrad reads a gradient row of at most 32 vec columns once: the
//   sum of squares comes from the values the update then uses, summed lane
//   by lane and then across the warp by shuffles (an order other than
//   torch's mean; two orders of E positive float32 terms differ by at most
//   2 (E - 1) 2^-24 of the sum). A wider row is walked twice.
// - The grid is the card's: its SMs times the blocks an SM holds, fewer
//   only where the list's fixed length has fewer entries than warps; the
//   warps stride over the tiles up to the count, which is read on the
//   device. The launch shape never follows the data, so a captured step
//   replays it as is.
// - Offsets are int64 throughout (the full vocabulary's cold tiers hold
//   39,868,928 rows, 5.1e9 elements at E 128).
// - Tails are unique, so no two warps write one row: no atomics, and two
//   runs give the same bits. The arithmetic rounds every product, quotient,
//   root and sum on its own (__fmul_rn, __fdiv_rn, __fsqrt_rn, __fadd_rn,
//   no contraction into fma), in the order torch evaluates the same
//   formula, so AdaGrad is its plain version to the last bit, and
//   RowWiseAdaGrad up to the order of its row sum.
#include "common.cuh"

namespace hctr {
namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxBlocks = 4096;
constexpr unsigned kFull = 0xffffffffu;
// Segment tails a warp of the general update keeps in flight, measured on
// an H100 at the samples' E 11 and 18: 2 beats 1, 4 and 8 (more registers,
// fewer warps an SM).
constexpr int kDepth = 2;

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

// The row update of one group of tails (AdaGrad): each lane's columns of
// every live row's gradient, table and accumulator are all loaded before
// the first one's arithmetic, then updated and stored.
template <typename TT, typename TA, int kVec>
__device__ __forceinline__ void adagrad_group(TT* __restrict__ table, TA* __restrict__ accum,
                                              const float* __restrict__ g, const int64_t (&r)[kDepth],
                                              const int64_t (&p)[kDepth], const bool (&live)[kDepth], int lane,
                                              int e, float neg_lr, float eps) {
  for (int c = lane * kVec; c < e; c += 32 * kVec) {
    float gv[kDepth][kVec], wv[kDepth][kVec], av[kDepth][kVec];
#pragma unroll
    for (int s = 0; s < kDepth; ++s) {
      if (!live[s]) continue;
      load_vec<kVec>(g + p[s] * e + c, gv[s]);
      load_vec<kVec>(table + r[s] * e + c, wv[s]);
      load_vec<kVec>(accum + r[s] * e + c, av[s]);
    }
#pragma unroll
    for (int s = 0; s < kDepth; ++s) {
      if (!live[s]) continue;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float gc = gv[s][i];
        const float a = __fadd_rn(av[s][i], __fmul_rn(gc, gc));
        const float d = __fdiv_rn(__fmul_rn(neg_lr, gc), __fadd_rn(__fsqrt_rn(a), eps));
        av[s][i] = a;
        wv[s][i] = __fadd_rn(wv[s][i], to_f32(from_f32<TT>(d)));
      }
      store_vec<kVec>(table + r[s] * e + c, wv[s]);
      store_vec<kVec>(accum + r[s] * e + c, av[s]);
    }
  }
}

template <int kN>
__device__ __forceinline__ void warp_sums(float (&x)[kN]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int s = 0; s < kN; ++s) x[s] = __fadd_rn(x[s], __shfl_xor_sync(kFull, x[s], o));
  }
}

// The row update of one group of tails (RowWiseAdaGrad). A row of at most
// 32 * kVec columns is read once: its sum of squares comes from the
// registers the update then uses, while the table rows and accumulators are
// in flight. A wider row is walked twice: the sums first, then the update.
template <typename TT, typename TA, int kVec>
__device__ __forceinline__ void rowwise_group(TT* __restrict__ table, TA* __restrict__ accum,
                                              const float* __restrict__ g, const int64_t (&r)[kDepth],
                                              const int64_t (&p)[kDepth], const bool (&live)[kDepth], int lane,
                                              int e, float neg_lr, float eps) {
  float acc[kDepth], ss[kDepth], den[kDepth];
#pragma unroll
  for (int s = 0; s < kDepth; ++s) {
    acc[s] = live[s] ? to_f32(accum[r[s]]) : 0.f;
    ss[s] = 0.f;
  }
  const int c0 = lane * kVec;
  if (e <= 32 * kVec) {
    const bool on = c0 < e;
    float gv[kDepth][kVec], wv[kDepth][kVec];
#pragma unroll
    for (int s = 0; s < kDepth; ++s) {
      if (!live[s] || !on) continue;
      load_vec<kVec>(g + p[s] * e + c0, gv[s]);
      load_vec<kVec>(table + r[s] * e + c0, wv[s]);
    }
#pragma unroll
    for (int s = 0; s < kDepth; ++s) {
      if (!live[s] || !on) continue;
#pragma unroll
      for (int i = 0; i < kVec; ++i) ss[s] = __fadd_rn(ss[s], __fmul_rn(gv[s][i], gv[s][i]));
    }
    warp_sums(ss);
#pragma unroll
    for (int s = 0; s < kDepth; ++s) {
      if (!live[s]) continue;
      const float a = __fadd_rn(acc[s], __fdiv_rn(ss[s], static_cast<float>(e)));
      const float dn = __fadd_rn(__fsqrt_rn(a), eps);
      if (on) {
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          wv[s][i] = __fadd_rn(wv[s][i], to_f32(from_f32<TT>(__fdiv_rn(__fmul_rn(neg_lr, gv[s][i]), dn))));
        store_vec<kVec>(table + r[s] * e + c0, wv[s]);
      }
      if (lane == 0) accum[r[s]] = from_f32<TA>(a);
    }
    return;
  }
  for (int c = c0; c < e; c += 32 * kVec) {
    float gv[kDepth][kVec];
#pragma unroll
    for (int s = 0; s < kDepth; ++s)
      if (live[s]) load_vec<kVec>(g + p[s] * e + c, gv[s]);
#pragma unroll
    for (int s = 0; s < kDepth; ++s) {
      if (!live[s]) continue;
#pragma unroll
      for (int i = 0; i < kVec; ++i) ss[s] = __fadd_rn(ss[s], __fmul_rn(gv[s][i], gv[s][i]));
    }
  }
  warp_sums(ss);
#pragma unroll
  for (int s = 0; s < kDepth; ++s) {
    acc[s] = __fadd_rn(acc[s], __fdiv_rn(ss[s], static_cast<float>(e)));
    den[s] = __fadd_rn(__fsqrt_rn(acc[s]), eps);
  }
  for (int c = c0; c < e; c += 32 * kVec) {
    float gv[kDepth][kVec], wv[kDepth][kVec];
#pragma unroll
    for (int s = 0; s < kDepth; ++s) {
      if (!live[s]) continue;
      load_vec<kVec>(g + p[s] * e + c, gv[s]);
      load_vec<kVec>(table + r[s] * e + c, wv[s]);
    }
#pragma unroll
    for (int s = 0; s < kDepth; ++s) {
      if (!live[s]) continue;
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        wv[s][i] = __fadd_rn(wv[s][i], to_f32(from_f32<TT>(__fdiv_rn(__fmul_rn(neg_lr, gv[s][i]), den[s]))));
      store_vec<kVec>(table + r[s] * e + c, wv[s]);
    }
  }
#pragma unroll
  for (int s = 0; s < kDepth; ++s)
    if (live[s] && lane == 0) accum[r[s]] = from_f32<TA>(acc[s]);
}

// The segment tails of the first n entries of a sorted list, in list
// order, handed to a warp one at a time. The warps walk tiles of `width`
// consecutive ids (tile t, t + stride, ...): lane j < width loads one id
// (lane width - 1 also the id after the tile) in one coalesced access,
// compares it with its neighbour's by a shuffle, and one ballot marks the
// tile's tails; the next tile's ids are loaded while this tile's tails are
// taken. The width is 32 where the count gives every warp of the grid 32
// ids or more, else the largest power of two that still does (down to 1),
// so that a short list spreads over the grid's warps as a long one does.
struct Tails {
  const int64_t* __restrict__ sidx;
  int64_t k, n, rows, tiles, stride, t, base;
  long long cur, id, after;
  unsigned mask;
  int lane, width, shift;

  __device__ __forceinline__ void load(int64_t tile) {
    const int64_t pos = (tile << shift) + lane;
    id = lane < width && pos < k ? static_cast<long long>(sidx[pos]) : -1;
    after = lane == width - 1 && pos + 1 < k ? static_cast<long long>(sidx[pos + 1]) : 0;
  }

  // makes tile t (its ids loaded) the current one
  __device__ __forceinline__ void scan() {
    base = t << shift;
    const int64_t pos = base + lane;
    long long nxt = __shfl_down_sync(kFull, id, 1);
    if (lane == width - 1) nxt = after;
    // the last entry of its run in the whole list (the entry after the
    // count is padding, whose id is at least rows, or the list's end)
    const bool tail = lane < width && pos < n && (pos + 1 >= k || nxt != id) && id >= 0 && id < rows;
    mask = __ballot_sync(kFull, tail);
    cur = id;
    if (t + stride < tiles) load(t + stride);
  }

  // false when the warp has no tile
  __device__ __forceinline__ bool start(const int64_t* __restrict__ ids, int64_t k_, int64_t n_, int64_t rows_) {
    sidx = ids, k = k_, n = n_, rows = rows_;
    stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
    t = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
    lane = threadIdx.x & 31;
    shift = 0;
    while (shift < 5 && (stride << (shift + 1)) <= n) ++shift;
    width = 1 << shift;
    tiles = (n + width - 1) >> shift;
    if (t >= tiles) return false;
    load(t);
    scan();
    return true;
  }

  // the next tail: its row id r and list position p; false past the last
  __device__ __forceinline__ bool next(long long& r, int64_t& p) {
    while (mask == 0) {
      if (t >= tiles) return false;
      t += stride;
      if (t >= tiles) return false;
      scan();
    }
    const int src = __ffs(static_cast<int>(mask)) - 1;
    mask &= mask - 1;
    r = __shfl_sync(kFull, cur, src);
    p = base + src;
    return true;
  }
};

__device__ __forceinline__ float load_lr(const void* lr_ptr, int lr_bf16) {
  return lr_bf16 ? __bfloat162float(*static_cast<const __nv_bfloat16*>(lr_ptr)) : *static_cast<const float*>(lr_ptr);
}

// The general update, for any E and alignment: kDepth tails a warp at a
// time, every load of all of them issued before the first one's arithmetic.
template <typename TT, typename TA, bool kRowwise, int kVec>
__global__ void __launch_bounds__(kThreads)
adagrad_rows(TT* __restrict__ table, TA* __restrict__ accum, const int64_t* __restrict__ sidx,
             const float* __restrict__ g, const int64_t* __restrict__ count, const void* __restrict__ lr_ptr,
             int lr_bf16, int64_t k, int64_t rows, int e, float eps) {
  int64_t n = *count;
  n = n < 0 ? 0 : (n < k ? n : k);
  Tails tails;
  if (!tails.start(sidx, k, n, rows)) return;  // the whole warp
  const float neg_lr = -load_lr(lr_ptr, lr_bf16);
  const int lane = threadIdx.x & 31;
  for (;;) {
    int64_t r[kDepth], p[kDepth];
    bool live[kDepth];
#pragma unroll
    for (int s = 0; s < kDepth; ++s) {
      long long rr = 0;
      int64_t pp = 0;
      live[s] = (s == 0 || live[s - 1]) && tails.next(rr, pp);
      r[s] = rr;
      p[s] = pp;
    }
    if (!live[0]) return;
    if constexpr (kRowwise)
      rowwise_group<TT, TA, kVec>(table, accum, g, r, p, live, lane, e, neg_lr, eps);
    else
      adagrad_group<TT, TA, kVec>(table, accum, g, r, p, live, lane, e, neg_lr, eps);
  }
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(a), "l"(src), "n"(kBytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending)); }

// The shared memory a warp's ring takes, measured on an H100: 3,072 to
// 6,144 bytes run alike; from 8,192 on, an SM holds fewer warps and the
// RowWiseAdaGrad bf16 rows run slower.
constexpr int kRingWarpBytes = 4096;

// The ring of the update at E <= 128 with 16-byte accesses: a lane's bytes
// of one row (its 4 columns of g, the table and, for AdaGrad, the
// accumulator) and the slots a warp keeps in flight in its
// kRingWarpBytes of shared memory.
template <typename TT, typename TA, bool kRowwise>
struct Ring {
  static constexpr int kT = 4 * sizeof(TT);
  static constexpr int kA = kRowwise ? 0 : 4 * sizeof(TA);
  static constexpr int kSlot = 32 * (16 + kT + kA);
  static constexpr int kSlots = kRingWarpBytes / kSlot < 32 ? kRingWarpBytes / kSlot : 32;
  static_assert(kSlots >= 2, "the ring holds at least two rows");
  static constexpr int kBlockBytes = kWarpsPerBlock * kSlots * kSlot;
};

// The update at E <= 128 where a lane's 4 columns are one 16-byte float32
// (8-byte bfloat16) access. Each warp streams its tails through a ring of
// kSlots rows in shared memory: a tail's rows are copied in by cp.async
// (every lane its own bytes, so it reads back only what it copied) kSlots
// tails before the warp updates them, and the ring slot is refilled with
// the next tail right after. Lane s keeps slot s's row id, and for
// RowWiseAdaGrad its accumulator, loaded when the slot was filled.
template <typename TT, typename TA, bool kRowwise>
__global__ void __launch_bounds__(kThreads)
adagrad_rows_ring(TT* __restrict__ table, TA* __restrict__ accum, const int64_t* __restrict__ sidx,
                  const float* __restrict__ g, const int64_t* __restrict__ count, const void* __restrict__ lr_ptr,
                  int lr_bf16, int64_t k, int64_t rows, int e, float eps) {
  using R = Ring<TT, TA, kRowwise>;
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t n = *count;
  n = n < 0 ? 0 : (n < k ? n : k);
  Tails tails;
  if (!tails.start(sidx, k, n, rows)) return;  // the whole warp
  const float neg_lr = -load_lr(lr_ptr, lr_bf16);
  const int lane = threadIdx.x & 31;
  const int c = lane * 4;
  const bool on = c < e;
  unsigned char* ring = smem + (threadIdx.x >> 5) * (R::kSlots * R::kSlot);
  auto g_at = [&](int s) { return reinterpret_cast<float*>(ring + s * R::kSlot + lane * 16); };
  auto t_at = [&](int s) { return reinterpret_cast<TT*>(ring + s * R::kSlot + 32 * 16 + lane * R::kT); };
  auto a_at = [&](int s) { return reinterpret_cast<TA*>(ring + s * R::kSlot + 32 * (16 + R::kT) + lane * R::kA); };
  // slot s's row id (and RowWiseAdaGrad's accumulator) on lane s; a slot
  // past the last tail is not live
  long long my_r = 0;
  float my_acc = 0.f;
  bool my_live = false, more = true;
  auto fill = [&](int s) {
    long long r = 0;
    int64_t p = 0;
    more = more && tails.next(r, p);
    if (more && on) {
      cp_async<16>(g_at(s), g + p * e + c);
      cp_async<R::kT>(t_at(s), table + r * e + c);
      if constexpr (!kRowwise) cp_async<R::kA>(a_at(s), accum + r * e + c);
    }
    cp_async_commit();
    if (lane == s) {
      my_live = more;
      my_r = r;
      if constexpr (kRowwise) my_acc = more ? to_f32(accum[r]) : 0.f;
    }
  };
#pragma unroll 1
  for (int s = 0; s < R::kSlots; ++s) fill(s);
  for (int s = 0;; s = s + 1 == R::kSlots ? 0 : s + 1) {
    cp_async_wait<R::kSlots - 1>();  // slot s, the oldest, has landed
    if (!__shfl_sync(kFull, static_cast<int>(my_live), s)) break;  // slots fill in order: none after it either
    const int64_t r = __shfl_sync(kFull, my_r, s);
    if constexpr (kRowwise) {
      float gv[4] = {0.f, 0.f, 0.f, 0.f}, wv[4];
      float ss = 0.f;
      if (on) {
        load_vec<4>(g_at(s), gv);
        load_vec<4>(t_at(s), wv);
#pragma unroll
        for (int i = 0; i < 4; ++i) ss = __fadd_rn(ss, __fmul_rn(gv[i], gv[i]));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(kFull, ss, o));
      const float a = __fadd_rn(__shfl_sync(kFull, my_acc, s), __fdiv_rn(ss, static_cast<float>(e)));
      const float dn = __fadd_rn(__fsqrt_rn(a), eps);
      if (on) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wv[i] = __fadd_rn(wv[i], to_f32(from_f32<TT>(__fdiv_rn(__fmul_rn(neg_lr, gv[i]), dn))));
        store_vec<4>(table + r * e + c, wv);
      }
      if (lane == 0) accum[r] = from_f32<TA>(a);
    } else if (on) {
      float gv[4], wv[4], av[4];
      load_vec<4>(g_at(s), gv);
      load_vec<4>(t_at(s), wv);
      load_vec<4>(a_at(s), av);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = __fadd_rn(av[i], __fmul_rn(gv[i], gv[i]));
        const float d = __fdiv_rn(__fmul_rn(neg_lr, gv[i]), __fadd_rn(__fsqrt_rn(a), eps));
        av[i] = a;
        wv[i] = __fadd_rn(wv[i], to_f32(from_f32<TT>(d)));
      }
      store_vec<4>(table + r * e + c, wv);
      store_vec<4>(accum + r * e + c, av);
    }
    fill(s);
  }
  cp_async_wait<0>();
}

inline unsigned grid_for(int64_t k) {
  const int64_t want = (k + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return static_cast<unsigned>(want < kMaxBlocks ? (want > 0 ? want : 1) : kMaxBlocks);
}

// The update's grid: the blocks the card holds at once (its SMs times the
// blocks of this kernel an SM keeps resident with `smem` bytes of shared
// memory each), or fewer where the list has fewer entries than warps. It
// follows the list's fixed length k, never the count, so a captured launch
// does what an eager one does. The first call on a device also lets the
// kernel have `smem` bytes.
template <typename Kernel>
unsigned card_grid(Kernel kernel, int smem, int64_t k, int (&resident)[64]) {
  int dev = 0;
  cudaGetDevice(&dev);
  int& blocks = resident[dev & 63];
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (smem > 48 * 1024) cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    blocks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t want = (k + kWarpsPerBlock - 1) / kWarpsPerBlock;  // a warp an entry at most
  return static_cast<unsigned>(want < blocks ? (want > 0 ? want : 1) : blocks);
}

template <typename TT, typename TA, bool kRowwise, int kVec>
int adagrad_launch_one(void* table, void* accum, const int64_t* sidx, const float* g, const int64_t* count,
                       const void* lr, int lr_bf16, int64_t k, int64_t rows, int e, float eps, cudaStream_t s) {
  auto* t = static_cast<TT*>(table);
  auto* a = static_cast<TA*>(accum);
  if constexpr (kVec == 4) {
    if (e <= 128) {
      using R = Ring<TT, TA, kRowwise>;
      static int ring_blocks[64] = {};  // resident on each device
      const unsigned grid = card_grid(adagrad_rows_ring<TT, TA, kRowwise>, R::kBlockBytes, k, ring_blocks);
      adagrad_rows_ring<TT, TA, kRowwise><<<grid, kThreads, R::kBlockBytes, s>>>(t, a, sidx, g, count, lr, lr_bf16,
                                                                                k, rows, e, eps);
      return cudaGetLastError();
    }
  }
  static int blocks[64] = {};  // resident on each device
  const unsigned grid = card_grid(adagrad_rows<TT, TA, kRowwise, kVec>, 0, k, blocks);
  adagrad_rows<TT, TA, kRowwise, kVec><<<grid, kThreads, 0, s>>>(t, a, sidx, g, count, lr, lr_bf16, k, rows, e, eps);
  return cudaGetLastError();
}

template <typename TT, typename TA>
int adagrad_launch(void* table, void* accum, const int64_t* sidx, const float* g, const int64_t* count,
                   const void* lr, int lr_bf16, int64_t k, int64_t rows, int e, float eps, int rowwise, int vec,
                   cudaStream_t s) {
  if (rowwise)
    return vec == 4 ? adagrad_launch_one<TT, TA, true, 4>(table, accum, sidx, g, count, lr, lr_bf16, k, rows, e, eps, s)
                    : adagrad_launch_one<TT, TA, true, 1>(table, accum, sidx, g, count, lr, lr_bf16, k, rows, e, eps, s);
  return vec == 4 ? adagrad_launch_one<TT, TA, false, 4>(table, accum, sidx, g, count, lr, lr_bf16, k, rows, e, eps, s)
                  : adagrad_launch_one<TT, TA, false, 1>(table, accum, sidx, g, count, lr, lr_bf16, k, rows, e, eps, s);
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
// `lr_dtype`. vec 4: e is a multiple of 4 and g, table and (AdaGrad) accum
// start on 4 elements, so a lane's columns take one 16-byte (float32) or
// 8-byte (bfloat16) access; else 1. Returns cudaGetLastError().
extern "C" int hctr_adagrad_rows(int table_dtype, int accum_dtype, void* table, void* accum, const void* sidx,
                                 const void* g, const void* count, const void* lr, int lr_dtype, int64_t k,
                                 int64_t rows, int e, float eps, int rowwise, int vec, void* stream) {
  if (k == 0 || e == 0) return cudaSuccess;
  if (vec != 1 && vec != 4) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int64_t*>(sidx);
  const auto* gx = static_cast<const float*>(g);
  const auto* cnt = static_cast<const int64_t*>(count);
  const int lr_bf16 = lr_dtype == hctr::kBF16;
  using bf16 = __nv_bfloat16;
  using hctr::adagrad_launch;
  if (table_dtype == hctr::kF32 && accum_dtype == hctr::kF32)
    return adagrad_launch<float, float>(table, accum, ix, gx, cnt, lr, lr_bf16, k, rows, e, eps, rowwise, vec, s);
  if (table_dtype == hctr::kBF16 && accum_dtype == hctr::kF32)
    return adagrad_launch<bf16, float>(table, accum, ix, gx, cnt, lr, lr_bf16, k, rows, e, eps, rowwise, vec, s);
  if (table_dtype == hctr::kF32 && accum_dtype == hctr::kBF16)
    return adagrad_launch<float, bf16>(table, accum, ix, gx, cnt, lr, lr_bf16, k, rows, e, eps, rowwise, vec, s);
  if (table_dtype == hctr::kBF16 && accum_dtype == hctr::kBF16)
    return adagrad_launch<bf16, bf16>(table, accum, ix, gx, cnt, lr, lr_bf16, k, rows, e, eps, rowwise, vec, s);
  return cudaErrorInvalidValue;
}
