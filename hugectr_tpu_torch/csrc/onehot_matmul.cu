// Pooled lookup and its weight gradient for the small-table (one-hot) engine.
//
// Replaces: hugectr_tpu/ops/pallas/onehot_matmul.py::onehot_matmul_fwd
// (body _fwd_kernel, tile _onehot_tile) and ::onehot_matmul_bwd (body
// _bwd_kernel), and around both the per-lookup placement of
// hugectr_tpu/embedding/collection.py (_slot_placement, _onehot_local_keys,
// _onehot_fwd, _onehot_grad_pallas: int32 cast, floor-mod wrap, mean
// division, concatenation, slicing).
//
//   forward:   out[b, :] = sum_h [0 <= keys[b,h] < V] * w[b,h] * table[keys[b,h], :]
//   backward:  grad[v, :] = sum_{b,h} [keys[b,h] == v] * w[b,h] * d[b, :]
//              cnt[v]     = sum_{b,h} [keys[b,h] == v] * |w[b,h]|
//
// w is 1 for an unweighted lookup. A weighted lookup (the JAX package's
// sp_weight_name, collection.py:1236-1300) passes float32 per-key weights
// [B, h] (any row stride): each hit adds w times its row, a Mean lookup
// divides by the sum of the weights of its non-padding keys (1 where that
// sum is 0, collection.py:538-554), the backward adds w times the
// cotangent, and the touch count of a row sums over the samples |the
// sample's summed weights on the row|, so that signed weights that cancel
// across samples still mark the row touched and a sample whose duplicate
// keys' weights cancel does not (collection.py:1383-1391).
//
// The TPU kernels build a [B, V] one-hot tile for the matrix unit, which
// costs 2 * B * V * E operations (31 GFLOP for a 7,424-row table at
// B = 16,384, E = 128). On an H100 most of the forward and the backward of
// tables whose keys are few per row are row moves instead; small tables of
// many keys per row take the matrix formulation on the tensor cores.
//
// Forward (onehot_fwd_group): one launch computes every lookup of a one-hot
// group and writes each into its columns [out_col, out_col + E) of the
// group's [B, W] output. Each lookup is a descriptor passed by value in the
// kernel's parameters (FwdGroup; no host-to-device copy): its keys' pointer
// (a column view of the batch's key tensor), row stride and type (int32, or
// int64 cut to int32 as the JAX package's astype does), h, V, the table's
// first row in the group storage, the output column, the combiner and the
// key window. In group mode a key is placed as the JAX package's
// _group_keys and _slot_placement place it: a windowed lookup (a tier of a
// split table, [key_lo, key_hi)) takes a key outside its window as padding
// and shifts one inside down by key_lo; then -1 is padding and any other
// key wraps by floor modulo into [0, V). In "local keys" mode (the per-table
// entry, hctr_onehot_fwd, the Pallas kernel's contract) any key outside
// [0, V) is padding. Sums are
// taken in float32, a Mean lookup divides by its count of non-padding keys
// (at least 1; a weighted one by the sum of their weights), and the output
// is rounded once to the table's type. A weighted lookup takes the gather
// route, whose lanes scale each row by its key's weight before the add.
// Bound: memory, each lookup's keys (B * h * key bytes), the touched table
// rows and the [B, W] output, at 3.35 TB/s: 0.0357 ms for the flagship's 13
// tables at B 16,384, E 128, float32, int32 keys (109.1 MB of output).
// Load balance: each lookup gets a range of blocks in proportion to B * h
// (a block finds its lookup by a scan over the ranges), so the lookup of
// h 40 is no longer the tail behind eight of h 1. The launch asks for at
// most 64 registers (four resident blocks of 8 warps an SM); the kernel's
// register count is the largest of its routes'. Routes per lookup, chosen
// by the launcher from V, h and E:
//   * gather: each warp takes a run of samples holding about kPairsPerWarp
//     (sample, key) pairs (fewer when that leaves SMs short of warps). A
//     lane owns four consecutive columns (16-byte lanes at E = 128). The 32
//     lanes read 32 keys at once, the next 32 while the rows of these are
//     added; rows are loaded kInFlight keys at a time before any is added,
//     so an h of 1 puts kInFlight samples in flight. A sample's sum is
//     written (streaming stores) when the next sample's first key comes up.
//   * counts matmul (V <= 128, 16 <= h <= 256, E a multiple of 8): the TPU
//     kernel's own formulation on the tensor cores. A block of 128 samples
//     forms the [128, V] counts tile in shared memory: one native shared
//     atomic per key on the 32-bit word that holds two 16-bit counts (small
//     integers, exact in bf16; bf16 atomics were the route's main cost). For
//     each 32-column slice it stages the table transposed in bf16, split
//     into hi, mid and lo terms when it is float32 (one term for bf16), and
//     each warp multiplies its 16 samples with mma.sync m16n8k16 (bf16 in,
//     float32 accumulate). A gather of h 40 reads 40 rows per sample
//     through L1 (335 MB at table 24); the matmul reads the table once per
//     128 samples. Beside other lookups a block takes two slices (64
//     columns) and forms their counts once, and these lookups' blocks come
//     first in the grid (last, the longest blocks would be its tail);
//     alone, a block per slice fills the card. A gather over the table
//     staged in shared memory was measured against it and lost to both
//     routes (PERF.md).
//
// Backward (onehot_bwd_group): one launch computes the weight gradient and
// touch counts of every lookup of a one-hot group from the forward's
// descriptors (raw keys, the window, the wrap, the Mean division, the
// weights) and the group's [B, W] cotangent read in place (lookup i's
// columns [out_col, out_col + e), any row stride), into the group's
// float32 [R, e] gradient and [R] counts. A Mean lookup's cotangent is
// divided by its sample's count of non-padding keys (a weighted one's by
// the sum of their weights, each rounded to d's type; 1 where that is 0)
// and rounded to d's type before use, as the JAX package divides in the
// table's type. Bound: memory, the keys, d (B * e * itemsize a lookup),
// grad and cnt: 0.0034 ms for table 20's superhot tier of bench.py (B
// 16,384, h 100, V 1,024, bf16 d). Power-law keys put about 4% of a tier's
// keys on its row 0: ~65,000 adds on each of its columns, which a scatter
// straight into device memory serialises in L2 (0.7238 ms at that tier
// before this design). Each lookup gets a range of blocks, counts-matmul
// lookups first, the most keys first; the launcher takes a route per
// lookup from B, h, V, e and the weights (thresholds beside bwd_route):
//   * Counts matmul, the TPU kernel's own formulation (_bwd_kernel):
//     countsT [V, B] @ d [B, e] on the tensor cores, whose cost does not
//     depend on how the keys are skewed. A block of 16 warps takes a tile
//     of 256 rows and 128 columns over a run of samples; per chunk of 64
//     samples it forms the [rows, samples] counts tile in shared memory
//     (one native shared atomic per key on the 32-bit word that holds two
//     16-bit counts: small integers, exact in bf16), stages the chunk's d
//     columns as hi (+ mid + lo) bf16 terms (float32 d is split as the
//     forward splits a float32 table), and each warp multiplies its 16
//     rows with mma.sync m16n8k16 (bf16 in, float32 accumulate; d
//     fragments by ldmatrix.trans). A warp skips a 16 x 16 block of counts
//     that is all zero. The touch counts are the counts tile's row sums,
//     one more product with a B operand of ones (exact in float32). The
//     next chunk's keys are copied into shared memory (cp.async, h up to
//     128) and its d loaded while this chunk is counted and multiplied.
//     Every tile reads all of its run's keys, so a lookup costs about (V /
//     256) x (e / 128) passes over its keys. Runs of samples fill the card once;
//     each run writes its partial tile, and the last run of a group of 8
//     to finish sums the group's partials in run order (then the last
//     group the groups' sums), so two calls give the same bits (unless two
//     lookups share rows: their adds meet in either order). Unweighted
//     lookups only: weights as 16-bit counts would not be exact.
//   * Privatised, when the table fits one block's dynamic shared memory
//     (float32 [V, e] plus a [V] count; 450 rows at e = 128 on an H100,
//     ~227 KB) and the batch brings at least kHotKeysPerRow keys per row.
//     Each block zeroes its private copy and walks a slice of the samples,
//     kBatch keys at a time per warp: keys add an exact integer count (one
//     shared atomic per distinct row of 32 keys, __match_any), and the warp
//     loads the d rows of kBatch keys at once, then adds them into the table
//     rows with shared float32 atomics, lane-strided columns so no two lanes
//     share a bank; then the block adds its touched rows into grad.
//   * Global atomics, for keys spread thin: each warp takes kBatch keys,
//     loads their d rows at once and adds them straight into grad,
//     lane-strided, so each atomic instruction covers 128 consecutive bytes.
// A weighted lookup takes the privatised or the global route: each key's
// cotangent scaled by its weight, and its sample's |summed weights on the
// row| added to the row's float32 count by the row's first key in the
// sample. Tables larger than a block's shared memory are not cut into
// privatised tiles: a power-law batch puts nearly all its keys into the
// first tile (7.9 ms at V 8,192, h 128 when such tiles were tried). The
// launcher zeroes grad and cnt with cudaMemsetAsync unless the caller
// accumulates into its own buffers. Counts are exact (integers below 2^24
// per row). The scatter routes' atomic order varies from run to run, so
// their grad agrees with a fixed-order sum only to a float32 rounding
// tolerance. The per-table entry (hctr_onehot_bwd, the Pallas kernel's
// contract) is the group kernel with one lookup in local-keys mode, and a
// last pass casts its float32 sums to bfloat16 when asked.
#include "common.cuh"

// One lookup of a forward group, as the Python wrapper passes it (ctypes
// structure of the same layout in ops/onehot_matmul.py).
struct hctr_fwd_lookup {
  const void* keys;    // key of sample 0, slot 0
  int64_t key_stride;  // elements from one sample's keys to the next
  int64_t row_off;     // the table's first row in the group storage
  int h, v, out_col;
  int mean;            // 1: divide by the count of non-padding keys
  int key64;           // 1: int64 keys (cut to int32), 0: int32
  int key_lo, key_hi;  // the window; windowed iff key_lo > 0 or key_hi >= 0 (-1: no upper bound)
  const float* weights;  // null: unweighted; else the weight of sample 0, slot 0 (float32)
  int64_t w_stride;      // elements from one sample's weights to the next
};

namespace hctr {
namespace {

enum FwdRoute { kGather = 0, kMma = 1 };
constexpr int kMaxLookups = 48;  // FwdGroup stays under 4 KB of kernel parameters (3.8 KB)

struct FwdLookup {
  const void* keys;
  const float* w;  // per-key weights, or null
  int64_t key_stride, row_off;
  int key_lo, key_last;  // keys outside [key_lo, key_last] are padding (INT32_MIN, INT32_MAX: none)
  int h, v, out_col, mean, key64, route;
  int first_block, samples_per_block;
  int mma_slices;  // counts matmul: kMmaCols-column slices per block
  int w_stride;
};

struct FwdGroup {
  FwdLookup lk[kMaxLookups];
  const void* table;  // group storage [rows, e]
  void* out;          // [b, ld]
  int n, b, e, ld, local_keys;
};
static_assert(sizeof(FwdGroup) <= 4096, "FwdGroup must fit the 4 KB of kernel parameters");

// The forward's constants were chosen by measuring variants of each on the
// flagship's group (PERF.md).
constexpr int kFwdWarps = 8;        // warps per block of the forward
constexpr int kFwdMinBlocks = 4;    // resident blocks an SM must take (caps registers at 64)
constexpr int kInFlight = 4;        // table rows a lane loads before adding them
constexpr int kPairsPerWarp = 32;   // most (sample, key) pairs per warp, gather route
constexpr int kMinPairsPerWarp = kInFlight;
constexpr int kWarpsPerSm = 64;     // resident warps an SM takes at most
constexpr int kMmaSamples = 16 * kFwdWarps;  // samples per block, counts matmul (16 a warp)
constexpr int kMmaCols = 32;        // output columns per slice, counts matmul
constexpr int kGroupSlices = 2;     // slices per block beside other lookups
constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic shared memory a launch gets without opting in
constexpr int kMmaMaxV = 128;
constexpr int kMmaMaxH = 256;       // counts up to h stay exact in bf16
constexpr unsigned kFull = 0xffffffffu;

// A key as the kernel reads it: int32, or int64 cut to int32 (two's
// complement, as the JAX package's astype(int32) without x64).
__device__ __forceinline__ int32_t raw_key(const FwdLookup& L, int64_t sample, int slot) {
  const int64_t i = sample * L.key_stride + slot;
  return L.key64 ? static_cast<int32_t>(static_cast<uint32_t>(
                       __ldg(static_cast<const long long*>(L.keys) + i)))
                 : __ldg(static_cast<const int32_t*>(L.keys) + i);
}

// Table-local row of key k, or -1 for padding: the window, then the
// shift by key_lo (the window's first key is row 0), then the wrap.
template <typename Lookup>
__device__ __forceinline__ int place_key(int32_t k, const Lookup& L, int local) {
  if (k < L.key_lo || k > L.key_last) return -1;
  if (L.key_lo > 0) k -= L.key_lo;
  const int v = L.v;
  if (static_cast<uint32_t>(k) < static_cast<uint32_t>(v)) return k;  // no division
  if (local || k == -1) return -1;  // local: outside [0, v); group: INVALID_KEY
  const int m = k % v;  // % truncates toward zero; the wrap is a floor modulo
  return m < 0 ? m + v : m;
}

// Gather-pool of `ns` samples from `s_begin` by one warp, over the
// lookup's table `tab`. The keys of the next 32 pairs are loaded before the
// rows of the current 32 are added. kWeighted: each row is scaled by its
// key's weight, and a Mean divides by the sum of the weights.
template <typename T, int kVec, bool kWeighted>
__device__ void gather_samples(const FwdGroup& p, const FwdLookup& L, const T* tab,
                               int64_t s_begin, int ns, int lane) {
  const int h = L.h, e = p.e;
  const int npairs = ns * h;
  T* out = static_cast<T*>(p.out) + s_begin * p.ld + L.out_col;
  auto load = [&](int pr, int& smp, float& wt) -> int32_t {
    smp = -1;
    wt = 0.f;
    if (pr >= npairs) return -1;
    smp = pr / h;
    if constexpr (kWeighted) wt = __ldg(L.w + (s_begin + smp) * L.w_stride + (pr - smp * h));
    return raw_key(L, s_begin + smp, pr - smp * h);
  };
  for (int cbase = 0; cbase < e; cbase += 32 * kVec) {
    const int c0 = cbase + lane * kVec;
    const bool col_ok = c0 < e;
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
    int cur = 0, nval = 0;
    float wsum = 0.f;  // kWeighted: the sum of the sample's non-padding keys' weights
    auto flush = [&]() {
      if (!col_ok) return;
      float sc = 1.f;
      if (L.mean) {
        if constexpr (kWeighted) {
          sc = 1.f / (wsum == 0.f ? 1.f : wsum);
        } else {
          sc = 1.f / static_cast<float>(nval > 1 ? nval : 1);
        }
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] *= sc;
      T* o = out + static_cast<int64_t>(cur) * p.ld + c0;
      if constexpr (kVec == 4 && sizeof(T) == 4) {
        __stcs(reinterpret_cast<float4*>(o), make_float4(acc[0], acc[1], acc[2], acc[3]));
      } else {
        store_vec<kVec>(o, acc);
      }
    };
    int next_smp;
    float next_w;
    int32_t next_key = load(lane, next_smp, next_w);
    for (int p0 = 0; p0 < npairs; p0 += 32) {
      const int smp = next_smp;
      const float wt = next_w;
      const int row = smp < 0 ? -1 : place_key(next_key, L, p.local_keys);
      next_key = load(p0 + 32 + lane, next_smp, next_w);
      const int m = npairs - p0 < 32 ? npairs - p0 : 32;
      for (int q0 = 0; q0 < m; q0 += kInFlight) {
        int r[kInFlight], sq[kInFlight];
        float x[kInFlight][kVec];
        float wq[kInFlight];
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          r[q] = __shfl_sync(kFull, row, q0 + q);
          sq[q] = __shfl_sync(kFull, smp, q0 + q);
          if constexpr (kWeighted) wq[q] = __shfl_sync(kFull, wt, q0 + q);
        }
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          if (r[q] >= 0 && col_ok) {
            load_vec<kVec>(tab + static_cast<int64_t>(r[q]) * e + c0, x[q]);
          } else {
#pragma unroll
            for (int i = 0; i < kVec; ++i) x[q][i] = 0.f;
          }
        }
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          if (sq[q] < 0) continue;  // past the warp's last pair
          if (sq[q] != cur) {       // warp-uniform: the shuffled sample changed
            flush();
#pragma unroll
            for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
            cur = sq[q];
            nval = 0;
            wsum = 0.f;
          }
          if constexpr (kWeighted) {
#pragma unroll
            for (int i = 0; i < kVec; ++i) acc[i] += x[q][i] * wq[q];
            if (r[q] >= 0) wsum += wq[q];
          } else {
#pragma unroll
            for (int i = 0; i < kVec; ++i) acc[i] += x[q][i];
          }
          nval += r[q] >= 0;
        }
      }
    }
    flush();
  }
}

// c += a [16 x 16] * b [16 x 8], bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two 16-bit integer counts -> the same values as a bf16 pair (exact to 256).
__device__ __forceinline__ uint32_t counts_bf16(uint32_t w) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(static_cast<float>(w & 0xffffu),
                                                 static_cast<float>(w >> 16));
  return *reinterpret_cast<const uint32_t*>(&b);
}

// Row stride (elements) of the counts tile and of the transposed table
// slice: 8 bf16 past a multiple of 16, so a quad's fragment loads hit
// distinct banks.
__host__ __device__ __forceinline__ int mma_stride(int v) { return ((v + 15) & ~15) + 8; }

// Shared memory of one counts-matmul block: the [kMmaSamples, stride]
// counts tile, the table's column slice as kTerms transposed
// [kMmaCols, stride] bf16 tiles, and the samples' key counts.
__host__ __device__ inline size_t mma_smem_bytes(int v, int terms) {
  return static_cast<size_t>(kMmaSamples + terms * kMmaCols) * mma_stride(v) * 2 +
         kMmaSamples * sizeof(int);
}

// Counts matmul of samples [s0, s0 + kMmaSamples) of one lookup, output
// column slices [slice0, slice1) of kMmaCols. The block forms the
// [samples, V] counts tile once (a native shared atomic per key on the
// 32-bit word that holds its 16-bit count; small integers, exact in bf16),
// then for each slice stages the table's columns transposed as hi (+ mid +
// lo) bf16 terms and each warp multiplies its 16 samples on the tensor
// cores.
template <typename T>
__device__ void mma_block(const FwdGroup& p, const FwdLookup& L, unsigned char* smem, int64_t s0,
                          int slice0, int slice1) {
  constexpr int kTerms = sizeof(T) == 4 ? 3 : 1;
  constexpr int kSlice = kMmaMaxV * kMmaCols / (kFwdWarps * 32);  // table values a thread stages
  const int v = L.v, e = p.e, h = L.h, vpad = (v + 15) & ~15, ks = mma_stride(v);
  uint32_t* cw = reinterpret_cast<uint32_t*>(smem);  // [kMmaSamples][ks] 16-bit counts
  __nv_bfloat16* bt = reinterpret_cast<__nv_bfloat16*>(cw + kMmaSamples * ks / 2);  // [kTerms][kMmaCols][ks]
  int* nval = reinterpret_cast<int*>(bt + kTerms * kMmaCols * ks);
  const T* tab = static_cast<const T*>(p.table) + L.row_off * e;
  float x[kSlice];
  auto load_slice = [&](int c0) {
#pragma unroll
    for (int u = 0; u < kSlice; ++u) {
      const int i = threadIdx.x + u * kFwdWarps * 32, k = i / kMmaCols, n = i % kMmaCols;
      x[u] = k < v && c0 + n < e ? to_f32(tab[static_cast<int64_t>(k) * e + c0 + n]) : 0.f;
    }
  };
  auto store_slice = [&]() {
#pragma unroll
    for (int u = 0; u < kSlice; ++u) {
      const int i = threadIdx.x + u * kFwdWarps * 32, k = i / kMmaCols, n = i % kMmaCols;
      if (k >= vpad) continue;
#pragma unroll
      for (int t = 0; t < kTerms; ++t) {
        const __nv_bfloat16 y = __float2bfloat16(x[u]);
        bt[(t * kMmaCols + n) * ks + k] = y;
        x[u] -= __bfloat162float(y);
      }
    }
  };
  const int64_t left = p.b - s0;
  const int ns = left < kMmaSamples ? static_cast<int>(left) : kMmaSamples;
  const int npairs = ns * h;
  constexpr int kLoads = 8;  // key loads in flight per thread
  int32_t key[kLoads];
  int sm[kLoads];
  auto load_keys = [&](int p0) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int pr = p0 + u * kFwdWarps * 32 + threadIdx.x;
      sm[u] = pr < npairs ? pr / h : -1;
      key[u] = sm[u] >= 0 ? raw_key(L, s0 + sm[u], pr - sm[u] * h) : -1;
    }
  };
  // every load in flight before its first use: the first slice, the first keys
  load_slice(slice0 * kMmaCols);
  load_keys(0);
  for (int i = threadIdx.x; i < kMmaSamples * ks / 2; i += blockDim.x) cw[i] = 0u;
  for (int i = threadIdx.x; i < kMmaSamples; i += blockDim.x) nval[i] = 0;
  store_slice();
  __syncthreads();
  for (int p0 = 0; p0 < npairs; p0 += kLoads * kFwdWarps * 32) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int r = sm[u] < 0 ? -1 : place_key(key[u], L, p.local_keys);
      if (r >= 0) {
        atomicAdd(cw + (sm[u] * ks + r) / 2, 1u << (16 * (r & 1)));
        if (L.mean) atomicAdd(nval + sm[u], 1);
      }
    }
    load_keys(p0 + kLoads * kFwdWarps * 32);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3, m0 = warp * 16;
  float sc[2] = {1.f, 1.f};
  if (L.mean) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int nv = m0 + g + half * 8 < ns ? nval[m0 + g + half * 8] : 1;
      sc[half] = 1.f / static_cast<float>(nv > 1 ? nv : 1);
    }
  }
  for (int slice = slice0; slice < slice1; ++slice) {
    const int c0 = slice * kMmaCols;
    const int ntiles = (e - c0 < kMmaCols ? e - c0 : kMmaCols) / 8;
    if (slice > slice0) {  // the next slice, once every warp is done with this one
      load_slice(c0);
      __syncthreads();
      store_slice();
      __syncthreads();
    }
    if (m0 >= ns) continue;
    float acc[kMmaCols / 8][4] = {};
    for (int k0 = 0; k0 < vpad; k0 += 16) {
      const uint32_t* a = cw + ((m0 + g) * ks + k0 + tq * 2) / 2;
      const uint32_t af[4] = {counts_bf16(a[0]), counts_bf16(a[4 * ks]), counts_bf16(a[4]),
                              counts_bf16(a[4 * ks + 4])};
#pragma unroll
      for (int j = 0; j < kMmaCols / 8; ++j) {
        if (j >= ntiles) break;
#pragma unroll
        for (int t = kTerms - 1; t >= 0; --t) {  // smallest term first
          const __nv_bfloat16* b = bt + (t * kMmaCols + j * 8 + g) * ks + k0 + tq * 2;
          mma_bf16(acc[j], af, ld_u32(b), ld_u32(b + 8));
        }
      }
    }
    T* out = static_cast<T*>(p.out) + (s0 + m0) * p.ld + L.out_col + c0 + tq * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = g + half * 8;
      if (m0 + m >= ns) continue;
#pragma unroll
      for (int j = 0; j < kMmaCols / 8; ++j) {
        if (j >= ntiles) break;
        T* o = out + static_cast<int64_t>(m) * p.ld + j * 8;
        o[0] = from_f32<T>(acc[j][half * 2] * sc[half]);
        o[1] = from_f32<T>(acc[j][half * 2 + 1] * sc[half]);
      }
    }
  }
}

// One launch for every lookup of a group: block ranges per lookup.
template <typename T, int kVec>
__global__ void __launch_bounds__(kFwdWarps * 32, kFwdMinBlocks)
onehot_fwd_group(const __grid_constant__ FwdGroup p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int li = 0;
  while (li + 1 < p.n && static_cast<int>(blockIdx.x) >= p.lk[li + 1].first_block) ++li;
  const FwdLookup& L = p.lk[li];
  const int local = static_cast<int>(blockIdx.x) - L.first_block;
  if (L.route == kMma) {
    const int slices = (p.e + kMmaCols - 1) / kMmaCols, per = slices / L.mma_slices;
    const int slice0 = local % per * L.mma_slices;
    mma_block<T>(p, L, smem, static_cast<int64_t>(local / per) * kMmaSamples, slice0,
                 slice0 + L.mma_slices);
    return;
  }
  const int64_t s0 = static_cast<int64_t>(local) * L.samples_per_block;
  const T* tab = static_cast<const T*>(p.table) + L.row_off * p.e;
  const int spw = L.samples_per_block / kFwdWarps;
  const int64_t sb = s0 + static_cast<int64_t>(threadIdx.x >> 5) * spw;
  const int64_t left = p.b - sb;
  if (left <= 0) return;
  const int ns = left < spw ? static_cast<int>(left) : spw;
  if (L.w != nullptr) {
    gather_samples<T, kVec, true>(p, L, tab, sb, ns, threadIdx.x & 31);
  } else {
    gather_samples<T, kVec, false>(p, L, tab, sb, ns, threadIdx.x & 31);
  }
}

// ------------------------------------------------------------------ backward

enum BwdRoute { kGlobal = 0, kPrivatised = 1, kCountsMma = 2 };
constexpr int kFlagMean = 1, kFlagKey64 = 2, kFlagDVec = 4;

// One lookup of a backward group (76 bytes: 48 of them stay under the 4 KB
// of kernel parameters). Route parameters p0..p3:
//   counts matmul: p0 column slices, p1 sample runs, p2 samples per run,
//                  p3 the lookup's first partial slot (and counter) in the
//                  launch's scratch: runs + ceil(runs / kGroupRuns) a tile
//                  when runs > 1;
//   privatised:    p2 samples per block;
//   global:        none.
struct BwdLookup {
  const void* keys;
  const float* w;  // per-key weights, or null
  int key_stride, w_stride, row_off, v, h, d_col;
  int key_lo, key_last;  // keys outside [key_lo, key_last] are padding
  int flags, route, first_block, blocks;
  int p0, p1, p2, p3;
};

struct BwdGroup {
  BwdLookup lk[kMaxLookups];
  const void* d;      // cotangents [b, ld]: lookup i reads columns [d_col, d_col + e)
  float* grad;        // [rows, e] float32
  float* cnt;         // [rows] float32
  float* part;        // counts matmul: [slots][kPart] partial sums
  int* counters;      // counts matmul: [slots] finished runs of a group of runs, or groups of a tile
  int n, b, e, ld, local_keys;
};
static_assert(sizeof(BwdGroup) <= 4096, "BwdGroup must fit the 4 KB of kernel parameters");

// Element i of a lookup's key tensor, cut to int32.
__device__ __forceinline__ int32_t key_at(const BwdLookup& L, int64_t i) {
  return (L.flags & kFlagKey64) ? static_cast<int32_t>(static_cast<uint32_t>(
                                      __ldg(static_cast<const long long*>(L.keys) + i)))
                                : __ldg(static_cast<const int32_t*>(L.keys) + i);
}

__device__ __forceinline__ int32_t raw_key(const BwdLookup& L, int64_t sample, int slot) {
  return key_at(L, sample * L.key_stride + slot);
}

// place_key with a short path for a key that lands in [0, v) without the
// wrap (in its window, shifted down by the window's start `lo`).
__device__ __forceinline__ int bwd_row(int32_t k, const BwdLookup& L, int lo, int local) {
  const uint32_t r = static_cast<uint32_t>(k) - static_cast<uint32_t>(lo);
  if (r < static_cast<uint32_t>(L.v) && k >= L.key_lo && k <= L.key_last) return static_cast<int>(r);
  return place_key(k, L, local);
}

// The first key of a lookup's window (0 without one).
__device__ __forceinline__ int window_lo(const BwdLookup& L) { return L.key_lo == INT32_MIN ? 0 : L.key_lo; }

constexpr int kBwdWarps = 16;         // warps per block, every route (the counts matmul's 256-row tile)
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kBwdMinBlocks = 1;      // resident blocks an SM must take (caps registers at 128)
constexpr int kBwdCols = 4;           // columns per lane per pass, scatter routes
constexpr int kBatch = 8;             // keys whose d rows a warp loads at once, scatter routes
constexpr int kFlushRatio = 16;       // privatised: keys per table row of a slice, past one block per SM
constexpr int kGlobalMaxBlocks = 2048;  // global: most blocks of one lookup (they stride over its keys)
// counts matmul
constexpr int kRT = 16 * kBwdWarps;   // table rows per tile: 16 a warp
constexpr int kCT = 128;              // columns per slice: each slice reads all its run's keys again
constexpr int kS = 64;                // samples per chunk
constexpr int kCtWords = (kS + 8) / 2;  // 32-bit words per counts row: two 16-bit counts each, 8 halves of padding
constexpr int kDs = kCT + 8;          // bf16 per staged d row (8 of padding: ldmatrix rows on distinct banks)
constexpr int kPart = kRT * kCT + kRT;  // floats of one partial: [kRT, kCT] sums and [kRT] counts
constexpr int kMmaBwdMaxH = 128;      // counts matmul: a chunk's keys are staged in shared memory up to this h
constexpr int kGroupRuns = 8;         // partials one block sums, at each of the two levels
constexpr int kDVals = kS * kCT / kBwdThreads;  // d values a thread stages per chunk (16)
constexpr uint32_t kOnesBf16x2 = 0x3F803F80u;  // two bf16 1.0: the counts column's B operand

__host__ __device__ inline size_t mma_bwd_smem(int terms) {  // one counts tile, two of keys and of d
  return static_cast<size_t>(kRT) * kCtWords * 4 + kS * sizeof(int) +
         2 * (static_cast<size_t>(terms) * kS * kDs * 2 + static_cast<size_t>(kS) * kMmaBwdMaxH * 4);
}

// The cotangent of key (sample s) as the kernel adds it: Mean divides by
// `den` and rounds to T, as the JAX package divides in the table's type;
// then the weight scales it.
template <typename T>
__device__ __forceinline__ float d_value(T x, float den, float wt) {
  float y = to_f32(x);
  if (den != 1.f) y = to_f32(from_f32<T>(y / den));
  return y * wt;
}

// Key j of a sample whose first key is element `base` of the key tensor,
// and its row (or -1).
__device__ __forceinline__ int sample_row(const BwdLookup& L, int64_t base, int j, int local) {
  return bwd_row(key_at(L, base + j), L, window_lo(L), local);
}

// The Mean divisor of sample s: its count of non-padding keys, or for a
// weighted lookup the sum of their weights each rounded to T, summed in
// float32 and rounded to T (1 where it is 0); O(h) reads, cached in L1.
template <typename T>
__device__ float sample_den(const BwdLookup& L, int s, int local) {
  const int64_t base = static_cast<int64_t>(s) * L.key_stride;
  const float* w = L.w == nullptr ? nullptr : L.w + static_cast<int64_t>(s) * L.w_stride;
  float sum = 0.f;
  int nval = 0;
  for (int j = 0; j < L.h; ++j) {
    if (sample_row(L, base, j, local) < 0) continue;
    ++nval;
    if (w != nullptr) sum += to_f32(from_f32<T>(__ldg(w + j)));
  }
  if (w == nullptr) return to_f32(from_f32<T>(static_cast<float>(nval > 1 ? nval : 1)));
  const float den = to_f32(from_f32<T>(sum));
  return den == 0.f ? 1.f : den;
}

// The touch count key (s, slot) of row `row` adds in a weighted backward:
// the JAX package's sum over samples of |a sample's summed weights on the
// row|. The row's first key in the sample adds |the sum of the weights of
// the sample's keys on that row| and a later one nothing, so a sample whose
// duplicates' weights cancel does not touch the row. O(h) reads.
__device__ float sample_touch(const BwdLookup& L, int s, int slot, int row, int local) {
  const int64_t base = static_cast<int64_t>(s) * L.key_stride;
  const float* w = L.w + static_cast<int64_t>(s) * L.w_stride;
  for (int j = 0; j < slot; ++j)
    if (sample_row(L, base, j, local) == row) return 0.f;
  float sum = __ldg(w + slot);
  for (int j = slot + 1; j < L.h; ++j)
    if (sample_row(L, base, j, local) == row) sum += __ldg(w + j);
  return fabsf(sum);
}

// Adds the cotangent rows of the warp's keys marked in `m` (a warp-uniform
// ballot) into rows `row` of dst [*, e], where lane j holds key j's row,
// sample, weight and Mean divisor. Lane-strided columns: every atomic
// instruction of the warp covers 128 consecutive bytes, and no two lanes
// share a shared-memory bank. The d rows of kBatch keys are loaded before
// their adds.
template <typename T>
__device__ __forceinline__ void add_rows(const BwdGroup& p, const BwdLookup& L, unsigned m, int row,
                                         int sample, float wt, float den, float* dst, int lane) {
  const T* d = static_cast<const T*>(p.d) + L.d_col;
  const int e = p.e;
  while (m) {
    int r[kBatch], s[kBatch];
    float wq[kBatch], dq[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const bool ok = m != 0;
      const int j = ok ? __ffs(m) - 1 : 0;
      r[q] = __shfl_sync(kFull, row, j);
      s[q] = __shfl_sync(kFull, sample, j);
      wq[q] = __shfl_sync(kFull, wt, j);
      dq[q] = __shfl_sync(kFull, den, j);
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
          x[q][i] = r[q] >= 0 && c < e ? d_value(__ldg(d + static_cast<int64_t>(s[q]) * p.ld + c), dq[q], wq[q])
                                       : 0.f;
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

// One warp's 32 keys of the scatter routes, from flat key index f (sample
// f / h): adds each key's touch into `cnt` (rows of the lookup) and its
// cotangent row into `dst`. `live` lanes hold a key.
template <typename T>
__device__ __forceinline__ void scatter_keys(const BwdGroup& p, const BwdLookup& L, int f, bool live,
                                             float* dst, float* cnt, bool shared_cnt, int lane) {
  int row = -1, s = 0;
  float wt = 1.f, den = 1.f;
  if (live) {
    s = f / L.h;
    const int slot = f - s * L.h;
    row = bwd_row(raw_key(L, s, slot), L, window_lo(L), p.local_keys);
    if (row >= 0) {
      if (L.w != nullptr) {
        wt = __ldg(L.w + static_cast<int64_t>(s) * L.w_stride + slot);
        const float t = sample_touch(L, s, slot, row, p.local_keys);
        if (t != 0.f) atomicAdd(cnt + row, t);
      }
      if (L.flags & kFlagMean) den = sample_den<T>(L, s, p.local_keys);
    }
  }
  if (L.w == nullptr) {  // one count add per distinct row of the 32 keys
    const unsigned peers = __match_any_sync(kFull, row);
    if (row >= 0 && lane == __ffs(peers) - 1) {
      if (shared_cnt) {
        atomicAdd(reinterpret_cast<int*>(cnt) + row, __popc(peers));
      } else {
        atomicAdd(cnt + row, static_cast<float>(__popc(peers)));
      }
    }
  }
  add_rows<T>(p, L, __ballot_sync(kFull, row >= 0), row, s, wt, den, dst, lane);
}

// Privatised: the lookup's whole table in shared memory ([v, e] float32
// sums, then [v] counts: int, or float32 for a weighted lookup); the block
// takes samples [slice * p2, +p2), then adds its touched rows into grad.
template <typename T>
__device__ void privatised_block(const BwdGroup& p, const BwdLookup& L, float* part, int slice) {
  const int v = L.v, e = p.e, h = L.h;
  float* scnt = part + static_cast<int64_t>(v) * e;
  for (int i = threadIdx.x; i < v * e; i += kBwdThreads) part[i] = 0.f;
  for (int i = threadIdx.x; i < v; i += kBwdThreads) scnt[i] = 0.f;  // 0 bits: int 0 too
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s0 = slice * L.p2;
  const int s1 = s0 + L.p2 < p.b ? s0 + L.p2 : p.b;
  const int f1 = s1 * h;
  for (int g = s0 * h + warp * 32; g < f1; g += kBwdThreads)
    scatter_keys<T>(p, L, g + lane, g + lane < f1, part, scnt, L.w == nullptr, lane);
  __syncthreads();
  for (int r = warp; r < v; r += kBwdWarps) {
    const float n = L.w != nullptr ? scnt[r] : static_cast<float>(reinterpret_cast<int*>(scnt)[r]);
    if (n == 0.f) continue;
    float* grow = p.grad + static_cast<int64_t>(L.row_off + r) * e;
    for (int c = lane; c < e; c += 32) atomicAdd(grow + c, part[r * e + c]);
    if (lane == 0) atomicAdd(p.cnt + L.row_off + r, n);
  }
}

// Global atomics: each warp takes kBatch keys at a time (lanes 0..kBatch-1
// load them, so a batch has many warps in flight) and adds their rows
// straight into grad.
template <typename T>
__device__ void global_block(const BwdGroup& p, const BwdLookup& L, int local) {
  const int lane = threadIdx.x & 31;
  const int n = p.b * L.h;  // below 2^31: the launcher checks
  const int stride = L.blocks * kBwdWarps * kBatch;
  float* grad = p.grad + static_cast<int64_t>(L.row_off) * p.e;
  float* cnt = p.cnt + L.row_off;
  for (int g = (local * kBwdWarps + (threadIdx.x >> 5)) * kBatch; g < n; g += stride)
    scatter_keys<T>(p, L, g + lane, lane < kBatch && g + lane < n, grad, cnt, false, lane);
}

// An asynchronous 4-byte copy from device to shared memory, and its groups.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending)); }

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Whether this block is the last of `n` to arrive at `counter`, after its
// writes are visible to the others (they read them through L2).
__device__ __forceinline__ bool last_to_arrive(int* counter, int n) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == n - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Sums n partial tiles from `src` (kPart floats apart) in order: into
// `dst` (a partial tile) or, without one, into the tile's rows of grad and
// cnt (rows < v, columns < e; the counts only for the first column slice).
__device__ void sum_partials(const float* src, int n, float* dst, const BwdGroup& p, const BwdLookup& L, int r0,
                             int c0, bool with_cnt, int live_rows) {
  const int e = p.e;
  for (int i = threadIdx.x; i < live_rows * kCT / 4; i += kBwdThreads) {
    const int row = r0 + i / (kCT / 4), col = c0 + i % (kCT / 4) * 4;
    if (dst == nullptr && (row >= L.v || col >= e)) continue;
    float4 s = __ldcg(reinterpret_cast<const float4*>(src) + i);
    for (int r = 1; r < n; ++r) {  // in order: the same bits every call
      const float4 y = __ldcg(reinterpret_cast<const float4*>(src + static_cast<int64_t>(r) * kPart) + i);
      s.x += y.x;
      s.y += y.y;
      s.z += y.z;
      s.w += y.w;
    }
    if (dst != nullptr) {
      reinterpret_cast<float4*>(dst)[i] = s;
      continue;
    }
    float* o = p.grad + static_cast<int64_t>(L.row_off + row) * e + col;
    if (s.x != 0.f) atomicAdd(o, s.x);
    if (s.y != 0.f) atomicAdd(o + 1, s.y);
    if (s.z != 0.f) atomicAdd(o + 2, s.z);
    if (s.w != 0.f) atomicAdd(o + 3, s.w);
  }
  if (!with_cnt) return;
  for (int i = threadIdx.x; i < live_rows; i += kBwdThreads) {
    if (dst == nullptr && r0 + i >= L.v) continue;
    float s = __ldcg(src + kRT * kCT + i);
    for (int r = 1; r < n; ++r) s += __ldcg(src + static_cast<int64_t>(r) * kPart + kRT * kCT + i);
    if (dst != nullptr) {
      dst[kRT * kCT + i] = s;
    } else if (s != 0.f) {
      atomicAdd(p.cnt + L.row_off + r0 + i, s);
    }
  }
}

// Counts-transpose product, the TPU kernel's own formulation: block `local`
// takes tile (row tile, column slice) and sample run local % runs. Per
// chunk of kS samples it forms the [kRT rows, kS samples] counts tile in
// shared memory (one native shared atomic per key on the 32-bit word that
// holds its 16-bit count: small integers, exact in bf16 up to h 256), stages
// the chunk's d columns as hi (+ mid + lo) bf16 terms, and each warp
// multiplies its 16 rows on the tensor cores (mma.sync m16n8k16, bf16 in,
// float32 accumulate; d fragments by ldmatrix.trans). A warp whose 16 x 16
// counts block is zero skips it. The touch counts are the counts tile's
// row sums: one more product with a B operand of ones, exact in float32.
// With one run the block adds its sums into grad; with more, it writes its
// partial, and the run that finishes a tile last sums the tile's partials
// in run order into grad, so two calls give the same bits.
template <typename T>
__device__ void mma_bwd_block(const BwdGroup& p, const BwdLookup& L, unsigned char* smem, int local) {
  constexpr int kTerms = sizeof(T) == 4 ? 3 : 1;
  const int slices = L.p0, runs = L.p1, run_samples = L.p2;
  const int run = local % runs, tile = local / runs;
  const int r0 = tile / slices * kRT, c0 = tile % slices * kCT;
  const int e = p.e, h = L.h, v = L.v;
  const bool mean = L.flags & kFlagMean, with_cnt = c0 == 0;
  const int64_t s_begin = static_cast<int64_t>(run) * run_samples;
  const int64_t s_end = s_begin + run_samples < p.b ? s_begin + run_samples : p.b;
  uint32_t* ct = reinterpret_cast<uint32_t*>(smem);  // [kRT][kCtWords]
  int* nval = reinterpret_cast<int*>(ct + kRT * kCtWords);  // [kS]
  int32_t* kst = nval + kS;  // [2][kS * h] the chunks' keys (int32, or an int64 key's low word)
  __nv_bfloat16* ds = reinterpret_cast<__nv_bfloat16*>(kst + 2 * kS * kMmaBwdMaxH);  // [2][kTerms][kS][kDs]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3, m0 = warp * 16;
  const int ntiles = (e - c0 < kCT ? e - c0 : kCT) / 8;
  // rows of the tile that keys can reach (a warp past them reads zeros)
  const int live_rows = ((v - r0 < kRT ? v - r0 : kRT) + 15) & ~15;
  const T* d = static_cast<const T*>(p.d) + L.d_col + c0;
  const int ds_s = tid / (kCT / kDVals), ds_c = tid % (kCT / kDVals) * kDVals;  // this thread's d values
  const bool dvec = L.flags & kFlagDVec;
  float x[kDVals];
  auto load_d = [&](int64_t s0, int ns) {
    const T* src = d + (s0 + ds_s) * p.ld + ds_c;
#pragma unroll
    for (int i = 0; i < kDVals; i += 4) {
      const bool ok = ds_s < ns && c0 + ds_c + i < e;  // e % 8 == 0: four at a time
      if (ok && dvec) {
        float y[4];
        load_vec<4>(src + i, y);
#pragma unroll
        for (int u = 0; u < 4; ++u) x[i + u] = y[u];
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) x[i + u] = ok ? to_f32(__ldg(src + i + u)) : 0.f;
      }
    }
  };
  float acc[kCT / 8][4] = {};
  float accn[4] = {};
  // chunk c uses keys kst[c & 1] and staged d ds[c & 1]: the next chunk's
  // keys are copied into shared memory (cp.async) and its d loaded while
  // this chunk is counted and multiplied; the counts tile is zeroed after
  // each chunk's products
  const int step_s = kBwdThreads / h, step_r = kBwdThreads - step_s * h, lo = window_lo(L);
  const int64_t step_off = static_cast<int64_t>(step_s) * L.key_stride + step_r;
  const int cs0 = tid / h, cr0 = tid - cs0 * h;
  const int kshift = (L.flags & kFlagKey64) ? 3 : 2;  // bytes of a key: int64 keys' low words are their cut
  auto chunk_len = [&](int64_t cb) { return s_end - cb < kS ? static_cast<int>(s_end - cb) : kS; };
  // the chunk's keys into kst[b]: pairs tid, tid + T, ... stepped without a division
  auto copy_keys = [&](int64_t cb, int b) {  // the chunk of samples from cb
    const int n = chunk_len(cb) * h;
    int cs = cs0, cr = cr0;
    int64_t off = (cb + cs) * L.key_stride + cr;
    for (int pr = tid; pr < n; pr += kBwdThreads) {
      cp_async4(kst + b * kS * kMmaBwdMaxH + pr, static_cast<const char*>(L.keys) + (off << kshift));
      cs += step_s;
      cr += step_r;
      off += step_off;
      if (cr >= h) {
        cr -= h;
        ++cs;
        off += L.key_stride - h;
      }
    }
    cp_async_commit();
  };
  copy_keys(s_begin, 0);
  int ns = chunk_len(s_begin);
  load_d(s_begin, ns);
  for (int i = tid; i < live_rows * kCtWords; i += kBwdThreads) ct[i] = 0u;
  if (tid < kS) nval[tid] = 0;
  int buf = 0;
  for (int64_t s0 = s_begin; s0 < s_end; s0 += kS, buf ^= 1) {
    uint32_t* ctb = ct;
    int* nvb = nval;
    const int32_t* kb = kst + buf * kS * kMmaBwdMaxH;
    __nv_bfloat16* dsb = ds + buf * kTerms * kS * kDs;
    const int cns = ns;
    const bool more = s0 + kS < s_end;
    if (more) {
      copy_keys(s0 + kS, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the chunk's keys are in; its counts are zero; the last chunk's products are done
    // the chunk's counts
    const int npairs = cns * h;
    int cs = cs0, cr = cr0;
    for (int q = 0; q + (tid & ~31) < npairs; q += kBwdThreads) {  // warp-uniform
      const int pr = q + tid;
      const int r = pr < npairs ? bwd_row(kb[pr], L, lo, p.local_keys) : -1;
      if (mean) {  // non-padding keys per sample, one add per sample of the warp
        const unsigned peers = __match_any_sync(kFull, r >= 0 ? cs : -1);
        if (r >= 0 && lane == __ffs(peers) - 1) atomicAdd(nvb + cs, __popc(peers));
      }
      const int rl = r - r0;
      if (r >= 0 && rl < kRT && rl >= 0) atomicAdd(ctb + rl * kCtWords + cs / 2, 1u << (16 * (cs & 1)));
      cs += step_s;
      cr += step_r;
      if (cr >= h) {
        cr -= h;
        ++cs;
      }
    }
    __syncthreads();  // the chunk's counts are whole
    {  // stage the chunk's d: Mean-divided and rounded to T, split into bf16 terms
      float den = 1.f;
      if (mean && ds_s < cns) {
        const int nv = nvb[ds_s];
        den = to_f32(from_f32<T>(static_cast<float>(nv > 1 ? nv : 1)));
      }
#pragma unroll
      for (int i = 0; i < kDVals; ++i) x[i] = d_value(from_f32<T>(x[i]), den, 1.f);
#pragma unroll
      for (int t = 0; t < kTerms; ++t) {
        uint32_t packed[kDVals / 2];
#pragma unroll
        for (int i = 0; i < kDVals; i += 2) {
          const __nv_bfloat162 y = __floats2bfloat162_rn(x[i], x[i + 1]);
          x[i] -= __low2float(y);
          x[i + 1] -= __high2float(y);
          packed[i / 2] = *reinterpret_cast<const uint32_t*>(&y);
        }
        uint4* dst = reinterpret_cast<uint4*>(dsb + (t * kS + ds_s) * kDs + ds_c);
#pragma unroll
        for (int i = 0; i < kDVals / 8; ++i)
          dst[i] = make_uint4(packed[4 * i], packed[4 * i + 1], packed[4 * i + 2], packed[4 * i + 3]);
      }
    }
    if (more) {  // the next chunk: its d in flight
      ns = chunk_len(s0 + kS);
      load_d(s0 + kS, ns);
    }
    __syncthreads();  // the chunk's d is staged
    for (int k0 = 0; k0 < cns && m0 < live_rows; k0 += 16) {
      const uint32_t* a = ctb + (m0 + g) * kCtWords + k0 / 2 + tq;
      const uint32_t af[4] = {counts_bf16(a[0]), counts_bf16(a[8 * kCtWords]), counts_bf16(a[4]),
                              counts_bf16(a[8 * kCtWords + 4])};
      if (!__any_sync(kFull, (af[0] | af[1] | af[2] | af[3]) != 0u)) continue;  // no key of these rows
      const __nv_bfloat16* brow = dsb + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kDs + 8 * (lane >> 4);
#pragma unroll
      for (int j = 0; j < kCT / 8; j += 2) {
        if (j >= ntiles) break;
#pragma unroll
        for (int t = kTerms - 1; t >= 0; --t) {  // smallest term first
          uint32_t b[4];
          ldmatrix_x4_trans(b, brow + t * kS * kDs + 8 * j);
          mma_bf16(acc[j], af, b[0], b[1]);
          if (j + 1 < ntiles) mma_bf16(acc[j + 1], af, b[2], b[3]);
        }
      }
      if (with_cnt) mma_bf16(accn, af, kOnesBf16x2, kOnesBf16x2);
    }
    __syncthreads();  // the counts are free
    for (int i = tid; i < live_rows * kCtWords; i += kBwdThreads) ct[i] = 0u;
    if (tid < kS) nval[tid] = 0;
  }
  // acc[j][2 * half + u]: row m0 + g + 8 * half, column 8 j + 2 tq + u of the tile
  if (runs == 1) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + m0 + g + 8 * half;
      if (row >= v) continue;
      float* grow = p.grad + static_cast<int64_t>(L.row_off + row) * e + c0 + 2 * tq;
#pragma unroll
      for (int j = 0; j < kCT / 8; ++j) {
        if (j >= ntiles) break;
        if (acc[j][2 * half] != 0.f) atomicAdd(grow + 8 * j, acc[j][2 * half]);
        if (acc[j][2 * half + 1] != 0.f) atomicAdd(grow + 8 * j + 1, acc[j][2 * half + 1]);
      }
      if (with_cnt && tq == 0 && accn[2 * half] != 0.f) atomicAdd(p.cnt + L.row_off + row, accn[2 * half]);
    }
    return;
  }
  // the partial of this run; the last run of a group of kGroupRuns sums
  // the group's partials in run order, and (with more than one group) the
  // last group sums the groups' sums in group order
  const int ngroups = (runs + kGroupRuns - 1) / kGroupRuns;
  float* tp = p.part + (static_cast<int64_t>(L.p3) + static_cast<int64_t>(tile) * (runs + ngroups)) * kPart;
  int* tc = p.counters + L.p3 + tile * (runs + ngroups);
  float* part = tp + static_cast<int64_t>(run) * kPart;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + g + 8 * half;
    if (m0 >= live_rows) break;
#pragma unroll
    for (int j = 0; j < kCT / 8; ++j)
      *reinterpret_cast<float2*>(part + m * kCT + 8 * j + 2 * tq) = make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
    if (tq == 0) part[kRT * kCT + m] = accn[2 * half];
  }
  const int grp = run / kGroupRuns;
  const int gsize = runs - grp * kGroupRuns < kGroupRuns ? runs - grp * kGroupRuns : kGroupRuns;
  if (!last_to_arrive(tc + grp, gsize)) return;
  if (ngroups == 1) {
    sum_partials(tp, runs, nullptr, p, L, r0, c0, with_cnt, live_rows);
    return;
  }
  sum_partials(tp + static_cast<int64_t>(grp) * kGroupRuns * kPart, gsize, tp + static_cast<int64_t>(runs + grp) * kPart,
               p, L, r0, c0, with_cnt, live_rows);
  if (!last_to_arrive(tc + ngroups, ngroups)) return;
  sum_partials(tp + static_cast<int64_t>(runs) * kPart, ngroups, nullptr, p, L, r0, c0, with_cnt, live_rows);
}

// One launch for every lookup of a backward group: block ranges per lookup,
// counts-matmul lookups first (their blocks are the longest).
template <typename T>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
onehot_bwd_group(const __grid_constant__ BwdGroup p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int li = 0;
  while (li + 1 < p.n && static_cast<int>(blockIdx.x) >= p.lk[li + 1].first_block) ++li;
  const BwdLookup& L = p.lk[li];
  const int local = static_cast<int>(blockIdx.x) - L.first_block;
  if (L.route == kCountsMma) {
    mma_bwd_block<T>(p, L, smem, local);
  } else if (L.route == kPrivatised) {
    privatised_block<T>(p, L, reinterpret_cast<float*>(smem), local);
  } else {
    global_block<T>(p, L, local);
  }
}

__global__ void cast_to_bf16(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                             int64_t n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    dst[i] = __float2bfloat16(src[i]);
  }
}

int smem_optin() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin;
}

// The forward's route for a lookup of V rows, hotness h, width e.
int fwd_route(int v, int h, int e) {
  const bool mma = v <= kMmaMaxV && h >= 16 && h <= kMmaMaxH && e % 8 == 0;
  return mma ? kMma : kGather;
}

template <typename T, int kVec>
int launch_group(const FwdGroup& p, unsigned blocks, size_t smem, cudaStream_t s) {
  if (smem > kDefaultSmem) {  // the attribute is the current device's; cheap beside the launch
    const cudaError_t err = cudaFuncSetAttribute(
        onehot_fwd_group<T, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  onehot_fwd_group<T, kVec><<<blocks, kFwdWarps * 32, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
int fwd_group(const hctr_fwd_lookup* in, int n, const void* table, void* out, int b, int e,
              int ld, int local, cudaStream_t s) {
  if (n < 1 || n > kMaxLookups || e < 1 || ld < e) return cudaErrorInvalidValue;
  FwdGroup p{};
  p.table = table;
  p.out = out;
  p.n = n;
  p.b = b;
  p.e = e;
  p.ld = ld;
  p.local_keys = local;
  const size_t isz = sizeof(T);
  bool vec4 = e % 4 == 0 && ld % 4 == 0 && reinterpret_cast<uintptr_t>(table) % (4 * isz) == 0 &&
              reinterpret_cast<uintptr_t>(out) % (4 * isz) == 0;
  int route[kMaxLookups];
  int64_t gather_pairs = 0;
  for (int i = 0; i < n; ++i) {
    const hctr_fwd_lookup& x = in[i];
    if (x.h < 1 || x.v < 1 || x.out_col < 0 || x.out_col + e > ld) return cudaErrorInvalidValue;
    if (x.weights != nullptr && (x.w_stride < 0 || x.w_stride > INT32_MAX)) return cudaErrorInvalidValue;
    // the counts matmul's 16-bit integer counts cannot hold weights
    route[i] = x.weights != nullptr ? kGather : fwd_route(x.v, x.h, e);
    if (route[i] == kGather) gather_pairs += static_cast<int64_t>(b) * x.h;
    vec4 = vec4 && x.out_col % 4 == 0;
  }
  // gather warps: kPairsPerWarp pairs each, fewer when that leaves the card
  // without a full complement of resident warps
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t ppw = gather_pairs / (static_cast<int64_t>(sms) * kWarpsPerSm);
  ppw = ppw < kMinPairsPerWarp ? kMinPairsPerWarp : ppw > kPairsPerWarp ? kPairsPerWarp : ppw;
  // counts-matmul lookups first: their blocks are the longest, and last in
  // the grid they would be its tail
  int order[kMaxLookups], o = 0;
  for (int pass = 0; pass < 2; ++pass)
    for (int i = 0; i < n; ++i)
      if ((route[i] == kMma) == (pass == 0)) order[o++] = i;
  int64_t blocks = 0;
  size_t smem = 0;
  for (int j = 0; j < n; ++j) {
    const int i = order[j];
    const hctr_fwd_lookup& x = in[i];
    FwdLookup& L = p.lk[j];
    L.keys = x.keys;
    L.w = x.weights;
    L.w_stride = static_cast<int>(x.w_stride);
    L.key_stride = x.key_stride;
    L.row_off = x.row_off;
    L.h = x.h;
    L.v = x.v;
    L.out_col = x.out_col;
    L.mean = x.mean;
    L.key64 = x.key64;
    const bool windowed = x.key_lo > 0 || x.key_hi >= 0;
    L.key_lo = windowed ? x.key_lo : INT32_MIN;
    L.key_last = !windowed ? INT32_MAX : x.key_hi >= 0 ? x.key_hi - 1 : INT32_MAX - 1;
    L.route = route[i];
    int64_t nblk;
    if (L.route == kMma) {
      // alone, a block per column slice fills the card; beside other
      // lookups, a block takes kGroupSlices slices and forms their counts once
      const int slices = (e + kMmaCols - 1) / kMmaCols;
      L.mma_slices = n > 1 && slices % kGroupSlices == 0 ? kGroupSlices : 1;
      L.samples_per_block = kMmaSamples;
      const size_t need = mma_smem_bytes(x.v, sizeof(T) == 4 ? 3 : 1);  // <= 61,440 bytes
      smem = need > smem ? need : smem;
      nblk = (static_cast<int64_t>(b) + kMmaSamples - 1) / kMmaSamples * (slices / L.mma_slices);
    } else {
      L.samples_per_block = kFwdWarps * static_cast<int>((ppw + x.h - 1) / x.h);
      nblk = (static_cast<int64_t>(b) + L.samples_per_block - 1) / L.samples_per_block;
    }
    L.first_block = static_cast<int>(blocks);
    blocks += nblk;
    if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  }
  if (blocks == 0) return cudaSuccess;
  const unsigned nb = static_cast<unsigned>(blocks);
  return vec4 ? launch_group<T, 4>(p, nb, smem, s) : launch_group<T, 1>(p, nb, smem, s);
}

// Most table rows the privatised route holds in shared memory at width e.
int bwd_tile_rows(int e) { return smem_optin() / (e * 4 + 4); }

// Route thresholds, from `python -m hugectr_tpu_torch.tools.kernel_sweep
// --bwd-routes` at the main paths' lookups, each lookup alone on each route
// (PERF.md; one H100 80GB HBM3 at 700 W). The counts matmul costs about a
// pass over the keys and the products for each 256-row tile, the global
// atomics about the keys: the counts matmul where a sample brings at least
// kMmaKeysPerTile keys per row tile (it won at V 1,024 h 10 to h 100, V 155
// h 5, V 108 h 40, and lost at V 1,024 h 3 and h 7, V 2,209 h 6, V 976 to
// 7,424 at h 1 and 2), or where the rows take kMmaKeysPerRow keys each, so
// that the atomics would serialise on them (it won at V 3 to 36 at h 1, and
// lost at V 63 and 108 at h 1); else the global atomics, which beat the
// privatised route wherever the counts matmul could have run. A lookup the
// counts matmul cannot take (weighted, h above 128, e not a multiple of 8)
// takes the privatised route where its table fits shared memory and its
// rows take kHotKeysPerRow keys, else global atomics.
constexpr int kMmaKeysPerTile = 2;
constexpr int kMmaKeysPerRow = 400;
constexpr int kHotKeysPerRow = 256;
constexpr int kMinRunSamples = 256;   // counts matmul: samples per run at least
constexpr int kMaxRuns = kGroupRuns * kGroupRuns;  // two levels of sums
constexpr int kMmaBlocksPerSm = 1;    // counts matmul: a lookup's runs fill the card once (each run adds a partial tile)

// The backward's route for one lookup of [b, h] keys into v rows of width e.
int bwd_route(int b, int h, int v, int e, bool weighted) {
  const int64_t keys = static_cast<int64_t>(b) * h;
  const int row_tiles = (v + kRT - 1) / kRT;
  if (!weighted && h <= kMmaBwdMaxH && e % 8 == 0)
    return h >= kMmaKeysPerTile * row_tiles || keys >= static_cast<int64_t>(kMmaKeysPerRow) * v ? kCountsMma
                                                                                                : kGlobal;
  if (v <= bwd_tile_rows(e) && keys >= static_cast<int64_t>(kHotKeysPerRow) * v) return kPrivatised;
  return kGlobal;
}

// Whether a forced route can take the lookup.
bool bwd_route_ok(int route, int h, int v, int e, bool weighted) {
  if (route == kCountsMma) return !weighted && h <= kMmaBwdMaxH && e % 8 == 0;
  if (route == kPrivatised) return v <= bwd_tile_rows(e);
  return route == kGlobal;
}

// Sample runs of a counts-matmul lookup of `tiles` tiles: enough blocks to
// fill the card kMmaBlocksPerSm times over, at least kMinRunSamples
// samples a run, at most kMaxRuns runs.
int bwd_runs(int b, int tiles, int sms) {
  const int want = (kMmaBlocksPerSm * sms + tiles - 1) / tiles;
  const int most = (b + kMinRunSamples - 1) / kMinRunSamples;
  int r = want < most ? want : most;
  r = r > kMaxRuns ? kMaxRuns : r;
  return r < 1 ? 1 : r;
}

struct BwdPlan {
  int64_t slots = 0;  // the counts matmul's partial tiles (kPart floats and one counter each)
  int64_t blocks = 0;
  size_t smem = 0;
};

inline int64_t scratch_bytes(const BwdPlan& pl) { return pl.slots * (kPart * 4 + 4); }

// Routes, block ranges and scratch of a backward group (`force` >= 0: every
// lookup on that route). Fills p.lk, p.n, and the plan.
int plan_bwd(const hctr_fwd_lookup* in, int n, int b, int e, int ld, int terms, int force, BwdGroup& p,
             BwdPlan& pl) {
  if (n < 1 || n > kMaxLookups || e < 1 || ld < e || b < 0) return cudaErrorInvalidValue;
  int route[kMaxLookups];
  for (int i = 0; i < n; ++i) {
    const hctr_fwd_lookup& x = in[i];
    if (x.h < 1 || x.v < 1 || x.out_col < 0 || x.out_col + e > ld || x.row_off < 0 ||
        x.row_off + x.v > INT32_MAX || x.key_stride < 0 || x.key_stride > INT32_MAX ||
        static_cast<int64_t>(b) * x.h > INT32_MAX)  // a lookup's keys are counted in int
      return cudaErrorInvalidValue;
    const bool weighted = x.weights != nullptr;
    if (weighted && (x.w_stride < 0 || x.w_stride > INT32_MAX)) return cudaErrorInvalidValue;
    route[i] = force >= 0 ? force : bwd_route(b, x.h, x.v, e, weighted);
    if (!bwd_route_ok(route[i], x.h, x.v, e, weighted)) return cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // counts-matmul lookups first, the most keys first; then privatised, then global
  int order[kMaxLookups], o = 0;
  const int by_route[3] = {kCountsMma, kPrivatised, kGlobal};
  for (int r : by_route) {
    const int first = o;
    for (int i = 0; i < n; ++i)
      if (route[i] == r) {
        int j = o++;
        for (; j > first && in[order[j - 1]].h < in[i].h; --j) order[j] = order[j - 1];
        order[j] = i;
      }
  }
  pl = BwdPlan{};
  for (int j = 0; j < n; ++j) {
    const hctr_fwd_lookup& x = in[order[j]];
    if (route[order[j]] == kCountsMma) pl.smem = mma_bwd_smem(terms) > pl.smem ? mma_bwd_smem(terms) : pl.smem;
    if (route[order[j]] == kPrivatised)
    {
      const size_t need = static_cast<size_t>(x.v) * (static_cast<size_t>(e) * 4 + 4);
      pl.smem = need > pl.smem ? need : pl.smem;
    }
  }
  // privatised slices: a block per SM at least; past that at most one wave
  // of resident blocks and at least kFlushRatio keys per row and slice
  int per_sm = 1;
  if (pl.smem > 0) {
    per_sm = static_cast<int>(smem_optin() / pl.smem);
    per_sm = per_sm < 1 ? 1 : per_sm > kBwdMinBlocks ? kBwdMinBlocks : per_sm;
  } else {
    per_sm = kBwdMinBlocks;
  }
  p.n = n;
  for (int j = 0; j < n; ++j) {
    const int i = order[j];
    const hctr_fwd_lookup& x = in[i];
    BwdLookup& L = p.lk[j];
    L.keys = x.keys;
    L.w = x.weights;
    L.key_stride = static_cast<int>(x.key_stride);
    L.w_stride = static_cast<int>(x.w_stride);
    L.row_off = static_cast<int>(x.row_off);
    L.v = x.v;
    L.h = x.h;
    L.d_col = x.out_col;
    const bool windowed = x.key_lo > 0 || x.key_hi >= 0;
    L.key_lo = windowed ? x.key_lo : INT32_MIN;
    L.key_last = !windowed ? INT32_MAX : x.key_hi >= 0 ? x.key_hi - 1 : INT32_MAX - 1;
    L.flags = (x.mean ? kFlagMean : 0) | (x.key64 ? kFlagKey64 : 0) | (x.out_col % 4 == 0 ? kFlagDVec : 0);
    L.route = route[i];
    L.p0 = L.p1 = L.p2 = L.p3 = 0;
    const int64_t keys = static_cast<int64_t>(b) * x.h;
    int64_t nblk = 0;
    if (L.route == kCountsMma) {
      const int row_tiles = (x.v + kRT - 1) / kRT, slices = (e + kCT - 1) / kCT;
      const int tiles = row_tiles * slices;
      int runs = bwd_runs(b, tiles, sms);
      const int run_samples = (((b + runs - 1) / runs + kS - 1) / kS) * kS;
      runs = (b + run_samples - 1) / run_samples;
      L.p0 = slices;
      L.p1 = runs;
      L.p2 = run_samples;
      L.p3 = static_cast<int>(pl.slots);
      if (runs > 1) pl.slots += static_cast<int64_t>(tiles) * (runs + (runs + kGroupRuns - 1) / kGroupRuns);
      if (pl.slots > INT32_MAX) return cudaErrorInvalidValue;
      nblk = b > 0 ? static_cast<int64_t>(tiles) * runs : 0;
    } else if (L.route == kPrivatised) {
      const int64_t wave = static_cast<int64_t>(per_sm) * sms;
      const int64_t cap = keys / (static_cast<int64_t>(kFlushRatio) * x.v);
      int64_t slices = wave < cap ? wave : cap;
      slices = slices < sms ? sms : slices / sms * sms;
      if (slices > b) slices = b;
      if (slices < 1) slices = 1;
      L.p2 = static_cast<int>((b + slices - 1) / slices);
      nblk = b > 0 ? (b + L.p2 - 1) / L.p2 : 0;
    } else {
      const int64_t want = (keys + kBatch * kBwdWarps - 1) / (kBatch * kBwdWarps);
      nblk = want < kGlobalMaxBlocks ? want : kGlobalMaxBlocks;
    }
    L.first_block = static_cast<int>(pl.blocks);
    L.blocks = static_cast<int>(nblk);
    pl.blocks += nblk;
    if (pl.blocks > INT32_MAX) return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <typename T>
int bwd_group(const hctr_fwd_lookup* in, int n, const void* d, int ld, float* grad, float* cnt, int64_t rows,
              void* scratch, int64_t scratch_len, int b, int e, int accumulate, int local, int force,
              cudaStream_t s) {
  if (!accumulate && rows > 0) {
    cudaError_t err = cudaMemsetAsync(grad, 0, rows * e * sizeof(float), s);
    if (err == cudaSuccess) err = cudaMemsetAsync(cnt, 0, rows * sizeof(float), s);
    if (err != cudaSuccess) return err;
  }
  if (n == 0 || b == 0) return cudaSuccess;
  BwdGroup p{};
  BwdPlan pl;
  const int err = plan_bwd(in, n, b, e, ld, sizeof(T) == 4 ? 3 : 1, force, p, pl);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n; ++i)
    if (in[i].row_off + in[i].v > rows) return cudaErrorInvalidValue;
  if (scratch_bytes(pl) > scratch_len) return cudaErrorInvalidValue;
  const size_t isz = sizeof(T);
  if (!(ld % 4 == 0 && reinterpret_cast<uintptr_t>(d) % (4 * isz) == 0))
    for (int j = 0; j < n; ++j) p.lk[j].flags &= ~kFlagDVec;
  p.d = d;
  p.grad = grad;
  p.cnt = cnt;
  p.part = static_cast<float*>(scratch);
  p.counters = reinterpret_cast<int*>(static_cast<float*>(scratch) + pl.slots * kPart);
  p.b = b;
  p.e = e;
  p.ld = ld;
  p.local_keys = local;
  if (pl.slots > 0) {
    const cudaError_t e2 = cudaMemsetAsync(p.counters, 0, pl.slots * sizeof(int), s);
    if (e2 != cudaSuccess) return e2;
  }
  if (pl.blocks == 0) return cudaSuccess;
  if (pl.smem > kDefaultSmem) {
    const cudaError_t e2 = cudaFuncSetAttribute(onehot_bwd_group<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(pl.smem));
    if (e2 != cudaSuccess) return e2;
  }
  onehot_bwd_group<T><<<static_cast<unsigned>(pl.blocks), kBwdThreads, pl.smem, s>>>(p);
  return cudaGetLastError();
}

// The float32 sums cast to bfloat16 (the per-table entry's bf16 output).
int cast_bf16(const float* src, void* dst, int64_t n, cudaStream_t s) {
  if (n == 0) return cudaSuccess;
  const int64_t want = (n + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(want < 65535 ? want : 65535);
  cast_to_bf16<<<blocks, 256, 0, s>>>(src, static_cast<__nv_bfloat16*>(dst), n);
  return cudaGetLastError();
}

int bwd_dispatch(int dtype, const hctr_fwd_lookup* in, int n, const void* d, int ld, void* grad32, void* cnt,
                 int64_t rows, void* scratch, int64_t scratch_len, int b, int e, int accumulate, int local,
                 int force, cudaStream_t s) {
  auto* g = static_cast<float*>(grad32);
  auto* c = static_cast<float*>(cnt);
  if (dtype == kF32)
    return bwd_group<float>(in, n, d, ld, g, c, rows, scratch, scratch_len, b, e, accumulate, local, force, s);
  if (dtype == kBF16)
    return bwd_group<__nv_bfloat16>(in, n, d, ld, g, c, rows, scratch, scratch_len, b, e, accumulate, local,
                                    force, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace hctr

// The pooled lookups of a one-hot group in one launch: lookups[n] into the
// group storage `table` [rows, e], each written to out[:, out_col : out_col
// + e] of out [b, ld], both of `dtype`. Group mode: -1 is padding, other
// keys wrap by floor modulo into [0, v).
extern "C" int hctr_onehot_fwd_group(int dtype, const hctr_fwd_lookup* lookups, int n,
                                     const void* table, void* out, int b, int e, int ld,
                                     void* stream) {
  if (b == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == hctr::kF32)
    return hctr::fwd_group<float>(lookups, n, table, out, b, e, ld, 0, s);
  if (dtype == hctr::kBF16)
    return hctr::fwd_group<__nv_bfloat16>(lookups, n, table, out, b, e, ld, 0, s);
  return cudaErrorInvalidValue;
}

// The per-table contract of the Pallas kernel: keys [b, h] int32 table-local
// rows (outside [0, v): padding), table [v, e] and out [b, e] of `dtype`;
// the group kernel with one lookup in local-keys mode.
extern "C" int hctr_onehot_fwd(int dtype, const void* keys, const void* table, void* out, int b,
                               int h, int v, int e, void* stream) {
  if (b == 0) return cudaSuccess;
  const hctr_fwd_lookup lk{keys, h, 0, h, v, 0, 0, 0, 0, -1, nullptr, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == hctr::kF32) return hctr::fwd_group<float>(&lk, 1, table, out, b, e, e, 1, s);
  if (dtype == hctr::kBF16)
    return hctr::fwd_group<__nv_bfloat16>(&lk, 1, table, out, b, e, e, 1, s);
  return cudaErrorInvalidValue;
}

// The route the forward's launcher takes for a lookup: 0 gather, 1 counts matmul.
extern "C" int hctr_onehot_fwd_route(int v, int h, int e) { return hctr::fwd_route(v, h, e); }

// Most table rows the privatised backward takes at width e on the current device.
extern "C" int hctr_onehot_bwd_tile_rows(int e) { return hctr::bwd_tile_rows(e); }

// The backward's route for one lookup of [b, h] keys into [v, e]: 0 global
// atomics, 1 privatised, 2 counts matmul.
extern "C" int hctr_onehot_bwd_route(int b, int h, int v, int e, int weighted) {
  return hctr::bwd_route(b, h, v, e, weighted != 0);
}

// Scratch bytes a backward group needs (the counts matmul's partial sums
// and tile counters), or -1 for lookups the kernel does not take.
extern "C" int64_t hctr_onehot_bwd_scratch(const hctr_fwd_lookup* lookups, int n, int b, int e, int ld,
                                           int route) {
  if (n == 0 || b == 0) return 0;
  hctr::BwdGroup p{};
  hctr::BwdPlan pl;
  if (hctr::plan_bwd(lookups, n, b, e, ld, 1, route, p, pl) != cudaSuccess) return -1;
  return hctr::scratch_bytes(pl);
}

// The weight gradient and touch counts of a one-hot group in one launch:
// lookups[n] (the forward's descriptors; out_col is the lookup's column in
// d) with cotangents d [b, ld] of `d_dtype`, into grad32 [rows, e] and cnt
// [rows] float32, zeroed first unless `accumulate` is 1. Group mode: the
// window, -1 padding, the floor-mod wrap. `route` -1 lets the launcher
// choose each lookup's route; 0, 1, 2 force global, privatised or counts
// matmul on every lookup (sweeps and checks).
extern "C" int hctr_onehot_bwd_group(int d_dtype, const hctr_fwd_lookup* lookups, int n, const void* d, int ld,
                                     void* grad32, void* cnt, int64_t rows, void* scratch, int64_t scratch_len,
                                     int b, int e, int accumulate, int route, void* stream) {
  return hctr::bwd_dispatch(d_dtype, lookups, n, d, ld, grad32, cnt, rows, scratch, scratch_len, b, e,
                            accumulate, 0, route, static_cast<cudaStream_t>(stream));
}

// The per-table contract of the Pallas kernel: keys [b, h] int32 table-local
// rows (outside [0, v): padding), d [b, e] of `d_dtype`, w [b, h] float32
// per-key weights or null; grad32 [v, e] and cnt [v] float32 receive the
// sums, added to what they hold when `accumulate` is 1, else zeroed first;
// out_bf16 [v, e] receives their cast when it is not null. The group kernel
// with one lookup in local-keys mode.
extern "C" int hctr_onehot_bwd(int d_dtype, const void* keys, const void* d, const void* w, void* grad32,
                               void* cnt, void* out_bf16, void* scratch, int64_t scratch_len, int b, int h,
                               int v, int e, int accumulate, int route, void* stream) {
  const hctr_fwd_lookup lk{keys, h, 0, h, v, 0, 0, 0, 0, -1, static_cast<const float*>(w), h};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = hctr::bwd_dispatch(d_dtype, &lk, 1, d, e, grad32, cnt, v, scratch, scratch_len, b, e,
                                     accumulate, 1, route, s);
  if (err != cudaSuccess || out_bf16 == nullptr) return err;
  return hctr::cast_bf16(static_cast<const float*>(grad32), out_bf16, static_cast<int64_t>(v) * e, s);
}
