// Pooled lookup and its weight gradient for the small-table (one-hot) engine.
//
// Replaces: hugectr_tpu/ops/pallas/onehot_matmul.py::onehot_matmul_fwd
// (body _fwd_kernel, tile _onehot_tile) and ::onehot_matmul_bwd (body
// _bwd_kernel), and around the forward the per-lookup placement of
// hugectr_tpu/embedding/collection.py (_slot_placement, _onehot_local_keys,
// _onehot_fwd: int32 cast, floor-mod wrap, mean division, concatenation).
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
// B = 16,384, E = 128). On an H100 the backward and most of the forward are
// row moves instead.
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
// Backward (scatter-add). Bound: memory, the keys, d (B * E * itemsize),
// grad (V * E * itemsize) and cnt (V * 4 bytes): about 3.4 us for table 24
// of the flagship (B 16,384, h 40, V 108, float32). Power-law keys put
// ~10^5 adds on each column of the head rows of such a table, so a scatter
// straight into device memory (one float32 atomicAdd per key and column)
// serialises in L2: 3.29 ms at table 24 on an H100 in the first port, 4x
// `index_add_`. The launcher takes one of two routes by shape (a weighted
// lookup's backward takes the same ones, each key's d row scaled by its
// weight before the adds and its sample's |summed weights on the row|
// added to the row's float32 count by the row's first key in the sample):
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
constexpr int kBwdWarps = 16;       // warps per block of the privatised backward
constexpr int kGlobalWarps = 8;     // warps per block of the global-atomic backward
constexpr int kBwdCols = 4;         // columns per lane per pass of the backward
constexpr int kBatch = 8;           // keys whose d rows a warp loads at once in the backward
constexpr int kFlushRatio = 16;     // keys per table row of a slice, past one block per SM
constexpr int kHotKeysPerRow = 256; // privatise when B * h >= this * V
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
__device__ __forceinline__ int place_key(int32_t k, const FwdLookup& L, int local) {
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

// Adds the d rows of the warp's keys marked in `m` (a warp-uniform ballot)
// into rows `row` of dst [*, e], where lane j holds key j's destination row
// and sample. Lane-strided columns: every atomic instruction of the warp
// covers 128 consecutive bytes, and no two lanes share a shared-memory
// bank. The d rows of kBatch keys are loaded before their adds. kWeighted:
// lane j's `wt` scales key j's d row.
template <typename T, bool kWeighted>
__device__ __forceinline__ void add_rows(unsigned m, int row, long long sample, float wt,
                                         const T* __restrict__ d, float* dst, int e, int lane) {
  while (m) {
    int r[kBatch];
    long long s[kBatch];
    float wq[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const bool ok = m != 0;
      const int j = ok ? __ffs(m) - 1 : 0;
      r[q] = __shfl_sync(kFull, row, j);
      s[q] = __shfl_sync(kFull, sample, j);
      if constexpr (kWeighted) wq[q] = __shfl_sync(kFull, wt, j);
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
          if constexpr (kWeighted) x[q][i] *= wq[q];
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

// The touch count key f (of row `key`, in [0, v)) adds in a weighted
// backward: the JAX package's sum over samples of |a sample's summed
// weights on the row|. The first occurrence of the row in its sample adds
// |the sum of the weights of the sample's keys on that row| and a later
// duplicate adds nothing, so a sample whose duplicates' weights cancel does
// not touch the row. O(h^2) reads of the sample's keys, cached in L1.
__device__ __forceinline__ float sample_touch(const int32_t* __restrict__ keys,
                                              const float* __restrict__ w, int64_t f, int h, int key) {
  const int64_t s0 = f / h * h;
  for (int64_t i = s0; i < f; ++i)
    if (__ldg(keys + i) == key) return 0.f;
  float sum = __ldg(w + f);
  for (int64_t i = f + 1; i < s0 + h; ++i)
    if (__ldg(keys + i) == key) sum += __ldg(w + i);
  return fabsf(sum);
}

// Privatised backward: the whole table in shared memory; block `slice`
// takes samples [slice * slice_samples, +slice_samples). kWeighted: the
// counts are float32 sums of `sample_touch`.
template <typename T, bool kWeighted>
__global__ void __launch_bounds__(kBwdWarps * 32)
onehot_bwd(const int32_t* __restrict__ keys, const T* __restrict__ d, const float* __restrict__ w,
           float* __restrict__ grad, float* __restrict__ cnt, int b, int h, int v, int e,
           int slice_samples) {
  extern __shared__ float part[];  // [v][e] float32 sums, then [v] int counts (kWeighted: float)
  int* scnt = reinterpret_cast<int*>(part + v * e);
  float* swt = part + v * e;
  for (int i = threadIdx.x; i < v * e; i += blockDim.x) part[i] = 0.f;
  for (int i = threadIdx.x; i < v; i += blockDim.x) scnt[i] = 0;  // 0 bits: 0.f too
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * slice_samples;
  const int64_t s1 = s0 + slice_samples < b ? s0 + slice_samples : b;
  const int64_t f1 = s1 * h;
  for (int64_t g = s0 * h + warp * 32; g < f1; g += kBwdWarps * 32) {
    const int64_t f = g + lane;
    int key = -1;
    float wt = 0.f;
    if (f < f1) {
      key = __ldg(keys + f);
      if (key < 0 || key >= v) key = -1;
      if constexpr (kWeighted) wt = __ldg(w + f);
    }
    if constexpr (kWeighted) {
      if (key >= 0) {
        const float t = sample_touch(keys, w, f, h, key);
        if (t != 0.f) atomicAdd(swt + key, t);
      }
    } else {
      // one count add per distinct row of the 32 keys
      const unsigned peers = __match_any_sync(kFull, key);
      if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(scnt + key, __popc(peers));
    }
    add_rows<T, kWeighted>(__ballot_sync(kFull, key >= 0), key, f / h, wt, d, part, e, lane);
  }
  __syncthreads();

  for (int r = warp; r < v; r += kBwdWarps) {
    const float n = kWeighted ? swt[r] : static_cast<float>(scnt[r]);
    if (n == 0.f) continue;
    float* grow = grad + static_cast<int64_t>(r) * e;
    for (int c = lane; c < e; c += 32) atomicAdd(grow + c, part[r * e + c]);
    if (lane == 0) atomicAdd(cnt + r, n);
  }
}

// Global-atomic backward for tables whose keys spread over many rows: each
// warp takes kBatch keys at a time (lanes 0..kBatch-1 load them, so a batch
// has many warps in flight) and adds their d rows straight into grad.
template <typename T, bool kWeighted>
__global__ void __launch_bounds__(kGlobalWarps * 32)
onehot_bwd_global(const int32_t* __restrict__ keys, const T* __restrict__ d,
                  const float* __restrict__ w, float* __restrict__ grad, float* __restrict__ cnt,
                  int b, int h, int v, int e) {
  const int lane = threadIdx.x & 31;
  const int64_t n = static_cast<int64_t>(b) * h;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kGlobalWarps * kBatch;
  for (int64_t g = (static_cast<int64_t>(blockIdx.x) * kGlobalWarps + (threadIdx.x >> 5)) * kBatch;
       g < n; g += stride) {
    const int64_t f = g + lane;
    int key = -1;
    float wt = 0.f;
    if (lane < kBatch && f < n) {
      key = __ldg(keys + f);
      if (key < 0 || key >= v) key = -1;
      if constexpr (kWeighted) wt = __ldg(w + f);
    }
    if constexpr (kWeighted) {
      if (key >= 0) {
        const float t = sample_touch(keys, w, f, h, key);
        if (t != 0.f) atomicAdd(cnt + key, t);
      }
    } else {
      const unsigned peers = __match_any_sync(kFull, key);
      if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(cnt + key, static_cast<float>(__popc(peers)));
    }
    add_rows<T, kWeighted>(__ballot_sync(kFull, key >= 0), key, f / h, wt, d, grad, e, lane);
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

// Most table rows one backward block can hold in shared memory at width e.
int bwd_tile_rows(int e) { return smem_optin() / (e * 4 + 4); }

// The backward's route for a shape: privatised when the table fits one
// block's shared memory and its keys are many per row, so that a scatter
// straight into device memory would serialise on the rows; else global
// atomics.
inline bool bwd_privatised(int b, int h, int v, int e) {
  return v <= bwd_tile_rows(e) &&
         static_cast<int64_t>(b) * h >= static_cast<int64_t>(kHotKeysPerRow) * v;
}

template <typename T, bool kWeighted>
int bwd_global(const int32_t* keys, const T* d, const float* w, float* grad, float* cnt, int b, int h,
               int v, int e, cudaStream_t s) {
  const int64_t groups = (static_cast<int64_t>(b) * h + kBatch - 1) / kBatch;
  const int64_t want = (groups + kGlobalWarps - 1) / kGlobalWarps;
  const unsigned blocks = static_cast<unsigned>(want < 65535 ? want : 65535);
  onehot_bwd_global<T, kWeighted><<<blocks, kGlobalWarps * 32, 0, s>>>(keys, d, w, grad, cnt, b, h, v, e);
  return cudaGetLastError();
}

template <typename T, bool kWeighted>
int bwd(const void* keys_, const void* d_, const float* w, void* grad32, void* cnt_, int b, int h, int v,
        int e, cudaStream_t s) {
  const auto* keys = static_cast<const int32_t*>(keys_);
  const auto* d = static_cast<const T*>(d_);
  auto* grad = static_cast<float*>(grad32);
  auto* cnt = static_cast<float*>(cnt_);
  if (!bwd_privatised(b, h, v, e)) return bwd_global<T, kWeighted>(keys, d, w, grad, cnt, b, h, v, e, s);
  const size_t smem = static_cast<size_t>(v) * (e * 4 + 4);
  const int threads = kBwdWarps * 32;
  cudaError_t err = cudaFuncSetAttribute(onehot_bwd<T, kWeighted>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, onehot_bwd<T, kWeighted>, threads, smem);
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
  onehot_bwd<T, kWeighted><<<static_cast<unsigned>(slices), threads, smem, s>>>(keys, d, w, grad, cnt, b,
                                                                                 h, v, e, slice_samples);
  return cudaGetLastError();
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

// The backward's route for [b, h] keys into [v, e]: 1 privatised, 0 global.
extern "C" int hctr_onehot_bwd_privatised(int b, int h, int v, int e) {
  return hctr::bwd_privatised(b, h, v, e) ? 1 : 0;
}

// keys [b, h] int32; d [b, e] of `d_dtype`; w [b, h] float32 per-key
// weights or null; grad32 [v, e] and cnt [v] float32 receive the sums (with
// w: the w-scaled d rows and the sums of |a sample's summed w|): added to what they hold when
// `accumulate` is 1, else zeroed first. out_bf16 [v, e] bfloat16 receives
// the cast of grad32 when it is not null.
extern "C" int hctr_onehot_bwd(int d_dtype, const void* keys, const void* d, const void* w,
                               void* grad32, void* cnt, void* out_bf16, int b, int h, int v, int e,
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
    const auto* wf = static_cast<const float*>(w);
    if (d_dtype == hctr::kF32)
      err = wf ? hctr::bwd<float, true>(keys, d, wf, grad32, cnt, b, h, v, e, s)
               : hctr::bwd<float, false>(keys, d, wf, grad32, cnt, b, h, v, e, s);
    else
      err = wf ? hctr::bwd<__nv_bfloat16, true>(keys, d, wf, grad32, cnt, b, h, v, e, s)
               : hctr::bwd<__nv_bfloat16, false>(keys, d, wf, grad32, cnt, b, h, v, e, s);
  }
  if (err != cudaSuccess || out_bf16 == nullptr || n == 0) return err;
  const int64_t want = (n + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(want < 65535 ? want : 65535);
  hctr::cast_to_bf16<<<blocks, 256, 0, s>>>(static_cast<const float*>(grad32),
                                            static_cast<__nv_bfloat16*>(out_bf16), n);
  return cudaGetLastError();
}
