// Dropout's keep mask as a function of the layer's key and the global step.
//
// It replaces no TPU kernel: the JAX package draws Dropout's mask with
// jax.random.bernoulli from a key folded with the traced step
// (hugectr_tpu/layers/core_layers.py:88-97, hugectr_tpu/model/model.py:801),
// which XLA lowers to the TPU's own random bits. The port's step runs as one
// captured CUDA graph, so its mask has to follow a step that the graph reads
// from the device at each replay: a counter-based hash of (key, step,
// element), read from a device int64 the step fills. A torch.Generator keeps
// its position on the host, which a replay does not move.
//
// hctr_dropout_mask: out[i] = mix(mix((first + i) ^ k1) + mix(step ^ k0)) <
// thr for the n elements, all arithmetic on 32-bit unsigned words (wrapping),
// mix being two xorshift-multiply rounds, a bijection of the word
// (multipliers below 2^31, so that the plain version's int64 products stay
// exact). thr = keep * 2^32: an element is kept with probability keep.
// `first` is the global index of the rank's first element, so W ranks keep
// what one device keeps. The kernel and ops/dropout.py's plain version give
// the same bits.
//
// Bound on an H100: memory, the n mask bytes written (the step read once);
// about 24 integer operations an element. One thread an element in a
// grid-stride loop over a grid fixed by n.
#include "common.cuh"

namespace hctr {
namespace {

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x68E31DA5u;
  h ^= h >> 16;
  return h;
}

__global__ void __launch_bounds__(256)
dropout_mask(bool* __restrict__ out, const int64_t* __restrict__ step, int64_t first, int64_t n, uint32_t k0,
             uint32_t k1, uint32_t thr) {
  const uint32_t s = mix32(static_cast<uint32_t>(*step) ^ k0);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride)
    out[i] = mix32(mix32(static_cast<uint32_t>(first + i) ^ k1) + s) < thr;
}

}  // namespace
}  // namespace hctr

// out [n] bool: the keep mask of elements first .. first + n - 1 at the step
// *step (a device int64) for the key (k0, k1) and threshold thr. Returns
// cudaGetLastError().
extern "C" int hctr_dropout_mask(void* out, const void* step, int64_t first, int64_t n, uint32_t k0, uint32_t k1,
                                 uint32_t thr, void* stream) {
  if (n == 0) return cudaSuccess;
  const int64_t want = (n + 255) / 256;
  const unsigned grid = static_cast<unsigned>(want < 4096 ? want : 4096);
  hctr::dropout_mask<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<bool*>(out), static_cast<const int64_t*>(step), first, n, k0, k1, thr);
  return cudaGetLastError();
}
