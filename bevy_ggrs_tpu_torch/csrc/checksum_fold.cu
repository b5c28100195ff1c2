// Checksum block fold for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel `_hash_block_kernel` with its wrappers
// `component_part_pallas` / `world_checksum_pallas` (removed from
// bevy_ggrs_tpu/ops/pallas_hash.py, kept in docs/pallas_negative_result.md
// lines 63-152); the live semantics are bevy_ggrs_tpu/snapshot/checksum.py
// lines 101-139 (`_fold_rows` and `component_part`).
//
// For every frame f < k, every checksummed component c and every entity row
// n < N, with L the component's number of u32 lanes:
//
//   h = tag[c][s]
//   for i < L: h = mix32(h, lane[f, n, i])
//   h = fmix32(h ^ L)
//   h = fmix32(mix32(h, rollback_id[f, n]))
//   out[f, c, s] += (alive & !despawn_pending & has[c])[f, n] ? h : 0
//
// for both seeds s, where the sum over n wraps in u32.  The caller XORs the
// sum with the tag and applies fmix32, as component_part does.
//
// Bound on the card: the fold is a few integer multiplies per lane, far
// below the card's integer rate, so it is bound by the bytes it reads:
// each lane (4 bytes), the id (4) and three mask bytes per row and frame,
// over 3.35 TB/s of HBM3.  Design: a grid over (entity block, frame); each
// block walks its rows with a grid-stride loop, keeps the two seeds' sums
// in registers, reduces them in the block (warp shuffles, then shared
// memory) and adds them into out[f, c, :] with one atomicAdd per seed.
// Wrapping u32 addition is associative and commutative, so the atomics are
// bit-exact whatever order the blocks run in.  The TPU kernel's sequential
// grid accumulator (init at program_id 0) has no counterpart: blocks run
// in parallel here, and the caller zeroes `out` before the launch.  The
// launch allocates nothing and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxComps = 16;
constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 1024;

struct FoldParams {
  const uint32_t* lanes[kMaxComps];  // [k, n, nlanes[c]] u32 bit patterns
  const uint8_t* has[kMaxComps];     // [k, n] bool
  int nlanes[kMaxComps];
  uint32_t tag[kMaxComps][2];
  const int32_t* ids;                // [k, n]
  const uint8_t* alive;              // [k, n] bool
  const uint8_t* pending;            // [k, n] bool
  uint32_t* out;                     // [k, out_comps, 2], chunk offset applied
  long long n;
  int ncomp;
  int out_comps;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ uint32_t mix32(uint32_t h, uint32_t k) {
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  h ^= k;
  h = rotl32(h, 13);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// Wrapping sum of v over the block; the result is valid in thread 0.
__device__ __forceinline__ uint32_t block_sum(uint32_t v) {
  __shared__ uint32_t warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // an earlier call may still be reading warp_sums
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = (threadIdx.x < kThreads / 32) ? warp_sums[lane] : 0u;
  if (warp == 0) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads) checksum_fold_kernel(FoldParams p) {
  const long long f = blockIdx.y;
  const long long base = f * p.n;
  const long long stride = (long long)gridDim.x * kThreads;
  for (int c = 0; c < p.ncomp; ++c) {
    const uint32_t* lanes = p.lanes[c];
    const uint8_t* has = p.has[c];
    const int L = p.nlanes[c];
    const uint32_t t0 = p.tag[c][0];
    const uint32_t t1 = p.tag[c][1];
    uint32_t s0 = 0u, s1 = 0u;
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < p.n;
         i += stride) {
      const long long r = base + i;
      if (!p.alive[r] || p.pending[r] || !has[r]) continue;
      const uint32_t* row = lanes + r * L;
      uint32_t h0 = t0, h1 = t1;
      for (int j = 0; j < L; ++j) {
        const uint32_t v = row[j];
        h0 = mix32(h0, v);
        h1 = mix32(h1, v);
      }
      h0 = fmix32(h0 ^ (uint32_t)L);
      h1 = fmix32(h1 ^ (uint32_t)L);
      const uint32_t id = (uint32_t)p.ids[r];
      s0 += fmix32(mix32(h0, id));
      s1 += fmix32(mix32(h1, id));
    }
    s0 = block_sum(s0);
    s1 = block_sum(s1);
    if (threadIdx.x == 0) {
      uint32_t* o = p.out + (f * p.out_comps + c) * 2;
      atomicAdd(o, s0);
      atomicAdd(o + 1, s1);
    }
  }
}

}  // namespace

extern "C" int checksum_fold_max_comps() { return kMaxComps; }

// Launch the fold on `stream`.  Returns cudaGetLastError() (0 on success).
extern "C" int checksum_fold_launch(
    int device, int k, long long n, int ncomp, int out_comps,
    const void* const* lanes, const int* nlanes, const void* const* has,
    const unsigned int* tags, const void* ids, const void* alive,
    const void* pending, void* out, void* stream) {
  if (k <= 0 || k > 65535 || n <= 0 || ncomp <= 0 || ncomp > kMaxComps) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  FoldParams p;
  for (int c = 0; c < ncomp; ++c) {
    p.lanes[c] = static_cast<const uint32_t*>(lanes[c]);
    p.has[c] = static_cast<const uint8_t*>(has[c]);
    p.nlanes[c] = nlanes[c];
    p.tag[c][0] = tags[2 * c];
    p.tag[c][1] = tags[2 * c + 1];
  }
  for (int c = ncomp; c < kMaxComps; ++c) {
    p.lanes[c] = nullptr;
    p.has[c] = nullptr;
    p.nlanes[c] = 0;
    p.tag[c][0] = p.tag[c][1] = 0u;
  }
  p.ids = static_cast<const int32_t*>(ids);
  p.alive = static_cast<const uint8_t*>(alive);
  p.pending = static_cast<const uint8_t*>(pending);
  p.out = static_cast<uint32_t*>(out);
  p.n = n;
  p.ncomp = ncomp;
  p.out_comps = out_comps;
  long long bx = (n + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  dim3 grid((unsigned)bx, (unsigned)k);
  checksum_fold_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
