// The checksum pass for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel `_hash_block_kernel` with its wrappers
// `component_part_pallas` / `world_checksum_pallas` (removed from
// bevy_ggrs_tpu/ops/pallas_hash.py, kept in docs/pallas_negative_result.md
// lines 63-152); the live semantics are bevy_ggrs_tpu/snapshot/checksum.py
// lines 101-190 (`component_part`, `entity_part`, `world_checksum`).
//
// For a stack of k worlds of n entity rows it computes, for every frame f
// and both seeds s, the world checksum without its resource parts:
//
//   row(c, n)  = fmix32(mix32(fmix32(fold_s(lanes[c][f, n, :]) ^ L_c), id[f, n]))
//   part(c)    = fmix32(sum_n keep[c][f, n] * row(c, n) ^ tag[c][s])   (u32 sum)
//   out[f, s]  = entity(active_count[f], next_id[f], s) XOR_c part(c)
//
// where fold_s starts from tag[c][s] and mixes each u32 lane in, and keep is
// alive & !despawn_pending & has[c].  It writes out[f, 0, s] and every part
// out[f, 1 + c, s], int64 values in [0, 2**32).
//
// Bound on the card: the larger of the bytes over HBM3 (3.35 TB/s) and the
// 32-bit integer operations over their pipes.  Per kept row and component
// with L lanes, at least 5L + 28 operations on the integer ALU pipe (xor,
// shift, funnel shift, add) and 4L + 12 multiplies and multiply-adds on the
// FMA pipe (the key half of mix32 once for both seeds, the state half and
// the fmix32s per seed), against 4L + 1 bytes of lanes and has mask; per
// row another 4 id bytes and 2 mask bytes.  Compute capability 9.0 retires
// 64 results per clock per SM on each of the two pipes, side by side (CUDA
// C++ Programming Guide, arithmetic instruction throughput table), and
// issues 128.  At 6 f32 components that is ~34 ALU operations per 5 bytes,
// so the pass is bound by the integer ALU pipe before HBM.  The design does
// about each:
//
// - one walk over the rows for all components: a thread takes a group of
//   rows of one frame, reads its alive, pending and id words once, mixes the
//   id's seed-independent key half once, then reads each component's has
//   bytes and lanes; every byte is read once;
// - 16-byte loads: a group is 4 rows when every base address is 16-byte
//   aligned and n % 4 == 0 (4 ids, 4 mask bytes, 4 lanes of an L=1 column
//   in one load each); otherwise 1 row with scalar loads (ragged n, a frame
//   slice with a storage offset);
// - loads first, branch-free arithmetic: a dead row is hashed and then
//   multiplied by 0, so a group's loads do not wait on its masks;
// - a lane's key half of mix32 runs once for both seeds;
// - no zeroed buffer and no atomics: each thread keeps its running sums in
//   its own column of shared memory, each block reduces them and writes its
//   partial sums; a second small launch (one block per frame) reduces the
//   partials and applies the tags, the XOR across components and the entity
//   part.  Wrapping u32 addition and XOR are order-free, so the result is
//   bit-exact whatever order the blocks run in;
// - everything goes by value in one parameter block (__grid_constant__):
//   no host-to-device copy, no allocation, no synchronisation, so the two
//   launches are safe inside a CUDA graph.  More than kMaxComps components
//   take one launch pair per chunk; a later chunk XORs its parts into out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxComps = 16;
constexpr int kThreads = 256;
constexpr int kFinWarps = 16;

struct Comp {
  const uint32_t* lanes;  // [k, n, nlanes] u32 bit patterns
  const uint8_t* has;     // [k, n] bool
  int32_t nlanes;
  uint32_t tag[2];
  int32_t pad;
};

// Mirrored field for field by FoldParams in ops/checksum_fold.py.
struct Params {
  Comp comp[kMaxComps];
  const int32_t* ids;        // [k, n]
  const uint8_t* alive;      // [k, n] bool
  const uint8_t* pending;    // [k, n] bool
  const int32_t* next_id;    // [k]
  uint32_t* partials;        // [k, 2 * ncomp + 1, blocks_x]
  int64_t* out;              // [k, 1 + ncomp_total, 2]: checksum, then parts
  int64_t n;
  uint32_t entity_tag[2];
  int32_t k;
  int32_t ncomp;        // components of this chunk
  int32_t comp0;        // the chunk's first component
  int32_t ncomp_total;
  int32_t blocks_x;     // blocks per frame
  int32_t vec;          // 1: groups of 4 rows with 16-byte loads
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// mix32(h, k) = mix_state(h, mix_key(k)); the key half is seed-independent.
__device__ __forceinline__ uint32_t mix_key(uint32_t k) {
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  return k * 0x1B873593u;
}

__device__ __forceinline__ uint32_t mix_state(uint32_t h, uint32_t kk) {
  h ^= kk;
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

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void fold_lane(uint32_t& h0, uint32_t& h1, uint32_t w) {
  const uint32_t kk = mix_key(w);
  h0 = mix_state(h0, kk);
  h1 = mix_state(h1, kk);
}

// Ends a row's hash for both seeds and adds it, times keep (0 or 1), to s.
__device__ __forceinline__ void finish_row(uint32_t h0, uint32_t h1, uint32_t L,
                                           uint32_t kid, uint32_t keep,
                                           uint32_t& s0, uint32_t& s1) {
  h0 = fmix32(mix_state(fmix32(h0 ^ L), kid));
  h1 = fmix32(mix_state(fmix32(h1 ^ L), kid));
  s0 += h0 * keep;
  s1 += h1 * keep;
}

// Grid (blocks_x, k).  Block (bx, f) walks groups bx, bx + blocks_x, ... of
// frame f and writes its 2 * ncomp component sums and its active count to
// partials[f, :, bx].
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
fold_kernel(const __grid_constant__ Params p) {
  constexpr int R = kVec ? 4 : 1;
  extern __shared__ uint32_t acc[];  // [2 * ncomp + 1][kThreads]
  const int tid = threadIdx.x;
  const int f = blockIdx.y;
  const int nc = p.ncomp;
  for (int s = 0; s < 2 * nc; ++s) acc[s * kThreads + tid] = 0u;
  uint32_t count = 0u;
  const int64_t fbase = (int64_t)f * p.n;
  const int64_t groups = p.n / R;
  const int64_t stride = (int64_t)p.blocks_x * kThreads;
  for (int64_t g = (int64_t)blockIdx.x * kThreads + tid; g < groups; g += stride) {
    const int64_t row0 = fbase + g * R;
    uint32_t active;  // one byte per row, 0 or 1
    uint32_t kid[R];
    if constexpr (kVec) {
      const uint32_t a = __ldg(reinterpret_cast<const uint32_t*>(p.alive + row0));
      const uint32_t d = __ldg(reinterpret_cast<const uint32_t*>(p.pending + row0));
      const int4 id = __ldg(reinterpret_cast<const int4*>(p.ids + row0));
      active = a & ~d & 0x01010101u;
      kid[0] = mix_key((uint32_t)id.x);
      kid[1] = mix_key((uint32_t)id.y);
      kid[2] = mix_key((uint32_t)id.z);
      kid[3] = mix_key((uint32_t)id.w);
    } else {
      active = (uint32_t)(__ldg(p.alive + row0) & ~__ldg(p.pending + row0)) & 1u;
      kid[0] = mix_key((uint32_t)__ldg(p.ids + row0));
    }
    count += __popc(active);
    for (int c = 0; c < nc; ++c) {
      const Comp& cp = p.comp[c];
      const uint32_t L = (uint32_t)cp.nlanes;
      const uint32_t* ln = cp.lanes + row0 * L;
      uint32_t has;
      if constexpr (kVec) {
        has = __ldg(reinterpret_cast<const uint32_t*>(cp.has + row0));
      } else {
        has = __ldg(cp.has + row0);
      }
      const uint32_t keep = active & has;
      uint32_t h0[R], h1[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        h0[r] = cp.tag[0];
        h1[r] = cp.tag[1];
      }
      bool folded = false;
      if constexpr (kVec) {
        if (L == 1) {
          const int4 v = __ldg(reinterpret_cast<const int4*>(ln));
          fold_lane(h0[0], h1[0], (uint32_t)v.x);
          fold_lane(h0[1], h1[1], (uint32_t)v.y);
          fold_lane(h0[2], h1[2], (uint32_t)v.z);
          fold_lane(h0[3], h1[3], (uint32_t)v.w);
          folded = true;
        } else if (L == 2) {
          const int4 a = __ldg(reinterpret_cast<const int4*>(ln));
          const int4 b = __ldg(reinterpret_cast<const int4*>(ln + 4));
          fold_lane(h0[0], h1[0], (uint32_t)a.x);
          fold_lane(h0[0], h1[0], (uint32_t)a.y);
          fold_lane(h0[1], h1[1], (uint32_t)a.z);
          fold_lane(h0[1], h1[1], (uint32_t)a.w);
          fold_lane(h0[2], h1[2], (uint32_t)b.x);
          fold_lane(h0[2], h1[2], (uint32_t)b.y);
          fold_lane(h0[3], h1[3], (uint32_t)b.z);
          fold_lane(h0[3], h1[3], (uint32_t)b.w);
          folded = true;
        }
      }
      if (!folded) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          for (uint32_t j = 0; j < L; ++j) fold_lane(h0[r], h1[r], __ldg(ln + r * L + j));
        }
      }
      uint32_t s0 = 0u, s1 = 0u;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        finish_row(h0[r], h1[r], L, kid[r], (keep >> (8 * r)) & 1u, s0, s1);
      }
      acc[(2 * c) * kThreads + tid] += s0;
      acc[(2 * c + 1) * kThreads + tid] += s1;
    }
  }
  acc[(2 * nc) * kThreads + tid] = count;
  __syncthreads();
  const int slots = 2 * nc + 1;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int s = warp; s < slots; s += kThreads / 32) {
    uint32_t v = 0u;
    for (int i = lane; i < kThreads; i += 32) v += acc[s * kThreads + i];
    v = warp_sum(v);
    if (lane == 0) p.partials[((int64_t)f * slots + s) * p.blocks_x + blockIdx.x] = v;
  }
}

// Grid k, block (32, kFinWarps).  Reduces frame f's partials, applies the
// tags, writes the parts and XORs them (with the entity part, for the first
// chunk; with out's earlier value, for a later one) into out[f, 0, :].
__global__ void __launch_bounds__(32 * kFinWarps)
finalize_kernel(const __grid_constant__ Params p) {
  __shared__ uint32_t part[2][kMaxComps];
  __shared__ uint32_t count;
  const int f = blockIdx.x;
  const int nc = p.ncomp;
  const int slots = 2 * nc + 1;
  for (int s = threadIdx.y; s < slots; s += kFinWarps) {
    const uint32_t* src = p.partials + ((int64_t)f * slots + s) * p.blocks_x;
    uint32_t v = 0u;
    for (int b = threadIdx.x; b < p.blocks_x; b += 32) v += src[b];
    v = warp_sum(v);
    if (threadIdx.x == 0) {
      if (s == 2 * nc) {
        count = v;
      } else {
        const int c = s >> 1;
        const int seed = s & 1;
        const uint32_t h = fmix32(v ^ p.comp[c].tag[seed]);
        part[seed][c] = h;
        p.out[((int64_t)f * (p.ncomp_total + 1) + 1 + p.comp0 + c) * 2 + seed] = (int64_t)h;
      }
    }
  }
  __syncthreads();
  if (threadIdx.y == 0 && threadIdx.x < 2) {
    const int seed = threadIdx.x;
    uint32_t x = 0u;
    for (int c = 0; c < nc; ++c) x ^= part[seed][c];
    int64_t* o = p.out + (int64_t)f * (p.ncomp_total + 1) * 2 + seed;
    if (p.comp0 == 0) {
      uint32_t h = p.entity_tag[seed];
      h = mix_state(h, mix_key(count));
      h = mix_state(h, mix_key((uint32_t)p.next_id[f]));
      x ^= fmix32(h);
    } else {
      x ^= (uint32_t)*o;
    }
    *o = (int64_t)x;
  }
}

}  // namespace

extern "C" int checksum_fold_max_comps() { return kMaxComps; }
extern "C" int checksum_fold_threads() { return kThreads; }
extern "C" int checksum_fold_params_size() { return (int)sizeof(Params); }

// Launch one chunk's fold and finalisation on `stream`, on `device`.
// Returns cudaGetLastError() (0 on success).
// `params` points to a Params (a void pointer: Params has internal linkage).
extern "C" int checksum_fold_launch(int device, const void* params, void* stream) {
  const Params* p = static_cast<const Params*>(params);
  if (p->k <= 0 || p->k > 65535 || p->n <= 0 || p->ncomp < 0 ||
      p->ncomp > kMaxComps || p->blocks_x <= 0 || (p->vec && p->n % 4 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)p->blocks_x, (unsigned)p->k);
  const size_t smem = (size_t)(2 * p->ncomp + 1) * kThreads * sizeof(uint32_t);
  if (p->vec) {
    fold_kernel<true><<<grid, kThreads, smem, s>>>(*p);
  } else {
    fold_kernel<false><<<grid, kThreads, smem, s>>>(*p);
  }
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    finalize_kernel<<<(unsigned)p->k, dim3(32, kFinWarps), 0, s>>>(*p);
    err = cudaGetLastError();
  }
  if (current != device) cudaSetDevice(current);
  return (int)err;
}
