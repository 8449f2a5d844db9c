// Bytes per second from L2 into shared memory on the card, for three ways of
// copying a 16 KB tile: cp.async with each warp reading 4 whole 128-byte
// rows, cp.async with each warp reading 64 bytes of 8 rows 2 KB apart (the
// residual-block kernel's first copy pattern), and one bulk copy
// (cp.async.bulk) per tile.  Built and run by tools/torch_port_l2_bandwidth.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16384;
constexpr int STAGES = 3;
constexpr int THREADS = 128;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ int tile_of(int t, int n_tiles) {
  return (blockIdx.x * 7 + t * 131) % n_tiles;
}

// kRows false: thread k copies bytes 16k.. of a contiguous tile.  kRows true:
// lane -> (row lane % 8, 16-byte chunk lane / 8) over 128 rows 2 KB apart.
template <bool kRows>
__global__ void cp_async_tiles(const uint8_t* buf, int n_tiles, int iters, float* sink) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
  const int lr = threadIdx.x % 8, chunk = (threadIdx.x / 8) % 8, grp = threadIdx.x / 64;
  for (int t = 0; t < iters; ++t) {
    const uint32_t dst = s0 + (t % STAGES) * TILE;
    if (kRows) {
      const uint8_t* src = buf + (size_t)tile_of(t, n_tiles) * TILE * 16;
      for (int i = 0; i < 8; ++i) {
        const int row = grp * 8 + lr + 16 * i;
        cp_async16(dst + ((grp + 2 * i) * 8 + chunk) * 128 + lr * 16,
                   src + (size_t)row * 2048 + chunk * 16);
      }
    } else {
      const uint8_t* src = buf + (size_t)tile_of(t, n_tiles) * TILE;
      for (int k = threadIdx.x; k < TILE / 16; k += THREADS) cp_async16(dst + 16 * k, src + 16 * k);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 1) : "memory");
    __syncthreads();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) sink[blockIdx.x] = smem[5];
}

__global__ void bulk_tiles(const uint8_t* buf, int n_tiles, int iters, float* sink) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t bar[STAGES];
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"((uint32_t)__cvta_generic_to_shared(&bar[s])));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int t) {
    const uint32_t b = (uint32_t)__cvta_generic_to_shared(&bar[t % STAGES]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(b), "r"(TILE) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 :: "r"(s0 + (t % STAGES) * TILE), "l"(buf + (size_t)tile_of(t, n_tiles) * TILE),
                    "r"(TILE), "r"(b) : "memory");
  };
  if (threadIdx.x == 0)
    for (int t = 0; t < STAGES - 1 && t < iters; ++t) issue(t);
  for (int t = 0; t < iters; ++t) {
    const uint32_t b = (uint32_t)__cvta_generic_to_shared(&bar[t % STAGES]);
    asm volatile("{\n.reg .pred p;\nWAIT: mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
                 "@!p bra WAIT;\n}\n" :: "r"(b), "r"((t / STAGES) & 1) : "memory");
    __syncthreads();
    if (threadIdx.x == 0 && t + STAGES - 1 < iters) issue(t + STAGES - 1);
  }
  if (threadIdx.x == 0) sink[blockIdx.x] = smem[5];
}

}  // namespace

// pattern 0: whole rows, 1: 8 rows x 64 B, 2: bulk.  buf holds n_tiles
// tiles (n_tiles * 16 of them for pattern 1); sink [blocks] float32.
extern "C" int copy_tiles(int pattern, const void* buf, int n_tiles, int blocks, int iters,
                          void* sink) {
  const int smem = STAGES * TILE;
  const void* fns[3] = {(const void*)cp_async_tiles<false>, (const void*)cp_async_tiles<true>,
                        (const void*)bulk_tiles};
  if (pattern < 0 || pattern > 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fns[pattern],
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const uint8_t* b = (const uint8_t*)buf;
  if (pattern == 0) cp_async_tiles<false><<<blocks, THREADS, smem>>>(b, n_tiles, iters, (float*)sink);
  if (pattern == 1) cp_async_tiles<true><<<blocks, THREADS, smem>>>(b, n_tiles, iters, (float*)sink);
  if (pattern == 2) bulk_tiles<<<blocks, THREADS, smem>>>(b, n_tiles, iters, (float*)sink);
  return (int)cudaGetLastError();
}
