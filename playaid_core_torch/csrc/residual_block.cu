// Fused identity ResNet BasicBlock at inference:
//   relu(bn2(conv3x3(relu(bn1(conv3x3(x, w1))), w2)) + x)
// with batch norm folded into a per-channel scale and bias.
//
// Replaces the TPU kernel playaid_core_tpu/ops/pallas_conv_block.py:
// pallas_residual_block (_block_kernel).  On the TPU one program held both
// weight tensors in VMEM and ran each 3x3 conv as nine shifted
// [TB*16, C] x [C, C] matrix products.  Here each conv is an implicit GEMM
// on Hopper's tensor cores: rows are output pixels (M = B*H*W), columns
// output channels (N = C), depth is tap * C + input channel (K = 9*C).
//
// Bound on an H100: operations.  A ResNet's identity blocks all do the same
// work a pixel row of the input crop: at B=48 and 128-px crops, 32x32x64,
// 16x16x128, 8x8x256 and 4x4x512 are each 2 * 2 * M * C * 9C = 7.25 GFLOP
// (0.044 ms as 3xTF32 at 495 TFLOP/s; in bfloat16 0.0073 ms at 989), against
// 22 MB (C=512) to 25 MB (C=64) of float32 weights and activations, each
// read or written once (0.0066-0.0076 ms at 3.35 TB/s).  Float32 runs as
// 3xTF32 (below), three TF32 products per product.
//
// Design:
// - Operands.  A is the NHWC activations gathered per tap, B the weights
//   packed once by the wrapper as [C_out, 9*C_in]; both are K-major, which
//   is what wgmma needs for TF32 and takes for bf16.
// - Tensor cores.  Each warpgroup of a block runs wgmma.mma_async m64nBN
//   (BN = 64 or 128; k16 bf16, k8 tf32) from shared memory on its own 64
//   rows of the tile, with float32 accumulators in registers.  bf16: one
//   wgmma per 32-byte depth step.  float32: 3xTF32, a = a_hi + a_lo with
//   a_hi = tf32(a), a_lo = tf32(a - a_hi), summed as a_lo*b_hi + a_hi*b_lo
//   + a_hi*b_hi (error about 1e-6 of the output's scale, where one TF32 pass
//   is off by about 3e-4).  The weights' halves are split at pack time; each
//   thread splits the activations it copied, in place in shared memory,
//   after its copies land.  Each slice's products go to a fresh accumulator
//   that is added to the block's sum on the CUDA cores: summed over the
//   whole depth of C=512 inside the tensor cores, the float32 result kept
//   too few bits and landed within a few times of the 1e-4 gate.
// - Copies.  Every thread issues 16-byte cp.async copies into a ring of 3
//   stages of 128-byte depth slices; taps in the zero padding and rows past
//   the last pixel copy 0 source bytes and so zero-fill.  The copies of the
//   next two slices are in flight while the current slice's wgmmas run.
//   Eight neighbouring threads copy one whole 128-byte row, so a warp reads
//   four full cache lines: copies of 8 rows x 64 bytes a warp moved about a
//   third of the bytes per second out of L2 on the card (PERF.md).
// - Shared-memory layout.  K-major tiles of 128-byte rows in the 128-byte
//   swizzle that wgmma reads (layout type 1): 16-byte chunk j of row r sits
//   at chunk j ^ (r % 8), so the eight threads that write a row, and the
//   tensor cores that read 8 rows of one chunk, hit eight different banks.
// - The launch's shape.  A tile is 64 x 64, 64 x 128 or 128 x 128 (pixel
//   rows by channels; 128 rows are two warpgroups sharing the B tile).  A
//   larger tile reads fewer bytes out of L2 per product (B twice, hi and
//   lo), but fewer tiles fill fewer SMs: at 96 KB of shared memory (f32)
//   two 64 x 64 blocks share an SM, at 144 and 192 KB one block has it.
//   (128 x 64 tiles were never the fastest at any shape of the routes.)
//   Split-K: a cluster of 2 blocks shares a tile, each takes half of the
//   depth, and block 1 hands its partial sums to block 0 through
//   distributed shared memory before block 0's epilogue.  The wrapper
//   picks the tile and the split from C and M alone
//   (ops/conv_block.py:launch_shape): at 48x4x4x512 64 x 128 tiles split in
//   two, 12 x 4 x 2 = 96 blocks; at 48x16x16x128 128 x 128 tiles, 96
//   blocks with the whole depth; at 48x32x32x64 64 x 64 tiles, 768 blocks,
//   no split, where K = 576 is already short.
// - The block runs as two launches of one kernel.  The first writes
//   relu(conv1 * s1 + b1), rounded to the input type, to a scratch tensor
//   that the wrapper allocates (1.5 MB at 48x4x4x512; it stays in L2); the
//   second reads it, adds conv2 * s2 + b2 and the residual x, and applies
//   the last relu, in NHWC for a fused block that follows or channels first
//   for a cuDNN one: cuDNN took a channels-last map with layout conversions
//   and more host time (PERF.md).  The order of operations is the
//   reference's.  Any B, H and W work: the last row tile is masked.  C must
//   divide by 64 and by BN.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int STAGES = 3;    // cp.async ring depth
constexpr int SLICE = 128;   // bytes of depth a stage: one swizzled row
constexpr int WG_ROWS = 64;  // rows a warpgroup (wgmma M)

// A tile of kWG warpgroups x 64 pixel rows by kBN output channels.
template <int kWG, int kBN> struct Tile {
  static constexpr int BM = WG_ROWS * kWG;
  static constexpr int BN = kBN;
  static constexpr int THREADS = 128 * kWG;
  static constexpr int NACC = kBN / 2;            // accumulators a thread
  static constexpr int A_BYTES = BM * SLICE;
  static constexpr int B_BYTES = BN * SLICE;
  static constexpr int ROWS_STEP = THREADS / 8;   // rows one pass of the block copies
  static constexpr int A_COPIES = BM / ROWS_STEP;
  static constexpr int B_COPIES = BN / ROWS_STEP;
};

template <typename T> struct Traits;
// float32: TF32 hi and lo halves of both operands, 4 values a chunk.
template <> struct Traits<float> { static constexpr int kHalves = 2, kPerChunk = 4; };
template <> struct Traits<__nv_bfloat16> { static constexpr int kHalves = 1, kPerChunk = 8; };

template <typename T, typename Tl>
__host__ __device__ constexpr int stage_bytes() {
  return Traits<T>::kHalves * (Tl::A_BYTES + Tl::B_BYTES);
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows with the
// 128-byte swizzle: SBO 1024 B between 8-row groups, LBO unused (1), layout
// type 1.  Tiles start 1024-byte aligned; a 32-byte depth step adds 32 to
// the start address.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmmas.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define F8(d, o) "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), \
                 "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// d[64 x N] (+)= a[64 x 32 B] * b[N x 32 B]^T from K-major shared memory;
// scale_d 0 overwrites d.  TF32 (k8) or bf16 (k16), N = 64 or 128.
template <typename T, int N> struct Mma;
#define D32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define D64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
            "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
template <> struct Mma<float, 64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da, uint64_t db, int sd) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " D32
                 ", %32, %33, p, 1, 1;\n}\n"
                 : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24) : "l"(da), "l"(db), "r"(sd));
  }
};
template <> struct Mma<__nv_bfloat16, 64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da, uint64_t db, int sd) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " D32
                 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24) : "l"(da), "l"(db), "r"(sd));
  }
};
template <> struct Mma<float, 128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da, uint64_t db, int sd) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " D64
                 ", %64, %65, p, 1, 1;\n}\n"
                 : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40), F8(d, 48),
                   F8(d, 56)
                 : "l"(da), "l"(db), "r"(sd));
  }
};
template <> struct Mma<__nv_bfloat16, 128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da, uint64_t db, int sd) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " D64
                 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
                 : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40), F8(d, 48),
                   F8(d, 56)
                 : "l"(da), "l"(db), "r"(sd));
  }
};

__device__ __forceinline__ float2 load2(const float* p) { return *(const float2*)p; }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*(const __nv_bfloat162*)p);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *(float2*)p = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *(__nv_bfloat162*)p = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }

// out[m, n] = relu(conv3x3(in, w)[m, n] * scale[n] + bias[n] (+ residual[m, n]))
// in, residual: [B, H, W, C] in T; out the same, or [B, C, H, W] when
// kNchwOut; wp: [halves, C, 9*C] K-major in T; C % 64 == 0 and C % BN == 0.
// Grid (C / BN, ceil(M / BM), kSplit), in clusters of kSplit blocks along z.
// The split and the output layout are template arguments: decided at run
// time they cost 2-7% of the kernel's time (PERF.md).
template <typename T, bool kResidual, int kWG, int kBN, int kSplit, bool kNchwOut>
__global__ void __launch_bounds__(128 * kWG)
conv3x3_wgmma_kernel(const T* __restrict__ in, const T* __restrict__ wp,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     const T* __restrict__ residual, T* __restrict__ out,
                     int m_total, int h, int wd, int c) {
  using Tl = Tile<kWG, kBN>;
  constexpr int kHalves = Traits<T>::kHalves;
  constexpr int kPerChunk = Traits<T>::kPerChunk;
  constexpr int kStage = stage_bytes<T, Tl>();
  constexpr int kDepth = SLICE / sizeof(T);  // depth values a stage
  constexpr int NACC = Tl::NACC;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t smem0 = (uint32_t)__cvta_generic_to_shared(smem);

  const int tid = threadIdx.x;
  const int wg = kWG == 1 ? 0 : tid / 128;  // this thread's warpgroup: rows 64 * wg
  const int m0 = blockIdx.y * Tl::BM;
  const int n0 = blockIdx.x * Tl::BN;
  const int depth = 9 * c;
  const int nk = depth / kDepth;
  const int k_begin = blockIdx.z * nk / kSplit;
  const int k_count = (blockIdx.z + 1) * nk / kSplit - k_begin;

  // Copy roles: thread tid copies 16-byte chunk `chunk` of rows row0 +
  // ROWS_STEP * i of each tile.  Eight neighbouring threads read one whole
  // 128-byte row (a warp reads 4 full cache lines) and write it to one row
  // of shared memory, its chunks permuted by the swizzle (chunk ^ row % 8),
  // without bank conflicts.
  const int chunk = tid % 8;
  const int row0 = tid / 8;
  const uint32_t my_off = row0 * SLICE + ((chunk ^ (row0 % 8)) * 16);
  constexpr uint32_t kStep = Tl::ROWS_STEP * SLICE;

  // The output pixels of this thread's A rows, decomposed once.
  int a_b[Tl::A_COPIES], a_y[Tl::A_COPIES], a_x[Tl::A_COPIES];
#pragma unroll
  for (int i = 0; i < Tl::A_COPIES; ++i) {
    const int m = m0 + row0 + Tl::ROWS_STEP * i;
    const int p = m % (h * wd);
    a_b[i] = m < m_total ? m / (h * wd) : -1;
    a_y[i] = p / wd;
    a_x[i] = p % wd;
  }

  auto load_stage = [&](int ks, int slot) {
    const int k0 = (k_begin + ks) * kDepth;
    const int tap = k0 / c;
    const int ci = k0 - tap * c + chunk * kPerChunk;
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    const uint32_t st = smem0 + slot * kStage;
#pragma unroll
    for (int i = 0; i < Tl::A_COPIES; ++i) {
      const int y = a_y[i] + dy;
      const int x = a_x[i] + dx;
      const bool ok = a_b[i] >= 0 && y >= 0 && y < h && x >= 0 && x < wd;
      const T* src = ok ? in + ((size_t)(a_b[i] * h + y) * wd + x) * c + ci : in;
      cp_async16(st + my_off + i * kStep, src, ok ? 16 : 0);
    }
#pragma unroll
    for (int half = 0; half < kHalves; ++half) {
#pragma unroll
      for (int i = 0; i < Tl::B_COPIES; ++i) {
        const int n = n0 + row0 + Tl::ROWS_STEP * i;
        const T* src = wp + ((size_t)half * c + n) * depth + k0 + chunk * kPerChunk;
        cp_async16(st + kHalves * Tl::A_BYTES + half * Tl::B_BYTES + my_off + i * kStep, src,
                   16);
      }
    }
  };

  float acc[NACC], part[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_count) load_stage(s, s);
    cp_async_commit();
  }

  for (int ks = 0; ks < k_count; ++ks) {
    const int slot = ks % STAGES;
    cp_async_wait<STAGES - 2>();  // this thread's copies of slice ks landed
    if constexpr (kHalves == 2) {
      // Split the activations this thread copied: hi in place, lo beside.
#pragma unroll
      for (int i = 0; i < Tl::A_COPIES; ++i) {
        float4* hi = (float4*)(smem + slot * kStage + my_off + i * kStep);
        float4* lo = (float4*)(smem + slot * kStage + Tl::A_BYTES + my_off + i * kStep);
        const float4 v = *hi;
        const float4 a = make_float4(to_tf32(v.x), to_tf32(v.y), to_tf32(v.z), to_tf32(v.w));
        *lo = make_float4(to_tf32(v.x - a.x), to_tf32(v.y - a.y), to_tf32(v.z - a.z),
                          to_tf32(v.w - a.w));
        *hi = a;
      }
    }
    // Generic-proxy writes (cp.async, the split) before async-proxy reads.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // slice ks is complete; the wgmmas of ks-1 are done
    if (ks + STAGES - 1 < k_count) load_stage(ks + STAGES - 1, (ks + STAGES - 1) % STAGES);
    cp_async_commit();

    // The slice's products go to a fresh accumulator that is then added to
    // acc in float32 on the CUDA cores: the tensor cores' own accumulation
    // over the whole depth keeps fewer bits.
    const uint32_t st = smem0 + slot * kStage;
    const uint32_t a_st = st + wg * WG_ROWS * SLICE;  // this warpgroup's rows
    fence_acc(part);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < SLICE / 32; ++s) {  // 32-byte depth steps
      const uint64_t a_hi = smem_desc(a_st + s * 32);
      const uint64_t b_hi = smem_desc(st + kHalves * Tl::A_BYTES + s * 32);
      if constexpr (kHalves == 2) {
        const uint64_t a_lo = smem_desc(a_st + Tl::A_BYTES + s * 32);
        const uint64_t b_lo = smem_desc(st + 2 * Tl::A_BYTES + Tl::B_BYTES + s * 32);
        Mma<T, kBN>::run(part, a_lo, b_hi, s > 0);
        Mma<T, kBN>::run(part, a_hi, b_lo, 1);
        Mma<T, kBN>::run(part, a_hi, b_hi, 1);
      } else {
        Mma<T, kBN>::run(part, a_hi, b_hi, s > 0);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] += part[i];
  }

  if constexpr (kSplit > 1) {
    // Split-K: the other blocks of the cluster leave their partial sums in
    // their shared memory, and block 0 adds them in rank order through
    // distributed shared memory.
    uint32_t rank;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    float* red = (float*)smem;
    if (rank != 0) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) red[i * Tl::THREADS + tid] = acc[i];
    }
    cluster_sync();
    if (rank == 0) {
#pragma unroll
      for (int p = 1; p < kSplit; ++p) {
        uint32_t remote;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                     : "=r"(remote) : "r"(smem0), "r"(p));
#pragma unroll
        for (int i = 0; i < NACC; ++i) {
          float v;
          asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
                       : "=f"(v) : "r"(remote + (uint32_t)(i * Tl::THREADS + tid) * 4));
          acc[i] += v;
        }
      }
    }
    cluster_sync();  // the partial sums stay readable until block 0 has them
    if (rank != 0) return;
  }

  // Accumulator layout of wgmma m64nN: warp w of the warpgroup holds rows
  // 16w + lane/4 (+8), and for each 8-column block j the columns
  // 8j + 2*(lane%4) (+1).  Channels-first output: a warp's store covers 8
  // neighbouring pixels of 8 channels, 8 full 32-byte sectors in float32.
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int hw = h * wd;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int m = m0 + wg * WG_ROWS + warp * 16 + lane / 4 + 8 * hr;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < Tl::BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      const size_t o = (size_t)m * c + n;
      float v0 = acc[4 * j + 2 * hr] * scale[n] + bias[n];
      float v1 = acc[4 * j + 2 * hr + 1] * scale[n + 1] + bias[n + 1];
      if (kResidual) {
        const float2 r = load2(residual + o);
        v0 += r.x;
        v1 += r.y;
      }
      if constexpr (kNchwOut) {
        const size_t image = (size_t)(m / hw) * c * hw + m % hw;  // [b, 0, y, x]
        store1(out + image + (size_t)n * hw, fmaxf(v0, 0.0f));
        store1(out + image + (size_t)(n + 1) * hw, fmaxf(v1, 0.0f));
      } else {
        store2(out + o, fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
      }
    }
  }
}

// Both convs of the block at one launch shape: kWG warpgroups x kBN
// channels a tile, the depth split over kSplit blocks of a cluster; the
// second writes `out` channels first when nchw_out.
template <typename T, int kWG, int kBN, int kSplit>
int launch_tiles(const T* x, const T* w1, const float* s1, const float* b1, const T* w2,
                 const float* s2, const float* b2, T* mid, T* out, int m_total, int h,
                 int wd, int c, int nchw_out, cudaStream_t st) {
  using Tl = Tile<kWG, kBN>;
  constexpr int smem = STAGES * stage_bytes<T, Tl>();
  static_assert(smem >= Tl::NACC * Tl::THREADS * 4, "the split-K partial sums reuse the ring");
  const auto first = conv3x3_wgmma_kernel<T, false, kWG, kBN, kSplit, false>;
  const auto second_nhwc = conv3x3_wgmma_kernel<T, true, kWG, kBN, kSplit, false>;
  const auto second_nchw = conv3x3_wgmma_kernel<T, true, kWG, kBN, kSplit, true>;
  // Above 48 KB of dynamic shared memory a kernel must opt in, once per
  // device.
  static unsigned configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!(configured & (1u << dev))) {
    const decltype(first) kernels[] = {first, second_nhwc, second_nchw};
    for (const auto kernel : kernels) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
    }
    configured |= 1u << dev;
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = kSplit;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c / kBN, (m_total + Tl::BM - 1) / Tl::BM, kSplit);
  cfg.blockDim = dim3(Tl::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = kSplit > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, first, x, w1, s1, b1, static_cast<const T*>(nullptr), mid,
                           m_total, h, wd, c);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaLaunchKernelEx(&cfg, nchw_out ? second_nchw : second_nhwc,
                                 static_cast<const T*>(mid), w2, s2, b2, x, out, m_total, h, wd,
                                 c);
}

template <typename T>
int launch_block(const void* x, const void* w1, const void* s1, const void* b1,
                 const void* w2, const void* s2, const void* b2, void* mid,
                 void* out, int batch, int h, int wd, int c, int bm, int bn, int split,
                 int nchw_out, void* stream) {
  const int m_total = batch * h * wd;
  if (c % 64 != 0 || c % bn != 0 || (split != 1 && split != 2))
    return (int)cudaErrorInvalidValue;
  if (m_total == 0) return (int)cudaSuccess;
  auto run = [&](auto launch) {
    return launch((const T*)x, (const T*)w1, (const float*)s1, (const float*)b1, (const T*)w2,
                  (const float*)s2, (const float*)b2, (T*)mid, (T*)out, m_total, h, wd, c,
                  nchw_out, (cudaStream_t)stream);
  };
  const bool two = split == 2;
  if (bm == 64 && bn == 64)
    return two ? run(launch_tiles<T, 1, 64, 2>) : run(launch_tiles<T, 1, 64, 1>);
  if (bm == 64 && bn == 128)
    return two ? run(launch_tiles<T, 1, 128, 2>) : run(launch_tiles<T, 1, 128, 1>);
  if (bm == 128 && bn == 128)
    return two ? run(launch_tiles<T, 2, 128, 2>) : run(launch_tiles<T, 2, 128, 1>);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, mid: [batch, h, w, c]; out the same, or [batch, c, h, w] when nchw_out
// is not 0 (the layout a cuDNN block after the fused ones takes); w1, w2:
// the packed weights [2, c, 9*c] (TF32 hi, lo) for float32 and [1, c, 9*c]
// for bfloat16, K-major (depth index tap * c + input channel); s1, b1, s2,
// b2: [c] float32; c % 64 == 0.  The launch: tiles of 64 x 64, 64 x 128 or
// 128 x 128 (bm pixel rows by bn channels, bn dividing c), the depth split
// over `split` (1 or 2) blocks.
extern "C" int residual_block_f32(const void* x, const void* w1, const void* s1,
                                  const void* b1, const void* w2, const void* s2,
                                  const void* b2, void* mid, void* out,
                                  int batch, int h, int w, int c, int bm, int bn, int split,
                                  int nchw_out, void* stream) {
  return launch_block<float>(x, w1, s1, b1, w2, s2, b2, mid, out, batch, h, w, c, bm, bn,
                             split, nchw_out, stream);
}

extern "C" int residual_block_bf16(const void* x, const void* w1, const void* s1,
                                   const void* b1, const void* w2, const void* s2,
                                   const void* b2, void* mid, void* out,
                                   int batch, int h, int w, int c, int bm, int bn, int split,
                                   int nchw_out, void* stream) {
  return launch_block<__nv_bfloat16>(x, w1, s1, b1, w2, s2, b2, mid, out, batch, h, w, c, bm,
                                     bn, split, nchw_out, stream);
}
