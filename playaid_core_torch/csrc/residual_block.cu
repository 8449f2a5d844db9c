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
// Bound on an H100: operations.  At B=48, C=512 the two convs are
// 2 * 2 * 768 * 512 * 4608 = 7.25 GFLOP against about 21 MB of float32
// weights and activations (0.0063 ms at 3.35 TB/s).  In bfloat16 that is
// 0.0073 ms at 989 TFLOP/s.  Float32 runs as 3xTF32 (below), three TF32
// products per product, 0.044 ms at 495 TFLOP/s.
//
// Design:
// - Operands.  A is the NHWC activations gathered per tap, B the weights
//   packed once by the wrapper as [C_out, 9*C_in]; both are K-major, which
//   is what wgmma needs for TF32 and takes for bf16.
// - Tensor cores.  One warpgroup a block issues wgmma.mma_async m64n64
//   (k16 bf16, k8 tf32) from shared memory, with float32 accumulators in
//   registers.  bf16: one wgmma per 32-byte depth step.  float32: 3xTF32,
//   a = a_hi + a_lo with a_hi = tf32(a), a_lo = tf32(a - a_hi), summed as
//   a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (error about 1e-6 of the output's
//   scale, where one TF32 pass is off by about 3e-4).  The weights' halves
//   are split at pack time; each thread splits the activations it copied,
//   in place in shared memory, after its copies land.  Each slice's
//   products go to a fresh accumulator that is added to the block's sum on
//   the CUDA cores: summed over the whole depth of C=512 inside the tensor
//   cores, the float32 result kept too few bits and landed within a few
//   times of the 1e-4 gate.
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
// - Filling the SMs.  Tiles of 64 pixels x 64 channels, and split-K: a
//   cluster of 2 blocks shares a tile, each takes half of the depth, and
//   block 1 hands its partial sums to block 0 through distributed shared
//   memory before block 0's epilogue.  At B=48 (M=768, N=512) that is
//   12 x 8 x 2 = 192 blocks for 132 SMs, at 96 KB (f32) or 48 KB (bf16) of
//   shared memory and one warpgroup each, so two or more share an SM and
//   all 192 are resident at once.  (128x128 tiles would give 24 blocks;
//   64x32 tiles without split-K give 192 too, but read the activations
//   from L2 twice as often.)
// - The block runs as two launches of one kernel.  The first writes
//   relu(conv1 * s1 + b1), rounded to the input type, to a scratch tensor
//   that the wrapper allocates (1.5 MB at B=48; it stays in L2); the second
//   reads it, adds conv2 * s2 + b2 and the residual x, and applies the last
//   relu.  The order of operations is the reference's.  Any B works: the
//   last row tile is masked.  C must divide by 64.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;                   // output pixels a block (wgmma M)
constexpr int BN = 64;                   // output channels a block (wgmma N)
constexpr int STAGES = 3;                // cp.async ring depth
constexpr int KSPLIT = 2;                // blocks of a cluster that split the depth
constexpr int SLICE = 128;               // bytes of depth a stage: one swizzled row
constexpr int THREADS = 128;             // one warpgroup
constexpr int NACC = BN / 2;             // accumulators a thread
constexpr int A_BYTES = BM * SLICE;
constexpr int B_BYTES = BN * SLICE;
constexpr int ROWS_STEP = THREADS / 8;   // rows one pass of the block copies
constexpr int A_COPIES = BM / ROWS_STEP;
constexpr int B_COPIES = BN / ROWS_STEP;

template <typename T> struct Traits;
// float32: TF32 hi and lo halves of both operands, 4 values a chunk.
template <> struct Traits<float> { static constexpr int kHalves = 2, kPerChunk = 4; };
template <> struct Traits<__nv_bfloat16> { static constexpr int kHalves = 1, kPerChunk = 8; };

template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return Traits<T>::kHalves * (A_BYTES + B_BYTES);
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
__device__ __forceinline__ void fence_acc(float (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define F8(d, o) "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), \
                 "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// d[64 x BN] (+)= a[64 x 32 B] * b[BN x 32 B]^T from K-major shared memory;
// scale_d 0 overwrites d.  TF32 (k8) or bf16 (k16).
template <typename T> struct Mma;
#define D32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
template <> struct Mma<float> {
  static __device__ __forceinline__ void run(float (&d)[NACC], uint64_t da, uint64_t db, int sd) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " D32
                 ", %32, %33, p, 1, 1;\n}\n"
                 : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24) : "l"(da), "l"(db), "r"(sd));
  }
};
template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[NACC], uint64_t da, uint64_t db, int sd) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " D32
                 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24) : "l"(da), "l"(db), "r"(sd));
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

// out[m, n] = relu(conv3x3(in, w)[m, n] * scale[n] + bias[n] (+ residual[m, n]))
// in, residual, out: [B, H, W, C] in T; wp: [halves, C, 9*C] K-major in T;
// C % 64 == 0.  Grid (C / BN, ceil(M / BM), KSPLIT), clusters of KSPLIT
// blocks along z.
template <typename T, bool kResidual>
__global__ void __cluster_dims__(1, 1, KSPLIT) __launch_bounds__(THREADS)
conv3x3_wgmma_kernel(const T* __restrict__ in, const T* __restrict__ wp,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     const T* __restrict__ residual, T* __restrict__ out,
                     int m_total, int h, int wd, int c) {
  constexpr int kHalves = Traits<T>::kHalves;
  constexpr int kPerChunk = Traits<T>::kPerChunk;
  constexpr int kStage = stage_bytes<T>();
  constexpr int kDepth = SLICE / sizeof(T);  // depth values a stage
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t smem0 = (uint32_t)__cvta_generic_to_shared(smem);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int depth = 9 * c;
  const int nk = depth / kDepth;
  const int k_begin = blockIdx.z * nk / KSPLIT;
  const int k_count = (blockIdx.z + 1) * nk / KSPLIT - k_begin;

  // Copy roles: thread tid copies 16-byte chunk `chunk` of rows row0 +
  // ROWS_STEP * i of each tile.  Eight neighbouring threads read one whole
  // 128-byte row (a warp reads 4 full cache lines) and write it to one row
  // of shared memory, its chunks permuted by the swizzle (chunk ^ row % 8),
  // without bank conflicts.
  const int chunk = tid % 8;
  const int row0 = tid / 8;
  const uint32_t my_off = row0 * SLICE + ((chunk ^ (row0 % 8)) * 16);
  constexpr uint32_t kStep = ROWS_STEP * SLICE;

  // The output pixels of this thread's A rows, decomposed once.
  int a_b[A_COPIES], a_y[A_COPIES], a_x[A_COPIES];
#pragma unroll
  for (int i = 0; i < A_COPIES; ++i) {
    const int m = m0 + row0 + ROWS_STEP * i;
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
    for (int i = 0; i < A_COPIES; ++i) {
      const int y = a_y[i] + dy;
      const int x = a_x[i] + dx;
      const bool ok = a_b[i] >= 0 && y >= 0 && y < h && x >= 0 && x < wd;
      const T* src = ok ? in + ((size_t)(a_b[i] * h + y) * wd + x) * c + ci : in;
      cp_async16(st + my_off + i * kStep, src, ok ? 16 : 0);
    }
#pragma unroll
    for (int half = 0; half < kHalves; ++half) {
#pragma unroll
      for (int i = 0; i < B_COPIES; ++i) {
        const int n = n0 + row0 + ROWS_STEP * i;
        const T* src = wp + ((size_t)half * c + n) * depth + k0 + chunk * kPerChunk;
        cp_async16(st + kHalves * A_BYTES + half * B_BYTES + my_off + i * kStep, src, 16);
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
      for (int i = 0; i < A_COPIES; ++i) {
        float4* hi = (float4*)(smem + slot * kStage + my_off + i * kStep);
        float4* lo = (float4*)(smem + slot * kStage + A_BYTES + my_off + i * kStep);
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
    fence_acc(part);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < SLICE / 32; ++s) {  // 32-byte depth steps
      const uint64_t a_hi = smem_desc(st + s * 32);
      const uint64_t b_hi = smem_desc(st + kHalves * A_BYTES + s * 32);
      if constexpr (kHalves == 2) {
        const uint64_t a_lo = smem_desc(st + A_BYTES + s * 32);
        const uint64_t b_lo = smem_desc(st + 2 * A_BYTES + B_BYTES + s * 32);
        Mma<T>::run(part, a_lo, b_hi, s > 0);
        Mma<T>::run(part, a_hi, b_lo, 1);
        Mma<T>::run(part, a_hi, b_hi, 1);
      } else {
        Mma<T>::run(part, a_hi, b_hi, s > 0);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] += part[i];
  }

  if constexpr (KSPLIT > 1) {
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
      for (int i = 0; i < NACC; ++i) red[i * THREADS + tid] = acc[i];
    }
    cluster_sync();
    if (rank == 0) {
#pragma unroll
      for (int p = 1; p < KSPLIT; ++p) {
        uint32_t remote;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                     : "=r"(remote) : "r"(smem0), "r"(p));
#pragma unroll
        for (int i = 0; i < NACC; ++i) {
          float v;
          asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
                       : "=f"(v) : "r"(remote + (uint32_t)(i * THREADS + tid) * 4));
          acc[i] += v;
        }
      }
    }
    cluster_sync();  // the partial sums stay readable until block 0 has them
    if (rank != 0) return;
  }

  // Accumulator layout of wgmma m64nN: warp w holds rows 16w + lane/4 (+8),
  // and for each 8-column block j the columns 8j + 2*(lane%4) (+1).
  const int warp = tid / 32;
  const int lane = tid % 32;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int m = m0 + warp * 16 + lane / 4 + 8 * hr;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      const size_t o = (size_t)m * c + n;
      float v0 = acc[4 * j + 2 * hr] * scale[n] + bias[n];
      float v1 = acc[4 * j + 2 * hr + 1] * scale[n + 1] + bias[n + 1];
      if (kResidual) {
        const float2 r = load2(residual + o);
        v0 += r.x;
        v1 += r.y;
      }
      store2(out + o, fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
    }
  }
}

template <typename T>
int launch_block(const void* x, const void* w1, const void* s1, const void* b1,
                 const void* w2, const void* s2, const void* b2, void* mid,
                 void* out, int batch, int h, int wd, int c, void* stream) {
  const int m_total = batch * h * wd;
  if (c % 64 != 0) return (int)cudaErrorInvalidValue;
  if (m_total == 0) return (int)cudaSuccess;
  constexpr int smem = STAGES * stage_bytes<T>();
  static_assert(smem >= NACC * THREADS * 4, "the split-K partial sums reuse the ring");
  // Above 48 KB of dynamic shared memory a kernel must opt in, once per
  // device.
  static unsigned configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!(configured & (1u << dev))) {
    err = cudaFuncSetAttribute(conv3x3_wgmma_kernel<T, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(conv3x3_wgmma_kernel<T, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured |= 1u << dev;
  }
  const dim3 grid(c / BN, (m_total + BM - 1) / BM, KSPLIT);
  cudaStream_t st = (cudaStream_t)stream;
  conv3x3_wgmma_kernel<T, false><<<grid, THREADS, smem, st>>>(
      (const T*)x, (const T*)w1, (const float*)s1, (const float*)b1, nullptr,
      (T*)mid, m_total, h, wd, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  conv3x3_wgmma_kernel<T, true><<<grid, THREADS, smem, st>>>(
      (const T*)mid, (const T*)w2, (const float*)s2, (const float*)b2,
      (const T*)x, (T*)out, m_total, h, wd, c);
  return (int)cudaGetLastError();
}

}  // namespace

// x, mid, out: [batch, h, w, c]; w1, w2: the packed weights [2, c, 9*c]
// (TF32 hi, lo) for float32 and [1, c, 9*c] for bfloat16, K-major (depth
// index tap * c + input channel); s1, b1, s2, b2: [c] float32; c % 64 == 0.
extern "C" int residual_block_f32(const void* x, const void* w1, const void* s1,
                                  const void* b1, const void* w2, const void* s2,
                                  const void* b2, void* mid, void* out,
                                  int batch, int h, int w, int c, void* stream) {
  return launch_block<float>(x, w1, s1, b1, w2, s2, b2, mid, out, batch, h, w,
                             c, stream);
}

extern "C" int residual_block_bf16(const void* x, const void* w1, const void* s1,
                                   const void* b1, const void* w2, const void* s2,
                                   const void* b2, void* mid, void* out,
                                   int batch, int h, int w, int c, void* stream) {
  return launch_block<__nv_bfloat16>(x, w1, s1, b1, w2, s2, b2, mid, out,
                                     batch, h, w, c, stream);
}
