// A 1x1 convolution at inference with its batch norm folded, an optional
// residual and an optional ReLU, as one GEMM on Hopper's tensor cores (K5):
//   out = act(conv1x1(x, w, stride) * scale + bias [+ residual])
// scale and bias are the folded batch norm, per output channel.
//
// Replaces no TPU kernel: the JAX package leaves ResNet-50's convolutions to
// XLA.  It was added because ResNet-50's 36 bottleneck 1x1 convolutions
// (conv1, conv3 and the downsample projections) are about half of its work
// (1.384 of 2.669 GFLOP a 128-px crop), and on cuDNN in float32 each also
// paid a batch-norm pass and, for conv3, an add and a ReLU pass over its
// output in device memory.
//
// Bound on an H100: a 48-crop chunk's 36 1x1s of ResNet-50 at 128 px are
// 66.4 GFLOP (0.134 ms at 495 TFLOP/s TF32 for one product, 0.403 ms as
// three) against 1.43 GB of float32 maps (each input pixel the stride keeps,
// output and residual once) and weights (0.426 ms at 3.35 TB/s).  At one
// TF32 pass nearly all are bound by bytes; at the three this kernel runs,
// layer 1's and half of layer 2's by bytes, layers 3's and 4's by
// operations.
//
// Design (after residual_block.cu, K2, whose machinery it shares):
// - The GEMM.  Rows are output pixels (M = B * H_out * W_out), columns
//   output channels (N = C_out), depth input channels (K = C_in).  A is
//   the activations, B the weights packed once by the wrapper as [C_out,
//   C_in] in TF32 hi and lo halves; wgmma takes TF32 operands only K-major,
//   so A is made K-major in shared memory (below).
// - Tensor cores.  Each warpgroup runs wgmma.mma_async m64nBN k8 (BN = 64 or
//   128) from shared memory on its 64 rows.  3xTF32: a = a_hi + a_lo, the
//   products a_lo*b_hi + a_hi*b_lo + a_hi*b_hi of a 32-channel depth slice
//   go to a fresh accumulator that is added to the block's sum on the CUDA
//   cores (K2 found that the tensor cores' own sum over a depth of 512 kept
//   too few bits; K reaches 2,048 here).
// - NCHW activations.  Each thread owns a 4 x 4 patch of a slice: 4
//   pixels by 4 channels.  It copies the patch with cp.async into its own
//   64 bytes of a raw ring (4 copies of 4 neighbouring pixels of one
//   channel), waits for its own copies only, transposes the patch in
//   registers, splits it into TF32 hi and lo and writes 4 rows of each into
//   the K-major tiles in the 128-byte swizzle that wgmma reads.  Eight
//   neighbouring threads write one row's eight 16-byte chunks, so the
//   writes meet no bank conflict, nor do the raw reads (the raw chunks are
//   XOR-permuted per thread).  A stride-2 projection gathers its rows with
//   4-byte copies of the strided pixels.
// - The pipeline.  The hi/lo tiles are double-buffered: while a slice's
//   wgmmas run, the threads split the next slice into the other buffer,
//   then wait for the wgmmas and add them up; one barrier a slice, after
//   which the next slice's wgmmas are issued before the copies.  K2 runs
//   its split and its wgmmas one after the other, and with one block an SM
//   the tensor cores then idle through the split, the barrier and the copies'
//   issue (about 1 us a 32-channel slice of a 64 x 64 tile alone on an SM
//   before this overlap, PERF.md).
// - Copies.  A ring of 3 stages (raw activations, weight hi and lo) keeps
//   two slices' copies in flight besides the one being split; the weights
//   are copied as K2 copies them, 8 threads a 128-byte row.
// - The launch's shape.  64 x 64, 64 x 128 or 128 x 128 tiles (rows by
//   channels), the depth split over a cluster of 1, 2 or 4 blocks whose
//   partial sums meet in block 0's registers through distributed shared
//   memory.  The wrapper picks both from M, N and K alone
//   (ops/conv1x1.py:launch_shape); the split is a template argument, as in
//   K2, where deciding it at run time cost 2-7%.
// - The epilogue keeps K2's order of operations: the product, then * scale
//   + bias, then the residual, then the ReLU, stored NCHW (a warp's store
//   covers 8 neighbouring pixels of 8 channels).
//
// The layout: NCHW, as cuDNN's 3x3 convolutions around it take their maps.
// A channels-last variant of this kernel, measured on the card against this
// one (PERF.md, K5's finding), made a 48-crop ResNet-50 trunk 5.68 device
// ms against 5.45 NCHW: K5 itself was 6% faster channels last (16-byte
// copies of a stride-2 projection's rows), cuDNN's stem, pool and 3x3s
// slower.  Only NCHW is kept.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int STAGES = 3;    // cp.async ring depth
constexpr int SLICE = 128;   // bytes of depth a stage: 32 float32 channels
constexpr int WG_ROWS = 64;  // rows a warpgroup (wgmma M)

// A tile of kWG warpgroups x 64 pixel rows by kBN output channels.
template <int kWG, int kBN> struct Tile {
  static constexpr int BM = WG_ROWS * kWG;
  static constexpr int BN = kBN;
  static constexpr int THREADS = 128 * kWG;
  static constexpr int NACC = kBN / 2;          // accumulators a thread
  static constexpr int A_BYTES = BM * SLICE;    // one K-major activation tile
  static constexpr int B_BYTES = BN * SLICE;    // one K-major weight tile
  static constexpr int ROWS_STEP = THREADS / 8; // weight rows one pass copies
  static constexpr int B_COPIES = BN / ROWS_STEP;
  static constexpr int RING = A_BYTES + 2 * B_BYTES;  // raw A, B hi, B lo
  static constexpr int SPLIT = 2 * A_BYTES;           // A hi, A lo
  static constexpr int SMEM = STAGES * RING + 2 * SPLIT;
  // Every thread owns one 4-pixel x 4-channel patch of a slice.
  static_assert(BM / 4 * 8 == THREADS, "one patch a thread");
};

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows with the
// 128-byte swizzle: SBO 1024 B between 8-row groups, LBO unused (1), layout
// type 1.  Tiles start 1024-byte aligned; a 32-byte depth step adds 32.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
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

// d[64 x N] (+)= a[64 x 32 B] * b[N x 32 B]^T, TF32 (k8), from K-major
// shared memory; scale_d 0 overwrites d.
template <int N> struct Mma;
#define D32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define D64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
            "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
template <> struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da, uint64_t db, int sd) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " D32
                 ", %32, %33, p, 1, 1;\n}\n"
                 : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24) : "l"(da), "l"(db), "r"(sd));
  }
};
template <> struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da, uint64_t db, int sd) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " D64
                 ", %64, %65, p, 1, 1;\n}\n"
                 : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40), F8(d, 48),
                   F8(d, 56)
                 : "l"(da), "l"(db), "r"(sd));
  }
};

struct Shape {
  int m_total;     // B * h_out * w_out
  int h, w;        // input map
  int h_out, w_out;
  int stride;
  int c_in, c_out;
  int residual;    // add `residual` (the output's layout and shape)
  int relu;
};

// out[m, n] = act(sum_k x[m', k] w[n, k] * scale[n] + bias[n] (+ residual[m, n]))
// with m' the input pixel under output pixel m.  x: [B, C_in, H, W]; out
// and residual: [B, C_out, H_out, W_out]; wp: [2, C_out, C_in] (TF32 hi,
// lo), K-major.
// C_in % 32 == 0, C_out % kBN == 0.  Grid (C_out / BN, ceil(M / BM), kSplit),
// in clusters of kSplit blocks along z.
template <int kWG, int kBN, int kSplit>
__global__ void __launch_bounds__(128 * kWG)
conv1x1_gemm_kernel(const float* __restrict__ in, const float* __restrict__ wp,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    const float* __restrict__ residual, float* __restrict__ out, Shape sh) {
  using Tl = Tile<kWG, kBN>;
  constexpr int NACC = Tl::NACC;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t smem0 = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t split0 = smem0 + STAGES * Tl::RING;  // the two hi/lo buffers

  const int tid = threadIdx.x;
  const int wg = kWG == 1 ? 0 : tid / 128;  // this thread's warpgroup: rows 64 * wg
  const int m0 = blockIdx.y * Tl::BM;
  const int n0 = blockIdx.x * Tl::BN;
  const int nk = sh.c_in / 32;
  const int k_begin = blockIdx.z * nk / kSplit;
  const int k_count = (blockIdx.z + 1) * nk / kSplit - k_begin;
  const int hw_in = sh.h * sh.w;
  const int hw_out = sh.h_out * sh.w_out;

  // This thread's patch: channels 4 * pj .. + 3 of the slice, pixel rows
  // 4 * pq .. + 3 of the tile.  Eight neighbouring threads share pq.
  const int pj = tid % 8;
  const int pq = tid / 8;
  // Its 64 raw bytes: part i at 16 * (i ^ ((tid >> 1) & 3)), so that eight
  // neighbouring threads' 16-byte reads fall in eight bank groups.
  const uint32_t raw_off = tid * 64;
  const int raw_perm = (tid >> 1) & 3;

  // The input element offset of each of the patch's pixels at channel 0,
  // (b * C_in) * H * W + y * W + x, or -1 past the last row.
  long long pix[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = m0 + 4 * pq + e;
    if (m >= sh.m_total) {
      pix[e] = -1;
      continue;
    }
    const int b = m / hw_out;
    const int p = m - b * hw_out;
    const int y = p / sh.w_out * sh.stride;
    const int x = p % sh.w_out * sh.stride;
    pix[e] = (long long)b * sh.c_in * hw_in + (long long)y * sh.w + x;
  }
  // Stride 1 and whole quads of pixels in an image: one 16-byte copy a
  // channel (the wrapper hands 16-byte-aligned maps).
  const bool quad = sh.stride == 1 && hw_out % 4 == 0;

  // Weight copy roles, as in K2: thread tid copies 16-byte chunk tid % 8 of
  // rows tid / 8 + ROWS_STEP * i, swizzled (chunk ^ row % 8).
  const int chunk = tid % 8;
  const int row0 = tid / 8;
  const uint32_t b_off = row0 * SLICE + ((chunk ^ (row0 % 8)) * 16);
  constexpr uint32_t kStep = Tl::ROWS_STEP * SLICE;

  auto load_stage = [&](int ks, int slot) {
    const int k0 = (k_begin + ks) * 32;
    const uint32_t st = smem0 + slot * Tl::RING;
    const uint32_t raw = st + raw_off;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t dst = raw + 16 * (i ^ raw_perm);
      const long long ch = (long long)(k0 + 4 * pj + i) * hw_in;
      if (quad) {
        const bool ok = pix[0] >= 0;
        cp_async16(dst, ok ? in + pix[0] + ch : in, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = pix[e] >= 0;
          cp_async4(dst + 4 * e, ok ? in + pix[e] + ch : in, ok ? 4 : 0);
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int i = 0; i < Tl::B_COPIES; ++i) {
        const int n = n0 + row0 + Tl::ROWS_STEP * i;
        const float* src = wp + ((size_t)half * sh.c_out + n) * sh.c_in + k0 + chunk * 4;
        cp_async16(st + Tl::A_BYTES + half * Tl::B_BYTES + b_off + i * kStep, src, 16);
      }
    }
  };

  // Slice ks's patch (v[i][e]: copy i, element e) from the raw ring, each of
  // its four pixel rows made a 16-byte chunk of 4 channels, split into TF32
  // hi and lo in hi/lo buffer ks % 2.
  auto split_slice = [&](int ks) {
    const uint8_t* raw = smem + (ks % STAGES) * Tl::RING + raw_off;
    float v[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t = *(const float4*)(raw + 16 * (i ^ raw_perm));
      v[i][0] = t.x;
      v[i][1] = t.y;
      v[i][2] = t.z;
      v[i][3] = t.w;
    }
    uint8_t* hi_tile = smem + STAGES * Tl::RING + (ks % 2) * Tl::SPLIT;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // Copy i is channel i of the 4 pixels: pixel r's 4 channels.
      const float4 a = make_float4(v[0][r], v[1][r], v[2][r], v[3][r]);
      const float4 h = make_float4(to_tf32(a.x), to_tf32(a.y), to_tf32(a.z), to_tf32(a.w));
      const float4 l = make_float4(to_tf32(a.x - h.x), to_tf32(a.y - h.y),
                                   to_tf32(a.z - h.z), to_tf32(a.w - h.w));
      const int row = 4 * pq + r;
      const uint32_t off = row * SLICE + ((pj ^ (row % 8)) * 16);
      *(float4*)(hi_tile + off) = h;
      *(float4*)(hi_tile + Tl::A_BYTES + off) = l;
    }
  };

  float acc[NACC], part[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;

  // Slice ks's products into a fresh accumulator, issued and left running.
  auto issue_mma = [&](int ks) {
    const uint32_t b_st = smem0 + (ks % STAGES) * Tl::RING + Tl::A_BYTES;
    const uint32_t a_st = split0 + (ks % 2) * Tl::SPLIT + wg * WG_ROWS * SLICE;  // its rows
    fence_acc(part);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < SLICE / 32; ++s) {  // 32-byte depth steps: 8 channels
      const uint64_t a_hi = smem_desc(a_st + s * 32);
      const uint64_t a_lo = smem_desc(a_st + Tl::A_BYTES + s * 32);
      const uint64_t b_hi = smem_desc(b_st + s * 32);
      const uint64_t b_lo = smem_desc(b_st + Tl::B_BYTES + s * 32);
      Mma<kBN>::run(part, a_lo, b_hi, s > 0);
      Mma<kBN>::run(part, a_hi, b_lo, 1);
      Mma<kBN>::run(part, a_hi, b_hi, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };

  // The pipeline: slice s's copies form commit group s.  While slice ks's
  // wgmmas run, each thread splits its patch of slice ks + 1; then it waits
  // for them and adds them to acc.  After the barrier (slice ks + 1 split by
  // all, slice ks's wgmmas done in every warpgroup) it issues slice ks + 1's
  // wgmmas, then copies slice ks + 3 into slice ks's stage.
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < k_count) load_stage(s, s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();  // this thread's copies of slice 0 landed
  split_slice(0);
  // Generic-proxy writes (cp.async, the split) before async-proxy reads.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  issue_mma(0);
  for (int ks = 0; ks < k_count; ++ks) {
    if (ks + 1 < k_count) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of slice ks + 1 landed
      split_slice(ks + 1);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] += part[i];
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (ks + 1 < k_count) issue_mma(ks + 1);
    if (ks + STAGES < k_count) load_stage(ks + STAGES, ks % STAGES);
    cp_async_commit();
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
  // 8j + 2*(lane%4) (+1).
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int m = m0 + wg * WG_ROWS + warp * 16 + lane / 4 + 8 * hr;
    if (m >= sh.m_total) continue;
    // [b, 0, y, x]
    const size_t base = (size_t)(m / hw_out) * sh.c_out * hw_out + m % hw_out;
#pragma unroll
    for (int j = 0; j < Tl::BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      const size_t o0 = base + (size_t)n * hw_out;
      const size_t o1 = o0 + hw_out;
      float v0 = acc[4 * j + 2 * hr] * scale[n] + bias[n];
      float v1 = acc[4 * j + 2 * hr + 1] * scale[n + 1] + bias[n + 1];
      if (sh.residual) {
        v0 += residual[o0];
        v1 += residual[o1];
      }
      if (sh.relu) {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      }
      out[o0] = v0;
      out[o1] = v1;
    }
  }
}

template <int kWG, int kBN, int kSplit>
int launch(const float* x, const float* w, const float* s, const float* b, const float* res,
           float* out, const Shape& sh, cudaStream_t st) {
  using Tl = Tile<kWG, kBN>;
  static_assert(Tl::SMEM >= Tl::NACC * Tl::THREADS * 4, "the split-K partial sums reuse smem");
  static_assert(Tl::SMEM <= 232448, "a block's shared memory on an H100");
  const auto kernel = conv1x1_gemm_kernel<kWG, kBN, kSplit>;
  // Above 48 KB of dynamic shared memory a kernel must opt in, once per
  // device.
  static unsigned configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!(configured & (1u << dev))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured |= 1u << dev;
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = kSplit;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sh.c_out / kBN, (sh.m_total + Tl::BM - 1) / Tl::BM, kSplit);
  cfg.blockDim = dim3(Tl::THREADS);
  cfg.dynamicSmemBytes = Tl::SMEM;
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = kSplit > 1 ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kernel, x, w, s, b, res, out, sh);
}

template <int kWG, int kBN>
int launch_split(int split, const float* x, const float* w, const float* s, const float* b,
                 const float* res, float* out, const Shape& sh, cudaStream_t st) {
  if (split == 1) return launch<kWG, kBN, 1>(x, w, s, b, res, out, sh, st);
  if (split == 2) return launch<kWG, kBN, 2>(x, w, s, b, res, out, sh, st);
  if (split == 4) return launch<kWG, kBN, 4>(x, w, s, b, res, out, sh, st);
  return (int)cudaErrorInvalidValue;
}

int launch_tiles(int bm, int bn, int split, const float* x, const float* w, const float* s,
                 const float* b, const float* res, float* out, const Shape& sh,
                 cudaStream_t st) {
  if (bm == 64 && bn == 64) return launch_split<1, 64>(split, x, w, s, b, res, out, sh, st);
  if (bm == 64 && bn == 128) return launch_split<1, 128>(split, x, w, s, b, res, out, sh, st);
  if (bm == 128 && bn == 128) return launch_split<2, 128>(split, x, w, s, b, res, out, sh, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: [batch, c_in, h, w] float32, starting 16-byte aligned; out, and
// residual when not null: [batch, c_out, h_out, w_out] with h_out =
// (h - 1) / stride + 1 (likewise w_out); w: the packed weights [2, c_out,
// c_in] (TF32 hi, lo), K-major; scale, bias: [c_out] float32.  c_in % 32
// == 0, c_out % bn == 0.  The launch: tiles of 64 x 64, 64 x 128 or 128 x
// 128 (bm pixel rows by bn channels), the depth split over `split` (1, 2
// or 4) blocks, each with at least one 32-channel slice.  relu != 0
// applies the ReLU last.
extern "C" int conv1x1_f32(const void* x, const void* w, const void* scale, const void* bias,
                           const void* residual, void* out, int batch, int h, int wd, int c_in,
                           int c_out, int stride, int bm, int bn, int split, int relu,
                           void* stream) {
  if (batch < 0 || h <= 0 || wd <= 0 || stride <= 0 || c_in <= 0 || c_in % 32 != 0 ||
      bn <= 0 || c_out <= 0 || c_out % bn != 0 || split <= 0 || c_in / 32 < split)
    return (int)cudaErrorInvalidValue;
  Shape sh;
  sh.h = h;
  sh.w = wd;
  sh.stride = stride;
  sh.h_out = (h - 1) / stride + 1;
  sh.w_out = (wd - 1) / stride + 1;
  sh.m_total = batch * sh.h_out * sh.w_out;
  sh.c_in = c_in;
  sh.c_out = c_out;
  sh.residual = residual != nullptr;
  sh.relu = relu != 0;
  if (sh.m_total == 0) return (int)cudaSuccess;
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  const float* sf = (const float*)scale;
  const float* bf = (const float*)bias;
  const float* rf = (const float*)residual;
  float* of = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  return launch_tiles(bm, bn, split, xf, wf, sf, bf, rf, of, sh, st);
}
