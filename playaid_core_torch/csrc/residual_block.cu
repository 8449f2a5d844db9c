// Fused identity ResNet BasicBlock at inference:
//   relu(bn2(conv3x3(relu(bn1(conv3x3(x, w1))), w2)) + x)
// with batch norm folded into a per-channel scale and bias.
//
// Replaces the TPU kernel playaid_core_tpu/ops/pallas_conv_block.py:
// pallas_residual_block (_block_kernel).  On the TPU one program held both
// weight tensors in VMEM and ran each 3x3 conv as nine shifted
// [TB*16, C] x [C, C] matrix products.  Here each conv is an implicit GEMM:
// rows are output pixels (B*H*W), columns output channels (C), depth is
// tap * C + input channel (9*C).  Activations are gathered with zero
// padding straight from device memory into shared-memory tiles, weights
// (HWIO, i.e. [9*C, C] row-major) are read as tiles, and every product is
// accumulated in float32 registers.  The batch is not tiled by a fixed
// tile_b: the last row tile is masked, so any B works, and so do other
// spatial sizes than 4x4.
//
// The block runs as two launches of one kernel.  The first writes
// relu(conv1 * s1 + b1), rounded to the input type, to a scratch tensor
// that the wrapper allocates; the second reads it, adds conv2 * s2 + b2
// and the residual x, and applies the last relu.  The order of operations
// is the reference's: conv1, scale and bias, relu, round to the input
// type, conv2, scale and bias, + x, relu, store in the input type.
//
// Bound on an H100: operations.  At B=48, C=512 the two convs are
// 2 * 2 * 768 * 512 * 4608 = 7.2 GFLOP against about 21 MB of float32
// weights and activations.  This first kernel runs them on the CUDA cores
// (float32 FMA, bf16 inputs widened to float32), a classic register-tiled
// SGEMM: 32x32 output tiles, depth slices of 16 input channels of one tap,
// 4x2 outputs per thread, 128 threads a block.  At B=48 that is 384 blocks
// for 132 SMs; larger tiles left SMs idle and timed slower on the card
// (PERF.md).  Each thread decomposes its output pixels once, so the
// activation gather costs no integer division in the depth loop.
// Tensor cores (wgmma) and TMA-fed pipelines are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;  // output pixels per block
constexpr int BN = 32;  // output channels per block
constexpr int BK = 16;  // depth slice: input channels of one tap
constexpr int TM = 4;   // rows per thread
constexpr int TN = 2;   // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 128
constexpr int A_LOADS = BM * BK / THREADS;      // 4 activation values a thread
constexpr int B_LOADS = BK * BN / THREADS;      // 4 weight values a thread
constexpr int A_PITCH = BM + 4;                 // pad: fewer bank conflicts on stores

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// out[m, n] = relu(conv3x3(in, w)[m, n] * scale[n] + bias[n] (+ residual[m, n]))
// in, residual, out: [B, H, W, C] in T; w: [3, 3, C, C] in T; C % BK == 0.
template <typename T, bool kResidual>
__global__ void __launch_bounds__(THREADS)
conv3x3_bn_relu_kernel(const T* __restrict__ in, const T* __restrict__ w,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const T* __restrict__ residual, T* __restrict__ out,
                       int m_total, int h, int wd, int c) {
  __shared__ float a_tile[BK][A_PITCH];
  __shared__ float b_tile[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // Each thread loads the same BK-lane of A_LOADS fixed output pixels in
  // every depth slice: decompose those pixels once.
  const int a_k = tid % BK;
  int a_b[A_LOADS], a_y[A_LOADS], a_x[A_LOADS];
#pragma unroll
  for (int r = 0; r < A_LOADS; ++r) {
    const int m = m0 + tid / BK + r * (THREADS / BK);
    const int p = m % (h * wd);
    a_b[r] = m < m_total ? m / (h * wd) : -1;
    a_y[r] = p / wd;
    a_x[r] = p % wd;
  }
  const int b_k = tid / BN;
  const int b_n = n0 + tid % BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    for (int c0 = 0; c0 < c; c0 += BK) {
      // Activations: a tap in the zero padding reads nothing.
#pragma unroll
      for (int r = 0; r < A_LOADS; ++r) {
        const int y = a_y[r] + dy;
        const int x = a_x[r] + dx;
        float v = 0.0f;
        if (a_b[r] >= 0 && y >= 0 && y < h && x >= 0 && x < wd)
          v = to_float(in[((size_t)(a_b[r] * h + y) * wd + x) * c + c0 + a_k]);
        a_tile[a_k][tid / BK + r * (THREADS / BK)] = v;
      }
      // Weights: rows tap * C + c0 .. + BK of the [9*C, C] matrix.
#pragma unroll
      for (int r = 0; r < B_LOADS; ++r) {
        const int kk = b_k + r * (THREADS / BN);
        b_tile[kk][tid % BN] =
            b_n < c ? to_float(w[((size_t)tap * c + c0 + kk) * c + b_n]) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float av[TM], bw[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = a_tile[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) bw[j] = b_tile[kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += av[i] * bw[j];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= c) continue;
      const size_t o = (size_t)m * c + n;
      float v = acc[i][j] * scale[n] + bias[n];
      if (kResidual) v += to_float(residual[o]);
      out[o] = from_float<T>(fmaxf(v, 0.0f));
    }
  }
}

template <typename T>
int launch_block(const void* x, const void* w1, const void* s1, const void* b1,
                 const void* w2, const void* s2, const void* b2, void* mid,
                 void* out, int batch, int h, int wd, int c, void* stream) {
  const int m_total = batch * h * wd;
  if (c % BK != 0) return (int)cudaErrorInvalidValue;
  if (m_total == 0) return (int)cudaSuccess;
  const dim3 grid((c + BN - 1) / BN, (m_total + BM - 1) / BM);
  cudaStream_t st = (cudaStream_t)stream;
  conv3x3_bn_relu_kernel<T, false><<<grid, THREADS, 0, st>>>(
      (const T*)x, (const T*)w1, (const float*)s1, (const float*)b1, nullptr,
      (T*)mid, m_total, h, wd, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  conv3x3_bn_relu_kernel<T, true><<<grid, THREADS, 0, st>>>(
      (const T*)mid, (const T*)w2, (const float*)s2, (const float*)b2,
      (const T*)x, (T*)out, m_total, h, wd, c);
  return (int)cudaGetLastError();
}

}  // namespace

// x, mid, out: [batch, h, w, c]; w1, w2: [3, 3, c, c] (HWIO); s1, b1, s2,
// b2: [c] float32; c % 16 == 0.  x, weights, mid and out share one type.
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
