// Packed planar YUV420 crops -> BT.601 limited-range RGB in [0, 1], stored
// channels first.
//
// Replaces the unpack of playaid_core_tpu/infer/pipeline.py:
// BatchedActionPipeline._embed_crops_yuv_impl, which XLA fused into the
// stem's program on the TPU; the port ran it as about 20 elementwise
// launches a chunk.
//
// Math, the JAX function's in the plain version's float32 operations and
// order (ops/yuv.py: yuv420_to_rgb_ref): chroma upsampled 2x by nearest
// neighbour, yc = 1.164383 * (y - 16), r = yc + 1.596027 * (v - 128),
// g = yc - 0.391762 * (u - 128) - 0.812968 * (v - 128),
// b = yc + 2.017232 * (u - 128), clamp to [0, 255], then / 255 as PyTorch
// divides a CUDA tensor by a scalar: a product with float(1 / 255).  Every
// operation is an explicit round-to-nearest intrinsic, so nothing is
// contracted into a fused multiply-add and the output equals the plain
// version's on the card bit for bit (on the CPU the plain version divides,
// at most one ulp away).  The constants are the Python doubles rounded to
// float, as PyTorch rounds a scalar for a float32 tensor.
//
// Bound on an H100: bytes.  A chunk of 48 128-px crops reads 1,179,648 B
// and writes 9,437,184 B of float32, 3.17 us at 3.35 TB/s; the arithmetic
// is about 15 operations an output value.
//
// Design: one thread a 2x2 luma quad, which shares one U and one V sample:
// it reads 4 Y, 1 U and 1 V and writes 12 floats as six 8-byte stores,
// two rows of two pixels in each of the three channel planes.  A warp
// covers 32 neighbouring quads of one quad row, so each of its loads and
// stores is one contiguous span.  The output is [N, 3, S, S] (NCHW): the
// wrapper returns its [N, S, S, 3] view, and the stem's permute back to
// channels first is then a contiguous tensor, which cuDNN takes as it is.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float unit(float x) {
  return __fmul_rn(fminf(fmaxf(x, 0.0f), 255.0f), 1.0f / 255.0f);
}

__global__ void __launch_bounds__(THREADS)
yuv420_unpack_kernel(const uint8_t* __restrict__ yuv, float* __restrict__ out, int n, int s) {
  const int h = s / 2;
  const long long quads = (long long)h * h;
  const long long q = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (q >= n * quads) return;
  const int crop = (int)(q / quads);
  const int r = (int)(q % quads);
  const int i = r / h;
  const int j = r % h;
  const size_t plane = (size_t)s * s;
  const uint8_t* src = yuv + (size_t)crop * (plane + 2 * (size_t)h * h);
  const float du = __fsub_rn((float)src[plane + r], 128.0f);
  const float dv = __fsub_rn((float)src[plane + (size_t)h * h + r], 128.0f);
  const float cr = __fmul_rn(static_cast<float>(1.596027), dv);
  const float cgu = __fmul_rn(static_cast<float>(0.391762), du);
  const float cgv = __fmul_rn(static_cast<float>(0.812968), dv);
  const float cb = __fmul_rn(static_cast<float>(2.017232), du);
  float* dst = out + (size_t)crop * 3 * plane;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const size_t row = (size_t)(2 * i + dy) * s + 2 * j;
    float rgb[3][2];
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const float yc =
          __fmul_rn(static_cast<float>(1.164383), __fsub_rn((float)src[row + dx], 16.0f));
      rgb[0][dx] = unit(__fadd_rn(yc, cr));
      rgb[1][dx] = unit(__fsub_rn(__fsub_rn(yc, cgu), cgv));
      rgb[2][dx] = unit(__fadd_rn(yc, cb));
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
      *reinterpret_cast<float2*>(dst + c * plane + row) = make_float2(rgb[c][0], rgb[c][1]);
  }
}

}  // namespace

// yuv [n, s * s * 3 / 2] uint8 (Y, then U, then V, each plane row-major);
// out [n, 3, s, s] float32, 8-byte aligned; s even.
extern "C" int yuv420_unpack(const void* yuv, void* out, int n, int s, void* stream) {
  if (n == 0 || s == 0) return (int)cudaSuccess;
  if (s % 2 != 0 || (uintptr_t)out % 8 != 0) return (int)cudaErrorInvalidValue;
  const long long quads = (long long)n * (s / 2) * (s / 2);
  const unsigned blocks = (unsigned)((quads + THREADS - 1) / THREADS);
  yuv420_unpack_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)yuv, (float*)out, n, s);
  return (int)cudaGetLastError();
}
