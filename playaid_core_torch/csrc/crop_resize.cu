// Batched square crop + letterbox + bilinear resize + BGR->RGB + /255.
//
// Replaces the TPU kernel playaid_core_tpu/ops/pallas_kernels.py:
// pallas_square_crop_resize (_crop_kernel, _axis_weight_matrix).  On the
// TPU each (crop, channel) program copied a fixed window of the frame into
// VMEM and resampled it as two matrix products with dense weight matrices
// Wy * window * Wx^T.  Those matrices have two non-zeros per row, so here
// one thread computes one output value (n, i, j, c) directly from its four
// bilinear taps in device memory: no static window, no window-size limit,
// no alignment padding.
//
// The kernel computes each crop's window from its box itself, so a call is
// one launch and no small tensor operations around it.
//
// Bound on an H100: bytes.  Each crop touches about side^2 * 3 source bytes
// and writes S^2 * 3 floats; the arithmetic is a few operations per output.
// Threads of one warp write consecutive output floats (coalesced); their
// 3-byte pixel reads are not coalesced and are served from L1/L2, where
// neighbouring outputs share taps.  Staging each crop's window in shared
// memory would coalesce the reads and is left for a later change.
//
// Numerics follow the JAX function: src = origin + (i + 0.5) * side / S -
// 0.5, floorf (not a truncating cast) for negative coordinates, weights of
// zero when src lies outside [-1, len], and taps outside the frame count
// as zero (the zero rows and columns of Wy and Wx).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void crop_resize_kernel(const uint8_t* __restrict__ frames,
                                   const float* __restrict__ boxes,
                                   float* __restrict__ out, int crop0,
                                   int boxes_per_frame, int h, int w, int s,
                                   float padding, int bgr_to_rgb, float scale) {
  // One block row per (crop, output row); threads run along (column, channel).
  const int q = crop0 + blockIdx.z;
  const int i = blockIdx.y;
  const int jc = blockIdx.x * blockDim.x + threadIdx.x;
  if (jc >= s * 3) return;
  const int j = jc / 3;
  const int c = jc - j * 3;

  // The square source window of square_window_params, in the same float32
  // operations: side = 2 * (floor(max(w_px, h_px) / 2) + padding), centred
  // on the integer centre pixel.
  const float cx = floorf(boxes[q * 4 + 0] * (float)w);
  const float cy = floorf(boxes[q * 4 + 1] * (float)h);
  const float half = floorf(fmaxf(floorf(boxes[q * 4 + 2] * (float)w),
                                  floorf(boxes[q * 4 + 3] * (float)h)) / 2.0f);
  const float side = fmaxf(2.0f * (half + padding), 1.0f);
  const float y0 = cy - half - padding;
  const float x0 = cx - half - padding;
  const float sy = y0 + (i + 0.5f) * side / s - 0.5f;
  const float sx = x0 + (j + 0.5f) * side / s - 0.5f;

  float v = 0.0f;
  if (sy >= -1.0f && sy <= (float)h && sx >= -1.0f && sx <= (float)w) {
    const float ly = floorf(sy);
    const float lx = floorf(sx);
    const float fy = sy - ly;
    const float fx = sx - lx;
    const int iy = (int)ly;
    const int ix = (int)lx;
    const float wy[2] = {1.0f - fy, fy};
    const float wx[2] = {1.0f - fx, fx};
    const int src_c = bgr_to_rgb ? 2 - c : c;
    const uint8_t* frame = frames + (size_t)(q / boxes_per_frame) * h * w * 3;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int y = iy + dy;
      if (y < 0 || y >= h) continue;
      float row = 0.0f;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int x = ix + dx;
        if (x < 0 || x >= w) continue;
        row += wx[dx] * (float)frame[((size_t)y * w + x) * 3 + src_c];
      }
      v += wy[dy] * row;
    }
  }
  out[((size_t)q * s + i) * s * 3 + jc] = v * scale;
}

}  // namespace

// frames [n_frames, h, w, 3] uint8; boxes [n_frames * boxes_per_frame, 4]
// float32 normalised (cx, cy, w, h); out [n_frames * boxes_per_frame, s, s,
// 3] float32.
extern "C" int crop_resize(const void* frames, const void* boxes, void* out,
                           int n_frames, int boxes_per_frame, int h, int w,
                           int s, float padding, int bgr_to_rgb, int normalize,
                           void* stream) {
  const int n_crops = n_frames * boxes_per_frame;
  const int threads = 128;
  const int max_z = 65535;  // grid z limit: crops go in slices of this many
  for (int crop0 = 0; crop0 < n_crops; crop0 += max_z) {
    const int nz = n_crops - crop0 < max_z ? n_crops - crop0 : max_z;
    const dim3 grid((s * 3 + threads - 1) / threads, s, nz);
    crop_resize_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)frames, (const float*)boxes, (float*)out, crop0,
        boxes_per_frame, h, w, s, padding, bgr_to_rgb,
        normalize ? 1.0f / 255.0f : 1.0f);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
