// Batched square crop + letterbox + bilinear resize + BGR->RGB + /255.
//
// Replaces the TPU kernel playaid_core_tpu/ops/pallas_kernels.py:
// pallas_square_crop_resize (_crop_kernel, _axis_weight_matrix), and the
// same resample on windows cut out on the host
// (playaid_core_tpu/ops/preprocess.py: batched_window_resize, which the
// VOD window route runs through the TPU's _crop_one) and on gathered rows
// of an image bank (playaid_core_tpu/train/device_synth.py:
// synth_composite, which resamples its sprite and stage rows through
// _crop_one).  On the
// TPU each (crop, channel) program copied a fixed window of the frame into
// VMEM and resampled it as two matrix products with dense weight matrices
// Wy * window * Wx^T.  Those matrices have two non-zeros per row, so here
// each output pixel is computed directly from its four bilinear taps.
//
// Bound on an H100: bytes.  Each crop reads the source pixels its taps
// touch (about side^2 * 3 bytes) and writes S^2 * 3 floats; the arithmetic
// is a few operations per output value.  At the main path's 48 crops of a
// 1080p frame (side 320, S 128) that is 18.88 MB, 0.0056 ms at 3.35 TB/s;
// at the shared-frame route's one frame and two crops 0.786 MB, 0.0002 ms,
// where a launch is all latency.
//
// The window route reads windows instead of frames: at its 96 windows of
// 384 x 384 (side about 320) the taps touch about 23.6 MB and the output is
// 18.9 MB, 0.013 ms at 3.35 TB/s.
//
// The bank entry of device-side synthesis reads at most each gathered row
// once and writes float32 without /255: for a batch of 16 clips of 7
// frames, 112 RGBA sprite rows of 128^2 (7.3 MB read, 29.4 MB written) and
// 16 RGB stage crops of 128^2 from 192^2 patches (about 4 MB), about 41 MB,
// 0.012 ms at 3.35 TB/s.
//
// Design (the one before it, commit 45b0240, staged each band's tap rows
// through shared memory with cp.async after three barriers; at two crops
// its 16 blocks ran 0.0104 ms, and at 48 crops reading the taps straight
// from device memory was as fast: PERF.md section 6, K1's rows):
// - Three entries, one kernel body: crop_resize takes normalised yolo boxes
//   and computes each crop's square window from them; window_resize takes
//   each window's origin and side (y0, x0, side) as floats, one crop per
//   window; bank_resize takes origins too, and a bank row index and an
//   optional mirror per crop.  The geometry source, the source row and the
//   mirror are the only differences.  The channel count (3, or 4 for the
//   bank's RGBA sprites) is a template argument.
// - Output layout.  The frames and window entries feed the stem's
//   convolution, which cuDNN takes channels first: they write
//   [n, 3, S, S] (planar), and the wrapper returns its [n, S, S, 3] view,
//   whose permute back to channels first is a contiguous tensor (as K4's
//   does).  The bank entry feeds synth_composite's channels-last arithmetic
//   and writes [n, S, S, C].
// - One warp an output row, a block of THREADS / 32 warps; the grid is
//   (crops, rows / warps), so two crops of S 128 give 128 blocks, one an
//   SM, and 48 crops 3,072.  No thread waits on another for the geometry:
//   every thread reads its crop's box or origin (one broadcast load) and
//   computes the window in the same float32 operations, so a warp's chain
//   is the box's load, the taps' loads, the stores.
// - Taps straight from device memory through the read-only cache: lane j
//   computes column j (and j + 32, ...), so each tap load of the warp is one
//   short contiguous span of the source row.  A lane issues the tap loads
//   of GROUPS columns (24 bytes for RGB at 2) before it uses any, so a
//   warp waits on memory once a pair of column groups, not once for each
//   tap row of each.  Output rows of a downscaled crop share no tap rows
//   (at the main path's side 320 to S 128 they are 2.5 source rows apart),
//   so staging them bought nothing.
// - The mirror is applied in the source column index: output column taps
//   at column x read source column w - 1 - x.
// - Stores.  The warp computes its row into a row buffer in shared memory,
//   then writes it as 16-byte stores: a plane's row of 128 floats is one
//   store instruction of the warp (planar), or 96 float4s for a row of
//   128 x 3 interleaved floats (the bank entry).
//
// Numerics follow the JAX function: src = origin + (i + 0.5) * side / S -
// 0.5, floorf (not a truncating cast) for negative coordinates, weights of
// zero when src lies outside [-1, len], and taps outside the frame count
// as zero (the zero rows and columns of Wy and Wx).  Each value is the
// same sequence of float32 operations as in the design of commit 45b0240
// (held bit for bit when it was replaced: PERF.md section 6, K1's rows).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;             // two warps, each an output row
constexpr int GROUPS = 2;               // column groups whose taps a lane loads at once
constexpr int MAX_SMEM_BYTES = 232448;  // what an H100 block can have

__device__ __forceinline__ float source_coord(float origin, int i, float side, int s) {
  return origin + (i + 0.5f) * side / s - 0.5f;
}

// The source row of tap dy (0 or 1) of output row i, or -1 where it lies
// outside the source or the output row samples outside [-1, h].
__device__ __forceinline__ int tap_row(float y0, float side, int s, int h, int i, int dy) {
  if (i >= s) return -1;
  const float sy = source_coord(y0, i, side, s);
  if (sy < -1.0f || sy > (float)h) return -1;
  const int y = (int)floorf(sy) + dy;
  return y >= 0 && y < h ? y : -1;
}

// One output row: the bilinear value of every column from its taps in
// source rows ys[0] and ys[1] of frame (a row of -1 lies outside and is
// not read), times scale, into the warp's row buffer.  A lane takes GROUPS
// columns, 32 apart, at a time and issues all their tap loads (12 for
// RGB) before it uses one, so they are in flight together.
template <int C, bool PLANAR>
__device__ __forceinline__ void compute_row(float* row_buf, const uint8_t* frame,
                                            const int (&ys)[2], float sy, float x0, float side,
                                            int s, int h, int w, bool mirror, int bgr_to_rgb,
                                            float scale, int lane) {
  const bool has[2] = {ys[0] >= 0, ys[1] >= 0};
  const bool row_in = sy >= -1.0f && sy <= (float)h;
  const float fy = sy - floorf(sy);
  const float wy[2] = {1.0f - fy, fy};
  for (int j0 = lane; j0 < s; j0 += 32 * GROUPS) {
    bool col_in[GROUPS];
    float wx[GROUPS][2];
    int ix[GROUPS];
    uint8_t tap[GROUPS][2][2][C];  // [group][dy][dx][channel]
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const int j = j0 + 32 * g;
      const float sx = source_coord(x0, j, side, s);
      col_in[g] = j < s && row_in && sx >= -1.0f && sx <= (float)w;
      const float lx = floorf(sx);
      const float fx = sx - lx;
      ix[g] = (int)lx;
      wx[g][0] = 1.0f - fx;
      wx[g][1] = fx;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int x = ix[g] + dx;
          const bool tap_in = col_in[g] && has[dy] && x >= 0 && x < w;
          const int col = mirror ? w - 1 - x : x;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int src_c = bgr_to_rgb && c < 3 ? 2 - c : c;
            tap[g][dy][dx][c] = tap_in ? __ldg(frame + ((size_t)ys[dy] * w + col) * C + src_c) : 0;
          }
        }
    }
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const int j = j0 + 32 * g;
      if (j >= s) break;
      float v[C];
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = 0.0f;
      if (col_in[g]) {
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          if (!has[dy]) continue;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            float acc = 0.0f;
#pragma unroll
            for (int dx = 0; dx < 2; ++dx) {
              const int x = ix[g] + dx;
              if (x < 0 || x >= w) continue;
              acc += wx[g][dx] * (float)tap[g][dy][dx][c];
            }
            v[c] += wy[dy] * acc;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) row_buf[PLANAR ? c * s + j : j * C + c] = v[c] * scale;
    }
  }
}

// The warp's row buffer out to output row i of crop q: each plane's row
// (planar [n, C, s, s]) or the interleaved row ([n, s, s, C]) as 16-byte
// stores where rows start 16-byte aligned.
template <int C, bool PLANAR>
__device__ __forceinline__ void store_row(float* out, const float* row_buf, int q, int i, int s,
                                          int lane) {
  if constexpr (PLANAR) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float* dst = out + (((size_t)q * C + c) * s + i) * s;
      const float* src = row_buf + c * s;
      if (s % 4 == 0) {
        for (int f = lane; f < s / 4; f += 32) ((float4*)dst)[f] = ((const float4*)src)[f];
      } else {
        for (int f = lane; f < s; f += 32) dst[f] = src[f];
      }
    }
  } else {
    float* dst = out + ((size_t)q * s + i) * s * C;
    if ((s * C) % 4 == 0) {
      for (int f = lane; f < s * C / 4; f += 32)
        ((float4*)dst)[f] = ((const float4*)row_buf)[f];
    } else {
      for (int f = lane; f < s * C; f += 32) dst[f] = row_buf[f];
    }
  }
}

// frames [n_frames, h, w, C]; crop q reads frame rows[q] when rows is given
// (a bank row; out of range reads nothing), else frame q / boxes_per_frame.
template <int C, bool PLANAR>
__global__ void __launch_bounds__(THREADS)
crop_resize_kernel(const uint8_t* __restrict__ frames, const float* __restrict__ boxes,
                   const float* __restrict__ origins, const int* __restrict__ rows,
                   const int* __restrict__ flips, float* __restrict__ out, int n_frames,
                   int boxes_per_frame, int h, int w, int s, float padding, int bgr_to_rgb,
                   float scale) {
  constexpr int WARPS = THREADS / 32;
  extern __shared__ __align__(16) float row_bufs[];

  const int q = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int src_frame = rows != nullptr ? __ldg(rows + q) : q / boxes_per_frame;
  const bool src_ok = src_frame >= 0 && src_frame < n_frames;
  const bool mirror = flips != nullptr && __ldg(flips + q) != 0;

  // The square source window: given by origins (window_resize and
  // bank_resize, side at least 1), or that of square_window_params in the
  // same float32 operations: side = 2 * (floor(max(w_px, h_px) / 2) +
  // padding), centred on the integer centre pixel.
  float y0, x0, side;
  if (origins != nullptr) {
    y0 = __ldg(origins + q * 3 + 0);
    x0 = __ldg(origins + q * 3 + 1);
    side = fmaxf(__ldg(origins + q * 3 + 2), 1.0f);
  } else {
    const float cx = floorf(__ldg(boxes + q * 4 + 0) * (float)w);
    const float cy = floorf(__ldg(boxes + q * 4 + 1) * (float)h);
    const float half = floorf(fmaxf(floorf(__ldg(boxes + q * 4 + 2) * (float)w),
                                    floorf(__ldg(boxes + q * 4 + 3) * (float)h)) / 2.0f);
    side = fmaxf(2.0f * (half + padding), 1.0f);
    y0 = cy - half - padding;
    x0 = cx - half - padding;
  }
  const uint8_t* frame = frames + (size_t)(src_ok ? src_frame : 0) * h * w * C;
  float* row_buf = row_bufs + warp * s * C;

  for (int i = blockIdx.y * WARPS + warp; i < s; i += gridDim.y * WARPS) {
    const int ys[2] = {src_ok ? tap_row(y0, side, s, h, i, 0) : -1,
                       src_ok ? tap_row(y0, side, s, h, i, 1) : -1};
    compute_row<C, PLANAR>(row_buf, frame, ys, source_coord(y0, i, side, s), x0, side, s, h,
                           w, mirror, bgr_to_rgb, scale, lane);
    __syncwarp();
    store_row<C, PLANAR>(out, row_buf, q, i, s, lane);
    __syncwarp();
  }
}

// The launch of every entry: the geometry comes from boxes or from
// origins, whichever is not null; the source row from rows when given.
template <int C, bool PLANAR>
int launch_c(const void* frames, const void* boxes, const void* origins, const void* rows,
             const void* flips, void* out, int n_frames, int n_crops, int boxes_per_frame,
             int h, int w, int s, float padding, int bgr_to_rgb, int normalize, void* stream) {
  if (n_crops == 0 || s == 0) return (int)cudaSuccess;
  constexpr int warps = THREADS / 32;
  const size_t smem = (size_t)warps * s * C * sizeof(float);
  if (smem > (size_t)MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // above 48 KB a kernel must opt in
    const cudaError_t err = cudaFuncSetAttribute(
        crop_resize_kernel<C, PLANAR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n_crops, (s + warps - 1) / warps);
  crop_resize_kernel<C, PLANAR><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)boxes, (const float*)origins, (const int*)rows,
      (const int*)flips, (float*)out, n_frames, boxes_per_frame, h, w, s, padding, bgr_to_rgb,
      normalize ? 1.0f / 255.0f : 1.0f);
  return (int)cudaGetLastError();
}

}  // namespace

// frames [n_frames, h, w, 3] uint8; boxes [n_frames *
// boxes_per_frame, 4] float32 normalised (cx, cy, w, h); out [n_frames *
// boxes_per_frame, 3, s, s] float32 (channels first).
extern "C" int crop_resize(const void* frames, const void* boxes, void* out,
                           int n_frames, int boxes_per_frame, int h, int w,
                           int s, float padding, int bgr_to_rgb, int normalize,
                           void* stream) {
  return launch_c<3, true>(frames, boxes, nullptr, nullptr, nullptr, out, n_frames,
                           n_frames * boxes_per_frame, boxes_per_frame, h, w, s, padding,
                           bgr_to_rgb, normalize, stream);
}

// windows [n, h, w, 3] uint8; origins [n, 3] float32
// window-relative (y0, x0, side); out [n, 3, s, s] float32 (channels first).
extern "C" int window_resize(const void* windows, const void* origins, void* out, int n,
                             int h, int w, int s, int bgr_to_rgb, int normalize,
                             void* stream) {
  return launch_c<3, true>(windows, nullptr, origins, nullptr, nullptr, out, n, n, 1, h, w, s,
                           0.0f, bgr_to_rgb, normalize, stream);
}

// bank [m, h, w, c] uint8, c = 3 or 4; rows [n] int32
// indices into the bank (a row out of range gives zeros); origins [n, 3]
// float32 row-relative (y0, x0, side); flips [n] int32 (non-zero mirrors
// the row left to right) or null; out [n, s, s, c] float32 (channels
// last, for synth_composite), not /255.
extern "C" int bank_resize(const void* bank, const void* rows, const void* origins,
                           const void* flips, void* out, int m, int n, int h, int w, int c,
                           int s, void* stream) {
  if (c == 3)
    return launch_c<3, false>(bank, nullptr, origins, rows, flips, out, m, n, 1, h, w, s, 0.0f,
                              0, 0, stream);
  if (c == 4)
    return launch_c<4, false>(bank, nullptr, origins, rows, flips, out, m, n, 1, h, w, s, 0.0f,
                              0, 0, stream);
  return (int)cudaErrorInvalidValue;
}
