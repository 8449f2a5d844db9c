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
// 1080p frame (side 320, S 128) that is 18.88 MB, 0.0056 ms at 3.35 TB/s.
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
// Design:
// - Three entries, one kernel body: crop_resize takes normalised yolo boxes
//   and computes each crop's square window from them; window_resize takes
//   each window's origin and side (y0, x0, side) as floats, one crop per
//   window; bank_resize takes origins too, and a bank row index and an
//   optional mirror per crop.  The geometry source, the source row and the
//   mirror are the only differences.  The channel count (3, or 4 for the
//   bank's RGBA sprites) is a template argument.
// - The mirror is applied in the source column index: output column taps
//   at column x read source column w - 1 - x, and the staged span is the
//   mirror image of the taps' span.
// - One block per (crop, band of output rows).  Thread 0 reads or computes
//   the crop's window once; the block then finds the in-frame column span
//   of its bilinear taps.
// - Staging.  For each output row of the band the block stages its two
//   tap rows (at most two per output row) over that column span into
//   shared memory, with 16-byte cp.async copies from 16-byte-aligned
//   addresses: neighbouring threads copy neighbouring chunks of a row, so
//   the reads are coalesced.  Rows outside the frame are not copied and
//   count as zero.  The band height is chosen per crop so that its staged
//   rows fit the shared memory the block asks for, and a block walks over
//   further bands when a wide window needs short ones, so any window size
//   works (the TPU kernel's static window limit is gone).
// - Compute and store.  A warp takes one output row; each thread computes
//   whole RGB pixels from shared memory into a row buffer, and the warp
//   writes the row out as 16-byte stores (96 for a row of 128 x 3 floats).
//
// Numerics follow the JAX function: src = origin + (i + 0.5) * side / S -
// 0.5, floorf (not a truncating cast) for negative coordinates, weights of
// zero when src lies outside [-1, len], and taps outside the frame count
// as zero (the zero rows and columns of Wy and Wx).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BAND = 16;             // output rows a band at most
constexpr int MIN_STAGE_BYTES = 32768;   // staging room a block asks for at least
constexpr int MAX_SMEM_BYTES = 232448;   // what an H100 block can have

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// Bytes of one staged row of c channels: the tap columns' bytes from a
// 16-byte-aligned start, rounded up to whole 16-byte chunks.
__host__ __device__ __forceinline__ int row_pitch(int columns, int c) {
  return 16 * ((c * columns + 15) / 16 + 1);
}

__device__ __forceinline__ float source_coord(float origin, int i, float side, int s) {
  return origin + (i + 0.5f) * side / s - 0.5f;
}

// frames [n_frames, h, w, C]; crop q reads frame rows[q] when rows is given
// (a bank row; out of range reads nothing), else frame q / boxes_per_frame.
template <int C>
__global__ void __launch_bounds__(THREADS)
crop_resize_kernel(const uint8_t* __restrict__ frames, const float* __restrict__ boxes,
                   const float* __restrict__ origins, const int* __restrict__ rows,
                   const int* __restrict__ flips, float* __restrict__ out, int n_frames,
                   int boxes_per_frame, int h, int w, int s, float padding, int bgr_to_rgb,
                   float scale, int stage_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];  // staged rows, then row buffers
  __shared__ float win_y0, win_x0, win_side;
  __shared__ int col_lo, col_hi;
  __shared__ int slot_y[2 * MAX_BAND];      // source row of each slot, -1 if none
  __shared__ int slot_shift[2 * MAX_BAND];  // bytes from the aligned start to column col_lo

  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int src_frame = rows != nullptr ? rows[q] : q / boxes_per_frame;
  const bool src_ok = src_frame >= 0 && src_frame < n_frames;
  const bool mirror = flips != nullptr && flips[q] != 0;

  // The square source window: given by origins (window_resize and
  // bank_resize, side at least 1), or that of square_window_params in the same float32
  // operations: side = 2 * (floor(max(w_px, h_px) / 2) + padding), centred
  // on the integer centre pixel.
  if (tid == 0 && origins != nullptr) {
    win_y0 = origins[q * 3 + 0];
    win_x0 = origins[q * 3 + 1];
    win_side = fmaxf(origins[q * 3 + 2], 1.0f);
    col_lo = INT_MAX;
    col_hi = -1;
  } else if (tid == 0) {
    const float cx = floorf(boxes[q * 4 + 0] * (float)w);
    const float cy = floorf(boxes[q * 4 + 1] * (float)h);
    const float half = floorf(fmaxf(floorf(boxes[q * 4 + 2] * (float)w),
                                    floorf(boxes[q * 4 + 3] * (float)h)) / 2.0f);
    win_side = fmaxf(2.0f * (half + padding), 1.0f);
    win_y0 = cy - half - padding;
    win_x0 = cx - half - padding;
    col_lo = INT_MAX;
    col_hi = -1;
  }
  __syncthreads();
  const float y0 = win_y0, x0 = win_x0, side = win_side;

  // In-frame columns of the taps of the output columns that sample inside
  // [-1, w] (columns of the mirrored row when mirror is set).
  for (int j = tid; j < s && src_ok; j += THREADS) {
    const float sx = source_coord(x0, j, side, s);
    if (sx >= -1.0f && sx <= (float)w) {
      const int ix = (int)floorf(sx);
      atomicMin(&col_lo, max(ix, 0));
      atomicMax(&col_hi, min(ix + 1, w - 1));
    }
  }
  __syncthreads();
  const int xlo = col_lo;
  const int xhi = col_hi;
  const bool any_cols = xlo <= xhi;
  const int pitch = any_cols ? row_pitch(xhi - xlo + 1, C) : 16;
  const int nch = pitch / 16;
  const int band = min(MAX_BAND, stage_bytes / (2 * pitch));  // >= 1: the host sized it
  // The staged span in source columns: [xlo, xhi], or its mirror image.
  const int src_lo = mirror ? w - 1 - xhi : xlo;
  const uint8_t* frame = frames + (size_t)(src_ok ? src_frame : 0) * h * w * C;
  const uint8_t* frames_end = frames + (size_t)n_frames * h * w * C;
  const uint32_t stage0 = (uint32_t)__cvta_generic_to_shared(smem);
  float* row_buf = (float*)(smem + stage_bytes) + warp * s * C;

  for (int i0 = blockIdx.y * band; i0 < s; i0 += gridDim.y * band) {
    // Slots 2r and 2r + 1 hold the two tap rows of output row i0 + r.
    if (tid < 2 * band) {
      const int i = i0 + tid / 2;
      int y = -1;
      if (i < s && any_cols) {
        const float sy = source_coord(y0, i, side, s);
        if (sy >= -1.0f && sy <= (float)h) {
          const int yy = (int)floorf(sy) + (tid & 1);
          if (yy >= 0 && yy < h) y = yy;
        }
      }
      slot_y[tid] = y;
      if (y >= 0)
        slot_shift[tid] = (int)((uintptr_t)(frame + ((size_t)y * w + src_lo) * C) & 15);
    }
    __syncthreads();
    for (int e = tid; e < 2 * band * nch; e += THREADS) {
      const int slot = e / nch;
      const int k = e - slot * nch;
      const int y = slot_y[slot];
      if (y < 0) continue;
      const uint8_t* src = frame + ((size_t)y * w + src_lo) * C - slot_shift[slot] + 16 * k;
      const long long left = frames_end - src;  // the last chunk may end past the frames
      if (left > 0) cp_async16(stage0 + slot * pitch + 16 * k, src, left < 16 ? (int)left : 16);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    for (int r = warp; r < band && i0 + r < s; r += WARPS) {
      const int i = i0 + r;
      const float sy = source_coord(y0, i, side, s);
      const bool row_in = sy >= -1.0f && sy <= (float)h;
      const float fy = sy - floorf(sy);
      const float wy[2] = {1.0f - fy, fy};
      for (int j = lane; j < s; j += 32) {
        float v[C];
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = 0.0f;
        const float sx = source_coord(x0, j, side, s);
        if (row_in && sx >= -1.0f && sx <= (float)w) {
          const float lx = floorf(sx);
          const float fx = sx - lx;
          const int ix = (int)lx;
          const float wx[2] = {1.0f - fx, fx};
#pragma unroll
          for (int dy = 0; dy < 2; ++dy) {
            const int slot = 2 * r + dy;
            if (slot_y[slot] < 0) continue;
            const uint8_t* row = smem + slot * pitch + slot_shift[slot];
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const int src_c = bgr_to_rgb && c < 3 ? 2 - c : c;
              float acc = 0.0f;
#pragma unroll
              for (int dx = 0; dx < 2; ++dx) {
                const int x = ix + dx;
                if (x < 0 || x >= w) continue;
                const int col = mirror ? w - 1 - x : x;
                acc += wx[dx] * (float)row[(col - src_lo) * C + src_c];
              }
              v[c] += wy[dy] * acc;
            }
          }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) row_buf[j * C + c] = v[c] * scale;
      }
      __syncwarp();
      float* dst = out + ((size_t)q * s + i) * s * C;
      if ((s * C) % 4 == 0) {  // rows start 16-byte aligned
        for (int f = lane; f < s * C / 4; f += 32)
          ((float4*)dst)[f] = ((const float4*)row_buf)[f];
      } else {
        for (int f = lane; f < s * C; f += 32) dst[f] = row_buf[f];
      }
      __syncwarp();
    }
    __syncthreads();  // the next band reuses the slots
  }
}

// The launch of every entry: the geometry comes from boxes or from
// origins, whichever is not null; the source row from rows when given.
template <int C>
int launch_c(const void* frames, const void* boxes, const void* origins, const void* rows,
             const void* flips, void* out, int n_frames, int n_crops, int boxes_per_frame,
             int h, int w, int s, float padding, int bgr_to_rgb, int normalize, void* stream) {
  if (n_crops == 0 || s == 0) return (int)cudaSuccess;
  if ((uintptr_t)frames % 16 != 0) return (int)cudaErrorInvalidValue;
  // Room for a band of one output row at the widest window (the whole
  // frame width), and at least MIN_STAGE_BYTES.
  const int stage_bytes =
      2 * row_pitch(w, C) > MIN_STAGE_BYTES ? 2 * row_pitch(w, C) : MIN_STAGE_BYTES;
  const size_t smem = (size_t)stage_bytes + (size_t)WARPS * s * C * sizeof(float);
  if (smem > (size_t)MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // above 48 KB a kernel must opt in
    const cudaError_t err = cudaFuncSetAttribute(
        crop_resize_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n_crops, (s + MAX_BAND - 1) / MAX_BAND);
  crop_resize_kernel<C><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)boxes, (const float*)origins, (const int*)rows,
      (const int*)flips, (float*)out, n_frames, boxes_per_frame, h, w, s, padding, bgr_to_rgb,
      normalize ? 1.0f / 255.0f : 1.0f, stage_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// frames [n_frames, h, w, 3] uint8, 16-byte aligned; boxes [n_frames *
// boxes_per_frame, 4] float32 normalised (cx, cy, w, h); out [n_frames *
// boxes_per_frame, s, s, 3] float32.
extern "C" int crop_resize(const void* frames, const void* boxes, void* out,
                           int n_frames, int boxes_per_frame, int h, int w,
                           int s, float padding, int bgr_to_rgb, int normalize,
                           void* stream) {
  return launch_c<3>(frames, boxes, nullptr, nullptr, nullptr, out, n_frames,
                     n_frames * boxes_per_frame, boxes_per_frame, h, w, s, padding, bgr_to_rgb,
                     normalize, stream);
}

// windows [n, h, w, 3] uint8, 16-byte aligned; origins [n, 3] float32
// window-relative (y0, x0, side); out [n, s, s, 3] float32.
extern "C" int window_resize(const void* windows, const void* origins, void* out, int n,
                             int h, int w, int s, int bgr_to_rgb, int normalize,
                             void* stream) {
  return launch_c<3>(windows, nullptr, origins, nullptr, nullptr, out, n, n, 1, h, w, s, 0.0f,
                     bgr_to_rgb, normalize, stream);
}

// bank [m, h, w, c] uint8, 16-byte aligned, c = 3 or 4; rows [n] int32
// indices into the bank (a row out of range gives zeros); origins [n, 3]
// float32 row-relative (y0, x0, side); flips [n] int32 (non-zero mirrors
// the row left to right) or null; out [n, s, s, c] float32, not /255.
extern "C" int bank_resize(const void* bank, const void* rows, const void* origins,
                           const void* flips, void* out, int m, int n, int h, int w, int c,
                           int s, void* stream) {
  if (c == 3)
    return launch_c<3>(bank, nullptr, origins, rows, flips, out, m, n, 1, h, w, s, 0.0f, 0, 0,
                       stream);
  if (c == 4)
    return launch_c<4>(bank, nullptr, origins, rows, flips, out, m, n, 1, h, w, s, 0.0f, 0, 0,
                       stream);
  return (int)cudaErrorInvalidValue;
}
