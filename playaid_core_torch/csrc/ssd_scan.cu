// K6: the Mamba-2 SSD chunked scan (Dao and Gu 2024, "Transformers are SSMs",
// section 6: the state space dual's chunked closed form), float32 on the CUDA
// cores.
//
// For each batch row b, head h (of group g = h / (H / G)) and position l of a
// sequence cut into chunks of Q = 256 positions:
//
//   acs[l]  = sum of dt[s] * A[h] over the positions s <= l of l's chunk
//   y[l, p] = sum_{s <= l, same chunk} (C[l] . B[s]) exp(acs[l] - acs[s]) dt[s] x[s, p]
//           + exp(acs[l]) sum_n C[l, n] S_in[c][p, n]
//           + D[h] x[l, p]
//   S_c[p, n]       = sum_{s in chunk c} exp(acs[last] - acs[s]) dt[s] x[s, p] B[s, n]
//   S_in[0]         = 0,  S_in[c + 1] = exp(acs_c[last]) S_in[c] + S_c
//
// which is the recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,
// y_t = C_t h_t + D x_t from a zero state, carried across every chunk.
// Replaces the eager einsums of the chunked form (the plain twin in
// ops/ssd_scan.py: ssd_scan_ref), which build a decay mask of H x Q x Q a
// chunk.
//
// Four launches on the caller's stream, each kernel named ssd_scan_*:
//   ssd_scan_cb_kernel     C B^T of each chunk, once a group (not a head);
//   ssd_scan_state_kernel  the decay's cumulative sum in the chunk and the
//                          chunk's own state S_c, a block a (chunk, head);
//   ssd_scan_pass_kernel   the state pass between chunks, in place: S_c
//                          becomes S_in[c], a thread a state element;
//   ssd_scan_out_kernel    the intra-chunk product, the output from the
//                          incoming state and the D skip, a block a
//                          (chunk, head), its 256 x 64 output tile held in
//                          registers (8 x 8 a thread).
// Products are float32 fused multiply-adds; no tensor core, no TF32.
// Causal tiles that lie wholly after a warp's rows are skipped.
//
// Shapes: head size P = 64, state size N = 128, chunk Q = 256; any number of
// heads H, groups G dividing H, batch rows and chunks. Inputs may be strided
// views (the mixer's split of its projection): a row stride each, heads or
// groups contiguous inside a row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int Q = 256;   // positions a chunk
constexpr int P = 64;    // head size
constexpr int N = 128;   // state size
constexpr int THREADS = 256;
constexpr int KT = 32;   // the contracted dimension's tile

struct Args {
  const float* x;      // x[b, l, h, p]  at x + (b * L + l) * x_row + h * P + p
  const float* dt;     // dt[b, l, h]    at dt + (b * L + l) * dt_row + h
  const float* A;      // [H]
  const float* Bm;     // B[b, l, g, n]  at Bm + (b * L + l) * bc_row + g * N + n
  const float* Cm;     // C[b, l, g, n]  at Cm + (b * L + l) * bc_row + g * N + n
  const float* D;      // [H]
  float* y;            // [b, L, H, P] contiguous
  float* acs;          // [b, H, nc, Q]  the decay's cumulative sum in each chunk
  float* cbt;          // [b, G, nc, Q (s), Q (l)]  (C B^T)^T of each chunk
  float* states;       // [b, nc, H, N, P]  S_c, then S_in[c]
  long long x_row, dt_row, bc_row;
  int L, H, G, nc;
};

// C B^T of a chunk, stored transposed (s major): block (chunk, quarter of l),
// group, batch row; each thread 8 s x 8 l.
__global__ void __launch_bounds__(THREADS)
ssd_scan_cb_kernel(Args a) {
  __shared__ __align__(16) float Bs[KT][Q + 4];
  __shared__ __align__(16) float Cs[KT][64 + 4];
  const int c = blockIdx.x >> 2, lq = (blockIdx.x & 3) * 64;
  const int g = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const long long row0 = (long long)b * a.L + (long long)c * Q;
  const int ts = t >> 3, tl = t & 7;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int n0 = 0; n0 < N; n0 += KT) {
    const int n = t & 31;
#pragma unroll 4
    for (int r = 0; r < Q / 8; ++r) {
      const int s = (t >> 5) + 8 * r;
      Bs[n][s] = a.Bm[(row0 + s) * a.bc_row + g * N + n0 + n];
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int l = (t >> 5) + 8 * r;
      Cs[n][l] = a.Cm[(row0 + lq + l) * a.bc_row + g * N + n0 + n];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KT; ++k) {
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][ts * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][ts * 8 + 4]);
      const float4 c0 = *reinterpret_cast<const float4*>(&Cs[k][tl * 8]);
      const float4 c1 = *reinterpret_cast<const float4*>(&Cs[k][tl * 8 + 4]);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(bv[i], cv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = a.cbt + (((long long)b * a.G + g) * a.nc + c) * Q * Q;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* dst = out + (long long)(ts * 8 + i) * Q + lq + tl * 8;
    *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(dst + 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// The decay's inclusive cumulative sum in the chunk, and the chunk's own
// state S_c[n][p]: block (chunk, head, batch row); each thread 8 n x 4 p.
__global__ void __launch_bounds__(THREADS)
ssd_scan_state_kernel(Args a) {
  __shared__ float cs[Q];
  __shared__ float ws[Q];
  __shared__ float warp_sum[THREADS / 32];
  __shared__ __align__(16) float Xs[KT][P];
  __shared__ __align__(16) float Bs[KT][N];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int g = h / (a.H / a.G);
  const long long row0 = (long long)b * a.L + (long long)c * Q;
  const float dtv = a.dt[(row0 + t) * a.dt_row + h];
  float v = dtv * a.A[h];
  const int lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_sum[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += warp_sum[w];
  cs[t] = v;
  a.acs[(((long long)b * a.H + h) * a.nc + c) * Q + t] = v;
  __syncthreads();
  ws[t] = expf(cs[Q - 1] - v) * dtv;
  __syncthreads();

  const int tp = t & 15, tn = t >> 4;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  for (int s0 = 0; s0 < Q; s0 += KT) {
#pragma unroll
    for (int r = 0; r < KT * P / THREADS; ++r) {
      const int idx = t + THREADS * r, s = idx / P, p = idx % P;
      Xs[s][p] = a.x[(row0 + s0 + s) * a.x_row + (long long)h * P + p] * ws[s0 + s];
    }
#pragma unroll
    for (int r = 0; r < KT * N / THREADS; ++r) {
      const int idx = t + THREADS * r, s = idx / N, n = idx % N;
      Bs[s][n] = a.Bm[(row0 + s0 + s) * a.bc_row + g * N + n];
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KT; ++k) {
      float xv[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = Xs[k][tp + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = Bs[k][tn + 16 * j];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(bv[j], xv[i], acc[j][i]);
    }
    __syncthreads();
  }
  float* out = a.states + (((long long)b * a.nc + c) * a.H + h) * N * P;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) out[(tn + 16 * j) * P + tp + 16 * i] = acc[j][i];
}

// The state pass, in place: S_c -> S_in[c], sequential over the chunks; a
// thread a state element of one (batch row, head).  Each group of PASS
// chunks' states and decays is loaded before any is written, so the loads
// overlap instead of waiting one after another.
constexpr int PASS = 32;

__global__ void __launch_bounds__(THREADS)
ssd_scan_pass_kernel(Args a) {
  const int e = blockIdx.x * THREADS + threadIdx.x;  // n * P + p
  const int h = blockIdx.y, b = blockIdx.z;
  const float* last = a.acs + ((long long)b * a.H + h) * a.nc * Q + (Q - 1);
  float* s = a.states + ((long long)b * a.nc * a.H + h) * N * P + e;  // chunk c at c * step
  const long long step = (long long)a.H * N * P;
  float running = 0.f;
  for (int c0 = 0; c0 < a.nc; c0 += PASS) {
    float own[PASS], decay[PASS];
#pragma unroll
    for (int i = 0; i < PASS; ++i) {
      if (c0 + i < a.nc) {
        own[i] = s[(c0 + i) * step];
        decay[i] = expf(last[(long long)(c0 + i) * Q]);
      }
    }
#pragma unroll
    for (int i = 0; i < PASS; ++i) {
      if (c0 + i < a.nc) {
        s[(c0 + i) * step] = running;
        running = fmaf(decay[i], running, own[i]);
      }
    }
  }
}

// The output of a chunk and head: the masked (C B^T) decay product with
// dt x, then exp(acs) C S_in, then D x.  Block (chunk, head, batch row);
// thread t holds rows l = (t / 8) * 8 + i and columns p = (t % 8) * 8 + j.
__global__ void __launch_bounds__(THREADS, 2)
ssd_scan_out_kernel(Args a) {
  __shared__ float cs[Q];
  __shared__ float ecs[Q];
  __shared__ float dts[Q];
  __shared__ __align__(16) float Ms[KT][Q + 4];
  __shared__ __align__(16) float Vs[KT][P + 4];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int g = h / (a.H / a.G);
  const long long row0 = (long long)b * a.L + (long long)c * Q;
  cs[t] = a.acs[(((long long)b * a.H + h) * a.nc + c) * Q + t];
  ecs[t] = expf(cs[t]);
  dts[t] = a.dt[(row0 + t) * a.dt_row + h];
  __syncthreads();

  const int tl = t >> 3, tp = t & 7;
  const int l_hi = tl * 8 + 7;  // this thread's last row; warp-uniform test below
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const float* cb = a.cbt + (((long long)b * a.G + g) * a.nc + c) * Q * Q;
  for (int s0 = 0; s0 < Q; s0 += KT) {
    // Ms[s][l] = (C B^T)[l, s0 + s] exp(acs[l] - acs[s0 + s]) for s0 + s <= l, else 0.
    const float cl = cs[t];
#pragma unroll 4
    for (int r = 0; r < KT; ++r) {
      const int s = s0 + r;
      Ms[r][t] = s <= t ? cb[(long long)s * Q + t] * expf(cl - cs[s]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < KT * P / THREADS; ++r) {
      const int idx = t + THREADS * r, s = idx / P, p = idx % P;
      Vs[s][p] = a.x[(row0 + s0 + s) * a.x_row + (long long)h * P + p] * dts[s0 + s];
    }
    __syncthreads();
    if (s0 <= l_hi) {
#pragma unroll 4
      for (int k = 0; k < KT; ++k) {
        const float4 m0 = *reinterpret_cast<const float4*>(&Ms[k][tl * 8]);
        const float4 m1 = *reinterpret_cast<const float4*>(&Ms[k][tl * 8 + 4]);
        const float4 v0 = *reinterpret_cast<const float4*>(&Vs[k][tp * 8]);
        const float4 v1 = *reinterpret_cast<const float4*>(&Vs[k][tp * 8 + 4]);
        const float mv[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
        const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(mv[i], vv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  const float* s_in = a.states + (((long long)b * a.nc + c) * a.H + h) * N * P;
  for (int n0 = 0; n0 < N; n0 += KT) {
    // Ms[n][l] = C[l, n0 + n] exp(acs[l]);  Vs[n][p] = S_in[n0 + n][p].
#pragma unroll 4
    for (int r = 0; r < KT * Q / THREADS; ++r) {
      const int idx = t + THREADS * r, l = idx / KT, n = idx % KT;
      Ms[n][l] = a.Cm[(row0 + l) * a.bc_row + g * N + n0 + n] * ecs[l];
    }
#pragma unroll
    for (int r = 0; r < KT * P / THREADS; ++r) {
      const int idx = t + THREADS * r, n = idx / P, p = idx % P;
      Vs[n][p] = s_in[(n0 + n) * P + p];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KT; ++k) {
      const float4 m0 = *reinterpret_cast<const float4*>(&Ms[k][tl * 8]);
      const float4 m1 = *reinterpret_cast<const float4*>(&Ms[k][tl * 8 + 4]);
      const float4 v0 = *reinterpret_cast<const float4*>(&Vs[k][tp * 8]);
      const float4 v1 = *reinterpret_cast<const float4*>(&Vs[k][tp * 8 + 4]);
      const float mv[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(mv[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float dh = a.D[h];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = row0 + tl * 8 + i;
    const float* xr = a.x + row * a.x_row + (long long)h * P + tp * 8;
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = fmaf(dh, xr[j], acc[i][j]);
    float* dst = a.y + (row * a.H + h) * P + tp * 8;
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(o[4], o[5], o[6], o[7]);
  }
}

}  // namespace

// x, dt, B, C: float32 views, each row (batch row and position) `*_row`
// floats after the last, a row's heads (x: P floats each), heads (dt) or
// groups (B, C: N floats each) contiguous; A, D [heads]; y [batch, L, heads,
// P] contiguous and 16-byte aligned.  Scratch: acs [batch, heads, L / Q],
// cbt [batch, groups, L / Q, Q, Q], states [batch, L / Q, heads, N, P], each
// float32 and 16-byte aligned.  L a multiple of Q; heads a multiple of
// groups.  Four launches on `stream`.
extern "C" int ssd_scan(const void* x, long long x_row, const void* dt, long long dt_row,
                        const void* A, const void* Bm, const void* Cm, long long bc_row,
                        const void* D, void* y, void* acs, void* cbt, void* states, int batch,
                        int L, int heads, int groups, void* stream) {
  if (batch == 0 || L == 0) return (int)cudaSuccess;
  if (L % Q != 0 || groups <= 0 || heads % groups != 0 || (uintptr_t)y % 16 != 0 ||
      (uintptr_t)cbt % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = (const float*)x;
  a.dt = (const float*)dt;
  a.A = (const float*)A;
  a.Bm = (const float*)Bm;
  a.Cm = (const float*)Cm;
  a.D = (const float*)D;
  a.y = (float*)y;
  a.acs = (float*)acs;
  a.cbt = (float*)cbt;
  a.states = (float*)states;
  a.x_row = x_row;
  a.dt_row = dt_row;
  a.bc_row = bc_row;
  a.L = L;
  a.H = heads;
  a.G = groups;
  a.nc = L / Q;
  cudaStream_t s = (cudaStream_t)stream;
  ssd_scan_cb_kernel<<<dim3(a.nc * 4, groups, batch), THREADS, 0, s>>>(a);
  ssd_scan_state_kernel<<<dim3(a.nc, heads, batch), THREADS, 0, s>>>(a);
  ssd_scan_pass_kernel<<<dim3(N * P / THREADS, heads, batch), THREADS, 0, s>>>(a);
  ssd_scan_out_kernel<<<dim3(a.nc, heads, batch), THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
