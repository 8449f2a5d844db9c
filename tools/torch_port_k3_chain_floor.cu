// The dependent-chain floor of K3 (playaid_core_torch/csrc/viterbi.cu): one
// warp runs F dependent steps of only
//   m = the maximum of 63 floats over the warp; carry = row + max(carry, m - cost)
// (a compare and a select, as K3 keeps the stay bit), its rows read from a
// 64-row table in shared memory, with the reduction done each way a design
// may take.  Built and run by chip_smoke.py phase 5 and
// tools/torch_port_k3_ablation.py; clock64() gives its cycles a step.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The signed key K3 takes: one xor each way.
__device__ __forceinline__ int signed_key(float v) {
  const int i = __float_as_int(v);
  return i ^ ((i >> 31) & 0x7fffffff);
}

// L lanes a sequence hold K = 64 / L classes each (class g + L k, g = lane % L);
// REDUX 1: __reduce_max_sync of an unsigned order key, 2: of the signed key
// (L = 32 only); 0: a butterfly of fmaxf over shuffles.
template <int L, int REDUX>
__global__ void __launch_bounds__(32)
chain_floor(const float* __restrict__ table, int f, float cost, float* out,
            long long* cycles) {
  constexpr int K = 64 / L;
  __shared__ float rows[64 * 64];
  const int lane = threadIdx.x;
  for (int i = lane; i < 64 * 64; i += 32) rows[i] = table[i];
  __syncwarp();
  const int g = lane % L;
  float carry[K];
#pragma unroll
  for (int k = 0; k < K; ++k) carry[k] = g + L * k < 63 ? rows[g + L * k] : -CUDART_INF_F;
  const long long t0 = clock64();
#pragma unroll 4
  for (int t = 1; t < f; ++t) {
    const float* r = rows + (t & 63) * 64;
    float lm = carry[0];
#pragma unroll
    for (int k = 1; k < K; ++k) lm = fmaxf(lm, carry[k]);
    float m;
    if (REDUX == 1) {
      m = from_key(__reduce_max_sync(FULL, order_key(lm)));
    } else if (REDUX == 2) {
      const int k = __reduce_max_sync(FULL, signed_key(lm));
      m = __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
    } else {
      m = lm;
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
    }
    const float score = __fsub_rn(m, cost);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float row = g + L * k < 63 ? r[g + L * k] : -CUDART_INF_F;
      carry[k] = __fadd_rn(row, carry[k] >= score ? carry[k] : score);
    }
  }
  const long long t1 = clock64();
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) s += carry[k];
  out[lane] = s;
  if (lane == 0) cycles[0] = t1 - t0;
}

template <int L, int REDUX>
int launch(const void* table, int f, float cost, void* out, void* cycles, void* stream) {
  chain_floor<L, REDUX><<<1, 32, 0, (cudaStream_t)stream>>>(
      (const float*)table, f, cost, (float*)out, (long long*)cycles);
  return (int)cudaGetLastError();
}

extern "C" int chain_floor_run(int variant, const void* table, int f, float cost, void* out,
                               void* cycles, void* stream) {
  switch (variant) {
    case 0: return launch<32, 2>(table, f, cost, out, cycles, stream);
    case 1: return launch<32, 1>(table, f, cost, out, cycles, stream);
    case 2: return launch<32, 0>(table, f, cost, out, cycles, stream);
    case 3: return launch<16, 0>(table, f, cost, out, cycles, stream);
    case 4: return launch<8, 0>(table, f, cost, out, cycles, stream);
    default: return launch<4, 0>(table, f, cost, out, cycles, stream);
  }
}
