// Viterbi decode under a Potts prior (a uniform switch cost), one warp a
// sequence, every sequence of a batch in one launch.
//
// Replaces playaid_core_tpu/infer/pipeline.py:
// BatchedActionPipeline._viterbi_decode, a lax.scan forward pass and a
// reversed lax.scan backtrack that XLA fused on the TPU (called once a
// fighter by _two_fighter_tail).  The port ran it as a Python loop of
// about seven small launches a frame.
//
// Semantics, the JAX function's: carry starts at row 0 (zero when
// true_len <= 0); each step t < n = clamp(true_len, 1, F) takes
// from = the first index of max(carry), score = carry[from] - cost,
// stay = carry >= score (staying wins ties), carry = lp[t] + (stay ? carry
// : score); the backpointer of class a is a where it stays, else from.
// Rows at or after n take the last valid row's label.
//
// Bound on an H100: neither bytes nor operations.  [2, 240, 63] reads
// 120,960 B and writes 3,840 B of int64 labels, 0.04 us at 3.35 TB/s; the
// arithmetic is a few hundred operations a step.  What bounds it is the
// dependent chain: step t needs step t-1's carry, so the time is F times
// one step's latency (a lane-local argmax, two warp reductions, a ballot
// and an add), then F times the backtrack's select.  chip_smoke.py phase 5
// measures it in us a step at F = 240 and F = 14,400.
//
// Design:
// - One warp a sequence, no __syncthreads: lane l holds classes l, l + 32,
//   ... (K = 1, 2, 4, ... 32 of them, K = 2 at A = 63) of carry in
//   registers; classes past A hold -inf and never win a tie.
// - The argmax: a lane-local argmax, then the warp's maximum of the values
//   (__reduce_max_sync on an order-preserving 32-bit key of the float) and
//   the minimum of the indices whose lane value equals it
//   (__reduce_min_sync), so the first index of the maximum wins as in
//   torch.argmax and jnp.argmax.  Two hardware reductions in place of ten
//   dependent shuffles.
// - Backpointers: under the Potts prior step t's backpointer of class a is
//   a where a stays, else from, so a step keeps K 32-bit stay masks
//   (__ballot_sync) and one 16-bit from: 10 B at A = 63, and 14,400 steps
//   take 144 KB of the block's 227 KB of shared memory.  Steps past what
//   the wrapper sized into shared memory go to its scratch buffer.
// - Prefetch: the next D rows of log-probs (D = 8 at K <= 2) sit in a
//   register ring, loaded D steps before their use, so no step of the
//   chain waits on device memory.
// - Backtrack: lane 0 walks the masks back from the final argmax (its loads
//   do not depend on the label it follows, only the select does) and
//   writes each row's label; the warp writes the frozen rows.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM_BYTES = 232448;  // what an H100 block can have
constexpr int MAX_CLASSES = 1024;

__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The first index of the warp's maximum of carry; its value in *m.
template <int K>
__device__ __forceinline__ int warp_argmax(const float (&carry)[K], int lane, float* m) {
  float bv = carry[0];
  int bi = lane;
#pragma unroll
  for (int k = 1; k < K; ++k) {
    if (carry[k] > bv) {
      bv = carry[k];
      bi = lane + 32 * k;
    }
  }
  *m = from_key(__reduce_max_sync(FULL, order_key(bv)));
  return (int)__reduce_min_sync(FULL, bv == *m ? (unsigned)bi : 0xffffffffu);
}

template <int K>
__device__ __forceinline__ void load_row(float (&dst)[K], const float* __restrict__ x, int row,
                                         int n, int a, int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + 32 * k;
    dst[k] = (row < n && c < a) ? __ldg(x + (size_t)row * a + c) : -CUDART_INF_F;
  }
}

// The stay mask word of class cur in a step's K words.  For small K every
// word is loaded and one selected, so the loads do not wait on cur.
template <int K>
__device__ __forceinline__ uint32_t mask_word(const uint32_t* words, int cur) {
  if (K <= 4) {
    uint32_t w = words[0];
#pragma unroll
    for (int k = 1; k < K; ++k) {
      const uint32_t v = words[k];
      if ((cur >> 5) == k) w = v;
    }
    return w;
  }
  return words[cur >> 5];
}

// lp [B, F, A] float32; lens [B] int32, or null and every sequence has
// length; labels [B, F] int64; steps s = t - 1 < cap in shared memory, the
// rest in spill_masks [B, spill, K] and spill_from [B, spill].
template <int K>
__global__ void __launch_bounds__(32)
viterbi_kernel(const float* __restrict__ lp, const int* __restrict__ lens, int length, float cost,
               long long* __restrict__ labels, uint32_t* __restrict__ spill_masks,
               uint16_t* __restrict__ spill_from, int f, int a, int cap, int spill) {
  constexpr int D = K >= 16 ? 2 : (K >= 4 ? 4 : 8);
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* s_masks = reinterpret_cast<uint32_t*>(smem);
  uint16_t* s_from = reinterpret_cast<uint16_t*>(smem + (size_t)cap * K * sizeof(uint32_t));

  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const float* x = lp + (size_t)b * f * a;
  long long* out = labels + (size_t)b * f;
  const int len = lens != nullptr ? lens[b] : length;
  const int n = len < 1 ? 1 : (len > f ? f : len);

  float carry[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + 32 * k;
    carry[k] = c < a ? (len > 0 ? x[c] : 0.0f) : -CUDART_INF_F;
  }
  float ring[D][K];
#pragma unroll
  for (int j = 0; j < D; ++j) load_row<K>(ring[j], x, 1 + j, n, a, lane);

  for (int t0 = 1; t0 < n; t0 += D) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const int t = t0 + j;
      if (t < n) {
        float m;
        const int from = warp_argmax<K>(carry, lane, &m);
        const float score = __fsub_rn(m, cost);
        uint32_t stay_bits[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const bool stay = carry[k] >= score;
          stay_bits[k] = __ballot_sync(FULL, stay);
          carry[k] = __fadd_rn(ring[j][k], stay ? carry[k] : score);
        }
        if (lane == 0) {
          const int s = t - 1;
          uint32_t* words;
          if (s < cap) {
            words = s_masks + (size_t)s * K;
            s_from[s] = (uint16_t)from;
          } else {
            const size_t g = (size_t)b * spill + (s - cap);
            words = spill_masks + g * K;
            spill_from[g] = (uint16_t)from;
          }
#pragma unroll
          for (int k = 0; k < K; ++k) words[k] = stay_bits[k];
        }
        load_row<K>(ring[j], x, t + D, n, a, lane);
      }
    }
  }

  float m;
  const int last = warp_argmax<K>(carry, lane, &m);
  for (int t = n + lane; t < f; t += 32) out[t] = last;
  if (lane == 0) {
    int cur = last;
    out[n - 1] = cur;
#pragma unroll 4
    for (int s = n - 2; s >= 0; --s) {
      uint32_t w;
      int from;
      if (s < cap) {
        w = mask_word<K>(s_masks + (size_t)s * K, cur);
        from = s_from[s];
      } else {
        const size_t g = (size_t)b * spill + (s - cap);
        w = mask_word<K>(spill_masks + g * K, cur);
        from = spill_from[g];
      }
      if (!((w >> (cur & 31)) & 1u)) cur = from;
      out[s] = cur;
    }
  }
}

template <int K>
int launch_k(const void* lp, const void* lens, int length, float cost, void* labels,
             void* spill_masks, void* spill_from, int b, int f, int a, int cap, int spill,
             void* stream) {
  const size_t smem = (size_t)cap * K * sizeof(uint32_t) + (size_t)cap * sizeof(uint16_t);
  if (smem > (size_t)MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // above 48 KB a kernel must opt in
    const cudaError_t err = cudaFuncSetAttribute(
        viterbi_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  viterbi_kernel<K><<<b, 32, smem, (cudaStream_t)stream>>>(
      (const float*)lp, (const int*)lens, length, cost, (long long*)labels,
      (uint32_t*)spill_masks, (uint16_t*)spill_from, f, a, cap, spill);
  return (int)cudaGetLastError();
}

}  // namespace

// lp [b, f, a] float32, contiguous; lens [b] int32 or null (then every
// sequence has true length `length`); labels [b, f] int64.  Steps 1..f-1
// keep their stay masks and from: the first cap in shared memory, the
// other spill = f - 1 - cap in spill_masks [b, spill, K] int32 and
// spill_from [b, spill] int16, K = 32-bit words a step (the smallest power
// of two with 32 K >= a).
extern "C" int viterbi_decode(const void* lp, const void* lens, int length, float cost,
                              void* labels, void* spill_masks, void* spill_from, int b, int f,
                              int a, int cap, int spill, void* stream) {
  if (b == 0 || f == 0) return (int)cudaSuccess;
  if (a < 1 || a > MAX_CLASSES || cap < 0 || spill < 0 || cap + spill != f - 1)
    return (int)cudaErrorInvalidValue;
  if (spill > 0 && (spill_masks == nullptr || spill_from == nullptr))
    return (int)cudaErrorInvalidValue;
  int k = 1;
  while (32 * k < a) k *= 2;
  switch (k) {
    case 1:
      return launch_k<1>(lp, lens, length, cost, labels, spill_masks, spill_from, b, f, a, cap,
                         spill, stream);
    case 2:
      return launch_k<2>(lp, lens, length, cost, labels, spill_masks, spill_from, b, f, a, cap,
                         spill, stream);
    case 4:
      return launch_k<4>(lp, lens, length, cost, labels, spill_masks, spill_from, b, f, a, cap,
                         spill, stream);
    case 8:
      return launch_k<8>(lp, lens, length, cost, labels, spill_masks, spill_from, b, f, a, cap,
                         spill, stream);
    case 16:
      return launch_k<16>(lp, lens, length, cost, labels, spill_masks, spill_from, b, f, a, cap,
                          spill, stream);
    default:
      return launch_k<32>(lp, lens, length, cost, labels, spill_masks, spill_from, b, f, a, cap,
                          spill, stream);
  }
}
