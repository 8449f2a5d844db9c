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
// dependent chain: step t needs step t-1's carry.  Its floor, a warp's
// maximum of 63 floats then a subtract, a compare-select and an add, is
// 89.5 cycles a step on an H100 with __reduce_max_sync of the signed key
// below, 106.5 with an unsigned key (three operations each way) and
// 154-177 with shuffle butterflies over 32, 16, 8 or 4 lanes
// (tools/torch_port_k3_ablation.py, which also splits the kernel's time).
//
// Design:
// - One warp a sequence, no __syncthreads: lane l holds classes l, l + 32,
//   ... (K = 1, 2, 4, ... 32 of them, K = 2 at A = 63) of carry in
//   registers; classes past A hold -inf and never win a tie.
// - The chain holds values only: the lane-local fmaxf, the warp's maximum
//   (__reduce_max_sync of a signed order key of the float, one xor each
//   way), the subtract, the compare-select and the add.  No warp-wide
//   instruction but that one reduction runs in a step.
// - Backpointers, transposed and without a branch: in a group of 32 rows,
//   lane l gathers two registers a class of bits, bit j set where class
//   l + 32 k held the maximum at the step that made row j, and where it
//   stayed.  At the group's end a 32 x 32 bit transpose over the warp
//   (five rounds of __shfl_xor_sync) hands lane j the classes that held
//   the maximum at step j, and __ffs of the first nonzero slot is that
//   step's from: torch.argmax's first-index tie-break, 0 when all are
//   -inf.  The warp then stores the 32 K stay words and the 32 16-bit
//   froms in one coalesced store, to shared memory or, past what the
//   wrapper sized there, to its scratch buffer: 10 B a step at A = 63.
// - Rows through the TMA: a sequence's rows are one contiguous run, copied
//   R rows at a time (64 at K <= 4, a tile of at most 32 KB) by 1-D bulk
//   copies (cp.async.bulk) of its 16-byte aligned span into a two-tile ring
//   in shared memory, completing on mbarriers.  Lane 0 starts the copy of
//   tile i + 1 when the warp moves into tile i, a whole tile ahead of its
//   use.  The steps run in blocks of up to 32, unrolled, with no branch
//   and no global load: each row comes from shared memory into registers,
//   and no load waits on the carry, so the compiler reads rows ahead.
// - Backtrack: the warp walks the groups back.  In a group the label stays
//   cur down to the last step where cur did not stay, the highest clear
//   bit of cur's word (one __clz); that step's from takes over.  So a
//   group costs one pass and one more a switch of the label, not one a
//   step, and each lane writes its step's label: 32 labels in one store.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM_BYTES = 232448;  // what an H100 block can have
constexpr int MAX_CLASSES = 1024;

// Rows a tile of the ring: 64, or fewer so that a tile stays within 32 KB.
template <int K>
__host__ __device__ constexpr int tile_rows() {
  return 256 / K < 64 ? 256 / K : 64;
}

// A float's bits with a negative one's magnitude bits flipped: as signed
// ints these order as the floats do (-0 below +0).  Its own inverse.
__device__ __forceinline__ int order_key(int bits) {
  return bits ^ ((bits >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float warp_max(float v) {
  return __int_as_float(order_key(__reduce_max_sync(FULL, order_key(__float_as_int(v)))));
}

template <int K>
__device__ __forceinline__ float lane_max(const float (&v)[K]) {
  float m = v[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = fmaxf(m, v[k]);
  return m;
}

// The 32 x 32 bit matrix held one row a lane (bit j of lane l's word),
// transposed: lane j gets bit l.  Five rounds of swapping the off-diagonal
// blocks between lanes l and l ^ s.
__device__ __forceinline__ uint32_t transpose32(uint32_t w, int lane) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const uint32_t m = 0xffffffffu / ((1u << s) + 1u);  // bits j with j & s == 0
    const uint32_t other = __shfl_xor_sync(FULL, w, s);
    w = (lane & s) ? (w & ~m) | ((other >> s) & m) : (w & m) | ((other << s) & ~m);
  }
  return w;
}

// The from of the group's step `lane`: the first class that held the
// maximum there, from the words where bit j of class l + 32 k says class
// l + 32 k held it at step j.  All -inf gives 0.
template <int K>
__device__ __forceinline__ int first_indices(const uint32_t (&max_words)[K], int lane) {
  int idx = 0;
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    const uint32_t lanes = transpose32(max_words[k], lane);
    if (lanes) idx = 32 * k + __ffs(lanes) - 1;
  }
  return idx;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Rows [tile R, min(tile R + R, n)) of x into ring slot tile % 2, as one
// bulk copy of the 16-byte aligned span around them (its ends lie in the
// 16-byte chunks that hold the rows' first and last bytes, so it reads no
// page the tensor does not).  Lane 0 only.
template <int K>
__device__ __forceinline__ void load_tile(uint8_t* ring, int stride, uint64_t* bars,
                                          const float* x, int tile, int n, int a) {
  constexpr int R = tile_rows<K>();
  const int rows = min(R, n - tile * R);
  const uintptr_t lo = reinterpret_cast<uintptr_t>(x + (size_t)tile * R * a) & ~uintptr_t(15);
  const uintptr_t hi =
      (reinterpret_cast<uintptr_t>(x + ((size_t)tile * R + rows) * a) + 15) & ~uintptr_t(15);
  const uint32_t bytes = static_cast<uint32_t>(hi - lo);
  const uint32_t bar = smem_addr(&bars[tile & 1]);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(ring + (tile & 1) * stride)),
      "l"(lo), "r"(bytes), "r"(bar)
      : "memory");
}

// One group's backpointers: lane l's K stay words (class l + 32 k) and
// the from of the group's step l.
template <int K>
__device__ __forceinline__ void flush(uint32_t* words, uint16_t* froms, const uint32_t (&stay)[K],
                                      int from, int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) words[32 * k + lane] = stay[k];
  froms[lane] = static_cast<uint16_t>(from);
}

// One step t of the forward pass, bit j of its 32-step group: row t read
// from shared memory, the chain on values, and beside it the bits of the
// classes that held the maximum and of those that stay.
template <int K>
__device__ __forceinline__ void step(float (&carry)[K], const float* srow, const int (&col)[K],
                                     const bool (&valid)[K], float cost, int j,
                                     uint32_t (&max_words)[K], uint32_t (&stay_words)[K]) {
  float row[K];
#pragma unroll
  for (int k = 0; k < K; ++k) row[k] = valid[k] ? srow[col[k]] : -CUDART_INF_F;
  const float m = warp_max(lane_max<K>(carry));
  const float score = __fsub_rn(m, cost);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    max_words[k] |= carry[k] == m ? 1u << j : 0u;
    const bool stay = carry[k] >= score;
    stay_words[k] |= stay ? 1u << j : 0u;
    carry[k] = __fadd_rn(row[k], stay ? carry[k] : score);
  }
}

// label[n - 1] = last; label[t - 1] = stay_t(label[t]) ? label[t] :
// from_t, for t = n - 1 down to 1, a 32-step group at a time (lane j
// writes label[32 g + j - 1]).
template <int K>
__device__ __forceinline__ void backtrack(const uint32_t* s_words, const uint16_t* s_from,
                                          const uint32_t* g_words, const uint16_t* g_from,
                                          long long* out, int n, int last, int cap, int lane) {
  int cur = last;
  for (int g = (n - 1) >> 5; g >= 0; --g) {
    const bool shared = g < cap;
    const uint32_t* words = shared ? s_words + (size_t)g * 32 * K
                                   : g_words + (size_t)(g - cap) * 32 * K;
    const uint16_t* froms = shared ? s_from + (size_t)g * 32 : g_from + (size_t)(g - cap) * 32;
    const int lo = g == 0;  // row 0 has no step
    const int top = min(31, n - 1 - 32 * g);
    int label = cur;
    for (int p = top; p >= lo;) {
      // The steps lo..p where cur did not stay; the last of them switches.
      const uint32_t moved = ~words[cur] & ((2u << p) - 1u) & ~((1u << lo) - 1u);
      const int s = moved ? 31 - __clz(moved) : -1;
      if (lane > s && lane <= p) label = cur;
      if (s < 0) break;
      cur = froms[s];
      if (lane == s) label = cur;
      p = s - 1;
    }
    if (lane >= lo && lane <= top) out[32 * g + lane - 1] = label;
  }
}

// lp [B, F, A] float32; lens [B] int32, or null and every sequence has
// length; labels [B, F] int64.  Step t (rows 1..n-1) is bit t % 32 of
// group t / 32; groups g < cap keep their backpointers in shared memory,
// the rest in spill_words [B, spill, 32 K] and spill_from [B, spill, 32].
template <int K>
__global__ void __launch_bounds__(32)
viterbi_kernel(const float* __restrict__ lp, const int* __restrict__ lens, int length, float cost,
               long long* __restrict__ labels, uint32_t* __restrict__ spill_words,
               uint16_t* __restrict__ spill_from, int f, int a, int cap, int spill) {
  constexpr int R = tile_rows<K>();
  constexpr int B = R < 32 ? R : 32;  // steps a block: no tile starts inside one
  extern __shared__ __align__(16) uint8_t smem[];
  const int stride = R * a * 4 + 16;  // a ring slot: R rows and the alignment skew
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * stride);
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem + 2 * stride + 16);
  uint16_t* s_from = reinterpret_cast<uint16_t*>(s_words + (size_t)cap * 32 * K);

  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const float* x = lp + (size_t)b * f * a;
  long long* out = labels + (size_t)b * f;
  uint32_t* g_words = spill_words + (size_t)b * spill * 32 * K;
  uint16_t* g_from = spill_from + (size_t)b * spill * 32;
  const int len = lens != nullptr ? lens[b] : length;
  const int n = len < 1 ? 1 : (len > f ? f : len);
  const int tiles = (n + R - 1) / R;
  // Every tile's rows start this many floats into its slot: R a 4 bytes
  // is a multiple of 16, so the skew of x repeats.
  const int skew = static_cast<int>(reinterpret_cast<uintptr_t>(x) & 15) / 4;

  if (lane == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_tile<K>(smem, stride, bars, x, 0, n, a);
    if (tiles > 1) load_tile<K>(smem, stride, bars, x, 1, n, a);
  }
  __syncwarp();
  mbar_wait(&bars[0], 0);

  // Lane l's classes l + 32 k; a class past A reads column 0 and holds -inf.
  bool valid[K];
  int col[K];
  float carry[K];
  const float* row0 = reinterpret_cast<const float*>(smem) + skew;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    valid[k] = lane + 32 * k < a;
    col[k] = valid[k] ? lane + 32 * k : 0;
    carry[k] = valid[k] ? (len > 0 ? row0[col[k]] : 0.0f) : -CUDART_INF_F;
  }

  for (int g = 0; 32 * g < n; ++g) {
    uint32_t max_words[K], stay_words[K];
#pragma unroll
    for (int k = 0; k < K; ++k) max_words[k] = stay_words[k] = 0;
#pragma unroll
    for (int sub = 0; sub < 32 / B; ++sub) {
      const int t0 = 32 * g + sub * B;
      if (t0 >= n) break;
      const int tile = t0 / R;
      if (t0 % R == 0 && tile > 0) {  // the block opens a tile
        mbar_wait(&bars[tile & 1], (tile >> 1) & 1);
        if (tile + 1 < tiles) {
          __syncwarp();  // every lane has read the slot the copy refills
          if (lane == 0) {
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            load_tile<K>(smem, stride, bars, x, tile + 1, n, a);
          }
        }
      }
      const float* srow =
          reinterpret_cast<const float*>(smem + (tile & 1) * stride) + skew + (t0 % R) * a;
      if (t0 > 0 && t0 + B <= n) {  // every step of the block: no branch
#pragma unroll
        for (int j = 0; j < B; ++j)
          step<K>(carry, srow + j * a, col, valid, cost, sub * B + j, max_words, stay_words);
      } else {  // the first block (row 0 has no step) and the last
#pragma unroll 1
        for (int j = t0 > 0 ? 0 : 1; j < B && t0 + j < n; ++j)
          step<K>(carry, srow + j * a, col, valid, cost, sub * B + j, max_words, stay_words);
      }
    }
    const int from_mine = first_indices<K>(max_words, lane);
    const bool shared = g < cap;
    flush<K>(shared ? s_words + (size_t)g * 32 * K : g_words + (size_t)(g - cap) * 32 * K,
             shared ? s_from + (size_t)g * 32 : g_from + (size_t)(g - cap) * 32, stay_words,
             from_mine, lane);
  }

  // The last row's label: the first index of the maximum, by ballots.
  const float m = warp_max(lane_max<K>(carry));
  int last = 0;
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    const uint32_t eq = __ballot_sync(FULL, carry[k] == m);
    if (eq) last = 32 * k + __ffs(eq) - 1;
  }
  for (int t = n - 1 + lane; t < f; t += 32) out[t] = last;
  __syncwarp();  // the groups' stores before the walk reads them
  backtrack<K>(s_words, s_from, g_words, g_from, out, n, last, cap, lane);
}

template <int K>
int launch_k(const void* lp, const void* lens, int length, float cost, void* labels,
             void* spill_words, void* spill_from, int b, int f, int a, int cap, int spill,
             void* stream) {
  constexpr int R = tile_rows<K>();
  const size_t smem = 2 * ((size_t)R * a * 4 + 16) + 16 + (size_t)cap * 32 * (4 * K + 2);
  if (smem > (size_t)MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // above 48 KB a kernel must opt in
    const cudaError_t err = cudaFuncSetAttribute(
        viterbi_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  viterbi_kernel<K><<<b, 32, smem, (cudaStream_t)stream>>>(
      (const float*)lp, (const int*)lens, length, cost, (long long*)labels,
      (uint32_t*)spill_words, (uint16_t*)spill_from, f, a, cap, spill);
  return (int)cudaGetLastError();
}

}  // namespace

// lp [b, f, a] float32, contiguous; lens [b] int32 or null (then every
// sequence has true length `length`); labels [b, f] int64.  Steps 1..f-1
// keep their backpointers by groups of 32 rows: the first cap groups in
// shared memory, the other spill = ceil(f / 32) - cap in spill_words
// [b, spill, 32 K] int32 and spill_from [b, spill, 32] int16, K = 32-bit
// words a lane (the smallest power of two with 32 K >= a).
extern "C" int viterbi_decode(const void* lp, const void* lens, int length, float cost,
                              void* labels, void* spill_words, void* spill_from, int b, int f,
                              int a, int cap, int spill, void* stream) {
  if (b == 0 || f == 0) return (int)cudaSuccess;
  if (a < 1 || a > MAX_CLASSES || cap < 0 || spill < 0 || cap + spill != (f + 31) / 32)
    return (int)cudaErrorInvalidValue;
  if (spill > 0 && (spill_words == nullptr || spill_from == nullptr))
    return (int)cudaErrorInvalidValue;
  int k = 1;
  while (32 * k < a) k *= 2;
  switch (k) {
    case 1:
      return launch_k<1>(lp, lens, length, cost, labels, spill_words, spill_from, b, f, a, cap,
                         spill, stream);
    case 2:
      return launch_k<2>(lp, lens, length, cost, labels, spill_words, spill_from, b, f, a, cap,
                         spill, stream);
    case 4:
      return launch_k<4>(lp, lens, length, cost, labels, spill_words, spill_from, b, f, a, cap,
                         spill, stream);
    case 8:
      return launch_k<8>(lp, lens, length, cost, labels, spill_words, spill_from, b, f, a, cap,
                         spill, stream);
    case 16:
      return launch_k<16>(lp, lens, length, cost, labels, spill_words, spill_from, b, f, a, cap,
                          spill, stream);
    default:
      return launch_k<32>(lp, lens, length, cost, labels, spill_words, spill_from, b, f, a, cap,
                          spill, stream);
  }
}
