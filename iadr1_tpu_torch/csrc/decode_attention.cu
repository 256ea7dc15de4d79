// K4: ragged single-token decode attention for Hopper (sm_90a), bf16.
//
// Replaces the TPU kernel iadr1_tpu/kernels/decode_attention.py
// `_decode_kernel` (reached through `_decode_impl`).  One query token per
// sequence attends a static KV cache [B, Hkv, S, D]; a cache slot is valid
// when its index < length and its segment id != 0.  No slot at or past
// `length` is read, so the cost scales with the valid prefix, not with S.
// A row with no valid slot gets 0.  Inference only.
//
// Bound on this card: HBM bytes of the valid K/V prefix (2 * B * Hkv *
// live slots * D * 2 bytes at 3.35 TB/s): a few microseconds at the
// serving shapes, so the kernel is bound by how many loads are in flight
// and by launch latency, not by arithmetic.
//
// Design: split-K over the sequence, two passes, no atomics (the result
// is deterministic).
// * Pass 1: one block of 4 warps per (64-slot chunk, kv head, b).  The
//   block reads the chunk's segment ids first; a chunk with no live slot
//   loads nothing and records m = -inf, l = 0.  Otherwise the live K and V
//   rows are staged in shared memory by 16-byte cp.async copies
//   (neighbouring threads on neighbouring addresses; dead rows are zero
//   filled, not loaded), K and V in two commit groups so V stays in flight
//   while the logits are formed.  Each K row is read once for the whole
//   GQA group: a thread forms whole dot products of one slot with half
//   the group's queries (q held in shared memory in f32, pre-scaled by
//   scale*log2(e)), so there is no per-slot shuffle chain.  One warp per
//   query head then takes the chunk's max and sum, and each thread
//   accumulates p @ V for one (head, 8-wide column slice).  The block
//   writes its f32 partials (m, l and the unnormalised acc[G, D]) to a
//   workspace the wrapper allocates.
// * Pass 2: one block per (query head, b) forms the weight of every chunk
//   below `length` in parallel (exp2(m_c - max m), 0 for an empty chunk),
//   then sums the chunks' acc in chunk order and writes bf16 out.
// Both passes launch from one C entry point.  The grid depends only on
// the static cache size S; blocks at or past `length` return at once, so
// a CUDA graph of the decode step needs only `length` moved to device
// memory (not done here: `length` is a kernel argument).
//
// What it leaves on the table: the merge is a second launch; a block
// takes one chunk, so its K and V land in one stage with nothing to
// overlap them with; the p @ V loop reads V from shared memory once per
// query head.
#include <math.h>

#include "hopper_common.cuh"

namespace {

constexpr int kChunk = 64;     // cache slots per pass-1 block
constexpr int kThreads = 128;
constexpr int kMaxGroup = 8;
constexpr int kMaxDim = 256;

__host__ __device__ constexpr int round8(int d) { return (d + 7) / 8 * 8; }
// shared K/V row stride: 16 bytes of padding spread one slot's rows over
// the banks when each thread reads its own slot
__host__ __device__ constexpr int row_stride(int d) { return round8(d) + 8; }

__host__ __device__ constexpr size_t smem_bytes(int d, int g) {
  return (size_t)2 * kChunk * row_stride(d) * sizeof(__nv_bfloat16) +
         (size_t)g * round8(d) * sizeof(float) +   // q, f32
         (size_t)g * kChunk * sizeof(float) +      // logits, then p
         (size_t)kChunk * sizeof(int);             // segment ids
}

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::kLog2e;

// rows [0, kChunk) of one chunk of a [S, D] cache into a padded tile:
// live rows copied, dead rows and rows past the chunk's end zero-filled
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           const int* seg_s, int n, int D,
                                           bool vec) {
  const int ld = row_stride(D);
  if (vec) {
    const int pieces = D / 8;
    for (int idx = threadIdx.x; idx < kChunk * pieces; idx += kThreads) {
      const int j = idx / pieces, c = idx % pieces;
      __nv_bfloat16* d = dst + j * ld + c * 8;
      if (j < n && seg_s[j] != 0)
        cp_async16(d, src + (size_t)j * D + c * 8);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {  // rows not 16-byte aligned: plain loads, zero past D
    const int width = round8(D);
    for (int idx = threadIdx.x; idx < kChunk * width; idx += kThreads) {
      const int j = idx / width, c = idx % width;
      dst[j * ld + c] = (j < n && seg_s[j] != 0 && c < D)
                            ? src[(size_t)j * D + c]
                            : __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// Pass 1.  acc: [B, Hkv, n_chunks, G, D] f32; stats: [B, Hkv, n_chunks,
// G, 2] f32 (m in log2 units, l).
__global__ void __launch_bounds__(kThreads)
decode_chunk_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ seg, float* __restrict__ acc,
                    float* __restrict__ stats, int H, int Hkv, int S, int D,
                    int length, float scale_log2, int vec) {
  const int c0 = blockIdx.x * kChunk;
  if (c0 >= length) return;  // the grid follows S, the work follows length
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / Hkv, D8 = round8(D), ld = row_stride(D);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kChunk * ld;
  float* q_s = reinterpret_cast<float*>(v_s + kChunk * ld);   // [G, D8]
  float* p_s = q_s + G * D8;                                  // [G, kChunk]
  int* seg_s = reinterpret_cast<int*>(p_s + G * kChunk);      // [kChunk]

  const int hk = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int n = min(kChunk, length - c0);
  const int n_chunks = gridDim.x;
  const size_t rec = (((size_t)b * Hkv + hk) * n_chunks + blockIdx.x) * G;

  // q, wanted whatever the chunk holds, loads beside the segment ids
  for (int idx = tid; idx < G * D8; idx += kThreads) {
    const int g = idx / D8, d = idx % D8;
    q_s[idx] = d < D ? __bfloat162float(q[((size_t)b * H + hk * G + g) * D + d]) *
                           scale_log2
                     : 0.f;
  }
  int live = 0;
  if (tid < kChunk) {
    const int s = tid < n ? seg[(size_t)b * S + c0 + tid] : 0;
    seg_s[tid] = s;
    live = s != 0;
  }
  if (!__syncthreads_or(live)) {  // no live slot: nothing to load
    if (tid < G) {
      stats[(rec + tid) * 2] = -INFINITY;
      stats[(rec + tid) * 2 + 1] = 0.f;
    }
    return;
  }

  const size_t base = (((size_t)b * Hkv + hk) * S + c0) * D;
  stage_rows(k_s, k + base, seg_s, n, D, vec);
  cp_async_commit();
  stage_rows(v_s, v + base, seg_s, n, D, vec);
  cp_async_commit();
  cp_async_wait<1>();  // K has landed; V may still be in flight
  __syncthreads();

  // logits: thread -> one slot and the heads of one parity
  {
    const int j = tid % kChunk, hp = tid / kChunk;
    float dot[kMaxGroup / 2] = {0.f, 0.f, 0.f, 0.f};
    const __nv_bfloat16* kr = k_s + j * ld;
    for (int c = 0; c < D8 / 8; ++c) {
      float kf[8];
      unpack8(*reinterpret_cast<const uint4*>(kr + c * 8), kf);
#pragma unroll
      for (int gi = 0; gi < kMaxGroup / 2; ++gi) {
        const int g = hp + 2 * gi;
        if (g < G) {
          const float4* qp = reinterpret_cast<const float4*>(q_s + g * D8 + c * 8);
          const float4 a = qp[0], bq = qp[1];
          dot[gi] += a.x * kf[0] + a.y * kf[1] + a.z * kf[2] + a.w * kf[3] +
                     bq.x * kf[4] + bq.y * kf[5] + bq.z * kf[6] + bq.w * kf[7];
        }
      }
    }
    const bool ok = j < n && seg_s[j] != 0;
#pragma unroll
    for (int gi = 0; gi < kMaxGroup / 2; ++gi) {
      const int g = hp + 2 * gi;
      if (g < G) p_s[g * kChunk + j] = ok ? dot[gi] : -INFINITY;
    }
  }
  __syncthreads();

  // chunk max and sum per head: one warp per head
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int g = warp; g < G; g += kThreads / 32) {
      const float s0 = p_s[g * kChunk + lane], s1 = p_s[g * kChunk + lane + 32];
      float m = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      // m is finite: the chunk has a live slot
      const float p0 = exp2f(s0 - m), p1 = exp2f(s1 - m);
      p_s[g * kChunk + lane] = p0;
      p_s[g * kChunk + lane + 32] = p1;
      float l = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        l += __shfl_xor_sync(0xffffffffu, l, off);
      if (lane == 0) {
        stats[(rec + g) * 2] = m;
        stats[(rec + g) * 2 + 1] = l;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // acc = p @ V: thread -> one (head, 8-wide column slice)
  const int slices = D8 / 8;
  for (int idx = tid; idx < G * slices; idx += kThreads) {
    const int g = idx / slices, c = idx % slices;
    float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const float* pg = p_s + g * kChunk;
    // rows past n are zero and their p is 0: a fixed trip count unrolls
#pragma unroll 8
    for (int j = 0; j < kChunk; ++j) {
      float vf[8];
      unpack8(*reinterpret_cast<const uint4*>(v_s + j * ld + c * 8), vf);
      const float p = pg[j];  // 0 for dead slots, whose rows are zero
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] += p * vf[e];
    }
    float* dst = acc + (rec + g) * D + c * 8;
    if (D % 8 == 0) {
      reinterpret_cast<float4*>(dst)[0] = make_float4(o[0], o[1], o[2], o[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(o[4], o[5], o[6], o[7]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (c * 8 + e < D) dst[e] = o[e];
    }
  }
}

// sum (or max) over a block of kThreads, in a fixed order
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // red may still be read from a previous call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w)
    x = kMax ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// Pass 2: one block per (query head, b).  The chunks' weights
// exp2(m_c - max m) are formed in parallel into shared memory, then each
// thread sums its columns over the chunks in chunk order.
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ acc,
                    const float* __restrict__ stats,
                    __nv_bfloat16* __restrict__ out, int H, int Hkv, int D,
                    int n_chunks, int used_chunks) {
  extern __shared__ float w_s[];                 // [used_chunks]
  __shared__ float red[kThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int G = H / Hkv, hk = h / G, g = h % G;
  const size_t rec0 = ((size_t)b * Hkv + hk) * n_chunks * G + g;
  float mx = -INFINITY;
  for (int c = tid; c < used_chunks; c += kThreads) {
    const float m = stats[(rec0 + (size_t)c * G) * 2];
    w_s[c] = m;
    mx = fmaxf(mx, m);
  }
  mx = block_reduce<true>(mx, red);
  float l = 0.f;
  for (int c = tid; c < used_chunks; c += kThreads) {
    const float m = w_s[c];
    // an empty chunk (m = -inf) weighs 0; its acc was never written
    const float w = m == -INFINITY ? 0.f : exp2f(m - mx);
    w_s[c] = w;
    l += w * stats[(rec0 + (size_t)c * G) * 2 + 1];
  }
  l = block_reduce<false>(l, red);   // its barriers publish w_s too
  for (int d = tid; d < D; d += kThreads) {
    float res = 0.f;
    if (mx != -INFINITY) {  // else no valid slot: the row is 0
      float o = 0.f;
#pragma unroll 8
      for (int c = 0; c < used_chunks; ++c) {
        const float w = w_s[c];
        const float a = acc[(rec0 + (size_t)c * G) * D + d];
        o += w != 0.f ? w * a : 0.f;   // never touch an unwritten acc
      }
      res = o / l;
    }
    out[((size_t)b * H + h) * D + d] = __float2bfloat16(res);
  }
}

}  // namespace

// q [B,H,D], k/v [B,Hkv,S,D] bf16 contiguous; seg [B,S] int32;
// out [B,H,D] bf16; 0 <= length <= S; H / Hkv <= 8; D <= 256.
// workspace: f32, at least B * Hkv * ceil(S / 64) * (H / Hkv) * (D + 2)
// elements.  Launches both passes on `stream`; returns cudaGetLastError().
extern "C" int iadr1_decode_bf16(const void* q, const void* k, const void* v,
                                 const int* seg, void* out, void* workspace,
                                 int B, int H, int Hkv, int S, int D,
                                 int length, float scale, void* stream) {
  if (H % Hkv != 0 || H / Hkv > kMaxGroup || D > kMaxDim || D < 1 ||
      length < 0 || length > S)
    return static_cast<int>(cudaErrorInvalidValue);
  // once (a thread-safe static): the most any (D, G) needs
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      decode_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxDim, kMaxGroup)));
  if (attr_err != cudaSuccess) return static_cast<int>(attr_err);
  const int G = H / Hkv;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  float* acc = static_cast<float*>(workspace);
  float* stats = acc + (size_t)B * Hkv * n_chunks * G * D;
  // 16-byte copies need 16-byte aligned rows
  const int vec = D % 8 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_chunks > 0) {
    decode_chunk_kernel<<<dim3(n_chunks, Hkv, B), kThreads, smem_bytes(D, G),
                          st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), seg, acc, stats, H, Hkv, S, D,
        length, scale * kLog2e, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int used = (length + kChunk - 1) / kChunk;
  if (used * sizeof(float) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  decode_merge_kernel<<<dim3(H, B), kThreads, used * sizeof(float), st>>>(
      acc, stats, static_cast<__nv_bfloat16*>(out), H, Hkv, D, n_chunks,
      used);
  return static_cast<int>(cudaGetLastError());
}
