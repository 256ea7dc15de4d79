// K4: ragged single-token decode attention for Hopper (sm_90a), bf16.
//
// Replaces the TPU kernel iadr1_tpu/kernels/decode_attention.py
// `_decode_kernel` (reached through `_decode_impl`).  One query token per
// sequence attends a static KV cache [B, Hkv, S, D]; a cache slot is valid
// when its index < length and its segment id != 0.  The loop stops at
// `length`, so the cost scales with the valid prefix, not with S.  A row
// with no valid slot gets 0.  Inference only.
//
// Design (simple first): one block of 8 warps per (b, kv head).  Warp w
// takes slots w, w + 8, ...; the 32 lanes split the head dim, so each slot's
// K and V rows are read once, coalesced, for the whole GQA group.  Each warp
// keeps an online softmax per query head of the group in registers, with
// the next slot's K/V loads issued before the current slot's arithmetic;
// the 8 partial softmaxes merge through shared memory at the end.
//
// Bound on this card: HBM bytes of the valid K/V prefix
// (2 * B * Hkv * length * D * 2 bytes at 3.35 TB/s).  What this design
// leaves on the table: only B * Hkv blocks run (8 SMs of 132 at the serving
// shapes), so the loop is latency-bound, far from the bandwidth bound; a
// split over the sequence across blocks with a second merge pass (split-K
// decode), deeper load pipelining and 16-byte loads per lane would close it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 8;
constexpr float kLog2e = 1.4426950408889634f;

// one cache slot's K/V elements for this lane, and the slot's segment id
template <int EPL>
__device__ __forceinline__ void load_slot(
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ segb, size_t base, int j, int lane, int D,
    float (&kd)[EPL], float (&vd)[EPL], int& sj) {
  sj = segb[j];
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const int d = lane + 32 * i;
    kd[i] = d < D ? __bfloat162float(k[base + (size_t)j * D + d]) : 0.f;
    vd[i] = d < D ? __bfloat162float(v[base + (size_t)j * D + d]) : 0.f;
  }
}

// EPL: head-dim elements per lane (D <= 32 * EPL)
template <int EPL>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const int* __restrict__ seg, __nv_bfloat16* __restrict__ out,
              int H, int Hkv, int S, int D, int length, float scale_log2) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  float* sm_m = smem;                      // [kWarps, G]
  float* sm_l = sm_m + kWarps * G;         // [kWarps, G]
  float* sm_acc = sm_l + kWarps * G;       // [kWarps, G, D]

  const int hk = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float qr[kMaxGroup][EPL];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int d = lane + 32 * i;
      qr[g][i] = (g < G && d < D)
          ? __bfloat162float(q[((size_t)b * H + hk * G + g) * D + d]) * scale_log2
          : 0.f;
    }
  }
  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][EPL];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[g][i] = 0.f;
  }

  const size_t base = ((size_t)b * Hkv + hk) * (size_t)S * D;
  const int* segb = seg + (size_t)b * S;

  float kr[EPL], vr[EPL], kn[EPL], vn[EPL];
  int sg = 0, sn = 0;
  if (warp < length) load_slot<EPL>(k, v, segb, base, warp, lane, D, kr, vr, sg);
  for (int j = warp; j < length; j += kWarps) {
    const int jn = j + kWarps;
    if (jn < length) load_slot<EPL>(k, v, segb, base, jn, lane, D, kn, vn, sn);
    if (sg != 0) {  // warp-uniform: every lane reads the same slot
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g >= G) break;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) part += qr[g][i] * kr[i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        const float m_new = fmaxf(m[g], part);   // part is finite
        const float alpha = exp2f(m[g] - m_new);
        const float p = exp2f(part - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[g][i] = acc[g][i] * alpha + p * vr[i];
        m[g] = m_new;
      }
    }
    if (jn < length) {
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        kr[i] = kn[i];
        vr[i] = vn[i];
      }
      sg = sn;
    }
  }

#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm_m[warp * G + g] = m[g];
      sm_l[warp * G + g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) sm_acc[(warp * G + g) * D + d] = acc[g][i];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float mm = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w * G + g]);
    float res = 0.f;
    if (mm != -INFINITY) {  // else no valid slot: the row is 0
      float ll = 0.f, o = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float c = exp2f(sm_m[w * G + g] - mm);  // 0 for an idle warp
        ll += sm_l[w * G + g] * c;
        o += sm_acc[(w * G + g) * D + d] * c;
      }
      res = o / ll;
    }
    out[((size_t)b * H + hk * G + g) * D + d] = __float2bfloat16(res);
  }
}

template <int EPL>
int launch(const void* q, const void* k, const void* v, const int* seg,
           void* out, int B, int H, int Hkv, int S, int D, int length,
           float scale_log2, cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t smem = (size_t)kWarps * G * (2 + D) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<EPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(Hkv, B);
  decode_kernel<EPL><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), seg, static_cast<__nv_bfloat16*>(out),
      H, Hkv, S, D, length, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B,H,D], k/v [B,Hkv,S,D] bf16 contiguous; seg [B,S] int32;
// out [B,H,D] bf16; 0 <= length <= S; H / Hkv <= 8; D <= 256.
// Returns cudaGetLastError().
extern "C" int iadr1_decode_bf16(const void* q, const void* k, const void* v,
                                 const int* seg, void* out, int B, int H,
                                 int Hkv, int S, int D, int length,
                                 float scale, void* stream) {
  if (H % Hkv != 0 || H / Hkv > kMaxGroup || D > 256 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float sl = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch<2>(q, k, v, seg, out, B, H, Hkv, S, D, length, sl, st);
  if (D <= 96) return launch<3>(q, k, v, seg, out, B, H, Hkv, S, D, length, sl, st);
  if (D <= 128) return launch<4>(q, k, v, seg, out, B, H, Hkv, S, D, length, sl, st);
  return launch<8>(q, k, v, seg, out, B, H, Hkv, S, D, length, sl, st);
}
