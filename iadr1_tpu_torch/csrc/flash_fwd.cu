// K1: flash-attention forward for Hopper (sm_90a), bf16 in, f32 statistics.
//
// Replaces the TPU kernel iadr1_tpu/kernels/flash_attention.py `_fwd_kernel`
// (reached through `_fwd`, and its lane-layout twin `_fwd_kernel_t`).
// Computes, per query row, online-softmax attention over the keys that are
// valid for it, and the natural-log logsumexp of its scaled logits:
//   valid(t, s) = q_seg[t] == kv_seg[s] && kv_seg[s] != 0
//                 && (!causal || s <= t)            (top-left alignment)
//   out[b,h,t] = softmax(q.k * scale) @ v ,  lse[b,h,t] = log sum exp(...)
// A row with no valid key gets out = 0 and lse = +inf.  Masked logits are
// selected out (-inf, never added to) and K/V rows past S are zero-filled in
// shared memory, so no garbage reaches the products.
//
// Design (simple first): one block of 4 warps per (b, kv head, 64 stacked
// query rows).  The GQA group's query rows are stacked, row r = g*T + t, so
// every row of a block reads the same K/V head and each K/V tile is loaded
// once for the whole group.  Each warp owns 16 rows and keeps its Q
// fragments and the [16, D] f32 output accumulator in registers; the block
// walks 64-key tiles of K (row-major) and V (stored transposed) through
// shared memory and runs QK^T and PV with mma.sync m16n8k16 (bf16 in, f32
// accumulate).  The causal walk stops at the block's last query position.
//
// Bound on this card: tensor-core FLOPs (4*B*H*T*S*D, halved when causal,
// at 989 TFLOP/s dense bf16); bytes are small next to that.  What this
// design leaves on the table: wgmma (the only path to the full tensor-core
// rate), TMA and a multi-stage cp.async pipeline (the tile loads here are
// synchronous and not overlapped with the products), ldmatrix fragment
// loads, and a persistent schedule that balances causal blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // stacked query rows per block (4 warps x 16)
constexpr int kBlockN = 64;   // keys per tile
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2 with `lo` in the low half (the lower column index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int H, int Hkv, int T, int S, float scale_log2, int causal) {
  constexpr int kSteps = D / 16;        // k-steps of QK^T
  constexpr int kDTiles = D / 8;        // n-tiles of the output
  constexpr int kNTiles = kBlockN / 8;  // n-tiles of the logits
  constexpr int kKStride = D + 8;       // padded smem rows: no bank conflicts
  constexpr int kVStride = kBlockN + 8;
  constexpr int kChunks = D / 8;        // 16-byte chunks per K/V row

  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockN * kKStride];
  __shared__ __align__(16) __nv_bfloat16 vt_s[D * kVStride];
  __shared__ int seg_s[kBlockN];

  const int group = H / Hkv;
  const int rows_total = group * T;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int row0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, tq = lane % 4;

  // this thread's two rows: quad and quad + 8 of the warp's 16
  bool row_ok[2];
  int row_t[2], row_seg[2];
  size_t row_off[2];  // element offset of the row in q / out
  size_t lse_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + warp * 16 + quad + 8 * i;
    row_ok[i] = r < rows_total;
    const int rr = row_ok[i] ? r : 0;
    const int g = rr / T, t = rr % T;
    const int head = hk * group + g;
    row_t[i] = t;
    row_seg[i] = row_ok[i] ? q_seg[(size_t)b * T + t] : 0;
    lse_off[i] = ((size_t)b * H + head) * T + t;
    row_off[i] = lse_off[i] * D;
  }

  // Q fragments for the whole head dim (rows past the end are zero)
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const int c = ks * 16 + tq * 2;
    qa[ks][0] = row_ok[0] ? ld32(q + row_off[0] + c) : 0u;
    qa[ks][1] = row_ok[1] ? ld32(q + row_off[1] + c) : 0u;
    qa[ks][2] = row_ok[0] ? ld32(q + row_off[0] + c + 8) : 0u;
    qa[ks][3] = row_ok[1] ? ld32(q + row_off[1] + c + 8) : 0u;
  }

  float o[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  // causal: no key past the block's last query position is ever valid
  const int r_end = min(row0 + kBlockM, rows_total);
  int kv_end = S;
  if (causal) {
    const bool one_head = (row0 / T) == ((r_end - 1) / T);
    const int t_hi = one_head ? (r_end - 1) % T : T - 1;
    kv_end = min(S, t_hi + 1);
  }

  const size_t kv_base = ((size_t)b * Hkv + hk) * (size_t)S * D;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  for (int kv0 = 0; kv0 < kv_end; kv0 += kBlockN) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < kBlockN * kChunks; idx += kThreads) {
      const int rrow = idx / kChunks, c8 = idx % kChunks;
      const int kv = kv0 + rrow;
      uint4 kval = zero4, vval = zero4;
      if (kv < S) {
        kval = reinterpret_cast<const uint4*>(k + kv_base + (size_t)kv * D)[c8];
        vval = reinterpret_cast<const uint4*>(v + kv_base + (size_t)kv * D)[c8];
      }
      *reinterpret_cast<uint4*>(k_s + rrow * kKStride + c8 * 8) = kval;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vval);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt_s[(c8 * 8 + e) * kVStride + rrow] = ve[e];
    }
    for (int idx = threadIdx.x; idx < kBlockN; idx += kThreads) {
      const int kv = kv0 + idx;
      seg_s[idx] = kv < S ? kv_seg[(size_t)b * S + kv] : 0;
    }
    __syncthreads();

    // logits tile [16, 64] per warp
    float s[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = k_s + (nt * 8 + quad) * kKStride + tq * 2;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks)
        mma_16816(s[nt], qa[ks], ld32(krow + ks * 16), ld32(krow + ks * 16 + 8));
    }

    // mask (select, never add), scale to base-2 units, running max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const int local = nt * 8 + tq * 2 + (e & 1);
        const int col = kv0 + local;
        const int seg = seg_s[local];
        const bool ok = row_ok[i] && col < S && seg != 0 &&
                        seg == row_seg[i] && (!causal || col <= row_t[i]);
        s[nt][e] = ok ? s[nt][e] * scale_log2 : -INFINITY;
        mx[i] = fmaxf(mx[i], s[nt][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // a row with no valid key so far keeps m = -inf: exponentiate
      // against 0 so that -inf - -inf never makes a NaN
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = exp2f(m[i] - m_use);
      m[i] = m_new;
      mx[i] = m_use;
    }
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        s[nt][e] = exp2f(s[nt][e] - mx[i]);
        rowsum[i] += s[nt][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], 1);
      rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], 2);
      l[i] = alpha[i] * l[i] + rowsum[i];
    }
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // o += p @ v: the logits' accumulator layout is the A-fragment layout
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        const __nv_bfloat16* vrow =
            vt_s + (dt * 8 + quad) * kVStride + kk * 16 + tq * 2;
        mma_16816(o[dt], pa, ld32(vrow), ld32(vrow + 8));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    const bool empty = l[i] == 0.f;
    const float inv = empty ? 0.f : 1.f / l[i];
    __nv_bfloat16* orow = out + row_off[i];
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + tq * 2) =
          pack_bf16(o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
    }
    if (tq == 0)
      lse[lse_off[i]] = empty ? INFINITY : m[i] / kLog2e + logf(l[i]);
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, const int* q_seg,
            const int* kv_seg, void* out, float* lse, int B, int H, int Hkv,
            int T, int S, float scale_log2, int causal, cudaStream_t stream) {
  const int rows = (H / Hkv) * T;
  dim3 grid((rows + kBlockM - 1) / kBlockM, Hkv, B);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), q_seg, kv_seg,
      static_cast<__nv_bfloat16*>(out), lse, H, Hkv, T, S, scale_log2, causal);
}

}  // namespace

// q [B,H,T,D], k/v [B,Hkv,S,D] bf16 contiguous; q_seg [B,T], kv_seg [B,S]
// int32; out [B,H,T,D] bf16; lse [B,H,T] f32.  Returns cudaGetLastError().
extern "C" int iadr1_flash_fwd_bf16(const void* q, const void* k,
                                    const void* v, const int* q_seg,
                                    const int* kv_seg, void* out, float* lse,
                                    int B, int H, int Hkv, int T, int S, int D,
                                    float scale, int causal, void* stream) {
  const float scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      launch<64>(q, k, v, q_seg, kv_seg, out, lse, B, H, Hkv, T, S, scale_log2, causal, st);
      break;
    case 80:
      launch<80>(q, k, v, q_seg, kv_seg, out, lse, B, H, Hkv, T, S, scale_log2, causal, st);
      break;
    case 128:
      launch<128>(q, k, v, q_seg, kv_seg, out, lse, B, H, Hkv, T, S, scale_log2, causal, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
