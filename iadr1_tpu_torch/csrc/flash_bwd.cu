// K2 and K3: flash-attention backward for Hopper (sm_90a), bf16 in, f32
// accumulation.
//
// Replaces the TPU kernels iadr1_tpu/kernels/flash_attention.py
// `_bwd_dq_kernel` (K2) and `_bwd_dkv_kernel` (K3), both reached through
// `_bwd`.  Given the forward's inputs, its natural-log lse and the
// per-row delta = rowsum(out * dout) - dlse (computed once by the caller),
// they recompute p = exp(s - lse) tile by tile and form
//   ds = p * (dout @ v^T - delta) * scale
//   dq = ds @ k                      (K2, in the q dtype)
//   dk = sum over the GQA group of ds^T @ q,  dv = ... p^T @ dout   (K3,
//        f32 accumulators cast to the k/v dtype)
// The mask is K1's: q_seg[t] == kv_seg[s] && kv_seg[s] != 0 and, when
// causal, s <= t (top-left alignment when T != S).  Masked pairs are
// selected to p = ds = 0, never computed from -inf arithmetic, so a row
// with no valid key (lse = +inf) contributes nothing and gets dq = 0.
// Taking dlse inside delta makes the lse output differentiable, which the
// TPU kernels' VJP drops.
//
// Design (simple first; two kernels, no atomics, so results are
// deterministic):
// * K2: one block of 4 warps per (b, kv head, 64 stacked query rows), the
//   GQA group's rows stacked as in K1 (row r = g*T + t).  Each warp keeps
//   its Q and dO fragments and a [16, D] f32 dq accumulator in registers
//   and walks 32-key tiles of K and V (row-major in shared memory).
// * K3: one block of 4 warps per (b, kv head, 64 keys); each warp owns 16
//   keys and [16, D] f32 dk and dv accumulators.  The block loops over the
//   group's query heads and 32-row query tiles (Q, dO row-major in shared
//   memory), computing s^T = K Q^T and dp^T = V dO^T directly so that p^T
//   and ds^T come out in the A-fragment layout of the next products.  The
//   causal loop starts at the first query tile that can see the block.
// Every product is mma.sync m16n8k16 (bf16 in, f32 accumulate), as in K1.
// Operands needed transposed (K in ds @ K, Q and dO in the dk/dv products)
// are read as column pairs of the row-major tiles.  Shared-memory rows are
// padded by 8 elements to spread the fragment reads over the banks.
//
// Bound on this card: tensor-core FLOPs.  K2 does 3 and K3 4 products of
// 2*D flops per valid (query, key) pair and head (at 989 TFLOP/s dense
// bf16); bytes are small next to that at training lengths.  What this
// design leaves on the table: wgmma and TMA, a cp.async pipeline (tile
// loads are synchronous), ldmatrix (.trans) fragment loads in place of the
// column-pair reads, skipping key tiles no query segment can see, and
// fusing K2 into K3 (which recomputes s and dp a second time).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kDqRows = 64;   // K2: stacked query rows per block (4 x 16)
constexpr int kDqKeys = 32;   // K2: keys per tile
constexpr int kKvRows = 64;   // K3: keys per block (4 warps x 16)
constexpr int kQRows = 32;    // K3: query rows per tile
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

// p[0] (low half) and p[stride] (high half): two rows of one column
__device__ __forceinline__ uint32_t ld_col2(const __nv_bfloat16* p,
                                            int stride) {
  __nv_bfloat162 v;
  v.x = p[0];
  v.y = p[stride];
  return *reinterpret_cast<uint32_t*>(&v);
}

// accumulator fragments of two n-tiles -> the A fragment of a k-step
__device__ __forceinline__ void to_a_frag(uint32_t a[4], const float lo[4],
                                          const float hi[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// rows [row0, row0 + rows) of a [n, D] bf16 matrix into a padded tile,
// zero past n
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int rows, int n) {
  constexpr int kChunks = D / 8;
  constexpr int kStride = D + 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c8 = idx % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      val = reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D)[c8];
    *reinterpret_cast<uint4*>(dst + r * kStride + c8 * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ q_seg,
                    const int* __restrict__ kv_seg,
                    __nv_bfloat16* __restrict__ dq, int H, int Hkv, int T,
                    int S, float scale, int causal) {
  constexpr int kSteps = D / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kNTiles = kDqKeys / 8;
  constexpr int kStride = D + 8;

  __shared__ __align__(16) __nv_bfloat16 k_s[kDqKeys * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kDqKeys * kStride];
  __shared__ int seg_s[kDqKeys];

  const float scale_log2 = scale * kLog2e;
  const int group = H / Hkv;
  const int rows_total = group * T;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int row0 = blockIdx.x * kDqRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, tq = lane % 4;

  // this thread's two rows: quad and quad + 8 of the warp's 16
  bool row_ok[2];
  int row_t[2], row_seg[2];
  size_t row_off[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + warp * 16 + quad + 8 * i;
    row_ok[i] = r < rows_total;
    const int rr = row_ok[i] ? r : 0;
    const int t = rr % T;
    const size_t stat = ((size_t)b * H + hk * group + rr / T) * T + t;
    row_t[i] = t;
    row_seg[i] = row_ok[i] ? q_seg[(size_t)b * T + t] : 0;
    row_off[i] = stat * D;
    lse2[i] = row_ok[i] ? lse[stat] * kLog2e : INFINITY;
    dlt[i] = row_ok[i] ? delta[stat] : 0.f;
  }

  uint32_t qa[kSteps][4], da[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const int c = ks * 16 + tq * 2;
    qa[ks][0] = row_ok[0] ? ld32(q + row_off[0] + c) : 0u;
    qa[ks][1] = row_ok[1] ? ld32(q + row_off[1] + c) : 0u;
    qa[ks][2] = row_ok[0] ? ld32(q + row_off[0] + c + 8) : 0u;
    qa[ks][3] = row_ok[1] ? ld32(q + row_off[1] + c + 8) : 0u;
    da[ks][0] = row_ok[0] ? ld32(dout + row_off[0] + c) : 0u;
    da[ks][1] = row_ok[1] ? ld32(dout + row_off[1] + c) : 0u;
    da[ks][2] = row_ok[0] ? ld32(dout + row_off[0] + c + 8) : 0u;
    da[ks][3] = row_ok[1] ? ld32(dout + row_off[1] + c + 8) : 0u;
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  // causal: no key past the block's last query position is ever valid
  const int r_end = min(row0 + kDqRows, rows_total);
  int kv_end = S;
  if (causal) {
    const bool one_head = (row0 / T) == ((r_end - 1) / T);
    const int t_hi = one_head ? (r_end - 1) % T : T - 1;
    kv_end = min(S, t_hi + 1);
  }
  const size_t kv_base = ((size_t)b * Hkv + hk) * (size_t)S * D;

  for (int kv0 = 0; kv0 < kv_end; kv0 += kDqKeys) {
    __syncthreads();  // the previous tile is consumed
    load_tile<D>(k_s, k + kv_base, kv0, kDqKeys, S);
    load_tile<D>(v_s, v + kv_base, kv0, kDqKeys, S);
    for (int idx = threadIdx.x; idx < kDqKeys; idx += kThreads) {
      const int kv = kv0 + idx;
      seg_s[idx] = kv < S ? kv_seg[(size_t)b * S + kv] : 0;
    }
    __syncthreads();

    // s = q k^T and dp = dout v^T, [16, 32] per warp
    float s[kNTiles][4], dp[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      const __nv_bfloat16* krow = k_s + (nt * 8 + quad) * kStride + tq * 2;
      const __nv_bfloat16* vrow = v_s + (nt * 8 + quad) * kStride + tq * 2;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        mma_16816(s[nt], qa[ks], ld32(krow + ks * 16), ld32(krow + ks * 16 + 8));
        mma_16816(dp[nt], da[ks], ld32(vrow + ks * 16), ld32(vrow + ks * 16 + 8));
      }
    }

    // ds = p * (dp - delta) * scale, masked pairs selected to 0
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
        const float p = ok ? exp2f(s[nt][e] * scale_log2 - lse2[i]) : 0.f;
        s[nt][e] = ok ? p * (dp[nt][e] - dlt[i]) * scale : 0.f;
      }
    }

    // dq += ds @ k: k's rows are the contraction, read as column pairs
#pragma unroll
    for (int kk = 0; kk < kDqKeys / 16; ++kk) {
      uint32_t sa[4];
      to_a_frag(sa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        const __nv_bfloat16* kc =
            k_s + (kk * 16 + tq * 2) * kStride + dt * 8 + quad;
        mma_16816(acc[dt], sa, ld_col2(kc, kStride),
                  ld_col2(kc + 8 * kStride, kStride));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    __nv_bfloat16* orow = dq + row_off[i];
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + tq * 2) =
          pack_bf16(acc[dt][2 * i], acc[dt][2 * i + 1]);
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(2 * kKvRows + 2 * kQRows) * (D + 8) * sizeof(__nv_bfloat16) +
         (size_t)3 * kQRows * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ q_seg,
                     const int* __restrict__ kv_seg,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int Hkv, int T,
                     int S, float scale, int causal) {
  constexpr int kSteps = D / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kNTiles = kQRows / 8;
  constexpr int kStride = D + 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kKvRows * kStride;
  __nv_bfloat16* q_s = v_s + kKvRows * kStride;
  __nv_bfloat16* do_s = q_s + kQRows * kStride;
  float* lse_s = reinterpret_cast<float*>(do_s + kQRows * kStride);
  float* dlt_s = lse_s + kQRows;
  int* qseg_s = reinterpret_cast<int*>(dlt_s + kQRows);

  const float scale_log2 = scale * kLog2e;
  const int group = H / Hkv;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int kv0 = blockIdx.x * kKvRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, tq = lane % 4;
  const size_t kv_base = ((size_t)b * Hkv + hk) * (size_t)S * D;

  load_tile<D>(k_s, k + kv_base, kv0, kKvRows, S);
  load_tile<D>(v_s, v + kv_base, kv0, kKvRows, S);

  // this thread's two keys: quad and quad + 8 of the warp's 16
  bool key_ok[2];
  int key[2], key_seg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = kv0 + warp * 16 + quad + 8 * i;
    key_ok[i] = key[i] < S;
    key_seg[i] = key_ok[i] ? kv_seg[(size_t)b * S + key[i]] : 0;
  }

  float dka[kDTiles][4], dva[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    dka[dt][0] = dka[dt][1] = dka[dt][2] = dka[dt][3] = 0.f;
    dva[dt][0] = dva[dt][1] = dva[dt][2] = dva[dt][3] = 0.f;
  }

  // causal: query rows before kv0 see none of this block's keys
  const int t_begin = causal ? (kv0 / kQRows) * kQRows : 0;
  const __nv_bfloat16* krow = k_s + (warp * 16 + quad) * kStride + tq * 2;
  const __nv_bfloat16* vrow = v_s + (warp * 16 + quad) * kStride + tq * 2;

  for (int g = 0; g < group; ++g) {
    const size_t head_row = ((size_t)b * H + hk * group + g) * T;
    for (int t0 = t_begin; t0 < T; t0 += kQRows) {
      __syncthreads();  // the previous tile is consumed (and K/V loaded)
      load_tile<D>(q_s, q + head_row * D, t0, kQRows, T);
      load_tile<D>(do_s, dout + head_row * D, t0, kQRows, T);
      for (int idx = threadIdx.x; idx < kQRows; idx += kThreads) {
        const int t = t0 + idx;
        const bool in = t < T;
        lse_s[idx] = in ? lse[head_row + t] * kLog2e : INFINITY;
        dlt_s[idx] = in ? delta[head_row + t] : 0.f;
        qseg_s[idx] = in ? q_seg[(size_t)b * T + t] : 0;
      }
      __syncthreads();

      // s^T = k q^T and dp^T = v dout^T, [16 keys, 32 queries] per warp
      float st[kNTiles][4], dpt[kNTiles][4];
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
        dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        uint32_t ka[4], va[4];
        const __nv_bfloat16* kr = krow + ks * 16;
        const __nv_bfloat16* vr = vrow + ks * 16;
        ka[0] = ld32(kr);
        ka[1] = ld32(kr + 8 * kStride);
        ka[2] = ld32(kr + 8);
        ka[3] = ld32(kr + 8 * kStride + 8);
        va[0] = ld32(vr);
        va[1] = ld32(vr + 8 * kStride);
        va[2] = ld32(vr + 8);
        va[3] = ld32(vr + 8 * kStride + 8);
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          const int off = (nt * 8 + quad) * kStride + ks * 16 + tq * 2;
          mma_16816(st[nt], ka, ld32(q_s + off), ld32(q_s + off + 8));
          mma_16816(dpt[nt], va, ld32(do_s + off), ld32(do_s + off + 8));
        }
      }

      // p^T and ds^T, masked pairs selected to 0
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2;
          const int local = nt * 8 + tq * 2 + (e & 1);
          const int t = t0 + local;
          const bool ok = key_ok[i] && t < T && key_seg[i] != 0 &&
                          qseg_s[local] == key_seg[i] &&
                          (!causal || key[i] <= t);
          const float p =
              ok ? exp2f(st[nt][e] * scale_log2 - lse_s[local]) : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = ok ? p * (dpt[nt][e] - dlt_s[local]) * scale : 0.f;
        }
      }

      // dv += p^T @ dout and dk += ds^T @ q: the query rows are the
      // contraction, read as column pairs
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk) {
        uint32_t pa[4], sa[4];
        to_a_frag(pa, st[2 * kk], st[2 * kk + 1]);
        to_a_frag(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int dt = 0; dt < kDTiles; ++dt) {
          const int off = (kk * 16 + tq * 2) * kStride + dt * 8 + quad;
          mma_16816(dva[dt], pa, ld_col2(do_s + off, kStride),
                    ld_col2(do_s + off + 8 * kStride, kStride));
          mma_16816(dka[dt], sa, ld_col2(q_s + off, kStride),
                    ld_col2(q_s + off + 8 * kStride, kStride));
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!key_ok[i]) continue;
    const size_t off = kv_base + (size_t)key[i] * D;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + off + dt * 8 + tq * 2) =
          pack_bf16(dka[dt][2 * i], dka[dt][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + dt * 8 + tq * 2) =
          pack_bf16(dva[dt][2 * i], dva[dt][2 * i + 1]);
    }
  }
}

using bf16 = __nv_bfloat16;

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const int* q_seg,
              const int* kv_seg, void* dq, int B, int H, int Hkv, int T, int S,
              float scale, int causal, cudaStream_t stream) {
  const int rows = (H / Hkv) * T;
  dim3 grid((rows + kDqRows - 1) / kDqRows, Hkv, B);
  flash_bwd_dq_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      q_seg, kv_seg, static_cast<bf16*>(dq), H, Hkv, T, S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int* q_seg,
               const int* kv_seg, void* dk, void* dv, int B, int H, int Hkv,
               int T, int S, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  // once per instantiation (a thread-safe static), not on every launch
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr_err != cudaSuccess) return static_cast<int>(attr_err);
  dim3 grid((S + kKvRows - 1) / kKvRows, Hkv, B);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      q_seg, kv_seg, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Hkv, T,
      S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout [B,H,T,D], k/v [B,Hkv,S,D] bf16 contiguous; lse, delta [B,H,T]
// f32; q_seg [B,T], kv_seg [B,S] int32; dq [B,H,T,D] bf16.
// Returns cudaGetLastError().
extern "C" int iadr1_flash_bwd_dq_bf16(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       const int* q_seg, const int* kv_seg,
                                       void* dq, int B, int H, int Hkv, int T,
                                       int S, int D, float scale, int causal,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, q_seg, kv_seg, dq, B, H, Hkv, T, S, scale, causal, st);
    case 80:
      return launch_dq<80>(q, k, v, dout, lse, delta, q_seg, kv_seg, dq, B, H, Hkv, T, S, scale, causal, st);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, q_seg, kv_seg, dq, B, H, Hkv, T, S, scale, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// as above; dk, dv [B,Hkv,S,D] bf16.  Returns cudaGetLastError().
extern "C" int iadr1_flash_bwd_dkv_bf16(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const float* lse, const float* delta,
                                        const int* q_seg, const int* kv_seg,
                                        void* dk, void* dv, int B, int H,
                                        int Hkv, int T, int S, int D,
                                        float scale, int causal,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, q_seg, kv_seg, dk, dv, B, H, Hkv, T, S, scale, causal, st);
    case 80:
      return launch_dkv<80>(q, k, v, dout, lse, delta, q_seg, kv_seg, dk, dv, B, H, Hkv, T, S, scale, causal, st);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, q_seg, kv_seg, dk, dv, B, H, Hkv, T, S, scale, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
