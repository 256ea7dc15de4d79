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
// Two kernels, no atomics in the result path, so results are
// deterministic.  Both are bound by tensor-core FLOPs: K2 does 3 and K3 4
// products of 2*D flops per valid (query, key) pair and head (at 989
// TFLOP/s dense bf16); bytes are small next to that at training lengths.
//
// K2 (a simple first design): one block of 4 warps per (b, kv head, 64
// stacked query rows), the GQA group's rows stacked as in K1 (row r =
// g*T + t).  Each warp keeps its Q and dO fragments and a [16, D] f32 dq
// accumulator in registers and walks 32-key tiles of K and V (row-major
// in shared memory, rows padded by 8 elements for the banks) with
// mma.sync m16n8k16; K, needed transposed in ds @ K, is read as column
// pairs.  It leaves on the table: wgmma, a cp.async pipeline, skipping
// dead tiles, and fusing K2 into K3 (which recomputes s and dp).
//
// K3, built for Hopper: one warpgroup (128 threads) per (64-key block,
// query head, b), so the card gets H/Hkv times the blocks a kv-head grid
// would give it (768 at the decoder's training shape, 1024 at the
// tower's).  Each block
// * first marks the query tiles that can hold a valid pair with its keys:
//   the tile's and the block's ranges of non-zero segment ids overlap
//   and, when causal, the tile's last row reaches the block's first key.
//   The test is conservative for any ids; on the block-diagonal tower
//   mask it keeps about a quarter of the tiles, on two packed causal
//   segments about half of the causal ones.  Dead tiles are never loaded;
// * walks the live 64-row query tiles with Q, dO, lse, delta and segment
//   ids double-buffered by cp.async, so tile n+1 loads while tile n
//   computes;
// * forms s^T = K Q^T and dp^T = V dO^T with wgmma m64n64k16 (both
//   operands in shared memory), selects p^T and ds^T (masked pairs to 0)
//   in the accumulators, and accumulates dv += p^T dO and dk += ds^T Q
//   with wgmma m64nDk16, A from registers (the accumulators repacked to
//   bf16, the FA2 trick) and B the same Q / dO tiles read transposed
//   through the descriptor.  Tiles sit in the no-swizzle core-matrix
//   layout, which serves both the K-major and the transposed read;
// * writes bf16 dk/dv when the group is one head, else this head's f32
//   part to a workspace that a second pass sums over the group in head
//   order.
// What K3 leaves on the table: the products of one tile run in two
// serial wgmma batches with the mask arithmetic between them (no second
// warpgroup to overlap them, no producer warp, no TMA); the no-swizzle
// layout costs shared-memory bandwidth that a 128-byte swizzle would
// save; the group sum round-trips f32 parts through device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kDqRows = 64;   // K2: stacked query rows per block (4 x 16)
constexpr int kDqKeys = 32;   // K2: keys per tile
constexpr int kKvRows = 64;   // K3: keys per block (4 warps x 16)
constexpr int kQRows = 64;    // K3: query rows per tile (wgmma N)
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

// ---------------------------------------------------------------------------
// K3 (wgmma)
// ---------------------------------------------------------------------------

// K3 tiles live in shared memory in wgmma's no-swizzle "core matrix"
// layout: 8 rows x 16 bytes (8 bf16) stored as 128 contiguous bytes, the
// core matrices of an 8-row group side by side along D, the groups one
// after another.  Element (r, c) of a [rows, D] tile sits at
//   (r / 8) * 8 * D + (c / 8) * 64 + (r % 8) * 8 + c % 8     (elements)
// One tile serves two descriptors: read K-major (contraction over D, for
// s^T = K Q^T) and N-major (contraction over rows, for dk += ds^T Q).
template <int D>
__device__ __forceinline__ int cm_offset(int r, int c8) {
  return (r / 8) * 8 * D + c8 * 64 + (r % 8) * 8;
}

// wgmma shared-memory matrix descriptor, no swizzle: start address,
// leading byte offset (between core matrices along the contraction) and
// stride byte offset (between core matrices along M or N), all >> 4
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy shared-memory writes (cp.async, st.shared) made visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d[32] (+)= A[64, 16] (shared, K-major) * B[16, 64] (shared,
// K-major): wgmma m64n64k16, f32 accumulate
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] += A[64, 16] (registers) * B[16, 64] (shared, N-major:
// transposed): wgmma m64n64k16, f32 accumulate
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[40] += A[64, 16] (registers) * B[16, 80] (shared, N-major:
// transposed): wgmma m64n80k16, f32 accumulate
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A[64, 16] (registers) * B[16, 128] (shared, N-major:
// transposed): wgmma m64n128k16, f32 accumulate
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (D == 80) wgmma_rs_n80(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// K3 shared memory: K and V tiles, then two stages of (Q, dO, lse, delta,
// q segment ids), the key block's id range; the live-tile flags (one
// byte per query tile) follow
template <int D>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(2 * kKvRows + 4 * kQRows) * D * sizeof(__nv_bfloat16) +
         (size_t)2 * 3 * kQRows * sizeof(float) + 2 * sizeof(int);
}
constexpr int kMaxFlags = 16 * 1024;   // query tiles: T up to kQRows * this

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + rows) of a [n, D] bf16 matrix into a core-matrix
// tile by 16-byte cp.async copies, zero-filled past n.  Eight neighbouring
// threads take eight rows of one 16-byte column, so a warp reads four
// full 32-byte sectors per row group and writes 512 contiguous bytes.
template <int D>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int row0,
                                           int rows, int n) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int r8 = idx % 8, rest = idx / 8;
    const int c8 = rest % kChunks, r = (rest / kChunks) * 8 + r8;
    __nv_bfloat16* d = dst + cm_offset<D>(r, c8);
    if (row0 + r < n)
      cp_async16(d, src + (size_t)(row0 + r) * D + c8 * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
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
                     __nv_bfloat16* __restrict__ dv,
                     float* __restrict__ dkv_part, int H, int Hkv, int T,
                     int S, float scale, int causal) {
  constexpr int kSteps = D / 16;        // k-steps of s^T and dp^T
  constexpr int kDTiles = D / 8;
  constexpr int kNTiles = kQRows / 8;
  constexpr int kTile = kQRows * D;     // elements of one Q or dO tile
  // descriptor offsets, bytes: core matrices are 128 B; an 8-row group
  // of a tile is 16 * D B
  constexpr uint32_t kCore = 128, kGroup = 16 * D;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kKvRows * D;
  __nv_bfloat16* q_st = v_s + kKvRows * D;              // [2][kTile]
  __nv_bfloat16* do_st = q_st + 2 * kTile;              // [2][kTile]
  float* lse_st = reinterpret_cast<float*>(do_st + 2 * kTile);
  float* dlt_st = lse_st + 2 * kQRows;                  // [2][kQRows]
  int* qseg_st = reinterpret_cast<int*>(dlt_st + 2 * kQRows);
  int* krange = qseg_st + 2 * kQRows;                   // [2]
  unsigned char* live_s = reinterpret_cast<unsigned char*>(krange + 2);

  const float scale_log2 = scale * kLog2e;
  const int group = H / Hkv;
  const int b = blockIdx.z, h = blockIdx.y, hk = h / group;
  const int kv0 = blockIdx.x * kKvRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, tq = lane % 4;
  const size_t kv_base = ((size_t)b * Hkv + hk) * (size_t)S * D;
  const size_t head_row = ((size_t)b * H + h) * T;

  // Which query tiles can hold a valid pair with this key block: the
  // tile's and the block's ranges of non-zero segment ids must overlap
  // and, when causal, the tile's last row must reach kv0 (this also ends
  // the walk when T < S).  Conservative for any ids, sorted or not.
  if (threadIdx.x == 0) {
    krange[0] = INT_MAX;
    krange[1] = INT_MIN;
  }
  __syncthreads();
  if (threadIdx.x < kKvRows && kv0 + threadIdx.x < S) {
    const int id = kv_seg[(size_t)b * S + kv0 + threadIdx.x];
    if (id != 0) {
      atomicMin(&krange[0], id);
      atomicMax(&krange[1], id);
    }
  }
  __syncthreads();
  // Four neighbouring threads cover one tile, 16 rows each, with their
  // 16 loads in flight together.
  constexpr int kPart = kQRows / 4;
  const int n_tiles = (T + kQRows - 1) / kQRows;
  for (int base = 0; base < n_tiles * 4; base += kThreads) {
    const int part = base + threadIdx.x, t0 = part * kPart;
    int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
    for (int j = 0; j < kPart; ++j) {
      const int id = t0 + j < T ? q_seg[(size_t)b * T + t0 + j] : 0;
      if (id != 0) {
        lo = min(lo, id);
        hi = max(hi, id);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    const int i = part / 4;
    if (part % 4 == 0 && i < n_tiles) {
      const int t1 = min((i + 1) * kQRows, T);
      live_s[i] = lo <= hi && krange[0] <= krange[1] && lo <= krange[1] &&
                  krange[0] <= hi && (!causal || t1 - 1 >= kv0);
    }
  }
  __syncthreads();  // the flags are read by every thread below

  // one query tile's Q, dO, lse, delta and segment ids into a stage
  auto fetch = [&](int stage, int tile) {
    const int t0 = tile * kQRows;
    stage_tile<D>(q_st + stage * kTile, q + head_row * D, t0, kQRows, T);
    stage_tile<D>(do_st + stage * kTile, dout + head_row * D, t0, kQRows, T);
    for (int idx = threadIdx.x; idx < kQRows; idx += kThreads) {
      const int t = t0 + idx, o = stage * kQRows + idx;
      if (t < T) {
        cp_async4(lse_st + o, lse + head_row + t);
        cp_async4(dlt_st + o, delta + head_row + t);
        cp_async4(qseg_st + o, q_seg + (size_t)b * T + t);
      } else {
        lse_st[o] = INFINITY;
        dlt_st[o] = 0.f;
        qseg_st[o] = 0;
      }
    }
  };
  auto next_live = [&](int tile) {
    do ++tile; while (tile < n_tiles && !live_s[tile]);
    return tile;
  };

  // K and V ride in the first tile's group
  stage_tile<D>(k_s, k + kv_base, kv0, kKvRows, S);
  stage_tile<D>(v_s, v + kv_base, kv0, kKvRows, S);
  int cur = next_live(-1), stage = 0;
  if (cur < n_tiles) fetch(0, cur);
  cp_async_commit();

  // this thread's two keys: quad and quad + 8 of its warp's 16 (the rows
  // of the wgmma accumulators it holds)
  bool key_ok[2];
  int key[2], key_seg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = kv0 + warp * 16 + quad + 8 * i;
    key_ok[i] = key[i] < S;
    key_seg[i] = key_ok[i] ? kv_seg[(size_t)b * S + key[i]] : 0;
  }

  // dk, dv [64 keys, D] f32 accumulators; chunk dt (8 columns) is
  // elements 4*dt .. 4*dt+3
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  const uint64_t k_desc = smem_desc(k_s, kCore, kGroup);
  const uint64_t v_desc = smem_desc(v_s, kCore, kGroup);

  // walk the live tiles (the flags are block-uniform, so is the walk);
  // tile n+1's copies go out while tile n's products run
  while (cur < n_tiles) {
    cp_async_wait<0>();   // this tile (and, first time round, K and V)
    fence_proxy_async();
    __syncthreads();
    const int t0 = cur * kQRows;
    const __nv_bfloat16* q_s = q_st + stage * kTile;
    const __nv_bfloat16* do_s = do_st + stage * kTile;
    const float* lse_s = lse_st + stage * kQRows;
    const float* dlt_s = dlt_st + stage * kQRows;
    const int* qseg_s = qseg_st + stage * kQRows;

    // s^T = K Q^T and dp^T = V dO^T, [64 keys, 64 queries]: both operands
    // K-major in shared memory, one k-step is two core matrices (256 B)
    float st[kQRows / 2], dpt[kQRows / 2];
#pragma unroll
    for (int i = 0; i < kQRows / 2; ++i) st[i] = dpt[i] = 0.f;
    const uint64_t q_desc = smem_desc(q_s, kCore, kGroup);
    const uint64_t do_desc = smem_desc(do_s, kCore, kGroup);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      wgmma_ss_n64(st, k_desc + ks * 16, q_desc + ks * 16, ks > 0);
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      wgmma_ss_n64(dpt, v_desc + ks * 16, do_desc + ks * 16, ks > 0);
    wgmma_commit();
    // the other stage was consumed by the previous tile, whose products
    // every thread waited for before the barrier above
    const int nxt = next_live(cur);
    if (nxt < n_tiles) fetch(stage ^ 1, nxt);
    cp_async_commit();
    wgmma_wait_all();

    // p^T and ds^T, masked pairs selected to 0 (key_seg is 0 past S and
    // the staged q segment id is 0 past T, so those pairs fail the test)
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int local = nt * 8 + tq * 2 + c, t = t0 + local;
        const float lse2 = lse_s[local] * kLog2e, dlt = dlt_s[local];
        const int qs = qseg_s[local];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * nt + 2 * i + c;
          const bool ok = (qs == key_seg[i]) & (key_seg[i] != 0) &
                          (!causal | (key[i] <= t));
          const float p = exp2f(st[e] * scale_log2 - lse2);
          st[e] = ok ? p : 0.f;
          dpt[e] = ok ? p * (dpt[e] - dlt) * scale : 0.f;
        }
      }
    }

    // dv += p^T dO and dk += ds^T Q: A (p^T, ds^T) from the accumulators
    // in registers, B the same tiles read N-major (transposed); one
    // k-step is 16 query rows, two 8-row groups.  Every A fragment is
    // written before the fence that orders it for wgmma.
    uint32_t pa[kQRows / 16][4], sa[kQRows / 16][4];
#pragma unroll
    for (int kk = 0; kk < kQRows / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pa[kk][j] = pack_bf16(st[8 * kk + 2 * j], st[8 * kk + 2 * j + 1]);
        sa[kk][j] = pack_bf16(dpt[8 * kk + 2 * j], dpt[8 * kk + 2 * j + 1]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQRows / 16; ++kk)
      wgmma_rs<D>(dva, pa[kk], smem_desc(do_s + kk * 16 * D, kGroup, kCore));
#pragma unroll
    for (int kk = 0; kk < kQRows / 16; ++kk)
      wgmma_rs<D>(dka, sa[kk], smem_desc(q_s + kk * 16 * D, kGroup, kCore));
    wgmma_commit();
    wgmma_wait_all();
    cur = nxt;
    stage ^= 1;
  }
  cp_async_wait<0>();  // a block with no live tile still copied K and V

  // one head: bf16 dk/dv directly; a GQA group: this head's f32 part,
  // summed over the group by dkv_group_sum_kernel
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!key_ok[i]) continue;
    if (group == 1) {
      const size_t off = kv_base + (size_t)key[i] * D;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        *reinterpret_cast<uint32_t*>(dk + off + dt * 8 + tq * 2) =
            pack_bf16(dka[4 * dt + 2 * i], dka[4 * dt + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + dt * 8 + tq * 2) =
            pack_bf16(dva[4 * dt + 2 * i], dva[4 * dt + 2 * i + 1]);
      }
    } else {
      const size_t off = (((size_t)b * H + h) * S + key[i]) * D;
      const size_t half = (size_t)gridDim.z * H * S * D;   // dk | dv
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        *reinterpret_cast<float2*>(dkv_part + off + dt * 8 + tq * 2) =
            make_float2(dka[4 * dt + 2 * i], dka[4 * dt + 2 * i + 1]);
        *reinterpret_cast<float2*>(dkv_part + half + off + dt * 8 + tq * 2) =
            make_float2(dva[4 * dt + 2 * i], dva[4 * dt + 2 * i + 1]);
      }
    }
  }
}

// dk, dv [B, Hkv, S, D] bf16 = the f32 parts [2, B, H, S, D] summed over
// each GQA group, in head order (deterministic); 4 elements a thread
__global__ void dkv_group_sum_kernel(const float* __restrict__ part,
                                     __nv_bfloat16* __restrict__ dk,
                                     __nv_bfloat16* __restrict__ dv, int B,
                                     int H, int Hkv, int S, int D) {
  const int group = H / Hkv;
  const size_t per_head = (size_t)S * D;
  const size_t n4 = (size_t)B * Hkv * per_head / 4;
  const size_t half = (size_t)B * H * per_head;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = i * 4, bh = e / per_head, r = e % per_head;
    const size_t src = bh * group * per_head + r;   // (b, hk*group) head
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const float* p = part + which * half + src;
      float4 acc = *reinterpret_cast<const float4*>(p);
      for (int g = 1; g < group; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(p + g * per_head);
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      uint2 packed;
      packed.x = pack_bf16(acc.x, acc.y);
      packed.y = pack_bf16(acc.z, acc.w);
      *reinterpret_cast<uint2*>((which == 0 ? dk : dv) + e) = packed;
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
               const int* kv_seg, void* dk, void* dv, float* dkv_part, int B,
               int H, int Hkv, int T, int S, float scale, int causal,
               cudaStream_t stream) {
  const int n_tiles = (T + kQRows - 1) / kQRows;
  if (n_tiles > kMaxFlags) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dkv_smem_bytes<D>() + n_tiles;
  // once per instantiation (a thread-safe static), not on every launch
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dkv_smem_bytes<D>() + kMaxFlags));
  if (attr_err != cudaSuccess) return static_cast<int>(attr_err);
  const int group = H / Hkv;
  if (group > 1 && dkv_part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((S + kKvRows - 1) / kKvRows, H, B);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      q_seg, kv_seg, static_cast<bf16*>(dk), static_cast<bf16*>(dv), dkv_part,
      H, Hkv, T, S, scale, causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || group == 1) return static_cast<int>(err);
  const size_t n4 = (size_t)B * Hkv * S * D / 4;
  const size_t want = (n4 + 255) / 256, cap = 132 * 8;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  dkv_group_sum_kernel<<<blocks, 256, 0, stream>>>(
      dkv_part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, H, Hkv, S,
      D);
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

// as above; dk, dv [B,Hkv,S,D] bf16; dkv_part: f32 [2, B, H, S, D] when
// H > Hkv (unused, may be null, when H == Hkv).  Launches the per-head
// pass and, for a GQA group, the group sum.  Returns cudaGetLastError().
extern "C" int iadr1_flash_bwd_dkv_bf16(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const float* lse, const float* delta,
                                        const int* q_seg, const int* kv_seg,
                                        void* dk, void* dv, float* dkv_part,
                                        int B, int H,
                                        int Hkv, int T, int S, int D,
                                        float scale, int causal,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, q_seg, kv_seg, dk, dv, dkv_part, B, H, Hkv, T, S, scale, causal, st);
    case 80:
      return launch_dkv<80>(q, k, v, dout, lse, delta, q_seg, kv_seg, dk, dv, dkv_part, B, H, Hkv, T, S, scale, causal, st);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, q_seg, kv_seg, dk, dv, dkv_part, B, H, Hkv, T, S, scale, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
