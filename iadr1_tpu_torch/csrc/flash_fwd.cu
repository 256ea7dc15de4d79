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
// Bound on this card: tensor-core FLOPs (4 * D per valid (query, key) pair
// and head, at 989 TFLOP/s dense bf16); bytes are small next to that at
// the main path's lengths.
//
// Design: one warpgroup (128 threads) per (64 stacked query rows, kv head,
// b).  The GQA group's query rows are stacked, row r = g*T + t, so every
// row of a block reads the same K/V head and each K/V tile is loaded once
// for the whole group.  When T is not a multiple of 64 a block's rows run
// from the end of one head into the start of the next; the prologue reads
// each row's own t, so its tests cover both runs.  Each block
// * first marks the 64-key tiles that can hold a valid pair with its rows
//   (hopper_common.cuh `mark_key_tiles`: the id ranges overlap and, when
//   causal, the tile's first key is at most the block's last t), and the
//   live tiles whose every pair is valid (one segment on both sides and,
//   when causal, wholly below the diagonal), which skip the mask.  A
//   block with no live tile loads nothing and writes out = 0, lse = +inf;
// * stages its Q rows once and walks the live tiles with K, V and their
//   segment ids double-buffered by cp.async in the core-matrix layout; the
//   next live tile's copies are issued right after the first product;
// * forms S = Q K^T with wgmma m64n64k16 (both operands in shared memory,
//   K-major), masks it branch-free in the accumulators (selects, with the
//   tile's ids read once from shared memory), runs the online softmax, and
//   accumulates O += P V with wgmma m64nDk16, A from registers (the S
//   accumulators repacked to bf16) and V read N-major through the
//   descriptor, so V needs no transpose;
// * writes bf16 out through a padded shared tile with 16-byte stores.
// Head dims 64, 72, 80 and 128.  SigLIP's 72 is not a multiple of a
// k-step's 16 columns: its rows are staged at a width of 80 whose last 8
// columns are zeroed once per buffer (hopper_common.cuh `kPadD`,
// `zero_pad_cols`), S = Q K^T runs five k-steps over them, and O += P V is
// a wgmma m64n72k16 that reads and writes only the 72 columns.
// What it leaves on the table: the softmax of tile n does not overlap the
// product of tile n+1 inside the block (one warpgroup, no producer warp, no
// TMA; the blocks resident on an SM overlap each other instead: issuing
// the next tile's S before the softmax cost a resident block's registers
// and ran slower on the card); the no-swizzle layout costs shared-memory
// bandwidth a 128-byte swizzle would save; blocks of a causal grid do
// unequal work and are not rebalanced.
#include <math.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

template <int D>
constexpr size_t fwd_smem_bytes() {
  // Q, two stages of K and V (each at the staged width kPadD<D>), two
  // stages of key segment ids, the block's id info; the live-tile flags
  // (one byte per key tile) follow
  return (size_t)5 * kTileRows * kPadD<D> * sizeof(bf16) +
         (size_t)2 * kTileRows * sizeof(int) + 8 * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg, bf16* __restrict__ out,
                 float* __restrict__ lse, int H, int Hkv, int T, int S,
                 float scale_log2, int causal) {
  constexpr int W = kPadD<D>;             // staged width (72 -> 80)
  constexpr int kSteps = W / 16;          // k-steps of S = Q K^T
  constexpr int kTile = kTileRows * W;    // elements of one Q, K or V tile
  constexpr uint32_t kGroup = kGroupBytes<W>;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_st = q_s + kTile;                               // [2][kTile]
  bf16* v_st = k_st + 2 * kTile;                          // [2][kTile]
  int* seg_st = reinterpret_cast<int*>(v_st + 2 * kTile); // [2][64]
  int* info = seg_st + 2 * kTileRows;                     // [8]
  unsigned char* flags = reinterpret_cast<unsigned char*>(info + 8);
  zero_pad_cols<D>(q_s, 5);   // Q and both stages of K and V

  const int group = H / Hkv;
  const int rows_total = group * T;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int row0 = blockIdx.x * kTileRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, tq = lane % 4;
  const int n_tiles = (S + kTileRows - 1) / kTileRows;
  const size_t kv_base = ((size_t)b * Hkv + hk) * (size_t)S * D;
  const int* kv_seg_b = kv_seg + (size_t)b * S;

  mark_key_tiles(flags, info, q_seg + (size_t)b * T, kv_seg_b, row0,
                 rows_total, T, S, causal);

  // (b, head, t) row index of stacked row r of this block, or -1 past the
  // last row
  auto stat_index = [=](int r) -> long long {
    const int rr = row0 + r;
    if (rr >= rows_total) return -1;
    return ((long long)b * H + hk * group + rr / T) * T + rr % T;
  };
  auto fetch = [&](int stage, int tile) {
    stage_tile<D>(k_st + stage * kTile, k + kv_base, tile * kTileRows, S);
    stage_tile<D>(v_st + stage * kTile, v + kv_base, tile * kTileRows, S);
    stage_ids(seg_st + stage * kTileRows, kv_seg_b, tile * kTileRows, S);
  };

  int cur = next_live(flags, -1, n_tiles), stage = 0;
  if (cur < n_tiles) {   // Q rides in the first tile's group
    stage_rows<D>(q_s, q, [&](int r) {
      const long long i = stat_index(r);
      return i < 0 ? i : i * D;
    });
    fetch(0, cur);
  }
  cp_async_commit();

  // this thread's two rows: quad and quad + 8 of its warp's 16
  int row_t[2], row_seg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + warp * 16 + quad + 8 * i;
    row_t[i] = r % T;
    row_seg[i] = r < rows_total ? q_seg[(size_t)b * T + r % T] : 0;
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};   // this thread's part of each row's sum
  const uint64_t q_desc = smem_desc(q_s, kCore, kGroup);

  // the flags are block-uniform, so is the walk
  while (cur < n_tiles) {
    cp_async_wait<0>();   // this tile (and, first time round, Q)
    fence_proxy_async();
    __syncthreads();
    const bf16* k_s = k_st + stage * kTile;
    const bf16* v_s = v_st + stage * kTile;
    const int* seg_s = seg_st + stage * kTileRows;
    const int kv0 = cur * kTileRows;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const uint64_t k_desc = smem_desc(k_s, kCore, kGroup);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      wgmma_ss_n64(s, q_desc + ks * 16, k_desc + ks * 16, ks > 0);
    wgmma_commit();
    // the other stage was consumed by the previous tile, whose products
    // every thread waited for before the barrier above
    const int nxt = next_live(flags, cur, n_tiles);
    if (nxt < n_tiles) fetch(stage ^ 1, nxt);
    cp_async_commit();
    wgmma_wait_all();

    // mask (select, never add) in base-2 units, running max
    float mx[2] = {-INFINITY, -INFINITY};
    if (flags[cur] & 2) {   // every pair valid
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        s[e] *= scale_log2;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int local = nt * 8 + tq * 2 + c, key = kv0 + local;
          const int ks = seg_s[local];   // 0 past S
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * nt + 2 * i + c;
            const bool ok = (ks == row_seg[i]) & (ks != 0) &
                            (!causal | (key <= row_t[i]));
            s[e] = ok ? s[e] * scale_log2 : -INFINITY;
            mx[i] = fmaxf(mx[i], s[e]);
          }
        }
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
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      s[e] = exp2f(s[e] - mx[i]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] *= alpha[i];
#pragma unroll
    for (int e = 0; e < 32; ++e) l[(e >> 1) & 1] += s[e];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

    // O += P V: P from the accumulators, V's rows are the contraction
    // (N-major); every register written above is ordered by the fence
    uint32_t pa[4][4];
    acc_to_a_frags(pa, s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(o, pa[kk], smem_desc(v_s + kk * 16 * W, kGroup, kCore));
    wgmma_commit();
    wgmma_wait_all();
    cur = nxt;
    stage ^= 1;
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const bool empty = l[i] == 0.f;
    inv[i] = empty ? 0.f : 1.f / l[i];
    const long long stat = stat_index(warp * 16 + quad + 8 * i);
    if (tq == 0 && stat >= 0)
      lse[stat] = empty ? INFINITY : m[i] / kLog2e + logf(l[i]);
  }
  __syncthreads();   // every product is done: the K stages are free
  store_rows<D>(o, inv, k_st, out, [&](int r) {
    const long long i = stat_index(r);
    return i < 0 ? i : i * D;
  });
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* q_seg,
           const int* kv_seg, void* out, float* lse, int B, int H, int Hkv,
           int T, int S, float scale_log2, int causal, cudaStream_t stream) {
  const int n_tiles = (S + kTileRows - 1) / kTileRows;
  if (n_tiles > kMaxFlags) return static_cast<int>(cudaErrorInvalidValue);
  // once per instantiation (a thread-safe static), not on every launch
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(fwd_smem_bytes<D>() + kMaxFlags));
  if (attr_err != cudaSuccess) return static_cast<int>(attr_err);
  const int rows = (H / Hkv) * T;
  dim3 grid((rows + kTileRows - 1) / kTileRows, Hkv, B);
  flash_fwd_kernel<D><<<grid, kThreads, fwd_smem_bytes<D>() + n_tiles,
                        stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), q_seg, kv_seg, static_cast<bf16*>(out),
      lse, H, Hkv, T, S, scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
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
      return launch<64>(q, k, v, q_seg, kv_seg, out, lse, B, H, Hkv, T, S, scale_log2, causal, st);
    case 72:
      return launch<72>(q, k, v, q_seg, kv_seg, out, lse, B, H, Hkv, T, S, scale_log2, causal, st);
    case 80:
      return launch<80>(q, k, v, q_seg, kv_seg, out, lse, B, H, Hkv, T, S, scale_log2, causal, st);
    case 128:
      return launch<128>(q, k, v, q_seg, kv_seg, out, lse, B, H, Hkv, T, S, scale_log2, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
