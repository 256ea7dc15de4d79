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
// K2 stays its own kernel: fusing dq into K3 would need a sum across key
// blocks, by atomics (not deterministic) or an f32 workspace per key block
// (about 1.3 GB at the tower's shape).
//
// Both kernels share hopper_common.cuh: the live-tile prologue, cp.async
// staging into wgmma's no-swizzle core-matrix layout, and the wgmma
// products (SS for two operands in shared memory, RS for A from
// registers with B read N-major, i.e. transposed, through the descriptor).
//
// K2: one warpgroup (128 threads) per (64 stacked query rows, kv head, b),
// the GQA group's rows stacked as in K1 (row r = g*T + t; a block whose
// rows run from one head into the next is covered by the prologue, which
// reads each row's own t).  Each block
// * marks the 64-key tiles that can hold a valid pair with its rows, and
//   those whose every pair is valid (K1's `mark_key_tiles`); a block with
//   no live tile loads nothing and writes dq = 0;
// * stages Q and dO once and walks the live key tiles with K, V and their
//   segment ids double-buffered by cp.async, the next live tile's copies
//   issued right after the first product batch;
// * forms s = Q K^T and dp = dO V^T with wgmma m64n64k16, selects ds in
//   the accumulators (branch-free; skipped where every pair is valid) and
//   accumulates dq += ds K with wgmma m64nDk16, ds from registers and K
//   read N-major, so K needs no column loads;
// * writes bf16 dq through a padded shared tile with 16-byte stores.
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
//   through the descriptor;
// * writes bf16 dk/dv when the group is one head, else this head's f32
//   part to a workspace that a second pass sums over the group in head
//   order.
// What both leave on the table: the products of one tile run in serial
// wgmma batches with the mask arithmetic between them (no second
// warpgroup to overlap them, no producer warp, no TMA); the no-swizzle
// layout costs shared-memory bandwidth that a 128-byte swizzle would
// save; K3's group sum round-trips f32 parts through device memory.
#include <math.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kKvRows = kTileRows;   // K3: keys per block (4 warps x 16)
constexpr int kQRows = kTileRows;    // K3: query rows per tile (wgmma N)

// K2 shared memory: Q, dO, two stages of K and V, two stages of key
// segment ids, the block's id info; the live-tile flags (one byte per key
// tile) follow
template <int D>
constexpr size_t dq_smem_bytes() {
  return (size_t)6 * kTileRows * D * sizeof(bf16) +
         (size_t)2 * kTileRows * sizeof(int) + 8 * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ q_seg,
                    const int* __restrict__ kv_seg, bf16* __restrict__ dq,
                    int H, int Hkv, int T, int S, float scale, int causal) {
  constexpr int kSteps = D / 16;          // k-steps of s and dp
  constexpr int kTile = kTileRows * D;    // elements of one tile
  constexpr uint32_t kGroup = kGroupBytes<D>;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kTile;
  bf16* k_st = do_s + kTile;                              // [2][kTile]
  bf16* v_st = k_st + 2 * kTile;                          // [2][kTile]
  int* seg_st = reinterpret_cast<int*>(v_st + 2 * kTile); // [2][64]
  int* info = seg_st + 2 * kTileRows;                     // [8]
  unsigned char* flags = reinterpret_cast<unsigned char*>(info + 8);

  const float scale_log2 = scale * kLog2e;
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

  // element offset of stacked row r of this block in q / dout / dq, or -1
  // past the last row
  auto row_off = [=](int r) -> long long {
    const int rr = row0 + r;
    if (rr >= rows_total) return -1;
    return (((long long)b * H + hk * group + rr / T) * T + rr % T) * D;
  };
  auto fetch = [&](int stage, int tile) {
    stage_tile<D>(k_st + stage * kTile, k + kv_base, tile * kTileRows, S);
    stage_tile<D>(v_st + stage * kTile, v + kv_base, tile * kTileRows, S);
    stage_ids(seg_st + stage * kTileRows, kv_seg_b, tile * kTileRows, S);
  };

  int cur = next_live(flags, -1, n_tiles), stage = 0;
  if (cur < n_tiles) {   // Q and dO ride in the first tile's group
    stage_rows<D>(q_s, q, row_off);
    stage_rows<D>(do_s, dout, row_off);
    fetch(0, cur);
  }
  cp_async_commit();

  // this thread's two rows: quad and quad + 8 of its warp's 16
  int row_t[2], row_seg[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + quad + 8 * i;
    const long long off = row_off(r);
    row_t[i] = (row0 + r) % T;
    row_seg[i] = off >= 0 ? q_seg[(size_t)b * T + row_t[i]] : 0;
    lse2[i] = off >= 0 ? lse[off / D] * kLog2e : INFINITY;
    dlt[i] = off >= 0 ? delta[off / D] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint64_t q_desc = smem_desc(q_s, kCore, kGroup);
  const uint64_t do_desc = smem_desc(do_s, kCore, kGroup);

  // the flags are block-uniform, so is the walk
  while (cur < n_tiles) {
    cp_async_wait<0>();   // this tile (and, first time round, Q and dO)
    fence_proxy_async();
    __syncthreads();
    const bf16* k_s = k_st + stage * kTile;
    const bf16* v_s = v_st + stage * kTile;
    const int* seg_s = seg_st + stage * kTileRows;
    const int kv0 = cur * kTileRows;

    // s = Q K^T and dp = dO V^T, [64 rows, 64 keys], both K-major
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    const uint64_t k_desc = smem_desc(k_s, kCore, kGroup);
    const uint64_t v_desc = smem_desc(v_s, kCore, kGroup);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      wgmma_ss_n64(s, q_desc + ks * 16, k_desc + ks * 16, ks > 0);
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      wgmma_ss_n64(dp, do_desc + ks * 16, v_desc + ks * 16, ks > 0);
    wgmma_commit();
    // the other stage was consumed by the previous tile, whose products
    // every thread waited for before the barrier above
    const int nxt = next_live(flags, cur, n_tiles);
    if (nxt < n_tiles) fetch(stage ^ 1, nxt);
    cp_async_commit();
    wgmma_wait_all();

    // ds = p * (dp - delta) * scale, masked pairs selected to 0
    if (flags[cur] & 2) {   // every pair valid
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1;
        s[e] = exp2f(s[e] * scale_log2 - lse2[i]) * (dp[e] - dlt[i]) * scale;
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
            const float p = exp2f(s[e] * scale_log2 - lse2[i]);
            s[e] = ok ? p * (dp[e] - dlt[i]) * scale : 0.f;
          }
        }
      }
    }

    // dq += ds K: ds from the accumulators, K's rows are the contraction
    // (N-major); every fragment is written before the fence
    uint32_t sa[4][4];
    acc_to_a_frags(sa, s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(acc, sa[kk], smem_desc(k_s + kk * 16 * D, kGroup, kCore));
    wgmma_commit();
    wgmma_wait_all();
    cur = nxt;
    stage ^= 1;
  }

  __syncthreads();   // every product is done: the K stages are free
  const float one[2] = {1.f, 1.f};
  store_rows<D>(acc, one, k_st, dq, row_off);
}

// K3 shared memory: K and V tiles, then two stages of (Q, dO, lse, delta,
// q segment ids), the key block's id info; the live-tile flags (one byte
// per query tile) follow
template <int D>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(2 * kKvRows + 4 * kQRows) * D * sizeof(bf16) +
         (size_t)2 * 3 * kQRows * sizeof(float) + 8 * sizeof(int);
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
  constexpr uint32_t kGroup = kGroupBytes<D>;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kKvRows * D;
  __nv_bfloat16* q_st = v_s + kKvRows * D;              // [2][kTile]
  __nv_bfloat16* do_st = q_st + 2 * kTile;              // [2][kTile]
  float* lse_st = reinterpret_cast<float*>(do_st + 2 * kTile);
  float* dlt_st = lse_st + 2 * kQRows;                  // [2][kQRows]
  int* qseg_st = reinterpret_cast<int*>(dlt_st + 2 * kQRows);
  int* info = qseg_st + 2 * kQRows;                     // [8]
  unsigned char* live_s = reinterpret_cast<unsigned char*>(info + 8);

  const float scale_log2 = scale * kLog2e;
  const int group = H / Hkv;
  const int b = blockIdx.z, h = blockIdx.y, hk = h / group;
  const int kv0 = blockIdx.x * kKvRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, tq = lane % 4;
  const size_t kv_base = ((size_t)b * Hkv + hk) * (size_t)S * D;
  const size_t head_row = ((size_t)b * H + h) * T;

  // Which query tiles can hold a valid pair with this key block
  // (`mark_tiles`): the tile's and the block's ranges of non-zero segment
  // ids must overlap and, when causal, the tile's last row must reach kv0
  // (this also ends the walk when T < S).
  const int n_tiles = (T + kQRows - 1) / kQRows;
  reset_block_info(info);
  if (threadIdx.x < kKvRows) {
    const int s = kv0 + threadIdx.x;
    add_block_entry(info, s < S, s < S ? kv_seg[(size_t)b * S + s] : 0, s);
  }
  __syncthreads();
  const TileTest test = {info[0], info[1], INT_MAX, causal ? kv0 : INT_MIN,
                         0, INT_MAX};
  mark_tiles(live_s, q_seg + (size_t)b * T, T, test);

  // one query tile's Q, dO, lse, delta and segment ids into a stage
  auto fetch = [&](int stage, int tile) {
    const int t0 = tile * kQRows;
    stage_tile<D>(q_st + stage * kTile, q + head_row * D, t0, T);
    stage_tile<D>(do_st + stage * kTile, dout + head_row * D, t0, T);
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
  // K and V ride in the first tile's group
  stage_tile<D>(k_s, k + kv_base, kv0, S);
  stage_tile<D>(v_s, v + kv_base, kv0, S);
  int cur = next_live(live_s, -1, n_tiles), stage = 0;
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
    const int nxt = next_live(live_s, cur, n_tiles);
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
    uint32_t pa[4][4], sa[4][4];
    acc_to_a_frags(pa, st);
    acc_to_a_frags(sa, dpt);
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
                                     bf16* __restrict__ dk,
                                     bf16* __restrict__ dv, int B,
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

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const int* q_seg,
              const int* kv_seg, void* dq, int B, int H, int Hkv, int T, int S,
              float scale, int causal, cudaStream_t stream) {
  const int n_tiles = (S + kTileRows - 1) / kTileRows;
  if (n_tiles > kMaxFlags) return static_cast<int>(cudaErrorInvalidValue);
  // once per instantiation (a thread-safe static), not on every launch
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_smem_bytes<D>() + kMaxFlags));
  if (attr_err != cudaSuccess) return static_cast<int>(attr_err);
  const int rows = (H / Hkv) * T;
  dim3 grid((rows + kTileRows - 1) / kTileRows, Hkv, B);
  flash_bwd_dq_kernel<D><<<grid, kThreads, dq_smem_bytes<D>() + n_tiles,
                           stream>>>(
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
