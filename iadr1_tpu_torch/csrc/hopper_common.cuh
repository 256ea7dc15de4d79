// Helpers shared by the hand-written Hopper (sm_90a) kernels: bf16
// packing, cp.async staging, wgmma's shared-memory descriptors, the wgmma
// products the flash kernels use, and the live-tile prologue of K1, K2
// and K3.  Everything sits in namespace `hopper`; nothing here is a
// kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace hopper {

constexpr int kThreads = 128;        // one warpgroup
constexpr int kTileRows = 64;        // rows of every flash tile (wgmma M)
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxFlags = 16 * 1024; // live-tile flags: up to 64 * this rows

using bf16 = __nv_bfloat16;

// two floats -> bf16x2 with `lo` in the low half (the lower column index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Flash tiles live in shared memory in wgmma's no-swizzle "core matrix"
// layout: 8 rows x 16 bytes (8 bf16) stored as 128 contiguous bytes, the
// core matrices of an 8-row group side by side along D, the groups one
// after another.  Element (r, c) of a [rows, D] tile sits at
//   (r / 8) * 8 * D + (c / 8) * 64 + (r % 8) * 8 + c % 8     (elements)
// One tile serves two descriptors: read K-major (contraction over D, as
// in s = Q K^T) and N-major (contraction over rows, as in o += p V).
template <int D>
__device__ __forceinline__ int cm_offset(int r, int c8) {
  return (r / 8) * 8 * D + c8 * 64 + (r % 8) * 8;
}

// descriptor offsets, bytes: a core matrix is 128 B; an 8-row group of a
// [rows, D] tile is 16 * D B.  K-major: (kCore, group); N-major: (group,
// kCore).
constexpr uint32_t kCore = 128;
template <int D>
constexpr uint32_t kGroupBytes = 16 * D;

// wgmma shared-memory matrix descriptor, no swizzle: start address,
// leading byte offset (between core matrices along the contraction) and
// stride byte offset (between core matrices along M or N), all >> 4.
// Adding 16 to a K-major descriptor steps 16 columns (256 B) along D.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// orders this thread's register writes (A fragments, accumulators) before
// the wgmma that reads them
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

// The accumulator of an m64nN product: thread (warp w, lane l) holds rows
// 16w + l/4 (i = 0) and 16w + l/4 + 8 (i = 1), columns 8j + 2(l%4) + c,
// as element 4j + 2i + c.  Its 16-column slice kk, repacked to bf16, is
// the A fragment of a k-step: a[j] = (elements 8kk + 2j, 8kk + 2j + 1).

// d[32] (+)= A[64, 16] (shared, K-major) * B[16, 64] (shared,
// K-major): wgmma m64n64k16, f32 accumulate; scale_d = 0 overwrites d
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

// d[D/2] += A[64, 16] (registers) * B[16, D] (shared, N-major)
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (D == 80) wgmma_rs_n80(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// the 16-column slices of an m64n64 accumulator, repacked to bf16 A
// fragments (the FA2 register trick)
__device__ __forceinline__ void acc_to_a_frags(uint32_t (&a)[4][4],
                                               const float (&acc)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(acc[8 * kk + 2 * j], acc[8 * kk + 2 * j + 1]);
}

// ---------------------------------------------------------------------------
// staging tiles
// ---------------------------------------------------------------------------

// 64 rows of D bf16 into a core-matrix tile by 16-byte cp.async copies:
// row r comes from src + row_off(r) (elements), or is zero-filled when
// row_off(r) < 0.  Eight neighbouring threads take eight rows of one
// 16-byte column, so a warp writes 512 contiguous bytes.
template <int D, class RowOff>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           RowOff row_off) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < kTileRows * kChunks; idx += kThreads) {
    const int r8 = idx % 8, rest = idx / 8;
    const int c8 = rest % kChunks, r = (rest / kChunks) * 8 + r8;
    bf16* d = dst + cm_offset<D>(r, c8);
    const long long off = row_off(r);
    if (off >= 0)
      cp_async16(d, src + off + c8 * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// rows [row0, row0 + 64) of a [n, D] bf16 matrix, zero-filled past n
template <int D>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           int row0, int n) {
  stage_rows<D>(dst, src, [=](int r) -> long long {
    return row0 + r < n ? (long long)(row0 + r) * D : -1;
  });
}

// ids [i0, i0 + 64) of one row of segment ids by 4-byte cp.async, 0 past n
__device__ __forceinline__ void stage_ids(int* dst, const int* src, int i0,
                                          int n) {
  for (int idx = threadIdx.x; idx < kTileRows; idx += kThreads) {
    if (i0 + idx < n)
      cp_async4(dst + idx, src + i0 + idx);
    else
      dst[idx] = 0;
  }
}

// A [64, D] f32 accumulator (the wgmma layout above), each row times
// mul[i], to bf16 rows in device memory: through a row-major shared tile
// padded by 8 elements (the accumulator's 4-byte writes hit 32 distinct
// banks), then 16-byte stores along each row.  Row r goes to dst +
// row_off(r), or nowhere when row_off(r) < 0.  `tile` holds 64 * (D + 8)
// elements and no wgmma may still read it.
template <int D, class RowOff>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           const float (&mul)[2], bf16* tile,
                                           bf16* dst, RowOff row_off) {
  constexpr int kStride = D + 8, kChunks = D / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + lane / 4 + 8 * i;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(tile + r * kStride + dt * 8 +
                                   (lane % 4) * 2) =
          pack_bf16(acc[4 * dt + 2 * i] * mul[i],
                    acc[4 * dt + 2 * i + 1] * mul[i]);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kTileRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c8 = idx % kChunks;
    const long long off = row_off(r);
    if (off >= 0)
      *reinterpret_cast<uint4*>(dst + off + c8 * 8) =
          *reinterpret_cast<const uint4*>(tile + r * kStride + c8 * 8);
  }
}

// ---------------------------------------------------------------------------
// the live-tile prologue (K1, K2, K3)
// ---------------------------------------------------------------------------

// A block covers 64 entries on one side of the (query, key) grid (K1, K2:
// stacked query rows; K3: keys) and walks 64-entry tiles of the other
// side.  A tile can hold a valid pair only when its and the block's
// ranges of non-zero segment ids overlap and, when causal, the positions
// allow it.  The test reads ranges, so it is conservative for any ids,
// sorted or not.
struct TileTest {
  int lo, hi;          // the block's non-zero ids (lo > hi: none)
  int first_max;       // a tile whose first entry is past this is dead
  int last_min;        // a tile whose last entry is before this is dead
  int uniform;         // the block's one id when every entry holds it,
                       // else 0
  int full_last_max;   // a tile can be full only if its last entry is at
                       // most this (causal K1/K2: the block's first t)
};

// Block-wide reduction of (id, position) over the block's entries into
// info[0..4] = (lo, hi, min position, max position, any entry missing or
// of id 0).  info must be reset by reset_block_info first; both end
// with a barrier.
__device__ __forceinline__ void reset_block_info(int* info) {
  if (threadIdx.x == 0) {
    info[0] = INT_MAX;
    info[1] = INT_MIN;
    info[2] = INT_MAX;
    info[3] = INT_MIN;
    info[4] = 0;
  }
  __syncthreads();
}
__device__ __forceinline__ void add_block_entry(int* info, bool present,
                                                int id, int pos) {
  if (!present || id == 0) info[4] = 1;
  if (present) {
    atomicMin(&info[2], pos);
    atomicMax(&info[3], pos);
    if (id != 0) {
      atomicMin(&info[0], id);
      atomicMax(&info[1], id);
    }
  }
}

// flags[i] for each 64-entry tile i of seg[0, n): bit 0 when the tile is
// live; bit 1, in addition, when every pair of the tile with the block is
// valid: the tile is whole (64 entries below n), all its ids equal
// t.uniform (non-zero) and its last entry is at most t.full_last_max.
// Four neighbouring threads cover one tile, 16 entries each, with their
// loads in flight together.  Ends with a barrier.
__device__ __forceinline__ void mark_tiles(unsigned char* flags,
                                           const int* seg, int n,
                                           const TileTest& t) {
  constexpr int kPart = kTileRows / 4;
  const int n_tiles = (n + kTileRows - 1) / kTileRows;
  for (int base = 0; base < n_tiles * 4; base += kThreads) {
    const int part = base + threadIdx.x, e0 = part * kPart;
    int lo = INT_MAX, hi = INT_MIN, gap = 0;
#pragma unroll
    for (int j = 0; j < kPart; ++j) {
      const int id = e0 + j < n ? seg[e0 + j] : 0;
      if (id != 0) {
        lo = min(lo, id);
        hi = max(hi, id);
      } else {
        gap = 1;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      gap |= __shfl_xor_sync(0xffffffffu, gap, off);
    }
    const int i = part / 4;
    if (part % 4 == 0 && i < n_tiles) {
      const int first = i * kTileRows;
      const int last = min(first + kTileRows, n) - 1;
      const bool live = lo <= hi && t.lo <= t.hi && lo <= t.hi &&
                        t.lo <= hi && first <= t.first_max &&
                        last >= t.last_min;
      const bool full = live && !gap && lo == hi && lo == t.uniform &&
                        last <= t.full_last_max;
      flags[i] = static_cast<unsigned char>(live | (full << 1));
    }
  }
  __syncthreads();
}

// the next live tile after `tile` (n_tiles when none is left)
__device__ __forceinline__ int next_live(const unsigned char* flags,
                                         int tile, int n_tiles) {
  do ++tile; while (tile < n_tiles && !flags[tile]);
  return tile;
}

// The prologue of K1 and K2: a block of 64 stacked query rows (row r =
// g * T + t, the GQA group's heads one after another).  When T is not a
// multiple of 64 a block's rows can run from the end of one head into the
// start of the next; the reduction reads each row's own t, so the id
// range and the causal bound cover both runs.  Marks the key tiles of
// kv_seg[0, S) and returns the test.
__device__ __forceinline__ void mark_key_tiles(unsigned char* flags,
                                               int* info, const int* q_seg,
                                               const int* kv_seg, int row0,
                                               int rows_total, int T, int S,
                                               int causal) {
  reset_block_info(info);
  if (threadIdx.x < kTileRows) {
    const int r = row0 + threadIdx.x;
    const bool present = r < rows_total;
    const int t = present ? r % T : 0;
    add_block_entry(info, present, present ? q_seg[t] : 0, t);
  }
  __syncthreads();
  TileTest test;
  test.lo = info[0];
  test.hi = info[1];
  test.first_max = causal ? info[3] : INT_MAX;  // no key past the last t
  test.last_min = INT_MIN;
  test.uniform = (!info[4] && info[0] == info[1]) ? info[0] : 0;
  test.full_last_max = causal ? info[2] : INT_MAX;  // every key <= every t
  mark_tiles(flags, kv_seg, S, test);
}

}  // namespace hopper
