// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel is exported through a plain C function that launches on the
// caller's stream, allocates nothing (the Python wrapper hands in outputs
// and scratch) and returns the cudaError_t of the launch, which the wrapper
// checks. Reductions across CTAs never use float atomics, so every sum is
// taken in the same order on every run: either each CTA writes its partial
// to scratch and a second small kernel combines the partials in ascending
// CTA order, or (gram) the CTAs form one cluster and its first CTA sums the
// others' partials over distributed shared memory in a fixed order. The
// directional extremes are folded by (value, lowest row), which is exact in
// any order; the sweep's sketch has no partials at all: each bucket has one
// owner, which adds the bucket's points in ascending order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// Element loads and stores of the kernels that take bfloat16 or float32:
// arithmetic is float32, conversions go through the intrinsics.
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Tensor-core helpers of the bf16 bodies (flash_attention, ssd).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// D = A·B + D for one 16×8×16 tile: A row-major 16×16 bf16 (4 regs), B
// column-major 16×8 bf16 (2 regs), D 16×8 f32 (4 regs).
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Asynchronous copies global → shared of 16, 8 and 4 bytes (the cp.async
// rings of gram.cu and extremes.cu); both addresses aligned to the size.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// Largest P-row width (Bernstein degree + 1) the templated kernels take.
#define REPRO_MAX_DP 16

// Compensated (Kahan) f32 accumulator: the moment and Gram sums run over
// tens of thousands of rows, and the compensation keeps their f32 result
// within a few ulp of the exact sum, whatever the row count.
struct KahanSum {
  float s;
  float c;
  __device__ __forceinline__ KahanSum() : s(0.f), c(0.f) {}
  __device__ __forceinline__ void add(float x) {
    const float y = x - c;
    const float t = s + y;
    c = (t - s) - y;
    s = t;
  }
};

#define REPRO_DP_CASE(N, ...)  \
  case N: {                    \
    constexpr int DP = N;      \
    __VA_ARGS__;               \
  } break;

// Instantiate a statement for the runtime P-row width dp ∈ [1, 16].
#define REPRO_DISPATCH_DP(dp, ...)                                        \
  switch (dp) {                                                           \
    REPRO_DP_CASE(1, __VA_ARGS__) REPRO_DP_CASE(2, __VA_ARGS__)           \
    REPRO_DP_CASE(3, __VA_ARGS__) REPRO_DP_CASE(4, __VA_ARGS__)           \
    REPRO_DP_CASE(5, __VA_ARGS__) REPRO_DP_CASE(6, __VA_ARGS__)           \
    REPRO_DP_CASE(7, __VA_ARGS__) REPRO_DP_CASE(8, __VA_ARGS__)           \
    REPRO_DP_CASE(9, __VA_ARGS__) REPRO_DP_CASE(10, __VA_ARGS__)          \
    REPRO_DP_CASE(11, __VA_ARGS__) REPRO_DP_CASE(12, __VA_ARGS__)         \
    REPRO_DP_CASE(13, __VA_ARGS__) REPRO_DP_CASE(14, __VA_ARGS__)         \
    REPRO_DP_CASE(15, __VA_ARGS__) REPRO_DP_CASE(16, __VA_ARGS__)         \
    default:                                                              \
      return (int)cudaErrorInvalidValue;                                  \
  }


// ---------------------------------------------------------------------------
// Directional extremes (extremes.cu, sweep.cu): per direction, (max, argmax,
// min, argmin) of dirs @ Pᵀ over the valid rows of P, first occurrence on
// ties, in two launches.
//
// Score CTAs: a CTA stages a block of P's rows in shared memory, padded to
// a multiple of 4 floats so a row is one or more 16-byte broadcast loads,
// and each thread holds kExtR directions in registers, so a staged row
// feeds kExtR·DP FMAs. The inner loop keeps only fmaxf/fminf of the scores
// over a tile of kExtTile rows; a tile whose max beats the running max
// strictly (min: below it) becomes the winner, so the block's partial is
// (its extreme, the first row of the first tile that attains it).
//
// Fold CTAs fold the partials by (value, then lowest row), which is exact,
// so the result does not depend on the order of the fold: it is the
// extreme and the first tile of P that attains it. Then one rescan of that
// tile, a row a lane, finds the first row whose score equals the extreme:
// the same FMA chain gives the same bits, and == treats -0 and +0 as equal,
// as the dense argmax does. Rows at or past n_valid are never scored; they
// follow every valid row, so a rescan never stops at one.

// The wrappers' launch plans read kExtWarpDirs, kExtMaxWarps, kExtTile,
// kExtCtasPerSm and kExtMaxBlockRows from kernels/_lib.py:CUDA_CONSTANTS,
// which tests/test_torch_structure.py holds to the values here.
constexpr int kExtR = 4;                  // directions a thread
constexpr int kExtTile = 16;              // rows a tile (blocks are whole tiles)
constexpr int kExtWarpDirs = 32 * kExtR;  // directions a warp
constexpr int kExtFoldDirs = 32;          // directions a fold CTA
constexpr int kExtFoldWarps = 16;         // warps of a fold CTA
// warps of a score CTA at most: kExtCtasPerSm CTAs of 416 threads fit an
// SM's registers at ≤ 72 a thread (__launch_bounds__(416, 2))
constexpr int kExtMaxWarps = 13;
constexpr int kExtCtasPerSm = 2;
constexpr int kExtMaxBlockRows = 512;     // P rows a score CTA stages at most
static_assert(2 * kExtTile == 32, "a rescan takes a row a lane, max and min in one warp");
static_assert(2 * kExtFoldWarps == kExtFoldDirs, "two rescanned directions a fold warp");

__host__ __device__ constexpr int pad4(int dp) { return (dp + 3) / 4 * 4; }

// dirs·p as an FMA chain in feature order: s = d0·p0, s = fma(dk, pk, s).
// This is the rounding the JAX package's CPU dot and the plain version
// (ref.py) reproduce, so argmax indices agree exactly, first occurrence on
// exact ties included.
template <int DP>
__device__ __forceinline__ float dir_score(const float (&dv)[DP], const float (&p)[DP]) {
  float s = dv[0] * p[0];
#pragma unroll
  for (int k = 1; k < DP; ++k) s = fmaf(dv[k], p[k], s);
  return s;
}

// Row i of a staged block (rows of pad4(DP) floats, 16-byte aligned).
template <int DP>
__device__ __forceinline__ void staged_row(const float* __restrict__ tile, int i,
                                           float (&p)[DP]) {
  const float4* r = reinterpret_cast<const float4*>(tile + i * pad4(DP));
#pragma unroll
  for (int q = 0; q < pad4(DP) / 4; ++q) {
    const float4 v = r[q];
    if (4 * q + 0 < DP) p[4 * q + 0] = v.x;
    if (4 * q + 1 < DP) p[4 * q + 1] = v.y;
    if (4 * q + 2 < DP) p[4 * q + 2] = v.z;
    if (4 * q + 3 < DP) p[4 * q + 3] = v.w;
  }
}

// One staged row's scores folded into the tile's (hi, lo).
template <int DP>
__device__ __forceinline__ void row_minmax(const float* __restrict__ tile, int i,
                                           const float (&dv)[kExtR][DP], float (&hi)[kExtR],
                                           float (&lo)[kExtR]) {
  float p[DP];
  staged_row<DP>(tile, i, p);
#pragma unroll
  for (int k = 0; k < kExtR; ++k) {
    const float s = dir_score<DP>(dv[k], p);
    hi[k] = fmaxf(hi[k], s);
    lo[k] = fminf(lo[k], s);
  }
}

// One thread's partials for its kExtR directions over the first nv rows of
// a staged block whose first row is P's row base: each extreme and the
// first row of the first tile attaining it. With no valid row (or none
// whose score beats ∓inf) a partial is (-inf, base, +inf, base), which the
// fold never picks over a real score.
template <int DP>
__device__ __forceinline__ void block_extremes(const float* __restrict__ tile, int nv, int base,
                                               const float (&dv)[kExtR][DP],
                                               float (&vmax)[kExtR], int (&imax)[kExtR],
                                               float (&vmin)[kExtR], int (&imin)[kExtR]) {
#pragma unroll
  for (int k = 0; k < kExtR; ++k) {
    vmax[k] = -CUDART_INF_F;
    vmin[k] = CUDART_INF_F;
    imax[k] = imin[k] = base;
  }
  for (int r0 = 0; r0 < nv; r0 += kExtTile) {
    float hi[kExtR], lo[kExtR];
#pragma unroll
    for (int k = 0; k < kExtR; ++k) {
      hi[k] = -CUDART_INF_F;
      lo[k] = CUDART_INF_F;
    }
    if (r0 + kExtTile <= nv) {
#pragma unroll
      for (int j = 0; j < kExtTile; ++j) row_minmax<DP>(tile, r0 + j, dv, hi, lo);
    } else {
      for (int j = r0; j < nv; ++j) row_minmax<DP>(tile, j, dv, hi, lo);
    }
#pragma unroll
    for (int k = 0; k < kExtR; ++k) {
      if (hi[k] > vmax[k]) {
        vmax[k] = hi[k];
        imax[k] = base + r0;
      }
      if (lo[k] < vmin[k]) {
        vmin[k] = lo[k];
        imin[k] = base + r0;
      }
    }
  }
}

// Warps of a score CTA for m directions (one CTA row covers warps·128).
__host__ __device__ inline int ext_row_warps(int m, int warps) {
  return (m + warps * kExtWarpDirs - 1) / (warps * kExtWarpDirs);
}

// Rows [base, base + cnt) of P (rows × DP f32) staged into tile, padded to
// pad4(DP) floats a row (the pad is zero); the caller synchronizes.
template <int DP>
__device__ __forceinline__ void stage_rows(const float* __restrict__ P, int base, int cnt,
                                           float* __restrict__ tile) {
  constexpr int DP4 = pad4(DP);
  for (int i = threadIdx.x; i < cnt * DP4; i += blockDim.x) {
    const int r = i / DP4, k = i - r * DP4;
    tile[i] = k < DP ? P[(long long)(base + r) * DP + k] : 0.f;
  }
}

// The scoring of one block of a score launch, staged in tile (cnt rows from
// P's row base, 16-byte aligned): directions dir0 + w·128 + k·32 + lane
// for warps w < warps; partials at [blk·m + dir]. Warps past `warps` return.
template <int DP>
__device__ __forceinline__ void score_block(const float* __restrict__ tile, int base, int cnt,
                                            int n_valid, const float* __restrict__ dirs, int m,
                                            int warps, int blk, int dir0,
                                            float* __restrict__ pvmax, int* __restrict__ pimax,
                                            float* __restrict__ pvmin, int* __restrict__ pimin) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= warps) return;
  float dv[kExtR][DP];
#pragma unroll
  for (int k = 0; k < kExtR; ++k) {
    const int d = min(dir0 + warp * kExtWarpDirs + k * 32 + lane, m - 1);
#pragma unroll
    for (int j = 0; j < DP; ++j) dv[k][j] = dirs[(long long)d * DP + j];
  }
  const int nv = max(0, min(cnt, n_valid - base));
  float vmax[kExtR], vmin[kExtR];
  int imax[kExtR], imin[kExtR];
  block_extremes<DP>(tile, nv, base, dv, vmax, imax, vmin, imin);
#pragma unroll
  for (int k = 0; k < kExtR; ++k) {
    const int d = dir0 + warp * kExtWarpDirs + k * 32 + lane;
    if (d < m) {
      const long long o = (long long)blk * m + d;
      pvmax[o] = vmax[k];
      pimax[o] = imax[k];
      pvmin[o] = vmin[k];
      pimin[o] = imin[k];
    }
  }
}

// (v, i) replaces (bv, bi) as the max: larger value, or equal value at a
// lower row. Exact, so any order of the fold gives the same pair.
__device__ __forceinline__ bool beats_max(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}
__device__ __forceinline__ bool beats_min(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// A fold CTA (kExtFoldWarps warps) for directions dir0 + lane, lane < 32,
// over nblk partials [b·m + dir] of a score launch over P (rows × DP). Warp
// w reads blocks w, w + 16, ... (each read covers 32 consecutive
// directions: coalesced); warp 0 folds the warps' results; then warp w
// rescans the winning tiles of directions 2w and 2w + 1, lanes 0–15 the
// max's tile and lanes 16–31 the min's, a row a lane. DP = 0 (the wide
// body, whose partials hold the exact row): warp 0 writes its fold, no
// rescan. smem: 4·16·32 words.
template <int DP>
__device__ __forceinline__ void extremes_fold_cta(
    const float* __restrict__ pvmax, const int* __restrict__ pimax,
    const float* __restrict__ pvmin, const int* __restrict__ pimin, int nblk, int m, int dir0,
    const float* __restrict__ P, int rows, const float* __restrict__ dirs,
    float* __restrict__ smem, float* __restrict__ vmax, int* __restrict__ imax,
    float* __restrict__ vmin, int* __restrict__ imin) {
  constexpr int kNone = 0x7fffffff;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float bx = -CUDART_INF_F, bn = CUDART_INF_F;
  int jx = kNone, jn = kNone;
  if (dir0 + lane < m) {
    for (int b0 = warp; b0 < nblk; b0 += 8 * kExtFoldWarps) {  // 8 blocks' loads in flight
      float vx[8], vn[8];
      int ix[8], in[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int b = b0 + u * kExtFoldWarps;
        const long long o = (long long)min(b, nblk - 1) * m + dir0 + lane;
        vx[u] = b < nblk ? pvmax[o] : -CUDART_INF_F;
        vn[u] = b < nblk ? pvmin[o] : CUDART_INF_F;
        ix[u] = b < nblk ? pimax[o] : kNone;
        in[u] = b < nblk ? pimin[o] : kNone;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (beats_max(vx[u], ix[u], bx, jx)) {
          bx = vx[u];
          jx = ix[u];
        }
        if (beats_min(vn[u], in[u], bn, jn)) {
          bn = vn[u];
          jn = in[u];
        }
      }
    }
  }
  float* sx = smem;
  float* sn = sx + kExtFoldWarps * 32;
  int* ix_ = reinterpret_cast<int*>(sn + kExtFoldWarps * 32);
  int* in_ = ix_ + kExtFoldWarps * 32;
  sx[warp * 32 + lane] = bx;
  sn[warp * 32 + lane] = bn;
  ix_[warp * 32 + lane] = jx;
  in_[warp * 32 + lane] = jn;
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < kExtFoldWarps; ++w) {
      if (beats_max(sx[w * 32 + lane], ix_[w * 32 + lane], bx, jx)) {
        bx = sx[w * 32 + lane];
        jx = ix_[w * 32 + lane];
      }
      if (beats_min(sn[w * 32 + lane], in_[w * 32 + lane], bn, jn)) {
        bn = sn[w * 32 + lane];
        jn = in_[w * 32 + lane];
      }
    }
  }
  if constexpr (DP == 0) {  // the wide body's partials name the exact row: no rescan
    if (warp == 0 && dir0 + lane < m) {
      vmax[dir0 + lane] = bx;
      imax[dir0 + lane] = jx == kNone ? 0 : jx;
      vmin[dir0 + lane] = bn;
      imin[dir0 + lane] = jn == kNone ? 0 : jn;
    }
    return;
  }
  __syncthreads();  // warp 0's results replace row 0 of the tables
  if (warp == 0) {
    sx[lane] = bx;
    sn[lane] = bn;
    ix_[lane] = jx;
    in_[lane] = jn;
  }
  __syncthreads();
  const int half = lane >> 4, j = lane & 15;  // extreme (max, min), row of its tile
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int l = 2 * warp + q, dir = dir0 + l;
    if (dir >= m) break;  // uniform across the warp
    const float v = half == 0 ? sx[l] : sn[l];
    const int t0 = half == 0 ? ix_[l] : in_[l];
    const int row = t0 + j;
    bool hit = false;
    float s = v;
    if (t0 != kNone && row < rows) {
      if constexpr (DP > 0) {
        float dv[DP], p[DP];
#pragma unroll
        for (int k = 0; k < DP; ++k) {
          dv[k] = dirs[(long long)dir * DP + k];
          p[k] = P[(long long)row * DP + k];
        }
        s = dir_score<DP>(dv, p);
      }
      hit = s == v;
    }
    const unsigned ball = __ballot_sync(0xffffffffu, hit);
    const unsigned mine = (ball >> (16 * half)) & 0xffffu;
    const int first = mine ? __ffs(mine) - 1 : 0;
    const float at = __shfl_sync(0xffffffffu, s, 16 * half + first);
    if (j == 0) {
      const int idx = t0 == kNone ? 0 : t0 + first;
      const float val = mine ? at : v;
      if (half == 0) {
        vmax[dir] = val;
        imax[dir] = idx;
      } else {
        vmin[dir] = val;
        imin[dir] = idx;
      }
    }
  }
}
