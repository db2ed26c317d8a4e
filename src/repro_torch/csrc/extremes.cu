// Directional extremes: per direction, (max, argmax, min, argmin) of
// dirs @ Pᵀ over the valid rows of P, first occurrence on ties.
//
// Replaces: src/repro/kernels/extremes/kernel.py:extremes_kernel (the TPU
// kernel folds each row block's MXU score tile into running extremes held
// in revisited VMEM blocks, in grid order).
//
// Bound on the H100: f32 FMA work, m·rows·d multiply-adds (2·1,614·32,768·7
// ≈ 0.74 GFLOP at k = 2000, ≈ 11 µs at 67 TFLOP/s); P itself is under 1 MB.
// Design (common.cuh, block_extremes): rows are cut into blocks of rb rows
// (blockIdx.x), sized by the wrapper so the grid is about two CTAs per SM,
// and directions into CTA rows of warps·128 (blockIdx.y). A CTA stages its
// block padded to 8 floats a row (two 16-byte broadcast loads), each thread
// holds 4 directions in registers, so a staged row feeds 28 FMAs, and the
// inner loop keeps only fmaxf/fminf over 16-row tiles. A second launch
// folds the per-block partials by (value, lowest row), 32 directions a CTA
// reading them coalesced, and rescans each direction's one winning tile, a
// row a lane, for the first row that attains the extreme. The scores keep
// the FMA chain of common.cuh:dir_score, so values and indices are
// bit-identical to the plain version's. (A rescan in the score CTAs, each
// lane on its own tile, cost as much as the main loop: its shared-memory
// reads conflict.) Rows at or past n_valid are never scored, which is what
// scoring them ∓inf does.
//
// The wide body (d > REPRO_MAX_DP, any d): the template body holds a row
// and 4 directions of DP coordinates in registers, which no runtime d
// allows. Here a CTA of kExtWideWarps warps takes kExtWideDirs directions
// (4 a lane) and steps over its block kExtWideRows rows at a time, warp w on
// rows 16w..16w+15 of the step; each thread carries the partial scores of
// its 4 directions × 16 rows in registers while the coordinates stream
// through shared memory in slices of kExtWideK (the rows as broadcast
// float4s, the directions' slice padded to kExtWideK + 4 floats a direction
// so a warp's float4 reads are conflict-free). The FMA chain is
// dir_score's, in coordinate order: the carry starts at −0, which makes the
// first fmaf the plain product d₀p₀ to the bit, and the slice tail pads
// the rows with −0 and the directions with +0, whose product −0 leaves any
// carry's bits as they are. Each warp keeps, over its rows in ascending
// order, the first row attaining each extreme, and writes that exact row as
// its partial; the fold launch is the template body's, at runtime width
// (its rescan then stops at the partial's own row). Bound at d = 70,
// 16,384 rows, 1,614 directions: 2·16,384·1,614·70 ≈ 3.7 GFLOP, 55 µs at
// 67 TFLOP/s.
#include "common.cuh"

// The wide body's launch units; kernels/_lib.py:CUDA_CONSTANTS mirrors them
// for the wrapper's plan (extremes/ops.py:wide_launch_plan).
constexpr int kExtWideWarps = 8;    // warps of a wide score CTA
constexpr int kExtWideRows = 128;   // rows a step: a 16-row tile a warp
constexpr int kExtWideDirs = 128;   // directions a CTA: kExtR a lane
constexpr int kExtWideK = 32;       // coordinates a shared-memory slice
static_assert(kExtWideRows == kExtWideWarps * kExtTile, "a 16-row tile a warp a step");
static_assert(kExtWideDirs == 32 * kExtR, "kExtR directions a lane");
static_assert(kExtWideK % 4 == 0, "slices of whole float4s");

namespace {

template <int DP>
__global__ void __launch_bounds__(kExtMaxWarps * 32, kExtCtasPerSm) extremes_score_kernel(
    const float* __restrict__ P, int rows, int n_valid, int rb, const float* __restrict__ dirs,
    int m, int warps, float* __restrict__ pvmax, int* __restrict__ pimax,
    float* __restrict__ pvmin, int* __restrict__ pimin) {
  extern __shared__ __align__(16) float tile[];
  const int base = blockIdx.x * rb, cnt = min(rb, rows - base);
  stage_rows<DP>(P, base, cnt, tile);
  __syncthreads();
  score_block<DP>(tile, base, cnt, n_valid, dirs, m, warps, blockIdx.x,
                  blockIdx.y * warps * kExtWarpDirs, pvmax, pimax, pvmin, pimin);
}

template <int DP>
__global__ void __launch_bounds__(kExtFoldWarps * 32) extremes_fold_kernel(
    const float* __restrict__ pvmax, const int* __restrict__ pimax,
    const float* __restrict__ pvmin, const int* __restrict__ pimin, int nblk, int m,
    const float* __restrict__ P, int rows, const float* __restrict__ dirs,
    float* __restrict__ vmax, int* __restrict__ imax, float* __restrict__ vmin,
    int* __restrict__ imin, int dp) {
  __shared__ float red[4 * kExtFoldWarps * 32];
  extremes_fold_cta<DP>(pvmax, pimax, pvmin, pimin, nblk, m, blockIdx.x * kExtFoldDirs, P, rows,
                        dirs, red, vmax, imax, vmin, imin, dp);
}

// The wide body: block blockIdx.x of rb rows (a multiple of kExtWideRows),
// directions blockIdx.y·kExtWideDirs + k·32 + lane; warp w's partials at
// [(blockIdx.x·kExtWideWarps + w)·m + dir].
__global__ void __launch_bounds__(kExtWideWarps * 32, 2) extremes_wide_kernel(
    const float* __restrict__ P, int rows, int d, int n_valid, int rb,
    const float* __restrict__ dirs, int m, float* __restrict__ pvmax, int* __restrict__ pimax,
    float* __restrict__ pvmin, int* __restrict__ pimin) {
  constexpr int kDirStride = kExtWideK + 4;
  __shared__ __align__(16) float srow[kExtWideRows * kExtWideK];
  __shared__ __align__(16) float sdir[kExtWideDirs * kDirStride];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int base = blockIdx.x * rb;
  const int nv = max(0, min(min(rb, rows - base), n_valid - base));
  const int dir0 = blockIdx.y * kExtWideDirs;
  float vmax[kExtR], vmin[kExtR];
  int imax[kExtR], imin[kExtR];
#pragma unroll
  for (int k = 0; k < kExtR; ++k) {
    vmax[k] = -CUDART_INF_F;
    vmin[k] = CUDART_INF_F;
    imax[k] = imin[k] = base;
  }
  for (int t0 = 0; t0 < nv; t0 += kExtWideRows) {  // the same trip count in every warp
    float acc[kExtR][kExtTile];
#pragma unroll
    for (int k = 0; k < kExtR; ++k)
#pragma unroll
      for (int r = 0; r < kExtTile; ++r) acc[k][r] = -0.f;
    for (int k0 = 0; k0 < d; k0 += kExtWideK) {
      __syncthreads();  // the previous slice is read
      for (int i = threadIdx.x; i < kExtWideRows * kExtWideK; i += blockDim.x) {
        const int r = i / kExtWideK, c = k0 + i % kExtWideK;
        srow[i] = t0 + r < nv && c < d ? P[(long long)(base + t0 + r) * d + c] : -0.f;
      }
      for (int i = threadIdx.x; i < kExtWideDirs * kExtWideK; i += blockDim.x) {
        const int j = i / kExtWideK, q = i % kExtWideK, c = k0 + q;
        sdir[j * kDirStride + q] = c < d ? dirs[(long long)min(dir0 + j, m - 1) * d + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int q = 0; q < kExtWideK; q += 4) {
        float4 dv[kExtR];
#pragma unroll
        for (int k = 0; k < kExtR; ++k)
          dv[k] = *reinterpret_cast<const float4*>(sdir + (k * 32 + lane) * kDirStride + q);
#pragma unroll
        for (int r = 0; r < kExtTile; ++r) {
          const float4 p =
              *reinterpret_cast<const float4*>(srow + (warp * kExtTile + r) * kExtWideK + q);
#pragma unroll
          for (int k = 0; k < kExtR; ++k) {
            float s = acc[k][r];
            s = fmaf(dv[k].x, p.x, s);
            s = fmaf(dv[k].y, p.y, s);
            s = fmaf(dv[k].z, p.z, s);
            s = fmaf(dv[k].w, p.w, s);
            acc[k][r] = s;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kExtTile; ++r) {
      const int row = t0 + warp * kExtTile + r;
      if (row < nv) {
#pragma unroll
        for (int k = 0; k < kExtR; ++k) {
          if (acc[k][r] > vmax[k]) {
            vmax[k] = acc[k][r];
            imax[k] = base + row;
          }
          if (acc[k][r] < vmin[k]) {
            vmin[k] = acc[k][r];
            imin[k] = base + row;
          }
        }
      }
    }
  }
  const long long blk = (long long)blockIdx.x * kExtWideWarps + warp;
#pragma unroll
  for (int k = 0; k < kExtR; ++k) {
    const int dir = dir0 + k * 32 + lane;
    if (dir < m) {
      const long long o = blk * m + dir;
      pvmax[o] = vmax[k];
      pimax[o] = imax[k];
      pvmin[o] = vmin[k];
      pimin[o] = imin[k];
    }
  }
}

}  // namespace

// P (rows, dp) f32, dirs (m, dp) f32, n_valid ≤ rows → vmax, vmin (m,) f32
// and imax, imin (m,) i32 row ids into P, in two launches: the score CTAs,
// then the fold. The plan comes from the wrapper (extremes/ops.py).
// dp ≤ REPRO_MAX_DP (the template body): rb rows a block (a multiple of
// kExtTile, ≤ kExtMaxBlockRows) and `warps` warps of kExtWarpDirs directions
// a CTA (1–kExtMaxWarps), launch_plan; nblk = ceil(rows/rb) partials.
// dp > REPRO_MAX_DP (the wide body): rb a multiple of kExtWideRows, `warps`
// unused, wide_launch_plan; nblk = ceil(rows/rb)·kExtWideWarps partials.
// Scratch: fscratch (2·nblk·m f32) and iscratch (2·nblk·m i32).
REPRO_EXPORT int repro_extremes(const void* P, int rows, int dp, int n_valid, const void* dirs,
                                int m, int rb, int warps, void* fscratch, void* iscratch,
                                void* vmax, void* imax, void* vmin, void* imin, void* stream) {
  const bool wide = dp > REPRO_MAX_DP;
  if (rows < 0 || m <= 0 || dp <= 0 || rb <= 0 ||
      (wide ? rb % kExtWideRows != 0
            : (rb > kExtMaxBlockRows || rb % kExtTile != 0 || warps < 1 || warps > kExtMaxWarps)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nrb = (rows + rb - 1) / rb;
  const int nblk = wide ? nrb * kExtWideWarps : nrb;
  float* pvmax = (float*)fscratch;
  float* pvmin = pvmax + (long long)nblk * m;
  int* pimax = (int*)iscratch;
  int* pimin = pimax + (long long)nblk * m;
  const dim3 fold_grid((m + kExtFoldDirs - 1) / kExtFoldDirs);
  if (wide) {
    if (nrb > 0) {
      const dim3 grid(nrb, (m + kExtWideDirs - 1) / kExtWideDirs);
      extremes_wide_kernel<<<grid, kExtWideWarps * 32, 0, st>>>(
          (const float*)P, rows, dp, n_valid, rb, (const float*)dirs, m, pvmax, pimax, pvmin,
          pimin);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    extremes_fold_kernel<0><<<fold_grid, kExtFoldWarps * 32, 0, st>>>(
        pvmax, pimax, pvmin, pimin, nblk, m, (const float*)P, rows, (const float*)dirs,
        (float*)vmax, (int*)imax, (float*)vmin, (int*)imin, dp);
    return (int)cudaGetLastError();
  }
  if (nblk > 0) {
    const dim3 grid(nblk, ext_row_warps(m, warps));
    const int threads = max(128, warps * 32);  // ≤ 416
    const size_t smem = sizeof(float) * rb * pad4(dp);
    REPRO_DISPATCH_DP(dp, extremes_score_kernel<DP><<<grid, threads, smem, st>>>(
        (const float*)P, rows, n_valid, rb, (const float*)dirs, m, warps, pvmax, pimax, pvmin,
        pimin));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  REPRO_DISPATCH_DP(dp, extremes_fold_kernel<DP><<<fold_grid, kExtFoldWarps * 32, 0, st>>>(
      pvmax, pimax, pvmin, pimin, nblk, m, (const float*)P, rows, (const float*)dirs,
      (float*)vmax, (int*)imax, (float*)vmin, (int*)imin, dp));
  return (int)cudaGetLastError();
}
