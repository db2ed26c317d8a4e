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
#include "common.cuh"

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
    int* __restrict__ imin) {
  __shared__ float red[4 * kExtFoldWarps * 32];
  extremes_fold_cta<DP>(pvmax, pimax, pvmin, pimin, nblk, m, blockIdx.x * kExtFoldDirs, P, rows,
                        dirs, red, vmax, imax, vmin, imin);
}

}  // namespace

// P (rows, dp) f32, dirs (m, dp) f32, n_valid ≤ rows; rb rows a block (a
// multiple of kExtTile, ≤ kExtMaxBlockRows) and `warps` warps of
// kExtWarpDirs directions a CTA (1–kExtMaxWarps), from the wrapper
// (extremes/ops.py:launch_plan);
// scratch fscratch (2·nblk·m f32) and iscratch (2·nblk·m i32) with
// nblk = ceil(rows/rb) → vmax, vmin (m,) f32 and imax, imin (m,) i32 row ids
// into P. Two launches: the score CTAs, then the fold.
REPRO_EXPORT int repro_extremes(const void* P, int rows, int dp, int n_valid, const void* dirs,
                                int m, int rb, int warps, void* fscratch, void* iscratch,
                                void* vmax, void* imax, void* vmin, void* imin, void* stream) {
  if (rows < 0 || m <= 0 || dp <= 0 || dp > REPRO_MAX_DP || rb <= 0 || rb > kExtMaxBlockRows ||
      rb % kExtTile != 0 || warps < 1 || warps > kExtMaxWarps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nblk = (rows + rb - 1) / rb;
  float* pvmax = (float*)fscratch;
  float* pvmin = pvmax + (long long)nblk * m;
  int* pimax = (int*)iscratch;
  int* pimin = pimax + (long long)nblk * m;
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
  REPRO_DISPATCH_DP(dp, extremes_fold_kernel<DP><<<(m + kExtFoldDirs - 1) / kExtFoldDirs,
                                                     kExtFoldWarps * 32, 0, st>>>(
      pvmax, pimax, pvmin, pimin, nblk, m, (const float*)P, rows, (const float*)dirs,
      (float*)vmax, (int*)imax, (float*)vmin, (int*)imin));
  return (int)cudaGetLastError();
}
