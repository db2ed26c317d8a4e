// Directional extremes: per direction, (max, argmax, min, argmin) of
// dirs @ Pᵀ over the valid rows of P, first occurrence on ties.
//
// Replaces: src/repro/kernels/extremes/kernel.py:extremes_kernel (the TPU
// kernel folds each row block's MXU score tile into running extremes held
// in revisited VMEM blocks, in grid order). On the H100, rows are cut into
// CTA-sized ranges (blockIdx.x) and directions into tiles of 128
// (blockIdx.y). Each CTA writes per-direction partials for its row range;
// a second kernel folds them in ascending row-range order with strict
// comparisons, which is the first-occurrence rule across CTAs. Rows at or
// past n_valid are never scored, which is what scoring them ∓inf does.
//
// Bound on the H100: f32 FMA work, m·rows·d multiply-adds (2·1,614·32,768·7
// ≈ 0.74 GFLOP at k = 2000, ≈11 µs at 67 TFLOP/s) — P itself is under
// 1 MB. Design: the CTA's P rows are staged once in shared memory and read
// as broadcasts (every thread of a warp reads the same row), each thread
// keeps its direction in registers and runs the FMA chain of
// common.cuh:dir_score over the rows in ascending order, so the scores are
// bit-identical to the plain version's.
#include "common.cuh"

namespace {

constexpr int kRowsPerCta = 512;
constexpr int kDirsPerCta = 128;

template <int DP>
__global__ void extremes_partial_kernel(const float* __restrict__ P, int rows,
                                        int n_valid,
                                        const float* __restrict__ dirs, int m,
                                        float* __restrict__ pvmax,
                                        int* __restrict__ pimax,
                                        float* __restrict__ pvmin,
                                        int* __restrict__ pimin) {
  __shared__ float tile[kRowsPerCta * DP];
  const int base = blockIdx.x * kRowsPerCta;
  const int cnt = min(kRowsPerCta, rows - base);
  for (int i = threadIdx.x; i < cnt * DP; i += blockDim.x)
    tile[i] = P[(long long)base * DP + i];
  __syncthreads();
  const int dir = blockIdx.y * kDirsPerCta + threadIdx.x;
  if (dir >= m) return;
  const int nv = max(0, min(cnt, n_valid - base));
  float vmax, vmin;
  int imax, imin;
  tile_extremes<DP>(tile, nv, base, dirs + (long long)dir * DP, vmax, imax,
                    vmin, imin);
  const long long o = (long long)blockIdx.x * m + dir;
  pvmax[o] = vmax;
  pimax[o] = imax;
  pvmin[o] = vmin;
  pimin[o] = imin;
}

}  // namespace

// P (rows, dp) f32, dirs (m, dp) f32, n_valid ≤ rows; scratch fscratch
// (2·nblk·m f32) and iscratch (2·nblk·m i32) with nblk = ceil(rows/512)
// → vmax, vmin (m,) f32 and imax, imin (m,) i32 row ids into P.
REPRO_EXPORT int repro_extremes(const void* P, int rows, int dp, int n_valid,
                                const void* dirs, int m, void* fscratch,
                                void* iscratch, void* vmax, void* imax,
                                void* vmin, void* imin, void* stream) {
  if (rows < 0 || m <= 0 || dp <= 0 || dp > REPRO_MAX_DP)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nblk = (rows + kRowsPerCta - 1) / kRowsPerCta;
  float* pvmax = (float*)fscratch;
  float* pvmin = pvmax + (long long)nblk * m;
  int* pimax = (int*)iscratch;
  int* pimin = pimax + (long long)nblk * m;
  if (nblk > 0) {
    const dim3 grid(nblk, (m + kDirsPerCta - 1) / kDirsPerCta);
    REPRO_DISPATCH_DP(dp, extremes_partial_kernel<DP><<<grid, kDirsPerCta, 0, st>>>(
        (const float*)P, rows, n_valid, (const float*)dirs, m, pvmax, pimax,
        pvmin, pimin));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  extremes_fold_kernel<<<(m + 127) / 128, 128, 0, st>>>(
      pvmax, pimax, pvmin, pimin, nblk, m, (float*)vmax, (int*)imax,
      (float*)vmin, (int*)imin);
  return (int)cudaGetLastError();
}
