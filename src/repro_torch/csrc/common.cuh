// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel is exported through a plain C function that launches on the
// caller's stream, allocates nothing (the Python wrapper hands in outputs
// and scratch) and returns the cudaError_t of the launch, which the wrapper
// checks. Reductions across CTAs never use atomics: each CTA writes its
// partial to scratch and a second small kernel combines the partials in
// ascending CTA order, so every sum is taken in the same order on every run.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

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

// dirs·p as an FMA chain in feature order: s = d0·p0, s = fma(dk, pk, s).
// This is the rounding the JAX package's CPU dot and the plain version
// (ref.py) reproduce, so argmax indices agree exactly, first occurrence on
// exact ties included.
template <int DP>
__device__ __forceinline__ float dir_score(const float (&dv)[DP],
                                           const float* __restrict__ p) {
  float s = dv[0] * p[0];
#pragma unroll
  for (int k = 1; k < DP; ++k) s = fmaf(dv[k], p[k], s);
  return s;
}

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

// Fold per-CTA directional-extreme partials in ascending CTA order. Strict
// comparisons keep the earlier CTA (lower rows) on equal values: the
// first-occurrence rule of a dense argmax over all rows.
static __global__ void extremes_fold_kernel(
    const float* __restrict__ pvmax, const int* __restrict__ pimax,
    const float* __restrict__ pvmin, const int* __restrict__ pimin, int nblk,
    int m, float* __restrict__ vmax, int* __restrict__ imax,
    float* __restrict__ vmin, int* __restrict__ imin) {
  const int dir = blockIdx.x * blockDim.x + threadIdx.x;
  if (dir >= m) return;
  float bmax = -CUDART_INF_F, bmin = CUDART_INF_F;
  int jmax = 0, jmin = 0;
  for (int b = 0; b < nblk; ++b) {
    const long long o = (long long)b * m + dir;
    const float vx = pvmax[o];
    if (vx > bmax) {
      bmax = vx;
      jmax = pimax[o];
    }
    const float vn = pvmin[o];
    if (vn < bmin) {
      bmin = vn;
      jmin = pimin[o];
    }
  }
  vmax[dir] = bmax;
  imax[dir] = jmax;
  vmin[dir] = bmin;
  imin[dir] = jmin;
}

// One direction's extremes over the first nv rows of a P tile staged in
// shared memory (rows of DP floats); row ids are reported as base + i. With
// no valid row the partial stays (-inf, base, +inf, base), which the strict
// fold never picks over a real score.
template <int DP>
__device__ __forceinline__ void tile_extremes(const float* __restrict__ tile,
                                              int nv, int base,
                                              const float* __restrict__ dir,
                                              float& vmax, int& imax,
                                              float& vmin, int& imin) {
  float dv[DP];
#pragma unroll
  for (int k = 0; k < DP; ++k) dv[k] = dir[k];
  vmax = -CUDART_INF_F;
  vmin = CUDART_INF_F;
  imax = base;
  imin = base;
  for (int i = 0; i < nv; ++i) {
    const float s = dir_score<DP>(dv, tile + i * DP);
    if (s > vmax) {
      vmax = s;
      imax = base + i;
    }
    if (s < vmin) {
      vmin = s;
      imin = base + i;
    }
  }
}
