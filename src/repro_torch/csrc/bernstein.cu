// Fused Bernstein featurize: scaler transform, clip, basis and scaled
// derivative of every (point, j) value in one pass.
//
// Replaces: src/repro/kernels/bernstein/kernel.py:bernstein_kernel (the TPU
// kernel builds the powers of t in registers from one read of t and writes
// (d, rows, 128) tiles). Here the kernel also does what the JAX package's
// featurize (mctm.basis_features) does around it: t = (y - low)/(high - low)
// clipped to [0, 1], and the derivative scaled by inv_span[j]. It writes
// A and A' as (c, J, d) row-major, the layout basis_features returns, so no
// transpose follows.
//
// Bound on the H100: bytes. Per (point, j) it reads 4 B and writes 2·d·4 B
// (56 B at d = 7); the arithmetic is ~4·d flops. Design: one thread per
// (point, j) value, the degree a template parameter so the power ladders
// t^k, (1-t)^k stay in registers, and 2·d consecutive stores per thread so
// a warp writes contiguous runs of memory.
#include "common.cuh"

namespace {

constexpr int kMaxDegree = REPRO_MAX_DP - 1;
constexpr int kThreads = 256;

struct Coeffs {
  float c[kMaxDegree + 1];   // C(M, k), k = 0..M
  float lo[kMaxDegree + 1];  // C(M-1, k), k = 0..M-1
};

template <int M>
__global__ void bernstein_featurize_kernel(const float* __restrict__ Y,
                                           long long nvals, int J,
                                           const float* __restrict__ bounds,
                                           Coeffs cf, float* __restrict__ A,
                                           float* __restrict__ Ap) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= nvals) return;
  const int j = (int)(v % J);
  // bounds rows: low (J), high (J), inv_span (J), all f32
  const float low = bounds[j], high = bounds[J + j], isp = bounds[2 * J + j];
  float t = (Y[v] - low) / (high - low);
  t = fminf(fmaxf(t, 0.f), 1.f);
  const float u = 1.f - t;
  float tp[M + 1], up[M + 1];
  tp[0] = 1.f;
  up[0] = 1.f;
#pragma unroll
  for (int k = 1; k <= M; ++k) {
    tp[k] = tp[k - 1] * t;
    up[k] = up[k - 1] * u;
  }
  float* a = A + v * (M + 1);
  float* ap = Ap + v * (M + 1);
#pragma unroll
  for (int k = 0; k <= M; ++k) a[k] = (cf.c[k] * tp[k]) * up[M - k];
  if (M == 0) {
    ap[0] = 0.f;
    return;
  }
  // d b_{k,M}/dt = M (b_{k-1,M-1} - b_{k,M-1}), then d/dy = d/dt · inv_span
  float lower[M > 0 ? M : 1];
#pragma unroll
  for (int k = 0; k < M; ++k) lower[k] = (cf.lo[k] * tp[k]) * up[M - 1 - k];
#pragma unroll
  for (int k = 0; k <= M; ++k) {
    const float left = k >= 1 ? lower[k - 1] : 0.f;
    const float right = k <= M - 1 ? lower[k] : 0.f;
    ap[k] = ((float)M * (left - right)) * isp;
  }
}

void binomials(int M, float* out) {
  double c = 1.0;
  out[0] = 1.f;
  for (int k = 1; k <= M; ++k) {
    c = c * (M - k + 1) / k;
    out[k] = (float)c;
  }
}

}  // namespace

#define REPRO_BERN_CASE(N)                                                  \
  case N:                                                                   \
    bernstein_featurize_kernel<N><<<grid, kThreads, 0, st>>>(               \
        (const float*)Y, nvals, J, (const float*)bounds, cf, (float*)A,     \
        (float*)Ap);                                                        \
    break;

// Y (n_points, J) f32, bounds (3, J) f32 = [low; high; inv_span] → A, Ap
// each (n_points, J, degree+1) f32.
REPRO_EXPORT int repro_bernstein_featurize(const void* Y, long long n_points,
                                           int J, int degree,
                                           const void* bounds, void* A,
                                           void* Ap, void* stream) {
  if (degree < 0 || degree > kMaxDegree || J <= 0 || n_points < 0)
    return (int)cudaErrorInvalidValue;
  const long long nvals = n_points * J;
  if (nvals == 0) return (int)cudaSuccess;
  Coeffs cf = {};
  binomials(degree, cf.c);
  if (degree > 0) binomials(degree - 1, cf.lo);
  const unsigned grid = (unsigned)((nvals + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  switch (degree) {
    REPRO_BERN_CASE(0) REPRO_BERN_CASE(1) REPRO_BERN_CASE(2)
    REPRO_BERN_CASE(3) REPRO_BERN_CASE(4) REPRO_BERN_CASE(5)
    REPRO_BERN_CASE(6) REPRO_BERN_CASE(7) REPRO_BERN_CASE(8)
    REPRO_BERN_CASE(9) REPRO_BERN_CASE(10) REPRO_BERN_CASE(11)
    REPRO_BERN_CASE(12) REPRO_BERN_CASE(13) REPRO_BERN_CASE(14)
    REPRO_BERN_CASE(15)
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
