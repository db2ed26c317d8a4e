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
// t^k, (1-t)^k stay in registers. The stores are 93% of the bytes, and a
// thread's d floats of A lie d·4 B from its neighbour's, so each thread
// writes its values into the CTA's tile of A and of A' in shared memory
// (256 values: 256·d floats each, contiguous in global memory and 16-byte
// aligned) and the CTA writes both tiles back as 16-byte stores, neighbouring
// threads on neighbouring addresses. A grid sized to the SMs' resident CTAs
// walks the tiles; two tile buffers let one tile's stores drain while the
// next tile's values are computed, with one barrier per tile. The staging
// changes no arithmetic: each value is computed expression for expression
// as when every thread stored its own, so A and A' keep those bits.
#include "common.cuh"

namespace {

constexpr int kMaxDegree = REPRO_MAX_DP - 1;
constexpr int kThreads = 256;  // values per tile

struct Coeffs {
  float c[kMaxDegree + 1];   // C(M, k), k = 0..M
  float lo[kMaxDegree + 1];  // C(M-1, k), k = 0..M-1
};

// Dynamic shared memory: two stages × (A tile, A' tile) of kThreads·(M+1) floats.
constexpr size_t smem_bytes(int M) { return 4 * (size_t)kThreads * (M + 1) * sizeof(float); }

template <int M>
__global__ void __launch_bounds__(kThreads)
    bernstein_featurize_kernel(const float* __restrict__ Y, long long nvals, int J,
                               const float* __restrict__ bounds, Coeffs cf,
                               float* __restrict__ A, float* __restrict__ Ap,
                               long long ntiles) {
  constexpr int W = M + 1;             // floats of A (and of A') per value
  constexpr int kTile = kThreads * W;  // floats of one array per tile
  extern __shared__ float4 smem4[];
  float* const buf = reinterpret_cast<float*>(smem4);
  int stage = 0;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, stage ^= 1) {
    float* const sa = buf + stage * 2 * kTile;
    float* const sap = sa + kTile;
    const long long v0 = tile * kThreads;
    const long long v = v0 + threadIdx.x;
    if (v < nvals) {
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
      float* a = sa + threadIdx.x * W;
      float* ap = sap + threadIdx.x * W;
#pragma unroll
      for (int k = 0; k <= M; ++k) a[k] = (cf.c[k] * tp[k]) * up[M - k];
      if (M == 0) {
        ap[0] = 0.f;
      } else {
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
    }
    // The stage written two tiles ago was read before this barrier, so one
    // barrier per tile orders both buffers.
    __syncthreads();
    const int nf = (int)min((long long)kThreads, nvals - v0) * W;  // floats of this tile
    const int n4 = nf >> 2;
    float4* ga = reinterpret_cast<float4*>(A + v0 * W);
    float4* gap = reinterpret_cast<float4*>(Ap + v0 * W);
    for (int q = threadIdx.x; q < n4; q += kThreads) {
      ga[q] = reinterpret_cast<const float4*>(sa)[q];
      gap[q] = reinterpret_cast<const float4*>(sap)[q];
    }
    for (int q = 4 * n4 + threadIdx.x; q < nf; q += kThreads) {  // the ragged tile's tail
      A[v0 * W + q] = sa[q];
      Ap[v0 * W + q] = sap[q];
    }
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

// CTAs of one instantiation resident on all SMs of the current device
// (queried once per degree and device): the grid of the tile walk.
template <int M>
int resident_ctas(int& out) {
  static int cached[16] = {};  // by device ordinal
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int& c = cached[dev & 15];
  if (c == 0) {
    const size_t bytes = smem_bytes(M);
    if (bytes > 48 * 1024) {
      err = cudaFuncSetAttribute(bernstein_featurize_kernel<M>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bernstein_featurize_kernel<M>,
                                                        kThreads, bytes);
    if (err != cudaSuccess) return (int)err;
    c = sms * (per_sm > 0 ? per_sm : 1);
  }
  out = c;
  return 0;
}

template <int M>
int launch(const void* Y, long long nvals, int J, const void* bounds, const Coeffs& cf, void* A,
           void* Ap, cudaStream_t st) {
  int ctas = 0;
  const int err = resident_ctas<M>(ctas);
  if (err != 0) return err;
  const long long ntiles = (nvals + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(ntiles < ctas ? ntiles : ctas);
  bernstein_featurize_kernel<M><<<grid, kThreads, smem_bytes(M), st>>>(
      (const float*)Y, nvals, J, (const float*)bounds, cf, (float*)A, (float*)Ap, ntiles);
  return (int)cudaGetLastError();
}

}  // namespace

#define REPRO_BERN_CASE(N) \
  case N:                  \
    return launch<N>(Y, nvals, J, bounds, cf, A, Ap, st);

// Y (n_points, J) f32, bounds (3, J) f32 = [low; high; inv_span] → A, Ap
// each (n_points, J, degree+1) f32, 16-byte aligned.
REPRO_EXPORT int repro_bernstein_featurize(const void* Y, long long n_points,
                                           int J, int degree,
                                           const void* bounds, void* A,
                                           void* Ap, void* stream) {
  if (degree < 0 || degree > kMaxDegree || J <= 0 || n_points < 0 ||
      (reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(Ap)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long nvals = n_points * J;
  if (nvals == 0) return (int)cudaSuccess;
  Coeffs cf = {};
  binomials(degree, cf.c);
  if (degree > 0) binomials(degree - 1, cf.lo);
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
}
