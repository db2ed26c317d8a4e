// Gram matrix G = (√w·X)ᵀ(√w·X) of one chunk of basis rows.
//
// Replaces: src/repro/kernels/gram/kernel.py:gram_kernel (the TPU kernel
// revisits one (D, D) VMEM block across a sequential grid of row blocks).
// On the H100 the CTAs run in no order, so each CTA accumulates the Gram of
// its own rows and writes it to scratch; a second kernel sums the partials
// in ascending CTA order and mirrors the triangle. No atomics: the sum is
// taken in the same order on every run.
//
// Bound on the H100: bytes, and at the main path's shapes launch latency.
// A chunk is 16,384 × 14 f32 = 0.9 MB (≈0.3 µs at 3.35 TB/s) and 2·D² flops
// per row (≈6.4 MFLOP). Design: rows staged through shared memory in tiles,
// one thread per upper-triangle entry (D(D+1)/2 = 105 at D = 14) summing
// its products with a compensated f32 sum, √w applied while staging.
#include "common.cuh"

namespace {

constexpr int kRowsPerCta = 256;
constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kMaxD = 64;
constexpr int kMaxEntries = (kMaxD * (kMaxD + 1) / 2 + kThreads - 1) / kThreads;

__device__ __forceinline__ void tri_index(int e, int D, int& a, int& b) {
  a = 0;
  while (e >= D - a) {
    e -= D - a;
    ++a;
  }
  b = a + e;
}

__global__ void gram_partial_kernel(const float* __restrict__ X,
                                    const float* __restrict__ sw, int n, int D,
                                    float* __restrict__ partial) {
  __shared__ float tile[kTile * kMaxD];
  const int ntri = D * (D + 1) / 2;
  const int row0 = blockIdx.x * kRowsPerCta;
  const int row_end = min(row0 + kRowsPerCta, n);
  int ea[kMaxEntries], eb[kMaxEntries];
  KahanSum acc[kMaxEntries];
#pragma unroll
  for (int q = 0; q < kMaxEntries; ++q) {
    const int e = threadIdx.x + q * kThreads;
    ea[q] = eb[q] = 0;
    if (e < ntri) tri_index(e, D, ea[q], eb[q]);
  }
  for (int r0 = row0; r0 < row_end; r0 += kTile) {
    const int cnt = min(kTile, row_end - r0);
    for (int i = threadIdx.x; i < cnt * D; i += kThreads) {
      const int r = i / D;
      const float x = X[(long long)(r0 + r) * D + (i - r * D)];
      tile[i] = sw != nullptr ? x * sw[r0 + r] : x;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kMaxEntries; ++q) {
      if (threadIdx.x + q * kThreads < ntri) {
        for (int r = 0; r < cnt; ++r)
          acc[q].add(tile[r * D + ea[q]] * tile[r * D + eb[q]]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kMaxEntries; ++q) {
    const int e = threadIdx.x + q * kThreads;
    if (e < ntri) partial[(long long)blockIdx.x * ntri + e] = acc[q].s;
  }
}

__global__ void gram_combine_kernel(const float* __restrict__ partial,
                                    int nblk, int D, float* __restrict__ G) {
  const int ntri = D * (D + 1) / 2;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= ntri) return;
  KahanSum s;
  for (int b = 0; b < nblk; ++b) s.add(partial[(long long)b * ntri + e]);
  int a, c;
  tri_index(e, D, a, c);
  G[a * D + c] = s.s;
  G[c * D + a] = s.s;
}

}  // namespace

// X (n, D) f32, sw (n,) f32 or null (all ones); partial scratch of
// max(1, ceil(n/256)) · D(D+1)/2 f32 → G (D, D) f32.
REPRO_EXPORT int repro_gram(const void* X, const void* sw, int n, int D,
                            void* partial, void* G, void* stream) {
  if (D <= 0 || D > kMaxD || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nblk = (n + kRowsPerCta - 1) / kRowsPerCta;
  if (nblk > 0) {
    gram_partial_kernel<<<nblk, kThreads, 0, st>>>(
        (const float*)X, (const float*)sw, n, D, (float*)partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int ntri = D * (D + 1) / 2;
  gram_combine_kernel<<<(ntri + 127) / 128, 128, 0, st>>>(
      (const float*)partial, nblk, D, (float*)G);
  return (int)cudaGetLastError();
}
