// Fused one-pass sweep step over one chunk of basis rows X and derivative
// rows P: the CountSketch delta dSX = S·(√w·X), the emitted rows
// z = (√w·X)Ω (or √w·X), the moment deltas (Σp, Σppᵀ) and the chunk-local
// directional extremes of dirs @ Pᵀ, from one residency of each row block.
//
// Replaces: src/repro/kernels/sweep/kernel.py:sweep_kernel (the TPU kernel
// walks row blocks in grid order, realizes the sketch as a one-hot MXU
// product and keeps every accumulator in revisited VMEM blocks). The
// contract is kept: the step emits block-local deltas (dSX, moment deltas,
// chunk-local extremes) and the Python wrapper folds them into the carried
// state; it is f32 only; validity is a count of valid points, scaled by
// the r P rows of each point.
//
// Bound on the H100: f32 FMA work of the extremes (m·c·r·d multiply-adds,
// ≈0.74 GFLOP per 16,384-point chunk at m = 1,614), then bytes (X, P, z:
// a few MB per chunk). Design: one CTA per 128 points stages √w·X, P, the
// sketch rows and signs in shared memory. The sketch is deterministic
// without atomics: the CTA keeps a private (sketch, D) partial in shared
// memory (784 × 14 f32 = 44 KB), thread (o, col) owns column col of the
// buckets s ≡ o (mod 256/D) and adds the CTA's rows in ascending order; a
// second kernel sums the CTA partials in ascending CTA order, as it does
// the moment partials (compensated f32 sums). z is written from the staged
// rows, and the extremes run the FMA chain of common.cuh:dir_score with
// the same two-stage fold as kernels/extremes.
#include "common.cuh"

namespace {

constexpr int kPts = 128;
constexpr int kThreads = 256;
constexpr int kMaxD = 64;
constexpr size_t kMaxSmem = 232448;  // 227 KB: an H100 CTA's opt-in limit

__device__ __forceinline__ void tri_index(int e, int D, int& a, int& b) {
  a = 0;
  while (e >= D - a) {
    e -= D - a;
    ++a;
  }
  b = a + e;
}

template <int DP>
__global__ void sweep_main_kernel(
    const float* __restrict__ X, int c, int D, const float* __restrict__ sw,
    const int* __restrict__ rows, const float* __restrict__ signs,
    const float* __restrict__ P, int r, int n_valid,
    const float* __restrict__ dirs, int m, const float* __restrict__ omega,
    int q, int sk, int want_z, int want_mom, float* __restrict__ psx,
    float* __restrict__ z, float* __restrict__ pmom,
    float* __restrict__ pvmax, int* __restrict__ pimax,
    float* __restrict__ pvmin, int* __restrict__ pimin) {
  extern __shared__ float smem[];
  const int pt0 = blockIdx.x * kPts;
  const int cnt = min(kPts, c - pt0);
  float* xw = smem;                      // kPts · D   √w·X rows
  float* sg = xw + kPts * D;             // kPts       sketch signs
  int* rw = (int*)(sg + kPts);           // kPts       sketch rows
  float* part = (float*)(rw + kPts);     // sk · D     this CTA's dSX
  float* pt = part + (long long)sk * D;  // kPts·r·DP  P rows (if any)

  for (int i = threadIdx.x; i < cnt * D; i += kThreads) {
    const int row = i / D;
    xw[i] = X[(long long)pt0 * D + i] * sw[pt0 + row];
  }
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    sg[i] = signs[pt0 + i];
    rw[i] = rows[pt0 + i];
  }
  if (P != nullptr) {
    for (int i = threadIdx.x; i < cnt * r * DP; i += kThreads)
      pt[i] = P[(long long)pt0 * r * DP + i];
  }
  for (int i = threadIdx.x; i < sk * D; i += kThreads) part[i] = 0.f;
  __syncthreads();

  // CountSketch delta, rows in ascending order into owned bucket entries
  const int n_own = kThreads / D;
  const int own = threadIdx.x / D;
  const int col = threadIdx.x - own * D;
  if (own < n_own) {
    for (int i = 0; i < cnt; ++i) {
      const int s = rw[i];
      if (s >= 0 && s < sk && s % n_own == own)
        part[s * D + col] += sg[i] * xw[i * D + col];
    }
  }

  if (want_z) {
    const int qw = omega != nullptr ? q : D;
    for (int e = threadIdx.x; e < cnt * qw; e += kThreads) {
      const int i = e / qw;
      const int oc = e - i * qw;
      const float* xr = xw + i * D;
      float v;
      if (omega != nullptr) {
        v = xr[0] * omega[oc];
        for (int k = 1; k < D; ++k) v = fmaf(xr[k], omega[k * q + oc], v);
      } else {
        v = xr[oc];
      }
      z[(long long)(pt0 + i) * qw + oc] = v;
    }
  }

  if (want_mom) {
    const int nrow = cnt * r;
    const int nm = DP + DP * (DP + 1) / 2;
    for (int e = threadIdx.x; e < nm; e += kThreads) {
      KahanSum acc;
      if (e < DP) {
        for (int i = 0; i < nrow; ++i) acc.add(pt[i * DP + e]);
      } else {
        int a, b;
        tri_index(e - DP, DP, a, b);
        for (int i = 0; i < nrow; ++i) acc.add(pt[i * DP + a] * pt[i * DP + b]);
      }
      pmom[(long long)blockIdx.x * nm + e] = acc.s;
    }
  }

  if (dirs != nullptr) {
    const int base = pt0 * r;
    const int nv = max(0, min(cnt * r, n_valid * r - base));
    for (int dir = threadIdx.x; dir < m; dir += kThreads) {
      float vmax, vmin;
      int imax, imin;
      tile_extremes<DP>(pt, nv, base, dirs + (long long)dir * DP, vmax, imax,
                        vmin, imin);
      const long long o = (long long)blockIdx.x * m + dir;
      pvmax[o] = vmax;
      pimax[o] = imax;
      pvmin[o] = vmin;
      pimin[o] = imin;
    }
  }

  __syncthreads();
  for (int i = threadIdx.x; i < sk * D; i += kThreads)
    psx[(long long)blockIdx.x * sk * D + i] = part[i];
}

// dSX entries first, then the moment entries (Σp, then the Σppᵀ triangle)
__global__ void sweep_combine_kernel(const float* __restrict__ psx,
                                     const float* __restrict__ pmom, int nblk,
                                     int skD, int dp, float* __restrict__ dsx,
                                     float* __restrict__ ds1,
                                     float* __restrict__ ds2) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int nm = pmom != nullptr ? dp + dp * (dp + 1) / 2 : 0;
  if (e >= skD + nm) return;
  KahanSum s;
  if (e < skD) {
    for (int b = 0; b < nblk; ++b) s.add(psx[(long long)b * skD + e]);
    dsx[e] = s.s;
    return;
  }
  const int k = e - skD;
  for (int b = 0; b < nblk; ++b) s.add(pmom[(long long)b * nm + k]);
  if (k < dp) {
    ds1[k] = s.s;
  } else {
    int a, b;
    tri_index(k - dp, dp, a, b);
    ds2[a * dp + b] = s.s;
    ds2[b * dp + a] = s.s;
  }
}

size_t smem_bytes(int D, int sk, bool has_p, int r, int dp) {
  return sizeof(float) * ((size_t)kPts * D + 2 * (size_t)kPts + (size_t)sk * D +
                          (has_p ? (size_t)kPts * r * dp : 0));
}

template <int DP>
cudaError_t launch_main(int nblk, size_t smem, cudaStream_t st, const float* X,
                        int c, int D, const float* sw, const int* rows,
                        const float* signs, const float* P, int r, int n_valid,
                        const float* dirs, int m, const float* omega, int q,
                        int sk, int want_z, int want_mom, float* psx, float* z,
                        float* pmom, float* pvmax, int* pimax, float* pvmin,
                        int* pimin) {
  cudaError_t err = cudaFuncSetAttribute(
      sweep_main_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  sweep_main_kernel<DP><<<nblk, kThreads, smem, st>>>(
      X, c, D, sw, rows, signs, P, r, n_valid, dirs, m, omega, q, sk, want_z,
      want_mom, psx, z, pmom, pvmax, pimax, pvmin, pimin);
  return cudaGetLastError();
}

}  // namespace

// Shared-memory bytes one CTA needs; the wrapper refuses shapes above the
// H100's 227 KB.
REPRO_EXPORT long long repro_sweep_smem_bytes(int D, int sk, int has_p, int r,
                                              int dp) {
  return (long long)smem_bytes(D, sk, has_p != 0, r, dp);
}

// X (c, D), sw (c,), rows (c,) i32, signs (c,) f32, P (c·r, dp) or null,
// dirs (m, dp) or null, omega (D, q) or null. Outputs: dsx (sk, D); z
// (c, q or D) or null; ds1 (dp,) and ds2 (dp, dp) or null; extremes (m,)
// when dirs is given. Scratch, with nblk = ceil(c/128) and
// nm = dp + dp(dp+1)/2: fscratch nblk·(sk·D + nm + 2m) f32, iscratch
// 2·nblk·m i32.
REPRO_EXPORT int repro_sweep(const void* X, int c, int D, const void* sw,
                             const void* rows, const void* signs,
                             const void* P, int r, int dp, int n_valid,
                             const void* dirs, int m, const void* omega, int q,
                             int sk, void* fscratch, void* iscratch, void* dsx,
                             void* z, void* ds1, void* ds2, void* vmax,
                             void* imax, void* vmin, void* imin,
                             void* stream) {
  const bool has_p = P != nullptr;
  const bool want_mom = ds1 != nullptr;
  if (c < 0 || D <= 0 || D > kMaxD || sk <= 0 || r <= 0 ||
      dp <= 0 || dp > REPRO_MAX_DP || ((dirs != nullptr || want_mom) && !has_p) ||
      (dirs != nullptr && m <= 0) || (omega != nullptr && q <= 0))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D, sk, has_p, r, dp);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nblk = (c + kPts - 1) / kPts;
  const int nm = dp + dp * (dp + 1) / 2;
  const int skD = sk * D;
  const int mm = dirs != nullptr ? m : 0;
  float* psx = (float*)fscratch;
  float* pmom = psx + (long long)nblk * skD;
  float* pvmax = pmom + (long long)nblk * nm;
  float* pvmin = pvmax + (long long)nblk * mm;
  int* pimax = (int*)iscratch;
  int* pimin = pimax + (long long)nblk * mm;
  if (nblk > 0) {
    cudaError_t err = cudaSuccess;
    REPRO_DISPATCH_DP(dp, err = launch_main<DP>(
        nblk, smem, st, (const float*)X, c, D, (const float*)sw,
        (const int*)rows, (const float*)signs, (const float*)P, r, n_valid,
        (const float*)dirs, mm, (const float*)omega, q, sk, z != nullptr,
        want_mom, psx, (float*)z, pmom, pvmax, pimax, pvmin, pimin));
    if (err != cudaSuccess) return (int)err;
  }
  const int total = skD + (want_mom ? nm : 0);
  sweep_combine_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      psx, want_mom ? pmom : nullptr, nblk, skD, dp, (float*)dsx, (float*)ds1,
      (float*)ds2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dirs == nullptr) return (int)err;
  extremes_fold_kernel<<<(m + 127) / 128, 128, 0, st>>>(
      pvmax, pimax, pvmin, pimin, nblk, m, (float*)vmax, (int*)imax,
      (float*)vmin, (int*)imin);
  return (int)cudaGetLastError();
}
