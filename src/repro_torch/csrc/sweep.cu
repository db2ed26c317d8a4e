// Fused one-pass sweep step over one chunk of basis rows X and derivative
// rows P: the CountSketch update SX' = SX + S·(√w·X), the emitted rows
// z = (√w·X)Ω (or √w·X), the moments (Σp, Σppᵀ) added to their carry and
// the chunk-local directional extremes of dirs @ Pᵀ.
//
// Replaces: src/repro/kernels/sweep/kernel.py:sweep_kernel (the TPU kernel
// walks row blocks in grid order, realizes the sketch as a one-hot MXU
// product and keeps every accumulator in revisited VMEM blocks). The
// contract is kept: f32 only; validity is a count of valid points, scaled
// by the r P rows of each point; the extremes carry chunk-local row ids.
//
// Bound on the H100: f32 FMA work of the extremes (m·c·r·d multiply-adds,
// ≈ 0.74 GFLOP per 16,384-point chunk at m = 1,614), then bytes (X, P, z
// and SX: a few MB per chunk at J = 2, SX alone 44 MB at J = 20, X and z
// 134 MB each at D = 2,048). X takes any D; P rows take d ≤ REPRO_MAX_DP
// (scoring.py scores a wider P beside the sweep, on the extremes and gram
// kernels). Design:
// one launch of two kinds of CTA, the sketch CTAs first in the grid, and
// about two CTAs an SM in all, so every CTA starts at once.
//
//  - Block CTAs each own pb consecutive points (their pb·r P rows): they
//    stage the P rows (padded, as kernels/extremes does) and √w·X (where
//    pb·D ≤ kXwStageFloats; a wider X is read from device memory as z is
//    written, the same product √w·x), write z, coalesced (the FMA chain of
//    fma_matmul when Ω is given), sum the moments of the P rows in compensated f32 sums (row
//    groups combined in a fixed order) into one partial a CTA, and score
//    the P rows against the directions with common.cuh:score_block.
//  - Sketch CTAs each own a range of bk buckets. A CTA reads the chunk's
//    sketch rows, compacts the points that land in its range in ascending
//    point order (a scan over each warp and a prefix over the warps),
//    stages their sign·(x·√w) rows in shared memory, a slab of kSlabCols
//    columns at a time, and each warp adds them into the rows of the buckets
//    it owns, each bucket's points in ascending order (ballots over the
//    list), starting from the carried SX.
//    That is the order of the plain version's index_add on the CPU, so SX'
//    has its bits; there is no per-CTA partial and no limit on the sketch
//    size (a range holds up to 4,096 points at a time and is flushed in
//    parts).
//
// A second launch folds the extremes partials by (value, lowest row) and
// rescans the winning tiles (common.cuh), and folds the moment partials in
// ascending CTA order (compensated) onto the carry. No float atomics: every
// sum is taken in the same order on every call.
#include "common.cuh"

namespace {

constexpr int kSegCap = 4096;     // compacted points a sketch CTA holds
constexpr int kScanPts = 8;       // points a thread per compaction step
constexpr int kSlabCols = 160;    // SX columns a warp adds at a time
constexpr int kColsPerLane = kSlabCols / 32;  // of them a lane
constexpr int kStageFloats = 8192; // staged sign·(x·√w) values of a flush chunk
constexpr int kXwStageFloats = 12288;  // √w·X values a block CTA stages, at most
constexpr int kMaxThreads = kExtMaxWarps * 32;
static_assert(kSegCap >= kMaxThreads * kScanPts, "a compaction step must fit the segment");
static_assert(32 * kColsPerLane == kSlabCols, "a warp's lanes must cover a slab of SX");
static_assert(kStageFloats >= kSlabCols, "a flush chunk must hold a slab of one row");

struct SweepArgs {
  const float* X;
  const float* sw;
  const int* rows;
  const float* signs;
  const float* P;
  const float* dirs;
  const float* omega;
  const float* SX;
  float* SXo;
  float* z;
  float* pmom;
  float* pvmax;
  int* pimax;
  float* pvmin;
  int* pimin;
  int c, D, r, n_valid, m, q, sk;
  int want_z, want_mom;
  int stage_x;   // block CTAs stage √w·X (pb·D ≤ kXwStageFloats)
  int pb, nblk;  // block CTAs: points each (pb·r P rows), count
  int bk, ns;    // sketch CTAs: buckets each, count
  int warps;     // scoring warps of a block CTA
};

__device__ __forceinline__ void tri_index(int e, int D, int& a, int& b) {
  a = 0;
  while (e >= D - a) {
    e -= D - a;
    ++a;
  }
  b = a + e;
}

template <int DP>
__device__ __forceinline__ void block_cta(const SweepArgs& A, int blk, float* smem) {
  constexpr int DP4 = pad4(DP);
  const int tid = threadIdx.x, T = blockDim.x;
  const int pt0 = blk * A.pb;
  const int cnt = min(A.pb, A.c - pt0);
  const int D = A.D, rb = A.pb * A.r, nrow = cnt * A.r;
  const bool has_p = A.dirs != nullptr || A.want_mom;
  float* tile = smem;                           // rb · DP4   P rows, padded
  const bool stage_x = A.want_z && A.stage_x;
  float* xw = tile + (has_p ? rb * DP4 : 0);    // pb · D     √w·X rows
  float* red = xw + (stage_x ? A.pb * D : 0);   // T          moment partials
  if (has_p) stage_rows<DP>(A.P, pt0 * A.r, nrow, tile);
  if (stage_x)
    for (int i = tid; i < cnt * D; i += T)
      xw[i] = __fmul_rn(A.X[(long long)pt0 * D + i], A.sw[pt0 + i / D]);
  __syncthreads();
  if (A.want_z) {
    const int qw = A.omega != nullptr ? A.q : D;
    for (int e = tid; e < cnt * qw; e += T) {
      const int i = e / qw, oc = e - i * qw;
      const float* xr = xw + i * D;
      const float* xg = A.X + (long long)(pt0 + i) * D;
      const float wi = A.sw[pt0 + i];
      // √w·x of column k: staged, or the same product from device memory
      auto xv = [&](int k) { return stage_x ? xr[k] : __fmul_rn(xg[k], wi); };
      float v;
      if (A.omega != nullptr) {
        v = xv(0) * A.omega[oc];
        for (int k = 1; k < D; ++k) v = fmaf(xv(k), A.omega[(long long)k * A.q + oc], v);
      } else {
        v = xv(oc);
      }
      A.z[(long long)(pt0 + i) * qw + oc] = v;
    }
  }
  if (A.want_mom) {
    // thread (e, g): entry e over rows g, g + groups, ...; groups in order
    constexpr int nm = DP + DP * (DP + 1) / 2;
    const int groups = max(1, T / nm);
    if (tid < nm * groups) {
      const int e = tid % nm, g = tid / nm;
      int a = e, b = e;
      if (e >= DP) tri_index(e - DP, DP, a, b);
      KahanSum acc;
      for (int i = g; i < nrow; i += groups)
        acc.add(e < DP ? tile[i * DP4 + e] : tile[i * DP4 + a] * tile[i * DP4 + b]);
      red[g * nm + e] = acc.s;
    }
    __syncthreads();
    if (tid < nm) {
      KahanSum acc;
      for (int g = 0; g < groups; ++g) acc.add(red[g * nm + tid]);
      A.pmom[(long long)blk * nm + tid] = acc.s;
    }
  }
  for (int dir0 = 0; dir0 < A.m; dir0 += A.warps * kExtWarpDirs)
    score_block<DP>(tile, pt0 * A.r, nrow, A.n_valid * A.r, A.dirs, A.m, A.warps, blk, dir0,
                    A.pvmax, A.pimax, A.pvmin, A.pimin);
}

// Sketch CTA: one flush of the n compacted points (Lp ids, Lb buckets in
// the range, ascending) into SX', a slab of S ≤ kSlabCols columns at a
// time, in chunks of the list: all threads stage the chunk's rows
// sign·(x·√w) of the slab in V (loads in parallel), then warp w adds them to
// the buckets b ≡ w (mod warps) it owns, lanes on columns, each bucket's
// points in list order (ballots over the chunk). A column's sum takes the
// same order whatever the slabs: one slab for D ≤ kSlabCols.
__device__ __forceinline__ void sketch_flush(const SweepArgs& A, int lo, int nb, int n,
                                             const int* Lp, const int* Lb, float* V) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, W = T >> 5;
  const int D = A.D;
  for (int s0 = 0; s0 < D; s0 += kSlabCols) {
    const int S = min(kSlabCols, D - s0);
    const int chunk = kStageFloats / S;
    for (int c0 = 0; c0 < n; c0 += chunk) {
      const int cn = min(chunk, n - c0);
      __syncthreads();  // the list is written; the last chunk's V is read
#pragma unroll 4
      for (int i = tid; i < cn * S; i += T) {
        const int j = i / S, col = i - j * S;
        const int pt = Lp[c0 + j];
        V[i] = __fmul_rn(A.signs[pt], __fmul_rn(A.X[(long long)pt * D + s0 + col], A.sw[pt]));
      }
      __syncthreads();
      for (int b = warp; b < nb; b += W) {
        const long long row = (long long)(lo + b) * D + s0;
        float acc[kColsPerLane];
        bool live = false;  // uniform across the warp
        for (int j0 = 0; j0 < cn; j0 += 32) {
          unsigned mask = __ballot_sync(0xffffffffu, j0 + lane < cn && Lb[c0 + j0 + lane] == b);
          if (mask && !live) {
#pragma unroll
            for (int q = 0; q < kColsPerLane; ++q)
              acc[q] = lane + 32 * q < S ? A.SXo[row + lane + 32 * q] : 0.f;
            live = true;
          }
          while (mask) {
            const float* v = V + (j0 + __ffs(mask) - 1) * S;
            mask &= mask - 1;
#pragma unroll
            for (int q = 0; q < kColsPerLane; ++q)
              if (lane + 32 * q < S) acc[q] = __fadd_rn(acc[q], v[lane + 32 * q]);
          }
        }
        if (live)
#pragma unroll
          for (int q = 0; q < kColsPerLane; ++q)
            if (lane + 32 * q < S) A.SXo[row + lane + 32 * q] = acc[q];
      }
    }
  }
  __syncthreads();  // the list may be refilled
}

// Sketch rows of one compaction step's points, -1 past the chunk.
__device__ __forceinline__ void fetch_rows(const SweepArgs& A, int t0, int (&r)[kScanPts]) {
#pragma unroll
  for (int k = 0; k < kScanPts; ++k) {
    const int pt = t0 + threadIdx.x * kScanPts + k;
    r[k] = pt < A.c ? A.rows[pt] : -1;
  }
}

__device__ __forceinline__ void sketch_cta(const SweepArgs& A, int sc, int* smem) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int lo = sc * A.bk;
  const int nb = min(A.bk, A.sk - lo);
  if (nb <= 0) return;
  int* Lp = smem;                               // kSegCap  point ids, ascending
  int* Lb = Lp + kSegCap;                       // kSegCap  their buckets - lo
  float* V = reinterpret_cast<float*>(Lb + kSegCap);  // kStageFloats
  int* wc = Lb + kSegCap + kStageFloats;        // 2 × 32 warp counts, alternate steps
  const long long off = (long long)lo * A.D;
  for (long long i = tid; i < (long long)nb * A.D; i += T) A.SXo[off + i] = A.SX[off + i];
  // compaction: a step takes kScanPts consecutive points a thread, so list
  // order is (thread, point) order, i.e. ascending; the sketch rows of the
  // next two steps are in flight while one is compacted
  const int step = T * kScanPts;
  int now[kScanPts], next[kScanPts], after[kScanPts];
  fetch_rows(A, 0, next);
  fetch_rows(A, step, after);
  int nseg = 0, parity = 0;
  for (int t0 = 0; t0 < A.c; t0 += step) {
#pragma unroll
    for (int k = 0; k < kScanPts; ++k) {
      now[k] = next[k];
      next[k] = after[k];
    }
    fetch_rows(A, t0 + 2 * step, after);
    int bkt[kScanPts];
    int mine = 0;
#pragma unroll
    for (int k = 0; k < kScanPts; ++k) {
      bkt[k] = now[k] < 0 ? -1 : now[k] - lo;
      if (bkt[k] >= nb) bkt[k] = -1;
      mine += bkt[k] >= 0;
    }
    int x = mine;  // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    int* w = wc + 32 * parity;
    if (lane == 31) w[warp] = x;
    __syncthreads();
    const int wv = lane < (T >> 5) ? w[lane] : 0;  // the warps' counts, scanned
    int wx = wv;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wx, o);
      if (lane >= o) wx += y;
    }
    const int before = __shfl_sync(0xffffffffu, wx - wv, warp);
    const int total = __shfl_sync(0xffffffffu, wx, 31);
    int o = nseg + before + x - mine;
#pragma unroll
    for (int k = 0; k < kScanPts; ++k)
      if (bkt[k] >= 0) {
        Lp[o] = t0 + tid * kScanPts + k;
        Lb[o] = bkt[k];
        ++o;
      }
    nseg += total;
    parity ^= 1;
    if (nseg > kSegCap - step) {
      sketch_flush(A, lo, nb, nseg, Lp, Lb, V);
      nseg = 0;
    }
  }
  if (nseg > 0) sketch_flush(A, lo, nb, nseg, Lp, Lb, V);
}

template <int DP>
__global__ void __launch_bounds__(kMaxThreads, kExtCtasPerSm) sweep_main_kernel(const SweepArgs A) {
  extern __shared__ __align__(16) float smem[];
  if ((int)blockIdx.x < A.ns)
    sketch_cta(A, blockIdx.x, reinterpret_cast<int*>(smem));
  else
    block_cta<DP>(A, blockIdx.x - A.ns, smem);
}

// The extremes fold (CTAs [0, n_ext)), then one CTA that folds the moment
// partials of the block CTAs in ascending order onto the carry.
template <int DP>
__global__ void __launch_bounds__(kExtFoldWarps * 32) sweep_fold_kernel(
    const SweepArgs A, int n_ext, const float* __restrict__ s1c, const float* __restrict__ s2c,
    float* __restrict__ s1o, float* __restrict__ s2o, float* __restrict__ vmax,
    int* __restrict__ imax, float* __restrict__ vmin, int* __restrict__ imin) {
  __shared__ float red[4 * kExtFoldWarps * 32];
  if ((int)blockIdx.x < n_ext) {
    extremes_fold_cta<DP>(A.pvmax, A.pimax, A.pvmin, A.pimin, A.nblk, A.m,
                          blockIdx.x * kExtFoldDirs, A.P, A.c * A.r, A.dirs, red, vmax, imax,
                          vmin, imin);
    return;
  }
  constexpr int nm = DP + DP * (DP + 1) / 2;
  constexpr int groups = kExtFoldWarps * 32 / nm;
  static_assert(groups * nm <= 4 * kExtFoldWarps * 32, "moment groups overflow red");
  const int tid = threadIdx.x;
  if (tid < nm * groups) {
    const int e = tid % nm, g = tid / nm;
    KahanSum acc;
    for (int b = g; b < A.nblk; b += groups) acc.add(A.pmom[(long long)b * nm + e]);
    red[g * nm + e] = acc.s;
  }
  __syncthreads();
  if (tid >= nm) return;
  KahanSum acc;
  for (int g = 0; g < groups; ++g) acc.add(red[g * nm + tid]);
  if (tid < DP) {
    s1o[tid] = __fadd_rn(s1c[tid], acc.s);
  } else {
    int a, b;
    tri_index(tid - DP, DP, a, b);
    s2o[a * DP + b] = __fadd_rn(s2c[a * DP + b], acc.s);
    if (a != b) s2o[b * DP + a] = __fadd_rn(s2c[b * DP + a], acc.s);
  }
}

template <int DP>
cudaError_t launch(const SweepArgs& A, int threads, const float* s1c, const float* s2c,
                   float* s1o, float* s2o, float* vmax, int* imax, float* vmin, int* imin,
                   cudaStream_t st) {
  const bool has_p = A.dirs != nullptr || A.want_mom;
  long long smem = 4LL * ((has_p ? (long long)A.pb * A.r * pad4(DP) : 0) +
                          (A.want_z && A.stage_x ? (long long)A.pb * A.D : 0) +
                          threads);  // block CTAs
  if (A.ns > 0 && smem < 4 * (2 * kSegCap + kStageFloats + 64))
    smem = 4 * (2 * kSegCap + kStageFloats + 64);
  if (smem > 232448) return cudaErrorInvalidValue;  // an H100 CTA's opt-in limit
  static long long smem_set = 0;  // the opt-in so far, of this instantiation
  cudaError_t err = cudaSuccess;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(sweep_main_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const int grid = A.ns + A.nblk;
  if (grid > 0) {
    sweep_main_kernel<DP><<<grid, threads, smem, st>>>(A);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int n_ext = A.dirs != nullptr ? (A.m + kExtFoldDirs - 1) / kExtFoldDirs : 0;
  const int n_fold = n_ext + (A.want_mom ? 1 : 0);
  if (n_fold == 0) return cudaSuccess;
  sweep_fold_kernel<DP><<<n_fold, kExtFoldWarps * 32, 0, st>>>(A, n_ext, s1c, s2c, s1o, s2o,
                                                               vmax, imax, vmin, imin);
  return cudaGetLastError();
}

}  // namespace

// X (c, D), sw (c,), rows (c,) i32, signs (c,) f32, P (c·r, dp) or null,
// dirs (m, dp) or null, omega (D, q) or null, SX (sk, D) the carry, s1c
// (dp,) and s2c (dp, dp) the moment carry or null. Outputs: SXo (sk, D);
// z (c, q or D) or null; s1o, s2o when the carry is given; extremes (m,)
// when dirs is (row ids into P). The plan, from the wrapper
// (sweep/ops.py:launch_plan): pb points a block CTA (pb·r ≤
// kExtMaxBlockRows P rows);
// bk buckets a sketch CTA; `warps` scoring warps a block CTA (128
// directions each; a CTA takes m in turns of warps·128). Scratch: fscratch (2·nblk·m + nblk·nm
// f32) and iscratch (2·nblk·m i32), nblk = ceil(c/pb), nm = dp + dp(dp+1)/2.
// One main launch and, with dirs or moments, a fold.
REPRO_EXPORT int repro_sweep(const void* X, int c, int D, const void* sw, const void* rows,
                             const void* signs, const void* P, int r, int dp, int n_valid,
                             const void* dirs, int m, const void* omega, int q, const void* SX,
                             int sk, const void* s1c, const void* s2c, int pb, int bk,
                             int warps, void* fscratch, void* iscratch, void* SXo, void* z,
                             void* s1o, void* s2o, void* vmax, void* imax, void* vmin,
                             void* imin, void* stream) {
  const bool has_p = P != nullptr;
  const bool want_mom = s1c != nullptr;
  if (c < 0 || D <= 0 || sk <= 0 || r <= 0 || dp <= 0 || dp > REPRO_MAX_DP ||
      ((dirs != nullptr || want_mom) && !has_p) || (dirs != nullptr && m <= 0) ||
      (omega != nullptr && q <= 0) || pb <= 0 || pb * r > kExtMaxBlockRows || bk <= 0 ||
      (dirs != nullptr && (warps < 1 || warps > kExtMaxWarps)))
    return (int)cudaErrorInvalidValue;
  SweepArgs A;
  A.X = (const float*)X;
  A.sw = (const float*)sw;
  A.rows = (const int*)rows;
  A.signs = (const float*)signs;
  A.P = (const float*)P;
  A.dirs = (const float*)dirs;
  A.omega = (const float*)omega;
  A.SX = (const float*)SX;
  A.SXo = (float*)SXo;
  A.z = (float*)z;
  A.c = c;
  A.D = D;
  A.r = r;
  A.n_valid = n_valid;
  A.m = dirs != nullptr ? m : 0;
  A.q = q;
  A.sk = sk;
  A.want_z = z != nullptr;
  A.want_mom = want_mom;
  A.stage_x = (long long)pb * D <= kXwStageFloats;
  A.pb = pb;
  A.nblk = (A.want_z || want_mom || dirs != nullptr) ? (c + pb - 1) / pb : 0;
  A.bk = bk;
  A.ns = (sk + bk - 1) / bk;
  A.warps = dirs != nullptr ? warps : 1;
  const long long nbm = (long long)A.nblk * A.m;
  A.pvmax = (float*)fscratch;
  A.pvmin = A.pvmax + nbm;
  A.pmom = A.pvmin + nbm;
  A.pimax = (int*)iscratch;
  A.pimin = A.pimax + nbm;
  const int threads = dirs != nullptr ? max(256, warps * 32) : 256;
  cudaError_t err = cudaSuccess;
  REPRO_DISPATCH_DP(dp, err = launch<DP>(A, threads, (const float*)s1c, (const float*)s2c,
                                         (float*)s1o, (float*)s2o, (float*)vmax, (int*)imax,
                                         (float*)vmin, (int*)imin, (cudaStream_t)stream));
  return (int)err;
}
