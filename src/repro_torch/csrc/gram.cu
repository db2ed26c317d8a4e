// Gram matrix G = acc + (√w·X)ᵀ(√w·X) of one chunk of basis rows, in one
// launch.
//
// Replaces: src/repro/kernels/gram/kernel.py:gram_kernel (the TPU kernel
// revisits one (D, D) VMEM block across a sequential grid of row blocks).
//
// Bound on the H100: bytes — a chunk is 16,384 × 14 f32 = 0.9 MB (≈ 0.3 µs
// at 3.35 TB/s) for 2·D² flops a row (≈ 6.4 MFLOP) — and below that a
// launch's own latency, so the design spends exactly one launch per call:
//
//  - One thread-block cluster of C ≤ 16 CTAs (C = ⌈n/512⌉ capped at 16; 16
//    needs the non-portable cluster size). CTA c copies its contiguous
//    span of rows into shared memory with 16-byte cp.async, in stages of
//    ≤ 8,192 floats, two in flight (at the path's 16,384 × 14 chunk the
//    whole 1,024-row span is in flight at once), and √w with it; √w
//    scales each value as a row is read for the products.
//  - Every thread works: the upper triangle of 4×4 blocks of G (10 blocks
//    at D = 14) times G_r row groups fills ≥ 377 threads of ≤ 512, each
//    summing a 4×4 block over the rows of its group (four 8-byte shared
//    loads, eight multiplies by √w and 16 FMAs a row at even D). A stage's
//    products are summed plainly (≤ 12 rows a thread at D = 14), and the
//    stage sums go into compensated (Kahan) f32 sums, which hold the Gram
//    against float64 at any row count.
//  - The short sums that follow take a fixed order in plain f32: each
//    entry's 51 row-group partials (at D = 14) in four interleaved chains,
//    then rank 0 of the cluster gathers the C CTA partials over distributed
//    shared memory and sums them in a pairwise tree over the ranks, adds
//    acc (prefetched with the first tile) last and writes both triangles.
//    No float atomics and no scratch: the sum is taken in the same order
//    on every run, on every stream. (Compensated sums there cost more than
//    the rest of the kernel: a single warp's dependent chains.)
//
// For 64 < D ≤ 160 (J·(degree+1) at J = 10 and 20) a second body, simple
// rather than fast, takes the call, also in one launch: G's upper triangle
// is cut into 32×32 tiles (blockIdx.y), and the rows into C ≤ 16 contiguous
// spans, one a CTA of a C-CTA cluster (blockIdx.x). A CTA stages 128-row
// stages of its two 32-column panels of √w·X in shared memory, loading the
// next stage into registers while it multiplies this one; each of its
// 256 threads sums a 4×4 block of the tile over a quarter of each stage's
// rows in plain f32 and adds the stage sums into compensated sums, as the
// small body does. The four row groups are added in a fixed tree, and rank
// 0 sums the ranks' tiles in rank order over distributed shared memory,
// adds acc last and writes both triangles.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxD = 64;
constexpr int kMaxCluster = 16;
constexpr int kMinRowsPerCta = 512;
constexpr int kThreadsTarget = 512;  // row groups × 4×4 blocks ≤ this
constexpr int kMinThreads = 377;     // nblk·⌊512/nblk⌋ for every D ≤ 64 is at least this
constexpr int kStages = 2;
constexpr int kStageFloats = 8192;   // rows of X in one stage, unpadded
constexpr int kMaxStageRows = 2048;
constexpr int kRedFloats = kStages * kStageFloats;  // row-group partials (alias the stages)
constexpr int kSmemBytes = 4 * (kStages * (kStageFloats + kMaxStageRows) + kMaxD * kMaxD);

struct Shape {
  int ntri, nb, nblk, groups, stage_rows;
};

__host__ __device__ inline Shape make_shape(int D) {
  Shape s;
  s.nb = (D + 3) / 4;
  s.ntri = D * (D + 1) / 2;
  s.nblk = s.nb * (s.nb + 1) / 2;
  s.groups = kThreadsTarget / s.nblk > 1 ? kThreadsTarget / s.nblk : 1;
  const int rows = kStageFloats / D / 4 * 4;
  s.stage_rows = rows < kMaxStageRows ? rows : kMaxStageRows;
  return s;
}

// e-th entry of the upper triangle (row-major, a ≤ b) of a D×D matrix
__device__ __forceinline__ int tri_of(int a, int b, int D) { return a * D - a * (a - 1) / 2 + b - a; }

// k-th block of the upper triangle of an nb×nb block grid
__device__ __forceinline__ void block_of(int k, int nb, int& ba, int& bb) {
  ba = 0;
  while (k >= nb - ba) {
    k -= nb - ba;
    ++ba;
  }
  bb = ba + k;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
// Copy n floats (src and dst 16-byte aligned) with 16-byte cp.async, the
// ragged tail by element.
__device__ __forceinline__ void stage_copy(float* dst, const float* src, int n, int tid, int T) {
  const int n4 = n / 4;
  for (int i = tid; i < n4; i += T) cp_async16(dst + 4 * i, src + 4 * i);
  for (int i = 4 * n4 + tid; i < n; i += T) cp_async4(dst + i, src + i);
}

// The products of one staged tile: thread (blk, grp) sums the 4×4 block
// (ca.., cb..) of (√w·x)ᵀ(√w·x) over rows grp, grp + groups, ...; rows of
// even D are 8-byte aligned, so each half of a 4-vector is one 8-byte load.
// Columns past D read the next row or stale floats: their entries are never
// written out.
template <bool kEven, bool kWeighted>
__device__ __forceinline__ void tile_products(const float* __restrict__ x,
                                              const float* __restrict__ w, int cnt, int D,
                                              int ca, int cb, int grp, int groups,
                                              float (&part)[16]) {
  for (int r = grp; r < cnt; r += groups) {
    const float* xr = x + r * D;
    float av[4], bv[4];
    if (kEven) {
      const float2 a0 = *reinterpret_cast<const float2*>(xr + ca);
      const float2 a1 = *reinterpret_cast<const float2*>(xr + ca + 2);
      const float2 b0 = *reinterpret_cast<const float2*>(xr + cb);
      const float2 b1 = *reinterpret_cast<const float2*>(xr + cb + 2);
      av[0] = a0.x, av[1] = a0.y, av[2] = a1.x, av[3] = a1.y;
      bv[0] = b0.x, bv[1] = b0.y, bv[2] = b1.x, bv[3] = b1.y;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = xr[ca + i];
        bv[i] = xr[cb + i];
      }
    }
    if (kWeighted) {
      const float wr = w[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] *= wr;
        bv[i] *= wr;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[4 * i + j] = fmaf(av[i], bv[j], part[4 * i + j]);
  }
}

__global__ void __launch_bounds__(kThreadsTarget)
    gram_cluster_kernel(const float* __restrict__ X, const float* __restrict__ sw, int n, int D,
                        int span, const float* __restrict__ acc, float* __restrict__ G) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                  // kStages × kStageFloats
  float* ws = smem + kStages * kStageFloats;         // kStages × kMaxStageRows
  float* accs = ws + kStages * kMaxStageRows;        // acc, on rank 0
  float* red = smem;                                 // after the last tile
  cg::cluster_group cluster = cg::this_cluster();
  const Shape sh = make_shape(D);
  const int tid = threadIdx.x, T = blockDim.x;
  const int blk = tid % sh.nblk, grp = tid / sh.nblk;
  int ba, bb;
  block_of(blk, sh.nb, ba, bb);
  const int ca = 4 * ba, cb = 4 * bb;

  const int rank = (int)cluster.block_rank();
  const int row0 = min(n, rank * span);
  const int row_end = min(n, row0 + span);
  const int ntiles = (row_end - row0 + sh.stage_rows - 1) / sh.stage_rows;

  // tile t's rows (row0 + t·stage_rows is a multiple of 4 rows, so its
  // first float is 16-byte aligned) and √w into stage t % 2
  auto issue = [&](int t) {
    if (t < ntiles) {
      const int r0 = row0 + t * sh.stage_rows;
      const int cnt = min(sh.stage_rows, row_end - r0);
      const int st = t % kStages;
      stage_copy(xs + st * kStageFloats, X + (long long)r0 * D, cnt * D, tid, T);
      if (sw != nullptr) stage_copy(ws + st * kMaxStageRows, sw + r0, cnt, tid, T);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  if (rank == 0 && acc != nullptr)  // lands with the first tile
    for (int i = tid; i < D * D; i += T) cp_async4(accs + i, acc + i);
  KahanSum run[16];
  issue(0);
  issue(1);
  for (int t = 0; t < ntiles; ++t) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const int cnt = min(sh.stage_rows, row_end - (row0 + t * sh.stage_rows));
    const float* x = xs + (t % kStages) * kStageFloats;
    const float* w = ws + (t % kStages) * kMaxStageRows;
    float part[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) part[i] = 0.f;
    if (D % 2 == 0) {
      if (sw != nullptr)
        tile_products<true, true>(x, w, cnt, D, ca, cb, grp, sh.groups, part);
      else
        tile_products<true, false>(x, w, cnt, D, ca, cb, grp, sh.groups, part);
    } else {
      if (sw != nullptr)
        tile_products<false, true>(x, w, cnt, D, ca, cb, grp, sh.groups, part);
      else
        tile_products<false, false>(x, w, cnt, D, ca, cb, grp, sh.groups, part);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) run[i].add(part[i]);
    __syncthreads();  // stage t % 2 is free again
    issue(t + 2);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // row-group partials → red[grp·ntri + e]; then each entry's partials are
  // summed in a fixed order, four interleaved chains over the groups
  // (g mod 4) combined as (c0 + c1) + (c2 + c3), into red[e]
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = ca + i, b = cb + j;
      if (a <= b && b < D) red[grp * sh.ntri + tri_of(a, b, D)] = run[4 * i + j].s;
    }
  __syncthreads();
  float total[(kMaxD * (kMaxD + 1) / 2 + kMinThreads - 1) / kMinThreads];  // tid, tid + T, ...
#pragma unroll
  for (int q = 0; q < (int)(sizeof(total) / sizeof(float)); ++q) {
    const int e = tid + q * T;
    total[q] = 0.f;
    if (e < sh.ntri) {
      float c4[4] = {0.f, 0.f, 0.f, 0.f};
      for (int g = 0; g < sh.groups; g += 4)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (g + k < sh.groups) c4[k] += red[(g + k) * sh.ntri + e];
      total[q] = (c4[0] + c4[1]) + (c4[2] + c4[3]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < (int)(sizeof(total) / sizeof(float)); ++q)
    if (tid + q * T < sh.ntri) red[tid + q * T] = total[q];

  // rank 0 gathers the CTA partials (red[0, ntri) of every rank) over
  // distributed shared memory and sums them in a fixed pairwise tree over
  // the ranks (missing ranks count as +0)
  cluster.sync();
  if (rank == 0) {
    const int C = (int)cluster.num_blocks();
    for (int e = tid; e < sh.ntri; e += T) {
      float v[kMaxCluster];
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c)
        v[c] = c < C ? cluster.map_shared_rank(red, c)[e] : 0.f;
      static_assert(kMaxCluster == 16, "the rank tree below is written for 16");
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] = v[2 * c] + v[2 * c + 1];
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = v[2 * c] + v[2 * c + 1];
      const float sum = (v[0] + v[1]) + (v[2] + v[3]);
      int a = 0, k = e;
      while (k >= D - a) {
        k -= D - a;
        ++a;
      }
      const int b = a + k;
      G[a * D + b] = acc != nullptr ? accs[a * D + b] + sum : sum;
      if (a != b) G[b * D + a] = acc != nullptr ? accs[b * D + a] + sum : sum;
    }
  }
  cluster.sync();  // no CTA leaves while rank 0 reads its shared memory
}


constexpr int kWideMaxD = 160;
constexpr int kWideTile = 32;       // columns of a panel; G tiles are 32×32
constexpr int kWideRows = 128;      // rows of a stage
constexpr int kWideThreads = 256;   // 64 4×4 blocks × 4 row groups
constexpr int kWideMaxCluster = 16; // as the small body: needs the non-portable size
constexpr int kWideMinRows = 1024;  // rows a rank before another rank joins

__global__ void __launch_bounds__(kWideThreads)
    gram_wide_kernel(const float* __restrict__ X, const float* __restrict__ sw, int n, int D,
                     int span, const float* __restrict__ acc, float* __restrict__ G) {
  __shared__ __align__(16) float xa[kWideRows * kWideTile];
  __shared__ __align__(16) float xb[kWideRows * kWideTile];
  __shared__ float tp[kWideTile * kWideTile];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  int ta, tb;
  block_of(blockIdx.y, (D + kWideTile - 1) / kWideTile, ta, tb);
  const int ca0 = ta * kWideTile, cb0 = tb * kWideTile;
  const bool diag = ta == tb;
  const float* xbs = diag ? xa : xb;
  const int tid = threadIdx.x;
  const int blk = tid & 63, grp = tid >> 6;
  const int bi = blk >> 3, bj = blk & 7;
  const int row0 = min(n, rank * span);
  const int row_end = min(n, row0 + span);

  // each thread's elements of a stage: i = tid + 256·q, row i / 32, column
  // i % 32 of each panel; the next stage's are loaded while this one is
  // multiplied
  constexpr int kPer = kWideRows * kWideTile / kWideThreads;
  float na[kPer], nb[kPer], nw[kPer];
  auto fetch = [&](int r0) {
    const int cnt = min(kWideRows, row_end - r0);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = tid + kWideThreads * q, r = i / kWideTile, cc = i % kWideTile;
      const long long o = (long long)(r0 + r) * D;
      const bool ok = r < cnt;
      nw[q] = ok && sw != nullptr ? sw[r0 + r] : 1.f;
      na[q] = ok && ca0 + cc < D ? X[o + ca0 + cc] : 0.f;
      nb[q] = ok && !diag && cb0 + cc < D ? X[o + cb0 + cc] : 0.f;
    }
  };
  KahanSum run[16];
  if (row0 < row_end) fetch(row0);
  for (int r0 = row0; r0 < row_end; r0 += kWideRows) {
    const int cnt = min(kWideRows, row_end - r0);
    __syncthreads();  // the previous stage is read
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      xa[tid + kWideThreads * q] = na[q] * nw[q];
      if (!diag) xb[tid + kWideThreads * q] = nb[q] * nw[q];
    }
    __syncthreads();
    if (r0 + kWideRows < row_end) fetch(r0 + kWideRows);
    float part[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) part[i] = 0.f;
    for (int r = grp; r < cnt; r += 4) {
      const float4 a = *reinterpret_cast<const float4*>(xa + r * kWideTile + 4 * bi);
      const float4 b = *reinterpret_cast<const float4*>(xbs + r * kWideTile + 4 * bj);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[4 * i + j] = fmaf(av[i], bv[j], part[4 * i + j]);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) run[i].add(part[i]);
  }

  // row groups → red[grp · 1024 + e] (aliasing xa), then a fixed tree
  __syncthreads();
  float* red = xa;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[grp * kWideTile * kWideTile + (4 * bi + i) * kWideTile + 4 * bj + j] = run[4 * i + j].s;
  __syncthreads();
  constexpr int kT2 = kWideTile * kWideTile;
  for (int e = tid; e < kT2; e += kWideThreads)
    tp[e] = (red[e] + red[kT2 + e]) + (red[2 * kT2 + e] + red[3 * kT2 + e]);

  // rank 0 sums the ranks' tiles in rank order, adds acc, writes G
  cluster.sync();
  if (rank == 0) {
    const int C = (int)cluster.num_blocks();
    for (int e = tid; e < kT2; e += kWideThreads) {
      const int a = ca0 + e / kWideTile, b = cb0 + e % kWideTile;
      if (a >= D || b >= D || (diag && a > b)) continue;
      float v[kWideMaxCluster];  // all ranks' values in flight, then summed in rank order
#pragma unroll
      for (int c = 0; c < kWideMaxCluster; ++c)
        v[c] = c < C ? cluster.map_shared_rank(tp, c)[e] : 0.f;
      float s = v[0];
#pragma unroll
      for (int c = 1; c < kWideMaxCluster; ++c)
        if (c < C) s += v[c];
      G[a * D + b] = acc != nullptr ? acc[a * D + b] + s : s;
      if (a != b) G[b * D + a] = acc != nullptr ? acc[b * D + a] + s : s;
    }
  }
  cluster.sync();  // no CTA leaves while rank 0 reads its shared memory
}

int launch_wide(const float* X, const float* sw, int n, int D, const float* acc, float* G,
                cudaStream_t st) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        gram_wide_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int nt = (D + kWideTile - 1) / kWideTile;
  // ranks: one wave of CTAs (one an SM at this body's registers), and at
  // least kWideMinRows rows a rank
  int C = (n + kWideMinRows - 1) / kWideMinRows;
  const int fit = sms / (nt * (nt + 1) / 2);
  C = C > fit ? fit : C;
  C = C < 1 ? 1 : (C > kWideMaxCluster ? kWideMaxCluster : C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, nt * (nt + 1) / 2);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, gram_wide_kernel, X, sw, n, D, (n + C - 1) / C, acc, G);
}

}  // namespace

// X (n, D) f32, D ≤ 160, and sw (n,) f32 or null (all ones), both with
// 16-byte aligned bases,
// acc (D, D) f32 or null (zeros) → G = acc + (√w·X)ᵀ(√w·X), (D, D) f32. G
// must not alias X, sw or acc.
REPRO_EXPORT int repro_gram(const void* X, const void* sw, int n, int D, const void* acc,
                            void* G, void* stream) {
  if (D <= 0 || D > kWideMaxD || n < 0) return (int)cudaErrorInvalidValue;
  if (D > kMaxD)
    return launch_wide((const float*)X, (const float*)sw, n, D, (const float*)acc, (float*)G,
                       (cudaStream_t)stream);
  const Shape sh = make_shape(D);
  if (sh.groups * sh.ntri > kRedFloats || sh.nblk * sh.groups < kMinThreads)
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e =
        cudaFuncSetAttribute(gram_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(gram_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  int C = (n + kMinRowsPerCta - 1) / kMinRowsPerCta;
  C = C < 1 ? 1 : (C > kMaxCluster ? kMaxCluster : C);
  const int span = ((n + C - 1) / C + 3) / 4 * 4;  // rows a CTA, a multiple of 4

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(sh.nblk * sh.groups);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, gram_cluster_kernel, (const float*)X, (const float*)sw, n,
                                 D, span, (const float*)acc, (float*)G);
}
