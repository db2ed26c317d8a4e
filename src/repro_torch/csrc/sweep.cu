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
// That is the design for D ≤ kSlabCols. Past it (the pooled embeddings of a
// feature selector, D = 2,048: X, z and SX 134 MB each) the sweep is bound
// by bytes, and a sketch CTA that scans every bucket id of the chunk, X read
// by both kinds of CTA and the sketch CTAs' 64-KB reservation on every CTA
// of the launch keep the design above far from that bound. So for D >
// kSlabCols:
//
//  - A front launch: partition units (CTAs whose warps take kPartPoints
//    or more consecutive points each) split the chunk's points into ranges
//    of BK buckets, stably: each warp counts its points a range (warp
//    match + integer atomics, whose sums do not depend on order), the
//    warps scan the (range, warp) counts, and each warp walks its points
//    again in order with the scanned counts as cursors, writing each
//    point's entry {point, bucket in the range, √w, sign} to the unit's
//    region of the list. A range's points are then the concatenation of
//    its segment in every unit, in ascending point order. The same launch
//    holds the block CTAs where P rows or Ω need them.
//  - A tile launch: one CTA per (range, slab of 4·T columns). It loads the
//    range's BK rows of SX into registers (in flight while it gathers its
//    segments' entries into shared memory), reads each of its points' x
//    once, writes z = √w·x there when no Ω is given, and adds sign·(√w·x)
//    to the bucket's registers in list order, so each bucket's sum takes
//    the plain version's order; then it writes its rows of SX'. No CTA
//    reads another range's ids, X is read once without Ω and P, and no
//    shared memory is sized by the sketch.
//
// A last launch, with dirs or moments, folds the extremes partials by
// (value, lowest row) and rescans the winning tiles (common.cuh), and folds
// the moment partials in ascending CTA order (compensated) onto the carry. No float atomics: every
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
// D > kSlabCols
constexpr int kTileMaxThreads = 256;  // threads of a sketch tile, at most (4 columns each)
constexpr int kTileCtasPerSm = 2;     // the tile's launch bound: 128 registers a thread, at most
constexpr int kTileEntries = 256;     // list entries a tile stages at a time
constexpr int kTileBatch = 4;         // points whose x a thread loads before adding them
constexpr int kMaxParts = 64;         // partition units (a CTA each), at most
constexpr int kPartPoints = 128;      // points a partition warp takes, at least
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

// The fold launch, with dirs or moments.
template <int DP>
cudaError_t launch_fold(const SweepArgs& A, const float* s1c, const float* s2c, float* s1o,
                        float* s2o, float* vmax, int* imax, float* vmin, int* imin,
                        cudaStream_t st) {
  const int n_ext = A.dirs != nullptr ? (A.m + kExtFoldDirs - 1) / kExtFoldDirs : 0;
  const int n_fold = n_ext + (A.want_mom ? 1 : 0);
  if (n_fold == 0) return cudaSuccess;
  sweep_fold_kernel<DP><<<n_fold, kExtFoldWarps * 32, 0, st>>>(A, n_ext, s1c, s2c, s1o, s2o,
                                                               vmax, imax, vmin, imin);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// D > kSlabCols: the partition and the sketch tiles.

struct WideArgs {
  const float* X;
  const float* sw;
  const int* rows;
  const float* signs;
  const float* SX;
  float* SXo;
  float* z;    // written by the tiles (no Ω), else null
  int4* list;  // c entries {point, bucket − range start, √w bits, sign bits}
  int* cnt;    // parts × nr × part_warps: the units' counts, then their cursors (below)
  int c, D, sk, bk, nr, parts, part_warps, part_pts, nslab;
};

// Partition unit g: one CTA of W warps, warp w taking the part_pts points
// from g·W·part_pts + w·part_pts. Each warp counts its points a range r =
// row / bk into cell (r, w) of the unit's nr × W counts (warp match, then
// an integer atomic: the counts do not depend on order); the warps scan the
// cells in (range, warp) order, a contiguous share each; each warp walks
// its points again in order with its cells as cursors, writing each point's
// entry to the unit's region of the list (from g·W·part_pts). The region
// then holds the unit's points by range, each range in point order, and
// cell (r, W − 1) the end of range r's segment (its start the end of
// range r − 1, 0 for r = 0). A point whose row lies outside the sketch
// joins no range (index_add would refuse it). The cells live in L2
// (atomics, __ldcg/__stcg): no stale L1 line.
__device__ __forceinline__ void partition_unit(const WideArgs& A, int g) {
  __shared__ int wsum[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, W = A.part_warps;
  const unsigned below = (1u << lane) - 1u;
  const long long cells = (long long)A.nr * W;
  int* cnt = A.cnt + g * cells;
  for (long long i = tid; i < cells; i += blockDim.x) __stcg(cnt + i, 0);
  const int base = g * W * A.part_pts;  // the unit's region of the list
  const int p0 = base + warp * A.part_pts, p1 = min(A.c, p0 + A.part_pts);
  // a point's row and range, or a range no other lane holds; one step ahead
  int row = p0 + lane < p1 ? A.rows[p0 + lane] : -1;
  auto range_of = [&](int rw) { return rw >= 0 && rw < A.sk ? rw / A.bk : -1 - lane; };
  __syncthreads();
  for (int t0 = p0; t0 < p1; t0 += 32) {
    const int r = range_of(row);
    row = t0 + 32 + lane < p1 ? A.rows[t0 + 32 + lane] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, r);
    if (r >= 0 && lane == __ffs(peers) - 1) atomicAdd(&cnt[r * W + warp], __popc(peers));
  }
  __threadfence_block();
  __syncthreads();
  // exclusive scan of the cells: a warp's share is contiguous, 128 a round
  const long long per = ((cells + W - 1) / W + 127) / 128 * 128;
  const long long w0 = min(cells, warp * per), w1 = min(cells, w0 + per);
  int sum = 0;
#pragma unroll 8
  for (long long i = w0 + lane; i < w1; i += 32) sum += __ldcg(cnt + i);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) wsum[warp] = sum;
  __syncthreads();
  int carry = 0;
  for (int k = 0; k < warp; ++k) carry += wsum[k];
  int v[4], nv[4];  // this round's cells and the next round's, loaded ahead
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long i = w0 + 32 * k + lane;
    nv[k] = i < w1 ? __ldcg(cnt + i) : 0;
  }
  for (long long i0 = w0; i0 < w1; i0 += 128) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long i = i0 + 128 + 32 * k + lane;
      v[k] = nv[k];
      nv[k] = i < w1 ? __ldcg(cnt + i) : 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int x = v[k];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      const long long i = i0 + 32 * k + lane;
      if (i < w1) __stcg(cnt + i, carry + x - v[k]);
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
  }
  __syncthreads();
  // the scatter: the scanned cells are the cursors, taken in point order
  row = p0 + lane < p1 ? A.rows[p0 + lane] : -1;
  float w = p0 + lane < p1 ? A.sw[p0 + lane] : 0.f;
  float sg = p0 + lane < p1 ? A.signs[p0 + lane] : 0.f;
  for (int t0 = p0; t0 < p1; t0 += 32) {
    const int pt = t0 + lane, rw = row, r = range_of(rw);
    const float wv = w, sv = sg;
    const bool next = t0 + 32 + lane < p1;
    row = next ? A.rows[t0 + 32 + lane] : -1;
    w = next ? A.sw[t0 + 32 + lane] : 0.f;
    sg = next ? A.signs[t0 + 32 + lane] : 0.f;
    const unsigned peers = __match_any_sync(0xffffffffu, r);
    const int leader = __ffs(peers) - 1;
    int old = 0;
    if (r >= 0 && lane == leader) old = atomicAdd(&cnt[r * W + warp], __popc(peers));
    const int at = __shfl_sync(0xffffffffu, old, leader) + __popc(peers & below);
    if (r >= 0)
      A.list[base + at] = make_int4(pt, rw - r * A.bk, __float_as_int(wv), __float_as_int(sv));
  }
}

// The front launch: the partition units in the first W.parts CTAs, then the
// block CTAs (B.nblk of them; B.want_z only with Ω).
template <int DP>
__global__ void __launch_bounds__(kMaxThreads, kExtCtasPerSm)
    sweep_front_kernel(const SweepArgs B, const WideArgs W) {
  extern __shared__ __align__(16) float smem[];
  if ((int)blockIdx.x < W.parts) {
    partition_unit(W, blockIdx.x);
    return;
  }
  block_cta<DP>(B, blockIdx.x - W.parts, smem);
}

// A thread's 4 columns of a row at col: a 16-byte access (VEC), or 4
// accesses T apart, each predicated on the width.
template <bool VEC>
__device__ __forceinline__ void load4(const float* row, int col, int T, int D, float (&v)[4]) {
  if constexpr (VEC) {
    if (col < D) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(row + col));
      v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (col + q * T < D) v[q] = __ldg(row + col + q * T);
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* row, int col, int T, int D, const float (&v)[4]) {
  if constexpr (VEC) {
    if (col < D) __stcs(reinterpret_cast<float4*>(row + col), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (col + q * T < D) __stcs(row + col + q * T, v[q]);
  }
}

// Sketch tile (range r = blockIdx / nslab of BK buckets, slab s of 4·T
// columns). Its rows of SX are loaded first; warp 0 reads the range's
// segment in every unit (two units a lane) and scans their lengths; the
// entries are staged kTileEntries at a time (each thread finds its entry's
// unit by bisection), and every thread walks them in list order, adding
// its columns of sign·(√w·x) to the bucket's registers.
template <int BK, bool VEC>
__global__ void __launch_bounds__(kTileMaxThreads, kTileCtasPerSm)
    sweep_tile_kernel(const WideArgs A) {
  __shared__ int pre[kMaxParts + 1];  // the tile's entries before unit u's segment
  __shared__ int beg[kMaxParts];      // the segment's start in unit u's region
  __shared__ int4 ent[kTileEntries];
  const int tid = threadIdx.x, T = blockDim.x, D = A.D;
  const int r = blockIdx.x / A.nslab, s = blockIdx.x - r * A.nslab;
  const int lo = r * BK, nb = min(BK, A.sk - lo);
  const int col = s * 4 * T + (VEC ? 4 * tid : tid);
  float acc[BK][4];
#pragma unroll
  for (int k = 0; k < BK; ++k)
    if (k < nb) load4<VEC>(A.SX + (long long)(lo + k) * D, col, T, D, acc[k]);
  if (tid < 32) {
    int n[2] = {0, 0}, b[2] = {0, 0};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = 2 * tid + h;
      if (u < A.parts) {  // the ends of ranges r − 1 and r: cells (·, W − 1)
        const int* cu = A.cnt + (long long)u * A.nr * A.part_warps + A.part_warps - 1;
        b[h] = r > 0 ? cu[(long long)(r - 1) * A.part_warps] : 0;
        n[h] = cu[(long long)r * A.part_warps] - b[h];
      }
    }
    int x = n[0] + n[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (tid >= o) x += y;
    }
    const int before = x - n[0] - n[1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = 2 * tid + h;
      if (u < A.parts) {
        pre[u] = before + (h ? n[0] : 0);
        beg[u] = b[h];
      }
    }
    const int total = __shfl_sync(0xffffffffu, x, 31);
    if (tid == 0) pre[A.parts] = total;
  }
  __syncthreads();
  const int total = pre[A.parts];
  for (int e0 = 0; e0 < total; e0 += kTileEntries) {
    const int cn = min(kTileEntries, total - e0);
    if (e0 > 0) __syncthreads();  // the last batch's entries are read
    for (int i = tid; i < cn; i += T) {
      const int e = e0 + i;
      int a = 0, hi = A.parts - 1;  // the last unit whose segment starts at or before e
      while (a < hi) {
        const int mid = (a + hi + 1) >> 1;
        if (pre[mid] <= e) a = mid; else hi = mid - 1;
      }
      ent[i] = A.list[(long long)a * A.part_warps * A.part_pts + beg[a] + (e - pre[a])];
    }
    __syncthreads();
    for (int j0 = 0; j0 < cn; j0 += kTileBatch) {
      float xv[kTileBatch][4];
#pragma unroll
      for (int j = 0; j < kTileBatch; ++j)
        if (j0 + j < cn) load4<VEC>(A.X + (long long)ent[j0 + j].x * D, col, T, D, xv[j]);
#pragma unroll
      for (int j = 0; j < kTileBatch; ++j) {
        if (j0 + j >= cn) break;
        const int4 e = ent[j0 + j];
        const float w = __int_as_float(e.z), sg = __int_as_float(e.w);
        float xw[4], v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          xw[q] = __fmul_rn(xv[j][q], w);
          v[q] = __fmul_rn(sg, xw[q]);
        }
        if (A.z != nullptr) store4<VEC>(A.z + (long long)e.x * D, col, T, D, xw);
#pragma unroll
        for (int k = 0; k < BK; ++k)
          if (e.y == k)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[k][q] = __fadd_rn(acc[k][q], v[q]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < BK; ++k)
    if (k < nb) store4<VEC>(A.SXo + (long long)(lo + k) * D, col, T, D, acc[k]);
}

template <int BK>
cudaError_t launch_tiles(const WideArgs& W, int threads, bool vec, cudaStream_t st) {
  const long long grid = (long long)W.nr * W.nslab;
  if (grid <= 0) return cudaSuccess;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (vec)
    sweep_tile_kernel<BK, true><<<(int)grid, threads, 0, st>>>(W);
  else
    sweep_tile_kernel<BK, false><<<(int)grid, threads, 0, st>>>(W);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_wide(const SweepArgs& B, const WideArgs& W, int threads, int tile_threads,
                        const float* s1c, const float* s2c, float* s1o, float* s2o,
                        float* vmax, int* imax, float* vmin, int* imin, cudaStream_t st) {
  const bool has_p = B.dirs != nullptr || B.want_mom;
  long long smem = B.nblk == 0 ? 0 : 4LL * ((has_p ? (long long)B.pb * B.r * pad4(DP) : 0) +
                                            (B.want_z && B.stage_x ? (long long)B.pb * B.D : 0) +
                                            threads);
  if (smem > 232448) return cudaErrorInvalidValue;  // an H100 CTA's opt-in limit
  static long long smem_set = 0;  // the opt-in so far, of this instantiation
  cudaError_t err = cudaSuccess;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(sweep_front_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  sweep_front_kernel<DP><<<W.parts + B.nblk, threads, smem, st>>>(B, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bool vec = W.D % 4 == 0 &&
                   (((uintptr_t)W.X | (uintptr_t)W.SX | (uintptr_t)W.SXo | (uintptr_t)W.z) & 15) == 0;
  switch (W.bk) {
    case 4: err = launch_tiles<4>(W, tile_threads, vec, st); break;
    case 8: err = launch_tiles<8>(W, tile_threads, vec, st); break;
    case 16: err = launch_tiles<16>(W, tile_threads, vec, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return launch_fold<DP>(B, s1c, s2c, s1o, s2o, vmax, imax, vmin, imin, st);
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
  return launch_fold<DP>(A, s1c, s2c, s1o, s2o, vmax, imax, vmin, imin, st);
}

}  // namespace

// X (c, D), sw (c,), rows (c,) i32, signs (c,) f32, P (c·r, dp) or null,
// dirs (m, dp) or null, omega (D, q) or null, SX (sk, D) the carry, s1c
// (dp,) and s2c (dp, dp) the moment carry or null. Outputs: SXo (sk, D);
// z (c, q or D) or null; s1o, s2o when the carry is given; extremes (m,)
// when dirs is (row ids into P). The plan, from the wrapper
// (sweep/ops.py:launch_plan): pb points a block CTA (pb·r ≤
// kExtMaxBlockRows P rows); `warps` scoring warps a block CTA (128
// directions each; a CTA takes m in turns of warps·128). D ≤ kSlabCols: bk
// buckets a sketch CTA. D > kSlabCols: bk ∈ {4, 8, 16} buckets a range,
// tile_threads threads a sketch tile (4 columns each), parts partition
// units (CTAs of the launch's W = threads/32 warps) of part_pts points a
// warp (a multiple of 32). Scratch: fscratch (2·nblk·m + nblk·nm f32),
// iscratch (2·nblk·m i32), nblk = ceil(c/pb), nm = dp + dp(dp+1)/2; for D >
// kSlabCols pscratch (4·c + parts·ceil(sk/bk)·W i32, 16-byte aligned). D ≤ kSlabCols: one main launch; D > kSlabCols: the
// front and the tile launch; with dirs or moments, a fold.
REPRO_EXPORT int repro_sweep(const void* X, int c, int D, const void* sw, const void* rows,
                             const void* signs, const void* P, int r, int dp, int n_valid,
                             const void* dirs, int m, const void* omega, int q, const void* SX,
                             int sk, const void* s1c, const void* s2c, int pb, int bk,
                             int warps, int tile_threads, int parts, int part_pts,
                             void* fscratch, void* iscratch, void* pscratch, void* SXo, void* z,
                             void* s1o, void* s2o, void* vmax, void* imax, void* vmin,
                             void* imin, void* stream) {
  const bool has_p = P != nullptr;
  const bool want_mom = s1c != nullptr;
  const bool wide = D > kSlabCols;
  if (c < 0 || D <= 0 || sk <= 0 || r <= 0 || dp <= 0 || dp > REPRO_MAX_DP ||
      ((dirs != nullptr || want_mom) && !has_p) || (dirs != nullptr && m <= 0) ||
      (omega != nullptr && q <= 0) || pb <= 0 || pb * r > kExtMaxBlockRows || bk <= 0 ||
      (dirs != nullptr && (warps < 1 || warps > kExtMaxWarps)))
    return (int)cudaErrorInvalidValue;
  const int threads = dirs != nullptr ? max(256, warps * 32) : 256;
  if (wide && (tile_threads < 32 || tile_threads > kTileMaxThreads || tile_threads % 32 != 0 ||
               parts < 1 || parts > kMaxParts || part_pts < 32 || part_pts % 32 != 0 ||
               (long long)parts * (threads >> 5) * part_pts < c || pscratch == nullptr ||
               ((uintptr_t)pscratch & 15) != 0))
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
  if (wide) {  // the tiles write z without Ω; block CTAs only for P rows or Ω
    A.want_z = z != nullptr && omega != nullptr;
    A.nblk = (A.want_z || want_mom || dirs != nullptr) ? (c + pb - 1) / pb : 0;
    A.ns = 0;
  }
  const long long nbm = (long long)A.nblk * A.m;
  A.pvmax = (float*)fscratch;
  A.pvmin = A.pvmax + nbm;
  A.pmom = A.pvmin + nbm;
  A.pimax = (int*)iscratch;
  A.pimin = A.pimax + nbm;
  cudaError_t err = cudaSuccess;
  if (wide) {
    WideArgs W;
    W.X = A.X;
    W.sw = A.sw;
    W.rows = A.rows;
    W.signs = A.signs;
    W.SX = A.SX;
    W.SXo = A.SXo;
    W.z = omega == nullptr ? (float*)z : nullptr;
    W.list = (int4*)pscratch;
    W.cnt = (int*)pscratch + 4LL * c;
    W.c = c;
    W.D = D;
    W.sk = sk;
    W.bk = bk;
    W.nr = (sk + bk - 1) / bk;
    W.parts = parts;
    W.part_warps = threads >> 5;
    W.part_pts = part_pts;
    W.nslab = (D + 4 * tile_threads - 1) / (4 * tile_threads);
    REPRO_DISPATCH_DP(dp, err = launch_wide<DP>(A, W, threads, tile_threads, (const float*)s1c,
                                                (const float*)s2c, (float*)s1o, (float*)s2o,
                                                (float*)vmax, (int*)imax, (float*)vmin,
                                                (int*)imin, (cudaStream_t)stream));
    return (int)err;
  }
  REPRO_DISPATCH_DP(dp, err = launch<DP>(A, threads, (const float*)s1c, (const float*)s2c,
                                         (float*)s1o, (float*)s2o, (float*)vmax, (int*)imax,
                                         (float*)vmin, (int*)imin, (cudaStream_t)stream));
  return (int)err;
}
