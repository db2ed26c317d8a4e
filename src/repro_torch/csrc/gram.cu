// Gram matrix G = acc + (√w·X)ᵀ(√w·X) of one chunk of basis rows, in one
// launch (two for D > 160).
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
// For 64 < D ≤ 160 (J·(degree+1) at J = 10 and 20: a 16,384-row chunk is
// 4.6 MB at D 70, 1.4 µs of bytes, and 0.08–0.33 GFLOP, 1.2–4.9 µs of f32
// CUDA-core work) the tiled body takes the call, in one launch:
//
//  - Tensor cores at f32 accuracy: each √w·x is split into hi = tf32(x) and
//    lo = x − hi (read as TF32 by the tensor core), and every 16×8×8 tile
//    product sums lo·hi + hi·lo + hi·hi (mma.sync m16n8k8 TF32, f32
//    accumulators): x·y to O(2⁻²¹) relative, the missing lo·lo included
//    (ssd's mma body splits its f32 operands the same way, in bf16). The
//    split is three integer/float ops a value: cvt.rna.tf32 issues at a
//    fraction of their rate. mma.sync rather than wgmma: here K is the row
//    axis of a row-major X, and mma.sync reads its fragments from a
//    row-major stage as it lies (A(i) of G's rows 16i.. is B(2i) and
//    B(2i + 1) of its columns, so a lane loads and splits each value once
//    for both operands), while wgmma's TF32 operands must be K-major in
//    shared memory (every stage transposed on its way in), and its 64-row
//    tiles cover the triangle with more waste than 16×8 tiles do. On this
//    card mma.sync TF32 peaks near 300 TFLOP/s (about 100 of f32 work at
//    three products), against 60 for f32 FMA.
//  - The rows split over one wave: ⌈n/64⌉ CTAs at most, in clusters of 8,
//    as many clusters as the card holds at once (15 at one CTA an SM: 120
//    CTAs of 160 rows at n = 16,384). A CTA streams its contiguous span in
//    32-row stages through a 4-deep cp.async ring (a warp a row, 16-, 8- or
//    4-byte copies as D allows), rows padded to a stride ≡ 8 (mod 32) words
//    so the fragment loads hit 32 banks.
//  - Only the upper triangle: G's 16×8 tiles (i, j ≥ 2i), listed strip by
//    strip, are cut into runs of W tiles, one warp a run (≤ 16 warps;
//    make_tiled_plan on the host, a pure function of D; W is the template
//    argument): 25 tiles in 13 runs of 2 at D 70, 90 in 15 of 6 at D 140.
//    With few tiles a warp, the three products go to three accumulator
//    chains, so the mma's latency does not bound them.
//  - Fixed-order sums, no float atomics: the mma sums one stage; stage sums
//    add in registers for ≤ 16 stages and then into compensated (Kahan)
//    sums in shared memory, a slot per fragment value. Rank r of a cluster
//    sums its slice of the slots over the cluster's CTAs in rank order over
//    distributed shared memory, compensated, and stores the (sum,
//    compensation) pair to the cluster's row of a scratch buffer
//    (torch.empty in ops.py); the last cluster to store slice r (an integer
//    ticket) sums the slice over the clusters in cluster order, compensated,
//    adds acc last and writes both triangles, so the result has the bits of
//    acc + gram(X) on every call, within ~4e-8 of float64 relative to
//    max|G| at the path's chunk.
//
// For D > 160 (any D: feature rows of a generic featurize, such as a
// 2,048-wide mean-pooled embedding) the large body takes the call, in two
// launches. Its instructions: three TF32 products over the upper triangle,
// 2·3·n·D(D+1)/2 flops (206 GFLOP at n = 16,384, D = 2,048: 0.42 ms at
// 495 TFLOP/s; the f32 FMA bound of the same Gram is 1.0 ms at 67 TFLOP/s).
//
//  - Tensor cores at f32 accuracy, as in the tiled body: each √w·x split
//    into hi + lo (split_tf32), each mma.sync m16n8k8 tile summing lo·hi +
//    hi·lo + hi·hi.
//  - G's upper triangle in 128 × 128 tiles (bi ≤ bj), nb(nb+1)/2 of them
//    over blockIdx.x, and the rows in `splits` contiguous spans over
//    blockIdx.y (ops.py:large_plan, a pure function of n and D that sizes
//    the spans for whole waves of CTAs). A CTA of 16 warps takes a tile,
//    each warp 32 × 32 of it (2 × 4 mma tiles, issued product by product so
//    8 independent mma separate two into one accumulator); on a diagonal
//    tile the six warps wholly below the diagonal do nothing, and one side
//    is staged.
//  - A 4-deep cp.async ring of 32-row stages of the tile's two 128-column
//    sides, 16 bytes a copy (D % 4 == 0: ops.py pads X with zero columns
//    otherwise, as 4-byte copies would take the body ~1.6× as long), rows
//    padded to a stride ≡ 8 (mod 32) words so the fragment loads hit 32
//    banks; √w rides with them and scales a value as it is split.
//  - Fixed-order sums, no float atomics: the mma sums a stage in its
//    accumulators (its f32 accumulation is not rounded to nearest, so it
//    sums no more); each stage sum goes into a compensated (Kahan) pair per
//    entry, the sum in registers and the compensation in shared memory (so
//    one CTA an SM), which the CTA stores once to its split's row of a
//    scratch (torch.empty in ops.py). A fold launch sums each
//    upper entry over the splits in split order, compensated, adds acc last
//    and writes both triangles, so the result has the bits of acc +
//    gram(X) on every call.
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
constexpr int kWideCluster = 8;        // CTAs of a cluster (the portable size)
constexpr int kWideMaxGroups = 16;     // warps of a CTA, one a run of tiles
constexpr int kWideMinRunTiles = 2;    // 16×8 tiles a warp: the kernel's template argument
constexpr int kWideMaxRunTiles = 7;
constexpr int kWideStageRows = 32;     // rows of a stage: four k-steps of eight
constexpr int kWideStages = 4;         // cp.async ring
constexpr int kWideSegStages = 16;     // stage sums added in registers before a compensated add
constexpr int kWideMinRows = 64;       // rows a CTA before another CTA joins
constexpr int kWideMaxClusters = 16;   // clusters at most: rows of the scratch (the card holds 15)
// the scratch a call: a (sum, compensation) pair of each fragment slot of a
// CTA (4 values × W tiles × 32 lanes × runs, at most) for each cluster
constexpr int kWideScratchFloats = kWideMaxClusters * 2 * 4 * kWideMaxRunTiles * 32 * kWideMaxGroups;

// The warps' runs of tiles. G's upper triangle is covered by 16×8 tiles
// (i, j ≥ 2i) of G's rows 16i.. and columns 8j..; run k has `tiles` of
// them: q < split[k] are (i0, j0 + q), the rest (i0 + 1, 2(i0 + 1) + q −
// split) (the next strip from its diagonal), and q ≥ cnt[k] pad the run
// (computed, never written).
struct TiledPlan {
  int runs, tiles;
  unsigned char i0[kWideMaxGroups], j0[kWideMaxGroups], split[kWideMaxGroups],
      cnt[kWideMaxGroups];
};

// The plan of D: the tiles listed strip by strip (i, then j) are cut into
// runs of W, one a warp. A run touches at most two strips: it ends early
// (cnt < W) rather than reach a third, as the last run may. W is the least
// in [kWideMinRunTiles, kWideMaxRunTiles] that needs at most kWideMaxGroups
// runs: as many warps as fit, for latency. runs = 0: no plan (D out of range).
inline TiledPlan make_tiled_plan(int D) {
  TiledPlan plan = {};
  if (D <= kMaxD || D > kWideMaxD) return plan;
  const int M = (D + 15) / 16, N = (D + 7) / 8;  // strip i holds tiles j = 2i .. N − 1
  for (int W = kWideMinRunTiles; W <= kWideMaxRunTiles; ++W) {
    int runs = 0, i = 0, j = 0;
    for (; i < M && runs < kWideMaxGroups; ++runs) {
      const int i0 = i, j0 = j;
      int cnt = 0, split = 0;
      for (; i < M && i <= i0 + 1 && cnt < W; ++cnt) {
        split += i == i0;
        if (++j == N) j = 2 * ++i;
      }
      plan.i0[runs] = (unsigned char)i0;
      plan.j0[runs] = (unsigned char)j0;
      plan.split[runs] = (unsigned char)split;
      plan.cnt[runs] = (unsigned char)cnt;
    }
    if (i == M) {
      plan.runs = runs;
      plan.tiles = W;
      return plan;
    }
  }
  plan.runs = 0;
  return plan;
}

// A stage row holds columns 0..Dm−1 (Dm = D rounded up to 16, as the
// fragments of the last m-tile read) and 8 more: a row stride ≡ 8 or 24
// (mod 32) words puts the 32 lanes of a fragment load (rows t, columns g)
// on 32 banks.
__host__ __device__ inline int tiled_ld(int D) { return (D + 15) / 16 * 16 + 8; }

// Fragment slots of a CTA: 4 values × W tiles × 32 lanes × runs.
__host__ __device__ inline int tiled_slots(int W, int runs) { return 4 * W * 32 * runs; }

__host__ __device__ inline size_t tiled_smem_bytes(int D, int slots) {
  return 4 * ((size_t)kWideStages * kWideStageRows * (tiled_ld(D) + 1) + 2 * (size_t)slots);
}

// x = hi + lo exactly: hi = x rounded to TF32 (nearest, ties away from
// zero, as cvt.rna.tf32.f32 — by integer ops: the conversion instruction
// issues at a fraction of their rate), lo = x − hi, which the tensor core
// reads as TF32 by dropping its low 13 bits: x·y to O(2⁻²¹) relative
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// D += A·B for one 16×8×8 tile: A row-major 16×8 TF32 (4 regs), B
// column-major 8×8 TF32 (2 regs), D 16×8 f32 (4 regs).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Compensated (Kahan) f32 sum of a few terms in a fixed order.
__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = x - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// Accumulator chains a tile: the three products of a k-step go to separate
// chains where a warp has few tiles (the mma's latency, not its rate, would
// bound a lone chain), to one where it has many.
template <int W>
struct Chains {
  static constexpr int kCount = W <= 3 ? 3 : (W <= 5 ? 2 : 1);
  // chain of product p (0: lo·hi, 1: hi·lo, 2: hi·hi)
  __host__ __device__ static constexpr int of(int p) {
    return kCount == 3 ? p : (kCount == 2 ? p / 2 : 0);
  }
};

// First column of tile q of a run (padding tiles repeat the first tile).
__device__ __forceinline__ int tile_col(int q, int i0, int j0, int split, int cnt) {
  return 8 * (q >= cnt ? j0 : (q < split ? j0 + q : 2 * (i0 + 1) + q - split));
}

// One stage's products (four k-steps) of a warp's run into its chains.
// kTwo: the run reaches the next strip, whose A fragment (ca1) serves the
// tiles q ≥ split.
template <int W, bool kTwo>
__device__ __forceinline__ void stage_products(const float* __restrict__ xs,
                                               const float* __restrict__ ws, bool weighted,
                                               int LD, int ca0, int ca1, int i0, int j0,
                                               int split, int cnt, int g, int t,
                                               float (&acc)[Chains<W>::kCount][W][4]) {
#pragma unroll
  for (int k0 = 0; k0 < kWideStageRows; k0 += 8) {
    // this lane's fragment elements: rows k0 + t and k0 + t + 4, column g
    // of an 8-column block; A(i) is B(2i) and B(2i + 1) side by side
    const float* x0 = xs + (k0 + t) * LD + g;
    const float* x1 = x0 + 4 * LD;
    const float w0 = weighted ? ws[k0 + t] : 1.f, w1 = weighted ? ws[k0 + t + 4] : 1.f;
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int m = 0; m < (kTwo ? 2 : 1); ++m) {
      const int ca = m == 0 ? ca0 : ca1;
      split_tf32(x0[ca] * w0, ah[m][0], al[m][0]);
      split_tf32(x0[ca + 8] * w0, ah[m][1], al[m][1]);
      split_tf32(x1[ca] * w1, ah[m][2], al[m][2]);
      split_tf32(x1[ca + 8] * w1, ah[m][3], al[m][3]);
    }
#pragma unroll
    for (int q = 0; q < W; ++q) {
      const int cb = tile_col(q, i0, j0, split, cnt);
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(x0[cb] * w0, bh0, bl0);
      split_tf32(x1[cb] * w1, bh1, bl1);
      const int m = kTwo && q >= split ? 1 : 0;
      uint32_t a_h[4], a_l[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        a_h[v] = kTwo ? (m ? ah[1][v] : ah[0][v]) : ah[0][v];
        a_l[v] = kTwo ? (m ? al[1][v] : al[0][v]) : al[0][v];
      }
      // the two small products first, then the large one
      mma_tf32(acc[Chains<W>::of(0)][q], a_l, bh0, bh1);
      mma_tf32(acc[Chains<W>::of(1)][q], a_h, bl0, bl1);
      mma_tf32(acc[Chains<W>::of(2)][q], a_h, bh0, bh1);
    }
  }
}

// G's entry (a, b) of fragment slot `slot` of a CTA of T threads, false for
// padding and for entries below the diagonal or past D.
__device__ __forceinline__ bool slot_entry(int slot, int T, int D, const TiledPlan& plan,
                                           int& a, int& b) {
  const int tid = slot % T, qv = slot / T, q = qv >> 2, v = qv & 3;
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int i0 = plan.i0[warp], j0 = plan.j0[warp], split = plan.split[warp];
  const int cnt = plan.cnt[warp];
  if (q >= cnt) return false;
  a = 16 * (q < split ? i0 : i0 + 1) + g + 8 * (v >> 1);
  b = tile_col(q, i0, j0, split, cnt) + 2 * t + (v & 1);
  return a <= b && b < D;
}

// The tiled body, 64 < D ≤ 160. Grid: ncl clusters of C CTAs; CTA x takes
// rows [x·span, (x+1)·span). vec: floats a cp.async (D % vec == 0). W:
// tiles a warp (plan.tiles).
template <int W>
__global__ void __launch_bounds__(kWideMaxGroups * 32, 1)
    gram_tiled_kernel(const float* __restrict__ X, const float* __restrict__ sw, int n, int D,
                      int span, int vec, const __grid_constant__ TiledPlan plan,
                      const float* __restrict__ acc_in, float* __restrict__ G,
                      float* __restrict__ scratch, int* __restrict__ tickets) {
  constexpr int CH = Chains<W>::kCount;
  extern __shared__ __align__(16) float smem[];
  __shared__ int last;
  const int LD = tiled_ld(D);
  const int tid = threadIdx.x, T = blockDim.x, nw = T / 32;
  const int slots = tiled_slots(W, nw);
  float* ring = smem;                                         // stages × rows × LD
  float* wring = ring + kWideStages * kWideStageRows * LD;    // stages × rows (√w)
  float* part = wring + kWideStages * kWideStageRows;         // slots: this CTA's sums
  float* comp = part + slots;                                 // slots: their compensations
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int cl = (int)blockIdx.x / C, ncl = (int)gridDim.x / C;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = min(n, (int)blockIdx.x * span), row_end = min(n, row0 + span);
  const int nst = (row_end - row0 + kWideStageRows - 1) / kWideStageRows;
  const bool weighted = sw != nullptr;

  // stage s: a warp a row, its lanes along it (no divisions: this runs every
  // stage); rows past the span zeroed; √w by the last warp, 16 bytes a lane
  // (the stage starts at a multiple of 32 rows)
  auto issue = [&](int s) {
    if (s < nst) {
      const int r0 = row0 + s * kWideStageRows;
      const int cnt = min(kWideStageRows, row_end - r0);
      float* dst = ring + (s % kWideStages) * kWideStageRows * LD;
      for (int r = warp; r < kWideStageRows; r += nw) {
        float* d = dst + r * LD;
        if (r < cnt) {
          const float* src = X + (long long)(r0 + r) * D;
          for (int c = vec * lane; c < D; c += 32 * vec) {
            if (vec == 4)
              cp_async16(d + c, src + c);
            else if (vec == 2)
              cp_async8(d + c, src + c);
            else
              cp_async4(d + c, src + c);
          }
        } else {
          for (int c = lane; c < D; c += 32) d[c] = 0.f;
        }
      }
      if (weighted && warp == nw - 1 && 4 * lane < kWideStageRows) {
        // rows past the span get √w = 0: stale shared memory may hold a NaN,
        // and 0·NaN would reach every product of the stage
        float* wdst = wring + (s % kWideStages) * kWideStageRows;
        if (4 * lane + 3 < cnt) {
          cp_async16(wdst + 4 * lane, sw + r0 + 4 * lane);
        } else {
          for (int r = 4 * lane; r < 4 * lane + 4; ++r) {
            if (r < cnt)
              cp_async4(wdst + r, sw + r0 + r);
            else
              wdst[r] = 0.f;
          }
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

#pragma unroll
  for (int s = 0; s < kWideStages - 1; ++s) issue(s);
  // while they land: pad columns [D, LD) of every ring row are zero and stay
  // so (the copies never touch them)
  for (int r = warp; r < kWideStages * kWideStageRows; r += nw)
    for (int c = D + lane; c < LD; c += 32) ring[r * LD + c] = 0.f;

  const int i0 = plan.i0[warp], j0 = plan.j0[warp], split = plan.split[warp];
  const int cnt = plan.cnt[warp];
  const int ca0 = 16 * i0, ca1 = 16 * min(i0 + 1, (D + 15) / 16 - 1);
  const bool two = split < cnt;
  float acc[CH][W][4], seg[W][4];
#pragma unroll
  for (int q = 0; q < W; ++q)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      seg[q][v] = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) acc[c][q][v] = 0.f;
    }

  // the segment sums into part/comp, slot (q·4 + v)·T + tid: compensated
  // (Kahan) after the first segment, which stores (comp 0). `more`: some CTA
  // has a second segment, so the rank reduce reads the compensations; it is
  // decided by the span, the same for every CTA, as any rank reads them all
  const bool more = (span + kWideStageRows - 1) / kWideStageRows > kWideSegStages;
  auto flush = [&](bool first) {
#pragma unroll
    for (int q = 0; q < W; ++q)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int e = (q * 4 + v) * T + tid;
        if (first) {
          part[e] = seg[q][v];
          comp[e] = 0.f;
        } else {
          float sum = part[e], c = comp[e];
          kahan_add(sum, c, seg[q][v]);
          part[e] = sum;
          comp[e] = c;
        }
        seg[q][v] = 0.f;
      }
  };

  for (int s = 0; s < nst; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kWideStages - 2) : "memory");
    __syncthreads();  // stage s landed for every thread; stage s − 1 is read
    issue(s + kWideStages - 1);
    const float* xs = ring + (s % kWideStages) * kWideStageRows * LD;
    const float* ws = wring + (s % kWideStages) * kWideStageRows;
    if (two)
      stage_products<W, true>(xs, ws, weighted, LD, ca0, ca1, i0, j0, split, cnt, g, t, acc);
    else
      stage_products<W, false>(xs, ws, weighted, LD, ca0, ca1, i0, j0, split, cnt, g, t, acc);
    // the stage's chains (small products first) into the segment sums
#pragma unroll
    for (int q = 0; q < W; ++q)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float x = acc[0][q][v];
#pragma unroll
        for (int c = 1; c < CH; ++c) x += acc[c][q][v];
        seg[q][v] += x;
#pragma unroll
        for (int c = 0; c < CH; ++c) acc[c][q][v] = 0.f;
      }
    if ((s + 1) % kWideSegStages == 0 || s + 1 == nst) flush(s < kWideSegStages);
  }
  if (nst == 0) flush(true);  // an empty span: zeros
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // rank r sums slots [r·per, (r+1)·per) over the cluster's CTAs in rank
  // order (every rank's load in flight first) into a compensated pair
  // (s, c), value s − c: the cluster's rows of scratch (s plane, c plane)
  cluster.sync();
  const int per = (slots + C - 1) / C;
  const int e0 = min(slots, rank * per), e1 = min(slots, e0 + per);
  for (int e = e0 + tid; e < e1; e += T) {
    float ps[kWideCluster], pc[kWideCluster];
#pragma unroll
    for (int c = 0; c < kWideCluster; ++c) {
      const int r = c < C ? c : 0;
      ps[c] = cluster.map_shared_rank(part, r)[e];
      pc[c] = more ? cluster.map_shared_rank(comp, r)[e] : 0.f;
    }
    float sum = 0.f, cmp = 0.f;
#pragma unroll
    for (int c = 0; c < kWideCluster; ++c) {
      if (c >= C) break;
      kahan_add(sum, cmp, ps[c]);
      kahan_add(sum, cmp, -pc[c]);
    }
    float* row = scratch + (long long)cl * 2 * slots;
    row[e] = sum;
    row[slots + e] = cmp;
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory

  // the last cluster to finish its slots of slice `rank` (an integer ticket)
  // sums the slice over the clusters in cluster order (compensated, every
  // cluster's loads in flight first), adds acc last and writes both
  // triangles; it then resets the ticket for the next call
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + rank, 1) == ncl - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = e0 + tid; e < e1; e += T) {
    float vs[kWideMaxClusters], vc[kWideMaxClusters];
#pragma unroll
    for (int c = 0; c < kWideMaxClusters; ++c) {  // the loads first, the slot's decoding under them
      const float* row = scratch + (long long)min(c, ncl - 1) * 2 * slots;
      vs[c] = c < ncl ? __ldcg(row + e) : 0.f;
      vc[c] = c < ncl ? __ldcg(row + slots + e) : 0.f;
    }
    int a, b;
    if (!slot_entry(e, T, D, plan, a, b)) continue;
    const float lo = acc_in != nullptr ? acc_in[a * D + b] : 0.f;
    const float hi = acc_in != nullptr ? acc_in[b * D + a] : 0.f;
    float sum = 0.f, cmp = 0.f;
#pragma unroll
    for (int c = 0; c < kWideMaxClusters; ++c) {
      if (c >= ncl) break;
      kahan_add(sum, cmp, vs[c]);
      kahan_add(sum, cmp, -vc[c]);
    }
    const float total = sum - cmp;
    G[a * D + b] = acc_in != nullptr ? lo + total : total;
    if (a != b) G[b * D + a] = acc_in != nullptr ? hi + total : total;
  }
  if (tid == 0) tickets[rank] = 0;
}

template <int W>
int launch_tiled_as(const float* X, const float* sw, int n, int D, const TiledPlan& plan,
                    const float* acc, float* G, float* scratch, int* tickets, cudaStream_t st) {
  auto kernel = gram_tiled_kernel<W>;
  const int slots = tiled_slots(W, plan.runs);
  const size_t smem = tiled_smem_bytes(D, slots);
  static bool attr_set = false;
  static int max_clusters[kWideMaxD + 1] = {};  // by D: co-resident clusters of kWideCluster
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tiled_smem_bytes(kWideMaxD, tiled_slots(kWideMaxRunTiles, kWideMaxGroups)));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(32 * plan.runs);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters[D] == 0) {
    cfg.gridDim = dim3(kWideCluster);
    attr[0].val.clusterDim.x = kWideCluster;
    int m = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&m, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (m < 1) return (int)cudaErrorInvalidConfiguration;
    max_clusters[D] = m;
  }
  // CTAs: one a kWideMinRows rows, in one wave of whole clusters
  const int want = max(1, (n + kWideMinRows - 1) / kWideMinRows);
  int C = want, ncl = 1;
  if (want >= kWideCluster) {
    C = kWideCluster;
    ncl = min(min(want / kWideCluster, max_clusters[D]), kWideMaxClusters);
  }
  const int ctas = C * ncl;
  // a span of whole stages, so every stage starts 16-byte aligned for √w
  const int span = ((n + ctas - 1) / ctas + kWideStageRows - 1) / kWideStageRows * kWideStageRows;
  const int vec = D % 4 == 0 ? 4 : (D % 2 == 0 ? 2 : 1);
  cfg.gridDim = dim3(ctas);
  attr[0].val.clusterDim.x = C;
  return (int)cudaLaunchKernelEx(&cfg, kernel, X, sw, n, D, span, vec, plan, acc, G, scratch,
                                 tickets);
}

int launch_tiled(const float* X, const float* sw, int n, int D, const float* acc, float* G,
                 float* scratch, int* tickets, cudaStream_t st) {
  const TiledPlan plan = make_tiled_plan(D);
  // every cluster's row of (sum, compensation) pairs fits the scratch the
  // wrapper allocates (kWideScratchFloats)
  if (plan.runs == 0 || scratch == nullptr || tickets == nullptr ||
      kWideMaxClusters * 2 * tiled_slots(plan.tiles, plan.runs) > kWideScratchFloats)
    return (int)cudaErrorInvalidValue;
  switch (plan.tiles) {
    case 2: return launch_tiled_as<2>(X, sw, n, D, plan, acc, G, scratch, tickets, st);
    case 3: return launch_tiled_as<3>(X, sw, n, D, plan, acc, G, scratch, tickets, st);
    case 4: return launch_tiled_as<4>(X, sw, n, D, plan, acc, G, scratch, tickets, st);
    case 5: return launch_tiled_as<5>(X, sw, n, D, plan, acc, G, scratch, tickets, st);
    case 6: return launch_tiled_as<6>(X, sw, n, D, plan, acc, G, scratch, tickets, st);
    default: return launch_tiled_as<7>(X, sw, n, D, plan, acc, G, scratch, tickets, st);
  }
}


constexpr int kLargeTile = 128;         // G's tiles: kLargeTile × kLargeTile
constexpr int kLargeStageRows = 32;     // rows a stage: four k-steps of eight
constexpr int kLargeStages = 4;         // cp.async ring
constexpr int kLargeThreads = 512;      // 16 warps, 4 × 4, a 32 × 32 warp tile each
constexpr int kLargeCtasPerSm = 1;      // (sums in registers, compensations in shared memory)
constexpr int kLargeLd = kLargeTile + 8;  // floats a staged row of a side: ≡ 8 (mod 32)
constexpr int kLargeMaxSplits = 64;
constexpr int kLargeTileFloats = kLargeTile * kLargeTile;
constexpr int kLargeSideFloats = kLargeStageRows * kLargeLd;
constexpr int kLargeSlots = 32;         // entries a thread: 2 × 4 mma tiles × 4
constexpr size_t kLargeSmemBytes =
    4 * ((size_t)kLargeStages * (2 * kLargeSideFloats + kLargeStageRows) +
         (size_t)kLargeSlots * kLargeThreads);
static_assert(kLargeLd % 32 == 8, "fragment loads of rows t, columns g hit 32 banks");
static_assert(kLargeThreads == 16 * 32 && kLargeTile == 4 * 32, "16 warps of 32 × 32 cover a tile");

// t-th tile of the upper triangle of an nb×nb tile grid, row by row
__device__ __forceinline__ void large_tile_of(int t, int nb, int& bi, int& bj) {
  bi = 0;
  while (t >= nb - bi) {
    t -= nb - bi;
    ++bi;
  }
  bj = bi + t;
}

// The large body's products: tile blockIdx.x over the rows of split
// blockIdx.y, [y·span, (y+1)·span), into its (sum, compensation) planes of
// the scratch, the tile's entries row-major. Warp (wm, wn) = (w / 4, w % 4)
// takes the tile's rows 32·wm.. and columns 32·wn.. in 2 × 4 mma tiles of
// 16 × 8; on a diagonal tile the warps wm > wn lie below the diagonal and do
// nothing. D % 4 == 0: rows are staged 16 bytes a copy (ops.py pads X with
// zero columns otherwise). Weighted: sw given.
template <bool Weighted>
__global__ void __launch_bounds__(kLargeThreads, kLargeCtasPerSm)
    gram_large_kernel(const float* __restrict__ X, const float* __restrict__ sw, int n, int D,
                      int span, float* __restrict__ scratch) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                         // stages × (side A, side B) rows
  float* wring = ring + kLargeStages * 2 * kLargeSideFloats;  // stages × rows: √w
  const int nb = (D + kLargeTile - 1) / kLargeTile;
  int bi, bj;
  large_tile_of((int)blockIdx.x, nb, bi, bj);
  const bool diag = bi == bj;  // side B is side A: staged once
  const int a0 = bi * kLargeTile, b0 = bj * kLargeTile;
  const int na = min(kLargeTile, D - a0), nbc = min(kLargeTile, D - b0);  // real columns a side
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const bool busy = !diag || wm <= wn;
  const long long first = (long long)blockIdx.y * span;
  const int row0 = (int)min((long long)n, first);
  const int row_end = (int)min((long long)n, first + span);
  const int nst = (row_end - row0 + kLargeStageRows - 1) / kLargeStageRows;

  // stage s: a side's rows as kLargeTile / 4 pieces, a thread one piece
  // column (no divisions); rows past the span zeroed and their √w 0 (stale
  // shared memory may hold a NaN, and 0·NaN reaches every product)
  auto issue = [&](int s) {
    if (s < nst) {
      const int r0 = row0 + s * kLargeStageRows;
      const int cnt = min(kLargeStageRows, row_end - r0);
      float* dst = ring + (s % kLargeStages) * 2 * kLargeSideFloats;
      const int sides = diag ? 1 : 2;
      constexpr int pl = kLargeTile / 4;  // pieces a row of a side
      const int q = (tid % pl) * 4;
      for (int l = tid / pl; l < sides * kLargeStageRows; l += kLargeThreads / pl) {
        const int side = l / kLargeStageRows, r = l - side * kLargeStageRows;
        float* d = dst + side * kLargeSideFloats + r * kLargeLd + q;
        if (r >= cnt) {
          *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
        } else if (q < (side ? nbc : na)) {
          cp_async16(d, X + (long long)(r0 + r) * D + (side ? b0 : a0) + q);
        }
      }
      if (Weighted && warp == kLargeThreads / 32 - 1) {
        float* wdst = wring + (s % kLargeStages) * kLargeStageRows;
        if (lane < cnt)
          cp_async4(wdst + lane, sw + r0 + lane);
        else
          wdst[lane] = 0.f;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

#pragma unroll
  for (int s = 0; s < kLargeStages - 1; ++s) issue(s);
  // while they land: a side's columns past D are zero in every ring slot
  // and stay so (the copies never touch them)
  for (int i = tid; i < kLargeStages * 2 * kLargeStageRows * kLargeTile; i += kLargeThreads) {
    const int c = i % kLargeTile, line = i / kLargeTile;
    const int side = (line / kLargeStageRows) % 2;
    if (c >= (side ? nbc : na)) ring[line * kLargeLd + c] = 0.f;
  }

  // each stage's sums (the mma's accumulators acc: its 32 rows) go into a
  // compensated (Kahan) pair per entry, the sum in registers and its
  // compensation in shared memory (slot q·kLargeThreads + tid): the tensor
  // core's f32 accumulation is not rounded to nearest, so it sums no more
  // than a stage
  float acc[2][4][4], sum[2][4][4];
  float* comp = wring + kLargeStages * kLargeStageRows;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = sum[i][j][v] = 0.f;
#pragma unroll
  for (int q = 0; q < kLargeSlots; ++q) comp[q * kLargeThreads + tid] = 0.f;
  auto stage_sum = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          float& c = comp[((i * 4 + j) * 4 + v) * kLargeThreads + tid];
          float cc = c;
          kahan_add(sum[i][j][v], cc, acc[i][j][v]);
          c = cc;
          acc[i][j][v] = 0.f;
        }
  };

  for (int s = 0; s < nst; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kLargeStages - 2) : "memory");
    __syncthreads();  // stage s landed for every thread; stage s − 1 is read
    issue(s + kLargeStages - 1);
    if (!busy) continue;
    const float* xa = ring + (s % kLargeStages) * 2 * kLargeSideFloats;
    const float* xb = diag ? xa : xa + kLargeSideFloats;
    const float* ws = wring + (s % kLargeStages) * kLargeStageRows;
#pragma unroll
    for (int k0 = 0; k0 < kLargeStageRows; k0 += 8) {
      // this lane's rows k0 + t and k0 + t + 4; A(i) from side A's columns
      // 32·wm + 16·i + g (+ 8), B(j) from side B's 32·wn + 8·j + g
      const float w0 = Weighted ? ws[k0 + t] : 1.f, w1 = Weighted ? ws[k0 + t + 4] : 1.f;
      const float* a0p = xa + (k0 + t) * kLargeLd + wm * 32 + g;
      const float* b0p = xb + (k0 + t) * kLargeLd + wn * 32 + g;
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* p = a0p + 16 * i;
        split_tf32(Weighted ? p[0] * w0 : p[0], ah[i][0], al[i][0]);
        split_tf32(Weighted ? p[8] * w0 : p[8], ah[i][1], al[i][1]);
        split_tf32(Weighted ? p[4 * kLargeLd] * w1 : p[4 * kLargeLd], ah[i][2], al[i][2]);
        split_tf32(Weighted ? p[4 * kLargeLd + 8] * w1 : p[4 * kLargeLd + 8], ah[i][3],
                   al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split_tf32(Weighted ? b0p[8 * j] * w0 : b0p[8 * j], bh[j][0], bl[j][0]);
        split_tf32(Weighted ? b0p[8 * j + 4 * kLargeLd] * w1 : b0p[8 * j + 4 * kLargeLd],
                   bh[j][1], bl[j][1]);
      }
      // product by product over the 8 tiles, so 8 independent mma lie
      // between two into one accumulator: the two small products first
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], bh[j][0], bh[j][1]);
    }
    stage_sum();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (!busy) return;
  // the CTA's (sum, compensation) pair of each entry, row-major in the tile
  float* part = scratch + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * 2 * kLargeTileFloats;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = (wm * 32 + i * 16 + g + 8 * h) * kLargeTile + wn * 32 + j * 8 + 2 * t;
        const int q = (i * 4 + j) * 4 + 2 * h;
        *reinterpret_cast<float2*>(part + e) = make_float2(sum[i][j][2 * h], sum[i][j][2 * h + 1]);
        *reinterpret_cast<float2*>(part + kLargeTileFloats + e) =
            make_float2(comp[q * kLargeThreads + tid], comp[(q + 1) * kLargeThreads + tid]);
      }
}

// The large body's fold: entry (a, b ≥ a) of G summed over the splits in
// split order, compensated; acc added last; both triangles written.
__global__ void __launch_bounds__(256)
    gram_large_fold_kernel(const float* __restrict__ scratch, int D, int splits,
                           const float* __restrict__ acc, float* __restrict__ G) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)D * D) return;
  const int a = (int)(e / D), b = (int)(e % D);
  if (a > b) return;
  const int nb = (D + kLargeTile - 1) / kLargeTile, ntiles = nb * (nb + 1) / 2;
  const int bi = a / kLargeTile, bj = b / kLargeTile;
  const int t = bi * nb - bi * (bi - 1) / 2 + bj - bi;
  const int local = (a % kLargeTile) * kLargeTile + b % kLargeTile;
  float sum = 0.f, cmp = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const float* part = scratch + ((long long)sp * ntiles + t) * 2 * kLargeTileFloats;
    kahan_add(sum, cmp, part[local]);
    kahan_add(sum, cmp, -part[kLargeTileFloats + local]);
  }
  const float total = sum - cmp;
  const long long ab = (long long)a * D + b, ba = (long long)b * D + a;
  G[ab] = acc != nullptr ? acc[ab] + total : total;
  if (a != b) G[ba] = acc != nullptr ? acc[ba] + total : total;
}

template <bool Weighted>
int launch_large_as(const float* X, const float* sw, int n, int D, int splits, const float* acc,
                    float* G, float* scratch, cudaStream_t st) {
  auto kernel = gram_large_kernel<Weighted>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kLargeSmemBytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int nb = (D + kLargeTile - 1) / kLargeTile;
  const int span = ((n + splits - 1) / splits + kLargeStageRows - 1) / kLargeStageRows *
                   kLargeStageRows;  // whole stages
  kernel<<<dim3(nb * (nb + 1) / 2, splits), kLargeThreads, kLargeSmemBytes, st>>>(
      X, sw, n, D, span, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long entries = (long long)D * D;
  gram_large_fold_kernel<<<(unsigned)((entries + 255) / 256), 256, 0, st>>>(scratch, D, splits,
                                                                           acc, G);
  return (int)cudaGetLastError();
}

int launch_large(const float* X, const float* sw, int n, int D, int splits, const float* acc,
                 float* G, float* scratch, cudaStream_t st) {
  if (D % 4 != 0 || splits < 1 || splits > kLargeMaxSplits || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  return sw != nullptr ? launch_large_as<true>(X, sw, n, D, splits, acc, G, scratch, st)
                       : launch_large_as<false>(X, sw, n, D, splits, acc, G, scratch, st);
}

}  // namespace

// X (n, D) f32 and sw (n,) f32 or null (all ones), both with 16-byte
// aligned bases, acc (D, D) f32 or null (zeros) → G = acc + (√w·X)ᵀ(√w·X),
// (D, D) f32. G must not alias X, sw or acc. D ≤ 64: the cluster body,
// which reads neither scratch nor tickets. 64 < D ≤ 160 (the tiled body):
// scratch kWideScratchFloats f32 of device memory, tickets kWideCluster
// int32 that are 0 (the kernel leaves them 0). D > 160 (the large body,
// D % 4 == 0): `splits` row spans (ops.py:large_plan) and scratch of splits ·
// nb(nb+1)/2 · 2 · kLargeTile² f32, nb = ⌈D/kLargeTile⌉; two launches.
REPRO_EXPORT int repro_gram(const void* X, const void* sw, int n, int D, const void* acc,
                            void* G, void* scratch, void* tickets, int splits, void* stream) {
  if (D <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (D > kWideMaxD)
    return launch_large((const float*)X, (const float*)sw, n, D, splits, (const float*)acc,
                        (float*)G, (float*)scratch, (cudaStream_t)stream);
  if (D > kMaxD)
    return launch_tiled((const float*)X, (const float*)sw, n, D, (const float*)acc, (float*)G,
                        (float*)scratch, (int*)tickets, (cudaStream_t)stream);
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

// The tiled body's plan of D (64 < D ≤ 160), as make_tiled_plan builds it:
// out (2 + 4·kWideMaxGroups int32) gets runs, the run width W, then (i0, j0,
// split, cnt) of each run. Host only; for the tests and the logs.
REPRO_EXPORT int repro_gram_tiled_plan(int D, void* out) {
  const TiledPlan plan = make_tiled_plan(D);
  if (plan.runs == 0 || out == nullptr) return (int)cudaErrorInvalidValue;
  int* o = (int*)out;
  o[0] = plan.runs;
  o[1] = plan.tiles;
  for (int k = 0; k < plan.runs; ++k) {
    o[2 + 4 * k] = plan.i0[k];
    o[3 + 4 * k] = plan.j0[k];
    o[4 + 4 * k] = plan.split[k];
    o[5 + 4 * k] = plan.cnt[k];
  }
  return 0;
}
