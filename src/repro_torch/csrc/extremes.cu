// Directional extremes: per direction, (max, argmax, min, argmin) of
// dirs @ Pᵀ over the valid rows of P, first occurrence on ties.
//
// Replaces: src/repro/kernels/extremes/kernel.py:extremes_kernel (the TPU
// kernel folds each row block's MXU score tile into running extremes held
// in revisited VMEM blocks, in grid order).
//
// Bound on the H100: f32 FMA work, m·rows·d multiply-adds (2·1,614·32,768·7
// ≈ 0.74 GFLOP at k = 2000, ≈ 11 µs at 67 TFLOP/s); P itself is under 1 MB.
// Design (common.cuh, block_extremes): rows are cut into blocks of rb rows
// (blockIdx.x), sized by the wrapper so the grid is about two CTAs per SM,
// and directions into CTA rows of warps·128 (blockIdx.y). A CTA stages its
// block padded to 8 floats a row (two 16-byte broadcast loads), each thread
// holds 4 directions in registers, so a staged row feeds 28 FMAs, and the
// inner loop keeps only fmaxf/fminf over 16-row tiles. A second launch
// folds the per-block partials by (value, lowest row), 32 directions a CTA
// reading them coalesced, and rescans each direction's one winning tile, a
// row a lane, for the first row that attains the extreme. The scores keep
// the FMA chain of common.cuh:dir_score, so values and indices are
// bit-identical to the plain version's. (A rescan in the score CTAs, each
// lane on its own tile, cost as much as the main loop: its shared-memory
// reads conflict.) Rows at or past n_valid are never scored, which is what
// scoring them ∓inf does.
//
// The wide body (d > REPRO_MAX_DP, any d): a SIMT product of a register-
// tiled output, directions × rows. The template body holds a row and 4
// directions of DP coordinates in registers, which no runtime d allows; here
// the coordinates stream through shared memory. Bound: f32 FMA work, m·rows·d
// multiply-adds (2·16,384·1,614·70 ≈ 3.7 GFLOP at d = 70, 55 µs at 67
// TFLOP/s); the scores must keep dir_score's fmaf chain in coordinate order
// (the plain version's bits), so neither the coordinates nor a tensor core
// can share the work, and the design is a SIMT GEMM whose every output is
// one chain:
//
//  - Two tiles (extremes/ops.py:wide_launch_plan): tile 0, 128 directions ×
//    128 rows (8 warps, 4 × 2), where a lane holds 8 directions × 8 rows of
//    partial scores (64 chains), its directions 4 apart and its rows 8
//    apart, so the 16-byte shared reads of a warp touch 4 and 8 consecutive
//    lines; no direction past m is staged, and a warp whose 32 directions
//    all lie past m does no work. Tile 1, for m = 1 (the greedy hull walk):
//    one direction × 128 rows, 4 warps, a lane a row. (A 64 × 256 tile for
//    m that leave tile 0's last warps idle lost to tile 0 at every shape
//    timed, 1.25–1.41× at d 32 × 1,704 and d 70 × 130.)
//  - An asynchronous ring: slices of kExtWideK coordinates of the CTA's
//    rows and directions, kExtWideStages deep, copied with 16-, 8- or 4-byte
//    cp.async (as d and the bases allow), so a slice lands while the slices
//    before it are summed. A staged line is kExtWideLd = kExtWideK + 4 floats
//    (≡ 4 mod 32): 8 consecutive lines' 16-byte reads hit 32 banks.
//  - A CTA walks its block of rows one tile at a time, the ring running on
//    across tiles, so the next tile's first slices land under this one's
//    last; the plan sizes blocks for whole waves of CTAs.
//  - The chain: each score starts at −0, so the first fmaf is the product
//    d₀p₀ to the bit, and takes the coordinates in order, 4 a step; the last
//    slice stops at the first multiple of 4 past d, its pad columns −0 in
//    the rows and +0 in the directions, whose product −0 leaves any carry's
//    bits as they are.
//  - After a tile's last slice each lane keeps, per direction, the first of
//    its rows attaining each extreme; the lanes that share a direction fold
//    theirs by (value, lowest row) with shuffles, and the warp's running
//    extremes over its tiles (ascending rows, strict comparisons) live in
//    shared memory. At the end the warps along the rows fold theirs by
//    (value, lowest row), so a CTA writes its exact rows as one partial a
//    row block (fewer partials to fold: at m = 1 the fold of 4 a block took
//    more time than the scores); the fold launch is the template body's at
//    runtime width, with no rescan (the partial's row attains the extreme).
#include "common.cuh"

// The wide body's tiles and ring; kernels/_lib.py:CUDA_CONSTANTS mirrors
// the ones the wrapper's plan reads (extremes/ops.py:wide_launch_plan).
constexpr int kExtWideK = 32;            // coordinates a slice
constexpr int kExtWideLd = kExtWideK + 4;  // floats a staged line: ≡ 4 (mod 32)
constexpr int kExtWideStages = 3;        // the cp.async ring
constexpr int kExtWideRd = 8;            // directions a lane (tile 0)
constexpr int kExtWideRr = 8;            // rows a lane
constexpr int kExtWideTileDirs = 128;    // tile 0: 128 directions × 128 rows
constexpr int kExtWideTileRows = 128;
constexpr int kExtWideCtasPerSm = 2;     // CTAs of tile 0 an SM holds (≤ 128 registers)
constexpr int kExtWideOneWarps = 4;      // tile 1 (m = 1): 32·kExtWideOneWarps rows, a lane a row
constexpr int kExtWideOneCtasPerSm = 4;
static_assert(kExtWideLd % 8 == 4 && kExtWideK % 4 == 0, "conflict-free float4 lines");
static_assert(kExtWideTileDirs == 4 * 4 * kExtWideRd && kExtWideTileRows == 2 * 8 * kExtWideRr,
              "tile 0: 4 × 2 warps of 32 directions × 64 rows");

namespace {

template <int DP>
__global__ void __launch_bounds__(kExtMaxWarps * 32, kExtCtasPerSm) extremes_score_kernel(
    const float* __restrict__ P, int rows, int n_valid, int rb, const float* __restrict__ dirs,
    int m, int warps, float* __restrict__ pvmax, int* __restrict__ pimax,
    float* __restrict__ pvmin, int* __restrict__ pimin) {
  extern __shared__ __align__(16) float tile[];
  const int base = blockIdx.x * rb, cnt = min(rb, rows - base);
  stage_rows<DP>(P, base, cnt, tile);
  __syncthreads();
  score_block<DP>(tile, base, cnt, n_valid, dirs, m, warps, blockIdx.x,
                  blockIdx.y * warps * kExtWarpDirs, pvmax, pimax, pvmin, pimin);
}

template <int DP>
__global__ void __launch_bounds__(kExtFoldWarps * 32) extremes_fold_kernel(
    const float* __restrict__ pvmax, const int* __restrict__ pimax,
    const float* __restrict__ pvmin, const int* __restrict__ pimin, int nblk, int m,
    const float* __restrict__ P, int rows, const float* __restrict__ dirs,
    float* __restrict__ vmax, int* __restrict__ imax, float* __restrict__ vmin,
    int* __restrict__ imin) {
  __shared__ float red[4 * kExtFoldWarps * 32];
  extremes_fold_cta<DP>(pvmax, pimax, pvmin, pimin, nblk, m, blockIdx.x * kExtFoldDirs, P, rows,
                        dirs, red, vmax, imax, vmin, imin);
}

// One slice's products of a lane's RD directions × RR rows, kq float4
// steps of coordinates (4 in a full slice), each score's chain in
// coordinate order. sd: the lane's first direction line, its others LD
// lines apart; sr: its first row line, its others LR lines apart.
template <int RD, int RR, int LD, int LR>
__device__ __forceinline__ void wide_products(const float* __restrict__ sd,
                                              const float* __restrict__ sr, int kq,
                                              float (&acc)[RD][RR]) {
#pragma unroll
  for (int q = 0; q < kExtWideK / 4; ++q) {
    if (q >= kq) break;
    float4 dv[RD];
#pragma unroll
    for (int i = 0; i < RD; ++i)
      dv[i] = *reinterpret_cast<const float4*>(sd + i * LD * kExtWideLd + 4 * q);
#pragma unroll
    for (int j = 0; j < RR; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(sr + j * LR * kExtWideLd + 4 * q);
#pragma unroll
      for (int i = 0; i < RD; ++i) {
        float s = acc[i][j];
        s = fmaf(dv[i].x, p.x, s);
        s = fmaf(dv[i].y, p.y, s);
        s = fmaf(dv[i].z, p.z, s);
        s = fmaf(dv[i].w, p.w, s);
        acc[i][j] = s;
      }
    }
  }
}

// A stage's copies: columns [0, kc) of nd direction lines (from pdir, d
// apart) and nr row lines (from prow) into lines 0.. and TD.. of st, V
// floats a cp.async; a thread keeps one column piece, so no division.
template <int V, int T, int TD>
__device__ __forceinline__ void wide_stage_lines(float* __restrict__ st,
                                                 const float* __restrict__ pdir,
                                                 const float* __restrict__ prow, int d, int nd,
                                                 int nr, int kc) {
  constexpr int PL = kExtWideK / V;  // pieces a line
  static_assert(T % PL == 0, "whole lines a pass");
  const int q = (int)(threadIdx.x % PL) * V;
  if (q >= kc) return;
  for (int l = (int)threadIdx.x / PL; l < nd + nr; l += T / PL) {
    const bool dir = l < nd;
    const float* src = (dir ? pdir + (long long)l * d : prow + (long long)(l - nd) * d) + q;
    float* dst = st + (dir ? l : TD + l - nd) * kExtWideLd + q;
    if constexpr (V == 4)
      cp_async16(dst, src);
    else if constexpr (V == 2)
      cp_async8(dst, src);
    else
      cp_async4(dst, src);
  }
}

// The wide body. A CTA of WD × WR warps takes directions blockIdx.y·TD..
// (TD = WD·LD·RD) over its block blockIdx.x of rb rows (whole tiles of TR =
// WR·(32/LD)·RR rows); warp (wd, wr) takes directions wd·LD·RD.. and rows
// wr·(32/LD)·RR.. of each tile, lane (ld, lr) directions ld + LD·i and rows
// lr + (32/LD)·j. The CTA's partials at [blockIdx.x·m + dir].
// vec: floats a cp.async (it divides d; the bases are 4·vec-byte aligned).
template <int WD, int WR, int LD, int RD, int RR, int MINB>
__global__ void __launch_bounds__(WD * WR * 32, MINB) extremes_wide_kernel(
    const float* __restrict__ P, int rows, int d, int n_valid, int rb,
    const float* __restrict__ dirs, int m, int vec, float* __restrict__ pvmax,
    int* __restrict__ pimax, float* __restrict__ pvmin, int* __restrict__ pimin) {
  constexpr int LR = 32 / LD, T = WD * WR * 32;
  constexpr int WDIRS = LD * RD, WROWS = LR * RR;  // a warp's tile
  constexpr int TD = WD * WDIRS, TR = WR * WROWS;  // the CTA's
  constexpr int kStage = (TD + TR) * kExtWideLd;   // floats a stage: direction lines, then rows
  constexpr int kNone = 0x7fffffff;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wd = warp % WD, wr = warp / WD, ld = lane % LD, lr = lane / LD;
  // the warp's running extremes over its tiles, a word of each a direction
  float* rvmax = smem + kExtWideStages * kStage + warp * 4 * WDIRS;
  float* rvmin = rvmax + WDIRS;
  int* rimax = reinterpret_cast<int*>(rvmin + WDIRS);
  int* rimin = rimax + WDIRS;
  const int base = blockIdx.x * rb;
  const int nv = max(0, min(min(rb, rows - base), n_valid - base));  // the block's scored rows
  const int dir0 = blockIdx.y * TD;
  const int nd = min(TD, m - dir0);  // the CTA's directions, ≥ 1
  const bool busy = wd * WDIRS < nd;  // the warp has a direction
  const int nsl = (d + kExtWideK - 1) / kExtWideK;
  const int total = (nv + TR - 1) / TR * nsl;  // stages: slices of tiles

  // stage s: slice s % nsl of tile s / nsl; only lines of real directions
  // and scored rows are copied; the last slice's pad columns are written
  auto issue = [&](int s) {
    if (s < total) {
      const int t = s / nsl, k0 = (s - t * nsl) * kExtWideK;
      const int kc = min(kExtWideK, d - k0);
      const int nr = min(TR, nv - t * TR);
      const float* pdir = dirs + (long long)dir0 * d + k0;
      const float* prow = P + (long long)(base + t * TR) * d + k0;
      float* st = smem + (s % kExtWideStages) * kStage;
      if (vec == 4)
        wide_stage_lines<4, T, TD>(st, pdir, prow, d, nd, nr, kc);
      else if (vec == 2)
        wide_stage_lines<2, T, TD>(st, pdir, prow, d, nd, nr, kc);
      else
        wide_stage_lines<1, T, TD>(st, pdir, prow, d, nd, nr, kc);
      const int pad = ((kc + 3) & ~3) - kc;
      if (pad)
        for (int c = tid; c < (TD + TR) * pad; c += T) {
          const int l = c / pad;
          st[l * kExtWideLd + kc + c - l * pad] = l < TD ? 0.f : -0.f;
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  for (int k = lane; k < WDIRS; k += 32) {
    rvmax[k] = -CUDART_INF_F;
    rvmin[k] = CUDART_INF_F;
    rimax[k] = rimin[k] = base;
  }
#pragma unroll
  for (int s = 0; s < kExtWideStages - 1; ++s) issue(s);
  const float* sd = smem + (wd * WDIRS + ld) * kExtWideLd;
  const float* sr = smem + (TD + wr * WROWS + lr) * kExtWideLd;
  float acc[RD][RR];
  for (int s = 0; s < total; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kExtWideStages - 2) : "memory");
    __syncthreads();  // stage s landed for every thread; stage s − 1 is read
    issue(s + kExtWideStages - 1);
    const int t = s / nsl, ks = s - t * nsl;
    const int w0 = t * TR + wr * WROWS;  // the warp's first row of tile t, in the block
    if (!busy || w0 >= nv) continue;     // uniform across the warp
    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < RD; ++i)
#pragma unroll
        for (int j = 0; j < RR; ++j) acc[i][j] = -0.f;
    }
    const int off = (s % kExtWideStages) * kStage;
    wide_products<RD, RR, LD, LR>(sd + off, sr + off, (min(kExtWideK, d - ks * kExtWideK) + 3) >> 2,
                                  acc);
    if (ks != nsl - 1) continue;
    // tile t's extremes: each lane's first row attaining them (ascending
    // rows, strict comparisons), folded over the lanes sharing a direction
    // by (value, lowest row), then into the warp's running extremes
#pragma unroll
    for (int i = 0; i < RD; ++i) {
      float hx = -CUDART_INF_F, hn = CUDART_INF_F;
      int jx = kNone, jn = kNone;
#pragma unroll
      for (int j = 0; j < RR; ++j) {
        const int row = w0 + lr + LR * j;
        if (row < nv) {
          if (acc[i][j] > hx) {
            hx = acc[i][j];
            jx = base + row;
          }
          if (acc[i][j] < hn) {
            hn = acc[i][j];
            jn = base + row;
          }
        }
      }
#pragma unroll
      for (int o = LD; o < 32; o <<= 1) {
        const float vx = __shfl_xor_sync(0xffffffffu, hx, o);
        const float vn = __shfl_xor_sync(0xffffffffu, hn, o);
        const int ix = __shfl_xor_sync(0xffffffffu, jx, o);
        const int in = __shfl_xor_sync(0xffffffffu, jn, o);
        if (beats_max(vx, ix, hx, jx)) {
          hx = vx;
          jx = ix;
        }
        if (beats_min(vn, in, hn, jn)) {
          hn = vn;
          jn = in;
        }
      }
      if (lr == 0) {
        const int k = ld + LD * i;
        if (hx > rvmax[k]) {
          rvmax[k] = hx;
          rimax[k] = jx;
        }
        if (hn < rvmin[k]) {
          rvmin[k] = hn;
          rimin[k] = jn;
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // every warp's running extremes are in shared memory
  // the CTA's partial: warp (wd, 0) folds those of warps (wd, 0..WR) by
  // (value, lowest row)
  if (wr != 0) return;
  for (int k = lane; k < WDIRS; k += 32) {
    const int dir = dir0 + wd * WDIRS + k;
    if (dir >= m) continue;
    float bx = rvmax[k], bn = rvmin[k];
    int jx = rimax[k], jn = rimin[k];
#pragma unroll
    for (int r = 1; r < WR; ++r) {
      const float* ov = rvmax + r * WD * 4 * WDIRS;  // warp (wd, r)'s
      const int* oi = reinterpret_cast<const int*>(ov + 2 * WDIRS);
      if (beats_max(ov[k], oi[k], bx, jx)) {
        bx = ov[k];
        jx = oi[k];
      }
      if (beats_min(ov[WDIRS + k], oi[WDIRS + k], bn, jn)) {
        bn = ov[WDIRS + k];
        jn = oi[WDIRS + k];
      }
    }
    const long long o = (long long)blockIdx.x * m + dir;
    pvmax[o] = bx;
    pimax[o] = jx;
    pvmin[o] = bn;
    pimin[o] = jn;
  }
}

template <int WD, int WR, int LD, int RD, int RR, int MINB>
int launch_wide_as(const float* P, int rows, int d, int n_valid, int rb, const float* dirs, int m,
                   int vec, float* pvmax, int* pimax, float* pvmin, int* pimin, cudaStream_t st) {
  constexpr int TD = WD * LD * RD, TR = WR * (32 / LD) * RR, T = WD * WR * 32;
  auto kernel = extremes_wide_kernel<WD, WR, LD, RD, RR, MINB>;
  constexpr size_t smem =
      sizeof(float) * ((size_t)kExtWideStages * (TD + TR) * kExtWideLd + 4 * (T / 32) * LD * RD);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  if (rb % TR != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((rows + rb - 1) / rb, (m + TD - 1) / TD);
  kernel<<<grid, T, smem, st>>>(P, rows, d, n_valid, rb, dirs, m, vec, pvmax, pimax, pvmin, pimin);
  return (int)cudaGetLastError();
}

// The wide body's launch for tile `tile` (wide_launch_plan): 0 = 128
// directions × 128 rows, 1 = one direction (m = 1) × 128 rows.
int launch_wide(int tile, const float* P, int rows, int d, int n_valid, int rb, const float* dirs,
                int m, float* pvmax, int* pimax, float* pvmin, int* pimin, cudaStream_t st) {
  const uintptr_t bases = (uintptr_t)P | (uintptr_t)dirs;
  const int vec = d % 4 == 0 && bases % 16 == 0 ? 4 : (d % 2 == 0 && bases % 8 == 0 ? 2 : 1);
#define REPRO_WIDE(WD, WR, LD, RD, RR, MINB)                                                     \
  return launch_wide_as<WD, WR, LD, RD, RR, MINB>(P, rows, d, n_valid, rb, dirs, m, vec, pvmax, \
                                                  pimax, pvmin, pimin, st)
  if (tile == 0) REPRO_WIDE(4, 2, 4, kExtWideRd, kExtWideRr, kExtWideCtasPerSm);
  REPRO_WIDE(1, kExtWideOneWarps, 1, 1, 1, kExtWideOneCtasPerSm);
#undef REPRO_WIDE
}

}  // namespace

// P (rows, dp) f32, dirs (m, dp) f32, n_valid ≤ rows → vmax, vmin (m,) f32
// and imax, imin (m,) i32 row ids into P, in two launches: the score CTAs,
// then the fold. The plan comes from the wrapper (extremes/ops.py).
// dp ≤ REPRO_MAX_DP (the template body): rb rows a block (a multiple of
// kExtTile, ≤ kExtMaxBlockRows) and `shape` warps of kExtWarpDirs
// directions a CTA (1–kExtMaxWarps), launch_plan. dp > REPRO_MAX_DP (the
// wide body): `shape` the tile (launch_wide), rb a multiple of its rows,
// wide_launch_plan. Either way nblk = ceil(rows/rb) partials.
// Scratch: fscratch (2·nblk·m f32) and iscratch (2·nblk·m i32).
REPRO_EXPORT int repro_extremes(const void* P, int rows, int dp, int n_valid, const void* dirs,
                                int m, int rb, int shape, void* fscratch, void* iscratch,
                                void* vmax, void* imax, void* vmin, void* imin, void* stream) {
  const bool wide = dp > REPRO_MAX_DP;
  const int warps = shape;
  if (rows < 0 || m <= 0 || dp <= 0 || rb <= 0 ||
      (wide ? shape < 0 || shape > 1 || (shape == 1 && m != 1)
            : (rb > kExtMaxBlockRows || rb % kExtTile != 0 || warps < 1 || warps > kExtMaxWarps)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nblk = (rows + rb - 1) / rb;
  float* pvmax = (float*)fscratch;
  float* pvmin = pvmax + (long long)nblk * m;
  int* pimax = (int*)iscratch;
  int* pimin = pimax + (long long)nblk * m;
  const dim3 fold_grid((m + kExtFoldDirs - 1) / kExtFoldDirs);
  if (wide) {
    if (nblk > 0) {
      const int err = launch_wide(shape, (const float*)P, rows, dp, n_valid, rb,
                                  (const float*)dirs, m, pvmax, pimax, pvmin, pimin, st);
      if (err != 0) return err;
    }
    extremes_fold_kernel<0><<<fold_grid, kExtFoldWarps * 32, 0, st>>>(
        pvmax, pimax, pvmin, pimin, nblk, m, (const float*)P, rows, (const float*)dirs,
        (float*)vmax, (int*)imax, (float*)vmin, (int*)imin);
    return (int)cudaGetLastError();
  }
  if (nblk > 0) {
    const dim3 grid(nblk, ext_row_warps(m, warps));
    const int threads = max(128, warps * 32);  // ≤ 416
    const size_t smem = sizeof(float) * rb * pad4(dp);
    REPRO_DISPATCH_DP(dp, extremes_score_kernel<DP><<<grid, threads, smem, st>>>(
        (const float*)P, rows, n_valid, rb, (const float*)dirs, m, warps, pvmax, pimax, pvmin,
        pimin));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  REPRO_DISPATCH_DP(dp, extremes_fold_kernel<DP><<<fold_grid, kExtFoldWarps * 32, 0, st>>>(
      pvmax, pimax, pvmin, pimin, nblk, m, (const float*)P, rows, (const float*)dirs,
      (float*)vmax, (int*)imax, (float*)vmin, (int*)imin));
  return (int)cudaGetLastError();
}
