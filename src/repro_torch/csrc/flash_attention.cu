// Causal or non-causal online-softmax (flash) attention with GQA.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:flash_attention_kernel
// (wrapper ops.py:flash_attention). The TPU kernel takes (B·H, S, d) after
// its wrapper materialises jnp.repeat of k/v and a transpose, and needs S to
// divide into blocks. Here q (B, S, H, d) and k, v (B, S, KV, d) are read
// through their strides, q-head h reads KV head h / (H/KV), and the ragged S
// edge is masked in the kernel. Scores, running max, running sum and the
// accumulator are f32; the output is in the input dtype; scale d^-0.5.
//
// Bound on the H100 at the serve path's prefill (1, 1024, 32, 64) bf16: the
// causal work is 2·B·H·S²·d ≈ 4.30 GFLOP (≈ 4.35 µs at the 989 TFLOP/s bf16
// tensor-core peak); the bytes are ≈ 9.4 MB (≈ 2.8 µs). Operations bound it,
// and only wgmma reaches that tensor-core rate. At recurrentgemma's prefill
// (1, 1024, 10, 256), one KV head: ≈ 5.37 GFLOP (≈ 5.4 µs), ≈ 11.5 MB; at
// phi-3-vision's (1, 1280, 32, 96): ≈ 10.1 GFLOP (≈ 10.2 µs), ≈ 31.5 MB.
//
// Three bodies behind one entry point, for d ≤ kFlashMaxD (256):
//  - bf16 with d ∈ {64, 96, 128, 256} (the zoo's heads): wgmma, fed by TMA.
//    One CTA of three warpgroups per (b·h, 128-row q tile). Warpgroup 2
//    drops to 24 registers (setmaxnreg) so that the two consumer
//    warpgroups can hold 240 each; one of its threads loads Q once and
//    keeps K and V tiles of KT keys in flight through a two-stage ring of
//    mbarriers (KT = 128; KT = 64 at d = 256, where a 128-key ring would
//    need 320 KiB of shared memory with the 64-KiB Q tile, and 64 keys fit
//    in 192 KiB), with TMA boxes of 64 columns in the 128-byte swizzle that
//    the wgmma descriptors read (4-D tensor maps over the strided GQA
//    views, encoded per call through cudaGetDriverEntryPoint, passed as
//    __grid_constant__). Each consumer warpgroup owns 64 q rows: S = QKᵀ is
//    wgmma m64nKTk16 from shared memory, the online softmax runs on S in
//    registers, and P, rounded to bf16, is the register A operand of
//    O += PV (one m64n64k16 per 64-column chunk of O), with V read MN-major
//    (the transpose bit), so V needs no transposed copy. At d = 256 a
//    consumer thread holds 128 f32 of O, 32 of S and 16 words of P. The
//    mask is applied only on the tiles that the diagonal or the ragged end
//    crosses. The epilogue writes O in bf16 into the freed Q tile in the
//    same 128-byte swizzle and stores it with one TMA box a chunk (a 4-D
//    map of the output): rows past S and columns past d are not written.
//    Against each thread's 4-byte stores of its fragments, it took a lone
//    4-key-tile CTA at d = 256 from 13.25 to 10.96 µs (PERF.md §6).
//    d = 96 (phi-3-vision) pads to two chunks without a padded copy: the
//    maps span the real 96 columns (q, k and v are views of one fused
//    projection, so columns 96–127 of a head are the next head's), TMA
//    writes zeros past them and counts the whole box; S = QKᵀ takes the
//    six k16 steps that hold data, O's second chunk is one m64n32k16 on the
//    first 64 bytes of each 128-byte swizzled V row, and the TMA store
//    stops at column 96. The scale is the caller's d^-0.5 of the real width.
//    Where the grid of q tiles leaves SMs idle (recurrentgemma's and
//    gemma-2b's 10 and 8 heads at d = 256: 80 and 64 CTAs on 132 SMs, and
//    under the causal mask the last q tile walks 16 key tiles, 2.9× and
//    3.7× an even share), the heaviest q tiles' key ranges split in two:
//    each part is a CTA of its own, at most `cap` key tiles, cap the least
//    that keeps every CTA in one wave of one CTA an SM (ops.split_plan,
//    from the SM count). The part that finishes first (an integer ticket)
//    writes its unnormalised f32 O, row max and row sum to a workspace; the
//    other copies that O into its shared memory with cp.async and merges it
//    into its registers in part order, O = w_1·O_1 + w_0·O_0 as one fma (no
//    float atomics: the same inputs give the same bits), then stores O.
//  - bf16 with d ∈ {16, 32}: tensor cores through mma.sync m16n8k16 (bf16
//    in, f32 accumulate). One CTA of four warps per (b·h, 64-row q tile);
//    each warp owns 16 q rows whose Q fragments stay in registers. K and V
//    tiles of 64 keys are staged in shared memory (rows padded by 8 bf16,
//    so the fragment loads hit 32 distinct banks); S = QKᵀ stays in
//    registers and P is re-packed in registers as the A operand of PV (the
//    FlashAttention-2 register layout).
//  - everything else (f32, or another d): plain f32 FMA. Up to d = 128 two
//    threads per q row, each holding every other dimension of q and of the
//    accumulator, K and V tiles of 32 keys in shared memory as f32 (32 KiB).
//    Past 128 four threads a row (64 dimensions of q and of the accumulator
//    each, so nothing spills) and tiles of 16 keys, which keep the tiles in
//    the same 32 KiB of static shared memory.
// The tensor-core bodies run the softmax in the log2 domain and round its
// weights to bf16 for the PV product, as every bf16 flash kernel does; the
// running sum takes them in f32. Every body skips key tiles above the
// diagonal and launches the q tiles (or parts) with the most key tiles
// first.
#include <cuda.h>  // CUtensorMap and its enums (libcuda itself is not linked)
#include <stdint.h>

#include "common.cuh"

namespace {

struct Strides {
  long long b, s, h;  // elements; the d stride is 1
};

constexpr int kFlashMaxD = 256;  // the widest head any body takes
constexpr int kMmaRows = 64;     // q rows per CTA (4 warps × 16)
constexpr int kMmaKeys = 64;     // keys per staged tile
constexpr int kMmaThreads = 128;
constexpr int kSimtThreads = 128;

__device__ __forceinline__ uint32_t load_q_pair(const __nv_bfloat16* base, int row, int col, int S,
                                                long long stride) {
  return row < S ? *reinterpret_cast<const uint32_t*>(base + (long long)row * stride + col) : 0u;
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
    flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
                     int H, int KV, Strides qs, Strides ks, Strides vs, float scale_log2,
                     int causal) {
  constexpr int kStride = HD + 8;
  __shared__ __align__(16) __nv_bfloat16 Ks[kMmaKeys * kStride];
  __shared__ __align__(16) __nv_bfloat16 Vs[kMmaKeys * kStride];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int qtile = gridDim.y - 1 - blockIdx.y;  // most key tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = qtile * kMmaRows + warp * 16 + g;  // this thread's rows r0, r0 + 8
  const int r1 = r0 + 8;

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + kvh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kvh * vs.h;

  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qa[kk][0] = load_q_pair(qb, r0, c, S, qs.s);
    qa[kk][1] = load_q_pair(qb, r1, c, S, qs.s);
    qa[kk][2] = load_q_pair(qb, r0, c + 8, S, qs.s);
    qa[kk][3] = load_q_pair(qb, r1, c + 8, S, qs.s);
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  float m0 = -1e30f, m1 = -1e30f;  // running max of rows r0, r1 (log2 domain)
  float l0 = 0.f, l1 = 0.f;        // this thread's share of the running sums

  const int n_kv = (S + kMmaKeys - 1) / kMmaKeys;
  const int n_tiles = causal ? min(n_kv, qtile + 1) : n_kv;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kMmaKeys;
    __syncthreads();
    constexpr int kVecs = HD / 8;  // 16-byte vectors per row
    for (int i = threadIdx.x; i < kMmaKeys * kVecs; i += kMmaThreads) {
      const int r = i / kVecs, c = (i % kVecs) * 8;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < S) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * ks.s + c);
        vv4 = *reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * vs.s + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r * kStride + c]) = kv4;
      *reinterpret_cast<uint4*>(&Vs[r * kStride + c]) = vv4;
    }
    __syncthreads();

    // S = Q Kᵀ for this warp's 16 rows × 64 keys
    float s[kMmaKeys / 8][4];
#pragma unroll
    for (int nb = 0; nb < kMmaKeys / 8; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const __nv_bfloat16* kr = &Ks[(nb * 8 + g) * kStride + kk * 16 + t4 * 2];
        mma_16816(s[nb], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                  *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // mask, scale, online softmax (rows r0: entries 0,1; r1: entries 2,3)
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int nb = 0; nb < kMmaKeys / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nb * 8 + t4 * 2 + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const bool ok = key < S && (!causal || key <= row);
        s[nb][e] = ok ? s[nb][e] * scale_log2 : -CUDART_INF_F;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < kMmaKeys / 8; ++nb) {
      s[nb][0] = exp2f(s[nb][0] - mn0);
      s[nb][1] = exp2f(s[nb][1] - mn0);
      s[nb][2] = exp2f(s[nb][2] - mn1);
      s[nb][3] = exp2f(s[nb][3] - mn1);
      rs0 += s[nb][0] + s[nb][1];
      rs1 += s[nb][2] + s[nb][3];
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      acc[nb][0] *= al0;
      acc[nb][1] *= al0;
      acc[nb][2] *= al1;
      acc[nb][3] *= al1;
    }

    // O += P V: P's accumulator layout is the A operand's, 16 keys per step
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int key = kk * 16 + t4 * 2;
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb) {
        const int col = nb * 8 + g;
        const uint32_t b0 = pack_raw(Vs[key * kStride + col], Vs[(key + 1) * kStride + col]);
        const uint32_t b1 =
            pack_raw(Vs[(key + 8) * kStride + col], Vs[(key + 9) * kStride + col]);
        mma_16816(acc[nb], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const long long row_stride = (long long)H * HD;
  __nv_bfloat16* ob = o + ((long long)b * S * H + h) * HD;
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb) {
    const int col = nb * 8 + t4 * 2;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + r0 * row_stride + col) =
          pack_bf16(acc[nb][0] * inv0, acc[nb][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + r1 * row_stride + col) =
          pack_bf16(acc[nb][2] * inv1, acc[nb][3] * inv1);
  }
}

// TPR threads per q row (ROWS rows per CTA), KEYS keys per staged tile.
template <typename T, int DMAX, int TPR, int KEYS>
__global__ void __launch_bounds__(kSimtThreads)
    flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, int S, int H, int KV, int d, Strides qs, Strides ks,
                      Strides vs, float scale, int causal) {
  constexpr int ROWS = kSimtThreads / TPR;
  constexpr int DH = DMAX / TPR;  // dimensions TPR·i + part of q and acc per thread
  __shared__ float Ks[KEYS * DMAX];
  __shared__ float Vs[KEYS * DMAX];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int qtile = gridDim.y - 1 - blockIdx.y;
  const int part = threadIdx.x % TPR;
  const int row = qtile * ROWS + threadIdx.x / TPR;

  const T* qr = q + b * qs.b + h * qs.h + (long long)row * qs.s;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  float qv[DH], acc[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    const int dim = TPR * i + part;
    qv[i] = (row < S && dim < d) ? to_float(qr[dim]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -1e30f, l = 0.f;

  const int last_key = causal ? min(S, qtile * ROWS + ROWS) : S;
  const int n_tiles = (last_key + KEYS - 1) / KEYS;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * KEYS;
    __syncthreads();
    for (int i = threadIdx.x; i < KEYS * DMAX; i += kSimtThreads) {
      const int r = i / DMAX, c = i % DMAX;
      const bool ok = k0 + r < S && c < d;
      Ks[i] = ok ? to_float(kb[(long long)(k0 + r) * ks.s + c]) : 0.f;
      Vs[i] = ok ? to_float(vb[(long long)(k0 + r) * vs.s + c]) : 0.f;
    }
    __syncthreads();
    float sc[KEYS];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int kk = 0; kk < KEYS; ++kk) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) dot = fmaf(qv[i], Ks[kk * DMAX + TPR * i + part], dot);
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int key = k0 + kk;
      const bool ok = key < S && (!causal || key <= row);
      sc[kk] = ok ? dot * scale : -CUDART_INF_F;
      mx = fmaxf(mx, sc[kk]);
    }
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    m = mn;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DH; ++i) acc[i] *= alpha;
#pragma unroll
    for (int kk = 0; kk < KEYS; ++kk) {
      const float p = expf(sc[kk] - mn);
      l += p;
#pragma unroll
      for (int i = 0; i < DH; ++i) acc[i] = fmaf(p, Vs[kk * DMAX + TPR * i + part], acc[i]);
    }
  }
  if (row >= S) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* orow = o + (((long long)b * S + row) * H + h) * d;
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    const int dim = TPR * i + part;
    if (dim < d) orow[dim] = from_float<T>(acc[i] * inv);
  }
}

template <typename T, int DMAX, int TPR, int KEYS>
void run_simt(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KV,
              int d, Strides qs, Strides ks, Strides vs, float scale, int causal,
              cudaStream_t st) {
  constexpr int kRows = kSimtThreads / TPR;
  const dim3 grid(B * H, (S + kRows - 1) / kRows);
  flash_simt_kernel<T, DMAX, TPR, KEYS><<<grid, kSimtThreads, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, KV, d, qs, ks, vs, scale, causal);
}

template <typename T>
int launch_simt(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KV,
                int d, Strides qs, Strides ks, Strides vs, float scale, int causal,
                cudaStream_t st) {
  if (d <= 16)
    run_simt<T, 16, 2, 32>(q, k, v, o, B, S, H, KV, d, qs, ks, vs, scale, causal, st);
  else if (d <= 32)
    run_simt<T, 32, 2, 32>(q, k, v, o, B, S, H, KV, d, qs, ks, vs, scale, causal, st);
  else if (d <= 64)
    run_simt<T, 64, 2, 32>(q, k, v, o, B, S, H, KV, d, qs, ks, vs, scale, causal, st);
  else if (d <= 128)
    run_simt<T, 128, 2, 32>(q, k, v, o, B, S, H, KV, d, qs, ks, vs, scale, causal, st);
  else
    run_simt<T, kFlashMaxD, 4, 16>(q, k, v, o, B, S, H, KV, d, qs, ks, vs, scale, causal, st);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- wgmma body

constexpr int kWgRows = 128;     // q rows per CTA: two consumer warpgroups × 64
constexpr int kWgKeys = 128;     // keys per staged K/V tile (d ≤ 128)
constexpr int kWgKeysWide = 64;  // keys per staged K/V tile at d = 256
constexpr int kWgStages = 2;     // K/V ring depth
constexpr int kWgThreads = 384;  // warpgroups 0, 1 consume; warpgroup 2 loads
constexpr int kChunk = 64;       // bf16 columns of one 128-byte swizzled chunk
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr int kSplitMaxParts = 2;   // CTAs a q tile's key range splits into at most
constexpr int kSplitMinCap = 4;     // the fewest key tiles a split grid caps a CTA at
constexpr int kPartPad = 8;         // floats that pad a row of a part's O

// Key tiles of KT keys that q tile t (kWgRows rows) walks.
__host__ __device__ __forceinline__ int wg_tiles(int t, int S, int KT, int causal) {
  const int n_kv = (S + KT - 1) / KT;
  const int diag = ((t + 1) * kWgRows + KT - 1) / KT;
  return causal && diag < n_kv ? diag : n_kv;
}

// The split grid: q tile t's key tiles go to ceil(n / cap) CTAs, a near-even
// share each. CTA row y counts q tiles from the last (the heaviest) down,
// their parts in key order; the split tiles (parts > 1) take the first rows
// of y, and part y of them owns slot y of the workspace. Sets the q tile,
// its key-tile range [j0, j1), its part count and which part this is.
__device__ __forceinline__ void wg_part(int y, int S, int KT, int causal, int cap, int& t, int& j0,
                                        int& j1, int& parts, int& part) {
  for (t = (S + kWgRows - 1) / kWgRows - 1;; --t) {
    const int n = wg_tiles(t, S, KT, causal);
    parts = (n + cap - 1) / cap;
    if (y < parts) {
      j0 = y * n / parts;
      j1 = (y + 1) * n / parts;
      part = y;
      return;
    }
    y -= parts;
  }
}

template <int HD, int KT>
struct WgLayout {  // byte offsets in dynamic shared memory, 1,024-aligned tiles
  static constexpr int kChunks = (HD + kChunk - 1) / kChunk;  // 64-column chunks, the last
                                                              // zero-filled past HD
  static constexpr int kQ = kWgRows * kChunks * 128;  // kChunks chunks of 128 rows × 128 B
  static constexpr int kKV = KT * kChunks * 128;      // one K or V tile
  static constexpr int kQChunk = kWgRows * 128;
  static constexpr int kKVChunk = KT * 128;
  static constexpr int q = 0;
  static constexpr int k = kQ;
  static constexpr int v = k + kWgStages * kKV;
  static constexpr int bars = v + kWgStages * kKV;
  // q_full, k_full[2], v_full[2], k_empty[2], v_empty[2]
  static constexpr int bytes = bars + 16 * 8 + 1024;  // + slack to align the base
  // a split part's unnormalised O in f32, over Q and the ring (no longer
  // read), rows padded by kPartPad floats so that the fragment accesses of
  // a half-warp hit distinct banks
  static constexpr int kOStride = HD + kPartPad;  // floats
  static constexpr int part_o = 0;
  static_assert(kWgRows * kOStride * 4 <= bars, "a part's O fits over Q and the ring");
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spin until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One TMA box of the 4-D (d, heads, S, B) map into shared memory; the
// barrier counts its bytes (rows past S arrive as zeros).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// One TMA box from shared memory into the 4-D map (rows past S and columns
// past d are not written), in the CTA's bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
// Shared-memory writes of this thread, made visible to the TMA (async) proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Commit the bulk group and wait until its copies have read shared memory.
__device__ __forceinline__ void bulk_commit_and_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), swizzle mode 1.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// 2^x on the special-function unit (flushes results below 2^-126 to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The two consumer warpgroups take turns issuing their wgmmas (named
// barriers 1 and 2 of 256 threads): one issues while the other runs its
// softmax, so the tensor cores and the special-function units overlap.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}
// Both consumer warpgroups (named barrier 3), without the producer.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// Keep the compiler from moving register reads or writes across a wgmma.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64×128 f32) = A·B, plus D when scale_d: A 64×16 bf16 and B 16×128
// bf16 both from shared memory, K-major (B as 128 rows of 16 k values).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64×64 f32) = A·B, plus D when scale_d: as wgmma_ss_n128 with 64 rows
// of B.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64×64 f32) += A·B: A 64×16 bf16 in registers (each warp's 16 rows
// in the mma.m16n8k16 A-fragment layout), B 16×64 bf16 from shared memory,
// MN-major (transposed: each k row holds 64 contiguous columns).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D (64×32 f32) += A·B: as wgmma_rs_n64_tb over the first 32 columns of
// a 64-column chunk of B (each k row's first 64 bytes).
__device__ __forceinline__ void wgmma_rs_n32_tb(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// One CTA per part of a (b·h, 128-row q tile): the q tile's key tiles
// [j0, j1) (all of them unless the grid is split), heaviest parts first.
// Warpgroup 2 gives up its registers and one of its threads streams Q once
// and the K/V tiles of KT keys through a two-stage ring with TMA; warpgroups
// 0 and 1 each own 64 q rows: S = QKᵀ by wgmma from shared memory, the
// online softmax on S in registers (log2 domain, f32), P re-packed in
// registers as the A operand of O += PV, V read MN-major (transposed) from
// its tile. A head width HD that is no multiple of 64 (96) pads its last
// chunk with the zeros that TMA writes past HD: S skips the all-zero k16
// steps and O's last chunk is one n32 product. Of the two parts of a split
// q tile, the first to finish writes its unnormalised O, running max and
// running sum to slot (b·h, y) of the workspace, and the other merges them
// into its own and writes O; any other CTA writes O (TMA, from shared
// memory).
template <int HD, int KT>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap omap, __nv_bfloat16* __restrict__ o,
                       int S, int H, int KV, float scale_log2, int causal, int cap, int y_split,
                       float* __restrict__ part_o, float* __restrict__ part_ml,
                       int* __restrict__ tickets) {
  using L = WgLayout<HD, KT>;
  constexpr int kChunks = L::kChunks;
  constexpr int kFull = HD / kChunk;  // chunks of O that are m64n64 products
  constexpr int kTail = HD % kChunk;  // columns of the last, n32 chunk (or 0)
  static_assert(KT == 64 || KT == 128, "S = QK^T is one m64n64 or m64n128 product");
  static_assert(kTail == 0 || kTail == 32, "the last chunk of O is an n64 or n32 product");
  static_assert(HD % 16 == 0, "S = QK^T takes k16 steps");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 3;
  uint64_t* k_empty = bars + 5;
  uint64_t* v_empty = bars + 7;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  int qtile, j0, j1, parts = 1, part = 0;
  if (y_split == 0) {  // unsplit: one CTA a q tile, the last (most key tiles) first
    qtile = gridDim.y - 1 - blockIdx.y;
    j0 = 0;
    j1 = wg_tiles(qtile, S, KT, causal);
  } else {
    wg_part(blockIdx.y, S, KT, causal, cap, qtile, j0, j1, parts, part);
  }
  const int q0 = qtile * kWgRows;
  const int n_tiles = j1 - j0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);  // one arrival per consumer warp
      mbar_init(&v_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, L::kQ);
      for (int c = 0; c < kChunks; ++c)
        tma_load_4d(smem + L::q + c * L::kQChunk, &qmap, q_full, c * kChunk, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kWgStages, ph = (i / kWgStages) & 1, key0 = (j0 + i) * KT;
        mbar_wait(&k_empty[st], ph ^ 1);
        mbar_expect_tx(&k_full[st], L::kKV);
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(smem + L::k + st * L::kKV + c * L::kKVChunk, &kmap, &k_full[st],
                      c * kChunk, kvh, key0, b);
        mbar_wait(&v_empty[st], ph ^ 1);
        mbar_expect_tx(&v_full[st], L::kKV);
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(smem + L::v + st * L::kKV + c * L::kKVChunk, &vmap, &v_full[st],
                      c * kChunk, kvh, key0, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows q0 + 64·wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wt = threadIdx.x % 128, warp = wt >> 5, lane = wt & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int rlo = q0 + wg * 64;
    const int r0 = rlo + warp * 16 + g, r1 = r0 + 8;

    float acc[kFull][32];
    float acc_t[kTail ? kTail / 2 : 1];  // the n32 chunk's columns (kTail only)
#pragma unroll
    for (int c = 0; c < kFull; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
#pragma unroll
    for (int i = 0; i < (kTail ? kTail / 2 : 1); ++i) acc_t[i] = 0.f;
    float m0 = -1e30f, m1 = -1e30f;  // running max of rows r0, r1 (log2 domain)
    float l0 = 0.f, l1 = 0.f;        // this thread's share of the running sums
    float s[KT / 2];                 // S of one tile, then its softmax weights
    uint32_t p[KT / 16][4];          // the weights in bf16, the A operand of PV
    const uint8_t* qs = smem + L::q + wg * 64 * 128;

    // S = Q Kᵀ of tile j, 64 rows × KT keys, issued and committed (not
    // waited for); a k16 step advances 32 B inside a 128-byte row, then to
    // the next 64-column chunk (none past HD: those columns hold zeros).
    // j counts the part's tiles, so the ring's stage is j % kWgStages
    auto issue_s = [&](int j) {
      const uint8_t* ks = smem + L::k + (j % kWgStages) * L::kKV;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int off = (kk & 3) * 32;
        const uint64_t da = sw128_desc(qs + (kk >> 2) * L::kQChunk + off, 16, 1024);
        const uint64_t db = sw128_desc(ks + (kk >> 2) * L::kKVChunk + off, 16, 1024);
        if constexpr (KT == 128)
          wgmma_ss_n128(s, da, db, kk > 0);
        else
          wgmma_ss_n64(s, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of tile j: 16 keys (two 8-row groups, 1,024 B apart) per k
    // step, one wgmma per 64-column chunk of V; issued and committed
    // (a 32-column last chunk, d = 96: the n32 product)
    auto issue_pv = [&](int j) {
      const uint8_t* vs = smem + L::v + (j % kWgStages) * L::kKV;
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
        for (int c = 0; c < kFull; ++c)
          wgmma_rs_n64_tb(acc[c], p[kk],
                          sw128_desc(vs + c * L::kKVChunk + kk * 16 * 128, 1024, 1024));
        if constexpr (kTail > 0)
          wgmma_rs_n32_tb(acc_t, p[kk],
                          sw128_desc(vs + kFull * L::kKVChunk + kk * 16 * 128, 1024, 1024));
      }
      wgmma_commit();
    };
    auto pin_o = [&]() {
#pragma unroll
      for (int c = 0; c < kFull; ++c) pin(acc[c]);
      pin(acc_t);
      pin(p);
    };
    // one arrival per warp on a stage's "empty" barrier (count 8)
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // the online softmax of key tile j on s: mask only where the diagonal
    // or the ragged end crosses the tile, weights exp2(s·scale − m) in
    // place; returns the factors that rescale the accumulator rows
    auto softmax = [&](int j, float& al0, float& al1) {
      const int k0 = j * KT;
      if ((causal && k0 + KT - 1 > rlo) || k0 + KT > S) {
#pragma unroll
        for (int i = 0; i < KT / 2; ++i) {
          const int key = k0 + (i >> 2) * 8 + t4 * 2 + (i & 1);
          const int row = (i & 2) ? r1 : r0;
          if (key >= S || (causal && key > row)) s[i] = -CUDART_INF_F;
        }
      }
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int nb = 0; nb < KT / 8; ++nb) {
        mx0 = fmaxf(mx0, fmaxf(s[nb * 4], s[nb * 4 + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[nb * 4 + 2], s[nb * 4 + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
      al0 = ex2(m0 - mn0);
      al1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int nb = 0; nb < KT / 8; ++nb) {
        s[nb * 4] = ex2(fmaf(s[nb * 4], scale_log2, -mn0));
        s[nb * 4 + 1] = ex2(fmaf(s[nb * 4 + 1], scale_log2, -mn0));
        s[nb * 4 + 2] = ex2(fmaf(s[nb * 4 + 2], scale_log2, -mn1));
        s[nb * 4 + 3] = ex2(fmaf(s[nb * 4 + 3], scale_log2, -mn1));
        rs0 += s[nb * 4] + s[nb * 4 + 1];
        rs1 += s[nb * 4 + 2] + s[nb * 4 + 3];
      }
      l0 = l0 * al0 + rs0;
      l1 = l1 * al1 + rs1;
    };
    // rescale O by the new tile's factors, then pack its weights in the
    // A-fragment layout: keys 16kk .. 16kk + 15 per k step
    auto rescale_and_pack = [&](float al0, float al1) {
#pragma unroll
      for (int c = 0; c < kFull; ++c)
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          acc[c][nb * 4] *= al0;
          acc[c][nb * 4 + 1] *= al0;
          acc[c][nb * 4 + 2] *= al1;
          acc[c][nb * 4 + 3] *= al1;
        }
#pragma unroll
      for (int nb = 0; nb < kTail / 8; ++nb) {
        acc_t[nb * 4] *= al0;
        acc_t[nb * 4 + 1] *= al0;
        acc_t[nb * 4 + 2] *= al1;
        acc_t[nb * 4 + 3] *= al1;
      }
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    // Software pipeline: while the softmax of tile j runs on the CUDA
    // cores, the tensor cores finish S of tile j and O += P V of tile j − 1
    // (this warpgroup's) and the other warpgroup's products.
    float al0, al1;
    if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
    mbar_wait(q_full, 0);
    mbar_wait(&k_full[0], 0);
    turn_wait(wg);
    wgmma_fence();
    issue_s(0);
    turn_pass(wg);
    wgmma_wait<0>();
    pin(s);
    release(&k_empty[0]);
    softmax(j0, al0, al1);
    rescale_and_pack(al0, al1);
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % kWgStages, prev = (j - 1) % kWgStages;
      mbar_wait(&k_full[st], (j / kWgStages) & 1);
      mbar_wait(&v_full[prev], ((j - 1) / kWgStages) & 1);
      turn_wait(wg);
      wgmma_fence();
      issue_s(j);
      issue_pv(j - 1);
      turn_pass(wg);
      wgmma_wait<1>();  // S of tile j
      pin(s);
      release(&k_empty[st]);
      softmax(j0 + j, al0, al1);
      wgmma_wait<0>();  // PV of tile j − 1
      pin_o();
      release(&v_empty[prev]);
      rescale_and_pack(al0, al1);
    }
    const int last = n_tiles - 1;
    mbar_wait(&v_full[last % kWgStages], (last / kWgStages) & 1);
    turn_wait(wg);
    wgmma_fence();
    issue_pv(last);
    turn_pass(wg);
    wgmma_wait<0>();
    pin_o();
    release(&v_empty[last % kWgStages]);

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    if (parts > 1) {
      // One of the two parts of a split q tile, each with an integer
      // ticket. The first to finish writes its unnormalised O (through
      // shared memory, coalesced), max and sum to its slot and counts
      // itself ready; the second waits for that (the first took its ticket,
      // so it is resident and finishing), copies the first's O into shared
      // memory with every copy in flight, and merges it into its registers
      // in part order, O = w_1·O_1 + w_0·O_0 as one fma and l likewise
      // (w_p = 2^(m_p − m)): the same bits whichever part finishes first.
      const int tid = threadIdx.x;
      const long long slot0 = (long long)bh * y_split + blockIdx.y - part;
      int* arrive = tickets + 2 * slot0;
      int* ready = arrive + 1;
      int* ticket = reinterpret_cast<int*>(bars + 9);  // past the nine barriers
      float* stage = reinterpret_cast<float*>(smem + L::part_o);
      const int lr0 = r0 - q0, lr1 = r1 - q0;
      constexpr int kVecs = kWgRows * L::kOStride / 4;  // float4 of a part's O
      consumers_sync();  // both warpgroups are done with Q and the ring
      if (tid == 0) *ticket = atomicAdd(arrive, 1);
      consumers_sync();
      if (*ticket == 0) {
        auto put = [&](int col, float a0, float a1, float a2, float a3) {
          *reinterpret_cast<float2*>(stage + lr0 * L::kOStride + col) = make_float2(a0, a1);
          *reinterpret_cast<float2*>(stage + lr1 * L::kOStride + col) = make_float2(a2, a3);
        };
#pragma unroll
        for (int c = 0; c < kFull; ++c)
#pragma unroll
          for (int nb = 0; nb < 8; ++nb)
            put(c * kChunk + nb * 8 + t4 * 2, acc[c][nb * 4], acc[c][nb * 4 + 1],
                acc[c][nb * 4 + 2], acc[c][nb * 4 + 3]);
#pragma unroll
        for (int nb = 0; nb < kTail / 8; ++nb)
          put(kFull * kChunk + nb * 8 + t4 * 2, acc_t[nb * 4], acc_t[nb * 4 + 1],
              acc_t[nb * 4 + 2], acc_t[nb * 4 + 3]);
        float* gml = part_ml + (slot0 + part) * 2 * kWgRows;
        if (t4 == 0) {
          gml[lr0] = m0;
          gml[lr1] = m1;
          gml[kWgRows + lr0] = l0;
          gml[kWgRows + lr1] = l1;
        }
        consumers_sync();
        float4* go = reinterpret_cast<float4*>(part_o + (slot0 + part) * kWgRows * L::kOStride);
        const float4* st4 = reinterpret_cast<const float4*>(stage);
#pragma unroll 4
        for (int i = tid; i < kVecs; i += 256) go[i] = st4[i];
        __threadfence();
        consumers_sync();
        if (tid == 0) atomicAdd(ready, 1);
        return;
      }
      if (tid == 0)
        while (*reinterpret_cast<volatile int*>(ready) == 0) __nanosleep(64);
      consumers_sync();
      __threadfence();
      const int other = 1 - part;
      const float* go = part_o + (slot0 + other) * kWgRows * L::kOStride;
      for (int i = tid; i < kVecs; i += 256) cp_async16(stage + 4 * i, go + 4 * i);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      const float* gml = part_ml + (slot0 + other) * 2 * kWgRows;
      const float mo0 = __ldcg(gml + lr0), mo1 = __ldcg(gml + lr1);
      const float lo0 = __ldcg(gml + kWgRows + lr0), lo1 = __ldcg(gml + kWgRows + lr1);
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      consumers_sync();
      if (tid == 0) {  // both parts are past their tickets
        *arrive = 0;
        *ready = 0;
      }
      const bool first = part == 0;  // this part's O is O_0
      const float mn0 = fmaxf(m0, mo0), mn1 = fmaxf(m1, mo1);
      const float ws0 = exp2f(m0 - mn0), wo0 = exp2f(mo0 - mn0);
      const float ws1 = exp2f(m1 - mn1), wo1 = exp2f(mo1 - mn1);
      // rows r0 and r1: w_0 and w_1, and O_0 and O_1 of an element as
      // (own, other) or (other, own)
      const float w00 = first ? ws0 : wo0, w10 = first ? wo0 : ws0;
      const float w01 = first ? ws1 : wo1, w11 = first ? wo1 : ws1;
      l0 = first ? fmaf(w10, lo0, w00 * l0) : fmaf(w10, l0, w00 * lo0);
      l1 = first ? fmaf(w11, lo1, w01 * l1) : fmaf(w11, l1, w01 * lo1);
      auto mix = [&](float& a, float x, float w0, float w1) {
        a = first ? fmaf(w1, x, w0 * a) : fmaf(w1, a, w0 * x);
      };
      auto merge = [&](int col, float& a0, float& a1, float& a2, float& a3) {
        const float2 x = *reinterpret_cast<const float2*>(stage + lr0 * L::kOStride + col);
        const float2 z = *reinterpret_cast<const float2*>(stage + lr1 * L::kOStride + col);
        mix(a0, x.x, w00, w10);
        mix(a1, x.y, w00, w10);
        mix(a2, z.x, w01, w11);
        mix(a3, z.y, w01, w11);
      };
#pragma unroll
      for (int c = 0; c < kFull; ++c)
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
          merge(c * kChunk + nb * 8 + t4 * 2, acc[c][nb * 4], acc[c][nb * 4 + 1],
                acc[c][nb * 4 + 2], acc[c][nb * 4 + 3]);
#pragma unroll
      for (int nb = 0; nb < kTail / 8; ++nb)
        merge(kFull * kChunk + nb * 8 + t4 * 2, acc_t[nb * 4], acc_t[nb * 4 + 1],
              acc_t[nb * 4 + 2], acc_t[nb * 4 + 3]);
    }
    // O, normalised, in bf16 into the Q tile's chunks (128-byte swizzle,
    // conflict-free), then one TMA store a chunk: rows past S and columns
    // past HD (the next head's) are not written
    consumers_sync();  // both warpgroups are done with Q (and a merge with its stage)
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    uint8_t* ost = smem + L::q;
    const int lr0 = r0 - q0, lr1 = r1 - q0;
    auto put = [&](int col, float a0, float a1, float a2, float a3) {
      uint8_t* chunk = ost + (col / kChunk) * L::kQChunk;
      const int cb = (col % kChunk) * 2;  // byte in the 128-byte row
      *reinterpret_cast<uint32_t*>(chunk + lr0 * 128 + (((cb >> 4) ^ (lr0 & 7)) << 4) +
                                   (cb & 15)) = pack_bf16(a0 * inv0, a1 * inv0);
      *reinterpret_cast<uint32_t*>(chunk + lr1 * 128 + (((cb >> 4) ^ (lr1 & 7)) << 4) +
                                   (cb & 15)) = pack_bf16(a2 * inv1, a3 * inv1);
    };
#pragma unroll
    for (int c = 0; c < kFull; ++c)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        put(c * kChunk + nb * 8 + t4 * 2, acc[c][nb * 4], acc[c][nb * 4 + 1], acc[c][nb * 4 + 2],
            acc[c][nb * 4 + 3]);
#pragma unroll
    for (int nb = 0; nb < kTail / 8; ++nb)
      put(kFull * kChunk + nb * 8 + t4 * 2, acc_t[nb * 4], acc_t[nb * 4 + 1], acc_t[nb * 4 + 2],
          acc_t[nb * 4 + 3]);
    fence_proxy_async();
    consumers_sync();
    if (threadIdx.x == 0) {
      for (int c = 0; c < kChunks; ++c)
        tma_store_4d(&omap, ost + c * L::kQChunk, c * kChunk, h, q0, b);
      bulk_commit_and_wait_read();
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda through the runtime's entry-point
// query, so the library needs no -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The 4-D map (d, heads, S, B) of a bf16 (B, S, heads, d) view with the
// given (b, s, h) element strides, boxes of 64 columns × rows positions of
// one head, 128-byte swizzle, zeros past every edge.
bool make_map(CUtensorMap* map, const void* base, int B, int S, int heads, int d, Strides st,
              int rows) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kChunk, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
             box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The split grid that `cap` key tiles a CTA gives: CTA rows a (b·h) (the
// grid's y) and the parts of split q tiles a (b·h), the first rows of y;
// false where a q tile would take more than kSplitMaxParts parts.
bool split_grid(int S, int KT, int causal, int cap, int& grid_y, int& y_split) {
  grid_y = y_split = 0;
  for (int t = 0; t < (S + kWgRows - 1) / kWgRows; ++t) {
    const int parts = (wg_tiles(t, S, KT, causal) + cap - 1) / cap;
    if (parts > kSplitMaxParts) return false;
    grid_y += parts;
    if (parts > 1) y_split += parts;
  }
  return true;
}

template <int HD, int KT>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                 int KV, Strides qs, Strides ks, Strides vs, float scale_log2, int causal,
                 int cap, float* work, long long slots, int* tickets, cudaStream_t st) {
  using L = WgLayout<HD, KT>;
  static_assert(L::bytes <= 232448, "past the 227 KB of shared memory a block may use");
  int grid_y, y_split;
  if (cap < 1 || !split_grid(S, KT, causal, cap, grid_y, y_split) ||
      (y_split > 0 && cap < kSplitMinCap) || slots != (long long)B * H * y_split ||
      (slots > 0 && (work == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm, om;
  const Strides os{(long long)S * H * HD, (long long)H * HD, HD};  // o is contiguous
  if (!make_map(&qm, q, B, S, H, HD, qs, kWgRows) || !make_map(&km, k, B, S, KV, HD, ks, KT) ||
      !make_map(&vm, v, B, S, KV, HD, vs, KT) || !make_map(&om, o, B, S, H, HD, os, kWgRows))
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<HD, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  float* part_ml = work == nullptr ? nullptr : work + slots * kWgRows * (HD + kPartPad);
  flash_wgmma_kernel<HD, KT><<<dim3(B * H, grid_y), kWgThreads, L::bytes, st>>>(
      qm, km, vm, om, (__nv_bfloat16*)o, S, H, KV, scale_log2, causal, cap, y_split, work,
      part_ml, tickets);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, H, d), k and v (B, S, KV, d) with unit d stride, read through the
// given (b, s, h) strides in elements; o (B, S, H, d) contiguous. dtype 0 is
// float32, 1 bfloat16. path 2 asks for the wgmma body (bf16, d ∈ {64, 96,
// 128, 256}), path 1 for the mma.sync body (bf16, d ∈ {16, 32}), both with
// every pointer and (b, s, h) stride 16-byte aligned; path 0 for the f32-FMA
// body (d ≤ kFlashMaxD). scale multiplies q·k. On path 2, cap is the most
// key tiles a CTA walks (at least every q tile's count: no split); where it
// splits, work holds slots × kWgRows × (d + kPartPad + 2) floats, slots =
// B·H × the split parts a (b·h) (split_grid), and tickets 2·slots int32
// zeros (the kernel leaves them zero).
REPRO_EXPORT int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                       int dtype, int path, int B, int S, int H, int KV, int d,
                                       long long qsb, long long qss, long long qsh,
                                       long long ksb, long long kss, long long ksh,
                                       long long vsb, long long vss, long long vsh, int causal,
                                       float scale, int cap, void* work, long long slots,
                                       void* tickets, void* stream) {
  if (B < 0 || S < 0 || H <= 0 || KV <= 0 || H % KV != 0 || d <= 0 || d > kFlashMaxD ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const float sl2 = scale * 1.4426950408889634f;
  if (path == 2) {
    float* w = (float*)work;
    int* tk = (int*)tickets;
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (d == 64)
      return launch_wgmma<64, kWgKeys>(q, k, v, o, B, S, H, KV, qs, ks, vs, sl2, causal, cap, w,
                                       slots, tk, st);
    if (d == 96)
      return launch_wgmma<96, kWgKeys>(q, k, v, o, B, S, H, KV, qs, ks, vs, sl2, causal, cap, w,
                                       slots, tk, st);
    if (d == 128)
      return launch_wgmma<128, kWgKeys>(q, k, v, o, B, S, H, KV, qs, ks, vs, sl2, causal, cap, w,
                                        slots, tk, st);
    if (d == 256)
      return launch_wgmma<256, kWgKeysWide>(q, k, v, o, B, S, H, KV, qs, ks, vs, sl2, causal, cap,
                                            w, slots, tk, st);
    return (int)cudaErrorInvalidValue;
  }
  if (path == 1) {
    if (dtype != 1 || (d != 16 && d != 32)) return (int)cudaErrorInvalidValue;
    const dim3 grid(B * H, (S + kMmaRows - 1) / kMmaRows);
    const __nv_bfloat16* qp = (const __nv_bfloat16*)q;
    const __nv_bfloat16* kp = (const __nv_bfloat16*)k;
    const __nv_bfloat16* vp = (const __nv_bfloat16*)v;
    __nv_bfloat16* op = (__nv_bfloat16*)o;
    if (d == 16)
      flash_mma_kernel<16><<<grid, kMmaThreads, 0, st>>>(qp, kp, vp, op, S, H, KV, qs, ks, vs,
                                                         sl2, causal);
    else
      flash_mma_kernel<32><<<grid, kMmaThreads, 0, st>>>(qp, kp, vp, op, S, H, KV, qs, ks, vs,
                                                         sl2, causal);
    return (int)cudaGetLastError();
  }
  if (dtype == 0)
    return launch_simt<float>(q, k, v, o, B, S, H, KV, d, qs, ks, vs, scale, causal, st);
  return launch_simt<__nv_bfloat16>(q, k, v, o, B, S, H, KV, d, qs, ks, vs, scale, causal, st);
}
