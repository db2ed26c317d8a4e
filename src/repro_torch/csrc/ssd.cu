// Mamba2 SSD chunk scan with the recurrent state carried in and out.
//
// Replaces: src/repro/kernels/ssd/kernel.py:ssd_kernel (wrapper
// ops.py:ssd_chunked), and on the model's path its twin
// src/repro/models/ssm.py:_ssd_chunked. Layout is the model's: x (B, T, H, P),
// dt (B, T, H) > 0, A (H,) < 0, Bm and Cm (B, T, 1, N) shared by every head,
// state (B, H, P, N). Per chunk of Q steps, all in f32 as the TPU kernel:
//   la    = cumsum(dt·A)
//   y     = (C Bᵀ ⊙ exp(la_i − la_j), j ≤ i) · (x·dt)  +  exp(la) ⊙ (C · state)
//   state = exp(la_Q)·state + Bᵀ((x·dt) ⊙ exp(la_Q − la))
// Steps at and beyond T are dt = 0 steps with zero inputs (the padding of
// ssd/ops.py, masked here instead of copied): they leave the state as it is.
//
// Two bodies. The wrapper names the one a call takes (ops.kernel_path).
//
// "mma" (x, B, C in bf16, P ∈ {32, 64}, N a multiple of 16 up to 128: the
// serve path) splits the scan the way Dao & Gu (2024, §6) do, into three
// launches:
//   1. chunk state: per (b, chunk, head, block of state rows), S_c = Σ_j
//      (B_j · dt_j · e^{la_Q − la_j})ᵀ x_j, and la_Q. Every chunk in parallel.
//   2. state passing: per (b, head, state entry), h_{c+1} = e^{la_Q,c} h_c +
//      S_c over the chunks; writes the state entering each chunk after the
//      first, and the final state.
//   3. chunk scan: per (b, chunk, head, block of rows), y = e^{la_i}
//      (C_i · h_c) + Σ_{j ≤ i} (C_i·B_j) e^{la_i − la_j} dt_j x_j. Every chunk
//      in parallel; each CTA takes all P columns, so each decay exp is taken
//      once per (i, j, head). The row blocks with the most j steps launch
//      first.
// C Bᵀ is recomputed inside each chunk-scan CTA (one bf16 tensor-core pass
// per head) instead of going through scratch: it needs no global round trip
// and costs ≈ 1 GFLOP over all heads of a 1,024-token prefill.
// Every product runs on the tensor cores (mma.sync m16n8k16) at f32
// accuracy: one operand is bf16 and exact (x, B, C), the other is f32 (the
// weights C Bᵀ ⊙ decay ⊙ dt, (B ⊙ dt ⊙ tail)ᵀ, the state) and is split into
// three bf16 pieces hi + mid + lo that carry its 24-bit mantissa; the three
// products are summed in f32. C Bᵀ has two exact operands and takes one pass.
// B, C, x and the state reach shared memory by 16-byte cp.async, through a
// ring of buffers so that the next tiles load while one is multiplied; x
// reaches the B-operand fragments through ldmatrix.trans.
// Each 16-row tile of phases 1 and 3 belongs to one warp, or to a pair of
// warps that take its 16-step blocks in turns. Pairs halve the longest
// warp's chain of steps where the grid gives each SM one CTA (a 256-token
// prefill); single warps in larger blocks of rows read h, B and x fewer
// times where the grid fills the card (the bytes bound it there).
//
// "simt" (f32 inputs, and any other shape): one CTA walks the chunks of one
// (b, h, 16 columns of P) in a loop, on the CUDA cores; a first kernel
// writes the lower triangle of C Bᵀ per (b, chunk) to scratch.
//
// Bound on the H100 at the serve path's prefill (1, 1024, 32, 64), N = 128,
// Q = 256: ≈ 1.65 GFLOP of f32 work ≈ 25 µs at the 67 TFLOP/s f32 peak; the
// mma body does it as ≈ 5.9 GFLOP of bf16 tensor-core work (three passes of
// the intra, inter and state products, C Bᵀ once per head) ≈ 6 µs at 989
// TFLOP/s; the bytes (≈ 10.6 MB with bf16 x/y/B/C and f32 state) ≈ 3.2 µs.
#include "common.cuh"

namespace {

constexpr int kMaxQ = 256;
constexpr int kMaxN = 128;
constexpr int kPB = 16;       // columns of P per CTA
constexpr int kThreads = 256;
constexpr int kCbTile = 32;   // C Bᵀ kernel: 32 × 32 output tile
constexpr int kJTile = 16;    // scan: columns of C Bᵀ staged at a time

struct Seq {
  long long b, t;  // element strides of a (B, T, ...) operand
};

// cb[b, c, i, j] = Σ_n C[b, cQ+i, n] · B[b, cQ+j, n] for the 32 × 32 tiles
// on or below the diagonal; tiles above it are never read and stay unwritten.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_cb_kernel(const T* __restrict__ Cm, const T* __restrict__ Bm, float* __restrict__ cb,
                  int T_len, int N, int Q, int nc, Seq bs, Seq cs) {
  __shared__ float Cs[kCbTile][kMaxN + 1];
  __shared__ float Bs[kCbTile][kMaxN + 1];
  const int ntile = (Q + kCbTile - 1) / kCbTile;
  const int ti = blockIdx.x / ntile, tj = blockIdx.x % ntile;
  if (tj > ti) return;
  const int c = blockIdx.y, b = blockIdx.z;
  const int i0 = ti * kCbTile, j0 = tj * kCbTile;
  for (int idx = threadIdx.x; idx < kCbTile * N; idx += kThreads) {
    const int r = idx / N, n = idx % N;
    const int ti_ = c * Q + i0 + r, tj_ = c * Q + j0 + r;
    Cs[r][n] = (i0 + r < Q && ti_ < T_len) ? to_float(Cm[b * cs.b + ti_ * cs.t + n]) : 0.f;
    Bs[r][n] = (j0 + r < Q && tj_ < T_len) ? to_float(Bm[b * bs.b + tj_ * bs.t + n]) : 0.f;
  }
  __syncthreads();
  const int i = threadIdx.x / 8;
  float* out = cb + (((long long)b * nc + c) * Q + i0 + i) * Q + j0;
#pragma unroll
  for (int e = 0; e < kCbTile / 8; ++e) {
    const int j = threadIdx.x % 8 + 8 * e;
    float s = 0.f;
    for (int n = 0; n < N; ++n) s = fmaf(Cs[i][n], Bs[j][n], s);
    if (i0 + i < Q && j0 + j < Q) out[j] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const float* __restrict__ cb, const T* __restrict__ Cm,
                    const float* __restrict__ state0, T* __restrict__ y,
                    float* __restrict__ state_out, int T_len, int H, int P, int N, int Q, int nc,
                    Seq xs, Seq dts, Seq bs, Seq cs) {
  __shared__ float la_s[kMaxQ];
  __shared__ float tail_s[kMaxQ];
  __shared__ float xdt_s[kMaxQ][kPB];
  __shared__ float st_s[kMaxN][kPB];
  __shared__ float cb_s[kMaxQ][kJTile + 1];
  __shared__ float warp_tot[kThreads / 32];

  const int p0 = blockIdx.x * kPB, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int np = min(kPB, P - p0);
  const float a = A[h];
  const long long sbase = ((long long)b * H + h) * P;  // state row of (b, h, p = 0)

  for (int idx = tid; idx < kPB * N; idx += kThreads) {
    const int pp = idx / N, n = idx % N;
    st_s[n][pp] = (pp < np && state0 != nullptr) ? state0[(sbase + p0 + pp) * N + n] : 0.f;
  }

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * Q;
    const int i = tid;  // row of the chunk this thread owns for y
    const bool row_ok = i < Q && t0 + i < T_len;
    const float dti = row_ok ? dt[b * dts.b + (long long)(t0 + i) * dts.t + h] : 0.f;

    // la: inclusive scan of dt·A over the chunk (warp scans, then warp totals)
    float v = dti * a;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    __syncthreads();  // the previous chunk's readers of la_s, xdt_s are done
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float w = lane < kThreads / 32 ? warp_tot[lane] : 0.f;
#pragma unroll
      for (int off = 1; off < kThreads / 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += u;
      }
      if (lane < kThreads / 32) warp_tot[lane] = w;
    }
    __syncthreads();
    if (warp > 0) v += warp_tot[warp - 1];
    if (i < Q) {
      la_s[i] = v;
      const T* xr = x + b * xs.b + (long long)(t0 + i) * xs.t + (long long)h * P + p0;
#pragma unroll
      for (int pp = 0; pp < kPB; ++pp)
        xdt_s[i][pp] = (row_ok && pp < np) ? to_float(xr[pp]) * dti : 0.f;
    }
    __syncthreads();
    const float la_last = la_s[Q - 1];
    if (i < Q) tail_s[i] = expf(la_last - la_s[i]);

    // inter-chunk term: exp(la_i) · (C_i · state)
    float acc[kPB];
#pragma unroll
    for (int pp = 0; pp < kPB; ++pp) acc[pp] = 0.f;
    const float la_i = i < Q ? la_s[i] : 0.f;
    if (row_ok) {
      const T* cr = Cm + b * cs.b + (long long)(t0 + i) * cs.t;
      for (int n = 0; n < N; ++n) {
        const float cn = to_float(cr[n]);
#pragma unroll
        for (int pp = 0; pp < kPB; ++pp) acc[pp] = fmaf(cn, st_s[n][pp], acc[pp]);
      }
      const float e = expf(la_i);
#pragma unroll
      for (int pp = 0; pp < kPB; ++pp) acc[pp] *= e;
    }

    // intra-chunk term: Σ_{j ≤ i} (C Bᵀ)_ij · exp(la_i − la_j) · xdt_j
    const float* cbc = cb + ((long long)b * nc + c) * Q * Q;
    for (int j0 = 0; j0 < Q; j0 += kJTile) {
      __syncthreads();
      for (int idx = tid; idx < Q * kJTile; idx += kThreads) {
        const int r = idx / kJTile, jj = idx % kJTile;
        if (j0 + jj <= r) cb_s[r][jj] = cbc[(long long)r * Q + j0 + jj];
      }
      __syncthreads();
      if (i < Q && j0 <= i) {
        const int jn = min(kJTile, i - j0 + 1);
        for (int jj = 0; jj < jn; ++jj) {
          const float w = cb_s[i][jj] * expf(la_i - la_s[j0 + jj]);
#pragma unroll
          for (int pp = 0; pp < kPB; ++pp) acc[pp] = fmaf(w, xdt_s[j0 + jj][pp], acc[pp]);
        }
      }
    }
    if (row_ok) {
      T* yr = y + (((long long)b * T_len + t0 + i) * H + h) * P + p0;
#pragma unroll
      for (int pp = 0; pp < kPB; ++pp)
        if (pp < np) yr[pp] = from_float<T>(acc[pp]);
    }
    __syncthreads();  // every reader of st_s for the inter term is done

    // state update: thread (n, half) owns st_s[n][8·half .. 8·half + 7]
    const int n = tid >> 1, q0 = (tid & 1) * (kPB / 2);
    if (n < N) {
      float add[kPB / 2];
#pragma unroll
      for (int e = 0; e < kPB / 2; ++e) add[e] = 0.f;
      const T* bcol = Bm + b * bs.b + n;
      for (int j = 0; j < Q && t0 + j < T_len; ++j) {
        const float w = to_float(bcol[(long long)(t0 + j) * bs.t]) * tail_s[j];
#pragma unroll
        for (int e = 0; e < kPB / 2; ++e) add[e] = fmaf(w, xdt_s[j][q0 + e], add[e]);
      }
      const float decay = expf(la_last);
#pragma unroll
      for (int e = 0; e < kPB / 2; ++e) st_s[n][q0 + e] = st_s[n][q0 + e] * decay + add[e];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kPB * N; idx += kThreads) {
    const int pp = idx / N, n = idx % N;
    if (pp < np) state_out[(sbase + p0 + pp) * N + n] = st_s[n][pp];
  }
}

template <typename T>
int launch_simt(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                const void* state0, void* y, void* state_out, void* cb, int B, int T_len, int H,
                int P, int N, int Q, Seq xs, Seq dts, Seq bs, Seq cs, cudaStream_t st) {
  const int nc = (T_len + Q - 1) / Q;
  const int ntile = (Q + kCbTile - 1) / kCbTile;
  ssd_cb_kernel<T><<<dim3(ntile * ntile, nc, B), kThreads, 0, st>>>(
      (const T*)Cm, (const T*)Bm, (float*)cb, T_len, N, Q, nc, bs, cs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T><<<dim3((P + kPB - 1) / kPB, H, B), kThreads, 0, st>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm, (const float*)cb,
      (const T*)Cm, (const float*)state0, (T*)y, (float*)state_out, T_len, H, P, N, Q, nc, xs,
      dts, bs, cs);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- mma body

using bf16 = __nv_bfloat16;
// Both phases that multiply give each 16-row tile one warp, or a pair of
// warps that take its steps in turns and add their sums at the end
// (kPair = 2): the launch takes pairs where the grid alone leaves SMs with
// a single CTA, and single warps (more CTAs per SM, fewer bytes per row)
// where it does not.
constexpr int kJB = 64;          // chunk steps per staged tile
constexpr int kStateWarps = 4;   // chunk state: 4 tiles, or 2 tiles of pairs
constexpr int kHCols = 64;       // chunk scan: state columns n per staged tile
constexpr int kHS = kHCols + 8;  // chunk scan: row stride of a staged state tile, floats

// Chunk scan: stages in shared memory at once, and rows per CTA.
__host__ __device__ constexpr int scan_ring(int pair) { return pair == 2 ? 4 : 2; }
__host__ __device__ constexpr int scan_rows(int pair) { return pair == 2 ? 64 : 128; }

// bf16 elements of one chunk-scan ring buffer: the largest stage (the
// CTA's `rows` rows of C, a state tile, or B and x for 64 steps), in whole
// 16-byte units.
__host__ __device__ inline int scan_slot(int P, int N, int rows) {
  int e = kJB * (N + 8 + P + 8);
  e = e > 2 * P * kHS ? e : 2 * P * kHS;
  e = e > rows * (N + 8) ? e : rows * (N + 8);
  return (e + 7) / 8 * 8;
}

// 16 bytes global → shared without registers; ok = false writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8×8 bf16 tiles of a row-major [k][n] array, transposed: the B
// operands of mma m16n8k16 for two 8-column blocks. Lane l gives the
// address of row k = l % 16 at column 8·(l / 16) of the block pair.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// v = hi + mid + lo, each a bf16: 3 × 8 significant bits hold f32's 24.
__device__ __forceinline__ void split3(float v, bf16& hi, bf16& mid, bf16& lo) {
  hi = __float2bfloat16_rn(v);
  const float r = __fsub_rn(v, __bfloat162float(hi));
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(mid)));
}

// The pair (v0, v1) as three packed bf16 pairs.
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi, uint32_t& mid,
                                           uint32_t& lo) {
  bf16 h0, m0, l0, h1, m1, l1;
  split3(v0, h0, m0, l0);
  split3(v1, h1, m1, l1);
  hi = pack_raw(h0, h1);
  mid = pack_raw(m0, m1);
  lo = pack_raw(l0, l1);
}

// An f32 A fragment (v[2r], v[2r+1] in register r) as three bf16 fragments.
__device__ __forceinline__ void split_frag(const float (&v)[8], uint32_t (&hi)[4],
                                           uint32_t (&mid)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) split_pair(v[2 * r], v[2 * r + 1], hi[r], mid[r], lo[r]);
}

// d += (hi + mid + lo)·b, the small pieces first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&hi)[4],
                                     const uint32_t (&mid)[4], const uint32_t (&lo)[4],
                                     uint32_t b0, uint32_t b1) {
  mma_16816(d, lo, b0, b1);
  mma_16816(d, mid, b0, b1);
  mma_16816(d, hi, b0, b1);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// la[k] = Σ_{k' ≤ k} dt_k'·a over the chunk's Q steps, by warp 0: lane l folds
// steps [l·per, (l+1)·per) in order after a fixed shuffle scan of the lanes'
// totals, so both kernels that call it get the same bits. Entries Q..kMaxQ−1
// repeat la[Q − 1].
__device__ __forceinline__ void chunk_cumsum(const float* dt_s, float a, float* la_s, int Q) {
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  constexpr int kPer = kMaxQ / 32;
  const int per = (Q + 31) >> 5;
  const int k0 = lane * per;
  float v[kPer];
  float tot = 0.f;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    v[q] = q < per && k0 + q < Q ? __fmul_rn(dt_s[k0 + q], a) : 0.f;
    tot = __fadd_rn(tot, v[q]);
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot = __fadd_rn(tot, u);
  }
  float run = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) run = 0.f;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    run = __fadd_rn(run, v[q]);
    if (q < per && k0 + q < Q) la_s[k0 + q] = run;
  }
  const float last = __shfl_sync(0xffffffffu, run, (Q - 1) / per);
  for (int k = Q + lane; k < kMaxQ; k += 32) la_s[k] = last;
}

// dt of one (b, chunk, head), zero past the chunk's valid steps: thread t
// holds steps t, t + kThreads, ... The loads are issued before the stages'
// cp.async, so that they do not wait behind them.
template <int kThreads>
struct DtFetch {
  float v[kMaxQ / kThreads];
  __device__ __forceinline__ DtFetch(const float* __restrict__ dt, Seq dts, int b, int t0, int h,
                                     int q_valid) {
#pragma unroll
    for (int q = 0; q < kMaxQ / kThreads; ++q) {
      const int k = threadIdx.x + q * kThreads;
      v[q] = k < q_valid ? dt[b * dts.b + (long long)(t0 + k) * dts.t + h] : 0.f;
    }
  }
  // dt into shared memory, then la (warp 0). Ends with a barrier.
  __device__ __forceinline__ void finish(int Q, float a, float* dt_s, float* la_s) const {
#pragma unroll
    for (int q = 0; q < kMaxQ / kThreads; ++q) dt_s[threadIdx.x + q * kThreads] = v[q];
    __syncthreads();
    chunk_cumsum(dt_s, a, la_s, Q);
    __syncthreads();
  }
};

// Add the second warp of each pair's accumulators into the first's, in
// shared memory laid out [tile][element][lane] (no bank conflicts); the
// first warp of the pair ends with the sum. Ends with a barrier.
template <int NB>
__device__ __forceinline__ void pair_reduce(float (&acc)[NB][4], float* red, int tile, int half,
                                            int lane) {
  __syncthreads();  // every reader of the ring is done
  if (half == 1) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(tile * NB * 4 + nb * 4 + e) * 32 + lane] = acc[nb][e];
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][e] += red[(tile * NB * 4 + nb * 4 + e) * 32 + lane];
  }
}

// Phase 1, chunk state. CTA (64 / kPair state rows n0.., chunk c, b·H + h);
// tile t (warp t, or warps 2t and 2t + 1 in turns) owns state rows n0 + 16t..
// and all P columns:
//   S[b, c, h, p, n] = Σ_j B[j, n] · dt_j · e^{la_Q − la_j} · x[j, p]
// as A = (B ⊙ w)ᵀ (f32, split three ways) times x (bf16). Also writes la_Q.
// Tiles of 64 steps of B and x stream through a ring of buffers.
template <int P, int kPair>
__global__ void __launch_bounds__(kStateWarps * 32)
    ssd_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const bf16* __restrict__ Bm,
                     float* __restrict__ S, float* __restrict__ la_last, int T_len, int H, int N,
                     int Q, int nc, Seq xs, Seq dts, Seq bs) {
  constexpr int kThreads = kStateWarps * 32, kStateRows = 16 * kStateWarps / kPair;
  constexpr int kRing = kPair == 2 ? 3 : 2;  // stages in shared memory at once (< 48 KB)
  constexpr int NB = P / 8, kBS = kStateRows + 8, kXS = P + 8;
  constexpr int kSlot = kJB * kBS + kJB * kXS;  // bf16 of one stage: B tile, then x tile
  static_assert(kSlot * sizeof(bf16) >= 2 * NB * 4 * 32 * sizeof(float), "reduce fits a slot");
  __shared__ __align__(16) bf16 ring[kRing * kSlot];
  __shared__ float dt_s[kMaxQ], la_s[kMaxQ], w_s[kMaxQ];

  const int n0 = blockIdx.x * kStateRows, c = blockIdx.y, b = blockIdx.z / H, h = blockIdx.z % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int tile = warp / kPair, half = warp % kPair;
  const int t0 = c * Q, q_valid = min(Q, T_len - t0);
  const long long bch = ((long long)b * nc + c) * H + h;
  const int n_stages = (q_valid + kJB - 1) / kJB;
  auto issue = [&](int st) {
    if (st < n_stages) {
      bf16* Bs = ring + (st % kRing) * kSlot;
      bf16* Xs = Bs + kJB * kBS;
      const int j0 = st * kJB;
      for (int idx = tid; idx < kJB * (kStateRows / 8); idx += kThreads) {
        const int r = idx / (kStateRows / 8), cc = (idx % (kStateRows / 8)) * 8;
        const bool ok = j0 + r < q_valid && n0 + cc < N;
        cp_async16(&Bs[r * kBS + cc],
                   ok ? Bm + b * bs.b + (long long)(t0 + j0 + r) * bs.t + n0 + cc : Bm, ok);
      }
      for (int idx = tid; idx < kJB * (P / 8); idx += kThreads) {
        const int r = idx / (P / 8), cc = (idx % (P / 8)) * 8;
        const bool ok = j0 + r < q_valid;
        cp_async16(&Xs[r * kXS + cc],
                   ok ? x + b * xs.b + (long long)(t0 + j0 + r) * xs.t + (long long)h * P + cc
                      : x,
                   ok);
      }
    }
    cp_async_commit();
  };
  const DtFetch<kThreads> dtf(dt, dts, b, t0, h, q_valid);
#pragma unroll
  for (int st = 0; st < kRing - 1; ++st) issue(st);
  dtf.finish(Q, A[h], dt_s, la_s);
  const float la_q = la_s[Q - 1];
  for (int k = tid; k < kMaxQ; k += kThreads) w_s[k] = __fmul_rn(dt_s[k], expf(la_q - la_s[k]));
  if (blockIdx.x == 0 && tid == 0) la_last[bch] = la_q;

  float acc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  const int m0 = tile * 16;  // this tile's first state row within the CTA's
  const bool active = n0 + m0 < N;
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kRing - 2>();
    __syncthreads();  // this stage's tiles (and, at the first, w_s) are visible
    issue(st + kRing - 1);  // into the buffer freed by stage st − 1
    const bf16* Bs = ring + (st % kRing) * kSlot;
    const bf16* Xs = Bs + kJB * kBS;
    const int j0 = st * kJB;
    if (active) {
      const int steps = (min(kJB, q_valid - j0) + 15) / 16;
      for (int s = half; s < steps; s += kPair) {
        const int jr = s * 16;
        // A[m, k] = B[k, m] · w_k: register r holds (row g + 8(r&1), cols 2t4 + 8(r>>1) + {0,1})
        float av[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int m = m0 + g + ((e >> 1) & 1) * 8;
          const int k = jr + 2 * t4 + (e >> 2) * 8 + (e & 1);
          av[e] = __bfloat162float(Bs[k * kBS + m]) * w_s[j0 + k];
        }
        uint32_t hi[4], mid[4], lo[4];
        split_frag(av, hi, mid, lo);
#pragma unroll
        for (int pb = 0; pb < NB / 2; ++pb) {
          uint32_t xf[4];
          ldsm_x4_trans(xf, &Xs[(jr + (lane & 15)) * kXS + pb * 16 + (lane >> 4) * 8]);
          mma3(acc[2 * pb], hi, mid, lo, xf[0], xf[1]);
          mma3(acc[2 * pb + 1], hi, mid, lo, xf[2], xf[3]);
        }
      }
    }
  }
  if (kPair == 2) {
    cp_async_wait<0>();
    pair_reduce(acc, reinterpret_cast<float*>(ring), tile, half, lane);
  }
  if (!active || half != 0) return;
  float* Sb = S + bch * P * N;
  const int n = n0 + m0 + g;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int p = nb * 8 + 2 * t4;
    Sb[(long long)p * N + n] = acc[nb][0];
    Sb[(long long)(p + 1) * N + n] = acc[nb][1];
    Sb[(long long)p * N + n + 8] = acc[nb][2];
    Sb[(long long)(p + 1) * N + n + 8] = acc[nb][3];
  }
}

// Phase 2, state passing: one thread per four state entries e.. e + 3
// (e = p·N + n, in 16-byte loads and stores), head and b walks the chunks.
// hs[b, c, h] (P × N, f32) holds the state entering chunk c ≥ 1 (chunk 0's
// is state0); state_out the state after the last.
__global__ void __launch_bounds__(256)
    ssd_pass_kernel(const float* __restrict__ S, const float* __restrict__ la_last,
                    const float* __restrict__ state0, float* __restrict__ state_out,
                    float* __restrict__ hs, int H, int PN, int nc) {
  const int e = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long sidx = ((long long)b * H + h) * PN + e;
  float4 st = state0 != nullptr ? *reinterpret_cast<const float4*>(state0 + sidx)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc; ++c) {
    const long long bch = ((long long)b * nc + c) * H + h;
    if (c > 0) *reinterpret_cast<float4*>(hs + bch * PN + e) = st;
    const float d = expf(la_last[bch]);
    const float4 s = *reinterpret_cast<const float4*>(S + bch * PN + e);
    st.x = st.x * d + s.x;
    st.y = st.y * d + s.y;
    st.z = st.z * d + s.z;
    st.w = st.w * d + s.w;
  }
  *reinterpret_cast<float4*>(state_out + sidx) = st;
}

// Phase 3, chunk scan. CTA (b·nc·H + c·H + h, block of 16·kTiles rows);
// tile t (warp t, or warps 2t and 2t + 1, which take alternate 16-column
// blocks of h and alternate 16-step blocks of j) owns chunk rows
// i_base + 16t.. and all P columns. Its inputs stream in stages through a
// ring of buffers:
//   stage 0: the C rows → A fragments in registers (exact bf16);
//   stages 1..nh: 64 columns n of the entering state h_c (f32, split three
//     ways on the fly): y = C · h_c, then y ⊙= e^{la_i};
//   then B and x for 64 steps j each: y += Σ_{j ≤ i} (C Bᵀ ⊙ e^{la_i − la_j}
//     ⊙ dt_j) x_j, per 16 steps: C Bᵀ by one pass, the weights in f32, split
//     three ways, times x.
// A pair's sums are added at the end, always in the same order. Pairs run
// 4 tiles (64 rows) with a ring of four stages, one CTA per SM; single
// warps run 8 tiles (128 rows, so that h, B and x are read by half as many
// CTAs) with a ring of two, within 128 registers, two CTAs per SM.
template <int P, int kPair>
__global__ void __launch_bounds__(256, 3 - kPair)
    ssd_scan_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A, const bf16* __restrict__ Bm,
                        const bf16* __restrict__ Cm, const float* __restrict__ state0,
                        const float* __restrict__ hs, bf16* __restrict__ y, int T_len, int H,
                        int N, int Q, int nc, Seq xs, Seq dts, Seq bs, Seq cs) {
  constexpr int NB = P / 8, kXS = P + 8, kMaxK = kMaxN / 16;
  constexpr int kThreads = 256, kRing = scan_ring(kPair), kRows = scan_rows(kPair);
  extern __shared__ __align__(16) unsigned char smem[];
  float* dt_s = reinterpret_cast<float*>(smem);
  float* la_s = dt_s + kMaxQ;
  bf16* ring = reinterpret_cast<bf16*>(smem + 2 * kMaxQ * sizeof(float));
  const int NS = N + 8, nk = N / 16, slot = scan_slot(P, N, kRows);

  const int bch = blockIdx.x, h = bch % H, c = (bch / H) % nc, b = bch / (H * nc);
  const int i_base = (gridDim.y - 1 - blockIdx.y) * kRows;  // the heaviest row blocks first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int tile = warp / kPair, half = warp % kPair;
  const int t0 = c * Q, q_valid = min(Q, T_len - t0);
  if (i_base >= q_valid) return;
  const int j_end = min(i_base + kRows, q_valid);  // steps any row of the CTA needs
  // the entering state: state0 for the first chunk (none: no inter term), else phase 2's
  const float* hsrc = c > 0 ? hs + (long long)bch * P * N
                 : state0 == nullptr ? nullptr : state0 + ((long long)b * H + h) * P * N;
  const int nh = hsrc == nullptr ? 0 : (N + kHCols - 1) / kHCols;
  const int n_stages = 1 + nh + (j_end + kJB - 1) / kJB;
  auto issue = [&](int st) {
    if (st < n_stages) {
      bf16* buf = ring + (st % kRing) * slot;
      if (st == 0) {
        for (int idx = tid; idx < kRows * (N / 8); idx += kThreads) {
          const int r = idx / (N / 8), cc = (idx % (N / 8)) * 8;
          const bool ok = i_base + r < q_valid;
          cp_async16(&buf[r * NS + cc],
                     ok ? Cm + b * cs.b + (long long)(t0 + i_base + r) * cs.t + cc : Cm, ok);
        }
      } else if (st <= nh) {  // h_c[p, n0 .. n0 + 63], f32, rows of kHS floats
        float* hb = reinterpret_cast<float*>(buf);
        const int n0 = (st - 1) * kHCols;
        for (int idx = tid; idx < P * (kHCols / 4); idx += kThreads) {
          const int r = idx / (kHCols / 4), cc = (idx % (kHCols / 4)) * 4;
          const bool ok = n0 + cc < N;
          cp_async16(&hb[r * kHS + cc], ok ? hsrc + (long long)r * N + n0 + cc : hsrc, ok);
        }
      } else {
        const int j0 = (st - 1 - nh) * kJB;
        bf16* Xs = buf + kJB * NS;
        for (int idx = tid; idx < kJB * (N / 8); idx += kThreads) {
          const int r = idx / (N / 8), cc = (idx % (N / 8)) * 8;
          const bool ok = j0 + r < q_valid;
          cp_async16(&buf[r * NS + cc],
                     ok ? Bm + b * bs.b + (long long)(t0 + j0 + r) * bs.t + cc : Bm, ok);
        }
        for (int idx = tid; idx < kJB * (P / 8); idx += kThreads) {
          const int r = idx / (P / 8), cc = (idx % (P / 8)) * 8;
          const bool ok = j0 + r < q_valid;
          cp_async16(&Xs[r * kXS + cc],
                     ok ? x + b * xs.b + (long long)(t0 + j0 + r) * xs.t + (long long)h * P + cc
                        : x,
                     ok);
        }
      }
    }
    cp_async_commit();
  };
  const DtFetch<kThreads> dtf(dt, dts, b, t0, h, q_valid);
#pragma unroll
  for (int st = 0; st < kRing - 1; ++st) issue(st);
  dtf.finish(Q, A[h], dt_s, la_s);

  const int wr = tile * 16, i0 = i_base + wr + g, i1 = i0 + 8;  // this thread's two rows
  const bool active = i_base + wr < q_valid;
  const float la0 = la_s[i0], la1 = la_s[i1];
  uint32_t cf[kMaxK][4];
  float acc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kRing - 2>();
    __syncthreads();  // this stage's tiles are visible; stage st − 1's buffer is free
    issue(st + kRing - 1);
    const bf16* buf = ring + (st % kRing) * slot;
    if (st == 0) {
#pragma unroll
      for (int kk = 0; kk < kMaxK; ++kk) {
        if (kk < nk) {
          const bf16* p = &buf[(wr + g) * NS + kk * 16 + 2 * t4];
          cf[kk][0] = lds32(p);
          cf[kk][1] = lds32(p + 8 * NS);
          cf[kk][2] = lds32(p + 8);
          cf[kk][3] = lds32(p + 8 * NS + 8);
        }
      }
    } else if (st <= nh) {
      if (active) {
        const float* hb = reinterpret_cast<const float*>(buf);
        const int kk0 = (st - 1) * (kHCols / 16);
#pragma unroll
        for (int q = 0; q < kHCols / 16 / kPair; ++q) {  // this warp's 16-column blocks of h
          const int kl = kPair * q + half, kk = kk0 + kl;
          if (kk >= nk) continue;
          uint32_t a[4];  // cf[kk], picked by compile-time indices
#pragma unroll
          for (int k2 = 0; k2 < kMaxK; ++k2)
            if (k2 == kk) a[0] = cf[k2][0], a[1] = cf[k2][1], a[2] = cf[k2][2], a[3] = cf[k2][3];
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            const float* hp = &hb[(nb * 8 + g) * kHS + kl * 16 + 2 * t4];
            const float2 v0 = *reinterpret_cast<const float2*>(hp);
            const float2 v1 = *reinterpret_cast<const float2*>(hp + 8);
            uint32_t b0h, b0m, b0l, b1h, b1m, b1l;
            split_pair(v0.x, v0.y, b0h, b0m, b0l);
            split_pair(v1.x, v1.y, b1h, b1m, b1l);
            mma_16816(acc[nb], a, b0l, b1l);
            mma_16816(acc[nb], a, b0m, b1m);
            mma_16816(acc[nb], a, b0h, b1h);
          }
        }
      }
    } else if (active) {
      if (st == nh + 1 && nh > 0) {  // the inter term is complete: scale it by e^{la_i}
        const float e0 = expf(la0), e1 = expf(la1);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          acc[nb][0] *= e0;
          acc[nb][1] *= e0;
          acc[nb][2] *= e1;
          acc[nb][3] *= e1;
        }
      }
      const int j0 = (st - 1 - nh) * kJB;
      const bf16* Bs = buf;
      const bf16* Xs = buf + kJB * NS;
      for (int s = half; s < kJB / 16; s += kPair) {
        const int js = j0 + s * 16;
        if (js > i_base + wr || js >= j_end) break;  // steps past this tile's last row
        float cb[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < kMaxK; ++kk) {
          if (kk < nk) {
#pragma unroll
            for (int nj = 0; nj < 2; ++nj) {
              const bf16* p = &Bs[(s * 16 + nj * 8 + g) * NS + kk * 16 + 2 * t4];
              mma_16816(cb[nj], cf[kk], lds32(p), lds32(p + 8));
            }
          }
        }
        // the accumulator of C Bᵀ is the A fragment of the weights:
        // av[e] = cb[e >> 2][e & 3] at row i0 or i1, column js + 8(e>>2) + 2t4 + (e&1)
        float av[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = (e & 2) ? i1 : i0;
          const float lai = (e & 2) ? la1 : la0;
          const int j = js + (e >> 2) * 8 + 2 * t4 + (e & 1);
          const float w = cb[e >> 2][e & 3] * expf(lai - la_s[j]) * dt_s[j];
          av[e] = j <= i ? w : 0.f;
        }
        uint32_t hi[4], mid[4], lo[4];
        split_frag(av, hi, mid, lo);
#pragma unroll
        for (int pb = 0; pb < NB / 2; ++pb) {
          uint32_t xf[4];
          ldsm_x4_trans(xf, &Xs[(s * 16 + (lane & 15)) * kXS + pb * 16 + (lane >> 4) * 8]);
          mma3(acc[2 * pb], hi, mid, lo, xf[0], xf[1]);
          mma3(acc[2 * pb + 1], hi, mid, lo, xf[2], xf[3]);
        }
      }
    }
  }
  if (kPair == 2) {
    cp_async_wait<0>();
    pair_reduce(acc, reinterpret_cast<float*>(ring), tile, half, lane);
  }
  if (!active || half != 0) return;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int p = nb * 8 + 2 * t4;
    if (i0 < q_valid)
      *reinterpret_cast<uint32_t*>(y + (((long long)b * T_len + t0 + i0) * H + h) * P + p) =
          pack_bf16(acc[nb][0], acc[nb][1]);
    if (i1 < q_valid)
      *reinterpret_cast<uint32_t*>(y + (((long long)b * T_len + t0 + i1) * H + h) * P + p) =
          pack_bf16(acc[nb][2], acc[nb][3]);
  }
}

size_t scan_mma_smem(int P, int N, int kPair) {
  return 2 * kMaxQ * sizeof(float) +
         scan_ring(kPair) * (size_t)scan_slot(P, N, scan_rows(kPair)) * sizeof(bf16);
}

int sm_count() {
  static int cached[16] = {};  // by device ordinal
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  int& n = cached[dev & 15];
  if (n == 0 && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    n = 132;
  return n;
}

template <int P, int kPair>
int launch_scan(const bf16* x, const float* dt, const float* A, const bf16* Bm, const bf16* Cm,
                const float* state0, const float* hs, bf16* y, int B, int T_len, int H, int N,
                int Q, int nc, Seq xs, Seq dts, Seq bs, Seq cs, cudaStream_t st) {
  const size_t smem = scan_mma_smem(P, N, kPair);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_mma_kernel<P, kPair>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = scan_rows(kPair);
  ssd_scan_mma_kernel<P, kPair><<<dim3(B * nc * H, (Q + rows - 1) / rows), 256, smem, st>>>(
      x, dt, A, Bm, Cm, state0, hs, y, T_len, H, N, Q, nc, xs, dts, bs, cs);
  return (int)cudaGetLastError();
}

// scratch: S (B, nc, H, P, N) f32 | hs (B, nc, H, P, N) f32 | la_Q (B, nc, H) f32
template <int P>
int launch_mma(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
               const void* state0, void* y, void* state_out, void* scratch, int B, int T_len,
               int H, int N, int Q, Seq xs, Seq dts, Seq bs, Seq cs, cudaStream_t st) {
  const int nc = (T_len + Q - 1) / Q;
  const size_t ent = (size_t)B * nc * H * P * N;
  float* S = static_cast<float*>(scratch);
  float* hs = S + ent;
  float* la_last = hs + ent;
  const bf16 *xp = (const bf16*)x, *Bp = (const bf16*)Bm, *Cp = (const bf16*)Cm;
  const float *dtp = (const float*)dt, *Ap = (const float*)A, *s0 = (const float*)state0;
  const long long sms = sm_count(), bch = (long long)B * nc * H;
  // pairs where one CTA per SM is all the grid gives
  const bool state_pairs = (N + 63) / 64 * bch < sms;
  if (state_pairs)
    ssd_state_kernel<P, 2><<<dim3((N + 31) / 32, nc, B * H), kStateWarps * 32, 0, st>>>(
        xp, dtp, Ap, Bp, S, la_last, T_len, H, N, Q, nc, xs, dts, bs);
  else
    ssd_state_kernel<P, 1><<<dim3((N + 63) / 64, nc, B * H), kStateWarps * 32, 0, st>>>(
        xp, dtp, Ap, Bp, S, la_last, T_len, H, N, Q, nc, xs, dts, bs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_pass_kernel<<<dim3((P * N + 1023) / 1024, H, B), 256, 0, st>>>(
      S, la_last, s0, (float*)state_out, hs, H, P * N, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (bch * ((Q + scan_rows(2) - 1) / scan_rows(2)) <= sms)
    return launch_scan<P, 2>(xp, dtp, Ap, Bp, Cp, s0, hs, (bf16*)y, B, T_len, H, N, Q, nc, xs,
                             dts, bs, cs, st);
  return launch_scan<P, 1>(xp, dtp, Ap, Bp, Cp, s0, hs, (bf16*)y, B, T_len, H, N, Q, nc, xs, dts,
                           bs, cs, st);
}

}  // namespace

// x (B, T, H, P) with (h, p) contiguous, dt (B, T, H) f32 with h contiguous,
// A (H,) f32, Bm and Cm (B, T, N) with n contiguous (G = 1), each read
// through its (b, t) strides in elements; state0 (B, H, P, N) f32 contiguous
// or null (zeros). Writes y (B, T, H, P) contiguous in x's dtype and
// state_out (B, H, P, N) f32. dtype 0 is float32, 1 bfloat16 (x, Bm, Cm, y).
// Q ≤ 256, N ≤ 128. path 0 is the simt body, whose scratch is
// B · ceil(T/Q) · Q · Q f32; path 1 the mma body (bf16, P ∈ {32, 64},
// N % 16 == 0, base pointers and (b, t) strides of x, Bm, Cm 16-byte
// aligned), whose scratch is B · ceil(T/Q) · H · (8 · P · N + 4) bytes.
REPRO_EXPORT int repro_ssd(const void* x, const void* dt, const void* A, const void* Bm,
                           const void* Cm, const void* state0, void* y, void* state_out,
                           void* scratch, int dtype, int path, int B, int T_len, int H, int P,
                           int N, int Q, long long xsb, long long xst, long long dtsb,
                           long long dtst, long long bsb, long long bst, long long csb,
                           long long cst, void* stream) {
  if (B < 0 || T_len < 0 || H <= 0 || P <= 0 || N <= 0 || N > kMaxN || Q <= 0 || Q > kMaxQ ||
      (dtype != 0 && dtype != 1) || (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  if (path == 1 && (dtype != 1 || (P != 32 && P != 64) || N % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  if (T_len == 0) {  // no steps: the state passes through
    const size_t bytes = (size_t)B * H * P * N * sizeof(float);
    if (state0 == nullptr) return (int)cudaMemsetAsync(state_out, 0, bytes, (cudaStream_t)stream);
    return (int)cudaMemcpyAsync(state_out, state0, bytes, cudaMemcpyDeviceToDevice,
                                (cudaStream_t)stream);
  }
  const Seq xs{xsb, xst}, dts{dtsb, dtst}, bs{bsb, bst}, cs{csb, cst};
  cudaStream_t st = (cudaStream_t)stream;
  if (path == 1) {
    if (P == 64)
      return launch_mma<64>(x, dt, A, Bm, Cm, state0, y, state_out, scratch, B, T_len, H, N, Q,
                            xs, dts, bs, cs, st);
    return launch_mma<32>(x, dt, A, Bm, Cm, state0, y, state_out, scratch, B, T_len, H, N, Q, xs,
                          dts, bs, cs, st);
  }
  if (dtype == 0)
    return launch_simt<float>(x, dt, A, Bm, Cm, state0, y, state_out, scratch, B, T_len, H, P,
                              N, Q, xs, dts, bs, cs, st);
  return launch_simt<__nv_bfloat16>(x, dt, A, Bm, Cm, state0, y, state_out, scratch, B, T_len,
                                    H, P, N, Q, xs, dts, bs, cs, st);
}
