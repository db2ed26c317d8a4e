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
// The TPU kernel carries the (N, P) state across a sequential grid. Here one
// CTA walks the chunks of one (b, h, 16 columns of P) in a loop: columns of P
// are independent (y[:, p] needs only state[:, p]), so a grid of
// (P/16, H, B) — 128 CTAs for one mamba2 request — fills the card with no
// sum across CTAs. C Bᵀ is the same for every head (G = 1) and every column
// block, so a first kernel computes its lower triangle once per (b, chunk)
// into scratch, and the scan reads it back from L2 in tiles of 16 columns.
// B and C are never staged whole: at Q = 256, N = 128 one f32 chunk of B
// alone is 128 KB. The scan keeps la, x·dt (Q × 16), the state (N × 16) and
// one C Bᵀ tile (Q × 16) in 44 KB of shared memory; thread i owns row i of
// the chunk for y, and threads (n, half) own 8 state entries for the update.
//
// Bound on the H100 at the serve path's prefill (1, 1024, 32, 64), N = 128,
// Q = 256: ≈ 1.65 GFLOP of f32 work (C Bᵀ once per chunk, then per head the
// intra, inter and state terms) ≈ 25 µs at the 67 TFLOP/s f32 peak; the bytes
// (≈ 10.6 MB with bf16 x/y/B/C and f32 state) ≈ 3.2 µs. Operations bound it.
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
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
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

}  // namespace

// x (B, T, H, P) with (h, p) contiguous, dt (B, T, H) f32 with h contiguous,
// A (H,) f32, Bm and Cm (B, T, N) with n contiguous (G = 1), each read
// through its (b, t) strides in elements; state0 (B, H, P, N) f32 contiguous
// or null (zeros). Writes y (B, T, H, P) contiguous in x's dtype and
// state_out (B, H, P, N) f32; cb is scratch of B · ceil(T/Q) · Q · Q f32.
// dtype 0 is float32, 1 bfloat16 (x, Bm, Cm, y). Q ≤ 256, N ≤ 128.
REPRO_EXPORT int repro_ssd(const void* x, const void* dt, const void* A, const void* Bm,
                           const void* Cm, const void* state0, void* y, void* state_out,
                           void* cb, int dtype, int B, int T_len, int H, int P, int N, int Q,
                           long long xsb, long long xst, long long dtsb, long long dtst,
                           long long bsb, long long bst, long long csb, long long cst,
                           void* stream) {
  if (B < 0 || T_len < 0 || H <= 0 || P <= 0 || N <= 0 || N > kMaxN || Q <= 0 || Q > kMaxQ ||
      (dtype != 0 && dtype != 1))
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
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, state0, y, state_out, cb, B, T_len, H, P, N, Q, xs,
                         dts, bs, cs, st);
  return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, state0, y, state_out, cb, B, T_len, H, P, N,
                               Q, xs, dts, bs, cs, st);
}
