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
// causal work is 2·B·H·S²·d ≈ 4.3 GFLOP (≈ 4.3 µs at the 989 TFLOP/s bf16
// tensor-core peak); the bytes are ≈ 9.4 MB (≈ 2.8 µs). Operations bound it.
//
// Two bodies behind one entry point:
//  - bf16 with d ∈ {16, 32, 64, 128}: tensor cores through mma.sync
//    m16n8k16 (bf16 in, f32 accumulate) on 16-byte aligned rows (the
//    wrapper copies an input that is not aligned). One CTA of four
//    warps per (b·h, 64-row q tile); each warp owns 16 q rows whose Q
//    fragments stay in registers. K and V tiles of 64 keys are staged in
//    shared memory (rows padded by 8 bf16, so the fragment loads hit 32
//    distinct banks); S = QKᵀ stays in registers, the online softmax runs on
//    it in the log2 domain, and P is re-packed in registers as the A operand
//    of PV (the FlashAttention-2 register layout). The softmax weights are
//    rounded to bf16 for the PV product, as every bf16 flash kernel does;
//    the running sum takes them in f32.
//  - everything else (f32, or d not a multiple of 16, up to 128): plain f32
//    FMA. Two threads per q row, each holding every other dimension of q and
//    of the accumulator; K and V tiles of 32 keys in shared memory as f32.
// Both skip key tiles above the diagonal, and launch the q tiles with the
// most key tiles first.
#include <stdint.h>

#include "common.cuh"

namespace {

struct Strides {
  long long b, s, h;  // elements; the d stride is 1
};

constexpr int kMmaRows = 64;   // q rows per CTA (4 warps × 16)
constexpr int kMmaKeys = 64;   // keys per staged tile
constexpr int kMmaThreads = 128;
constexpr int kSimtRows = 64;  // q rows per CTA (2 threads each)
constexpr int kSimtKeys = 32;
constexpr int kSimtThreads = 128;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// D = A·B + D for one 16×8×16 tile: A row-major 16×16 bf16 (4 regs), B
// column-major 16×8 bf16 (2 regs), D 16×8 f32 (4 regs).
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

template <typename T, int DMAX>
__global__ void __launch_bounds__(kSimtThreads)
    flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, int S, int H, int KV, int d, Strides qs, Strides ks,
                      Strides vs, float scale, int causal) {
  constexpr int DH = DMAX / 2;  // dimensions 2i + half of q and acc per thread
  __shared__ float Ks[kSimtKeys * DMAX];
  __shared__ float Vs[kSimtKeys * DMAX];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int qtile = gridDim.y - 1 - blockIdx.y;
  const int half = threadIdx.x & 1;
  const int row = qtile * kSimtRows + (threadIdx.x >> 1);

  const T* qr = q + b * qs.b + h * qs.h + (long long)row * qs.s;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  float qv[DH], acc[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    const int dim = 2 * i + half;
    qv[i] = (row < S && dim < d) ? to_float(qr[dim]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -1e30f, l = 0.f;

  const int last_key = causal ? min(S, qtile * kSimtRows + kSimtRows) : S;
  const int n_tiles = (last_key + kSimtKeys - 1) / kSimtKeys;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kSimtKeys;
    __syncthreads();
    for (int i = threadIdx.x; i < kSimtKeys * DMAX; i += kSimtThreads) {
      const int r = i / DMAX, c = i % DMAX;
      const bool ok = k0 + r < S && c < d;
      Ks[i] = ok ? to_float(kb[(long long)(k0 + r) * ks.s + c]) : 0.f;
      Vs[i] = ok ? to_float(vb[(long long)(k0 + r) * vs.s + c]) : 0.f;
    }
    __syncthreads();
    float sc[kSimtKeys];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int kk = 0; kk < kSimtKeys; ++kk) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) dot = fmaf(qv[i], Ks[kk * DMAX + 2 * i + half], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
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
    for (int kk = 0; kk < kSimtKeys; ++kk) {
      const float p = expf(sc[kk] - mn);
      l += p;
#pragma unroll
      for (int i = 0; i < DH; ++i) acc[i] = fmaf(p, Vs[kk * DMAX + 2 * i + half], acc[i]);
    }
  }
  if (row >= S) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* orow = o + (((long long)b * S + row) * H + h) * d;
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    const int dim = 2 * i + half;
    if (dim < d) orow[dim] = from_float<T>(acc[i] * inv);
  }
}

template <typename T>
int launch_simt(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KV,
                int d, Strides qs, Strides ks, Strides vs, float scale, int causal,
                cudaStream_t st) {
  const dim3 grid(B * H, (S + kSimtRows - 1) / kSimtRows);
  const T* qp = (const T*)q;
  const T* kp = (const T*)k;
  const T* vp = (const T*)v;
  T* op = (T*)o;
  if (d <= 16)
    flash_simt_kernel<T, 16><<<grid, kSimtThreads, 0, st>>>(qp, kp, vp, op, S, H, KV, d, qs, ks,
                                                            vs, scale, causal);
  else if (d <= 32)
    flash_simt_kernel<T, 32><<<grid, kSimtThreads, 0, st>>>(qp, kp, vp, op, S, H, KV, d, qs, ks,
                                                            vs, scale, causal);
  else if (d <= 64)
    flash_simt_kernel<T, 64><<<grid, kSimtThreads, 0, st>>>(qp, kp, vp, op, S, H, KV, d, qs, ks,
                                                            vs, scale, causal);
  else
    flash_simt_kernel<T, 128><<<grid, kSimtThreads, 0, st>>>(qp, kp, vp, op, S, H, KV, d, qs, ks,
                                                             vs, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, H, d), k and v (B, S, KV, d) with unit d stride, read through the
// given (b, s, h) strides in elements; o (B, S, H, d) contiguous. dtype 0 is
// float32, 1 bfloat16. path 1 asks for the tensor-core body (bf16, d a
// multiple of 16 up to 128, every pointer and row stride 16-byte aligned),
// path 0 for the f32-FMA body (d ≤ 128). scale multiplies q·k.
REPRO_EXPORT int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                       int dtype, int path, int B, int S, int H, int KV, int d,
                                       long long qsb, long long qss, long long qsh,
                                       long long ksb, long long kss, long long ksh,
                                       long long vsb, long long vss, long long vsh, int causal,
                                       float scale, void* stream) {
  if (B < 0 || S < 0 || H <= 0 || KV <= 0 || H % KV != 0 || d <= 0 || d > 128 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  if (path == 1) {
    if (dtype != 1 || d % 16 != 0) return (int)cudaErrorInvalidValue;
    const dim3 grid(B * H, (S + kMmaRows - 1) / kMmaRows);
    const float sl2 = scale * 1.4426950408889634f;
    const __nv_bfloat16* qp = (const __nv_bfloat16*)q;
    const __nv_bfloat16* kp = (const __nv_bfloat16*)k;
    const __nv_bfloat16* vp = (const __nv_bfloat16*)v;
    __nv_bfloat16* op = (__nv_bfloat16*)o;
    switch (d) {
      case 16:
        flash_mma_kernel<16><<<grid, kMmaThreads, 0, st>>>(qp, kp, vp, op, S, H, KV, qs, ks, vs,
                                                           sl2, causal);
        break;
      case 32:
        flash_mma_kernel<32><<<grid, kMmaThreads, 0, st>>>(qp, kp, vp, op, S, H, KV, qs, ks, vs,
                                                           sl2, causal);
        break;
      case 64:
        flash_mma_kernel<64><<<grid, kMmaThreads, 0, st>>>(qp, kp, vp, op, S, H, KV, qs, ks, vs,
                                                           sl2, causal);
        break;
      default:
        flash_mma_kernel<128><<<grid, kMmaThreads, 0, st>>>(qp, kp, vp, op, S, H, KV, qs, ks,
                                                            vs, sl2, causal);
    }
    return (int)cudaGetLastError();
  }
  if (dtype == 0)
    return launch_simt<float>(q, k, v, o, B, S, H, KV, d, qs, ks, vs, scale, causal, st);
  return launch_simt<__nv_bfloat16>(q, k, v, o, B, S, H, KV, d, qs, ks, vs, scale, causal, st);
}
