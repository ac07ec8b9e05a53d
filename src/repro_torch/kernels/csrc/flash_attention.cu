// Blocked online-softmax (flash) attention, causal / sliding window / GQA.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_bhsd
//
// o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / G, j] * scale) v[b, h / G, j]
// over the unmasked keys j (causal: j <= i; window w: i - j < w); masked
// scores are NEG_INF = -0.7 * FLT_MAX, as in the TPU kernel and the plain
// version.  q (B, H, Sq, hd), k and v (B, KV, Sk, hd), float32 or bfloat16,
// contiguous; G = H / KV; hd in {32, 64, 128}.  o (B, H, Sq, hd) in q's type.
//
// Arithmetic (the TPU kernel's): scores S = q k^T * scale in fp32 FMAs,
// running max m, sum l and accumulator acc in fp32; the probabilities are
// rounded to v's type before the product with v; o = acc / max(l, 1e-30).
// No TF32 and no tensor cores: the plain version and the JAX reference
// are full fp32.
//
// Bound on an H100: operations.  The work is 4 * B * H * Sq * Sk * hd fp32
// flops (two products) over B * (H * Sq + 2 * KV * Sk) * hd elements read
// once: at the filter trunk's (32, 4, 3136, 32) that is ~161 GFLOP against
// ~51 MB, ~2.4 ms at 67 TFLOP/s of fp32 FMAs and ~0.015 ms of memory.
// The S x S score matrix never leaves the SM.  Design against that bound:
//   - one block per (q tile of 64 rows, head, batch); a loop inside the
//     block walks the key tiles (the TPU's sequential grid axis), so the
//     running (m, l, acc) stay in registers for the whole row block;
//   - 128 threads as 16 row groups x 8 column groups: a thread owns 4
//     query rows x 8 keys of the score tile and 4 rows x hd/8 columns of
//     the accumulator, i.e. the same 4 rows in both products, so the
//     rescaling by exp(m_old - m_new) needs no exchange;
//   - q and k tiles are staged transposed in shared memory (d-major) and
//     the probabilities likewise (key-major), so the inner loops read one
//     16-byte vector of rows and two of keys (or hd/32 of values) per step
//     and do 32 (or 4 * hd/8) FMAs with them; pitches are padded by four
//     floats, which keeps the vectors aligned;
//   - the row max and row sum are reduced over the 8 threads of a row
//     group with warp shuffles; every thread of the group ends with the
//     same bits;
//   - key tiles wholly masked by causality or by the window are skipped
//     before any load, by the TPU kernel's rules; keys past Sk score
//     NEG_INF and query rows past Sq are computed on zeros and never
//     stored, so every Sq and Sk launch (the TPU kernel asserts divisible
//     tiles, and its wrapper falls back to the plain version otherwise).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kQP = kBQ + 4;   // pitch of the transposed q and p tiles
constexpr int kKP = kBK + 4;   // pitch of the transposed k tile
constexpr float kNegInf = (float)(-0.7 * 3.4028234663852886e38);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)HD * kQP + (size_t)HD * kKP + (size_t)kBK * (HD + 4) +
         (size_t)kBK * kQP;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int KV, int Sq, int Sk, float scale, int causal,
                       int window) {
  constexpr int kVP = HD + 4;      // pitch of the v tile
  constexpr int kCV = HD / 32;     // 4-wide column vectors per thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // HD x kQP  (d, row)
  float* kt = qt + HD * kQP;                    // HD x kKP  (d, key)
  float* vs = kt + HD * kKP;                    // kBK x kVP (key, d)
  float* pt = vs + kBK * kVP;                   // kBK x kQP (key, row)

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const int q_hi = min(q0 + kBQ, Sq) - 1;      // last real query row
  const int tid = threadIdx.x;
  const int ty = tid >> 3;                     // rows ty*4 .. ty*4+3
  const int tx = tid & 7;                      // keys / columns tx*4 (+32)
  const T* qb = q + (long long)(b * H + h) * Sq * HD;
  const T* kb = k + (long long)(b * KV + kvh) * Sk * HD;
  const T* vb = v + (long long)(b * KV + kvh) * Sk * HD;
  T* ob = o + (long long)(b * H + h) * Sq * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i - r * HD;
    qt[d * kQP + r] = q0 + r < Sq ? to_f(qb[(long long)(q0 + r) * HD + d])
                                  : 0.f;
  }

  float m[4], l[4], acc[4][4 * kCV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kCV; ++c) acc[i][c] = 0.f;
  }

  const int n_k = (Sk + kBK - 1) / kBK;
  for (int t = 0; t < n_k; ++t) {
    const int k0 = t * kBK;
    // the TPU kernel's skipping rules, on the block's real rows
    if (causal && k0 > q_hi) break;
    if (window > 0 && k0 + kBK - 1 < q0 - window + 1) continue;

    __syncthreads();                 // the previous tile is consumed
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD;
      const int d = i - r * HD;
      const bool in = k0 + r < Sk;
      const long long off = (long long)(k0 + r) * HD + d;
      kt[d * kKP + r] = in ? to_f(kb[off]) : 0.f;
      vs[r * kVP + d] = in ? to_f(vb[off]) : 0.f;
    }
    __syncthreads();

    // S = q k^T for 4 rows x 8 keys
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kQP + ty * 4);
      const float4 b0 =
          *reinterpret_cast<const float4*>(kt + d * kKP + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(kt + d * kKP + 32 + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // mask, online softmax over the tile, rescale the accumulator
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + (j < 4 ? tx * 4 + j : 32 + tx * 4 + j - 4);
        bool keep = kp < Sk;
        if (causal) keep = keep && qp >= kp;
        if (window > 0) keep = keep && qp - kp < window;
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kCV; ++c) acc[i][c] *= corr;
    }
    // p, rounded to v's type, into the key-major tile
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kc = j < 4 ? tx * 4 + j : 32 + tx * 4 + j - 4;
      float4 pv;
      pv.x = to_f(from_f<T>(s[0][j]));
      pv.y = to_f(from_f<T>(s[1][j]));
      pv.z = to_f(from_f<T>(s[2][j]));
      pv.w = to_f(from_f<T>(s[3][j]));
      *reinterpret_cast<float4*>(pt + kc * kQP + ty * 4) = pv;
    }
    __syncthreads();

    // acc += p v for 4 rows x hd/8 columns
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(pt + kk * kQP + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int c = 0; c < kCV; ++c) {
        const float4 bv = *reinterpret_cast<const float4*>(
            vs + kk * kVP + c * 32 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c * 4 + 0] = fmaf(av[i], bv.x, acc[i][c * 4 + 0]);
          acc[i][c * 4 + 1] = fmaf(av[i], bv.y, acc[i][c * 4 + 1]);
          acc[i][c * 4 + 2] = fmaf(av[i], bv.z, acc[i][c * 4 + 2]);
          acc[i][c * 4 + 3] = fmaf(av[i], bv.w, acc[i][c * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCV; ++c)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        ob[(long long)qr * HD + c * 32 + tx * 4 + jj] =
            from_f<T>(acc[i][c * 4 + jj] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int Sq, int Sk, float scale, int causal,
           int window, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) {      // report it, leave no stale error behind
    cudaGetLastError();
    return (int)e;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, KV, Sq, Sk, scale,
      causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int H, int KV, int Sq, int Sk, int hd, float scale, int causal,
              int window, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KV, Sq, Sk, scale, causal,
                           window, s);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Sk, scale, causal,
                           window, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Sk, scale, causal,
                            window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd); o: (B, H, Sq, hd); contiguous,
// all of one type: dtype 0 = float32, 1 = bfloat16.  H % KV == 0,
// hd in {32, 64, 128}; window <= 0 means no sliding window.
// Returns cudaGetLastError() of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int KV, int Sq, int Sk, int hd,
                                      int dtype, int causal, int window,
                                      float scale, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_hd<float>(q, k, v, o, B, H, KV, Sq, Sk, hd, scale, causal,
                            window, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Sk, hd, scale,
                                    causal, window, s);
  return (int)cudaErrorInvalidValue;
}
