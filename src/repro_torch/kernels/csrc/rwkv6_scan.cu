// RWKV-6 WKV recurrence (per token, fp32 state in registers).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6_scan.py::rwkv6_scan_bhtk
//
// For each (b, h), with the state S (K x V) starting at s0[b, h]:
//   o_t = r_t S_{t-1} + (r_t . u . k_t) v_t
//   S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T
// r, k, v (B, H, T, K|V) float32 or bfloat16 (one type), lw (B, H, T, K)
// float32, u (H, K) float32, s0 (B, H, K, V) float32, all contiguous.
// out (B, H, T, V) in r's type; sT (B, H, K, V) float32.  K in
// {16, 32, 64, 128}; any V >= 1 and any T >= 1.
//
// The TPU kernel is chunked because its matrix unit wants (c, c) products:
// within a chunk it scales r and k by exp(+-cumsum(lw)), up to e^64, and
// carries S across chunks in VMEM.  Here the recurrence runs token by token
// in fp32 FMAs, as the plain version does, so nothing is rescaled and the
// kernel matches the plain version to rounding (the sums are taken in
// another order).
//
// Bound on an H100: operations.  Per token and head the recurrence does
// about 5 K V flops (the r_t S product, the decay and the rank-1 update)
// on 3 K + V input values; at the serving path's prefill (4, 40, 1024, 64)
// that is ~3.4 GFLOP against ~131 MB, ~0.050 ms at 67 TFLOP/s of fp32
// against ~0.039 ms at 3.35 TB/s.  Design against that bound:
//   - the columns of S are independent, so one block owns one (b, h) and a
//     tile of 32 columns of S; no value crosses a block, and splitting V
//     gives more blocks at decode's small batch;
//   - four threads share a column, each holding K/4 of its rows in
//     registers, so a block has 128 threads and the r_t S dot product is
//     four short chains joined by two warp shuffles;
//   - o_t[j] = sum_i r_i (S_ij + u_i k_i v_j) folds the bonus into the same
//     pass, and S_ij <- S_ij w_i + k_i v_j follows it in the same loop;
//   - r_t, k_t and exp(lw_t) of 32 tokens at a time (16 at K = 128, to
//     stay within 48 KB of static shared memory) are staged once in
//     shared memory (fp32, each thread's rows padded so the four row
//     groups of a warp read 16-byte vectors from distinct banks), with
//     v_t of the block's columns beside them;
//   - the T loop runs inside the block; the last chunk is ragged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;            // columns of S per block
constexpr int kSplit = 4;            // threads per column
constexpr int kThreads = kCols * kSplit;

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

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ lw,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  T* __restrict__ out, float* __restrict__ sT, int H, int T_,
                  int V) {
  constexpr int kRows = K / kSplit;         // rows of S per thread
  constexpr int kSeg = kRows + 4;           // padded row segment
  constexpr int kRow = kSplit * kSeg;       // padded token row
  constexpr int kChunk = K <= 64 ? 32 : 16;  // tokens staged per pass
  __shared__ __align__(16) float rs[kChunk * kRow];
  __shared__ __align__(16) float ks[kChunk * kRow];
  __shared__ __align__(16) float ws[kChunk * kRow];
  __shared__ float vs[kChunk * kCols];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int part = tid & (kSplit - 1);      // row group of this thread
  const int c = tid / kSplit;               // column within the tile
  const int col = blockIdx.x * kCols + c;
  const bool live = col < V;
  const long long bh = (long long)b * H + h;
  const T* rb = r + bh * T_ * K;
  const T* kb = k + bh * T_ * K;
  const float* wb = lw + bh * T_ * K;
  const T* vb = v + bh * T_ * V;
  T* ob = out + bh * T_ * V;
  const int row0 = part * kRows;

  float S[kRows], uu[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    S[m] = live ? s0[(bh * K + row0 + m) * V + col] : 0.f;
    uu[m] = u[(long long)h * K + row0 + m];
  }

  for (int t0 = 0; t0 < T_; t0 += kChunk) {
    const int n = min(kChunk, T_ - t0);
    __syncthreads();                        // the previous chunk is consumed
    for (int i = tid; i < n * K; i += kThreads) {
      const int t = i / K;
      const int kk = i - t * K;
      const int dst = t * kRow + (kk / kRows) * kSeg + kk % kRows;
      const long long src = (long long)(t0 + t) * K + kk;
      rs[dst] = to_f(rb[src]);
      ks[dst] = to_f(kb[src]);
      ws[dst] = expf(wb[src]);
    }
    for (int i = tid; i < n * kCols; i += kThreads) {
      const int t = i / kCols;
      const int cc = blockIdx.x * kCols + i - t * kCols;
      vs[i] = cc < V ? to_f(vb[(long long)(t0 + t) * V + cc]) : 0.f;
    }
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const float vj = vs[t * kCols + c];
      const float4* r4 =
          reinterpret_cast<const float4*>(rs + t * kRow + part * kSeg);
      const float4* k4 =
          reinterpret_cast<const float4*>(ks + t * kRow + part * kSeg);
      const float4* w4 =
          reinterpret_cast<const float4*>(ws + t * kRow + part * kSeg);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kRows / 4; ++q) {
        const float4 ra = r4[q], ka = k4[q], wa = w4[q];
        const float rv[4] = {ra.x, ra.y, ra.z, ra.w};
        const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
        const float wv[4] = {wa.x, wa.y, wa.z, wa.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = q * 4 + e;
          const float kvj = kv[e] * vj;
          acc = fmaf(rv[e], fmaf(uu[m], kvj, S[m]), acc);
          S[m] = fmaf(S[m], wv[e], kvj);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (live && part == 0)
        ob[(long long)(t0 + t) * V + col] = from_f<T>(acc);
    }
  }

  if (live) {
#pragma unroll
    for (int m = 0; m < kRows; ++m) sT[(bh * K + row0 + m) * V + col] = S[m];
  }
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const float* lw,
           const float* u, const float* s0, void* out, float* sT, int B,
           int H, int T_, int V, cudaStream_t stream) {
  const dim3 grid((V + kCols - 1) / kCols, H, B);
  rwkv6_scan_kernel<T, K><<<grid, kThreads, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, lw, u, s0, (T*)out, sT, H, T_,
      V);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k(const void* r, const void* k, const void* v, const float* lw,
             const float* u, const float* s0, void* out, float* sT, int B,
             int H, int T_, int K, int V, cudaStream_t s) {
  switch (K) {
    case 16:
      return launch<T, 16>(r, k, v, lw, u, s0, out, sT, B, H, T_, V, s);
    case 32:
      return launch<T, 32>(r, k, v, lw, u, s0, out, sT, B, H, T_, V, s);
    case 64:
      return launch<T, 64>(r, k, v, lw, u, s0, out, sT, B, H, T_, V, s);
    case 128:
      return launch<T, 128>(r, k, v, lw, u, s0, out, sT, B, H, T_, V, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, lw: (B, H, T, K); v: (B, H, T, V); u: (H, K); s0, sT: (B, H, K, V);
// out: (B, H, T, V); contiguous.  dtype of r, k, v and out: 0 = float32,
// 1 = bfloat16; lw, u, s0 and sT are float32.  K in {16, 32, 64, 128}.
// Returns cudaGetLastError() of the launch.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* lw, const void* u,
                                 const void* s0, void* out, void* sT, int B,
                                 int H, int T_, int K, int V, int dtype,
                                 void* stream) {
  if (B <= 0 || H <= 0 || V <= 0) return 0;
  if (T_ <= 0 || H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* lwf = (const float*)lw;
  const float* uf = (const float*)u;
  const float* s0f = (const float*)s0;
  float* sTf = (float*)sT;
  if (dtype == 0)
    return launch_k<float>(r, k, v, lwf, uf, s0f, out, sTf, B, H, T_, K, V,
                           s);
  if (dtype == 1)
    return launch_k<__nv_bfloat16>(r, k, v, lwf, uf, s0f, out, sTf, B, H, T_,
                                   K, V, s);
  return (int)cudaErrorInvalidValue;
}
