// Single-token attention over a KV cache, the G query heads of each kv head
// resident (GQA decode).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention.py::decode_attention_bkgd
//
// o[b, n, g] = sum_{j < kv_len} softmax_j(q[b, n, g] . k[b, n, j] * scale)
//              v[b, n, j]
// q (B, KV, G, hd), k and v (B, KV, S, hd), float32 or bfloat16 (one type),
// contiguous; kv_len an int32 on the device, 1 <= kv_len <= S; G <= 16,
// hd in {64, 128}.  o (B, KV, G, hd) in q's type.
//
// Arithmetic (the TPU kernel's): scores q k^T * scale in fp32, keys at
// kv_len or later score NEG_INF = -0.7 * FLT_MAX, online softmax with the
// running max m, sum l and accumulator acc in fp32, the probabilities
// rounded to v's type before the product with v, o = acc / max(l, 1e-30).
//
// Bound on an H100: bytes.  Every valid cache row is read once, 2 kv_len hd
// elements per (b, n), against 4 G kv_len hd flops: at qwen2-0.5b's
// decode_32k (B 128, KV 2, G 7, hd 64, bf16, kv_len 30000) that is ~1.97 GB
// against ~14 GFLOP, ~0.59 ms at 3.35 TB/s.  Design against that bound:
//   - the TPU kernel walks the cache on a sequential grid axis; here the
//     cache is cut into splits (flash decoding), one block per (split, kv
//     head, b), so that a small batch still fills the card; each block
//     leaves (m, l, acc) for its split, and a second small kernel merges
//     the splits (a single split writes the output directly);
//   - tiles of 64 keys are copied into shared memory with cp.async, two
//     stages deep, so the next tile's loads are in flight while this one
//     is used; rows at kv_len or later are zero-filled, never read, and a
//     split wholly past kv_len loads nothing (the TPU kernel's
//     pl.when(k_start < kv_len));
//   - each of the block's two warps owns 32 keys of a tile, one per lane:
//     a lane takes its key's scores for all G rows (q staged once, fp32,
//     read as broadcast 16-byte vectors), the row max and sum are warp
//     shuffles, and a warp whose 32 keys all lie at kv_len or later skips
//     the tile;
//   - for p v each lane owns hd/32 columns of all G rows of the
//     accumulator, reading p from a small per-warp shared tile;
//   - the two warps' states are merged through shared memory at the end.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32 * kWarps;     // keys per tile: one per lane
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

// 16 bytes of T -> floats (8 for bfloat16, 4 for float32)
__device__ __forceinline__ void chunk_to_f(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
__device__ __forceinline__ void chunk_to_f(const __nv_bfloat16* p,
                                           float* out) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// NC consecutive elements of T -> floats
template <int NC>
__device__ __forceinline__ void cols_to_f(const float* p, float* out) {
#pragma unroll
  for (int c = 0; c < NC; ++c) out[c] = p[c];
}
template <int NC>
__device__ __forceinline__ void cols_to_f(const __nv_bfloat16* p,
                                          float* out) {
#pragma unroll
  for (int c = 0; c < NC; c += 2) {
    const unsigned w = *reinterpret_cast<const unsigned*>(p + c);
    out[c] = __uint_as_float(w << 16);
    out[c + 1] = __uint_as_float(w & 0xffff0000u);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;           // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
struct Geometry {
  static constexpr int kRowBytes = HD * (int)sizeof(T) + 16;  // padded row
  static constexpr int kTileBytes = kTile * kRowBytes;
  static constexpr int kChunks = HD * (int)sizeof(T) / 16;    // per row
};

template <typename T, int HD, int GB>
constexpr size_t smem_bytes() {
  return (size_t)GB * HD * 4 + (size_t)kWarps * GB * 32 * 4 +
         (size_t)4 * Geometry<T, HD>::kTileBytes;
}

// grid (nsplit, KV, B).  part: (B, KV, nsplit, G * (HD + 2)) float32 with
// acc (G, HD), then m (G), then l (G); unused when nsplit == 1.
template <typename T, int HD, int GB>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ kv_len_p, T* __restrict__ o,
                        float* __restrict__ part, int KV, int G, int S,
                        int span, float scale) {
  using Geo = Geometry<T, HD>;
  constexpr int NC = HD / 32;                   // accumulator columns/lane
  constexpr int EPC = 16 / (int)sizeof(T);      // elements per 16 bytes
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // GB x HD
  float* ps = qs + GB * HD;                     // kWarps x GB x 32
  char* kvbuf = reinterpret_cast<char*>(ps + kWarps * GB * 32);

  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const long long bn = (long long)b * KV + n;
  const T* qb = q + bn * G * HD;
  const T* kb = k + bn * S * HD;
  const T* vb = v + bn * S * HD;
  const int kv_len = min(max(*kv_len_p, 0), S);
  const int lo = split * span;
  const int hi = min(lo + span, kv_len);
  const int n_tiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;

  for (int i = tid; i < GB * HD; i += kThreads)
    qs[i] = i < G * HD ? to_f(qb[i]) : 0.f;

  auto load_tile = [&](int stage, int t0) {
    char* kd = kvbuf + stage * 2 * Geo::kTileBytes;
    char* vd = kd + Geo::kTileBytes;
    for (int i = tid; i < kTile * Geo::kChunks; i += kThreads) {
      const int row = i / Geo::kChunks;
      const int c = i - row * Geo::kChunks;
      const int key = t0 + row;
      const bool in = key < hi;
      const long long off = in ? (long long)key * HD + c * EPC : 0;
      cp_async16(kd + row * Geo::kRowBytes + c * 16, kb + off, in);
      cp_async16(vd + row * Geo::kRowBytes + c * 16, vb + off, in);
    }
  };

  float m[GB], l[GB], acc[GB][NC];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[g][c] = 0.f;
  }

  if (n_tiles > 0) {
    load_tile(0, lo);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = lo + it * kTile;
    if (it + 1 < n_tiles) {
      load_tile((it + 1) & 1, t0 + kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t0 + w * 32 < hi) {                    // warp-uniform skip
      const char* kd = kvbuf + (it & 1) * 2 * Geo::kTileBytes;
      const char* vd = kd + Geo::kTileBytes;
      // scores of this lane's key for all GB rows
      const T* krow =
          reinterpret_cast<const T*>(kd + (w * 32 + lane) * Geo::kRowBytes);
      float s[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) s[g] = 0.f;
#pragma unroll 2
      for (int c = 0; c < Geo::kChunks; ++c) {
        float kf[EPC];
        chunk_to_f(krow + c * EPC, kf);
#pragma unroll
        for (int e = 0; e < EPC; e += 4) {
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qs + g * HD + c * EPC + e);
            s[g] = fmaf(qv.x, kf[e], s[g]);
            s[g] = fmaf(qv.y, kf[e + 1], s[g]);
            s[g] = fmaf(qv.z, kf[e + 2], s[g]);
            s[g] = fmaf(qv.w, kf[e + 3], s[g]);
          }
        }
      }
      // online softmax over the warp's 32 keys
      const bool valid = t0 + w * 32 + lane < hi;
      float* pw = ps + w * GB * 32;
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float sc = valid ? s[g] * scale : kNegInf;
        const float m_new = fmaxf(m[g], warp_max(sc));
        const float corr = expf(m[g] - m_new);
        const float p = expf(sc - m_new);
        l[g] = l[g] * corr + warp_sum(p);
        m[g] = m_new;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[g][c] *= corr;
        pw[g * 32 + lane] = to_f(from_f<T>(p));   // p in v's type
      }
      __syncwarp();
      // acc += p v over the warp's 32 keys, 4 at a time
      for (int j = 0; j < 32; j += 4) {
        float vv[4][NC];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          cols_to_f<NC>(reinterpret_cast<const T*>(
                            vd + (w * 32 + j + jj) * Geo::kRowBytes) +
                            lane * NC,
                        vv[jj]);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float4 p4 = *reinterpret_cast<const float4*>(pw + g * 32 + j);
          const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int c = 0; c < NC; ++c)
              acc[g][c] = fmaf(pj[jj], vv[jj][c], acc[g][c]);
        }
      }
      __syncwarp();
    }
    __syncthreads();                           // this stage is consumed
  }

  // merge the warps' states through shared memory (the tiles are free)
  float* cm = reinterpret_cast<float*>(kvbuf);  // kWarps x GB
  float* cl = cm + kWarps * GB;                 // kWarps x GB
  float* ca = cl + kWarps * GB;                 // kWarps x GB x HD
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (lane == 0) {
      cm[w * GB + g] = m[g];
      cl[w * GB + g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) ca[(w * GB + g) * HD + lane * NC + c] =
        acc[g][c];
  }
  __syncthreads();
  float* pb = part + (bn * nsplit + split) * (long long)G * (HD + 2);
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i - g * HD;
    float mx = kNegInf;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) mx = fmaxf(mx, cm[ww * GB + g]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) {
      const float f = expf(cm[ww * GB + g] - mx);
      lt += cl[ww * GB + g] * f;
      at += ca[(ww * GB + g) * HD + d] * f;
    }
    if (nsplit == 1) {
      o[(bn * G + g) * HD + d] = from_f<T>(at / fmaxf(lt, 1e-30f));
    } else {
      pb[g * HD + d] = at;
      if (d == 0) {
        pb[G * HD + g] = mx;
        pb[G * HD + G + g] = lt;
      }
    }
  }
}

// grid (KV, B): merge the splits' (m, l, acc) into o.
template <typename T, int HD>
__global__ void __launch_bounds__(128)
decode_attention_merge(const float* __restrict__ part, T* __restrict__ o,
                       int KV, int G, int nsplit) {
  const long long bn = (long long)blockIdx.y * KV + blockIdx.x;
  const long long pitch = (long long)G * (HD + 2);
  const float* pb = part + bn * nsplit * pitch;
  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) {
    const int g = i / HD;
    float mx = kNegInf;
    for (int s = 0; s < nsplit; ++s)
      mx = fmaxf(mx, pb[s * pitch + G * HD + g]);
    float lt = 0.f, at = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float f = expf(pb[s * pitch + G * HD + g] - mx);
      lt += pb[s * pitch + G * HD + G + g] * f;
      at += pb[s * pitch + i] * f;
    }
    o[bn * G * HD + i] = from_f<T>(at / fmaxf(lt, 1e-30f));
  }
}

template <typename T, int HD, int GB>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* o, float* part, int B, int KV, int G, int S, int span,
           int nsplit, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD, GB>();
  cudaError_t e = cudaFuncSetAttribute(
      decode_attention_kernel<T, HD, GB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) {      // report it, leave no stale error behind
    cudaGetLastError();
    return (int)e;
  }
  decode_attention_kernel<T, HD, GB>
      <<<dim3(nsplit, KV, B), kThreads, smem, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, kv_len, (T*)o, part, KV, G,
          S, span, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  decode_attention_merge<T, HD><<<dim3(KV, B), 128, 0, stream>>>(
      part, (T*)o, KV, G, nsplit);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_g(const void* q, const void* k, const void* v, const int* kv_len,
             void* o, float* part, int B, int KV, int G, int S, int span,
             int nsplit, float scale, cudaStream_t s) {
  if (G <= 4)
    return launch<T, HD, 4>(q, k, v, kv_len, o, part, B, KV, G, S, span,
                            nsplit, scale, s);
  if (G <= 8)
    return launch<T, HD, 8>(q, k, v, kv_len, o, part, B, KV, G, S, span,
                            nsplit, scale, s);
  return launch<T, HD, 16>(q, k, v, kv_len, o, part, B, KV, G, S, span,
                           nsplit, scale, s);
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, const int* kv_len,
              void* o, float* part, int B, int KV, int G, int S, int hd,
              int span, int nsplit, float scale, cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch_g<T, 64>(q, k, v, kv_len, o, part, B, KV, G, S, span,
                             nsplit, scale, s);
    case 128:
      return launch_g<T, 128>(q, k, v, kv_len, o, part, B, KV, G, S, span,
                              nsplit, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, KV, G, hd); k, v: (B, KV, S, hd); contiguous, all of one type:
// dtype 0 = float32, 1 = bfloat16.  kv_len: one int32 on the device.
// The cache is cut into nsplit splits of span keys (span a multiple of 64,
// nsplit * span >= S); part: (B, KV, nsplit, G * (hd + 2)) float32 scratch
// when nsplit > 1.  G in 1..16, hd in {64, 128}.
// Returns cudaGetLastError() of the launches.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* kv_len,
                                       void* o, void* part, int B, int KV,
                                       int G, int S, int hd, int dtype,
                                       int span, int nsplit, float scale,
                                       void* stream) {
  if (B <= 0 || KV <= 0) return 0;
  if (G < 1 || G > 16 || S < 1 || span < 1 || span % kTile != 0 ||
      nsplit < 1 || (long long)nsplit * span < S || KV > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* len = (const int*)kv_len;
  float* p = (float*)part;
  if (dtype == 0)
    return launch_hd<float>(q, k, v, len, o, p, B, KV, G, S, hd, span,
                            nsplit, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, len, o, p, B, KV, G, S, hd,
                                    span, nsplit, scale, s);
  return (int)cudaErrorInvalidValue;
}
