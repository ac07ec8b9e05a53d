// Fused class-activation-map head (paper Eq. 1 with GAP + FC).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/cam_head.py::cam_head_bgd
//
// cam[b, p, c] = sum_d feat[b, p, d] * w[d, c]            (float32 FMAs)
// counts[b, c] = relu(sum_p cam[b, p, c] / P + bias[c])
// feat (B, P, D), w (D, C), bias (C,) float32 -> counts (B, C), cam (B, P, C).
//
// Bound on an H100: memory.  The kernel must read B*P*D*4 bytes of
// features (at the filter's (32, 3136, 256) that is 102.8 MB, more than
// the 50 MB L2) and write B*P*C*4 bytes of CAM; it does 2*B*P*D*C flops,
// C/2 flops per byte read, far below the fp32 balance point for the few
// classes a filter head has.  So the time is set by how many bytes are
// in flight across the 132 SMs: at 3.35 TB/s and ~1 us of latency that
// is ~25-32 KB per SM.  Design against that bound:
//   - the grid is (tile of kTile cells, frame): 49 x 32 = 1,568 blocks at
//     the filter's shape, about 12 per SM, whatever B is;
//   - each warp owns kRows cells and streams their rows with 16-byte
//     loads marked evict-first (a 256-float row is 64 float4, two per
//     lane): kRows independent loads per lane are in flight before the
//     first FMA, 4 KB per warp, 64 KB per SM at two blocks per SM;
//   - w is staged in shared memory four classes at a time, as one float4
//     per feature, and read as a broadcast;
//   - each cell's partial dot products are reduced across the warp by an
//     xor butterfly of shuffles (a fixed order; every lane ends with the
//     same bits), and one lane per cell writes the CAM;
//   - the counts need the column sums of the CAM over the frame: each
//     block sums its cells in order into a (B, n_tiles, C) scratch
//     buffer, and a second small kernel sums the tiles in tile order and
//     applies /P + b and relu.  No float atomics, so every run gives the
//     same bits;
//   - where D is not a multiple of 4 or feat is not 16-byte aligned, a
//     scalar path reads one float per lane; the ragged last tile is
//     masked; C > 4 takes ceil(C / 4) passes over the tile.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;                 // cells per warp
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kRows * kWarps;    // cells per block
constexpr int kCB = 4;                   // classes per pass

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
cam_tile_kernel(const float* __restrict__ feat, const float* __restrict__ w,
                float* __restrict__ cam, float* __restrict__ part, int P,
                int D, int C) {
  extern __shared__ float4 w_s[];               // D x kCB classes
  __shared__ float warp_part[kWarps][kCB];
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int n_tiles = gridDim.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cell0 = tile * kTile + warp * kRows;
  const float* fb = feat + ((long long)b * P + cell0) * D;
  float* cb = cam + ((long long)b * P + cell0) * C;

  for (int c0 = 0; c0 < C; c0 += kCB) {
    __syncthreads();                            // w_s and warp_part free
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float4 v;
      v.x = w[(long long)d * C + c0];
      v.y = c0 + 1 < C ? w[(long long)d * C + c0 + 1] : 0.f;
      v.z = c0 + 2 < C ? w[(long long)d * C + c0 + 2] : 0.f;
      v.w = c0 + 3 < C ? w[(long long)d * C + c0 + 3] : 0.f;
      w_s[d] = v;
    }
    __syncthreads();

    float acc[kRows][kCB];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCB; ++c) acc[r][c] = 0.f;

    if (VEC) {
      const int D4 = D >> 2;
      for (int d4 = lane; d4 < D4; d4 += 32) {
        float4 x[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          x[r] = cell0 + r < P
                     ? __ldcs(reinterpret_cast<const float4*>(
                                  fb + (long long)r * D) + d4)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 w0 = w_s[4 * d4], w1 = w_s[4 * d4 + 1],
                     w2 = w_s[4 * d4 + 2], w3 = w_s[4 * d4 + 3];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r][0] = fmaf(x[r].x, w0.x, acc[r][0]);
          acc[r][1] = fmaf(x[r].x, w0.y, acc[r][1]);
          acc[r][2] = fmaf(x[r].x, w0.z, acc[r][2]);
          acc[r][3] = fmaf(x[r].x, w0.w, acc[r][3]);
          acc[r][0] = fmaf(x[r].y, w1.x, acc[r][0]);
          acc[r][1] = fmaf(x[r].y, w1.y, acc[r][1]);
          acc[r][2] = fmaf(x[r].y, w1.z, acc[r][2]);
          acc[r][3] = fmaf(x[r].y, w1.w, acc[r][3]);
          acc[r][0] = fmaf(x[r].z, w2.x, acc[r][0]);
          acc[r][1] = fmaf(x[r].z, w2.y, acc[r][1]);
          acc[r][2] = fmaf(x[r].z, w2.z, acc[r][2]);
          acc[r][3] = fmaf(x[r].z, w2.w, acc[r][3]);
          acc[r][0] = fmaf(x[r].w, w3.x, acc[r][0]);
          acc[r][1] = fmaf(x[r].w, w3.y, acc[r][1]);
          acc[r][2] = fmaf(x[r].w, w3.z, acc[r][2]);
          acc[r][3] = fmaf(x[r].w, w3.w, acc[r][3]);
        }
      }
    } else {
      for (int d = lane; d < D; d += 32) {
        float x[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          x[r] = cell0 + r < P ? fb[(long long)r * D + d] : 0.f;
        const float4 wv = w_s[d];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r][0] = fmaf(x[r], wv.x, acc[r][0]);
          acc[r][1] = fmaf(x[r], wv.y, acc[r][1]);
          acc[r][2] = fmaf(x[r], wv.z, acc[r][2]);
          acc[r][3] = fmaf(x[r], wv.w, acc[r][3]);
        }
      }
    }

    // per-cell sums across the warp; then the warp's column sums over its
    // cells, in cell order (cells past P hold zeros)
    float col[kCB] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < kCB; ++c) {
        const float s = warp_sum(acc[r][c]);
        col[c] += s;
        if (lane == r * kCB + c && cell0 + r < P && c0 + c < C)
          cb[(long long)r * C + c0 + c] = s;
      }
    }
    if (lane < kCB) {
      float v = col[0];
      if (lane == 1) v = col[1];
      if (lane == 2) v = col[2];
      if (lane == 3) v = col[3];
      warp_part[warp][lane] = v;
    }
    __syncthreads();
    if (threadIdx.x < kCB && c0 + threadIdx.x < C) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) s += warp_part[i][threadIdx.x];
      part[((long long)b * n_tiles + tile) * C + c0 + threadIdx.x] = s;
    }
  }
}

// counts[b, c] = relu(sum over tiles, in tile order, of part / P + bias)
__global__ void cam_counts_kernel(const float* __restrict__ part,
                                  const float* __restrict__ bias,
                                  float* __restrict__ counts, int n_tiles,
                                  int P, int C) {
  const int b = blockIdx.x;
  const int c = threadIdx.x;
  if (c >= C) return;
  const float* pb = part + (long long)b * n_tiles * C + c;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += pb[(long long)t * C];
  counts[(long long)b * C + c] = fmaxf(s / (float)P + bias[c], 0.f);
}

}  // namespace

// feat: (B, P, D), w: (D, C), b: (C,), counts: (B, C), cam: (B, P, C),
// part: (B, ceil(P / 64), C) scratch, all float32 contiguous; B <= 65535,
// 1 <= C <= 64.  Two launches on `stream`; returns cudaGetLastError().
extern "C" int cam_head_launch(const void* feat, const void* w, const void* b,
                               void* counts, void* cam, void* part, int B,
                               int P, int D, int C, void* stream) {
  if (B <= 0) return 0;
  if (P <= 0 || D <= 0 || C < 1 || C > 64 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = (P + kTile - 1) / kTile;
  const size_t smem = (size_t)D * sizeof(float4);
  const bool vec = D % 4 == 0 && ((unsigned long long)feat & 15) == 0;
  const void* fn = vec ? (const void*)cam_tile_kernel<true>
                       : (const void*)cam_tile_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) {      // e.g. more shared memory than the card
    cudaGetLastError();        // allows: report it, leave no stale error
    return (int)e;
  }
  const dim3 grid(n_tiles, B);
  if (vec)
    cam_tile_kernel<true><<<grid, kThreads, smem, s>>>(
        (const float*)feat, (const float*)w, (float*)cam, (float*)part, P, D,
        C);
  else
    cam_tile_kernel<false><<<grid, kThreads, smem, s>>>(
        (const float*)feat, (const float*)w, (float*)cam, (float*)part, P, D,
        C);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cam_counts_kernel<<<B, 64, 0, s>>>((const float*)part, (const float*)b,
                                     (float*)counts, n_tiles, P, C);
  return (int)cudaGetLastError();
}
