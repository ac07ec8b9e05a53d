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
// features and write B*P*C*4 bytes of CAM; it does 2*B*P*D*C flops, i.e.
// C/2 flops per byte read, far below the fp32 balance point (~20
// flops/byte) for the few classes a filter head has.  Design against
// that bound:
//   - one block per frame; w is staged in shared memory once per block
//     and read as a broadcast;
//   - the frame's features stream through a shared-memory tile of
//     CELLS x DT floats, loaded with consecutive threads on consecutive
//     addresses (each feature element read once, coalesced), padded by
//     one column so the per-thread row reads are free of bank conflicts;
//   - each thread owns one cell of the tile and accumulates its C outputs
//     in registers with fp32 FMAs over D, in order, then writes them;
//   - the counts need the column sums of the CAM over the frame: each
//     thread adds its cells' outputs to its own row of a shared buffer,
//     and a fixed-order tree over the threads reduces the rows.  No float
//     atomics, so every run gives the same bits.
#include <cuda_runtime.h>

namespace {

constexpr int kCells = 256;     // threads per block = cells per tile
constexpr int kDT = 32;         // feature columns per tile
constexpr int kPitch = kDT + 1;

template <int CM>
__global__ void cam_head_kernel(const float* __restrict__ feat,
                                const float* __restrict__ w,
                                const float* __restrict__ bias,
                                float* __restrict__ counts,
                                float* __restrict__ cam,
                                int P, int D, int C) {
  extern __shared__ float sm[];
  float* w_s = sm;                                 // D * C
  float* tile = w_s + (size_t)D * C;               // kCells * kPitch
  float* part = tile + kCells * kPitch;            // kCells * C

  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < D * C; i += kCells) w_s[i] = w[i];
  for (int i = tid; i < kCells * C; i += kCells) part[i] = 0.f;
  __syncthreads();

  const float* fp = feat + (long long)f * P * D;
  float* cp = cam + (long long)f * P * C;
  for (int base = 0; base < P; base += kCells) {
    float acc[CM];
#pragma unroll
    for (int c = 0; c < CM; ++c) acc[c] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kDT) {
      __syncthreads();                             // tile free to refill
      for (int i = tid; i < kCells * kDT; i += kCells) {
        const int rr = i / kDT;
        const int cc = i - rr * kDT;
        const int cell = base + rr;
        const int d = d0 + cc;
        tile[rr * kPitch + cc] =
            (cell < P && d < D) ? fp[(long long)cell * D + d] : 0.f;
      }
      __syncthreads();
      const int dn = min(kDT, D - d0);
      const float* row = tile + tid * kPitch;
      for (int j = 0; j < dn; ++j) {
        const float v = row[j];
        const float* wr = w_s + (size_t)(d0 + j) * C;
#pragma unroll
        for (int c = 0; c < CM; ++c)
          if (c < C) acc[c] = fmaf(v, wr[c], acc[c]);
      }
    }
    const int cell = base + tid;
    if (cell < P) {
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        if (c < C) {
          cp[(long long)cell * C + c] = acc[c];
          part[tid * C + c] += acc[c];
        }
      }
    }
  }
  __syncthreads();

  // fixed-order tree over the kCells per-thread rows
  for (int s = kCells / 2; s > 0; s >>= 1) {
    for (int i = tid; i < s * C; i += kCells) {
      const int t = i / C;
      const int c = i - t * C;
      part[t * C + c] += part[(t + s) * C + c];
    }
    __syncthreads();
  }
  for (int c = tid; c < C; c += kCells)
    counts[(long long)f * C + c] = fmaxf(part[c] / (float)P + bias[c], 0.f);
}

template <int CM>
int launch(const float* feat, const float* w, const float* b, float* counts,
           float* cam, int B, int P, int D, int C, cudaStream_t stream) {
  const size_t smem =
      ((size_t)D * C + (size_t)kCells * kPitch + (size_t)kCells * C) *
      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      cam_head_kernel<CM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) {      // e.g. more shared memory than the card
    cudaGetLastError();        // allows: report it, leave no stale error
    return (int)e;
  }
  cam_head_kernel<CM><<<B, kCells, smem, stream>>>(feat, w, b, counts, cam,
                                                   P, D, C);
  return (int)cudaGetLastError();
}

}  // namespace

// feat: (B, P, D), w: (D, C), b: (C,), counts: (B, C), cam: (B, P, C), all
// float32 contiguous; 1 <= C <= 64.  Returns cudaGetLastError().
extern "C" int cam_head_launch(const void* feat, const void* w, const void* b,
                               void* counts, void* cam, int B, int P, int D,
                               int C, void* stream) {
  if (B <= 0) return 0;
  const float* f = (const float*)feat;
  const float* wp = (const float*)w;
  const float* bp = (const float*)b;
  float* co = (float*)counts;
  float* ca = (float*)cam;
  cudaStream_t s = (cudaStream_t)stream;
  if (C <= 4) return launch<4>(f, wp, bp, co, ca, B, P, D, C, s);
  if (C <= 8) return launch<8>(f, wp, bp, co, ca, B, P, D, C, s);
  if (C <= 16) return launch<16>(f, wp, bp, co, ca, B, P, D, C, s);
  if (C <= 32) return launch<32>(f, wp, bp, co, ca, B, P, D, C, s);
  if (C <= 64) return launch<64>(f, wp, bp, co, ca, B, P, D, C, s);
  return (int)cudaErrorInvalidValue;
}
