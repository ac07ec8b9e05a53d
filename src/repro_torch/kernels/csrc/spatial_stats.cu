// Per-frame, per-class occupancy statistics of a thresholded CAM grid.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/spatial_predicate.py::spatial_stats_bgc      (full batch)
//   src/repro/kernels/spatial_predicate.py::spatial_stats_rows_bgc (row list)
// with one kernel body and an optional row pointer.
//
// out[r, c] = [min_row, max_row, min_col, max_col, count] over the cells
// of frame rows[r] (or r) whose value is > tau; an empty class gives
// [g, -1, g, -1, 0].  float32 (B, g, g, C) in, float32 (R, C, 5) out.
//
// Bound on an H100: memory.  The kernel reads R*g*g*C*4 bytes once and
// does one compare per element, far below the card's ~20 operations per
// byte balance point for fp32.  Design against that bound:
//   - one block per output frame; the block's thread count is a multiple
//     of C, so thread t always owns class t % C and consecutive threads
//     load consecutive addresses of the contiguous (g*g, C) plane
//     (coalesced, each element read once);
//   - each thread keeps its class's extrema and count in registers and
//     merges them once with integer atomicMin/atomicMax/atomicAdd in
//     shared memory.  Integer min/max/add are order-independent, so the
//     result is the same on every run and bit-exact with the plain
//     version; conversion to float happens only at the store;
//   - the row variant reads frame rows[r] in place: the gathered
//     (R, g, g, C) tensor is never built, as in the TPU kernel's
//     scalar-prefetched index map.
#include <cuda_runtime.h>

namespace {

__global__ void spatial_stats_kernel(const float* __restrict__ x,
                                     const int* __restrict__ rows,
                                     float* __restrict__ out,
                                     int g, int C, float tau) {
  extern __shared__ int sm[];
  int* mn_r = sm;
  int* mx_r = sm + C;
  int* mn_c = sm + 2 * C;
  int* mx_c = sm + 3 * C;
  int* cnt = sm + 4 * C;

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const long long frame = rows != nullptr ? rows[r] : r;
  for (int i = tid; i < C; i += blockDim.x) {
    mn_r[i] = g;
    mx_r[i] = -1;
    mn_c[i] = g;
    mx_c[i] = -1;
    cnt[i] = 0;
  }
  __syncthreads();

  const int g2 = g * g;
  const int per = blockDim.x / C;          // threads per class
  const int c = tid % C;
  const float* xf = x + frame * (long long)g2 * C;
  int lmn_r = g, lmx_r = -1, lmn_c = g, lmx_c = -1, n = 0;
  for (int cell = tid / C; cell < g2; cell += per) {
    const float v = xf[(long long)cell * C + c];
    if (v > tau) {
      const int row = cell / g;
      const int col = cell - row * g;
      lmn_r = min(lmn_r, row);
      lmx_r = max(lmx_r, row);
      lmn_c = min(lmn_c, col);
      lmx_c = max(lmx_c, col);
      ++n;
    }
  }
  if (n > 0) {
    atomicMin(&mn_r[c], lmn_r);
    atomicMax(&mx_r[c], lmx_r);
    atomicMin(&mn_c[c], lmn_c);
    atomicMax(&mx_c[c], lmx_c);
    atomicAdd(&cnt[c], n);
  }
  __syncthreads();

  for (int i = tid; i < C; i += blockDim.x) {
    float* o = out + ((long long)r * C + i) * 5;
    o[0] = (float)mn_r[i];
    o[1] = (float)mx_r[i];
    o[2] = (float)mn_c[i];
    o[3] = (float)mx_c[i];
    o[4] = (float)cnt[i];
  }
}

}  // namespace

// x: (B, g, g, C) float32 contiguous; rows: (R,) int32 or null (then R = B);
// out: (R, C, 5) float32.  1 <= C <= 1024.  Returns cudaGetLastError().
extern "C" int spatial_stats_launch(const void* x, const void* rows, void* out,
                                    int R, int g, int C, float tau,
                                    void* stream) {
  if (R <= 0) return 0;
  const int per = C >= 256 ? 1 : 256 / C;
  const int threads = per * C;
  const size_t smem = 5 * (size_t)C * sizeof(int);
  spatial_stats_kernel<<<R, threads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)rows, (float*)out, g, C, tau);
  return (int)cudaGetLastError();
}
