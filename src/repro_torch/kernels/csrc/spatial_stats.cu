// Per-frame, per-class occupancy statistics of a thresholded CAM grid.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/spatial_predicate.py::spatial_stats_bgc      (full batch)
//   src/repro/kernels/spatial_predicate.py::spatial_stats_rows_bgc (row list)
// with one kernel body, an optional row list and an optional class list.
//
// out[r, j] = [min_row, max_row, min_col, max_col, count] over the cells
// of frame rows[r] (or r) whose value of class classes[j] (or j), widened
// to float32, is > tau; an empty class gives [g, -1, g, -1, 0].
// (B, g, g, C) float32, bfloat16 or float16 in, float32 (R, C', 5) out.
//
// Bound on an H100: memory, and at the planner's sizes (32 frames of
// 56 x 56 x 3, under 1.2 MB) latency: the kernel reads each element once
// and does one compare per element.  Design against that:
//   - one block per output frame, or, where one block would need more
//     than two rounds of loads (a large frame: 56 x 56 x 8), a
//     thread-block cluster of S <= 8 blocks per frame, S capped so that
//     R * S blocks fill about three quarters of the SMs;
//   - 16-byte vector loads where the frame's span is 16-byte aligned, an
//     elementwise loop of the same body otherwise, several loads in flight
//     per thread.  The class planes are read in place from the full grid:
//     a (C,) lookup in shared memory maps a class to its output slot (or
//     to none), so the gathered (B, g, g, C') grid is never built;
//   - the host sizes the block so that a frame's thread count times the
//     loads' width is a multiple of C: lane k of a thread then meets one
//     class in every step, and its row and column advance by constants.
//     Extrema and counts stay in registers (no atomics in the loop);
//   - each lane merges once into the block's (C', 5) by shared-memory
//     atomics; in a cluster the other blocks fold theirs into block rank
//     0's through distributed shared memory, one atomic a field, and rank
//     0 writes the row: no second launch, no global scratch.  Integer
//     min/max/add in any order are exact, so the result is bit-identical
//     with the plain version;
//   - row and class ids are read on the device, int32 or int64, through
//     their strides; an id out of range traps (the launch fails and the
//     error surfaces at the next synchronisation).  One launch per call.
#include <climits>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxClasses = 1024;     // of the grid, and of the class list
constexpr int kMaxCluster = 8;        // the portable cluster size
constexpr int kBlock = 256;           // preferred threads per block

// Loads a thread keeps in flight: 8 x 16 bytes, or 4 for 16-bit types
// (their 8 lanes hold more registers), or 8 single elements.
template <int V>
__host__ __device__ constexpr int loads_in_flight() { return V == 8 ? 4 : 8; }

struct Params {
  const void* x;            // (B, g, g, C) contiguous
  const void* rows;         // (R,) ids or null (then R = B)
  const void* classes;      // (C',) ids or null (then C' = C)
  float* out;               // (R, C', 5)
  long long rows_stride, classes_stride;
  int B, g, C, Cp, S;
  int rows64, classes64;
  float tau;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

__device__ __forceinline__ long long load_id(const void* p, long long i,
                                             int is64) {
  return is64 ? __ldg((const long long*)p + i)
              : (long long)__ldg((const int*)p + i);
}

// The two halves of a cluster barrier: shared memory written before
// arrive() is visible to every block of the cluster after wait().
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T, int V>
struct alignas(V * sizeof(T)) Pack {
  T v[V];
};

// V consecutive elements starting at element i * V
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* __restrict__ x,
                                                long long i) {
  Pack<T, V> p;
  if constexpr (V == 1) {
    p.v[0] = x[i];
  } else {
    static_assert(V * sizeof(T) == 16, "vector loads are 16 bytes");
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x) + i);
    p = *reinterpret_cast<const Pack<T, V>*>(&raw);
  }
  return p;
}

template <typename T, int V>
__global__ void __launch_bounds__(V == 1 ? 1024 : kBlock)
spatial_stats_kernel(const Params p) {
  extern __shared__ int sm[];
  int* lut = sm;                // (C,): class -> slot, INT_MAX if not read
  int* st = sm + p.C;           // (C', 5) of this block
  int* listed = st + 5 * p.Cp;  // (C',): the class list
  const int S = p.S, g = p.g, C = p.C, Cp = p.Cp;
  const int tid = threadIdx.x, bd = blockDim.x;
  const int r = blockIdx.x / S;      // a 1-D cluster is S blocks in a row
  const int rank = blockIdx.x % S;   // so this is its rank in the cluster

  for (int c = tid; c < C; c += bd) lut[c] = p.classes ? INT_MAX : c;
  for (int s = tid; s < Cp; s += bd) {
    st[5 * s + 0] = g;
    st[5 * s + 1] = -1;
    st[5 * s + 2] = g;
    st[5 * s + 3] = -1;
    st[5 * s + 4] = 0;
  }
  long long frame = r;
  if (p.rows) {
    frame = load_id(p.rows, r * p.rows_stride, p.rows64);
    if (frame < 0 || frame >= p.B) __trap();
  }
  // Lane k of thread t meets element t * V + k + i * nt * V in step i;
  // the host made nt * V a multiple of C, so its class is fixed and its
  // cell advances by nt * V / C cells a step.  The first U loads are
  // issued before the class lookup is built, so the two overlap.
  const int g2 = g * g;
  const int nt = S * bd;                             // threads per frame
  const int t = rank * bd + tid;
  const long long units = (long long)g2 * C / V;     // loads per frame
  const T* __restrict__ xf = (const T*)p.x + frame * (long long)g2 * C;
  constexpr int U = loads_in_flight<V>();
  Pack<T, V> buf[U];
  long long i0 = t;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (i0 + (long long)u * nt < units)
      buf[u] = load_pack<T, V>(xf, i0 + (long long)u * nt);

  // the cluster's blocks merge into rank 0's (C', 5) once every block has
  // initialised its own: arrive now, wait just before the merge
  if (S > 1) cluster_arrive();
  __syncthreads();
  if (p.classes) {
    for (int j = tid; j < Cp; j += bd) {
      const long long c = load_id(p.classes, j * p.classes_stride,
                                  p.classes64);
      if (c < 0 || c >= C) __trap();
      listed[j] = (int)c;
      atomicMin(&lut[c], j);    // a repeated class reads its first slot
    }
    __syncthreads();
  }

  const int step = (int)((long long)nt * V / C);
  const int dr = step / g, dc = step % g;
  int slot[V], row[V], col[V], mnr[V], mxr[V], mnc[V], mxc[V], n[V];
  {
    int c = t * V % C, cell = t * V / C;
    int rr = cell / g, cc = cell % g;
#pragma unroll
    for (int k = 0; k < V; ++k) {   // lanes are consecutive elements
      const int s = lut[c];
      slot[k] = s == INT_MAX ? -1 : s;
      row[k] = rr;
      col[k] = cc;
      mnr[k] = g;
      mxr[k] = -1;
      mnc[k] = g;
      mxc[k] = -1;
      n[k] = 0;
      if (++c == C) {
        c = 0;
        if (++cc == g) {
          cc = 0;
          ++rr;
        }
      }
    }
  }
  const float tau = p.tau;
  while (i0 < units) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + (long long)u * nt < units) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          if (slot[k] >= 0 && widen(buf[u].v[k]) > tau) {
            mnr[k] = min(mnr[k], row[k]);
            mxr[k] = max(mxr[k], row[k]);
            mnc[k] = min(mnc[k], col[k]);
            mxc[k] = max(mxc[k], col[k]);
            ++n[k];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        row[k] += dr;
        col[k] += dc;
        if (col[k] >= g) {
          col[k] -= g;
          ++row[k];
        }
      }
    }
    i0 += (long long)U * nt;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + (long long)u * nt < units)
        buf[u] = load_pack<T, V>(xf, i0 + (long long)u * nt);
  }

  // one merge per lane that met a cell above tau: measured on an H100, a
  // warp reduction per slot before it (redux.sync) was no faster at
  // 56 x 56 x 3 and slower at C = 8
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (slot[k] >= 0 && n[k] > 0) {
      int* o = st + 5 * slot[k];
      atomicMin(o + 0, mnr[k]);
      atomicMax(o + 1, mxr[k]);
      atomicMin(o + 2, mnc[k]);
      atomicMax(o + 3, mxc[k]);
      atomicAdd(o + 4, n[k]);
    }
  }
  __syncthreads();
  if (S > 1) {
    // each block's (C', 5) is whole: the others fold theirs into rank
    // 0's through distributed shared memory, one atomic a live field
    cluster_wait();
    if (rank != 0) {
      int* dst = cg::this_cluster().map_shared_rank(st, 0);
      for (int e = tid; e < Cp * 5; e += bd) {
        const int f = e % 5, v = st[e];
        if (f == 4) {
          if (v) atomicAdd(dst + e, v);
        } else if (f & 1) {
          if (v >= 0) atomicMax(dst + e, v);
        } else if (v < g) {
          atomicMin(dst + e, v);
        }
      }
    }
    cg::this_cluster().sync();  // every block's merge has landed
    if (rank != 0) return;
  }
  float* o = p.out + (long long)r * Cp * 5;
  for (int e = tid; e < Cp * 5; e += bd) {
    const int j = e / 5;
    const int s = p.classes ? lut[listed[j]] : j;
    o[e] = (float)st[5 * s + e % 5];
  }
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Threads per block: a multiple of m = C / gcd(C, S * V), so that a
// frame's S * bd * V elements per step are a multiple of C; a multiple of
// 32 up to kBlock where that is possible.  0 if only more than `most` do.
int block_threads(int C, int V, int S, int most) {
  const int m = C / gcd(C, S * V);
  const int unit = m / gcd(m, 32) * 32;
  if (unit <= kBlock) return kBlock / unit * unit;
  if (m <= kBlock) return kBlock / m * m;
  return m <= most ? m : 0;
}

int sm_count() {
  static int counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    counts[dev] = 132;
  return counts[dev];
}

template <typename T, int V>
int launch(const Params& p, int R, int bd, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(R * p.S));
  cfg.blockDim = dim3((unsigned)bd);
  cfg.dynamicSmemBytes = (size_t)(p.C + 6 * p.Cp) * sizeof(int);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.S > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, spatial_stats_kernel<T, V>,
                                             p);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Picks the cluster size S, the block size and the load width, and
// launches.
template <typename T>
int dispatch(Params& p, int R, int cluster, bool aligned,
             cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const long long g2c = (long long)p.g * p.g * p.C;
  const bool vec = aligned && g2c % V == 0;
  const long long units = vec ? g2c / V : g2c;
  // A frame is split over a cluster only where one block would need more
  // than two rounds of loads (U per thread); then into about one round
  // per block, on at most three quarters of the SMs.  Measured on an H100
  // (chip_smoke.py's cluster sweep): at 56 x 56 x 3 (1.15 rounds) one
  // block per frame is fastest, at 56 x 56 x 8 (3.1 rounds) S = 3 for 32
  // frames and S = 4 for 16, where a full wave (S = 4 and 8) is slower.
  const long long round =
      (long long)(vec ? loads_in_flight<V>() : loads_in_flight<1>()) * kBlock;
  int S = cluster;
  if (S <= 0) {
    S = 1;
    if (units > 2 * round) {
      const long long by_work = (units + round - 1) / round;
      const long long by_sms = 3LL * sm_count() / (4LL * R);
      S = (int)(by_work < by_sms ? by_work : by_sms);
      S = S < 1 ? 1 : S > kMaxCluster ? kMaxCluster : S;
    }
  }
  if (S < 1 || S > kMaxCluster || (long long)R * S > INT_MAX)
    return (int)cudaErrorInvalidValue;
  p.S = S;
  const int bd_vec = vec ? block_threads(p.C, V, S, kBlock) : 0;
  const int bd = bd_vec ? bd_vec : block_threads(p.C, 1, S, 1024);
  if (!bd) return (int)cudaErrorInvalidValue;
  return bd_vec ? launch<T, V>(p, R, bd, stream)
                : launch<T, 1>(p, R, bd, stream);
}

// a[0..3]: x, rows (or 0), classes (or 0), out; a[4..]: B, R, g, C, C',
// dtype (0 float32, 1 bfloat16, 2 float16), rows is int64, rows stride,
// classes is int64, classes stride, cluster size (0: the host picks).
// 1 <= C <= 1024, C' <= 1024.
int run(const long long* a, float tau, cudaStream_t stream) {
  Params p;
  p.x = (const void*)a[0];
  p.rows = (const void*)a[1];
  p.classes = (const void*)a[2];
  p.out = (float*)a[3];
  p.B = (int)a[4];
  const int R = (int)a[5];
  p.g = (int)a[6];
  p.C = (int)a[7];
  p.Cp = (int)a[8];
  const int dtype = (int)a[9];
  p.rows64 = (int)a[10];
  p.rows_stride = a[11];
  p.classes64 = (int)a[12];
  p.classes_stride = a[13];
  const int cluster = (int)a[14];
  p.tau = tau;
  p.S = 1;
  if (R <= 0 || p.Cp <= 0) return 0;
  if (p.g <= 0 || p.C < 1 || p.C > kMaxClasses || p.Cp > kMaxClasses ||
      (p.classes == nullptr && p.Cp != p.C) ||
      (long long)p.g * p.g > INT_MAX / kMaxClasses)
    return (int)cudaErrorInvalidValue;
  const bool aligned = ((unsigned long long)p.x & 15) == 0;
  if (dtype == 0)
    return dispatch<float>(p, R, cluster, aligned, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(p, R, cluster, aligned, stream);
  if (dtype == 2)
    return dispatch<__half>(p, R, cluster, aligned, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One launch on `stream`; returns its cudaError_t.  `a` as for run().
extern "C" int spatial_stats_launch(const long long* a, float tau,
                                    void* stream) {
  return run(a, tau, (cudaStream_t)stream);
}

