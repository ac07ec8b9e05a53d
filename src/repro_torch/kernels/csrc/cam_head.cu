// Fused class-activation-map head (paper Eq. 1 with GAP + FC).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/cam_head.py::cam_head_bgd
//
// cam[b, p, c] = sum_d feat[b, p, d] * w[d, c]            (float32 FMAs)
// counts[b, c] = relu(sum_p cam[b, p, c] / P + bias[c])
// feat (B, P, D), w (D, C), bias (C,), each float32 or bfloat16 (widened
// to float32 as it is loaded, as the Pallas body widens its inputs), any
// C >= 1 -> counts (B, C), cam (B, P, C) float32.
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
//   - where D is not a multiple of 4 or feat is not aligned to four of its
//     values, a scalar path reads one value per lane; the ragged last tile
//     is masked; C > 4 takes ceil(C / 4) passes over the tile (the tile's
//     rows come from L1 / L2 after the first), and the counts kernel
//     takes the classes in blocks of 64, so any C runs; a bf16 feat is
//     read 8 bytes (four values) a lane in the vector path.
// Many classes (C at or above CAM_MMA_MIN_CLASSES in cam_head.py, where
// that body wins on the card) run a second body, cam_mma_kernel below: a
// tiled product on warpgroup MMA (wgmma) fed by TMA.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched
                   // through cudaGetDriverEntryPoint (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;                 // cells per warp
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kRows * kWarps;    // cells per block
constexpr int kCB = 4;                   // classes per pass
constexpr int kCountClasses = 64;        // classes a block of the counts

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// four consecutive features, streamed (evict-first)
__device__ __forceinline__ float4 load_feat4(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load_feat4(const bf16* p) {
  const uint2 a = __ldcs(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(a.x << 16),
                     __uint_as_float(a.x & 0xffff0000u),
                     __uint_as_float(a.y << 16),
                     __uint_as_float(a.y & 0xffff0000u));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename TF, typename TW, bool VEC>
__global__ void __launch_bounds__(kThreads)
cam_tile_kernel(const TF* __restrict__ feat, const TW* __restrict__ w,
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
  const TF* fb = feat + ((long long)b * P + cell0) * D;
  float* cb = cam + ((long long)b * P + cell0) * C;

  for (int c0 = 0; c0 < C; c0 += kCB) {
    __syncthreads();                            // w_s and warp_part free
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float4 v;
      v.x = to_f(w[(long long)d * C + c0]);
      v.y = c0 + 1 < C ? to_f(w[(long long)d * C + c0 + 1]) : 0.f;
      v.z = c0 + 2 < C ? to_f(w[(long long)d * C + c0 + 2]) : 0.f;
      v.w = c0 + 3 < C ? to_f(w[(long long)d * C + c0 + 3]) : 0.f;
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
          x[r] = cell0 + r < P ? load_feat4(fb + (long long)r * D + 4 * d4)
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
          x[r] = cell0 + r < P ? to_f(fb[(long long)r * D + d]) : 0.f;
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

// counts[b, c] = relu(sum over tiles, in tile order, of part / P + bias);
// grid (B, ceil(C / 64)), a class a thread
template <typename TB>
__global__ void cam_counts_kernel(const float* __restrict__ part,
                                  const TB* __restrict__ bias,
                                  float* __restrict__ counts, int n_tiles,
                                  int P, int C) {
  const int b = blockIdx.x;
  const int c = blockIdx.y * kCountClasses + threadIdx.x;
  if (c >= C) return;
  const float* pb = part + (long long)b * n_tiles * C + c;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += pb[(long long)t * C];
  counts[(long long)b * C + c] = fmaxf(s / (float)P + to_f(bias[c]), 0.f);
}


// ---------------------------------------------------------------------------
// Many classes: a tiled product on warpgroup MMA (wgmma), sm_90a.
//
// Past a few classes the streaming body above re-reads every tile (ceil(C
// / 4) passes) and ends each (cell, class) with a shuffle butterfly: at
// (32, 3136, 256) x 128 in float32 it ran at 6.8% of even its SIMT FMA
// bound.  On the tensor cores the bound is the bytes again (102.8 MB of
// float32 features in, 51.4 MB of CAM out: 0.046 ms at 3.35 TB/s; the
// three TF32 products of 3xTF32 take 0.040 ms at 495 TFLOP/s).  Design:
//   - a block is persistent (one an SM) and walks tiles of kBM = 128 cells
//     of one frame x N classes (N: C rounded up to 8, 16, 32, 64 or 128;
//     more classes take blocks of 128, next to each other in the tile
//     order, so that they read the same features through L2);
//   - a producer thread keeps a ring of stages full with TMA: a stage is a
//     K-chunk of 128 bytes a row (32 float32 or 64 bf16 features) of the
//     tile's cells (one box, 128-byte swizzle; cells past P and features
//     past D read as zero) and the same K-chunk of w's planes, armed on a
//     full barrier with expect_tx; each consumer warp arrives on the
//     stage's empty barrier when its products are done;
//   - w (D x C) is split once a call (split_w_kernel) into planes of w^T,
//     K-major, zero past C and D, in a workspace the wrapper allocates:
//     float32 features take TF32 planes (hi and lo of a float32 w; a bf16
//     w is exact in TF32: one plane), bf16 features bf16 planes (a bf16 w
//     as it is; a float32 w as three bf16 terms w1 + w2 + w3, exact to
//     2^-24 of w, so each product is exact in fp32);
//   - two consumer warpgroups take 64 cells each.  Float32 features run
//     3xTF32 (lo w_hi + hi w_lo + hi w_hi; lo w + hi w where w is bf16):
//     each thread reads its A fragments from the swizzled box (no bank
//     conflict), splits them by integer round-to-nearest and issues wgmma
//     m64nNk8 with A from registers.  bf16 features (exact in TF32 too)
//     run wgmma m64nNk16 on both operands in shared memory, one product a
//     plane, small planes first;
//   - the tensor cores sum a wgmma's terms into its accumulator with
//     truncation, so each K-chunk's products start an accumulator of
//     their own (12 products at most), added to the tile's sums with
//     rounded fp32 adds;
//   - the epilogue writes the CAM from the sums and adds the tile's
//     columns in one order (a thread's two rows, an xor butterfly over
//     the warp's 8 row groups, then the 8 warps in order) into the (B,
//     n_tiles, C) scratch that cam_counts_kernel sums.
// No float atomics: a repeated call gives the same bits.
namespace mma {

constexpr int kBM = 128;                      // cells a tile
constexpr int kConsumers = 256;               // two warpgroups of 64 cells
constexpr int kThreads = 128 + kConsumers;    // and a producer warpgroup
// setmaxnreg: the producer's one working thread needs few registers, a
// consumer's 2 x N/2 sums and A fragments need more than the 168 a
// thread of 384 gets at entry
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr uint32_t kRowBytes = 128;           // a box row (the swizzle's)
constexpr uint32_t kFeatBytes = kBM * kRowBytes;   // 16 KB a stage
constexpr uint32_t kRingBytes = 196608;       // the ring's budget
constexpr int kMaxStages = 6;

template <int N, int kPlanes>
struct Ring {
  static constexpr uint32_t kPlane = N * kRowBytes;      // a plane's chunk
  static constexpr uint32_t kStage = kFeatBytes + kPlanes * kPlane;
  static constexpr int kStages = kRingBytes / kStage < kMaxStages
                                     ? (int)(kRingBytes / kStage)
                                     : kMaxStages;
  static constexpr uint32_t kColOff = kStages * kStage;  // column sums x 2
  static constexpr uint32_t kBarOff = kColOff + 2 * 8 * N * 4;
  // barriers (8 bytes each) at kBarOff: full[kStages], empty[kStages]
  static constexpr size_t kSmem = 1024 + kBarOff + 2 * kStages * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// arrive once and expect `bytes` more of TMA traffic on the phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// box (c0, c1, c2) of `map` into shared memory at dst, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accesses to r across a wgmma's async
// window (the asm statements order the instructions, not the registers)
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// K-major shared-memory matrix descriptor, 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// x rounded to TF32 (to nearest, ties away from zero) with the low 13
// bits cleared, so that x - hi is exact
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo; the tensor cores read a TF32 operand's top 19 bits, so lo
// is rounded to nearest by adding half a TF32 ulp
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_hi(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// wgmma m64nN: tf32 (d += a b^T, a 64 x 8 TF32 in registers, b N x 8
// K-major in shared memory) and bf16 (d = (acc ? d : 0) + a b^T, a 64 x
// 16 and b N x 16, both K-major in shared memory); tf32's acc likewise
template <int N>
struct Mma;

template <>
struct Mma<8> {
  static __device__ __forceinline__ void tf32(float (&d)[4],
                                             const uint32_t* a,
                                             uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
  static __device__ __forceinline__ void bf16(float (&d)[4], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Mma<16> {
  static __device__ __forceinline__ void tf32(float (&d)[8],
                                             const uint32_t* a,
                                             uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, "
      "%4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
  static __device__ __forceinline__ void bf16(float (&d)[8], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, "
      "%4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void tf32(float (&d)[16],
                                             const uint32_t* a,
                                             uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, "
      "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, "
      "%18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
  static __device__ __forceinline__ void bf16(float (&d)[16], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, "
      "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, "
      "1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void tf32(float (&d)[32],
                                             const uint32_t* a,
                                             uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, "
      "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
  static __device__ __forceinline__ void bf16(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, "
      "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void tf32(float (&d)[64],
                                             const uint32_t* a,
                                             uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, "
      "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
  static __device__ __forceinline__ void bf16(float (&d)[64], uint64_t da,
                                             uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
  }
};


// the planes of w^T that a call's types take: split_w_kernel's kind, the
// number of planes, their element size and the features a K-chunk
struct Planes {
  int kind, n, esize, cols;
};
inline Planes planes_for(int types) {
  if (!(types & 1))
    return types & 2 ? Planes{1, 1, 4, 32} : Planes{0, 2, 4, 32};
  return types & 2 ? Planes{2, 1, 2, 64} : Planes{3, 3, 2, 64};
}

// the class block: C rounded up to 8, 16, 32, 64 or 128
inline int class_block(int C) {
  return C <= 8 ? 8 : C <= 16 ? 16 : C <= 32 ? 32 : C <= 64 ? 64 : 128;
}

// w (D, C) into planes of w^T (Cp, Dp), K-major, zero past C and D.
// kKind 0: TF32 hi and lo of a float32 w (lo rounded, low bits clear);
// 1: a bf16 w widened (exact in TF32); 2: a bf16 w; 3: three bf16 terms
// of a float32 w (w1 = bf16(w), w2 = bf16(w - w1), w3 = bf16(w - w1 -
// w2)).  A block transposes 32 features x 32 classes through shared
// memory
template <typename TW, int kKind>
__global__ void __launch_bounds__(256)
split_w_kernel(const TW* __restrict__ w, void* __restrict__ ws, int D,
               int C, int Dp, int Cp) {
  __shared__ float tile[32][33];
  const int d0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int r = ty; r < 32; r += 8)
    tile[r][tx] = d0 + r < D && c0 + tx < C
                      ? to_f(w[(long long)(d0 + r) * C + c0 + tx])
                      : 0.f;
  __syncthreads();
  const long long plane = (long long)Cp * Dp;
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    if (c0 + r >= Cp) break;
    const long long at = (long long)(c0 + r) * Dp + d0 + tx;
    const float x = tile[tx][r];
    if constexpr (kKind <= 1) {
      float* o = reinterpret_cast<float*>(ws);
      const float hi = __uint_as_float(tf32_hi(x));
      o[at] = hi;
      if constexpr (kKind == 0)
        o[plane + at] = __uint_as_float(tf32_hi(x - hi));
    } else {
      bf16* o = reinterpret_cast<bf16*>(ws);
      const bf16 w1 = __float2bfloat16_rn(x);
      o[at] = w1;
      if constexpr (kKind == 3) {
        const float r1 = x - __bfloat162float(w1);
        const bf16 w2 = __float2bfloat16_rn(r1);
        o[plane + at] = w2;
        o[2 * plane + at] = __float2bfloat16_rn(r1 - __bfloat162float(w2));
      }
    }
  }
}

template <int N, bool kF32, int kPlanes>
__global__ void __launch_bounds__(kThreads, 1)
cam_mma_kernel(const __grid_constant__ CUtensorMap mf,
               const __grid_constant__ CUtensorMap mw,
               float* __restrict__ cam, float* __restrict__ part, int B,
               int P, int C, int n_tiles, int n_cb, int n_kc) {
  using R = Ring<N, kPlanes>;
  constexpr int kCols = kF32 ? 32 : 64;         // features a K-chunk
  constexpr int kA = N / 2;                     // accumulator registers
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  unsigned char* gbase = smem + (base - smem_u32(smem));
  float* col_s = reinterpret_cast<float*>(gbase + R::kColOff);
  const uint32_t full = base + R::kBarOff, empty = full + 8 * R::kStages;
  const int n_work = B * n_tiles * n_cb;        // (frame, cell tile, class
                                                // block), the last fastest
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the ring full; K-chunk n of the
    // block's sequence goes to stage n % kStages
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int n = 0;
      for (int x = blockIdx.x; x < n_work; x += gridDim.x) {
        const int cb = x % n_cb, ct = x / n_cb % n_tiles;
        const int b = x / n_cb / n_tiles;
        for (int kc = 0; kc < n_kc; ++kc, ++n) {
          const int s = n % R::kStages, u = n / R::kStages;
          if (u > 0) mbar_wait(empty + 8 * s, (u - 1) & 1);
          const uint32_t dst = base + s * R::kStage, bar = full + 8 * s;
          mbar_expect_tx(bar, R::kStage);
          tma_load(dst, &mf, bar, kc * kCols, ct * kBM, b);
#pragma unroll
          for (int p = 0; p < kPlanes; ++p)
            tma_load(dst + kFeatBytes + p * R::kPlane, &mw, bar, kc * kCols,
                     cb * N, p);
        }
      }
    }
    return;
  }

  // ---- consumers: warp w (0-7) owns the tile's rows 16 w .. 16 w + 15,
  // warpgroup w / 4 the 64 rows wgmma takes
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int tid = threadIdx.x - 128;
  const int warp = tid >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = 16 * warp + g;                // this thread's: row, row + 8
  // sums at tot[4 j + e]: row + 8 (e >> 1), class 8 j + 2 t + (e & 1) of
  // the block; acc the K-chunk's, in the same layout
  float tot[kA], acc[kA];
#pragma unroll
  for (int e = 0; e < kA; ++e) acc[e] = 0.f;
  int n = 0, it = 0;
  for (int x = blockIdx.x; x < n_work; x += gridDim.x, ++it) {
    const int cb = x % n_cb, ct = x / n_cb % n_tiles;
    const int b = x / n_cb / n_tiles;
#pragma unroll
    for (int e = 0; e < kA; ++e) tot[e] = 0.f;
    for (int kc = 0; kc < n_kc; ++kc, ++n) {
      const int s = n % R::kStages;
      mbar_wait(full + 8 * s, (n / R::kStages) & 1);
      const uint32_t st = base + s * R::kStage;
      const uint32_t wp = st + kFeatBytes;      // w's planes
      pin(acc);
      if constexpr (kF32) {
        // A of k-step kk: (row, 8 kk + t), (row + 8, ..), (row, 8 kk + t
        // + 4), (row + 8, ..); in the swizzled box 16-byte unit u of row r
        // sits at u ^ (r & 7), and r & 7 = g
        const float* fr = reinterpret_cast<const float*>(
            gbase + (st - base) + row * kRowBytes);
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split(fr[(e & 1) * 8 * (kRowBytes / 4) +
                     (((2 * kk + (e >> 1)) ^ g) << 2) + t],
                  ah[kk][e], al[kk][e]);
          pin(ah[kk]);
          pin(al[kk]);
        }
        fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t off = kk * 32;         // 8 TF32 a k-step
          Mma<N>::tf32(acc, al[kk], desc_k(wp + off), kk > 0);
          if constexpr (kPlanes == 2)
            Mma<N>::tf32(acc, ah[kk], desc_k(wp + R::kPlane + off), 1);
          Mma<N>::tf32(acc, ah[kk], desc_k(wp + off), 1);
        }
      } else {
        const uint32_t fa = st + (warp >> 2) * 64 * kRowBytes;
        fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int p = kPlanes - 1; p >= 0; --p)
            Mma<N>::bf16(acc, desc_k(fa + kk * 32),
                         desc_k(wp + p * R::kPlane + kk * 32),
                         kk > 0 || p < kPlanes - 1);
      }
      commit();
      wait_all();
      pin(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);   // the stage may go
#pragma unroll
      for (int e = 0; e < kA; ++e) tot[e] += acc[e];
    }

    // ---- the tile's CAM rows (cells past P and classes past C dropped)
    const int c0 = cb * N;
    const int cell = ct * kBM + row;
    float* cr = cam + ((long long)b * P + cell) * C + c0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (cell + 8 * h >= P) continue;
      float* dst = cr + (long long)8 * h * C;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int c = 8 * j + 2 * t;
        if (c0 + c >= C) continue;
        const float v0 = tot[4 * j + 2 * h], v1 = tot[4 * j + 2 * h + 1];
        if ((C & 1) == 0) {
          *reinterpret_cast<float2*>(dst + c) = make_float2(v0, v1);
        } else {
          dst[c] = v0;
          if (c0 + c + 1 < C) dst[c + 1] = v1;
        }
      }
    }
    // ---- the tile's column sums, in one order: rows g and g + 8, the
    // warp's row groups by an xor butterfly (every lane ends with the same
    // bits), then the 8 warps in order; rows past P hold zeros
    float* cs = col_s + (it & 1) * 8 * N;       // two buffers: one barrier
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = tot[4 * j + e] + tot[4 * j + 2 + e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) cs[warp * N + 8 * j + 2 * t + e] = v;
      }
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
    for (int c = tid; c < N && c0 + c < C; c += kConsumers) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += cs[i * N + c];
      part[((long long)b * n_tiles + ct) * C + c0 + c] = sum;
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, or null
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      p = nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A refused tensor map is returned as kMapError + its CUresult (the
// wrapper names it); cudaError_t values stay below it
constexpr int kMapError = 100000;

// a (d2, d1, d0) array of bf16 (bytes 2) or float32 (4), contiguous, as a
// 3-D map with boxes of (b0, b1, 1) and 128-byte swizzle; past the ends
// reads as zero
int make_map_3d(CUtensorMap* map, int bytes, const void* base, long long d0,
                long long d1, long long d2, int b0, int b1) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return kMapError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1,
                              (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)(d0 * bytes),
                                 (cuuint64_t)(d0 * d1 * bytes)};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(
      map, bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + (int)r;
}

// the body's instantiation for C and the types, as a tag
template <int N, bool F, int Pl>
struct Inst {
  static constexpr int kN = N;
  static constexpr bool kF32 = F;
  static constexpr int kPlanes = Pl;
};
template <bool F, int Pl, typename Fn>
int by_n(int C, Fn&& fn) {
  switch (class_block(C)) {
    case 8: return fn(Inst<8, F, Pl>{});
    case 16: return fn(Inst<16, F, Pl>{});
    case 32: return fn(Inst<32, F, Pl>{});
    case 64: return fn(Inst<64, F, Pl>{});
    default: return fn(Inst<128, F, Pl>{});
  }
}
template <typename Fn>
int dispatch(int C, int types, Fn&& fn) {
  switch (planes_for(types).kind) {
    case 0: return by_n<true, 2>(C, fn);
    case 1: return by_n<true, 1>(C, fn);
    case 2: return by_n<false, 1>(C, fn);
    default: return by_n<false, 3>(C, fn);
  }
}

long long workspace_bytes(int D, int C, int types) {
  const Planes pl = planes_for(types);
  const int N = class_block(C);
  const long long Dp = (long long)(D + pl.cols - 1) / pl.cols * pl.cols;
  const long long Cp = (long long)(C + N - 1) / N * N;
  return pl.n * Cp * Dp * pl.esize;
}

int n_sms() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    cudaGetLastError();
    return 132;
  }
  return n;
}

int launch(const void* feat, const void* w, float* cam, float* part,
           void* ws, int B, int P, int D, int C, int types, cudaStream_t s) {
  const Planes pl = planes_for(types);
  const int esize = types & 1 ? 2 : 4;
  if (ws == nullptr || (D * esize) % 16 != 0 ||
      (((unsigned long long)feat | (unsigned long long)ws) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int N = class_block(C);
  const int n_cb = (C + N - 1) / N, Cp = n_cb * N;
  const int n_kc = (D + pl.cols - 1) / pl.cols, Dp = n_kc * pl.cols;
  const int n_tiles = (P + kBM - 1) / kBM;
  const long long work = (long long)B * n_tiles * n_cb;
  if (work > INT_MAX) return (int)cudaErrorInvalidValue;
  // the split pass
  const dim3 grid_w(Dp / 32, (Cp + 31) / 32);
  switch (pl.kind) {
    case 0:
      split_w_kernel<float, 0><<<grid_w, 256, 0, s>>>((const float*)w, ws,
                                                      D, C, Dp, Cp);
      break;
    case 1:
      split_w_kernel<bf16, 1><<<grid_w, 256, 0, s>>>((const bf16*)w, ws, D,
                                                     C, Dp, Cp);
      break;
    case 2:
      split_w_kernel<bf16, 2><<<grid_w, 256, 0, s>>>((const bf16*)w, ws, D,
                                                     C, Dp, Cp);
      break;
    default:
      split_w_kernel<float, 3><<<grid_w, 256, 0, s>>>((const float*)w, ws,
                                                      D, C, Dp, Cp);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mf, mw;
  int rc = make_map_3d(&mf, esize, feat, D, P, B, pl.cols, kBM);
  if (rc == 0) rc = make_map_3d(&mw, pl.esize, ws, Dp, Cp, pl.n, pl.cols, N);
  if (rc != 0) return rc;
  const int grid = (int)(work < n_sms() ? work : n_sms());
  return dispatch(C, types, [&](auto inst) {
    using I = decltype(inst);
    using R = Ring<I::kN, I::kPlanes>;
    cudaError_t err = cudaFuncSetAttribute(
        cam_mma_kernel<I::kN, I::kF32, I::kPlanes>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)R::kSmem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    cam_mma_kernel<I::kN, I::kF32, I::kPlanes>
        <<<grid, kThreads, R::kSmem, s>>>(mf, mw, cam, part, B, P, C,
                                          n_tiles, n_cb, n_kc);
    return (int)cudaGetLastError();
  });
}

}  // namespace mma

// the streaming body's launch
template <typename TF, typename TW>
int launch_tile(const void* feat, const void* w, float* cam, float* part,
                int B, int P, int D, int C, cudaStream_t s) {
  const int n_tiles = (P + kTile - 1) / kTile;
  const size_t smem = (size_t)D * sizeof(float4);
  const bool vec = D % 4 == 0 &&
                   ((unsigned long long)feat % (4 * sizeof(TF))) == 0;
  const void* fn = vec ? (const void*)cam_tile_kernel<TF, TW, true>
                       : (const void*)cam_tile_kernel<TF, TW, false>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) {      // e.g. more shared memory than the card
    cudaGetLastError();        // allows: report it, leave no stale error
    return (int)e;
  }
  const dim3 grid(n_tiles, B);
  if (vec)
    cam_tile_kernel<TF, TW, true><<<grid, kThreads, smem, s>>>(
        (const TF*)feat, (const TW*)w, cam, part, P, D, C);
  else
    cam_tile_kernel<TF, TW, false><<<grid, kThreads, smem, s>>>(
        (const TF*)feat, (const TW*)w, cam, part, P, D, C);
  return (int)cudaGetLastError();
}

// launches of each body (0 streaming, 1 many classes) since the library
// was loaded: which body ran, for a test
int g_body_launches[2] = {0, 0};

}  // namespace

extern "C" int cam_head_body_launches(int* out) {
  out[0] = g_body_launches[0];
  out[1] = g_body_launches[1];
  return 0;
}

// The scratch a call's many-classes body (body 1) needs, in bytes: the
// planes of w^T for D features, C classes and `types` (as below).
extern "C" long long cam_head_workspace_bytes(int D, int C, int types) {
  return mma::workspace_bytes(D, C, types);
}

// feat: (B, P, D), w: (D, C), b: (C,), counts: (B, C), cam: (B, P, C),
// part: (B, ceil(P / tile), C) scratch with the body's tile of cells (64
// for body 0, 128 for body 1), all contiguous; feat, w and b each float32
// or bfloat16 (types: bit 0 feat, bit 1 w, bit 2 b set where bfloat16),
// counts, cam and part float32; B <= 65535, C >= 1.  body 0 is the
// streaming body (any D and alignment), body 1 the many-classes body,
// which needs D * sizeof(feat) a multiple of 16 bytes, feat 16-byte
// aligned and ws, 16-byte aligned, of cam_head_workspace_bytes(D, C,
// types).  Launches on `stream`; returns cudaGetLastError(), or 100000 +
// the CUresult of a tensor map the driver refused (body 1).
extern "C" int cam_head_launch(const void* feat, const void* w, const void* b,
                               void* counts, void* cam, void* part, void* ws,
                               int B, int P, int D, int C, int types,
                               int body, void* stream) {
  if (B <= 0) return 0;
  if (P <= 0 || D <= 0 || C < 1 || B > 65535 || C > 65535 * kCountClasses ||
      types < 0 || types > 7 || body < 0 || body > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* fc = (float*)counts;
  float* fm = (float*)cam;
  float* fp = (float*)part;
  int rc;
  if (body == 1) {
    rc = mma::launch(feat, w, fm, fp, ws, B, P, D, C, types, s);
  } else {
    switch (types & 3) {
      case 0:
        rc = launch_tile<float, float>(feat, w, fm, fp, B, P, D, C, s);
        break;
      case 1:
        rc = launch_tile<bf16, float>(feat, w, fm, fp, B, P, D, C, s);
        break;
      case 2:
        rc = launch_tile<float, bf16>(feat, w, fm, fp, B, P, D, C, s);
        break;
      default:
        rc = launch_tile<bf16, bf16>(feat, w, fm, fp, B, P, D, C, s);
    }
  }
  if (rc != 0) return rc;
  ++g_body_launches[body];
  const int n_tiles = (P + (body == 1 ? mma::kBM : kTile) - 1) /
                      (body == 1 ? mma::kBM : kTile);
  const dim3 grid(B, (C + kCountClasses - 1) / kCountClasses);
  if (types & 4)
    cam_counts_kernel<bf16><<<grid, kCountClasses, 0, s>>>(
        fp, (const bf16*)b, fc, n_tiles, P, C);
  else
    cam_counts_kernel<float><<<grid, kCountClasses, 0, s>>>(
        fp, (const float*)b, fc, n_tiles, P, C);
  return (int)cudaGetLastError();
}

// The many-classes body's launch shape and resources for C classes and
// `types`, for a report: out[0] its dynamic shared memory (bytes), [1]
// threads a block, [2] registers a thread and [3] local memory a thread
// (spills), as the runtime reads them from the binary, [4] its blocks an
// SM, [5] the ring's stages, [6] the class block N.  Returns a
// cudaError_t.
extern "C" int cam_head_mma_info(int C, int types, int* out) {
  if (C < 1 || types < 0 || types > 7) return (int)cudaErrorInvalidValue;
  return mma::dispatch(C, types, [&](auto inst) {
    using I = decltype(inst);
    using R = mma::Ring<I::kN, I::kPlanes>;
    auto fn = mma::cam_mma_kernel<I::kN, I::kF32, I::kPlanes>;
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)R::kSmem);
    cudaFuncAttributes attr;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
    int blocks = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fn, mma::kThreads, R::kSmem);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
    out[0] = (int)R::kSmem;
    out[1] = mma::kThreads;
    out[2] = attr.numRegs;
    out[3] = (int)attr.localSizeBytes;
    out[4] = blocks;
    out[5] = R::kStages;
    out[6] = I::kN;
    return 0;
  });
}
