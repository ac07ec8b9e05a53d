// Blocked online-softmax (flash) attention, causal / sliding window / GQA.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_bhsd
//
// o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / G, j] * scale) v[b, h / G, j]
// over the unmasked keys j (causal: j <= i; window w: i - j < w); masked
// scores are NEG_INF = -0.7 * FLT_MAX, as in the TPU kernel and the plain
// version.  q (B, H, Sq, hd), k and v (B, KV, Sk, hd), float32 or bfloat16,
// contiguous; G = H / KV; hd in {32, 64, 128, 256} or a multiple of 8
// above 256 (the wrapper zero-pads any other hd up to the next of these and
// passes the true hd's scale; above 256 bf16 up to hd 512 runs a wgmma
// body of its own, float32 and wider head dims the slab body, below).  o
// (B, H, Sq, hd) in q's type.
//
// Arithmetic (the TPU kernel's): scores S = q k^T * scale accumulated in
// fp32, running max m, sum l and accumulator acc in fp32; the
// probabilities are rounded to v's type before the product with v;
// o = acc / max(l, 1e-30).  Fully masked key tiles are skipped by the TPU
// kernel's rules; keys past Sk score NEG_INF and query rows past Sq are
// computed on zeros and never stored, so every Sq and Sk launches.
//
// Bound on an H100: operations.  The work is 4 * B * H * Sq * Sk * hd
// flops (two products); at the filter trunk's (32, 4, 3136, 32) in fp32
// that is 161 GFLOP against ~51 MB of q, k, v and o, and the S x S scores
// never leave the SM.  In SIMT fp32 FMAs (67 TFLOP/s) that is 2.4 ms.
// The tensor cores take TF32, which keeps 11 significant bits and would
// miss the plain fp32 version by ~1e-2 once the softmax is peaky, so each
// fp32 product is split (3xTF32): x = hi + lo with hi = tf32(x) and
// lo = tf32(x - hi), and x y ~ hi_x hi_y + hi_x lo_y + lo_x hi_y, with
// every sum in fp32; the dropped lo_x lo_y and the rounding of lo are
// ~2^-21 of the product.  Three TF32 products per fp32 product bound the
// kernel at 3 x 161 GFLOP / 495 TFLOP/s = 0.98 ms; the 1.26e9 exps
// (~0.3 ms on the SFUs) overlap the products.  What else costs is the
// split itself (integer ops on every k and v element a warp reads) and
// the shared-memory reads of the k and v fragments.  Design against that:
//   - one block per (64 query rows, head, batch); a loop in the block
//     walks the key tiles (the TPU's sequential grid axis), so the running
//     (m, l, acc) stay in registers.  A warp owns 16 rows (one mma row
//     tile), or 32 at fp32 hd 32, where each k and v fragment it reads
//     and splits serves two row tiles (2 warps per block there, else 4);
//   - both products are mma.sync.m16n8k8 TF32 tensor-core products, three
//     per fp32 product; the q tile is split once per block (into
//     registers for hd <= 64, into shared memory for hd 128), k and v
//     fragments as they are read.  The small terms of q k^T are summed
//     before the large ones meet them, so the score accumulator rounds
//     each k-step's large term once;
//   - the split rounds with integer ops, off the conversion unit;
//   - a lane's fragments are contiguous in shared memory (16-byte reads,
//     no bank conflict): the sums over the head dim and over the keys do
//     not depend on their order, so operand columns are mapped to head
//     dims and keys to suit (qk_dim, v_dim), and the probabilities keep
//     the score accumulator's layout (no shuffle between the products);
//   - bf16 takes mma.sync.m16n8k16 on bf16 directly (exact products, fp32
//     sums); the probabilities are rounded to bf16 when packed;
//   - k and v tiles of 64 keys are double-buffered with 16-byte cp.async
//     copies (zero-filled past Sk): the next tile's copy overlaps this
//     tile's products; rows are padded by 16 bytes;
//   - the online softmax stays in fp32 registers, in base 2 with log2(e)
//     folded into one FMA per score; row maxima are reduced over the 4
//     lanes of a row with shuffles, row sums only once at the end;
//   - a warp whose rows all precede a causal key tile skips its math.
// Head dim 256 (paligemma-3b's) has two bodies of its own for Hopper,
// below: bf16's (flash_attention_kernel_hd256_wgmma) and float32's
// (flash_attention_kernel_hd256_tf32), warpgroup MMA on TMA-fed tiles;
// so has bf16 at head dims 257-512 (flash_attention_kernel_wide_wgmma).
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched
                   // through cudaGetDriverEntryPoint (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kWideMaxHd = 512;    // bf16's wide wgmma body, 257-512
constexpr float kNegInf = (float)(-0.7 * 3.4028234663852886e38);
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int HD>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kBK = 64;                             // keys a tile
  static constexpr int kJ = kBK / 8;                         // S n-tiles
  static constexpr int kPitch = HD + 16 / (int)sizeof(T);   // elements
  static constexpr int kTile = kBK * kPitch;                 // elements
  static constexpr bool kQReg = !kF32 || HD <= 64;       // q in registers
  static constexpr int kQPitch = HD + 4;       // floats (fp32 hd 128 split)
  static constexpr int kNT = HD / 8;                         // o n-tiles
  static constexpr int kM = kF32 && HD == 32 ? 2 : 1;  // row tiles/warp
  static constexpr int kThreads = kBQ / (16 * kM) * 32;      // per block
  static constexpr size_t kSmem =
      4 * (size_t)kTile * sizeof(T) +
      (kQReg ? 0 : 2 * (size_t)kBQ * kQPitch * sizeof(float));
  static constexpr int kMinBlocks = HD == 32 ? 4 : (HD == 64 ? 2 : 1);
  static_assert(HD != 256, "hd 256 runs the wgmma bodies");
};

// x rounded to TF32 (to nearest, ties away from zero, as cvt.rna does)
// with the low 13 bits cleared, so that x - hi is exact.  Two full-rate
// integer ops in place of cvt.rna.tf32.f32, a conversion-unit op: the
// split runs on every k and v element a warp reads
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo.  The mma reads the top 19 bits of a TF32 operand, so lo is
// rounded to nearest by adding half a TF32 ulp, and its low bits are left
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_hi(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// the same with lo truncated by the mma (2^-21 of x at most): for the
// probabilities, which are at most 1 and reach the output linearly
__device__ __forceinline__ void split_p(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_hi(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// fp32 layouts.  The sums over the head dim (q k^T) and over the keys
// (p v) do not depend on the order of their terms, so each k-step's
// operand columns are mapped to head dims and keys such that a lane's
// fragments are contiguous in shared memory (16-byte reads, no bank
// conflict).  q k^T, k-step kk: operand column t (and t + 4) is head dim
// qk_dim(t, kk) (and + 1): lane t reads the float4 chunks 2t + (i & 1)
// + 8 (i >> 1) of a row, chunk i holding k-steps 2i and 2i + 1.
__device__ __forceinline__ int qk_dim(int t, int kk) {
  return 8 * t + 4 * ((kk >> 1) & 1) + 32 * (kk >> 2) + 2 * (kk & 1);
}
// p v: operand column t (t + 4) of a k-step is its key 2t (2t + 1), so
// the probabilities keep the score accumulator's layout; the product's
// column x of n-tile n is head dim v_dim(x, n): lane g reads the float4
// chunks g + 8m of a v row, and the lane of (row, 2t) holds head dims
// 8t + 32m .. 8t + 32m + 7 of the output.
__device__ __forceinline__ int v_dim(int x, int n) {
  return 4 * (x + 8 * (n >> 2)) + (n & 3);
}

// 2^x on the special-function unit; results below 2^-126 flush to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d += a b, a 16x8 (row), b 8x8 (col), TF32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, a 16x16 (row), b 16x8 (col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // lo: low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  const __nv_bfloat162 p = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 16 bytes global -> shared; zero-filled when !in (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// keys k0 .. k0 + kBK - 1 of k and v into one stage (rows past Sk zeroed)
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* kb,
                                          const T* vb, int k0, int Sk) {
  using C = Cfg<T, HD>;
  constexpr int kE = 16 / (int)sizeof(T);        // elements per copy
  constexpr int kChunks = HD / kE;               // copies per row
#pragma unroll
  for (int i = threadIdx.x; i < C::kBK * kChunks; i += C::kThreads) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * kE;
    const bool in = k0 + r < Sk;
    const long long off = in ? (long long)(k0 + r) * HD + c : 0;
    cp_async16(ks + r * C::kPitch + c, kb + off, in);
    cp_async16(vs + r * C::kPitch + c, vb + off, in);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<T, HD>::kThreads,
                                  Cfg<T, HD>::kMinBlocks)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int KV, int Sq, int Sk, float scale_log2, int causal,
                       int window) {
  using C = Cfg<T, HD>;
  constexpr int kNT = C::kNT;
  constexpr int kM = C::kM;                     // 16-row tiles per warp
  constexpr int kBK = C::kBK;
  constexpr int kJ = C::kJ;
  extern __shared__ float4 smem4[];
  T* kv_s = reinterpret_cast<T*>(smem4);        // [stage][k, v][kBK][pitch]
  float* qs_hi = reinterpret_cast<float*>(kv_s + 4 * C::kTile);
  float* qs_lo = qs_hi + kBQ * C::kQPitch;      // hd 128 fp32 only

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const int q_hi = min(q0 + kBQ, Sq) - 1;       // last real query row
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;                      // fragment row group
  const int t = lane & 3;                       // fragment column group
  const int row0 = q0 + warp * 16 * kM;         // the warp's first row
  const int row_last = row0 + 16 * kM - 1;
  const T* qb = q + (long long)(b * H + h) * Sq * HD;
  const T* kb = k + (long long)(b * KV + kvh) * Sk * HD;
  const T* vb = v + (long long)(b * KV + kvh) * Sk * HD;
  T* ob = o + (long long)(b * H + h) * Sq * HD;

  // the TPU kernel's skipping rules, on the block's real rows
  const int n_k = (Sk + kBK - 1) / kBK;
  const int t_end = causal ? min(n_k, q_hi / kBK + 1) : n_k;
  int t_begin = 0;
  if (window > 0) {
    const int x = q0 - window - (kBK - 2);
    if (x > 0) t_begin = (x + kBK - 1) / kBK;
  }
  if (t_begin < t_end)
    load_tile<T, HD>(kv_s, kv_s + C::kTile, kb, vb, t_begin * kBK, Sk);
  cp_async_commit();

  // the q tile, split once: fragments a0 (row g, col t), a1 (g + 8, t),
  // a2 (g, t + 4), a3 (g + 8, t + 4) of each row tile; tf32 columns are
  // head dims qk_dim(t, kk) (+ 1), bf16 ones the pairs at 2t (+ 8)
  constexpr int kQF = C::kQReg ? (C::kF32 ? HD / 8 : HD / 16) : 1;
  uint32_t qa[kM][kQF][4], qal[kM][kQF][4];
  if constexpr (C::kF32 && C::kQReg) {
#pragma unroll
    for (int mt = 0; mt < kM; ++mt) {
      const int ra = row0 + mt * 16 + g, rb = ra + 8;
#pragma unroll
      for (int kk = 0; kk < kQF; ++kk) {
        const int c = qk_dim(t, kk);
        const float x[4] = {
            ra < Sq ? qb[(long long)ra * HD + c] : 0.f,
            rb < Sq ? qb[(long long)rb * HD + c] : 0.f,
            ra < Sq ? qb[(long long)ra * HD + c + 1] : 0.f,
            rb < Sq ? qb[(long long)rb * HD + c + 1] : 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) split(x[e], qa[mt][kk][e], qal[mt][kk][e]);
      }
    }
  } else if constexpr (C::kQReg) {
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(qb);
#pragma unroll
    for (int mt = 0; mt < kM; ++mt) {
      const int ra = row0 + mt * 16 + g, rb = ra + 8;
#pragma unroll
      for (int kk = 0; kk < kQF; ++kk) {
        const int c = kk * 8 + t;                   // in 32-bit words
        qa[mt][kk][0] = ra < Sq ? q32[(long long)ra * (HD / 2) + c] : 0u;
        qa[mt][kk][1] = rb < Sq ? q32[(long long)rb * (HD / 2) + c] : 0u;
        qa[mt][kk][2] = ra < Sq ? q32[(long long)ra * (HD / 2) + c + 4] : 0u;
        qa[mt][kk][3] = rb < Sq ? q32[(long long)rb * (HD / 2) + c + 4] : 0u;
      }
    }
  } else {                          // fp32 hd 128: split planes
    for (int i = threadIdx.x; i < kBQ * HD; i += C::kThreads) {
      const int r = i / HD;
      const int d = i - r * HD;
      const float x = q0 + r < Sq ? (float)qb[(long long)(q0 + r) * HD + d]
                                  : 0.f;
      uint32_t hi, lo;
      split(x, hi, lo);
      qs_hi[r * C::kQPitch + d] = __uint_as_float(hi);
      qs_lo[r * C::kQPitch + d] = __uint_as_float(lo);
    }
  }

  float m[kM][2], l[kM][2];   // rows g, g + 8 of each row tile; m in
  float acc[kM][kNT][4];      // scaled base-2 units, l this lane's share
#pragma unroll
  for (int mt = 0; mt < kM; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[mt][i] = kNegInf;
      l[mt][i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  }

  for (int tt = t_begin, it = 0; tt < t_end; ++tt, ++it) {
    const int k0 = tt * kBK;
    const int st = it & 1;
    if (tt + 1 < t_end)
      load_tile<T, HD>(kv_s + (2 * (st ^ 1)) * C::kTile,
                       kv_s + (2 * (st ^ 1) + 1) * C::kTile, kb, vb,
                       k0 + kBK, Sk);
    cp_async_commit();
    cp_async_wait1();                // this tile's copies have landed
    __syncthreads();
    const T* ks = kv_s + (2 * st) * C::kTile;
    const T* vs = ks + C::kTile;

    if (!(causal && k0 > row_last)) {
      // ---- S = q k^T: s[mt][j] holds keys k0 + 8j + 2t (+1), rows g, g + 8
      float s[kM][kJ][4];
#pragma unroll
      for (int mt = 0; mt < kM; ++mt)
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
      if constexpr (C::kF32 && C::kQReg) {
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const float* kr =
              reinterpret_cast<const float*>(ks) + (j * 8 + g) * C::kPitch;
          uint32_t bh[kQF][2], bl[kQF][2];
#pragma unroll
          for (int i = 0; i < kQF / 2; ++i) {
            const float4 x = *reinterpret_cast<const float4*>(
                kr + qk_dim(t, 2 * i));
            split(x.x, bh[2 * i][0], bl[2 * i][0]);
            split(x.y, bh[2 * i][1], bl[2 * i][1]);
            split(x.z, bh[2 * i + 1][0], bl[2 * i + 1][0]);
            split(x.w, bh[2 * i + 1][1], bl[2 * i + 1][1]);
          }
#pragma unroll
          for (int mt = 0; mt < kM; ++mt)
#pragma unroll
            for (int kk = 0; kk < kQF; ++kk) {
              mma_tf32(s[mt][j], qal[mt][kk], bh[kk][0], bh[kk][1]);
              mma_tf32(s[mt][j], qa[mt][kk], bl[kk][0], bl[kk][1]);
            }
#pragma unroll
          for (int mt = 0; mt < kM; ++mt)
#pragma unroll
            for (int kk = 0; kk < kQF; ++kk)
              mma_tf32(s[mt][j], qa[mt][kk], bh[kk][0], bh[kk][1]);
        }
      } else if constexpr (C::kF32) {   // hd 128: one row tile a warp
        float sl[kJ][4];
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sl[j][e] = 0.f;
#pragma unroll 2
        for (int kk = 0; kk < HD / 8; ++kk) {
          const int c = qk_dim(t, kk);
          uint32_t ah[4], al[4];
          const float* qh = qs_hi + (warp * 16 + g) * C::kQPitch + c;
          const float* ql = qs_lo + (warp * 16 + g) * C::kQPitch + c;
          constexpr int r8 = 8 * C::kQPitch;
          ah[0] = __float_as_uint(qh[0]);
          ah[1] = __float_as_uint(qh[r8]);
          ah[2] = __float_as_uint(qh[1]);
          ah[3] = __float_as_uint(qh[r8 + 1]);
          al[0] = __float_as_uint(ql[0]);
          al[1] = __float_as_uint(ql[r8]);
          al[2] = __float_as_uint(ql[1]);
          al[3] = __float_as_uint(ql[r8 + 1]);
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            const float2 x = *reinterpret_cast<const float2*>(
                reinterpret_cast<const float*>(ks) + (j * 8 + g) * C::kPitch +
                c);
            uint32_t bh0, bl0, bh1, bl1;
            split(x.x, bh0, bl0);
            split(x.y, bh1, bl1);
            mma_tf32(sl[j], al, bh0, bh1);
            mma_tf32(sl[j], ah, bl0, bl1);
            mma_tf32(s[0][j], ah, bh0, bh1);
          }
        }
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[0][j][e] += sl[j][e];
      } else {
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const uint32_t* kr = reinterpret_cast<const uint32_t*>(
              ks + (j * 8 + g) * C::kPitch + 2 * t);
#pragma unroll
          for (int mt = 0; mt < kM; ++mt)
#pragma unroll
            for (int kk = 0; kk < kQF; ++kk)
              mma_bf16(s[mt][j], qa[mt][kk], kr[kk * 8], kr[kk * 8 + 4]);
        }
      }

      // ---- mask, online softmax (base 2), rescale the accumulator.
      // Masked raw scores are NEG_INF; m is NEG_INF while every score of
      // its row so far is masked, so a masked score weighs
      // exp2(NEG_INF - m): 1 then, 0 once m is real, as the TPU kernel's
      // exp(NEG_INF - m)
      const bool need_mask = k0 + kBK > Sk ||
                             (causal && k0 + kBK - 1 > row0) ||
                             (window > 0 && row_last - k0 >= window);
#pragma unroll
      for (int mt = 0; mt < kM; ++mt) {
        if (need_mask) {
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qp = row0 + mt * 16 + g + (e >> 1) * 8;
              const int kp = k0 + j * 8 + 2 * t + (e & 1);
              bool keep = kp < Sk;
              if (causal) keep = keep && qp >= kp;
              if (window > 0) keep = keep && qp - kp < window;
              if (!keep) s[mt][j][e] = kNegInf;
            }
          }
        }
        float mx[2] = {kNegInf, kNegInf}, corr[2];
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][j][e]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float m_new = fmaxf(
              m[mt][i], mx[i] == kNegInf ? kNegInf : mx[i] * scale_log2);
          corr[i] = ex2(m[mt][i] - m_new);
          m[mt][i] = m_new;
          l[mt][i] *= corr[i];
        }
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float mi = m[mt][e >> 1];
            const float x = fmaf(s[mt][j][e], scale_log2, -mi);
            s[mt][j][e] =
                ex2(need_mask && s[mt][j][e] == kNegInf ? kNegInf - mi : x);
            l[mt][e >> 1] += s[mt][j][e];
          }
        }
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          acc[mt][n][0] *= corr[0];
          acc[mt][n][1] *= corr[0];
          acc[mt][n][2] *= corr[1];
          acc[mt][n][3] *= corr[1];
        }
      }

      // ---- acc += p v
      if constexpr (C::kF32) {
        const float* vf = reinterpret_cast<const float*>(vs);
#pragma unroll
        for (int kk = 0; kk < kJ; ++kk) {
          // operand column t is key 2t, column t + 4 is key 2t + 1
          uint32_t ah[kM][4], al[kM][4];
#pragma unroll
          for (int mt = 0; mt < kM; ++mt) {
            split_p(s[mt][kk][0], ah[mt][0], al[mt][0]);
            split_p(s[mt][kk][2], ah[mt][1], al[mt][1]);
            split_p(s[mt][kk][1], ah[mt][2], al[mt][2]);
            split_p(s[mt][kk][3], ah[mt][3], al[mt][3]);
          }
          const float* vr = vf + (kk * 8 + 2 * t) * C::kPitch;
#pragma unroll
          for (int mm = 0; mm < kNT / 4; ++mm) {
            const float4 x0 = *reinterpret_cast<const float4*>(
                vr + v_dim(g, 4 * mm));
            const float4 x1 = *reinterpret_cast<const float4*>(
                vr + C::kPitch + v_dim(g, 4 * mm));
            const float a0[4] = {x0.x, x0.y, x0.z, x0.w};
            const float a1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              uint32_t bh0, bl0, bh1, bl1;
              split(a0[e], bh0, bl0);
              split(a1[e], bh1, bl1);
#pragma unroll
              for (int mt = 0; mt < kM; ++mt) {
                float(&d)[4] = acc[mt][4 * mm + e];
                mma_tf32(d, al[mt], bh0, bh1);
                mma_tf32(d, ah[mt], bl0, bl1);
                mma_tf32(d, ah[mt], bh0, bh1);
              }
            }
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kJ / 2; ++kk) {
          uint32_t pa[kM][4];
#pragma unroll
          for (int mt = 0; mt < kM; ++mt) {
            pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
            pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
            pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
            pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
          }
          const T* vr = vs + (kk * 16 + 2 * t) * C::kPitch + g;
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            const T* c = vr + n * 8;
            const uint32_t b0 = pack_bf16(c[0], c[C::kPitch]);
            const uint32_t b1 = pack_bf16(c[8 * C::kPitch], c[9 * C::kPitch]);
#pragma unroll
            for (int mt = 0; mt < kM; ++mt)
              mma_bf16(acc[mt][n], pa[mt], b0, b1);
          }
        }
      }
    }
    __syncthreads();                 // this stage may be refilled
  }

#pragma unroll
  for (int mt = 0; mt < kM; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[mt][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      li = fmaxf(li, 1e-30f);
      const int r = row0 + mt * 16 + g + 8 * i;
      if (r >= Sq) continue;
      const float(&a)[kNT][4] = acc[mt];
      if constexpr (C::kF32) {       // head dims v_dim(2t (+ 1), n)
#pragma unroll
        for (int mm = 0; mm < kNT / 4; ++mm) {
          float* dst = ob + (long long)r * HD + v_dim(2 * t, 4 * mm);
          const int n = 4 * mm, c = 2 * i;
          *reinterpret_cast<float4*>(dst) =
              make_float4(a[n][c] / li, a[n + 1][c] / li, a[n + 2][c] / li,
                          a[n + 3][c] / li);
          *reinterpret_cast<float4*>(dst + 4) = make_float4(
              a[n][c + 1] / li, a[n + 1][c + 1] / li, a[n + 2][c + 1] / li,
              a[n + 3][c + 1] / li);
        }
      } else {
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r * HD + n * 8 +
                                             2 * t) =
              __floats2bfloat162_rn(a[n][2 * i] / li, a[n][2 * i + 1] / li);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Bf16 at head dim 256: warpgroup MMA (wgmma) on TMA-fed tiles, sm_90a.
//
// Bound at paligemma-3b's (8, 8, 1, 1024, 256) causal: the causal half of
// 4 B H S^2 hd is 34.4 GFLOP, 0.0347 ms at 989 TFLOP/s, against 38 MB of
// q, k, v and o.  mma.sync reaches a fraction of that rate; only wgmma,
// fed by TMA, reaches the tensor cores' full rate.  The design follows
// FlashAttention-3's forward at hd 256 (Shah et al., arXiv:2407.08608):
//   - a block owns 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows each, and a producer warpgroup of which one
//     thread issues the TMA loads; setmaxnreg gives each consumer thread
//     240 registers (o: 64 x 256 fp32 a warpgroup, 128 a thread; s: 32;
//     p: 16 bf16 pairs) and each producer thread 24;
//   - shared memory: the q tile (128 x 256, 64 KB, loaded once) and a
//     two-stage ring of k and v tiles (64 keys x 256, 32 KB each), 192 KB
//     in all, one block an SM.  Each stage has a full barrier for k and
//     one for v, armed by the producer with expect_tx, and an empty
//     barrier that each consumer warp arrives on when it is done;
//   - TMA: 3-D tensor maps (hd, S, B x heads) with 128-byte swizzle and
//     boxes of 64 head-dim columns (128 bytes, the swizzle's width), so a
//     tile is four boxes and never reads past its own head's last key
//     (rows past Sk or Sq come back zero).  The maps (q, k, v and o) are
//     encoded on the host per call and passed as __grid_constant__
//     arguments;
//   - S = q k^T: 16 wgmma m64n64k16 over hd, q and k both K-major in
//     shared memory; a k-step moves the descriptors 32 bytes inside a box
//     (the swizzle is a function of the address), the next box is a box
//     further on;
//   - the online softmax is the other bodies' (fp32 scores, base 2 with
//     scale * log2(e) in one FMA, NEG_INF masks and the masked-weight
//     rule, rows reduced over the 4 lanes that share them); p is rounded
//     to bf16 straight into wgmma's A registers: the m64nNk16 accumulator
//     layout is the register A layout of the next product;
//   - o += p v: 4 wgmma m64n256k16, A from registers, v read MN-major from
//     shared memory through the instruction's transpose bit;
//   - the TPU kernel's tile-skipping rules at 64-key tiles; a warpgroup
//     whose 64 rows all precede a causal tile, lie past Sq or lie past a
//     sliding window skips its math (exact: such keys weigh 0 once a row
//     has a real score), and only tiles on an edge are masked;
//   - the two consumer warpgroups issue their score products in turns
//     (two named barriers), so that one's softmax runs while the tensor
//     cores take the other's products: waiting on the same k tile, they
//     would otherwise reach the tensor cores and the softmax together;
//   - o = acc / l by l's rounded reciprocal and one FMA correction an
//     element: the correctly rounded quotient, in three instructions
//     where a division takes several more; each warpgroup stages its
//     bf16 rows in its own q rows (swizzled as the maps) and one TMA
//     store per box writes them, clipped at Sq: scattered 4-byte stores
//     from the accumulator's layout cost 9% of the time at S 1,024;
//   - blocks are launched longest-first (the q tile is the slowest block
//     index, reversed), so causal blocks finish together.
// A repeated call is bit-identical: no atomics, a fixed order of sums.
namespace wg {

constexpr int kBM = 128;                        // query rows a block
constexpr int kBN = 64;                         // keys a tile
constexpr int kHD = 256;
constexpr int kBoxCols = 64;                    // 128 bytes of bf16
constexpr int kThreads = 3 * 128;               // producer + 2 consumers
constexpr int kConsumerRegs = 240, kProducerRegs = 24;
constexpr uint32_t kRowBytes = kBoxCols * 2;    // a box row: 128 B
constexpr uint32_t kQBox = kBM * kRowBytes;     // 16 KB
constexpr uint32_t kKBox = kBN * kRowBytes;     // 8 KB
constexpr uint32_t kQBytes = 4 * kQBox;         // 64 KB
constexpr uint32_t kTileBytes = 4 * kKBox;      // 32 KB, k or v
constexpr uint32_t kBarOff = kQBytes + 4 * kTileBytes;  // 2 stages of k, v
// barriers (8 bytes each) at kBarOff: q, full k[2], full v[2], empty[2]
constexpr size_t kSmem = 1024 + kBarOff + 7 * 8;   // 1024: base alignment

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

// box (c0 columns, c1 rows, c2 the head) of `map` into shared memory at
// dst, completing on `bar`
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

// a box of shared memory at src to (c0 columns, c1 rows, c2 the head) of
// `map`; rows past the map's end are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until every committed group is done
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
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle: start address, the
// leading and stride byte offsets (all >> 4)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major (q, k): rows of 128 B, 8-row groups 1024 B apart (lbo unused)
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return desc(addr, 16, 1024);
}
// MN-major (v read along hd): the four 64-column boxes kKBox apart, 8-key
// groups 1024 B apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return desc(addr, kKBox, 1024);
}

// d (64 x 64 fp32) = (acc ? d : 0) + a (64 x 16) b^T (b 64 x 16); a and b
// K-major in shared memory
__device__ __forceinline__ void mma_64x64(float (&d)[32], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 256 fp32) += a (64 x 16, bf16 pairs in registers) b (16 x 256);
// b MN-major in shared memory (transposed on read)
__device__ __forceinline__ void mma_64x256(float (&d)[128],
                                           const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// s = a b^T over the 256 head dims: 16 k-steps, 4 in each 64-column box;
// `a_box` is the byte distance between a's boxes
__device__ __forceinline__ void qk(float (&s)[32], uint32_t a, uint32_t a_box,
                                   uint32_t b) {
  const uint64_t da = desc_k(a), db = desc_k(b);
#pragma unroll
  for (int kk = 0; kk < kHD / 16; ++kk)
    mma_64x64(s, da + (((kk >> 2) * a_box + (kk & 3) * 32) >> 4),
              db + (((kk >> 2) * kKBox + (kk & 3) * 32) >> 4), kk > 0);
}

// p as wgmma's A fragments: k-step kk (keys 16 kk ..) from s's n-tiles
// 2 kk and 2 kk + 1, rows g and g + 8
__device__ __forceinline__ void pack_p(uint32_t (&p)[16],
                                       const float (&s)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// o += p v over the tile's 64 keys: 4 k-steps of 16 keys (2 KB of v each)
__device__ __forceinline__ void pv(float (&o)[128], const uint32_t (&p)[16],
                                   uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    mma_64x256(o, p + 4 * kk, desc_mn(v + kk * 16 * kRowBytes));
}

// the online softmax of one tile's scores, as in flash_attention_kernel
// above: s[4 j + e] (row ra + 8 (e >> 1), key k0 + 8 j + 2 t + (e & 1);
// N / 4 n-tiles of 8 keys) becomes its weight in fp32; m and l are the
// rows' running max (scaled, base 2) and this lane's share of their sums,
// corr the factor that rescales the rows' accumulator.  Masked raw scores
// are NEG_INF; m is NEG_INF while every score of its row so far is
// masked, so a masked score weighs exp2(NEG_INF - m): 1 then, 0 once m is
// real, as the TPU kernel's exp(NEG_INF - m)
template <int N>
__device__ __forceinline__ void softmax(float (&s)[N], float (&m)[2],
                                        float (&l)[2], float (&corr)[2],
                                        bool need_mask, int ra, int k0,
                                        int t, int Sk, int causal,
                                        int window, float scale_log2) {
  if (need_mask) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int qp = ra + ((j >> 1) & 1) * 8;
      const int kp = k0 + (j >> 2) * 8 + 2 * t + (j & 1);
      bool keep = kp < Sk;
      if (causal) keep = keep && qp >= kp;
      if (window > 0) keep = keep && qp - kp < window;
      if (!keep) s[j] = kNegInf;
    }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < N; ++j)
    mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new =
        fmaxf(m[r], mx[r] == kNegInf ? kNegInf : mx[r] * scale_log2);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int r = (j >> 1) & 1;
    const float x = fmaf(s[j], scale_log2, -m[r]);
    s[j] = ex2(need_mask && s[j] == kNegInf ? kNegInf - m[r] : x);
    l[r] += s[j];
  }
}

// warpgroup `id`'s turn at the tensor cores: the consumer warpgroups
// issue their score products in turns (named barriers 1 and 2, both
// warpgroups' 256 threads), so that one's softmax runs while the other's
// product does
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel_hd256_wgmma(const __grid_constant__ CUtensorMap mq,
                                   const __grid_constant__ CUtensorMap mk,
                                   const __grid_constant__ CUtensorMap mv,
                                   const __grid_constant__ CUtensorMap mo,
                                   int BH, int H, int KV, int Sq, int Sk,
                                   int n_q, float scale_log2, int causal,
                                   int window) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sq = base;                     // q: 4 boxes of 128 rows
  const uint32_t bar = base + kBarOff;
  const uint32_t full_q = bar, full_k = bar + 8, full_v = bar + 24,
                 empty = bar + 40;              // + 8 x stage

  const int bh = blockIdx.x % BH;               // b * H + h
  const int q0 = (n_q - 1 - blockIdx.x / BH) * kBM;   // longest first
  const int kvh = (bh / H) * KV + (bh % H) / (H / KV);
  const int q_hi = min(q0 + kBM, Sq) - 1;       // last real query row

  // the TPU kernel's skipping rules, on the block's real rows
  const int n_k = (Sk + kBN - 1) / kBN;
  const int t_end = causal ? min(n_k, q_hi / kBN + 1) : n_k;
  int t_begin = 0;
  if (window > 0) {
    const int x = q0 - window - (kBN - 2);
    if (x > 0) t_begin = (x + kBN - 1) / kBN;
  }
  const int n_t = max(t_end - t_begin, 0);      // tiles t_begin + i

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);              // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, kQBytes);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        tma_load(sq + c * kQBox, &mq, full_q, c * kBoxCols, q0, bh);
      for (int i = 0; i < n_t; ++i) {
        const int s = i & 1;
        if (i >= 2) mbar_wait(empty + 8 * s, ((i >> 1) & 1) ^ 1);
        const int k0 = (t_begin + i) * kBN;
        const uint32_t ks = base + kQBytes + 2 * s * kTileBytes;
        mbar_expect_tx(full_k + 8 * s, kTileBytes);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          tma_load(ks + c * kKBox, &mk, full_k + 8 * s, c * kBoxCols, k0,
                   kvh);
        mbar_expect_tx(full_v + 8 * s, kTileBytes);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          tma_load(ks + kTileBytes + c * kKBox, &mv, full_v + 8 * s,
                   c * kBoxCols, k0, kvh);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int t = lane & 3;
    const int row0 = q0 + 64 * wg;              // the warpgroup's rows
    const int row_last = row0 + 63;
    const int wrow0 = row0 + 16 * warp;         // the warp's rows
    const int ra = wrow0 + (lane >> 2);         // this thread's: ra, ra + 8
    const uint32_t qw = sq + wg * 64 * kRowBytes;

    // the tiles whose math the warpgroup runs, [i_lo, i_hi): none past
    // Sq, none after a causal tile past its last row, none before a tile
    // that reaches into its first row's window
    int i_lo = 0, i_hi = row0 < Sq ? n_t : 0;
    if (causal) i_hi = min(i_hi, row_last / kBN + 1 - t_begin);
    if (window > 0) {
      const int x = row0 - window - (kBN - 1);
      if (x >= 0) i_lo = x / kBN + 1 - t_begin;
    }
    i_lo = min(max(i_lo, 0), n_t);
    i_hi = min(max(i_hi, i_lo), n_t);

    // o at acc[4 j + e]: row ra + 8 (e >> 1), column 8 j + 2 t + (e & 1);
    // the tile's scores, then weights, at sc[4 j + e]: the same row, key
    // k0 + 8 j + 2 t + (e & 1)
    float acc[128], sc[32];
#pragma unroll
    for (int e = 0; e < 128; ++e) acc[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    // every tile is a turn of both warpgroups, run or not, so that their
    // turns pair up; warpgroup 0 goes first
    if (wg == 1) turn_pass(1);
    mbar_wait(full_q, 0);
    for (int i = 0; i < n_t; ++i) {
      const int s = i & 1;
      const uint32_t ph = (i >> 1) & 1;
      const int k0 = (t_begin + i) * kBN;
      const uint32_t ks = base + kQBytes + 2 * s * kTileBytes;
      const bool run = i >= i_lo && i < i_hi;
      mbar_wait(full_k + 8 * s, ph);
      if (run) {
        // ---- S = q k^T (the first k-step ignores sc's old values)
        pin(sc);
        turn_wait(1 + wg);
        fence();
        qk(sc, qw, kQBox, ks);
        commit();
        turn_pass(2 - wg);
        wait_all();
        pin(sc);

        // ---- mask, online softmax (base 2), rescale the accumulator
        const bool need_mask = k0 + kBN > Sk ||
                               (causal && k0 + kBN - 1 > wrow0) ||
                               (window > 0 && wrow0 + 15 - k0 >= window);
        float corr[2];
        softmax(sc, m, l, corr, need_mask, ra, k0, t, Sk, causal, window,
                scale_log2);
        uint32_t p[16];
        pack_p(p, sc);
#pragma unroll
        for (int e = 0; e < 128; ++e) acc[e] *= corr[(e >> 1) & 1];

        // ---- o += p v
        mbar_wait(full_v + 8 * s, ph);
        pin(acc);
        pin(p);
        fence();
        pv(acc, p, ks + kTileBytes);
        commit();
        wait_all();
        pin(acc);
      } else {
        turn_wait(1 + wg);
        turn_pass(2 - wg);
        mbar_wait(full_v + 8 * s, ph);          // the stage's loads landed
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);   // the stage may be refilled
    }

    // ---- o = acc / max(l, 1e-30) in bf16, staged in the warpgroup's own
    // q rows (its products are done) in the map's swizzled layout, then
    // stored by TMA, which writes no row past Sq
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float li = l[r];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      li = fmaxf(li, 1e-30f);
      // x / li rounded to nearest, in three instructions: the product with
      // the rounded reciprocal, corrected by its exact residual (one FMA)
      // (tests/test_torch_attention.py pins that this is the quotient)
      const float rl = __frcp_rn(li);
      auto quot = [&](float x) {
        const float q = x * rl;
        return fmaf(fmaf(-q, li, x), rl, q);
      };
      const int rr = ra - row0 + 8 * r;         // the row in the warpgroup's
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const uint32_t at = qw + (c >> 3) * kQBox + rr * kRowBytes +
                            (((c & 7) ^ (rr & 7)) << 4) + 4 * t;
        const uint32_t v = pack_bf16(quot(acc[4 * c + 2 * r]),
                                     quot(acc[4 * c + 2 * r + 1]));
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(at), "r"(v) : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(3 + wg) : "memory");
    if ((threadIdx.x & 127) == 0 && row0 < Sq) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        tma_store(&mo, qw + c * kQBox, c * kBoxCols, row0, bh);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
}

// One warpgroup, the body's two products on one tile: d (64 x 64 fp32) =
// a b^T, then e (64 x 256 fp32) = bf16(d) c, for a, b, c (64 x 256) bf16
// through the same tensor maps, descriptors and wgmma wrappers
__global__ void __launch_bounds__(128, 1)
flash_attention_wgmma_probe_kernel(const __grid_constant__ CUtensorMap ma,
                                   const __grid_constant__ CUtensorMap mb,
                                   const __grid_constant__ CUtensorMap mc,
                                   float* __restrict__ d,
                                   float* __restrict__ e) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t bar = base + 3 * kTileBytes;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, 3 * kTileBytes);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      tma_load(base + c * kKBox, &ma, bar, c * kBoxCols, 0, 0);
      tma_load(base + kTileBytes + c * kKBox, &mb, bar, c * kBoxCols, 0, 0);
      tma_load(base + 2 * kTileBytes + c * kKBox, &mc, bar, c * kBoxCols, 0,
               0);
    }
  }
  mbar_wait(bar, 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ra = 16 * warp + (lane >> 2), t = lane & 3;
  float s[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = 0.f;
  pin(s);
  fence();
  qk(s, base, kKBox, base + kTileBytes);
  commit();
  wait_all();
  pin(s);
#pragma unroll
  for (int j = 0; j < 32; ++j)
    d[(ra + 8 * ((j >> 1) & 1)) * 64 + 8 * (j >> 2) + 2 * t + (j & 1)] = s[j];
  uint32_t p[16];
  pack_p(p, s);
  float acc[128];
#pragma unroll
  for (int j = 0; j < 128; ++j) acc[j] = 0.f;
  pin(acc);
  fence();
  pv(acc, p, base + 2 * kTileBytes);
  commit();
  wait_all();
  pin(acc);
#pragma unroll
  for (int j = 0; j < 128; ++j)
    e[(ra + 8 * ((j >> 1) & 1)) * 256 + 8 * (j >> 2) + 2 * t + (j & 1)] =
        acc[j];
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

// a (d2, d1, d0) array of `type` (elements of `bytes`), contiguous, as a
// 3-D map with boxes of (b0, b1, 1) and 128-byte swizzle; past the ends
// reads as zero and is not written
int make_map_3d(CUtensorMap* map, CUtensorMapDataType type, int bytes,
                const void* base, long long d0, long long d1, long long d2,
                int b0, int b1) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return kMapError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1,
                              (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)(d0 * bytes),
                                 (cuuint64_t)(d0 * d1 * bytes)};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(map, type, 3, const_cast<void*>(base), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + (int)r;
}

// (rows, 256) bf16 matrices of `heads` heads with boxes of (64 columns,
// box_rows rows, 1 head)
int make_map(CUtensorMap* map, const void* base, long long rows,
             long long heads, int box_rows) {
  return make_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, kHD,
                     rows, heads, kBoxCols, box_rows);
}

int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int Sq, int Sk, float scale, int causal,
           int window, cudaStream_t stream) {
  const long long BH = (long long)B * H;
  const long long n_q = (Sq + kBM - 1) / kBM;
  if (n_q * BH > INT_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo;
  int rc = make_map(&mq, q, Sq, BH, kBM);
  if (rc == 0) rc = make_map(&mk, k, Sk, (long long)B * KV, kBN);
  if (rc == 0) rc = make_map(&mv, v, Sk, (long long)B * KV, kBN);
  if (rc == 0) rc = make_map(&mo, o, Sq, BH, kBM / 2);   // a warpgroup's
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel_hd256_wgmma,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  flash_attention_kernel_hd256_wgmma<<<(unsigned)(n_q * BH), kThreads, kSmem,
                                       stream>>>(
      mq, mk, mv, mo, (int)BH, H, KV, Sq, Sk, (int)n_q, scale * kLog2e,
      causal, window);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// Float32 at head dim 256: 3xTF32 on warpgroup MMA (wgmma) on TMA-fed
// tiles, sm_90a.
//
// Bound at paligemma-3b's (8, 8, 1, 1024, 256) causal: the causal half of
// 4 B H S^2 hd is 34.4 GFLOP; three TF32 products stand for each fp32
// one, 103 GFLOP at 495 TFLOP/s: 0.2082 ms.  Only wgmma reaches that
// rate.  For 32-bit types wgmma has no transpose: both shared-memory
// operands are K-major, and A may come from registers.  The design:
//   - a split pass (split_kv_kernel) runs once a call, before the body:
//     k becomes its TF32 planes k_hi and k_lo (the same layout), v the
//     planes of v^T (B KV, 256, Skp): keys contiguous, so that v is a
//     K-major B operand of p v, and within each 8 keys in the order
//     0 2 4 6 1 3 5 7, the order in which p's accumulator layout hands
//     the keys to A's columns (column t is key 2t, t + 4 is 2t + 1);
//     keys past Sk (to Skp, the next multiple of 8) are zero.  Each k and
//     v element is split once a call, not once a block and warp that
//     reads it (eight query heads share paligemma's one kv head).  The
//     other route, o^T = v^T p^T with v^T as A from registers, would put
//     the head dim on the rows, so each row's rescale and sum would cross
//     warpgroups through shared memory;
//   - a block owns 64 query rows of one (batch, head): one consumer
//     warpgroup of 4 warps and one producer warp, 160 threads, so every
//     thread may hold 255 registers without setmaxnreg (o: 64 x 256 fp32,
//     128 a thread).  Two consumer warpgroups did not pay on an H100:
//     taking alternate key tiles, they spill under setmaxnreg's 240
//     registers; splitting the head dims, they run in lockstep at this
//     body's speed (PERF.md);
//   - shared memory: q (64 KB), each thread's own A fragments in the order
//     it reads them (one 16-byte read a k-step, no bank conflict; loaded
//     once, split as read), and a ring of five 32 KB slots that take, in
//     turn, a 32-key tile's k_hi, k_lo, v^T hi and v^T lo: 229,376 B, one
//     block an SM.  The producer keeps the ring full with TMA (full
//     barriers armed with expect_tx; empty barriers that each consumer
//     warp arrives on); a tile of k is eight boxes of 32 head dims (128
//     bytes, the swizzle's width), one of v^T is one box of 32 keys x 256
//     head dims; rows past a head's end read as zero;
//   - S = q k^T: 32 k-steps of wgmma m64n32k8, A (q's hi and lo) from
//     registers, three products a step, a commit group a step, kPipe
//     steps' A in registers: 240 registers, none spilled (two k-steps a
//     group, or a second box accumulator below, spill).  The tensor cores
//     sum a wgmma's terms into its accumulator with truncation, so a long
//     chain drifts: the small terms (lo hi, hi lo) run in one chain over
//     the 256 head dims, the large one (hi hi) in a chain restarted at
//     each 64-column box and added to the score with rounded fp32 adds
//     (tests/test_torch_attention.py holds that order at 1e-4 where one
//     chain misses).  A box's chain is read after the next k-step's small
//     products are issued, so the tensor cores have work meanwhile;
//   - the online softmax is the other bodies' (fp32, base 2, NEG_INF
//     masks and the masked-weight rule); p is split to TF32 hi and lo
//     straight into A's registers; a warp skips the accumulator's rescale
//     where no row's max moved (its factor is exactly 1);
//   - o += p v: per 8 keys three wgmma m64n256k8, A = p from registers,
//     B = the v^T planes;
//   - the tile-skipping rules and the 32-key tiles of the body this one
//     replaced; blocks launched longest-first (causal);
//   - o = acc / max(l, 1e-30) by l's rounded reciprocal and one FMA
//     correction, the correctly rounded quotient.
// A repeated call is bit-identical: no atomics, a fixed order of sums.
namespace tf {

using wg::commit;
using wg::desc_k;
using wg::fence;
using wg::mbar_arrive;
using wg::mbar_expect_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::pin;
using wg::smem_u32;
using wg::softmax;
using wg::tma_load;

constexpr int kBM = 64;                         // query rows a block
constexpr int kBN = 32;                         // keys a tile
constexpr int kHD = 256;
constexpr int kSteps = kHD / 8;                 // k-steps of q k^T
constexpr int kBoxCols = 32;                    // 128 bytes of fp32
constexpr int kThreads = 160;                   // consumers + producer warp
constexpr int kSlots = 5;
constexpr int kPipe = 3;                        // k-steps of A in registers
constexpr uint32_t kKBox = kBN * 128;           // 4 KB: 32 keys x 32 dims
constexpr uint32_t kQuarter = kBN * kHD * 4;    // 32 KB: one plane a tile
constexpr uint32_t kQBytes = kBM * kHD * 4;     // 64 KB
constexpr uint32_t kBarOff = kQBytes + kSlots * kQuarter;
// barriers (8 bytes each) at kBarOff: full[kSlots], empty[kSlots]
constexpr size_t kSmem = 1024 + kBarOff + 2 * kSlots * 8;

// wait until at most N committed groups are pending
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d (64 x 32 fp32) = (acc ? d : 0) + a (64 x 8 TF32, registers) b^T (b
// 32 x 8, K-major in shared memory)
__device__ __forceinline__ void mma_n32(float (&d)[16], const uint32_t* a,
                                        uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (64 x 256 fp32) += a (64 x 8 TF32, registers) b^T (b 256 x 8, K-major
// in shared memory)
__device__ __forceinline__ void mma_n256(float (&d)[128], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the split pass: a block takes 32 keys x 32 head dims of one kv head
__global__ void __launch_bounds__(256)
split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                float* __restrict__ khi, float* __restrict__ klo,
                float* __restrict__ vthi, float* __restrict__ vtlo, int Sk,
                int Skp) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const long long hk = (long long)blockIdx.z * Sk * kHD;
  const long long hv = (long long)blockIdx.z * kHD * Skp;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int key = k0 + r;
    float x = 0.f;
    if (key < Sk) {
      const long long at = hk + (long long)key * kHD + d0 + tx;
      uint32_t hi, lo;
      split(k[at], hi, lo);
      khi[at] = __uint_as_float(hi);
      klo[at] = __uint_as_float(lo);
      x = v[at];
    }
    tile[r][tx] = x;
  }
  __syncthreads();
  // position tx of a row of v^T holds key (tx & ~7) + perm(tx & 7)
  const int p = tx & 7;
  const int key = (tx & ~7) + (p < 4 ? 2 * p : 2 * p - 7);
  if (k0 + tx < Skp) {
#pragma unroll
    for (int r = ty; r < 32; r += 8) {
      const long long at = hv + (long long)(d0 + r) * Skp + k0 + tx;
      uint32_t hi, lo;
      split(tile[key][r], hi, lo);
      vthi[at] = __uint_as_float(hi);
      vtlo[at] = __uint_as_float(lo);
    }
  }
}

// s = q k^T over the 256 head dims (3xTF32, the sums as the top says).
// qt: this thread's A fragments, one float4 a k-step, 128 threads apart;
// khi, klo: the tile's planes (8 boxes of 32 dims).  k-step kk's A sits
// in registers kk % kPipe until its products are done, so kPipe - 1
// steps' products stay in flight while the next step's fragments are
// split, and the next fragments are read from shared memory as soon as
// these are split.  At a box's end its hi hi chain (sb) is added to s
// after the next step's small products are issued, so the tensor cores
// have work meanwhile
__device__ __forceinline__ void qk(float (&s)[16], float (&sm)[16],
                                   float (&sb)[16], const float4* qt,
                                   uint32_t khi, uint32_t klo) {
  uint32_t ah[kPipe][4], al[kPipe][4];
  float4 x = qt[0];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int r = kk % kPipe;
    if (kk >= kPipe) wait<kPipe - 1>();  // k-step kk - kPipe's are done
    split(x.x, ah[r][0], al[r][0]);
    split(x.y, ah[r][1], al[r][1]);
    split(x.z, ah[r][2], al[r][2]);
    split(x.w, ah[r][3], al[r][3]);
    if (kk + 1 < kSteps) x = qt[128 * (kk + 1)];
    pin(ah[r]);
    pin(al[r]);
    pin(sm);
    fence();
    const uint32_t off = (kk >> 2) * kKBox + (kk & 3) * 32;
    mma_n32(sm, al[r], desc_k(khi + off), kk > 0);
    mma_n32(sm, ah[r], desc_k(klo + off), 1);
    if ((kk & 7) == 0 && kk > 0) {       // box kk / 8 - 1 is issued
      commit();
      wait<1>();                         // and done
      pin(sb);
#pragma unroll
      for (int e = 0; e < 16; ++e) s[e] = kk == 8 ? sb[e] : s[e] + sb[e];
      pin(s);
      fence();
    }
    pin(sb);
    mma_n32(sb, ah[r], desc_k(khi + off), (kk & 7) != 0);
    commit();
  }
  wait<0>();
  pin(sm);
  pin(sb);
#pragma unroll
  for (int e = 0; e < 16; ++e) s[e] = (s[e] + sb[e]) + sm[e];
}

// o += p v over the tile's 32 keys: p's weights (s's layout) split into
// A's hi and lo (column t of k-step j is key 8 j + 2 t, t + 4 is 8 j +
// 2 t + 1: the v^T planes' key order), three m64n256k8 a k-step
__device__ __forceinline__ void pv(float (&o)[128], const float (&p)[16],
                                   uint32_t vthi, uint32_t vtlo) {
  uint32_t ph[16], pl[16];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split_p(p[4 * j], ph[4 * j], pl[4 * j]);
    split_p(p[4 * j + 2], ph[4 * j + 1], pl[4 * j + 1]);
    split_p(p[4 * j + 1], ph[4 * j + 2], pl[4 * j + 2]);
    split_p(p[4 * j + 3], ph[4 * j + 3], pl[4 * j + 3]);
  }
  pin(o);
  pin(ph);
  pin(pl);
  fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mma_n256(o, pl + 4 * j, desc_k(vthi + 32 * j));
    mma_n256(o, ph + 4 * j, desc_k(vtlo + 32 * j));
    mma_n256(o, ph + 4 * j, desc_k(vthi + 32 * j));
  }
  commit();
  wait<0>();
  pin(o);
}

// this thread's A fragments of q k^T into its own 16-byte column of
// shared memory: k-step kk at qt[128 kk], (row g, dim 8 kk + t), (g + 8,
// 8 kk + t), (g, 8 kk + t + 4), (g + 8, 8 kk + t + 4); rows past Sq zero
__device__ __forceinline__ void load_q(float4* qt, const float* qb, int ra,
                                       int t, int Sq) {
  const bool in_a = ra < Sq, in_b = ra + 8 < Sq;
  const float* pa = qb + (long long)ra * kHD + t;
  const float* pb = pa + 8 * kHD;
#pragma unroll 8
  for (int kk = 0; kk < kSteps; ++kk)
    qt[128 * kk] = make_float4(in_a ? pa[8 * kk] : 0.f,
                               in_b ? pb[8 * kk] : 0.f,
                               in_a ? pa[8 * kk + 4] : 0.f,
                               in_b ? pb[8 * kk + 4] : 0.f);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel_hd256_tf32(const __grid_constant__ CUtensorMap mkh,
                                  const __grid_constant__ CUtensorMap mkl,
                                  const __grid_constant__ CUtensorMap mvh,
                                  const __grid_constant__ CUtensorMap mvl,
                                  const float* __restrict__ q,
                                  float* __restrict__ o, int BH, int H,
                                  int KV, int Sq, int Sk, int n_q,
                                  float scale_log2, int causal, int window) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  unsigned char* gbase = smem + (base - smem_u32(smem));
  const uint32_t ring = base + kQBytes;
  const uint32_t full = base + kBarOff, empty = full + 8 * kSlots;

  const int bh = blockIdx.x % BH;               // b * H + h
  const int q0 = (n_q - 1 - blockIdx.x / BH) * kBM;   // longest first
  const int kvh = (bh / H) * KV + (bh % H) / (H / KV);
  const int q_hi = min(q0 + kBM, Sq) - 1;       // last real query row

  // the TPU kernel's skipping rules, on the block's real rows
  const int n_k = (Sk + kBN - 1) / kBN;
  const int t_end = causal ? min(n_k, q_hi / kBN + 1) : n_k;
  int t_begin = 0;
  if (window > 0) {
    const int x = q0 - window - (kBN - 2);
    if (x > 0) t_begin = (x + kBN - 1) / kBN;
  }
  const int n_t = max(t_end - t_begin, 0);      // tiles t_begin + i

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);              // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: one thread keeps the ring full; plane n of the
    // sequence (tile n / 4: k hi, k lo, v^T hi, v^T lo) goes to slot n % 5
    if (threadIdx.x == 128) {
      for (int n = 0; n < 4 * n_t; ++n) {
        const int s = n % kSlots, u = n / kSlots;
        if (u > 0) mbar_wait(empty + 8 * s, (u - 1) & 1);
        const int k0 = (t_begin + n / 4) * kBN;
        const uint32_t dst = ring + s * kQuarter, bar = full + 8 * s;
        mbar_expect_tx(bar, kQuarter);
        switch (n & 3) {
          case 0:
          case 1:
#pragma unroll
            for (int c = 0; c < kHD / kBoxCols; ++c)
              tma_load(dst + c * kKBox, (n & 3) ? &mkl : &mkh, bar,
                       c * kBoxCols, k0, kvh);
            break;
          default:
            tma_load(dst, (n & 3) == 3 ? &mvl : &mvh, bar, k0, 0, kvh);
        }
      }
    }
  } else {
    // ---- consumers: the warpgroup owns rows q0 .. q0 + 63
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int t = lane & 3;
    const int wrow0 = q0 + 16 * warp;           // the warp's rows
    const int ra = wrow0 + (lane >> 2);         // this thread's: ra, ra + 8
    float4* qt = reinterpret_cast<float4*>(gbase) + threadIdx.x;
    load_q(qt, q + (long long)bh * Sq * kHD, ra, t, Sq);

    // o at acc[4 j + e]: row ra + 8 (e >> 1), column 8 j + 2 t + (e & 1);
    // the tile's scores, then weights, at sc[4 j + e]: the same row, key
    // k0 + 8 j + 2 t + (e & 1)
    float acc[128], sc[16], sm[16], sb[16];
#pragma unroll
    for (int e = 0; e < 128; ++e) acc[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) sc[e] = sm[e] = sb[e] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    for (int i = 0; i < n_t; ++i) {
      const int k0 = (t_begin + i) * kBN;
      // the tile's planes: sequence 4 i + c in slot (4 i + c) % kSlots,
      // its (4 i + c) / kSlots-th use
      const int n = 4 * i;
      auto slot = [&](int c) { return (n + c) % kSlots; };
      auto use = [&](int c) { return (uint32_t)((n + c) / kSlots) & 1; };
      // ---- S = q k^T
      mbar_wait(full + 8 * slot(0), use(0));
      mbar_wait(full + 8 * slot(1), use(1));
      qk(sc, sm, sb, qt, ring + slot(0) * kQuarter,
         ring + slot(1) * kQuarter);
      __syncwarp();
      if (lane == 0) {                          // the k planes may go
        mbar_arrive(empty + 8 * slot(0));
        mbar_arrive(empty + 8 * slot(1));
      }

      // ---- mask, online softmax (base 2), rescale the accumulator (not
      // where no row's max moved: its factor is exactly 1)
      const bool need_mask = k0 + kBN > Sk ||
                             (causal && k0 + kBN - 1 > wrow0) ||
                             (window > 0 && wrow0 + 15 - k0 >= window);
      float corr[2];
      softmax(sc, m, l, corr, need_mask, ra, k0, t, Sk, causal, window,
              scale_log2);
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int e = 0; e < 128; ++e) acc[e] *= corr[(e >> 1) & 1];
      }

      // ---- o += p v
      mbar_wait(full + 8 * slot(2), use(2));
      mbar_wait(full + 8 * slot(3), use(3));
      pv(acc, sc, ring + slot(2) * kQuarter, ring + slot(3) * kQuarter);
      __syncwarp();
      if (lane == 0) {                          // the v planes may go
        mbar_arrive(empty + 8 * slot(2));
        mbar_arrive(empty + 8 * slot(3));
      }
    }

    // ---- o = acc / max(l, 1e-30), the correctly rounded quotient
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float li = l[r];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      li = fmaxf(li, 1e-30f);
      const float rl = __frcp_rn(li);
      auto quot = [&](float x) {
        const float qv = x * rl;
        return fmaf(fmaf(-qv, li, x), rl, qv);
      };
      const int row = ra + 8 * r;
      if (row >= Sq) continue;
      float* dst = o + ((long long)bh * Sq + row) * kHD + 2 * t;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(quot(acc[4 * j + 2 * r]), quot(acc[4 * j + 2 * r + 1]));
    }
  }
}

// One warpgroup, the body's two products on one tile, through its split
// pass, tensor maps, descriptors and A layouts: d (64 x 32) = a b^T, then
// e (64 x 256) = d c, for a (64 x 256), b, c (32 x 256) float32
__global__ void __launch_bounds__(128, 1)
flash_attention_f32_wgmma_probe_kernel(const __grid_constant__ CUtensorMap mkh,
                                       const __grid_constant__ CUtensorMap mkl,
                                       const __grid_constant__ CUtensorMap mvh,
                                       const __grid_constant__ CUtensorMap mvl,
                                       const float* __restrict__ a,
                                       float* __restrict__ d,
                                       float* __restrict__ e) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  unsigned char* gbase = smem + (base - smem_u32(smem));
  const uint32_t ring = base + kQBytes, bar = ring + 4 * kQuarter;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, 4 * kQuarter);
#pragma unroll
    for (int c = 0; c < kHD / kBoxCols; ++c) {
      tma_load(ring + c * kKBox, &mkh, bar, c * kBoxCols, 0, 0);
      tma_load(ring + kQuarter + c * kKBox, &mkl, bar, c * kBoxCols, 0, 0);
    }
    tma_load(ring + 2 * kQuarter, &mvh, bar, 0, 0, 0);
    tma_load(ring + 3 * kQuarter, &mvl, bar, 0, 0, 0);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ra = 16 * warp + (lane >> 2), t = lane & 3;
  float4* qt = reinterpret_cast<float4*>(gbase) + threadIdx.x;
  load_q(qt, a, ra, t, kBM);
  mbar_wait(bar, 0);
  float s[16], sm[16], sb[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) s[j] = sm[j] = sb[j] = 0.f;
  qk(s, sm, sb, qt, ring, ring + kQuarter);
#pragma unroll
  for (int j = 0; j < 16; ++j)
    d[(ra + 8 * ((j >> 1) & 1)) * kBN + 8 * (j >> 2) + 2 * t + (j & 1)] = s[j];
  float acc[128];
#pragma unroll
  for (int j = 0; j < 128; ++j) acc[j] = 0.f;
  pv(acc, s, ring + 2 * kQuarter, ring + 3 * kQuarter);
#pragma unroll
  for (int j = 0; j < 128; ++j)
    e[(ra + 8 * ((j >> 1) & 1)) * kHD + 8 * (j >> 2) + 2 * t + (j & 1)] =
        acc[j];
}

// keys of the v^T planes: Sk rounded up to the next multiple of 8
inline long long padded_keys(int Sk) { return (Sk + 7LL) / 8 * 8; }

// the workspace (floats) of a call: k_hi, k_lo, then v^T hi, v^T lo
inline long long workspace_floats(long long heads, int Sk) {
  return 2 * heads * kHD * (Sk + padded_keys(Sk));
}

// the split pass over (heads, Sk, 256) k and v into `ws`, and the four
// planes' tensor maps
int split_and_map(const void* k, const void* v, float* ws, long long heads,
                  int Sk, CUtensorMap* maps, cudaStream_t stream) {
  const long long Skp = padded_keys(Sk);
  float* khi = ws;
  float* klo = khi + heads * Sk * kHD;
  float* vthi = klo + heads * Sk * kHD;
  float* vtlo = vthi + heads * kHD * Skp;
  if (heads > 65535) return (int)cudaErrorInvalidValue;
  // (heads, d1, d0) float32 planes, boxes of (b0, b1, 1)
  auto map = [&](CUtensorMap* m, const float* p, long long d0, long long d1,
                 int b0, int b1) {
    return wg::make_map_3d(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p, d0, d1,
                           heads, b0, b1);
  };
  int rc = map(&maps[0], khi, kHD, Sk, kBoxCols, kBN);
  if (rc == 0) rc = map(&maps[1], klo, kHD, Sk, kBoxCols, kBN);
  if (rc == 0) rc = map(&maps[2], vthi, Skp, kHD, kBN, kHD);
  if (rc == 0) rc = map(&maps[3], vtlo, Skp, kHD, kBN, kHD);
  if (rc != 0) return rc;
  const dim3 grid((unsigned)((Skp + 31) / 32), kHD / 32, (unsigned)heads);
  split_kv_kernel<<<grid, 256, 0, stream>>>(
      (const float*)k, (const float*)v, khi, klo, vthi, vtlo, Sk, (int)Skp);
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, void* o, void* ws,
           int B, int H, int KV, int Sq, int Sk, float scale, int causal,
           int window, cudaStream_t stream) {
  const long long BH = (long long)B * H;
  const long long n_q = (Sq + kBM - 1) / kBM;
  if (ws == nullptr || n_q * BH > INT_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  int rc = split_and_map(k, v, (float*)ws, (long long)B * KV, Sk, maps,
                         stream);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel_hd256_tf32,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  flash_attention_kernel_hd256_tf32<<<(unsigned)(n_q * BH), kThreads, kSmem,
                                      stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)q, (float*)o,
      (int)BH, H, KV, Sq, Sk, (int)n_q, scale * kLog2e, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace tf

// ---------------------------------------------------------------------------
// Bf16 at head dims 257-512: warpgroup MMA (wgmma) on TMA-fed tiles, the
// scores computed once a tile, sm_90a.
//
// Bound at (4, 8, 8, 1024, 512) causal: 134 MB of q, k, v and o (0.0401
// ms at 3.35 TB/s) against the causal half of 4 B H S^2 hd, 34.4 GFLOP
// (0.0347 ms at 989 TFLOP/s).  The slab body below recomputes q k^T over
// the whole head dim once for each 128 columns of o (four times at hd
// 512) on mma.sync.  This body follows the bf16 hd 256 one's pattern
// (flash_attention_kernel_hd256_wgmma) with the head dim split instead
// of the rows:
//   - a block owns 64 query rows of one (batch, head) and all of hd: a
//     producer warpgroup (one thread issues the TMA loads) and two
//     consumer warpgroups, each owning NB 64-column boxes of the head dim
//     (NB = 3 up to hd 384, 4 up to 512); setmaxnreg gives a consumer
//     thread 232 registers (o: 64 x 64 NB fp32, 32 NB a thread) and a
//     producer thread 40;
//   - shared memory: q (64 rows x 2 NB boxes, loaded once), a ring of
//     32-key stages of k and v (2 NB boxes of 4 KB each), and the score
//     exchange: 224 KB at NB 4 (two stages), 176 KB at NB 3 (three);
//   - TMA maps with the true hd's extent: columns past hd read as zero,
//     and boxes wholly past it are not loaded but zeroed once in shared
//     memory (q's and every stage's k), so that every warpgroup runs the
//     same unrolled products; no column past hd or row past Sq is
//     stored, so q, k and v are read in place;
//   - S = q k^T: each consumer warpgroup takes its boxes' partial (wgmma
//     m64n32k16, 4 k-steps a box), writes it to shared memory in its
//     accumulator layout, and after a named barrier of both adds the
//     other's: the same two fp32 terms in both warpgroups (a + b is b +
//     a), so both hold the same scores, m and l bit for bit;
//   - the online softmax is the other bodies' (fp32, base 2 with scale *
//     log2(e) in one FMA, NEG_INF masks and the masked-weight rule); p is
//     rounded to bf16 straight into wgmma's A registers;
//   - o += p v over the warpgroup's own columns: 2 wgmma m64n(64 NB)k16,
//     A from registers, v MN-major through the transpose bit;
//   - the TPU kernel's tile-skipping rules at 32-key tiles on the block's
//     rows; blocks launched longest-first (causal);
//   - o = acc / max(l, 1e-30) by l's rounded reciprocal and one FMA
//     correction, staged in the warpgroup's own q boxes and stored by
//     TMA.
// A repeated call is bit-identical: no atomics, a fixed order of sums.
namespace wide {

using wg::desc;
using wg::desc_k;
using wg::fence;
using wg::commit;
using wg::wait_all;
using wg::mbar_arrive;
using wg::mbar_expect_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::pin;
using wg::smem_u32;
using wg::softmax;
using wg::tma_load;
using wg::tma_store;

constexpr int kBM = 64;                         // query rows a block
constexpr int kBN = 32;                         // keys a tile
constexpr int kBoxCols = 64;                    // 128 bytes of bf16
constexpr int kThreads = 3 * 128;               // producer + 2 consumers
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr uint32_t kRowBytes = kBoxCols * 2;
constexpr uint32_t kQBox = kBM * kRowBytes;     // 8 KB
constexpr uint32_t kKBox = kBN * kRowBytes;     // 4 KB
constexpr uint32_t kXBytes = 2 * 2 * 128 * 16 * 4;   // the exchange, x 2

template <int NB>
struct Geo {
  static constexpr int kBoxes = 2 * NB;
  static constexpr int kStages = NB == 4 ? 2 : 3;
  static constexpr uint32_t kQBytes = kBoxes * kQBox;
  static constexpr uint32_t kTile = kBoxes * kKBox;   // k or v
  static constexpr uint32_t kXOff = kQBytes + kStages * 2 * kTile;
  static constexpr uint32_t kBarOff = kXOff + kXBytes;
  // barriers (8 bytes each) at kBarOff: q, full k[kStages], full
  // v[kStages], empty[kStages]
  static constexpr size_t kSmem = 1024 + kBarOff + (1 + 3 * kStages) * 8;
};

// d (64 x 32 fp32) = (acc ? d : 0) + a (64 x 16) b^T (b 32 x 16); a and b
// K-major in shared memory
__device__ __forceinline__ void mma_64x32(float (&d)[16], uint64_t da,
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

// d (64 x 192 fp32) += a (64 x 16, bf16 pairs in registers) b (16 x 192);
// b MN-major in shared memory (transposed on read)
__device__ __forceinline__ void mma_64x192(float (&d)[96],
                                           const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, "
      "p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// d (64 x 256 fp32) += a b, as mma_64x192
__device__ __forceinline__ void mma_pv(float (&d)[128], const uint32_t* a,
                                       uint64_t db) {
  wg::mma_64x256(d, a, db);
}
__device__ __forceinline__ void mma_pv(float (&d)[96], const uint32_t* a,
                                       uint64_t db) {
  mma_64x192(d, a, db);
}

template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel_wide_wgmma(const __grid_constant__ CUtensorMap mq,
                                  const __grid_constant__ CUtensorMap mk,
                                  const __grid_constant__ CUtensorMap mv,
                                  const __grid_constant__ CUtensorMap mo,
                                  int BH, int H, int KV, int Sq, int Sk,
                                  int hd, int n_q, float scale_log2,
                                  int causal, int window) {
  using G = Geo<NB>;
  constexpr int kS = G::kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  unsigned char* gbase = smem + (base - smem_u32(smem));
  const uint32_t sq = base;                     // q: 2 NB boxes of 64 rows
  const uint32_t ring = base + G::kQBytes;      // stage s: k, then v
  float4* xs = reinterpret_cast<float4*>(gbase + G::kXOff);
  const uint32_t bar = base + G::kBarOff;
  const uint32_t full_q = bar, full_k = bar + 8, full_v = full_k + 8 * kS,
                 empty = full_v + 8 * kS;       // + 8 x stage
  const int n_box = (hd + kBoxCols - 1) / kBoxCols;   // boxes holding hd

  const int bh = blockIdx.x % BH;               // b * H + h
  const int q0 = (n_q - 1 - blockIdx.x / BH) * kBM;   // longest first
  const int kvh = (bh / H) * KV + (bh % H) / (H / KV);
  const int q_hi = min(q0 + kBM, Sq) - 1;       // last real query row

  // the TPU kernel's skipping rules, on the block's real rows
  const int n_k = (Sk + kBN - 1) / kBN;
  const int t_end = causal ? min(n_k, q_hi / kBN + 1) : n_k;
  int t_begin = 0;
  if (window > 0) {
    const int x = q0 - window - (kBN - 2);
    if (x > 0) t_begin = (x + kBN - 1) / kBN;
  }
  const int n_t = max(t_end - t_begin, 0);      // tiles t_begin + i

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);              // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the ring full; tile i goes to stage
    // i % kS
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, n_box * kQBox);
      for (int c = 0; c < n_box; ++c)
        tma_load(sq + c * kQBox, &mq, full_q, c * kBoxCols, q0, bh);
      for (int i = 0; i < n_t; ++i) {
        const int s = i % kS, u = i / kS;
        if (u > 0) mbar_wait(empty + 8 * s, (u - 1) & 1);
        const int k0 = (t_begin + i) * kBN;
        const uint32_t ks = ring + 2 * s * G::kTile;
        mbar_expect_tx(full_k + 8 * s, n_box * kKBox);
        for (int c = 0; c < n_box; ++c)
          tma_load(ks + c * kKBox, &mk, full_k + 8 * s, c * kBoxCols, k0, kvh);
        mbar_expect_tx(full_v + 8 * s, n_box * kKBox);
        for (int c = 0; c < n_box; ++c)
          tma_load(ks + G::kTile + c * kKBox, &mv, full_v + 8 * s,
                   c * kBoxCols, k0, kvh);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns boxes NB wg .. NB wg + NB - 1 of
    // the head dim, both all 64 rows
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = threadIdx.x & 31;
    const int t = lane & 3;
    const int wrow0 = q0 + 16 * warp;           // the warp's rows
    const int ra = wrow0 + (lane >> 2);         // this thread's: ra, ra + 8
    const int box0 = NB * wg;                   // the warpgroup's first box
    const int nb = min(NB, n_box - box0);       // its boxes that hold hd
    // its boxes past hd: zero in q and in every stage's k (TMA never
    // writes them), seen by the tensor cores' async proxy
    for (int bx = nb; bx < NB; ++bx) {
      uint4* q4 = reinterpret_cast<uint4*>(gbase + (box0 + bx) * kQBox);
      for (int i = tid; i < (int)(kQBox / 16); i += 128)
        q4[i] = make_uint4(0u, 0u, 0u, 0u);
      for (int st = 0; st < kS; ++st) {
        uint4* k4 = reinterpret_cast<uint4*>(
            gbase + G::kQBytes + 2 * st * G::kTile + (box0 + bx) * kKBox);
        for (int i = tid; i < (int)(kKBox / 16); i += 128)
          k4[i] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");

    // o at acc[4 j + e]: row ra + 8 (e >> 1), column 64 box0 + 8 j + 2 t +
    // (e & 1); the tile's scores, then weights, at sc[4 j + e]: the same
    // row, key k0 + 8 j + 2 t + (e & 1)
    float acc[32 * NB], sc[16];
#pragma unroll
    for (int e = 0; e < 32 * NB; ++e) acc[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) sc[e] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    mbar_wait(full_q, 0);
    for (int i = 0; i < n_t; ++i) {
      const int s = i % kS;
      const uint32_t ph = (i / kS) & 1;
      const int k0 = (t_begin + i) * kBN;
      const uint32_t ks = ring + 2 * s * G::kTile;
      mbar_wait(full_k + 8 * s, ph);
      // ---- this warpgroup's partial of S = q k^T (the first k-step
      // ignores sc's old values)
      pin(sc);
      fence();
#pragma unroll
      for (int bx = 0; bx < NB; ++bx) {
        const uint32_t qa = sq + (box0 + bx) * kQBox;
        const uint32_t kb = ks + (box0 + bx) * kKBox;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_64x32(sc, desc_k(qa + kk * 32), desc_k(kb + kk * 32),
                    bx > 0 || kk > 0);
      }
      commit();
      wait_all();
      pin(sc);
      // ---- the exchange: both warpgroups add the same two partials
      float4* mine = xs + ((i & 1) * 2 + wg) * 4 * 128 + tid;
      const float4* other = xs + ((i & 1) * 2 + (1 - wg)) * 4 * 128 + tid;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mine[128 * j] =
            make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3]);
      asm volatile("bar.sync 1, 256;" ::: "memory");
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 x = other[128 * j];
        sc[4 * j] += x.x;
        sc[4 * j + 1] += x.y;
        sc[4 * j + 2] += x.z;
        sc[4 * j + 3] += x.w;
      }

      // ---- mask, online softmax (base 2), rescale the accumulator
      const bool need_mask = k0 + kBN > Sk ||
                             (causal && k0 + kBN - 1 > wrow0) ||
                             (window > 0 && wrow0 + 15 - k0 >= window);
      float corr[2];
      softmax(sc, m, l, corr, need_mask, ra, k0, t, Sk, causal, window,
              scale_log2);
      uint32_t p[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
#pragma unroll
      for (int e = 0; e < 32 * NB; ++e) acc[e] *= corr[(e >> 1) & 1];

      // ---- o += p v over the warpgroup's columns: 2 k-steps of 16 keys
      mbar_wait(full_v + 8 * s, ph);
      pin(acc);
      pin(p);
      fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        mma_pv(acc, p + 4 * kk,
               desc(ks + G::kTile + box0 * kKBox + kk * 16 * kRowBytes,
                    kKBox, 1024));
      commit();
      wait_all();
      pin(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);   // the stage may be refilled
    }

    // ---- o = acc / max(l, 1e-30) in bf16, staged in the warpgroup's own
    // q boxes (its products are done) in the map's swizzled layout, then
    // stored by TMA, which writes no column past hd and no row past Sq
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float li = l[r];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      li = fmaxf(li, 1e-30f);
      // the correctly rounded quotient, as the hd 256 bodies take it
      const float rl = __frcp_rn(li);
      auto quot = [&](float x) {
        const float q = x * rl;
        return fmaf(fmaf(-q, li, x), rl, q);
      };
      const int rr = ra - q0 + 8 * r;           // the row in the block
#pragma unroll
      for (int c = 0; c < 8 * NB; ++c) {
        const uint32_t at = sq + (box0 + (c >> 3)) * kQBox + rr * kRowBytes +
                            (((c & 7) ^ (rr & 7)) << 4) + 4 * t;
        const uint32_t v = pack_bf16(quot(acc[4 * c + 2 * r]),
                                     quot(acc[4 * c + 2 * r + 1]));
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(at), "r"(v) : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
    if (tid == 0) {
      for (int c = 0; c < nb; ++c)
        tma_store(&mo, sq + (box0 + c) * kQBox, (box0 + c) * kBoxCols, q0,
                  bh);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
}

// NB for head dim hd (257-512): the boxes a consumer warpgroup owns
inline int boxes_for(int hd) { return hd <= 3 * 2 * kBoxCols ? 3 : 4; }

template <int NB>
int launch_nb(const void* q, const void* k, const void* v, void* o, int B,
              int H, int KV, int Sq, int Sk, int hd, float scale, int causal,
              int window, cudaStream_t stream) {
  const long long BH = (long long)B * H;
  const long long n_q = (Sq + kBM - 1) / kBM;
  if (n_q * BH > INT_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo;
  auto map = [&](CUtensorMap* m, const void* p, long long rows,
                 long long heads, int box_rows) {
    return wg::make_map_3d(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, hd,
                           rows, heads, kBoxCols, box_rows);
  };
  int rc = map(&mq, q, Sq, BH, kBM);
  if (rc == 0) rc = map(&mk, k, Sk, (long long)B * KV, kBN);
  if (rc == 0) rc = map(&mv, v, Sk, (long long)B * KV, kBN);
  if (rc == 0) rc = map(&mo, o, Sq, BH, kBM);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel_wide_wgmma<NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Geo<NB>::kSmem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  flash_attention_kernel_wide_wgmma<NB>
      <<<(unsigned)(n_q * BH), kThreads, Geo<NB>::kSmem, stream>>>(
          mq, mk, mv, mo, (int)BH, H, KV, Sq, Sk, hd, (int)n_q,
          scale * kLog2e, causal, window);
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int Sq, int Sk, int hd, float scale, int causal,
           int window, cudaStream_t stream) {
  return boxes_for(hd) == 3
             ? launch_nb<3>(q, k, v, o, B, H, KV, Sq, Sk, hd, scale, causal,
                            window, stream)
             : launch_nb<4>(q, k, v, o, B, H, KV, Sq, Sk, hd, scale, causal,
                            window, stream);
}

}  // namespace wide

// ---------------------------------------------------------------------------
// Head dims above 256, both types: column slabs on mma.sync.
//
// A head dim above 256 (the wrapper zero-pads it to a multiple of 8, D)
// would hold o's 64 x D accumulator in registers, more than a thread has.
// So a block owns 64 query rows (four warps of 16, as the hd <= 128 bodies)
// and 128 columns of o, a slab (grid (q tiles x slabs, H, B), the slabs of
// a q tile neighbours in the block order, so they read the same k and v
// tiles through L2).  For each 64-key tile it computes the scores over the
// whole head dim in chunks of 64 columns, chunk by chunk in the same order
// in every slab, so the slabs of a row hold the same scores, m and l bit
// for bit; then p v over its own 128 columns.  Each chunk's q and k, and
// each tile's 128 columns of v, are an item of a two-buffer cp.async ring
// (rows padded by 16 bytes; rows past Sq or Sk and columns past D zero).
// The products are the hd <= 128 bodies': bf16 by mma.sync.m16n8k16,
// float32 by m16n8k8 on the 3xTF32 split (q split as read from shared
// memory).  A chunk's scores restart their accumulator and are added to
// the tile's with rounded fp32 adds (the large terms; the small ones run
// in one chain over D), so a long head dim does not lengthen the chain the
// tensor cores sum into; the softmax, masks and skipping rules are the
// other bodies'.  The cost: q and k are read once a slab (ceil(D / 128)
// times, from L2 after the first), the scores computed once a slab.
// ---------------------------------------------------------------------------
namespace slab {

constexpr int kBK = 64;        // keys a tile
constexpr int kKC = 64;        // head-dim columns a chunk of q k^T
constexpr int kNS = 128;       // columns of o a block owns
constexpr int kThreads = 128;  // four warps of 16 query rows

template <typename T>
struct Geo {
  static constexpr int kE = 16 / (int)sizeof(T);       // elements a copy
  static constexpr int kQKPitch = kKC + kE;            // elements, padded
  static constexpr int kVPitch = kNS + kE;
  static constexpr int kQK = (kBQ + kBK) * kQKPitch;   // q's chunk, k's
  static constexpr int kV = kBK * kVPitch;
  static constexpr int kBuf = kQK > kV ? kQK : kV;     // elements a buffer
  static constexpr size_t kSmem = 2 * (size_t)kBuf * sizeof(T);
};

}  // namespace slab

template <typename T>
__global__ void __launch_bounds__(slab::kThreads)
flash_attention_slab(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H,
                     int KV, int Sq, int Sk, int D, int nslab,
                     float scale_log2, int causal, int window) {
  using namespace slab;
  using Ge = Geo<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kJ = kBK / 8;                   // score n-tiles
  constexpr int kNT = kNS / 8;                  // o n-tiles
  constexpr int kE = Ge::kE;
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);

  const int slab_i = blockIdx.x % nslab;
  const int q0 = blockIdx.x / nslab * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q_hi = min(q0 + kBQ, Sq) - 1;       // last real query row
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;                      // fragment row group
  const int t = lane & 3;                       // fragment column group
  const int row0 = q0 + warp * 16;              // the warp's first row
  const int row_last = row0 + 15;
  const int col_v = slab_i * kNS;               // the slab's first column
  const T* qb = q + (long long)(b * H + h) * Sq * D;
  const T* kb = k + (long long)(b * KV + kvh) * Sk * D;
  const T* vb = v + (long long)(b * KV + kvh) * Sk * D;
  T* ob = o + (long long)(b * H + h) * Sq * D;

  // the TPU kernel's skipping rules, on the block's real rows
  const int n_k = (Sk + kBK - 1) / kBK;
  const int t_end = causal ? min(n_k, q_hi / kBK + 1) : n_k;
  int t_begin = 0;
  if (window > 0) {
    const int x = q0 - window - (kBK - 2);
    if (x > 0) t_begin = (x + kBK - 1) / kBK;
  }
  const int n_kc = (D + kKC - 1) / kKC;         // score chunks
  const int per = n_kc + 1;                     // items a tile
  const int n_items = max(t_end - t_begin, 0) * per;

  // item i into buffer i & 1: chunk j's 64 columns of the block's q rows
  // and the tile's k rows, or the tile's v rows over the slab
  auto issue = [&](int i) {
    const int k0 = (t_begin + i / per) * kBK;
    const int j = i % per;
    T* dst = smem + (i & 1) * Ge::kBuf;
    if (j < n_kc) {
      const int c0 = j * kKC;
      constexpr int kCh = kKC / kE;             // copies a row
      for (int x = threadIdx.x; x < (kBQ + kBK) * kCh; x += kThreads) {
        const int r = x / kCh, c = x % kCh;
        const bool is_q = r < kBQ;
        const int row = is_q ? q0 + r : k0 + r - kBQ;
        const bool in = row < (is_q ? Sq : Sk) && c0 + c * kE < D;
        const T* src = (is_q ? qb : kb) + (long long)row * D + c0 + c * kE;
        cp_async16(dst + r * Ge::kQKPitch + c * kE, in ? src : qb, in);
      }
    } else {
      constexpr int kCh = kNS / kE;
      for (int x = threadIdx.x; x < kBK * kCh; x += kThreads) {
        const int r = x / kCh, c = x % kCh;
        const bool in = k0 + r < Sk && col_v + c * kE < D;
        cp_async16(dst + r * Ge::kVPitch + c * kE,
                   in ? vb + (long long)(k0 + r) * D + col_v + c * kE : vb,
                   in);
      }
    }
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kNT][4];
  float s[kJ][4], sl[kJ][4];    // the tile's scores; float32's small terms
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (n_items > 0) issue(0);
  cp_async_commit();
  for (int i = 0; i < n_items; ++i) {
    if (i + 1 < n_items) issue(i + 1);
    cp_async_commit();
    cp_async_wait1();                // item i has landed (this thread)
    __syncthreads();                 // ... for all; item i - 1 is used
    const int k0 = (t_begin + i / per) * kBK;
    const int j = i % per;
    const T* buf = smem + (i & 1) * Ge::kBuf;
    if (causal && k0 > row_last) {   // the warp's rows precede the tile
      __syncthreads();
      continue;
    }
    if (j == 0) {
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = sl[jj][e] = 0.f;
    }
    if (j < n_kc) {
      // ---- the chunk's scores, in an accumulator of their own
      const T* qs = buf + (warp * 16) * Ge::kQKPitch;
      const T* ks = buf + kBQ * Ge::kQKPitch;
      float sc[kJ][4];
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[jj][e] = 0.f;
      if constexpr (kF32) {
        const float* qf = reinterpret_cast<const float*>(qs);
        const float* kf = reinterpret_cast<const float*>(ks);
#pragma unroll
        for (int ii = 0; ii < kKC / 16; ++ii) {     // k-steps 2ii, 2ii + 1
          const int c = qk_dim(t, 2 * ii);
          const float4 x0 = *reinterpret_cast<const float4*>(
              qf + g * Ge::kQKPitch + c);
          const float4 x1 = *reinterpret_cast<const float4*>(
              qf + (g + 8) * Ge::kQKPitch + c);
          uint32_t ah[2][4], al[2][4];
          split(x0.x, ah[0][0], al[0][0]);
          split(x1.x, ah[0][1], al[0][1]);
          split(x0.y, ah[0][2], al[0][2]);
          split(x1.y, ah[0][3], al[0][3]);
          split(x0.z, ah[1][0], al[1][0]);
          split(x1.z, ah[1][1], al[1][1]);
          split(x0.w, ah[1][2], al[1][2]);
          split(x1.w, ah[1][3], al[1][3]);
#pragma unroll
          for (int jj = 0; jj < kJ; ++jj) {
            const float4 y = *reinterpret_cast<const float4*>(
                kf + (jj * 8 + g) * Ge::kQKPitch + c);
            uint32_t bh[2][2], bl[2][2];
            split(y.x, bh[0][0], bl[0][0]);
            split(y.y, bh[0][1], bl[0][1]);
            split(y.z, bh[1][0], bl[1][0]);
            split(y.w, bh[1][1], bl[1][1]);
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
              mma_tf32(sl[jj], al[kk], bh[kk][0], bh[kk][1]);
              mma_tf32(sl[jj], ah[kk], bl[kk][0], bl[kk][1]);
              mma_tf32(sc[jj], ah[kk], bh[kk][0], bh[kk][1]);
            }
          }
        }
      } else {
        const uint32_t* q32 = reinterpret_cast<const uint32_t*>(qs);
        constexpr int P2 = Ge::kQKPitch / 2;        // pitch in 32-bit words
#pragma unroll
        for (int kk = 0; kk < kKC / 16; ++kk) {
          const int c = kk * 8 + t;                 // in 32-bit words
          const uint32_t qa[4] = {q32[g * P2 + c], q32[(g + 8) * P2 + c],
                                  q32[g * P2 + c + 4],
                                  q32[(g + 8) * P2 + c + 4]};
#pragma unroll
          for (int jj = 0; jj < kJ; ++jj) {
            const uint32_t* kr = reinterpret_cast<const uint32_t*>(ks) +
                                 (jj * 8 + g) * P2 + c;
            mma_bf16(sc[jj], qa, kr[0], kr[4]);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] += sc[jj][e];
    } else {
      if constexpr (kF32) {
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[jj][e] += sl[jj][e];
      }
      // ---- mask, online softmax (base 2), rescale the accumulator; the
      // masked-weight rule of flash_attention_kernel
      const bool need_mask = k0 + kBK > Sk ||
                             (causal && k0 + kBK - 1 > row0) ||
                             (window > 0 && row_last - k0 >= window);
      if (need_mask) {
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qp = row0 + g + (e >> 1) * 8;
            const int kp = k0 + jj * 8 + 2 * t + (e & 1);
            bool keep = kp < Sk;
            if (causal) keep = keep && qp >= kp;
            if (window > 0) keep = keep && qp - kp < window;
            if (!keep) s[jj][e] = kNegInf;
          }
      }
      float mx[2] = {kNegInf, kNegInf}, corr[2];
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[jj][e]);
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(0xffffffffu, mx[ii], 1));
        mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(0xffffffffu, mx[ii], 2));
        const float m_new = fmaxf(
            m[ii], mx[ii] == kNegInf ? kNegInf : mx[ii] * scale_log2);
        corr[ii] = ex2(m[ii] - m_new);
        m[ii] = m_new;
        l[ii] *= corr[ii];
      }
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mi = m[e >> 1];
          const float x = fmaf(s[jj][e], scale_log2, -mi);
          s[jj][e] = ex2(need_mask && s[jj][e] == kNegInf ? kNegInf - mi : x);
          l[e >> 1] += s[jj][e];
        }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
      // ---- acc += p v over the slab's columns
      constexpr int P = Ge::kVPitch;
      if constexpr (kF32) {
        const float* vf = reinterpret_cast<const float*>(buf);
#pragma unroll
        for (int kk = 0; kk < kJ; ++kk) {
          uint32_t ah[4], al[4];
          split_p(s[kk][0], ah[0], al[0]);
          split_p(s[kk][2], ah[1], al[1]);
          split_p(s[kk][1], ah[2], al[2]);
          split_p(s[kk][3], ah[3], al[3]);
          const float* vr = vf + (kk * 8 + 2 * t) * P;
#pragma unroll
          for (int mm = 0; mm < kNT / 4; ++mm) {
            const float4 x0 =
                *reinterpret_cast<const float4*>(vr + v_dim(g, 4 * mm));
            const float4 x1 =
                *reinterpret_cast<const float4*>(vr + P + v_dim(g, 4 * mm));
            const float a0[4] = {x0.x, x0.y, x0.z, x0.w};
            const float a1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              uint32_t bh0, bl0, bh1, bl1;
              split(a0[e], bh0, bl0);
              split(a1[e], bh1, bl1);
              float(&d)[4] = acc[4 * mm + e];
              mma_tf32(d, al, bh0, bh1);
              mma_tf32(d, ah, bl0, bl1);
              mma_tf32(d, ah, bh0, bh1);
            }
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kJ / 2; ++kk) {
          const uint32_t pa[4] = {
              pack_bf16(s[2 * kk][0], s[2 * kk][1]),
              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
          const T* vr = buf + (kk * 16 + 2 * t) * P + g;
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            const T* c = vr + n * 8;
            const uint32_t b0 = pack_bf16(c[0], c[P]);
            const uint32_t b1 = pack_bf16(c[8 * P], c[9 * P]);
            mma_bf16(acc[n], pa, b0, b1);
          }
        }
      }
    }
    __syncthreads();                 // buffer i & 1 may be refilled
  }

#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    float li = l[ii];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li = fmaxf(li, 1e-30f);
    const int r = row0 + g + 8 * ii;
    if (r >= Sq) continue;
    if constexpr (kF32) {            // head dims v_dim(2t (+ 1), n)
#pragma unroll
      for (int mm = 0; mm < kNT / 4; ++mm) {
        const int col = col_v + v_dim(2 * t, 4 * mm);
        if (col >= D) continue;
        float* dst = ob + (long long)r * D + col;
        const int n = 4 * mm, c = 2 * ii;
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[n][c] / li, acc[n + 1][c] / li,
                        acc[n + 2][c] / li, acc[n + 3][c] / li);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(
            acc[n][c + 1] / li, acc[n + 1][c + 1] / li,
            acc[n + 2][c + 1] / li, acc[n + 3][c + 1] / li);
      }
    } else {
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        if (col_v + n * 8 >= D) continue;
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r * D + col_v +
                                           n * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[n][2 * ii] / li,
                                  acc[n][2 * ii + 1] / li);
      }
    }
  }
}

template <typename T>
int launch_slab(const void* q, const void* k, const void* v, void* o, int B,
                int H, int KV, int Sq, int Sk, int D, float scale,
                int causal, int window, cudaStream_t stream) {
  const size_t smem = slab::Geo<T>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_slab<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) {      // report it, leave no stale error behind
    cudaGetLastError();
    return (int)e;
  }
  const int nslab = (D + slab::kNS - 1) / slab::kNS;
  const dim3 grid((Sq + kBQ - 1) / kBQ * nslab, H, B);
  flash_attention_slab<T><<<grid, slab::kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, KV, Sq, Sk, D, nslab,
      scale * kLog2e, causal, window);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int Sq, int Sk, float scale, int causal,
           int window, cudaStream_t stream) {
  const size_t smem = Cfg<T, HD>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) {      // report it, leave no stale error behind
    cudaGetLastError();
    return (int)e;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, HD>
      <<<grid, Cfg<T, HD>::kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, KV, Sq, Sk,
      scale * kLog2e, causal, window);
  return (int)cudaGetLastError();
}

// launches of each body since the library was loaded, which body ran for
// a test: flash_attention_kernel (hd <= 128), the hd 256 wgmma and tf32
// bodies, the wide wgmma body, the slab body
int g_body_launches[5] = {0, 0, 0, 0, 0};

int counted(int body, int rc) {
  if (rc == 0) ++g_body_launches[body];
  return rc;
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, void* ws,
              int B, int H, int KV, int Sq, int Sk, int hd, float scale,
              int causal, int window, cudaStream_t s) {
  switch (hd) {
    case 32:
      return counted(0, launch<T, 32>(q, k, v, o, B, H, KV, Sq, Sk, scale,
                                      causal, window, s));
    case 64:
      return counted(0, launch<T, 64>(q, k, v, o, B, H, KV, Sq, Sk, scale,
                                      causal, window, s));
    case 128:
      return counted(0, launch<T, 128>(q, k, v, o, B, H, KV, Sq, Sk, scale,
                                       causal, window, s));
    case 256:
      if constexpr (std::is_same<T, float>::value)
        return counted(2, tf::launch(q, k, v, o, ws, B, H, KV, Sq, Sk, scale,
                                     causal, window, s));
      else
        return counted(1, wg::launch(q, k, v, o, B, H, KV, Sq, Sk, scale,
                                     causal, window, s));
    default:
      if (hd <= 256 || hd % 8 != 0) return (int)cudaErrorInvalidValue;
      // bf16 up to hd 512: the wide wgmma body (its shared memory holds
      // q's 64 rows and two 32-key stages up to there); float32 and wider
      // head dims: the slab body
      if constexpr (std::is_same<T, __nv_bfloat16>::value)
        if (hd <= kWideMaxHd)
          return counted(3, wide::launch(q, k, v, o, B, H, KV, Sq, Sk, hd,
                                         scale, causal, window, s));
      return counted(4, launch_slab<T>(q, k, v, o, B, H, KV, Sq, Sk, hd,
                                       scale, causal, window, s));
  }
}

}  // namespace

// q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd); o: (B, H, Sq, hd); contiguous,
// 16-byte aligned, all of one type: dtype 0 = float32, 1 = bfloat16.
// H % KV == 0, hd in {32, 64, 128, 256} or a multiple of 8 above 256 (bf16
// to 512 the wide wgmma body, else the slab body); window <= 0 means no
// sliding window.  scale is the softmax
// scale of the true head dim: the wrapper zero-pads q, k and v of any other
// hd up to the next of these bodies, which changes no score and no kept
// column.  ws: float32 at
// hd 256 only, flash_attention_workspace_floats(B * KV, Sk) floats,
// 16-byte aligned (the split planes of k and v); else unused.  Returns
// cudaGetLastError() of the launch, or 100000 + the CUresult of a tensor
// map the driver refused (the wgmma bodies).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* ws,
                                      int B, int H, int KV, int Sq, int Sk,
                                      int hd, int dtype, int causal,
                                      int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  if ((((unsigned long long)q | (unsigned long long)k |
        (unsigned long long)v | (unsigned long long)o |
        (unsigned long long)ws) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_hd<float>(q, k, v, o, ws, B, H, KV, Sq, Sk, hd, scale,
                            causal, window, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, o, ws, B, H, KV, Sq, Sk, hd,
                                    scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

// The float32 hd 256 body's workspace, in floats, for `heads` = B * KV kv
// heads of Sk keys
extern "C" long long flash_attention_workspace_floats(long long heads,
                                                      int Sk) {
  return tf::workspace_floats(heads, Sk);
}

// The bf16 hd 256 body's two products on one tile, for a card test: a, b,
// c (64, 256) bf16, contiguous, 16-byte aligned; d (64, 64) = a b^T and
// e (64, 256) = bf16(d) c, both float32.  Returns as above.
extern "C" int flash_attention_wgmma_probe(const void* a, const void* b,
                                           const void* c, void* d, void* e,
                                           void* stream) {
  CUtensorMap ma, mb, mc;
  int rc = wg::make_map(&ma, a, 64, 1, 64);
  if (rc == 0) rc = wg::make_map(&mb, b, 64, 1, 64);
  if (rc == 0) rc = wg::make_map(&mc, c, 64, 1, 64);
  if (rc != 0) return rc;
  const size_t smem = 1024 + 3 * wg::kTileBytes + 8;
  cudaError_t err = cudaFuncSetAttribute(
      wg::flash_attention_wgmma_probe_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  wg::flash_attention_wgmma_probe_kernel<<<1, 128, smem,
                                           (cudaStream_t)stream>>>(
      ma, mb, mc, (float*)d, (float*)e);
  return (int)cudaGetLastError();
}

// The bf16 hd 256 body's launch shape and resources, for a report: out[0]
// its dynamic shared memory (bytes), [1] threads a block, [2] and [3] the
// registers a consumer and a producer thread get (setmaxnreg), [4] the
// registers at entry and [5] the local memory a thread (spills), as the
// runtime reads them from the binary, [6] its blocks an SM.  Returns a
// cudaError_t.
extern "C" int flash_attention_hd256_info(int* out) {
  auto fn = wg::flash_attention_kernel_hd256_wgmma;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wg::kSmem);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                      wg::kThreads,
                                                      wg::kSmem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  out[0] = (int)wg::kSmem;
  out[1] = wg::kThreads;
  out[2] = wg::kConsumerRegs;
  out[3] = wg::kProducerRegs;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  out[6] = blocks;
  return 0;
}

// The float32 hd 256 body's two products on one tile, for a card test,
// through its split pass, tensor maps, descriptors and A layouts: a
// (64, 256), b and c (32, 256) float32, contiguous, 16-byte aligned; ws
// flash_attention_workspace_floats(1, 32) floats; d (64, 32) = a b^T and
// e (64, 256) = d c (d's weights split as the body splits p), float32.
// Returns as above.
extern "C" int flash_attention_f32_wgmma_probe(const void* a, const void* b,
                                               const void* c, void* d,
                                               void* e, void* ws,
                                               void* stream) {
  CUtensorMap maps[4];
  const cudaStream_t s = (cudaStream_t)stream;
  int rc = tf::split_and_map(b, c, (float*)ws, 1, tf::kBN, maps, s);
  if (rc != 0) return rc;
  const size_t smem = 1024 + tf::kQBytes + 4 * tf::kQuarter + 8;
  cudaError_t err = cudaFuncSetAttribute(
      tf::flash_attention_f32_wgmma_probe_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  tf::flash_attention_f32_wgmma_probe_kernel<<<1, 128, smem, s>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)a, (float*)d,
      (float*)e);
  return (int)cudaGetLastError();
}

// The float32 hd 256 body's launch shape and resources, for a report, as
// flash_attention_hd256_info's: out[0] dynamic shared memory (bytes), [1]
// threads a block, [2] and [3] the registers a consumer and a producer
// thread hold (no setmaxnreg: both the compiled count), [4] registers at
// entry, [5] local memory a thread, [6] blocks an SM.  Returns a
// cudaError_t.
extern "C" int flash_attention_hd256_f32_info(int* out) {
  auto fn = tf::flash_attention_kernel_hd256_tf32;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tf::kSmem);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                      tf::kThreads,
                                                      tf::kSmem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  out[0] = (int)tf::kSmem;
  out[1] = tf::kThreads;
  out[2] = attr.numRegs;
  out[3] = attr.numRegs;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  out[6] = blocks;
  return 0;
}

// The bf16 wide body's launch shape and resources at head dim hd (257-512),
// as flash_attention_hd256_info's: out[0] dynamic shared memory (bytes),
// [1] threads a block, [2] and [3] the registers a consumer and a producer
// thread get (setmaxnreg), [4] registers at entry, [5] local memory a
// thread, [6] blocks an SM, [7] the ring's stages.  Returns a cudaError_t.
extern "C" int flash_attention_wide_info(int hd, int* out) {
  if (hd <= 256 || hd > kWideMaxHd) return (int)cudaErrorInvalidValue;
  const bool three = wide::boxes_for(hd) == 3;
  const void* fn =
      three ? (const void*)wide::flash_attention_kernel_wide_wgmma<3>
            : (const void*)wide::flash_attention_kernel_wide_wgmma<4>;
  const size_t smem = three ? wide::Geo<3>::kSmem : wide::Geo<4>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                      wide::kThreads, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  out[0] = (int)smem;
  out[1] = wide::kThreads;
  out[2] = wide::kConsumerRegs;
  out[3] = wide::kProducerRegs;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  out[6] = blocks;
  out[7] = three ? wide::Geo<3>::kStages : wide::Geo<4>::kStages;
  return 0;
}

// Launches of each body since the library was loaded (g_body_launches'
// order), for a test that reads which body ran.
extern "C" int flash_attention_body_launches(int* out) {
  for (int i = 0; i < 5; ++i) out[i] = g_body_launches[i];
  return 0;
}
