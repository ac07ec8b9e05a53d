// Blocked online-softmax (flash) attention, causal / sliding window / GQA.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_bhsd
//
// o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / G, j] * scale) v[b, h / G, j]
// over the unmasked keys j (causal: j <= i; window w: i - j < w); masked
// scores are NEG_INF = -0.7 * FLT_MAX, as in the TPU kernel and the plain
// version.  q (B, H, Sq, hd), k and v (B, KV, Sk, hd), float32 or bfloat16,
// contiguous; G = H / KV; hd in {32, 64, 128, 256} (the wrapper zero-pads
// any other hd <= 256 up to the next of these and passes the true hd's
// scale).  o (B, H, Sq, hd) in q's type.
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
// Head dim 256 (paligemma-3b's) changes four things, for want of
// registers in bf16 and of shared memory in fp32, and for fp32's sums:
//   - the key tile is 32 keys, so the S tile is 16 floats a thread beside
//     the 128 of the o accumulator (16 rows x 256 columns a warp);
//   - q is staged raw in shared memory (cp.async, with the first k / v
//     tile) and its fragments are read per head-dim step: 64 registers of
//     bf16 q fragments would not fit beside the accumulator, and split
//     fp32 planes of q (133 KB) would not fit beside the k / v stages;
//     fp32 splits its q fragment as it reads it, once per step and tile;
//   - shared memory is 4 x 32 x 264 x 2 + 64 x 264 x 2 = 101,376 B in
//     bf16 (two blocks an SM) and 4 x 32 x 260 x 4 + 64 x 260 x 4 =
//     199,680 B in fp32 (one), both under the 232,448 B opt-in limit;
//   - fp32 adds each head-dim step's large q k^T term to the score with
//     one rounded fp32 add instead of leaving it in the mma's accumulator,
//     whose running sum is truncated: over 32 steps that lost 1e-4 of a
//     peaky softmax's output (q and k scaled by 8).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr float kNegInf = (float)(-0.7 * 3.4028234663852886e38);
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int HD>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kBK = HD == 256 ? 32 : 64;            // keys a tile
  static constexpr int kJ = kBK / 8;                         // S n-tiles
  static constexpr int kPitch = HD + 16 / (int)sizeof(T);   // elements
  static constexpr int kTile = kBK * kPitch;                 // elements
  static constexpr bool kQRaw = HD == 256;         // q raw in shared mem
  static constexpr bool kQReg = !kQRaw && (!kF32 || HD <= 64);  // in regs
  static constexpr int kQPitch = HD + 4;       // floats (fp32 hd 128 split)
  static constexpr int kNT = HD / 8;                         // o n-tiles
  static constexpr int kM = kF32 && HD == 32 ? 2 : 1;  // row tiles/warp
  static constexpr int kThreads = kBQ / (16 * kM) * 32;      // per block
  static constexpr size_t kSmem =
      4 * (size_t)kTile * sizeof(T) +
      (kQRaw ? (size_t)kBQ * kPitch * sizeof(T)
             : kQReg ? 0 : 2 * (size_t)kBQ * kQPitch * sizeof(float));
  static constexpr int kMinBlocks =
      HD == 32 ? 4 : (HD == 64 || (HD == 256 && !kF32) ? 2 : 1);
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

// the block's q rows q0 .. q0 + kBQ - 1, raw, at the k / v pitch (rows
// past Sq zeroed); hd 256 only
template <typename T, int HD>
__device__ __forceinline__ void load_q(T* qs, const T* qb, int q0, int Sq) {
  using C = Cfg<T, HD>;
  constexpr int kE = 16 / (int)sizeof(T);
  constexpr int kChunks = HD / kE;
#pragma unroll 4
  for (int i = threadIdx.x; i < kBQ * kChunks; i += C::kThreads) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * kE;
    const bool in = q0 + r < Sq;
    const long long off = in ? (long long)(q0 + r) * HD + c : 0;
    cp_async16(qs + r * C::kPitch + c, qb + off, in);
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
  T* qs_raw = kv_s + 4 * C::kTile;              // hd 256 only
  float* qs_hi = reinterpret_cast<float*>(qs_raw);
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
  if (t_begin < t_end) {
    if constexpr (C::kQRaw) load_q<T, HD>(qs_raw, qb, q0, Sq);
    load_tile<T, HD>(kv_s, kv_s + C::kTile, kb, vb, t_begin * kBK, Sk);
  }
  cp_async_commit();

  // the q tile, split once: fragments a0 (row g, col t), a1 (g + 8, t),
  // a2 (g, t + 4), a3 (g + 8, t + 4) of each row tile; tf32 columns are
  // head dims qk_dim(t, kk) (+ 1), bf16 ones the pairs at 2t (+ 8).  At
  // hd 256 the raw tile arrives with the first k / v stage instead
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
  } else if constexpr (!C::kQRaw) {   // fp32 hd 128: split planes
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
      } else if constexpr (C::kF32) {   // hd 128 / 256: one row tile a warp
        float sl[kJ][4];
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sl[j][e] = 0.f;
#pragma unroll 2
        for (int kk = 0; kk < HD / 8; ++kk) {
          const int c = qk_dim(t, kk);
          uint32_t ah[4], al[4];
          if constexpr (C::kQRaw) {       // split as read
            const float* qr = reinterpret_cast<const float*>(qs_raw) +
                              (warp * 16 + g) * C::kPitch + c;
            constexpr int r8 = 8 * C::kPitch;
            split(qr[0], ah[0], al[0]);
            split(qr[r8], ah[1], al[1]);
            split(qr[1], ah[2], al[2]);
            split(qr[r8 + 1], ah[3], al[3]);
          } else {
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
          }
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
            if constexpr (C::kQRaw) {     // a rounded add (see the top)
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              mma_tf32(d, ah, bh0, bh1);
#pragma unroll
              for (int e = 0; e < 4; ++e) s[0][j][e] += d[e];
            } else {
              mma_tf32(s[0][j], ah, bh0, bh1);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[0][j][e] += sl[j][e];
      } else if constexpr (C::kQRaw) {  // bf16 hd 256: q read per k-step
        const uint32_t* qr = reinterpret_cast<const uint32_t*>(
            qs_raw + (warp * 16 + g) * C::kPitch + 2 * t);
        constexpr int r8 = 4 * C::kPitch;           // 8 rows, in words
#pragma unroll 2
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t a[4] = {qr[kk * 8], qr[r8 + kk * 8],
                                 qr[kk * 8 + 4], qr[r8 + kk * 8 + 4]};
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            const uint32_t* kr = reinterpret_cast<const uint32_t*>(
                ks + (j * 8 + g) * C::kPitch + 2 * t);
            mma_bf16(s[0][j], a, kr[kk * 8], kr[kk * 8 + 4]);
          }
        }
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
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, KV, Sq, Sk, scale, causal,
                            window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd); o: (B, H, Sq, hd); contiguous,
// 16-byte aligned, all of one type: dtype 0 = float32, 1 = bfloat16.
// H % KV == 0, hd in {32, 64, 128, 256}; window <= 0 means no sliding
// window.  scale is the softmax scale of the true head dim: the wrapper
// zero-pads q, k and v of any other hd <= 256 up to the next of these
// bodies, which changes no score and no kept column.  Returns
// cudaGetLastError() of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int KV, int Sq, int Sk, int hd,
                                      int dtype, int causal, int window,
                                      float scale, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  if ((((unsigned long long)q | (unsigned long long)k |
        (unsigned long long)v | (unsigned long long)o) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_hd<float>(q, k, v, o, B, H, KV, Sq, Sk, hd, scale, causal,
                            window, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Sk, hd, scale,
                                    causal, window, s);
  return (int)cudaErrorInvalidValue;
}
