// Single-token attention over a KV cache, the G query heads of each kv head
// resident (GQA decode).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention.py::decode_attention_bkgd
//
// o[b, n, g] = sum_{j < kv_len} softmax_j(q[b, n, g] . k[b, n, j] * scale)
//              v[b, n, j]
// q (B, KV, G, hd) contiguous, float32 or bfloat16; k and v of q's type,
// read in place through their element strides (batch, kv head, key) with
// the last dimension contiguous, so both the (B, KV, S, hd) layout and the
// model's (B, S, KV, hd) cache launch without a copy; rows 16-byte
// aligned.  kv_len an int32 on the device, 1 <= kv_len <= S; G <= 16,
// hd in {64, 128, 256}.  o (B, KV, G, hd) in q's type.
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
//   - flash decoding: the valid keys [0, kv_len) are cut into nsplit spans
//     of whole 64-key tiles, one block per (split, kv head, b).  The host
//     picks nsplit from S, B KV and the resident blocks per SM so that the
//     grid fills whole waves; each block derives its span from *kv_len on
//     the device, so no split is short while another is full and the host
//     never waits for the card.  A split with no keys exits at once; the
//     merge kernel skips it;
//   - bfloat16 (the timed case): both products on the tensor cores with
//     mma.sync.m16n8k16 (bf16 in, fp32 sums).  The G <= 16 query rows fill
//     the 16-row A operand once and stay in registers for the block; K
//     tiles reach the B operand through ldmatrix, V through ldmatrix.trans;
//     the scores' fp32 fragments are re-packed in registers as the bf16 A
//     operand of p v (their layouts coincide).  mma.sync, not wgmma: wgmma
//     takes 64 rows, so at G = 7 it would compute 57 padded rows for 7 real
//     ones and need warpgroup-wide tiles; m16n8k16 pads to 16, and the
//     kernel is bound by bytes, so the 9 padded rows cost no time that
//     matters;
//   - four warps per block, each taking its own 16 keys of every 64-key
//     stage; a ring of three stages of K and V (18 KB each at hd 64) is
//     filled by cp.async, so two stages (36 KB) are in flight per block
//     while the third is used.  At hd 64 a block holds 54 KB of shared
//     memory and 96 registers a thread (nvcc -Xptxas -v), so four blocks
//     reside per SM, ~147 KB in flight; at hd 128 two.  Rows at kv_len or
//     later are zero-filled, never read, and a warp whose 16 keys all lie
//     past kv_len skips the tile;
//   - hd 256 (paligemma, G = 8 over one kv head): the ring is 3 x 2 x 64
//     rows of 528 B = 198 KB, so one block resides per SM with 135 KB in
//     flight, which is still far above what hides the memory latency.  The
//     accumulator is 16 rows x 256 columns, 128 fp32 registers a thread;
//     holding q's 16 A fragments too (64 more) would crowd the 255-register
//     limit, so at hd 256 q is staged once in 8.25 KB of shared memory
//     after the ring (padded rows: the fragment loads hit 32 distinct
//     banks) and its fragments are read per k-step;
//   - rows are padded by 16 bytes in shared memory so the eight rows of an
//     ldmatrix fall in distinct banks;
//   - the four warps' (m, l, acc) are merged through shared memory at the
//     end, in a fixed order (no float atomics: a repeated call is
//     bit-identical);
//   - float32 keeps the SIMT body of the first port (one key per lane,
//     fp32 FMAs, two cp.async stages; one stage at hd 256, where two
//     stages of 64 fp32 rows would need 266 KB): it is held at 1e-4 and is
//     not the timed case; it takes the same strides and the same split
//     plan.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;              // keys per stage, in both bodies
constexpr int kMaxRows = 16;           // query rows of the mma A operand
constexpr int kMmaWarps = 4;
constexpr int kMmaStages = 3;
constexpr int kSimtWarps = 2;
constexpr float kNegInf = (float)(-0.7 * 3.4028234663852886e38);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;           // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
// d += a (16 x 16, bf16, row) * b (16 x 8, bf16, col), fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats -> bf16x2 (lo in the low half), round to nearest even as
// astype does
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
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

// The keys [lo, hi) of one split: the kv_len valid keys in whole tiles,
// ceil(tiles / nsplit) tiles per split (the last live split ragged, later
// ones empty).  kv_len_split_range in decode_attention.py mirrors it.
struct Span {
  int lo, hi;
};
__device__ __forceinline__ int tiles_per_split(int kv_len, int nsplit) {
  const int tiles = (kv_len + kTile - 1) / kTile;
  return (tiles + nsplit - 1) / nsplit;
}
__device__ __forceinline__ Span split_span(int kv_len, int nsplit,
                                           int split) {
  const int lo = min(split * tiles_per_split(kv_len, nsplit) * kTile,
                     kv_len);
  const int hi = min(lo + tiles_per_split(kv_len, nsplit) * kTile, kv_len);
  return {lo, hi};
}

__device__ __forceinline__ int read_kv_len(const int* p, int S) {
  return min(max(*p, 0), S);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// Merge the warps' (m, l, acc) of one block (kWarps x 16 rows staged in
// cm, cl, ca) and write o (one split) or the split's part.
template <typename T, int HD, int kWarps, int kRows>
__device__ __forceinline__ void finish_block(const float* cm, const float* cl,
                                             const float* ca, T* ob,
                                             float* pb, int G, int nsplit,
                                             int tid, int nthreads) {
  for (int i = tid; i < G * HD; i += nthreads) {
    const int g = i / HD;
    const int d = i - g * HD;
    float mx = kNegInf;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) mx = fmaxf(mx, cm[ww * kRows + g]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) {
      const float f = expf(cm[ww * kRows + g] - mx);
      lt += cl[ww * kRows + g] * f;
      at += ca[(ww * kRows + g) * HD + d] * f;
    }
    if (nsplit == 1) {
      ob[i] = from_f<T>(at / fmaxf(lt, 1e-30f));
    } else {
      pb[i] = at;
      if (d == 0) {
        pb[G * HD + g] = mx;
        pb[G * HD + G + g] = lt;
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void write_zeros(T* ob, int n, int tid,
                                            int nthreads) {
  for (int i = tid; i < n; i += nthreads) ob[i] = from_f<T>(0.f);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core body
// ---------------------------------------------------------------------------

template <int HD>
struct MmaGeo {
  static constexpr int kRowBytes = HD * 2 + 16;   // padded row
  static constexpr int kTileBytes = kTile * kRowBytes;
  static constexpr int kChunks = HD * 2 / 16;     // 16-byte chunks per row
  static constexpr size_t kRing = (size_t)kMmaStages * 2 * kTileBytes;
  // q's A fragments: in registers up to hd 128, else staged after the ring
  static constexpr bool kQInSmem = HD > 128;
  static constexpr size_t kSmem =
      kRing + (kQInSmem ? (size_t)kMaxRows * kRowBytes : 0);
  static_assert((size_t)kMmaWarps * kMaxRows * (HD + 2) * 4 <= kRing,
                "the warps' merge scratch must fit in the ring");
  static_assert(kSmem <= 232448, "dynamic shared memory above 227 KB");
};

// grid (nsplit, KV, B), 128 threads.  part: (B, KV, nsplit, G * (HD + 2))
// float32 with acc (G, HD), then m (G), then l (G); unused when nsplit == 1.
template <int HD>
__global__ void __launch_bounds__(kMmaWarps * 32)
decode_attention_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const int* __restrict__ kv_len_p, bf16* __restrict__ o,
                     float* __restrict__ part, int KV, int G, int S,
                     long long ksb, long long ksn, long long kss,
                     long long vsb, long long vsn, long long vss,
                     float scale) {
  using Geo = MmaGeo<HD>;
  constexpr int KS = HD / 16;          // k-steps of q k^T
  constexpr int NT = HD / 8;           // n-tiles of the accumulator
  constexpr int kThreads = kMmaWarps * 32;
  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;            // fragment row (and row + 8)
  const int tq = lane & 3;             // fragment column pair
  const long long bn = (long long)b * KV + n;
  const int kv_len = read_kv_len(kv_len_p, S);
  const Span sp = split_span(kv_len, nsplit, split);
  bf16* ob = o + bn * G * HD;
  if (sp.lo >= sp.hi) {
    if (nsplit == 1) write_zeros(ob, G * HD, tid, kThreads);
    return;
  }
  const unsigned char* kb =
      reinterpret_cast<const unsigned char*>(k + b * ksb + n * ksn);
  const unsigned char* vb =
      reinterpret_cast<const unsigned char*>(v + b * vsb + n * vsn);
  const long long krow = kss * 2, vrow = vss * 2;     // bytes per key
  const int n_tiles = (sp.hi - sp.lo + kTile - 1) / kTile;

  // q as the A operand of every k-step, rows >= G zero: in registers, or
  // (hd 256) staged in shared memory and read per k-step
  constexpr int QK = Geo::kQInSmem ? 1 : KS;
  unsigned qa[QK][4];
  const bf16* qb = q + bn * G * HD;
  unsigned char* qs = smem + Geo::kRing;
  if constexpr (Geo::kQInSmem) {
    // 4-byte words: q needs no more alignment than the register path's
    for (int i = tid; i < kMaxRows * HD / 2; i += kThreads) {
      const int row = i / (HD / 2);
      const int c = i % (HD / 2);
      reinterpret_cast<unsigned*>(qs + row * Geo::kRowBytes)[c] =
          row < G ? reinterpret_cast<const unsigned*>(qb + row * HD)[c]
                  : 0u;
    }
    __syncthreads();
  } else {
    const unsigned* r0 = reinterpret_cast<const unsigned*>(qb + gr * HD);
    const unsigned* r1 =
        reinterpret_cast<const unsigned*>(qb + (gr + 8) * HD);
#pragma unroll
    for (int kk = 0; kk < QK; ++kk) {
      const int c = (kk * 16 + 2 * tq) / 2;
      qa[kk][0] = gr < G ? r0[c] : 0u;
      qa[kk][1] = gr + 8 < G ? r1[c] : 0u;
      qa[kk][2] = gr < G ? r0[c + 4] : 0u;
      qa[kk][3] = gr + 8 < G ? r1[c + 4] : 0u;
    }
  }
  const unsigned* q0 =
      reinterpret_cast<const unsigned*>(qs + gr * Geo::kRowBytes);
  const unsigned* q1 =
      reinterpret_cast<const unsigned*>(qs + (gr + 8) * Geo::kRowBytes);

  auto load_tile = [&](int stage, int t0) {
    unsigned char* kd = smem + stage * 2 * Geo::kTileBytes;
    unsigned char* vd = kd + Geo::kTileBytes;
#pragma unroll
    for (int i = tid; i < kTile * Geo::kChunks; i += kThreads) {
      const int row = i / Geo::kChunks;
      const int c = i % Geo::kChunks;
      const int key = t0 + row;
      const bool in = key < sp.hi;
      const long long j = in ? key : sp.lo;
      cp_async16(kd + row * Geo::kRowBytes + c * 16, kb + j * krow + c * 16,
                 in);
      cp_async16(vd + row * Geo::kRowBytes + c * 16, vb + j * vrow + c * 16,
                 in);
    }
  };

#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < n_tiles) load_tile(s, sp.lo + s * kTile);
    cp_async_commit();
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  // ldmatrix addresses: lane -> row (lane & 7) of matrix (lane >> 3)
  const int mi = lane >> 3;
  const int r8 = lane & 7;
  const int k_off = (w * 16 + (mi >> 1) * 8 + r8) * Geo::kRowBytes +
                    (mi & 1) * 16;
  const int v_off = (w * 16 + (mi & 1) * 8 + r8) * Geo::kRowBytes +
                    (mi >> 1) * 16;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kMmaStages - 2>();   // tile it has landed (this thread)
    __syncthreads();                   // ... for all; tile it - 1 is used
    {
      const int nt = it + kMmaStages - 1;
      if (nt < n_tiles) load_tile(nt % kMmaStages, sp.lo + nt * kTile);
      cp_async_commit();
    }
    const int key0 = sp.lo + it * kTile + w * 16;
    if (key0 >= sp.hi) continue;       // warp-uniform: all 16 keys masked
    const unsigned char* kd = smem + (it % kMmaStages) * 2 * Geo::kTileBytes;
    const unsigned char* vd = kd + Geo::kTileBytes;

    // scores of the warp's 16 keys: two n-tiles of 8 keys
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned bk[4];
      ldsm_x4(bk, kd + k_off + kk * 32);
      if constexpr (Geo::kQInSmem) {
        const int c = kk * 8 + tq;
        const unsigned a[4] = {q0[c], q1[c], q0[c + 4], q1[c + 4]};
        mma_bf16(s[0], a, bk[0], bk[1]);
        mma_bf16(s[1], a, bk[2], bk[3]);
      } else {
        mma_bf16(s[0], qa[kk], bk[0], bk[1]);
        mma_bf16(s[1], qa[kk], bk[2], bk[3]);
      }
    }
    // mask, scale, online softmax; rows gr (e = 0, 1) and gr + 8 (e = 2, 3)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + j * 8 + 2 * tq + (e & 1);
        s[j][e] = key < sp.hi ? s[j][e] * scale : kNegInf;
      }
    float mx[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                      fmaxf(s[1][2 * h], s[1][2 * h + 1]));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      mx[h] = fmaxf(m[h], x);
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      corr[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
    }
    float p[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = expf(s[j][e] - mx[e >> 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      l[h] = l[h] * corr[h] + ((p[0][2 * h] + p[0][2 * h + 1]) +
                               (p[1][2 * h] + p[1][2 * h + 1]));
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      acc[t][0] *= corr[0];
      acc[t][1] *= corr[0];
      acc[t][2] *= corr[1];
      acc[t][3] *= corr[1];
    }
    // p (rounded to bf16) as the A operand: the score fragments of keys
    // 0-7 and 8-15 are its k halves
    const unsigned pa[4] = {pack_bf16(p[0][0], p[0][1]),
                            pack_bf16(p[0][2], p[0][3]),
                            pack_bf16(p[1][0], p[1][1]),
                            pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      unsigned bv[4];
      ldsm_x4_trans(bv, vd + v_off + dp * 32);
      mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
      mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring is free for the merge

  // the warp's row sums over its lanes, then merge the four warps
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  float* cm = reinterpret_cast<float*>(smem);        // kMmaWarps x 16
  float* cl = cm + kMmaWarps * kMaxRows;             // kMmaWarps x 16
  float* ca = cl + kMmaWarps * kMaxRows;             // kMmaWarps x 16 x HD
  if (tq == 0) {
    cm[w * kMaxRows + gr] = m[0];
    cm[w * kMaxRows + gr + 8] = m[1];
    cl[w * kMaxRows + gr] = l[0];
    cl[w * kMaxRows + gr + 8] = l[1];
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    float* a0 = ca + (w * kMaxRows + gr) * HD + t * 8 + 2 * tq;
    float* a1 = a0 + 8 * HD;
    a0[0] = acc[t][0];
    a0[1] = acc[t][1];
    a1[0] = acc[t][2];
    a1[1] = acc[t][3];
  }
  __syncthreads();
  finish_block<bf16, HD, kMmaWarps, kMaxRows>(
      cm, cl, ca, ob, part + (bn * nsplit + split) * (long long)G * (HD + 2),
      G, nsplit, tid, kThreads);
}

// ---------------------------------------------------------------------------
// float32: SIMT body (one key per lane), not the timed case
// ---------------------------------------------------------------------------

template <int HD>
struct SimtGeo {
  static constexpr int kRowBytes = HD * 4 + 16;   // padded row
  static constexpr int kTileBytes = kTile * kRowBytes;
  static constexpr int kChunks = HD * 4 / 16;
  static constexpr int kStages = HD > 128 ? 1 : 2;   // K and V per stage
};

template <int HD, int GB>
constexpr size_t simt_smem() {
  return (size_t)GB * HD * 4 + (size_t)kSimtWarps * GB * 32 * 4 +
         (size_t)2 * SimtGeo<HD>::kStages * SimtGeo<HD>::kTileBytes;
}

template <int HD, int GB>
__global__ void __launch_bounds__(kSimtWarps * 32)
decode_attention_simt(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const int* __restrict__ kv_len_p,
                      float* __restrict__ o, float* __restrict__ part,
                      int KV, int G, int S, long long ksb, long long ksn,
                      long long kss, long long vsb, long long vsn,
                      long long vss, float scale) {
  using Geo = SimtGeo<HD>;
  constexpr int NC = HD / 32;                   // accumulator columns/lane
  constexpr int kThreads = kSimtWarps * 32;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // GB x HD
  float* ps = qs + GB * HD;                     // kSimtWarps x GB x 32
  char* kvbuf = reinterpret_cast<char*>(ps + kSimtWarps * GB * 32);

  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const long long bn = (long long)b * KV + n;
  const int kv_len = read_kv_len(kv_len_p, S);
  const Span sp = split_span(kv_len, nsplit, split);
  float* ob = o + bn * G * HD;
  if (sp.lo >= sp.hi) {
    if (nsplit == 1) write_zeros(ob, G * HD, tid, kThreads);
    return;
  }
  const float* qb = q + bn * G * HD;
  const float* kb = k + b * ksb + n * ksn;
  const float* vb = v + b * vsb + n * vsn;
  const int lo = sp.lo, hi = sp.hi;
  const int n_tiles = (hi - lo + kTile - 1) / kTile;

  for (int i = tid; i < GB * HD; i += kThreads)
    qs[i] = i < G * HD ? qb[i] : 0.f;

  auto load_tile = [&](int stage, int t0) {
    char* kd = kvbuf + stage * 2 * Geo::kTileBytes;
    char* vd = kd + Geo::kTileBytes;
    for (int i = tid; i < kTile * Geo::kChunks; i += kThreads) {
      const int row = i / Geo::kChunks;
      const int c = i - row * Geo::kChunks;
      const int key = t0 + row;
      const bool in = key < hi;
      const long long j = in ? key : lo;
      cp_async16(kd + row * Geo::kRowBytes + c * 16, kb + j * kss + c * 4,
                 in);
      cp_async16(vd + row * Geo::kRowBytes + c * 16, vb + j * vss + c * 4,
                 in);
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

  load_tile(0, lo);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = lo + it * kTile;
    if (Geo::kStages == 2 && it + 1 < n_tiles) {
      load_tile((it + 1) & 1, t0 + kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t0 + w * 32 < hi) {                    // warp-uniform skip
      const char* kd =
          kvbuf + (Geo::kStages == 2 ? it & 1 : 0) * 2 * Geo::kTileBytes;
      const char* vd = kd + Geo::kTileBytes;
      // scores of this lane's key for all GB rows
      const float* krow =
          reinterpret_cast<const float*>(kd + (w * 32 + lane) * Geo::kRowBytes);
      float s[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) s[g] = 0.f;
#pragma unroll 4
      for (int c = 0; c < HD; c += 4) {
        const float4 kf = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + g * HD + c);
          s[g] = fmaf(qv.x, kf.x, s[g]);
          s[g] = fmaf(qv.y, kf.y, s[g]);
          s[g] = fmaf(qv.z, kf.z, s[g]);
          s[g] = fmaf(qv.w, kf.w, s[g]);
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
        pw[g * 32 + lane] = p;
      }
      __syncwarp();
      // acc += p v over the warp's 32 keys, 4 at a time
      for (int j = 0; j < 32; j += 4) {
        float vv[4][NC];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            vv[jj][c] = reinterpret_cast<const float*>(
                vd + (w * 32 + j + jj) * Geo::kRowBytes)[lane * NC + c];
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
    if (Geo::kStages == 1 && it + 1 < n_tiles) {
      load_tile(0, t0 + kTile);
      cp_async_commit();
    }
  }

  // merge the warps' states through shared memory (the tiles are free)
  float* cm = reinterpret_cast<float*>(kvbuf);  // kSimtWarps x GB
  float* cl = cm + kSimtWarps * GB;             // kSimtWarps x GB
  float* ca = cl + kSimtWarps * GB;             // kSimtWarps x GB x HD
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
  finish_block<float, HD, kSimtWarps, GB>(
      cm, cl, ca, ob, part + (bn * nsplit + split) * (long long)G * (HD + 2),
      G, nsplit, tid, kThreads);
}

// grid (KV, B): merge the live splits' (m, l, acc) into o.
template <typename T, int HD>
__global__ void __launch_bounds__(128)
decode_attention_merge(const float* __restrict__ part, T* __restrict__ o,
                       const int* __restrict__ kv_len_p, int KV, int G,
                       int S, int nsplit) {
  const long long bn = (long long)blockIdx.y * KV + blockIdx.x;
  const long long pitch = (long long)G * (HD + 2);
  const float* pb = part + bn * nsplit * pitch;
  const int kv_len = read_kv_len(kv_len_p, S);
  const int per = tiles_per_split(kv_len, nsplit);
  const int tiles = (kv_len + kTile - 1) / kTile;
  const int live = per > 0 ? (tiles + per - 1) / per : 0;
  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) {
    const int g = i / HD;
    float mx = kNegInf;
    for (int s = 0; s < live; ++s)
      mx = fmaxf(mx, pb[s * pitch + G * HD + g]);
    float lt = 0.f, at = 0.f;
    for (int s = 0; s < live; ++s) {
      const float f = expf(pb[s * pitch + G * HD + g] - mx);
      lt += pb[s * pitch + G * HD + G + g] * f;
      at += pb[s * pitch + i] * f;
    }
    o[bn * G * HD + i] = from_f<T>(at / fmaxf(lt, 1e-30f));
  }
}

struct Args {
  const void *q, *k, *v;
  const int* kv_len;
  void* o;
  float* part;
  int B, KV, G, S, hd, nsplit;
  float scale;
  long long ksb, ksn, kss, vsb, vsn, vss;
  cudaStream_t stream;
};

// Call f(kernel, dynamic shared memory, threads) with the kernel that a
// (dtype, hd, G) launches: the tensor-core body for bfloat16, the SIMT
// body (rows padded to 4, 8 or 16) for float32.
template <typename F>
int with_mma(int hd, F&& f) {
  if (hd == 64) return f(decode_attention_mma<64>, MmaGeo<64>::kSmem, 128);
  if (hd == 128) return f(decode_attention_mma<128>, MmaGeo<128>::kSmem, 128);
  if (hd == 256) return f(decode_attention_mma<256>, MmaGeo<256>::kSmem, 128);
  return (int)cudaErrorInvalidValue;
}
template <int HD, typename F>
int with_simt_g(int G, F&& f) {
  if (G <= 4) return f(decode_attention_simt<HD, 4>, simt_smem<HD, 4>(), 64);
  if (G <= 8) return f(decode_attention_simt<HD, 8>, simt_smem<HD, 8>(), 64);
  return f(decode_attention_simt<HD, 16>, simt_smem<HD, 16>(), 64);
}
template <typename F>
int with_simt(int hd, int G, F&& f) {
  if (hd == 64) return with_simt_g<64>(G, f);
  if (hd == 128) return with_simt_g<128>(G, f);
  if (hd == 256) return with_simt_g<256>(G, f);
  return (int)cudaErrorInvalidValue;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) cudaGetLastError();   // leave no stale error behind
  return e;
}

struct Occupancy {
  int* out;
  template <typename K>
  int operator()(K kernel, size_t smem, int threads) const {
    cudaError_t e = allow_smem(kernel, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads,
                                                        smem);
    if (e != cudaSuccess) cudaGetLastError();
    return (int)e;
  }
};

template <typename T>
struct Launch {
  const Args& a;
  template <typename K>
  int operator()(K kernel, size_t smem, int threads) const {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3(a.nsplit, a.KV, a.B), threads, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, a.kv_len, (T*)a.o,
        a.part, a.KV, a.G, a.S, a.ksb, a.ksn, a.kss, a.vsb, a.vsn, a.vss,
        a.scale);
    e = cudaGetLastError();
    if (e != cudaSuccess || a.nsplit == 1) return (int)e;
    const dim3 grid(a.KV, a.B);
    if (a.hd == 64)
      decode_attention_merge<T, 64><<<grid, 128, 0, a.stream>>>(
          a.part, (T*)a.o, a.kv_len, a.KV, a.G, a.S, a.nsplit);
    else if (a.hd == 128)
      decode_attention_merge<T, 128><<<grid, 128, 0, a.stream>>>(
          a.part, (T*)a.o, a.kv_len, a.KV, a.G, a.S, a.nsplit);
    else
      decode_attention_merge<T, 256><<<grid, 128, 0, a.stream>>>(
          a.part, (T*)a.o, a.kv_len, a.KV, a.G, a.S, a.nsplit);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// Resident blocks per SM of the kernel that (hd, dtype, G) launches, from
// the occupancy calculator (the wrapper's split planner reads it once).
extern "C" int decode_attention_blocks_per_sm(int hd, int dtype, int G,
                                              int* out) {
  if (dtype == 1) return with_mma(hd, Occupancy{out});
  if (dtype == 0) return with_simt(hd, G, Occupancy{out});
  return (int)cudaErrorInvalidValue;
}

// q, o: (B, KV, G, hd) contiguous; k, v: element strides (batch, kv head,
// key) with the last dimension contiguous, 16-byte aligned rows; all of
// one type: dtype 0 = float32, 1 = bfloat16.  kv_len: one int32 on the
// device.  The valid keys are cut into nsplit splits of whole 64-key tiles
// (split_span); part: (B, KV, nsplit, G * (hd + 2)) float32 scratch when
// nsplit > 1.  G in 1..16, hd in {64, 128, 256}.
// Returns cudaGetLastError() of the launches.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* kv_len, void* o,
    void* part, int B, int KV, int G, int S, int hd, int dtype, int nsplit,
    float scale, long long ksb, long long ksn, long long kss, long long vsb,
    long long vsn, long long vss, void* stream) {
  if (B <= 0 || KV <= 0) return 0;
  const long long align = dtype == 1 ? 8 : 4;     // elements per 16 bytes
  if (G < 1 || G > kMaxRows || S < 1 || nsplit < 1 || nsplit > 65535 ||
      KV > 65535 || B > 65535 || ((unsigned long long)k & 15) ||
      ((unsigned long long)v & 15) || ksb % align || ksn % align ||
      kss % align || vsb % align || vsn % align || vss % align ||
      (nsplit > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, (const int*)kv_len, o, (float*)part, B, KV, G, S,
               hd, nsplit, scale, ksb, ksn, kss, vsb, vsn, vss,
               (cudaStream_t)stream};
  if (dtype == 1) return with_mma(hd, Launch<bf16>{a});
  if (dtype == 0) return with_simt(hd, G, Launch<float>{a});
  return (int)cudaErrorInvalidValue;
}
