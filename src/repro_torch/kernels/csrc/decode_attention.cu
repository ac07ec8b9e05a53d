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
// model's (B, S, KV, hd) cache launch without a copy.  kv_len an int32 on
// the device, 1 <= kv_len <= S.  Any G >= 1 and any hd >= 1.  o (B, KV, G,
// hd) in q's type.
//
// Every shape launches one of the bodies below (the wrapper's body_for
// picks it; nothing is copied or padded in device memory):
//   - a head dim up to 256 runs the least body of width 64, 128 or 256 at
//     or above it, on the true hd: the loads copy hd columns and leave the
//     body's columns past it zero in shared memory (cp.async's src-size
//     operand zero-fills; the hd 256 ring bodies' tensor maps have an hd
//     extent of the true hd, so a box's columns past it arrive zero), q's
//     columns past hd are zero, and only hd columns of o are stored.  A
//     zero column adds nothing to a score, so this is the same function;
//   - G > 16 query heads a kv head: in bf16 at widths 64 and 128 the rows
//     body (decode_attention_mma_rows) gives each warp 16 heads over all
//     keys of a stage, up to 128 heads a block, so a block reads each
//     cache row once; the other bodies run chunks of 16 heads (the mma A
//     operand's rows) as a grid index beside the split, next to it in the
//     block order, so a (split, kv head)'s chunks run side by side and read
//     the same cache rows through L2 (from device memory about once, from
//     L2 ceil(G / 16) times);
//   - hd above 256, and any cache whose rows are not 16-byte aligned (base
//     or strides), run the slab body (decode_attention_slab): a block owns
//     128 columns of o, scores each 32-key stage over the whole hd in
//     chunks of 128 columns, in a fixed order (so every slab of a row holds
//     the same m and l, bit for bit), and adds p v over its own columns.
//     Aligned rows are copied by 16-byte cp.async (zero-filled past hd),
//     others element by element.
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
//   - hd 64 and 128: four warps per block, each taking its own 16 keys of
//     every 64-key stage; a ring of three stages of K and V (18 KB each at
//     hd 64) is filled by cp.async, so two stages (36 KB) are in flight per
//     block while the third is used.  At hd 64 a block holds 54 KB of
//     shared memory and 96 registers a thread (nvcc -Xptxas -v), so four
//     blocks reside per SM, ~147 KB in flight; at hd 128 two.  Rows at
//     kv_len or later are zero-filled, never read, and a warp whose 16 keys
//     all lie past kv_len skips the tile;
//   - hd 256 (paligemma, G = 8 over one kv head; decode_attention_hd256_bulk)
//     holds a 192 KB ring, so one block resides per SM:
//       * warp roles: a producer warp only moves bytes: per 64-key tile,
//         eight TMA copies (tensor maps, 128-byte swizzle) of 64 rows x
//         64 columns of K and V into a ring of three stages, each with a
//         full mbarrier (armed with expect_tx for its 64 KB) and an empty
//         one (one arrival a consumer warp).  The maps, one per (pointer,
//         shape, strides), are encoded once and kept, and read any strides
//         cache_strides accepts;
//       * four consumer warps of mma.sync, with no load of k or v and no
//         block-wide barrier in the loop: each scores all 64 keys of a
//         tile (q k^T repeats in the four warps, bit for bit) and keeps 64
//         of the 256 output columns (acc 32 registers, q's fragments 64),
//         so the warps share m and l and need no merge: splitting the keys
//         instead, as the hd 64 / 128 body does, left four 16 x 256
//         accumulators to merge through shared memory, which cost ~11 us
//         a block on an H100;
//       * the rows past kv_len of a ragged tile hold whatever the cache
//         holds there: their scores are dropped by the select, and each
//         warp zeroes its V box's rows there (0 * NaN would be NaN in p v);
//   - at hd 64 and 128 rows are padded by 16 bytes in shared memory so the
//     eight rows of an ldmatrix fall in distinct banks (at hd 256 the
//     swizzle does that);
//   - the warps' (m, l, acc) are merged in a fixed order, and so are the
//     splits' (no float atomics: a repeated call is
//     bit-identical);
//   - float32 at hd 256 (paligemma's float32 serving;
//     decode_attention_hd256_f32) is bound by bytes too: a key costs
//     4 G hd flops against 2 hd 4 bytes, 4 flop/B at G = 8, a fifth of the
//     card's fp32 FMA rate at 3.35 TB/s, so its products stay fp32 FMAs on
//     the SIMT cores (no TF32), with the other bodies' split plan and
//     merge:
//       * a producer warp fills a ring of 32-key stages (three of 64 KB at
//         G <= 8, two at G 16) through the same cached tensor maps in
//         fp32 boxes of 32 columns x 32 keys (128 bytes a row, 128-byte
//         swizzle), full and empty mbarriers as in the bf16 body;
//       * four consumer warps split the columns, two boxes (64 columns)
//         each.  Lane = key: a warp's partial scores over its 64 columns
//         (the swizzle puts eight lanes' rows in distinct banks; q is
//         broadcast from shared memory) go to shared memory; after a
//         barrier of the consumers alone (bar.sync 1) every warp sums the
//         four partials in warp order, so all hold bit-identical scores,
//         m, l and p and the block merges no accumulators.  Lane = column:
//         acc += p v over the warp's two boxes, 2 G accumulators a lane.
//         Eight warps of one box each (twice the softmax and partial sums
//         a stage) were no faster on an H100, and two warps slower;
//       * the softmax's G rows take each shuffle step together, so a
//         stage waits on five shuffle latencies, not 5 x G;
//       * rows past kv_len in a ragged stage are dropped by the select and
//         zeroed in each warp's V box, as in the bf16 body;
//   - float32 at hd 64 and 128 keeps the SIMT body of the first port (one
//     key per lane, fp32 FMAs, two cp.async stages of 64 padded rows,
//     warps on split keys merged through shared memory); it takes the same
//     strides and the split plan.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched
                   // through cudaGetDriverEntryPoint (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;              // keys per stage, in both bodies
constexpr int kMaxRows = 16;           // query rows of the mma A operand
constexpr int kMmaWarps = 4;
constexpr int kMmaStages = 3;
constexpr int kSimtWarps = 2;
constexpr float kNegInf = (float)(-0.7 * 3.4028234663852886e38);

// 16 bytes into shared memory of which the first n (0..16) are read from
// gmem and the rest zero-filled (n = 0 reads nothing)
__device__ __forceinline__ void cp_async_n(void* smem, const void* gmem,
                                           int n) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
// the bytes of 16-byte chunk c of a row of `row_bytes`, for cp_async_n
__device__ __forceinline__ int chunk_bytes(int row_bytes, int c) {
  return min(max(row_bytes - c * 16, 0), 16);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned s) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              unsigned s) {
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
// ones empty).  split_span in decode_attention.py mirrors it.
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

// A block's place in the grid: blockIdx.x = (split * nch + chunk) * nslab
// + slab, so a split's group chunks and slabs are neighbours in the block
// order and read the same cache rows at about the same time (through L2).
// The block takes query heads g0 .. g0 + gc - 1 of its kv head's G (a
// chunk of at most `rows`: 16, or the rows body's 16 a warp) and, in the
// slab body, output columns 128 slab .. 128 slab + 127.
struct Place {
  int split, nsplit, chunk, slab, g0, gc;
};
__device__ __forceinline__ Place place(int G, int nch, int nslab,
                                       int rows = kMaxRows) {
  Place p;
  const int x = blockIdx.x;
  p.slab = x % nslab;
  p.chunk = (x / nslab) % nch;
  p.split = x / (nslab * nch);
  p.nsplit = gridDim.x / (nslab * nch);
  p.g0 = p.chunk * rows;
  p.gc = min(G - p.g0, rows);
  return p;
}
// A split's float32 scratch: acc (gc, D), then m (gc), then l (gc), one
// per (b, kv head, chunk, split) at a pitch of min(G, rows) (D + 2) floats
__device__ __forceinline__ float* part_of(float* part, long long bn,
                                          const Place& p, int G, int nch,
                                          int D, int rows = kMaxRows) {
  const long long pitch = (long long)min(G, rows) * (D + 2);
  return part + ((bn * nch + p.chunk) * p.nsplit + p.split) * pitch;
}

// columns col (even) and col + 1 of q's row `row` as the bf16 pair of an
// mma operand register, zero past hd (D) and at rows >= rows; one 4-byte
// load where D is even and q 4-byte aligned (`pairs`), so that a pair lies
// wholly inside or past the row
__device__ __forceinline__ unsigned q_pair(const bf16* qb, int row, int col,
                                           int rows, int D, bool pairs) {
  if (row >= rows) return 0u;
  if (pairs)
    return col < D ? *reinterpret_cast<const unsigned*>(
                         qb + (long long)row * D + col)
                   : 0u;
  const bf16 z = __float2bfloat16(0.f);
  const __nv_bfloat162 h = __halves2bfloat162(
      col < D ? qb[(long long)row * D + col] : z,
      col + 1 < D ? qb[(long long)row * D + col + 1] : z);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// Merge the warps' (m, l, acc) of one block (kWarps x kRows rows of HD
// columns staged in cm, cl, ca) and write the hd (D) columns of its gc rows
// of o (one split) or the split's part.
template <typename T, int HD, int kWarps, int kRows>
__device__ __forceinline__ void finish_block(const float* cm, const float* cl,
                                             const float* ca, T* ob,
                                             float* pb, int gc, int D,
                                             int nsplit, int tid,
                                             int nthreads) {
  for (int i = tid; i < gc * D; i += nthreads) {
    const int g = i / D;
    const int d = i - g * D;
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
        pb[gc * D + g] = mx;
        pb[gc * D + gc + g] = lt;
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
  static constexpr size_t kSmem = kRing;
  static_assert((size_t)kMmaWarps * kMaxRows * (HD + 2) * 4 <= kRing,
                "the warps' merge scratch must fit in the ring");
  static_assert(kSmem <= 232448, "dynamic shared memory above 227 KB");
};

// The lane's ldmatrix addresses in a stage of rows padded by 16 bytes:
// kd and vd at its row of K and V, a k-step (d-step) 32 bytes on.
struct PaddedRows {
  unsigned kd, vd;
  __device__ __forceinline__ unsigned k(int, int kk) const {
    return kd + kk * 32;
  }
  __device__ __forceinline__ unsigned v(int, int dp) const {
    return vd + dp * 32;
  }
};

// One warp's NK keys of a stage (key0 its first key) against NC columns
// of the output: the scores q k^T over the KD-deep head on the tensor
// cores, keys at hi or later NEG_INF (a select, so whatever their rows
// hold is dropped), the online softmax, acc += p v.  at.k(j, kk) gives the
// lane's ldmatrix address of k-step kk of key group j (16 keys) of K,
// at.v(j, dp) that of d-step dp (16 columns) of key group j of V.
template <int KD, int NK, int NC, typename Rows>
__device__ __forceinline__ void warp_tile(const Rows& at,
                                          const unsigned (&qa)[KD / 16][4],
                                          int key0, int hi, float scale,
                                          float (&m)[2], float (&l)[2],
                                          float (&acc)[NC / 8][4], int tq) {
  constexpr int KS = KD / 16;          // k-steps of q k^T
  constexpr int KG = NK / 16;          // key groups
  constexpr int NT = NC / 8;           // n-tiles of the accumulator
  // scores: two n-tiles of 8 keys a group
  float s[2 * KG][4];
#pragma unroll
  for (int j = 0; j < 2 * KG; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int j = 0; j < KG; ++j) {
      unsigned bk[4];
      ldsm_x4(bk, at.k(j, kk));
      mma_bf16(s[2 * j], qa[kk], bk[0], bk[1]);
      mma_bf16(s[2 * j + 1], qa[kk], bk[2], bk[3]);
    }
  // mask, scale, online softmax; rows gr (e = 0, 1) and gr + 8 (e = 2, 3)
#pragma unroll
  for (int j = 0; j < 2 * KG; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + j * 8 + 2 * tq + (e & 1);
      s[j][e] = key < hi ? s[j][e] * scale : kNegInf;
    }
  float mx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                    fmaxf(s[1][2 * h], s[1][2 * h + 1]));
#pragma unroll
    for (int j = 2; j < 2 * KG; ++j)
      x = fmaxf(x, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
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
  float p[2 * KG][4];
#pragma unroll
  for (int j = 0; j < 2 * KG; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[j][e] = expf(s[j][e] - mx[e >> 1]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < KG; ++j) {
      const float g = (p[2 * j][2 * h] + p[2 * j][2 * h + 1]) +
                      (p[2 * j + 1][2 * h] + p[2 * j + 1][2 * h + 1]);
      ps = j ? ps + g : g;
    }
    l[h] = l[h] * corr[h] + ps;
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    acc[t][0] *= corr[0];
    acc[t][1] *= corr[0];
    acc[t][2] *= corr[1];
    acc[t][3] *= corr[1];
  }
#pragma unroll
  for (int j = 0; j < KG; ++j) {
    // p (rounded to bf16) as the A operand: the score fragments of the
    // group's keys 0-7 and 8-15 are its k halves
    const unsigned pa[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                            pack_bf16(p[2 * j][2], p[2 * j][3]),
                            pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                            pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int dp = 0; dp < NC / 16; ++dp) {
      unsigned bv[4];
      ldsm_x4_trans(bv, at.v(j, dp));
      mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
      mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
    }
  }
}

// hd up to 64 and up to 128 (D <= HD columns of a body HD wide): grid
// (nsplit nch, KV, B), 128 threads.  part: part_of's scratch; unused when
// nsplit == 1.
template <int HD>
__global__ void __launch_bounds__(kMmaWarps * 32)
decode_attention_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const int* __restrict__ kv_len_p, bf16* __restrict__ o,
                     float* __restrict__ part, int KV, int G, int S, int D,
                     int nch, long long ksb, long long ksn, long long kss,
                     long long vsb, long long vsn, long long vss,
                     float scale) {
  using Geo = MmaGeo<HD>;
  constexpr int KS = HD / 16;          // k-steps of q k^T
  constexpr int NT = HD / 8;           // n-tiles of the accumulator
  constexpr int kThreads = kMmaWarps * 32;
  extern __shared__ __align__(16) unsigned char smem[];

  const Place pl = place(G, nch, 1);
  const int nsplit = pl.nsplit;
  const int gc = pl.gc;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;            // fragment row (and row + 8)
  const int tq = lane & 3;             // fragment column pair
  const long long bn = (long long)b * KV + n;
  const int kv_len = read_kv_len(kv_len_p, S);
  const Span sp = split_span(kv_len, nsplit, pl.split);
  bf16* ob = o + (bn * G + pl.g0) * D;
  if (sp.lo >= sp.hi) {
    if (nsplit == 1) write_zeros(ob, gc * D, tid, kThreads);
    return;
  }
  const unsigned char* kb =
      reinterpret_cast<const unsigned char*>(k + b * ksb + n * ksn);
  const unsigned char* vb =
      reinterpret_cast<const unsigned char*>(v + b * vsb + n * vsn);
  const long long krow = kss * 2, vrow = vss * 2;     // bytes per key
  const int n_tiles = (sp.hi - sp.lo + kTile - 1) / kTile;

  // q as the A operand of every k-step, rows >= gc and columns >= D zero,
  // in registers
  unsigned qa[KS][4];
  const bf16* qb = q + (bn * G + pl.g0) * D;
  const bool pairs = D % 2 == 0 && ((unsigned long long)qb & 3) == 0;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 16 + 2 * tq;
    qa[kk][0] = q_pair(qb, gr, c, gc, D, pairs);
    qa[kk][1] = q_pair(qb, gr + 8, c, gc, D, pairs);
    qa[kk][2] = q_pair(qb, gr, c + 8, gc, D, pairs);
    qa[kk][3] = q_pair(qb, gr + 8, c + 8, gc, D, pairs);
  }

  // a row's D columns; the chunks past them, and rows at hi or later,
  // zero-filled
  const int row_bytes = D * 2;
  auto load_tile = [&](int stage, int t0) {
    unsigned char* kd = smem + stage * 2 * Geo::kTileBytes;
    unsigned char* vd = kd + Geo::kTileBytes;
#pragma unroll
    for (int i = tid; i < kTile * Geo::kChunks; i += kThreads) {
      const int row = i / Geo::kChunks;
      const int c = i % Geo::kChunks;
      const int key = t0 + row;
      const int nb = key < sp.hi ? chunk_bytes(row_bytes, c) : 0;
      const long long j = nb ? key : sp.lo;
      const int off = nb ? c * 16 : 0;
      cp_async_n(kd + row * Geo::kRowBytes + c * 16, kb + j * krow + off, nb);
      cp_async_n(vd + row * Geo::kRowBytes + c * 16, vb + j * vrow + off, nb);
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
    const unsigned kd = (unsigned)__cvta_generic_to_shared(
        smem + (it % kMmaStages) * 2 * Geo::kTileBytes);
    warp_tile<HD, 16, HD>(
        PaddedRows{kd + k_off, kd + Geo::kTileBytes + v_off}, qa, key0,
        sp.hi, scale, m, l, acc, tq);
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
      cm, cl, ca, ob, part_of(part, bn, pl, G, nch, D), gc, D, nsplit, tid,
      kThreads);
}

// The ldmatrix addresses of a lane in a stage of rows padded by 16 bytes,
// for a warp that takes all 64 keys: key group j (16 keys) is 16 rows on.
struct PaddedTile {
  unsigned kd, vd;
  __device__ __forceinline__ unsigned k(int j, int kk) const {
    return kd + j * 16 * kRowStride + kk * 32;
  }
  __device__ __forceinline__ unsigned v(int j, int dp) const {
    return vd + j * 16 * kRowStride + dp * 32;
  }
  unsigned kRowStride;
};

// bf16 at hd up to 64 and up to 128 with G > 16 query heads a kv head:
// grid (nsplit nch, KV, B), NW warps, each owning 16 query rows (a chunk of
// 16 NW rows a block) over all 64 keys of every stage, so a block reads
// each cache row once for its 16 NW query heads (decode_attention_mma
// splits the keys of a stage over its warps instead, for G <= 16).  No
// state crosses warps: each writes its rows' o, or their (acc, m, l) to
// part_of's scratch, itself.  The ring, its loads and the arithmetic are
// decode_attention_mma's.
template <int HD, int NW>
__global__ void __launch_bounds__(NW * 32)
decode_attention_mma_rows(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const int* __restrict__ kv_len_p,
                          bf16* __restrict__ o, float* __restrict__ part,
                          int KV, int G, int S, int D, int nch, long long ksb,
                          long long ksn, long long kss, long long vsb,
                          long long vsn, long long vss, float scale) {
  using Geo = MmaGeo<HD>;
  constexpr int KS = HD / 16;          // k-steps of q k^T
  constexpr int NT = HD / 8;           // n-tiles of the accumulator
  constexpr int kThreads = NW * 32;
  constexpr int kRows = NW * 16;       // query rows a block
  extern __shared__ __align__(16) unsigned char smem[];

  const Place pl = place(G, nch, 1, kRows);
  const int nsplit = pl.nsplit;
  const int gc = pl.gc;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;            // fragment row (and row + 8)
  const int tq = lane & 3;             // fragment column pair
  const long long bn = (long long)b * KV + n;
  const int kv_len = read_kv_len(kv_len_p, S);
  const Span sp = split_span(kv_len, nsplit, pl.split);
  bf16* ob = o + (bn * G + pl.g0) * D;
  if (sp.lo >= sp.hi) {
    if (nsplit == 1) write_zeros(ob, gc * D, tid, kThreads);
    return;
  }
  const unsigned char* kb =
      reinterpret_cast<const unsigned char*>(k + b * ksb + n * ksn);
  const unsigned char* vb =
      reinterpret_cast<const unsigned char*>(v + b * vsb + n * vsn);
  const long long krow = kss * 2, vrow = vss * 2;     // bytes per key
  const int n_tiles = (sp.hi - sp.lo + kTile - 1) / kTile;
  const int r0 = w * 16;               // the warp's first row in the chunk
  const bool busy = r0 < gc;           // warp-uniform: rows of its own

  // the warp's q rows as the A operand of every k-step, rows >= gc and
  // columns >= D zero, in registers
  unsigned qa[KS][4];
  const bf16* qb = q + (bn * G + pl.g0) * D;
  const bool pairs = D % 2 == 0 && ((unsigned long long)qb & 3) == 0;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 16 + 2 * tq;
    qa[kk][0] = q_pair(qb, r0 + gr, c, gc, D, pairs);
    qa[kk][1] = q_pair(qb, r0 + gr + 8, c, gc, D, pairs);
    qa[kk][2] = q_pair(qb, r0 + gr, c + 8, gc, D, pairs);
    qa[kk][3] = q_pair(qb, r0 + gr + 8, c + 8, gc, D, pairs);
  }

  const int row_bytes = D * 2;
  auto load_tile = [&](int stage, int t0) {
    unsigned char* kd = smem + stage * 2 * Geo::kTileBytes;
    unsigned char* vd = kd + Geo::kTileBytes;
    for (int i = tid; i < kTile * Geo::kChunks; i += kThreads) {
      const int row = i / Geo::kChunks;
      const int c = i % Geo::kChunks;
      const int key = t0 + row;
      const int nb = key < sp.hi ? chunk_bytes(row_bytes, c) : 0;
      const long long j = nb ? key : sp.lo;
      const int off = nb ? c * 16 : 0;
      cp_async_n(kd + row * Geo::kRowBytes + c * 16, kb + j * krow + off, nb);
      cp_async_n(vd + row * Geo::kRowBytes + c * 16, vb + j * vrow + off, nb);
    }
  };

#pragma unroll
  for (int st = 0; st < kMmaStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, sp.lo + st * kTile);
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
  const int k_off = ((mi >> 1) * 8 + r8) * Geo::kRowBytes + (mi & 1) * 16;
  const int v_off = ((mi & 1) * 8 + r8) * Geo::kRowBytes + (mi >> 1) * 16;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kMmaStages - 2>();   // tile it has landed (this thread)
    __syncthreads();                   // ... for all; tile it - 1 is used
    {
      const int nt = it + kMmaStages - 1;
      if (nt < n_tiles) load_tile(nt % kMmaStages, sp.lo + nt * kTile);
      cp_async_commit();
    }
    if (!busy) continue;
    const unsigned kd = (unsigned)__cvta_generic_to_shared(
        smem + (it % kMmaStages) * 2 * Geo::kTileBytes);
    warp_tile<HD, kTile, HD>(
        PaddedTile{kd + k_off, kd + Geo::kTileBytes + v_off,
                   (unsigned)Geo::kRowBytes},
        qa, sp.lo + it * kTile, sp.hi, scale, m, l, acc, tq);
  }
  cp_async_wait<0>();
  if (!busy) return;

  // the warp's rows: l over the row's four lanes, then o or the split's
  // part
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  float* pb = part_of(part, bn, pl, G, nch, D, kRows);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + gr + 8 * h;
    if (row >= gc) continue;
    const float d = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = t * 8 + 2 * tq + e;
        if (col >= D) continue;
        if (nsplit == 1)
          ob[row * D + col] = __float2bfloat16(acc[t][2 * h + e] / d);
        else
          pb[row * D + col] = acc[t][2 * h + e];
      }
    }
    if (nsplit > 1 && tq == 0) {
      pb[gc * D + row] = m[h];
      pb[gc * D + gc + row] = l[h];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 at hd 256: a producer warp and a TMA ring
// ---------------------------------------------------------------------------

namespace bulk {

constexpr int kHD = 256;
constexpr int kConsumers = 4;                      // math warps
constexpr int kThreads = (kConsumers + 1) * 32;    // and the producer warp
constexpr int kStages = 3;                         // 64-key tiles
constexpr int kBoxCols = 64;                       // 128 bytes of bf16
constexpr int kBoxes = kHD / kBoxCols;             // boxes across a row
constexpr int kCols = kHD / kConsumers;            // a warp's columns: a box
constexpr uint32_t kBoxBytes = kTile * kBoxCols * 2;     // 8 KB
constexpr uint32_t kTileBytes = kBoxes * kBoxBytes;      // K or V: 32 KB
constexpr uint32_t kStageBytes = 2 * kTileBytes;         // K, then V
constexpr uint32_t kBarOff = kStages * kStageBytes;
// mbarriers at kBarOff: full[kStages], empty[kStages]; 1024 more for the
// base's alignment (the 128-byte swizzle's atom)
constexpr size_t kSmem = 1024 + kBarOff + 2 * kStages * 8;
static_assert(kCols == kBoxCols, "a consumer warp's columns are one box");
static_assert(kSmem <= 232448, "dynamic shared memory above 227 KB");

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
// the box of `map` at (c0, c1, c2, c3) into shared memory at dst,
// completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// The lane's ldmatrix addresses in a stage of the ring: K and V of 64 keys
// as four boxes of (64 rows x 128 bytes) each, 16-byte chunk c of row r at
// chunk c ^ (r % 8) (TMA's 128-byte swizzle), so the eight rows of an
// ldmatrix fall in distinct banks.  kd: the lane's row of key group 0 in
// K's box 0, vd: in V's box of the warp's columns; kc, vc: the lane's
// chunk bit xor'd with its row.
struct SwizzledRows {
  uint32_t kd, vd, kc, vc;
  __device__ __forceinline__ uint32_t k(int j, int kk) const {
    return kd + (kk >> 2) * kBoxBytes + j * 16 * (kBoxCols * 2) +
           ((((kk & 3) << 1) ^ kc) << 4);
  }
  __device__ __forceinline__ uint32_t v(int j, int dp) const {
    return vd + j * 16 * (kBoxCols * 2) + (((dp << 1) ^ vc) << 4);
  }
};

}  // namespace bulk

// grid (nsplit nch, KV, B), 160 threads, one block an SM: the keys of
// split_span, as decode_attention_mma takes them.  mk, mv: k and v as 4-D
// tensor maps (the hd (D <= 256) columns, then the key, kv head and batch
// dims in the order of their strides; slots_k and slots_v hold the
// coordinate slot of each, 2 bits apiece); a box's columns past D arrive
// zero.  part: part_of's scratch; unused when nsplit == 1.  FULL: D = 256,
// one chunk (G <= 16) and q 4-byte aligned, known at compile time, so the
// full-width shapes pay nothing for the general ones.
template <bool FULL>
__global__ void __launch_bounds__(bulk::kThreads, 1)
decode_attention_hd256_bulk(const __grid_constant__ CUtensorMap mk,
                            const __grid_constant__ CUtensorMap mv,
                            const bf16* __restrict__ q,
                            const int* __restrict__ kv_len_p,
                            bf16* __restrict__ o, float* __restrict__ part,
                            int KV, int G, int S, int D, int nch, int slots_k,
                            int slots_v, float scale) {
  using namespace bulk;
  constexpr int KS = kHD / 16;
  constexpr int NT = kCols / 8;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if constexpr (FULL) {
    D = kHD;
    nch = 1;
  }

  const Place pl = place(G, nch, 1);
  const int nsplit = pl.nsplit;
  const int gc = pl.gc;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const long long bn = (long long)b * KV + n;
  const int kv_len = read_kv_len(kv_len_p, S);
  const Span sp = split_span(kv_len, nsplit, pl.split);
  bf16* ob = o + (bn * G + pl.g0) * D;
  if (sp.lo >= sp.hi) {
    if (nsplit == 1) write_zeros(ob, gc * D, tid, kThreads);
    return;
  }
  const int n_tiles = (sp.hi - sp.lo + kTile - 1) / kTile;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full = base + kBarOff, empty = full + 8 * kStages;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);    // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (w == kConsumers) {
    // ---- producer: each tile's four boxes of K and four of V (lanes 0-7,
    // one box each)
    if (lane < 2) {
      const CUtensorMap* map = lane ? &mv : &mk;
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(map))
                   : "memory");
    }
    const int slots = lane < kBoxes ? slots_k : slots_v;
    const int s_key = slots & 3, s_n = (slots >> 2) & 3;
    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it % kStages;
      const uint32_t bar = full + 8 * stage;
      mbar_wait(empty + 8 * stage, ((it / kStages) & 1) ^ 1);
      if (lane == 0) mbar_expect_tx(bar, kStageBytes);
      __syncwarp();
      if (lane < 2 * kBoxes) {
        const int key = sp.lo + it * kTile;
        int c[3];                      // slots 1-3: key, kv head, batch
#pragma unroll
        for (int i = 0; i < 3; ++i)
          c[i] = s_key == i + 1 ? key : s_n == i + 1 ? n : b;
        tma_load(base + stage * kStageBytes + lane * kBoxBytes,
                 lane < kBoxes ? &mk : &mv, bar, (lane & 3) * kBoxCols, c[0],
                 c[1], c[2]);
      }
    }
    return;
  }

  // ---- consumers: warp w scores every key of each tile and keeps output
  // columns 64 w .. 64 w + 63 (V's box w).  The q k^T products repeat in
  // the four warps and so agree bit for bit, m and l with them: the warps
  // need no merge.
  const int gr = lane >> 2;            // fragment row (and row + 8)
  const int tq = lane & 3;             // fragment column pair
  const int mi = lane >> 3;            // ldmatrix: lane -> row r8 of matrix mi
  const int r8 = lane & 7;
  const uint32_t k_row = ((mi >> 1) * 8 + r8) * (kBoxCols * 2);
  const uint32_t v_row = ((mi & 1) * 8 + r8) * (kBoxCols * 2);
  // q as the A operand of every k-step, rows >= gc and columns >= D zero,
  // in registers
  unsigned qa[KS][4];
  {
    const bf16* qb = q + (bn * G + pl.g0) * D;
    const bool pairs =
        FULL || (D % 2 == 0 && ((unsigned long long)qb & 3) == 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = kk * 16 + 2 * tq;
      qa[kk][0] = q_pair(qb, gr, c, gc, D, pairs);
      qa[kk][1] = q_pair(qb, gr + 8, c, gc, D, pairs);
      qa[kk][2] = q_pair(qb, gr, c + 8, gc, D, pairs);
      qa[kk][3] = q_pair(qb, gr + 8, c + 8, gc, D, pairs);
    }
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    const int key0 = sp.lo + it * kTile;
    mbar_wait(full + 8 * stage, (it / kStages) & 1);
    const uint32_t kd = base + stage * kStageBytes;
    const uint32_t vd = kd + kTileBytes + w * kBoxBytes;
    const int n0 = sp.hi - key0;       // rows of the tile below hi
    if (n0 < kTile) {
      // the rows at hi or later hold whatever the cache holds there: the
      // warp's V rows are zeroed (p is 0 there, 0 * NaN is not), K's
      // scores dropped
      for (int i = lane; i < (kTile - n0) * 8; i += 32)
        *reinterpret_cast<uint4*>(smem + (vd - base) +
                                  (n0 + i / 8) * (kBoxCols * 2) +
                                  (i % 8) * 16) = make_uint4(0, 0, 0, 0);
      __syncwarp();
    }
    warp_tile<kHD, kTile, kCols>(
        SwizzledRows{kd + k_row, vd + v_row, (uint32_t)((mi & 1) ^ r8),
                     (uint32_t)((mi >> 1) ^ r8)},
        qa, key0, sp.hi, scale, m, l, acc, tq);
    // the zeros precede the ring's next TMA write of these rows
    if (n0 < kTile)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * stage);
  }

  // the split's (m, l, acc): l over the row's four lanes, then o or the
  // split's part, each warp its columns
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  float* pb = part_of(part, bn, pl, G, nch, D);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = gr + 8 * h;
    if (row >= gc) continue;
    const float d = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int col = w * kCols + t * 8 + 2 * tq;
      if (col + 1 < D && D % 2 == 0) {     // a pair, 4- or 8-byte aligned
        if (nsplit == 1)
          *reinterpret_cast<unsigned*>(ob + row * D + col) =
              pack_bf16(acc[t][2 * h] / d, acc[t][2 * h + 1] / d);
        else
          *reinterpret_cast<float2*>(pb + row * D + col) =
              make_float2(acc[t][2 * h], acc[t][2 * h + 1]);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (col + e >= D) continue;
        if (nsplit == 1)
          ob[row * D + col + e] = __float2bfloat16(acc[t][2 * h + e] / d);
        else
          pb[row * D + col + e] = acc[t][2 * h + e];
      }
    }
    if (nsplit > 1 && w == 0 && tq == 0) {
      pb[gc * D + row] = m[h];
      pb[gc * D + gc + row] = l[h];
    }
  }
}

// ---------------------------------------------------------------------------
// float32 at hd 256: a producer warp's TMA ring, column-split SIMT consumers
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kHD = 256;
constexpr int kKeys = 32;                          // keys a stage, one a lane
constexpr int kConsumers = 4;                      // math warps
constexpr int kThreads = (kConsumers + 1) * 32;    // and the producer warp
constexpr int kBoxCols = 32;                       // 128 bytes of fp32
constexpr int kBoxes = kHD / kBoxCols;             // boxes across a row
constexpr int kWarpBoxes = kBoxes / kConsumers;    // a warp's columns
constexpr uint32_t kBoxBytes = kKeys * kBoxCols * 4;     // 4 KB
constexpr uint32_t kTileBytes = kBoxes * kBoxBytes;      // K or V: 32 KB
constexpr uint32_t kStageBytes = 2 * kTileBytes;         // K, then V
static_assert(kBoxes % kConsumers == 0, "whole boxes a consumer warp");
static_assert(kTile % kKeys == 0, "a split's tiles are whole stages");

// Shared memory at GB query rows: the ring, q (GB x 256), the warps'
// partial scores (two buffers of kConsumers x GB x 32), each warp's
// probabilities (kConsumers x GB x 32), then the mbarriers full[kStages]
// and empty[kStages]; 1024 more for the base's alignment.  Three stages
// where they fit in 227 KB, else two (GB 16).
template <int GB>
struct Geo {
  static constexpr uint32_t kQBytes = GB * kHD * 4;
  static constexpr uint32_t kPartBytes = 2 * kConsumers * GB * kKeys * 4;
  static constexpr uint32_t kPBytes = kConsumers * GB * kKeys * 4;
  static constexpr uint32_t kExtra = kQBytes + kPartBytes + kPBytes;
  static constexpr int kStages =
      1024 + 3 * kStageBytes + kExtra + 6 * 8 <= 232448 ? 3 : 2;
  static constexpr uint32_t kQOff = kStages * kStageBytes;
  static constexpr uint32_t kPartOff = kQOff + kQBytes;
  static constexpr uint32_t kPOff = kPartOff + kPartBytes;
  static constexpr uint32_t kBarOff = kPOff + kPBytes;
  static constexpr size_t kSmem = 1024 + kBarOff + 2 * kStages * 8;
  static_assert(kSmem <= 232448, "dynamic shared memory above 227 KB");
};

// the consumer warps' own barrier (the producer is not in it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers * 32) : "memory");
}

}  // namespace f32

// grid (nsplit nch, KV, B), 160 threads, one block an SM: the keys of
// split_span, in stages of 32.  mk, mv: k and v as 4-D tensor maps, as
// decode_attention_hd256_bulk takes them, in boxes of 32 columns x 32
// keys.  part: part_of's scratch; unused when nsplit == 1.  FULL: D = 256
// and one chunk, known at compile time, as decode_attention_hd256_bulk's.
template <int GB, bool FULL>
__global__ void __launch_bounds__(f32::kThreads, 1)
decode_attention_hd256_f32(const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const float* __restrict__ q,
                           const int* __restrict__ kv_len_p,
                           float* __restrict__ o, float* __restrict__ part,
                           int KV, int G, int S, int D, int nch, int slots_k,
                           int slots_v, float scale) {
  using namespace f32;
  using G_ = Geo<GB>;
  constexpr int NB = kWarpBoxes;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if constexpr (FULL) {
    D = kHD;
    nch = 1;
  }

  const Place pl = place(G, nch, 1);
  const int nsplit = pl.nsplit;
  const int gc = pl.gc;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const long long bn = (long long)b * KV + n;
  const int kv_len = read_kv_len(kv_len_p, S);
  const Span sp = split_span(kv_len, nsplit, pl.split);
  float* ob = o + (bn * G + pl.g0) * D;
  if (sp.lo >= sp.hi) {
    if (nsplit == 1) write_zeros(ob, gc * D, tid, kThreads);
    return;
  }
  const int n_stages = (sp.hi - sp.lo + kKeys - 1) / kKeys;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const uint32_t base = (bulk::smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - bulk::smem_u32(smem_raw));
  float* qs = reinterpret_cast<float*>(smem + G_::kQOff);
  float* parts = reinterpret_cast<float*>(smem + G_::kPartOff);
  const uint32_t full = base + G_::kBarOff;
  const uint32_t empty = full + 8 * G_::kStages;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < G_::kStages; ++s) {
      bulk::mbar_init(full + 8 * s, 1);
      bulk::mbar_init(empty + 8 * s, kConsumers);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (w == kConsumers) {
    // ---- producer: each stage's eight boxes of K and eight of V (lanes
    // 0-15, one box each)
    if (lane < 2) {
      const CUtensorMap* map = lane ? &mv : &mk;
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(map))
                   : "memory");
    }
    const int slots = lane < kBoxes ? slots_k : slots_v;
    const int s_key = slots & 3, s_n = (slots >> 2) & 3;
    for (int it = 0; it < n_stages; ++it) {
      const int stage = it % G_::kStages;
      const uint32_t bar = full + 8 * stage;
      bulk::mbar_wait(empty + 8 * stage, ((it / G_::kStages) & 1) ^ 1);
      if (lane == 0) bulk::mbar_expect_tx(bar, kStageBytes);
      __syncwarp();
      if (lane < 2 * kBoxes) {
        const int key = sp.lo + it * kKeys;
        int c[3];                      // slots 1-3: key, kv head, batch
#pragma unroll
        for (int i = 0; i < 3; ++i)
          c[i] = s_key == i + 1 ? key : s_n == i + 1 ? n : b;
        bulk::tma_load(base + stage * kStageBytes + lane * kBoxBytes,
                       lane < kBoxes ? &mk : &mv, bar,
                       (lane % kBoxes) * kBoxCols, c[0], c[1], c[2]);
      }
    }
    return;
  }

  // ---- consumers: warp w owns K's and V's boxes NB w .. NB w + NB - 1.
  // Lane = key: the partial scores over the warp's columns; the warps'
  // partials summed in warp order give every warp the same scores, so all
  // hold the same m, l and p and need no merge.  Lane = column: acc += p v
  // over the warp's columns.
  // q into shared memory (rows gc .. GB - 1 and columns D .. 255 zero)
  // while the first stages are in flight
  const float* qb = q + (bn * G + pl.g0) * D;
#pragma unroll 4
  for (int i = tid; i < GB * kHD; i += kConsumers * 32) {
    const int g = i / kHD, d = i % kHD;
    qs[i] = g < gc && d < D ? qb[g * D + d] : 0.f;
  }
  consumers_sync();
  float* pw = reinterpret_cast<float*>(smem + G_::kPOff) + w * GB * kKeys;
  const int sw = lane & 7;             // the swizzle of the lane's K row
  const uint32_t v_col = (uint32_t)((lane & 3) << 2);
  float m[GB], l[GB], acc[GB][NB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) acc[g][bb] = 0.f;
  }
  for (int it = 0; it < n_stages; ++it) {
    const int stage = it % G_::kStages;
    const int nv = min(kKeys, sp.hi - sp.lo - it * kKeys);   // >= 1
    bulk::mbar_wait(full + 8 * stage, (it / G_::kStages) & 1);
    const unsigned char* kd = smem + stage * kStageBytes + w * NB * kBoxBytes;
    unsigned char* vd = smem + stage * kStageBytes + kTileBytes +
                        w * NB * kBoxBytes;
    if (nv < kKeys) {
      // the rows past hi hold whatever the cache holds there: the warp's
      // V rows are zeroed (p is 0 there, 0 * NaN is not), K's scores
      // dropped
#pragma unroll
      for (int bb = 0; bb < NB; ++bb)
        for (int i = lane; i < (kKeys - nv) * 8; i += 32)
          *reinterpret_cast<uint4*>(vd + bb * kBoxBytes +
                                    (nv + i / 8) * (kBoxCols * 4) +
                                    (i % 8) * 16) = make_uint4(0, 0, 0, 0);
    }
    // partial scores: 16-byte chunk j of row r at chunk j ^ (r % 8) (TMA's
    // 128-byte swizzle), so eight lanes' rows fall in distinct banks
    float s[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) s[g] = 0.f;
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) {
      const unsigned char* row = kd + bb * kBoxBytes + lane * (kBoxCols * 4);
      const float* qc = qs + (w * NB + bb) * kBoxCols;
#pragma unroll
      for (int j = 0; j < kBoxCols / 4; ++j) {
        const float4 kf = *reinterpret_cast<const float4*>(row +
                                                           ((j ^ sw) << 4));
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qc + g * kHD + j * 4);
          s[g] = fmaf(qv.x, kf.x, s[g]);
          s[g] = fmaf(qv.y, kf.y, s[g]);
          s[g] = fmaf(qv.z, kf.z, s[g]);
          s[g] = fmaf(qv.w, kf.w, s[g]);
        }
      }
    }
    float* pp = parts + (it & 1) * kConsumers * GB * kKeys;
#pragma unroll
    for (int g = 0; g < GB; ++g) pp[(w * GB + g) * kKeys + lane] = s[g];
    // the other buffer was read before this barrier's previous phase, so
    // one barrier a stage orders both
    consumers_sync();
    // the online softmax, the G rows' shuffles interleaved (each row's
    // max and sum reduce in warp_max's and warp_sum's order)
    const bool valid = lane < nv;
    float sc[GB], red[GB], corr[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float x = pp[g * kKeys + lane];
#pragma unroll
      for (int ww = 1; ww < kConsumers; ++ww)
        x += pp[(ww * GB + g) * kKeys + lane];
      sc[g] = valid ? x * scale : kNegInf;
      red[g] = sc[g];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int g = 0; g < GB; ++g)
        red[g] = fmaxf(red[g], __shfl_xor_sync(0xffffffffu, red[g], o));
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float mx = fmaxf(m[g], red[g]);
      corr[g] = expf(m[g] - mx);
      const float p = expf(sc[g] - mx);
      m[g] = mx;
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) acc[g][bb] *= corr[g];
      pw[g * kKeys + lane] = p;
      red[g] = p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int g = 0; g < GB; ++g)
        red[g] += __shfl_xor_sync(0xffffffffu, red[g], o);
#pragma unroll
    for (int g = 0; g < GB; ++g) l[g] = l[g] * corr[g] + red[g];
    __syncwarp();
    // acc += p v, lane = column, the stage's keys in order
#pragma unroll
    for (int j = 0; j < kKeys; j += 4) {
      float vv[4][NB];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int bb = 0; bb < NB; ++bb)
          vv[jj][bb] = *reinterpret_cast<const float*>(
              vd + bb * kBoxBytes + (j + jj) * (kBoxCols * 4) +
              ((((uint32_t)(lane >> 2) ^ ((j + jj) & 7)) << 4) | v_col));
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + g * kKeys + j);
        const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int bb = 0; bb < NB; ++bb)
            acc[g][bb] = fmaf(pj[jj], vv[jj][bb], acc[g][bb]);
      }
    }
    // the zeros precede the ring's next TMA write of these rows
    if (nv < kKeys)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) bulk::mbar_arrive(empty + 8 * stage);
  }

  // the split's (m, l, acc), each warp its columns: o, or the split's part
  float* pb = part_of(part, bn, pl, G, nch, D);
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g >= gc) break;
    const float d = fmaxf(l[g], 1e-30f);
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) {
      const int col = (w * NB + bb) * kBoxCols + lane;
      if (col >= D) continue;
      if (nsplit == 1)
        ob[g * D + col] = acc[g][bb] / d;
      else
        pb[g * D + col] = acc[g][bb];
    }
    if (nsplit > 1 && w == 0 && lane == 0) {
      pb[gc * D + g] = m[g];
      pb[gc * D + gc + g] = l[g];
    }
  }
}

// ---------------------------------------------------------------------------
// float32 at hd 64 and 128: SIMT body (one key per lane)
// ---------------------------------------------------------------------------

template <int HD>
struct SimtGeo {
  static constexpr int kRowBytes = HD * 4 + 16;   // padded row
  static constexpr int kTileBytes = kTile * kRowBytes;
  static constexpr int kChunks = HD * 4 / 16;
  static constexpr int kStages = 2;               // K and V per stage
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
                      int KV, int G, int S, int D, int nch, long long ksb,
                      long long ksn, long long kss, long long vsb,
                      long long vsn, long long vss, float scale) {
  using Geo = SimtGeo<HD>;
  constexpr int NC = HD / 32;                   // accumulator columns/lane
  constexpr int kThreads = kSimtWarps * 32;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // GB x HD
  float* ps = qs + GB * HD;                     // kSimtWarps x GB x 32
  char* kvbuf = reinterpret_cast<char*>(ps + kSimtWarps * GB * 32);

  const Place pl = place(G, nch, 1);
  const int nsplit = pl.nsplit;
  const int gc = pl.gc;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const long long bn = (long long)b * KV + n;
  const int kv_len = read_kv_len(kv_len_p, S);
  const Span sp = split_span(kv_len, nsplit, pl.split);
  float* ob = o + (bn * G + pl.g0) * D;
  if (sp.lo >= sp.hi) {
    if (nsplit == 1) write_zeros(ob, gc * D, tid, kThreads);
    return;
  }
  const float* qb = q + (bn * G + pl.g0) * D;
  const float* kb = k + b * ksb + n * ksn;
  const float* vb = v + b * vsb + n * vsn;
  const int lo = sp.lo, hi = sp.hi;
  const int n_tiles = (hi - lo + kTile - 1) / kTile;

  for (int i = tid; i < GB * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    qs[i] = g < gc && d < D ? qb[g * D + d] : 0.f;
  }

  // a row's D columns; the chunks past them, and rows at hi or later,
  // zero-filled
  const int row_bytes = D * 4;
  auto load_tile = [&](int stage, int t0) {
    char* kd = kvbuf + stage * 2 * Geo::kTileBytes;
    char* vd = kd + Geo::kTileBytes;
    for (int i = tid; i < kTile * Geo::kChunks; i += kThreads) {
      const int row = i / Geo::kChunks;
      const int c = i - row * Geo::kChunks;
      const int key = t0 + row;
      const int nb = key < hi ? chunk_bytes(row_bytes, c) : 0;
      const long long j = nb ? key : lo;
      const int off = nb ? c * 4 : 0;
      cp_async_n(kd + row * Geo::kRowBytes + c * 16, kb + j * kss + off, nb);
      cp_async_n(vd + row * Geo::kRowBytes + c * 16, vb + j * vss + off, nb);
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
      cm, cl, ca, ob, part_of(part, bn, pl, G, nch, D), gc, D, nsplit, tid,
      kThreads);
}

// ---------------------------------------------------------------------------
// any hd, rows of any alignment: the slab body
// ---------------------------------------------------------------------------

namespace slab {

constexpr int kKeys = 32;                  // keys a stage, one a lane
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 128;                 // columns of a score chunk, of a slab
constexpr int kWarpCols = kCols / kWarps;  // a warp's columns of either

// Shared memory at GB query rows: two buffers of 32 rows of 128 columns of
// T (K's chunk or V's slab; rows padded by 16 bytes, so the rows a
// lane = key read start in distinct banks), two of q's chunk widened to
// float (GB x 128), the warps' partial scores (kWarps x GB x 32) and each
// warp's probabilities (kWarps x GB x 32)
template <typename T, int GB>
struct Geo {
  static constexpr int kPitch = kCols + 16 / (int)sizeof(T);   // elements
  static constexpr int kBufBytes = kKeys * kPitch * (int)sizeof(T);
  static constexpr int kQOff = 2 * kBufBytes;
  static constexpr int kPartOff = kQOff + 2 * GB * kCols * 4;
  static constexpr int kPOff = kPartOff + kWarps * GB * kKeys * 4;
  static constexpr size_t kSmem = (size_t)kPOff + kWarps * GB * kKeys * 4;
  static_assert(kSmem <= 232448, "dynamic shared memory above 227 KB");
};

// four consecutive values of a row in shared memory -> floats
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&x)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(a.x << 16);
  x[1] = __uint_as_float(a.x & 0xffff0000u);
  x[2] = __uint_as_float(a.y << 16);
  x[3] = __uint_as_float(a.y & 0xffff0000u);
}

}  // namespace slab

// grid (nsplit nch nslab, KV, B), 128 threads: the keys of split_span in
// stages of 32, each stage one item per 128-column chunk of K (with q's
// chunk), then one of V's slab (the block's 128 columns of o), copied into
// a two-buffer ring.  Lane = key: each warp's partial scores over its 32
// columns of each chunk, chunk by chunk; after the stage's last chunk the
// warps' partials are summed in warp order, so every warp, and every slab
// of the row, holds the same scores, m and l.  Lane = column: acc += p v
// over the warp's 32 columns of the slab, key by key.  bf16: the
// products in fp32 on the SIMT cores, p rounded to bf16 before p v as the
// other bodies round it.  VEC: rows 16-byte aligned, copied by cp.async
// with columns past hd and rows at hi or later zero-filled; else element
// by element.  part: part_of's scratch (m and l from slab 0); unused when
// nsplit == 1.
template <typename T, int GB, bool VEC>
__global__ void __launch_bounds__(slab::kThreads)
decode_attention_slab(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const int* __restrict__ kv_len_p, T* __restrict__ o,
                      float* __restrict__ part, int KV, int G, int S, int D,
                      int nch, int nslab, long long ksb, long long ksn,
                      long long kss, long long vsb, long long vsn,
                      long long vss, float scale) {
  using namespace slab;
  using Ge = Geo<T, GB>;
  extern __shared__ __align__(16) unsigned char smem[];

  const Place pl = place(G, nch, nslab);
  const int nsplit = pl.nsplit;
  const int gc = pl.gc;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const long long bn = (long long)b * KV + n;
  const int kv_len = read_kv_len(kv_len_p, S);
  const Span sp = split_span(kv_len, nsplit, pl.split);
  T* ob = o + (bn * G + pl.g0) * D;
  if (sp.lo >= sp.hi) {
    if (nsplit == 1 && pl.slab == 0) write_zeros(ob, gc * D, tid, kThreads);
    return;
  }
  const T* qb = q + (bn * G + pl.g0) * D;
  const T* kb = k + b * ksb + n * ksn;
  const T* vb = v + b * vsb + n * vsn;
  const int n_kc = (D + kCols - 1) / kCols;     // score chunks
  const int per = n_kc + 1;                     // items a stage
  const int n_stages = (sp.hi - sp.lo + kKeys - 1) / kKeys;
  const int n_items = n_stages * per;
  const int col_v = pl.slab * kCols;            // the slab's first column
  float* qs = reinterpret_cast<float*>(smem + Ge::kQOff);
  float* parts = reinterpret_cast<float*>(smem + Ge::kPartOff);
  float* pw = reinterpret_cast<float*>(smem + Ge::kPOff) + w * GB * kKeys;

  // item i into buffer i & 1: rows key0 .. key0 + 31 of K's chunk or V's
  // slab (columns past hd and rows at hi or later zero); a chunk of K
  // brings q's chunk too, widened to float (rows past gc zero)
  auto issue = [&](int i) {
    const int it = i / per, j = i % per;
    const int key0 = sp.lo + it * kKeys;
    const bool is_v = j == n_kc;
    const int c0 = is_v ? col_v : j * kCols;
    const int cols = min(kCols, D - c0);        // >= 1
    const T* src = is_v ? vb : kb;
    const long long ss = is_v ? vss : kss;
    T* dst = reinterpret_cast<T*>(smem + (i & 1) * Ge::kBufBytes);
    if constexpr (VEC) {
      constexpr int kE = 16 / (int)sizeof(T);   // elements a copy
      constexpr int kChunks = kCols / kE;
      for (int x = tid; x < kKeys * kChunks; x += kThreads) {
        const int r = x / kChunks, c = x % kChunks;
        const int key = key0 + r;
        const int nb =
            key < sp.hi ? chunk_bytes(cols * (int)sizeof(T), c) : 0;
        cp_async_n(dst + r * Ge::kPitch + c * kE,
                   nb ? src + key * ss + c0 + c * kE : src, nb);
      }
    } else {
      for (int x = tid; x < kKeys * kCols; x += kThreads) {
        const int r = x / kCols, c = x % kCols;
        const int key = key0 + r;
        dst[r * Ge::kPitch + c] = key < sp.hi && c < cols
                                      ? src[key * ss + c0 + c]
                                      : from_f<T>(0.f);
      }
    }
    if (!is_v) {
      float* qd = qs + (i & 1) * GB * kCols;
      for (int x = tid; x < GB * kCols; x += kThreads) {
        const int g = x / kCols, c = x % kCols;
        qd[x] = g < gc && c < cols ? to_f(qb[(long long)g * D + c0 + c])
                                   : 0.f;
      }
    }
  };

  float s[GB], m[GB], l[GB], acc[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    s[g] = 0.f;
    m[g] = kNegInf;
    l[g] = 0.f;
    acc[g] = 0.f;
  }
  issue(0);
  cp_async_commit();
  for (int i = 0; i < n_items; ++i) {
    if (i + 1 < n_items) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();                // item i has landed (this thread)
    __syncthreads();                   // ... for all; item i - 1 is used
    const int it = i / per, j = i % per;
    const T* buf = reinterpret_cast<const T*>(smem + (i & 1) * Ge::kBufBytes);
    if (j < n_kc) {
      // lane = key: partial scores over the warp's 32 columns of the chunk
      const float* qc = qs + (i & 1) * GB * kCols + w * kWarpCols;
      const T* row = buf + lane * Ge::kPitch + w * kWarpCols;
#pragma unroll 2
      for (int c = 0; c < kWarpCols; c += 4) {
        float kf[4];
        load4(row + c, kf);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float4 qv = *reinterpret_cast<const float4*>(qc + g * kCols
                                                             + c);
          s[g] = fmaf(qv.x, kf[0], s[g]);
          s[g] = fmaf(qv.y, kf[1], s[g]);
          s[g] = fmaf(qv.z, kf[2], s[g]);
          s[g] = fmaf(qv.w, kf[3], s[g]);
        }
      }
      if (j == n_kc - 1) {             // the stage's partials, for its V item
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          parts[(w * GB + g) * kKeys + lane] = s[g];
          s[g] = 0.f;
        }
      }
    } else {
      // the warps' partials in warp order, scaled and masked; the online
      // softmax, the G rows' shuffles interleaved
      const bool valid = sp.lo + it * kKeys + lane < sp.hi;
      float sc[GB], red[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float x = parts[g * kKeys + lane];
#pragma unroll
        for (int ww = 1; ww < kWarps; ++ww)
          x += parts[(ww * GB + g) * kKeys + lane];
        sc[g] = valid ? x * scale : kNegInf;
        red[g] = sc[g];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < GB; ++g)
          red[g] = fmaxf(red[g], __shfl_xor_sync(0xffffffffu, red[g], off));
      float corr[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float mx = fmaxf(m[g], red[g]);
        corr[g] = expf(m[g] - mx);
        const float p = expf(sc[g] - mx);
        m[g] = mx;
        acc[g] *= corr[g];
        pw[g * kKeys + lane] = to_f(from_f<T>(p));   // v's type, as p v
        red[g] = p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < GB; ++g)
          red[g] += __shfl_xor_sync(0xffffffffu, red[g], off);
#pragma unroll
      for (int g = 0; g < GB; ++g) l[g] = l[g] * corr[g] + red[g];
      __syncwarp();
      // lane = column: acc += p v over the stage's keys in order
      const T* vc = buf + w * kWarpCols + lane;
#pragma unroll 4
      for (int key = 0; key < kKeys; ++key) {
        const float vv = to_f(vc[key * Ge::kPitch]);
#pragma unroll
        for (int g = 0; g < GB; ++g)
          acc[g] = fmaf(pw[g * kKeys + key], vv, acc[g]);
      }
    }
    __syncthreads();                   // buffer i & 1 may be refilled
  }

  // the split's (m, l, acc), each lane its column of the slab
  const int col = col_v + w * kWarpCols + lane;
  float* pb = part_of(part, bn, pl, G, nch, D);
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g >= gc) break;
    if (col < D) {
      if (nsplit == 1)
        ob[(long long)g * D + col] = from_f<T>(acc[g] / fmaxf(l[g], 1e-30f));
      else
        pb[g * D + col] = acc[g];
    }
    if (nsplit > 1 && pl.slab == 0 && tid == 0) {
      pb[gc * D + g] = m[g];
      pb[gc * D + gc + g] = l[g];
    }
  }
}

// grid (KV, B, G): merge query head g's live splits' (m, l, acc) into its
// hd (D) columns of o; the body ran chunks of `rows` query heads
template <typename T>
__global__ void __launch_bounds__(128)
decode_attention_merge(const float* __restrict__ part, T* __restrict__ o,
                       const int* __restrict__ kv_len_p, int KV, int G,
                       int S, int D, int nch, int rows, int nsplit) {
  const long long bn = (long long)blockIdx.y * KV + blockIdx.x;
  const int g = blockIdx.z;
  const int chunk = g / rows, r = g % rows;
  const int gc = min(G - chunk * rows, rows);
  const long long pitch = (long long)min(G, rows) * (D + 2);
  const float* pb = part + (bn * nch + chunk) * nsplit * pitch;
  const int kv_len = read_kv_len(kv_len_p, S);
  const int per = tiles_per_split(kv_len, nsplit);
  const int tiles = (kv_len + kTile - 1) / kTile;
  const int live = per > 0 ? (tiles + per - 1) / per : 0;
  float mx = kNegInf;
  for (int s = 0; s < live; ++s) mx = fmaxf(mx, pb[s * pitch + gc * D + r]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float lt = 0.f, at = 0.f;
    for (int s = 0; s < live; ++s) {
      const float f = expf(pb[s * pitch + gc * D + r] - mx);
      lt += pb[s * pitch + gc * D + gc + r] * f;
      at += pb[s * pitch + r * D + d] * f;
    }
    o[(bn * G + g) * D + d] = from_f<T>(at / fmaxf(lt, 1e-30f));
  }
}

struct Args {
  const void *q, *k, *v;
  const int* kv_len;
  void* o;
  float* part;
  int B, KV, G, S, D, nsplit, nch, nslab, rows;
  float scale;
  long long ksb, ksn, kss, vsb, vsn, vss;
  cudaStream_t stream;
};

// Call f(kernel, dynamic shared memory, threads) with the kernel that a
// (dtype, body width, G) launches: the tensor-core body for bfloat16 at
// widths 64 and 128 (256 has a ring body of its own), the SIMT body (rows
// padded to 4, 8 or 16) for float32; G > 16 runs chunks of 16 rows.
template <typename F>
int with_mma(int hd, F&& f) {
  if (hd == 64) return f(decode_attention_mma<64>, MmaGeo<64>::kSmem, 128);
  if (hd == 128) return f(decode_attention_mma<128>, MmaGeo<128>::kSmem, 128);
  return (int)cudaErrorInvalidValue;
}
// bf16 at widths 64 and 128 with G > 16: the rows body at `rows` query
// heads a block (mma_rows: 32, 64 or 128, two, four or eight warps)
template <int HD, typename F>
int with_rows_hd(int rows, F&& f) {
  if (rows == 32)
    return f(decode_attention_mma_rows<HD, 2>, MmaGeo<HD>::kSmem, 64);
  if (rows == 64)
    return f(decode_attention_mma_rows<HD, 4>, MmaGeo<HD>::kSmem, 128);
  return f(decode_attention_mma_rows<HD, 8>, MmaGeo<HD>::kSmem, 256);
}
template <typename F>
int with_rows(int hd, int rows, F&& f) {
  if (hd == 64) return with_rows_hd<64>(rows, f);
  if (hd == 128) return with_rows_hd<128>(rows, f);
  return (int)cudaErrorInvalidValue;
}
// the query heads a block of the body that (dtype, width, G) launches
// takes: bf16 at widths 64 and 128 beyond 16 heads, the rows body's 32,
// 64 or 128 (the least that holds G, at most 128); else 16
int mma_rows(int dtype, int body, int G) {
  if (dtype != 1 || (body != 64 && body != 128) || G <= kMaxRows)
    return kMaxRows;
  return G <= 32 ? 32 : G <= 64 ? 64 : 128;
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
  return (int)cudaErrorInvalidValue;
}
// float32 at width 256: the ring body at GB rows (4, 8 or 16), FULL where
// hd is 256 and G <= 16 (ring_full)
template <bool FULL, typename F>
int with_f32_ring_f(int G, F&& f) {
  using namespace f32;
  if (G <= 4)
    return f(decode_attention_hd256_f32<4, FULL>, Geo<4>::kSmem, kThreads);
  if (G <= 8)
    return f(decode_attention_hd256_f32<8, FULL>, Geo<8>::kSmem, kThreads);
  return f(decode_attention_hd256_f32<16, FULL>, Geo<16>::kSmem, kThreads);
}
template <typename F>
int with_f32_ring(int G, bool full, F&& f) {
  return full ? with_f32_ring_f<true>(G, f) : with_f32_ring_f<false>(G, f);
}
// the bf16 ring body, FULL or not
template <typename F>
int with_bulk(bool full, F&& f) {
  return full ? f(decode_attention_hd256_bulk<true>, bulk::kSmem,
                  bulk::kThreads)
              : f(decode_attention_hd256_bulk<false>, bulk::kSmem,
                  bulk::kThreads);
}
// whether a width-256 call is the ring bodies' full shape: hd 256, one
// chunk of query heads, q 4-byte aligned
bool ring_full(const void* q, int D, int G) {
  return D == 256 && G <= kMaxRows && ((unsigned long long)q & 3) == 0;
}
// any hd, either alignment: the slab body at GB rows (4, 8 or 16)
template <typename T, bool VEC, typename F>
int with_slab_v(int G, F&& f) {
  using namespace slab;
  if (G <= 4)
    return f(decode_attention_slab<T, 4, VEC>, Geo<T, 4>::kSmem, kThreads);
  if (G <= 8)
    return f(decode_attention_slab<T, 8, VEC>, Geo<T, 8>::kSmem, kThreads);
  return f(decode_attention_slab<T, 16, VEC>, Geo<T, 16>::kSmem, kThreads);
}
template <typename T, typename F>
int with_slab(int G, bool vec, F&& f) {
  return vec ? with_slab_v<T, true>(G, f) : with_slab_v<T, false>(G, f);
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

// the merge of a call's splits (a call of one split has none)
template <typename T>
int launch_merge(const Args& a) {
  if (a.nsplit == 1) return 0;
  decode_attention_merge<T><<<dim3(a.KV, a.B, a.G), a.D <= 64 ? 64 : 128, 0,
                              a.stream>>>(a.part, (T*)a.o, a.kv_len, a.KV,
                                          a.G, a.S, a.D, a.nch, a.rows,
                                          a.nsplit);
  return (int)cudaGetLastError();
}

// the cp.async bodies over grid (nsplit nch, KV, B), then the merge
template <typename T>
struct Launch {
  const Args& a;
  template <typename K>
  int operator()(K kernel, size_t smem, int threads) const {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3(a.nsplit * a.nch, a.KV, a.B), threads, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, a.kv_len, (T*)a.o,
        a.part, a.KV, a.G, a.S, a.D, a.nch, a.ksb, a.ksn, a.kss, a.vsb,
        a.vsn, a.vss, a.scale);
    e = cudaGetLastError();
    return e != cudaSuccess ? (int)e : launch_merge<T>(a);
  }
};

// the slab body over grid (nsplit nch nslab, KV, B), then the merge
template <typename T>
struct LaunchSlab {
  const Args& a;
  template <typename K>
  int operator()(K kernel, size_t smem, int threads) const {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3(a.nsplit * a.nch * a.nslab, a.KV, a.B), threads, smem,
             a.stream>>>((const T*)a.q, (const T*)a.k, (const T*)a.v,
                         a.kv_len, (T*)a.o, a.part, a.KV, a.G, a.S, a.D,
                         a.nch, a.nslab, a.ksb, a.ksn, a.kss, a.vsb, a.vsn,
                         a.vss, a.scale);
    e = cudaGetLastError();
    return e != cudaSuccess ? (int)e : launch_merge<T>(a);
  }
};

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

// k or v, (B, KV, S, D) bf16 or float32 (dtype 1 or 0), D <= 256, at
// element strides (sb, sn, ss) with the last dim contiguous, as a 4-D map:
// the D columns, then the key, kv head and batch dims in the order of their
// strides (a dim of size 1 last, its stride past the others'), boxes of
// 128 bytes of columns (64 bf16, 32 float32) x a stage's keys (64 bf16,
// 32 float32), 128-byte swizzle; columns past D and keys past S read as
// zero.  slots: the coordinate slot (1-3) of the key, the kv head and the
// batch, 2 bits apiece.
struct CacheMap {
  CUtensorMap map;
  int slots;
};

int make_cache_map(CacheMap* out, const void* base, int dtype, int B, int KV,
                   int S, int D, long long sb, long long sn, long long ss) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return kMapError + (int)CUDA_ERROR_NOT_FOUND;
  const long long esize = dtype == 1 ? 2 : 4;
  const int box_keys = dtype == 1 ? kTile : f32::kKeys;
  struct Dim {
    long long size, stride;
    int box, which;
  } d[3] = {{S, ss * esize, box_keys, 0}, {KV, sn * esize, 1, 1},
            {B, sb * esize, 1, 2}};
  auto before = [](const Dim& x, const Dim& y) {
    if ((x.size == 1) != (y.size == 1)) return y.size == 1;
    return x.stride < y.stride;
  };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && before(d[j], d[j - 1]); --j) {
      const Dim t = d[j];
      d[j] = d[j - 1];
      d[j - 1] = t;
    }
  long long top = bulk::kHD * esize;   // past every element of the others
  for (const Dim& x : d)
    if (x.size > 1 && x.stride * x.size > top) top = x.stride * x.size;
  cuuint64_t dims[4] = {(cuuint64_t)D, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {(cuuint32_t)(128 / esize), 0, 0, 0};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  out->slots = 0;
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)d[i].size;
    strides[i] = (cuuint64_t)(d[i].size > 1 ? d[i].stride : top);
    box[i + 1] = (cuuint32_t)d[i].box;
    out->slots |= (i + 1) << (2 * d[i].which);
  }
  const CUresult r = enc(&out->map,
                         dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                         4, const_cast<void*>(base), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + (int)r;
}

// make_cache_map's map, encoded once per (pointer, type, shape, strides)
// and kept (a decode step finds every layer's cache maps made)
int cache_map(CacheMap* out, const void* base, int dtype, int B, int KV,
              int S, int D, long long sb, long long sn, long long ss) {
  struct Key {
    const void* p;
    long long dtype, B, KV, S, D, sb, sn, ss;
    bool operator==(const Key& o) const {
      return p == o.p && dtype == o.dtype && B == o.B && KV == o.KV &&
             S == o.S && D == o.D && sb == o.sb && sn == o.sn && ss == o.ss;
    }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      size_t h = std::hash<const void*>()(k.p);
      for (long long x : {k.dtype, k.B, k.KV, k.S, k.D, k.sb, k.sn, k.ss})
        h = h * 1000003u ^ std::hash<long long>()(x);
      return h;
    }
  };
  static std::mutex mu;
  static std::unordered_map<Key, CacheMap, Hash> maps;
  const Key key{base, dtype, B, KV, S, D, sb, sn, ss};
  std::lock_guard<std::mutex> lock(mu);
  auto it = maps.find(key);
  if (it == maps.end()) {
    CacheMap m;
    const int rc = make_cache_map(&m, base, dtype, B, KV, S, D, sb, sn, ss);
    if (rc != 0) return rc;
    if (maps.size() >= 4096) maps.clear();
    it = maps.emplace(key, m).first;
  }
  *out = it->second;
  return 0;
}

// width 256 in either type: the ring body over grid (nsplit nch, KV, B)
// on k's and v's tensor maps, then the merge
template <typename T>
struct LaunchRing {
  const Args& a;
  int dtype;
  template <typename K>
  int operator()(K kernel, size_t smem, int threads) const {
    CacheMap mk, mv;
    int rc = cache_map(&mk, a.k, dtype, a.B, a.KV, a.S, a.D, a.ksb, a.ksn,
                       a.kss);
    if (rc == 0)
      rc = cache_map(&mv, a.v, dtype, a.B, a.KV, a.S, a.D, a.vsb, a.vsn,
                     a.vss);
    if (rc != 0) return rc;
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3(a.nsplit * a.nch, a.KV, a.B), threads, smem, a.stream>>>(
        mk.map, mv.map, (const T*)a.q, a.kv_len, (T*)a.o, a.part, a.KV, a.G,
        a.S, a.D, a.nch, mk.slots, mv.slots, a.scale);
    e = cudaGetLastError();
    return e != cudaSuccess ? (int)e : launch_merge<T>(a);
  }
};

// out[0] a ring body's dynamic shared memory (bytes), [1] threads a block,
// [2] consumer (math) warps, [3] ring stages, [4] registers a thread and
// [5] local memory a thread (spills), as the runtime reads them from the
// binary, [6] its blocks an SM
struct Info {
  int* out;
  int consumers, stages;
  template <typename K>
  int operator()(K kernel, size_t smem, int threads) const {
    cudaError_t e = allow_smem(kernel, smem);
    cudaFuncAttributes attr;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
    int blocks = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
    out[0] = (int)smem;
    out[1] = threads;
    out[2] = consumers;
    out[3] = stages;
    out[4] = attr.numRegs;
    out[5] = (int)attr.localSizeBytes;
    out[6] = blocks;
    return 0;
  }
};

int f32_stages(int G) {
  using namespace f32;
  return G <= 4 ? Geo<4>::kStages : G <= 8 ? Geo<8>::kStages
                                           : Geo<16>::kStages;
}

}  // namespace

// Resident blocks per SM of the body that (body, dtype, G) launches (body:
// the width 64, 128 or 256, or 0 for the slab body), from the occupancy
// calculator (the wrapper's planner reads it once).
extern "C" int decode_attention_blocks_per_sm(int body, int dtype, int G,
                                              int* out) {
  if (body == 0 && dtype == 1) return with_slab<bf16>(G, true, Occupancy{out});
  if (body == 0 && dtype == 0)
    return with_slab<float>(G, true, Occupancy{out});
  if (dtype == 1 && body == 256)
    return with_bulk(true, Occupancy{out});
  if (dtype == 1 && G > kMaxRows)
    return with_rows(body, mma_rows(dtype, body, G), Occupancy{out});
  if (dtype == 1) return with_mma(body, Occupancy{out});
  if (dtype == 0 && body == 256)
    return with_f32_ring(G, true, Occupancy{out});
  if (dtype == 0) return with_simt(body, G, Occupancy{out});
  return (int)cudaErrorInvalidValue;
}

// q, o: (B, KV, G, D) contiguous; k, v: element strides (batch, kv head,
// key) with the last dimension contiguous; all of one type: dtype 0 =
// float32, 1 = bfloat16.  kv_len: one int32 on the device.  body: the
// width (64, 128 or 256, at least D; rows 16-byte aligned) of the body that
// runs, or 0 for the slab body (any D, any alignment; nslab = ceil(D /
// 128)).  nch = ceil(G / rows) chunks of query heads, rows = 16, or for
// bf16 at widths 64 and 128 beyond 16 heads the rows body's (mma_rows).
// The valid keys are cut into nsplit splits of whole 64-key tiles
// (split_span); part: B KV nch nsplit min(G, rows) (D + 2) floats of
// scratch when nsplit > 1.
// Returns cudaGetLastError() of the launches, or kMapError + the CUresult
// of a tensor map cuTensorMapEncodeTiled refused (width 256).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* kv_len, void* o,
    void* part, int B, int KV, int G, int S, int D, int body, int dtype,
    int nsplit, int nch, int nslab, float scale, long long ksb, long long ksn,
    long long kss, long long vsb, long long vsn, long long vss,
    void* stream) {
  if (B <= 0 || KV <= 0) return 0;
  const long long align = dtype == 1 ? 8 : 4;     // elements per 16 bytes
  const bool vec = !(((unsigned long long)k | (unsigned long long)v) & 15) &&
                   !(ksb % align || ksn % align || kss % align ||
                     vsb % align || vsn % align || vss % align);
  const int rows = body == 0 ? kMaxRows : mma_rows(dtype, body, G);
  if (G < 1 || G > 65535 || D < 1 || S < 1 || nsplit < 1 ||
      nsplit > 65535 || KV > 65535 || B > 65535 ||
      nch != (G + rows - 1) / rows ||
      (body == 0 ? nslab != (D + slab::kCols - 1) / slab::kCols
                 : nslab != 1 || D > body || !vec))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, (const int*)kv_len, o, (float*)part, B, KV, G, S,
               D, nsplit, nch, nslab, rows, scale, ksb, ksn, kss, vsb, vsn,
               vss, (cudaStream_t)stream};
  if (part == nullptr && nsplit > 1) return (int)cudaErrorInvalidValue;
  if (body == 0 && dtype == 1)
    return with_slab<bf16>(G, vec, LaunchSlab<bf16>{a});
  if (body == 0 && dtype == 0)
    return with_slab<float>(G, vec, LaunchSlab<float>{a});
  if (dtype == 1 && body == 256)
    return with_bulk(ring_full(q, D, G), LaunchRing<bf16>{a, 1});
  if (dtype == 1 && rows > kMaxRows)
    return with_rows(body, rows, Launch<bf16>{a});
  if (dtype == 1) return with_mma(body, Launch<bf16>{a});
  if (dtype == 0 && body == 256)
    return with_f32_ring(G, ring_full(q, D, G), LaunchRing<float>{a, 0});
  if (dtype == 0) return with_simt(body, G, Launch<float>{a});
  return (int)cudaErrorInvalidValue;
}

// The hd 256 ring body's launch shape and resources, for a report (Info's
// out[0..6]): the bf16 body (dtype 1), or the float32 body (dtype 0) that
// G query rows a kv head launch.  Returns a cudaError_t.
extern "C" int decode_attention_hd256_info(int dtype, int G, int* out) {
  if (dtype == 1)
    return with_bulk(true, Info{out, bulk::kConsumers, bulk::kStages});
  if (dtype == 0 && G >= 1)
    return with_f32_ring(G, true,
                         Info{out, f32::kConsumers, f32_stages(G)});
  return (int)cudaErrorInvalidValue;
}
