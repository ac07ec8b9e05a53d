// RWKV-6 WKV recurrence (per token, fp32 state in registers).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6_scan.py::rwkv6_scan_bhtk
//
// For each (b, h), with the state S (K x V) starting at s0[b, h]:
//   o_t = r_t S_{t-1} + (r_t . u . k_t) v_t
//   S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T
// r, k, v (B, H, T, K|V) float32 or bfloat16 (one type), lw (B, H, T, K)
// float32, each read in place through its element strides (batch, head,
// token) with the last dimension contiguous.  u (H, K) and s0 (B, H, K, V)
// float32, contiguous.  out in r's type through its strides (the wrapper
// passes a (B, T, H, V) tensor, the layout the time-mix reads); sT
// (B, H, K, V) float32.  Any K >= 1, T >= 1 and V >= 1:
//   - the body is instantiated at K 16, 32, 64 and 128 (Kp); a K between
//     runs the next of them with r, k, lw and u zero past K in shared
//     memory and the state's rows past K neither loaded from s0 nor stored
//     to sT.  That is exact: a zero key adds nothing to the state, a zero
//     r reads nothing from it, and those rows start at zero;
//   - a K above 128 splits the state into slabs of 128 rows, each run by
//     its own blocks on its rows (its share of r S and of the bonus
//     (r . u . k) v) into a float32 scratch; a second kernel
//     (rwkv6_sum_slabs) sums the slabs' partial outputs in slab order, so
//     a repeated call is bit-identical;
//   - rows that are not 16-byte aligned (start or strides of r, k, v or
//     lw) are copied element by element instead of by cp.async.
//
// The TPU kernel is chunked because its matrix unit wants (c, c) products:
// within a chunk it scales r and k by exp(+-cumsum(lw)), up to e^64, and
// carries S across chunks in VMEM.  Here the recurrence runs token by token
// in fp32 FMAs, as the plain version does, so nothing is rescaled and the
// kernel matches the plain version to rounding (the sums are taken in
// another order; exp is the ex2 unit's, ~2 ulp).
//
// Bound on an H100: operations.  Per token and head the recurrence does
// about 5 K V flops (the r_t S product, the decay and the rank-1 update)
// on 3 K + V input values; at the serving path's prefill (4, 40, 1024, 64)
// that is ~3.4 GFLOP against ~131 MB, ~0.050 ms at 67 TFLOP/s of fp32
// against ~0.039 ms at 3.35 TB/s.  What holds this kernel back in
// practice is instruction issue: every thread reads r_t, k_t and lw_t of
// its rows from shared memory for each token, and each token's state
// update is a handful of instructions per element on few warps (the
// prefill has 160 (b, h) pairs).  Design:
//   - the columns of S are independent: a block owns one (b, h) and 16
//     columns of S (64 at K = 16, 32 at K = 32), so the prefill call has
//     640 blocks of 2 warps, all resident at once; no value crosses a
//     block;
//   - a thread holds a 4 x 4 tile of S (4 rows, 4 columns) in registers,
//     so it reads 16 values from shared memory per token for 16 state
//     elements (a 2 x 8 or 8 x 2 tile would read 14 or 26); the 16
//     threads of a column each own 4 rows;
//   - the token loop has no cross-lane step and no store: the partial sums
//     of o_t stay in registers for the chunk, so the loads of later tokens
//     issue early and the only loop-carried chain is each element's FMA.
//     After the chunk a reduce-scatter by shuffles over a column's lanes
//     (halving the values at each step, in a fixed order: a repeated call
//     is bit-identical) leaves each lane whole sums of o, written straight
//     to device memory; no shared memory holds partial sums;
//   - each thread widens r and k from bf16 as it reads them, takes exp of
//     its 4 rows of lw (the ex2 unit) and its share of the bonus
//     (r_t . u . k_t) v_t, which the sum over row quads completes, so a
//     staged chunk needs no preparing pass;
//   - staging is pipelined: chunks of 16 tokens of r, k, lw and v are
//     copied as they are stored, by 16-byte cp.async, into a ring of three
//     stages, two chunks ahead of the one computed, with one barrier per
//     chunk;
//   - outputs are written as 16-byte vectors (scalar stores only at a
//     ragged or unaligned edge); a one-token chunk (a decode step) sums
//     its one token by an all-reduce instead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kChunk = 16;           // tokens per stage
constexpr int kStages = 3;           // stages of the cp.async ring
constexpr int kRows = 4;             // rows of S per thread
constexpr int kItemRows = 8;         // rows of a staged (token, group) item

__device__ __forceinline__ float bf_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
// four consecutive values of T in shared memory -> floats
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  x[0] = bf_lo(a.x); x[1] = bf_hi(a.x); x[2] = bf_lo(a.y); x[3] = bf_hi(a.y);
}
// 16 bytes of outputs of T from floats (round to nearest even, as astype
// does), and one output
__device__ __forceinline__ uint4 pack16(const float (&x)[4]) {
  return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                    __float_as_uint(x[2]), __float_as_uint(x[3]));
}
__device__ __forceinline__ uint4 pack16(const float (&x)[8]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// N outputs to dst (none if dst is null): one 16-byte store where they
// fill it and the row allows it, else one by one up to the room left in V
template <int N, typename T>
__device__ __forceinline__ void write_out(T* dst, const float (&x)[N],
                                          bool vec, int room) {
  if (dst == nullptr) return;
  if constexpr (N * sizeof(T) == 16) {
    if (vec && room >= N) {
      *reinterpret_cast<uint4*>(dst) = pack16(x);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < N; ++e)
    if (e < room) store1(dst + e, x[e]);
}

__device__ __forceinline__ float exp_fast(float x) {   // e^x = 2^(x log2 e)
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  // bytes < 16: the rest is zero-filled, and 0 reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int K>
struct Geo {
  static constexpr int kSplit = K / kRows;              // threads per column
  static constexpr int kCols = K <= 64 ? 1024 / K : 16;  // columns per block
  static constexpr int kThreads = kCols / 4 * kSplit;   // 64, or 128 at K 128
  static constexpr int kGroups = K / kItemRows;         // items per token
  static constexpr int kItems = kChunk * kGroups;       // (token, row group)
  static constexpr int kOVec = 16 / (int)sizeof(T);     // values per 16 bytes
  static constexpr int kVChunks = kChunk * kCols / kOVec;
  static constexpr int kPerRow = kCols / kOVec;         // v copies per token
  static constexpr int kHeld = kChunk * 4 / kSplit;    // sums a lane ends with
  // shared memory, in bytes: the ring's stages, each a chunk's r, k, lw
  // and the block's columns of v as stored
  static constexpr int kR = kChunk * K * (int)sizeof(T);
  static constexpr int kW = 2 * kR;                     // offsets in a stage
  static constexpr int kV = kW + kChunk * K * 4;
  static constexpr int kStage = kV + kChunk * kCols * (int)sizeof(T);
  static constexpr int kSmem = kStages * kStage;
  static_assert(kSplit <= 32 && kHeld >= 2, "a column's lanes in a warp");
  static_assert(kCols >= 16 && kCols % kOVec == 0, "16-byte vectors");
  static_assert(kThreads % kGroups == 0, "a thread stages one row group");
};

// one step of a reduce-scatter over lanes d apart: the lane whose bit d is
// set keeps the upper HALF values, its partner the lower, each adding the
// other's copy of what it keeps; the kept values move to a[0, HALF)
template <int D, int HALF, int N>
__device__ __forceinline__ void scatter_step(float (&a)[N], int lane_bits) {
  const bool up = lane_bits & D;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? a[i] : a[i + HALF];
    const float keep = up ? a[i + HALF] : a[i];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, D);
  }
}

// x[0, 4) += the lane d away's, all 32 lanes taking part
template <int D, int N>
__device__ __forceinline__ void add_from(float (&x)[N]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) x[c] += __shfl_xor_sync(0xffffffffu, x[c], D);
}

struct Strides {
  long long b, h, t;
};

// grid (ceil(V / kCols) x slabs, H, B).  The block's slab holds the
// state's rows k0 .. k0 + K - 1 (k0 = K slab) of the Kall rows, of which
// the first Kt = min(K, Kall - k0) are real.  out: TO through os_, plus
// slab_stride a slab (a slab's partial sums, float32, where Kall > 128).
// VEC: r, k, v and lw rows 16-byte aligned, copied by cp.async; else
// element by element.
template <typename T, typename TO, int K, bool VEC>
__global__ void __launch_bounds__(Geo<T, K>::kThreads)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ lw,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  TO* __restrict__ out, float* __restrict__ sT, int H,
                  int T_, int V, int Kall, int n_vb, long long slab_stride,
                  Strides rs_, Strides ks_, Strides ws_, Strides vs_,
                  Strides os_) {
  using G = Geo<T, K>;
  extern __shared__ __align__(16) unsigned char smem[];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int slab = blockIdx.x / n_vb;
  const int k0 = slab * K;                  // the slab's first state row
  const int Kt = min(K, Kall - k0);         // its real rows
  const int p = tid % G::kSplit;            // rows p * 4.. of S here
  const int g = tid % G::kGroups;           // the row group it stages
  const int c0 = 4 * (tid / G::kSplit);     // its four columns in the tile
  const int col0 = blockIdx.x % n_vb * G::kCols;
  const int col = col0 + c0;
  const long long bh = (long long)b * H + h;
  constexpr long long E = sizeof(T);
  // the real rows of the thread's staged row group, and its bytes of r, k
  const int g_rows = min(max(Kt - g * kItemRows, 0), kItemRows);
  const int g_bytes = g_rows * (int)E;
  const unsigned char* rb = reinterpret_cast<const unsigned char*>(
      r + b * rs_.b + h * rs_.h + k0 + g * kItemRows);
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(
      k + b * ks_.b + h * ks_.h + k0 + g * kItemRows);
  const unsigned char* wb = reinterpret_cast<const unsigned char*>(
      lw + b * ws_.b + h * ws_.h + k0 + g * kItemRows);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(
      v + b * vs_.b + h * vs_.h + col0);
  TO* ob = out + slab * slab_stride + b * os_.b + h * os_.h;
  const int n_chunks = (T_ + kChunk - 1) / kChunk;
  const bool vec_ok =
      ((unsigned long long)ob % 16 == 0) && (os_.t % G::kOVec == 0);
  const int v_bytes = (V - col0) * (int)E;  // valid bytes of a v row here
  auto stage = [&](int ch) { return smem + (ch % kStages) * G::kStage; };

  // copy chunk ch into its stage as stored: each thread its share of
  // (token, 8-row group) pieces of r, k, lw and 16-byte pieces of v, the
  // ragged end zero-filled
  // the pieces this thread copies: its (token, row group) items at fixed
  // offsets in a stage, their sources advancing one chunk per copy
  constexpr int kMine = (G::kItems + G::kThreads - 1) / G::kThreads;
  const unsigned char* src[kMine][3];
  int dst[kMine];
#pragma unroll
  for (int j = 0; j < kMine; ++j) {
    const int t = (tid + j * G::kThreads) / G::kGroups;
    dst[j] = t * K + g * kItemRows;
    src[j][0] = rb + t * rs_.t * E;
    src[j][1] = kb + t * ks_.t * E;
    src[j][2] = wb + t * ws_.t * 4;
  }
  constexpr int kMineV = (G::kVChunks + G::kThreads - 1) / G::kThreads;
  const long long step_r = kChunk * rs_.t * E, step_k = kChunk * ks_.t * E,
                  step_w = kChunk * ws_.t * 4, step_v = kChunk * vs_.t * E;
  // a piece of n real bytes (the rest of its 16 zero): cp.async where
  // the rows are aligned, else element by element (the bits of an element
  // of el's size)
  using Raw = typename std::conditional<sizeof(T) == 2, unsigned short,
                                        unsigned>::type;
  auto piece = [&](unsigned char* d, const unsigned char* s_, int n,
                   auto el) {
    if constexpr (VEC) {
      cp_async16(d, s_, n);
    } else {
      using EL = decltype(el);
#pragma unroll
      for (int e = 0; e < 16 / (int)sizeof(EL); ++e)
        reinterpret_cast<EL*>(d)[e] =
            e * (int)sizeof(EL) < n ? reinterpret_cast<const EL*>(s_)[e]
                                    : EL(0);
    }
  };
  auto issue = [&](int ch) {
    unsigned char* st = stage(ch);
    const int t0 = ch * kChunk;
#pragma unroll
    for (int j = 0; j < kMine; ++j) {
      if (tid + j * G::kThreads >= G::kItems) break;
      const int t = (tid + j * G::kThreads) / G::kGroups;
      const bool in = t0 + t < T_;
      const unsigned char* r_ = src[j][0] + ch * step_r;
      const unsigned char* k_ = src[j][1] + ch * step_k;
      const unsigned char* w_ = src[j][2] + ch * step_w;
#pragma unroll
      for (int q = 0; q < kItemRows * (int)E / 16; ++q) {
        const int n = in ? min(max(g_bytes - q * 16, 0), 16) : 0;
        piece(st + dst[j] * E + q * 16, n ? r_ + q * 16 : rb, n, Raw(0));
        piece(st + G::kR + dst[j] * E + q * 16, n ? k_ + q * 16 : kb, n,
              Raw(0));
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = in ? min(max(g_rows * 4 - q * 16, 0), 16) : 0;
        piece(st + G::kW + dst[j] * 4 + q * 16, n ? w_ + q * 16 : wb, n,
              0u);
      }
    }
#pragma unroll
    for (int j = 0; j < kMineV; ++j) {     // its 16-byte pieces of v
      const int i = tid + j * G::kThreads;
      if (i >= G::kVChunks) break;
      const int t = i / G::kPerRow, q = i % G::kPerRow;
      const int n = t0 + t < T_ ? min(max(v_bytes - q * 16, 0), 16) : 0;
      piece(st + G::kV + (t * G::kCols + q * G::kOVec) * E,
            n ? vb + t * vs_.t * E + ch * step_v + q * 16 : vb, n, Raw(0));
    }
  };

  // the complete sums a lane holds after a chunk's reduce-scatter: kHeld
  // values from flat (token, column) index p * kHeld of its column quad.
  // A bf16 lane takes its neighbouring quad's sums (the lane kSplit away)
  // so that eight columns leave as one 16-byte store
  auto store_out = [&](int ch, const float (&o)[kChunk * 4]) {
    const int t0 = ch * kChunk;
    const int j0 = p * G::kHeld;
    auto at = [&](int t, int cc) {
      return t0 + t < T_ && col0 + cc < V
                 ? ob + (long long)(t0 + t) * os_.t + col0 + cc : nullptr;
    };
    if constexpr (G::kHeld >= 4) {
#pragma unroll
      for (int i = 0; i < G::kHeld / 4; ++i) {
        float x[G::kOVec];
#pragma unroll
        for (int c = 0; c < 4; ++c) x[c] = o[4 * i + c];
        if constexpr (sizeof(T) == 2) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            x[4 + c] = __shfl_xor_sync(0xffffffffu, x[c], G::kSplit);
          if ((c0 >> 2) & 1) continue;      // its sums went to the even quad
        }
        write_out(at(j0 / 4 + i, c0), x, vec_ok, V - col0 - c0);
      }
    } else {                               // K = 128: two columns a lane
      const float x[2] = {o[0], o[1]};
      write_out(at(j0 / 4, c0 + j0 % 4), x, false, V - col0 - c0 - j0 % 4);
    }
  };

  // one token's whole sums, held by every lane of the column quad: the
  // quad's first lane writes them (a bf16 even quad with its neighbour's)
  auto store_token = [&](int tok, float (&x)[G::kOVec]) {
    if constexpr (sizeof(T) == 2 && G::kSplit < 32) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        x[4 + c] = __shfl_xor_sync(0xffffffffu, x[c], G::kSplit);
      if ((c0 >> 2) & 1) return;
    }
    if (p != 0 || tok >= T_ || col0 + c0 >= V) return;
    TO* dst = ob + (long long)tok * os_.t + col0 + c0;
    if constexpr (sizeof(T) == 2 && G::kSplit < 32) {
      write_out(dst, x, vec_ok, V - col0 - c0);
    } else {
      const float y[4] = {x[0], x[1], x[2], x[3]};
      write_out(dst, y, vec_ok, V - col0 - c0);
    }
  };

  float uq[kRows];                // u of this thread's rows (0 past Kt)
#pragma unroll
  for (int m = 0; m < kRows; ++m)
    uq[m] = p * kRows + m < Kt ? u[(long long)h * Kall + k0 + p * kRows + m]
                               : 0.f;
  // S and sT move as 16-byte rows of four columns where V allows it; rows
  // past Kt start at zero and are not stored
  const bool s_vec = V % 4 == 0;
  float S[4][kRows];              // rows p * 4.. of columns col..col + 3
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const float* src = s0 + (bh * Kall + k0 + p * kRows + m) * V + col;
    if (p * kRows + m >= Kt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) S[c][m] = 0.f;
    } else if (s_vec && col < V) {
      const float4 x = *reinterpret_cast<const float4*>(src);
      S[0][m] = x.x; S[1][m] = x.y; S[2][m] = x.z; S[3][m] = x.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) S[c][m] = col + c < V ? src[c] : 0.f;
    }
  }

  issue(0);
  cp_async_commit();
  if (n_chunks > 1) issue(1);
  cp_async_commit();

  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<1>();           // this thread's copies of chunk ch
    __syncthreads();              // ... and everyone's; chunk ch - 1
                                  // computed by all, its stage free
    if (ch + 2 < n_chunks) issue(ch + 2);
    cp_async_commit();

    // the recurrence over the chunk, partial sums of o in registers; no
    // store inside the loop, so the loads of later tokens issue early.  A
    // full chunk runs without a branch per token
    const unsigned char* st = stage(ch);
    const T* rs = reinterpret_cast<const T*>(st) + p * kRows;
    const T* ks = reinterpret_cast<const T*>(st + G::kR) + p * kRows;
    const float* ws = reinterpret_cast<const float*>(st + G::kW) + p * kRows;
    const T* vs = reinterpret_cast<const T*>(st + G::kV) + c0;
    const int n = min(kChunk, T_ - ch * kChunk);
    float a[kChunk * 4];          // (token, column), flat
    auto token = [&](int t) {
      float rv[4], kv[4], lv[4], vj[4];
      load4(rs + t * K, rv);
      load4(ks + t * K, kv);
      load4(ws + t * K, lv);
      load4(vs + t * G::kCols, vj);
      // this thread's share of the bonus (r . u . k) v and its decays
      float bonus = 0.f, wv[4];
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        bonus = fmaf(rv[m] * uq[m], kv[m], bonus);
        wv[m] = exp_fast(lv[m]);
      }
      float x[4], y[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        x[c] = fmaf(rv[0], S[c][0], bonus * vj[c]);
        y[c] = rv[1] * S[c][1];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        x[c] = fmaf(rv[2], S[c][2], x[c]);
        y[c] = fmaf(rv[3], S[c][3], y[c]);
      }
#pragma unroll
      for (int m = 0; m < kRows; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          S[c][m] = fmaf(S[c][m], wv[m], kv[m] * vj[c]);
#pragma unroll
      for (int c = 0; c < 4; ++c) a[4 * t + c] = x[c] + y[c];
    };
    if (n == kChunk) {
#pragma unroll
      for (int t = 0; t < kChunk; ++t) token(t);
    } else {
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        if (t < n) {
          token(t);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) a[4 * t + c] = 0.f;
        }
      }
    }
    // o_t: the column's kSplit lanes hold partial sums of 16 tokens x 4
    // columns; a reduce-scatter by shuffles (halving the values at each
    // step, in a fixed order) leaves each lane kHeld complete sums,
    // lane p the flat range [p * kHeld, (p + 1) * kHeld) of (token, column)
    if (n == 1) {                 // one token (a decode step): all-reduce
      float x[G::kOVec];
#pragma unroll
      for (int c = 0; c < 4; ++c) x[c] = a[c];
      if constexpr (G::kSplit >= 32) add_from<16>(x);
      if constexpr (G::kSplit >= 16) add_from<8>(x);
      if constexpr (G::kSplit >= 8) add_from<4>(x);
      if constexpr (G::kSplit >= 4) add_from<2>(x);
      add_from<1>(x);
      store_token(ch * kChunk, x);
      continue;
    }
    constexpr int kAll = kChunk * 4;
    if constexpr (G::kSplit >= 32) scatter_step<16, kAll / 2>(a, p);
    if constexpr (G::kSplit >= 16)
      scatter_step<8, kAll * 8 / G::kSplit>(a, p);
    if constexpr (G::kSplit >= 8) scatter_step<4, kAll * 4 / G::kSplit>(a, p);
    if constexpr (G::kSplit >= 4) scatter_step<2, kAll * 2 / G::kSplit>(a, p);
    scatter_step<1, kAll / G::kSplit>(a, p);
    store_out(ch, a);
  }

#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    if (p * kRows + m >= Kt) break;
    float* dst = sT + (bh * Kall + k0 + p * kRows + m) * V + col;
    if (s_vec && col < V) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(S[0][m], S[1][m], S[2][m], S[3][m]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (col + c < V) dst[c] = S[c][m];
    }
  }
}

// out[b, h, t, c] = the slabs' partial sums of o, added in slab order, in
// T through out's strides; part: (slabs, B, H, T, V) float32, n = B H T V
template <typename T>
__global__ void __launch_bounds__(256)
rwkv6_sum_slabs(const float* __restrict__ part, T* __restrict__ out,
                int slabs, int H, int T_, int V, long long n, Strides os) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n;
       i += (long long)gridDim.x * 256) {
    float x = part[i];
    for (int sl = 1; sl < slabs; ++sl) x += part[sl * n + i];
    const int c = (int)(i % V);
    long long rest = i / V;
    const int t = (int)(rest % T_);
    rest /= T_;
    const int h = (int)(rest % H);
    store1(out + rest / H * os.b + h * os.h + t * os.t + c, x);
  }
}

struct Call {
  const void *r, *k, *v;
  const float *lw, *u, *s0;
  float* sT;
  int B, H, T_, K, V;
  const long long* st;     // strides of r, k, lw, v, out (see below)
  cudaStream_t stream;
};

// the body at KP rows a slab, its outputs (TO) through os (and
// slab_stride a slab)
template <typename T, typename TO, int KP, bool VEC>
int launch(const Call& c, TO* out, Strides os, long long slab_stride) {
  using G = Geo<T, KP>;
  auto kernel = rwkv6_scan_kernel<T, TO, KP, VEC>;
  static unsigned ready = 0;   // devices whose shared-memory limit is set
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && !(ready >> (dev & 31) & 1u)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::kSmem);
    if (e == cudaSuccess) ready |= 1u << (dev & 31);
  }
  if (e != cudaSuccess) {      // report it, leave no stale error behind
    cudaGetLastError();
    return (int)e;
  }
  const long long* st = c.st;
  const int n_vb = (c.V + G::kCols - 1) / G::kCols;
  const dim3 grid(n_vb * ((c.K + KP - 1) / KP), c.H, c.B);
  kernel<<<grid, G::kThreads, G::kSmem, c.stream>>>(
      (const T*)c.r, (const T*)c.k, (const T*)c.v, c.lw, c.u, c.s0, out,
      c.sT, c.H, c.T_, c.V, c.K, n_vb, slab_stride,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, os);
  return (int)cudaGetLastError();
}

// K up to 128: the least instantiation at or above it, straight into out;
// above 128: slabs of 128 rows into `part`, then their sum
template <typename T, bool VEC>
int launch_k(const Call& c, void* out, float* part) {
  const Strides os{c.st[12], c.st[13], c.st[14]};
  if (c.K <= 16) return launch<T, T, 16, VEC>(c, (T*)out, os, 0);
  if (c.K <= 32) return launch<T, T, 32, VEC>(c, (T*)out, os, 0);
  if (c.K <= 64) return launch<T, T, 64, VEC>(c, (T*)out, os, 0);
  if (c.K <= 128) return launch<T, T, 128, VEC>(c, (T*)out, os, 0);
  if (part == nullptr) return (int)cudaErrorInvalidValue;
  const long long n = (long long)c.B * c.H * c.T_ * c.V;
  const int rc = launch<T, float, 128, VEC>(
      c, part, Strides{(long long)c.H * c.T_ * c.V, (long long)c.T_ * c.V,
                       c.V}, n);
  if (rc != 0) return rc;
  const long long want = (n + 255) / 256;
  const long long blocks = want < 132 * 16 ? want : 132 * 16;
  rwkv6_sum_slabs<T><<<(unsigned)blocks, 256, 0, c.stream>>>(
      part, (T*)out, (c.K + 127) / 128, c.H, c.T_, c.V, n, os);
  return (int)cudaGetLastError();
}

}  // namespace

// One array a of 30 values, so that a call converts two arguments: the
// pointers r, k, v, lw, u, s0, out, sT; then B, H, T, K, V and the dtype of
// r, k, v and out (0 = float32, 1 = bfloat16; lw, u, s0 and sT are
// float32); then the element strides (batch, head, token) of r, k, lw, v
// and out; then `part`, float32 scratch of ceil(K / 128) B H T V where
// K > 128 (else unused).  r, k, lw: (B, H, T, K); v, out: (B, H, T, V);
// last dimensions contiguous.  u: (H, K) and s0, sT: (B, H, K, V)
// contiguous.  Any K >= 1; rows of r, k, lw and v that are 16-byte aligned
// (start and strides) are copied by cp.async, others element by element.
// Returns cudaGetLastError() of the launches.
extern "C" int rwkv6_scan_launch(const long long* a, void* stream) {
  const void *r = (const void*)a[0], *k = (const void*)a[1],
             *v = (const void*)a[2], *lw = (const void*)a[3],
             *u = (const void*)a[4], *s0 = (const void*)a[5];
  void *out = (void*)a[6], *sT = (void*)a[7];
  const int B = (int)a[8], H = (int)a[9], T_ = (int)a[10], K = (int)a[11],
            V = (int)a[12], dtype = (int)a[13];
  const long long* st = a + 14;
  float* part = (float*)a[29];
  if (B <= 0 || H <= 0 || V <= 0) return 0;
  if (T_ <= 0 || K <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const long long align = dtype == 1 ? 8 : 4;     // elements per 16 bytes
  const int sizes[3] = {B, H, T_};                // a size-1 stride is moot
  bool vec = !((((unsigned long long)r | (unsigned long long)k |
                 (unsigned long long)lw | (unsigned long long)v) & 15));
  for (int i = 0; i < 12; ++i)                    // r, k: T; lw: float; v: T
    if (sizes[i % 3] > 1 && st[i] % (i < 6 || i >= 9 ? align : 4))
      vec = false;
  const Call c{r, k, v, (const float*)lw, (const float*)u,
               (const float*)s0, (float*)sT, B, H, T_, K, V, st,
               (cudaStream_t)stream};
  if (dtype == 0)
    return vec ? launch_k<float, true>(c, out, part)
               : launch_k<float, false>(c, out, part);
  if (dtype == 1)
    return vec ? launch_k<__nv_bfloat16, true>(c, out, part)
               : launch_k<__nv_bfloat16, false>(c, out, part);
  return (int)cudaErrorInvalidValue;
}
