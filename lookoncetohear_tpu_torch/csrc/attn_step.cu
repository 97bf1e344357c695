// Ring attention step over a float or int8 K/V history.
//
// Replaces two Pallas TPU kernels of
//   lookoncetohear_tpu/ops/pallas_attention.py:
//   attention_step_pallas (body _attn_step_kernel) over a float32 or
//   bfloat16 ring, and attention_step_int8_pallas (body
//   _attn_step_int8_kernel) over an int8 ring with per-slot scales.
// Contract, per row b (a (stream, head) pair of the head-major layout):
//   s_j   = (q . K_j) [* k_scale_j] * inv   for the W1 ring slots j,
//   s_cur = (q . k_t) * inv,                 inv = 1/sqrt(Dk),
//   p     = softmax over the W1 + 1 scores,
//   out   = (sum_j p_j [* v_scale_j] V_j + p_cur v_t),
// accumulated in float32 and stored in q's type. The ring is only
// read: the caller writes slot `pos` after the step (attend, then
// write). q, k_t, v_t share one type T (float32 or bfloat16); the ring
// is stored as S (float32, bfloat16, or int8 with float32 scales
// [B, W1]). Instantiated for (T, S) = (f32, f32), (bf16, bf16),
// (f32, bf16), (f32, int8), (bf16, int8).
//
// What bounds it on the H100: device memory. At the serving shape
// (64 streams x 4 heads = 256 rows, W1 = 49, Dk = 582, Dv = 1552) a
// call reads 107 MB of float32 ring (54 MB bf16, 27 MB int8), 32 us
// at 3.35 TB/s (16.6 bf16, 8.1 int8), and does 0.05 GFLOP. A row's K
// block [W1, Dk] and V block [W1, Dv] are each one contiguous span
// (57 KB and 152 KB in bf16).
//
// Bytes in flight (Little's law): 3.35 TB/s over a loaded DRAM latency
// of ~0.6-0.8 us needs 2.0-2.7 MB in flight on the card, 8-11 KB per
// block of the serving shape. The two-pass kernel of PR 5 had ~4 KB per
// block in flight (K in two-byte loads, 4 at a time per lane; V only
// after the softmax): ~1 MB on the card, 49% of the bound in bf16.
//
// Design: one block of 256 threads per row (and per 2 x 256 V granules
// of columns, so any Dv fits); two blocks per SM, so the 256 rows of
// the serving shape run in one wave. A row is read as tiles of about
// 24 KB (make_plan): first its K slots (3 tiles of 17, 17 and 15 slots
// in bf16), then its V slots (7 tiles of 7). Three shared-memory
// buffers take the tiles in that order by bulk copies (cp.async.bulk on
// one mbarrier a buffer) issued by one lane: two at the start, then, as
// tile t arrives, tile t + 2 into the buffer that tile t - 1 left. So a
// block keeps two tiles (~44 KB) outstanding, also while it computes:
// ~11 MB on the card, 4-5x what Little's law asks. V's copies are in
// flight while K is scored, and no load waits on a score.
//   - Less in flight is faster here: with 3 or 4 tiles of 22-32 KB
//     outstanding per block from the start (~22 MB on the card) the
//     first tiles of some blocks arrived 6-10 us late and the blocks'
//     ends spread over 7 us; an L2 prefetch of the next tile, or a third
//     tile outstanding near a row's end, also cost time (bf16, 256 rows,
//     on an H100 at 700 W, `python3 -m lookoncetohear_tpu_torch.attn_phases`).
//     The copies alone, without the arithmetic, take within ~0.5 us of
//     the whole kernel: it runs at the rate this pattern streams from
//     HBM (~2.7 TB/s over the call, ~2.8-3.0 in its middle).
//   - Small loads first: q, k_t, v_t, the scales and the ragged K
//     elements are loaded into registers before the first bulk copy is
//     issued; issued after, they waited behind the copies of all blocks.
//   - K in 16-byte copies: a tile's K bytes [cs, ce) land in its buffer
//     at offset (address - floor16(cs)). The copy covers
//     [max(floor16(cs), A0), min(ceil16(ce), A1)), A0/A1 the row span's
//     16-byte-aligned interior, so it never reads outside the row; the
//     ragged head [Kb, A0) and tail [A1, Ke) of the row (< 16 bytes
//     each, any Dk) are held by warp 0's lanes and stored into the
//     buffer of the tile they belong to (place_edges).
//     ops/attn_step.py::k_tile_copies mirrors this for the CPU tests.
//   - Pass 1: scores from shared memory, up to four rows a warp at once
//     sharing the loads of q (float32 in shared memory), in element
//     pairs when Dk is even (every K row is then 2-element aligned); the
//     current frame's score from the prologue's partial sums. One warp
//     takes the softmax over the W1 + 1 scores once; the slots' weights
//     take their V scales.
//   - Pass 2: a thread owns up to two granules of 16 bytes of V (8 bytes
//     for int8, converted by byte permute instead of the quarter-rate
//     I2F unit), granule t and t + 256 of its block's columns, and adds
//     each V tile's weighted rows from shared memory: no exp in the
//     value loop. (An online softmax over tiles of K and V together,
//     tried first, spent an exp per slot and thread and was
//     compute-bound: 31.8 us bf16.)
// No fast-math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGranules = 2;              // V granules per thread
constexpr int kTileBytes = 24 * 1024;     // K or V bytes a tile aims at
constexpr int kMaxStages = 3;
constexpr int kBarBytes = 64;             // kMaxStages mbarriers
constexpr int kPre = 4;                   // q, k_t values a thread prefetches
// dynamic shared memory a block may take (opt-in above 48 KB)
constexpr int kMaxSmem = 232448;
constexpr int kDefaultSmem = 48 * 1024;

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// elements of S in one V granule: 16 bytes, 8 bytes for int8
template <typename S> __host__ __device__ constexpr int granule() {
  return sizeof(S) == 1 ? 8 : 16 / (int)sizeof(S);
}

// How a launch cuts its rows; ops/attn_step.py::attn_step_plan mirrors
// it.
struct Plan {
  int cols;     // V columns a block takes (the last block fewer)
  int col_blocks;
  int kslots;   // slots a K tile
  int ktiles;
  int vslots;   // slots a V tile
  int vtiles;
  int stages;   // shared-memory buffers
  int cap;      // bytes of a buffer
  int smem;     // dynamic shared memory of a block
};

// slots per tile when a slot takes `bytes`: tiles of about kTileBytes,
// the slots spread evenly over them
void tile(int W1, long bytes, int* slots, int* tiles) {
  long most = kTileBytes / (bytes > 0 ? bytes : 1);
  most = most < 1 ? 1 : most;
  *tiles = W1 > 0 ? (int)((W1 + most - 1) / most) : 0;
  *slots = *tiles > 0 ? (W1 + *tiles - 1) / *tiles : 1;
}

Plan make_plan(int W1, int Dk, int Dv, int es, int gran, bool scaled) {
  Plan p{};
  const int cols_max = kGranules * kThreads * gran;
  p.col_blocks = Dv > cols_max ? (Dv + cols_max - 1) / cols_max : 1;
  p.cols = Dv < cols_max ? Dv : cols_max;
  tile(W1, (long)Dk * es, &p.kslots, &p.ktiles);
  tile(W1, (long)p.cols * es, &p.vslots, &p.vtiles);
  const int kcap = round16(p.kslots * Dk * es) + 32;
  const int vcap = p.vslots * p.cols * es;
  p.cap = kcap > vcap ? kcap : vcap;
  const int fixed = kBarBytes + round16(4 * (W1 + 1)) + round16(4 * Dk) +
                    4 * p.cols + 4 * kWarps +
                    (scaled ? 2 * round16(4 * W1) : 0);
  const int tiles = p.ktiles + p.vtiles;
  const int fit = (kMaxSmem - fixed) / p.cap;
  int st = tiles < kMaxStages ? tiles : kMaxStages;
  st = st < fit ? st : fit;
  p.stages = st < 1 ? 1 : st;
  p.smem = fixed + p.stages * p.cap;
  return p;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// int8 to float without the conversion unit: the byte xor 0x80 under
// the exponent of 2^23 is the float 2^23 + 128 + b exactly.
constexpr float kMagic = 8388736.0f;   // 2^23 + 128
__device__ __forceinline__ float byte_to_f32(unsigned u) {   // u = b & 0xff
  return __int_as_float((u ^ 0x80u) | 0x4b000000u) - kMagic;
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return byte_to_f32((unsigned char)x);
}
// acc[k] += w * (the k-th int8 of `word`), k = 0..3 (little endian)
__device__ __forceinline__ void fma_int8x4(float* acc, float w, int word) {
  const unsigned x = (unsigned)word ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    acc[k] = fmaf(w, __int_as_float(__byte_perm(x, 0x4b000000u,
                                                0x7540 + k)) - kMagic,
                  acc[k]);
}

// acc[k] += w * (element k of the V granule at p), k < granule<S>()
__device__ __forceinline__ void fma_granule(float* acc, float w,
                                            const float* p) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  acc[0] = fmaf(w, r.x, acc[0]);
  acc[1] = fmaf(w, r.y, acc[1]);
  acc[2] = fmaf(w, r.z, acc[2]);
  acc[3] = fmaf(w, r.w, acc[3]);
}
__device__ __forceinline__ void fma_granule(float* acc, float w,
                                            const __nv_bfloat16* p) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc[2 * k] = fmaf(w, __uint_as_float(u[k] << 16), acc[2 * k]);
    acc[2 * k + 1] =
        fmaf(w, __uint_as_float(u[k] & 0xffff0000u), acc[2 * k + 1]);
  }
}
__device__ __forceinline__ void fma_granule(float* acc, float w,
                                            const int8_t* p) {
  const int2 r = *reinterpret_cast<const int2*>(p);
  fma_int8x4(acc, w, r.x);
  fma_int8x4(acc + 4, w, r.y);
}

// n (a multiple of 4) values of type T at p, 16-byte aligned, as float32
__device__ __forceinline__ void load_f32(float* d, const float* p, int n) {
  for (int k = 0; k < n; k += 4) {
    const float4 r = *reinterpret_cast<const float4*>(p + k);
    d[k] = r.x; d[k + 1] = r.y; d[k + 2] = r.z; d[k + 3] = r.w;
  }
}
__device__ __forceinline__ void load_f32(float* d, const __nv_bfloat16* p,
                                         int n) {
  for (int k = 0; k < n; k += 8) {
    const uint4 r = *reinterpret_cast<const uint4*>(p + k);
    const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      d[k + 2 * i] = __uint_as_float(u[i] << 16);
      d[k + 2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}
__device__ __forceinline__ void store_f32(float* p, const float* s, int n) {
  for (int k = 0; k < n; k += 4)
    *reinterpret_cast<float4*>(p + k) =
        make_float4(s[k], s[k + 1], s[k + 2], s[k + 3]);
}
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, const float* s,
                                          int n) {
  for (int k = 0; k < n; k += 8) {
    unsigned u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h =
          __floats2bfloat162_rn(s[k + 2 * i], s[k + 2 * i + 1]);
      u[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p + k) = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Elements 2i and 2i + 1 of a row in shared memory as float32; the row
// is 2-element aligned
__device__ __forceinline__ float2 load_pair(const float* row, int i) {
  return reinterpret_cast<const float2*>(row)[i];
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* row, int i) {
  const unsigned u = reinterpret_cast<const unsigned*>(row)[i];
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float2 load_pair(const int8_t* row, int i) {
  const unsigned u = reinterpret_cast<const unsigned short*>(row)[i];
  return make_float2(byte_to_f32(u & 0xffu), byte_to_f32(u >> 8));
}

// This lane's parts of q . r[u], u < N, over elements lane, lane + 32,
// ... (element pairs when kPair: Dk even, rows 2-element aligned); the
// rows share the loads of q
template <int N, bool kPair, typename S>
__device__ __forceinline__ void dot_rows(const S* const* r, const float* qs,
                                         int Dk, int lane, float* acc) {
#pragma unroll
  for (int u = 0; u < N; ++u) acc[u] = 0.0f;
  if (kPair) {
#pragma unroll 2
    for (int i = lane; i < Dk / 2; i += 32) {
      const float2 qv = reinterpret_cast<const float2*>(qs)[i];
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const float2 k = load_pair(r[u], i);
        acc[u] = fmaf(qv.y, k.y, fmaf(qv.x, k.x, acc[u]));
      }
    }
  } else {
#pragma unroll 2
    for (int i = lane; i < Dk; i += 32) {
      const float qi = qs[i];
#pragma unroll
      for (int u = 0; u < N; ++u) acc[u] = fmaf(qi, to_f32(r[u][i]), acc[u]);
    }
  }
}

// scores of the tile's rows jj, jj + kWarps, ... (n_mine of them, at
// most 4) into sc[j0 + row]: warp sums, k scale, 1/sqrt(Dk)
template <int N, bool kPair, typename S>
__device__ __forceinline__ void score_rows(const unsigned char* rows,
                                           size_t row_bytes, int jj, int j0,
                                           const float* qs, int Dk, int lane,
                                           const float* ksc, float inv,
                                           float* sc) {
  const S* r[N];
#pragma unroll
  for (int u = 0; u < N; ++u)
    r[u] = reinterpret_cast<const S*>(rows + (jj + u * kWarps) * row_bytes);
  float acc[N];
  dot_rows<N, kPair>(r, qs, Dk, lane, acc);
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const float x = warp_sum(acc[u]);
    const int j = j0 + jj + u * kWarps;
    if (lane == 0) sc[j] = (ksc != nullptr ? x * ksc[j] : x) * inv;
  }
}

template <bool kPair, typename S>
__device__ __forceinline__ void score_tile(const unsigned char* rows,
                                           size_t row_bytes, int n, int j0,
                                           int warp, const float* qs,
                                           int Dk, int lane, const float* ksc,
                                           float inv, float* sc) {
  for (int jj = warp; jj < n; jj += 4 * kWarps) {
    const int mine = (n - jj + kWarps - 1) / kWarps;
    if (mine >= 4)
      score_rows<4, kPair, S>(rows, row_bytes, jj, j0, qs, Dk, lane, ksc,
                              inv, sc);
    else if (mine == 3)
      score_rows<3, kPair, S>(rows, row_bytes, jj, j0, qs, Dk, lane, ksc,
                              inv, sc);
    else if (mine == 2)
      score_rows<2, kPair, S>(rows, row_bytes, jj, j0, qs, Dk, lane, ksc,
                              inv, sc);
    else
      score_rows<1, kPair, S>(rows, row_bytes, jj, j0, qs, Dk, lane, ksc,
                              inv, sc);
  }
}

// ---- mbarriers and bulk copies (PTX)
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// bytes (a multiple of 16) from 16-byte aligned global src to dst
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads, 2)
attn_step_kernel(const T* __restrict__ q, const T* __restrict__ kt,
                 const T* __restrict__ vt, const S* __restrict__ k_buf,
                 const S* __restrict__ v_buf,
                 const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale, T* __restrict__ out,
                 int W1, int Dk, int Dv, float inv, Plan p) {
  constexpr int es = sizeof(S);
  constexpr int kG = granule<S>();
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stage0 = smem + kBarBytes;
  // [W1 + 1] scores (the current frame's last), then value weights
  float* sc = reinterpret_cast<float*>(stage0 + p.stages * p.cap);
  float* qs = sc + round16(4 * (W1 + 1)) / 4;    // [Dk] q, float32
  float* vts = qs + round16(4 * Dk) / 4;         // [cols] v_t, float32
  float* red = vts + p.cols;                     // [kWarps] partial sums
  float* ksc = red + kWarps;                     // [W1] k_scale (int8)
  float* vsc = ksc + round16(4 * W1) / 4;        // [W1] v_scale (int8)
  __shared__ float p_cur, den_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool scaled = k_scale != nullptr;
  const int tiles = p.ktiles + p.vtiles;

  // the row's K span [kb, ke) and its 16-byte-aligned interior [a0, a1)
  const size_t row_bytes = (size_t)Dk * es;
  const uintptr_t kb = reinterpret_cast<uintptr_t>(k_buf + (size_t)b * W1 * Dk);
  const uintptr_t ke = kb + (size_t)W1 * row_bytes;
  const uintptr_t a0 = (kb + 15) & ~(uintptr_t)15;
  const uintptr_t a1 = ke & ~(uintptr_t)15;
  const uintptr_t head_end = ke < a0 ? ke : a0;
  const uintptr_t tail_beg = a1 > head_end ? a1 : head_end;
  // this block's V columns [c0, c0 + cols)
  const int c0 = blockIdx.y * (kGranules * kThreads * kG);
  const int cols = Dv - c0 < p.cols ? Dv - c0 : p.cols;
  const S* vrow0 = v_buf + (size_t)b * W1 * Dv + c0;

  // ---- small loads first: in the queue ahead of the bulk copies
  const T* qr = q + (size_t)b * Dk;
  const T* ktr = kt + (size_t)b * Dk;
  float qv[kPre], kv[kPre];
#pragma unroll
  for (int u = 0; u < kPre; ++u) {
    const int i = tid + u * kThreads;
    qv[u] = i < Dk ? to_f32(qr[i]) : 0.0f;
    kv[u] = i < Dk ? to_f32(ktr[i]) : 0.0f;
  }
  const T* vtr = vt + (size_t)b * Dv + c0;
  float vtv[kGranules][kG];
#pragma unroll
  for (int g = 0; g < kGranules; ++g) {
    const int col = (tid + g * kThreads) * kG;
    if (col < cols) load_f32(vtv[g], vtr + col, kG);
  }
  const bool pre_scale = scaled && tid < W1;
  const float ks0 = pre_scale ? k_scale[(size_t)b * W1 + tid] : 0.0f;
  const float vs0 = pre_scale ? v_scale[(size_t)b * W1 + tid] : 0.0f;
  // warp 0 lane l < 16 holds element l of the ragged head, lane 16 + l
  // element l of the ragged tail (edge_at 0: none)
  S edge{};
  uintptr_t edge_at = 0;
  if (warp == 0) {
    const uintptr_t a = lane < 16 ? kb + (uintptr_t)lane * es
                                  : tail_beg + (uintptr_t)(lane - 16) * es;
    if (a < (lane < 16 ? head_end : ke)) {
      edge = *reinterpret_cast<const S*>(a);
      edge_at = a;
    }
  }

  // warp 0: ask for tile t in buffer t % stages (lane 0 the copies):
  // tiles < ktiles hold K slots, the others V slots
  auto issue = [&](int t) {
    const int s = t % p.stages;
    unsigned char* buf = stage0 + s * p.cap;
    if (t < p.ktiles) {
      const int j0 = t * p.kslots;
      const int n = W1 - j0 < p.kslots ? W1 - j0 : p.kslots;
      const uintptr_t cs = kb + (size_t)j0 * row_bytes;
      const uintptr_t ce = cs + (size_t)n * row_bytes;
      const uintptr_t base = cs & ~(uintptr_t)15;
      const uintptr_t lo = base > a0 ? base : a0;
      const uintptr_t ce16 = (ce + 15) & ~(uintptr_t)15;
      const uintptr_t hi = ce16 < a1 ? ce16 : a1;
      const unsigned bytes = hi > lo ? (unsigned)(hi - lo) : 0u;
      if (lane == 0) {
        bar_expect(&bar[s], bytes);
        if (bytes)
          bulk_copy(buf + (lo - base), reinterpret_cast<const void*>(lo),
                    bytes, &bar[s]);
      }
    } else {
      const int j0 = (t - p.ktiles) * p.vslots;
      const int n = W1 - j0 < p.vslots ? W1 - j0 : p.vslots;
      const unsigned vrow = (unsigned)(cols * es);
      if (lane == 0) {
        bar_expect(&bar[s], (unsigned)n * vrow);
        if (cols == Dv)
          bulk_copy(buf, vrow0 + (size_t)j0 * Dv, (unsigned)n * vrow,
                    &bar[s]);
      }
      if (cols != Dv) {
        __syncwarp();
        for (int jj = lane; jj < n; jj += 32)
          bulk_copy(buf + (size_t)jj * vrow, vrow0 + (size_t)(j0 + jj) * Dv,
                    vrow, &bar[s]);
      }
    }
  };
  // warp 0: the ragged K elements of tile t into its buffer
  auto place_edges = [&](int t) {
    if (t >= p.ktiles) return;
    const int j0 = t * p.kslots;
    const int n = W1 - j0 < p.kslots ? W1 - j0 : p.kslots;
    const uintptr_t cs = kb + (size_t)j0 * row_bytes;
    const uintptr_t ce = cs + (size_t)n * row_bytes;
    if (edge_at >= cs && edge_at < ce)
      *reinterpret_cast<S*>(stage0 + (t % p.stages) * p.cap +
                            (edge_at - (cs & ~(uintptr_t)15))) = edge;
  };

  // Tiles in flight: the first `first` at the start; then, as tile t
  // arrives, tile t + stages - 1 into the buffer that tile t - 1 left
  // (consumed before the barrier that ended it). So a block keeps at
  // most stages - 1 copies outstanding, and that many while it
  // computes.
  const int first = p.stages > 1 ? p.stages - 1 : 1;
  auto refill = [&](int t) {
    const int n = t + p.stages - 1;
    if (n >= first && n < tiles) {
      issue(n);
      place_edges(n);
    }
  };

  if (warp == 0) {
    if (lane == 0) {
      for (int s = 0; s < p.stages; ++s) bar_init(&bar[s]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    for (int t = 0; t < first && t < tiles; ++t) issue(t);
    for (int t = 0; t < first && t < tiles; ++t) place_edges(t);
  }

  // ---- q into shared memory, the current frame's score
  float part = 0.0f;
#pragma unroll
  for (int u = 0; u < kPre; ++u) {
    const int i = tid + u * kThreads;
    if (i < Dk) qs[i] = qv[u];
    part = fmaf(qv[u], kv[u], part);
  }
  for (int i = tid + kPre * kThreads; i < Dk; i += kThreads) {
    const float x = to_f32(qr[i]);
    qs[i] = x;
    part = fmaf(x, to_f32(ktr[i]), part);
  }
  if (scaled) {
    if (pre_scale) {
      ksc[tid] = ks0;
      vsc[tid] = vs0;
    }
    for (int j = tid + kThreads; j < W1; j += kThreads) {
      ksc[j] = k_scale[(size_t)b * W1 + j];
      vsc[j] = v_scale[(size_t)b * W1 + j];
    }
  }
  part = warp_sum(part);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (tid == 0) {
    float s_cur = 0.0f;
    for (int w = 0; w < kWarps; ++w) s_cur += red[w];
    sc[W1] = s_cur * inv;
  }

  // ---- pass 1: scores, K tile by K tile; a warp takes rows jj, jj + 8,
  // ..., up to four at once
  for (int t = 0; t < p.ktiles; ++t) {
    const int s = t % p.stages;
    const unsigned char* buf = stage0 + s * p.cap;
    const int j0 = t * p.kslots;
    const int n = W1 - j0 < p.kslots ? W1 - j0 : p.kslots;
    const unsigned char* rows =
        buf + ((kb + (size_t)j0 * row_bytes) & 15);
    bar_wait(&bar[s], (unsigned)(t / p.stages) & 1u);
    if (warp == 0) refill(t);
    if (Dk % 2 == 0)
      score_tile<true, S>(rows, row_bytes, n, j0, warp, qs, Dk, lane,
                          scaled ? ksc : nullptr, inv, sc);
    else
      score_tile<false, S>(rows, row_bytes, n, j0, warp, qs, Dk, lane,
                           scaled ? ksc : nullptr, inv, sc);
    __syncthreads();
  }
#pragma unroll
  for (int g = 0; g < kGranules; ++g) {
    const int col = (tid + g * kThreads) * kG;
    if (col < cols)
#pragma unroll
      for (int k = 0; k < kG; ++k) vts[col + k] = vtv[g][k];
  }

  // ---- softmax over the W1 + 1 scores, one warp; the ring slots'
  // weights take their V scales
  if (warp == 0) {
    float m = -INFINITY;
    for (int j = lane; j <= W1; j += 32) m = fmaxf(m, sc[j]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float den = 0.0f;
    for (int j = lane; j <= W1; j += 32) {
      const float e = expf(sc[j] - m);
      den += e;
      if (j < W1)
        sc[j] = scaled ? e * vsc[j] : e;
      else
        p_cur = e;
    }
    den = warp_sum(den);
    if (lane == 0) den_s = den;
  }
  __syncthreads();

  // ---- pass 2: values, V tile by V tile; a thread owns granules
  // tid and tid + kThreads of the block's columns
  const int col0 = tid * kG, col1 = (tid + kThreads) * kG;
  float acc0[kG], acc1[kG];
#pragma unroll
  for (int k = 0; k < kG; ++k) acc0[k] = acc1[k] = 0.0f;
  for (int t = p.ktiles; t < tiles; ++t) {
    const int s = t % p.stages;
    const S* vs = reinterpret_cast<const S*>(stage0 + s * p.cap);
    const int j0 = (t - p.ktiles) * p.vslots;
    const int n = W1 - j0 < p.vslots ? W1 - j0 : p.vslots;
    const float* w = sc + j0;
    bar_wait(&bar[s], (unsigned)(t / p.stages) & 1u);
    if (warp == 0) refill(t);
    if (col0 < cols) {
#pragma unroll 4
      for (int jj = 0; jj < n; ++jj)
        fma_granule(acc0, w[jj], vs + (size_t)jj * cols + col0);
    }
    if (col1 < cols) {
#pragma unroll 4
      for (int jj = 0; jj < n; ++jj)
        fma_granule(acc1, w[jj], vs + (size_t)jj * cols + col1);
    }
    __syncthreads();
  }

  T* o = out + (size_t)b * Dv + c0;
  const float pc = p_cur, den = den_s;
  if (col0 < cols) {
    float r[kG];
#pragma unroll
    for (int k = 0; k < kG; ++k) r[k] = fmaf(pc, vts[col0 + k], acc0[k]) / den;
    store_f32(o + col0, r, kG);
  }
  if (col1 < cols) {
    float r[kG];
#pragma unroll
    for (int k = 0; k < kG; ++k) r[k] = fmaf(pc, vts[col1 + k], acc1[k]) / den;
    store_f32(o + col1, r, kG);
  }
}

// Lets attn_step_kernel<T, S> take `smem` bytes of dynamic shared
// memory on the current device; the attribute is set again only when a
// launch needs more than that device was last granted.
constexpr int kMaxDevices = 16;

template <typename T, typename S>
cudaError_t reserve_smem(int smem) {
  static std::atomic<int> granted[kMaxDevices];
  if (smem <= kDefaultSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && granted[dev].load() >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(attn_step_kernel<T, S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && dev < kMaxDevices) granted[dev].store(smem);
  return err;
}

template <typename T, typename S>
int launch(const void* q, const void* kt, const void* vt, const void* k_buf,
           const void* v_buf, const void* k_scale, const void* v_scale,
           void* out, int B, int W1, int Dk, int Dv, float inv,
           void* stream) {
  const bool scaled = k_scale != nullptr;
  // V rows go by 16-byte bulk copies, V granules of granule<S>()
  if (Dk < 1 || W1 < 0 || ((size_t)Dv * sizeof(S)) % 16 != 0 ||
      Dv % granule<S>() != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Dv == 0) return 0;
  const Plan p = make_plan(W1, Dk, Dv, (int)sizeof(S), granule<S>(), scaled);
  if (p.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = reserve_smem<T, S>(p.smem);
  if (err != cudaSuccess) return (int)err;
  attn_step_kernel<T, S><<<dim3(B, p.col_blocks), kThreads, p.smem,
                           (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kt),
      static_cast<const T*>(vt), static_cast<const S*>(k_buf),
      static_cast<const S*>(v_buf), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<T*>(out), W1, Dk, Dv,
      inv, p);
  return (int)cudaGetLastError();
}

}  // namespace

#define ATTN_STEP_ENTRY(name, T, S)                                          \
  extern "C" int name(const void* q, const void* kt, const void* vt,         \
                      const void* k_buf, const void* v_buf,                  \
                      const void* k_scale, const void* v_scale, void* out,   \
                      int B, int W1, int Dk, int Dv, float inv,              \
                      void* stream) {                                        \
    return launch<T, S>(q, kt, vt, k_buf, v_buf, k_scale, v_scale, out, B,   \
                        W1, Dk, Dv, inv, stream);                            \
  }

ATTN_STEP_ENTRY(attn_step_f32, float, float)
ATTN_STEP_ENTRY(attn_step_bf16, __nv_bfloat16, __nv_bfloat16)
ATTN_STEP_ENTRY(attn_step_f32_bf16kv, float, __nv_bfloat16)
ATTN_STEP_ENTRY(attn_step_f32_int8kv, float, int8_t)
ATTN_STEP_ENTRY(attn_step_bf16_int8kv, __nv_bfloat16, int8_t)
