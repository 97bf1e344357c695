// Segmented row LayerNorm: the streaming step's flat LayerNorms.
//
// Replaces no Pallas kernel. The JAX package computes these norms with
// XLA in their "MXU-dot" form (lookoncetohear_tpu/ops/norms.py ::
// flat_head_layer_norm, flat_layer_norm): each (row, head) mean and
// mean square is a float32 product with a 0/1 segment matrix [D, nh],
// broadcast back by two more products of depth nh, around a chain of
// elementwise ops. That suits a TPU's matrix unit. On the H100 it is
// 36 thin GEMMs and ~300 small launches a flagship step, ~0.6 ms of
// the card's ~2 ms. This kernel does one norm's statistics,
// normalisation, affine and cast in one pass, and up to kMaxDescs norms
// in one launch.
//
// Contract, per norm (a descriptor): the input is `rows` rows of
// `groups` groups of `segs` segments of `width` elements, element
// (r, g, s, w) at x[r * row_stride + g * group_stride + s * width + w]
// (x already points at the view's first column). Each (row, segment)
// is normalised over its groups * width elements:
//   v    = x, or PReLU(x) = (x >= 0 ? x : T(alpha * x)) when `alpha`
//          is given (the projection's PReLU, its one slope, rounded to
//          T as the eager op rounds it);
//   mu   = sum(v) / n, m2 = sum(v * v) / n, in float32, n = groups *
//          width;
//   inv  = rsqrt(max(m2 - mu * mu, 0) + eps);
//   out  = T((v - mu) * inv * scale[g * width + w] + bias[...]),
// the plain version's one-pass form (ops/norms.py), each product and
// sum rounded on its own (no contraction into an fma), so only the
// order of the two sums differs. The affine [groups * width] is shared
// by the segments, as the heads share the Q/K/V norms' [F * dim]
// affine. The output is contiguous in the flat (g, s, w) layout:
// out[r * groups * segs * width + g * segs * width + s * width + w].
// Head norm of a fused Q/K/V projection y [B, F, C]: groups = F, segs
// = nh, width = dim, row_stride = F * C, group_stride = C, x = y plus
// the block's column offset. Whole-row norm [R, D]: groups = segs = 1,
// width = D. T is float or __nv_bfloat16 (scale, bias and alpha in T).
//
// What bounds it on the H100: launches, then bytes. A flagship step
// (64 streams, bf16) reads and writes ~23 MB through these norms,
// mostly from L2: ~7 us at 3.35 TB/s, spread over 12 launches (three
// blocks of: the Q/K/V norms in one launch, the intra, inter and
// attention-output row norms). Each launch is a few microseconds of
// latency, not of bandwidth.
//
// Design: the work is a grid of segments, not of products.
//   - A team of `team` threads (a power of two, the wrapper's choice,
//     ops/norms.py::flat_norm_desc) owns one segment; a CTA of kThreads
//     holds kThreads / team teams. The team reads its segment in
//     `vec`-element loads (16 bytes where the strides and offset allow:
//     8 bf16 or 4 float; the flagship's Q/K heads of 6 take 2), each
//     thread at most kValues / vec of them, so the segment stays in
//     registers between the sums and the write and is read once.
//   - The wrapper picks the smallest team whose threads take at most
//     two loads, up to a whole CTA: every load of a step is in flight at
//     once, and a segment of 64 takes one 16-byte load a thread.
//   - Sums: shuffles within the team (xor butterflies, so every lane
//     holds the same bits), then, for a team wider than a warp, the
//     warps' partials in shared memory, added in warp order. The order
//     is fixed, so a launch is deterministic and a graph replay gives
//     the eager step's bits.
//   - Several norms in one launch: the descriptors' CTAs follow each
//     other in the grid, and a CTA finds its descriptor by its index.
//     The Q/K/V norms of a block read the one fused projection where it
//     lies: no slice copies, no expanded affine, no separate PReLU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kValues = 32;        // float32 values a thread keeps
constexpr int kMaxDescs = 3;       // norms in one launch
constexpr int kMaxVecBytes = 16;   // the widest load
constexpr int kPtrs = 5;           // x, out, scale, bias, alpha
constexpr int kDims = 8;           // rows .. team, as struct Desc

struct Desc {
  const void* x;
  void* out;
  const void* scale;
  const void* bias;
  const void* alpha;               // nullptr: no PReLU
  int rows, groups, segs, width;
  int row_stride, group_stride;    // in elements
  int vec, team;
  int first_block;                 // this norm's first CTA
  float eps;
};

struct Launch {
  Desc d[kMaxDescs];
  int n;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// the sum over each aligned group of `team` lanes (a power of two up to
// 32); every lane of the group gets the same bits
__device__ __forceinline__ float team_sum(float v, int team) {
  for (int o = team >> 1; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One CTA's teams of norm `d`, `blk` its CTA index within the norm.
// Every thread of the CTA runs this to its end (the shuffles and the
// barrier need them all); a team past the last segment loads nothing.
template <typename T, int V>
__device__ __forceinline__ void norm_block(const Desc& d, int blk) {
  constexpr int kVecs = kValues / V;
  __shared__ float2 part[kWarps];
  const int team = d.team;
  const int seg = blk * (kThreads / team) + threadIdx.x / team;
  const int t = threadIdx.x & (team - 1);
  const int S = d.segs, W = d.width, G = d.groups;
  const bool active = seg < d.rows * S;
  const int r = active ? seg / S : 0, s = seg - r * S;
  const int wv = W / V;            // loads in a group's part of a segment
  const int nvec = G * wv;
  const T* x = static_cast<const T*>(d.x) +
               (long long)r * d.row_stride + s * W;
  T* out = static_cast<T*>(d.out) + (long long)r * G * S * W + s * W;
  const T* sc = static_cast<const T*>(d.scale);
  const T* bi = static_cast<const T*>(d.bias);
  const bool prelu = d.alpha != nullptr;
  const float alpha = prelu ? to_f32(*static_cast<const T*>(d.alpha)) : 0.f;

  float v[kVecs][V];
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int j = i * team + t;
    if (!active || j >= nvec) break;
    const int g = j / wv, c = (j - g * wv) * V;
    const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(
        x + (long long)g * d.group_stride + c);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float a = to_f32(p.v[k]);
      if (prelu && !(a >= 0.f)) a = to_f32(from_f32<T>(__fmul_rn(alpha, a)));
      v[i][k] = a;
      sum = __fadd_rn(sum, a);
      sq = __fadd_rn(sq, __fmul_rn(a, a));
    }
  }
  if (team <= 32) {
    sum = team_sum(sum, team);
    sq = team_sum(sq, team);
  } else {
    sum = team_sum(sum, 32);
    sq = team_sum(sq, 32);
    const int warp = threadIdx.x / 32;
    if ((threadIdx.x & 31) == 0) part[warp] = make_float2(sum, sq);
    __syncthreads();
    const int first = (threadIdx.x / team) * (team / 32);
    sum = 0.f;
    sq = 0.f;
    for (int w = 0; w < team / 32; ++w) {
      sum = __fadd_rn(sum, part[first + w].x);
      sq = __fadd_rn(sq, part[first + w].y);
    }
  }
  const float n = (float)(G * W);
  const float mu = sum / n, m2 = sq / n;
  float var = __fsub_rn(m2, __fmul_rn(mu, mu));
  var = var < 0.f ? 0.f : var;     // clamp(min=0), NaN kept
  const float inv = rsqrtf(__fadd_rn(var, d.eps));
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int j = i * team + t;
    if (!active || j >= nvec) break;
    const int g = j / wv, c = (j - g * wv) * V;
    // the affine index g * W + c is j * V
    const Pack<T, V> ps = *reinterpret_cast<const Pack<T, V>*>(sc + j * V);
    const Pack<T, V> pb = *reinterpret_cast<const Pack<T, V>*>(bi + j * V);
    Pack<T, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xn = __fmul_rn(__fsub_rn(v[i][k], mu), inv);
      o.v[k] = from_f32<T>(
          __fadd_rn(__fmul_rn(xn, to_f32(ps.v[k])), to_f32(pb.v[k])));
    }
    *reinterpret_cast<Pack<T, V>*>(out + (long long)g * S * W + c) = o;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flat_norm_kernel(const Launch l) {
  // constant indices only: a dynamic index into the parameters would
  // copy them to local memory
  Desc d = l.d[0];
  if (l.n > 1 && (int)blockIdx.x >= l.d[1].first_block) d = l.d[1];
  if (l.n > 2 && (int)blockIdx.x >= l.d[2].first_block) d = l.d[2];
  const int blk = blockIdx.x - d.first_block;
  switch (d.vec) {
    case 1: norm_block<T, 1>(d, blk); break;
    case 2: norm_block<T, 2>(d, blk); break;
    case 4: norm_block<T, 4>(d, blk); break;
    default:
      if constexpr (8 * sizeof(T) <= kMaxVecBytes) norm_block<T, 8>(d, blk);
      break;
  }
}

bool valid(const Desc& d, int elem) {
  const bool pow2_vec = d.vec == 1 || d.vec == 2 || d.vec == 4 || d.vec == 8;
  const bool pow2_team = d.team >= 1 && d.team <= kThreads &&
                         (d.team & (d.team - 1)) == 0;
  if (!pow2_vec || !pow2_team || d.vec * elem > kMaxVecBytes) return false;
  if (d.rows < 1 || d.groups < 1 || d.segs < 1 || d.width < 1) return false;
  if (d.width % d.vec || d.row_stride % d.vec || d.group_stride % d.vec)
    return false;
  const int nvec = d.groups * d.width / d.vec;
  return (nvec + d.team - 1) / d.team <= kValues / d.vec;
}

// ptrs: n x kPtrs, dims: n x kDims (rows, groups, segs, width,
// row_stride, group_stride, vec, team), eps: n
template <typename T>
int launch(const void* const* ptrs, const int* dims, const float* eps,
           int n, void* stream) {
  if (n < 1 || n > kMaxDescs) return (int)cudaErrorInvalidValue;
  Launch l{};
  l.n = n;
  int blocks = 0;
  for (int i = 0; i < n; ++i) {
    Desc& d = l.d[i];
    const void* const* p = ptrs + kPtrs * i;
    const int* m = dims + kDims * i;
    d.x = p[0];
    d.out = const_cast<void*>(p[1]);
    d.scale = p[2];
    d.bias = p[3];
    d.alpha = p[4];
    d.rows = m[0];
    d.groups = m[1];
    d.segs = m[2];
    d.width = m[3];
    d.row_stride = m[4];
    d.group_stride = m[5];
    d.vec = m[6];
    d.team = m[7];
    d.eps = eps[i];
    if (!valid(d, (int)sizeof(T))) return (int)cudaErrorInvalidValue;
    d.first_block = blocks;
    const int per_block = kThreads / d.team;
    blocks += (d.rows * d.segs + per_block - 1) / per_block;
  }
  flat_norm_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(l);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flat_norm_f32(const void* const* ptrs, const int* dims,
                             const float* eps, int n, void* stream) {
  return launch<float>(ptrs, dims, eps, n, stream);
}

extern "C" int flat_norm_bf16(const void* const* ptrs, const int* dims,
                              const float* eps, int n, void* stream) {
  return launch<__nv_bfloat16>(ptrs, dims, eps, n, stream);
}
