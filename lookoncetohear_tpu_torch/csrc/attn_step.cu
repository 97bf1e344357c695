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
// at 3.35 TB/s, and does 0.05 GFLOP.
//
// Design: one block of 256 threads per row; all 256 blocks of the
// serving shape are resident at once. q is staged in shared memory as
// float32. Pass 1: one warp per slot (the current frame is slot W1)
// reads the slot's K row in two-element loads: Dk = 582 is even but
// not a multiple of 4, so a K row starts only 2-element aligned
// (2328 B per float32 row, 1164 B bf16, 582 B int8) and wider vector
// loads would be misaligned on odd slots. Pass 2: after one warp takes
// the softmax, each thread owns 16 bytes of V columns (Dv * size is a
// multiple of 16, so every V row is 16-byte aligned) and loops over the
// slots with one 16-byte load per slot, 8 slots' loads in flight. No
// fast-math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlotBatch = 8;
// dynamic shared memory a launch may take without an opt-in attribute
constexpr size_t kMaxSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Elements 2i and 2i+1 of a row as float32; the row is 2-element
// aligned.
__device__ __forceinline__ float2 load_pair(const float* row, int i) {
  return reinterpret_cast<const float2*>(row)[i];
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* row, int i) {
  const unsigned u = reinterpret_cast<const unsigned*>(row)[i];
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float2 load_pair(const int8_t* row, int i) {
  const char2 c = reinterpret_cast<const char2*>(row)[i];
  return make_float2((float)c.x, (float)c.y);
}

// acc[k] += w * (element k of the 16 bytes r), k < 16 / sizeof(S)
template <typename S>
__device__ __forceinline__ void fma16(float* acc, float w, const int4& r);
template <>
__device__ __forceinline__ void fma16<float>(float* acc, float w,
                                             const int4& r) {
  acc[0] = fmaf(w, __int_as_float(r.x), acc[0]);
  acc[1] = fmaf(w, __int_as_float(r.y), acc[1]);
  acc[2] = fmaf(w, __int_as_float(r.z), acc[2]);
  acc[3] = fmaf(w, __int_as_float(r.w), acc[3]);
}
template <>
__device__ __forceinline__ void fma16<__nv_bfloat16>(float* acc, float w,
                                                     const int4& r) {
  const unsigned u[4] = {(unsigned)r.x, (unsigned)r.y, (unsigned)r.z,
                         (unsigned)r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc[2 * k] = fmaf(w, __uint_as_float(u[k] << 16), acc[2 * k]);
    acc[2 * k + 1] =
        fmaf(w, __uint_as_float(u[k] & 0xffff0000u), acc[2 * k + 1]);
  }
}
template <>
__device__ __forceinline__ void fma16<int8_t>(float* acc, float w,
                                              const int4& r) {
  const int u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc[4 * k] = fmaf(w, (float)(signed char)u[k], acc[4 * k]);
    acc[4 * k + 1] = fmaf(w, (float)(signed char)(u[k] >> 8), acc[4 * k + 1]);
    acc[4 * k + 2] =
        fmaf(w, (float)(signed char)(u[k] >> 16), acc[4 * k + 2]);
    acc[4 * k + 3] = fmaf(w, (float)(u[k] >> 24), acc[4 * k + 3]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// This lane's part of q . row over element pairs lane, lane + 32, ...
template <typename R>
__device__ __forceinline__ float dot_part(const R* __restrict__ row,
                                          const float* qs, int pairs,
                                          int lane) {
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 4
  for (int i = lane; i < pairs; i += 32) {
    const float2 k = load_pair(row, i);
    const float2 qv = reinterpret_cast<const float2*>(qs)[i];
    a0 = fmaf(qv.x, k.x, a0);
    a1 = fmaf(qv.y, k.y, a1);
  }
  return a0 + a1;
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
attn_step_kernel(const T* __restrict__ q, const T* __restrict__ kt,
                 const T* __restrict__ vt, const S* __restrict__ k_buf,
                 const S* __restrict__ v_buf,
                 const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale, T* __restrict__ out,
                 int W1, int Dk, int Dv, float inv) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;          // [Dk] q of this row, float32
  float* sc = qs + Dk;       // [W1 + 1] scores, then value weights
  __shared__ float den_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* qr = q + (size_t)b * Dk;
  for (int c = tid; c < Dk; c += kThreads) qs[c] = to_f32(qr[c]);
  __syncthreads();

  // ---- pass 1: scores, one warp per slot; slot W1 is the current
  // frame (its own type T, no scale)
  const int pairs = Dk / 2;
  for (int s = warp; s <= W1; s += kWarps) {
    float acc =
        s < W1 ? dot_part(k_buf + ((size_t)b * W1 + s) * Dk, qs, pairs, lane)
               : dot_part(kt + (size_t)b * Dk, qs, pairs, lane);
    acc = warp_sum(acc);
    if (lane == 0) {
      if (s < W1 && k_scale != nullptr) acc *= k_scale[(size_t)b * W1 + s];
      sc[s] = acc * inv;
    }
  }
  __syncthreads();

  // ---- softmax over the W1 + 1 scores, one warp; the ring slots'
  // weights take their V scales
  if (warp == 0) {
    float m = -INFINITY;
    for (int s = lane; s <= W1; s += 32) m = fmaxf(m, sc[s]);
    m = warp_max(m);
    float den = 0.0f;
    for (int s = lane; s <= W1; s += 32) {
      const float p = expf(sc[s] - m);
      den += p;
      sc[s] = (s < W1 && v_scale != nullptr)
                  ? p * v_scale[(size_t)b * W1 + s]
                  : p;
    }
    den = warp_sum(den);
    if (lane == 0) den_s = den;
  }
  __syncthreads();

  // ---- pass 2: values; thread owns 16 bytes of columns of every slot
  constexpr int kVec = 16 / sizeof(S);
  const int nvec = Dv / kVec;
  const int4* vrows =
      reinterpret_cast<const int4*>(v_buf + (size_t)b * W1 * Dv);
  const float p_cur = sc[W1];
  const float den = den_s;
  for (int c = tid; c < nvec; c += kThreads) {
    float acc[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] = 0.0f;
    for (int s0 = 0; s0 < W1; s0 += kSlotBatch) {
      int4 raw[kSlotBatch];
#pragma unroll
      for (int i = 0; i < kSlotBatch; ++i)
        if (s0 + i < W1) raw[i] = vrows[(size_t)(s0 + i) * nvec + c];
#pragma unroll
      for (int i = 0; i < kSlotBatch; ++i)
        if (s0 + i < W1) fma16<S>(acc, sc[s0 + i], raw[i]);
    }
    const T* vtr = vt + (size_t)b * Dv + (size_t)c * kVec;
    T* o = out + (size_t)b * Dv + (size_t)c * kVec;
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      o[k] = from_f32<T>(fmaf(p_cur, to_f32(vtr[k]), acc[k]) / den);
  }
}

template <typename T, typename S>
int launch(const void* q, const void* kt, const void* vt, const void* k_buf,
           const void* v_buf, const void* k_scale, const void* v_scale,
           void* out, int B, int W1, int Dk, int Dv, float inv,
           void* stream) {
  const size_t smem = (size_t)(Dk + W1 + 1) * sizeof(float);
  if (smem > kMaxSmem || Dk % 2 != 0 || Dv % (16 / sizeof(S)) != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  attn_step_kernel<T, S><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kt),
      static_cast<const T*>(vt), static_cast<const S*>(k_buf),
      static_cast<const S*>(v_buf), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<T*>(out), W1, Dk, Dv,
      inv);
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
