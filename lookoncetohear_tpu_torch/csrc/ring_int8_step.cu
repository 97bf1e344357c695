// Write-first int8 K/V ring attention step, projection-native layout.
//
// Replaces the Pallas TPU kernel
//   lookoncetohear_tpu/ops/pallas_attention.py ::
//   ring_attend_int8_step_pallas (body _ring_v2_step_kernel).
// Contract (per stream row b; columns in flat (f, head, d) order, so
// column c belongs to head (c % (nh*dim)) / dim):
//   1. quantize k_t and v_t per (row, head): scale = max(amax, 1e-12)
//      / 127, q8 = clamp(rint(x / scale), -127, 127) (round half to
//      even, true IEEE division), and write them and their scales into
//      ring slot `pos`;
//   2. score q against every int8 K slot of the head, times the slot's
//      K scale, times 1/sqrt(F*e) (the per-head width); slot `pos` and
//      the padding slots >= w are masked out;
//   3. softmax per head together with the full-precision current-frame
//      score q.k_t; out = (sum_s p_s * vscale_s * V8_s + p_cur * v_t) /
//      den, accumulated in float32 and stored in q's dtype.
// The ring (k_buf, k_scale, v_buf, v_scale) is updated IN PLACE, where
// the JAX kernel donates it (input_output_aliases): only slot `pos` of
// each row is written. `pos` is read from device memory and advanced to
// (pos + 1) % w by a one-thread kernel launched right after the step.
// The ring keeps the JAX package's 56-slot padded layout ([B, WP, D],
// WP = ceil(w/8)*8) so states compare one to one; the TPU-only parts
// of the Pallas kernel (the 8-slot window write, the f32 select, the
// mxu_dot/block_rows/w_chunk knobs) are gone.
//
// What bounds it on the H100: device memory. At the serving shape
// (B=64, Dk=2328, Dv=6208, w=50) a call must read the 49 live int8
// slots of every row, ~27 MB, more than stays in the 50 MB L2 across
// the three blocks of a step, so ~8 us at 3.35 TB/s; the ~0.05 GFLOP
// of arithmetic is negligible.
//
// Design: one block of 512 threads per row, reading each live slot of
// the row once, in order and coalesced. The row's K slots (116 KB at
// the serving shape) are first staged in shared memory with 8-byte
// loads, many in flight, since the scores read them in 6-byte
// segments. The scores run one warp per slot: each lane owns whole (f, head) segments with a stride of 32
// segments, so its head is fixed and three shuffles per slot reduce a
// head. The softmax runs one warp per head. The value sum, 70% of the
// bytes, runs one thread per 16 columns of one head, with one 16-byte
// load per slot and 8 slots' loads in flight: a first version with
// one 4-byte load per slot and thread waited on each load in turn and
// took 145 us at the serving shape. The quantization reads the current
// frame from global memory; q is staged in shared memory. No
// fast-math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeads = kWarps;   // one warp per head in the softmax
constexpr int kSlotBatch = 8;

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

// Sum (or max) over the lanes of a warp that share lane % nh; lanes
// 0..nh-1 end up holding their head's value.
__device__ __forceinline__ float warp_head_sum(float v, int nh) {
  for (int off = 16; off >= nh; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float warp_head_max(float v, int nh) {
  for (int off = 16; off >= nh; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Dynamic shared memory of a block: the w staged K slots (rounded up to
// 16 bytes), then q [Dk], the scores [WP, nh] and the partials
// [kWarps, nh] in float32.
__host__ __device__ inline int kstage_floats(int w, int Dk) {
  return (w * Dk + 15) / 16 * 4;
}
__host__ __device__ inline size_t ring_smem_bytes(int Dk, int WP, int w,
                                                  int nh) {
  return (size_t)(kstage_floats(w, Dk) + Dk + WP * nh + kWarps * nh) *
         sizeof(float);
}

// acc[k] += ws * (the k-th int8 of `word`), k = 0..3 (little endian)
__device__ __forceinline__ void fma_int8x4(float* acc, float ws, int word) {
  acc[0] = fmaf(ws, (float)(signed char)word, acc[0]);
  acc[1] = fmaf(ws, (float)(signed char)(word >> 8), acc[1]);
  acc[2] = fmaf(ws, (float)(signed char)(word >> 16), acc[2]);
  acc[3] = fmaf(ws, (float)(word >> 24), acc[3]);
}

__device__ __forceinline__ int8_t quantize(float x, float scale) {
  float r = rintf(__fdiv_rn(x, scale));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return (int8_t)(int)r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_int8_step_kernel(const T* __restrict__ q, const T* __restrict__ kt,
                      const T* __restrict__ vt, int8_t* __restrict__ k_buf,
                      float* __restrict__ k_scale,
                      int8_t* __restrict__ v_buf,
                      float* __restrict__ v_scale,
                      const int* __restrict__ pos_ptr, T* __restrict__ out,
                      int Dk, int Dv, int WP, int w, int F, int nh,
                      float inv) {
  extern __shared__ __align__(16) float smem[];
  int8_t* kst = reinterpret_cast<int8_t*>(smem);  // [w, Dk] K slots
  float* qs = smem + kstage_floats(w, Dk);  // [Dk] q of this row, f32
  float* s4 = qs + Dk;              // [WP, nh] scores, then weights
  float* red = s4 + WP * nh;        // [kWarps, nh] cross-warp partials
  __shared__ float kscale_s[kMaxHeads], vscale_s[kMaxHeads];
  __shared__ float scur_s[kMaxHeads], ecur_s[kMaxHeads], den_s[kMaxHeads];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int e = Dk / (F * nh);
  const int vd = Dv / (F * nh);
  const int nseg = F * nh;          // (f, head) segments per slot
  const int pos = *pos_ptr;
  const T* qr = q + (size_t)b * Dk;
  const T* ktr = kt + (size_t)b * Dk;
  const T* vtr = vt + (size_t)b * Dv;

  // Stage the row's w K slots in shared memory with 8-byte loads, many
  // in flight; the scores then read them from there. Slot `pos` is
  // staged with its old content and masked.
  {
    const int2* src =
        reinterpret_cast<const int2*>(k_buf + (size_t)b * WP * Dk);
    int2* dst = reinterpret_cast<int2*>(kst);
    const int n8 = w * (Dk / 8);
#pragma unroll 8
    for (int i = tid; i < n8; i += kThreads) dst[i] = src[i];
  }
  for (int c = tid; c < Dk; c += kThreads) qs[c] = to_f32(qr[c]);
  __syncthreads();

  // ---- per-head amax of k_t and v_t, and the current-frame score.
  // Thread tid owns segments tid, tid + kThreads, ...; kThreads % nh
  // == 0, so all of them belong to head tid % nh.
  float kmax = 0.0f, vmax = 0.0f, scur = 0.0f;
  for (int sg = tid; sg < nseg; sg += kThreads) {
    for (int d = 0; d < e; ++d) {
      const float x = to_f32(ktr[sg * e + d]);
      kmax = fmaxf(kmax, fabsf(x));
      scur = fmaf(qs[sg * e + d], x, scur);
    }
    for (int d = 0; d < vd; ++d)
      vmax = fmaxf(vmax, fabsf(to_f32(vtr[sg * vd + d])));
  }
  kmax = warp_head_max(kmax, nh);
  vmax = warp_head_max(vmax, nh);
  scur = warp_head_sum(scur, nh);
  float* red_k = red;
  if (lane < nh) red_k[warp * nh + lane] = kmax;
  __syncthreads();
  if (tid < nh) {
    float m = 0.0f;
    for (int i = 0; i < kWarps; ++i) m = fmaxf(m, red_k[i * nh + tid]);
    kscale_s[tid] = fmaxf(m, 1e-12f) / 127.0f;
  }
  __syncthreads();
  if (lane < nh) red_k[warp * nh + lane] = vmax;
  __syncthreads();
  if (tid < nh) {
    float m = 0.0f;
    for (int i = 0; i < kWarps; ++i) m = fmaxf(m, red_k[i * nh + tid]);
    vscale_s[tid] = fmaxf(m, 1e-12f) / 127.0f;
  }
  __syncthreads();
  if (lane < nh) red_k[warp * nh + lane] = scur;
  __syncthreads();
  if (tid < nh) {
    float s = 0.0f;
    for (int i = 0; i < kWarps; ++i) s += red_k[i * nh + tid];
    scur_s[tid] = s * inv;
    k_scale[((size_t)b * WP + pos) * nh + tid] = kscale_s[tid];
    v_scale[((size_t)b * WP + pos) * nh + tid] = vscale_s[tid];
  }

  // ---- write the quantized current frame into slot `pos`, the only
  // slot of the row this kernel writes. It is masked below: the scores
  // skip it and its value weight is 0.
  {
    int8_t* kw = k_buf + ((size_t)b * WP + pos) * Dk;
    int8_t* vw = v_buf + ((size_t)b * WP + pos) * Dv;
    for (int c = tid; c < Dk; c += kThreads)
      kw[c] = quantize(to_f32(ktr[c]), kscale_s[(c % (nh * e)) / e]);
    for (int c = tid; c < Dv; c += kThreads)
      vw[c] = quantize(to_f32(vtr[c]), vscale_s[(c % (nh * vd)) / vd]);
  }

  // ---- scores: one warp per live slot; lane owns segments lane,
  // lane + 32, ... (head lane % nh).
  for (int s = warp; s < WP; s += kWarps) {
    if (s == pos || s >= w) continue;           // uniform per warp
    const int8_t* kr = kst + (size_t)s * Dk;
    float acc = 0.0f;
    for (int sg = lane; sg < nseg; sg += 32) {
      const int c0 = sg * e;
      for (int d = 0; d < e; ++d)
        acc = fmaf(qs[c0 + d], (float)kr[c0 + d], acc);
    }
    acc = warp_head_sum(acc, nh);
    if (lane < nh)
      s4[s * nh + lane] = acc * k_scale[((size_t)b * WP + s) * nh + lane]
                          * inv;
  }
  __syncthreads();

  // ---- softmax per head over the live slots + the current frame, one
  // warp per head; s4 becomes the value weights p_s * vscale_s (0 on
  // slot `pos` and on the padding slots).
  if (warp < nh) {
    const int h = warp;
    float m = scur_s[h];
    for (int s = lane; s < w; s += 32)
      if (s != pos) m = fmaxf(m, s4[s * nh + h]);
    m = warp_head_max(m, 1);
    float den = 0.0f;
    for (int s = lane; s < WP; s += 32) {
      float p = 0.0f;
      if (s != pos && s < w) {
        p = expf(s4[s * nh + h] - m);
        den += p;
      }
      s4[s * nh + h] = p * v_scale[((size_t)b * WP + s) * nh + h];
    }
    den = warp_head_sum(den, 1);
    if (lane == 0) {
      const float ec = expf(scur_s[h] - m);
      ecur_s[h] = ec;
      den_s[h] = den + ec;
    }
  }
  __syncthreads();

  // ---- values: one thread per 16 columns, which share one head
  // (vd % 16 == 0); one 16-byte load per slot, kSlotBatch slots' loads
  // issued before their FMAs so that many are in flight. Slot `pos`
  // (written above, before a barrier) has weight 0.
  const int dv16 = Dv / 16;
  for (int c16 = tid; c16 < dv16; c16 += kThreads) {
    const int c = c16 * 16;
    const int h = (c % (nh * vd)) / vd;
    float acc[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] = 0.0f;
    const int4* vcol =
        reinterpret_cast<const int4*>(v_buf + (size_t)b * WP * Dv + c);
    for (int s0 = 0; s0 < w; s0 += kSlotBatch) {
      int4 raw[kSlotBatch];
#pragma unroll
      for (int i = 0; i < kSlotBatch; ++i)
        if (s0 + i < w) raw[i] = vcol[(size_t)(s0 + i) * dv16];
#pragma unroll
      for (int i = 0; i < kSlotBatch; ++i) {
        if (s0 + i < w) {
          const float ws = s4[(s0 + i) * nh + h];
          fma_int8x4(acc, ws, raw[i].x);
          fma_int8x4(acc + 4, ws, raw[i].y);
          fma_int8x4(acc + 8, ws, raw[i].z);
          fma_int8x4(acc + 12, ws, raw[i].w);
        }
      }
    }
    const float ec = ecur_s[h], den = den_s[h];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float o = acc[k] + ec * to_f32(vtr[c + k]);
      out[(size_t)b * Dv + c + k] = from_f32<T>(o / den);
    }
  }
}

// The cursor advance, stream-ordered after the step so every block of
// the step has read the old `pos`: no host sync.
__global__ void ring_advance_pos(int* pos, int w) { *pos = (*pos + 1) % w; }

// Lets ring_int8_step_kernel<T> take `smem` bytes of dynamic shared
// memory on the current device. The attribute is set again only when a
// launch needs more than that device was last granted, so a step pays
// for no driver call (kMaxDevices bounds the devices remembered).
constexpr int kMaxDevices = 16;

template <typename T>
cudaError_t reserve_smem(int smem) {
  static std::atomic<int> granted[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && granted[dev].load() >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(ring_int8_step_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && dev < kMaxDevices) granted[dev].store(smem);
  return err;
}

template <typename T>
int launch(const void* q, const void* kt, const void* vt, void* k_buf,
           void* k_scale, void* v_buf, void* v_scale, void* pos,
           void* out, int B, int Dk, int Dv, int WP, int w, int F, int nh,
           float inv, void* stream) {
  const size_t smem = ring_smem_bytes(Dk, WP, w, nh);
  cudaError_t err = reserve_smem<T>((int)smem);
  if (err != cudaSuccess) return (int)err;
  ring_int8_step_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kt),
      static_cast<const T*>(vt), static_cast<int8_t*>(k_buf),
      static_cast<float*>(k_scale), static_cast<int8_t*>(v_buf),
      static_cast<float*>(v_scale), static_cast<const int*>(pos),
      static_cast<T*>(out), Dk, Dv, WP, w, F, nh, inv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ring_advance_pos<<<1, 1, 0, (cudaStream_t)stream>>>(
      static_cast<int*>(pos), w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ring_int8_step_f32(const void* q, const void* kt,
                                  const void* vt, void* k_buf, void* k_scale,
                                  void* v_buf, void* v_scale, void* pos,
                                  void* out, int B, int Dk, int Dv, int WP,
                                  int w, int F, int nh, float inv,
                                  void* stream) {
  return launch<float>(q, kt, vt, k_buf, k_scale, v_buf, v_scale, pos, out,
                       B, Dk, Dv, WP, w, F, nh, inv, stream);
}

extern "C" int ring_int8_step_bf16(const void* q, const void* kt,
                                   const void* vt, void* k_buf,
                                   void* k_scale, void* v_buf, void* v_scale,
                                   void* pos, void* out, int B, int Dk,
                                   int Dv, int WP, int w, int F, int nh,
                                   float inv, void* stream) {
  return launch<__nv_bfloat16>(q, kt, vt, k_buf, k_scale, v_buf, v_scale,
                               pos, out, B, Dk, Dv, WP, w, F, nh, inv,
                               stream);
}
