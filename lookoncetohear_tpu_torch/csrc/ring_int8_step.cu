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
//      den, accumulated in float32 and stored in q's dtype;
//   4. advance `pos` to (pos + 1) % w in device memory.
// The ring (k_buf, k_scale, v_buf, v_scale) is updated IN PLACE, where
// the JAX kernel donates it (input_output_aliases): only slot `pos` of
// each row is written. The ring keeps the JAX package's 56-slot padded
// layout ([B, WP, D], WP = ceil(w/8)*8) so states compare one to one;
// the TPU-only parts of the Pallas kernel (the 8-slot window write, the
// f32 select, the mxu_dot/block_rows/w_chunk knobs) are gone.
//
// What bounds it on the H100: device memory. At the serving shape
// (B=64, Dk=2328, Dv=6208, w=50) a call must read the 49 live int8
// slots of every row, ~27 MB, more than stays in the 50 MB L2 across
// the three blocks of a step, so ~8.8 us at 3.35 TB/s; the ~0.05 GFLOP
// of arithmetic is negligible.
//
// Design: the slots of each row are split over a thread-block cluster
// of S = kSplit CTAs of 416 threads, fixed when the kernel is compiled
// (__cluster_dims__; ops/ring_step.py::ring_split_plan mirrors it for
// the wrapper's shared-memory check). CTA r of row b takes slots
// [r*w/S, (r+1)*w/S) and skips slot `pos`: it never reads that slot, so
// the writes of slot `pos` race with no reader. S is 2: at S = 4 the
// H100 cannot hold all of the serving step's 64 clusters at once and
// the last ones run in a second wave (52.6 us against 29.3 on an H100
// at 700 W, `python3 -m lookoncetohear_tpu_torch.ab`); at S = 2 the 128
// CTAs run one per SM in one wave.
//   - Each CTA stages the row's q, k_t and v_t (16-byte cp.async) and
//     its own K slots (8-byte cp.async: K rows of 2,328 bytes are only
//     8-byte aligned) in shared memory, and asks the L2 for its V slots
//     at once (cp.async.bulk.prefetch, 6,208 bytes a slot, 16-byte
//     aligned), so the V bytes stream in while K is scored.
//   - Every CTA computes the per-head amax of k_t and v_t and the
//     current-frame score itself. That is redundant, but max and the
//     scale formula are exact, so every CTA gets the same bits and no
//     CTA waits on another before it writes its 1/S share of slot
//     `pos`'s int8 segments (CTA 0 writes the scales).
//   - int8 becomes float32 without the conversion unit, whose quarter
//     rate set the time of the value sum: the byte, xor 0x80, under the
//     exponent of 2^23 is the float 2^23 + 128 + b, and one subtraction
//     leaves b exactly (byte_to_f32, fma_int8x4).
//   - Scores: one thread per (f, head) segment, its q (up to 8 values)
//     in registers, over all of the CTA's slots; shuffles sum a head's
//     lanes and shared memory its warps. Softmax per head over the
//     CTA's slots only: its running max m_r, exp-sum l_r, and the
//     float32 partial of the weighted V sum over its slots (one thread
//     per 16 columns, one 16-byte load per slot, 8 slots in flight),
//     kept in shared memory.
//   - After cluster.sync(), CTA r combines 1/S of the Dv columns from
//     all S peers through distributed shared memory: M = max(s_cur,
//     m_r'), out = (sum_r' exp(m_r' - M) part_r' + exp(s_cur - M) v_t)
//     / (sum_r' exp(m_r' - M) l_r' + exp(s_cur - M)), then writes its
//     share of `out`. A second cluster.sync() keeps each CTA's shared
//     memory alive until its peers have read it. Nothing crosses global
//     memory and nothing needs a second kernel.
//   - The cursor: every thread reads `pos` first; at its very end each
//     CTA (past its barriers, after a __threadfence) adds one to a
//     per-device arrival counter that is 0 at rest. The CTA that
//     arrives last knows that every CTA has read `pos`: it writes (pos
//     + 1) % w and resets the counter to 0, so the step is one launch
//     and can be captured in a CUDA graph. The wrapper keeps one
//     counter per ring (per `pos`), so rings stepped on different
//     streams never share one; one ring is stepped on one stream at a
//     time, as its in-place update requires anyway. Arriving at the start
//     instead, thread 0's fence waited on its copies in flight and held
//     the CTA at the next barrier.
// One block per row would leave half of the 132 SMs idle at 64 rows,
// and run its phases one after another. The int8 writes stay bit-exact
// with the plain version: rintf(__fdiv_rn(x, scale)), no fast-math.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 416;        // 13 warps: Dv/16 = 388 value threads
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeads = 16;        // kThreads % nh == 0 for nh | 16
// CTAs per row, one cluster. A build may set LOOKONCE_RING_SPLIT (up to
// 8, the portable cluster size) to compare other splits.
#ifndef LOOKONCE_RING_SPLIT
#define LOOKONCE_RING_SPLIT 2
#endif
constexpr int kSplit = LOOKONCE_RING_SPLIT;
static_assert(kSplit >= 1 && kSplit <= 8, "cluster of 1 to 8 CTAs");
constexpr int kSlotBatch = 8;
constexpr int kMaxE = 8;            // K dim per head, q held in registers

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
// warp_head_sum of four values at once, their shuffles interleaved
__device__ __forceinline__ void warp_head_sum4(float* v, int nh) {
  for (int off = 16; off >= nh; off >>= 1) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] += __shfl_xor_sync(0xffffffffu, v[u], off);
  }
}
__device__ __forceinline__ float warp_head_max(float v, int nh) {
  for (int off = 16; off >= nh; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// max |x| over the 16 bytes of `raw` read as T
__device__ __forceinline__ float amax16(int4 raw, float) {
  return fmaxf(fmaxf(fabsf(__int_as_float(raw.x)),
                     fabsf(__int_as_float(raw.y))),
               fmaxf(fabsf(__int_as_float(raw.z)),
                     fabsf(__int_as_float(raw.w))));
}
__device__ __forceinline__ float amax16(int4 raw, __nv_bfloat16) {
  const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) m = fmaxf(m, fabsf(__bfloat162float(v[k])));
  return m;
}

// Dynamic shared memory of a CTA, in this order: its K slots
// [maxslots, Dk] int8 (rounded up to 16 bytes), q [Dk], k_t [Dk] and
// v_t [Dv] in T, the float32 partial of the value sum [Dv], its scores
// [maxslots, nh] and the cross-warp partials [kWarps, max(3,
// maxslots), nh] in float32. ops/ring_step.py::ring_split_plan
// mirrors this.
__host__ __device__ inline size_t ring_smem_bytes(int Dk, int Dv, int nh,
                                                  int maxslots,
                                                  int tbytes) {
  const int nred = maxslots > 3 ? maxslots : 3;
  return ((size_t)maxslots * Dk + 15) / 16 * 16 +
         (size_t)(2 * Dk + Dv) * tbytes +
         (size_t)(Dv + maxslots * nh + kWarps * nred * nh) * sizeof(float);
}

// int8 to float without the conversion unit (I2F runs at a quarter of
// the FMA rate and set the time of the value sum): the byte plus 128,
// under the exponent of 2^23, is the float 2^23 + 128 + b exactly.
constexpr float kMagic = 8388736.0f;   // 2^23 + 128
__device__ __forceinline__ float byte_to_f32(unsigned u) {   // u = b & 0xff
  return __int_as_float((u ^ 0x80u) | 0x4b000000u) - kMagic;
}
// acc[k] += ws * (the k-th int8 of `word`), k = 0..3 (little endian)
__device__ __forceinline__ void fma_int8x4(float* acc, float ws, int word) {
  const unsigned x = (unsigned)word ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    acc[k] = fmaf(ws, __int_as_float(__byte_perm(x, 0x4b000000u,
                                                 0x7540 + k)) - kMagic,
                  acc[k]);
}

__device__ __forceinline__ int8_t quantize(float x, float scale) {
  float r = rintf(__fdiv_rn(x, scale));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return (int8_t)(int)r;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// `bytes` (a multiple of 16) at a 16-byte aligned `src` into the L2
__device__ __forceinline__ void prefetch_l2(const void* src, int bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src),
               "r"(bytes)
               : "memory");
}

template <typename T>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads, 1)
ring_int8_step_kernel(const T* __restrict__ q, const T* __restrict__ kt,
                      const T* __restrict__ vt, int8_t* __restrict__ k_buf,
                      float* __restrict__ k_scale,
                      int8_t* __restrict__ v_buf,
                      float* __restrict__ v_scale, int* pos_ptr,
                      int* arrivals, T* __restrict__ out, int Dk, int Dv,
                      int WP, int w, int F, int nh, float inv) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float kscale_s[kMaxHeads], vscale_s[kMaxHeads];
  __shared__ float scur_s[kMaxHeads], ecur_s[kMaxHeads], den_s[kMaxHeads];
  __shared__ float m_s[kMaxHeads], l_s[kMaxHeads];   // read by the peers
  __shared__ float fac_s[kSplit][kMaxHeads];

  cg::cluster_group cluster = cg::this_cluster();
  constexpr int S = kSplit;
  const int r = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int e = Dk / (F * nh);
  const int vd = Dv / (F * nh);
  const int nseg = F * nh;          // (f, head) segments per slot
  const int pos = *(volatile int*)pos_ptr;   // read once, before arriving

  // this CTA's slots: [lo, hi) without `pos`, n of them
  const int maxslots = (w + S - 1) / S;
  const int lo = r * w / S, hi = (r + 1) * w / S;
  const bool has_pos = pos >= lo && pos < hi;
  const int n = hi - lo - (has_pos ? 1 : 0);
  auto slot_of = [&](int i) {
    const int s = lo + i;
    return has_pos && s >= pos ? s + 1 : s;
  };

  int8_t* kst = reinterpret_cast<int8_t*>(smem);             // [maxslots, Dk]
  T* qs = reinterpret_cast<T*>(smem + ((size_t)maxslots * Dk + 15) / 16 * 16);
  T* kts = qs + Dk;
  T* vts = kts + Dk;
  float* part = reinterpret_cast<float*>(vts + Dv);          // [Dv]
  float* s4 = part + Dv;                                     // [maxslots, nh]
  float* red = s4 + maxslots * nh;          // [kWarps, max(3, maxslots), nh]

  // ---- stage q, k_t, v_t (group 1), then this CTA's K slots (group
  // 2); ask the L2 for its V slots.
  {
    const T* rows[3] = {q + (size_t)b * Dk, kt + (size_t)b * Dk,
                        vt + (size_t)b * Dv};
    T* dst[3] = {qs, kts, vts};
    const int n16[3] = {Dk * (int)sizeof(T) / 16, Dk * (int)sizeof(T) / 16,
                        Dv * (int)sizeof(T) / 16};
#pragma unroll
    for (int a = 0; a < 3; ++a)
      for (int i = tid; i < n16[a]; i += kThreads)
        cp_async16(reinterpret_cast<int4*>(dst[a]) + i,
                   reinterpret_cast<const int4*>(rows[a]) + i);
    cp_async_commit();
    const int dk8 = Dk / 8;
    const int8_t* krow = k_buf + (size_t)b * WP * Dk;
    for (int i = tid; i < n * dk8; i += kThreads) {
      const int sl = i / dk8, c8 = i - sl * dk8;
      cp_async8(kst + (size_t)sl * Dk + c8 * 8,
                krow + (size_t)slot_of(sl) * Dk + c8 * 8);
    }
    cp_async_commit();
    if (tid < n)
      prefetch_l2(v_buf + ((size_t)b * WP + slot_of(tid)) * Dv, Dv);
  }
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();

  // ---- per-head amax of k_t and v_t, and the current-frame score.
  // Thread tid owns segments tid, tid + kThreads, ...; kThreads % nh
  // == 0, so all of them belong to head tid % nh. v_t is read in
  // 16-byte pieces, rotated by tid to spread the shared-memory banks.
  {
    float kmax = 0.0f, vmax = 0.0f, scur = 0.0f;
    const int nv = vd * (int)sizeof(T) / 16;
    for (int sg = tid; sg < nseg; sg += kThreads) {
      for (int d = 0; d < e; ++d) {
        const float x = to_f32(kts[sg * e + d]);
        kmax = fmaxf(kmax, fabsf(x));
        scur = fmaf(to_f32(qs[sg * e + d]), x, scur);
      }
      const int4* v16 = reinterpret_cast<const int4*>(vts + sg * vd);
      for (int k = 0; k < nv; ++k)
        vmax = fmaxf(vmax, amax16(v16[(k + tid) % nv], T()));
    }
    kmax = warp_head_max(kmax, nh);
    vmax = warp_head_max(vmax, nh);
    scur = warp_head_sum(scur, nh);
    if (lane < nh) {
      red[warp * nh + lane] = kmax;
      red[(kWarps + warp) * nh + lane] = vmax;
      red[(2 * kWarps + warp) * nh + lane] = scur;
    }
  }
  __syncthreads();
  if (tid < nh) {
    float km = 0.0f, vm = 0.0f, sc = 0.0f;
    for (int i = 0; i < kWarps; ++i) {
      km = fmaxf(km, red[i * nh + tid]);
      vm = fmaxf(vm, red[(kWarps + i) * nh + tid]);
      sc += red[(2 * kWarps + i) * nh + tid];
    }
    kscale_s[tid] = fmaxf(km, 1e-12f) / 127.0f;
    vscale_s[tid] = fmaxf(vm, 1e-12f) / 127.0f;
    scur_s[tid] = sc * inv;
    if (r == 0) {
      k_scale[((size_t)b * WP + pos) * nh + tid] = kscale_s[tid];
      v_scale[((size_t)b * WP + pos) * nh + tid] = vscale_s[tid];
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // ---- write this CTA's share of the quantized current frame into
  // slot `pos`, which no CTA of the step reads: segments [sg0, sg1) of
  // both K and V, one thread per segment and ring (the V segment as
  // 16-byte stores).
  {
    int8_t* kw = k_buf + ((size_t)b * WP + pos) * Dk;
    int8_t* vw = v_buf + ((size_t)b * WP + pos) * Dv;
    const int sg0 = r * nseg / S, ns = (r + 1) * nseg / S - sg0;
    for (int job = tid; job < 2 * ns; job += kThreads) {
      const int sg = sg0 + (job < ns ? job : job - ns);
      const int h = sg & (nh - 1);
      if (job < ns) {
        const float sc = vscale_s[h];
        for (int c = sg * vd; c < (sg + 1) * vd; c += 16) {
          unsigned q8[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int k = 0; k < 16; ++k)
            q8[k / 4] |= (unsigned)(uint8_t)quantize(to_f32(vts[c + k]), sc)
                         << (8 * (k % 4));
          *reinterpret_cast<int4*>(vw + c) =
              make_int4((int)q8[0], (int)q8[1], (int)q8[2], (int)q8[3]);
        }
      } else {
        const float sc = kscale_s[h];
        for (int c = sg * e; c < (sg + 1) * e; ++c)
          kw[c] = quantize(to_f32(kts[c]), sc);
      }
    }
  }

  // ---- scores: one thread per (f, head) segment, its q in registers,
  // over all of this CTA's slots (independent, so many in flight); the
  // lanes of a head are summed by shuffles, the warps in shared memory.
  for (int sg0 = 0; sg0 < nseg; sg0 += kThreads) {
    const int sg = sg0 + tid;
    const bool live = sg < nseg;
    float qv[kMaxE];
#pragma unroll
    for (int d = 0; d < kMaxE; ++d)
      qv[d] = live && d < e ? to_f32(qs[sg * e + d]) : 0.0f;
    const uint8_t* kseg = reinterpret_cast<const uint8_t*>(kst) + sg * e;
    // four slots at a time, all their loads before any store to `red`
    // (which the compiler must assume may alias the K bytes)
    for (int sl0 = 0; sl0 < n; sl0 += 4) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (live) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (sl0 + u < n) {
#pragma unroll
            for (int d = 0; d < kMaxE; ++d)
              if (d < e)
                acc[u] = fmaf(qv[d],
                              byte_to_f32(kseg[(size_t)(sl0 + u) * Dk + d]),
                              acc[u]);
          }
        }
      }
      warp_head_sum4(acc, nh);
      if (lane < nh) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (sl0 + u < n) {
            float* r = &red[(warp * maxslots + sl0 + u) * nh + lane];
            *r = sg0 == 0 ? acc[u] : *r + acc[u];
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < n * nh; i += kThreads) {
    const int sl = i / nh, h = i - sl * nh;
    float acc = 0.0f;
    for (int wi = 0; wi < kWarps; ++wi) acc += red[(wi * maxslots + sl) * nh + h];
    s4[i] = acc * k_scale[((size_t)b * WP + slot_of(sl)) * nh + h] * inv;
  }
  __syncthreads();

  // ---- softmax over this CTA's slots, one warp per head: m_r, l_r,
  // and s4 becomes the value weights exp(s - m_r) * vscale_s.
  for (int h = warp; h < nh; h += kWarps) {
    float m = -INFINITY;
    for (int sl = lane; sl < n; sl += 32) m = fmaxf(m, s4[sl * nh + h]);
    m = warp_head_max(m, 1);
    float l = 0.0f;
    for (int sl = lane; sl < n; sl += 32) {
      const float p = expf(s4[sl * nh + h] - m);
      l += p;
      s4[sl * nh + h] =
          p * v_scale[((size_t)b * WP + slot_of(sl)) * nh + h];
    }
    l = warp_head_sum(l, 1);
    if (lane == 0) {
      m_s[h] = m;
      l_s[h] = l;
    }
  }
  __syncthreads();

  // ---- the value partial over this CTA's slots: one thread per 16
  // columns (of one head, vd % 16 == 0), one 16-byte load per slot,
  // kSlotBatch slots' loads issued before their FMAs.
  const int dv16 = Dv / 16;
  for (int c16 = tid; c16 < dv16; c16 += kThreads) {
    const int c = c16 * 16;
    const int h = (c % (nh * vd)) / vd;
    float acc[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] = 0.0f;
    const int4* vcol =
        reinterpret_cast<const int4*>(v_buf + (size_t)b * WP * Dv + c);
    for (int i0 = 0; i0 < n; i0 += kSlotBatch) {
      int4 raw[kSlotBatch];
#pragma unroll
      for (int i = 0; i < kSlotBatch; ++i)
        if (i0 + i < n) raw[i] = vcol[(size_t)slot_of(i0 + i) * dv16];
#pragma unroll
      for (int i = 0; i < kSlotBatch; ++i) {
        if (i0 + i < n) {
          const float ws = s4[(i0 + i) * nh + h];
          fma_int8x4(acc, ws, raw[i].x);
          fma_int8x4(acc + 4, ws, raw[i].y);
          fma_int8x4(acc + 8, ws, raw[i].z);
          fma_int8x4(acc + 12, ws, raw[i].w);
        }
      }
    }
    float4* dst = reinterpret_cast<float4*>(part + c);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      dst[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2],
                           acc[4 * k + 3]);
  }
  cluster.sync();

  // ---- combine the S partials of the row: per-head factors, then
  // this CTA's 1/S of the columns, read from every peer's `part`.
  if (tid < nh) {
    float mp[S], lp[S];
#pragma unroll
    for (int p = 0; p < S; ++p) {
      mp[p] = *cluster.map_shared_rank(&m_s[tid], p);
      lp[p] = *cluster.map_shared_rank(&l_s[tid], p);
    }
    float mx = scur_s[tid];
#pragma unroll
    for (int p = 0; p < S; ++p) mx = fmaxf(mx, mp[p]);
    const float ec = expf(scur_s[tid] - mx);
    float den = ec;
#pragma unroll
    for (int p = 0; p < S; ++p) {
      const float fp = expf(mp[p] - mx);
      fac_s[p][tid] = fp;
      den += fp * lp[p];
    }
    ecur_s[tid] = ec;
    den_s[tid] = den;
  }
  __syncthreads();
  {
    const int dv4 = Dv / 4;
    for (int c4 = r * dv4 / S + tid; c4 < (r + 1) * dv4 / S;
         c4 += kThreads) {
      const int c = c4 * 4;
      const int h = (c % (nh * vd)) / vd;
      float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int p = 0; p < S; ++p) {
        const float4 pv = *cluster.map_shared_rank(
            reinterpret_cast<float4*>(part) + c4, p);
        const float fp = fac_s[p][h];
        o[0] = fmaf(fp, pv.x, o[0]);
        o[1] = fmaf(fp, pv.y, o[1]);
        o[2] = fmaf(fp, pv.z, o[2]);
        o[3] = fmaf(fp, pv.w, o[3]);
      }
      const float ec = ecur_s[h], den = den_s[h];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        out[(size_t)b * Dv + c + k] =
            from_f32<T>((o[k] + ec * to_f32(vts[c + k])) / den);
    }
  }
  // the peers may still read this CTA's shared memory
  cluster.sync();

  // ---- every thread of this CTA has read `pos` (before the barriers
  // above): arrive. The last CTA of the grid to arrive advances the
  // cursor and resets the counter.
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(arrivals, 1) == (int)(gridDim.x * gridDim.y) - 1) {
      __threadfence();
      *pos_ptr = (pos + 1) % w;
      *arrivals = 0;
    }
  }
}

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
           void* arrivals, void* out, int B, int Dk, int Dv, int WP, int w,
           int F, int nh, float inv, void* stream) {
  if (nh > kMaxHeads || Dk / (F * nh) > kMaxE)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ring_smem_bytes(Dk, Dv, nh, (w + kSplit - 1) / kSplit,
                                      (int)sizeof(T));
  cudaError_t err = reserve_smem<T>((int)smem);
  if (err != cudaSuccess) return (int)err;
  // the cluster shape is the kernel's own (__cluster_dims__)
  ring_int8_step_kernel<T><<<dim3(kSplit, B), kThreads, smem,
                             (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kt),
      static_cast<const T*>(vt), static_cast<int8_t*>(k_buf),
      static_cast<float*>(k_scale), static_cast<int8_t*>(v_buf),
      static_cast<float*>(v_scale), static_cast<int*>(pos),
      static_cast<int*>(arrivals), static_cast<T*>(out), Dk, Dv, WP, w, F,
      nh, inv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ring_int8_step_f32(const void* q, const void* kt,
                                  const void* vt, void* k_buf, void* k_scale,
                                  void* v_buf, void* v_scale, void* pos,
                                  void* arrivals, void* out, int B, int Dk,
                                  int Dv, int WP, int w, int F, int nh,
                                  float inv, void* stream) {
  return launch<float>(q, kt, vt, k_buf, k_scale, v_buf, v_scale, pos,
                       arrivals, out, B, Dk, Dv, WP, w, F, nh, inv, stream);
}

extern "C" int ring_int8_step_bf16(const void* q, const void* kt,
                                   const void* vt, void* k_buf,
                                   void* k_scale, void* v_buf, void* v_scale,
                                   void* pos, void* arrivals, void* out,
                                   int B, int Dk, int Dv, int WP, int w,
                                   int F, int nh, float inv, void* stream) {
  return launch<__nv_bfloat16>(q, kt, vt, k_buf, k_scale, v_buf, v_scale,
                               pos, arrivals, out, B, Dk, Dv, WP, w, F, nh,
                               inv, stream);
}
