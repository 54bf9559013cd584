// K3 flash_attention for Hopper (sm_90a): GQA attention over a whole
// sequence, forward only, causal and/or sliding-window, with the queries at
// the tail of the KV sequence.
//
// Replaces the TPU kernel
//   repro/kernels/flash_attention/kernel.py::flash_attention (_fa_kernel).
// Bound: operations.  At the prefill shapes (Sq = Skv = 512, D = 128) each
// K/V row staged in shared memory serves 64 queries, so the work is ~4*D
// multiply-adds per (query, key) pair against 4*D bytes per key row: far
// above the card's ridge point.  This first version computes in f32 on the
// CUDA cores (no tensor cores), so it runs below the bf16 tensor-core
// bound by design; wgmma tiles are later work.
//
// Design: one block of 256 threads per (query tile of 64 rows, query head,
// sequence).  Four threads share a query row: each holds a quarter of the
// row's q and of its f32 accumulator in registers, as float4 groups
// (group i of the row belongs to thread i % 4), so a shared-memory read of
// a K or V row is one 16-byte load per thread and the four threads' loads
// are consecutive.  The block walks the K/V tiles of its KV head (query
// head h reads KV head h / G) in order, staging each tile of BK positions
// in shared memory as f32, and keeps an f32 online softmax (m, l, acc) per
// query row.  Per tile a row first scores all BK positions (the four
// partial dot products summed by two shuffles), then rescales once and
// accumulates.  Tiles wholly above the diagonal or wholly left of every
// query's window are never visited, as _fa_kernel skips them with pl.when.
//
// Masks: query row i sits at absolute position Skv - Sq + i; key position
// k is attended when k < Skv, k <= q (causal) and q - k < window.  The
// probability of a masked entry is set to 0 explicitly, so a tile in which
// a row attends nothing leaves that row's (m, l, acc) untouched: the first
// tile a row visits under a window may be wholly masked for it (the TPU
// body relies on the next tile's rescale by 0 to wipe it).  A row that
// attends nothing ends with l = 0 and is written as 0 (the l == 0 guard).
// Any Sq <= Skv is taken; the tiles' ragged ends are masked.  Output is in
// q's dtype.
//
// The C entry returns cudaErrorInvalidValue for a shape it does not take
// (D not a multiple of 4 or above 256, Hq not a multiple of Hkv, Sq > Skv,
// unaligned pointers) and otherwise cudaGetLastError().

#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::load4;

constexpr int kQRows = 64;              // query rows per block
constexpr int kTPQ = 4;                 // threads per query row
constexpr int kThreads = kQRows * kTPQ;

template <typename T, int MAX_G, int BK>
__global__ void __launch_bounds__(kThreads) fa_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int Hq, int Hkv, int Sq,
    int Skv, int D, int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);    // [BK][D]
  float* vs = ks + BK * D;                         // [BK][D]
  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int row = qt * kQRows + tid / kTPQ;       // query row in [0, Sq)
  const int part = tid % kTPQ;
  const bool row_ok = row < Sq;
  const int q_base = Skv - Sq;
  const int qpos = q_base + row;                   // absolute position
  const int ng = D / 4;                            // float4 groups per row
  const int64_t q_off = (((int64_t)b * Hq + h) * Sq + row) * D;
  const int64_t kv_off = ((int64_t)b * Hkv + kvh) * Skv * D;

  float4 qr[MAX_G], acc[MAX_G];
#pragma unroll
  for (int i = 0; i < MAX_G; ++i) {
    const int gi = part + kTPQ * i;
    qr[i] = (row_ok && gi < ng) ? load4(q + q_off + 4 * gi)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf, l = 0.f;

  // key positions any row of this block may attend: [k_start, k_end)
  const int first_q = q_base + qt * kQRows;
  const int last_q = q_base + min(Sq, (qt + 1) * kQRows) - 1;
  const int k_end = causal ? min(Skv, last_q + 1) : Skv;
  const int k_start = window > 0 ? max(0, first_q - window + 1) : 0;

  for (int k0 = (k_start / BK) * BK; k0 < k_end; k0 += BK) {
    const int n = min(BK, Skv - k0);
    __syncthreads();                               // last tile consumed
    for (int e = tid; e < BK * ng; e += kThreads) {
      const int r = e / ng;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (r < n) {
        const int64_t src = kv_off + (int64_t)k0 * D + 4 * e;
        kk = load4(k + src);
        vv = load4(v + src);
      }
      reinterpret_cast<float4*>(ks)[e] = kk;
      reinterpret_cast<float4*>(vs)[e] = vv;
    }
    __syncthreads();

    float s[BK];
    unsigned ok_bits = 0u;
    float tile_max = kNegInf;
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      const float4* kr = reinterpret_cast<const float4*>(ks + c * D);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_G; ++i) {
        const int gi = part + kTPQ * i;
        if (gi < ng) {
          const float4 kk = kr[gi];
          dot += qr[i].x * kk.x + qr[i].y * kk.y + qr[i].z * kk.z +
                 qr[i].w * kk.w;
        }
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kpos = k0 + c;
      bool ok = row_ok && c < n;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && qpos - kpos < window;
      s[c] = ok ? dot * scale : kNegInf;
      if (ok) {
        ok_bits |= 1u << c;
        tile_max = fmaxf(tile_max, s[c]);
      }
    }
    if (ok_bits == 0u) continue;                   // row attends nothing here
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < MAX_G; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      const float p = (ok_bits >> c) & 1u ? expf(s[c] - m_new) : 0.f;
      psum += p;
      const float4* vr = reinterpret_cast<const float4*>(vs + c * D);
#pragma unroll
      for (int i = 0; i < MAX_G; ++i) {
        const int gi = part + kTPQ * i;
        if (gi < ng) {
          const float4 vv = vr[gi];
          acc[i].x += p * vv.x;
          acc[i].y += p * vv.y;
          acc[i].z += p * vv.z;
          acc[i].w += p * vv.w;
        }
      }
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (!row_ok) return;
  const float den = l == 0.f ? 1.f : l;
#pragma unroll
  for (int i = 0; i < MAX_G; ++i) {
    const int gi = part + kTPQ * i;
    if (gi < ng) {
      T* o = out + q_off + 4 * gi;
      o[0] = repro::from_f32<T>(acc[i].x / den);
      o[1] = repro::from_f32<T>(acc[i].y / den);
      o[2] = repro::from_f32<T>(acc[i].z / den);
      o[3] = repro::from_f32<T>(acc[i].w / den);
    }
  }
}

template <typename T, int MAX_G, int BK>
void launch(const void* q, const void* k, const void* v, void* out, int B,
            int Hq, int Hkv, int Sq, int Skv, int D, int causal, int window,
            float scale, cudaStream_t stream) {
  const dim3 grid((Sq + kQRows - 1) / kQRows, Hq, B);
  const int smem = 2 * BK * D * (int)sizeof(float);
  fa_kernel<T, MAX_G, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, Sq, Skv, D,
      causal, window, scale);
}

template <typename T>
void launch_d(const void* q, const void* k, const void* v, void* out, int B,
              int Hq, int Hkv, int Sq, int Skv, int D, int causal, int window,
              float scale, cudaStream_t s) {
  // MAX_G float4 groups per thread cover D <= 16 * MAX_G; the K and V
  // tiles take 2 * BK * D * 4 <= 32 KB of shared memory
  if (D <= 32)
    launch<T, 2, 32>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal, window,
                     scale, s);
  else if (D <= 64)
    launch<T, 4, 32>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal, window,
                     scale, s);
  else if (D <= 128)
    launch<T, 8, 32>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal, window,
                     scale, s);
  else
    launch<T, 16, 16>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal, window,
                      scale, s);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; window <= 0 means none
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Hq, int Hkv, int Sq,
                               int Skv, int D, int causal, int window,
                               float scale, int dtype, void* stream) {
  if (D < 4 || D > 256 || D % 4 || Hkv < 1 || Hq % Hkv || Sq > Skv)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      (dtype == 1 ? 8 : 16))   // load4 reads 4 elements at once
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hq == 0 || Sq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_d<float>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal, window,
                    scale, s);
  else if (dtype == 1)
    launch_d<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal,
                            window, scale, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
