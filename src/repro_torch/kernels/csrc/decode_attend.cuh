// One-token decode attention for K2 (paged_decode.cu, positions found
// through a block table): the warp-level online softmax over chunks of K/V
// rows held in registers, and the block's log-sum-exp merge of its warps.
//
// A warp handles one query head.  Lane j holds the element pairs
// (2p, 2p + 1) of a row for p = j, j + 32, ... (MAX_P pairs), so a row is
// read with one 4-byte (bf16) or 8-byte (f32) load per lane and pair, and
// the warp's loads of a row are consecutive.  Loading a chunk's CHUNK rows
// first keeps all of their loads in flight together.  Rows must start at
// an even element (D even, even pointers).
#pragma once

#include "common.cuh"

namespace repro {

template <typename T> __device__ __forceinline__ float2 load2(const T* p);
template <> __device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <> __device__ __forceinline__ float2 load2<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// this lane's pairs of a D-long row as f32 (zeros where !ok or past D)
template <typename T, int MAX_P>
__device__ __forceinline__ void load_row(const T* row, int D, int lane,
                                         bool ok, float2 (&out)[MAX_P]) {
#pragma unroll
  for (int i = 0; i < MAX_P; ++i) {
    const int e = 2 * (lane + 32 * i);
    out[i] = ok && e < D ? load2(row + e) : make_float2(0.f, 0.f);
  }
}

// Fold CHUNK rows (K row at k + base[c], V row at v + base[c], attended
// where ok[c]) into the warp's online softmax (m, l, acc); scale multiplies
// the q.k product.  A chunk that attends nothing changes nothing.
template <typename Tkv, int MAX_P, int CHUNK>
__device__ __forceinline__ void fold_chunk(
    const Tkv* __restrict__ k, const Tkv* __restrict__ v,
    const int64_t (&base)[CHUNK], const bool (&ok)[CHUNK], int D, int lane,
    float scale, const float2 (&qr)[MAX_P], float2 (&acc)[MAX_P], float& m,
    float& l) {
  float2 kr[CHUNK][MAX_P], vr[CHUNK][MAX_P];
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) {
    load_row(k + base[c], D, lane, ok[c], kr[c]);
    load_row(v + base[c], D, lane, ok[c], vr[c]);
  }
  float s[CHUNK];
  float cmax = kNegInf;
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) {
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_P; ++i)
      part += qr[i].x * kr[c][i].x + qr[i].y * kr[c][i].y;
    part = warp_sum(part);
    s[c] = ok[c] ? part * scale : kNegInf;
    cmax = fmaxf(cmax, s[c]);
  }
  if (cmax == kNegInf) return;
  const float m_new = fmaxf(m, cmax);
  const float alpha = expf(m - m_new);
  float psum = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_P; ++i) {
    acc[i].x *= alpha;
    acc[i].y *= alpha;
  }
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) {
    const float p = ok[c] ? expf(s[c] - m_new) : 0.f;
    psum += p;
#pragma unroll
    for (int i = 0; i < MAX_P; ++i) {
      acc[i].x += p * vr[c][i].x;
      acc[i].y += p * vr[c][i].y;
    }
  }
  l = l * alpha + psum;
  m = m_new;
}

// A warp's record in shared memory: acc[D] | m | l.
template <int MAX_P>
__device__ __forceinline__ void store_record(float* r, const float2 (&acc)[MAX_P],
                                             float m, float l, int D,
                                             int lane) {
#pragma unroll
  for (int i = 0; i < MAX_P; ++i) {
    const int e = 2 * (lane + 32 * i);
    if (e < D) {
      r[e] = acc[i].x;
      r[e + 1] = acc[i].y;
    }
  }
  if (lane == 0) {
    r[D] = m;
    r[D + 1] = l;
  }
}

// Log-sum-exp merge of each head's wph warp records (head g's records
// start at smem + g * wph * (D + 2)), by the whole block: writes m, l and
// the unnormalised acc for the G heads from head0 on.
__device__ __forceinline__ void merge_records(const float* smem, int G, int D,
                                              int wph, int64_t head0,
                                              float* __restrict__ out,
                                              float* __restrict__ m_out,
                                              float* __restrict__ l_out) {
  const int rec = D + 2;
  for (int e = threadIdx.x; e < G * (D + 1); e += blockDim.x) {
    const int g = e / (D + 1);
    const int d = e - g * (D + 1);
    const float* r = smem + (int64_t)g * wph * rec;
    float mx = kNegInf;
    for (int w = 0; w < wph; ++w) mx = fmaxf(mx, r[w * rec + D]);
    float lsum = 0.f;
    for (int w = 0; w < wph; ++w)
      lsum += r[w * rec + D + 1] * expf(r[w * rec + D] - mx);
    if (d < D) {
      float sum = 0.f;
      for (int w = 0; w < wph; ++w)
        sum += r[w * rec + d] * expf(r[w * rec + D] - mx);
      out[(head0 + g) * D + d] = sum;
    } else {
      m_out[head0 + g] = mx;
      l_out[head0 + g] = lsum;
    }
  }
}

}  // namespace repro
