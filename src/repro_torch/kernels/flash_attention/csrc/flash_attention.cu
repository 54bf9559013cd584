// K3 flash_attention for Hopper (sm_90a): GQA attention over a whole
// sequence, forward only, causal and/or sliding-window, with the queries at
// the tail of the KV sequence.
//
// Replaces the TPU kernel
//   repro/kernels/flash_attention/kernel.py::flash_attention (_fa_kernel).
// Bound: bytes at the prefill shapes (B 8, Hq 16, Hkv 8, S 512, D 128,
// causal): 50 MB moved against 8.6 GFLOP, 15 us against 8.7 us at the bf16
// tensor-core rate.  Every K/V tile staged in shared memory serves 64
// queries, so a kernel of this shape is held back by its arithmetic long
// before the bytes: the tensor cores are the only way near the bound.
//
// Two variants of one function; the wrapper (kernel.py) picks one by dtype,
// head dim and alignment before the launch and never falls back.
//
// 1. Tensor cores (fa_tc_kernel; bf16, D in {64, 128}, K/V aligned to 16
//    bytes, q and out to 4).  One block of 4 warps per (query head,
//    sequence, tile of 64 query rows), the query tiles with the most causal
//    work dispatched first.  A warp owns 16 query rows: their q stays in
//    registers as mma A fragments, and the online softmax (m, l) of its two
//    rows per thread and the f32 output accumulator (16 x D) stay in
//    registers in the mma C-fragment layout, the row max reduced across the
//    four threads of a quad.  K and V tiles of 64 keys x D in bf16 go
//    through a two-stage ring in shared memory filled by cp.async (16 bytes
//    a thread, chunk c of row r stored at c ^ (r & 7) so that ldmatrix
//    reads are free of bank conflicts): tile t + 1 loads while tile t
//    computes.  q.k^T and p.v are mma.sync.m16n8k16 bf16 products with f32
//    accumulation, K fed by ldmatrix and V by ldmatrix.trans.
//    Why mma.sync and not wgmma: the FA2 register layout lets the online
//    softmax and the p.v A operand live in registers with no shared-memory
//    round trip, and a block needs no warpgroup, TMA descriptor or mbarrier
//    protocol; wgmma on 64-row warpgroup tiles fed by TMA is the next step.
//    p is kept precise before p.v: p is split into p_hi = bf16(p) and
//    p_lo = bf16(p - p_hi) and both go through the tensor cores (three
//    products per tile instead of two).  Rounding p to bf16 alone would
//    leave ~2^-9 relative error per probability, enough to move 10% of
//    bf16 outputs of one causal 512 x 512 head by more than one bf16
//    rounding step from the f32-softmax result (ref.mha); hi + lo carries
//    p to ~2^-17.
//
// 2. CUDA cores (fa_kernel; f32, and bf16 at any other head dim: D a
//    multiple of 4 up to 256).  One block of 256 threads per (query tile
//    of 64 rows, query head, sequence).  Four threads share a query row:
//    each holds a quarter of the row's q and of its f32 accumulator in
//    registers, as float4 groups (group i of the row belongs to thread
//    i % 4), so a shared-memory read of a K or V row is one 16-byte load
//    per thread and the four threads' loads are consecutive.  The block
//    walks the K/V tiles of its KV head (query head h reads KV head h / G)
//    in order, staging each tile of BK positions in shared memory as f32,
//    and keeps an f32 online softmax (m, l, acc) per query row.  Per tile a
//    row first scores all BK positions (the four partial dot products
//    summed by two shuffles), then rescales once and accumulates.
//
// Both variants visit no tile wholly above the diagonal or wholly left of
// every query's window, as _fa_kernel skips them with pl.when.  Masks:
// query row i sits at absolute position Skv - Sq + i; key position k is
// attended when k < Skv, k <= q (causal) and q - k < window.  The
// probability of a masked entry is set to exactly 0, so a tile in which a
// row attends nothing leaves that row's (m, l, acc) untouched: the first
// tile a row visits under a window may be wholly masked for it (the TPU
// body relies on the next tile's rescale by 0 to wipe it).  A row that
// attends nothing ends with l = 0 and is written as 0 (the l == 0 guard).
// Any Sq <= Skv is taken; the tiles' ragged ends are masked (rows past Skv
// are zero-filled).  Without causality or a window any Sq is taken, Sq >
// Skv too (cross-attention to a shorter source): the query positions,
// negative then, are read by neither mask, every query walks [0, Skv), and
// a tile is an edge only where it runs past Skv.  Output is in q's dtype.
//
// The C entry returns cudaErrorInvalidValue for a shape the asked variant
// does not take (Hq not a multiple of Hkv, Sq > Skv when causal or
// windowed; the CUDA-core variant:
// D not a multiple of 4 or above 256, pointers not aligned to 4 elements;
// the tensor-core variant: not bf16, D not 64 or 128, K/V not aligned to
// 16 bytes or q/out to 4) and otherwise cudaGetLastError().

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::cp_async16;
using repro::kNegInf;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::load4;
using repro::mma_bf16;
using repro::smem_addr;
using repro::split_bf16;

// -- CUDA-core variant ------------------------------------------------------

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

// -- tensor-core variant ----------------------------------------------------

constexpr int kTcRows = 64;             // query rows per block: 4 warps x 16
constexpr int kTcKeys = 64;             // keys per K/V tile
constexpr int kTcThreads = 128;

__device__ __forceinline__ float minus_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// byte offset of element (row, 8 * chunk) in a swizzled [kTcKeys][D] tile
template <int D>
__device__ __forceinline__ uint32_t tile_offset(int row, int chunk) {
  return (uint32_t)(row * D + ((chunk ^ (row & 7)) << 3)) * 2u;
}

template <int D>
__global__ void __launch_bounds__(kTcThreads) fa_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int Hq, int Hkv, int Sq, int Skv, int causal, int window,
    float scale_log2) {
  constexpr int KS = D / 16;            // k-steps of q.k^T
  constexpr int NT = D / 8;             // 8-wide column tiles of the output
  constexpr int NCH = D / 8;            // 16-byte chunks per K/V row
  constexpr int TILE = kTcKeys * D;     // elements of one K or V tile
  // [stage][K tile | V tile], bf16
  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;        // heaviest tiles first
  const int kvh = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;             // fragment row (and row + 8)
  const int gc = (lane & 3) * 2;        // fragment column pair
  const int q_base = Skv - Sq;
  const int row0 = qt * kTcRows + warp * 16;        // this warp's first row
  const int64_t q_off = ((int64_t)b * Hq + h) * Sq * D;
  const int64_t kv_off = ((int64_t)b * Hkv + kvh) * Skv * D;

  // q as A fragments: rows gr and gr + 8, columns gc, gc + 1 (+8) per k-step
  uint32_t qa[KS][4];
  {
    const int r_lo = row0 + gr, r_hi = r_lo + 8;
    const __nv_bfloat16* p_lo = q + q_off + (int64_t)r_lo * D + gc;
    const __nv_bfloat16* p_hi = p_lo + 8 * D;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qa[kk][0] = r_lo < Sq ? load_pair(p_lo + kk * 16) : 0u;
      qa[kk][1] = r_hi < Sq ? load_pair(p_hi + kk * 16) : 0u;
      qa[kk][2] = r_lo < Sq ? load_pair(p_lo + kk * 16 + 8) : 0u;
      qa[kk][3] = r_hi < Sq ? load_pair(p_hi + kk * 16 + 8) : 0u;
    }
  }

  auto load_tile = [&](int stage, int k0) {
    __nv_bfloat16* ks = tiles + stage * 2 * TILE;
    __nv_bfloat16* vs = ks + TILE;
#pragma unroll
    for (int i = 0; i < kTcKeys * NCH / kTcThreads; ++i) {
      const int c = threadIdx.x + i * kTcThreads;
      const int r = c / NCH, ch = c % NCH;
      const bool ok = k0 + r < Skv;
      const int64_t src = kv_off + (int64_t)(ok ? k0 + r : 0) * D + ch * 8;
      const int dst = r * D + ((ch ^ (r & 7)) << 3);
      cp_async16(ks + dst, k + src, ok);
      cp_async16(vs + dst, v + src, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // running max (in log2 units of the scaled logits) and partial row sums
  // of rows gr and gr + 8; l is summed across the quad at the end
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  const int first_q = q_base + qt * kTcRows;
  const int last_q = q_base + min(Sq, (qt + 1) * kTcRows) - 1;
  const int k_end = causal ? min(Skv, last_q + 1) : Skv;
  const int k_start = window > 0 ? max(0, first_q - window + 1) : 0;
  const int t_first = k_start / kTcKeys;
  const int t_end = (k_end + kTcKeys - 1) / kTcKeys;
  const int qpos = q_base + row0 + gr;               // and qpos + 8
  const uint32_t tiles_addr = smem_addr(tiles);
  // ldmatrix row addresses: lanes 8i..8i+7 give the rows of matrix i
  const int k_row = (lane & 7) + ((lane >> 4) << 3);
  const int k_chunk = (lane >> 3) & 1;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int v_chunk = lane >> 4;

  if (t_first < t_end) load_tile(0, t_first * kTcKeys);
  for (int t = t_first; t < t_end; ++t) {
    const int stage = (t - t_first) & 1;
    if (t + 1 < t_end) {
      load_tile(stage ^ 1, (t + 1) * kTcKeys);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const uint32_t ks = tiles_addr + stage * 2 * TILE * 2;
    const uint32_t vs = ks + TILE * 2;

    // s = q.k^T: 16 rows x 64 keys, 8 column tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ks + tile_offset<D>(jp * 16 + k_row,
                                            kk * 2 + k_chunk));
        mma_bf16(s[2 * jp], qa[kk], bf[0], bf[1]);
        mma_bf16(s[2 * jp + 1], qa[kk], bf[2], bf[3]);
      }
    }

    // scale into log2 units; masked entries to -inf (probability 0)
    const int k0 = t * kTcKeys;
    const bool edge = k0 + kTcKeys > Skv ||
                      (causal && k0 + kTcKeys - 1 > first_q) ||
                      (window > 0 && last_q - k0 >= window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int key = k0 + j * 8 + gc + (e & 1);
          const int qp = qpos + (e >> 1) * 8;
          bool ok = key < Skv;
          if (causal) ok = ok && key <= qp;
          if (window > 0) ok = ok && qp - key < window;
          if (!ok) x = minus_inf();
        }
        s[j][e] = x;
      }
    }

    // online softmax per row; a row with nothing attended here keeps
    // (m, l, o): its max is -inf, alpha 1 and every p exactly 0
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = minus_inf();
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * rr], s[j][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[rr], mx);
      const float alpha = exp2f(m_r[rr] - m_new);
      m_r[rr] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
          const float p = exp2f(s[j][e] - m_new);
          s[j][e] = p;
          ps += p;
        }
      }
      l_r[rr] = l_r[rr] * alpha + ps;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][2 * rr] *= alpha;
        o[n][2 * rr + 1] *= alpha;
      }
    }

    // o += p.v with p = p_hi + p_lo, each a bf16 A fragment taken straight
    // from the s fragments (keys 16kk..16kk+15 are s tiles 2kk and 2kk+1)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vs + tile_offset<D>(kk * 16 + v_row,
                                                  dp * 2 + v_chunk));
        mma_bf16(o[2 * dp], ph, bf[0], bf[1]);
        mma_bf16(o[2 * dp], pl, bf[0], bf[1]);
        mma_bf16(o[2 * dp + 1], ph, bf[2], bf[3]);
        mma_bf16(o[2 * dp + 1], pl, bf[2], bf[3]);
      }
    }
    __syncthreads();                     // this stage is free to refill
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_r[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + gr + rr * 8;
    if (row >= Sq) continue;
    const float den = l == 0.f ? 1.f : l;
    __nv_bfloat16* dst = out + q_off + (int64_t)row * D + gc;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = __floats2bfloat162_rn(
          o[n][2 * rr] / den, o[n][2 * rr + 1] / den);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int Hq, int Hkv, int Sq, int Skv, int causal, int window,
              float scale, cudaStream_t stream) {
  const int smem = 2 * 2 * kTcKeys * D * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      fa_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hq, B, (Sq + kTcRows - 1) / kTcRows);
  fa_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Hq, Hkv, Sq, Skv, causal, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; variant: 0 = CUDA cores (any
// dtype), 1 = tensor cores (bf16, D 64 or 128); window <= 0 means none
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Hq, int Hkv, int Sq,
                               int Skv, int D, int causal, int window,
                               float scale, int dtype, int variant,
                               void* stream) {
  if (Hkv < 1 || Hq % Hkv || (Sq > Skv && (causal || window > 0)))
    return (int)cudaErrorInvalidValue;
  const uintptr_t qo = reinterpret_cast<uintptr_t>(q) |
                       reinterpret_cast<uintptr_t>(out);
  const uintptr_t kv = reinterpret_cast<uintptr_t>(k) |
                       reinterpret_cast<uintptr_t>(v);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    // cp.async moves K/V in 16-byte chunks; q and out go by element pairs
    if (dtype != 1 || (D != 64 && D != 128) || kv % 16 || qo % 4)
      return (int)cudaErrorInvalidValue;
    if (B == 0 || Hq == 0 || Sq == 0) return (int)cudaSuccess;
    return D == 64 ? launch_tc<64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, causal,
                                   window, scale, s)
                   : launch_tc<128>(q, k, v, out, B, Hq, Hkv, Sq, Skv,
                                    causal, window, scale, s);
  }
  if (variant != 0 || D < 4 || D > 256 || D % 4)
    return (int)cudaErrorInvalidValue;
  if ((qo | kv) % (dtype == 1 ? 8 : 16))   // load4 reads 4 elements at once
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hq == 0 || Sq == 0) return (int)cudaSuccess;
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
