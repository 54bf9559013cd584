// K5 ssd for Hopper (sm_90a): the Mamba2 chunked SSD scan, forward only,
// returning y and the final state.
//
// Replaces the TPU kernel
//   repro/kernels/mamba2_ssd/kernel.py::ssd (_ssd_kernel).
// It computes what ref.ssd_chunked computes, chunk by chunk:
//   y[t]   = sum_{s<=t} exp(L_t - L_s) dt_s (C_t . B_s) x_s       (intra)
//          + exp(L_t) C_t . state                                 (inter)
//          + D x_t
//   state <- exp(L_last) state + sum_s exp(L_last - L_s) dt_s B_s x_s^T
// with L the inclusive cumulative sum of dt * A inside the chunk.  Unlike
// the TPU kernel it also writes the final state [Bt, H, N, P] in f32 (a
// prefill needs it; the TPU kernel drops it) and takes any S: the tail
// chunk's rows past S count as dt = 0, x = B = C = 0, so they decay nothing,
// inject nothing and are not written.
//
// Bound: bytes.  At the prefill shape (Bt 8, S 512, H 48, P 64, N 128,
// G 1, chunk 128) the call must move x, y, B, C, dt and the final state,
// 65.8 MB, against ~11 GFLOP: far below the card's ridge point in bf16.
// This version computes in f32 on the CUDA cores (no tensor cores) and
// re-reads B and C once per head, so it runs well above that bound;
// mma/wgmma tiles and sharing C B^T across a group's heads are later work.
//
// Design: one block of 256 threads per (sequence, head) walks the chunks
// in order -- the TPU grid's sequential chunk axis becomes a loop, and the
// [N, P] state stays in shared memory in f32 between chunks.  Per chunk
// the block stages in f32: x as [Q][P], B as [Q][N + 4], C transposed as
// [N][Q + 4] (the +4 keeps float4 rows 16-byte aligned and moves
// neighbouring rows to other banks), and dt; warp 0 forms the inclusive
// cumulative sum L.  Every product is register-blocked so that one
// 16-byte shared-memory load feeds at least 8 FMAs:
//   (a) inter: each thread owns 4 consecutive head-dim columns of 8
//       consecutive rows t: per state row n, one float4 of the state and
//       two float4s of C's column feed 32 FMAs;
//   (b) intra, in tiles of 32 key positions: the block forms the tile of
//       C B^T weighted by exp(L_t - L_s) dt_s, 4 x 4 entries a thread (per
//       4 state rows, 8 float4 loads feed 64 FMAs), with the entries above
//       the diagonal set to 0 explicitly (never exp of a positive
//       difference times 0), stored transposed; then each thread adds the
//       tile times x into its rows (3 float4 loads per 32 FMAs), skipping
//       keys after its last row;
//   (c) y = acc + D x is written in x's dtype, and each thread updates 8
//       consecutive state rows of its 4 columns (3 float4 loads and one
//       scalar per 32 FMAs).
// Shared memory at Q = N = 128, P = 64: 219,136 bytes, one block per SM.
//
// The C entry returns cudaErrorInvalidValue for a shape it does not take
// (P or N not a multiple of 4, P > 64, N > 128, chunk outside [1, 128],
// H not a multiple of G, pointers not aligned to 4 elements) and otherwise
// cudaGetLastError().

#include "common.cuh"

namespace {

using repro::load4;

constexpr int kThreads = 256;
constexpr int kMaxQ = 128, kMaxN = 128, kMaxP = 64;
constexpr int kTile = 32;                      // key positions per intra tile
constexpr int kColGroups = kMaxP / 4;          // float4 column groups
constexpr int kRowGroups = kThreads / kColGroups;
constexpr int kRows = kMaxQ / kRowGroups;      // consecutive rows a thread
static_assert(kRows == 8 && kMaxN / kRowGroups == 8, "8 rows a thread");

__host__ __device__ inline int padded_q(int q) {
  return (q + kTile - 1) / kTile * kTile;
}

// floats of dynamic shared memory for chunk q, state n, head dim p
__host__ __device__ inline int smem_floats(int q, int n, int p) {
  const int qp = padded_q(q);
  return (n * (qp + 4) + qp * (n + 4) + qp * p + n * p + kTile * (qp + 4) +
          3 * qp);
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& v) {
  acc.x += a * v.x;
  acc.y += a * v.y;
  acc.z += a * v.z;
  acc.w += a * v.w;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// the 8 consecutive values p[0..7] as one array
__device__ __forceinline__ void lds8(const float* p, float (&v)[8]) {
  const float4 a = lds4(p), b = lds4(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ Dv,
    T* __restrict__ y, float* __restrict__ state_out, int S, int H, int P,
    int G, int N, int Q) {
  extern __shared__ float4 smem4[];
  const int QP = padded_q(Q);
  const int LQ = QP + 4, LN = N + 4;
  float* ct = reinterpret_cast<float*>(smem4);   // [N][LQ]  C transposed
  float* bs = ct + N * LQ;                       // [QP][LN] B
  float* xs = bs + QP * LN;                      // [QP][P]  x
  float* st = xs + QP * P;                       // [N][P]   state
  float* gt = st + N * P;                        // [kTile][LQ] tile, by key
  float* lc = gt + kTile * LQ;                   // [QP] inclusive L
  float* dts = lc + QP;                          // [QP] dt
  float* ws = dts + QP;                          // [QP] exp(L_last - L_s) dt_s

  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int g = h / (H / G);
  const float a = A[h], d = Dv[h];
  const int tid = threadIdx.x;
  const int pg = tid % kColGroups;               // columns 4 pg .. 4 pg + 3
  const int r0 = kRows * (tid / kColGroups);     // rows r0 .. r0 + 7
  const int p4 = P / 4, n4 = N / 4;
  const bool col_ok = pg < p4;
  const bool rows_ok = col_ok && r0 < QP;        // this thread owns rows
  const bool nrows_ok = col_ok && r0 < N;        // ... and state rows
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int e = tid; e < N * P; e += kThreads) st[e] = 0.f;

  const int nc = (S + Q - 1) / Q;
  for (int c = 0; c < nc; ++c) {
    const int s0 = c * Q;
    __syncthreads();                             // last chunk consumed
    for (int e = tid; e < QP * p4; e += kThreads) {
      const int r = e / p4;
      float4 v = zero;
      if (r < Q && s0 + r < S)
        v = load4(x + (((int64_t)b * S + s0 + r) * H + h) * P + 4 * (e % p4));
      reinterpret_cast<float4*>(xs)[e] = v;
    }
    for (int e = tid; e < QP * n4; e += kThreads) {
      const int r = e / n4, nq = e % n4;
      float4 v = zero;
      if (r < Q && s0 + r < S)
        v = load4(Bm + (((int64_t)b * S + s0 + r) * G + g) * N + 4 * nq);
      *reinterpret_cast<float4*>(bs + r * LN + 4 * nq) = v;
    }
    for (int e = tid; e < QP * n4; e += kThreads) {
      const int r = e % QP, nq = e / QP;         // neighbours: next row
      float4 v = zero;
      if (r < Q && s0 + r < S)
        v = load4(Cm + (((int64_t)b * S + s0 + r) * G + g) * N + 4 * nq);
      float* col = ct + 4 * nq * LQ + r;
      col[0] = v.x; col[LQ] = v.y; col[2 * LQ] = v.z; col[3 * LQ] = v.w;
    }
    for (int r = tid; r < QP; r += kThreads)
      dts[r] = (r < Q && s0 + r < S) ? dt[((int64_t)b * S + s0 + r) * H + h]
                                     : 0.f;
    __syncthreads();
    if (tid < 32) {                              // L: warp 0, 4 rows a lane
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = 4 * tid + k;
        run += r < QP ? dts[r] * a : 0.f;
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += t;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = 4 * tid + k;
        if (r < QP) lc[r] = incl - run + v[k];
      }
    }
    __syncthreads();
    const float l_end = lc[QP - 1];              // padded rows add 0
    for (int r = tid; r < QP; r += kThreads)
      ws[r] = expf(l_end - lc[r]) * dts[r];

    // (a) inter: acc[i] = exp(L_t) C_t . state[:, cols], t = r0 + i
    float4 acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = zero;
    if (rows_ok) {
#pragma unroll 2
      for (int n = 0; n < N; ++n) {
        const float4 sv = lds4(st + n * P + 4 * pg);
        float cv[8];
        lds8(ct + n * LQ + r0, cv);
#pragma unroll
        for (int i = 0; i < kRows; ++i) fma4(acc[i], cv[i], sv);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float e = expf(lc[r0 + i]);
        acc[i].x *= e; acc[i].y *= e; acc[i].z *= e; acc[i].w *= e;
      }
    }

    // (b) intra, one tile of kTile key positions at a time
    for (int k0 = 0; k0 < Q; k0 += kTile) {
      __syncthreads();                           // last tile consumed
      {
        const int t0 = 4 * (tid / 8);            // rows t0 .. t0 + 3
        const int j0 = 4 * (tid % 8);            // tile keys j0 .. j0 + 3
        const int c0 = k0 + j0;
        if (t0 < QP) {
          float dot[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) dot[u][v] = 0.f;
          const bool live = c0 <= t0 + 3 && c0 < Q && t0 < Q;
          if (live) {
            for (int n = 0; n < N; n += 4) {
              float cr[4][4], br[4][4];          // [k][t], [s][k]
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const float4 v = lds4(ct + (n + k) * LQ + t0);
                cr[k][0] = v.x; cr[k][1] = v.y; cr[k][2] = v.z; cr[k][3] = v.w;
              }
#pragma unroll
              for (int v = 0; v < 4; ++v) {
                const float4 w = lds4(bs + (c0 + v) * LN + n);
                br[v][0] = w.x; br[v][1] = w.y; br[v][2] = w.z; br[v][3] = w.w;
              }
#pragma unroll
              for (int k = 0; k < 4; ++k)
#pragma unroll
                for (int u = 0; u < 4; ++u)
#pragma unroll
                  for (int v = 0; v < 4; ++v) dot[u][v] += cr[k][u] * br[v][k];
            }
          }
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int s = c0 + v;
            float o[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int t = t0 + u;
              o[u] = (live && s <= t && t < Q)
                         ? dot[u][v] * expf(lc[t] - lc[s]) * dts[s]
                         : 0.f;
            }
            *reinterpret_cast<float4*>(gt + (j0 + v) * LQ + t0) =
                make_float4(o[0], o[1], o[2], o[3]);
          }
        }
      }
      __syncthreads();
      if (rows_ok && r0 + kRows > k0) {         // keys after the last row: 0
        const int kn = min(min(kTile, Q - k0), r0 + kRows - k0);
        for (int j = 0; j < kn; ++j) {
          const float4 xv = lds4(xs + (k0 + j) * P + 4 * pg);
          float gv[8];
          lds8(gt + j * LQ + r0, gv);
#pragma unroll
          for (int i = 0; i < kRows; ++i) fma4(acc[i], gv[i], xv);
        }
      }
    }

    // (c) y = acc + D x, then the state update
    if (rows_ok) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int t = r0 + i;
        if (t < Q && s0 + t < S) {
          const float4 xv = lds4(xs + t * P + 4 * pg);
          T* o = y + (((int64_t)b * S + s0 + t) * H + h) * P + 4 * pg;
          o[0] = repro::from_f32<T>(acc[i].x + d * xv.x);
          o[1] = repro::from_f32<T>(acc[i].y + d * xv.y);
          o[2] = repro::from_f32<T>(acc[i].z + d * xv.z);
          o[3] = repro::from_f32<T>(acc[i].w + d * xv.w);
        }
      }
    }
    // state rows n = r0 .. r0 + 7; every read of the old state was in
    // (a), before the tile loop's barriers
    if (nrows_ok) {
      float4 upd[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) upd[j] = zero;
#pragma unroll 2
      for (int s = 0; s < Q; ++s) {
        float4 xv = lds4(xs + s * P + 4 * pg);
        const float w = ws[s];
        xv.x *= w; xv.y *= w; xv.z *= w; xv.w *= w;
        float bv[8];
        lds8(bs + s * LN + r0, bv);
#pragma unroll
        for (int j = 0; j < kRows; ++j) fma4(upd[j], bv[j], xv);
      }
      const float decay = expf(l_end);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (r0 + j < N) {
          float4* sp = reinterpret_cast<float4*>(st + (r0 + j) * P) + pg;
          float4 sv = *sp;
          sv.x = sv.x * decay + upd[j].x;
          sv.y = sv.y * decay + upd[j].y;
          sv.z = sv.z * decay + upd[j].z;
          sv.w = sv.w * decay + upd[j].w;
          *sp = sv;
        }
      }
    }
  }
  __syncthreads();
  float* so = state_out + ((int64_t)b * H + h) * N * P;
  for (int e = tid; e < N * P; e += kThreads) so[e] = st[e];
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, const float* D, void* y, float* state, int Bt,
           int S, int H, int P, int G, int N, int Q, cudaStream_t stream) {
  const int smem = smem_floats(Q, N, P) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<T><<<Bt * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), D, static_cast<T*>(y), state, S, H, P, G, N,
      Q);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes (x, B, C, y): 0 = float32, 1 = bfloat16; dt, A, D and the
// state are float32.  x, y [Bt, S, H, P]; dt [Bt, S, H]; A, D [H];
// B, C [Bt, S, G, N]; state [Bt, H, N, P]; all contiguous.
extern "C" int ssd(const void* x, const float* dt, const float* A,
                   const void* B, const void* C, const float* D, void* y,
                   float* state, int Bt, int S, int H, int P, int G, int N,
                   int chunk, int dtype, void* stream) {
  if (P < 4 || P > kMaxP || P % 4 || N < 4 || N > kMaxN || N % 4 ||
      chunk < 1 || chunk > kMaxQ || G < 1 || H < 1 || H % G || S < 0)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(B) | reinterpret_cast<uintptr_t>(C)) %
      (dtype == 1 ? 8 : 16))                     // load4 reads 4 elements
    return (int)cudaErrorInvalidValue;
  if (Bt == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, B, C, D, y, state, Bt, S, H, P, G, N,
                         chunk, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, B, C, D, y, state, Bt, S, H, P, G,
                                 N, chunk, s);
  return (int)cudaErrorInvalidValue;
}
