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
// 65.8 MB (0.0196 ms at 3.35 TB/s), against 11.3 GFLOP (0.0114 ms at the
// bf16 tensor-core rate, 0.17 ms at the f32 rate of the CUDA cores).
//
// Two variants of one function; the wrapper (kernel.py) picks one by
// dtype, widths, chunk and alignment before the launch and never falls
// back.
//
// 1. Tensor cores (ssd_cb_kernel, then ssd_tc_kernel; bf16, P, N and the
//    chunk multiples of 16 up to 64, 128 and 128, x, B and C aligned to 16
//    bytes).  Every product is mma.sync m16n8k16 with bf16 operands and f32
//    accumulation; x, B and C enter exactly, and the three f32 operands
//    enter as bf16 hi + lo (two products each): bf16 alone puts ~10% of y
//    outside one bf16 step of ref.ssd_chunked (tests/test_torch_ssd.py).
//    (a) The pre-pass: one block per (sequence, chunk, group) stages the
//        chunk's C and B and writes the 16 x 16 tiles of C B^T on and below
//        the diagonal to an f32 scratch buffer (the wrapper's; 1.2 MB at the
//        prefill shape, so it stays in the L2), each lane's accumulators as
//        they lie in its registers.  The H / G heads of a group read it
//        instead of each forming it.
//    (b) The scan: one block of 8 warps per (sequence, head) walks the
//        chunks in order.  Per chunk it stages C and B as [Q][N] and x as
//        [Q][P] in bf16 and dt in f32 by cp.async (16-byte chunk c of row r
//        stored at c ^ (r & 7): ldmatrix reads free of bank conflicts);
//        warp 0 forms L.  Warp w owns the query rows 16 w .. 16 w + 15:
//          inter  acc = exp(L_t) C_t . state, C by ldmatrix, the state from
//                 [P][N] bf16 hi and lo tiles;
//          intra  per tile of 16 keys up to the diagonal, the C B^T tile
//                 from the scratch (the next tile loading meanwhile) times
//                 exp(L_t - L_s) dt_s, the entries above the diagonal set
//                 to 0 explicitly (never exp of a positive difference),
//                 split into hi + lo A fragments in registers, times x
//                 (ldmatrix.trans);
//          y = acc + D x in bf16.
//        The state stays in f32 accumulators, state^T [P][N] over the 8
//        warps (32 values a thread): state^T <- exp(L_end) state^T +
//        (x w)^T B, x w formed and split in registers from an
//        ldmatrix.trans of x; at the chunk's end it is written to the hi
//        and lo tiles for the next chunk's inter product.
//    Shared memory: 2 Q N + Q P + 2 P N bf16 and 2 Q f32, 115,712 bytes at
//    the prefill's widths: two blocks of 256 threads per SM, each thread
//    at most 128 registers.  P 64, N 128, chunk 128 are compile-time
//    constants (every loop unrolled); other widths take them at run time.
//    The decays are __expf (ex2.approx of x log2 e): within ~6e-6
//    relative of exp for x >= -87 (below, a decay is under 1e-38), no
//    more than the hi + lo split's own 2^-17.
//    Measured at the prefill shape (NVIDIA H100 80GB HBM3, 700 W), each
//    alternative built with a compile-time switch since dropped and timed
//    against this design in the same call: this design 0.1159-0.1173 ms;
//    C B^T formed in each head's block instead of by the pre-pass
//    0.1275-0.1292; run-time widths at the prefill's shape too
//    0.1576-0.1588; one block per SM with no register cap (142-156
//    registers) 0.1429-0.1468; expf for the decays 0.1192-0.1203; each
//    lane forming the four w_s it uses 0.1231-0.1244; both 0.1264-0.1270;
//    the key-tile loop unrolled 0.1193-0.1206.  Against the design before those two changes
//    (0.1260-0.1275 in the same calls): 16 warps a block at 64 registers
//    (spills) 0.1575-0.1580; each warp on row tiles w % 4 and 7 - w % 4
//    with half the head dim (as many key tiles per warp) 0.1371-0.1388;
//    the state update first with the next chunk's B loading under the y
//    phase 0.1312-0.1316.  The first version (run-time widths, C B^T in
//    the block, expf) ran 0.170.  At 6x its bound the kernel is held
//    back by instruction issue and latency: occupancy, compile-time
//    widths and fewer instructions moved it; rearranging loads, balancing
//    the warps and unrolling the key tiles did not.
//
// 2. CUDA cores (ssd_kernel; f32, and bf16 at other widths or chunks).  One
//    block of 256 threads per (sequence, head) walks the chunks in order,
//    the [N, P] state in shared memory in f32 between chunks.  Per chunk
//    the block stages in f32: x as [Q][P], B as [Q][N + 4], C transposed
//    as [N][Q + 4] (the +4 keeps float4 rows 16-byte aligned and moves
//    neighbouring rows to other banks), and dt; warp 0 forms the inclusive
//    cumulative sum L.  Every product is register-blocked so that one
//    16-byte shared-memory load feeds at least 8 FMAs:
//    (a) inter: each thread owns 4 consecutive head-dim columns of 8
//        consecutive rows t: per state row n, one float4 of the state and
//        two float4s of C's column feed 32 FMAs;
//    (b) intra, in tiles of 32 key positions: the block forms the tile of
//        C B^T weighted by exp(L_t - L_s) dt_s, 4 x 4 entries a thread
//        (per 4 state rows, 8 float4 loads feed 64 FMAs), with the entries
//        above the diagonal set to 0 explicitly, stored transposed; then
//        each thread adds the tile times x into its rows (3 float4 loads
//        per 32 FMAs), skipping keys after its last row;
//    (c) y = acc + D x is written in x's dtype, and each thread updates 8
//        consecutive state rows of its 4 columns (3 float4 loads and one
//        scalar per 32 FMAs).
//    Shared memory at Q = N = 128, P = 64: 219,136 bytes, one block per
//    SM; 0.80 ms at the prefill shape in bf16 and f32.
//
// The C entry returns cudaErrorInvalidValue for a shape the asked variant
// does not take (H not a multiple of G; the CUDA-core variant: P or N not
// a multiple of 4, P > 64, N > 128, chunk outside [1, 128], pointers not
// aligned to 4 elements; the tensor-core variant: not bf16, P, N or the
// chunk not a multiple of 16 or above 64, 128, 128, x, B, C not aligned
// to 16 bytes, y not to 4, no scratch) and otherwise cudaGetLastError().

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::cp_async16;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::load4;
using repro::mma_bf16;
using repro::split_bf16;

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

// -- tensor-core variant ----------------------------------------------------

constexpr int kTcThreads = 256;                // 8 warps, two blocks per SM

// 4 bytes from global to shared memory, asynchronously; zeros where !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   repro::smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// The XOR mask of a swizzled row of ch 16-byte chunks: chunk c of row r is
// stored at c ^ (r & mask), which stays inside the row because mask + 1
// divides ch, and spreads 8 consecutive rows over 8 bank groups when 8 does.
__device__ __forceinline__ int swizzle_mask(int ch) {
  return (ch & 7) == 0 ? 7 : (ch & 3) == 0 ? 3 : (ch & 1) == 0 ? 1 : 0;
}

// byte offset of element (row, 8 * chunk) of a swizzled [rows][8 ch] tile
__device__ __forceinline__ uint32_t swz(int row, int chunk, int ch,
                                        int mask) {
  return (uint32_t)(row * ch + (chunk ^ (row & mask))) * 16u;
}

// 16 x 16 tiles of C B^T on and below the diagonal of a chunk of q rows;
// tile (rt, kt), kt <= rt, is number rt (rt + 1) / 2 + kt
__host__ __device__ inline int cb_tiles(int q) {
  return (q / 16) * (q / 16 + 1) / 2;
}

// rows q of C or B (src) from position s0 of sequence b, group g, into
// the swizzled [q][n] tile dst (zeros past S); not committed
__device__ __forceinline__ void load_gn(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src, int b,
                                        int s0, int S, int G, int g, int N,
                                        int Q) {
  const int nch = N / 8, nmask = swizzle_mask(nch);
  for (int e = threadIdx.x; e < Q * nch; e += kTcThreads) {
    const int r = e / nch, ch = e % nch;
    const bool ok = s0 + r < S;
    const int64_t row = ((int64_t)b * S + (ok ? s0 + r : 0)) * G + g;
    cp_async16(reinterpret_cast<char*>(dst) + swz(r, ch, nch, nmask),
               src + row * N + 8 * ch, ok);
  }
}

// cb = C_t . B_s for the 16 rows t of row tile rt and the 16 keys s of key
// tile kt, from the swizzled tiles at cs_a and bs_a: two m16n8
// accumulators (keys 16 kt .. + 7 and + 8 .. + 15)
template <int kN>
__device__ __forceinline__ void cb_product(float (&cb)[2][4], uint32_t cs_a,
                                           uint32_t bs_a, int rt, int kt,
                                           int n_arg) {
  const int N = kN ? kN : n_arg;
  const int nch = N / 8, nmask = swizzle_mask(nch);
  const int lane = threadIdx.x & 31;
  const int a_row = lane & 15, a_chunk = lane >> 4;
  const int k_row = (lane & 7) + ((lane >> 4) << 3);
  const int k_chunk = (lane >> 3) & 1;
#pragma unroll
  for (int j = 0; j < 2; ++j) cb[j][0] = cb[j][1] = cb[j][2] = cb[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    uint32_t ca[4], bb[4];
    ldmatrix_x4(ca, cs_a + swz(16 * rt + a_row, 2 * ks + a_chunk, nch, nmask));
    ldmatrix_x4(bb, bs_a + swz(16 * kt + k_row, 2 * ks + k_chunk, nch, nmask));
    mma_bf16(cb[0], ca, bb[0], bb[1]);
    mma_bf16(cb[1], ca, bb[2], bb[3]);
  }
}

// The pre-pass: one block per (sequence, chunk, group) stages the chunk's
// C and B and writes every tile of C B^T on and below the diagonal to
// cbs[(b nc + c) G + g][tile][lane][8] in f32, each lane's two m16n8
// accumulators as they lie in its registers, so that a warp reads a tile
// back as 1 KB of whole lines.
template <int kN, int kQ>
__global__ void __launch_bounds__(kTcThreads) ssd_cb_kernel(
    const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ Cm,
    float* __restrict__ cbs, int S, int G, int n_arg, int q_arg) {
  const int N = kN ? kN : n_arg, Q = kQ ? kQ : q_arg;
  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* bs = cs + Q * N;
  const int nc = (S + Q - 1) / Q;
  const int g = blockIdx.x % G;
  const int c = (blockIdx.x / G) % nc;
  const int b = blockIdx.x / G / nc;
  load_gn(cs, Cm, b, c * Q, S, G, g, N, Q);
  load_gn(bs, Bm, b, c * Q, S, G, g, N, Q);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = cb_tiles(Q);
  float* out = cbs + (int64_t)blockIdx.x * tiles * 256 + lane * 8;
  for (int i = warp; i < tiles; i += kTcThreads / 32) {
    int rt = 0;
    while ((rt + 1) * (rt + 2) / 2 <= i) ++rt;
    float cb[2][4];
    cb_product<kN>(cb, repro::smem_addr(cs), repro::smem_addr(bs), rt,
                   i - rt * (rt + 1) / 2, N);
    float4* o = reinterpret_cast<float4*>(out + i * 256);
    o[0] = make_float4(cb[0][0], cb[0][1], cb[0][2], cb[0][3]);
    o[1] = make_float4(cb[1][0], cb[1][1], cb[1][2], cb[1][3]);
  }
}

// bytes of dynamic shared memory for chunk q, state n, head dim p
__host__ __device__ inline int tc_smem_bytes(int q, int n, int p) {
  return 2 * (2 * q * n + q * p + 2 * p * n) + 2 * q * 4;
}

// kP, kN, kQ: the head dim, state size and chunk fixed at compile time
// (loops unrolled), or 0 to take them from the arguments
template <int kP, int kN, int kQ>
__global__ void __launch_bounds__(kTcThreads, 2)
    ssd_tc_kernel(const __nv_bfloat16* __restrict__ x,
                  const float* __restrict__ dt, const float* __restrict__ A,
                  const __nv_bfloat16* __restrict__ Bm,
                  const __nv_bfloat16* __restrict__ Cm,
                  const float* __restrict__ Dv, __nv_bfloat16* __restrict__ y,
                  float* __restrict__ state_out,
                  const float* __restrict__ cbs, int S, int H, int p_arg,
                  int G, int n_arg, int q_arg) {
  const int P = kP ? kP : p_arg, N = kN ? kN : n_arg, Q = kQ ? kQ : q_arg;
  extern __shared__ uint4 smem_tc[];
  // [Q][N] C, [Q][N] B, [Q][P] x, [P][N] state hi, [P][N] state lo (all
  // bf16, swizzled), [Q] L, [Q] dt (f32)
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* bs = cs + Q * N;
  __nv_bfloat16* xs = bs + Q * N;
  __nv_bfloat16* sh = xs + Q * P;
  __nv_bfloat16* sl = sh + P * N;
  float* lc = reinterpret_cast<float*>(sl + P * N);
  float* dts = lc + Q;
  const uint32_t cs_a = repro::smem_addr(cs), bs_a = repro::smem_addr(bs);
  const uint32_t xs_a = repro::smem_addr(xs), sh_a = repro::smem_addr(sh);
  const uint32_t sl_a = repro::smem_addr(sl);

  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int g = h / (H / G);
  const float a = A[h], d = Dv[h];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2;                      // fragment row (and + 8)
  const int gc = (lane & 3) * 2;                 // fragment column pair
  const int nch = N / 8, pch = P / 8;            // 16-byte chunks per row
  const int nmask = swizzle_mask(nch), pmask = swizzle_mask(pch);
  // ldmatrix row and chunk of this lane: A fragments (a0..a3) and the B
  // operand of a K-contiguous tile (K3's K) / of a K-by-rows tile (K3's V)
  const int a_row = lane & 15, a_chunk = lane >> 4;
  const int k_row = (lane & 7) + ((lane >> 4) << 3);
  const int k_chunk = (lane >> 3) & 1;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int v_chunk = lane >> 4;

  // y: warp w owns query rows 16 w .. 16 w + 15 (while 16 w < Q)
  const int rt = warp;
  const bool y_ok = 16 * rt < Q;
  // state^T [P][N] in accumulators: warp w owns head-dim rows 16 (w % 4)
  // .. + 15 and the 8-column tiles 8 (w / 4) .. + 7 of the state rows
  const int pt = warp & 3, nt0 = 8 * (warp >> 2);
  const bool st_ok = 16 * pt < P && nt0 < nch;
  float st[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;

  // C, B, x and dt of the chunk at s0 (zeros past S), as one group
  auto load_chunk = [&](int s0) {
    load_gn(cs, Cm, b, s0, S, G, g, N, Q);
    load_gn(bs, Bm, b, s0, S, G, g, N, Q);
    for (int e = tid; e < Q * pch; e += kTcThreads) {
      const int r = e / pch, ch = e % pch;
      const bool ok = s0 + r < S;
      const int64_t row = ((int64_t)b * S + (ok ? s0 + r : 0)) * H + h;
      cp_async16(reinterpret_cast<char*>(xs) + swz(r, ch, pch, pmask),
                 x + row * P + 8 * ch, ok);
    }
    for (int r = tid; r < Q; r += kTcThreads) {
      const bool ok = s0 + r < S;
      cp_async4(dts + r, dt + ((int64_t)b * S + (ok ? s0 + r : 0)) * H + h,
                ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int nc = (S + Q - 1) / Q;
  if (nc > 0) load_chunk(0);
  for (int c = 0; c < nc; ++c) {
    const int s0 = c * Q;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();                             // chunk c and state in smem
    if (warp == 0) {                             // L: 4 rows a lane
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = 4 * lane + k;
        run += r < Q ? dts[r] * a : 0.f;
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = 4 * lane + k;
        if (r < Q) lc[r] = incl - run + v[k];
      }
    }
    __syncthreads();
    const float l_end = lc[Q - 1];

    if (y_ok) {
      const int t0 = 16 * rt + gr, t1 = t0 + 8;
      const float l0 = lc[t0], l1 = lc[t1];
      float acc[8][4];                           // 8-column tiles of P
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      // inter: acc = exp(L_t) C_t . state, the state as bf16 hi + lo
      if (c > 0) {
#pragma unroll
        for (int ks = 0; ks < N / 16; ++ks) {
          uint32_t ca[4];
          ldmatrix_x4(ca, cs_a + swz(16 * rt + a_row, 2 * ks + a_chunk, nch,
                                     nmask));
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            if (16 * jp < P) {
              const uint32_t o = swz(16 * jp + k_row, 2 * ks + k_chunk, nch,
                                     nmask);
              uint32_t bh[4], bl[4];
              ldmatrix_x4(bh, sh_a + o);
              ldmatrix_x4(bl, sl_a + o);
              mma_bf16(acc[2 * jp], ca, bh[0], bh[1]);
              mma_bf16(acc[2 * jp], ca, bl[0], bl[1]);
              mma_bf16(acc[2 * jp + 1], ca, bh[2], bh[3]);
              mma_bf16(acc[2 * jp + 1], ca, bl[2], bl[3]);
            }
          }
        }
        const float e0 = __expf(l0), e1 = __expf(l1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j][0] *= e0; acc[j][1] *= e0;
          acc[j][2] *= e1; acc[j][3] *= e1;
        }
      }
      // intra, one tile of 16 keys at a time up to the diagonal
      // this row tile's C B^T tiles, the next loading while one is used
      const float4* cbp = reinterpret_cast<const float4*>(
          cbs + ((((int64_t)b * nc + c) * G + g) * cb_tiles(Q) +
                 rt * (rt + 1) / 2) * 256 + lane * 8);
      float4 nu = cbp[0], nv = cbp[1];
      for (int kt = 0; kt <= rt; ++kt) {
        float cb[2][4];
        cb[0][0] = nu.x; cb[0][1] = nu.y; cb[0][2] = nu.z; cb[0][3] = nu.w;
        cb[1][0] = nv.x; cb[1][1] = nv.y; cb[1][2] = nv.z; cb[1][3] = nv.w;
        if (kt < rt) {
          nu = cbp[64 * (kt + 1)];
          nv = cbp[64 * (kt + 1) + 1];
        }
        // weight exp(L_t - L_s) dt_s, exactly 0 above the diagonal
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = e < 2 ? t0 : t1;
            const int s = 16 * kt + 8 * j + gc + (e & 1);
            cb[j][e] = s <= t ? cb[j][e] *
                                    __expf((e < 2 ? l0 : l1) - lc[s]) * dts[s]
                              : 0.f;
          }
        }
        uint32_t ph[4], pl[4];
        split_bf16(cb[0][0], cb[0][1], ph[0], pl[0]);
        split_bf16(cb[0][2], cb[0][3], ph[1], pl[1]);
        split_bf16(cb[1][0], cb[1][1], ph[2], pl[2]);
        split_bf16(cb[1][2], cb[1][3], ph[3], pl[3]);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (16 * jp < P) {
            uint32_t bx[4];
            ldmatrix_x4_trans(bx, xs_a + swz(16 * kt + v_row, 2 * jp + v_chunk,
                                             pch, pmask));
            mma_bf16(acc[2 * jp], ph, bx[0], bx[1]);
            mma_bf16(acc[2 * jp], pl, bx[0], bx[1]);
            mma_bf16(acc[2 * jp + 1], ph, bx[2], bx[3]);
            mma_bf16(acc[2 * jp + 1], pl, bx[2], bx[3]);
          }
        }
      }
      // y = acc + D x in bf16, rows inside the sequence
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int t = rr ? t1 : t0;
        if (s0 + t >= S) continue;
        __nv_bfloat16* dst = y + (((int64_t)b * S + s0 + t) * H + h) * P + gc;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (8 * j < P) {
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    reinterpret_cast<const char*>(xs) +
                    swz(t, j, pch, pmask) + 2 * gc));
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
                __floats2bfloat162_rn(acc[j][2 * rr] + d * xv.x,
                                      acc[j][2 * rr + 1] + d * xv.y);
          }
        }
      }
    }

    // state^T <- exp(L_end) state^T + (x w)^T B, w_s = exp(L_end - L_s) dt_s,
    // x w as bf16 hi + lo
    if (st_ok) {
      const float decay = __expf(l_end);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        st[j][0] *= decay; st[j][1] *= decay;
        st[j][2] *= decay; st[j][3] *= decay;
      }
#pragma unroll
      for (int ks = 0; ks < Q / 16; ++ks) {
        uint32_t xa[4];
        ldmatrix_x4_trans(xa, xs_a + swz(16 * ks + k_row, 2 * pt + k_chunk,
                                         pch, pmask));
        // xa[i] holds (p, s), (p, s + 1): s = 16 ks + gc (+ 8 for i >= 2)
        // w_s for the 16 keys of this step, one a lane, shared by shuffle
        const int so = 16 * ks + (lane & 15);
        const float wo = __expf(l_end - lc[so]) * dts[so];
        const float wa0 = __shfl_sync(0xffffffffu, wo, gc);
        const float wa1 = __shfl_sync(0xffffffffu, wo, gc + 1);
        const float wb0 = __shfl_sync(0xffffffffu, wo, gc + 8);
        const float wb1 = __shfl_sync(0xffffffffu, wo, gc + 9);
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xa[i]));
          split_bf16(xv.x * (i < 2 ? wa0 : wb0), xv.y * (i < 2 ? wa1 : wb1),
                     ah[i], al[i]);
        }
#pragma unroll
        for (int jq = 0; jq < 4; ++jq) {
          if (nt0 + 2 * jq < nch) {
            uint32_t bb[4];
            ldmatrix_x4_trans(bb, bs_a + swz(16 * ks + v_row,
                                             nt0 + 2 * jq + v_chunk, nch,
                                             nmask));
            mma_bf16(st[2 * jq], ah, bb[0], bb[1]);
            mma_bf16(st[2 * jq], al, bb[0], bb[1]);
            mma_bf16(st[2 * jq + 1], ah, bb[2], bb[3]);
            mma_bf16(st[2 * jq + 1], al, bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();                             // chunk c consumed
    if (c + 1 < nc) {
      // the new state as bf16 hi + lo for the next chunk's inter product
      if (st_ok) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (nt0 + j < nch) {
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int pr = 16 * pt + gr + 8 * rr;
              const uint32_t o = swz(pr, nt0 + j, nch, nmask) + 2 * gc;
              uint32_t hi, lo;
              split_bf16(st[j][2 * rr], st[j][2 * rr + 1], hi, lo);
              *reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(sh) + o) =
                  hi;
              *reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(sl) + o) =
                  lo;
            }
          }
        }
      }
      load_chunk(s0 + Q);
    }
  }
  // the final state, [N][P] f32, through shared memory ([N][P + 4]) so
  // that the stores to device memory are whole rows
  float* so = reinterpret_cast<float*>(smem_tc);
  const int lp = P + 4;
  if (st_ok) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (nt0 + j < nch) {
        const int n = 8 * (nt0 + j) + gc;
        const int pr = 16 * pt + gr;
        so[n * lp + pr] = st[j][0];
        so[(n + 1) * lp + pr] = st[j][1];
        so[n * lp + pr + 8] = st[j][2];
        so[(n + 1) * lp + pr + 8] = st[j][3];
      }
    }
  }
  __syncthreads();
  float* out = state_out + ((int64_t)b * H + h) * N * P;
  for (int e = tid; e < N * P; e += kTcThreads)
    out[e] = so[(e / P) * lp + e % P];
}

// the instantiation for this shape: compile-time at the prefill's widths
// (mamba2-780m: P 64, N 128, chunk 128), run-time for the rest
using TcKernel = void (*)(const __nv_bfloat16*, const float*, const float*,
                          const __nv_bfloat16*, const __nv_bfloat16*,
                          const float*, __nv_bfloat16*, float*, const float*,
                          int, int, int, int, int, int);
using CbKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, float*,
                          int, int, int, int);
bool compile_time_shape(int P, int N, int Q) {
  return P == 64 && N == 128 && Q == 128;
}
TcKernel tc_kernel_for(int P, int N, int Q) {
  return compile_time_shape(P, N, Q) ? ssd_tc_kernel<64, 128, 128>
                                     : ssd_tc_kernel<0, 0, 0>;
}
CbKernel cb_kernel_for(int P, int N, int Q) {
  return compile_time_shape(P, N, Q) ? ssd_cb_kernel<128, 128>
                                     : ssd_cb_kernel<0, 0>;
}

template <typename Kernel>
cudaError_t tc_prepare(Kernel k, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(k,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

int launch_tc(const void* x, const float* dt, const float* A, const void* B,
              const void* C, const float* D, void* y, float* state,
              float* scratch, int Bt, int S, int H, int P, int G, int N,
              int Q, cudaStream_t stream) {
  const auto* Bb = static_cast<const __nv_bfloat16*>(B);
  const auto* Cb = static_cast<const __nv_bfloat16*>(C);
  const int nc = (S + Q - 1) / Q;
  cudaError_t err;
  if (nc > 0) {
    const CbKernel kc = cb_kernel_for(P, N, Q);
    const int smem_cb = 2 * Q * N * (int)sizeof(__nv_bfloat16);
    err = tc_prepare(kc, smem_cb);
    if (err != cudaSuccess) return (int)err;
    kc<<<Bt * nc * G, kTcThreads, smem_cb, stream>>>(Bb, Cb, scratch, S, G,
                                                     N, Q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const TcKernel k = tc_kernel_for(P, N, Q);
  const int smem = tc_smem_bytes(Q, N, P);
  err = tc_prepare(k, smem);
  if (err != cudaSuccess) return (int)err;
  k<<<Bt * H, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, A, Bb, Cb, D,
      static_cast<__nv_bfloat16*>(y), state, scratch, S, H, P, G, N, Q);
  return (int)cudaGetLastError();
}

// the tensor-core variant takes P, N and the chunk in multiples of 16 up
// to 64, 128 and 128
bool tc_takes(int P, int N, int Q) {
  return P >= 16 && P <= 64 && P % 16 == 0 && N >= 16 && N <= kMaxN &&
         N % 16 == 0 && Q >= 16 && Q <= kMaxQ && Q % 16 == 0;
}

}  // namespace

// dtype codes (x, B, C, y): 0 = float32, 1 = bfloat16; dt, A, D and the
// state are float32.  x, y [Bt, S, H, P]; dt [Bt, S, H]; A, D [H];
// B, C [Bt, S, G, N]; state [Bt, H, N, P]; all contiguous.  variant: 0 =
// CUDA cores (any dtype), 1 = tensor cores (bf16).  scratch: f32, at least
// ssd_tc_scratch_floats(...) of them (the tensor-core variant's C B^T).
extern "C" int ssd(const void* x, const float* dt, const float* A,
                   const void* B, const void* C, const float* D, void* y,
                   float* state, float* scratch, int Bt, int S, int H, int P,
                   int G, int N, int chunk, int dtype, int variant,
                   void* stream) {
  if (G < 1 || H < 1 || H % G || S < 0) return (int)cudaErrorInvalidValue;
  const uintptr_t xbc = reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(B) |
                        reinterpret_cast<uintptr_t>(C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    // cp.async moves x, B and C in 16-byte chunks; y goes by element pairs
    if (dtype != 1 || !tc_takes(P, N, chunk) || xbc % 16 ||
        reinterpret_cast<uintptr_t>(y) % 4 ||
        (S > 0 && Bt > 0 && scratch == nullptr))
      return (int)cudaErrorInvalidValue;
    if (Bt == 0) return (int)cudaSuccess;
    return launch_tc(x, dt, A, B, C, D, y, state, scratch, Bt, S, H, P, G, N,
                     chunk, s);
  }
  if (variant != 0 || P < 4 || P > kMaxP || P % 4 || N < 4 || N > kMaxN ||
      N % 4 || chunk < 1 || chunk > kMaxQ)
    return (int)cudaErrorInvalidValue;
  if ((xbc | reinterpret_cast<uintptr_t>(y)) % (dtype == 1 ? 8 : 16))
    return (int)cudaErrorInvalidValue;           // load4 reads 4 elements
  if (Bt == 0) return (int)cudaSuccess;
  if (dtype == 0)
    return launch<float>(x, dt, A, B, C, D, y, state, Bt, S, H, P, G, N,
                         chunk, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, B, C, D, y, state, Bt, S, H, P, G,
                                 N, chunk, s);
  return (int)cudaErrorInvalidValue;
}

// f32 scratch values the tensor-core variant needs for these sizes
extern "C" long long ssd_tc_scratch_floats(int Bt, int S, int G, int chunk) {
  if (chunk < 16) return 0;
  return (long long)Bt * ((S + chunk - 1) / chunk) * G * cb_tiles(chunk) *
         256;
}
