// K4 flash_decode for Hopper (sm_90a): one new token per sequence attends
// to its contiguous (batch-layout) KV cache, with a length mask and an
// optional sliding window.
//
// Replaces the TPU kernel
//   repro/kernels/paged_decode/flash.py::flash_decode (_decode_kernel).
// Bound: bytes.  Every attended K and V row is read once from device
// memory and used by only the G query heads of its KV head (2 for
// qwen3-0.6b): about G * 4 floating-point operations per byte, far below
// the H100's ridge point.  So the design is about keeping many bytes in
// flight on every SM.
//
// Design: the walk over positions is split across blocks.  One block of W
// warps per (split of kSplit = 64 positions, KV head, sequence): 512 blocks
// at the serving shape (B 8, Hkv 8, S 512) instead of one per (sequence,
// KV head).  S is known on the host; the lengths stay on the device, and a
// block whose split lies outside its row's attended range
// [max(0, len - window), min(len, S)) only counts itself in (below) and
// exits.  A half-warp reads one K or V row in units of U bytes, 16 lanes
// side by side (U = 16, 8 or 4: the widest that divides the row and
// aligns the K and V pointers; UPL units a lane when a row has more than
// 16), so at D = 128 in bf16 a warp instruction moves two whole rows.
// Each warp loads all of its 2 * NP rows of K and V into registers before
// it uses the first.  Every row then gives the G query heads of the group
// their dot products from registers (loaded once for all G), each summed
// across its half-warp by four shuffles; per head the warp folds its rows
// into (m, l, acc) in f32, the block merges its warps' records in warp
// order through shared memory and writes the split's unnormalised record
// (acc[D], m, l) to a scratch buffer.
//
// Merge: one launch per call.  Each block, after writing its records,
// fences and adds one to a counter of its (sequence, KV head); the block
// that brings it to the number of splits merges that row's records by
// log-sum-exp, in order of split index, and resets the counter to 0 for
// the next launch.  Which block merges depends on timing; what it computes
// does not, so two launches on the same inputs give the same bits.  It
// writes the output normalised by the local l, with m and l beside it, so
// that partials over several KV shards can be merged
// (flash_ops.merge_partials).  A row with length 0 gives out = 0,
// m = -1e30, l = 0, as the TPU kernel does.  scale multiplies the q.k
// product.  Any S is taken.
//
// Earlier versions: the first loaded one bf16 element per lane and load
// (0.17 ms per call at the serving shapes on an H100); the second, one
// block of 8 warps per (sequence, KV head) sharing K2's warp walk
// (decode_attend.cuh, still K2's), took 0.038 ms: 64 blocks on 132 SMs,
// and each K/V row fetched once per query head.
//
// The C entry returns cudaErrorInvalidValue for a head dim or group it does
// not take (D even, 2..256; G >= 1; pointers aligned to an element pair)
// and otherwise cudaGetLastError().  The caller passes scratch of
// B * Hkv * max(1, ceil(S / 64)) * G * (D + 2) floats and B * Hkv counters
// that are 0 (the kernel leaves them 0).

#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int kSplit = 64;              // positions per block

template <int U> struct Unit;
template <> struct Unit<16> { using T = uint4; };
template <> struct Unit<8> { using T = uint2; };
template <> struct Unit<4> { using T = uint32_t; };

// A lane holds UPL units of U bytes of each of NP rows of K and of V: at
// most 64 registers for both, and 2 * NP rows per warp, W warps per split.
template <typename Tkv, int U, int UPL>
struct Shape {
  static constexpr int E = U / (int)sizeof(Tkv);   // elements per unit
  static constexpr int NP = 32 / (UPL * U / 4) < 8 ? 32 / (UPL * U / 4) : 8;
  static constexpr int W = kSplit / (2 * NP);
};

template <typename Tkv, int U>
__device__ __forceinline__ float elem(const typename Unit<U>::T& u, int e) {
  return repro::to_f32(reinterpret_cast<const Tkv*>(&u)[e]);
}

__device__ __forceinline__ float minus_inf() {
  return __int_as_float(0xff800000);
}

template <typename Tkv, int U, int UPL>
__global__ void __launch_bounds__(Shape<Tkv, U, UPL>::W * 32)
    flash_decode_kernel(const void* __restrict__ q, int q_bf16,
                        const Tkv* __restrict__ k, const Tkv* __restrict__ v,
                        const int32_t* __restrict__ lengths,
                        void* __restrict__ out, float* __restrict__ m_out,
                        float* __restrict__ l_out, float* __restrict__ part,
                        unsigned* __restrict__ count, int Hkv, int G, int S,
                        int D, int window, float scale) {
  using V = typename Unit<U>::T;
  constexpr int E = Shape<Tkv, U, UPL>::E;
  constexpr int NP = Shape<Tkv, U, UPL>::NP;
  constexpr int W = Shape<Tkv, U, UPL>::W;
  extern __shared__ float rec[];                   // [W][D + 2]
  __shared__ int merger;
  const int j = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_split = gridDim.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int sub = lane & 15;
  const int len = lengths[b];
  const int lo = (window > 0 && len > window) ? len - window : 0;
  const int hi = min(len, S);
  const int64_t row = (int64_t)b * Hkv + h;        // (sequence, KV head)
  const int rec_len = D + 2;
  const int nu = D / E;                            // units per K/V row
  const int s_lo = max(lo, j * kSplit);
  const int s_hi = min(hi, (j + 1) * kSplit);

  if (s_lo < s_hi) {
    // this lane's rows: p0, p0 + 2, ..., each read by its half-warp
    V kr[NP][UPL], vr[NP][UPL];
    bool ok[NP];
    const int p0 = j * kSplit + warp * 2 * NP + half;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int pos = p0 + 2 * p;
      ok[p] = pos >= s_lo && pos < s_hi;
      const V* kp = reinterpret_cast<const V*>(k + (row * S + pos) * D);
      const V* vp = reinterpret_cast<const V*>(v + (row * S + pos) * D);
#pragma unroll
      for (int i = 0; i < UPL; ++i) {
        const int u = sub + 16 * i;
        kr[p][i] = ok[p] && u < nu ? kp[u] : V{};
        vr[p][i] = ok[p] && u < nu ? vp[u] : V{};
      }
    }
    float* part_row = part + (row * n_split + j) * G * rec_len;
    for (int g = 0; g < G; ++g) {
      // this lane's elements of query head g, in f32
      float qf[UPL][E];
      const int64_t qh = (row * G + g) * D;
#pragma unroll
      for (int i = 0; i < UPL; ++i) {
        const int u = sub + 16 * i;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int64_t idx = qh + u * E + e;
          qf[i][e] = u >= nu ? 0.f
                     : q_bf16 ? __bfloat162float(
                                    static_cast<const __nv_bfloat16*>(q)[idx])
                              : static_cast<const float*>(q)[idx];
        }
      }
      float s[NP];
      float mx = minus_inf();
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < UPL; ++i)
#pragma unroll
          for (int e = 0; e < E; ++e)
            dot += qf[i][e] * elem<Tkv, U>(kr[p][i], e);
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[p] = ok[p] ? dot * scale : minus_inf();
        mx = fmaxf(mx, s[p]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m = fmaxf(mx, kNegInf);          // no row: -1e30
      float l = 0.f;
      float acc[UPL][E];
#pragma unroll
      for (int i = 0; i < UPL; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const float pr = expf(s[p] - m);           // masked: exactly 0
        l += pr;
#pragma unroll
        for (int i = 0; i < UPL; ++i)
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[i][e] += pr * elem<Tkv, U>(vr[p][i], e);
      }
      l += __shfl_xor_sync(0xffffffffu, l, 16);
#pragma unroll
      for (int i = 0; i < UPL; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], 16);
      float* r = rec + warp * rec_len;
      if (half == 0) {
#pragma unroll
        for (int i = 0; i < UPL; ++i) {
          const int u = sub + 16 * i;
          if (u < nu) {
#pragma unroll
            for (int e = 0; e < E; ++e) r[u * E + e] = acc[i][e];
          }
        }
      }
      if (lane == 0) {
        r[D] = m;
        r[D + 1] = l;
      }
      __syncthreads();
      // the split's record for head g: the warps' records merged in order
      float* dst = part_row + g * rec_len;
      for (int e = threadIdx.x; e < rec_len; e += W * 32) {
        float mm = kNegInf;
        for (int w = 0; w < W; ++w) mm = fmaxf(mm, rec[w * rec_len + D]);
        const int src = e == D ? D + 1 : e;        // acc element or l
        float sum = 0.f;
        for (int w = 0; w < W; ++w)
          sum += rec[w * rec_len + src] * expf(rec[w * rec_len + D] - mm);
        dst[e] = e == D ? mm : sum;
      }
      __syncthreads();
    }
  }

  // the last block of this (sequence, KV head) to finish merges its splits
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    merger = atomicAdd(count + row, 1u) == (unsigned)(n_split - 1);
  __syncthreads();
  if (!merger) return;
  __threadfence();
  const float* recs = part + row * n_split * G * rec_len;
  for (int e = threadIdx.x; e < G * (D + 1); e += W * 32) {
    const int g = e / (D + 1);
    const int d = e - g * (D + 1);
    float mm = kNegInf;
    for (int jj = 0; jj < n_split; ++jj)
      if (max(lo, jj * kSplit) < min(hi, (jj + 1) * kSplit))
        mm = fmaxf(mm, __ldcg(recs + (jj * G + g) * rec_len + D));
    float lsum = 0.f, sum = 0.f;
    for (int jj = 0; jj < n_split; ++jj) {
      if (max(lo, jj * kSplit) >= min(hi, (jj + 1) * kSplit)) continue;
      const float* r = recs + (jj * G + g) * rec_len;
      const float w = expf(__ldcg(r + D) - mm);
      lsum += __ldcg(r + D + 1) * w;
      if (d < D) sum += __ldcg(r + d) * w;
    }
    const int64_t qh = row * G + g;
    if (d < D) {
      const float o = sum / (lsum == 0.f ? 1.f : lsum);
      if (q_bf16)
        static_cast<__nv_bfloat16*>(out)[qh * D + d] = __float2bfloat16_rn(o);
      else
        static_cast<float*>(out)[qh * D + d] = o;
    } else {
      m_out[qh] = mm;
      l_out[qh] = lsum;
    }
  }
  if (threadIdx.x == 0) count[row] = 0;
}

template <typename Tkv, int U, int UPL>
int launch(const void* q, int q_bf16, const void* k, const void* v,
           const void* lengths, void* out, void* m, void* l, void* part,
           void* count, int B, int Hkv, int G, int S, int D, int window,
           float scale, cudaStream_t stream) {
  constexpr int W = Shape<Tkv, U, UPL>::W;
  const dim3 grid(S > 0 ? (S + kSplit - 1) / kSplit : 1, Hkv, B);
  const int smem = W * (D + 2) * (int)sizeof(float);
  flash_decode_kernel<Tkv, U, UPL><<<grid, W * 32, smem, stream>>>(
      q, q_bf16, static_cast<const Tkv*>(k), static_cast<const Tkv*>(v),
      static_cast<const int32_t*>(lengths), out, static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(part),
      static_cast<unsigned*>(count), Hkv, G, S, D, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; window <= 0 means none
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* lengths, void* out, void* m, void* l,
                            void* part, void* count, int B, int Hkv, int G,
                            int S, int D, int window, float scale,
                            int q_dtype, int kv_dtype, void* stream) {
  if (D < 2 || D > 256 || D % 2 || G < 1 || q_dtype < 0 || q_dtype > 1 ||
      kv_dtype < 0 || kv_dtype > 1)
    return (int)cudaErrorInvalidValue;
  // rows are read in element pairs at least
  const uintptr_t kv = reinterpret_cast<uintptr_t>(k) |
                       reinterpret_cast<uintptr_t>(v);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(out)) %
          (q_dtype == 1 ? 4 : 8) ||
      kv % (kv_dtype == 1 ? 4 : 8))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hkv == 0) return (int)cudaSuccess;
  // the load unit: the widest of 16, 8, 4 bytes that divides a row and
  // aligns both K and V; UPL units a lane, 16 lanes a row
  const int row_bytes = D * (kv_dtype == 1 ? 2 : 4);
  const int unit = row_bytes % 16 == 0 && kv % 16 == 0  ? 16
                   : row_bytes % 8 == 0 && kv % 8 == 0 ? 8
                                                        : 4;
  int upl = 1;
  while (16 * upl < row_bytes / unit) upl *= 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE(TKV, UNIT, UPL)                                          \
  if (unit == UNIT && upl == UPL)                                             \
    return launch<TKV, UNIT, UPL>(q, q_dtype, k, v, lengths, out, m, l, part, \
                                  count, B, Hkv, G, S, D, window, scale, s);
  if (kv_dtype == 1) {
    REPRO_DECODE(__nv_bfloat16, 16, 1)
    REPRO_DECODE(__nv_bfloat16, 16, 2)
    REPRO_DECODE(__nv_bfloat16, 8, 1)
    REPRO_DECODE(__nv_bfloat16, 8, 2)
    REPRO_DECODE(__nv_bfloat16, 8, 4)
    REPRO_DECODE(__nv_bfloat16, 4, 1)
    REPRO_DECODE(__nv_bfloat16, 4, 2)
    REPRO_DECODE(__nv_bfloat16, 4, 4)
    REPRO_DECODE(__nv_bfloat16, 4, 8)
  } else {
    REPRO_DECODE(float, 16, 1)
    REPRO_DECODE(float, 16, 2)
    REPRO_DECODE(float, 16, 4)
    REPRO_DECODE(float, 8, 1)
    REPRO_DECODE(float, 8, 2)
    REPRO_DECODE(float, 8, 4)
    REPRO_DECODE(float, 8, 8)
  }
#undef REPRO_DECODE
  return (int)cudaErrorInvalidValue;
}
