// One-token decode attention as a split walk over positions, shared by K4
// (flash_decode.cu: a contiguous cache per sequence and KV head) and K2
// (paged_decode.cu: positions found through a block table).  The two differ
// only in how a position's K/V row is addressed and tested (the Rows
// argument) and in what they write (normalised in q's dtype, or the
// unnormalised f32 record).
//
// One block of W warps per (split of kSplit positions, KV head, sequence).
// A block whose split lies outside its row's attended range [lo, hi) only
// counts itself in (below) and exits.  A half-warp reads one K or V row in
// units of U bytes, 16 lanes side by side (U = 16, 8 or 4: the widest that
// divides the row and aligns the K and V pointers; UPL units a lane when a
// row has more than 16), so at D = 128 in bf16 a warp instruction moves two
// whole rows.  K/V may be f32, bf16 or fp8 e4m3fn (a 16-byte unit then
// holds 16 values, each widened to f32 exactly as it is used); q and the
// sums stay f32 or bf16 and f32.  Each warp loads all of its 2 * NP rows of K and V into
// registers before it uses the first.  Every row then gives the G query
// heads of the group their dot products from registers (loaded once for all
// G), each summed across its half-warp by four shuffles; per head the warp
// folds its rows into (m, l, acc) in f32, the block merges its warps'
// records in warp order through shared memory and writes the split's
// unnormalised record (acc[D], m, l) to a scratch buffer.
//
// Merge: one launch per call.  Each block, after writing its records,
// fences and adds one to a counter of its (sequence, KV head); the block
// that brings it to the number of splits merges that row's records by
// log-sum-exp, in order of split index, and resets the counter to 0 for
// the next launch.  Which block merges depends on timing; what it computes
// does not, so two launches on the same inputs give the same bits.
//
// Masked scores are -inf and the running max starts at -1e30, so a masked
// probability is exactly 0 and a split, or a whole row, that attends
// nothing gives exactly acc = 0, m = -1e30, l = 0.  scale multiplies the
// q.k product.
#pragma once

#include "common.cuh"

namespace repro {
namespace split_decode {

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
  return to_f32(reinterpret_cast<const Tkv*>(&u)[e]);
}

__device__ __forceinline__ float minus_inf() {
  return __int_as_float(0xff800000);
}

// What both kernels pass through unchanged.  q is [rows, G, D] in f32 or
// bf16; out [rows, G, D] in f32 or bf16; m_out, l_out [rows, G]; part
// [rows, n_split, G, D + 2] f32 scratch; count [rows] counters that are 0.
struct Params {
  const void* q;
  int q_bf16;
  void* out;
  int out_bf16;
  float* m_out;
  float* l_out;
  float* part;
  unsigned* count;
  int G, S, D, window;
  float scale;
};

// The block's work: split blockIdx.x of (sequence, KV head) ``row``, whose
// length is ``len``; rows(pos, off) is true where position pos is attended
// and then sets off to its K/V row's first element.  Normalise: write acc / l
// in out's dtype (K4); otherwise the unnormalised f32 acc (K2).
template <typename Tkv, int U, int UPL, bool Normalise, class Rows>
__device__ __forceinline__ void run(const Tkv* __restrict__ k,
                                    const Tkv* __restrict__ v,
                                    const Rows& rows, int64_t row, int len,
                                    const Params& p) {
  using V = typename Unit<U>::T;
  constexpr int E = Shape<Tkv, U, UPL>::E;
  constexpr int NP = Shape<Tkv, U, UPL>::NP;
  constexpr int W = Shape<Tkv, U, UPL>::W;
  extern __shared__ float rec[];                   // [W][D + 2]
  __shared__ int merger;
  const int G = p.G, D = p.D;
  const int j = blockIdx.x;
  const int n_split = gridDim.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int sub = lane & 15;
  const int lo = (p.window > 0 && len > p.window) ? len - p.window : 0;
  const int hi = min(len, p.S);
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
    for (int r = 0; r < NP; ++r) {
      const int pos = p0 + 2 * r;
      int64_t off = 0;
      ok[r] = pos >= s_lo && pos < s_hi && rows(pos, off);
      const V* kp = reinterpret_cast<const V*>(k + off);
      const V* vp = reinterpret_cast<const V*>(v + off);
#pragma unroll
      for (int i = 0; i < UPL; ++i) {
        const int u = sub + 16 * i;
        kr[r][i] = ok[r] && u < nu ? kp[u] : V{};
        vr[r][i] = ok[r] && u < nu ? vp[u] : V{};
      }
    }
    float* part_row = p.part + (row * n_split + j) * G * rec_len;
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
                     : p.q_bf16
                         ? __bfloat162float(
                               static_cast<const __nv_bfloat16*>(p.q)[idx])
                         : static_cast<const float*>(p.q)[idx];
        }
      }
      float s[NP];
      float mx = minus_inf();
#pragma unroll
      for (int r = 0; r < NP; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < UPL; ++i)
#pragma unroll
          for (int e = 0; e < E; ++e)
            dot += qf[i][e] * elem<Tkv, U>(kr[r][i], e);
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[r] = ok[r] ? dot * p.scale : minus_inf();
        mx = fmaxf(mx, s[r]);
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
      for (int r = 0; r < NP; ++r) {
        const float pr = expf(s[r] - m);           // masked: exactly 0
        l += pr;
#pragma unroll
        for (int i = 0; i < UPL; ++i)
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[i][e] += pr * elem<Tkv, U>(vr[r][i], e);
      }
      l += __shfl_xor_sync(0xffffffffu, l, 16);
#pragma unroll
      for (int i = 0; i < UPL; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], 16);
      float* own = rec + warp * rec_len;
      if (half == 0) {
#pragma unroll
        for (int i = 0; i < UPL; ++i) {
          const int u = sub + 16 * i;
          if (u < nu) {
#pragma unroll
            for (int e = 0; e < E; ++e) own[u * E + e] = acc[i][e];
          }
        }
      }
      if (lane == 0) {
        own[D] = m;
        own[D + 1] = l;
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
    merger = atomicAdd(p.count + row, 1u) == (unsigned)(n_split - 1);
  __syncthreads();
  if (!merger) return;
  __threadfence();
  const float* recs = p.part + row * n_split * G * rec_len;
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
      const float o = Normalise ? sum / (lsum == 0.f ? 1.f : lsum) : sum;
      if (p.out_bf16)
        static_cast<__nv_bfloat16*>(p.out)[qh * D + d] = __float2bfloat16_rn(o);
      else
        static_cast<float*>(p.out)[qh * D + d] = o;
    } else {
      p.m_out[qh] = mm;
      p.l_out[qh] = lsum;
    }
  }
  if (threadIdx.x == 0) p.count[row] = 0;
}

// Host side.  The kernel variant for a K/V dtype and row: its element type,
// load unit U and units per lane UPL.
template <typename Tkv, int U_, int UPL_>
struct Variant {
  using T = Tkv;
  static constexpr int U = U_;
  static constexpr int UPL = UPL_;
  static constexpr int W = Shape<Tkv, U_, UPL_>::W;
};

// K/V dtype codes of the C entries: 0 float32, 1 bfloat16, 2 float8_e4m3fn
inline int kv_bytes(int kv_dtype) { return kv_dtype == 0 ? 4 : kv_dtype == 1 ? 2 : 1; }

// Whether the split walk takes rows of D elements of kv_dtype at the K/V
// pointers' alignment kv_addr: D 2..256, the row and the pointers whole
// units of the smallest a variant reads, an element pair and 4 bytes at
// least (D even in f32 and bf16, a multiple of 4 in fp8).
inline bool takes(int kv_dtype, int D, uintptr_t kv_addr) {
  if (kv_dtype < 0 || kv_dtype > 2 || D < 2 || D > 256) return false;
  const int u = kv_dtype == 0 ? 8 : 4;
  return (D * kv_bytes(kv_dtype)) % u == 0 && kv_addr % u == 0;
}

// Calls launch(Variant<...>{}) for rows of D elements of the K/V dtype
// (kv_dtype, a code above) at the K/V pointers' alignment kv_addr, and
// returns its result: the unit is the widest of 16, 8, 4 bytes that divides
// a row and aligns both K and V, with UPL units a lane and 16 lanes a row.
// Rows the walk does not take (takes() false) give cudaErrorInvalidValue.
template <class Launch>
int dispatch(int kv_dtype, int D, uintptr_t kv_addr, Launch&& launch) {
  if (!takes(kv_dtype, D, kv_addr)) return (int)cudaErrorInvalidValue;
  const int row_bytes = D * kv_bytes(kv_dtype);
  const int unit = row_bytes % 16 == 0 && kv_addr % 16 == 0  ? 16
                   : row_bytes % 8 == 0 && kv_addr % 8 == 0 ? 8
                                                             : 4;
  int upl = 1;
  while (16 * upl < row_bytes / unit) upl *= 2;
#define REPRO_VARIANT(TKV, UNIT, UPL) \
  if (unit == UNIT && upl == UPL) return launch(Variant<TKV, UNIT, UPL>{});
  if (kv_dtype == 2) {
    REPRO_VARIANT(fp8e4m3, 16, 1)
    REPRO_VARIANT(fp8e4m3, 8, 1)
    REPRO_VARIANT(fp8e4m3, 8, 2)
    REPRO_VARIANT(fp8e4m3, 4, 1)
    REPRO_VARIANT(fp8e4m3, 4, 2)
    REPRO_VARIANT(fp8e4m3, 4, 4)
  } else if (kv_dtype == 1) {
    REPRO_VARIANT(__nv_bfloat16, 16, 1)
    REPRO_VARIANT(__nv_bfloat16, 16, 2)
    REPRO_VARIANT(__nv_bfloat16, 8, 1)
    REPRO_VARIANT(__nv_bfloat16, 8, 2)
    REPRO_VARIANT(__nv_bfloat16, 8, 4)
    REPRO_VARIANT(__nv_bfloat16, 4, 1)
    REPRO_VARIANT(__nv_bfloat16, 4, 2)
    REPRO_VARIANT(__nv_bfloat16, 4, 4)
    REPRO_VARIANT(__nv_bfloat16, 4, 8)
  } else {
    REPRO_VARIANT(float, 16, 1)
    REPRO_VARIANT(float, 16, 2)
    REPRO_VARIANT(float, 16, 4)
    REPRO_VARIANT(float, 8, 1)
    REPRO_VARIANT(float, 8, 2)
    REPRO_VARIANT(float, 8, 4)
    REPRO_VARIANT(float, 8, 8)
  }
#undef REPRO_VARIANT
  return (int)cudaErrorInvalidValue;
}

// the split count for S positions (at least one block per row, so that a
// row with S = 0 still writes its empty record)
inline int n_splits(int S) { return S > 0 ? (S + kSplit - 1) / kSplit : 1; }

}  // namespace split_decode
}  // namespace repro
