// K4 flash_decode for Hopper (sm_90a): one new token per sequence attends
// to its contiguous (batch-layout) KV cache, with a length mask and an
// optional sliding window.
//
// Replaces the TPU kernel
//   repro/kernels/paged_decode/flash.py::flash_decode (_decode_kernel).
// Bound: bytes.  Every attended K and V row is read once from device
// memory and used by only the G query heads of its KV head (2 for
// qwen3-0.6b): about G * 4 floating-point operations per byte, far below
// the H100's ridge point.
//
// Design: one block of 8 warps per (sequence, KV head), taking all G query
// heads of the group together, as the TPU grid does.  It is K2's
// (paged_decode.cu) register-resident online softmax with the block-table
// walk taken out (both use decode_attend.cuh): the positions are
// contiguous, [max(0, len - window), min(len, S)), and the block visits
// only those.  The warps split the G heads between them and, within a
// head, interleave chunks of 8 positions (4 when D > 128): a warp loads a
// whole chunk's K and V rows into registers, each lane a pair of elements
// per load, scores the chunk and folds it into its own (m, l, acc) in f32.
// The block merges its warps' records by log-sum-exp through shared
// memory and writes the output normalised by the local l, with m and l
// beside it, so that partials over several KV shards can be merged
// (flash_ops.merge_partials).  A row with
// length 0 gives out = 0, m = -1e30, l = 0, as the TPU kernel does.
// scale multiplies the q.k product.  Any S is taken.
//
// The first version loaded one element per lane and load; in bf16 it ran
// at 0.17 ms per call at the serving shapes on an H100, twice its plain
// version's time.
//
// The C entry returns cudaErrorInvalidValue for a head dim or group it does
// not take (D even, 2..256; the warps' records within 48 KB of shared
// memory; pointers aligned to an element pair) and otherwise
// cudaGetLastError().

#include "decode_attend.cuh"

namespace {

using repro::kNegInf;

constexpr int kWarps = 8;

template <typename Tq, typename Tkv, int MAX_P, int CHUNK>
__global__ void __launch_bounds__(kWarps * 32) flash_decode_kernel(
    const Tq* __restrict__ q, const Tkv* __restrict__ k,
    const Tkv* __restrict__ v, const int32_t* __restrict__ lengths,
    Tq* __restrict__ out, float* __restrict__ m_out,
    float* __restrict__ l_out, int Hkv, int G, int S, int D, int window,
    float scale) {
  // per (head g, warp-of-head w): acc[D] | m | l
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = lengths[b];
  const int lo = (window > 0 && len > window) ? len - window : 0;
  const int hi = min(len, S);
  const int64_t head0 = ((int64_t)b * Hkv + h) * G;        // first q head
  const int64_t kv0 = ((int64_t)b * Hkv + h) * S * D;      // first K/V row
  // warps per query head; with more heads than warps each warp takes
  // heads warp, warp + kWarps, ... alone
  const int wph = G >= kWarps ? 1 : kWarps / G;
  const int stride = CHUNK * wph;

  for (int g = warp / wph; g < G; g += kWarps / wph) {
    const int w = warp % wph;
    float2 qr[MAX_P], acc[MAX_P];
    repro::load_row(q + (head0 + g) * D, D, lane, true, qr);
#pragma unroll
    for (int i = 0; i < MAX_P; ++i) acc[i] = make_float2(0.f, 0.f);
    float m = kNegInf, l = 0.f;
    for (int c0 = lo + w * CHUNK; c0 < hi; c0 += stride) {
      int64_t base[CHUNK];
      bool ok[CHUNK];
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        ok[c] = c0 + c < hi;
        base[c] = kv0 + (int64_t)(c0 + c) * D;
      }
      repro::fold_chunk<Tkv, MAX_P, CHUNK>(k, v, base, ok, D, lane, scale,
                                           qr, acc, m, l);
    }
    repro::store_record(smem + (int64_t)(g * wph + w) * (D + 2), acc, m, l,
                        D, lane);
  }
  __syncthreads();
  repro::merge_records<Tq, true>(smem, G, D, wph, head0, out, m_out, l_out);
}

template <typename Tq, typename Tkv>
void launch(const void* q, const void* k, const void* v, const void* lengths,
            void* out, void* m, void* l, int B, int Hkv, int G, int S, int D,
            int window, float scale, int smem_bytes, cudaStream_t stream) {
  const dim3 grid(B, Hkv);
  const int threads = kWarps * 32;
#define REPRO_DECODE_ARGS                                                   \
  static_cast<const Tq*>(q), static_cast<const Tkv*>(k),                   \
      static_cast<const Tkv*>(v), static_cast<const int32_t*>(lengths),    \
      static_cast<Tq*>(out), static_cast<float*>(m), static_cast<float*>(l), \
      Hkv, G, S, D, window, scale
  if (D <= 128)
    flash_decode_kernel<Tq, Tkv, 2, 8>
        <<<grid, threads, smem_bytes, stream>>>(REPRO_DECODE_ARGS);
  else
    flash_decode_kernel<Tq, Tkv, 4, 4>
        <<<grid, threads, smem_bytes, stream>>>(REPRO_DECODE_ARGS);
#undef REPRO_DECODE_ARGS
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; window <= 0 means none
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* lengths, void* out, void* m, void* l,
                            int B, int Hkv, int G, int S, int D, int window,
                            float scale, int q_dtype, int kv_dtype,
                            void* stream) {
  if (D < 2 || D > 256 || D % 2 || G < 1) return (int)cudaErrorInvalidValue;
  // rows are read in element pairs
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(out)) %
          (q_dtype == 1 ? 4 : 8) ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) %
          (kv_dtype == 1 ? 4 : 8))
    return (int)cudaErrorInvalidValue;
  const int wph = G >= kWarps ? 1 : kWarps / G;
  const int smem_bytes = (int)sizeof(float) * G * wph * (D + 2);
  if (smem_bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (B == 0 || Hkv == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE(TQ, TKV)                                                 \
  launch<TQ, TKV>(q, k, v, lengths, out, m, l, B, Hkv, G, S, D, window,      \
                  scale, smem_bytes, s)
  if (q_dtype == 0 && kv_dtype == 0) REPRO_DECODE(float, float);
  else if (q_dtype == 0 && kv_dtype == 1) REPRO_DECODE(float, __nv_bfloat16);
  else if (q_dtype == 1 && kv_dtype == 0) REPRO_DECODE(__nv_bfloat16, float);
  else if (q_dtype == 1 && kv_dtype == 1)
    REPRO_DECODE(__nv_bfloat16, __nv_bfloat16);
  else return (int)cudaErrorInvalidValue;
#undef REPRO_DECODE
  return (int)cudaGetLastError();
}
