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
// Design: the walk over positions is split across blocks, in the split
// walk that K2 shares (kernels/csrc/split_decode.cuh, whose header gives the
// design and the merge): one block per (split of 64 positions, KV head,
// sequence), 512 blocks at the serving shape (B 8, Hkv 8, S 512) instead of
// one per (sequence, KV head).  S is known on the host; the lengths stay on
// the device.  Here a position's K/V row is row (sequence, KV head) * S +
// position of the contiguous cache, and every position below the length is
// attended.  The output is normalised by the local l, with m and l beside
// it, so that partials over several KV shards can be merged
// (flash_ops.merge_partials).  A row with length 0 gives out = 0,
// m = -1e30, l = 0, as the TPU kernel does.  Any S is taken.
//
// Earlier versions: the first loaded one bf16 element per lane and load
// (0.17 ms per call at the serving shapes on an H100); the second, one
// block of 8 warps per (sequence, KV head) walking its positions serially,
// took 0.038 ms: 64 blocks on 132 SMs, and each K/V row fetched once per
// query head.
//
// The C entry returns cudaErrorInvalidValue for a head dim or group it does
// not take (D 2..256, even, a multiple of 4 over an fp8 cache; G >= 1;
// pointers aligned to an element pair, to 4 bytes over fp8)
// and otherwise cudaGetLastError().  The caller passes scratch of
// B * Hkv * max(1, ceil(S / 64)) * G * (D + 2) floats and B * Hkv counters
// that are 0 (the kernel leaves them 0).

#include "split_decode.cuh"

namespace {

namespace sd = repro::split_decode;

// K/V row of a position: the contiguous cache of one (sequence, KV head)
struct ContiguousRows {
  int64_t first;                                   // row * S * D
  int D;
  __device__ __forceinline__ bool operator()(int pos, int64_t& off) const {
    off = first + (int64_t)pos * D;
    return true;
  }
};

template <typename Tkv, int U, int UPL>
__global__ void __launch_bounds__(sd::Shape<Tkv, U, UPL>::W * 32)
    flash_decode_kernel(const Tkv* __restrict__ k, const Tkv* __restrict__ v,
                        const int32_t* __restrict__ lengths, int Hkv,
                        sd::Params p) {
  const int b = blockIdx.z;
  const int64_t row = (int64_t)b * Hkv + blockIdx.y;  // (sequence, KV head)
  const ContiguousRows rows{row * p.S * p.D, p.D};
  sd::run<Tkv, U, UPL, true>(k, v, rows, row, lengths[b], p);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn (k and v only);
// window <= 0 means none
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* lengths, void* out, void* m, void* l,
                            void* part, void* count, int B, int Hkv, int G,
                            int S, int D, int window, float scale,
                            int q_dtype, int kv_dtype, void* stream) {
  // rows in whole units of the split walk (sd::takes)
  const uintptr_t kv = reinterpret_cast<uintptr_t>(k) |
                       reinterpret_cast<uintptr_t>(v);
  if (G < 1 || q_dtype < 0 || q_dtype > 1 || !sd::takes(kv_dtype, D, kv) ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(out)) %
          (q_dtype == 1 ? 4 : 8))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hkv == 0) return (int)cudaSuccess;
  const sd::Params p{q, q_dtype, out, q_dtype, static_cast<float*>(m),
                     static_cast<float*>(l), static_cast<float*>(part),
                     static_cast<unsigned*>(count), G, S, D, window, scale};
  const dim3 grid(sd::n_splits(S), Hkv, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return sd::dispatch(kv_dtype, D, kv, [&](auto var) {
    using Var = decltype(var);
    const int smem = Var::W * (D + 2) * (int)sizeof(float);
    flash_decode_kernel<typename Var::T, Var::U, Var::UPL>
        <<<grid, Var::W * 32, smem, s>>>(
            static_cast<const typename Var::T*>(k),
            static_cast<const typename Var::T*>(v),
            static_cast<const int32_t*>(lengths), Hkv, p);
    return (int)cudaGetLastError();
  });
}
