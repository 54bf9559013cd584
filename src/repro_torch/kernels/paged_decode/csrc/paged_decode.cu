// Paged-decode kernels for Hopper (sm_90a): the WRITE and READ halves of
// the emulated-memory protocol, walking the BlockManager's block tables
// inside the kernel so that address translation rides the memory access.
//
// K1 paged_kv_write replaces the TPU kernel
//   repro/kernels/paged_decode/kernel.py::paged_kv_write (_kv_write_kernel)
//   and, on the decode path, the per-head RMS norm and the rotary embedding
//   of q and k that XLA fuses beside it there (repro/models/layers.py:89-110,
//   _project_qkv's epilogue), which eager PyTorch ran as ~48 small launches
//   per layer.
//   Bound: bytes.  At the main path's shape (B 8, Hq 16, Hkv 8, D 128, bf16)
//   a call reads q, k and v (64 KB) and writes the normed, rotated q and the
//   new K/V rows (64 KB): ~131 KB.  The norm and rotary are ~10 operations
//   an element, far below the card's rate.  The time is a launch and a
//   chain of dependent loads, lengths -> block_table -> frame_ro.
//   Design: one body, two C entries.  Grid (Hq + Hkv, B): one block per
//   head of one sequence, ceil(D/2) threads rounded up to whole warps, each
//   thread one rotary pair (i, i + D/2).  The block's sum of squares is a
//   warp shuffle plus a shared-memory combine in warp order (deterministic).
//   KV-head blocks start the table chain before the reduction, so that its
//   latency overlaps the norm and the rotary.  A block reads only its
//   inputs and writes only its own q row or its own [D] slice of the K and V
//   rows, so no block reads what another writes.  The write applies the
//   TPU kernel's drops: write mask off, length 0, unmapped page, read-only
//   frame (frame_ro), and frames of other shards (f % n_shards != sid).
//   The TPU body rescans every sequence's table per visited row because
//   Pallas aliases output blocks and several grid steps may visit one row;
//   on the GPU distinct sequences never write the same (row, slot) -- a
//   frame that several sequences share is read-only and its writes drop --
//   so no scan is needed.
//   paged_qkv_write is the decode path's entry: q, k and v straight from the
//   projections in, the normed and rotated q out, k normed and rotated
//   before it is written; with no pages it is the batch layout's q/k
//   epilogue and returns the rotated k instead.  paged_kv_write is the TPU
//   kernel's exact function: the same body with q, the norm and the rotary
//   off.
//   Numerics follow the plain version's rounding points (ref.qkv_write,
//   models/layers.py rms_norm and rope, as torch runs them on the card):
//   the norm in f32 with the mean as sum * (1/D) and rsqrtf, cast to the
//   compute dtype before the weight multiply, which rounds once to that
//   dtype; the rotary in f32 with freqs = powf(theta, -i * (1/half)) (torch
//   divides by a scalar as a multiply by its reciprocal), the angle a single
//   product, full-precision cosf/sinf, and x1*cos - x2*sin without FMA
//   contraction (__fmul_rn/__fsub_rn), cast once at the end.
//   At the main path's shape on an H100 (chip_smoke.py): 0.0038 ms a call;
//   the write alone (paged_kv_write) 0.0030 ms, which the decode path ran
//   after ~45 separate torch ops of the norm and rotary (the earlier
//   design, one block per sequence writing Hkv*D elements).

// fp8 pages (float8_e4m3fn, the reference's kv_dtype): K1 casts the
//   new rows as the TPU kernel's astype does, to nearest even with NaN past
//   the range (common.cuh, from_f32<fp8e4m3>, the non-saturating cvt), and
//   K2 widens each value to f32 exactly as it reads it; a 16-byte unit then
//   holds 16 values, and the bytes that bound K2 halve against bf16.

// K2 paged_gather_attend replaces the TPU kernel
//   repro/kernels/paged_decode/kernel.py::paged_gather_attend
//   (_gather_attend_kernel).
//   Bound: bytes.  Every attended K and V row is read once from device
//   memory and used by only G query heads (2 for qwen3-0.6b), about
//   G * 4 floating-point operations per byte, well below the H100's
//   ridge point.
//   Design: a split walk of the block table, the one K4 uses over its
//   contiguous cache (kernels/csrc/split_decode.cuh, whose header gives the
//   design and the merge).  Each (sequence, local KV head) row's positions
//   are cut into 64-long splits, one block each: grid
//   (ceil(max_lpages * page_slots / 64), hkv_loc, B), 512 blocks at the
//   serving shape (B 8, Hkv 8, 32 pages of 16 slots).  Each lane translates
//   its own positions: frame f = block_table[b, pos / page_slots], attended
//   where f >= 0, f % n_shards == sid and f / n_shards < np_loc, and pos
//   lies in [max(0, len - window), len) -- the TPU grid walks all
//   max_lpages pages because its grid is static.  Each paged K/V row is
//   loaded once for all G query heads of its group, in 16-, 8- or 4-byte
//   units chosen per call.  The split's records go to scratch, and the last
//   block of a row merges them in split order, so one launch per call and
//   the same bits every launch.  It emits UNNORMALISED (acc, m, l) in f32
//   so shards can be merged the same way; an empty row, or one whose frames
//   all lie on other shards, gives exactly acc = 0, m = -1e30, l = 0.
//   scale = D^-0.5 multiplies the q.k product, as on the TPU.
//   Earlier versions, at the main path's shapes on an H100: staging pages
//   through shared memory with four block barriers per page, 0.30 ms per
//   call; one block of 8 warps per (sequence, KV head) walking its
//   positions serially, each lane one element per load, 0.088 ms; the same
//   walk with element-pair loads, 0.065 ms (64 blocks on 132 SMs).
//
// The entries take (sid, n_shards) (K2 also kv_start) so one build serves
// every shard of a multi-shard layout.  Each C entry returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape it refuses.

#include "split_decode.cuh"

namespace {

namespace sd = repro::split_decode;
using repro::to_f32;

// -- K1: norm, rotary and WRITE -------------------------------------------------

struct QkvArgs {
  const void* q;          // [B, hq, D] in the compute dtype (hq may be 0)
  const void* k;          // [B, hkv, D]
  const void* v;          // [B, hkv, D]; null without pages
  void* q_out;            // [B, hq, D]
  void* k_out;            // [B, hkv, D] rotated k, or null
  void* k_pages;          // [np_loc, page_slots, hkv, D], or null: no write
  void* v_pages;
  const void* q_norm;     // [D] in the compute dtype, or null: no norm
  const void* k_norm;
  const int32_t* bt;      // [B, max_lpages] global frame ids
  const int32_t* lengths; // [B], including the new token
  const uint8_t* frame_ro;
  const uint8_t* write_mask;
  int hq, hkv, D, max_lpages, page_slots, np_loc, n_frames, sid, n_shards;
  float eps, theta;
  int rope;
};

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(repro::from_f32<T>(x));
}

// the block's sum of x, the same bits in every thread
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float part[32];
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s = __fadd_rn(s, part[w]);
  return s;
}

template <typename Tin, typename Tkv>
__global__ void qkv_write_kernel(const QkvArgs a) {
  const int b = blockIdx.y;
  const bool is_q = (int)blockIdx.x < a.hq;
  const int h = is_q ? blockIdx.x : blockIdx.x - a.hq;
  const int half = (a.D + 1) / 2;
  const int i = threadIdx.x;
  const bool lo = i < half, hi = i + half < a.D;
  const int64_t row = ((int64_t)b * (is_q ? a.hq : a.hkv) + h) * a.D;
  const Tin* src = static_cast<const Tin*>(is_q ? a.q : a.k) + row;
  float x1 = lo ? to_f32(src[i]) : 0.f;
  float x2 = hi ? to_f32(src[i + half]) : 0.f;
  const int len = a.lengths[b];
  // the table chain starts here, before the norm: block_table now, frame_ro
  // once the frame is known
  const bool writes = !is_q && a.k_pages != nullptr;
  float v1 = 0.f, v2 = 0.f;
  int f = -1;
  if (writes) {
    const Tin* vs = static_cast<const Tin*>(a.v) + row;
    v1 = lo ? to_f32(vs[i]) : 0.f;
    v2 = hi ? to_f32(vs[i + half]) : 0.f;
    const int pidx = (len - 1) / a.page_slots;
    if (a.write_mask[b] && len > 0 && pidx < a.max_lpages)
      f = a.bt[(int64_t)b * a.max_lpages + pidx];
  }
  const Tin* w = static_cast<const Tin*>(is_q ? a.q_norm : a.k_norm);
  if (w != nullptr) {
    const float ss = block_sum(__fadd_rn(__fmul_rn(x1, x1), __fmul_rn(x2, x2)));
    const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.0f / a.D), a.eps));
    if (lo) x1 = round_to<Tin>(__fmul_rn(round_to<Tin>(__fmul_rn(x1, r)),
                                         to_f32(w[i])));
    if (hi) x2 = round_to<Tin>(__fmul_rn(round_to<Tin>(__fmul_rn(x2, r)),
                                         to_f32(w[i + half])));
  }
  bool ro = true;
  if (writes && f >= 0 && f < a.n_frames) ro = a.frame_ro[f];
  if (a.rope) {
    const float e = __fmul_rn(-(float)i, 1.0f / (float)half);
    const float ang = __fmul_rn((float)(len - 1), powf(a.theta, e));
    const float c = cosf(ang), s = sinf(ang);
    const float o1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
    const float o2 = __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
    x1 = round_to<Tin>(o1);
    x2 = round_to<Tin>(o2);
  }
  Tin* out = static_cast<Tin*>(is_q ? a.q_out : a.k_out);
  if (out != nullptr) {
    if (lo) out[row + i] = repro::from_f32<Tin>(x1);
    if (hi) out[row + i + half] = repro::from_f32<Tin>(x2);
  }
  if (!writes || ro || f % a.n_shards != a.sid) return;
  const int prow = f / a.n_shards;
  if (prow >= a.np_loc) return;
  const int off = (len - 1) % a.page_slots;
  const int64_t dst = (((int64_t)prow * a.page_slots + off) * a.hkv + h) * a.D;
  Tkv* kp = static_cast<Tkv*>(a.k_pages) + dst;
  Tkv* vp = static_cast<Tkv*>(a.v_pages) + dst;
  if (lo) {
    kp[i] = repro::from_f32<Tkv>(x1);
    vp[i] = repro::from_f32<Tkv>(v1);
  }
  if (hi) {
    kp[i + half] = repro::from_f32<Tkv>(x2);
    vp[i + half] = repro::from_f32<Tkv>(v2);
  }
}

// -- K2: READ + attend ------------------------------------------------------------

// K/V row of a position: through the block table, on this shard only
struct PagedRows {
  const int32_t* bt_row;                           // block_table[b]
  int page_slots, sid, n_shards, np_loc, hkv, kvh, D;
  __device__ __forceinline__ bool operator()(int pos, int64_t& off) const {
    const int f = bt_row[pos / page_slots];
    if (f < 0 || f % n_shards != sid || f / n_shards >= np_loc) return false;
    off = (((int64_t)(f / n_shards) * page_slots + pos % page_slots) * hkv +
           kvh) * D;
    return true;
  }
};

template <typename Tkv, int U, int UPL>
__global__ void __launch_bounds__(sd::Shape<Tkv, U, UPL>::W * 32)
    gather_attend_kernel(const Tkv* __restrict__ k_pages,
                         const Tkv* __restrict__ v_pages,
                         const int32_t* __restrict__ block_table,
                         const int32_t* __restrict__ lengths, int hkv_loc,
                         int max_lpages, int page_slots, int hkv, int np_loc,
                         int sid, int n_shards, int kv_start, sd::Params p) {
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const PagedRows rows{block_table + (int64_t)b * max_lpages, page_slots, sid,
                       n_shards, np_loc, hkv, kv_start + h, p.D};
  sd::run<Tkv, U, UPL, false>(k_pages, v_pages, rows,
                              (int64_t)b * hkv_loc + h, lengths[b], p);
}

// one block per head and sequence; a thread a rotary pair, whole warps
int launch_qkv(const QkvArgs& a, int B, int in_dtype, int kv_dtype,
               cudaStream_t s) {
  if (a.D < 1 || a.D > 2048 || (a.rope && a.D % 2) || a.hq < 0 || a.hkv < 0 ||
      (a.k_pages != nullptr && (a.page_slots < 1 || a.n_shards < 1)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || a.hq + a.hkv == 0) return (int)cudaSuccess;
  const dim3 grid(a.hq + a.hkv, B);
  const int threads = ((a.D + 1) / 2 + 31) / 32 * 32;
#define REPRO_QKV(TIN, TKV) \
  qkv_write_kernel<TIN, TKV><<<grid, threads, 0, s>>>(a)
  using repro::fp8e4m3;
  if (in_dtype == 0 && kv_dtype == 0) REPRO_QKV(float, float);
  else if (in_dtype == 0 && kv_dtype == 1) REPRO_QKV(float, __nv_bfloat16);
  else if (in_dtype == 0 && kv_dtype == 2) REPRO_QKV(float, fp8e4m3);
  else if (in_dtype == 1 && kv_dtype == 0) REPRO_QKV(__nv_bfloat16, float);
  else if (in_dtype == 1 && kv_dtype == 1)
    REPRO_QKV(__nv_bfloat16, __nv_bfloat16);
  else if (in_dtype == 1 && kv_dtype == 2)
    REPRO_QKV(__nv_bfloat16, fp8e4m3);
  else return (int)cudaErrorInvalidValue;
#undef REPRO_QKV
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn (K/V pages only)
extern "C" int paged_kv_write(const void* k_new, const void* v_new,
                              void* k_pages, void* v_pages, const void* bt,
                              const void* lengths, const void* frame_ro,
                              const void* write_mask, int B, int hkv, int D,
                              int max_lpages, int page_slots, int np_loc,
                              int n_frames, int sid, int n_shards,
                              int in_dtype, int kv_dtype, void* stream) {
  const QkvArgs a{nullptr, k_new, v_new, nullptr, nullptr, k_pages, v_pages,
                  nullptr, nullptr, static_cast<const int32_t*>(bt),
                  static_cast<const int32_t*>(lengths),
                  static_cast<const uint8_t*>(frame_ro),
                  static_cast<const uint8_t*>(write_mask), 0, hkv, D,
                  max_lpages, page_slots, np_loc, n_frames, sid, n_shards,
                  0.f, 0.f, 0};
  return launch_qkv(a, B, in_dtype, kv_dtype,
                    static_cast<cudaStream_t>(stream));
}

// k_pages == nullptr: no write (v, the tables and kv_dtype are not read);
// k_out == nullptr: the rotated k is not returned
extern "C" int paged_qkv_write(const void* q, const void* k, const void* v,
                               void* q_out, void* k_out, void* k_pages,
                               void* v_pages, const void* q_norm,
                               const void* k_norm, const void* bt,
                               const void* lengths, const void* frame_ro,
                               const void* write_mask, int B, int hq, int hkv,
                               int D, int max_lpages, int page_slots,
                               int np_loc, int n_frames, int sid, int n_shards,
                               float eps, float theta, int rope, int in_dtype,
                               int kv_dtype, void* stream) {
  const QkvArgs a{q, k, v, q_out, k_out, k_pages, v_pages, q_norm, k_norm,
                  static_cast<const int32_t*>(bt),
                  static_cast<const int32_t*>(lengths),
                  static_cast<const uint8_t*>(frame_ro),
                  static_cast<const uint8_t*>(write_mask), hq, hkv, D,
                  max_lpages, page_slots, np_loc, n_frames, sid, n_shards,
                  eps, theta, rope};
  return launch_qkv(a, B, in_dtype, k_pages ? kv_dtype : in_dtype,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int paged_gather_attend(const void* q, const void* k_pages,
                                   const void* v_pages, const void* bt,
                                   const void* lengths, void* acc, void* m,
                                   void* l, void* part, void* count, int B,
                                   int hkv_loc, int G, int D, int page_slots,
                                   int max_lpages, int hkv, int np_loc,
                                   int sid, int n_shards, int kv_start,
                                   int window, float scale, int q_dtype,
                                   int kv_dtype, void* stream) {
  // the one check of K2's shape limits: the wrapper reports
  // cudaErrorInvalidValue as a head_dim or group the kernel does not take
  // (rows in whole units of the split walk, sd::takes)
  const uintptr_t kv = reinterpret_cast<uintptr_t>(k_pages) |
                       reinterpret_cast<uintptr_t>(v_pages);
  if (G < 1 || q_dtype < 0 || q_dtype > 1 || !sd::takes(kv_dtype, D, kv) ||
      reinterpret_cast<uintptr_t>(q) % (q_dtype == 1 ? 4 : 8))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || hkv_loc == 0) return (int)cudaSuccess;
  const int S = max_lpages * page_slots;
  const sd::Params p{q, q_dtype, acc, 0, static_cast<float*>(m),
                     static_cast<float*>(l), static_cast<float*>(part),
                     static_cast<unsigned*>(count), G, S, D, window, scale};
  const dim3 grid(sd::n_splits(S), hkv_loc, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return sd::dispatch(kv_dtype, D, kv, [&](auto var) {
    using Var = decltype(var);
    using T = typename Var::T;
    const int smem = Var::W * (D + 2) * (int)sizeof(float);
    gather_attend_kernel<T, Var::U, Var::UPL><<<grid, Var::W * 32, smem, s>>>(
        static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
        static_cast<const int32_t*>(bt), static_cast<const int32_t*>(lengths),
        hkv_loc, max_lpages, page_slots, hkv, np_loc, sid, n_shards, kv_start,
        p);
    return (int)cudaGetLastError();
  });
}
