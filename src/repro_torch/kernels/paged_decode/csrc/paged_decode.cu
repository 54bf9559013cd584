// Paged-decode kernels for Hopper (sm_90a): the WRITE and READ halves of
// the emulated-memory protocol, walking the BlockManager's block tables
// inside the kernel so that address translation rides the memory access.
//
// K1 paged_kv_write replaces the TPU kernel
//   repro/kernels/paged_decode/kernel.py::paged_kv_write (_kv_write_kernel).
//   Bound: bytes.  Each sequence moves one [Hkv, D] K row and one V row
//   (16 KB per sequence in bf16 at Hkv=8, D=128) plus a few table words:
//   the work is a scatter, far below the card's operation rate.
//   Design: one block per sequence.  The block reads its length and its
//   block-table entry itself, applies the four drop conditions (write mask
//   off, length 0, unmapped page, read-only shared frame) and the shard
//   ownership test (f % n_shards == sid), and writes Hkv*D elements with
//   consecutive threads on consecutive addresses.  The TPU body rescans
//   every sequence's table per visited row because Pallas aliases output
//   blocks and several grid steps may visit one row; on the GPU distinct
//   sequences never write the same (row, slot) -- a frame that several
//   sequences share is read-only and its writes are dropped -- so no scan
//   is needed and every block writes only its own row.
//
// K2 paged_gather_attend replaces the TPU kernel
//   repro/kernels/paged_decode/kernel.py::paged_gather_attend
//   (_gather_attend_kernel).
//   Bound: bytes.  Every attended K and V row is read once from device
//   memory and used by only G query heads (2 for qwen3-0.6b), about
//   G * 4 floating-point operations per byte, well below the H100's
//   ridge point.
//   Design: one block of 8 warps per (sequence, local KV head).  The
//   block walks its block-table row itself, position by position, only over
//   [max(0, len - window), len) -- the TPU grid walks all max_lpages pages
//   because its grid is static -- and skips frames another shard owns.  The
//   warps split the G query heads of the group between them and, within a
//   head, interleave chunks of 8 positions (4 when D > 128): a warp first
//   loads a whole chunk's K and V rows into registers (each lane a pair of
//   elements per load, so every load is coalesced and a chunk's loads are
//   all in flight together), then scores it and folds it into the warp's
//   own online softmax (m, l, acc in f32 registers; decode_attend.cuh).
//   No shared memory holds K or V, so any page size fits.  At the end the
//   block merges its warps' (m, l, acc) by log-sum-exp through 8*D floats
//   of shared memory and emits UNNORMALISED (acc, m, l) so shards can be
//   merged the same way.  An empty row leaves exactly m = -1e30, l = 0,
//   acc = 0.  scale = D^-0.5 multiplies the q.k product, as on the TPU.
//   An earlier version staged pages through shared memory with four block
//   barriers per page; it ran at 0.30 ms per call at the main path's
//   shapes on an H100, twice the plain PyTorch version's device time.  The
//   next loaded one element per lane and load (0.088 ms).
//
// Both entries take (sid, n_shards, kv_start) so one build serves every
// shard of a multi-shard layout.  Each C entry returns cudaGetLastError().

#include "decode_attend.cuh"

namespace {

using repro::kNegInf;
using repro::to_f32;

template <typename To, typename From>
__device__ __forceinline__ To convert(From x) {
  return repro::from_f32<To>(to_f32(x));
}

// -- K1: WRITE -----------------------------------------------------------------
template <typename Tin, typename Tkv>
__global__ void kv_write_kernel(const Tin* __restrict__ k_new,
                                const Tin* __restrict__ v_new,
                                Tkv* __restrict__ k_pages,
                                Tkv* __restrict__ v_pages,
                                const int32_t* __restrict__ block_table,
                                const int32_t* __restrict__ lengths,
                                const uint8_t* __restrict__ frame_ro,
                                const uint8_t* __restrict__ write_mask,
                                int max_lpages, int page_slots, int np_loc,
                                int n_frames, int row_elems, int sid,
                                int n_shards) {
  const int b = blockIdx.x;
  const int len = lengths[b];
  if (!write_mask[b] || len <= 0) return;
  const int pidx = (len - 1) / page_slots;
  if (pidx >= max_lpages) return;
  const int f = block_table[(int64_t)b * max_lpages + pidx];
  if (f < 0 || f >= n_frames || frame_ro[f] || f % n_shards != sid) return;
  const int row = f / n_shards;
  if (row >= np_loc) return;
  const int off = (len - 1) % page_slots;
  const int64_t dst = ((int64_t)row * page_slots + off) * row_elems;
  const int64_t src = (int64_t)b * row_elems;
  for (int i = threadIdx.x; i < row_elems; i += blockDim.x) {
    k_pages[dst + i] = convert<Tkv, Tin>(k_new[src + i]);
    v_pages[dst + i] = convert<Tkv, Tin>(v_new[src + i]);
  }
}

// -- K2: READ + attend ------------------------------------------------------------
constexpr int kAttendWarps = 8;

template <typename Tq, typename Tkv, int MAX_P, int CHUNK>
__global__ void __launch_bounds__(kAttendWarps * 32) gather_attend_kernel(
    const Tq* __restrict__ q, const Tkv* __restrict__ k_pages,
    const Tkv* __restrict__ v_pages, const int32_t* __restrict__ block_table,
    const int32_t* __restrict__ lengths, float* __restrict__ acc_out,
    float* __restrict__ m_out, float* __restrict__ l_out, int hkv_loc, int G,
    int D, int page_slots, int max_lpages, int hkv, int np_loc, int sid,
    int n_shards, int kv_start, int window, float scale) {
  // per (head g, warp-of-head w): acc[D] | m | l
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = lengths[b];
  const int lo = (window > 0 && len > window) ? len - window : 0;
  const int hi = min(len, max_lpages * page_slots);
  const int kvh = kv_start + h;
  const int64_t head0 = ((int64_t)b * hkv_loc + h) * G;   // first q head
  const int32_t* bt_row = block_table + (int64_t)b * max_lpages;
  // warps per query head; with more heads than warps each warp takes
  // heads warp, warp + kAttendWarps, ... alone
  const int wph = G >= kAttendWarps ? 1 : kAttendWarps / G;
  const int stride = CHUNK * wph;

  for (int g = warp / wph; g < G; g += kAttendWarps / wph) {
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
        const int pos = c0 + c;
        ok[c] = false;
        base[c] = 0;
        if (pos < hi) {
          const int f = bt_row[pos / page_slots];
          if (f >= 0 && f % n_shards == sid && f / n_shards < np_loc) {
            ok[c] = true;
            base[c] = (((int64_t)(f / n_shards) * page_slots
                        + pos % page_slots) * hkv + kvh) * D;
          }
        }
      }
      repro::fold_chunk<Tkv, MAX_P, CHUNK>(k_pages, v_pages, base, ok, D,
                                           lane, scale, qr, acc, m, l);
    }
    repro::store_record(smem + (int64_t)(g * wph + w) * (D + 2), acc, m, l,
                        D, lane);
  }
  __syncthreads();
  // log-sum-exp merge of each head's warps; the output stays unnormalised
  repro::merge_records(smem, G, D, wph, head0, acc_out, m_out, l_out);
}

constexpr int kWriteThreads = 256;

template <typename Tin, typename Tkv>
void launch_write(const void* k_new, const void* v_new, void* k_pages,
                  void* v_pages, const void* bt, const void* lengths,
                  const void* frame_ro, const void* write_mask, int B,
                  int max_lpages, int page_slots, int np_loc, int n_frames,
                  int row_elems, int sid, int n_shards, cudaStream_t stream) {
  kv_write_kernel<Tin, Tkv><<<B, kWriteThreads, 0, stream>>>(
      static_cast<const Tin*>(k_new), static_cast<const Tin*>(v_new),
      static_cast<Tkv*>(k_pages), static_cast<Tkv*>(v_pages),
      static_cast<const int32_t*>(bt), static_cast<const int32_t*>(lengths),
      static_cast<const uint8_t*>(frame_ro),
      static_cast<const uint8_t*>(write_mask), max_lpages, page_slots, np_loc,
      n_frames, row_elems, sid, n_shards);
}

template <typename Tq, typename Tkv>
void launch_attend(const void* q, const void* k_pages, const void* v_pages,
                   const void* bt, const void* lengths, void* acc, void* m,
                   void* l, int B, int hkv_loc, int G, int D, int page_slots,
                   int max_lpages, int hkv, int np_loc, int sid, int n_shards,
                   int kv_start, int window, float scale, int smem_bytes,
                   cudaStream_t stream) {
  dim3 grid(B, hkv_loc);
  const int threads = kAttendWarps * 32;
#define REPRO_ATTEND_ARGS                                                     \
  static_cast<const Tq*>(q), static_cast<const Tkv*>(k_pages),               \
      static_cast<const Tkv*>(v_pages), static_cast<const int32_t*>(bt),     \
      static_cast<const int32_t*>(lengths), static_cast<float*>(acc),        \
      static_cast<float*>(m), static_cast<float*>(l), hkv_loc, G, D,         \
      page_slots, max_lpages, hkv, np_loc, sid, n_shards, kv_start, window,  \
      scale
  if (D <= 128)
    gather_attend_kernel<Tq, Tkv, 2, 8>
        <<<grid, threads, smem_bytes, stream>>>(REPRO_ATTEND_ARGS);
  else
    gather_attend_kernel<Tq, Tkv, 4, 4>
        <<<grid, threads, smem_bytes, stream>>>(REPRO_ATTEND_ARGS);
#undef REPRO_ATTEND_ARGS
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16
extern "C" int paged_kv_write(const void* k_new, const void* v_new,
                              void* k_pages, void* v_pages, const void* bt,
                              const void* lengths, const void* frame_ro,
                              const void* write_mask, int B, int max_lpages,
                              int page_slots, int np_loc, int n_frames,
                              int row_elems, int sid, int n_shards,
                              int in_dtype, int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_WRITE(TIN, TKV)                                               \
  launch_write<TIN, TKV>(k_new, v_new, k_pages, v_pages, bt, lengths,       \
                         frame_ro, write_mask, B, max_lpages, page_slots,   \
                         np_loc, n_frames, row_elems, sid, n_shards, s)
  if (in_dtype == 0 && kv_dtype == 0) REPRO_WRITE(float, float);
  else if (in_dtype == 0 && kv_dtype == 1) REPRO_WRITE(float, __nv_bfloat16);
  else if (in_dtype == 1 && kv_dtype == 0) REPRO_WRITE(__nv_bfloat16, float);
  else if (in_dtype == 1 && kv_dtype == 1)
    REPRO_WRITE(__nv_bfloat16, __nv_bfloat16);
  else return (int)cudaErrorInvalidValue;
#undef REPRO_WRITE
  return (int)cudaGetLastError();
}

extern "C" int paged_gather_attend(const void* q, const void* k_pages,
                                   const void* v_pages, const void* bt,
                                   const void* lengths, void* acc, void* m,
                                   void* l, int B, int hkv_loc, int G, int D,
                                   int page_slots, int max_lpages, int hkv,
                                   int np_loc, int sid, int n_shards,
                                   int kv_start, int window, float scale,
                                   int q_dtype, int kv_dtype, void* stream) {
  // the one check of K2's shape limits: the wrapper reports
  // cudaErrorInvalidValue as a head_dim or group the kernel does not take
  if (D < 2 || D > 256 || D % 2 || G < 1) return (int)cudaErrorInvalidValue;
  // rows are read in element pairs
  if (reinterpret_cast<uintptr_t>(q) % (q_dtype == 1 ? 4 : 8) ||
      (reinterpret_cast<uintptr_t>(k_pages) |
       reinterpret_cast<uintptr_t>(v_pages)) % (kv_dtype == 1 ? 4 : 8))
    return (int)cudaErrorInvalidValue;
  const int wph = G >= kAttendWarps ? 1 : kAttendWarps / G;
  const int smem_bytes = (int)sizeof(float) * G * wph * (D + 2);
  if (smem_bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_ATTEND(TQ, TKV)                                                \
  launch_attend<TQ, TKV>(q, k_pages, v_pages, bt, lengths, acc, m, l, B,     \
                         hkv_loc, G, D, page_slots, max_lpages, hkv, np_loc, \
                         sid, n_shards, kv_start, window, scale, smem_bytes, \
                         s)
  if (q_dtype == 0 && kv_dtype == 0) REPRO_ATTEND(float, float);
  else if (q_dtype == 0 && kv_dtype == 1) REPRO_ATTEND(float, __nv_bfloat16);
  else if (q_dtype == 1 && kv_dtype == 0) REPRO_ATTEND(__nv_bfloat16, float);
  else if (q_dtype == 1 && kv_dtype == 1)
    REPRO_ATTEND(__nv_bfloat16, __nv_bfloat16);
  else return (int)cudaErrorInvalidValue;
#undef REPRO_ATTEND
  return (int)cudaGetLastError();
}
