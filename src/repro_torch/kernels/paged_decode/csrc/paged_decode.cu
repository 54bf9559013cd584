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
// Both entries take (sid, n_shards, kv_start) so one build serves every
// shard of a multi-shard layout.  Each C entry returns cudaGetLastError().

#include "split_decode.cuh"

namespace {

namespace sd = repro::split_decode;
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
                                   void* l, void* part, void* count, int B,
                                   int hkv_loc, int G, int D, int page_slots,
                                   int max_lpages, int hkv, int np_loc,
                                   int sid, int n_shards, int kv_start,
                                   int window, float scale, int q_dtype,
                                   int kv_dtype, void* stream) {
  // the one check of K2's shape limits: the wrapper reports
  // cudaErrorInvalidValue as a head_dim or group the kernel does not take
  if (D < 2 || D > 256 || D % 2 || G < 1 || q_dtype < 0 || q_dtype > 1 ||
      kv_dtype < 0 || kv_dtype > 1)
    return (int)cudaErrorInvalidValue;
  // rows are read in element pairs at least
  const uintptr_t kv = reinterpret_cast<uintptr_t>(k_pages) |
                       reinterpret_cast<uintptr_t>(v_pages);
  if (reinterpret_cast<uintptr_t>(q) % (q_dtype == 1 ? 4 : 8) ||
      kv % (kv_dtype == 1 ? 4 : 8))
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
