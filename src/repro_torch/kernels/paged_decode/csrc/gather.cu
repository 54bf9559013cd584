// K7 gather_slots and K6 gather_pages for Hopper (sm_90a): the emulated
// memory's READ at slot and at page granularity.
//
// Replace the TPU kernels
//   repro/kernels/paged_decode/gather.py::gather_slots (_gather_slots_kernel)
//   repro/kernels/paged_decode/gather.py::gather_pages (_gather_pages_kernel)
// and compute what gather_ref.py computes: out[i] = row slots[i] of the
// store viewed as [n_slots, row] (K7), or page ids[i] viewed as
// [n_pages, page] (K6); a negative index writes zeros, and an index past
// the end reads the last row or page, as the oracle's clamped gather does,
// so neither kernel reads outside the store.
//
// Bound: bytes.  A gather does no arithmetic: it must read the indices and
// the rows or pages they name once and write the output once.  K7 at 65536
// slots of 128 f32 moves 67.4 MB (0.0201 ms at 3.35 TB/s); K6 at 4096
// pages of 256 x 128 f32 moves 1.07 GB (0.32 ms).
//
// Design: a gather is a byte copy, so both kernels take the row (K7) or the
// page (K6) in bytes and copy it in the widest unit that its byte size and
// both base pointers allow: 16-byte vectors for the production store's
// 512-byte rows, down to single bytes for a 3-element bf16 row.  K7 gives
// one warp to each requested slot, its lanes on consecutive units of the
// row, and grid-strides over the requests.  K6 cuts each page into chunks,
// one block each, on a flat grid whose block index gives (page, chunk).  A
// block of up to 256 threads copies one round of at most eight units a
// thread (32 KB in 16-byte units), all of a thread's loads in flight
// before its first store.  The chunk is chosen per call: that full round
// when there are pages enough for kMinBlocks blocks (the 4096-page bulk
// read: 16384 blocks of 2048 units), else the page cut into whole warps of
// units so that the grid has at least kMinBlocks blocks, two on each of
// the H100's 132 SMs (a 16-page cache fill: 256 blocks of 512 units; a
// 1-page swap-out: 256 blocks of 32 units, where one block a page ran on
// one SM).  A block has as many threads as its chunk has units, up to 256.
// Loads and stores stream past the caches (every byte is touched once).
// Every element and byte offset is computed in 64 bits: the production
// store holds 2^31 elements (8 GiB in f32).
//
// The C entries return cudaErrorInvalidValue for sizes they do not take
// and otherwise cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // K7: warps per block, a slot each
constexpr int64_t kMaxBlocks = 4096;  // K7: the grid strides past this
constexpr int kPageThreads = 256;     // K6: most threads per block
constexpr int kInFlight = 8;          // K6: units in flight per thread
constexpr int64_t kMinBlocks = 264;   // K6: two blocks per SM of an H100

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

template <typename V>
__global__ void __launch_bounds__(kWarps * 32) gather_slots_kernel(
    const V* __restrict__ pages, const int32_t* __restrict__ slots,
    V* __restrict__ out, int64_t n_slots, int64_t q, int64_t row_units) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  for (int64_t i = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); i < q;
       i += stride) {
    const int32_t slot = slots[i];
    V* dst = out + i * row_units;
    if (slot < 0) {
      for (int64_t j = lane; j < row_units; j += 32) dst[j] = V();
    } else {
      const V* src = pages + min64(slot, n_slots - 1) * row_units;
      for (int64_t j = lane; j < row_units; j += 32) dst[j] = src[j];
    }
  }
}

// Block i copies units [c * chunk, min((c + 1) * chunk, page_units)) of
// output page p = i / chunks, c = i % chunks, one round: chunk is at most
// kInFlight units for each of its threads.
template <typename V>
__global__ void __launch_bounds__(kPageThreads) gather_pages_kernel(
    const V* __restrict__ pages, const int32_t* __restrict__ ids,
    V* __restrict__ out, int64_t n_pages, int64_t page_units, int64_t chunk,
    int64_t chunks) {
  const int64_t p = blockIdx.x / chunks;
  const int64_t lo = blockIdx.x % chunks * chunk;
  const int64_t hi = min64(lo + chunk, page_units);
  const int64_t step = blockDim.x;
  const int64_t j = lo + threadIdx.x;
  const int32_t id = ids[p];
  V* dst = out + p * page_units;
  if (id < 0) {
#pragma unroll
    for (int k = 0; k < kInFlight; ++k)
      if (j + k * step < hi) __stcs(dst + j + k * step, V());
    return;
  }
  const V* src = pages + min64(id, n_pages - 1) * page_units;
  V v[kInFlight];
#pragma unroll
  for (int k = 0; k < kInFlight; ++k)
    if (j + k * step < hi) v[k] = __ldcs(src + j + k * step);
#pragma unroll
  for (int k = 0; k < kInFlight; ++k)
    if (j + k * step < hi) __stcs(dst + j + k * step, v[k]);
}

// the widest copy unit dividing ``bytes`` to which both pointers align
int unit_bytes(int64_t bytes, const void* a, const void* b) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b);
  int u = 16;
  while (u > 1 && (bytes % u || addr % u)) u >>= 1;
  return u;
}

template <typename V>
void launch_slots(const void* pages, const void* slots, void* out,
                  int64_t n_slots, int64_t q, int64_t row_bytes,
                  cudaStream_t stream) {
  const int64_t blocks = min64((q + kWarps - 1) / kWarps, kMaxBlocks);
  gather_slots_kernel<V><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const V*>(pages), static_cast<const int32_t*>(slots),
      static_cast<V*>(out), n_slots, q, row_bytes / (int64_t)sizeof(V));
}

template <typename V>
void launch_pages(const void* pages, const void* ids, void* out,
                  int64_t n_pages, int64_t p, int64_t page_bytes,
                  cudaStream_t stream) {
  const int64_t units = page_bytes / (int64_t)sizeof(V);
  // a full block's round, or the page cut into whole warps of units so that
  // the grid has kMinBlocks blocks
  int64_t chunk = min64(units, kInFlight * kPageThreads);
  const int64_t per_page = (kMinBlocks + p - 1) / p;
  if (per_page > 1 && units > 32)
    chunk = min64(chunk, ((units + per_page - 1) / per_page + 31) / 32 * 32);
  const int64_t chunks = (units + chunk - 1) / chunk;
  // at least chunk / kInFlight threads: one round
  const int threads = (int)min64(chunk, kPageThreads);
  gather_pages_kernel<V><<<(unsigned)(p * chunks), threads, 0, stream>>>(
      static_cast<const V*>(pages), static_cast<const int32_t*>(ids),
      static_cast<V*>(out), n_pages, units, chunk, chunks);
}

}  // namespace

#define REPRO_BY_UNIT(LAUNCH, ...)                   \
  switch (unit_bytes(__VA_ARGS__)) {                 \
    case 16: LAUNCH(uint4); break;                   \
    case 8: LAUNCH(uint2); break;                    \
    case 4: LAUNCH(unsigned int); break;             \
    case 2: LAUNCH(unsigned short); break;           \
    default: LAUNCH(unsigned char); break;           \
  }

// pages: the store, n_slots rows of row_bytes; slots: int32 [q]; out: [q]
// rows of row_bytes
extern "C" int gather_slots(const void* pages, const void* slots, void* out,
                            long long n_slots, long long q,
                            long long row_bytes, void* stream) {
  if (n_slots < 1 || q < 0 || row_bytes < 1) return (int)cudaErrorInvalidValue;
  if (q == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SLOTS(V) \
  launch_slots<V>(pages, slots, out, n_slots, q, row_bytes, s)
  REPRO_BY_UNIT(REPRO_SLOTS, row_bytes, pages, out)
#undef REPRO_SLOTS
  return (int)cudaGetLastError();
}

// pages: the store, n_pages pages of page_bytes; ids: int32 [p]; out: [p]
// pages of page_bytes
extern "C" int gather_pages(const void* pages, const void* ids, void* out,
                            long long n_pages, long long p,
                            long long page_bytes, void* stream) {
  // a block a page and 2048 bytes or more: the grid's 2^31 - 1 blocks
  if (n_pages < 1 || p < 0 || page_bytes < 1 || p > 0x7fffffffLL ||
      (page_bytes + 2047) / 2048 > 0x7fffffffLL / (p > 0 ? p : 1))
    return (int)cudaErrorInvalidValue;
  if (p == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_PAGES(V) \
  launch_pages<V>(pages, ids, out, n_pages, p, page_bytes, s)
  REPRO_BY_UNIT(REPRO_PAGES, page_bytes, pages, out)
#undef REPRO_PAGES
  return (int)cudaGetLastError();
}
