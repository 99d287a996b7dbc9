// Embedding-row gather for Hopper (sm_90a): out[k] = table[clamp(ids[k], 0, n_rows - 1)].
//
// Replaces the TPU kernel marius_tpu/ops/pallas/gather.py:gather_rows_pallas
// (_gather_kernel), which streams one row DMA per id with 4 DMAs in flight and
// needs d % 128 == 0 and K % 1024 == 0. Here any K and any d are taken, with
// int64 or int32 ids, and f32 or bf16 rows (the TPU kernel's output takes the
// table's dtype). The copy moves bytes: one kernel serves both element types,
// and the entry points differ only in the element size they plan with.
//
// Bound: bytes; there is no arithmetic. The kernel reads each distinct row
// once and the ids once, and writes K rows.
// - At the flagship batch (K = 12,000, d = 50, a 2.9 MB table) the table
//   stays in L2, and the 4.1 MB move in about the time HBM would take for
//   them. The launch itself is the larger part: one launch of this kernel
//   for a single id takes about two thirds of the flagship's time.
// - At the out-of-core batch (30,000 distinct ids into a 17.2 GB partition
//   buffer, d = 100) the rows come from HBM: 12 MB of random 400-byte reads,
//   which need many bytes in flight to hide HBM's latency.
//
// Design:
// - A flat vector mapping. The output is K x (row bytes / V) vectors of V
//   bytes, V = 16, 8, 4 or 2: the widest that divides the row's bytes (4d in
//   f32, 2d in bf16) and both base addresses (the wrapper picks it on the
//   host; a table may be a view at an offset). Neighbouring threads take
//   neighbouring output vectors, so loads and stores coalesce and no lane
//   idles at d = 50 (f32: V = 8, 25 per row; bf16: 100-byte rows, V = 4).
//   V = 2 serves bf16 rows of an odd width.
// - 16 bytes per thread, every load before any store. A thread owns
//   U = 16 / V vectors of a tile, strided by the block's width: it loads
//   their ids, then all U row vectors, then stores them.
// - One wave. The wrapper sizes the grid to what the card holds at once (SMs
//   times resident blocks of 128 threads, read once per device); a
//   grid-stride loop takes any K beyond that.
// Many small threads (24-32 registers, 16 blocks per SM) keep the most bytes
// in flight: per-thread batches of 4 to 16 vectors, wider blocks, ids staged
// in shared memory and TMA row copies (cp.async.bulk into shared memory, one
// bulk store per block) were each slower at one shape or both. Row and
// column of each vector are stepped from the thread's first one by constant
// increments, so a thread does one 32-bit division, not one per vector.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kThreadBytes = 16;  // U x V

template <typename Id, typename Vec>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const Vec* __restrict__ table, const Id* __restrict__ ids,
                   Vec* __restrict__ out, int64_t n_rows, int64_t k, uint32_t vpr) {
  constexpr int U = kThreadBytes / sizeof(Vec);
  constexpr uint32_t kTile = kThreads * U;
  // from a thread's vector to its next one in the tile, and from one tile to the next
  const uint32_t step_rows = kThreads / vpr, step_cols = kThreads - step_rows * vpr;
  const uint32_t stride = gridDim.x * kTile;
  const uint32_t stride_rows = stride / vpr, stride_cols = stride - stride_rows * vpr;
  const uint32_t first = blockIdx.x * kTile + threadIdx.x;
  int64_t flat = first;  // the thread's first vector in this tile
  int64_t row = first / vpr;
  uint32_t col = first - static_cast<uint32_t>(row) * vpr;
  while (row < k) {
    // the thread's vector u lies in row row + dr[u]; it exists while that is below k
    const int64_t left64 = k - row;
    const uint32_t left = left64 > 0xffffffffLL ? 0xffffffffu : static_cast<uint32_t>(left64);
    const Vec* src[U];
    int valid = 0;
    uint32_t dr = 0, c = col;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (dr < left) {
        int64_t id = static_cast<int64_t>(ids[row + dr]);
        id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
        src[u] = table + id * vpr + c;
        valid = u + 1;
      }
      c += step_cols;
      dr += step_rows;
      if (c >= vpr) {
        c -= vpr;
        ++dr;
      }
    }
    Vec v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < valid) v[u] = __ldg(src[u]);
    }
    Vec* dst = out + flat;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < valid) dst[u * kThreads] = v[u];
    }
    flat += stride;
    row += stride_rows;
    col += stride_cols;
    if (col >= vpr) {
      col -= vpr;
      ++row;
    }
  }
}

template <typename Id, typename Vec>
int launch_vec(const void* table, const Id* ids, void* out, int64_t n_rows, int64_t k,
               uint32_t vpr, int grid, cudaStream_t stream) {
  gather_rows_kernel<Id, Vec><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const Vec*>(table), ids, reinterpret_cast<Vec*>(out), n_rows, k, vpr);
  return static_cast<int>(cudaGetLastError());
}

template <typename Id>
int launch(const void* table, const Id* ids, void* out, int64_t n_rows, int64_t k, int64_t d,
           int64_t elem_bytes, int vec_bytes, int unroll, int grid, cudaStream_t stream) {
  if (k == 0 || d == 0) return 0;
  // the plan must be one this file compiles, and the kernel counts a row's
  // vectors and a wave's in 32 bits
  const int64_t row_bytes = elem_bytes * d;
  if (vec_bytes <= 0 || vec_bytes > kThreadBytes || unroll != kThreadBytes / vec_bytes ||
      grid <= 0 || row_bytes % vec_bytes != 0 || row_bytes / vec_bytes > 0x7fffffffLL ||
      static_cast<int64_t>(grid) * kThreads * unroll > 0xffffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t vpr = static_cast<uint32_t>(row_bytes / vec_bytes);
  switch (vec_bytes) {
    case 16: return launch_vec<Id, uint4>(table, ids, out, n_rows, k, vpr, grid, stream);
    case 8: return launch_vec<Id, uint2>(table, ids, out, n_rows, k, vpr, grid, stream);
    case 4: return launch_vec<Id, uint32_t>(table, ids, out, n_rows, k, vpr, grid, stream);
    case 2: return launch_vec<Id, uint16_t>(table, ids, out, n_rows, k, vpr, grid, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Kernel>
int fewer_resident(Kernel kernel, int* blocks) {
  int n = 0;
  const int rc = static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0));
  if (rc == 0 && n < *blocks) *blocks = n;
  return rc;
}

template <typename Id>
int resident_of(int* blocks) {
  int rc = fewer_resident(gather_rows_kernel<Id, uint4>, blocks);
  if (rc == 0) rc = fewer_resident(gather_rows_kernel<Id, uint2>, blocks);
  if (rc == 0) rc = fewer_resident(gather_rows_kernel<Id, uint32_t>, blocks);
  if (rc == 0) rc = fewer_resident(gather_rows_kernel<Id, uint16_t>, blocks);
  return rc;
}

}  // namespace

// What the wrapper needs to size the grid, read once per device: the threads
// per block, the device's SM count and the fewest blocks of any instantiation
// that one SM keeps resident. Returns a cudaError_t (0 = success).
extern "C" int marius_gather_rows_config(int device, int* threads, int* sm_count,
                                         int* resident_blocks) {
  *threads = kThreads;
  int rc = static_cast<int>(cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount,
                                                   device));
  if (rc != 0) return rc;
  *resident_blocks = 1 << 30;
  rc = resident_of<int64_t>(resident_blocks);
  if (rc != 0) return rc;
  return resident_of<int32_t>(resident_blocks);
}

// Plain C entry points, loaded with ctypes. Each returns the cudaError_t of
// the launch (0 = success). Pointers are device pointers; no synchronisation.
// vec_bytes, unroll and grid come from the wrapper's plan (ops/cuda/gather.py).
extern "C" int marius_gather_rows_f32_i64(const float* table, const int64_t* ids, float* out,
                                          int64_t n_rows, int64_t k, int64_t d, int vec_bytes,
                                          int unroll, int grid, void* stream) {
  return launch<int64_t>(table, ids, out, n_rows, k, d, 4, vec_bytes, unroll, grid,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int marius_gather_rows_f32_i32(const float* table, const int32_t* ids, float* out,
                                          int64_t n_rows, int64_t k, int64_t d, int vec_bytes,
                                          int unroll, int grid, void* stream) {
  return launch<int32_t>(table, ids, out, n_rows, k, d, 4, vec_bytes, unroll, grid,
                         static_cast<cudaStream_t>(stream));
}

// bf16 tables: 2-byte elements (the rows are copied as bytes).
extern "C" int marius_gather_rows_bf16_i64(const uint16_t* table, const int64_t* ids,
                                           uint16_t* out, int64_t n_rows, int64_t k, int64_t d,
                                           int vec_bytes, int unroll, int grid, void* stream) {
  return launch<int64_t>(table, ids, out, n_rows, k, d, 2, vec_bytes, unroll, grid,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int marius_gather_rows_bf16_i32(const uint16_t* table, const int32_t* ids,
                                           uint16_t* out, int64_t n_rows, int64_t k, int64_t d,
                                           int vec_bytes, int unroll, int grid, void* stream) {
  return launch<int32_t>(table, ids, out, n_rows, k, d, 2, vec_bytes, unroll, grid,
                         static_cast<cudaStream_t>(stream));
}
