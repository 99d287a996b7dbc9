// Embedding-row gather for Hopper (sm_90a): out[k] = table[clamp(ids[k], 0, n_rows - 1)].
//
// Replaces the TPU kernel marius_tpu/ops/pallas/gather.py:gather_rows_pallas
// (_gather_kernel), which streams one row DMA per id with 4 DMAs in flight and
// needs d % 128 == 0 and K % 1024 == 0. Here any K and any d are taken.
//
// Bound: bytes. The work is K row reads and K row writes of d floats plus the
// ids; there is no arithmetic. At the flagship shape (K = 12,000 ids, d = 50,
// a 2.9 MB table that stays in L2) about 4.8 MB move, a few microseconds at
// HBM rate, so launch overhead is of the same order.
//
// Design: one warp per output row. The 32 lanes read and write consecutive
// columns, so each row is one or two coalesced transactions; a row narrower
// than a multiple of 32 (d = 50) ends in a masked tail. Every lane reads the
// row's id (one broadcast load). A grid-stride loop over rows takes any K.
// Ids are int64 (torch's index dtype) or int32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int64_t kMaxBlocks = 1 << 20;

template <typename Id>
__global__ void gather_rows_kernel(const float* __restrict__ table,
                                   const Id* __restrict__ ids,
                                   float* __restrict__ out,
                                   int64_t n_rows, int64_t k, int64_t d) {
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t row = first; row < k; row += stride) {
    int64_t id = static_cast<int64_t>(ids[row]);
    id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
    const float* src = table + id * d;
    float* dst = out + row * d;
    for (int64_t c = lane; c < d; c += 32) {
      dst[c] = __ldg(src + c);
    }
  }
}

template <typename Id>
int launch(const float* table, const Id* ids, float* out, int64_t n_rows,
           int64_t k, int64_t d, cudaStream_t stream) {
  if (k == 0 || d == 0) return 0;
  int64_t blocks = (k + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gather_rows_kernel<Id><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
      table, ids, out, n_rows, k, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns the cudaError_t of
// the launch (0 = success). Pointers are device pointers; no synchronisation.
extern "C" int marius_gather_rows_f32_i64(const float* table, const int64_t* ids, float* out,
                                          int64_t n_rows, int64_t k, int64_t d, void* stream) {
  return launch<int64_t>(table, ids, out, n_rows, k, d, static_cast<cudaStream_t>(stream));
}

extern "C" int marius_gather_rows_f32_i32(const float* table, const int32_t* ids, float* out,
                                          int64_t n_rows, int64_t k, int64_t d, void* stream) {
  return launch<int32_t>(table, ids, out, n_rows, k, d, static_cast<cudaStream_t>(stream));
}
