// Row-sparse Adagrad on the embedding table for Hopper (sm_90a), in place:
//   for each k with 0 <= ids[k] < n_rows, per element in f32:
//     s' = s + g*g;  state[id] = s';  values[id] = v - lr*g / (sqrt(s') + 1e-10)
//
// Replaces the TPU kernel marius_tpu/ops/pallas/adagrad.py:
// sparse_adagrad_update_pallas (_adagrad_kernel), which DMAs each row in and
// out one at a time and needs d % 128 == 0, K % 256 == 0 and a scratch row for
// padding. Here any K and any d are taken, and padding ids (>= n_rows, or < 0)
// are skipped.
//
// Precondition: the valid ids are UNIQUE, as for the TPU kernel. Two lanes
// updating one row would race on its read-modify-write.
//
// Bound: bytes. Per valid row it reads values, state and grads and writes
// values and state (5 x d floats) plus the id; about 7 flops per element is far
// below the card's rate. At the flagship's dense-accumulate branch (all 14,541
// rows, d = 50) that is about 14.5 MB.
//
// Design: one warp per id, lanes over consecutive columns (coalesced, masked
// tail for d = 50), grid-stride over ids. Each operation is rounded on its own
// (__fmul_rn, __fadd_rn, __fsqrt_rn, __fdiv_rn, __fsub_rn): nvcc would
// otherwise contract s + g*g into an FMA, and the result would no longer match
// the plain PyTorch version bit for bit. Untouched rows are never written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int64_t kMaxBlocks = 1 << 20;
constexpr float kEps = 1e-10f;  // marius_tpu/parallel/embedding_table.py ADAGRAD_EPS

template <typename Id>
__global__ void adagrad_kernel(float* __restrict__ values, float* __restrict__ state,
                               const Id* __restrict__ ids, const float* __restrict__ grads,
                               int64_t n_rows, int64_t k, int64_t d, float lr) {
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t row = first; row < k; row += stride) {
    const int64_t id = static_cast<int64_t>(ids[row]);
    if (id < 0 || id >= n_rows) continue;
    float* v = values + id * d;
    float* s = state + id * d;
    const float* g = grads + row * d;
    for (int64_t c = lane; c < d; c += 32) {
      const float gc = g[c];
      const float ns = __fadd_rn(s[c], __fmul_rn(gc, gc));
      s[c] = ns;
      const float denom = __fadd_rn(__fsqrt_rn(ns), kEps);
      v[c] = __fsub_rn(v[c], __fdiv_rn(__fmul_rn(lr, gc), denom));
    }
  }
}

template <typename Id>
int launch(float* values, float* state, const Id* ids, const float* grads, int64_t n_rows,
           int64_t k, int64_t d, float lr, cudaStream_t stream) {
  if (k == 0 || d == 0) return 0;
  int64_t blocks = (k + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  adagrad_kernel<Id><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
      values, state, ids, grads, n_rows, k, d, lr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns the cudaError_t of
// the launch (0 = success). Pointers are device pointers; no synchronisation.
extern "C" int marius_sparse_adagrad_f32_i64(float* values, float* state, const int64_t* ids,
                                             const float* grads, int64_t n_rows, int64_t k,
                                             int64_t d, float lr, void* stream) {
  return launch<int64_t>(values, state, ids, grads, n_rows, k, d, lr,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int marius_sparse_adagrad_f32_i32(float* values, float* state, const int32_t* ids,
                                             const float* grads, int64_t n_rows, int64_t k,
                                             int64_t d, float lr, void* stream) {
  return launch<int32_t>(values, state, ids, grads, n_rows, k, d, lr,
                         static_cast<cudaStream_t>(stream));
}
