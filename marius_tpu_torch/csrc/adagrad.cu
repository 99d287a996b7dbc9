// Row-sparse Adagrad on the embedding table for Hopper (sm_90a), in place:
//   for each k with 0 <= ids[k] < n_rows, per element:
//     s' = s + g*g;  state[id] = s';  values[id] = v - lr*g / (sqrt(s') + 1e-10)
// for f32 or bf16 values, state and grads (all three of one type).
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
//
// bf16: every operation runs in f32 on bf16 inputs and is rounded to bf16
// (round to nearest even) before the next one uses it, and lr and eps are
// bf16 constants:
//   gg = rn(g*g); s' = rn(s + gg); q = rn(sqrt(s')); den = rn(q + rn(1e-10));
//   num = rn(rn(lr)*g); v' = rn(v - rn(num / den))
// That is the sequence XLA compiles JAX's plain sparse_adagrad_update to on
// bf16 rows (a convert to bf16 after each op; Python scalars are weakly typed,
// so lr and eps become bf16), and the sequence of the plain PyTorch version.
// The bytes per row halve; the kernel stays bound by them.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Loads, stores and the rounding after each operation, per element type.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

constexpr int kWarpsPerBlock = 8;
constexpr int64_t kMaxBlocks = 1 << 20;
constexpr float kEps = 1e-10f;  // marius_tpu/parallel/embedding_table.py ADAGRAD_EPS

template <typename T, typename Id>
__global__ void adagrad_kernel(T* __restrict__ values, T* __restrict__ state,
                               const Id* __restrict__ ids, const T* __restrict__ grads,
                               int64_t n_rows, int64_t k, int64_t d, float lr_in) {
  using E = Elem<T>;
  const float lr = E::round(lr_in);
  const float eps = E::round(kEps);
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t row = first; row < k; row += stride) {
    const int64_t id = static_cast<int64_t>(ids[row]);
    if (id < 0 || id >= n_rows) continue;
    T* v = values + id * d;
    T* s = state + id * d;
    const T* g = grads + row * d;
    for (int64_t c = lane; c < d; c += 32) {
      const float gc = E::load(g + c);
      const float ns = E::round(__fadd_rn(E::load(s + c), E::round(__fmul_rn(gc, gc))));
      E::store(s + c, ns);
      const float denom = E::round(__fadd_rn(E::round(__fsqrt_rn(ns)), eps));
      const float step = E::round(__fdiv_rn(E::round(__fmul_rn(lr, gc)), denom));
      E::store(v + c, __fsub_rn(E::load(v + c), step));
    }
  }
}

template <typename T, typename Id>
int launch(T* values, T* state, const Id* ids, const T* grads, int64_t n_rows,
           int64_t k, int64_t d, float lr, cudaStream_t stream) {
  if (k == 0 || d == 0) return 0;
  int64_t blocks = (k + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  adagrad_kernel<T, Id><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
      values, state, ids, grads, n_rows, k, d, lr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns the cudaError_t of
// the launch (0 = success). Pointers are device pointers; no synchronisation.
extern "C" int marius_sparse_adagrad_f32_i64(float* values, float* state, const int64_t* ids,
                                             const float* grads, int64_t n_rows, int64_t k,
                                             int64_t d, float lr, void* stream) {
  return launch<float, int64_t>(values, state, ids, grads, n_rows, k, d, lr,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int marius_sparse_adagrad_f32_i32(float* values, float* state, const int32_t* ids,
                                             const float* grads, int64_t n_rows, int64_t k,
                                             int64_t d, float lr, void* stream) {
  return launch<float, int32_t>(values, state, ids, grads, n_rows, k, d, lr,
                                static_cast<cudaStream_t>(stream));
}

// bf16 values, state and grads; lr is rounded to bf16 in the kernel.
extern "C" int marius_sparse_adagrad_bf16_i64(__nv_bfloat16* values, __nv_bfloat16* state,
                                              const int64_t* ids, const __nv_bfloat16* grads,
                                              int64_t n_rows, int64_t k, int64_t d, float lr,
                                              void* stream) {
  return launch<__nv_bfloat16, int64_t>(values, state, ids, grads, n_rows, k, d, lr,
                                        static_cast<cudaStream_t>(stream));
}

extern "C" int marius_sparse_adagrad_bf16_i32(__nv_bfloat16* values, __nv_bfloat16* state,
                                              const int32_t* ids, const __nv_bfloat16* grads,
                                              int64_t n_rows, int64_t k, int64_t d, float lr,
                                              void* stream) {
  return launch<__nv_bfloat16, int32_t>(values, state, ids, grads, n_rows, k, d, lr,
                                        static_cast<cudaStream_t>(stream));
}
