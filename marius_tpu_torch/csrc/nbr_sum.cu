// Bucketed neighbour gather-sum for Hopper (sm_90a): for every task t,
//   dest(t) = sum over slots s in [start[t], start[t] + len[t]) of x[ids[s]]
// with f32 accumulation whatever the input type, and ids outside [0, n_rows)
// adding zero. A task is one padded neighbour row of a degree bucket, or one
// 256-slot piece of a hub row; pieces land in a scratch block and a second
// small pass folds them, in piece order, into the hub's output row.
//
// Replaces the TPU kernel marius_tpu/ops/pallas/nbr_sum.py:gather_sum_pallas
// (_kernel), which streams neighbour rows with grouped row DMAs into VMEM,
// runs once per degree bucket, needs d % 128 == 0 and a zero sentinel row in
// x, and splits rows wider than 256 slots into virtual rows folded by XLA.
//
// Bound: bytes. Each slot reads one d-wide row of x at a random place; the
// sum itself is one add per element. Counting each input once (x, the ids
// and the task arrays) and the output once, the full-graph operator at
// ogbn-arxiv shape (169,343 x 128 f32, ~2.5 M slots) moves ~185 MB, ~55 us at
// 3.35 TB/s. x (87 MB) does not fit the 50 MB L2, so without reuse each slot
// costs a 512-byte row read from HBM (~1.3 GB, ~0.38 ms): what the kernel
// gets from L2 decides where it lands between the two.
//
// Design: one warp per task. The warp loads 32 of the task's ids at once
// (coalesced) and broadcasts them with __shfl_sync; lanes span the columns
// with 16-byte loads where the row allows it (f32 with d % 4 == 0, bf16 with
// d % 8 == 0, x 16-byte aligned) and one element per lane otherwise; a
// column tile loop covers any d. Four row loads are in flight per warp
// before their adds. Slots are added in order, one __fadd_rn each, into an
// f32 accumulator, so the result is deterministic (no atomics) and equals
// the plain PyTorch version in marius_tpu_torch/ops/cuda/nbr_sum.py bit for
// bit. Invalid ids (padding id n_rows) add zero without a row read, so x
// needs no sentinel row. Splitting hub rows (13k slots at arxiv shape) into
// 256-slot tasks keeps one warp from serialising a whole hub and setting the
// launch's time. Each task writes its own output row (or scratch row), so
// the degree-sorted -> original-order permutation costs nothing.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int64_t kMaxBlocks = 1 << 20;
constexpr int kInFlight = 4;   // row loads issued per warp before their adds

// load V consecutive elements of a row as floats
template <typename T, int V>
struct RowLoad;

template <>
struct RowLoad<float, 4> {
  static __device__ __forceinline__ void run(const float* p, float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};

template <>
struct RowLoad<float, 1> {
  static __device__ __forceinline__ void run(const float* p, float (&v)[1]) {
    v[0] = __ldg(p);
  }
};

template <>
struct RowLoad<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // element 2i is the low half of word i
      v[2 * i] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w[i] & 0xffffu)));
      v[2 * i + 1] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w[i] >> 16)));
    }
  }
};

template <>
struct RowLoad<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __bfloat162float(p[0]);
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_sum_kernel(const T* __restrict__ x, int64_t n_rows, int64_t d,
                  const int32_t* __restrict__ ids,
                  const int64_t* __restrict__ task_start,
                  const int32_t* __restrict__ task_len,
                  const int32_t* __restrict__ task_dest, int64_t n_tasks,
                  float* __restrict__ out, float* __restrict__ partial) {
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t task = first; task < n_tasks; task += stride) {
    const int64_t start = task_start[task];
    const int len = task_len[task];
    const int32_t dest = task_dest[task];
    float* dst = dest >= 0 ? out + static_cast<int64_t>(dest) * d
                           : partial + (-static_cast<int64_t>(dest) - 1) * d;
    // the tile base is the same for every lane, so all lanes reach each shuffle
    for (int64_t base = 0; base < d; base += 32 * V) {
      const int64_t col = base + static_cast<int64_t>(lane) * V;
      const bool active = col < d;   // V > 1 only when d % V == 0
      float acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = 0.0f;
      for (int b0 = 0; b0 < len; b0 += 32) {
        const int cnt = min(32, len - b0);
        const int32_t mine = lane < cnt ? ids[start + b0 + lane] : -1;
        for (int j = 0; j < cnt; j += kInFlight) {
          float v[kInFlight][V];
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) {
            const int32_t id = __shfl_sync(0xffffffffu, mine, (j + u) & 31);
            if (active && j + u < cnt && id >= 0 && id < n_rows) {
              RowLoad<T, V>::run(x + static_cast<int64_t>(id) * d + col, v[u]);
            } else {
#pragma unroll
              for (int k = 0; k < V; ++k) v[u][k] = 0.0f;
            }
          }
          // in slot order; adding +0.0f leaves the sum's bits as they are
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) {
#pragma unroll
            for (int k = 0; k < V; ++k) acc[k] = __fadd_rn(acc[k], v[u][k]);
          }
        }
      }
      if (active) {
#pragma unroll
        for (int k = 0; k < V; ++k) dst[col + k] = acc[k];
      }
    }
  }
}

// out[fold_dest[h]] = sum over k < fold_count[h] of partial[fold_first[h] + k], in order
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fold_kernel(const float* __restrict__ partial, int64_t d,
            const int32_t* __restrict__ fold_first,
            const int32_t* __restrict__ fold_count,
            const int32_t* __restrict__ fold_dest, int64_t n_folds,
            float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t h = first; h < n_folds; h += stride) {
    const float* src = partial + static_cast<int64_t>(fold_first[h]) * d;
    const int count = fold_count[h];
    float* dst = out + static_cast<int64_t>(fold_dest[h]) * d;
    for (int64_t c = lane; c < d; c += 32) {
      float acc = 0.0f;
      for (int k = 0; k < count; ++k) acc = __fadd_rn(acc, src[static_cast<int64_t>(k) * d + c]);
      dst[c] = acc;
    }
  }
}

unsigned grid_for(int64_t warps) {
  int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return static_cast<unsigned>(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

template <typename T, int V>
int launch(const T* x, int64_t n_rows, int64_t d, const int32_t* ids, const int64_t* task_start,
           const int32_t* task_len, const int32_t* task_dest, int64_t n_tasks,
           const int32_t* fold_first, const int32_t* fold_count, const int32_t* fold_dest,
           int64_t n_folds, float* out, float* partial, cudaStream_t stream) {
  if (n_tasks > 0) {
    gather_sum_kernel<T, V><<<grid_for(n_tasks), kWarpsPerBlock * 32, 0, stream>>>(
        x, n_rows, d, ids, task_start, task_len, task_dest, n_tasks, out, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_folds > 0) {
    fold_kernel<<<grid_for(n_folds), kWarpsPerBlock * 32, 0, stream>>>(
        partial, d, fold_first, fold_count, fold_dest, n_folds, out);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns the cudaError_t of
// its launches (0 = success). Pointers are device pointers; no
// synchronisation. task_dest >= 0 is an output row, < 0 the scratch row
// (-task_dest - 1); the fold arrays may be empty (n_folds = 0).
extern "C" int marius_gather_sum_f32(const float* x, int64_t n_rows, int64_t d,
                                     const int32_t* ids, const int64_t* task_start,
                                     const int32_t* task_len, const int32_t* task_dest,
                                     int64_t n_tasks, const int32_t* fold_first,
                                     const int32_t* fold_count, const int32_t* fold_dest,
                                     int64_t n_folds, float* out, float* partial, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned16(x)) {
    return launch<float, 4>(x, n_rows, d, ids, task_start, task_len, task_dest, n_tasks,
                            fold_first, fold_count, fold_dest, n_folds, out, partial, s);
  }
  return launch<float, 1>(x, n_rows, d, ids, task_start, task_len, task_dest, n_tasks,
                          fold_first, fold_count, fold_dest, n_folds, out, partial, s);
}

extern "C" int marius_gather_sum_bf16(const __nv_bfloat16* x, int64_t n_rows, int64_t d,
                                      const int32_t* ids, const int64_t* task_start,
                                      const int32_t* task_len, const int32_t* task_dest,
                                      int64_t n_tasks, const int32_t* fold_first,
                                      const int32_t* fold_count, const int32_t* fold_dest,
                                      int64_t n_folds, float* out, float* partial, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 8 == 0 && aligned16(x)) {
    return launch<__nv_bfloat16, 8>(x, n_rows, d, ids, task_start, task_len, task_dest,
                                    n_tasks, fold_first, fold_count, fold_dest, n_folds, out,
                                    partial, s);
  }
  return launch<__nv_bfloat16, 1>(x, n_rows, d, ids, task_start, task_len, task_dest, n_tasks,
                                  fold_first, fold_count, fold_dest, n_folds, out, partial, s);
}
