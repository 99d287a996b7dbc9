// Bucketed neighbour gather-sum for Hopper (sm_90a): for every task t,
//   dest(t) = sum over slots s in [start[t], start[t] + len[t]) of x[ids[s]]
// with f32 accumulation whatever the input type, and ids outside [0, n_rows)
// adding zero. A task is one padded neighbour row of a degree bucket, or one
// 256-slot piece of a hub row; a hub row's pieces are summed on their own and
// then folded, in piece order, into the hub's output row.
//
// Replaces the TPU kernel marius_tpu/ops/pallas/nbr_sum.py:gather_sum_pallas
// (_kernel), which streams neighbour rows with grouped row DMAs into VMEM,
// runs once per degree bucket, needs d % 128 == 0 and a zero sentinel row in
// x, and splits rows wider than 256 slots into virtual rows folded by XLA.
//
// Bound: bytes. Each slot reads one d-wide row of x at a random place; the
// sum itself is one add per element. Counting each input once (x, the ids
// and the task arrays) and the output once, the full-graph operator at
// ogbn-arxiv shape (169,343 x 128 f32, ~2.5 M slots) moves ~186 MB, ~55 us at
// 3.35 TB/s. Read row by row, x (87 MB) does not fit the 50 MB L2, so most
// of the 1.19 GB of slot reads would come from device memory (~0.36 ms);
// served from L2, they are bound by L2's read rate instead.
//
// Design (PERF.md, PR 3, has each step's measured effect):
// - Column slabs, slab-major. The columns are cut into slabs of 128 bytes
//   per row (32 f32 or 64 bf16 columns): one L2 line per row. Blocks are
//   numbered slab-major, so every task runs over slab 0 before any block
//   touches slab 1; one slab of x (21.7 MB at arxiv shape) then mostly stays
//   in L2 while all the slot reads of that slab hit it. The ids and the task
//   arrays are read with streaming loads (__ldcs) and the output written
//   with streaming stores (__stcs), so that they do not push the slab out of
//   L2; they are re-read once per slab.
// - Several tasks per warp. A group of 8 lanes covers one 128-byte slab row
//   with 16-byte loads (f32 with d % 4 == 0, bf16 with d % 8 == 0, x 16-byte
//   aligned; one element at a time otherwise), so a warp sums four tasks at
//   once, each group adding its own slots in order. The lanes of a group
//   load the ids of its next 16 slots and share them with __shfl_sync: 16
//   slab-row loads in flight per group (8 on the one-element path), and the
//   next batch's ids load while this batch's rows do. Blocks are small (4
//   warps), which measured faster than larger ones.
// - Hub pieces as tasks. The pieces of rows wider than 256 slots are the
//   first tasks of each slab, spread over all warps like any other task. A
//   group that sums a piece leaves it in a small scratch (n_pieces x d
//   floats, which stays in L2) and counts it in for its (hub, slab); the
//   group that brings the hub's last piece folds all of its pieces in piece
//   order and writes the hub's row. One launch; no second pass. (One block
//   per hub and slab, folding in shared memory, measured slower: the widest
//   hub's chain of dependent loads became the kernel's critical path.)
// Slots are added in order, one __fadd_rn each, into an f32 accumulator that
// starts at +0.0; an invalid id adds +0.0 (no row read), which leaves such a
// sum's bits as they are; pieces are folded in order the same way. So the
// result is deterministic (no atomics on values) and equals the plain PyTorch
// version in marius_tpu_torch/ops/cuda/nbr_sum.py bit for bit, hub split
// included. Each task writes its own output row, so the degree-sorted ->
// original-order permutation costs nothing.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                                  // warps per block
constexpr int kGroupLanes = 8;   // lanes per task: x 16 bytes = the slab's 128 bytes per row
constexpr int kGroups = kWarps * 32 / kGroupLanes;         // tasks per block

// Slab-row loads in flight per group: fewer on the one-element path, whose
// loads are 4 or 8 registers each, so that it needs no spills either.
template <bool kVec>
constexpr int kInFlightOf = kVec ? 16 : 8;

// The kC = 16 / sizeof(T) consecutive columns of one lane, as floats.
template <typename T, bool kVec>
struct Cols;

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <>
struct Cols<float, true> {   // one 16-byte load
  static constexpr int kC = 4;
  using Raw = float4;
  static __device__ __forceinline__ void load(const float* row, int64_t col, int64_t, Raw& r) {
    const uint4 q = ld16(row + col);
    r = make_float4(__uint_as_float(q.x), __uint_as_float(q.y), __uint_as_float(q.z),
                    __uint_as_float(q.w));
  }
  static __device__ __forceinline__ void zero(Raw& r) { r = make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ float get(const Raw& r, int k) {
    return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
  }
};

template <>
struct Cols<__nv_bfloat16, true> {   // one 16-byte load, widened when added
  static constexpr int kC = 8;
  using Raw = uint4;
  static __device__ __forceinline__ void load(const __nv_bfloat16* row, int64_t col, int64_t,
                                              Raw& r) {
    r = ld16(row + col);
  }
  static __device__ __forceinline__ void zero(Raw& r) { r = make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ float get(const Raw& r, int k) {
    const int i = k >> 1;
    const uint32_t w = i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
    // element 2i is the low half of word i; a bf16 is the high half of its f32
    return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
struct Cols<T, false> {   // one element at a time, masked at the row's end
  static constexpr int kC = 16 / sizeof(T);
  struct Raw { float v[kC]; };
  static __device__ __forceinline__ void load(const T* row, int64_t col, int64_t d, Raw& r) {
#pragma unroll
    for (int k = 0; k < kC; ++k) r.v[k] = col + k < d ? to_float(row[col + k]) : 0.0f;
  }
  static __device__ __forceinline__ void zero(Raw& r) {
#pragma unroll
    for (int k = 0; k < kC; ++k) r.v[k] = 0.0f;
  }
  static __device__ __forceinline__ float get(const Raw& r, int k) { return r.v[k]; }
};

template <bool kVec, int kC>
__device__ __forceinline__ void store(float* row, int64_t col, int64_t d, const float (&acc)[kC]) {
  if constexpr (kVec) {   // d % kC == 0: the lane's columns are all in the row
#pragma unroll
    for (int q = 0; q < kC; q += 4) {
      __stcs(reinterpret_cast<float4*>(row + col + q),
             make_float4(acc[q], acc[q + 1], acc[q + 2], acc[q + 3]));
    }
  } else {
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      if (col + k < d) __stcs(row + col + k, acc[k]);
    }
  }
}

// The group's ids of slots [b0, b0 + kInFlight): lane gl holds slots
// b0 + j * kGroupLanes + gl; -1 past the task's end.
template <int kInFlight, int kIdsPerLane>
__device__ __forceinline__ void load_ids(int32_t (&mine)[kIdsPerLane],
                                         const int32_t* __restrict__ ids, int64_t start, int len,
                                         int b0, int gl) {
#pragma unroll
  for (int j = 0; j < kIdsPerLane; ++j) {
    const int u = j * kGroupLanes + gl;
    mine[j] = (u < kInFlight && b0 + u < len) ? __ldcs(ids + start + b0 + u) : -1;
  }
}

// acc = the sum, in slot order, of the lane's columns [col, col + kC) of the
// rows x[ids[start + s]], s < len. Every lane of the warp calls it (the loop
// runs to the warp's longest task); lanes of one group share start and len.
template <typename T, bool kVec>
__device__ __forceinline__ void sum_slots(const T* __restrict__ x, int64_t n_rows, int64_t d,
                                          const int32_t* __restrict__ ids, int64_t start, int len,
                                          int64_t col, int gl, int lane0,
                                          float (&acc)[Cols<T, kVec>::kC]) {
  using C = Cols<T, kVec>;
  constexpr int kInFlight = kInFlightOf<kVec>;
  constexpr int kIdsPerLane = (kInFlight + kGroupLanes - 1) / kGroupLanes;
#pragma unroll
  for (int k = 0; k < C::kC; ++k) acc[k] = 0.0f;
  const bool active = col < d;
  const int most = __reduce_max_sync(0xffffffffu, len);
  int32_t mine[kIdsPerLane];
  load_ids<kInFlight>(mine, ids, start, len, 0, gl);
  for (int b0 = 0; b0 < most; b0 += kInFlight) {
    int32_t next[kIdsPerLane];   // the next batch's ids, in flight with this batch's rows
    load_ids<kInFlight>(next, ids, start, len, b0 + kInFlight, gl);
    typename C::Raw v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int32_t id = __shfl_sync(0xffffffffu, mine[u / kGroupLanes], lane0 + u % kGroupLanes);
      if (active && id >= 0 && id < n_rows) {
        C::load(x + static_cast<int64_t>(id) * d, col, d, v[u]);
      } else {
        C::zero(v[u]);
      }
    }
    // in slot order; adding +0.0f leaves the sum's bits as they are
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
#pragma unroll
      for (int k = 0; k < C::kC; ++k) acc[k] = __fadd_rn(acc[k], C::get(v[u], k));
    }
#pragma unroll
    for (int j = 0; j < kIdsPerLane; ++j) mine[j] = next[j];
  }
}

__device__ __forceinline__ int64_t ld_stream(const int64_t* p) {
  return __ldcs(reinterpret_cast<const long long*>(p));
}

// Hub h of piece task p: the last h with hub_first[h] <= p.
__device__ __forceinline__ int64_t hub_of(const int32_t* __restrict__ hub_first, int64_t n_hubs,
                                          int64_t p) {
  int64_t lo = 0, hi = n_hubs - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) / 2;
    if (__ldg(hub_first + mid) <= p) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The lane's kC columns of an f32 row that other blocks wrote (read from L2).
template <bool kVec, int kC>
__device__ __forceinline__ void load_l2(const float* row, int64_t col, int64_t d, float (&v)[kC]) {
  if constexpr (kVec) {
#pragma unroll
    for (int q = 0; q < kC; q += 4) {
      const float4 t = __ldcg(reinterpret_cast<const float4*>(row + col + q));
      v[q] = t.x; v[q + 1] = t.y; v[q + 2] = t.z; v[q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kC; ++k) v[k] = col + k < d ? __ldcg(row + col + k) : 0.0f;
  }
}

// Tasks [0, n_pieces) are the hub pieces, hub h's being the hub_count[h]
// tasks from hub_first[h], in order; tasks [n_pieces, n_tasks) write row
// task_dest. Blocks are numbered slab-major; within a slab, block b takes the
// kGroups tasks from b * kGroups, so the pieces (256 slots, the longest
// tasks) start first. A group that sums a piece leaves it in partial and
// counts its arrival for (hub, slab); the group that brings the last piece
// folds the hub's pieces in piece order and writes the hub's row.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
gather_sum_kernel(const T* __restrict__ x, int64_t n_rows, int64_t d,
                  const int32_t* __restrict__ ids, const int64_t* __restrict__ task_start,
                  const int32_t* __restrict__ task_len, const int32_t* __restrict__ task_dest,
                  int64_t n_tasks, int64_t n_pieces, const int32_t* __restrict__ hub_first,
                  const int32_t* __restrict__ hub_count, const int32_t* __restrict__ hub_dest,
                  int64_t n_hubs, int64_t blocks_per_slab, int64_t n_slabs,
                  float* __restrict__ out, float* __restrict__ partial,
                  int32_t* __restrict__ arrivals) {
  using C = Cols<T, kVec>;
  constexpr int kSlabCols = kGroupLanes * C::kC;
  const int64_t b = blockIdx.x;
  const int64_t slab = b / blocks_per_slab, local = b % blocks_per_slab;
  const int lane = threadIdx.x & 31;
  const int gl = lane % kGroupLanes;
  const int lane0 = lane - gl;
  const int group = threadIdx.x / kGroupLanes;
  const int64_t col = slab * kSlabCols + static_cast<int64_t>(gl) * C::kC;
  const int64_t task = local * kGroups + group;
  float acc[C::kC];
  int64_t start = 0;
  int len = 0;
  if (task < n_tasks) {
    start = ld_stream(task_start + task);
    len = __ldcs(task_len + task);
  }
  sum_slots<T, kVec>(x, n_rows, d, ids, start, len, col, gl, lane0, acc);
  if (task >= n_tasks) return;   // the whole group: no warp-wide step follows
  if (task >= n_pieces) {
    const int32_t dest = __ldcs(task_dest + task);
    if (col < d) store<kVec>(out + static_cast<int64_t>(dest) * d, col, d, acc);
    return;
  }
  // a hub piece: publish its sum, then count it in
  if (col < d) {
    float* row = partial + task * d;
    if constexpr (kVec) {
#pragma unroll
      for (int q = 0; q < C::kC; q += 4) {
        __stcg(reinterpret_cast<float4*>(row + col + q),
               make_float4(acc[q], acc[q + 1], acc[q + 2], acc[q + 3]));
      }
    } else {
#pragma unroll
      for (int k = 0; k < C::kC; ++k) {
        if (col + k < d) __stcg(row + col + k, acc[k]);
      }
    }
  }
  __threadfence();
  const unsigned gmask = ((1u << kGroupLanes) - 1u) << lane0;
  __syncwarp(gmask);
  const int64_t hub = hub_of(hub_first, n_hubs, task);
  int arrived = 0;
  if (gl == 0) arrived = atomicAdd(arrivals + hub * n_slabs + slab, 1);
  arrived = __shfl_sync(gmask, arrived, lane0);
  const int32_t count = __ldg(hub_count + hub);
  if (arrived != count - 1) return;
  // the last piece of the hub: fold all of them, in piece order
  __threadfence();
  const int64_t first = __ldg(hub_first + hub);
  float folded[C::kC];
#pragma unroll
  for (int k = 0; k < C::kC; ++k) folded[k] = 0.0f;
  constexpr int kFold = 8;   // piece sums in flight
  for (int q0 = 0; q0 < count; q0 += kFold) {
    float v[kFold][C::kC];
#pragma unroll
    for (int u = 0; u < kFold; ++u) {
      if (q0 + u < count && col < d) {
        load_l2<kVec>(partial + (first + q0 + u) * d, col, d, v[u]);
      } else {
#pragma unroll
        for (int k = 0; k < C::kC; ++k) v[u][k] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kFold; ++u) {
#pragma unroll
      for (int k = 0; k < C::kC; ++k) folded[k] = __fadd_rn(folded[k], v[u][k]);
    }
  }
  if (col < d) store<kVec>(out + static_cast<int64_t>(__ldg(hub_dest + hub)) * d, col, d, folded);
}

template <typename T, bool kVec>
int launch(const T* x, int64_t n_rows, int64_t d, const int32_t* ids, const int64_t* task_start,
           const int32_t* task_len, const int32_t* task_dest, int64_t n_tasks, int64_t n_pieces,
           const int32_t* hub_first, const int32_t* hub_count, const int32_t* hub_dest,
           int64_t n_hubs, float* out, float* partial, int32_t* arrivals, cudaStream_t stream) {
  constexpr int kSlabCols = kGroupLanes * Cols<T, kVec>::kC;
  const int64_t blocks_per_slab = (n_tasks + kGroups - 1) / kGroups;
  const int64_t n_slabs = (d + kSlabCols - 1) / kSlabCols;
  const int64_t blocks = blocks_per_slab * n_slabs;
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (n_hubs > 0) {
    const cudaError_t err = cudaMemsetAsync(arrivals, 0, sizeof(int32_t) * n_hubs * n_slabs,
                                            stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gather_sum_kernel<T, kVec><<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(
      x, n_rows, d, ids, task_start, task_len, task_dest, n_tasks, n_pieces, hub_first,
      hub_count, hub_dest, n_hubs, blocks_per_slab, n_slabs, out, partial, arrivals);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns the cudaError_t of
// its launches (0 = success). Pointers are device pointers; no
// synchronisation. The first n_pieces tasks are the hub pieces, hub h's
// being the hub_count[h] consecutive tasks from hub_first[h]; their
// task_dest is not read. The hub arrays may be empty (n_hubs = 0). Scratch:
// partial holds n_pieces x d floats; arrivals holds n_hubs x n_slabs ints,
// n_slabs = ceil(d / (128 / sizeof(element))), and is zeroed here.
extern "C" int marius_gather_sum_f32(const float* x, int64_t n_rows, int64_t d,
                                     const int32_t* ids, const int64_t* task_start,
                                     const int32_t* task_len, const int32_t* task_dest,
                                     int64_t n_tasks, int64_t n_pieces, const int32_t* hub_first,
                                     const int32_t* hub_count, const int32_t* hub_dest,
                                     int64_t n_hubs, float* out, float* partial,
                                     int32_t* arrivals, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned16(x)) {
    return launch<float, true>(x, n_rows, d, ids, task_start, task_len, task_dest, n_tasks,
                               n_pieces, hub_first, hub_count, hub_dest, n_hubs, out, partial,
                               arrivals, s);
  }
  return launch<float, false>(x, n_rows, d, ids, task_start, task_len, task_dest, n_tasks,
                              n_pieces, hub_first, hub_count, hub_dest, n_hubs, out, partial,
                              arrivals, s);
}

extern "C" int marius_gather_sum_bf16(const __nv_bfloat16* x, int64_t n_rows, int64_t d,
                                      const int32_t* ids, const int64_t* task_start,
                                      const int32_t* task_len, const int32_t* task_dest,
                                      int64_t n_tasks, int64_t n_pieces,
                                      const int32_t* hub_first, const int32_t* hub_count,
                                      const int32_t* hub_dest, int64_t n_hubs, float* out,
                                      float* partial, int32_t* arrivals, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 8 == 0 && aligned16(x)) {
    return launch<__nv_bfloat16, true>(x, n_rows, d, ids, task_start, task_len, task_dest,
                                       n_tasks, n_pieces, hub_first, hub_count, hub_dest, n_hubs,
                                       out, partial, arrivals, s);
  }
  return launch<__nv_bfloat16, false>(x, n_rows, d, ids, task_start, task_len, task_dest,
                                      n_tasks, n_pieces, hub_first, hub_count, hub_dest, n_hubs,
                                      out, partial, arrivals, s);
}
