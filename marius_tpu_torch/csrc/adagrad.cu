// Row-sparse Adagrad on the embedding table for Hopper (sm_90a), in place:
//   for each k with 0 <= ids[k] < n_rows, per element:
//     s' = s + g*g;  state[id] = s';  values[id] = v - lr*g / (sqrt(s') + 1e-10)
// for f32 or bf16 values, state and grads (all three of one type), with int64
// or int32 ids.
//
// Replaces the TPU kernel marius_tpu/ops/pallas/adagrad.py:89
// sparse_adagrad_update_pallas (_adagrad_kernel), which DMAs each row in and
// out one at a time and needs d % 128 == 0, K % 256 == 0 and a scratch row for
// padding. Here any K and any d are taken, and padding ids (>= n_rows, or < 0)
// are skipped: a padding row is neither read nor written.
//
// Precondition: the valid ids are UNIQUE, as for the TPU kernel. Two groups
// updating one row would race on its read-modify-write.
//
// Bound: bytes. Per valid row it reads values, state and grads and writes
// values and state (5 x d elements) plus the id; ~7 flops per element (the
// IEEE square root and division are a few instructions each) stay below the
// card's rate. At the flagship's dense-accumulate branch (all 14,541 rows,
// d = 50, f32) that is 14.7 MB, 4.4 us at 3.35 TB/s; on Freebase86m's buffer
// pair (30,000 random 400-byte rows of two 17.2 GB tensors) 60.2 MB, 18.0 us.
// What holds it back below that bound, measured on the card: on the buffer
// pair, HBM's rate of random row accesses (four per row: state and values,
// read and written; bf16's 200-byte rows move at a lower byte rate than
// f32's 400-byte ones, as in the row gather); at the L2-resident flagship,
// the launch and the instructions per element, not the bytes (bf16, half
// the bytes, takes as long as f32).
//
// Design (the host's plan, ops/cuda/adagrad.py:plan, picks V, G, U, the grid
// and the store policy):
// - Vector rows. A row is vpr = row bytes / V vectors of V = 16, 8, 4 or 2
//   bytes: the widest that divides the row's bytes and the three base
//   addresses (a tensor may be a view at an offset). d = 50 in f32 is 25
//   vectors of 8 bytes; d = 100 in f32 25 of 16 bytes.
// - 8 bytes or more per lane. Each lane moves U = max(1, 8 / V) vectors of
//   each array per row chunk, so its address arithmetic and five memory
//   instructions serve at least 8 bytes; narrower (4-byte vectors, one per
//   lane) was slower at the bf16 flagship, wider (U = 2 of 8 or 16 bytes)
//   at the f32 ones.
// - Several rows per warp. G lanes (a power of two) serve one row, strided by
//   G so a group's loads coalesce; a warp serves 32 / G rows at once. Rows
//   wider than G x U vectors loop over chunks.
// - Ids fetched ahead. The lanes of a warp read its tile's 32 / G ids in one
//   coalesced load, and the next tile's before this tile's rows move; each
//   group takes its row's id by __shfl_sync. A padding id skips the row.
// - All of a row chunk's loads before any arithmetic: the lane issues its
//   vector loads of g (streaming, __ldcs: read once), s and v, then runs the
//   element-wise rule on the unpacked vectors, then stores s and v as vectors.
// - Stores: evict-first (__stcs) when values and state together exceed L2
//   (the buffer pair, the full-graph table), the default policy when they fit
//   (the flagship), so the next step may find the rows in L2; each was the
//   faster at its shapes. Evict-first or L2-only loads of s and v were slower
//   on the buffer pair.
// - One wave: at most SMs x resident blocks of 128 threads, with a grid-stride
//   loop over the tiles beyond it. 10 resident blocks (at most 48 registers)
//   beat the unbounded 56-register build; tighter bounds spill. Two tiles in
//   flight per warp (the next tile's rows loaded before this one's update)
//   gained under 2% on the buffer pair and lost at the flagships.
// No shared memory and no TMA: each row is read once and written once, so
// there is no reuse to capture, and a 1-D bulk copy needs 16-byte multiples,
// which the flagship's 200-byte f32 rows and the buffer's 200-byte bf16 rows
// are not.
//
// Each operation is rounded on its own (__fmul_rn, __fadd_rn, __fsqrt_rn,
// __fdiv_rn, __fsub_rn): nvcc would otherwise contract s + g*g into an FMA,
// and the result would no longer match the plain PyTorch version bit for bit.
// Untouched rows are never written.
//
// bf16: every operation runs in f32 on bf16 inputs and is rounded to bf16
// (round to nearest even) before the next one uses it, and lr and eps are
// bf16 constants:
//   gg = rn(g*g); s' = rn(s + gg); q = rn(sqrt(s')); den = rn(q + rn(1e-10));
//   num = rn(rn(lr)*g); v' = rn(v - rn(num / den))
// That is the sequence XLA compiles JAX's plain sparse_adagrad_update to on
// bf16 rows (a convert to bf16 after each op; Python scalars are weakly typed,
// so lr and eps become bf16), and the sequence of the plain PyTorch version.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-10f;  // marius_tpu/parallel/embedding_table.py ADAGRAD_EPS

// An element's bits in a vector, its value in f32, and the rounding after each
// operation, per element type.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  using Bits = float;
  static __device__ __forceinline__ float load(Bits b) { return b; }
  static __device__ __forceinline__ Bits store(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  using Bits = unsigned short;
  static __device__ __forceinline__ float load(Bits b) {
    return __uint_as_float(static_cast<unsigned>(b) << 16);
  }
  static __device__ __forceinline__ Bits store(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// A V-byte vector and its elements.
template <typename Vec, typename Bits>
union Pack {
  Vec v;
  Bits e[sizeof(Vec) / sizeof(Bits)];
};

// The vectors each lane moves per row chunk: 8 bytes or more of each array.
template <typename Vec>
__host__ __device__ constexpr int unroll_of() {
  return sizeof(Vec) >= 8 ? 1 : 8 / static_cast<int>(sizeof(Vec));
}

// Blocks of kThreads one SM keeps resident (at most 48 registers a thread).
constexpr int kMinBlocks = 10;

template <typename T, typename Id, typename Vec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
adagrad_kernel(Vec* __restrict__ values, Vec* __restrict__ state, const Id* __restrict__ ids,
               const Vec* __restrict__ grads, int64_t n_rows, int64_t k, uint32_t vpr,
               int lanes_log2, bool stream_stores, float lr_in) {
  using E = Elem<T>;
  using P = Pack<Vec, typename E::Bits>;
  constexpr int U = unroll_of<Vec>();
  constexpr int kElems = sizeof(Vec) / sizeof(typename E::Bits);
  const float lr = E::round(lr_in);
  const float eps = E::round(kEps);
  const int lane = threadIdx.x & 31;
  const int rows = 32 >> lanes_log2;          // rows a warp serves at once
  const int group = lane >> lanes_log2;       // this lane's row of the tile
  const uint32_t lanes = 1u << lanes_log2;    // G
  const uint32_t first_col = lane & (lanes - 1);
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  // lane j < rows holds the id of the tile's row j; -1 past the end
  auto fetch = [&](int64_t t) -> long long {
    const int64_t r = t * rows + lane;
    return lane < rows && r < k ? static_cast<long long>(ids[r]) : -1;
  };
  long long next = fetch(tile);
  for (; tile * rows < k; tile += warps) {
    const long long held = next;
    next = fetch(tile + warps);  // in flight while this tile's rows move
    const int64_t id = __shfl_sync(0xffffffffu, held, group);
    const int64_t row = tile * rows + group;
    if (row >= k || id < 0 || id >= n_rows) continue;
    Vec* v_row = values + id * vpr;
    Vec* s_row = state + id * vpr;
    const Vec* g_row = grads + row * vpr;
    for (uint32_t c0 = first_col; c0 < vpr; c0 += lanes * U) {
      P g[U], s[U], v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint32_t c = c0 + u * lanes;
        if (c < vpr) {
          g[u].v = __ldcs(g_row + c);
          s[u].v = s_row[c];
          v[u].v = v_row[c];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint32_t c = c0 + u * lanes;
        if (c >= vpr) continue;
#pragma unroll
        for (int i = 0; i < kElems; ++i) {
          const float gc = E::load(g[u].e[i]);
          const float ns =
              E::round(__fadd_rn(E::load(s[u].e[i]), E::round(__fmul_rn(gc, gc))));
          s[u].e[i] = E::store(ns);
          const float denom = E::round(__fadd_rn(E::round(__fsqrt_rn(ns)), eps));
          const float num = E::round(__fmul_rn(lr, gc));
          // +-0 over a positive denominator is +-0, the IEEE quotient, without
          // the division's slow path: rows with no gradient (about half of the
          // dense-accumulate branch's) made the flagship measurably slower
          const float step =
              num == 0.0f && denom > 0.0f ? num : E::round(__fdiv_rn(num, denom));
          v[u].e[i] = E::store(__fsub_rn(E::load(v[u].e[i]), step));
        }
        if (stream_stores) {
          __stcs(s_row + c, s[u].v);
          __stcs(v_row + c, v[u].v);
        } else {
          s_row[c] = s[u].v;
          v_row[c] = v[u].v;
        }
      }
    }
  }
}

// Every instantiation, called with each kernel of one (T, Id) pair.
template <typename T, typename Id, typename Visit>
int each_kernel(Visit visit) {
  int rc = visit(adagrad_kernel<T, Id, uint4>);
  if (rc == 0) rc = visit(adagrad_kernel<T, Id, uint2>);
  if (rc == 0) rc = visit(adagrad_kernel<T, Id, unsigned>);
  if constexpr (sizeof(T) == 2) {
    if (rc == 0) rc = visit(adagrad_kernel<T, Id, unsigned short>);
  }
  return rc;
}

template <typename T, typename Id, typename Vec>
int launch_vec(void* values, void* state, const Id* ids, const void* grads, int64_t n_rows,
               int64_t k, uint32_t vpr, int lanes_log2, int unroll, int grid, bool stream_stores,
               float lr, cudaStream_t stream) {
  if (unroll != unroll_of<Vec>()) return static_cast<int>(cudaErrorInvalidValue);
  adagrad_kernel<T, Id, Vec><<<grid, kThreads, 0, stream>>>(
      static_cast<Vec*>(values), static_cast<Vec*>(state), ids, static_cast<const Vec*>(grads),
      n_rows, k, vpr, lanes_log2, stream_stores, lr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Id>
int launch(T* values, T* state, const Id* ids, const T* grads, int64_t n_rows, int64_t k,
           int64_t d, float lr, int vec_bytes, int lanes, int unroll, int grid,
           int stream_stores, cudaStream_t stream) {
  if (k == 0 || d == 0) return 0;
  // the plan must be one this file compiles: whole elements per vector, every
  // row and base address on a vector boundary, a power-of-two group, the
  // vectors per lane of the vector's width, and the kernel counts a row's
  // vectors in 32 bits
  const int64_t row_bytes = static_cast<int64_t>(sizeof(T)) * d;
  const auto aligned = [&](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(vec_bytes) == 0;
  };
  if (vec_bytes < static_cast<int>(sizeof(T)) || vec_bytes > 16 ||
      (vec_bytes & (vec_bytes - 1)) != 0 || row_bytes % vec_bytes != 0 ||
      row_bytes / vec_bytes > 0x7fffffffLL || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || grid <= 0 ||
      !aligned(values) || !aligned(state) || !aligned(grads))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t vpr = static_cast<uint32_t>(row_bytes / vec_bytes);
  const int lanes_log2 = __builtin_ctz(static_cast<unsigned>(lanes));
  const bool st = stream_stores != 0;
  switch (vec_bytes) {
    case 16:
      return launch_vec<T, Id, uint4>(values, state, ids, grads, n_rows, k, vpr, lanes_log2,
                                      unroll, grid, st, lr, stream);
    case 8:
      return launch_vec<T, Id, uint2>(values, state, ids, grads, n_rows, k, vpr, lanes_log2,
                                      unroll, grid, st, lr, stream);
    case 4:
      return launch_vec<T, Id, unsigned>(values, state, ids, grads, n_rows, k, vpr, lanes_log2,
                                         unroll, grid, st, lr, stream);
    default:
      if constexpr (sizeof(T) == 2)
        return launch_vec<T, Id, unsigned short>(values, state, ids, grads, n_rows, k, vpr,
                                                 lanes_log2, unroll, grid, st, lr, stream);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename Id>
int fewer_resident(int* blocks) {
  return each_kernel<T, Id>([&](auto kernel) {
    int n = 0;
    const int rc = static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0));
    if (rc == 0 && n < *blocks) *blocks = n;
    return rc;
  });
}

}  // namespace

// What the wrapper needs to size the grid, read once per device: the threads
// per block, the device's SM count and the fewest blocks of any instantiation
// that one SM keeps resident. Returns a cudaError_t (0 = success).
extern "C" int marius_sparse_adagrad_config(int device, int* threads, int* sm_count,
                                            int* resident_blocks) {
  *threads = kThreads;
  int rc = static_cast<int>(cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount,
                                                   device));
  if (rc != 0) return rc;
  *resident_blocks = 1 << 30;
  if (rc == 0) rc = fewer_resident<float, int64_t>(resident_blocks);
  if (rc == 0) rc = fewer_resident<float, int32_t>(resident_blocks);
  if (rc == 0) rc = fewer_resident<__nv_bfloat16, int64_t>(resident_blocks);
  if (rc == 0) rc = fewer_resident<__nv_bfloat16, int32_t>(resident_blocks);
  return rc;
}

// Plain C entry points, loaded with ctypes. Each returns the cudaError_t of
// the launch (0 = success). Pointers are device pointers; no synchronisation.
// vec_bytes, lanes, unroll (the vectors each lane moves per row chunk), grid
// and stream_stores come from the wrapper's plan (ops/cuda/adagrad.py).
extern "C" int marius_sparse_adagrad_f32_i64(float* values, float* state, const int64_t* ids,
                                             const float* grads, int64_t n_rows, int64_t k,
                                             int64_t d, float lr, int vec_bytes, int lanes,
                                             int unroll, int grid, int stream_stores,
                                             void* stream) {
  return launch<float, int64_t>(values, state, ids, grads, n_rows, k, d, lr, vec_bytes, lanes,
                                unroll, grid, stream_stores, static_cast<cudaStream_t>(stream));
}

extern "C" int marius_sparse_adagrad_f32_i32(float* values, float* state, const int32_t* ids,
                                             const float* grads, int64_t n_rows, int64_t k,
                                             int64_t d, float lr, int vec_bytes, int lanes,
                                             int unroll, int grid, int stream_stores,
                                             void* stream) {
  return launch<float, int32_t>(values, state, ids, grads, n_rows, k, d, lr, vec_bytes, lanes,
                                unroll, grid, stream_stores, static_cast<cudaStream_t>(stream));
}

// bf16 values, state and grads; lr is rounded to bf16 in the kernel.
extern "C" int marius_sparse_adagrad_bf16_i64(__nv_bfloat16* values, __nv_bfloat16* state,
                                              const int64_t* ids, const __nv_bfloat16* grads,
                                              int64_t n_rows, int64_t k, int64_t d, float lr,
                                              int vec_bytes, int lanes, int unroll, int grid,
                                              int stream_stores, void* stream) {
  return launch<__nv_bfloat16, int64_t>(values, state, ids, grads, n_rows, k, d, lr, vec_bytes,
                                        lanes, unroll, grid, stream_stores,
                                        static_cast<cudaStream_t>(stream));
}

extern "C" int marius_sparse_adagrad_bf16_i32(__nv_bfloat16* values, __nv_bfloat16* state,
                                              const int32_t* ids, const __nv_bfloat16* grads,
                                              int64_t n_rows, int64_t k, int64_t d, float lr,
                                              int vec_bytes, int lanes, int unroll, int grid,
                                              int stream_stores, void* stream) {
  return launch<__nv_bfloat16, int32_t>(values, state, ids, grads, n_rows, k, d, lr, vec_bytes,
                                        lanes, unroll, grid, stream_stores,
                                        static_cast<cudaStream_t>(stream));
}
