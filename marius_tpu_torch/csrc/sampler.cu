// One hop of the layered neighbour sampler for Hopper (sm_90a), as a few
// kernels with no host synchronisation:
//   hop     for each (direction, node, slot): the slot's CSR position, the
//           neighbour, its mask and relation, and the candidate (the
//           neighbour, or fill where masked) written where the hop's dedup
//           branch wants it;
// and, for a frontier-prefix hop, the dedup over the (fill + 1)-wide id space:
//   rank    per tile of 4,096 ids: which ids are new (a candidate, not in the
//           current frontier) and their rank within the tile;
//   totals  one block: the tiles' offsets, the new-id count, the holes of the
//           current frontier and their positions, the overflow;
//   place   per id: each new id into its slot of the next hop set;
//   map     per candidate: its slot (the inverse), the mask ANDed with
//           "the slot holds this id"; per slot of the next hop set, its mask.
//
// Replaces no TPU kernel: the JAX sampler (marius_tpu/data/samplers/
// neighbor.py sample_neighbor_batch, marius_tpu/ops/unique.py
// prefix_unique_padded) is jnp code that XLA fuses on the TPU. Run eagerly by
// PyTorch it is about a hundred small operations a hop, three of which wrote a
// Python number into a device tensor and so synchronised with the host.
// The plain PyTorch version (sample_neighbor_batch_plain in
// marius_tpu_torch/data/samplers/neighbor.py) stays as the CPU path and the
// yardstick; these kernels give its results bit for bit, for the same draws:
// integer arithmetic throughout, the DROPOUT test in float32 as PyTorch
// compares a float32 tensor with a Python number.
//
// Bound: bytes, and launches. At the ogbn-arxiv cell's shapes (1,000 seeds,
// caps 16,384, 65,536 and 169,344, UNIFORM 32 in and out) the largest hop
// has 4.2 M slots: its draws, neighbours, candidates and masks are some 55 MB,
// about 17 us at 3.35 TB/s. The CSR offsets and columns are read at random
// places; the id-space arrays (169,344 entries) stay in L2.
//
// Design:
// - The hop kernel does every slot's work in one pass, both directions in one
//   grid, and writes the candidate in the place its dedup needs: the output
//   index array itself where the hop saturates (cap == num_nodes + 1: slot ==
//   id), a concatenated candidate array for the sorted branch, and a mark in
//   an id-space array for the prefix branch. The same grid writes the
//   per-node outputs and the next hop set's prefill.
// - The prefix dedup is a two-level scan written out: tiles of 4,096 ids
//   scanned in registers and warp shuffles, one block for the tiles' offsets
//   and the frontier's holes (a few hundred tiles, tens of thousands of
//   nodes), then two element-wise passes that read the ranks back. Each
//   id-space array is read once or twice, each candidate once.
// - Marks and positions are plain stores: every write to one place writes the
//   same value, or (the frontier's own ids, which are distinct) only one
//   thread writes it. No atomics.
// - The caller zeroes nothing: one memset sets the two id-space arrays to -1,
//   and the first hop's kernel zeroes the batch's overflow counter.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // threads per block of the element-wise kernels
constexpr int kMaxGrid = 16384;   // larger work loops over the grid
constexpr int kItems = 16;        // ids per thread in a scan tile
constexpr int kTile = kThreads * kItems;   // ids per tile: 4,096
constexpr int kOneBlock = 1024;   // threads of the one-block pass

enum Kind { kAll = 0, kUniform = 1, kDropout = 2 };
enum Mode { kSaturated = 0, kPrefix = 1, kSorted = 2 };

// One direction's CSR and draws.
struct Direction {
  const int32_t* offsets;   // (num_nodes + 2,)
  const int32_t* cols;      // (num_cols,)
  const int32_t* rels;      // (num_cols,) or null
  const int32_t* rand;      // (n, F) raw draws, null for ALL
  const float* uni;         // (n, F) uniforms, DROPOUT only
  int64_t num_cols;
  int64_t cand_base;        // sorted branch: this direction's first candidate after the n frontier ids
  int used;
};

template <typename Id>
struct Hop {
  const Id* cur_ids;        // (n,) ids in [0, fill]
  const uint8_t* cur_mask;  // (n,) bool
  int64_t n, fanout, fill, cap;
  int64_t max_id;           // offsets length - 2: the clamp of an id (PyTorch's `safe`)
  int kind, mode, zero_overflow;
  float rate;
  Direction dir[2];
  int32_t* idx;             // (2, n, F): candidates (positions after the prefix dedup)
  uint8_t* mask;            // (2, n, F)
  int32_t* rel;             // (2, n, F) or null
  int32_t* self_idx;        // (n,) saturated and prefix
  int32_t* next_ids32;      // (cap,) saturated
  uint8_t* next_mask;       // (cap,) saturated
  int32_t* pos_cur;         // (fill + 1,) prefix: -1, or the frontier row of the id
  int32_t* mark;            // (fill + 1,) prefix: 0 where some candidate is the id, else -1
  Id* ids;                  // (cap,) prefix: the next hop set, prefilled
  Id* cand;                 // (n + used directions x n x F,) sorted
  int32_t* overflow;        // () the batch's counter
};

// Inclusive scan of one value per thread over the block; *total gets the
// block's sum. `sh` holds kBlock / 32 ints. Every thread must call it.
template <int kBlock>
__device__ __forceinline__ int32_t block_scan(int32_t v, int32_t* sh, int32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < kBlock / 32 ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    if (lane < kBlock / 32) sh[lane] = w;
  }
  __syncthreads();
  const int32_t out = v + (warp > 0 ? sh[warp - 1] : 0);
  *total = sh[kBlock / 32 - 1];
  __syncthreads();   // sh is reused by the next call
  return out;
}

template <typename Id>
__device__ __forceinline__ void sample_slot(const Hop<Id>& a, int64_t t, int64_t nf) {
  const int d = t >= nf;   // 0 incoming, 1 outgoing
  const int64_t r = t - d * nf;
  const Direction& dir = a.dir[d];
  if (!dir.used) {   // PyTorch's zero indices and false mask
    a.idx[t] = 0;
    a.mask[t] = 0;
    return;
  }
  const int64_t i = r / a.fanout, s = r - i * a.fanout;
  const int64_t id = static_cast<int64_t>(a.cur_ids[i]);
  const int64_t safe = id < a.max_id ? id : a.max_id;
  const int64_t start = dir.offsets[safe];
  const int64_t deg = static_cast<int64_t>(dir.offsets[safe + 1]) - start;
  int64_t pos;
  bool m;
  if (a.kind == kAll) {   // exact below the cap
    pos = s;
    m = s < deg;
  } else {   // each neighbour once where they fit the fanout, else rand % deg
    const int64_t div = deg > 1 ? deg : 1;
    int64_t draw = static_cast<int64_t>(dir.rand[r]) % div;
    if (draw < 0) draw += div;   // PyTorch's remainder takes the divisor's sign
    pos = deg <= a.fanout ? s : draw;
    m = s < (deg < a.fanout ? deg : a.fanout);
  }
  const int64_t last = deg > 1 ? deg - 1 : 0;
  if (pos > last) pos = last;
  if (a.kind == kDropout) m = m && dir.uni[r] >= a.rate;
  m = m && a.cur_mask[i];
  // a node without neighbours points one past its CSR run: the read is clamped
  int64_t at = start + pos;
  const int64_t top = dir.num_cols > 1 ? dir.num_cols - 1 : 0;
  if (at > top) at = top;
  const int32_t nbr = dir.num_cols > 0 ? dir.cols[at] : 0;
  if (a.rel != nullptr) a.rel[t] = dir.num_cols > 0 ? dir.rels[at] : 0;
  const int32_t cand = m ? nbr : static_cast<int32_t>(a.fill);
  a.idx[t] = cand;
  a.mask[t] = m;
  if (a.mode == kPrefix) {
    if (cand >= 0 && cand < a.fill) a.mark[cand] = 0;
  } else if (a.mode == kSorted) {
    a.cand[a.n + dir.cand_base + r] = static_cast<Id>(cand);
  }
}

template <typename Id>
__global__ void __launch_bounds__(kThreads) sampler_hop_kernel(Hop<Id> a) {
  const int64_t nf = a.n * a.fanout;
  const int64_t slots = 2 * nf;
  const int64_t set = a.mode == kSorted ? 0 : a.cap;   // next hop set entries written here
  int64_t total = slots > a.n ? slots : a.n;
  if (set > total) total = set;
  if (a.zero_overflow && blockIdx.x == 0 && threadIdx.x == 0) *a.overflow = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; t < total;
       t += stride) {
    if (t < slots) sample_slot(a, t, nf);
    if (t < a.n) {
      const bool valid = a.cur_mask[t];
      const int64_t id = static_cast<int64_t>(a.cur_ids[t]);
      if (a.mode == kSaturated) {
        a.self_idx[t] = static_cast<int32_t>(valid ? id : a.fill);
      } else if (a.mode == kPrefix) {
        a.self_idx[t] = static_cast<int32_t>(t);
        if (valid && id < a.fill) a.pos_cur[id] = static_cast<int32_t>(t);
      } else {
        a.cand[t] = valid ? a.cur_ids[t] : static_cast<Id>(a.fill);
      }
    }
    if (t < set) {
      if (a.mode == kSaturated) {   // every id, in order
        a.next_ids32[t] = static_cast<int32_t>(t);
        a.next_mask[t] = t < a.fill;
      } else {   // the frontier verbatim (invalid rows as fill), then fill
        a.ids[t] = t < a.n && a.cur_mask[t] ? a.cur_ids[t] : static_cast<Id>(a.fill);
      }
    }
  }
}

__device__ __forceinline__ bool is_new(const int32_t* pos_cur, const int32_t* mark, int64_t v,
                                       int64_t fill) {
  return v < fill && mark[v] == 0 && pos_cur[v] < 0;
}

// Per tile: each id's inclusive rank among the tile's new ids, and the tile's count.
__global__ void __launch_bounds__(kThreads)
sampler_rank_kernel(const int32_t* __restrict__ pos_cur, const int32_t* __restrict__ mark,
                    int64_t width, int64_t fill, int32_t* __restrict__ local,
                    int32_t* __restrict__ tile_sum) {
  __shared__ int32_t sh[kThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile +
                       static_cast<int64_t>(threadIdx.x) * kItems;
  int32_t run[kItems];
  int32_t sum = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t v = base + k;
    sum += v < width && is_new(pos_cur, mark, v, fill);
    run[k] = sum;
  }
  int32_t total;
  const int32_t before = block_scan<kThreads>(sum, sh, &total) - sum;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (base + k < width) local[base + k] = before + run[k];
  }
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = total;
}

// One block: the tiles' exclusive offsets (in place), the new-id count, the
// frontier's holes (rows with a false mask) and the position of each, and
// the overflow: new ids beyond the holes and the cap's tail.
__global__ void __launch_bounds__(kOneBlock)
sampler_totals_kernel(int32_t* __restrict__ tile_sum, int64_t tiles,
                      const uint8_t* __restrict__ cur_mask, int64_t n, int64_t size,
                      int32_t* __restrict__ hole_pos, int32_t* __restrict__ totals,
                      int32_t* __restrict__ overflow) {
  __shared__ int32_t sh[kOneBlock / 32];
  constexpr int kChunk = kOneBlock * kItems;
  int32_t carry = 0;
  for (int64_t c0 = 0; c0 < tiles; c0 += kChunk) {
    const int64_t base = c0 + static_cast<int64_t>(threadIdx.x) * kItems;
    int32_t sum = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) sum += base + k < tiles ? tile_sum[base + k] : 0;
    int32_t total;
    int32_t before = carry + block_scan<kOneBlock>(sum, sh, &total) - sum;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (base + k < tiles) {
        const int32_t v = tile_sum[base + k];
        tile_sum[base + k] = before;
        before += v;
      }
    }
    carry += total;
  }
  const int32_t new_count = carry;
  carry = 0;
  for (int64_t c0 = 0; c0 < n; c0 += kChunk) {
    const int64_t base = c0 + static_cast<int64_t>(threadIdx.x) * kItems;
    int32_t sum = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) sum += base + k < n && !cur_mask[base + k];
    int32_t total;
    int32_t rank = carry + block_scan<kOneBlock>(sum, sh, &total) - sum;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (base + k < n && !cur_mask[base + k]) hole_pos[rank++] = static_cast<int32_t>(base + k);
    }
    carry += total;
  }
  const int32_t num_holes = carry;
  for (int64_t k = num_holes + threadIdx.x; k < n; k += kOneBlock) {
    hole_pos[k] = static_cast<int32_t>(size);
  }
  if (threadIdx.x == 0) {
    totals[0] = new_count;
    totals[1] = num_holes;
    const int64_t over = new_count - (num_holes + size - n);
    *overflow += over > 0 ? static_cast<int32_t>(over) : 0;
  }
}

// Where id v goes (PyTorch's `slot`): its frontier row, else by its rank
// among the new ids the next free hole, then the tail from n. Rank 0 reads
// hole n - 1, as JAX's index -1 does.
__device__ __forceinline__ int64_t slot_of(const int32_t* pos_cur, const int32_t* local,
                                           const int32_t* tile_off, const int32_t* hole_pos,
                                           int64_t v, int64_t n, int64_t num_holes) {
  if (pos_cur[v] >= 0) return pos_cur[v];
  const int64_t rank = static_cast<int64_t>(local[v]) + tile_off[v / kTile];
  int64_t at = rank - 1 < n - 1 ? rank - 1 : n - 1;
  if (at < 0) at += n;
  return rank <= num_holes ? static_cast<int64_t>(hole_pos[at]) : n + rank - 1 - num_holes;
}

template <typename Id>
__global__ void __launch_bounds__(kThreads)
sampler_place_kernel(const int32_t* __restrict__ pos_cur, const int32_t* __restrict__ mark,
                     const int32_t* __restrict__ local, const int32_t* __restrict__ tile_off,
                     const int32_t* __restrict__ hole_pos, const int32_t* __restrict__ totals,
                     int64_t fill, int64_t n, int64_t size, Id* __restrict__ ids) {
  const int64_t num_holes = totals[1];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; v < fill;
       v += stride) {
    if (!is_new(pos_cur, mark, v, fill)) continue;
    const int64_t slot = slot_of(pos_cur, local, tile_off, hole_pos, v, n, num_holes);
    if (slot < size) ids[slot] = static_cast<Id>(v);
  }
}

template <typename Id>
__global__ void __launch_bounds__(kThreads)
sampler_map_kernel(const int32_t* __restrict__ pos_cur, const int32_t* __restrict__ local,
                   const int32_t* __restrict__ tile_off, const int32_t* __restrict__ hole_pos,
                   const int32_t* __restrict__ totals, const Id* __restrict__ ids, int64_t fill,
                   int64_t n, int64_t size, int64_t nf, int used_in, int used_out,
                   int32_t* __restrict__ idx, uint8_t* __restrict__ mask,
                   uint8_t* __restrict__ next_mask) {
  const int64_t num_holes = totals[1];
  const int64_t slots = 2 * nf;
  const int64_t total = slots > size ? slots : size;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; t < total;
       t += stride) {
    if (t < slots && (t < nf ? used_in : used_out)) {
      const int64_t cand = idx[t];
      const int64_t v = cand < 0 ? 0 : cand > fill ? fill : cand;   // candidates lie in [0, fill]
      int64_t inv = slot_of(pos_cur, local, tile_off, hole_pos, v, n, num_holes);
      if (inv > size - 1) inv = size - 1;
      // an overflowed new id aliases a kept slot: its mask drops
      if (static_cast<int64_t>(ids[inv]) != cand) mask[t] = 0;
      idx[t] = static_cast<int32_t>(inv);
    }
    if (t < size) next_mask[t] = static_cast<int64_t>(ids[t]) < fill;
  }
}

int grid_for(int64_t work) {
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 1 ? 1 : blocks > kMaxGrid ? kMaxGrid : blocks);
}

template <typename Id>
int run_hop(const Id* cur_ids, const uint8_t* cur_mask, int64_t n, int64_t fanout, int64_t fill,
            int64_t cap, int64_t max_id, int kind, float rate, int mode, int zero_overflow,
            const int32_t* const* csr, const int64_t* num_cols, const int32_t* const* rand,
            const float* const* uni, const int* used, int32_t* idx, uint8_t* mask,
            int32_t* rel, int32_t* self_idx, uint8_t* next_mask, void* next_ids,
            int32_t* scratch, int32_t* overflow, cudaStream_t stream) {
  Hop<Id> a{};
  a.cur_ids = cur_ids;
  a.cur_mask = cur_mask;
  a.n = n;
  a.fanout = fanout;
  a.fill = fill;
  a.cap = cap;
  a.max_id = max_id;
  a.kind = kind;
  a.mode = mode;
  a.zero_overflow = zero_overflow;
  a.rate = rate;
  int64_t cand_base = 0;
  for (int d = 0; d < 2; ++d) {
    a.dir[d] = Direction{csr[3 * d], csr[3 * d + 1], csr[3 * d + 2], rand[d], uni[d],
                         num_cols[d], cand_base, used[d]};
    if (used[d]) cand_base += n * fanout;
  }
  a.idx = idx;
  a.mask = mask;
  a.rel = rel;
  a.self_idx = self_idx;
  a.overflow = overflow;
  const int64_t width = fill + 1;
  const int64_t tiles = (width + kTile - 1) / kTile;
  if (mode == kSaturated) {
    a.next_ids32 = static_cast<int32_t*>(next_ids);
    a.next_mask = next_mask;
  } else if (mode == kPrefix) {
    // scratch: pos_cur and mark (-1), local ranks, tile sums, hole positions, totals
    a.pos_cur = scratch;
    a.mark = scratch + width;
    a.ids = static_cast<Id*>(next_ids);
    const cudaError_t rc = cudaMemsetAsync(scratch, 0xff, 2 * width * sizeof(int32_t), stream);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  } else {
    a.cand = static_cast<Id*>(next_ids);
  }
  int64_t work = 2 * n * fanout;
  if (n > work) work = n;
  if (mode != kSorted && cap > work) work = cap;
  sampler_hop_kernel<Id><<<grid_for(work), kThreads, 0, stream>>>(a);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || mode != kPrefix) return rc;

  int32_t* local = scratch + 2 * width;
  int32_t* tile_sum = local + width;
  int32_t* hole_pos = tile_sum + tiles;
  int32_t* totals = hole_pos + n;
  sampler_rank_kernel<<<static_cast<int>(tiles), kThreads, 0, stream>>>(a.pos_cur, a.mark, width,
                                                                       fill, local, tile_sum);
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  sampler_totals_kernel<<<1, kOneBlock, 0, stream>>>(tile_sum, tiles, cur_mask, n, cap, hole_pos,
                                                     totals, overflow);
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  sampler_place_kernel<Id><<<grid_for(fill), kThreads, 0, stream>>>(
      a.pos_cur, a.mark, local, tile_sum, hole_pos, totals, fill, n, cap, a.ids);
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  const int64_t nf = n * fanout;
  sampler_map_kernel<Id><<<grid_for(2 * nf > cap ? 2 * nf : cap), kThreads, 0, stream>>>(
      a.pos_cur, local, tile_sum, hole_pos, totals, a.ids, fill, n, cap, nf, used[0], used[1],
      idx, mask, next_mask);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes; one per frontier id type. Pointers
// are device pointers; no synchronisation. Returns the first nonzero
// cudaError_t of the memset and the launches, else 0.
//   csr: in offsets, in cols, in rels, out offsets, out cols, out rels
//        (rels null without relations); num_cols: in, out
//   rand, uni: per direction, null where not drawn; used: per direction
//   mode 0 (saturated): next_ids int32 (cap,), next_mask (cap,)
//   mode 1 (prefix): next_ids of the id type (cap,), next_mask (cap,), scratch
//        of marius_sampler_scratch_ints(n, fill) int32
//   mode 2 (sorted): next_ids is the candidates (n + used x n x F,) of the id type
#define MARIUS_SAMPLE_HOP(SUFFIX, ID)                                                          \
  extern "C" int marius_sample_hop_##SUFFIX(                                                   \
      const ID* cur_ids, const uint8_t* cur_mask, int64_t n, int64_t fanout, int64_t fill,    \
      int64_t cap, int64_t max_id, int kind, float rate, int mode, int zero_overflow,          \
      const int32_t* const* csr, const int64_t* num_cols, const int32_t* const* rand,          \
      const float* const* uni, const int* used, int32_t* idx, uint8_t* mask, int32_t* rel,     \
      int32_t* self_idx, uint8_t* next_mask, void* next_ids, int32_t* scratch,                 \
      int32_t* overflow, void* stream) {                                                       \
    return run_hop<ID>(cur_ids, cur_mask, n, fanout, fill, cap, max_id, kind, rate, mode,      \
                       zero_overflow, csr, num_cols, rand, uni, used, idx, mask, rel,          \
                       self_idx, next_mask, next_ids, scratch, overflow,                       \
                       static_cast<cudaStream_t>(stream));                                     \
  }

MARIUS_SAMPLE_HOP(i32, int32_t)
MARIUS_SAMPLE_HOP(i64, int64_t)

// The int32 scratch a prefix hop needs: two id-space arrays set to -1, the
// local ranks, the tile sums, the hole positions and two totals.
extern "C" int64_t marius_sampler_scratch_ints(int64_t n, int64_t fill) {
  const int64_t width = fill + 1;
  return 3 * width + (width + kTile - 1) / kTile + n + 2;
}
