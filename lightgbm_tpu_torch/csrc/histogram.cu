// Histogram kernels of lightgbm_tpu_torch for Hopper (sm_90a).
//
// Replaces, in lightgbm_tpu/ops/pallas_histogram.py:
//   B1  build_histograms_pallas   (:199; kernel body _kernel :62)
//   B2  fused_build_best_splits   (:460; _fused_kernel :423 and
//                                  _split_epilogue :365)
//   B3  build_root_histograms_classes (:766; _class_kernel :733)
//
// B1 computes, for every (leaf slot, feature, bin), the sums of
// (grad, hess, count) over the rows whose row_leaf equals that slot's
// leaf id. B2 is B1's accumulation followed by the split-finding
// epilogue: the eval_split_lattice gain scan of lightgbm_tpu/ops/
// split.py:136 and a first-max argmax per slot over (feature, bin,
// missing direction).
//
// What bounds them on this card. B1 does no arithmetic worth counting:
// it must read, per stream row, F bin bytes (gathered through
// row_gather on a compacted stream), 12 bytes of f32 (g, h, count) or 3
// of int8, and 4 bytes of row_leaf, and write an [L, F, B, 3] result.
// At the Higgs root (10.5M rows, F = 28) that is ~462 MB, ~0.14 ms at
// 3.35 TB/s: bytes bound it. The TPU kernel turned the scatter into a
// one-hot matmul because its core has no fast scatter; here the one-hot
// product would cost 2*R*F*B*L*3 flops (~4.7 TFLOP at the root with
// L = 42, ~5 ms of dense bf16 tensor time, and ~25 TFLOP for a
// class-batched B2 launch at 147 slots), because a one-hot over slots
// repeats the work L times. So B1 and B2 scatter into shared memory.
// A first design kept a [slots, B, 3] histogram per warp in shared
// memory and searched each row's slot per block: the slot count then
// set the tiling (one feature a block at 147 slots), every slot tile
// re-read the stream, and lanes sharing a bin were summed by one
// shuffle round each. It ran ~100x its byte bound.
//
// What the design does about it: the slot axis leaves shared memory.
//  * A pre-pass sorts the stream by slot, on the device, with num_rows
//    read there too (no host sync): leaf ids are ranked into a sorted
//    table (slot_table_kernel); each warp of slot_count_kernel takes a
//    chunk of rows, looks each row's slot up once (a binary search of
//    the table in shared memory; rows of no slot, dead or past
//    num_rows, drop out) and counts the rows of each slot with
//    __match_any_sync; slot_scan_kernel scans each slot's chunk counts
//    and slot_items_kernel the slots; slot_scatter_kernel writes each
//    row as a 16-byte record (its three addends, already rounded to
//    bf16 when asked, and its bins row after row_gather) at its slot's
//    offset plus its rank among the warp's lanes of that slot. Ranks
//    come from ballots, so the order within a slot is the stream order.
//  * A work item is up to S records of one slot (the host sizes the
//    grid from R and L alone, ceil(R / S) + L items, and surplus blocks
//    exit). A block takes one item and one tile of up to 32 features:
//    each lane owns one feature, each warp walks every W-th 32-record
//    step of the item into its own [B, 3, 32 lanes] shared histogram.
//    A lane only ever touches its own bank, so a one-hot column costs
//    what any column costs: no group sums, no shuffles, no atomics. A
//    row's bin bytes are one contiguous read across the lanes, and its
//    addends a broadcast from the warp's staged records. A warp runs
//    one step ahead: the bin loads of the next 32 rows are in flight
//    while it adds the current ones, and the records after them are
//    on their way. Rows add two at a time: both rows' loads issue
//    before either store, and a second row in the first's bin adds
//    onto its sum, so a cell's chain keeps stream order. Where only two
//    warps fit an SM (B = 253), these load-add-store chains, not the
//    shared-memory bandwidth, are what a warp waits on. (Groups of
//    four, and adds without the per-row branch, measured slower.)
//  * The warps' copies are summed in warp order into the item's
//    partial. A slot of more than 32 items (at the root every row is
//    in slot 0: ~1000 items) is first folded by slot_fold_kernel in
//    segments of 32 items, many blocks wide; slot_reduce_kernel then
//    sums each slot's segments, or its items, in order into
//    [L, F, B, 3] (zeros for a slot without rows), transposing through
//    shared memory. Given an accumulator (init), each cell's sum starts
//    from it instead of 0: the out-of-core sweep carries its histogram
//    from chunk to chunk this way, with no extra pass over it. The summation order is a function of the inputs
//    alone: two launches give bit-identical histograms and grow the
//    same trees (int8 is exact in any order).
//  * f32 addends are rounded to bf16 (round-to-nearest-even) when
//    asked, as the plain version rounds them, and summed in f32.
//  The split epilogue is a second launch, one block per slot, one warp
//  per feature: the histogram is under 25 MB and L2-resident, and B2's
//  callers write it out anyway for the subtraction cache. The epilogue
//  is bound by launch latency, not by bytes or flops.
//  What bounds this design: the pre-pass moves ~36 bytes a row and the
//  items read 16 + F; the items' shared-memory adds (three load-add-
//  store chains a row and lane, one bank each) and the latency of the
//  gathered bin loads, with 8 warps an SM at B = 63 and 2 at B = 253.
//
// B3 sums at the root only, so its key is the bin alone and each row
// carries K x 3 addends: out[k, f, b, c] = sum over root rows r with
// bins[r, f] == b of addend(gh_k[k, r, c]). That is the TPU kernel's own
// form, a one-hot product one_hot(bins[:, f])^T . G with G = [R, 3K]
// (2*R*F*B*3K flops, ~0.33 TFLOP dense at the Covertype root), and it
// fits this card's tensor cores without the slot blow-up of B1/B2.
//
// What bounds B3. Bytes: R*(F + 12K + 4) + the [K, F, B, 3] output,
// ~84 MB at the Covertype root, ~0.025 ms. The dense product is ~0.33 ms
// of bf16 tensor time; skipping empty bin tiles (below) leaves ~22M
// m16n8k16 products, ~0.1 ms. Per product the warp must also build its
// one-hot A fragment in registers and load G's B fragments from shared
// memory, and the block must stage G as bf16: the instruction issue
// around the products, not the products, is the likely limit.
//
// What the design does about it.
//  * Per feature one product on mma.sync.m16n8k16 (bf16 in, f32 out): M
//    is the bins in 16-bin tiles, N the block's K x 3 addend columns in
//    8-wide tiles (at most 3, so classes are tiled past K = 8), and the
//    contraction runs over 16 stream rows per step. The A fragment is
//    built in registers from four bin bytes per lane: element (m, k) is
//    1.0 when row k's bin equals the tile's first bin + m.
//  * G is staged per tile of 16 x S rows in shared memory as bf16, transposed
//    ([column][row], rows padded by 8 so that the B-fragment loads hit 32
//    distinct banks), zero where row_leaf != root_slot, which also
//    covers padded rows.
//  * f32 addends go through the one bf16 instruction as three terms,
//    hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), whose sum
//    is x exactly for normal x down to ~2^-110; all three accumulate
//    into the same fragment. bf16-rounded addends are one term. int8
//    values are exact in bf16 and their partial sums exact in f32.
//  * Short chains. Tensor-core f32 accumulation need not round to
//    nearest, so a fragment carries at most one tile of S = 32 steps
//    (512 rows); then each lane adds it into the block's [fc, bins, N]
//    shared-memory accumulator with ordinary f32 adds (int32 for int8,
//    whose tile sums stay below 2^24 and convert exactly). Each warp
//    owns its bin tiles: no atomics. Chunk partials are summed in chunk
//    order by chunk_reduce_kernel, so two launches are bit-identical.
//  * Empty bin tiles are skipped: per staged tile the warp reduces the
//    min and max bin of its feature and issues products only for the
//    bin tiles in between (a tile inside the range that a step's rows
//    miss adds exact zeros). A one-hot column costs one tile of 16. The
//    range is taken per tile, not per 16-row step: a per-step reduction
//    put two warp reductions and a branch into every step's dependency
//    chain, which cost more than the skipped products saved.
//  * Occupancy: a feature's [256, 24] f32 accumulator would be 192
//    registers a thread, so each warp owns 4 bin tiles (48 registers)
//    and a feature takes up to 4 such units of work; a warp takes units
//    in turn. class_mma_plan (ops/cuda_histogram.py) picks the features
//    and classes of a block (8 warps, 2 blocks an SM, or 16 warps where
//    two do not fit, as at the Covertype root), S, and the chunks.
// The result is not bit-equal to B1's root launch (another
// summation order): int8 is exact either way, f32 agrees within rtol
// 1e-4 of each channel's scale.
//
// Wide bins (max_bin > 255, EFB bundles of more than 256 bins). The bin
// matrix is then int16 (int32 past 32,768 bins a column), and every
// kernel that reads it is instantiated for uint8, int16 and int32
// columns. The lattice no longer fits one block:
//  * B1/B2: a warp's [B, 3, 32] histogram is 384 B a bin (393 KB at
//    B = 1,024, above the 227 KB a block may take). A third grid axis
//    cuts the bins into tiles (slot_hist_plan: tiles of at most 64
//    bins, eight warps of 25 KB a block); a block reads its item's rows
//    and bins in full and adds the rows whose bin falls in its tile, so
//    the bin column is read once a tile. Each tile writes its cells of
//    the item's partial, whose layout and reduction stay the same: the
//    order in which a cell sums its rows does not depend on the tiling,
//    and two launches stay bit-identical. Fewer feature lanes a block
//    would keep one read of the column but leave lanes idle, and a lane
//    is a feature, so at F = 28 there is nothing to take away. The
//    passes over the stream grow with the tiles as the warps an SM do:
//    tiles of 64, 128 and 256 bins time within 20% of each other, 64
//    the fastest, and the kernel stays ~100x its byte bound at
//    B = 1,021.
//  * B3: a block covers mtb 16-bin M-tiles of its features (all of them
//    while the [fc, bins, N] accumulator fits; class_mma_plan cuts the
//    bins into n_btiles ranges otherwise), and the unit of a warp's
//    work stays four M-tiles. The bins are staged at their own width;
//    rows outside the block's range miss every one-hot tile.
//  The split epilogue scans any B (a flat index is an int).
//
// This file is compiled with -fmad=false so that every a*b+c rounds as
// two operations, as the plain PyTorch version computes it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCh = 3;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kPreUnroll = 8;     // 32-row steps a pre-pass warp loads at once
constexpr int kFold = 32;         // items a fold segment sums

struct SlotArgs {
  const void* bins;           // [R_src, F] uint8, int16 or int32, row-major
  const void* gh;             // [R, 3] float32 or int8
  const int32_t* row_leaf;    // [R]
  const int32_t* leaf_ids;    // [L]
  const int32_t* row_gather;  // [R] or null
  const int32_t* num_rows;    // device scalar or null
  uint4* records;             // [R] slot-ordered: addends (bits), bins row
  int32_t* tab_keys;          // [L] leaf ids, ascending
  int32_t* tab_slots;         // [L] the slot of each
  int32_t* slot_rows;         // [L] live rows of each slot
  int32_t* slot_start;        // [L] its first record
  int32_t* item_start;        // [L + 1] its first work item; [L] = items
  int32_t* seg_start;         // [L + 1] its first fold segment (only a
                              // slot of more than kFold items has any)
  int32_t* counts;            // [L, n_wchunks] rows of slot s in warp
                              // chunk c, then their exclusive offsets
  void* partial;              // [n_items, n_ftiles, 3B, 32] accumulator
  void* folded;               // [n_segs, n_ftiles, 3B, 32] the same
  void* out;                  // [L, F, B, 3]
  const void* init;           // [L, F, B, 3] the sums to start from, or
                              // null (zeros)
  int F, L, R, B;
  int bf16_round;
  int fc, n_ftiles;           // features a tile (a lane each), tiles
  int bin_tile;               // bins a block's histogram covers
  int rows_per_item;          // S
  int pre_warps, chunk_rows, n_wchunks;
};

// Row-range geometry of B3's chunks: rows per chunk and chunks used for
// nr rows, a whole number of tiles, at least min_rows.
__device__ __forceinline__ void chunk_span(int nr, int n_chunks,
                                           int min_rows, int tile_rows,
                                           int& per, int& n_used) {
  per = (nr + n_chunks - 1) / n_chunks;
  per = max(per, min_rows);
  per = (per + tile_rows - 1) / tile_rows * tile_rows;
  n_used = (nr + per - 1) / per;
}

__device__ __forceinline__ int live_rows(const SlotArgs& a) {
  const int nr = a.num_rows ? *a.num_rows : a.R;
  return max(0, min(nr, a.R));
}

template <bool kQuant>
struct Types;
template <>
struct Types<false> {
  using acc_t = float;
  using gh_t = float;
};
template <>
struct Types<true> {
  using acc_t = int;
  using gh_t = int8_t;
};

// A bin as an unsigned int, from a uint8, int16 or int32 column (bins
// are never negative).
__device__ __forceinline__ unsigned load_bin(const uint8_t* p) {
  return (unsigned)__ldg(p);
}
__device__ __forceinline__ unsigned load_bin(const int16_t* p) {
  return (unsigned)(uint16_t)__ldg(p);
}
__device__ __forceinline__ unsigned load_bin(const int32_t* p) {
  return (unsigned)__ldg(p);
}

__device__ __forceinline__ float addend(float v, int bf16_round) {
  return bf16_round ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}
__device__ __forceinline__ int addend(int8_t v, int) { return (int)v; }

__device__ __forceinline__ unsigned to_bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ unsigned to_bits(int v) { return (unsigned)v; }
template <bool kQuant>
__device__ __forceinline__ typename Types<kQuant>::acc_t from_bits(
    unsigned u) {
  if constexpr (kQuant)
    return (int)u;
  else
    return __uint_as_float(u);
}

// Exclusive scan of v over the block (blockDim.x a multiple of 32);
// total gets the sum. wsum is [32] shared ints, reusable across calls.
__device__ int block_exclusive_scan(int v, int* wsum, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();                // wsum is free from an earlier call
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? wsum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    wsum[lane] = w;
  }
  __syncthreads();
  total = wsum[nw - 1];
  return x - v + (warp > 0 ? wsum[warp - 1] : 0);
}

// Leaf ids ranked ascending, ties by slot, so that a lower-bound search
// finds an id's first slot, as the plain version's first match does.
__global__ void slot_table_kernel(SlotArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.L) return;
  const int id = a.leaf_ids[i];
  int rank = 0;
  for (int j = 0; j < a.L; ++j) {
    const int o = __ldg(a.leaf_ids + j);
    rank += (o < id || (o == id && j < i)) ? 1 : 0;
  }
  a.tab_keys[rank] = id;
  a.tab_slots[rank] = i;
}

__device__ __forceinline__ int find_slot(const int* keys, const int* slots,
                                         int L, int leaf) {
  int lo = 0, hi = L;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < leaf)
      lo = mid + 1;
    else
      hi = mid;
  }
  return (lo < L && keys[lo] == leaf) ? slots[lo] : -1;
}

// The table into shared memory: keys [L], slots [L]; returns the warp's
// [L] ints after them (pre_warps of them).
__device__ __forceinline__ int* load_table(const SlotArgs& a, int* sm) {
  for (int i = threadIdx.x; i < a.L; i += blockDim.x) {
    sm[i] = a.tab_keys[i];
    sm[a.L + i] = a.tab_slots[i];
  }
  return sm + 2 * a.L + (threadIdx.x >> 5) * a.L;
}

// Rows of each slot in each warp chunk of chunk_rows stream rows.
__global__ void slot_count_kernel(SlotArgs a) {
  extern __shared__ int pre_s[];
  int* my = load_table(a, pre_s);
  const int lane = threadIdx.x & 31;
  for (int s = lane; s < a.L; s += 32) my[s] = 0;
  __syncthreads();
  const int nr = live_rows(a);
  const int n_used = (nr + a.chunk_rows - 1) / a.chunk_rows;
  const int c = blockIdx.x * a.pre_warps + (threadIdx.x >> 5);
  if (c >= n_used) return;
  const int* keys = pre_s;
  const int* slots = pre_s + a.L;
  const int r_end = min(nr, (c + 1) * a.chunk_rows);
  for (int t0 = c * a.chunk_rows; t0 < r_end; t0 += kPreUnroll * 32) {
    int leaf[kPreUnroll];
#pragma unroll
    for (int u = 0; u < kPreUnroll; ++u) {
      const int r = t0 + u * 32 + lane;
      leaf[u] = r < r_end ? __ldg(a.row_leaf + r) : 0;
    }
#pragma unroll
    for (int u = 0; u < kPreUnroll; ++u) {
      const int r = t0 + u * 32 + lane;
      const int s = r < r_end ? find_slot(keys, slots, a.L, leaf[u]) : -1;
      const unsigned peers = __match_any_sync(kFull, s);
      if (s >= 0 && lane == __ffs(peers) - 1) my[s] += __popc(peers);
      __syncwarp();
    }
  }
  for (int s = lane; s < a.L; s += 32)
    a.counts[(size_t)s * a.n_wchunks + c] = my[s];
}

// One block a slot: its chunk counts -> exclusive offsets, in place.
__global__ void slot_scan_kernel(SlotArgs a) {
  __shared__ int wsum[32];
  const int nr = live_rows(a);
  const int n = (nr + a.chunk_rows - 1) / a.chunk_rows;
  int* c = a.counts + (size_t)blockIdx.x * a.n_wchunks;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int b = min(n, (int)threadIdx.x * per);
  const int e = min(n, b + per);
  int sum = 0;
  for (int i = b; i < e; ++i) sum += c[i];
  int total;
  int run = block_exclusive_scan(sum, wsum, total);
  for (int i = b; i < e; ++i) {
    const int v = c[i];
    c[i] = run;
    run += v;
  }
  if (threadIdx.x == 0) a.slot_rows[blockIdx.x] = total;
}

// Slot s's records start at slot_start[s]; its ceil(rows / S) work
// items at item_start[s].
__global__ void slot_items_kernel(SlotArgs a) {
  __shared__ int wsum[32];
  const int per = (a.L + blockDim.x - 1) / blockDim.x;
  const int b = min(a.L, (int)threadIdx.x * per);
  const int e = min(a.L, b + per);
  const int S = a.rows_per_item;
  int rows = 0, items = 0, segs = 0;
  for (int s = b; s < e; ++s) {
    const int n = a.slot_rows[s];
    const int it = (n + S - 1) / S;
    rows += n;
    items += it;
    segs += it > kFold ? (it + kFold - 1) / kFold : 0;
  }
  int tot_rows, tot_items, tot_segs;
  int r0 = block_exclusive_scan(rows, wsum, tot_rows);
  int i0 = block_exclusive_scan(items, wsum, tot_items);
  int g0 = block_exclusive_scan(segs, wsum, tot_segs);
  for (int s = b; s < e; ++s) {
    const int n = a.slot_rows[s];
    const int it = (n + S - 1) / S;
    a.slot_start[s] = r0;
    a.item_start[s] = i0;
    a.seg_start[s] = g0;
    r0 += n;
    i0 += it;
    g0 += it > kFold ? (it + kFold - 1) / kFold : 0;
  }
  if (threadIdx.x == 0) {
    a.item_start[a.L] = tot_items;
    a.seg_start[a.L] = tot_segs;
  }
}

// The last s in [0, L) with start[s] <= i (start ascending).
__device__ __forceinline__ int owner(const int32_t* start, int L, int i) {
  int lo = 0, hi = L - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= i)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// Each live row's record at its slot's offset for this chunk plus its
// rank among the lanes of the step that share its slot.
template <bool kQuant>
__global__ void slot_scatter_kernel(SlotArgs a) {
  using gh_t = typename Types<kQuant>::gh_t;
  extern __shared__ int pre_s[];
  int* my = load_table(a, pre_s);
  __syncthreads();
  const int nr = live_rows(a);
  const int n_used = (nr + a.chunk_rows - 1) / a.chunk_rows;
  const int c = blockIdx.x * a.pre_warps + (threadIdx.x >> 5);
  if (c >= n_used) return;
  const int lane = threadIdx.x & 31;
  for (int s = lane; s < a.L; s += 32)
    my[s] = a.slot_start[s] + a.counts[(size_t)s * a.n_wchunks + c];
  __syncwarp();
  const int* keys = pre_s;
  const int* slots = pre_s + a.L;
  const gh_t* gh = reinterpret_cast<const gh_t*>(a.gh);
  const unsigned below = (1u << lane) - 1u;
  const int r_end = min(nr, (c + 1) * a.chunk_rows);
  for (int t0 = c * a.chunk_rows; t0 < r_end; t0 += kPreUnroll * 32) {
    int leaf[kPreUnroll];
#pragma unroll
    for (int u = 0; u < kPreUnroll; ++u) {
      const int r = t0 + u * 32 + lane;
      leaf[u] = r < r_end ? __ldg(a.row_leaf + r) : 0;
    }
    int sl[kPreUnroll], src[kPreUnroll];
    gh_t v[kPreUnroll][kCh];
#pragma unroll
    for (int u = 0; u < kPreUnroll; ++u) {
      const int r = t0 + u * 32 + lane;
      sl[u] = r < r_end ? find_slot(keys, slots, a.L, leaf[u]) : -1;
      src[u] = 0;
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch) v[u][ch] = 0;
      if (sl[u] >= 0) {
        src[u] = a.row_gather ? __ldg(a.row_gather + r) : r;
#pragma unroll
        for (int ch = 0; ch < kCh; ++ch)
          v[u][ch] = __ldg(gh + (size_t)r * kCh + ch);
      }
    }
#pragma unroll
    for (int u = 0; u < kPreUnroll; ++u) {
      const int s = sl[u];
      const unsigned peers = __match_any_sync(kFull, s);
      if (s >= 0) {
        uint4 rec;
        rec.x = to_bits(addend(v[u][0], a.bf16_round));
        rec.y = to_bits(addend(v[u][1], a.bf16_round));
        rec.z = to_bits(addend(v[u][2], a.bf16_round));
        rec.w = (unsigned)src[u];
        a.records[my[s] + __popc(peers & below)] = rec;
      }
      __syncwarp();
      if (s >= 0 && lane == __ffs(peers) - 1) my[s] += __popc(peers);
      __syncwarp();
    }
  }
}

// One work item (up to S records of one slot) x one feature tile x one
// bin tile: the block's histogram covers bins [b0, b0 + nb) and skips
// the rows whose bin lies outside. kTiled is false for a lattice of one
// tile: b0 is then 0 at compile time, and the hot loop is the one-tile
// kernel's (the tile arithmetic there cost ~80% of its time at B = 63).
template <bool kQuant, typename BinT, bool kTiled>
__global__ void slot_accum_kernel(SlotArgs a) {
  using acc_t = typename Types<kQuant>::acc_t;
  extern __shared__ __align__(16) unsigned char smem[];
  const int item = blockIdx.x;
  const int ft = blockIdx.y;
  if (item >= a.item_start[a.L]) return;          // surplus block
  const int s = owner(a.item_start, a.L, item);
  const int r0 = a.slot_start[s] + (item - a.item_start[s]) * a.rows_per_item;
  const int r1 = min(r0 + a.rows_per_item, a.slot_start[s] + a.slot_rows[s]);
  const int b0 = kTiled ? (int)blockIdx.z * a.bin_tile : 0;
  const int nb = kTiled ? min(a.bin_tile, a.B - b0) : a.B;
  const int Q = nb * kCh;
  const int f0 = ft * a.fc;
  const int fcn = min(a.fc, a.F - f0);
  const int W = blockDim.x >> 5;
  acc_t* hist = reinterpret_cast<acc_t*>(smem);   // [W][B][3][32]
  uint4* stage = reinterpret_cast<uint4*>(hist + (size_t)W * Q * 32);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  uint4* h4 = reinterpret_cast<uint4*>(hist);
  for (int i = tid; i < W * Q * 8; i += blockDim.x)
    h4[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  acc_t* my = hist + (size_t)warp * Q * 32 + lane;
  uint4* cur = stage + warp * 64;                 // two steps of records
  uint4* nxt = cur + 32;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  const bool active = lane < fcn;
  const BinT* col = reinterpret_cast<const BinT*>(a.bins) + f0 + lane;
  // a bin's offset in the tile; one below b0 wraps past nb
  const unsigned ub0 = (unsigned)b0;
  const unsigned none = (unsigned)nb;             // no bin: skip the row
  const int stride = W * 32;
  // One step ahead: a step's bin loads are in flight while the step
  // before it adds, and the records of the step after are on their way.
  // An idle lane, a row past the item and a bin outside the tile (or
  // >= B) add nothing.
  int t = r0 + warp * 32;
  cur[lane] = t + lane < r1 ? a.records[t + lane] : zero4;
  uint4 rn = t + stride + lane < r1 ? a.records[t + stride + lane] : zero4;
  __syncwarp();
  unsigned bv[32];
#pragma unroll
  for (int u = 0; u < 32; ++u)
    bv[u] = (active && t + u < r1)
                ? load_bin(col + (int64_t)cur[u].w * a.F) - ub0
                : none;
  for (; t < r1; t += stride) {
    const int tn = t + stride;
    nxt[lane] = rn;
    __syncwarp();
    unsigned bn[32];
#pragma unroll
    for (int u = 0; u < 32; ++u)
      bn[u] = (active && tn + u < r1)
                  ? load_bin(col + (int64_t)nxt[u].w * a.F) - ub0
                  : none;
    rn = tn + stride + lane < r1 ? a.records[tn + stride + lane] : zero4;
    // two rows at a time: both rows' loads issue before either store,
    // and where both rows hit one cell the second adds onto the first's
    // sum, so each cell still sums its rows in stream order
#pragma unroll
    for (int u = 0; u < 32; u += 2) {
      const unsigned b0 = bv[u], b1 = bv[u + 1];
      const uint4 e0 = cur[u], e1 = cur[u + 1];
      if (b0 < none && b1 < none) {
        acc_t* c0 = my + b0 * (kCh * 32);
        acc_t* c1 = my + b1 * (kCh * 32);
        acc_t x0[kCh], x1[kCh];
#pragma unroll
        for (int ch = 0; ch < kCh; ++ch) {
          x0[ch] = c0[ch * 32];
          x1[ch] = c1[ch * 32];
        }
        x0[0] += from_bits<kQuant>(e0.x);
        x0[1] += from_bits<kQuant>(e0.y);
        x0[2] += from_bits<kQuant>(e0.z);
        const bool same = b1 == b0;
        x1[0] = (same ? x0[0] : x1[0]) + from_bits<kQuant>(e1.x);
        x1[1] = (same ? x0[1] : x1[1]) + from_bits<kQuant>(e1.y);
        x1[2] = (same ? x0[2] : x1[2]) + from_bits<kQuant>(e1.z);
#pragma unroll
        for (int ch = 0; ch < kCh; ++ch) {
          c0[ch * 32] = x0[ch];
          c1[ch * 32] = x1[ch];
        }
      } else if (b0 < none) {
        acc_t* c = my + b0 * (kCh * 32);
        c[0] += from_bits<kQuant>(e0.x);
        c[32] += from_bits<kQuant>(e0.y);
        c[64] += from_bits<kQuant>(e0.z);
      } else if (b1 < none) {
        acc_t* c = my + b1 * (kCh * 32);
        c[0] += from_bits<kQuant>(e1.x);
        c[32] += from_bits<kQuant>(e1.y);
        c[64] += from_bits<kQuant>(e1.z);
      }
    }
#pragma unroll
    for (int u = 0; u < 32; ++u) bv[u] = bn[u];
    uint4* sw = cur;
    cur = nxt;
    nxt = sw;
    __syncwarp();
  }
  __syncthreads();
  // the warps' copies, in warp order, into the tile's cells of the
  // item's partial
  acc_t* P = reinterpret_cast<acc_t*>(a.partial) +
             ((size_t)item * a.n_ftiles + ft) * a.B * kCh * 32 +
             (size_t)b0 * kCh * 32;
  for (int i = tid; i < Q * 32; i += blockDim.x) {
    acc_t v = hist[i];
    for (int w = 1; w < W; ++w) v += hist[(size_t)w * Q * 32 + i];
    P[i] = v;
  }
}

// A slot of more than kFold items: each fold segment sums up to kFold of
// its items, in item order, so that the slot reduction's chains stay
// short and a slot that holds every row is read by many blocks.
template <typename acc_t>
__global__ void slot_fold_kernel(SlotArgs a) {
  const int seg = blockIdx.x;
  if (seg >= a.seg_start[a.L]) return;            // surplus block
  const int Q32 = a.B * kCh * 32;
  const int cell = blockIdx.z * blockDim.x + threadIdx.x;
  if (cell >= Q32) return;
  const int s = owner(a.seg_start, a.L, seg);
  const int i0 = a.item_start[s] + (seg - a.seg_start[s]) * kFold;
  const int i1 = min(i0 + kFold, a.item_start[s + 1]);
  const int ft = blockIdx.y;
  const acc_t* P = reinterpret_cast<const acc_t*>(a.partial);
  acc_t v = 0;
#pragma unroll 8
  for (int it = i0; it < i1; ++it)
    v += P[((size_t)it * a.n_ftiles + ft) * Q32 + cell];
  reinterpret_cast<acc_t*>(a.folded)[((size_t)seg * a.n_ftiles + ft) * Q32 +
                                     cell] = v;
}

// out[l][f][b][c] = init[l][f][b][c] (0 without init) plus the sum of
// slot l's fold segments, or of its items where it has none, in order
// (init, or zeros, for a slot without rows), transposed through shared
// memory. Seeding the chain with init carries an accumulator across
// launches (the out-of-core sweep's chunks) in one fixed order.
template <typename acc_t>
__global__ void slot_reduce_kernel(SlotArgs a) {
  __shared__ acc_t tile[32][33];
  const int Q = a.B * kCh;
  const int q0 = blockIdx.x * 32;
  const int ft = blockIdx.y;
  const int l = blockIdx.z;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int ny = blockDim.x >> 5;
  const bool folded = a.seg_start[l + 1] > a.seg_start[l];
  const int i0 = folded ? a.seg_start[l] : a.item_start[l];
  const int i1 = folded ? a.seg_start[l + 1] : a.item_start[l + 1];
  const acc_t* P = reinterpret_cast<const acc_t*>(folded ? a.folded
                                                         : a.partial);
  const int f0 = ft * a.fc;
  const int fcn = min(a.fc, a.F - f0);
  const acc_t* I = reinterpret_cast<const acc_t*>(a.init);
  for (int qq = ty; qq < 32; qq += ny) {
    const int q = q0 + qq;
    acc_t s = 0;
    if (I != nullptr && q < Q && tx < fcn)
      s = I[((size_t)l * a.F + f0 + tx) * Q + q];
    if (q < Q)
#pragma unroll 8
      for (int it = i0; it < i1; ++it)
        s += P[(((size_t)it * a.n_ftiles + ft) * Q + q) * 32 + tx];
    tile[tx][qq] = s;
  }
  __syncthreads();
  acc_t* out = reinterpret_cast<acc_t*>(a.out);
  const int q = q0 + tx;
  if (q < Q)
    for (int j = ty; j < fcn; j += ny)
      out[((size_t)l * a.F + f0 + j) * Q + q] = tile[j][tx];
}

// B3's chunk reduction: out[l][f][b][c] = the sum over its used chunks
// of partial [n_chunks, F, L, B, 3], in chunk order.
struct ChunkArgs {
  const void* partial;
  void* out;
  int F, L, R, B;
  int n_chunks, tile_rows;
};

template <typename acc_t>
__global__ void chunk_reduce_kernel(ChunkArgs a) {
  int per, n_used;
  chunk_span(a.R, a.n_chunks, a.tile_rows, a.tile_rows, per, n_used);
  const size_t bc_n = (size_t)a.B * kCh;
  const size_t total = (size_t)a.L * a.F * bc_n;
  const acc_t* P = reinterpret_cast<const acc_t*>(a.partial);
  acc_t* out = reinterpret_cast<acc_t*>(a.out);
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t bc = e % bc_n;
    const size_t lf = e / bc_n;
    const size_t f = lf % a.F;
    const size_t l = lf / a.F;
    acc_t s = 0;
    for (int c = 0; c < n_used; ++c)
      s += P[(((size_t)c * a.F + f) * a.L + l) * bc_n + bc];
    out[e] = s;
  }
}

// ---------------------------------------------------------------------
// B2 epilogue: eval_split_lattice + first-max argmax per slot.

struct SplitArgs {
  const void* hist;           // [L, F, B, 3] float32, or int32 (quant)
  const int32_t* nbpf;        // [F]
  const int32_t* nan_bin;     // [F]
  const int32_t* is_cat;      // [F]
  const uint8_t* fmask;       // [F] or [L, F], or null
  const int32_t* mono;        // [F] or null
  const float* leaf_lo;       // [L]
  const float* leaf_hi;       // [L]
  const float* parent_out;    // [L]
  const float* mono_pen;      // [L]
  const float* qscale;        // [L, 2] per slot (quant)
  float* rec;                 // [L, 16]
  int L, F, B;
  int quant, fmask_2d, use_mono, use_smooth, pen_on;
  float l1, l2, mds, ps, md, mh, mg;
};

constexpr int kRec = 16;

__device__ __forceinline__ float thr_l1(float s, float l1) {
  if (l1 <= 0.f) return s;
  float m = fabsf(s) - l1;
  m = m > 0.f ? m : 0.f;
  const float sg = s > 0.f ? 1.f : (s < 0.f ? -1.f : s);
  return sg * m;
}

__device__ __forceinline__ float calc_out(const SplitArgs& a, float g,
                                          float h, float n, float parent,
                                          bool smooth) {
  const float hl = h + a.l2;
  float out = hl > 0.f ? -thr_l1(g, a.l1) / hl : 0.f;
  if (a.mds > 0.f) out = fminf(fmaxf(out, -a.mds), a.mds);
  if (smooth) {
    const float sm = n / a.ps;
    out = out * sm / (sm + 1.f) + parent / (sm + 1.f);
  }
  return out;
}

__device__ __forceinline__ float gain_given(const SplitArgs& a, float g,
                                            float h, float out) {
  const float t = thr_l1(g, a.l1);
  return -(2.f * t * out + (h + a.l2) * out * out);
}

template <typename acc_t>
__device__ __forceinline__ float to_f(acc_t v, float scale, bool quant) {
  return quant ? (float)v * scale : (float)v;
}

template <typename acc_t>
__device__ __forceinline__ acc_t warp_sum(acc_t v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// One warp scans one (slot, feature): returns the feature's first-max
// candidate in registers of every lane.
template <typename acc_t>
__device__ void scan_feature(const SplitArgs& a, int l, int f,
                             float* best /*[kRec]*/, float* tot_out) {
  const int lane = threadIdx.x & 31;
  const bool quant = a.quant != 0;
  const acc_t* h =
      reinterpret_cast<const acc_t*>(a.hist) + ((size_t)l * a.F + f) * a.B * kCh;
  const int nan = a.nan_bin[f];
  const bool has_nan = nan >= 0;
  const bool cat = a.is_cat[f] != 0;
  const int nnb = a.nbpf[f] - (has_nan ? 1 : 0);
  const float sc0 = quant ? a.qscale[2 * l] : 1.f;
  const float sc1 = quant ? a.qscale[2 * l + 1] : 1.f;
  const int mt = a.use_mono ? a.mono[f] : 0;
  const float lo = a.use_mono ? a.leaf_lo[l] : 0.f;
  const float hi = a.use_mono ? a.leaf_hi[l] : 0.f;
  const float parent = a.use_smooth ? a.parent_out[l] : 0.f;
  const bool fm = a.fmask == nullptr ||
                  a.fmask[a.fmask_2d ? (size_t)l * a.F + f : f] != 0;

  acc_t ns[kCh] = {0, 0, 0};
  if (has_nan && nan < a.B)
    for (int c = 0; c < kCh; ++c) ns[c] = h[nan * kCh + c];
  // totals: non-NaN bins + the NaN bin
  acc_t tot[kCh];
  for (int c = 0; c < kCh; ++c) {
    acc_t s = 0;
    for (int b = lane; b < a.B; b += 32)
      s += (has_nan && b == nan) ? (acc_t)0 : h[b * kCh + c];
    tot[c] = warp_sum(s) + ns[c];
  }
  const float gt = to_f(tot[0], sc0, quant), ht = to_f(tot[1], sc1, quant),
              nt = to_f(tot[2], 1.f, quant);
  float pg;
  if (a.use_smooth) {
    const float p_out = cat ? parent : calc_out(a, gt, ht, nt, parent, true);
    pg = gain_given(a, gt, ht, p_out);
  } else if (a.mds > 0.f) {
    pg = gain_given(a, gt, ht, calc_out(a, gt, ht, nt, 0.f, false));
  } else {
    const float t = thr_l1(gt, a.l1);
    const float hl = ht + a.l2;
    pg = hl > 0.f ? t * t / hl : 0.f;
  }
  tot_out[0] = gt;
  tot_out[1] = ht;
  tot_out[2] = nt;

  // per-lane first max over its (bin, direction) candidates
  float b_val = -INFINITY;
  int b_idx = INT_MAX;
  float b_f[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};  // thr, opt, l3, r3, ol, or
  bool first = true;
  acc_t carry[kCh] = {0, 0, 0};
  for (int k0 = 0; k0 < a.B; k0 += 32) {
    const int b = k0 + lane;
    const bool in = b < a.B;
    acc_t hv[kCh], cum[kCh];
    for (int c = 0; c < kCh; ++c) {
      hv[c] = in ? h[b * kCh + c] : (acc_t)0;
      acc_t x = (in && !(has_nan && b == nan)) ? hv[c] : (acc_t)0;
      for (int o = 1; o < 32; o <<= 1) {
        const acc_t y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      cum[c] = carry[c] + x;
      carry[c] += __shfl_sync(kFull, x, 31);
    }
    if (!in) continue;
    for (int opt = 0; opt < 2; ++opt) {
      acc_t left[kCh], right[kCh];
      bool valid;
      if (cat) {
        for (int c = 0; c < kCh; ++c) left[c] = hv[c];
        valid = b < nnb && opt == 0;
      } else {
        for (int c = 0; c < kCh; ++c) left[c] = opt ? cum[c] + ns[c] : cum[c];
        valid = b < nnb - 1 && (opt == 0 || has_nan);
      }
      for (int c = 0; c < kCh; ++c) right[c] = tot[c] - left[c];
      const float gL = to_f(left[0], sc0, quant), hL = to_f(left[1], sc1, quant),
                  nL = to_f(left[2], 1.f, quant);
      const float gR = to_f(right[0], sc0, quant),
                  hR = to_f(right[1], sc1, quant),
                  nR = to_f(right[2], 1.f, quant);
      float ol = calc_out(a, gL, hL, nL, parent, a.use_smooth != 0);
      float orr = calc_out(a, gR, hR, nR, parent, a.use_smooth != 0);
      if (a.use_mono) {
        ol = fminf(fmaxf(ol, lo), hi);
        orr = fminf(fmaxf(orr, lo), hi);
      }
      float gain = gain_given(a, gL, hL, ol) + gain_given(a, gR, hR, orr);
      if (a.use_mono && ((mt > 0 && ol > orr) || (mt < 0 && ol < orr)))
        gain = 0.f;
      const bool ok = valid && nL >= a.md && nR >= a.md && hL >= a.mh &&
                      hR >= a.mh;
      float net = gain - pg - a.mg;
      net = (ok && net > 1e-10f) ? net : -INFINITY;
      if (a.use_mono && a.pen_on && mt != 0) net = net * a.mono_pen[l];
      if (!fm) net = -INFINITY;
      const int idx = b * 2 + opt;
      if (first || net > b_val) {
        first = false;
        b_val = net;
        b_idx = idx;
        b_f[0] = (float)b;
        b_f[1] = (float)opt;
        b_f[2] = gL; b_f[3] = hL; b_f[4] = nL;
        b_f[5] = gR; b_f[6] = hR; b_f[7] = nR;
        b_f[8] = ol; b_f[9] = orr;
      }
    }
  }
  // warp first-max: larger value, ties to the smaller index
  float v = b_val;
  int ix = b_idx;
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(kFull, v, o);
    const int i2 = __shfl_xor_sync(kFull, ix, o);
    if (v2 > v || (v2 == v && i2 < ix)) {
      v = v2;
      ix = i2;
    }
  }
  const unsigned who = __ballot_sync(kFull, b_idx == ix);
  const int src = __ffs(who) - 1;
  best[0] = v;
  best[1] = (float)f;
  for (int q = 0; q < 10; ++q) best[2 + q] = __shfl_sync(kFull, b_f[q], src);
  best[12] = (float)ix;  // flat index within the feature
}

template <typename acc_t>
__global__ void split_epilogue_kernel(SplitArgs a) {
  __shared__ float wrec[32][kRec];
  __shared__ float tot0[kCh];
  const int l = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  float wb[kRec];
  bool have = false;
  for (int f = warp; f < a.F; f += nwarps) {
    float cand[kRec];
    float tt[kCh];
    scan_feature<acc_t>(a, l, f, cand, tt);
    if (f == 0 && lane == 0) {
      tot0[0] = tt[0];
      tot0[1] = tt[1];
      tot0[2] = tt[2];
    }
    // features ascend within a warp: strict > keeps the first max
    if (!have || cand[0] > wb[0]) {
      for (int q = 0; q < kRec; ++q) wb[q] = cand[q];
      have = true;
    }
  }
  if (lane == 0) {
    for (int q = 0; q < kRec; ++q) wrec[warp][q] = have ? wb[q] : 0.f;
    if (!have) wrec[warp][1] = -1.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int bw = -1;
    for (int w = 0; w < nwarps; ++w) {
      if (wrec[w][1] < 0.f) continue;
      if (bw < 0) {
        bw = w;
        continue;
      }
      const float v = wrec[w][0], bv = wrec[bw][0];
      // flat order is (feature, bin, direction)
      const bool earlier = wrec[w][1] < wrec[bw][1] ||
                           (wrec[w][1] == wrec[bw][1] &&
                            wrec[w][12] < wrec[bw][12]);
      if (v > bv || (v == bv && earlier)) bw = w;
    }
    float* r = a.rec + (size_t)l * kRec;
    // gain, feature, bin, dir, left(3), right(3), out_l, out_r, totals(3)
    r[0] = wrec[bw][0];
    r[1] = wrec[bw][1];
    for (int q = 0; q < 10; ++q) r[2 + q] = wrec[bw][2 + q];
    r[12] = tot0[0];
    r[13] = tot0[1];
    r[14] = tot0[2];
    r[15] = 0.f;
  }
}

// The eight launches of B1's accumulation, in stream order.
template <bool kQuant, typename BinT>
int launch_slot_hist(const SlotArgs& a, int warps, int n_items, int n_segs,
                     size_t smem, cudaStream_t stream) {
  using acc_t = typename Types<kQuant>::acc_t;
  const int pre_threads = 32 * a.pre_warps;
  const size_t pre_smem = (size_t)(2 + a.pre_warps) * a.L * sizeof(int);
  const int pre_blocks = (a.n_wchunks + a.pre_warps - 1) / a.pre_warps;
  const int Q32 = a.B * kCh * 32;
  SlotArgs b = a;
  b.folded = reinterpret_cast<acc_t*>(a.partial) +
             (size_t)n_items * a.n_ftiles * Q32;
  cudaError_t e;
  slot_table_kernel<<<(a.L + 127) / 128, 128, 0, stream>>>(b);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  slot_count_kernel<<<pre_blocks, pre_threads, pre_smem, stream>>>(b);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  slot_scan_kernel<<<a.L, 256, 0, stream>>>(b);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  slot_items_kernel<<<1, 1024, 0, stream>>>(b);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  slot_scatter_kernel<kQuant><<<pre_blocks, pre_threads, pre_smem, stream>>>(
      b);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int n_btiles = (a.B + a.bin_tile - 1) / a.bin_tile;
  if (n_btiles > 1)
    slot_accum_kernel<kQuant, BinT, true>
        <<<dim3(n_items, a.n_ftiles, n_btiles), 32 * warps, smem, stream>>>(
            b);
  else
    slot_accum_kernel<kQuant, BinT, false>
        <<<dim3(n_items, a.n_ftiles), 32 * warps, smem, stream>>>(b);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  slot_fold_kernel<acc_t>
      <<<dim3(n_segs, a.n_ftiles, (Q32 + 255) / 256), 256, 0, stream>>>(b);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  slot_reduce_kernel<acc_t>
      <<<dim3((a.B * kCh + 31) / 32, a.n_ftiles, a.L), 256, 0, stream>>>(b);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// B3: root histograms of all K classes, one pass over bins, on the
// tensor cores.

constexpr int kMtw = 4;           // 16-bin M-tiles per warp
constexpr int kNtMax = 3;         // 8-column N-tiles per block
constexpr int kClassThreads = 512;
constexpr int kStage = 4;         // staged items a thread loads at once
enum { kModeBf16 = 0, kModeF32 = 1, kModeInt8 = 2 };

struct ClassArgs {
  const void* bins;           // [R, F] uint8, int16 or int32, row-major
  const void* gh;             // [K, R, 3] float32 or int8
  const int32_t* row_leaf;    // [R]
  void* partial;              // [n_chunks, F, K, B, 3] accumulator type
  unsigned long long* mtiles; // [F] M-tile steps issued, or null
  int F, K, R, B;
  int root_slot;
  int fc, kc, wpf;            // features, classes / block; units / feature
  int mtb, n_btiles;          // 16-bin M-tiles a block covers; bin tiles
  int n_chunks, tile_rows;    // tile_rows = 16 x steps between flushes
};

__device__ __forceinline__ uint32_t onehot_pair(int lo_bin, int hi_bin,
                                                int m) {
  // two bf16 in one register: the lower half is the lower column
  return (lo_bin == m ? 0x3F80u : 0u) | (hi_bin == m ? 0x3F800000u : 0u);
}

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Stage one addend: kTerms bf16 values at plane stride `plane`.
template <int kMode>
__device__ __forceinline__ void stage_addend(__nv_bfloat16* dst,
                                             size_t plane, float x) {
  if constexpr (kMode == kModeF32) {
    const __nv_bfloat16 hi = __float2bfloat16_rn(x);
    const float r1 = x - __bfloat162float(hi);
    const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
    const float r2 = r1 - __bfloat162float(mid);
    dst[0] = hi;
    dst[plane] = mid;
    dst[2 * plane] = __float2bfloat16_rn(r2);
  } else {
    dst[0] = __float2bfloat16_rn(x);   // int8 values are exact
  }
}

template <int kMode, typename BinT>
__global__ void __launch_bounds__(kClassThreads)
class_mma_kernel(ClassArgs a) {
  constexpr bool kQuant = kMode == kModeInt8;
  constexpr int kTerms = kMode == kModeF32 ? 3 : 1;
  using acc_t = typename Types<kQuant>::acc_t;
  using gh_t = typename Types<kQuant>::gh_t;
  extern __shared__ __align__(16) unsigned char smem[];

  const int bt = blockIdx.x % a.n_btiles;    // the block's bin tile
  const int f0 = (blockIdx.x / a.n_btiles) * a.fc;
  const int fcn = min(a.fc, a.F - f0);
  const int k0 = blockIdx.y * a.kc;
  const int kcn = min(a.kc, a.K - k0);
  const int chunk = blockIdx.z;
  const int T = a.tile_rows;
  int per, n_used;
  chunk_span(a.R, a.n_chunks, T, T, per, n_used);
  if (chunk >= n_used || fcn <= 0 || kcn <= 0) return;
  const int r_begin = chunk * per;
  const int r_end = min(a.R, r_begin + per);

  const int n_nt = (a.kc * kCh + 7) / 8;     // the plan's N-tiles
  const int npad = n_nt * 8;
  // the block's M-tiles [mt_base, mt_base + mt_blk) of the feature's
  const int mt_base = bt * a.mtb;
  const int mt_blk = min(a.mtb, (a.B + 15) / 16 - mt_base);
  const int mpad = a.mtb * 16;
  const int ts = T + 8;                      // row stride of staged G
  const size_t plane = (size_t)npad * ts;

  acc_t* acc_s = reinterpret_cast<acc_t*>(smem);     // [fc][mpad][npad]
  __nv_bfloat16* gt = reinterpret_cast<__nv_bfloat16*>(
      acc_s + (size_t)a.fc * mpad * npad);           // [terms][npad][ts]
  BinT* bins_s = reinterpret_cast<BinT*>(gt + kTerms * plane);  // [fc][T]

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;                   // fragment row group
  const int t = lane & 3;                    // thread in group
  for (size_t i = tid; i < (size_t)a.fc * mpad * npad; i += nthr)
    acc_s[i] = 0;
  for (size_t i = tid; i < kTerms * plane; i += nthr)
    gt[i] = __float2bfloat16_rn(0.f);        // pad columns stay zero

  const int nwarps = nthr >> 5;
  const gh_t* gh = reinterpret_cast<const gh_t*>(a.gh);
  const int n_units = fcn * a.wpf;           // (feature, 4 M-tiles) pairs

  for (int t0 = r_begin; t0 < r_end; t0 += T) {
    const int tn = min(T, r_end - t0);
    const int tn16 = (tn + 15) & ~15;
    __syncthreads();
    // -- stage the tile: G as bf16 terms, zero off the root, and the bin
    //    bytes. A thread issues the loads of kStage items, then stores.
    const int n_g = kcn * tn16;
    const int n_b = fcn * tn16;
    const int n_i = max(n_g, n_b);
    for (int i0 = 0; i0 < n_i; i0 += kStage * nthr) {
      float v[kStage][kCh];
      bool ok[kStage];
      BinT bv[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = i0 + u * nthr + tid;
        const int k = i / tn16;
        const int row = i - k * tn16;
        const bool in = i < n_g && row < tn;
        const int r = t0 + row;
        const gh_t* src = gh + ((size_t)(k0 + k) * a.R + r) * kCh;
        const int leaf = in ? __ldg(a.row_leaf + r) : -1;
#pragma unroll
        for (int ch = 0; ch < kCh; ++ch)
          v[u][ch] = in ? (float)__ldg(src + ch) : 0.f;
        ok[u] = in && leaf == a.root_slot;
        const int brow = i / fcn;
        const int j = i - brow * fcn;
        bv[u] = (i < n_b && brow < tn)
                    ? __ldg(reinterpret_cast<const BinT*>(a.bins) +
                            (int64_t)(t0 + brow) * a.F + f0 + j)
                    : (BinT)0;
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = i0 + u * nthr + tid;
        if (i < n_g) {
          const int k = i / tn16;
          const int row = i - k * tn16;
          __nv_bfloat16* dst = gt + (size_t)k * kCh * ts + row;
#pragma unroll
          for (int ch = 0; ch < kCh; ++ch)
            stage_addend<kMode>(dst + (size_t)ch * ts, plane,
                                ok[u] ? v[u][ch] : 0.f);
        }
        if (i < n_b) {
          const int brow = i / fcn;
          bins_s[(i - brow * fcn) * T + brow] = bv[u];
        }
      }
    }
    __syncthreads();
    // -- each warp takes units in turn; per unit, the bin range of the
    //    tile, then the products of 16 rows a step for the M-tiles in it
    for (int un = warp; un < n_units; un += nwarps) {
      const int fl = un / a.wpf;
      const int mt0 = (un - fl * a.wpf) * kMtw;   // within the block's
      if (mt0 >= mt_blk) continue;
      const int mt_abs = mt_base + mt0;           // the feature's M-tile
      const BinT* bw = bins_s + fl * T;
      unsigned lo = 0xffffffffu, hi = 0u;
      if constexpr (sizeof(BinT) == 1) {
        for (int i = lane * 8; i < tn16; i += 256) {   // 8 bytes a lane
          const uint2 w = *reinterpret_cast<const uint2*>(bw + i);
          const unsigned mn = __vminu4(w.x, w.y), mx = __vmaxu4(w.x, w.y);
#pragma unroll
          for (int sh = 0; sh < 32; sh += 8) {
            lo = min(lo, (mn >> sh) & 0xffu);
            hi = max(hi, (mx >> sh) & 0xffu);
          }
        }
      } else {
        for (int i = lane; i < tn16; i += 32) {
          const unsigned v = sizeof(BinT) == 2 ? (unsigned)(uint16_t)bw[i]
                                               : (unsigned)bw[i];
          lo = min(lo, v);
          hi = max(hi, v);
        }
      }
      const int qlo =
          max((int)(__reduce_min_sync(kFull, lo) >> 4) - mt_abs, 0);
      const int qhi = min(min((int)(__reduce_max_sync(kFull, hi) >> 4),
                              mt_base + mt_blk - 1) - mt_abs, kMtw - 1);
      if (qlo > qhi) continue;               // warp-uniform
      if (a.mtiles != nullptr && lane == 0)
        atomicAdd(a.mtiles + f0 + fl,
                  (unsigned long long)((qhi - qlo + 1) * (tn16 >> 4)));
      float c[kMtw][kNtMax][4];
#pragma unroll
      for (int q = 0; q < kMtw; ++q)
#pragma unroll
        for (int n = 0; n < kNtMax; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[q][n][e] = 0.f;
#pragma unroll 2
      for (int kr = 0; kr < tn16; kr += 16) {
        int r0, r1, r2, r3;
        if constexpr (sizeof(BinT) == 1) {
          const uint16_t p01 =
              *reinterpret_cast<const uint16_t*>(bw + kr + 2 * t);
          const uint16_t p89 =
              *reinterpret_cast<const uint16_t*>(bw + kr + 2 * t + 8);
          r0 = p01 & 0xff;
          r1 = p01 >> 8;
          r2 = p89 & 0xff;
          r3 = p89 >> 8;
        } else {
          // int16 bins are below 32768, so the value is the bin
          r0 = (int)bw[kr + 2 * t];
          r1 = (int)bw[kr + 2 * t + 1];
          r2 = (int)bw[kr + 2 * t + 8];
          r3 = (int)bw[kr + 2 * t + 9];
        }
        uint32_t bf[kTerms][kNtMax][2];
#pragma unroll
        for (int q = 0; q < kTerms; ++q)
#pragma unroll
          for (int n = 0; n < kNtMax; ++n) {
            if (n < n_nt) {
              const __nv_bfloat16* p =
                  gt + q * plane + (size_t)(n * 8 + g) * ts + kr + 2 * t;
              bf[q][n][0] = *reinterpret_cast<const uint32_t*>(p);
              bf[q][n][1] = *reinterpret_cast<const uint32_t*>(p + 8);
            }
          }
#pragma unroll
        for (int q = 0; q < kMtw; ++q) {
          if (q < qlo || q > qhi) continue;  // warp-uniform, per tile
          const int ma = (mt_abs + q) * 16 + g, mb = ma + 8;
          const uint32_t a0 = onehot_pair(r0, r1, ma);
          const uint32_t a1 = onehot_pair(r0, r1, mb);
          const uint32_t a2 = onehot_pair(r2, r3, ma);
          const uint32_t a3 = onehot_pair(r2, r3, mb);
#pragma unroll
          for (int n = 0; n < kNtMax; ++n) {
            if (n < n_nt) {
#pragma unroll
              for (int term = 0; term < kTerms; ++term)
                mma_bf16(c[q][n], a0, a1, a2, a3, bf[term][n][0],
                         bf[term][n][1]);
            }
          }
        }
      }
      // flush: the unit's fragments into its own M-tiles of the shared
      // accumulator, with round-to-nearest adds
#pragma unroll
      for (int q = 0; q < kMtw; ++q) {
        if (q < qlo || q > qhi) continue;
        const int m = (mt0 + q) * 16 + g;
#pragma unroll
        for (int n = 0; n < kNtMax; ++n) {
          if (n >= n_nt) continue;
          const int col = n * 8 + 2 * t;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc_t* cell = acc_s + ((size_t)fl * mpad + m + (e >> 1) * 8) *
                                      npad + col + (e & 1);
            if constexpr (kQuant)
              *cell += __float2int_rn(c[q][n][e]);
            else
              *cell += c[q][n][e];
          }
        }
      }
    }
  }
  __syncthreads();
  // -- this chunk's partial of the block's bins: [chunk][f][k][b][c]
  acc_t* P = reinterpret_cast<acc_t*>(a.partial);
  const int bb0 = mt_base * 16;
  const int nbb = min(mpad, a.B - bb0);
  const int per_f = kcn * nbb * kCh;
  for (int i = tid; i < fcn * per_f; i += nthr) {
    const int j = i / per_f;
    const int e = i - j * per_f;
    const int k = e / (nbb * kCh);
    const int bc = e - k * nbb * kCh;
    const int b = bc / kCh;
    const int ch = bc - b * kCh;
    P[(((size_t)chunk * a.F + f0 + j) * a.K + k0 + k) * a.B * kCh +
      (size_t)bb0 * kCh + bc] =
        acc_s[((size_t)j * mpad + b) * npad + k * kCh + ch];
  }
}

template <int kMode, typename BinT>
int launch_class(const ClassArgs& a, void* out, int n_ftiles, int n_ktiles,
                 int threads, size_t smem, cudaStream_t stream) {
  using acc_t = typename Types<kMode == kModeInt8>::acc_t;
  cudaError_t e;
  dim3 grid(n_ftiles * a.n_btiles, n_ktiles, a.n_chunks);
  class_mma_kernel<kMode, BinT><<<grid, threads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the chunk reduction, with the class axis as the slot axis
  ChunkArgs r;
  r.partial = a.partial;
  r.out = out;
  r.F = a.F;
  r.L = a.K;
  r.R = a.R;
  r.B = a.B;
  r.n_chunks = a.n_chunks;
  r.tile_rows = a.tile_rows;
  const size_t total = (size_t)a.K * a.F * a.B * kCh;
  int blocks = (int)((total + 255) / 256);
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  chunk_reduce_kernel<acc_t><<<blocks, 256, 0, stream>>>(r);
  return (int)cudaGetLastError();
}

template <typename BinT>
int launch_class_mode(const ClassArgs& a, int mode, void* out, int n_ftiles,
                      int n_ktiles, int threads, long long smem,
                      void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t sm = (size_t)smem;
  if (mode == kModeInt8)
    return launch_class<kModeInt8, BinT>(a, out, n_ftiles, n_ktiles, threads,
                                         sm, s);
  if (mode == kModeF32)
    return launch_class<kModeF32, BinT>(a, out, n_ftiles, n_ktiles, threads,
                                        sm, s);
  return launch_class<kModeBf16, BinT>(a, out, n_ftiles, n_ktiles, threads,
                                       sm, s);
}

template <typename BinT>
cudaError_t prepare_bins(int smem_optin) {
  const cudaFuncAttribute at = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(slot_accum_kernel<false, BinT, false>, at,
                                smem_optin)) ||
      (e = cudaFuncSetAttribute(slot_accum_kernel<true, BinT, false>, at,
                                smem_optin)) ||
      (e = cudaFuncSetAttribute(slot_accum_kernel<false, BinT, true>, at,
                                smem_optin)) ||
      (e = cudaFuncSetAttribute(slot_accum_kernel<true, BinT, true>, at,
                                smem_optin)) ||
      (e = cudaFuncSetAttribute(class_mma_kernel<kModeBf16, BinT>, at,
                                smem_optin)) ||
      (e = cudaFuncSetAttribute(class_mma_kernel<kModeF32, BinT>, at,
                                smem_optin)) ||
      (e = cudaFuncSetAttribute(class_mma_kernel<kModeInt8, BinT>, at,
                                smem_optin)))
    return e;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Raises the dynamic shared-memory limit of every kernel that may take
// more than 48 KB to smem_optin (the device's opt-in maximum), once,
// when the library is loaded. Launches then carry no attribute call,
// so the same launch sequence runs eagerly and under CUDA-graph stream
// capture. Returns a cudaError_t.
int lgbt_prepare(int smem_optin) {
  const cudaFuncAttribute at = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(slot_count_kernel, at, smem_optin)) ||
      (e = cudaFuncSetAttribute(slot_scatter_kernel<false>, at,
                                smem_optin)) ||
      (e = cudaFuncSetAttribute(slot_scatter_kernel<true>, at,
                                smem_optin)) ||
      (e = prepare_bins<uint8_t>(smem_optin)) ||
      (e = prepare_bins<int16_t>(smem_optin)) ||
      (e = prepare_bins<int32_t>(smem_optin)))
    return (int)e;
  return 0;
}

// B1's accumulation: the slot-ordered pre-pass, the work items and the
// slot reduction. bins are bin_bytes (1, 2 or 4) wide; each block's
// histogram covers bin_tile bins. meta holds 6L + 2 + L * n_wchunks
// int32 (table keys, table slots, slot rows, slot starts, item starts,
// fold segment starts, chunk counts); records [R] x 16 bytes; partial [n_items +
// n_segs, n_ftiles, 3B, 32] of the accumulator type. n_items must be
// at least ceil(R / rows_per_item) + L (the items of any split of R
// rows over L slots) and n_segs at least ceil(2 n_items / 32) (slots
// of more than 32 items are fewer than n_items / 32). init, when not
// null, is an [L, F, B, 3] accumulator the sums start from (the slot
// reduction adds onto it; a slot without rows gets it as it is). Returns
// a cudaError_t.
int lgbt_hist(const void* bins, int bin_bytes, const void* gh, int gh_int8,
              const int32_t* row_leaf, const int32_t* leaf_ids,
              const int32_t* row_gather, const int32_t* num_rows,
              void* records, int32_t* meta, void* partial, void* out,
              const void* init,
              int F, int L, int R, int B, int bf16_round, int fc,
              int n_ftiles, int bin_tile, int warps, int rows_per_item,
              int n_items, int n_segs, int pre_warps, int chunk_rows,
              int n_wchunks, long long smem, void* stream) {
  if (L < 1 || F < 1 || B < 1 || R < 0 || fc < 1 || fc > 32 ||
      bin_tile < 1 || (bin_bytes != 1 && bin_bytes != 2 && bin_bytes != 4) ||
      (long long)fc * n_ftiles < F || warps < 1 || warps > 32 ||
      rows_per_item < 1 || pre_warps < 1 || pre_warps > 32 ||
      chunk_rows < 1 || (long long)n_wchunks * chunk_rows < R ||
      n_items < (R + rows_per_item - 1) / rows_per_item + L ||
      (long long)n_segs * kFold < 2LL * n_items)
    return (int)cudaErrorInvalidValue;
  SlotArgs a;
  a.bins = bins;
  a.gh = gh;
  a.row_leaf = row_leaf;
  a.leaf_ids = leaf_ids;
  a.row_gather = row_gather;
  a.num_rows = num_rows;
  a.records = reinterpret_cast<uint4*>(records);
  a.tab_keys = meta;
  a.tab_slots = meta + L;
  a.slot_rows = meta + 2 * L;
  a.slot_start = meta + 3 * L;
  a.item_start = meta + 4 * L;
  a.seg_start = meta + 5 * L + 1;
  a.counts = meta + 6 * L + 2;
  a.partial = partial;
  a.folded = nullptr;
  a.out = out;
  a.init = init;
  a.F = F;
  a.L = L;
  a.R = R;
  a.B = B;
  a.bf16_round = bf16_round;
  a.fc = fc;
  a.n_ftiles = n_ftiles;
  a.bin_tile = bin_tile;
  a.rows_per_item = rows_per_item;
  a.pre_warps = pre_warps;
  a.chunk_rows = chunk_rows;
  a.n_wchunks = n_wchunks;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t sm = (size_t)smem;
  if (gh_int8) {
    if (bin_bytes == 1)
      return launch_slot_hist<true, uint8_t>(a, warps, n_items, n_segs, sm, s);
    if (bin_bytes == 2)
      return launch_slot_hist<true, int16_t>(a, warps, n_items, n_segs, sm, s);
    return launch_slot_hist<true, int32_t>(a, warps, n_items, n_segs, sm, s);
  }
  if (bin_bytes == 1)
    return launch_slot_hist<false, uint8_t>(a, warps, n_items, n_segs, sm, s);
  if (bin_bytes == 2)
    return launch_slot_hist<false, int16_t>(a, warps, n_items, n_segs, sm, s);
  return launch_slot_hist<false, int32_t>(a, warps, n_items, n_segs, sm, s);
}

// B2 epilogue over a finished [L, F, B, 3] histogram.
int lgbt_split_epilogue(const void* hist, int quant, const int32_t* nbpf,
                        const int32_t* nan_bin, const int32_t* is_cat,
                        const uint8_t* fmask, int fmask_2d,
                        const int32_t* mono, const float* leaf_lo,
                        const float* leaf_hi, const float* parent_out,
                        const float* mono_pen, const float* qscale,
                        float* rec, int L, int F, int B, int use_mono,
                        int use_smooth, int pen_on, float l1, float l2,
                        float mds, float ps, float md, float mh, float mg,
                        void* stream) {
  SplitArgs a;
  a.hist = hist;
  a.nbpf = nbpf;
  a.nan_bin = nan_bin;
  a.is_cat = is_cat;
  a.fmask = fmask;
  a.mono = mono;
  a.leaf_lo = leaf_lo;
  a.leaf_hi = leaf_hi;
  a.parent_out = parent_out;
  a.mono_pen = mono_pen;
  a.qscale = qscale;
  a.rec = rec;
  a.L = L;
  a.F = F;
  a.B = B;
  a.quant = quant;
  a.fmask_2d = fmask_2d;
  a.use_mono = use_mono;
  a.use_smooth = use_smooth;
  a.pen_on = pen_on;
  a.l1 = l1;
  a.l2 = l2;
  a.mds = mds;
  a.ps = ps;
  a.md = md;
  a.mh = mh;
  a.mg = mg;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int threads = F < 8 ? 32 * (F > 0 ? F : 1) : 256;
  if (quant)
    split_epilogue_kernel<int><<<L, threads, 0, s>>>(a);
  else
    split_epilogue_kernel<float><<<L, threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// B3 tensor-core accumulation + chunk reduction. mode: 0 bf16-rounded
// f32, 1 f32 (three bf16 terms), 2 int8. bins are bin_bytes (1, 2 or 4)
// wide; a block covers mtb 16-bin M-tiles of a feature, n_btiles of
// them the feature's bins. mtiles, when not null, gets
// per feature the 16-bin M-tiles issued, summed over 16-row steps (each
// counts n_tiles x terms products). Returns a cudaError_t.
int lgbt_class_hist(const void* bins, int bin_bytes, const void* gh,
                    int mode, const int32_t* row_leaf, void* partial,
                    void* out, unsigned long long* mtiles,
                    int F, int K, int R, int B, int root_slot, int fc,
                    int kc, int wpf, int mtb, int n_btiles, int n_ftiles,
                    int n_ktiles, int n_chunks, int tile_rows, int threads,
                    long long smem, void* stream) {
  ClassArgs a;
  a.bins = bins;
  a.gh = gh;
  a.row_leaf = row_leaf;
  a.partial = partial;
  a.mtiles = mtiles;
  a.F = F;
  a.K = K;
  a.R = R;
  a.B = B;
  a.root_slot = root_slot;
  a.fc = fc;
  a.kc = kc;
  a.wpf = wpf;
  a.mtb = mtb;
  a.n_btiles = n_btiles;
  a.n_chunks = n_chunks;
  a.tile_rows = tile_rows;
  if (threads > kClassThreads || threads % 32 != 0 ||
      kc * kCh > kNtMax * 8 || tile_rows % 16 != 0 || mode < 0 || mode > 2 ||
      mtb < 1 || n_btiles < 1 || (long long)mtb * n_btiles * 16 < B ||
      wpf * kMtw < mtb ||
      (bin_bytes != 1 && bin_bytes != 2 && bin_bytes != 4))
    return (int)cudaErrorInvalidValue;
  if (bin_bytes == 1)
    return launch_class_mode<uint8_t>(a, mode, out, n_ftiles, n_ktiles,
                                      threads, smem, stream);
  if (bin_bytes == 2)
    return launch_class_mode<int16_t>(a, mode, out, n_ftiles, n_ktiles,
                                      threads, smem, stream);
  return launch_class_mode<int32_t>(a, mode, out, n_ftiles, n_ktiles,
                                    threads, smem, stream);
}

}  // extern "C"
