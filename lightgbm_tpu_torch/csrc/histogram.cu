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
//
// What the design does about it.
//  * Rows are read as uint8 straight from bins (the Pallas path widens
//    them to int32 first, :275), and the kernel gathers row_gather's
//    rows itself instead of materialising a gathered copy.
//  * A block owns a tile of features x a tile of leaf slots x a range of
//    rows. It stages a tile of rows (slot, rounded addends, the tile's
//    bin bytes) in shared memory, then each warp scatters ONE feature
//    into its own private [slots, B, 3] shared-memory histogram. A leaf
//    id -> slot lookup replaces the Pallas mask compare.
//  * No atomics. Within a warp, lanes holding the same (slot, bin) key
//    are grouped with __match_any_sync and summed in lane order, and
//    the group leader adds the sum to the warp-private histogram. Each
//    chunk's partial is written to global memory and a second kernel
//    sums the partials in chunk order. The summation order is therefore
//    fixed: two runs on the card give bit-identical histograms and grow
//    the same trees (the int8 path is exact in any order).
//  * num_rows is read on the device; the rows past it are never touched
//    and the chunk geometry adapts to it, so a compacted child stream
//    pays only for its live prefix, without a host sync.
//  * f32 addends are rounded to bf16 (round-to-nearest-even) when asked,
//    as the plain version rounds them, and summed in f32.
//  The split epilogue is a second launch, one block per slot, one warp
//  per feature: the histogram is under 1 MB and L2-resident, and B2's
//  callers write it out anyway for the subtraction cache. The epilogue
//  is bound by launch latency, not by bytes or flops.
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
//    order by B1's reduction kernel, so two launches are bit-identical.
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

struct HistArgs {
  const uint8_t* bins;        // [R_src, F] uint8, row-major
  const void* gh;             // [R, 3] float32 or int8
  const int32_t* row_leaf;    // [R]
  const int32_t* leaf_ids;    // [L]
  const int32_t* row_gather;  // [R] or null
  const int32_t* num_rows;    // device scalar or null
  void* partial;              // [n_chunks, F, L, B, 3] accumulator type
  void* out;                  // [L, F, B, 3]
  int F, L, R, B;
  int bf16_round;
  int fc, Ls;                 // features / slots per block
  int n_chunks, tile_rows, min_chunk_rows;
};

// Rows per chunk and chunks used for nr live rows: a whole number of
// tiles, at least min_rows.
__device__ __forceinline__ void chunk_span(int nr, int n_chunks,
                                           int min_rows, int tile_rows,
                                           int& per, int& n_used) {
  per = (nr + n_chunks - 1) / n_chunks;
  per = max(per, min_rows);
  per = (per + tile_rows - 1) / tile_rows * tile_rows;
  n_used = (nr + per - 1) / per;
}

// Row-range geometry from the device-side live-row count; both kernels
// derive the same chunk count from it.
__device__ __forceinline__ void chunk_geom(const HistArgs& a, int& nr,
                                           int& per, int& n_used) {
  nr = a.num_rows ? *a.num_rows : a.R;
  nr = max(0, min(nr, a.R));
  chunk_span(nr, a.n_chunks, a.min_chunk_rows, a.tile_rows, per, n_used);
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

__device__ __forceinline__ float addend(float v, int bf16_round) {
  return bf16_round ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}
__device__ __forceinline__ int addend(int8_t v, int) { return (int)v; }

template <bool kQuant>
__global__ void hist_accum_kernel(HistArgs a) {
  using acc_t = typename Types<kQuant>::acc_t;
  using gh_t = typename Types<kQuant>::gh_t;
  extern __shared__ __align__(16) unsigned char smem[];

  const int f0 = blockIdx.x * a.fc;
  const int fcn = min(a.fc, a.F - f0);
  const int s0 = blockIdx.y * a.Ls;
  const int lsn = min(a.Ls, a.L - s0);
  const int chunk = blockIdx.z;
  int nr, per, n_used;
  chunk_geom(a, nr, per, n_used);
  if (chunk >= n_used || fcn <= 0 || lsn <= 0) return;
  const int r_begin = chunk * per;
  const int r_end = min(nr, r_begin + per);

  const size_t per_feat = (size_t)a.Ls * a.B * kCh;
  acc_t* hist = reinterpret_cast<acc_t*>(smem);           // [fc][Ls][B][3]
  acc_t* vals = hist + (size_t)a.fc * per_feat;           // [tile][3]
  int* slot_s = reinterpret_cast<int*>(vals + (size_t)a.tile_rows * kCh);
  int* ids = slot_s + a.tile_rows;                        // [Ls]
  uint8_t* bins_s = reinterpret_cast<uint8_t*>(ids + a.Ls);  // [tile][fc]

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (size_t i = tid; i < (size_t)a.fc * per_feat; i += nthr) hist[i] = 0;
  for (int i = tid; i < a.Ls; i += nthr)
    ids[i] = i < lsn ? a.leaf_ids[s0 + i] : -2;
  __syncthreads();

  const gh_t* gh = reinterpret_cast<const gh_t*>(a.gh);
  acc_t* my_hist = hist + (size_t)warp * per_feat;
  for (int t0 = r_begin; t0 < r_end; t0 += a.tile_rows) {
    const int tn = min(a.tile_rows, r_end - t0);
    // -- stage the tile: slot lookup, rounded addends, bin bytes
    for (int i = tid; i < tn; i += nthr) {
      const int r = t0 + i;
      const int leaf = a.row_leaf[r];
      int s = -1;
      for (int k = 0; k < lsn; ++k) {
        if (ids[k] == leaf) {
          s = k;
          break;
        }
      }
      slot_s[i] = s;
      if (s >= 0) {
        const gh_t* g = gh + (size_t)r * kCh;
        vals[i * kCh + 0] = addend(g[0], a.bf16_round);
        vals[i * kCh + 1] = addend(g[1], a.bf16_round);
        vals[i * kCh + 2] = addend(g[2], a.bf16_round);
        const int64_t src = a.row_gather ? (int64_t)a.row_gather[r] : r;
        const uint8_t* brow = a.bins + src * a.F + f0;
        for (int j = 0; j < fcn; ++j) bins_s[i * a.fc + j] = brow[j];
      }
    }
    __syncthreads();
    // -- one warp per feature: ordered, conflict-free scatter
    if (warp < fcn) {
      for (int g0 = 0; g0 < tn; g0 += 32) {
        const int i = g0 + lane;
        int key = -1;
        acc_t v0 = 0, v1 = 0, v2 = 0;
        if (i < tn) {
          const int s = slot_s[i];
          if (s >= 0) {
            const int b = bins_s[i * a.fc + warp];
            if (b < a.B) {
              key = s * a.B + b;
              v0 = vals[i * kCh + 0];
              v1 = vals[i * kCh + 1];
              v2 = vals[i * kCh + 2];
            }
          }
        }
        const unsigned peers = __match_any_sync(kFull, key);
        const int leader = __ffs(peers) - 1;
        const int gmax = __reduce_max_sync(kFull, (unsigned)__popc(peers));
        acc_t s0v = 0, s1v = 0, s2v = 0;
        unsigned rem = peers;
        for (int k = 0; k < gmax; ++k) {
          const int src = rem ? __ffs(rem) - 1 : lane;
          const acc_t w0 = __shfl_sync(kFull, v0, src);
          const acc_t w1 = __shfl_sync(kFull, v1, src);
          const acc_t w2 = __shfl_sync(kFull, v2, src);
          if (rem) {
            s0v += w0;
            s1v += w1;
            s2v += w2;
            rem &= rem - 1;
          }
        }
        if (key >= 0 && lane == leader) {
          acc_t* c = my_hist + (size_t)key * kCh;
          c[0] += s0v;
          c[1] += s1v;
          c[2] += s2v;
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }
  // -- this chunk's partial: [chunk][f][l][b][c]
  acc_t* P = reinterpret_cast<acc_t*>(a.partial);
  const size_t n = (size_t)lsn * a.B * kCh;
  for (int j = 0; j < fcn; ++j) {
    acc_t* dst =
        P + (((size_t)chunk * a.F + f0 + j) * a.L + s0) * a.B * kCh;
    const acc_t* src = hist + (size_t)j * per_feat;
    for (size_t e = tid; e < n; e += nthr) dst[e] = src[e];
  }
}

// out[l][f][b][c] = sum over used chunks, in chunk order.
template <typename acc_t>
__global__ void hist_reduce_kernel(HistArgs a) {
  int nr, per, n_used;
  chunk_geom(a, nr, per, n_used);
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
  const float* qscale;        // [2] (quant)
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
  const float sc0 = quant ? a.qscale[0] : 1.f;
  const float sc1 = quant ? a.qscale[1] : 1.f;
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

template <bool kQuant>
int launch_hist(const HistArgs& a, int n_ftiles, int n_stiles,
                int threads, size_t smem, cudaStream_t stream) {
  using acc_t = typename Types<kQuant>::acc_t;
  cudaError_t e = cudaFuncSetAttribute(
      hist_accum_kernel<kQuant>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_ftiles, n_stiles, a.n_chunks);
  hist_accum_kernel<kQuant><<<grid, threads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)a.L * a.F * a.B * kCh;
  int blocks = (int)((total + 255) / 256);
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  hist_reduce_kernel<acc_t><<<blocks, 256, 0, stream>>>(a);
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
  const uint8_t* bins;        // [R, F] uint8, row-major
  const void* gh;             // [K, R, 3] float32 or int8
  const int32_t* row_leaf;    // [R]
  void* partial;              // [n_chunks, F, K, B, 3] accumulator type
  unsigned long long* mtiles; // [F] M-tile steps issued, or null
  int F, K, R, B;
  int root_slot;
  int fc, kc, wpf;            // features, classes / block; units / feature
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

template <int kMode>
__global__ void __launch_bounds__(kClassThreads)
class_mma_kernel(ClassArgs a) {
  constexpr bool kQuant = kMode == kModeInt8;
  constexpr int kTerms = kMode == kModeF32 ? 3 : 1;
  using acc_t = typename Types<kQuant>::acc_t;
  using gh_t = typename Types<kQuant>::gh_t;
  extern __shared__ __align__(16) unsigned char smem[];

  const int f0 = blockIdx.x * a.fc;
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
  const int mt_all = (a.B + 15) / 16;
  const int mpad = mt_all * 16;
  const int ts = T + 8;                      // row stride of staged G
  const size_t plane = (size_t)npad * ts;

  acc_t* acc_s = reinterpret_cast<acc_t*>(smem);     // [fc][mpad][npad]
  __nv_bfloat16* gt = reinterpret_cast<__nv_bfloat16*>(
      acc_s + (size_t)a.fc * mpad * npad);           // [terms][npad][ts]
  uint8_t* bins_s = reinterpret_cast<uint8_t*>(
      gt + kTerms * plane);                          // [fc][T]

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
      uint8_t bv[kStage];
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
                    ? __ldg(a.bins + (int64_t)(t0 + brow) * a.F + f0 + j)
                    : (uint8_t)0;
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
      const int mt0 = (un - fl * a.wpf) * kMtw;
      if (mt0 >= mt_all) continue;
      const uint8_t* bw = bins_s + fl * T;
      unsigned lo = 255u, hi = 0u;
      for (int i = lane * 8; i < tn16; i += 256) {   // 8 bytes a lane
        const uint2 w = *reinterpret_cast<const uint2*>(bw + i);
        const unsigned mn = __vminu4(w.x, w.y), mx = __vmaxu4(w.x, w.y);
#pragma unroll
        for (int sh = 0; sh < 32; sh += 8) {
          lo = min(lo, (mn >> sh) & 0xffu);
          hi = max(hi, (mx >> sh) & 0xffu);
        }
      }
      const int qlo = max((int)(__reduce_min_sync(kFull, lo) >> 4) - mt0, 0);
      const int qhi = min(min((int)(__reduce_max_sync(kFull, hi) >> 4),
                              mt_all - 1) - mt0, kMtw - 1);
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
        const uint16_t p01 =
            *reinterpret_cast<const uint16_t*>(bw + kr + 2 * t);
        const uint16_t p89 =
            *reinterpret_cast<const uint16_t*>(bw + kr + 2 * t + 8);
        const int r0 = p01 & 0xff, r1 = p01 >> 8;
        const int r2 = p89 & 0xff, r3 = p89 >> 8;
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
          const int ma = (mt0 + q) * 16 + g, mb = ma + 8;
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
  // -- this chunk's partial: [chunk][f][k][b][c]
  acc_t* P = reinterpret_cast<acc_t*>(a.partial);
  const int per_f = kcn * a.B * kCh;
  for (int i = tid; i < fcn * per_f; i += nthr) {
    const int j = i / per_f;
    const int e = i - j * per_f;
    const int k = e / (a.B * kCh);
    const int bc = e - k * a.B * kCh;
    const int b = bc / kCh;
    const int ch = bc - b * kCh;
    P[(((size_t)chunk * a.F + f0 + j) * a.K + k0) * a.B * kCh + e] =
        acc_s[((size_t)j * mpad + b) * npad + k * kCh + ch];
  }
}

template <int kMode>
int launch_class(const ClassArgs& a, void* out, int n_ftiles, int n_ktiles,
                 int threads, size_t smem, cudaStream_t stream) {
  using acc_t = typename Types<kMode == kModeInt8>::acc_t;
  cudaError_t e = cudaFuncSetAttribute(
      class_mma_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_ftiles, n_ktiles, a.n_chunks);
  class_mma_kernel<kMode><<<grid, threads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the chunk reduction is B1's with the class axis as the slot axis
  HistArgs r = {};
  r.partial = a.partial;
  r.out = out;
  r.F = a.F;
  r.L = a.K;
  r.R = a.R;
  r.B = a.B;
  r.n_chunks = a.n_chunks;
  r.tile_rows = a.tile_rows;
  r.min_chunk_rows = a.tile_rows;
  const size_t total = (size_t)a.K * a.F * a.B * kCh;
  int blocks = (int)((total + 255) / 256);
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  hist_reduce_kernel<acc_t><<<blocks, 256, 0, stream>>>(r);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B1 accumulation + chunk reduction. Returns a cudaError_t.
int lgbt_hist(const uint8_t* bins, const void* gh, int gh_int8,
              const int32_t* row_leaf, const int32_t* leaf_ids,
              const int32_t* row_gather, const int32_t* num_rows,
              void* partial, void* out, int F, int L, int R, int B,
              int bf16_round, int fc, int Ls, int n_ftiles, int n_stiles,
              int n_chunks, int tile_rows, int min_chunk_rows, int threads,
              long long smem, void* stream) {
  HistArgs a;
  a.bins = bins;
  a.gh = gh;
  a.row_leaf = row_leaf;
  a.leaf_ids = leaf_ids;
  a.row_gather = row_gather;
  a.num_rows = num_rows;
  a.partial = partial;
  a.out = out;
  a.F = F;
  a.L = L;
  a.R = R;
  a.B = B;
  a.bf16_round = bf16_round;
  a.fc = fc;
  a.Ls = Ls;
  a.n_chunks = n_chunks;
  a.tile_rows = tile_rows;
  a.min_chunk_rows = min_chunk_rows;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (gh_int8)
    return launch_hist<true>(a, n_ftiles, n_stiles, threads, (size_t)smem, s);
  return launch_hist<false>(a, n_ftiles, n_stiles, threads, (size_t)smem, s);
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
// f32, 1 f32 (three bf16 terms), 2 int8. mtiles, when not null, gets
// per feature the 16-bin M-tiles issued, summed over 16-row steps (each
// counts n_tiles x terms products). Returns a cudaError_t.
int lgbt_class_hist(const uint8_t* bins, const void* gh, int mode,
                    const int32_t* row_leaf, void* partial, void* out,
                    unsigned long long* mtiles,
                    int F, int K, int R, int B, int root_slot, int fc,
                    int kc, int wpf, int n_ftiles, int n_ktiles,
                    int n_chunks, int tile_rows, int threads,
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
  a.n_chunks = n_chunks;
  a.tile_rows = tile_rows;
  if (threads > kClassThreads || threads % 32 != 0 ||
      kc * kCh > kNtMax * 8 || tile_rows % 16 != 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t sm = (size_t)smem;
  if (mode == kModeInt8)
    return launch_class<kModeInt8>(a, out, n_ftiles, n_ktiles, threads, sm,
                                   s);
  if (mode == kModeF32)
    return launch_class<kModeF32>(a, out, n_ftiles, n_ktiles, threads, sm, s);
  return launch_class<kModeBf16>(a, out, n_ftiles, n_ktiles, threads, sm, s);
}

}  // extern "C"
