"""Hopper histogram kernels (B1, B2, B3): build, bind, launch, count.

Counterpart of ``lightgbm_tpu/ops/pallas_histogram.py``. The sources are
``lightgbm_tpu_torch/csrc/histogram.cu`` (see its header for what bounds
each kernel and how the design meets it). At first use on a GPU they are
compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` into
``build/lightgbm_tpu_torch/`` beside the package and loaded with ctypes;
launches go on ``torch.cuda.current_stream()``.

Each kernel has a wrapper and, in the same package, a plain PyTorch
version of the same function:

- B1 ``build_histograms_cuda`` — plain version
  ``ops.histogram.build_histograms``.
- B2 ``fused_build_best_splits`` — plain version
  :func:`fused_build_best_splits_plain` (``find_best_splits`` over
  ``build_histograms``, plus ``slot_totals`` and the histogram).
- B3 ``build_root_histograms_classes`` — plain version
  :func:`build_root_histograms_classes_plain` (``build_histograms`` on
  the root slot, once per class).

A wrapper takes the plain version only for tensors that lie on the CPU.
For CUDA tensors it launches the kernel or raises — there is no quiet
fallback, and no probe. ``LAUNCHES`` counts kernel launches per wrapper
(one per call, incremented where the kernel is launched and nowhere
else) and ``INT8_LAUNCHES`` those of them made with int8 gradients (the
quantized-training mode); :func:`reset_launch_counts` zeroes both. A
replayed CUDA graph runs no wrapper: the launches a capture recorded
are counted apart (:func:`captured_launches`) and added on every
replay (:func:`count_replay`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

from .histogram import HIST_CH, build_histograms
from .split import _winner_fields, eval_split_lattice, pack_member_bitset

__all__ = ["build_histograms_cuda", "fused_build_best_splits",
           "fused_build_best_splits_plain", "build_root_histograms_classes",
           "build_root_histograms_classes_plain", "LAUNCHES",
           "INT8_LAUNCHES",
           "reset_launch_counts", "captured_launches", "count_replay",
           "load_library", "BUILD_INFO", "LIBRARY_LOADS",
           "slot_hist_plan", "class_mma_plan", "bf16_split3"]

LAUNCHES: Dict[str, int] = {"build_histograms_cuda": 0,
                            "fused_build_best_splits": 0,
                            "build_root_histograms_classes": 0}
INT8_LAUNCHES: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)
BUILD_INFO: Dict[str, str] = {}
# loads of the kernels' library by this process (the trace doctor's
# capture guard counts a load inside a steady-state scope as a rebuild)
LIBRARY_LOADS = 0

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "histogram.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
_LIB = None
_REC = 16                 # candidate record lanes (see histogram.cu)
# B1/B2 (see histogram.cu): the most warps of an accumulation block,
# the work items a plan aims at per block slot of the card (the grid's
# waves when every row is in one slot), the warps of a pre-pass block
# and the stream rows a pre-pass warp takes.
_ITEM_WARPS = 8
_ITEM_WAVES = 8
_PRE_WARPS = 8
_CHUNK_ROWS = 4096
_FOLD = 32                # items a fold segment sums (histogram.cu kFold)
_BIN_TILE = 64            # B1/B2: bins of a block's histogram past 256
# the bin matrix's element types the kernels read
_BIN_DTYPES = (torch.uint8, torch.int16, torch.int32)
# B3 (see histogram.cu): bin tiles per unit of a warp's work, N-tiles
# per block, the most warps a block may have (its __launch_bounds__) and
# the warps it has by default, units a warp takes per staged tile, the
# register budget that bound allows a thread, and S, the 16-row mma
# steps a register chain runs before it is flushed into shared memory
# (S x 16 <= 1024).
_MTW = 4
_NT_MAX = 3
_CLASS_MAX_WARPS = 16
_CLASS_WARPS = 8
_CLASS_UNITS = 2
_CLASS_REGS = 128
_CLASS_STEPS = 32
_CLASS_MODES = {"bfloat16": 0, "float32": 1, "int8": 2}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = INT8_LAUNCHES[k] = 0


def _count(name: str, quant: bool) -> None:
    LAUNCHES[name] += 1
    if quant:
        INT8_LAUNCHES[name] += 1


class Recorded(dict):
    """A capture's launches per wrapper; ``int8`` holds the int8 ones."""

    def __init__(self):
        super().__init__()
        self.int8: Dict[str, int] = {}


@contextlib.contextmanager
def captured_launches():
    """Around a CUDA-graph capture: the wrappers' launches recorded into
    the graph (which run nothing yet) are taken out of ``LAUNCHES`` and
    ``INT8_LAUNCHES`` into the :class:`Recorded` this yields;
    :func:`count_replay` adds them back on every replay of the graph."""
    before, before8 = dict(LAUNCHES), dict(INT8_LAUNCHES)
    recorded = Recorded()
    try:
        yield recorded
    finally:
        for k in LAUNCHES:
            recorded[k] = LAUNCHES[k] - before[k]
            recorded.int8[k] = INT8_LAUNCHES[k] - before8[k]
            LAUNCHES[k], INT8_LAUNCHES[k] = before[k], before8[k]


def count_replay(recorded: Recorded) -> None:
    """Count the launches of one replay of a captured graph."""
    for k, n in recorded.items():
        LAUNCHES[k] += n
    for k, n in recorded.int8.items():
        INT8_LAUNCHES[k] += n


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA histogram kernels are "
                       "built from source at first use")


def load_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernels' library."""
    global _LIB, LIBRARY_LOADS
    if _LIB is not None:
        return _LIB
    src = _SRC.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = _SRC.parents[2] / "build" / "lightgbm_tpu_torch" / \
        f"libhistogram_{tag}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_INFO["nvcc"] = " ".join(cmd)
        BUILD_INFO["log"] = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    F32 = ctypes.c_float
    lib.lgbt_hist.argtypes = [P, I, P, I, P, P, P, P, P, P, P, P, P, I,
                              I, I, I, I, I, I, I, I, I, I, I, I, I, I,
                              LL, P]
    lib.lgbt_hist.restype = I
    lib.lgbt_split_epilogue.argtypes = [P, I, P, P, P, P, I, P, P, P, P,
                                        P, P, P, I, I, I, I, I, I, F32,
                                        F32, F32, F32, F32, F32, F32, P]
    lib.lgbt_split_epilogue.restype = I
    lib.lgbt_class_hist.argtypes = [P, I, P, I, P, P, P, P, I, I, I, I, I,
                                    I, I, I, I, I, I, I, I, I, I, LL, P]
    lib.lgbt_class_hist.restype = I
    lib.lgbt_prepare.argtypes = [I]
    lib.lgbt_prepare.restype = I
    # the kernels' shared-memory limit is raised here, once, so that no
    # launch makes an attribute call (launches are captured into CUDA
    # graphs by the training step)
    _check(lib.lgbt_prepare(_device_props(torch.device(
        "cuda", torch.cuda.current_device()))[1]), "library preparation")
    BUILD_INFO["library"] = str(out)
    _LIB = lib
    LIBRARY_LOADS += 1
    return lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")


def _require(t: torch.Tensor, name: str, dtype, dev, shape=None) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _require_bins(bins: torch.Tensor, dev, shape=None) -> None:
    """The bin matrix: uint8, int16 or int32 (wide bins), contiguous."""
    _require(bins, "bins", None, dev, shape)
    if bins.dtype not in _BIN_DTYPES:
        raise ValueError(f"bins must be uint8, int16 or int32, got "
                         f"{bins.dtype}")


def _device_props(dev: torch.device):
    p = torch.cuda.get_device_properties(dev)
    smem = int(getattr(p, "shared_memory_per_block_optin", 0) or 232448)
    smem_sm = int(getattr(p, "shared_memory_per_multiprocessor", 0)
                  or 233472)
    return p.multi_processor_count, smem, smem_sm


def slot_hist_plan(F: int, L: int, B: int, R: int, acc_bytes: int = 4,
                   smem_max: int = 232448, smem_sm: int = 233472,
                   n_sm: int = 132, *, warps: Optional[int] = None,
                   rows: Optional[int] = None,
                   bin_tile: Optional[int] = None) -> dict:
    """Plan of B1's slot-segmented accumulation (B2's first half) for a
    stream of R rows over L slots.

    Up to B = 256 a block's histogram covers all bins; above, the bins
    are cut into ``n_btiles`` balanced tiles of ``bin_tile`` <= 64 bins,
    a grid axis: a block's histogram covers one tile, and the items'
    partials hold all B bins. (At the Higgs calls at B = 1,021, tiles
    of 64 bins at 8 warps ran 13% faster than tiles of 256 at 2;
    ``scripts/torch_b1_plans.py --wide``.)

    The pre-pass: warps of ``chunk_rows`` rows, ``n_wchunks`` of them
    for R rows, ``pre_warps`` a block beside the sorted leaf-id table
    and a [L] counter a warp (``pre_smem``); ``record_bytes`` and
    ``meta_ints`` of scratch. The items: S = ``rows_per_item`` records
    of one slot x one tile of ``fc`` <= 32 features (a lane each); a
    block of ``warps`` warps, each with its own [B, 3, 32] histogram
    and two steps of 32 staged records (``smem``). The host knows R and
    L, not how the rows fall, so the grid is the upper bound
    ``n_items`` = ceil(R / S) + L (surplus blocks exit); a slot of more
    than 32 items is folded in segments of 32 (at most ``n_segs``);
    ``partial_bytes`` holds the partials of both. S is sized so that a
    stream in one slot fills ~8 waves of the card; ``warps``, ``rows``
    and ``bin_tile`` fix the block width, S and the tile width instead,
    so that two plans can be timed at one shape."""
    if L < 1 or B < 1 or F < 1:
        raise ValueError(f"B1 plan: L={L}, B={B}, F={F} (each >= 1)")
    budget = smem_max - 1024
    q = HIST_CH * B
    if bin_tile is None:
        n_bt = 1 if B <= 256 else -(-B // _BIN_TILE)
        bt = -(-B // n_bt)             # balance the bin tiles
    elif 1 <= bin_tile <= B:
        bt, n_bt = bin_tile, -(-B // bin_tile)
    else:
        raise ValueError(f"B1 plan: bin_tile {bin_tile} (1..{B})")
    per_warp = HIST_CH * bt * 32 * acc_bytes + 64 * 16  # + two record steps
    fit = min(32, budget // per_warp)
    if fit < 1:
        raise ValueError(f"histogram lattice B={B} does not fit shared "
                         "memory")
    if warps is None:
        warps = min(_ITEM_WARPS, fit)
    elif not 1 <= warps <= fit:
        raise ValueError(f"B1 plan: warps {warps} (1..{fit} at B={B})")
    n_ft = -(-F // 32)
    fc = -(-F // n_ft)                 # balance the feature tiles
    smem = warps * per_warp
    per_sm = max(1, min(smem_sm // (smem + 1024), 64 // warps))
    step = 32 * warps
    if rows is None:
        target = max(1, _ITEM_WAVES * n_sm * per_sm // (n_ft * n_bt))
        rows = max(step, -(-(-(-R // target)) // step) * step)
    elif rows < 1:
        raise ValueError(f"B1 plan: rows {rows} (>= 1)")
    n_items = -(-R // rows) + L
    # fold segments of _FOLD items, only for slots of more than _FOLD:
    # fewer than n_items / _FOLD such slots, so at most 2 n_items / _FOLD
    n_segs = max(1, -(-2 * n_items // _FOLD))
    pre_warps = min(_PRE_WARPS, budget // 4 // L - 2)
    if pre_warps < 1:
        raise ValueError(f"{L} slots do not fit the pre-pass's shared "
                         "memory")
    n_wchunks = max(1, -(-R // _CHUNK_ROWS))
    return dict(fc=fc, n_ftiles=n_ft, bin_tile=bt, n_btiles=n_bt,
                warps=warps, threads=32 * warps,
                smem=smem, per_sm=per_sm, rows_per_item=rows,
                n_items=n_items, n_segs=n_segs,
                partial_bytes=(n_items + n_segs) * n_ft * q * 32 * acc_bytes,
                pre_warps=pre_warps, pre_smem=(2 + pre_warps) * L * 4,
                chunk_rows=_CHUNK_ROWS, n_wchunks=n_wchunks,
                record_bytes=max(R, 1) * 16,
                meta_ints=6 * L + 2 + L * n_wchunks)


def class_mma_plan(F: int, K: int, B: int, R: int, hist_dtype: str,
                   smem_max: int = 232448, smem_sm: int = 233472,
                   n_sm: int = 132, *, warps: Optional[int] = None,
                   steps: int = _CLASS_STEPS, bin_bytes: int = 1) -> dict:
    """Tile plan of B3's tensor-core kernel (``hist_dtype`` "bfloat16",
    "float32" or "int8"). The unit of a warp's work is (feature, 4 bin
    tiles of 16): ``wpf`` units cover a feature's B bins, and a warp
    takes up to ``_CLASS_UNITS`` units in turn per staged tile. The
    block's N-tiles of 8 addend columns number at most 3: classes are
    tiled so that ``kc`` x 3 <= 24. A block holds ``fc`` features (8
    warps, or 16 when two 8-warp blocks do not fit an SM, so that an SM
    runs 16) beside their [fc, 16 x bin tiles, N] shared accumulator
    and the staged tile (G as bf16, one plane per term, and the
    features' bin bytes). Row chunks (whole tiles of
    ``tile_rows`` = 16 x ``steps`` rows, one register chain each) are
    added until the grid is 4 blocks per SM slot, since which features
    are wide is known only on the device. ``warps`` fixes the block
    width (at most 16) instead, so that plans of other chain lengths
    can be compared at one block shape.

    A block covers ``mtb`` M-tiles of 16 bins of its features: all of
    a feature's tiles while one feature's accumulator fits shared
    memory, else ``n_btiles`` balanced ranges of them (a grid axis).
    The staged bins take ``bin_bytes`` each (1, 2 or 4)."""
    if not 1 <= steps <= 64 or (warps is not None
                                and not 1 <= warps <= _CLASS_MAX_WARPS):
        raise ValueError(f"B3 plan: steps {steps} (1..64), warps {warps} "
                         f"(1..{_CLASS_MAX_WARPS})")
    mt_all = -(-B // 16)
    n_kt = -(-(K * HIST_CH) // (8 * _NT_MAX))
    kc = -(-K // n_kt)                 # balanced class tiles
    nt = -(-(kc * HIST_CH) // 8)
    terms = 3 if hist_dtype == "float32" else 1
    tr = 16 * steps
    budget = smem_max - 1024

    def smem_for(fc, mt):
        return (fc * mt * 16 * nt * 8 * 4 + terms * nt * 8 * (tr + 8) * 2
                + fc * tr * bin_bytes)

    fit = mt_all
    while fit > 0 and smem_for(1, fit) > budget:
        fit -= 1
    if fit < 1:
        raise ValueError(f"histogram lattice B={B} does not fit B3's plan")
    n_bt = -(-mt_all // fit)
    mt = -(-mt_all // n_bt)            # balance the bin ranges
    wpf = -(-mt // _MTW)

    def tile(warps):
        fc = 1
        while (fc < F and (fc + 1) * wpf <= warps * _CLASS_UNITS
               and smem_for(fc + 1, mt) <= budget):
            fc += 1
        n_ft = -(-F // fc)
        fc = -(-F // n_ft)             # balance the feature tiles
        threads = 32 * min(warps, fc * wpf)
        per_sm = max(1, min(smem_sm // (smem_for(fc, mt) + 1024),
                            2048 // threads,
                            65536 // (threads * _CLASS_REGS)))
        return fc, n_ft, threads, per_sm

    # 8-warp blocks, two to an SM; 16-warp blocks where two do not fit
    if warps is not None:
        fc, n_ft, threads, per_sm = tile(warps)
    else:
        fc, n_ft, threads, per_sm = tile(_CLASS_WARPS)
        if per_sm < 2:
            fc, n_ft, threads, per_sm = tile(min(2 * _CLASS_WARPS,
                                                 _CLASS_MAX_WARPS))
    smem = smem_for(fc, mt)
    want = 4 * n_sm * per_sm
    n_chunks = max(1, min(-(-R // tr), -(-want // (n_ft * n_kt * n_bt))))
    return dict(fc=fc, kc=kc, wpf=wpf, mtb=mt, n_btiles=n_bt,
                bin_bytes=bin_bytes, n_ftiles=n_ft, n_ktiles=n_kt,
                n_chunks=n_chunks, tile_rows=tr, steps=steps,
                n_tiles=nt, terms=terms, threads=threads, smem=smem,
                acc_regs=_MTW * _NT_MAX * 4, per_sm=per_sm)


def bf16_split3(x: torch.Tensor):
    """The f32 addend split of B3's kernel, as the device code does it:
    hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each
    rounded to nearest even; the two differences are exact in f32. For
    normal x from about 2^-110 (below it ``lo`` turns bf16-subnormal) up
    to the largest finite bf16 (~3.39e38; above it ``hi`` overflows),
    hi + mid + lo equals x exactly."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16)
    r1 = x - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _num_rows_tensor(num_rows, dev):
    """``num_rows`` as an int32 device scalar. The tree builder passes a
    device tensor; an int is copied from the host (a sync eagerly, an
    error under CUDA-graph capture) and serves direct callers only."""
    if num_rows is None:
        return None
    if isinstance(num_rows, torch.Tensor):
        t = num_rows.reshape(()).to(device=dev, dtype=torch.int32)
        return t.contiguous()
    return torch.tensor(int(num_rows), dtype=torch.int32, device=dev)


def _launch_hist(bins, gh, row_leaf, leaf_ids, num_bins, hist_dtype,
                 row_gather, num_rows, plan=None, init=None) -> torch.Tensor:
    """Launch B1's accumulation (no count); ``plan`` replaces
    slot_hist_plan's default one, ``init`` seeds the slot reduction."""
    dev = gh.device
    R = gh.shape[0]
    F = bins.shape[1]
    L = leaf_ids.shape[0]
    B = int(num_bins)
    quant = gh.dtype == torch.int8
    _require_bins(bins, dev)
    _require(gh, "gh", torch.int8 if quant else torch.float32, dev,
             (R, HIST_CH))
    _require(row_leaf, "row_leaf", torch.int32, dev, (R,))
    _require(leaf_ids, "leaf_ids", torch.int32, dev, (L,))
    if row_gather is not None:
        _require(row_gather, "row_gather", torch.int32, dev, (R,))
    elif bins.shape[0] < R:
        raise ValueError("bins has fewer rows than the stream")
    if not quant and hist_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"hist_dtype {hist_dtype!r} is not supported by "
                         "the CUDA kernel")
    nr = _num_rows_tensor(num_rows, dev)
    acc_dt = torch.int32 if quant else torch.float32
    if init is not None:
        _require(init, "init", acc_dt, dev, (L, F, B, HIST_CH))
    if plan is None:
        n_sm, smem_max, smem_sm = _device_props(dev)
        plan = slot_hist_plan(F, L, B, R, 4, smem_max, smem_sm, n_sm)
    records = torch.empty(plan["record_bytes"] // 4, dtype=torch.int32,
                          device=dev)
    meta = torch.empty(plan["meta_ints"], dtype=torch.int32, device=dev)
    partial = torch.empty(plan["partial_bytes"] // 4, dtype=acc_dt,
                          device=dev)
    out = torch.empty((L, F, B, HIST_CH), dtype=acc_dt, device=dev)
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.lgbt_hist(
        bins.data_ptr(), bins.element_size(), gh.data_ptr(), int(quant),
        row_leaf.data_ptr(), leaf_ids.data_ptr(), _ptr(row_gather),
        _ptr(nr), records.data_ptr(), meta.data_ptr(), partial.data_ptr(),
        out.data_ptr(), _ptr(init), F, L, R, B,
        int(hist_dtype == "bfloat16"),
        plan["fc"], plan["n_ftiles"], plan["bin_tile"], plan["warps"],
        plan["rows_per_item"],
        plan["n_items"], plan["n_segs"], plan["pre_warps"],
        plan["chunk_rows"], plan["n_wchunks"], plan["smem"], stream)
    _check(err, "histogram accumulation")
    return out


def build_histograms_cuda(bins: torch.Tensor, gh: torch.Tensor,
                          row_leaf: torch.Tensor, leaf_ids: torch.Tensor, *,
                          num_bins: int, hist_dtype: str = "bfloat16",
                          row_gather: Optional[torch.Tensor] = None,
                          num_rows=None,
                          init: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """B1: the ``build_histograms_pallas`` contract plus ``row_gather``
    (the kernel gathers ``bins`` rows itself). bins [R_src, F] uint8
    (int16 or int32 for wide bins, B > 256),
    gh [R, 3] f32 (addends rounded to ``hist_dtype``) or int8 (exact
    int32), row_leaf [R] int32 (-1 dead), leaf_ids [L] int32 (-2 pad;
    real ids distinct), num_rows an int32 device scalar read on the
    device -> [L, F, B, 3] float32 or int32. On CUDA the rows are sorted
    by slot on the device and summed per slot (plan
    :func:`slot_hist_plan`); f32 sums run in another order than the
    plain version's, the same order on every launch.

    ``init`` [L, F, B, 3] (f32, or int32 for int8 gh) is a carried
    accumulator: the kernel's slot reduction starts each cell's sum from
    it, so the result is ``init`` plus this stream's sums, in one fixed
    order (the out-of-core sweep passes each chunk the sums of the
    chunks before it). ``init=None`` starts from zeros, as before."""
    if gh.device.type == "cpu":
        return build_histograms(bins, gh, row_leaf, leaf_ids,
                                num_bins=num_bins, hist_dtype=hist_dtype,
                                row_gather=row_gather, num_rows=num_rows,
                                init=init)
    out = _launch_hist(bins, gh, row_leaf, leaf_ids, num_bins, hist_dtype,
                       row_gather, num_rows, init=init)
    _count("build_histograms_cuda", gh.dtype == torch.int8)
    return out


def _best_from_records(rec: torch.Tensor, is_cat_pf: torch.Tensor,
                       B: int) -> dict:
    """Candidate records [L, 16] -> the find_best_splits dict (the
    postlude of pallas_histogram.py:662, in torch)."""
    gain = rec[:, 0].contiguous()
    feat = rec[:, 1].to(torch.int32)
    thr = rec[:, 2].to(torch.int32)
    is_cat_split = is_cat_pf.to(torch.bool)[feat.long()]
    iota = torch.arange(B, dtype=torch.int32, device=rec.device)
    member = ((iota[None, :] == thr[:, None]) & is_cat_split[:, None]
              & torch.isfinite(gain)[:, None])
    return {
        "gain": gain,
        "feature": feat,
        "threshold": thr,
        "default_left": rec[:, 3] == 1.0,
        "left_sum": rec[:, 4:7].contiguous(),
        "right_sum": rec[:, 7:10].contiguous(),
        "left_out": rec[:, 10].contiguous(),
        "right_out": rec[:, 11].contiguous(),
        "is_cat_split": is_cat_split,
        "cat_bitset": pack_member_bitset(member),
        "slot_totals": rec[:, 12:15].contiguous(),
    }


def fused_build_best_splits_plain(bins, gh, row_leaf, leaf_ids, *,
                                  num_bins: int, params, num_bins_pf,
                                  nan_bin_pf, is_cat_pf, feature_mask=None,
                                  mono_type=None, leaf_lo=None,
                                  leaf_hi=None, parent_output=None,
                                  mono_pen=None, quant_scales=None,
                                  hist_dtype: str = "bfloat16",
                                  num_rows=None, emit_hist: bool = False,
                                  row_gather=None):
    """Plain version of B2: the lattice + first-max over the plain
    histogram. ``slot_totals`` are feature 0's lattice totals, as the
    fused kernel reports them."""
    quant = gh.dtype == torch.int8
    if quant and quant_scales is None:
        raise ValueError("int8 gh requires quant_scales")
    hist = build_histograms(bins, gh, row_leaf, leaf_ids,
                            num_bins=num_bins, hist_dtype=hist_dtype,
                            row_gather=row_gather, num_rows=num_rows)
    use_mono = mono_type is not None
    lat = eval_split_lattice(
        hist, num_bins_pf, nan_bin_pf, is_cat_pf, params,
        feature_mask=feature_mask, mono_type=mono_type,
        leaf_lo=leaf_lo if use_mono else None,
        leaf_hi=leaf_hi if use_mono else None,
        parent_output=(parent_output if params.path_smooth > 0.0
                       else None),
        mono_pen=(mono_pen if use_mono and params.monotone_penalty > 0.0
                  else None),
        quant_scales=quant_scales if quant else None)
    L, F, B, _ = hist.shape
    best_idx = torch.argmax(lat["net"].reshape(L, F * B * 2), dim=1)
    best = _winner_fields(lat, best_idx, B)
    best["slot_totals"] = lat["totals"][:, 0, :].to(torch.float32)
    return best, (hist if emit_hist else None)


def fused_build_best_splits(bins: torch.Tensor, gh: torch.Tensor,
                            row_leaf: torch.Tensor, leaf_ids: torch.Tensor,
                            *, num_bins: int, params, num_bins_pf,
                            nan_bin_pf, is_cat_pf, feature_mask=None,
                            mono_type=None, leaf_lo=None, leaf_hi=None,
                            parent_output=None, mono_pen=None,
                            quant_scales=None, hist_dtype: str = "bfloat16",
                            num_rows=None, emit_hist: bool = False,
                            row_gather=None):
    """B2: build the histograms AND find each slot's best split (the
    ``fused_build_best_splits`` contract of pallas_histogram.py:460,
    plus ``row_gather``). Returns ``(best, hist)``: ``best`` is the
    find_best_splits dict plus ``slot_totals`` [L, 3]; ``hist`` is the
    [L, F, B, 3] histogram when ``emit_hist`` else None.

    On CUDA this is B1's accumulation (the slot-ordered pre-pass, the
    work items, the slot reduction), then the epilogue kernel (one
    block per slot, one warp per feature), and the tiny cross-record
    postlude in torch."""
    kw = dict(num_bins=num_bins, params=params, num_bins_pf=num_bins_pf,
              nan_bin_pf=nan_bin_pf, is_cat_pf=is_cat_pf,
              feature_mask=feature_mask, mono_type=mono_type,
              leaf_lo=leaf_lo, leaf_hi=leaf_hi,
              parent_output=parent_output, mono_pen=mono_pen,
              quant_scales=quant_scales, hist_dtype=hist_dtype,
              num_rows=num_rows, emit_hist=emit_hist,
              row_gather=row_gather)
    if gh.device.type == "cpu":
        return fused_build_best_splits_plain(bins, gh, row_leaf, leaf_ids,
                                             **kw)
    dev = gh.device
    quant = gh.dtype == torch.int8
    if quant and quant_scales is None:
        raise ValueError("int8 gh requires quant_scales")
    F = bins.shape[1]
    L = leaf_ids.shape[0]
    B = int(num_bins)
    use_mono = mono_type is not None
    use_smooth = params.path_smooth > 0.0
    pen_on = use_mono and params.monotone_penalty > 0.0
    i32 = torch.int32
    nbpf = num_bins_pf.to(device=dev, dtype=i32).contiguous()
    nan = nan_bin_pf.to(device=dev, dtype=i32).contiguous()
    cat = is_cat_pf.to(device=dev, dtype=i32).contiguous()
    for t, n in ((nbpf, "num_bins_pf"), (nan, "nan_bin_pf"),
                 (cat, "is_cat_pf")):
        _require(t, n, i32, dev, (F,))
    fmask = None
    fmask_2d = 0
    if feature_mask is not None:
        fmask = feature_mask.to(device=dev, dtype=torch.uint8).contiguous()
        fmask_2d = int(fmask.dim() == 2)
        _require(fmask, "feature_mask", torch.uint8, dev,
                 (L, F) if fmask_2d else (F,))

    def _lvec(a, name):
        if a is None:
            return None
        t = a.to(device=dev, dtype=torch.float32).contiguous()
        _require(t, name, torch.float32, dev, (L,))
        return t
    mono = None
    if use_mono:
        mono = mono_type.to(device=dev, dtype=i32).contiguous()
        _require(mono, "mono_type", i32, dev, (F,))
    lo = _lvec(leaf_lo, "leaf_lo") if use_mono else None
    hi = _lvec(leaf_hi, "leaf_hi") if use_mono else None
    po = _lvec(parent_output, "parent_output") if use_smooth else None
    pen = _lvec(mono_pen, "mono_pen") if pen_on else None
    if use_mono and (lo is None or hi is None):
        raise ValueError("mono_type needs leaf_lo and leaf_hi")
    if use_smooth and po is None:
        raise ValueError("path_smooth needs parent_output")
    if pen_on and pen is None:
        raise ValueError("monotone_penalty needs mono_pen")
    qs = None
    if quant:
        # [2] shared by every slot, or [L, 2] per slot (the class-batched
        # build folds each class's scales into its slots)
        qs = quant_scales.to(device=dev, dtype=torch.float32).reshape(-1, 2)
        qs = qs.expand(L, 2).contiguous()
        _require(qs, "quant_scales", torch.float32, dev, (L, 2))

    hist = _launch_hist(bins, gh, row_leaf, leaf_ids, B, hist_dtype,
                        row_gather, num_rows)
    rec = torch.empty((L, _REC), dtype=torch.float32, device=dev)
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    sp = params
    err = lib.lgbt_split_epilogue(
        hist.data_ptr(), int(quant), nbpf.data_ptr(), nan.data_ptr(),
        cat.data_ptr(), _ptr(fmask), fmask_2d, _ptr(mono), _ptr(lo),
        _ptr(hi), _ptr(po), _ptr(pen), _ptr(qs), rec.data_ptr(), L, F, B,
        int(use_mono), int(use_smooth), int(pen_on), sp.lambda_l1,
        sp.lambda_l2, sp.max_delta_step, sp.path_smooth,
        sp.min_data_in_leaf, sp.min_sum_hessian_in_leaf,
        sp.min_gain_to_split, stream)
    _check(err, "split epilogue")
    _count("fused_build_best_splits", quant)
    return _best_from_records(rec, cat, B), (hist if emit_hist else None)


def build_root_histograms_classes_plain(bins, gh_k, row_leaf, *,
                                        num_bins: int,
                                        hist_dtype: str = "bfloat16",
                                        root_slot: int = 0):
    """Plain version of B3: ``build_histograms`` on the root slot, once
    per class, stacked."""
    ids = torch.tensor([root_slot], dtype=torch.int32, device=gh_k.device)
    return torch.stack([
        build_histograms(bins, gh_k[k], row_leaf, ids, num_bins=num_bins,
                         hist_dtype=hist_dtype)[0]
        for k in range(gh_k.shape[0])])


def build_root_histograms_classes(bins: torch.Tensor, gh_k: torch.Tensor,
                                  row_leaf: torch.Tensor, *, num_bins: int,
                                  hist_dtype: str = "bfloat16",
                                  root_slot: int = 0,
                                  plan: Optional[dict] = None,
                                  mtiles: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """B3: the root histograms of all K classes with one pass over
    ``bins`` (the ``build_root_histograms_classes`` contract of
    pallas_histogram.py:766). bins [R, F] uint8 (int16 or int32 for
    wide bins), gh_k [K, R, 3] f32
    (addends rounded to ``hist_dtype``) or int8 (exact int32), row_leaf
    [R] int32 (rows equal to ``root_slot`` count, padded rows are -1)
    -> [K, F, B, 3] float32 or int32.

    On CUDA: one launch of the tensor-core kernel (a one-hot product per
    feature on bf16 ``mma.sync``; plan :func:`class_mma_plan`) and one of
    B1's chunk reduction. int8 is exact; f32 sums in another order than
    the plain version and B1 (within rtol 1e-4 of a channel's scale),
    the same order on every launch. ``plan`` replaces class_mma_plan's
    default one; ``mtiles``, an [F] int64 tensor on the card, gets the
    kernel's count of 16-bin M-tiles issued per feature, summed over
    16-row steps and class tiles (each counts ``n_tiles`` x ``terms``
    products). Both are card-only."""
    kw = dict(num_bins=num_bins, hist_dtype=hist_dtype, root_slot=root_slot)
    if gh_k.device.type == "cpu":
        if plan is not None or mtiles is not None:
            raise ValueError("plan and mtiles apply to the CUDA kernel only")
        return build_root_histograms_classes_plain(bins, gh_k, row_leaf,
                                                   **kw)
    dev = gh_k.device
    K, R = int(gh_k.shape[0]), int(gh_k.shape[1])
    F = bins.shape[1]
    B = int(num_bins)
    quant = gh_k.dtype == torch.int8
    _require_bins(bins, dev, (R, F))
    _require(gh_k, "gh_k", torch.int8 if quant else torch.float32, dev,
             (K, R, HIST_CH))
    _require(row_leaf, "row_leaf", torch.int32, dev, (R,))
    if not quant and hist_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"hist_dtype {hist_dtype!r} is not supported by "
                         "the CUDA kernel")
    mode = "int8" if quant else hist_dtype
    acc_dt = torch.int32 if quant else torch.float32
    n_sm, smem_max, smem_sm = _device_props(dev)
    if plan is None:
        plan = class_mma_plan(F, K, B, R, mode, smem_max, smem_sm, n_sm,
                              bin_bytes=bins.element_size())
    elif plan["bin_bytes"] != bins.element_size():
        raise ValueError("the plan's bin_bytes differs from the bins'")
    if mtiles is not None:
        _require(mtiles, "mtiles", torch.int64, dev, (F,))
    partial = torch.empty((plan["n_chunks"], F, K, B, HIST_CH),
                          dtype=acc_dt, device=dev)
    out = torch.empty((K, F, B, HIST_CH), dtype=acc_dt, device=dev)
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.lgbt_class_hist(
        bins.data_ptr(), bins.element_size(), gh_k.data_ptr(),
        _CLASS_MODES[mode], row_leaf.data_ptr(), partial.data_ptr(),
        out.data_ptr(), _ptr(mtiles), F, K, R,
        B, int(root_slot), plan["fc"], plan["kc"], plan["wpf"],
        plan["mtb"], plan["n_btiles"],
        plan["n_ftiles"], plan["n_ktiles"], plan["n_chunks"],
        plan["tile_rows"], plan["threads"], plan["smem"], stream)
    _check(err, "class root histogram")
    _count("build_root_histograms_classes", quant)
    return out
