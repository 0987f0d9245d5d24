"""PyTorch port on the card: the CUDA kernels B1, B2 and B3 against
their plain PyTorch versions on the same CUDA tensors, and small
training runs through the kernels (binary, and class-batched
multiclass); the captured step against the eager loop, with no host
sync, for each training path (GOSS, quantized, the regression
objectives among them); quantized leaf renewal bit-identical between
two runs; the threefry port's bits on the card equal to the CPU's; the
predict and serving path (tensorized leaves, sessions and early stop,
a PredictionServer) on the card against the CPU; the three kernels on
wide (int16 and int32) bin columns, training at max_bin 511 and over a
wide bundle plan, and linear trees, on the card against the CPU; a
custom objective, continued training, ``refit`` and ``cv`` on the card
against the CPU; B1 with a carried accumulator, a chunked (out-of-core)
run, and resume and rollback through the captured step; a telemetry
``/trace`` window opened while the step captures, and no cyclic
collection inside a capture.
Marked ``cuda``; every test skips where torch
sees no CUDA device. Run on a GPU host with
``python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest``
(the suite's conftest imports jax, which a GPU host need not have;
this file needs only torch and numpy)."""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops import cuda_histogram as CH
from lightgbm_tpu_torch.ops.histogram import build_histograms
from lightgbm_tpu_torch.ops.split import SplitParams, find_best_splits

pytestmark = pytest.mark.cuda

R, F, B, L = 4096, 8, 16, 6


@pytest.fixture
def rng():
    return np.random.RandomState(42)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


def _stream(rng, dev, quant=False):
    bins = rng.randint(0, B - 1, size=(R, F)).astype(np.uint8)
    bins[rng.rand(R) < 0.1, 2] = B - 1
    rl = rng.randint(-1, L, size=R).astype(np.int32)
    if quant:
        gh = np.stack([rng.randint(-3, 4, size=R), rng.randint(0, 5, size=R),
                       np.ones(R)], 1).astype(np.int8)
    else:
        g = rng.normal(size=R).astype(np.float32)
        gh = np.stack([g, np.abs(g) + 0.5, np.ones(R, np.float32)], 1)
    return [torch.from_numpy(a).to(dev)
            for a in (bins, gh, rl, np.arange(L, dtype=np.int32))]


@pytest.mark.parametrize("case", ["f32", "bf16", "int8", "compacted"])
def test_b1_kernel_matches_plain(rng, dev, case):
    bins, gh, rl, ids = _stream(rng, dev, quant=case == "int8")
    hd = "float32" if case == "f32" else "bfloat16"
    kw = {}
    if case == "compacted":
        perm = torch.randperm(R, device=dev).to(torch.int32)
        n = torch.tensor(R // 3, dtype=torch.int32, device=dev)
        rl = torch.where(torch.arange(R, device=dev) < n, rl[perm.long()],
                         -1).to(torch.int32)
        gh = gh[perm.long()].contiguous()
        kw = dict(row_gather=perm, num_rows=n)
    before = CH.LAUNCHES["build_histograms_cuda"]
    got = CH.build_histograms_cuda(bins, gh, rl, ids, num_bins=B,
                                   hist_dtype=hd, **kw)
    again = CH.build_histograms_cuda(bins, gh, rl, ids, num_bins=B,
                                     hist_dtype=hd, **kw)
    want = build_histograms(bins, gh, rl, ids, num_bins=B, hist_dtype=hd,
                            **kw)
    assert CH.LAUNCHES["build_histograms_cuda"] == before + 2
    assert torch.equal(got, again)               # fixed summation order
    if case == "int8":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("quant", [False, True])
def test_b2_kernel_matches_plain(rng, dev, quant):
    bins, gh, rl, ids = _stream(rng, dev, quant)
    meta = dict(
        num_bins_pf=torch.full((F,), B, dtype=torch.int32, device=dev),
        nan_bin_pf=torch.tensor(np.where(np.arange(F) == 2, B - 1, -1),
                                dtype=torch.int32, device=dev),
        is_cat_pf=torch.tensor(np.arange(F) == 5, device=dev))
    if quant:
        meta["quant_scales"] = torch.tensor([0.25, 0.5], device=dev)
    sp = SplitParams(min_data_in_leaf=5)
    got, gh_ = CH.fused_build_best_splits(bins, gh, rl, ids, num_bins=B,
                                          params=sp, hist_dtype="float32",
                                          emit_hist=True, **meta)
    # the plain version on CPU copies of the same inputs: on the card its
    # index_add_ sums with atomics, in an order that changes between calls
    want, wh = CH.fused_build_best_splits_plain(
        *(t.cpu() for t in (bins, gh, rl, ids)), num_bins=B, params=sp,
        hist_dtype="float32", emit_hist=True,
        **{k: v.cpu() for k, v in meta.items()})
    for k in want:
        if want[k].dtype.is_floating_point:
            torch.testing.assert_close(got[k].cpu(), want[k], rtol=3e-6,
                                       atol=3e-5)
        else:
            assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.parametrize("quant", [False, True])
def test_b2_kernel_matches_plain_at_ranking_width(rng, dev, quant):
    """B2 at the MS LTR-shaped ranking cell's width, F = 137 dense
    columns of B = 255 bins, over 21 leaf slots, against its plain
    version on CPU copies of the same inputs."""
    R_, F_, B_, L_ = 30000, 137, 255, 21
    bins = torch.from_numpy(rng.randint(0, B_, size=(R_, F_))
                            .astype(np.uint8)).to(dev)
    rl = torch.from_numpy(rng.randint(-1, L_, size=R_)
                          .astype(np.int32)).to(dev)
    ids = torch.arange(L_, dtype=torch.int32, device=dev)
    if quant:
        gh = np.stack([rng.randint(-3, 4, size=R_), rng.randint(0, 5, size=R_),
                       np.ones(R_)], 1).astype(np.int8)
    else:
        g = rng.normal(size=R_).astype(np.float32)
        gh = np.stack([g, np.abs(g) + 0.5, np.ones(R_, np.float32)], 1)
    gh = torch.from_numpy(gh).to(dev)
    meta = dict(num_bins_pf=torch.full((F_,), B_, dtype=torch.int32,
                                       device=dev),
                nan_bin_pf=torch.full((F_,), -1, dtype=torch.int32,
                                      device=dev),
                is_cat_pf=torch.zeros(F_, dtype=torch.bool, device=dev))
    if quant:
        meta["quant_scales"] = torch.tensor([0.25, 0.5], device=dev)
    sp = SplitParams(min_data_in_leaf=20)
    got, gh_ = CH.fused_build_best_splits(bins, gh, rl, ids, num_bins=B_,
                                          params=sp, hist_dtype="float32",
                                          emit_hist=True, **meta)
    want, wh = CH.fused_build_best_splits_plain(
        *(t.cpu() for t in (bins, gh, rl, ids)), num_bins=B_, params=sp,
        hist_dtype="float32", emit_hist=True,
        **{k: v.cpu() for k, v in meta.items()})
    if quant:
        assert torch.equal(gh_.cpu(), wh)
    else:
        torch.testing.assert_close(gh_.cpu(), wh, rtol=3e-6, atol=3e-5)
    for k in want:
        if want[k].dtype.is_floating_point:
            torch.testing.assert_close(got[k].cpu(), want[k], rtol=3e-6,
                                       atol=3e-5)
        else:
            assert torch.equal(got[k].cpu(), want[k]), k


def _slot_case(rng, dev, case, quant):
    """Streams that stress the slot-segmented accumulation: a column with
    95% of its rows in one bin; the Higgs root's 41 dead slots beside
    one live one; the class-batched 147 folded slots at F = 54, B = 253;
    a compacted stream with num_rows = 0; and dead rows interleaved in a
    compacted stream's live prefix."""
    R_, F_, B_ = dict(one_bin=(20000, 6, 32), dead_slots=(50000, 28, 63),
                      slots147=(60000, 54, 253), num_rows0=(5000, 8, 16),
                      dead_interleaved=(30000, 9, 40))[case]
    bins = rng.randint(0, B_, size=(R_, F_)).astype(np.uint8)
    kw = {}
    if case == "one_bin":
        bins[rng.rand(R_) < 0.95, 1] = 7
        ids = np.array([4, 0, -2, 2, 1], np.int32)
        rl = rng.randint(-1, 5, size=R_).astype(np.int32)
    elif case == "dead_slots":
        ids = np.full(42, -2, np.int32)
        ids[0] = 0
        rl = np.zeros(R_, np.int32)
        rl[rng.rand(R_) < 0.01] = -1
    elif case == "slots147":
        ids = (np.arange(7)[:, None] * 256
               + np.arange(21)[None, :]).reshape(-1).astype(np.int32)
        rl = (rng.randint(0, 7, R_) * 256
              + rng.randint(0, 42, R_)).astype(np.int32)   # half in ids
        rl[rng.rand(R_) < 0.05] = -1
    else:
        ids = np.array([3, 1, -2, 0], np.int32)
        rl = rng.randint(0, 6, size=R_).astype(np.int32)
        gather = rng.permutation(R_).astype(np.int32)
        n = 0 if case == "num_rows0" else R_ // 2
        rl = np.where(np.arange(R_) < n, rl[gather], -1).astype(np.int32)
        if case == "dead_interleaved":
            rl[:n][rng.rand(n) < 0.3] = -1
        kw = dict(row_gather=torch.from_numpy(gather).to(dev),
                  num_rows=torch.tensor(n, dtype=torch.int32, device=dev))
    if quant:
        gh = np.stack([rng.randint(-3, 4, size=R_), rng.randint(0, 5, R_),
                       np.ones(R_)], 1).astype(np.int8)
    else:
        g = rng.normal(size=R_).astype(np.float32)
        gh = np.stack([g, np.abs(g) + 0.5, np.ones(R_, np.float32)], 1)
    t = [torch.from_numpy(a).to(dev) for a in (bins, gh, rl, ids)]
    return t, kw, B_


@pytest.mark.parametrize("hd", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", ["one_bin", "dead_slots", "slots147",
                                  "num_rows0", "dead_interleaved"])
def test_b1_slot_segmented_streams(rng, dev, case, hd):
    (bins, gh, rl, ids), kw, B_ = _slot_case(rng, dev, case, hd == "int8")
    hd = "bfloat16" if hd == "int8" else hd
    got = CH.build_histograms_cuda(bins, gh, rl, ids, num_bins=B_,
                                   hist_dtype=hd, **kw)
    again = CH.build_histograms_cuda(bins, gh, rl, ids, num_bins=B_,
                                     hist_dtype=hd, **kw)
    want = build_histograms(bins, gh, rl, ids, num_bins=B_, hist_dtype=hd,
                            **kw)
    assert torch.equal(got, again)               # fixed summation order
    if gh.dtype == torch.int8:
        assert got.dtype == torch.int32 and torch.equal(got, want)
    else:
        _close_to_channel_scale(got, want)
    if case == "num_rows0":
        assert not got.any()


@pytest.mark.parametrize("hd", ["float32", "int8"])
@pytest.mark.parametrize("nb", [253, 256])
def test_b1_bundle_lattice_edge(rng, dev, nb, hd):
    """B1 at the EFB bundle lattice's edge: 12 uint8 columns whose values
    reach nb - 1 (255 at nb = 256), 42 slots, against the plain version;
    the shared-memory fit holds as many warps at 256 bins as at 253."""
    assert (CH.slot_hist_plan(12, 42, 256, 1 << 16)["warps"]
            == CH.slot_hist_plan(12, 42, 253, 1 << 16)["warps"])
    Rb = 1 << 16
    bins = rng.randint(0, nb, size=(Rb, 12)).astype(np.uint8)
    bins[rng.rand(Rb) < 0.2, 3] = nb - 1
    rl = rng.randint(-1, 42, size=Rb).astype(np.int32)
    if hd == "int8":
        gh = np.stack([rng.randint(-3, 4, size=Rb), rng.randint(0, 5, size=Rb),
                       np.ones(Rb)], 1).astype(np.int8)
    else:
        g = rng.normal(size=Rb).astype(np.float32)
        gh = np.stack([g, np.abs(g) + 0.5, np.ones(Rb, np.float32)], 1)
    t = [torch.from_numpy(a).to(dev)
         for a in (bins, gh, rl, np.arange(42, dtype=np.int32))]
    got = CH.build_histograms_cuda(*t, num_bins=nb, hist_dtype="float32")
    want = build_histograms(*t, num_bins=nb, hist_dtype="float32")
    assert got.shape == (42, 12, nb, 3)
    assert got[:, 3, nb - 1, 2].sum() > 0       # the top bin is counted
    if hd == "int8":
        assert torch.equal(got, want)
    else:
        _close_to_channel_scale(got, want)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("case", ["one_bin", "dead_slots", "slots147",
                                  "num_rows0", "dead_interleaved"])
def test_b2_slot_segmented_streams(rng, dev, case, quant):
    """B2 on the same streams: its histogram as B1's test holds it, and
    its winners those of find_best_splits over that histogram."""
    (bins, gh, rl, ids), kw, B_ = _slot_case(rng, dev, case, quant)
    F_ = bins.shape[1]
    meta = dict(
        num_bins_pf=torch.full((F_,), B_, dtype=torch.int32, device=dev),
        nan_bin_pf=torch.full((F_,), -1, dtype=torch.int32, device=dev),
        is_cat_pf=torch.zeros(F_, dtype=torch.bool, device=dev))
    qs = torch.tensor([0.25, 0.5], device=dev) if quant else None
    sp = SplitParams(min_data_in_leaf=20)
    runs = [CH.fused_build_best_splits(
        bins, gh, rl, ids, num_bins=B_, params=sp, hist_dtype="float32",
        emit_hist=True, quant_scales=qs, **meta, **kw) for _ in range(2)]
    (best, hist), (best2, hist2) = runs
    assert torch.equal(hist, hist2)
    want_h = build_histograms(bins, gh, rl, ids, num_bins=B_,
                              hist_dtype="float32", **kw)
    if quant:
        assert torch.equal(hist, want_h)
    else:
        _close_to_channel_scale(hist, want_h)
    want = find_best_splits(hist, meta["num_bins_pf"], meta["nan_bin_pf"],
                            meta["is_cat_pf"], sp, quant_scales=qs)
    for k in want:
        assert torch.equal(best[k], best2[k]), k
    _assert_winners_close(best, want)


def _assert_winners_close(best, want):
    """The epilogue's f32 arithmetic and the plain version's may part at
    a near tie (random gradients make many): there the winners may
    differ, with gains equal within 1e-5 of the largest gain."""
    same = ((best["feature"] == want["feature"])
            & (best["threshold"] == want["threshold"])
            & (best["default_left"] == want["default_left"]))
    fin = torch.isfinite(want["gain"])
    assert torch.equal(torch.isfinite(best["gain"]), fin)
    if bool(fin.any()):
        tol = 1e-5 * float(want["gain"][fin].abs().max())
        assert float((best["gain"] - want["gain"])[fin].abs().max()) <= tol
    for k in want:
        got_k, want_k = best[k][same], want[k][same]
        if want_k.dtype.is_floating_point:      # prefix sums of 20k+ rows
            torch.testing.assert_close(got_k, want_k, rtol=1e-5, atol=1e-4)
        else:
            assert torch.equal(got_k, want_k), k


@pytest.mark.parametrize("case", ["per_slot", "slots147"])
def test_b2_int8_per_slot_scales_match_plain(rng, dev, case):
    """B2's epilogue descales each slot by its own row of [L, 2] scales:
    6 slots with six scales, and the class-batched 147 folded slots with
    seven classes' scales repeated over each class's 21 slots (slot s,
    class s // 21); against the plain version on CPU copies."""
    if case == "per_slot":
        bins, gh, rl, ids = _stream(rng, dev, quant=True)
        kw, B_ = {}, B
        qs = np.stack([0.05 * 2.0 ** np.arange(L),
                       0.4 / (1.0 + np.arange(L))], 1)
    else:
        (bins, gh, rl, ids), kw, B_ = _slot_case(rng, dev, case, True)
        qs = np.repeat(np.stack([0.01 * 2.0 ** np.arange(7),
                                 0.2 / (1.0 + np.arange(7))], 1), 21, 0)
    qs = torch.tensor(qs, dtype=torch.float32, device=dev)
    F_ = bins.shape[1]
    meta = dict(
        num_bins_pf=torch.full((F_,), B_, dtype=torch.int32, device=dev),
        nan_bin_pf=torch.full((F_,), -1, dtype=torch.int32, device=dev),
        is_cat_pf=torch.zeros(F_, dtype=torch.bool, device=dev),
        quant_scales=qs)
    sp = SplitParams(min_data_in_leaf=5, lambda_l2=0.5)
    got, hist = CH.fused_build_best_splits(bins, gh, rl, ids, num_bins=B_,
                                           params=sp, emit_hist=True,
                                           **meta, **kw)
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}   # noqa: E731
    want, wh = CH.fused_build_best_splits_plain(
        *(t.cpu() for t in (bins, gh, rl, ids)), num_bins=B_, params=sp,
        emit_hist=True, **cpu(meta), **cpu(kw))
    assert torch.equal(hist.cpu(), wh)
    # the plain version with one scale for every slot finds other gains:
    # the comparison sees a wrong slot-to-scale map
    other, _ = CH.fused_build_best_splits_plain(
        *(t.cpu() for t in (bins, gh, rl, ids)), num_bins=B_, params=sp,
        **cpu(dict(meta, quant_scales=qs[0])), **cpu(kw))
    fin = torch.isfinite(want["gain"])
    assert not torch.equal(other["gain"][fin], want["gain"][fin])
    _assert_winners_close(cpu(got), want)


def test_wrappers_raise_on_bad_operands(dev):
    # the kernels read uint8, int16 and int32 bins; a float matrix raises
    bins = torch.zeros((64, 4), dtype=torch.float32, device=dev)
    gh = torch.zeros((64, 3), device=dev)
    rl = torch.zeros(64, dtype=torch.int32, device=dev)
    ids = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="uint8"):
        CH.build_histograms_cuda(bins, gh, rl, ids, num_bins=8)


def test_training_on_card_matches_cpu(rng, dev):
    X = rng.normal(size=(6000, 6))
    y = (X[:, 0] + X[:, 1] ** 2 > 1).astype(float)
    p = {"objective": "binary", "num_leaves": 15, "max_bin": 32,
         "verbosity": -1}
    gpu = lgt.train(p, lgt.Dataset(X, label=y), 3)
    cpu = lgt.train({**p, "device_type": "cpu"},
                    lgt.Dataset(X, label=y, params={"device_type": "cpu"}), 3)
    np.testing.assert_allclose(gpu.predict(X), cpu.predict(X), atol=1e-5)


def _close_to_channel_scale(got, want, rtol=1e-4):
    """|got - want| <= rtol * (|want| + the channel's largest |want|):
    the kernel sums in another order than the plain version."""
    g, w = got.double(), want.double()
    scale = w.abs().amax(dim=tuple(range(w.dim() - 1)), keepdim=True)
    assert bool(((g - w).abs() <= rtol * (w.abs() + scale)).all())


def _b3_case(rng, dev, case, R_, F_, K_, B_, onehot=()):
    bins = rng.randint(0, B_, size=(R_, F_)).astype(np.uint8)
    for f in onehot:                              # a two-bin column
        bins[:, f] = rng.rand(R_) < 0.2
    rl = np.zeros(R_, np.int32)
    rl[-min(100, R_ // 4):] = -1
    rl[rng.rand(R_) < 0.05] = 2
    if case == "int8":
        gh = rng.randint(-128, 128, size=(K_, R_, 3)).astype(np.int8)
    else:
        gh = rng.normal(size=(K_, R_, 3)).astype(np.float32)
        gh[..., 1] = np.abs(gh[..., 1]) + 0.5
    return [torch.from_numpy(a).to(dev) for a in (bins, gh, rl)]


def _check_b3(bins, gh, rl, case, B_, root_ids=None):
    hd = "float32" if case == "f32" else "bfloat16"
    before = CH.LAUNCHES["build_root_histograms_classes"]
    got = CH.build_root_histograms_classes(bins, gh, rl, num_bins=B_,
                                           hist_dtype=hd)
    again = CH.build_root_histograms_classes(bins, gh, rl, num_bins=B_,
                                             hist_dtype=hd)
    want = CH.build_root_histograms_classes_plain(bins, gh, rl,
                                                  num_bins=B_, hist_dtype=hd)
    assert CH.LAUNCHES["build_root_histograms_classes"] == before + 2
    assert torch.equal(got, again)               # fixed summation order
    # against the plain version and B1's root launch of each class
    ids = root_ids if root_ids is not None else torch.tensor(
        [0], dtype=torch.int32, device=bins.device)
    b1 = torch.stack([
        CH.build_histograms_cuda(bins, gh[k].contiguous(), rl, ids,
                                 num_bins=B_, hist_dtype=hd)[0]
        for k in range(gh.shape[0])])
    for ref in (want, b1):
        if case == "int8":
            assert got.dtype == torch.int32 and torch.equal(got, ref)
        else:
            _close_to_channel_scale(got, ref)


@pytest.mark.parametrize("case", ["f32", "bf16", "int8"])
def test_b3_kernel_matches_plain(rng, dev, case):
    ids = torch.full((12,), -2, dtype=torch.int32, device=dev)
    ids[0] = 0
    _check_b3(*_b3_case(rng, dev, case, R, F, 5, B), case, B, ids)


@pytest.mark.parametrize("case", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("shape", [
    "B37", "K1", "K11", "rows_ragged", "onehot_beside_wide"])
def test_b3_kernel_awkward_shapes(rng, dev, case, shape):
    """B not a multiple of 16, one class (one N-tile), eleven classes
    (two class tiles), a row count not a multiple of 16, and a two-bin
    column beside a 256-bin one (M-tile skipping in one block)."""
    R_, F_, K_, B_, onehot = dict(
        B37=(3000, 7, 4, 37, ()),
        K1=(3000, 5, 1, 63, ()),
        K11=(2000, 6, 11, 40, ()),
        rows_ragged=(2999, 5, 3, 16, ()),
        onehot_beside_wide=(5000, 4, 7, 256, (1, 2)))[shape]
    _check_b3(*_b3_case(rng, dev, case, R_, F_, K_, B_, onehot), case, B_)


def test_b3_counts_mtiles_and_takes_a_plan(rng, dev):
    """The kernel's own M-tile count: one 16-bin tile a 16-row step for a
    two-bin column, all 16 for a column that spans 256 bins in every
    tile; a plan of another block width and chain length gives the same
    int8 sums."""
    R_, F_, K_, B_ = 4096, 3, 7, 256              # whole 256-row tiles
    bins, gh, rl = _b3_case(rng, dev, "int8", R_, F_, K_, B_, (1,))
    bins[:, 2] = (torch.arange(R_, device=dev) % 256).to(torch.uint8)
    tiles = torch.zeros(F_, dtype=torch.int64, device=dev)
    got = CH.build_root_histograms_classes(bins, gh, rl, num_bins=B_,
                                           mtiles=tiles)
    steps = R_ // 16
    assert tiles.tolist()[1:] == [steps, 16 * steps]
    plan = CH.class_mma_plan(F_, K_, B_, R_, "int8", warps=16, steps=32)
    other = CH.build_root_histograms_classes(bins, gh, rl, num_bins=B_,
                                             plan=plan)
    assert torch.equal(got, other)


def test_class_batched_training_on_card(rng, dev):
    X = rng.normal(size=(6000, 6))
    y = (X[:, :3] + 0.5 * rng.normal(size=(6000, 3))).argmax(1).astype(float)
    p = {"objective": "multiclass", "num_class": 3, "num_leaves": 15,
         "max_bin": 32, "verbosity": -1}
    CH.reset_launch_counts()
    gpu = lgt.train(p, lgt.Dataset(X, label=y), 3)
    assert gpu._gbdt.class_batch_ok
    assert CH.LAUNCHES["build_root_histograms_classes"] == 3
    seq = lgt.train({**p, "class_batch": "off"}, lgt.Dataset(X, label=y), 3)
    cpu = lgt.train({**p, "device_type": "cpu"},
                    lgt.Dataset(X, label=y, params={"device_type": "cpu"}), 3)
    assert gpu.predict(X).shape == (6000, 3)
    np.testing.assert_allclose(gpu.predict(X), cpu.predict(X), atol=1e-5)
    np.testing.assert_allclose(seq.predict(X), cpu.predict(X), atol=1e-5)


# -- the training step: one CUDA-graph replay per iteration ------------------

_STEP_BINARY = {"objective": "binary", "metric": "auc", "num_leaves": 15,
                "leaf_batch": 4, "max_bin": 32, "verbosity": -1}
_STEP_MULTI = {**_STEP_BINARY, "objective": "multiclass", "num_class": 3,
               "metric": "multi_logloss"}
_QUANT = {"use_quantized_grad": True}
STEP_CASES = {
    "higgs_b2": _STEP_BINARY,
    "higgs_b1": {**_STEP_BINARY, "fused_split": "off"},
    "class_batched": _STEP_MULTI,
    "per_class": {**_STEP_MULTI, "class_batch": "off"},
    "bagging": {**_STEP_BINARY, "bagging_freq": 2, "bagging_fraction": 0.7,
                "feature_fraction": 0.8},
    # GOSS from iteration 2 on: two graphs, one each side of the start
    "goss": {**_STEP_BINARY, "data_sample_strategy": "goss",
             "learning_rate": 0.5},
    "quantized": {**_STEP_BINARY, **_QUANT},
    "quantized_b1_renew": {**_STEP_BINARY, **_QUANT, "fused_split": "off",
                           "quant_train_renew_leaf": True},
    "quantized_class_batched": {**_STEP_MULTI, **_QUANT},
    "regression_l1": {**_STEP_BINARY, "objective": "regression_l1",
                      "metric": "l1"},
    "poisson": {**_STEP_BINARY, "objective": "poisson", "metric": "poisson"},
    "quantile": {**_STEP_BINARY, "objective": "quantile", "alpha": 0.3,
                 "metric": "quantile"},
    # EFB: one-hot blocks bundled, B1 in bundle space (class-batched: no
    # B3); sorted-subset categoricals through B1 (and B3 at the
    # class-batched root)
    "efb_binary": _STEP_BINARY,
    "efb_class_batched": _STEP_MULTI,
    "efb_quantized_class_batched": {**_STEP_MULTI, **_QUANT},
    "cat_sorted_class_batched": {**_STEP_MULTI, "categorical_feature": "4"},
    "cat_sorted_quantized": {**_STEP_BINARY, **_QUANT,
                             "categorical_feature": "4"},
    # both under GOSS, crossing its start (iteration 2)
    "efb_goss": {**_STEP_BINARY, "data_sample_strategy": "goss",
                 "learning_rate": 0.5},
    "cat_sorted_goss_class_batched": {
        **_STEP_MULTI, "categorical_feature": "4",
        "data_sample_strategy": "goss", "learning_rate": 0.5},
    # ranking: queries of 50 rows (_step_dataset), the query lattice in
    # the graph; rank_xendcg draws from the iteration number on the card
    "rank_lambdarank": {**_STEP_BINARY, "objective": "lambdarank",
                        "metric": "ndcg"},
    "rank_xendcg": {**_STEP_BINARY, "objective": "rank_xendcg",
                    "metric": "ndcg"},
    "rank_bagging_by_query": {**_STEP_BINARY, "objective": "lambdarank",
                              "metric": "ndcg", "bagging_freq": 2,
                              "bagging_fraction": 0.7,
                              "bagging_by_query": True},
    # the builder options: per-node masks through B2, extra-trees and
    # gain scales through B1, the draws keyed by the iteration on the
    # card; intermediate and advanced monotone one split a round
    "opts_bynode_interaction": {**_STEP_BINARY,
                                "feature_fraction_bynode": 0.6,
                                "interaction_constraints": [[0, 1, 2],
                                                            [2, 3, 4, 5]]},
    "opts_extra_trees_contri": {**_STEP_BINARY, "extra_trees": True,
                                "feature_contri": [1, .5, 1, .8, 1, .3]},
    "opts_intermediate": {**_STEP_BINARY,
                          "monotone_constraints": [1, 0, 0, -1, 0, 0],
                          "monotone_constraints_method": "intermediate"},
    "opts_advanced": {**_STEP_BINARY,
                      "monotone_constraints": [1, 0, 0, -1, 0, 0],
                      "monotone_constraints_method": "advanced"},
    "opts_bynode_class_batched": {**_STEP_MULTI,
                                  "feature_fraction_bynode": 0.6,
                                  "extra_trees": True},
    # B2 at the class-batched call with per-slot [K*W, F] masks
    "opts_interaction_class_batched": {
        **_STEP_MULTI, "feature_fraction_bynode": 0.6,
        "interaction_constraints": [[0, 1, 2], [2, 3, 4, 5]]},
}


def _step_data(rng, params, n=6000, case=""):
    X = rng.normal(size=(n, 6))
    if case.startswith("efb_"):
        # an 8-way and a 4-way one-hot block, which EFB bundles
        X = np.concatenate([X, np.eye(8)[rng.randint(0, 8, size=n)],
                            np.eye(4)[rng.randint(0, 4, size=n)]], 1)
        X[:, 0] += X[:, 7] - X[:, 15]
    elif case.startswith("cat_"):
        X[:, 4] = rng.randint(0, 30, size=n)      # 30 categories
        X[:, 0] += rng.normal(size=30)[X[:, 4].astype(int)]
    if params["objective"] == "multiclass":
        y = (X[:, :3] + 0.5 * rng.normal(size=(n, 3))).argmax(1)
    else:
        y = X[:, 0] + X[:, 1] ** 2 > 1
    return X, y.astype(float)


def _step_dataset(params, X, y, reference=None):
    """A Dataset of the step tests; ranking objectives get queries of 50
    rows."""
    group = None
    if params["objective"] in ("lambdarank", "rank_xendcg"):
        group = np.full(len(X) // 50, 50)
    if reference is not None:
        return lgt.Dataset(X, label=y, group=group, reference=reference)
    return lgt.Dataset(X, label=y, group=group, params=params)


def _step_gbdt(params, X, y, Xv=None, yv=None):
    tr = _step_dataset(params, X, y)
    b = lgt.Booster(params=params, train_set=tr)
    if Xv is not None:
        b.add_valid(_step_dataset(params, Xv, yv, reference=tr), "v")
    b._ensure_gbdt()
    return b._gbdt


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_captured_step_matches_eager_loop(rng, dev, monkeypatch, case):
    """The captured step (iteration 0 eager, then one replay an
    iteration) against the eager loop: bit-identical trees, train and
    valid scores, and the same kernel launch counts."""
    monkeypatch.delenv("LIGHTGBM_TPU_FUSED_TRAIN", raising=False)
    p = STEP_CASES[case]
    X, y = _step_data(rng, p, case=case)
    runs = {}
    for fused in (True, False):
        CH.reset_launch_counts()
        tr = _step_dataset(p, X[:5000], y[:5000])
        va = _step_dataset(p, X[5000:], y[5000:], reference=tr)
        bst = lgt.train({**p, "fused_train": fused}, tr, 5, valid_sets=[va])
        torch.cuda.synchronize()
        runs[fused] = (bst, dict(CH.LAUNCHES))
    (cap, n_cap), (eag, n_eag) = runs[True], runs[False]
    assert cap._gbdt._graph is not None and eag._gbdt._graph is None
    if case.startswith(("efb_", "cat_")):
        # the two-pass arm: B1 only, and B3 only at a class-batched
        # root of feature-space bins
        assert n_cap["fused_build_best_splits"] == 0
        assert (n_cap["build_root_histograms_classes"] > 0) == (
            case.startswith("cat_") and cap._gbdt.class_batch_ok)
        assert (cap._gbdt._bundle_meta is not None) == case.startswith(
            "efb_")
    assert n_cap == n_eag and sum(n_cap.values()) > 0
    assert len(cap._trees) == len(eag._trees) == 5 * cap._gbdt.K
    for a, b in zip(cap._trees, eag._trees):
        assert a.num_leaves == b.num_leaves
        assert np.array_equal(a.split_feature, b.split_feature)
        assert np.array_equal(a.threshold_bin, b.threshold_bin)
        assert np.array_equal(a.leaf_value, b.leaf_value)
        assert np.array_equal(a.split_gain, b.split_gain)
    assert torch.equal(cap._gbdt.scores, eag._gbdt.scores)
    assert torch.equal(cap._gbdt.valid_scores[0], eag._gbdt.valid_scores[0])


def test_replays_count_the_captured_launches(rng, dev, monkeypatch):
    monkeypatch.delenv("LIGHTGBM_TPU_FUSED_TRAIN", raising=False)
    X, y = _step_data(rng, _STEP_MULTI)
    g = _step_gbdt(_STEP_MULTI, X, y)
    g.train_one_iter(defer=True)            # eager iteration 0, then capture
    rec = dict(g._graph_launches)
    assert rec["build_root_histograms_classes"] == 1
    assert rec["fused_build_best_splits"] > 0
    CH.reset_launch_counts()
    for _ in range(3):
        g.train_one_iter(defer=True)
    assert CH.LAUNCHES == {k: 3 * v for k, v in rec.items()}
    assert not g.sync()
    assert len(g.models) == 4 * g.K


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_makes_no_host_sync(rng, dev, monkeypatch, case):
    """Under ``set_sync_debug_mode("error")`` neither the step body run
    eagerly, nor a replay with its host part, nor an iteration of the
    eager loop synchronizes with the card. A GOSS run first reaches its
    start iteration, so that both of its graphs are captured and the
    eager loop's iterations under the check sample."""
    monkeypatch.delenv("LIGHTGBM_TPU_FUSED_TRAIN", raising=False)
    p = STEP_CASES[case]
    X, y = _step_data(rng, p, case=case)
    for fused in (True, False):
        g = _step_gbdt({**p, "fused_train": fused}, X[:5000], y[:5000],
                       X[5000:], y[5000:])
        for _ in range(g._goss_start + 1 if g._goss else 1):
            g.train_one_iter(defer=True)    # loads the library, captures
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            if fused:
                g._step_impl(g._goss_on(g.iter_))
            for _ in range(2):              # bagging_freq 2: a new mask
                g.train_one_iter(defer=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert not g.sync()


@pytest.mark.parametrize("multiclass", [False, True])
def test_quantized_renewal_is_deterministic_on_card(rng, dev, monkeypatch,
                                                    multiclass):
    """Two eager runs of quantized training with leaf renewal give
    bit-identical leaves: the per-leaf float sums run in a fixed order
    (no float atomics)."""
    monkeypatch.delenv("LIGHTGBM_TPU_FUSED_TRAIN", raising=False)
    p = {**(_STEP_MULTI if multiclass else _STEP_BINARY), **_QUANT,
         "quant_train_renew_leaf": True, "fused_train": False}
    X, y = _step_data(rng, p, n=40000)
    runs = [lgt.train(p, lgt.Dataset(X, label=y, params=p), 4)
            for _ in range(2)]
    assert runs[0]._gbdt._renew
    for a, b in zip(runs[0]._trees, runs[1]._trees):
        assert np.array_equal(a.split_feature, b.split_feature)
        assert np.array_equal(a.leaf_value, b.leaf_value)
    assert torch.equal(runs[0]._gbdt.scores, runs[1]._gbdt.scores)


def test_threefry_on_card_matches_cpu(dev):
    """The threefry keys, fold_in chains (a 0-d device tensor too) and
    uniforms computed on the card equal their CPU bits."""
    from lightgbm_tpu_torch.ops import threefry
    for seed in (0, 3, 2 ** 31 - 1):
        kc, kg = threefry.prng_key(seed), threefry.prng_key(seed, dev)
        assert torch.equal(kg.cpu(), kc)
        for d in (1, 12345):
            kc = threefry.fold_in(kc, d)
            kg = threefry.fold_in(kg, torch.tensor(d, device=dev))
            assert torch.equal(kg.cpu(), kc)
        for shape in ((7,), (4096,), (3, 1001), (7, 581), (1 << 20,)):
            uc = threefry.uniform(kc, shape)
            ug = threefry.uniform(kg, shape)
            assert torch.equal(ug.cpu().view(torch.int32),
                               uc.view(torch.int32))


# -- the predict and serving path on the card ---------------------------

def _grid_model(kind, n=3000, seed=5):
    """A port model trained on the CPU over 1/8-grid features, with the
    decision types each case is for: a categorical bitset with NaN
    missing, NaN missing, zero_as_missing, 7-class multiclass."""
    rng = np.random.RandomState(seed)
    X = np.round(rng.normal(size=(n, 6)) * 8) / 8.0
    p = {"objective": "binary", "num_leaves": 31, "min_data_in_leaf": 5,
         "verbosity": -1, "device_type": "cpu"}
    kw = {}
    if kind in ("categorical", "nan"):
        X[rng.rand(n, 6) < 0.1] = np.nan
    if kind == "categorical":
        X[:, 0] = rng.randint(0, 12, size=n)
        X[rng.rand(n) < 0.1, 0] = np.nan
        kw = {"categorical_feature": [0]}
        p["min_data_per_group"] = 5
    if kind == "zero_as_missing":
        X[rng.rand(n, 6) < 0.25] = 0.0
        p["zero_as_missing"] = True
    y = (np.nan_to_num(X[:, 1]) + 0.5 * np.nan_to_num(X[:, 2])
         + np.isin(X[:, 0], [1, 4, 7]) > 0.3).astype(float)
    if kind == "multiclass":
        y = np.digitize(np.nan_to_num(X[:, :3]).sum(1),
                        [-2.5, -1.5, -0.5, 0.5, 1.5, 2.5]).astype(float)
        p.update(objective="multiclass", num_class=7, num_leaves=15)
    bst = lgt.train(p, lgt.Dataset(X, label=y, params=p, **kw), 10)
    return X, bst.model_to_string()


def _on(text, device_type):
    return lgt.Booster(model_str=text, params={"device_type": device_type})


@pytest.mark.parametrize("kind", ["categorical", "nan", "zero_as_missing",
                                  "multiclass"])
def test_compiled_ensemble_on_card_matches_cpu(dev, kind):
    """The tensorized walk's leaves on the card equal the CPU's, and so
    its scores (the same f64 host reduction) bit for bit; the on-device
    f32 reduction within rtol 1e-6."""
    from lightgbm_tpu_torch.codegen import CompiledEnsemble
    X, text = _grid_model(kind)
    card = CompiledEnsemble(_on(text, "cuda"))
    cpu = CompiledEnsemble(_on(text, "cpu"))
    assert card.default_device.type == "cuda"
    np.testing.assert_array_equal(card.predict_leaf(X), cpu.predict_leaf(X))
    np.testing.assert_array_equal(card.predict(X), cpu.predict(X))
    np.testing.assert_allclose(card.predict_device(X), cpu.predict(X),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("kind", ["categorical", "multiclass"])
def test_session_and_early_stop_on_card_match_cpu(dev, kind):
    X, text = _grid_model(kind)
    card, cpu = _on(text, "cuda"), _on(text, "cpu")
    np.testing.assert_array_equal(card.predict(X, pred_leaf=True),
                                  cpu.predict(X, pred_leaf=True))
    for kw in ({}, {"raw_score": True},
               {"raw_score": True, "pred_early_stop": True,
                "pred_early_stop_freq": 2, "pred_early_stop_margin": 1.0}):
        np.testing.assert_allclose(card.predict_session(**kw).predict(X),
                                   cpu.predict_session(**kw).predict(X),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("compiled", [False, True])
def test_prediction_server_on_card(dev, tmp_path, compiled):
    """A PredictionServer on the card answers npy bit-equal to its own
    session (the tensorized fleet: two replicas on the card)."""
    import io
    import urllib.request
    from lightgbm_tpu_torch.serving import PredictionServer
    X, text = _grid_model("categorical")
    path = str(tmp_path / "m.txt")
    with open(path, "w") as f:
        f.write(text)
    srv = PredictionServer(port=0, max_batch_rows=64,
                           compiled_predict=compiled,
                           replicas=2 if compiled else 0)
    try:
        mv = srv.registry.register("default", path)
        port = srv.start()
        Xq = np.ascontiguousarray(X[:48])
        buf = io.BytesIO()
        np.save(buf, Xq)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=buf.getvalue(),
            headers={"Content-Type": "application/x-npy"})
        got = np.load(io.BytesIO(
            urllib.request.urlopen(req, timeout=60).read()))
        np.testing.assert_array_equal(got, mv.session.predict(Xq))
        assert mv.booster._predict_device().type == "cuda"
        if compiled:
            assert {str(r.device) for r in mv.replicas.replicas} == {
                "cuda:0"}
    finally:
        srv.stop()


# -- the builder options on the card ------------------------------------------

def test_reset_parameter_through_the_captured_step(rng, dev, monkeypatch):
    """A learning-rate schedule reaches every replay through the step's
    learning-rate buffer: captured trees equal the eager loop's, each
    with its own shrinkage."""
    monkeypatch.delenv("LIGHTGBM_TPU_FUSED_TRAIN", raising=False)
    X, y = _step_data(rng, _STEP_BINARY)
    sched = [0.3, 0.25, 0.2, 0.15, 0.1]
    runs = []
    for fused in (True, False):
        p = {**_STEP_BINARY, "fused_train": fused}
        runs.append(lgt.train(p, lgt.Dataset(X, label=y, params=p), 5,
                              callbacks=[lgt.reset_parameter(
                                  learning_rate=sched)]))
    cap, eag = runs
    assert cap._gbdt._graph is not None
    assert [t.shrinkage for t in cap._trees] == sched
    for a, b in zip(cap._trees, eag._trees):
        assert np.array_equal(a.leaf_value, b.leaf_value)
        assert np.array_equal(a.split_feature, b.split_feature)
    assert torch.equal(cap._gbdt.scores, eag._gbdt.scores)
    with pytest.raises(NotImplementedError, match="num_leaves"):
        cap.reset_parameter({"num_leaves": 7})


def test_forced_splits_through_the_captured_step(rng, dev, monkeypatch,
                                                 tmp_path):
    """Forced splits run in the step: captured equals the eager loop,
    and neither syncs with the card (the forced node's slot and sums
    are read on the device)."""
    import json
    monkeypatch.delenv("LIGHTGBM_TPU_FUSED_TRAIN", raising=False)
    path = tmp_path / "forced.json"
    path.write_text(json.dumps({
        "feature": 0, "threshold": 0.0,
        "left": {"feature": 1, "threshold": 0.5,
                 "left": {"feature": 2, "threshold": 0.1}},
        "right": {"feature": 2, "threshold": -0.5}}))
    p = {**_STEP_BINARY, "forcedsplits_filename": str(path)}
    X, y = _step_data(rng, p)
    runs = {}
    for fused in (True, False):
        g = _step_gbdt({**p, "fused_train": fused}, X[:5000], y[:5000],
                       X[5000:], y[5000:])
        g.train_one_iter(defer=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                g.train_one_iter(defer=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert not g.sync()
        runs[fused] = g
    cap, eag = runs[True], runs[False]
    assert cap._graph is not None
    for a, b in zip(cap.models, eag.models):
        assert a.split_feature[0] == 0
        assert np.array_equal(a.split_feature, b.split_feature)
        assert np.array_equal(a.leaf_value, b.leaf_value)
    assert torch.equal(cap.scores, eag.scores)


@pytest.mark.parametrize("case", ["cegb", "forced", "advanced"])
def test_eager_options_on_card_match_cpu(rng, dev, tmp_path, case):
    """CEGB (eager loop), forced splits (per class) and advanced
    monotone constraints: card trees equal the CPU's."""
    import json
    X, y = _step_data(rng, _STEP_BINARY)
    extra = {
        "cegb": {"cegb_penalty_split": 0.002,
                 "cegb_penalty_feature_coupled": [0, 2, 2, .5, 5, 5],
                 "cegb_penalty_feature_lazy": [.001, 0, .002, .001, 0,
                                               .003]},
        "advanced": {"monotone_constraints": [1, 0, 0, -1, 0, 0],
                     "monotone_constraints_method": "advanced"},
    }.get(case, {})
    if case == "forced":
        path = tmp_path / "forced.json"
        path.write_text(json.dumps({
            "feature": 0, "threshold": 0.0,
            "left": {"feature": 1, "threshold": 0.5},
            "right": {"feature": 2, "threshold": -0.5}}))
        extra = {"forcedsplits_filename": str(path)}
    p = {**_STEP_BINARY, **extra, "fused_train": False}
    gpu = lgt.train(p, lgt.Dataset(X, label=y, params=p), 4)
    pc = {**p, "device_type": "cpu"}
    cpu = lgt.train(pc, lgt.Dataset(X, label=y, params=pc), 4)
    for a, b in zip(gpu._trees, cpu._trees):
        assert a.num_leaves == b.num_leaves
        assert np.array_equal(a.split_feature, b.split_feature)
        assert np.array_equal(a.threshold_bin, b.threshold_bin)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, atol=1e-5)
    if case == "cegb":
        # the lazy costs' per-leaf sums: exact int32 counts times the
        # cost on the card, row-order f32 sums on the CPU
        assert torch.equal(gpu._gbdt._cegb_used_rows.cpu(),
                           cpu._gbdt._cegb_used_rows)


# -- wide bins (max_bin > 255, bundles over 256 bins) and linear trees -------

def _wide_stream(rng, dev, B_, dtype, quant=False, R_=R, F_=F):
    bins = rng.randint(0, B_, size=(R_, F_))
    bins[:, 1] = rng.randint(300 % B_, min(B_, 340), size=R_)
    bins[rng.rand(R_) < 0.1, 2] = B_ - 1
    rl = rng.randint(-1, L, size=R_).astype(np.int32)
    if quant:
        gh = np.stack([rng.randint(-3, 4, size=R_), rng.randint(0, 5, size=R_),
                       np.ones(R_)], 1).astype(np.int8)
    else:
        g = rng.normal(size=R_).astype(np.float32)
        gh = np.stack([g, np.abs(g) + 0.5, np.ones(R_, np.float32)], 1)
    return [torch.from_numpy(bins).to(dev, dtype)] + [
        torch.from_numpy(a).to(dev)
        for a in (gh, rl, np.arange(L, dtype=np.int32))]


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("case", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("B_", [300, 1024])
def test_b1_kernel_wide_bins(rng, dev, case, dtype, B_):
    """B1 over int16/int32 bin columns in bin tiles (B = 300: two
    ragged tiles; 1,024: four), against its plain version; two launches
    bit-identical."""
    bins, gh, rl, ids = _wide_stream(rng, dev, B_, dtype, case == "int8")
    hd = "float32" if case == "f32" else "bfloat16"
    got = CH.build_histograms_cuda(bins, gh, rl, ids, num_bins=B_,
                                   hist_dtype=hd)
    again = CH.build_histograms_cuda(bins, gh, rl, ids, num_bins=B_,
                                     hist_dtype=hd)
    want = build_histograms(*(t.cpu() for t in (bins, gh, rl, ids)),
                            num_bins=B_, hist_dtype=hd)
    assert torch.equal(got, again)
    if case == "int8":
        assert torch.equal(got.cpu(), want)
    else:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("quant", [False, True])
def test_b2_kernel_wide_bins(rng, dev, quant):
    B_ = 1024
    bins, gh, rl, ids = _wide_stream(rng, dev, B_, torch.int16, quant)
    meta = dict(
        num_bins_pf=torch.full((F,), B_, dtype=torch.int32, device=dev),
        nan_bin_pf=torch.tensor(np.where(np.arange(F) == 2, B_ - 1, -1),
                                dtype=torch.int32, device=dev),
        is_cat_pf=torch.zeros(F, dtype=torch.bool, device=dev))
    if quant:
        meta["quant_scales"] = torch.tensor([0.25, 0.5], device=dev)
    sp = SplitParams(min_data_in_leaf=5)
    got, gh_ = CH.fused_build_best_splits(bins, gh, rl, ids, num_bins=B_,
                                          params=sp, hist_dtype="float32",
                                          emit_hist=True, **meta)
    want, wh = CH.fused_build_best_splits_plain(
        *(t.cpu() for t in (bins, gh, rl, ids)), num_bins=B_, params=sp,
        hist_dtype="float32", emit_hist=True,
        **{k: v.cpu() for k, v in meta.items()})
    for k in want:
        if want[k].dtype.is_floating_point:
            torch.testing.assert_close(got[k].cpu(), want[k], rtol=3e-6,
                                       atol=3e-5)
        else:
            assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.parametrize("case", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("B_,dtype", [(1024, torch.int16),
                                      (2100, torch.int16),
                                      (700, torch.int32)])
def test_b3_kernel_wide_bins(rng, dev, case, B_, dtype):
    """B3 over wide bin columns: one bin range at B = 1,024, several at
    2,100 (f32), int32 columns; against its plain version and B1."""
    bins, gh, rl = _b3_case(rng, dev, case, 3000, 5, 7, 256)
    wide = torch.from_numpy(rng.randint(0, B_, size=(3000, 5))).to(dev, dtype)
    wide[:, 1] = (bins[:, 1].to(dtype) + 300) % B_
    _check_b3(wide, gh, rl, case, B_)


def _wide_data(rng, n=6000):
    X = rng.normal(size=(n, 6))
    y = (X[:, 0] + X[:, 1] ** 2 > 1).astype(float)
    return X, y


@pytest.mark.parametrize("case", ["b2", "b1", "multiclass", "efb"])
def test_wide_training_on_card_matches_cpu(rng, dev, case):
    """max_bin 511 through B2, B1 and the class-batched build (B3 + B2),
    and a bundle plan of up to 1,024 bins (B1): int16 columns, card
    trees equal the CPU's."""
    X, y = _wide_data(rng)
    p = {"objective": "binary", "num_leaves": 15, "max_bin": 511,
         "verbosity": -1}
    if case == "b1":
        p["fused_split"] = "off"
    if case == "multiclass":
        y = (X[:, :3] + 0.5 * rng.normal(size=(len(X), 3))).argmax(1)
        p.update(objective="multiclass", num_class=3)
    if case == "efb":
        X = np.zeros((8000, 8))
        for j in range(8):
            rows = np.arange(j, 8000, 8)
            X[rows, j] = rng.normal(size=len(rows))
        y = (X.sum(1) > 0).astype(float)
        p.update(max_bin=255, max_bundle_bins=1024)
    CH.reset_launch_counts()
    gpu = lgt.train(p, lgt.Dataset(X, label=y, params=p), 3)
    assert gpu._gbdt.train_set.bins.dtype == torch.int16
    launched = {k for k, v in CH.LAUNCHES.items() if v}
    want = {"b2": {"fused_build_best_splits"},
            "b1": {"build_histograms_cuda"},
            "multiclass": {"fused_build_best_splits",
                           "build_root_histograms_classes"},
            "efb": {"build_histograms_cuda"}}[case]
    assert launched == want
    pc = {**p, "device_type": "cpu"}
    cpu = lgt.train(pc, lgt.Dataset(X, label=y, params=pc), 3)
    for a, b in zip(gpu._trees, cpu._trees):
        assert a.num_leaves == b.num_leaves
        assert np.array_equal(a.split_feature, b.split_feature)
        assert np.array_equal(a.threshold_bin, b.threshold_bin)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, atol=1e-5)


@pytest.mark.parametrize("objective", ["regression", "multiclass"])
def test_linear_trees_on_card_match_cpu(rng, dev, objective):
    """linear_tree on the card: trees and coefficients equal the CPU's
    (within rtol 1e-9 for L2, whose gradients are exact, and predictions
    within 1e-9). The softmax's float32 gradients differ by rounding
    between the card's exp and the CPU's, which the solves carry into
    the fits and a near tie can carry into a split: multiclass trees are
    compared up to the first that differs, the first iteration's at
    least, coefficients within 1e-4 of their leaf's output scale. A CPU
    model predicts on the card within 1e-12 of Tree.predict."""
    X = rng.normal(size=(4000, 5))
    y = np.where(X[:, 0] > 0, 2.0 * X[:, 1] + 1.0, -1.5 * X[:, 1] - 0.5)
    p = {"objective": "regression", "num_leaves": 8, "linear_tree": True,
         "linear_lambda": 0.01, "verbosity": -1}
    K = 1
    if objective == "multiclass":
        y = np.digitize(y, [-0.5, 1.0])
        K = 3
        p.update(objective="multiclass", num_class=K)
    gpu = lgt.train(p, lgt.Dataset(X, label=y, params=p), 4)
    pc = {**p, "device_type": "cpu"}
    cpu = lgt.train(pc, lgt.Dataset(X, label=y, params=pc), 4)
    assert any(t.is_linear for t in gpu._trees)
    tol = 1e-9 if objective == "regression" else 1e-4
    same = 0
    for a, b in zip(gpu._trees, cpu._trees):
        if not (a.num_leaves == b.num_leaves
                and np.array_equal(a.split_feature, b.split_feature)
                and np.array_equal(a.threshold_bin, b.threshold_bin)):
            break
        same += 1
        assert a.is_linear == b.is_linear
        np.testing.assert_allclose(a.leaf_const, b.leaf_const, rtol=tol,
                                   atol=1e-12)
        for s in range(a.num_leaves):
            ma = dict(zip(a.leaf_features[s], a.leaf_coeff[s]))
            mb = dict(zip(b.leaf_features[s], b.leaf_coeff[s]))
            if objective == "regression":
                assert a.leaf_features[s] == b.leaf_features[s]
            keys = sorted(set(ma) | set(mb))     # noise may drop at 0
            if keys:
                # a coefficient against the leaf's output scale: a leaf
                # of near-constant gradients fits noise (~1e-8)
                cb = np.array([mb.get(k, 0.0) for k in keys])
                scale = max(np.abs(cb).max(), abs(b.leaf_const[s]))
                np.testing.assert_allclose(
                    [ma.get(k, 0.0) for k in keys], cb, rtol=tol,
                    atol=tol * scale + 1e-12)
    assert same >= (len(cpu._trees) if objective == "regression" else K)
    if same == len(cpu._trees):
        np.testing.assert_allclose(gpu.predict(X), cpu.predict(X),
                                   atol=1e-9 if objective == "regression"
                                   else 1e-4)
    on_card = lgt.Booster(model_str=cpu.model_to_string())
    raw = on_card.predict(X, raw_score=True).reshape(len(X), -1)
    host = np.zeros_like(raw)
    K = raw.shape[1]
    for i, t in enumerate(cpu._trees):
        host[:, i % K] += t.predict(X)
    np.testing.assert_allclose(raw, host, rtol=0, atol=1e-12)


def _fobj_logloss(preds, dataset):
    lab = dataset.get_label()
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - lab, p * (1.0 - p)


def _same_structure(a_trees, b_trees, atol=1e-5):
    assert len(a_trees) == len(b_trees)
    for a, b in zip(a_trees, b_trees):
        assert a.num_leaves == b.num_leaves
        assert np.array_equal(a.split_feature, b.split_feature)
        assert np.array_equal(a.threshold_bin, b.threshold_bin)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, atol=atol)


def _binary_data(rng, n=8000):
    X = rng.normal(size=(n, 8))
    y = (X[:, 0] - 0.7 * X[:, 1] ** 2 + rng.normal(scale=0.5, size=n)
         > 0).astype(float)
    return X, y


@pytest.mark.parametrize("fused_split", ["auto", "off"])
def test_binary_fobj_on_card_matches_cpu(rng, dev, fused_split):
    """A binary logloss fobj on the card (the eager loop through B2, or
    B1 with fused_split=off, 17 launches a tree) gives the CPU's
    trees."""
    X, y = _binary_data(rng)
    p = {"objective": "custom", "num_leaves": 15, "verbosity": -1,
         "fused_split": fused_split}
    CH.reset_launch_counts()
    gpu = lgt.train(p, lgt.Dataset(X, label=y, params=p), 4,
                    fobj=_fobj_logloss)
    kernel = ("fused_build_best_splits" if fused_split == "auto"
              else "build_histograms_cuda")
    assert {k for k, v in CH.LAUNCHES.items() if v} == {kernel}
    pc = {**p, "device_type": "cpu"}
    cpu = lgt.train(pc, lgt.Dataset(X, label=y, params=pc), 4,
                    fobj=_fobj_logloss)
    _same_structure(gpu._trees, cpu._trees)
    np.testing.assert_allclose(gpu.predict(X), cpu.predict(X), atol=1e-5)


@pytest.mark.parametrize("boosting", ["gbdt", "rf"])
def test_continued_training_on_card_matches_cpu(rng, dev, boosting):
    """init_model from one model text on the card and on the CPU: the
    same new trees, and the card's internal scores agree with its
    predict (the captured step runs from the base scores for gbdt)."""
    X, y = _binary_data(rng)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "boosting": boosting}
    if boosting == "rf":
        p.update(bagging_freq=1, bagging_fraction=0.7)
    pc = {**p, "device_type": "cpu"}
    text = lgt.train(pc, lgt.Dataset(X, label=y, params=pc),
                     3).model_to_string()
    runs = {}
    for name, q in (("gpu", p), ("cpu", pc)):
        base = lgt.Booster(model_str=text, params=q)
        runs[name] = lgt.train(q, lgt.Dataset(X, label=y, params=q,
                                              free_raw_data=False), 3,
                               init_model=base)
    gpu, cpu = runs["gpu"], runs["cpu"]
    assert gpu.num_trees() == 6
    _same_structure(gpu._all_trees(), cpu._all_trees())
    np.testing.assert_allclose(gpu._gbdt.eval_scores(-1)[:, 0],
                               gpu.predict(X, raw_score=True), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(gpu.predict(X), cpu.predict(X), atol=1e-5)


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_refit_on_card_matches_cpu(rng, dev, objective):
    """refit of one model text on the card and on the CPU: the same
    structures, leaf values within rtol 1e-9 (float64 sums of the same
    float32 gradients, in another order)."""
    X, y = _binary_data(rng)
    p = {"objective": objective, "num_leaves": 15, "verbosity": -1,
         "device_type": "cpu"}
    if objective == "multiclass":
        y = np.digitize(X[:, 0] + rng.normal(size=len(X)), [-0.5, 0.5])
        p["num_class"] = 3
    text = lgt.train(p, lgt.Dataset(X, label=y, params=p),
                     4).model_to_string()
    X2 = X + 0.1 * rng.normal(size=X.shape)
    gpu = lgt.Booster(model_str=text).refit(X2, y, decay_rate=0.3)
    cpu = lgt.Booster(model_str=text, params={"device_type": "cpu"}) \
        .refit(X2, y, decay_rate=0.3)
    for a, b in zip(gpu._all_trees(), cpu._all_trees()):
        assert np.array_equal(a.split_feature, b.split_feature)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-9,
                                   atol=1e-12)


def test_cv_on_card_matches_cpu(rng, dev):
    """cv on the card: every fold launches B2, and the aggregated
    metrics agree with the CPU's."""
    X, y = _binary_data(rng, n=6000)
    p = {"objective": "binary", "metric": "auc", "num_leaves": 15,
         "verbosity": -1}
    CH.reset_launch_counts()
    gpu = lgt.cv(p, lgt.Dataset(X, label=y, params=p, free_raw_data=False),
                 4, nfold=3)
    assert CH.LAUNCHES["fused_build_best_splits"] > 0
    pc = {**p, "device_type": "cpu"}
    cpu = lgt.cv(pc, lgt.Dataset(X, label=y, params=pc,
                                 free_raw_data=False), 4, nfold=3)
    np.testing.assert_allclose(gpu["valid auc-mean"], cpu["valid auc-mean"],
                               atol=1e-6)


@pytest.mark.parametrize("source", ["one_hot_csr", "random_csc", "csv",
                                    "libsvm"])
def test_sparse_and_file_inputs_bin_on_card_as_on_cpu(rng, dev, tmp_path,
                                                      source):
    """A CSR/CSC matrix and a CSV/LibSVM file, each built on the card:
    bins, bundle plan and dtype equal to the CPU's; 2 trees from the
    one-hot CSR train through B1 in bundle space."""
    import scipy.sparse as sp
    n = 6000
    if source == "one_hot_csr":
        cats = rng.randint(0, 8, size=(n, 16))
        cols = (cats + np.arange(16)[None, :] * 8).ravel()
        data = sp.csr_matrix((np.ones(n * 16), (np.repeat(np.arange(n), 16),
                                                cols)), shape=(n, 128))
    elif source == "random_csc":
        data = sp.random(n, 40, density=0.1, format="csc", random_state=1,
                         data_rvs=lambda k: rng.normal(size=k))
        data.data[::11] = np.nan
    else:
        X = rng.normal(size=(n, 6))
        X[X[:, 3] > 1.0, 3] = 0.0
        y = (X[:, 0] > 0).astype(float)
        data = str(tmp_path / ("d.csv" if source == "csv" else "d.svm"))
        with open(data, "w") as f:
            for row, lab in zip(X.tolist(), y.tolist()):
                if source == "csv":
                    f.write(",".join(repr(v) for v in [lab] + row) + "\n")
                else:
                    f.write(" ".join([repr(lab)] + [
                        f"{j}:{v!r}" for j, v in enumerate(row) if v])
                            + "\n")
    label = rng.normal(size=n)
    p = {"objective": "regression", "num_leaves": 15, "verbosity": -1}
    built = {}
    for d in ("cuda", "cpu"):
        q = {**p, "device_type": d}
        built[d] = lgt.Dataset(data, label=None if isinstance(data, str)
                               else label, params=q).construct()
    gpu, cpu = built["cuda"], built["cpu"]
    assert gpu.bins.device.type == "cuda"
    assert gpu.bins.dtype == cpu.bins.dtype
    assert torch.equal(gpu.bins.cpu(), cpu.bins)
    assert (gpu.bundle_plan is None) == (cpu.bundle_plan is None)
    if source == "one_hot_csr":
        assert gpu.bundle_plan.num_bundles <= 32
        CH.reset_launch_counts()
        lgt.train({**p, "fused_train": False}, gpu, 2)
        assert CH.LAUNCHES["build_histograms_cuda"] > 0


# ---------------------------------------------------------------------
# out-of-core training and checkpoints on the card


@pytest.mark.parametrize("case", ["f32", "bf16", "int8"])
def test_b1_init_carries_the_accumulator(rng, dev, case):
    """B1 with ``init``: the slot reduction starts from the carried
    sums. int8 is exact; f32 within rtol 1e-4 of a channel's scale; two
    launches are bit-identical; ``init=None`` equals an all-zero seed."""
    bins, gh, rl, ids = _stream(rng, dev, quant=case == "int8")
    hd = "float32" if case == "f32" else "bfloat16"
    half = R // 2
    kw = dict(num_bins=B, hist_dtype=hd)
    first = CH.build_histograms_cuda(bins[:half], gh[:half].contiguous(),
                                     rl[:half].contiguous(), ids, **kw)
    again = CH.build_histograms_cuda(bins[:half], gh[:half].contiguous(),
                                     rl[:half].contiguous(), ids, **kw,
                                     init=torch.zeros_like(first))
    assert torch.equal(first, again)
    tail = (bins[half:].contiguous(), gh[half:].contiguous(),
            rl[half:].contiguous(), ids)
    got = CH.build_histograms_cuda(*tail, init=first, **kw)
    assert torch.equal(got, CH.build_histograms_cuda(*tail, init=first,
                                                     **kw))
    want = build_histograms(bins.cpu(), gh.cpu(), rl.cpu(), ids.cpu(),
                            **kw)
    if case == "int8":
        assert torch.equal(got.cpu(), want)
    else:
        _close_to_channel_scale(got.cpu(), want)


def test_chunked_tree_on_card_matches_cpu(rng, dev, monkeypatch):
    """A Higgs-shaped chunked run (many chunks) on the card: B1 a chunk,
    never B2; the trees' predictions equal the CPU's chunked run's."""
    from lightgbm_tpu_torch.data import prefetch
    monkeypatch.setattr(prefetch, "chunk_rows_for", lambda *a: 4096)
    X = rng.normal(size=(20000, 28))
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
         "min_data_in_leaf": 20, "verbosity": -1, "out_of_core": "on",
         "use_quantized_grad": True, "hist_subtraction": False}
    CH.reset_launch_counts()
    gpu = lgt.train(p, lgt.Dataset(X, label=y), 3)
    assert gpu._gbdt.chunked and gpu._gbdt._prefetcher.num_chunks == 5
    assert CH.LAUNCHES["build_histograms_cuda"] > 0
    assert CH.LAUNCHES["fused_build_best_splits"] == 0
    cpu = lgt.train({**p, "device_type": "cpu"},
                    lgt.Dataset(X, label=y, params={"device_type": "cpu"}), 3)
    assert [t.num_leaves for t in gpu._all_trees()] == \
        [t.num_leaves for t in cpu._all_trees()]
    np.testing.assert_allclose(gpu.predict(X), cpu.predict(X), atol=1e-5)


def test_resume_through_the_captured_step(rng, dev, tmp_path, monkeypatch):
    """Checkpoints at iterations 3 and 6 of a captured run; a run
    resumed from iteration 3 (the restore copies into the step's
    buffers) gives byte-equal model text, and so does a rollback."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("LIGHTGBM_TPU_FUSED_TRAIN", "1")
    X = rng.normal(size=(8000, 10))
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "bagging_fraction": 0.8, "bagging_freq": 2, "snapshot_freq": 3,
         "resume": "auto", "output_model": "m.txt"}
    ref = lgt.train(p, lgt.Dataset(X, label=y), 8)
    assert ref._gbdt.fused_train_ok and ref._gbdt._graphs
    text = ref.model_to_string()
    import os
    os.unlink("m.txt.ckpt_iter_6")
    again = lgt.train(p, lgt.Dataset(X, label=y), 8)
    assert again.model_to_string() == text
    for f in os.listdir("."):
        os.unlink(f)
    monkeypatch.setenv("LIGHTGBM_TPU_CHAOS_POISON_ITER", "5")
    monkeypatch.setenv("LIGHTGBM_TPU_CHAOS_POISON_ONCE",
                       str(tmp_path / "marker"))
    rolled = lgt.train({**p, "nan_guard": "rollback"},
                       lgt.Dataset(X, label=y), 8)
    assert rolled.model_to_string().replace(
        "[nan_guard: rollback]\n", "") == text


def test_trace_window_during_the_capture(rng, dev, tmp_path, monkeypatch):
    """A ``/trace`` window that the telemetry server opens on its own
    thread while the training thread runs and captures the step (the
    profiler's first start, CUPTI's initialisation, among it) leaves
    the capture valid, and so do later captures after the window: the
    three runs train the same trees."""
    import http.client
    import threading
    import time
    from lightgbm_tpu_torch.telemetry import active_session
    monkeypatch.setenv("LIGHTGBM_TPU_FUSED_TRAIN", "1")
    X = rng.normal(size=(8000, 10))
    y = rng.randint(0, 3, size=8000).astype(float)
    y[X[:, 0] > 0.5] = 2
    p = {"objective": "multiclass", "num_class": 3, "num_leaves": 15,
         "verbosity": -1}
    bare = lgt.train(p, lgt.Dataset(X, label=y), 4)
    assert bare._gbdt.fused_train_ok and bare._gbdt._graphs
    status = []

    def tracer():
        t_end = time.perf_counter() + 120
        while time.perf_counter() < t_end:
            sess = active_session()
            if sess is not None and sess.port is not None:
                conn = http.client.HTTPConnection("127.0.0.1", sess.port,
                                                  timeout=120)
                conn.request("GET", "/trace?duration_ms=20")
                status.append(conn.getresponse().status)
                conn.close()
                return
            time.sleep(0.001)

    th = threading.Thread(target=tracer, daemon=True)
    th.start()
    traced = lgt.train({**p, "telemetry_port": 0,
                        "event_log": str(tmp_path / "ev.jsonl")},
                       lgt.Dataset(X, label=y), 4)
    th.join(timeout=150)
    after = lgt.train(p, lgt.Dataset(X, label=y), 4)
    assert status and status[0] in (200, 500)

    def trees(bst):
        return bst.model_to_string().split("\nparameters:")[0]
    assert trees(traced) == trees(bare)
    assert trees(after) == trees(bare)


def test_no_collection_inside_the_capture(rng, dev, monkeypatch):
    """Fault C10: a dead reference cycle holding an older booster, whose
    CUDA graph the cyclic collector would destroy inside the next run's
    capture (``cudaGraphExecDestroy`` is illegal while a stream
    captures). With the collector's thresholds at 1 it would run during
    that capture; the step turns it off for the capture, so no
    collection sees a capturing stream and the run trains."""
    import gc
    monkeypatch.setenv("LIGHTGBM_TPU_FUSED_TRAIN", "1")
    X = rng.normal(size=(8000, 10))
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
    ref = lgt.train(p, lgt.Dataset(X, label=y), 3)
    old = lgt.train(p, lgt.Dataset(X, label=y), 3)
    assert old._gbdt._graphs
    old._cycle = old
    del old
    seen = []

    def watch(phase, info):
        if phase == "start":
            seen.append(torch.cuda.is_current_stream_capturing())
    thresholds = gc.get_threshold()
    gc.callbacks.append(watch)
    gc.set_threshold(1, 1, 1)
    try:
        bst = lgt.train(p, lgt.Dataset(X, label=y), 3)
    finally:
        gc.set_threshold(*thresholds)
        gc.callbacks.remove(watch)
    assert seen and not any(seen)
    assert bst._gbdt._graphs
    assert (bst.model_to_string().split("\nparameters:")[0]
            == ref.model_to_string().split("\nparameters:")[0])
