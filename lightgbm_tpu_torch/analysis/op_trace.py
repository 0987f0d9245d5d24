"""The op recorder: the port's counterpart of a jaxpr.

The JAX doctor traces a program and walks its equations. The port's
step is a CUDA graph captured from eager PyTorch
(``GBDT._step_impl``/``_capture``), so the thing to walk is the trace
of that eager body as it runs. :func:`record` runs a callable under a
``TorchDispatchMode`` and logs every aten op it issues: the op's name,
the shape, dtype and device of each tensor it takes and returns, the
profiler phases open at the time (``profiler.phase``), and the op's
site, the innermost frame of the port that issued it (``module.func``,
e.g. ``boosting.gbdt._flatten``). Beside the ops it keeps:

- the kernel launches of the body, per wrapper of
  ``ops/cuda_histogram.py``, taken apart from ``LAUNCHES`` with
  ``captured_launches()`` so that recording disturbs no launch count;
- the collectives the body ran, the new records of a live
  ``parallel.comms.CommReport`` (each with its ``span``);
- the profiler phase totals of the run (TD005 counts the step's
  ``build`` spans);
- on the card, the host sync that ``torch.cuda.set_sync_debug_mode
  ("error")`` refused, if the body made one (the body stops there).
  A gloo group stages a collective of a CUDA tensor through the host
  (``Comm._to_host``/``_to_device``, :data:`STAGING_SITES`): under a
  gloo ``comm`` the debug mode is lifted for those copies alone, and
  the op lint reports them as staging, with their bytes.

The recorder works on the CPU and on the card alike. Kernels launched
through ctypes are not aten ops: they show as their wrapper's
allocations and in the launch counts.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = ["TensorMeta", "OpRecord", "OpTrace", "record", "STAGING_SITES"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SKIP = os.path.join(_PKG, "analysis") + os.sep
# the collective layer's copies of a gloo collective's CUDA tensor
STAGING_SITES = frozenset({"parallel.comms._to_host",
                           "parallel.comms._to_device"})


@dataclasses.dataclass(frozen=True)
class TensorMeta:
    """Shape, dtype and device of one tensor an op took or returned."""
    shape: Tuple[int, ...]
    dtype: str                      # e.g. "float32"
    device: str                     # "cpu" | "cuda"
    nbytes: int


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One aten op the recorded body issued."""
    op: str                         # e.g. "aten._to_copy.default"
    inputs: Tuple[TensorMeta, ...]
    outputs: Tuple[TensorMeta, ...]
    phases: Tuple[str, ...]         # profiler phases open, outermost first
    site: str                       # innermost port frame, "module.func"

    @property
    def name(self) -> str:
        """The op without its namespace and overload (``_to_copy``)."""
        return self.op.split(".")[1] if self.op.count(".") >= 1 else self.op


@dataclasses.dataclass
class OpTrace:
    """What :func:`record` saw of one run of a body."""
    device: str
    ops: List[OpRecord] = dataclasses.field(default_factory=list)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    collectives: List[Any] = dataclasses.field(default_factory=list)
    phase_totals: Any = None        # profiler.PhaseTotals of the run
    staging: bool = False           # the collectives ran on a gloo group
    sync_error: Optional[str] = None
    result: Any = None

    def is_staging(self, op: "OpRecord") -> bool:
        """Whether ``op`` stages a gloo collective through the host."""
        return self.staging and op.site in STAGING_SITES


def _meta(t: torch.Tensor) -> TensorMeta:
    return TensorMeta(tuple(int(d) for d in t.shape),
                      str(t.dtype).replace("torch.", ""), t.device.type,
                      int(t.numel()) * t.element_size())


def _metas(tree) -> Tuple[TensorMeta, ...]:
    from torch.utils._pytree import tree_flatten
    return tuple(_meta(x) for x in tree_flatten(tree)[0]
                 if isinstance(x, torch.Tensor))


def _site() -> str:
    """``module.func`` of the innermost frame in the port's package
    (outside this analysis package) on the current stack."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(_PKG) and not fn.startswith(_SKIP):
            mod = os.path.relpath(fn, _PKG)[:-3].replace(os.sep, ".")
            return f"{mod}.{f.f_code.co_name}"
        f = f.f_back
    return "<outside>"


def record(fn, *args, device=None, comm=None, sync_debug=None,
           **kwargs) -> OpTrace:
    """Run ``fn(*args, **kwargs)`` once under the recorder; returns its
    :class:`OpTrace` (``result`` holds what ``fn`` returned). ``device``
    ("cuda" or "cpu", default the card when there is one) says where the
    body runs: on the card it also runs under
    ``set_sync_debug_mode("error")`` (unless ``sync_debug`` is False),
    and a sync it makes ends the body with ``sync_error`` set. ``comm``
    is a ``parallel.comms.Comm`` whose new records are the trace's
    collectives; on a gloo ``comm`` its staging copies run with the
    debug mode lifted. An error of ``fn`` other than a refused sync
    propagates."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from .. import profiler
    from ..ops import cuda_histogram as CH

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    trace = OpTrace(device=dev.type)
    ops = trace.ops

    n0 = len(comm.report.ops) if comm is not None else 0
    card = dev.type == "cuda"
    debug = card if sync_debug is None else (card and sync_debug)
    trace.staging = comm is not None and comm.backend == "gloo"

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            kw = kw or {}
            rec = (str(func), _metas((a, kw)))
            where = (profiler.open_phases(), _site())
            lift = debug and trace.staging and where[1] in STAGING_SITES
            if lift:
                torch.cuda.set_sync_debug_mode(0)
            try:
                out = func(*a, **kw)
            except Exception:           # a refused sync is recorded too
                ops.append(OpRecord(*rec, (), *where))
                raise
            finally:
                if lift:
                    torch.cuda.set_sync_debug_mode("error")
            ops.append(OpRecord(*rec, _metas(out), *where))
            return out

    if card:
        torch.cuda.synchronize(dev)
    with CH.captured_launches() as launched, \
            profiler.collect_phase_totals() as totals:
        if debug:
            torch.cuda.set_sync_debug_mode("error")
        try:
            with _Mode():
                trace.result = fn(*args, **kwargs)
        except RuntimeError as e:
            if not (debug and "synchroniz" in str(e)):
                raise
            trace.sync_error = str(e).splitlines()[0]
        finally:
            if debug:
                torch.cuda.set_sync_debug_mode(0)
    trace.phase_totals = totals
    if card:
        torch.cuda.synchronize(dev)
    trace.launches = dict(launched)
    if comm is not None:
        trace.collectives = list(comm.report.ops[n0:])
    return trace
