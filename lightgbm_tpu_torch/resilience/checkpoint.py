"""Full-state training checkpoints with bit-identical resume (a port of
``lightgbm_tpu/resilience/checkpoint.py``; the container layout and the
state keys are the JAX package's, so a checkpoint written by either
package resumes in the other).

Container layout (all integers little-endian)::

    b"LGTPUCK1"                      8-byte magic
    u64 header_len                   length of the JSON header
    header JSON (utf-8)              {"format_version", "state", "sections"}
    payload                          concatenated section bytes
    b"LGTPUCKF"                      8-byte footer magic
    sha256(everything above)         32 bytes

``state`` is a JSON dict of scalar training state (iteration counter,
RNG streams, early-stopping/eval history, config fingerprint, cadence
base). ``sections`` is a table of named binary blobs — numpy arrays
(dtype+shape recorded) and utf-8 texts (the model dump) — so the score
accumulators round-trip exactly (raw f32 bytes, no decimal detour).

Truncation kills the footer-magic check; a bit-flip anywhere kills the
sha256. Both surface as :class:`CheckpointError`, which the resume
scanner treats as "skip this file, try the previous one".

This module deliberately imports only leaf modules (``..tree``,
``..log``) — ``engine`` imports *us*, never the reverse.

``device_type`` counts as topology (``_TOPOLOGY_EXCLUDE``): it decides
where the run executes, not what it computes, so a checkpoint written
on the CPU resumes on the card and the other way round.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..log import info as log_info, warning as log_warning
from ..tree import Tree
from .atomic_io import atomic_write_bytes

__all__ = [
    "CheckpointError", "checkpoint_path", "config_fingerprint",
    "find_resume_checkpoint", "is_valid_checkpoint", "list_numbered",
    "prune_numbered", "read_checkpoint", "topology_descriptor",
    "write_checkpoint", "capture_training_checkpoint",
    "restore_training_checkpoint", "write_training_checkpoint",
]

_MAGIC = b"LGTPUCK1"
_FOOTER = b"LGTPUCKF"
_FORMAT_VERSION = 1


class CheckpointError(RuntimeError):
    """Checkpoint file is corrupt, truncated, or incompatible."""


# ---------------------------------------------------------------------------
# container read/write
# ---------------------------------------------------------------------------

def write_checkpoint(path: str, state: Dict[str, Any],
                     arrays: Dict[str, np.ndarray],
                     texts: Dict[str, str]) -> None:
    """Serialize ``state`` + named arrays/texts to ``path`` atomically."""
    sections: List[Dict[str, Any]] = []
    payload = bytearray()
    for name, arr in sorted(arrays.items()):
        arr = np.ascontiguousarray(arr)
        raw = arr.tobytes()
        sections.append({"name": name, "offset": len(payload),
                         "nbytes": len(raw), "dtype": arr.dtype.str,
                         "shape": list(arr.shape)})
        payload += raw
    for name, text in sorted(texts.items()):
        raw = text.encode("utf-8")
        sections.append({"name": name, "offset": len(payload),
                         "nbytes": len(raw), "dtype": "text",
                         "shape": []})
        payload += raw

    header = json.dumps({"format_version": _FORMAT_VERSION,
                         "state": state,
                         "sections": sections}).encode("utf-8")
    blob = bytearray()
    blob += _MAGIC
    blob += struct.pack("<Q", len(header))
    blob += header
    blob += payload
    blob += _FOOTER
    blob += hashlib.sha256(bytes(blob)).digest()
    atomic_write_bytes(path, bytes(blob))


def read_checkpoint(path: str) -> Tuple[Dict[str, Any],
                                        Dict[str, np.ndarray],
                                        Dict[str, str]]:
    """Read and verify a checkpoint; raise :class:`CheckpointError` on
    any corruption (truncation, bit-flip, bad header)."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise CheckpointError(f"cannot read checkpoint {path}: {e}") from e
    try:
        min_len = len(_MAGIC) + 8 + len(_FOOTER) + 32
        if len(blob) < min_len:
            raise CheckpointError("file too short")
        if blob[:len(_MAGIC)] != _MAGIC:
            raise CheckpointError("bad magic")
        digest = blob[-32:]
        body = blob[:-32]
        if body[-len(_FOOTER):] != _FOOTER:
            raise CheckpointError("missing footer (truncated?)")
        if hashlib.sha256(body).digest() != digest:
            raise CheckpointError("checksum mismatch (corrupt)")
        (header_len,) = struct.unpack_from("<Q", blob, len(_MAGIC))
        hdr_start = len(_MAGIC) + 8
        hdr_end = hdr_start + header_len
        if hdr_end > len(body) - len(_FOOTER):
            raise CheckpointError("header overruns file")
        header = json.loads(body[hdr_start:hdr_end].decode("utf-8"))
        if header.get("format_version") != _FORMAT_VERSION:
            raise CheckpointError(
                f"unsupported format_version {header.get('format_version')}")
        payload = body[hdr_end:-len(_FOOTER)]
        arrays: Dict[str, np.ndarray] = {}
        texts: Dict[str, str] = {}
        for sec in header["sections"]:
            raw = payload[sec["offset"]:sec["offset"] + sec["nbytes"]]
            if len(raw) != sec["nbytes"]:
                raise CheckpointError(
                    f"section {sec['name']} truncated")
            if sec["dtype"] == "text":
                texts[sec["name"]] = raw.decode("utf-8")
            else:
                arrays[sec["name"]] = np.frombuffer(
                    raw, dtype=np.dtype(sec["dtype"])
                ).reshape(sec["shape"]).copy()
        return header["state"], arrays, texts
    except CheckpointError:
        raise
    except Exception as e:  # malformed JSON, bad struct, bad utf-8, ...
        raise CheckpointError(f"corrupt checkpoint {path}: {e}") from e


def is_valid_checkpoint(path: str) -> bool:
    try:
        read_checkpoint(path)
        return True
    except CheckpointError:
        return False


# ---------------------------------------------------------------------------
# paths / retention / resume scan
# ---------------------------------------------------------------------------

def checkpoint_path(output_model: str, iteration: int) -> str:
    return f"{output_model}.ckpt_iter_{int(iteration)}"


def list_numbered(prefix: str) -> List[Tuple[int, str]]:
    """List ``{prefix}<N>`` files as ``(N, path)`` sorted ascending by N.

    ``prefix`` includes everything up to the number, e.g.
    ``model.txt.ckpt_iter_`` or ``model.txt.snapshot_iter_``.
    """
    dirname = os.path.dirname(os.path.abspath(prefix)) or "."
    base = os.path.basename(prefix)
    pat = re.compile(re.escape(base) + r"(\d+)$")
    out: List[Tuple[int, str]] = []
    try:
        names = os.listdir(dirname)
    except OSError:
        return []
    for name in names:
        m = pat.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(dirname, name)))
    out.sort()
    return out


def prune_numbered(prefix: str, keep: int) -> int:
    """Delete all but the newest ``keep`` ``{prefix}<N>`` files; return
    the number removed."""
    keep = max(1, int(keep))
    files = list_numbered(prefix)
    removed = 0
    for _, path in files[:-keep] if len(files) > keep else []:
        try:
            os.unlink(path)
            removed += 1
        except OSError:
            pass
    return removed


def find_resume_checkpoint(output_model: str,
                           fingerprint: Optional[str] = None,
                           ) -> Optional[str]:
    """Newest *valid* checkpoint for ``output_model``, or None.

    Corrupt/truncated files (checksum failure) are skipped with a
    warning and the previous one is tried; a fingerprint mismatch
    (different training config) is likewise skipped.
    """
    for _, path in reversed(list_numbered(output_model + ".ckpt_iter_")):
        try:
            state, _, _ = read_checkpoint(path)
        except CheckpointError as e:
            log_warning(f"resume: skipping invalid checkpoint {path}: {e}")
            continue
        if fingerprint and state.get("config_fingerprint") not in (
                None, fingerprint):
            log_warning(
                f"resume: skipping {path}: config fingerprint mismatch "
                f"({state.get('config_fingerprint')} != {fingerprint})")
            continue
        return path
    return None


# ---------------------------------------------------------------------------
# config fingerprint
# ---------------------------------------------------------------------------

# Params that do not affect the trained model — a checkpoint from a run
# that differed only in these is still resumable.
_FINGERPRINT_EXCLUDE = frozenset({
    "resume", "output_model", "snapshot_freq", "snapshot_keep",
    "nan_guard", "on_device_loss", "verbosity", "task", "data", "valid",
    "input_model", "save_binary", "header", "label_column",
})

# Topology knobs: they decide WHERE the computation runs (plan, mesh,
# merge collective), not WHAT it computes — serial/data-parallel and
# allreduce/reduce_scatter produce bit-identical models. They are kept
# out of the model fingerprint so a checkpoint written on an 8-device
# data-parallel mesh resumes on 4 devices or serial (elastic resume);
# the topology it was written under is recorded separately as a
# descriptor (``topology_descriptor``) for the restore path to diff.
_TOPOLOGY_EXCLUDE = frozenset({
    "tree_learner", "num_machines", "dp_hist_merge", "machines",
    "machine_list_filename", "local_listen_port", "time_out",
    "feature_shard_storage", "device_type",
})


def config_fingerprint(params: Dict[str, Any]) -> str:
    """Short stable hash of the model-affecting training params.

    This is the MODEL fingerprint: learning params only. Topology
    knobs (``_TOPOLOGY_EXCLUDE``) are excluded so the same logical job
    resumed on a different mesh shape or tree learner still matches
    its own checkpoints."""
    items = []
    skip = _FINGERPRINT_EXCLUDE | _TOPOLOGY_EXCLUDE
    for k in sorted(params):
        if k in skip or callable(params[k]):
            continue
        items.append((k, repr(params[k])))
    blob = json.dumps(items).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()[:16]


def topology_descriptor(gbdt) -> Dict[str, Any]:
    """Where a training run executes: tree learner, parallel plan mode,
    shard count, device count and histogram-merge collective. Recorded
    next to (not inside) the model fingerprint in every checkpoint, so
    restore can tell "same model, different devices" apart from
    "different model" (checkpoint.py:268-288). A plan's shards are the
    ranks of its group: ``num_shards`` and ``num_machines`` record the
    world size. ``num_devices`` is ``torch.cuda.device_count()`` on the
    card and 1 on the CPU."""
    import torch
    cfg = getattr(gbdt, "config", None)
    plan = getattr(gbdt, "plan", None)
    dev = getattr(gbdt, "device", None)
    on_card = dev is not None and getattr(dev, "type", "") == "cuda"
    shards = int(plan.num_shards) if plan is not None else 1
    return {
        "tree_learner": str(getattr(cfg, "tree_learner", "serial")),
        "parallel_mode": (str(plan.parallel_mode) if plan is not None
                          else "serial"),
        "num_shards": shards,
        "num_devices": int(torch.cuda.device_count()) if on_card else 1,
        "dp_hist_merge": (str(plan.hist_merge) if plan is not None
                          else ""),
        "num_machines": max(int(getattr(cfg, "num_machines", 1) or 1),
                            shards),
    }


# ---------------------------------------------------------------------------
# RNG stream (de)serialization
# ---------------------------------------------------------------------------

def _rng_state_to_json(state: tuple) -> Dict[str, Any]:
    name, key, pos, has_gauss, cached = state
    return {"name": name, "key": np.asarray(key, dtype=np.uint32).tolist(),
            "pos": int(pos), "has_gauss": int(has_gauss),
            "cached_gaussian": float(cached)}


def _rng_state_from_json(d: Dict[str, Any]) -> tuple:
    return (d["name"], np.asarray(d["key"], dtype=np.uint32),
            int(d["pos"]), int(d["has_gauss"]),
            float(d["cached_gaussian"]))


# ---------------------------------------------------------------------------
# engine-facing capture / restore
# ---------------------------------------------------------------------------

def capture_training_checkpoint(booster, callbacks: Sequence,
                                *, begin_iteration: int,
                                end_iteration: int,
                                params: Dict[str, Any],
                                ) -> Tuple[Dict[str, Any],
                                           Dict[str, np.ndarray],
                                           Dict[str, str]]:
    """Snapshot the booster's complete mutable training state.

    Drains any pending step iterations first (``model_to_string`` syncs
    trees), so the captured iteration counter equals the number of RNG
    draws consumed — the invariant bit-identical resume depends on.
    """
    model_text = booster.model_to_string(num_iteration=-1)
    gb_state, gb_arrays = booster._gbdt.training_state()

    cb_states = []
    for cb in callbacks:
        get_state = getattr(cb, "get_state", None)
        key = getattr(cb, "state_key", None)
        if get_state is not None and key is not None:
            cb_states.append({"key": key, "state": get_state()})

    state: Dict[str, Any] = {
        "iteration": int(booster.current_iteration()),
        "begin_iteration": int(begin_iteration),
        "end_iteration": int(end_iteration),
        "config_fingerprint": config_fingerprint(params),
        "topology": topology_descriptor(booster._gbdt),
        "best_iteration": int(getattr(booster, "best_iteration", -1)),
        "best_score": getattr(booster, "best_score", None),
        "gbdt": gb_state,
        "callbacks": cb_states,
    }
    texts = {"model": model_text}
    return state, gb_arrays, texts


def write_training_checkpoint(path: str, booster, callbacks: Sequence,
                              *, begin_iteration: int,
                              end_iteration: int,
                              params: Dict[str, Any]) -> None:
    state, arrays, texts = capture_training_checkpoint(
        booster, callbacks, begin_iteration=begin_iteration,
        end_iteration=end_iteration, params=params)
    write_checkpoint(path, state, arrays, texts)
    log_info(f"checkpoint written: {path} "
             f"(iteration {state['iteration']})")


def restore_training_checkpoint(booster, callbacks: Sequence,
                                state: Dict[str, Any],
                                arrays: Dict[str, np.ndarray],
                                texts: Dict[str, str]) -> None:
    """Load a captured state back into a live booster + callback set.

    The booster must already be data-bound (``_ensure_gbdt`` ran) with
    the same config the checkpoint was written under; trees are replaced
    in place so the ``Booster._trees`` alias survives.
    """
    model_text = texts.get("model", "")
    rest = model_text.split("Tree=", 1)
    trees: List[Tree] = []
    if len(rest) == 2:
        for b in ("Tree=" + rest[1]).split("Tree=")[1:]:
            b = b.split("end of trees")[0]
            trees.append(Tree.from_text("Tree=" + b))

    booster._gbdt.load_training_state(state["gbdt"], arrays, trees)
    if hasattr(booster, "_model_version"):
        booster._model_version += 1     # invalidate predict caches

    booster.best_iteration = int(state.get("best_iteration", -1))
    if state.get("best_score") is not None:
        booster.best_score = state["best_score"]

    by_key: Dict[str, Any] = {}
    for cb in callbacks:
        key = getattr(cb, "state_key", None)
        if key is not None and getattr(cb, "set_state", None) is not None:
            by_key[key] = cb
    for entry in state.get("callbacks", []):
        cb = by_key.get(entry["key"])
        if cb is not None:
            cb.set_state(entry["state"])
        else:
            log_warning(f"resume: no callback to receive state "
                        f"'{entry['key']}' (ignored)")
