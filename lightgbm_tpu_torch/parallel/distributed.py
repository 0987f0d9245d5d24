"""Process bootstrap and the host-side protocols of multi-process
training (the port of ``lightgbm_tpu/parallel/distributed.py``).

The reference's machine-list networking (``linkers_socket.cpp:24``
parses ``machines``/``machine_list_file`` and builds a TCP mesh;
``Network::Init`` assigns ranks) becomes one
``torch.distributed.init_process_group`` over a TCP rendezvous:

- ``machines`` / ``machine_list_file``: host:port entries; the FIRST is
  the rendezvous address;
- ``num_machines``: the world size;
- ``local_listen_port``: unused (the rendezvous port is the first
  entry's), accepted;
- the rank: ``LIGHTGBM_TPU_RANK`` (set by ``lightgbm_tpu_torch.launch``).

Rank r runs on ``cuda:(r % device_count)`` unless the caller asks for
the CPU (``device_type="cpu"``, or ``LIGHTGBM_TPU_DEVICE_TYPE=cpu``,
which the launcher's ``--cpu`` sets). The backend follows
``comms.pick_backend``.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional

import numpy as np

__all__ = ["init_distributed", "maybe_init_distributed", "world_size",
           "rank", "default_comm", "feature_blocks", "sync_bin_mappers",
           "check_replicas_identical", "global_mean_init_scores"]

_initialized = False
_COMM = None


def _dist():
    import torch.distributed as dist
    return dist


def world_size() -> int:
    """Processes in the default group (1 without one)."""
    d = _dist()
    return d.get_world_size() if d.is_available() and d.is_initialized() \
        else 1


def rank() -> int:
    d = _dist()
    return d.get_rank() if d.is_available() and d.is_initialized() else 0


def default_comm():
    """The :class:`~.comms.Comm` of the default group (one a process:
    its report is the run's live record of collectives)."""
    global _COMM
    from .comms import Comm
    if _COMM is None:
        _COMM = Comm(None, label="default")
    return _COMM


def _device_type(device_type: Optional[str]) -> str:
    import torch
    if device_type is None:
        device_type = os.environ.get("LIGHTGBM_TPU_DEVICE_TYPE", "")
    if not device_type:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return device_type


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device_type: Optional[str] = None,
                     timeout_s: Optional[float] = None) -> None:
    """Join the process group (idempotent).

    With no arguments it reads the launcher's environment
    (``LIGHTGBM_TPU_COORDINATOR``, ``_RANK``, ``_NUM_PROCESSES``).
    ``timeout_s`` (default ``LIGHTGBM_TPU_DIST_TIMEOUT_S`` or 600)
    bounds every collective: a rank whose peer died raises after it
    instead of waiting forever."""
    global _initialized, _COMM
    d = _dist()
    if _initialized or d.is_initialized():
        _initialized = True
        return
    env_coord = os.environ.get("LIGHTGBM_TPU_COORDINATOR")
    env_n = os.environ.get("LIGHTGBM_TPU_NUM_PROCESSES")
    env_rank = os.environ.get("LIGHTGBM_TPU_RANK")
    if coordinator_address is None and env_coord:
        if env_n is None or env_rank is None:
            raise ValueError(
                "LIGHTGBM_TPU_COORDINATOR requires "
                "LIGHTGBM_TPU_NUM_PROCESSES and LIGHTGBM_TPU_RANK too "
                "(the lightgbm_tpu_torch.launch launcher sets all three)")
        coordinator_address = env_coord
    if num_processes is None and env_n is not None:
        num_processes = int(env_n)
    if process_id is None and env_rank is not None:
        process_id = int(env_rank)
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "init_distributed needs the rendezvous address, the world "
            "size and this process's rank (run under `python -m "
            "lightgbm_tpu_torch.launch`, or pass them)")
    import torch
    from .comms import pick_backend
    dt = _device_type(device_type)
    backend = pick_backend(dt, int(num_processes))
    if dt == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    if timeout_s is None:
        timeout_s = float(os.environ.get("LIGHTGBM_TPU_DIST_TIMEOUT_S",
                                         "600"))
    d.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    _initialized = True
    _COMM = None


def maybe_init_distributed(config) -> bool:
    """Config-driven init (``Network::Init``, network.cpp:45). True when
    it joined a group; ``num_machines <= 1`` is a no-op, the reference's
    is_parallel gate (application.cpp:171)."""
    n = int(getattr(config, "num_machines", 1) or 1)
    if n <= 1:
        return False
    machines = getattr(config, "machines", "") or ""
    mlist_file = (getattr(config, "machine_list_filename", "")
                  or getattr(config, "machine_list_file", "") or "")
    if not machines and mlist_file and os.path.exists(mlist_file):
        with open(mlist_file) as f:
            machines = ",".join(ln.strip() for ln in f if ln.strip())
    coordinator = machines.split(",")[0].strip() if machines else None
    rank_env = os.environ.get("LIGHTGBM_TPU_RANK")
    process_id = int(rank_env) if rank_env is not None else None
    init_distributed(coordinator_address=coordinator, num_processes=n,
                     process_id=process_id,
                     device_type=getattr(config, "device_type", None))
    return True


def feature_blocks(num_features: int, num_processes: int):
    """The per-process feature ownership blocks; the one source of truth
    for ``Dataset`` (which fits exactly these blocks) and
    :func:`sync_bin_mappers` (which merges them)."""
    return np.array_split(np.arange(num_features), num_processes)


def sync_bin_mappers(bin_mappers: List, comm=None) -> List:
    """Globally consistent bin mappers (the reference's
    ``ConstructBinMappersFromTextData`` Allgather,
    ``dataset_loader.cpp:1070``): each process serializes its owned
    feature block (``BinMapper.state_arrays``) and an all-gather merges
    the blocks, so every process ends with the identical full set. A
    collective; the identity at world size 1.

    The payload travels as raw bytes: bin bounds are f64, and the
    categorical ids are int64, shipped as their bits through the f64
    payload (a float cast rounds ids >= 2^53)."""
    if world_size() <= 1:
        return bin_mappers
    from ..binning import BinMapper
    comm = comm if comm is not None else default_comm()
    P, me = comm.world_size, comm.rank
    F = len(bin_mappers)
    blocks = feature_blocks(F, P)
    scal, ubs, cats = [], [], []
    ub_off, cat_off = [0], [0]
    for f in blocks[me]:
        s, ub, ct = bin_mappers[f].state_arrays()
        scal.append(np.asarray(s, np.float64))
        ubs.append(np.asarray(ub, np.float64))
        cats.append(np.asarray(ct, np.int64))
        ub_off.append(ub_off[-1] + len(ub))
        cat_off.append(cat_off[-1] + len(ct))
    ns = len(scal[0]) if scal else 0
    payload = np.concatenate([
        np.asarray([len(blocks[me]), ns], np.float64),
        np.asarray(ub_off, np.float64), np.asarray(cat_off, np.float64),
        np.concatenate(scal) if scal else np.empty(0),
        np.concatenate(ubs) if ubs else np.empty(0),
        (np.concatenate(cats) if cats else np.empty(0, np.int64))
        .view(np.float64)])
    rows = comm.gather_rows(_padded_rows(comm, payload), phase="host")
    merged: List = [None] * F
    for p in range(P):
        row = np.ascontiguousarray(rows[p]).view(np.float64)
        nf, ns_p = int(row[0]), int(row[1])
        pos = 2
        ub_off_p = row[pos:pos + nf + 1].astype(np.int64)
        pos += nf + 1
        cat_off_p = row[pos:pos + nf + 1].astype(np.int64)
        pos += nf + 1
        scal_p = row[pos:pos + nf * ns_p].reshape(nf, ns_p)
        pos += nf * ns_p
        ub_p = row[pos:pos + ub_off_p[-1]]
        pos += int(ub_off_p[-1])
        cat_p = np.ascontiguousarray(
            row[pos:pos + cat_off_p[-1]]).view(np.int64)
        for j, f in enumerate(blocks[p]):
            merged[f] = BinMapper.from_state_arrays(
                scal_p[j], ub_p[ub_off_p[j]:ub_off_p[j + 1]],
                cat_p[cat_off_p[j]:cat_off_p[j + 1]])
    return merged


def _padded_rows(comm, payload: np.ndarray) -> np.ndarray:
    """[1, maxlen] f64 of ``payload`` padded to the longest rank's, so
    that the all-gather is rectangular."""
    n = comm.gather_rows(np.asarray([payload.size], np.int64))
    buf = np.zeros((1, int(n.max())), np.float64)
    buf[0, :payload.size] = payload
    return buf


def check_replicas_identical(datasets, comm=None) -> None:
    """Every process must hold the SAME copy of each dataset (the
    feature-parallel learner replicates the full data per worker,
    ``feature_parallel_tree_learner.cpp:38``): compares row counts,
    widths and a full-buffer int64 bin checksum across processes and
    raises ValueError on a mismatch. No-op at world size 1."""
    if world_size() <= 1:
        return
    import torch
    comm = comm if comm is not None else default_comm()
    sig = []
    for ds in datasets:
        bins = ds.bins
        # a full-buffer int64 sum: a strided sample would let corrupted
        # rows between the stride points through
        sig.extend([int(ds.num_data), int(bins.shape[1]),
                    int(bins.reshape(-1).to(torch.int64).sum())])
    allv = comm.gather_rows(np.asarray([sig], np.int64))
    if not (allv == allv[0]).all():
        raise ValueError(
            "tree_learner=feature across machines requires IDENTICAL "
            "full data on every worker, but the loaded copies differ "
            f"across processes (per-process [rows, cols, checksum] x "
            f"datasets: {allv.tolist()}). Load the same unpartitioned "
            "file/array on each machine with pre_partition=true.")


def global_mean_init_scores(init_scores: np.ndarray, comm=None
                            ) -> np.ndarray:
    """The mean over processes of the per-process automatic init scores:
    the reference's ``Network::GlobalSyncUpByMean(init_score)`` in
    BoostFromAverage (gbdt.cpp:313)."""
    if world_size() <= 1:
        return init_scores
    comm = comm if comm is not None else default_comm()
    allv = comm.gather_rows(np.asarray(init_scores, np.float64)[None, :])
    return np.mean(allv, axis=0)
