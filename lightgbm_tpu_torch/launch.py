"""Multi-process training launcher (the port of
``lightgbm_tpu/launch.py``): the orchestration analog of the
reference's Dask integration (``python-package/lightgbm/dask.py:415``
``_train``: find workers, open ports, build the ``machines`` string, run
one network-initialized training per worker) and of ``mpirun`` for the
MPI build. The per-worker "network init" is
``torch.distributed.init_process_group``, so the launcher only has to
pick a rendezvous port, spawn N copies of the user's script with rank
environment variables, and fail fast if any worker dies (the
reference's collectives are fail-fast too, SURVEY.md 5).

Usage::

    python -m lightgbm_tpu_torch.launch -n 2 train_script.py [args...]
    python -m lightgbm_tpu_torch.launch -n 2 --cpu train_script.py
    python -m lightgbm_tpu_torch.launch --hostfile hosts.txt script.py

Each worker sees ``LIGHTGBM_TPU_COORDINATOR``, ``LIGHTGBM_TPU_RANK``
and ``LIGHTGBM_TPU_NUM_PROCESSES``; a script that calls
``lightgbm_tpu_torch.parallel.init_distributed()`` (or trains with
``num_machines`` > 1) picks them up. Rank r runs on ``cuda:(r %
device_count)``; ``--cpu`` sets ``LIGHTGBM_TPU_DEVICE_TYPE=cpu`` for
every rank, which makes the group gloo on the host (the script still
passes ``device_type="cpu"`` to its Datasets).

``--hostfile`` reaches across machines over DCN: an mpirun-style file
(one ``host [slots=N]`` per line, ``#`` comments) mirroring the
reference's ``machine_list_filename`` (config.h) and the worker
discovery of ``dask.py:415``. Remote ranks spawn over ``ssh`` (BatchMode
— keys must be set up, as with mpirun); hosts named ``localhost`` /
``127.0.0.1`` spawn directly. The coordinator is the first host at
``--port``.
"""

from __future__ import annotations

import argparse
import os
import shlex
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence, Tuple

__all__ = ["launch", "launch_hosts", "parse_hostfile", "main"]

_LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_fail_fast(procs: List[subprocess.Popen]) -> int:
    """Poll ALL workers: a rank-order wait would block on rank 0 while a
    later rank has already died, defeating fail-fast. Returns the first
    nonzero exit code (stragglers SIGTERMed) or 0."""
    rc = 0
    alive = list(procs)
    while alive:
        for p in list(alive):
            code = p.poll()
            if code is None:
                continue
            alive.remove(p)
            if code != 0 and rc == 0:
                rc = code
                for q in procs:
                    if q.poll() is None:
                        q.send_signal(signal.SIGTERM)
        if alive:
            time.sleep(0.1)
    return rc


def launch(script_argv: List[str], num_processes: int,
           coordinator: Optional[str] = None, cpu: bool = False) -> int:
    """Spawn ``num_processes`` local workers; returns the first nonzero
    exit code (killing the stragglers, fail-fast) or 0. ``cpu`` puts
    every rank on the host."""
    if num_processes < 1:
        raise ValueError("num_processes must be >= 1")
    coord = coordinator or f"127.0.0.1:{_free_port()}"
    procs = []
    try:
        for rank in range(num_processes):
            env = dict(os.environ)
            if cpu:
                env["LIGHTGBM_TPU_DEVICE_TYPE"] = "cpu"
            env["LIGHTGBM_TPU_COORDINATOR"] = coord
            env["LIGHTGBM_TPU_RANK"] = str(rank)
            env["LIGHTGBM_TPU_NUM_PROCESSES"] = str(num_processes)
            procs.append(subprocess.Popen(
                [sys.executable] + list(script_argv), env=env))
        return _wait_fail_fast(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def parse_hostfile(path: str) -> List[Tuple[str, int]]:
    """mpirun-style hostfile -> [(host, slots)]. One host per line,
    optional ``slots=N`` (default 1), ``#`` comments and blank lines
    ignored. The analog of parsing ``machine_list_filename``
    (config.h machine_list_filename; network.cpp Network::Init)."""
    hosts: List[Tuple[str, int]] = []
    with open(path) as f:
        for ln_no, raw in enumerate(f, 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            host, slots = parts[0], 1
            for tok in parts[1:]:
                if tok.startswith("slots="):
                    slots = int(tok.split("=", 1)[1])
                else:
                    raise ValueError(
                        f"{path}:{ln_no}: unrecognized token {tok!r} "
                        "(expected 'slots=N')")
            if slots < 1:
                raise ValueError(f"{path}:{ln_no}: slots must be >= 1")
            hosts.append((host, slots))
    if not hosts:
        raise ValueError(f"hostfile {path} lists no hosts")
    return hosts


def _remote_cmd(host: str, env: dict, script_argv: Sequence[str],
                ssh: str, python_exe: str, cwd: str) -> List[str]:
    """Build the ssh command for one remote rank: exports the
    coordinator/rank env and runs the script from the same cwd."""
    exports = " ".join(
        f"{k}={shlex.quote(v)}" for k, v in sorted(env.items()))
    inner = (f"cd {shlex.quote(cwd)} && env {exports} "
             + " ".join(shlex.quote(a)
                        for a in [python_exe, *script_argv]))
    # -tt forces a remote tty so killing the local ssh client HUPs the
    # remote python too (fail-fast must reach remote ranks, not just
    # their ssh clients)
    return [ssh, "-tt", "-o", "BatchMode=yes", host, inner]


def launch_hosts(script_argv: List[str], hosts: List[Tuple[str, int]],
                 port: int = 29500, ssh: str = "ssh",
                 python_exe: Optional[str] = None,
                 _popen=subprocess.Popen) -> int:
    """Spawn one worker per slot across ``hosts`` (first host runs the
    coordinator on ``port``); fail-fast like :func:`launch`. Local
    hosts spawn directly, remote hosts over ``ssh`` with the rank env
    exported — the multi-machine reach of dask.py:415's _train
    (worker discovery -> machines string -> per-worker network init).
    """
    total = sum(s for _, s in hosts)
    if hosts[0][0] in _LOCAL_HOSTS and any(
            h not in _LOCAL_HOSTS for h, _ in hosts):
        raise ValueError(
            "the first hostfile host runs the coordinator, and remote "
            f"ranks cannot reach {hosts[0][0]!r} — put a routable "
            "hostname/IP of this machine first")
    coord = f"{hosts[0][0]}:{port}"
    py = python_exe or sys.executable
    procs: List[subprocess.Popen] = []
    rank = 0
    try:
        for host, slots in hosts:
            local = host in _LOCAL_HOSTS
            for _ in range(slots):
                rank_env = {
                    "LIGHTGBM_TPU_COORDINATOR": coord,
                    "LIGHTGBM_TPU_RANK": str(rank),
                    "LIGHTGBM_TPU_NUM_PROCESSES": str(total),
                }
                if local:
                    env = dict(os.environ)
                    env.update(rank_env)
                    procs.append(_popen([py] + list(script_argv),
                                        env=env))
                else:
                    procs.append(_popen(_remote_cmd(
                        host, rank_env, script_argv, ssh, py,
                        os.getcwd())))
                rank += 1
        return _wait_fail_fast(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.launch",
        description="Run a training script as N coordinated processes")
    ap.add_argument("-n", "--num-processes", type=int, default=None)
    ap.add_argument("--coordinator", default=None,
                    help="host:port (default: 127.0.0.1:<free port>)")
    ap.add_argument("--hostfile", default=None,
                    help="mpirun-style host list: 'host [slots=N]' per "
                         "line; remote ranks spawn over ssh")
    ap.add_argument("--cpu", action="store_true",
                    help="run every rank on the host (gloo), not on "
                         "cuda:(rank %% device_count)")
    ap.add_argument("--port", type=int, default=29500,
                    help="coordinator port on the first hostfile host")
    ap.add_argument("--ssh", default="ssh",
                    help="remote shell command (hostfile mode)")
    ap.add_argument("--python", default=None, dest="python_exe",
                    help="python executable on the hosts (hostfile "
                         "mode; default: this launcher's interpreter)")
    ap.add_argument("script", help="python script to run per worker")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    ns = ap.parse_args(argv)
    if ns.hostfile is not None:
        if ns.num_processes is not None:
            ap.error("-n and --hostfile are mutually exclusive")
        if ns.coordinator is not None:
            ap.error("--coordinator applies to -n mode only; in "
                     "--hostfile mode the first host runs the "
                     "coordinator on --port")
        return launch_hosts([ns.script] + ns.args,
                            parse_hostfile(ns.hostfile),
                            port=ns.port, ssh=ns.ssh,
                            python_exe=ns.python_exe)
    if ns.num_processes is None:
        ap.error("one of -n or --hostfile is required")
    return launch([ns.script] + ns.args, ns.num_processes,
                  ns.coordinator, cpu=ns.cpu)


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
