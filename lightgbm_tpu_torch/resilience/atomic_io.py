"""Atomic file writes: tmp file in the target directory + fsync +
``os.replace`` (a copy of ``lightgbm_tpu/resilience/atomic_io.py``).

A plain ``open(path, "w").write(...)`` interrupted by SIGKILL (a
preempted job's common case) leaves a truncated file under the final
name, which ``init_model``/resume then half-parses. The replace dance
guarantees readers only ever observe the OLD complete file or the NEW
complete file — never a prefix. The directory fsync makes the rename
itself durable (without it a host crash can roll the directory entry
back even though the data blocks landed).
"""

from __future__ import annotations

import os
import tempfile

__all__ = ["atomic_write_bytes", "atomic_write_text",
           "atomic_append_line"]


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` atomically (tmp + fsync + replace)."""
    path = os.fspath(path)
    dirname = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".tmp.",
                               dir=dirname)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        tmp = None
        try:
            dfd = os.open(dirname, os.O_RDONLY)
        except OSError:
            return  # platform without directory fds; rename still atomic
        try:
            os.fsync(dfd)
        except OSError:
            pass  # some filesystems reject directory fsync; best effort
        finally:
            os.close(dfd)
    finally:
        if tmp is not None and os.path.exists(tmp):
            os.unlink(tmp)


def atomic_write_text(path: str, text: str) -> None:
    atomic_write_bytes(path, text.encode("utf-8"))


def atomic_append_line(path: str, line: str, fsync: bool = False) -> None:
    """Append one newline-terminated record to ``path`` atomically
    with respect to line boundaries (the telemetry event log's JSONL
    appends).

    ``O_APPEND`` + a single ``os.write`` of the whole record means a
    reader (or a concurrent appender) never observes a torn line: POSIX
    serializes the offset bump with the write. A SIGKILL mid-write can
    still truncate the FINAL record — readers of the event log treat a
    non-parsing last line as an interrupted run's tail, the same
    old-or-new contract :func:`atomic_write_bytes` gives whole files.
    ``fsync`` is opt-in: the event log is an observability artifact,
    not recovery state (checkpoints are), so losing the page-cache tail
    on host crash is acceptable by default and keeps appends off the
    disk-latency path.
    """
    data = line.encode("utf-8")
    if not data.endswith(b"\n"):
        data += b"\n"
    fd = os.open(os.fspath(path),
                 os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, data)
        if fsync:
            os.fsync(fd)
    finally:
        os.close(fd)
