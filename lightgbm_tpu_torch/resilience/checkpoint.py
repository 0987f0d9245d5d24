"""Retention of numbered training artifacts (a copy of
``prune_numbered`` from ``lightgbm_tpu/resilience/checkpoint.py:185``,
with its listing inlined).

``train`` writes ``{output_model}.snapshot_iter_{N}`` every
``snapshot_freq`` iterations and keeps the newest ``snapshot_keep``.
"""

from __future__ import annotations

import os
import re

__all__ = ["prune_numbered"]


def prune_numbered(prefix: str, keep: int) -> int:
    """Delete all but the newest ``keep`` ``{prefix}<N>`` files (by N);
    return the number removed. ``prefix`` is everything up to the
    number, e.g. ``model.txt.snapshot_iter_``."""
    keep = max(1, int(keep))
    dirname = os.path.dirname(os.path.abspath(prefix)) or "."
    pat = re.compile(re.escape(os.path.basename(prefix)) + r"(\d+)$")
    try:
        names = os.listdir(dirname)
    except OSError:
        return 0
    files = sorted((int(m.group(1)), os.path.join(dirname, name))
                   for name in names for m in [pat.match(name)] if m)
    removed = 0
    for _, path in files[:-keep] if len(files) > keep else []:
        try:
            os.unlink(path)
            removed += 1
        except OSError:
            pass
    return removed
