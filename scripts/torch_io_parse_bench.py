#!/usr/bin/env python3
"""The port's text parsers, each fast path against its general path, on
the files of chip_smoke.py's ``[cli]`` phase.

``lightgbm_tpu_torch/io.py`` parses a delimited body with ``np.loadtxt``
when it is rectangular and every token a number, and a LibSVM body whose
every token after the label is one ``idx:value`` with one
``np.fromstring`` pass; any other body goes through the general path
(one bytes array of tokens, converted in one cast). This script writes

- the ``[cli]`` CSV: the Higgs-shaped data at 2^20 rows (label and 28
  features, a header line), and
- the ``[cli]`` LibSVM file: the first 2^16 rows of ``[sparse]``'s
  Allstate-shaped CSR (128 nonzeros a row),

then parses each body ``--reps`` times by each path, in turns (fast,
general, general, fast, ...), from lines already read, and prints each
path's seconds per run, its median, and the peak resident set above the
start of the run. It checks that both paths give bit-equal results.

Usage, from the repository root (a host with ~8 GiB free):

    python scripts/torch_io_parse_bench.py [--reps N] [--csv-rows R]
        [--svm-rows R] [--out DIR]
"""

import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--csv-rows", type=int, default=None)
    ap.add_argument("--svm-rows", type=int, default=1 << 16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np

    import chip_smoke as C
    from lightgbm_tpu_torch import io as lio
    d = args.out or os.path.join(C.HERE, "build", "io_parse_bench")
    os.makedirs(d, exist_ok=True)
    X, y = C.make_higgs_like(args.csv_rows or C.VALID_ROWS)
    csv = os.path.join(d, "train.csv")
    C.write_csv(csv, ["label"] + [f"f{i}" for i in range(X.shape[1])],
                np.column_stack([y, X]))
    del X, y
    Xs, ys = C.make_allstate_like(args.svm_rows)
    svm = os.path.join(d, "allstate.svm")
    C.write_libsvm(svm, Xs, ys)
    del Xs, ys
    csv_lines = lio._read_lines(csv)[1:]
    svm_lines = lio._read_lines(svm)

    def loadtxt_off(*a, **k):
        raise ValueError("general path")

    def general_csv():
        real = lio.np.loadtxt
        lio.np.loadtxt = loadtxt_off
        try:
            return lio._parse_delimited(csv_lines, ",")
        finally:
            lio.np.loadtxt = real

    def general_svm():
        real = lio._parse_libsvm_regular
        lio._parse_libsvm_regular = lambda *a: None
        try:
            return lio._parse_libsvm(svm_lines)
        finally:
            lio._parse_libsvm_regular = real

    cases = {
        "csv": (f"{len(csv_lines)} rows x 29 columns, "
                f"{os.path.getsize(csv) / 2**20:.1f} MiB",
                lambda: lio._parse_delimited(csv_lines, ","), general_csv),
        "libsvm": (f"{len(svm_lines)} rows x 128 nonzeros, "
                   f"{os.path.getsize(svm) / 2**20:.1f} MiB",
                   lambda: lio._parse_libsvm(svm_lines), general_svm),
    }
    for name, (what, fast, general) in cases.items():
        a, b = fast(), general()
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        equal = all(np.array_equal(p, q, equal_nan=True)
                    and p.dtype == q.dtype for p, q in zip(a, b))
        if not equal:
            print(f"[{name}] fast and general paths differ", flush=True)
            return 1
        del a, b
        times = {"fast": [], "general": []}
        peaks = {"fast": 0, "general": 0}
        for i in range(args.reps):
            order = ("fast", "general") if i % 2 == 0 else ("general",
                                                            "fast")
            for arm in order:
                fn = fast if arm == "fast" else general
                with C.HostPeak() as hp:
                    t0 = time.perf_counter()
                    r = fn()
                    times[arm].append(time.perf_counter() - t0)
                del r
                peaks[arm] = max(peaks[arm], hp.peak)
        med = {k: statistics.median(v) for k, v in times.items()}
        for arm in ("fast", "general"):
            print(f"[{name}] {what}: {arm:7s} seconds "
                  f"{' '.join(f'{t:.3f}' for t in times[arm])} (median "
                  f"{med[arm]:.3f}; peak resident set above the start "
                  f"{peaks[arm] / 2**30:.2f} GiB)", flush=True)
        print(f"[{name}] general / fast median: "
              f"{med['general'] / med['fast']:.2f}x; results bit-equal",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
