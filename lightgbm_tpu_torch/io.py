"""Text-file data loading: CSV/TSV/LibSVM autodetect + metadata sidecars.

Port of ``lightgbm_tpu/io.py`` (the reference's ``src/io/parser.cpp:317``
format autodetection, ``src/io/dataset_loader.cpp:203``
``DatasetLoader::LoadFromFile`` and the ``.weight``/``.init``/``.query``
sidecars of ``src/io/metadata.cpp:632,681``), with the same column
semantics: ``label_column``/``weight_column``/``group_column``/
``ignore_column`` take an index or ``name:colname``, and for weight,
group and ignore an integer index does not count the label column.

The JAX package parses with a C library (``native/parser.c``) and falls
back to per-token Python. This port has no native code: it parses the
whole file with vectorised numpy. A rectangular delimited body without
missing-value tokens goes through ``np.loadtxt``'s C reader in one call;
any other body (ragged rows, ``NA``/``null``/empty tokens) splits into
one bytes array that numpy converts in one cast. A LibSVM body whose
every token after the label is one ``idx:value`` is read by one
``np.fromstring`` pass with the colons as separators, each number's
line found from the byte offsets of the newlines; any other LibSVM body
is tokenised as the delimited one is. Every path converts decimal text
with correct rounding (as ``float()`` does), so the matrix, label,
sidecars and names are bit-equal to the JAX package's. Each fast path
earns its place by time: ``scripts/torch_io_parse_bench.py`` times it
against the general path on the same file (PERF.md section 5).
"""

from __future__ import annotations

import io
import os
import warnings
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

__all__ = ["LoadedFile", "load_data_file", "parse_config_file"]

# tokens the delimited parsers read as missing (io.py:175)
_NA_TOKENS = (b"", b"na", b"NA", b"nan", b"NaN", b"null", b"None")


def parse_config_file(path: str) -> dict:
    """Parse a LightGBM ``train.conf``-style file into a params dict
    (io.py:38): ``key = value`` lines, ``#`` comments stripped, the FIRST
    occurrence of a duplicated key wins. Values stay strings; Config
    coerces types downstream."""
    params = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            params.setdefault(k.strip(), v.strip())
    return params


@dataclass
class LoadedFile:
    """Parsed text data + metadata, pre-binning."""
    X: np.ndarray                       # [n, F] float64, NaN for missing
    label: Optional[np.ndarray] = None  # [n]
    weight: Optional[np.ndarray] = None
    group: Optional[np.ndarray] = None  # per-query sizes
    init_score: Optional[np.ndarray] = None
    position: Optional[np.ndarray] = None  # per-row position ids/names
    feature_names: List[str] = field(default_factory=list)


def _read_lines(path: str) -> List[bytes]:
    """The file's non-blank lines, line ends stripped (io.py:70)."""
    with open(path, "rb") as f:
        raw = f.read()
    return [ln.rstrip(b"\r") for ln in raw.split(b"\n") if ln.strip()]


def _detect_delimiter(line: str) -> str:
    # reference CSVParser/TSVParser selection (parser.cpp:317): pick the
    # separator that actually splits the probe line
    if "\t" in line:
        return "\t"
    if "," in line:
        return ","
    return " "


def _is_libsvm(line: str, delim: str) -> bool:
    # a line whose non-leading tokens look like idx:value is LibSVM
    toks = line.split() if delim == " " else line.split(delim)
    for tok in toks[1:3]:
        if ":" in tok:
            head = tok.split(":", 1)[0]
            if head.lstrip("-").isdigit():
                return True
    return False


def _parse_column_spec(spec, names: List[str], *, counts_label: bool,
                       label_idx: int) -> Optional[int]:
    """Resolve a label/weight/group column spec to a RAW column index;
    ``counts_label=False`` applies "an index does not count the label
    column" (io.py:96)."""
    if spec is None or spec == "":
        return None
    s = str(spec)
    if s.startswith("name:"):
        nm = s[5:]
        if nm not in names:
            raise ValueError(f"column name '{nm}' not found in header")
        return names.index(nm)
    idx = int(s)
    if not counts_label and label_idx >= 0 and idx >= label_idx:
        idx += 1
    return idx


def _parse_index_list(spec, names: List[str], label_idx: int) -> List[int]:
    if spec is None or spec == "":
        return []
    s = str(spec)
    if s.startswith("name:"):
        return [names.index(nm) for nm in s[5:].split(",") if nm in names]
    out = []
    for tok in s.split(","):
        tok = tok.strip()
        if not tok:
            continue
        idx = int(tok)
        if label_idx >= 0 and idx >= label_idx:
            idx += 1
        out.append(idx)
    return out


def _to_float(tokens: np.ndarray) -> np.ndarray:
    """A bytes array to float64 in one cast (``float()``'s parse, so
    surrounding whitespace is allowed and rounding is correct)."""
    try:
        return tokens.astype(np.float64)
    except ValueError:
        bad = next(t for t in tokens.tolist() if not _parses(t))
        raise ValueError(f"could not convert string to float: "
                         f"{bad.decode(errors='replace')!r}") from None


def _parses(tok: bytes) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def _line_of_offsets(body: bytes, offsets: np.ndarray) -> np.ndarray:
    """Line number of each byte offset of ``body``."""
    nl = np.flatnonzero(np.frombuffer(body, np.uint8) == 10)
    return np.searchsorted(nl, offsets, side="right")


def _parse_delimited(lines: List[bytes], delim: str) -> np.ndarray:
    """[n, width] float64 of delimited lines; missing tokens and the
    cells past a short row's end are NaN (io.py:161)."""
    d = delim.encode()
    text = b"\n".join(lines)
    try:
        # the common case: rectangular, every token a number
        X = np.loadtxt(io.BytesIO(text), delimiter=delim, dtype=np.float64,
                       comments=None, ndmin=2, encoding="utf-8")
        if X.shape[0] == len(lines):
            return X
    except ValueError:
        pass
    # tokens per line = delimiters on the line + 1
    dpos = np.flatnonzero(np.frombuffer(text, np.uint8) == d[0])
    per_line = np.bincount(_line_of_offsets(text, dpos),
                           minlength=len(lines)) + 1
    toks = np.array(text.replace(b"\n", d).split(d))
    toks = np.char.strip(toks).astype(f"S{max(3, toks.itemsize)}")
    na = np.isin(toks, np.array(_NA_TOKENS))
    toks[na] = b"nan"
    vals = _to_float(toks)
    width = int(per_line.max())
    if (per_line == width).all():
        return vals.reshape(len(lines), width)
    out = np.full((len(lines), width), np.nan)
    rows = np.repeat(np.arange(len(lines)), per_line)
    starts = np.concatenate([[0], np.cumsum(per_line)[:-1]])
    cols = np.arange(len(vals)) - np.repeat(starts, per_line)
    out[rows, cols] = vals
    return out


def _parse_libsvm(lines: List[bytes], num_features_hint: int = 0):
    """LibSVM ``label idx:val ...`` -> (labels, dense X with 0 default)
    (io.py:181): absent entries are zero, tokens without ``:`` after
    the label are skipped, the widest index (or the hint) sets the
    width."""
    text = b"\n".join(lines)
    buf = np.frombuffer(text, np.uint8)
    ws = (buf == 32) | (buf == 9) | (buf == 10)
    start = np.flatnonzero(~ws & np.concatenate([[True], ws[:-1]]))
    line = _line_of_offsets(text, start)
    fast = _parse_libsvm_regular(text, buf, ws, line, len(lines),
                                 num_features_hint)
    if fast is not None:
        return fast
    toks = np.array(text.split())
    first = np.concatenate([[True], line[1:] != line[:-1]])
    labels = _to_float(toks[first])
    if len(labels) != len(lines):
        raise ValueError("LibSVM file has a line without a label")
    rest, rest_line = toks[~first], line[~first]
    feat = np.char.find(rest, b":") >= 0
    feat_toks, rows = rest[feat], rest_line[feat]
    if len(feat_toks):
        pairs = np.array(b" ".join(feat_toks.tolist())
                         .replace(b":", b" ").split())
        if len(pairs) != 2 * len(feat_toks):
            raise ValueError("LibSVM token is not idx:value")
        pairs = pairs.reshape(-1, 2)
        idx = pairs[:, 0].astype(np.int64)
        if (idx < 0).any():
            raise ValueError("LibSVM feature index is negative")
        vals = _to_float(pairs[:, 1])
        width = max(int(idx.max()) + 1, num_features_hint)
    else:
        idx = np.empty(0, np.int64)
        vals = np.empty(0)
        width = max(0, num_features_hint)
    X = np.zeros((len(lines), width), np.float64)
    X[rows, idx] = vals
    return labels, X


def _parse_libsvm_regular(text, buf, ws, line, n_lines, num_features_hint):
    """(labels, X) of a LibSVM body whose every token after the label is
    one ``idx:value``, converted in one ``np.fromstring`` pass over the
    text with the colons read as separators; None for any other body
    (tokens without a colon, two colons, a bad number), which the
    general path parses or rejects."""
    colon = buf == 58
    per_line = np.bincount(line, minlength=n_lines)
    colons = np.bincount(_line_of_offsets(text, np.flatnonzero(colon)),
                         minlength=n_lines)
    if (per_line < 1).any() or (colons != per_line - 1).any():
        return None
    # each colon splits exactly one token (no colon at a token's edge)
    at = np.flatnonzero(colon)
    if len(at) and (ws[np.maximum(at - 1, 0)].any() or at[0] == 0
                    or at[-1] == len(buf) - 1 or ws[at + 1].any()):
        return None
    n_tok = int(per_line.sum()) + len(at)
    spaced = text.replace(b":", b" ")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        try:
            flat = np.fromstring(spaced, dtype=np.float64, sep=" ")
        except (ValueError, DeprecationWarning):
            return None
    if len(flat) != n_tok:
        return None
    # line starts in the flat list: a line of k pairs holds 1 + 2k
    first = np.concatenate([[0], np.cumsum(2 * per_line - 1)[:-1]])
    labels = flat[first]
    is_label = np.zeros(n_tok, bool)
    is_label[first] = True
    pairs = flat[~is_label].reshape(-1, 2)
    idx = pairs[:, 0].astype(np.int64)
    if (idx < 0).any() or (idx != pairs[:, 0]).any():
        return None
    width = max(int(idx.max()) + 1 if len(idx) else 0, num_features_hint)
    X = np.zeros((n_lines, width), np.float64)
    X[np.repeat(np.arange(n_lines), per_line - 1), idx] = pairs[:, 1]
    return labels, X


def _load_sidecar(path: str, dtype) -> Optional[np.ndarray]:
    """One value a line; a non-numeric first line is a header and is
    skipped (io.py:139)."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        toks = [t for t in (ln.strip() for ln in f.read().split(b"\n"))
                if t]
    if toks and not _parses(toks[0]):
        toks = toks[1:]
    return _to_float(np.array(toks, dtype=bytes)).astype(dtype)


def load_data_file(path: str, config=None,
                   num_features_hint: int = 0) -> LoadedFile:
    """Load a CSV/TSV/LibSVM data file plus metadata sidecars
    (io.py:217): format autodetect, label/weight/group/ignore column
    extraction, then ``.weight``/``.query`` (or ``.group``)/``.init``/
    ``.position`` sidecars. ``num_features_hint`` pads LibSVM matrices
    so a file with a lower max feature index aligns with its training
    set."""
    from .config import Config
    cfg = config if config is not None else Config({})
    path = str(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"data file not found: {path}")
    lines = _read_lines(path)
    if not lines:
        raise ValueError(f"data file is empty: {path}")

    has_header = bool(getattr(cfg, "header", False))
    probe = (lines[1] if has_header and len(lines) > 1 else lines[0]
             ).decode("utf-8")
    delim = _detect_delimiter(probe)

    if _is_libsvm(probe, delim):
        body = lines[1:] if has_header else lines
        label, X = _parse_libsvm(body, num_features_hint)
        names = [f"Column_{i}" for i in range(X.shape[1])]
        out = LoadedFile(X=X, label=label, feature_names=names)
    else:
        names: List[str] = []
        if has_header:
            names = [t.strip()
                     for t in lines[0].decode("utf-8").split(delim)]
            lines = lines[1:]
        mat = _parse_delimited(lines, delim)
        if not names:
            names = [f"Column_{i}" for i in range(mat.shape[1])]

        label_idx = _parse_column_spec(
            getattr(cfg, "label_column", ""), names,
            counts_label=True, label_idx=-1)
        if label_idx is None:
            label_idx = 0
        weight_idx = _parse_column_spec(
            getattr(cfg, "weight_column", ""), names,
            counts_label=False, label_idx=label_idx)
        group_idx = _parse_column_spec(
            getattr(cfg, "group_column", ""), names,
            counts_label=False, label_idx=label_idx)
        ignore = _parse_index_list(
            getattr(cfg, "ignore_column", ""), names, label_idx)

        drop = {label_idx}
        if weight_idx is not None:
            drop.add(weight_idx)
        if group_idx is not None:
            drop.add(group_idx)
        drop.update(ignore)
        keep = [j for j in range(mat.shape[1]) if j not in drop]

        label = mat[:, label_idx].copy()
        weight = mat[:, weight_idx].copy() if weight_idx is not None else None
        group = None
        if group_idx is not None:
            # group column holds a query id per row; convert to sizes
            qid = mat[:, group_idx]
            change = np.nonzero(np.diff(qid))[0] + 1
            bounds = np.concatenate([[0], change, [len(qid)]])
            group = np.diff(bounds).astype(np.int64)
        out = LoadedFile(
            X=np.ascontiguousarray(mat[:, keep]), label=label, weight=weight,
            group=group, feature_names=[names[j] for j in keep])

    w = _load_sidecar(path + ".weight", np.float64)
    if w is not None:
        out.weight = w
    init = _load_sidecar(path + ".init", np.float64)
    if init is not None:
        out.init_score = init
    if os.path.exists(path + ".position"):
        with open(path + ".position", "r", encoding="utf-8") as f:
            out.position = np.asarray(
                [ln.strip() for ln in f if ln.strip()])
    for ext in (".query", ".group"):
        q = _load_sidecar(path + ext, np.int64)
        if q is not None:
            out.group = q.astype(np.int64)
            break

    n = out.X.shape[0]
    for nm in ("label", "weight", "group", "init_score"):
        v = getattr(out, nm)
        if v is None:
            continue
        if nm == "group":
            if int(v.sum()) != n:
                raise ValueError(
                    f"query sizes sum to {int(v.sum())} != num rows {n}")
        elif nm == "init_score":
            if len(v) % n != 0:
                raise ValueError(
                    f"init_score length {len(v)} is not a multiple of "
                    f"num rows {n}")
        elif len(v) != n:
            raise ValueError(f"{nm} length {len(v)} != num rows {n}")
    return out
