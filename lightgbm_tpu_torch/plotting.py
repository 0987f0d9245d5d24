"""Plotting utilities.

Port of ``lightgbm_tpu/plotting.py`` (the reference's
``python-package/lightgbm/plotting.py``): importance bars, metric curves
from record_evaluation, split-value histograms, and tree digraphs, all
read from the host trees. matplotlib and graphviz are imported inside
the functions that draw; ``create_tree_digraph`` builds the same DOT
source as the JAX package from the same model.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["plot_importance", "plot_metric", "plot_split_value_histogram",
           "plot_tree", "create_tree_digraph"]


def _check_not_tuple_of_2_elements(obj, obj_name):
    if not isinstance(obj, tuple) or len(obj) != 2:
        raise TypeError(f"{obj_name} must be a tuple of 2 elements")


def _mpl_axes(ax, figsize, dpi):
    import matplotlib.pyplot as plt
    if ax is not None:
        return ax
    if figsize is not None:
        _check_not_tuple_of_2_elements(figsize, "figsize")
    _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    return ax


def plot_importance(booster, ax=None, height: float = 0.2,
                    xlim: Optional[Tuple] = None,
                    ylim: Optional[Tuple] = None,
                    title: str = "Feature importance",
                    xlabel: str = "Feature importance",
                    ylabel: str = "Features",
                    importance_type: str = "auto",
                    max_num_features: Optional[int] = None,
                    ignore_zero: bool = True, figsize=None, dpi=None,
                    grid: bool = True, precision: int = 3, **kwargs):
    """Bar chart of feature importances (plotting.py:37 analog)."""
    from .engine import Booster
    if hasattr(booster, "booster_"):           # sklearn estimator
        booster = booster.booster_
    if not isinstance(booster, Booster):
        raise TypeError("booster must be a Booster or LGBMModel")
    if importance_type == "auto":
        importance_type = "split"
    importance = booster.feature_importance(importance_type)
    names = booster.feature_name()

    pairs = sorted(zip(names, importance), key=lambda x: x[1])
    if ignore_zero:
        pairs = [p for p in pairs if p[1] != 0]
    if max_num_features is not None and max_num_features > 0:
        pairs = pairs[-max_num_features:]
    if not pairs:
        raise ValueError("cannot plot importance: no nonzero importances")
    labels, values = zip(*pairs)

    ax = _mpl_axes(ax, figsize, dpi)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y,
                f"{x:.{precision}f}" if importance_type == "gain"
                else str(int(x)), va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
        ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
        ax.set_ylim(ylim)
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster, metric: Optional[str] = None,
                dataset_names=None, ax=None, xlim=None, ylim=None,
                title: str = "Metric during training",
                xlabel: str = "Iterations",
                ylabel: str = "@metric@", figsize=None, dpi=None,
                grid: bool = True):
    """Metric curves from a record_evaluation dict or CVBooster-style
    eval history (plotting.py:180 analog)."""
    if isinstance(booster, dict):
        eval_results = booster
    elif hasattr(booster, "evals_result_"):
        eval_results = booster.evals_result_
    else:
        raise TypeError(
            "booster must be a dict from record_evaluation() or a fitted "
            "LGBMModel (the Booster itself stores no eval history, "
            "matching the reference)")
    if not eval_results:
        raise ValueError("eval results are empty")

    names = list(dataset_names or eval_results.keys())
    first = eval_results[names[0]]
    if metric is None:
        metric = next(iter(first.keys()))
    ax = _mpl_axes(ax, figsize, dpi)
    for name in names:
        if metric not in eval_results.get(name, {}):
            continue
        vals = eval_results[name][metric]
        ax.plot(np.arange(1, len(vals) + 1), vals, label=name)
    ax.legend(loc="best")
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel.replace("@metric@", metric))
    ax.grid(grid)
    return ax


def plot_split_value_histogram(booster, feature, bins=None, ax=None,
                               width_coef: float = 0.8, xlim=None,
                               ylim=None,
                               title="Split value histogram for "
                                     "feature with @index/name@ @feature@",
                               xlabel="Feature split value",
                               ylabel="Count", figsize=None, dpi=None,
                               grid: bool = True):
    """Histogram of a feature's split thresholds across the model
    (plotting.py:742 analog)."""
    from .engine import Booster
    if hasattr(booster, "booster_"):
        booster = booster.booster_
    if not isinstance(booster, Booster):
        raise TypeError("booster must be a Booster or LGBMModel")
    names = booster.feature_name()
    if isinstance(feature, str):
        fidx = names.index(feature)
        fdesc = "name"
    else:
        fidx = int(feature)
        fdesc = "index"
    values = []
    for tree in booster._all_trees():
        sel = (tree.split_feature == fidx) & \
              ((tree.decision_type & 1) == 0)     # numerical splits only
        values.extend(np.asarray(tree.threshold)[sel].tolist())
    if not values:
        raise ValueError(
            f"feature {feature} is not used in any numerical split")
    hist, bin_edges = np.histogram(values, bins=bins or "auto")
    centers = (bin_edges[:-1] + bin_edges[1:]) / 2
    ax = _mpl_axes(ax, figsize, dpi)
    ax.bar(centers, hist, align="center",
           width=width_coef * (bin_edges[1] - bin_edges[0]))
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    if title:
        ax.set_title(title.replace("@feature@", str(feature))
                     .replace("@index/name@", fdesc))
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def _tree_to_dot(tree, feature_names, precision: int = 3,
                 show_info=()) -> str:
    """GraphViz DOT source for one tree (plotting.py _to_graphviz)."""
    lines = ["digraph Tree {", '  graph [rankdir="LR"]']

    def fmt(x):
        return f"{x:.{precision}g}"

    def leaf_label(s):
        parts = [f"leaf {s}: {fmt(tree.leaf_value[s])}"]
        if "leaf_count" in show_info:
            parts.append(f"count: {int(tree.leaf_count[s])}")
        if "leaf_weight" in show_info:
            parts.append(f"weight: {fmt(tree.leaf_weight[s])}")
        return "\\n".join(parts)

    if tree.num_leaves == 1:
        lines.append(f'  leaf0 [label="{leaf_label(0)}"]')
        lines.append("}")
        return "\n".join(lines)

    for i in range(tree.num_leaves - 1):
        f = int(tree.split_feature[i])
        name = (feature_names[f] if f < len(feature_names)
                else f"Column_{f}")
        if int(tree.decision_type[i]) & 1:
            cond = f"{name} in cat set {int(tree.threshold[i])}"
        else:
            cond = f"{name} <= {fmt(tree.threshold[i])}"
        parts = [cond]
        if "split_gain" in show_info:
            parts.append(f"gain: {fmt(tree.split_gain[i])}")
        if "internal_value" in show_info:
            parts.append(f"value: {fmt(tree.internal_value[i])}")
        if "internal_count" in show_info:
            parts.append(f"count: {int(tree.internal_count[i])}")
        label = "\\n".join(parts)
        lines.append(f'  split{i} [shape=rectangle, label="{label}"]')
    for i in range(tree.num_leaves - 1):
        for child, tag in ((int(tree.left_child[i]), "yes"),
                           (int(tree.right_child[i]), "no")):
            dst = f"split{child}" if child >= 0 else f"leaf{~child}"
            lines.append(f'  split{i} -> {dst} [label="{tag}"]')
    for s in range(tree.num_leaves):
        lines.append(f'  leaf{s} [label="{leaf_label(s)}"]')
    lines.append("}")
    return "\n".join(lines)


def create_tree_digraph(booster, tree_index: int = 0,
                        show_info=None, precision: int = 3,
                        orientation: str = "horizontal", **kwargs):
    """graphviz.Digraph of one tree (plotting.py:490 analog). Requires
    the graphviz package, like the reference."""
    from .engine import Booster
    if hasattr(booster, "booster_"):
        booster = booster.booster_
    if not isinstance(booster, Booster):
        raise TypeError("booster must be a Booster or LGBMModel")
    trees = booster._all_trees()
    if not 0 <= tree_index < len(trees):
        raise IndexError(f"tree_index {tree_index} out of range")
    dot = _tree_to_dot(trees[tree_index], booster.feature_name(),
                       precision, tuple(show_info or ()))
    try:
        import graphviz
    except ImportError as e:
        raise ImportError(
            "You must install graphviz and restart your session to plot "
            "a tree.") from e
    return graphviz.Source(dot, **kwargs)


def plot_tree(booster, ax=None, tree_index: int = 0, figsize=None,
              dpi=None, show_info=None, precision: int = 3, **kwargs):
    """Render one tree with matplotlib (plotting.py:641 analog; needs
    graphviz for layout, like the reference)."""
    import matplotlib.image as mpimg
    import matplotlib.pyplot as plt
    graph = create_tree_digraph(booster, tree_index=tree_index,
                                show_info=show_info, precision=precision,
                                **kwargs)
    ax = _mpl_axes(ax, figsize, dpi)
    import io
    s = io.BytesIO(graph.pipe(format="png"))
    img = mpimg.imread(s)
    ax.imshow(img)
    ax.axis("off")
    return ax
