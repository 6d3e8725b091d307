"""Plotting utilities.

Mirrors the reference plotting module (reference:
python-package/lightgbm/plotting.py:25-623 — plot_importance,
plot_split_value_histogram, plot_metric, create_tree_digraph, plot_tree)
on matplotlib / graphviz, gated on availability like the reference's
compat shims: the port's copy of lightgbm_tpu's ``plotting.py``; both
libraries are imported inside the functions that draw."""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .booster import Booster


def _check_not_tuple_of_2_elements(obj, obj_name: str) -> None:
    if not isinstance(obj, tuple) or len(obj) != 2:
        raise TypeError(f"{obj_name} must be a tuple of 2 elements.")


def _to_booster(booster) -> Booster:
    from .sklearn import LGBMModel
    if isinstance(booster, LGBMModel):
        return booster.booster_
    if isinstance(booster, Booster):
        return booster
    raise TypeError("booster must be Booster or LGBMModel.")


def plot_importance(booster, ax=None, height: float = 0.2,
                    xlim=None, ylim=None,
                    title: str = "Feature importance",
                    xlabel: str = "Feature importance",
                    ylabel: str = "Features",
                    importance_type: str = "split",
                    max_num_features: Optional[int] = None,
                    ignore_zero: bool = True, figsize=None, dpi=None,
                    grid: bool = True, precision: int = 3, **kwargs):
    """Bar chart of feature importances (reference: plotting.py:25-140)."""
    import matplotlib.pyplot as plt

    booster = _to_booster(booster)
    importance = booster.feature_importance(importance_type=importance_type)
    feature_name = booster.feature_name()
    if not len(importance):
        raise ValueError("Booster's feature_importance is empty.")

    tuples = sorted(zip(feature_name, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [x for x in tuples if x[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    labels, values = zip(*tuples) if tuples else ((), ())

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)

    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y,
                f"{x:.{precision}f}" if importance_type == "gain" else str(x),
                va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
    else:
        xlim = (0, max(values) * 1.1 if values else 1)
    ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
    else:
        ylim = (-1, len(values))
    ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        xlabel = xlabel.replace("@importance_type@", importance_type)
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_split_value_histogram(booster, feature, bins=None, ax=None,
                               width_coef: float = 0.8, xlim=None, ylim=None,
                               title="Split value histogram for feature with @index/name@ @feature@",
                               xlabel="Feature split value", ylabel="Count",
                               figsize=None, dpi=None, grid: bool = True,
                               **kwargs):
    """Histogram of split thresholds used for one feature
    (reference: plotting.py:141-246)."""
    import matplotlib.pyplot as plt

    booster = _to_booster(booster)
    model = booster.dump_model()
    feature_names = model["feature_names"]
    if isinstance(feature, str):
        feat_idx = feature_names.index(feature)
    else:
        feat_idx = int(feature)

    values: List[float] = []

    def walk(node):
        if "split_feature" in node:
            if node["split_feature"] == feat_idx and node["decision_type"] == "<=":
                values.append(float(node["threshold"]))
            walk(node["left_child"])
            walk(node["right_child"])

    for ti in model["tree_info"]:
        walk(ti["tree_structure"])
    if not values:
        raise ValueError("Cannot plot split value histogram, "
                         "as feature was not used in splitting of the model.")
    hist, bin_edges = np.histogram(values, bins=bins or max(10, len(set(values))))
    centres = (bin_edges[:-1] + bin_edges[1:]) / 2

    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    ax.bar(centres, hist, align="center",
           width=width_coef * (bin_edges[1] - bin_edges[0]), **kwargs)
    if xlim is None:
        xlim = (bin_edges[0], bin_edges[-1])
    ax.set_xlim(xlim)
    if ylim is None:
        ylim = (0, max(hist) * 1.1)
    ax.set_ylim(ylim)
    if title is not None:
        title = title.replace("@index/name@",
                              "name" if isinstance(feature, str) else "index")
        title = title.replace("@feature@", str(feature))
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster, metric: Optional[str] = None,
                dataset_names: Optional[List[str]] = None, ax=None,
                xlim=None, ylim=None, title: str = "Metric during training",
                xlabel: str = "Iterations", ylabel: str = "@metric@",
                figsize=None, dpi=None, grid: bool = True):
    """Plot metric curves recorded by record_evaluation
    (reference: plotting.py:247-380). Accepts the evals_result dict or a
    fitted sklearn estimator."""
    import matplotlib.pyplot as plt

    from .sklearn import LGBMModel
    if isinstance(booster, LGBMModel):
        eval_results = deepcopy(booster.evals_result_)
    elif isinstance(booster, dict):
        eval_results = deepcopy(booster)
    else:
        raise TypeError("booster must be dict or LGBMModel.")
    if not eval_results:
        raise ValueError("eval results cannot be empty.")

    if dataset_names is None:
        dataset_names = list(eval_results.keys())
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)

    first = eval_results[dataset_names[0]]
    if metric is None:
        metric = list(first.keys())[0]
    for name in dataset_names:
        if metric not in eval_results[name]:
            continue
        results = eval_results[name][metric]
        ax.plot(range(len(results)), results, label=name)
    ax.legend(loc="best")
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel.replace("@metric@", metric))
    ax.grid(grid)
    return ax


def _node_label(node: Dict[str, Any], feature_names, show_info, precision):
    if "split_feature" in node:
        feat = (feature_names[node["split_feature"]]
                if feature_names else f"f{node['split_feature']}")
        if node["decision_type"] == "<=":
            label = f"{feat} <= {node['threshold']:.{precision}g}"
        else:
            label = f"{feat} in {{{node['threshold']}}}"
        extras = []
        if "split_gain" in show_info:
            extras.append(f"gain: {node['split_gain']:.{precision}g}")
        if "internal_value" in show_info:
            extras.append(f"value: {node['internal_value']:.{precision}g}")
        if "internal_count" in show_info:
            extras.append(f"count: {node['internal_count']}")
        return "\n".join([label] + extras)
    extras = [f"leaf {node['leaf_index']}: {node['leaf_value']:.{precision}g}"]
    if "leaf_count" in show_info:
        extras.append(f"count: {node['leaf_count']}")
    if "leaf_weight" in show_info:
        extras.append(f"weight: {node['leaf_weight']:.{precision}g}")
    return "\n".join(extras)


def create_tree_digraph(booster, tree_index: int = 0, show_info=None,
                        precision: int = 3, orientation: str = "horizontal",
                        **kwargs):
    """Graphviz digraph of one tree (reference: plotting.py:468-544)."""
    try:
        import graphviz
    except ImportError as err:
        raise ImportError("You must install graphviz and restart your session "
                          "to plot tree.") from err

    booster = _to_booster(booster)
    model = booster.dump_model()
    if tree_index >= len(model["tree_info"]):
        raise IndexError("tree_index is out of range.")
    tree_info = model["tree_info"][tree_index]
    feature_names = model.get("feature_names")
    show_info = show_info or []

    graph = graphviz.Digraph(**kwargs)
    rankdir = "LR" if orientation == "horizontal" else "TB"
    graph.attr(rankdir=rankdir)

    counter = [0]

    def add(node, parent=None, decision=None):
        name = f"node{counter[0]}"
        counter[0] += 1
        shape = "rectangle" if "split_feature" in node else "ellipse"
        graph.node(name, label=_node_label(node, feature_names, show_info,
                                           precision), shape=shape)
        if parent is not None:
            graph.edge(parent, name, label=decision)
        if "split_feature" in node:
            add(node["left_child"], name, "yes")
            add(node["right_child"], name, "no")

    add(tree_info["tree_structure"])
    return graph


def plot_tree(booster, ax=None, tree_index: int = 0, figsize=None, dpi=None,
              show_info=None, precision: int = 3,
              orientation: str = "horizontal", **kwargs):
    """Render one tree with matplotlib via graphviz
    (reference: plotting.py:545-623). Falls back to a pure-matplotlib
    rendering when graphviz is unavailable."""
    import matplotlib.image as mimage
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    graphviz_missing: Tuple = (ImportError, FileNotFoundError)
    try:
        import graphviz as _gv
        graphviz_missing = graphviz_missing + (_gv.ExecutableNotFound,)
    except ImportError:
        pass
    try:
        graph = create_tree_digraph(booster, tree_index=tree_index,
                                    show_info=show_info, precision=precision,
                                    orientation=orientation, **kwargs)
        from io import BytesIO
        s = BytesIO(graph.pipe(format="png"))
        img = mimage.imread(s)
        ax.imshow(img)
        ax.axis("off")
        return ax
    except graphviz_missing:   # graphviz package or dot binary missing
        return _plot_tree_matplotlib(booster, ax, tree_index, show_info or [],
                                     precision)


def _plot_tree_matplotlib(booster, ax, tree_index, show_info, precision):
    """Minimal text-box tree rendering without graphviz."""
    booster = _to_booster(booster)
    model = booster.dump_model()
    tree_info = model["tree_info"][tree_index]
    feature_names = model.get("feature_names")

    # compute (depth, order) positions via in-order traversal
    positions: List[Tuple[float, float, str]] = []
    x_counter = [0.0]

    def walk(node, depth):
        if "split_feature" in node:
            lx = walk(node["left_child"], depth + 1)
            label = _node_label(node, feature_names, show_info, precision)
            x = x_counter[0]
            x_counter[0] += 1
            rx = walk(node["right_child"], depth + 1)
            positions.append((x, -depth, label))
            return x
        label = _node_label(node, feature_names, show_info, precision)
        x = x_counter[0]
        x_counter[0] += 1
        positions.append((x, -depth, label))
        return x

    walk(tree_info["tree_structure"], 0)
    for x, y, label in positions:
        ax.text(x, y, label, ha="center", va="center", fontsize=7,
                bbox=dict(boxstyle="round", fc="lightyellow", ec="gray"))
    xs = [p[0] for p in positions]
    ys = [p[1] for p in positions]
    ax.set_xlim(min(xs) - 1, max(xs) + 1)
    ax.set_ylim(min(ys) - 1, max(ys) + 1)
    ax.axis("off")
    return ax
