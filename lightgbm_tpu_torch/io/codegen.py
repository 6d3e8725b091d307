"""Model -> standalone C++ if-else code generation.

Mirrors the reference's convert_model task (reference:
src/boosting/gbdt_model_text.cpp ModelToIfElse + tree.cpp:530 ToIfElse):
emits one ``PredictTreeN`` function per tree plus aggregate ``PredictRaw`` /
``Predict`` entry points, with the exact NumericalDecision /
CategoricalDecision missing-value semantics (tree.h:320-360)."""

from __future__ import annotations

from typing import List

from ..binning import K_ZERO_THRESHOLD, MISSING_NAN, MISSING_ZERO
from .model_text import _CAT_MASK, _DEFAULT_LEFT_MASK, ModelTree, _collect

_HEADER = """// Generated by lightgbm_tpu convert_model (if-else prediction code).
// Layout mirrors the reference's ModelToIfElse output: one function per
// tree over a dense feature array, plus aggregate entry points.
#include <cmath>
#include <cstdint>

namespace lightgbm_tpu_model {{

static inline bool CatInBitset(const uint32_t* bits, int n_words, double fval) {{
  if (std::isnan(fval) || fval < 0) return false;
  int iv = static_cast<int>(fval);
  int w = iv / 32;
  if (w >= n_words) return false;
  return (bits[w] >> (iv % 32)) & 1;
}}

"""


def _leaf_code(tree: ModelTree, leaf: int, indent: str, lines: List[str]) -> None:
    plain = repr(float(tree.leaf_value[leaf]))
    if not tree.is_linear:
        lines.append(f"{indent}return {plain};")
        return
    # linear leaf: const + coeff . x, falling back to the plain output when
    # any used feature is NaN/inf (linear_tree_learner.cpp:19-41 semantics)
    feats = tree.leaf_features[leaf] if leaf < len(tree.leaf_features) else []
    const = repr(float(tree.leaf_const[leaf]))
    if not feats:
        lines.append(f"{indent}return {const};")
        return
    coeffs = tree.leaf_coeff[leaf]
    guard = " || ".join(f"!std::isfinite(fval[{f}])" for f in feats)
    expr = " + ".join([const] + [f"{repr(float(c))} * fval[{f}]"
                                 for c, f in zip(coeffs, feats)])
    lines.append(f"{indent}if ({guard}) return {plain};")
    lines.append(f"{indent}return {expr};")


def _node_code(tree: ModelTree, node: int, indent: str, lines: List[str],
               tree_idx: int) -> None:
    if node < 0:
        _leaf_code(tree, ~node, indent, lines)
        return
    dt = int(tree.decision_type[node])
    feat = int(tree.split_feature[node])
    default_left = bool(dt & _DEFAULT_LEFT_MASK)
    if dt & _CAT_MASK:
        ci = int(tree.threshold[node])
        lo, hi = int(tree.cat_boundaries[ci]), int(tree.cat_boundaries[ci + 1])
        words = ", ".join(f"0x{int(w):08x}u" for w in tree.cat_threshold[lo:hi])
        lines.append(f"{indent}static const uint32_t cat_{tree_idx}_{node}[] = "
                     f"{{{words}}};")
        cond = (f"CatInBitset(cat_{tree_idx}_{node}, {hi - lo}, "
                f"fval[{feat}])")
    else:
        thr = repr(float(tree.threshold[node]))
        mt = (dt >> 2) & 3
        v = f"fval[{feat}]"
        if mt == MISSING_NAN:
            miss = f"std::isnan({v})"
            val = v
        elif mt == MISSING_ZERO:
            # NaN folds to 0 first (tree.h:330), then zero-threshold test
            val = f"(std::isnan({v}) ? 0.0 : {v})"
            miss = f"(std::fabs({val}) <= {K_ZERO_THRESHOLD!r})"
        else:
            val = f"(std::isnan({v}) ? 0.0 : {v})"
            miss = "false"
        branch = "true" if default_left else "false"
        cond = f"({miss} ? {branch} : ({val} <= {thr}))"
    lines.append(f"{indent}if ({cond}) {{")
    _node_code(tree, int(tree.left_child[node]), indent + "  ", lines, tree_idx)
    lines.append(f"{indent}}} else {{")
    _node_code(tree, int(tree.right_child[node]), indent + "  ", lines, tree_idx)
    lines.append(f"{indent}}}")


def model_to_if_else(boosting) -> str:
    """Generate the full C++ translation unit."""
    meta, trees = _collect(boosting, -1, 0)
    k = max(meta["num_tree_per_iteration"], 1)
    out = [_HEADER.format()]
    for i, t in enumerate(trees):
        lines = [f"double PredictTree{i}(const double* fval) {{"]
        if t.num_leaves == 1:
            _leaf_code(t, 0, "  ", lines)
        else:
            _node_code(t, 0, "  ", lines, i)
        lines.append("}")
        out.append("\n".join(lines))
        out.append("")

    n_trees = len(trees)
    avg = meta.get("average_output")
    if k == 1:
        body = " + ".join(f"PredictTree{i}(fval)" for i in range(n_trees)) or "0.0"
        scale = f" / {n_trees}.0" if (avg and n_trees) else ""
        out.append(f"double PredictRaw(const double* fval) {{\n"
                   f"  return ({body}){scale};\n}}")
        obj = (meta.get("objective") or "").split()
        if obj and obj[0] in ("binary", "cross_entropy"):
            out.append("double Predict(const double* fval) {\n"
                       "  return 1.0 / (1.0 + std::exp(-PredictRaw(fval)));\n}")
        elif obj and obj[0] in ("poisson", "gamma", "tweedie"):
            out.append("double Predict(const double* fval) {\n"
                       "  return std::exp(PredictRaw(fval));\n}")
        else:
            out.append("double Predict(const double* fval) {\n"
                       "  return PredictRaw(fval);\n}")
    else:
        n_iters = max(n_trees // k, 1)
        scale = f" / {n_iters}.0" if avg else ""
        per_class = []
        for c in range(k):
            terms = " + ".join(f"PredictTree{i}(fval)"
                               for i in range(c, n_trees, k)) or "0.0"
            per_class.append(f"({terms}){scale}")
        cases = "\n".join(f"  out[{c}] = {t};" for c, t in enumerate(per_class))
        out.append(f"void PredictRaw(const double* fval, double* out) {{\n"
                   f"{cases}\n}}")
        obj = (meta.get("objective") or "").split()
        if obj and obj[0] == "multiclass":
            out.append(f"""void Predict(const double* fval, double* out) {{
  PredictRaw(fval, out);
  double wmax = out[0];
  for (int i = 1; i < {k}; ++i) if (out[i] > wmax) wmax = out[i];
  double wsum = 0.0;
  for (int i = 0; i < {k}; ++i) {{ out[i] = std::exp(out[i] - wmax); wsum += out[i]; }}
  for (int i = 0; i < {k}; ++i) out[i] /= wsum;
}}""")
        else:
            out.append(f"void Predict(const double* fval, double* out) {{\n"
                       f"  PredictRaw(fval, out);\n}}")
    out.append("\n}  // namespace lightgbm_tpu_model\n")
    return "\n".join(out)
