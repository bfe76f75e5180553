"""Standalone scoring-code generators ("quickscore" path).

Counterparts of the reference's three model translators:

  * ``condop`` — nested C conditional operators, one summand per tree
    (src/io/generate_conditional_operators.cc:28-115);
  * ``oblivious`` — dense tables + branch-free bit-OR ``leaf_id`` for
    symmetric trees (src/io/generate_oblivious.cc:137-330), trees grouped by
    depth;
  * ``vpred`` — the flat breadth-first node-list input format of Asadi et
    al.'s VPred (src/io/generate_vpred.cc:88-170), with learning-rate-scaled
    leaf outputs.

All generators work directly from the in-memory dense model tensors (no XML
navigation needed); the emitted artifacts are compatible with the formats
the reference produces from the same model.

Note: the in-framework equivalent of these generators is the batched
bit-OR scorer (ops/oblivious.py) — codegen exists for exporting models to
CPU serving stacks.
"""

from __future__ import annotations

from collections import deque

import numpy as np


def _fmt_thr(x: float) -> str:
    s = np.format_float_positional(np.float32(x), unique=True, trim="0")
    if "." not in s and "e" not in s and "inf" not in s:
        s += ".0"
    return s


def generate(model, generator: str = "condop") -> str:
    generator = generator.lower()
    if generator == "condop":
        return generate_condop(model)
    if generator == "oblivious":
        return generate_oblivious(model)
    if generator == "vpred":
        return generate_vpred(model)
    raise ValueError(f"unknown generator {generator!r}")


def _host_trees(model):
    ens = model._require_model()
    T = int(ens.num_trees)
    return T, (
        np.asarray(ens.feature),
        np.asarray(ens.threshold),
        np.asarray(ens.left),
        np.asarray(ens.right),
        np.asarray(ens.is_leaf),
        np.asarray(ens.leaf_value),
        np.asarray(ens.weight),
    )


def generate_condop(model) -> str:
    """double ranker(float* v) of nested ternaries (g_c_o.cc:93-112)."""
    T, (feat, thr, left, right, isleaf, lv, w) = _host_trees(model)

    def emit(t: int, i: int) -> str:
        if isleaf[t, i]:
            return repr(float(lv[t, i]))
        return (
            f"( v[{int(feat[t, i])}] <= {_fmt_thr(thr[t, i])}f ? "
            f"{emit(t, int(left[t, i]))} : {emit(t, int(right[t, i]))} )"
        )

    parts = ["double ranker(float* v) {", "\treturn 0.0 "]
    for t in range(T):
        parts.append(f"\t\t + {float(w[t]):.3g}f * {emit(t, 0)}")
    parts.append(";\n}")
    return "\n".join(parts) + "\n"


def generate_oblivious(model) -> str:
    """Dense-table + bit-OR leaf_id source (g_o.cc:137-330).

    Requires an oblivious (symmetric) model; trees are sorted/grouped by
    depth like the reference.
    """
    obl = model.oblivious_ensemble()
    fid = np.asarray(obl.fid)
    thr = np.asarray(obl.thr)
    leaf = np.asarray(obl.leaf)
    wts = np.asarray(obl.weight)[: int(obl.num_trees)]
    T, D = fid.shape
    L = leaf.shape[1]

    # effective depth per tree = number of live levels (dead ones have +inf)
    depths = np.maximum((thr < np.finfo(np.float32).max / 2).sum(axis=1), 1)
    order = np.argsort(depths, kind="stable")
    max_depth = int(depths[order[-1]])
    pops = [int(np.sum(depths == d + 1)) for d in range(max_depth)]

    out = [
        f"#define N {T} // no. of trees",
        f"#define M {D} // max tree depth",
        f"#define F {L} // max number of leaves",
        "",
        "const float tree_weights[N] = { "
        + ", ".join(repr(float(wts[i])) for i in order)
        + " };",
        "",
    ]
    rows = ",\n\t".join(
        "\t{ " + ", ".join(repr(float(x)) for x in leaf[i]) + " }"
        for i in order
    )
    out.append("const double leaf_outputs[N][F] = { \n\t" + rows + "\n};\n")
    rows = ",\n\t".join(
        "\t{ " + ", ".join(str(int(x)) for x in fid[i]) + " }" for i in order
    )
    out.append("const unsigned int features_ids[N][M] = { \n\t" + rows + "\n};\n")
    rows = ",\n\t".join(
        "\t{ " + ", ".join(_fmt_thr(x) for x in thr[i]) + " }" for i in order
    )
    out.append("const float thresholds[N][M] = { \n\t" + rows + "\n};\n")
    out.append("#define SHL(n,p) ((n)<<(p))\n")
    out.append(
        "unsigned int leaf_id(float *v, unsigned int const *fids, "
        "float const *thresh, const unsigned int m) {\n"
        "  unsigned int leafidx=0;\n"
        "  for (unsigned int i=0; i<m; ++i)\n"
        "    leafidx |= SHL( v[fids[i]]>thresh[i], m-1-i);\n"
        "  return leafidx;\n}\n"
    )
    body = ["double ranker(float *v) {", "  double score = 0.0;", "  int i = 0;"]
    for d in range(max_depth):
        body.append(f"  for (int j = 0; j < {pops[d]}; ++j) {{")
        body.append(
            "    score += tree_weights[i] * leaf_outputs[i]"
            f"[leaf_id(v, features_ids[i], thresholds[i], {d + 1})];"
        )
        body.append("    i++;")
        body.append("  }")
    body.append("  return score;\n}")
    out.append("\n".join(body))
    return "\n".join(out) + "\n"


def generate_vpred(model) -> str:
    """VPred breadth-first node-list format (g_v.cc:88-170)."""
    T, (feat, thr, left, right, isleaf, lv, w) = _host_trees(model)
    lr = getattr(model, "shrinkage", 1.0)

    def depth_of(t: int, i: int) -> int:
        if isleaf[t, i]:
            return 1
        return 1 + max(depth_of(t, int(left[t, i])), depth_of(t, int(right[t, i])))

    lines = [str(T)]
    for t in range(T):
        depth = depth_of(t, 0) - 1
        tree_size = 2**depth - 1
        lines.append(str(depth))
        # BFS: (node_index, local_id, parent_id, is_left, parent_feature)
        q = deque()
        next_id = 0
        q.append((0, next_id, -1, False, 0))
        next_id += 1
        while q:
            i, nid, pid, is_left, pfeat = q.popleft()
            if isleaf[t, i]:
                val = lr * float(lv[t, i])
                if nid >= tree_size:
                    lines.append(f"leaf {nid} {pid} {int(is_left)} {val}")
                else:
                    lines.append(
                        f"node {nid} {pid} {pfeat} {int(is_left)} {val}"
                    )
            else:
                f = int(feat[t, i])
                th = _fmt_thr(thr[t, i])
                if nid == 0:
                    lines.append(f"root 0 {f} {th}")
                else:
                    lines.append(f"node {nid} {pid} {f} {int(is_left)} {th}")
                q.append((int(left[t, i]), next_id, nid, True, f))
                next_id += 1
                q.append((int(right[t, i]), next_id, nid, False, f))
                next_id += 1
        lines.append("end")
    return "\n".join(lines) + "\n"
