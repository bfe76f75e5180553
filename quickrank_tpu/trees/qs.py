"""QuickScorer-style bitvector scoring as matrix products.

The reference family's namesake algorithm (Lucchese et al., "QuickScorer:
a fast algorithm to rank documents with additive ensembles of regression
trees", SIGIR 2015; the reference repo ships only the generated-C
scorers, src/io/generate_*.cc) evaluates a tree WITHOUT walking it: every
internal node carries a bitvector marking the leaves that become
unreachable when its test is false (= the leaves of its left subtree);
AND the bitvectors of all false nodes and the exit leaf is the leftmost
surviving bit.

Correctness (standard QS argument): the true exit leaf is excluded by no
false node (false ancestors send it right, non-ancestors don't contain
it), and every leaf strictly left of it is excluded by the lowest common
ancestor with the exit leaf (which tested false).  So leftmost
non-excluded == exit leaf.

Here the bitvector AND becomes a matmul: with ``excl[n, l] = 1`` iff
leaf ``l`` (in left-to-right order) lies in the left subtree of internal
node ``n``,

    false_bits = (X @ onehot(node features)) > thresholds    # [N, I]
    excluded   = false_bits @ excl                           # [N, L]
    exit leaf  = leftmost l with excluded[l] == 0

— no per-level loop at all, so the cost is independent of tree DEPTH
(the per-level descent pays 15 fused passes for a best-first 16-leaf
tree).  Exact: {0,1} operands are exact in bf16 and the exclusion counts
(<= I) accumulate exactly in f32; the feature column select is an f32
dot at HIGHEST precision with one nonzero product per output element, so
it returns the feature bit for bit (a TF32 select would misroute).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from quickrank_tpu.utils import struct

from quickrank_tpu.ops.scoring import kahan_add


@struct.dataclass
class QSEnsemble:
    """fid/thr: [T, I] internal-node tests (dead slots thr=+inf so the
    test is always true and excludes nothing); excl: [T, I, L] bf16
    left-subtree leaf masks; leafval: [T, L] in left-to-right leaf order
    (pad leaves sit rightmost and are provably never selected);
    weight: [T]."""

    fid: jnp.ndarray
    thr: jnp.ndarray
    excl: jnp.ndarray
    leafval: jnp.ndarray
    weight: jnp.ndarray
    num_trees: jnp.ndarray
    #: pre-pad tree-slot count: the Kahan chain must run exactly one step
    #: per ORIGINAL capacity slot to stay bitwise equal to score_ensemble
    #: (kahan_add with d=0 still folds the compensation term into the sum)
    orig_capacity: int = struct.field(pytree_node=False, default=0)


FLT_MAX = float(np.float32(3.4028235e38))


def ensemble_to_qs(ens, space: str = "value") -> QSEnsemble:
    """Host-side table build from dense EnsembleTensors (iterative —
    a chain-shaped XML import must not ride the Python recursion limit,
    cf. trees/perfect.py::tree_depths).

    ``space="bin"`` builds thresholds from ``threshold_bin`` instead of
    the value-space thresholds: scoring the BINNED tensor through the
    same score_qs is then exactly the training-time bin routing
    (``bin <= threshold_bin`` == ``v <= threshold`` by ops/binning.py
    construction; bin ids are exact in the f32 compare).  Used by warm
    restarts, which rescore from the binned tensor because raw features
    never ship to the device (TrainData.build)."""
    T = int(ens.num_trees)
    cap = int(ens.capacity)
    max_nodes = int(ens.feature.shape[1])
    feat = np.asarray(ens.feature)
    if space == "bin":
        thrv = np.asarray(ens.threshold_bin).astype(np.float32)
    else:
        thrv = np.asarray(ens.threshold)
    left = np.asarray(ens.left)
    right = np.asarray(ens.right)
    isleaf = np.asarray(ens.is_leaf)
    lv = np.asarray(ens.leaf_value)

    I = max(1, max_nodes // 2)  # 2k-1 nodes -> k-1 internal
    L = max(1, max_nodes - I)  # k leaves

    fid = np.zeros((cap, I), np.int32)
    thr = np.full((cap, I), FLT_MAX, np.float32)
    excl = np.zeros((cap, I, L), np.float32)
    leafval = np.zeros((cap, L), np.float32)

    for t in range(T):
        # in-order walk: leaves numbered left-to-right; internal nodes
        # get compact slots in visit order with their leaf span recorded
        nleaf = 0
        nint = 0
        # state: (node, phase) with an explicit stack; compute leaf spans
        # bottom-up via a post-order pass
        span = {}
        stack = [(0, 0)]
        post = []
        while stack:
            n, phase = stack.pop()
            if isleaf[t, n]:
                span[n] = (nleaf, nleaf + 1)
                nleaf += 1
                continue
            if phase == 0:
                stack.append((n, 1))
                stack.append((int(left[t, n]), 0))
            elif phase == 1:
                stack.append((n, 2))
                stack.append((int(right[t, n]), 0))
            else:
                ls, le = span[int(left[t, n])]
                rs, re = span[int(right[t, n])]
                span[n] = (ls, re)
                post.append((n, ls, le))
        for n, ls, le in post:
            fid[t, nint] = feat[t, n]
            thr[t, nint] = thrv[t, n]
            excl[t, nint, ls:le] = 1.0
            nint += 1
        # leaf values in left-to-right order (pre-order leaf visit above
        # IS left-to-right because left subtrees are expanded first)
        order_stack = [0]
        pos = 0
        while order_stack:
            n = order_stack.pop()
            if isleaf[t, n]:
                leafval[t, pos] = lv[t, n]
                pos += 1
                continue
            order_stack.append(int(right[t, n]))
            order_stack.append(int(left[t, n]))

    w = np.zeros((cap,), np.float32)
    w[:T] = np.asarray(ens.weight)[:T]
    # pad the tree axis to the scoring kernel's group size (dead slots:
    # thr=+inf tests exclude nothing, weight 0 contributes nothing)
    capg = -(-cap // QS_GROUP) * QS_GROUP
    if capg != cap:
        pad = capg - cap
        fid = np.pad(fid, ((0, pad), (0, 0)))
        thr = np.pad(thr, ((0, pad), (0, 0)), constant_values=FLT_MAX)
        excl = np.pad(excl, ((0, pad), (0, 0), (0, 0)))
        leafval = np.pad(leafval, ((0, pad), (0, 0)))
        w = np.pad(w, (0, pad))
    return QSEnsemble(
        fid=jnp.asarray(fid),
        thr=jnp.asarray(thr),
        excl=jnp.asarray(excl.astype(jnp.bfloat16)),
        leafval=jnp.asarray(leafval),
        weight=jnp.asarray(w),
        num_trees=jnp.asarray(T, jnp.int32),
        orig_capacity=cap,
    )


#: trees evaluated per scan step (not yet tuned on the GPU)
QS_GROUP = 8


@jax.jit
def score_qs(features: jnp.ndarray, qs: QSEnsemble) -> jnp.ndarray:
    """Weighted ensemble scores f32 [N] via the bitvector matmul.

    A scan over GROUPS of QS_GROUP trees; per group: one column-select
    dot, one broadcast compare, one block-diagonal [N, G*I] @ [G*I, G*L]
    exclusion matmul, and a per-tree leftmost-survivor reduction —
    all depth-independent.  The cross-tree sum stays a SEQUENTIAL
    per-tree Kahan accumulation (a small [N, G] fori), so scores are
    bitwise those of score_ensemble's one-tree-at-a-time scan."""
    N, W = features.shape
    Tp, I = qs.fid.shape
    L = qs.leafval.shape[1]
    G = QS_GROUP
    X = features.astype(jnp.float32)

    slots = jnp.arange(Tp).reshape(Tp // G, G)
    fid_g = qs.fid.reshape(Tp // G, G * I)
    thr_g = qs.thr.reshape(Tp // G, G * I)
    excl_g = qs.excl.reshape(Tp // G, G, I, L)
    leaf_g = qs.leafval.reshape(Tp // G, G, L)
    w_g = qs.weight.reshape(Tp // G, G)

    def body(carry, xs):
        fid, thr, excl, leafval, w, slot = xs
        sel = (
            fid[None, :] == jnp.arange(W)[:, None]
        ).astype(jnp.float32)  # [W, G*I]
        fcols = jax.lax.dot_general(
            X, sel, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )  # [N, G*I]
        false_bits = (fcols > thr[None, :]).astype(jnp.bfloat16)
        # block-diagonal exclusion operator: tree g's false bits only
        # meet tree g's leaf masks
        bd = jnp.zeros((G, I, G, L), jnp.bfloat16)
        bd = bd.at[jnp.arange(G), :, jnp.arange(G), :].set(excl)
        excluded = jax.lax.dot_general(
            false_bits, bd.reshape(G * I, G * L), (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )  # [N, G*L] — exact exclusion counts
        reached = (excluded == 0.0).reshape(N, G, L).astype(jnp.float32)
        first = reached * (jnp.cumsum(reached, axis=2) == 1.0)
        d = jnp.sum(first * leafval[None, :, :], axis=2)  # [N, G]

        def add_one(g, sc):
            s2, c2 = kahan_add(sc[0], sc[1], w[g] * d[:, g])
            keep = slot[g] < qs.orig_capacity  # pad slots: no Kahan step
            return jnp.where(keep, s2, sc[0]), jnp.where(keep, c2, sc[1])

        return jax.lax.fori_loop(0, G, add_one, carry), None

    z = jnp.zeros((N,), jnp.float32)
    (out, _), _ = jax.lax.scan(
        body, (z, z), (fid_g, thr_g, excl_g, leaf_g, w_g, slots)
    )
    return out


@jax.jit
def partial_scores_qs(features: jnp.ndarray, qs: QSEnsemble) -> jnp.ndarray:
    """Per-tree *unweighted* scores [N, orig_capacity] — the QS form of
    ops/scoring.py::partial_scores (Ensemble::partial_scores_instance,
    ensemble.cc:120-131): each tree's leaf pick comes straight out of
    the grouped bitvector evaluation, bitwise the descent's
    ``leaf_value[node]``.  Dead slots (t >= num_trees) are zero columns
    (their tables are zero by construction)."""
    N, W = features.shape
    Tp, I = qs.fid.shape
    L = qs.leafval.shape[1]
    G = QS_GROUP
    X = features.astype(jnp.float32)

    fid_g = qs.fid.reshape(Tp // G, G * I)
    thr_g = qs.thr.reshape(Tp // G, G * I)
    excl_g = qs.excl.reshape(Tp // G, G, I, L)
    leaf_g = qs.leafval.reshape(Tp // G, G, L)

    def body(_, xs):
        fid, thr, excl, leafval = xs
        sel = (
            fid[None, :] == jnp.arange(W)[:, None]
        ).astype(jnp.float32)
        fcols = jax.lax.dot_general(
            X, sel, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        false_bits = (fcols > thr[None, :]).astype(jnp.bfloat16)
        bd = jnp.einsum(
            "til,tu->tlui", excl.astype(jnp.float32),
            jnp.eye(G, dtype=jnp.float32),
        ).astype(jnp.bfloat16).reshape(G * L, G * I)
        excluded = jax.lax.dot_general(
            false_bits, bd, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        reached = (excluded == 0.0).reshape(N, G, L).astype(jnp.float32)
        first = reached * (jnp.cumsum(reached, axis=2) == 1.0)
        return None, jnp.sum(first * leafval[None, :, :], axis=2)  # [N, G]

    _, cols = jax.lax.scan(body, None, (fid_g, thr_g, excl_g, leaf_g))
    # cols: [Tp//G, N, G] -> [N, Tp]
    out = jnp.swapaxes(cols, 0, 1).reshape(N, Tp)
    return out[:, : qs.orig_capacity]
