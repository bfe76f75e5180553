"""Level-wise (depth-wise) tree growth — the throughput mode.

A performance-oriented alternative to the reference-faithful best-first
grower (trees/grow.py): all fringe nodes of a level split in ONE batched
histogram computation (ops/histogram.py::node_histograms), so a
depth-D tree costs ~D histogram passes instead of one per split — about 4x
fewer passes for 16-leaf trees.  Unlike oblivious trees, every node still
chooses its OWN (feature, threshold); unlike best-first, the tree is grown
breadth-first to a fixed depth, the standard depth-wise GBDT regime
(XGBoost's default).  This mode is an extension — the reference grows
best-first only (rt.cc:49-90) — and produces depth-capped trees.

Gain/minls/routing semantics are identical to the best-first grower.

Leaf values are computed FROM the level histograms rather than by a
separate per-leaf aggregation pass (leaf_outputs -> segment_sums): a split
node's left-child sums are exactly the cumulative histogram entries at its
chosen (feature, bin) — the docs with bin <= threshold_bin — and the right
child is total - left; a node that stops splitting keeps its own totals.
This drops one aggregation pass and one psum per boosting iteration.  The Newton denominator (sum of lambda
weights, rt.cc:186-207) rides along as an extra histogram channel in place
of the squared-gradient channel, which only the best-first deviance
priority needs.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from quickrank_tpu.ops.histogram import node_histograms
from quickrank_tpu.trees.grow import GrowConfig, _feature_sample_mask
from quickrank_tpu.trees.structs import Tree

NEG_INF = float("-inf")
# DBL_EPSILON guard of rt.cc:200 (same as trees/grow.py::leaf_outputs)
_EPS = 2.220446049250313e-16


def _route_bits(binned, f_sel, t_star, pos, n_nodes):
    """Per-doc routing bit ``binned[n, f_sel[pos[n]]] > t_star[pos[n]]``.

    Two exact contractions instead of elementwise gathers over the doc
    axis (not yet timed against a gather on the GPU): a bf16 one-hot
    matmul picks each node's split-feature column, and a [N, nodes]
    one-hot select picks each doc's own node's value and threshold.  bf16 holds integers
    <= 256 exactly, so the u8 wire uses one plane; the u16 wire (> 256
    bins) contracts its hi and lo bytes separately — each product is exact
    and the f32 recombination 256*hi + lo is exact below 2**24."""
    F = binned.shape[1]
    sel = (f_sel[None, :] == jnp.arange(F)[:, None]).astype(jnp.bfloat16)

    def _plane(x):
        return jax.lax.dot_general(
            x.astype(jnp.bfloat16), sel,
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )  # [N, nodes]

    if binned.dtype == jnp.uint8:
        fcols = _plane(binned)
    else:
        b = binned.astype(jnp.int32)
        fcols = 256.0 * _plane(b >> 8) + _plane(b & 0xFF)
    own = pos[:, None] == jnp.arange(n_nodes)[None, :]
    val = jnp.sum(jnp.where(own, fcols, 0.0), axis=1)
    thr = jnp.sum(
        jnp.where(own, t_star[None, :].astype(jnp.float32), 0.0), axis=1
    )
    return val > thr


def fit_tree_levelwise(
    binned: jnp.ndarray,
    grad: jnp.ndarray,
    doc_mask: jnp.ndarray,
    thresholds: jnp.ndarray,
    depth: int,
    cfg: GrowConfig,
    key: Optional[jnp.ndarray] = None,
    axis_name: Optional[str] = None,
    weights: Optional[jnp.ndarray] = None,
) -> tuple[Tree, jnp.ndarray]:
    """Grow a depth-``depth`` tree breadth-first (heap node layout: node i
    has children 2i+1/2i+2; leaves occupy [2^depth - 1, 2^(depth+1) - 1)).

    Returns (Tree WITH leaf values, node_of_doc over ALL docs).  Leaf
    values are mean pseudoresponse, or the Newton step sum(lambda)/sum(w)
    when ``weights`` is given (must be when ``cfg.newton``).
    """
    N, F = binned.shape
    B = cfg.num_bins
    minls = cfg.min_leaf_support
    feat_axis = cfg.feat_axis
    F_global = F * cfg.feat_axis_size
    max_nodes = 2 ** (depth + 1) - 1
    if key is None:
        key = jax.random.PRNGKey(0)

    newton = weights is not None
    m = doc_mask.astype(grad.dtype)
    cols = [m, grad * m]
    if newton:
        cols.append(weights * m)
    chan = jnp.stack(cols, axis=-1)  # count, grad[, newton weight]

    tree = Tree.empty(max_nodes)
    # per-leaf numerator / denominator of the final value
    leaf_num = jnp.zeros((max_nodes,), jnp.float32)
    leaf_den = jnp.zeros((max_nodes,), jnp.float32)
    # level-local node index of each doc (0..2^d - 1 at level d)
    pos = jnp.zeros((N,), jnp.int32)
    nfs = cfg.num_feature_samples(F_global)

    for d in range(depth):
        n_nodes = 2**d
        base = n_nodes - 1  # heap id of first node at this level
        hist = node_histograms(
            binned, chan, pos, doc_mask, n_nodes, B, values_premasked=True
        )
        if axis_name is not None:
            hist = jax.lax.psum(hist, axis_name)
        key, sub = jax.random.split(key)
        feat_mask_g = _feature_sample_mask(sub, F_global, nfs)
        if feat_axis is None:
            feat_mask = feat_mask_g
        else:
            shard = jax.lax.axis_index(feat_axis)
            feat_mask = jax.lax.dynamic_slice(feat_mask_g, (shard * F,), (F,))

        cum = jnp.cumsum(hist, axis=2)  # [nodes, F, B, C]
        lc = cum[..., 0]
        ls = cum[..., 1]
        tc = cum[:, :, -1:, 0]
        ts = cum[:, :, -1:, 1]
        rc = tc - lc
        rs = ts - ls
        gain = ls * ls / jnp.maximum(lc, 1.0) + rs * rs / jnp.maximum(rc, 1.0)
        valid = (
            (lc >= minls) & (rc >= minls) & feat_mask[None, :, None]
        )
        gain = jnp.where(valid, gain, NEG_INF)
        flat = jnp.argmax(gain.reshape(n_nodes, -1), axis=1)  # [nodes]
        f_loc = (flat // B).astype(jnp.int32)
        t_loc = (flat % B).astype(jnp.int32)

        def _take(arr):  # arr [nodes, F, B] -> winner entry per node
            return jnp.take_along_axis(
                arr.reshape(n_nodes, -1), flat[:, None], axis=1
            )[:, 0]

        best = _take(gain)
        has_valid = jnp.any(valid.reshape(n_nodes, -1), axis=1)
        # left-child sums at the winning (feature, bin), and that feature's
        # totals (same summation order, so left + right == total exactly)
        l_cnt, l_grad = _take(lc), _take(ls)
        t_cnt = jnp.take_along_axis(tc[:, :, 0], f_loc[:, None], axis=1)[:, 0]
        t_grad = jnp.take_along_axis(ts[:, :, 0], f_loc[:, None], axis=1)[:, 0]
        if newton:
            lw = cum[..., 2]
            l_den = _take(lw)
            t_den = jnp.take_along_axis(
                cum[:, :, -1, 2], f_loc[:, None], axis=1
            )[:, 0]
        else:
            l_den, t_den = l_cnt, t_cnt
        # node totals for nodes that stop here (any feature column sums the
        # same docs; use column 0 — under feature sharding, shard 0's)
        stop_num = cum[:, 0, -1, 1]
        stop_den = cum[:, 0, -1, 2] if newton else cum[:, 0, -1, 0]

        if feat_axis is None:
            f_star, t_star = f_loc, t_loc
            can = has_valid & (best > 0)
            thr_val = thresholds[f_star, t_star]
            # per-doc routing bit for its OWN node's split
            bit = _route_bits(binned, f_star, t_star, pos, n_nodes).astype(
                jnp.int32
            )
        else:
            shard = jax.lax.axis_index(feat_axis)
            cand = jnp.stack(
                [
                    jnp.where(has_valid, best, NEG_INF),
                    (shard * F + f_loc).astype(jnp.float32),
                    t_loc.astype(jnp.float32),
                ],
                axis=1,
            )  # [nodes, 3]
            allc = jax.lax.all_gather(cand, feat_axis)  # [k, nodes, 3]
            bidx = jnp.argmax(allc[:, :, 0], axis=0)  # [nodes]
            sel = jnp.take_along_axis(allc, bidx[None, :, None], axis=0)[0]
            can = jnp.isfinite(sel[:, 0]) & (sel[:, 0] > 0)
            f_star = sel[:, 1].astype(jnp.int32)  # GLOBAL
            t_star = sel[:, 2].astype(jnp.int32)
            owns = (f_star // F) == shard
            fl = jnp.where(owns, f_star % F, 0)
            my_bit = _route_bits(binned, fl, t_star, pos, n_nodes)
            my_owns = owns[pos]
            bit = jax.lax.psum(
                (my_bit & my_owns).astype(jnp.int32), feat_axis
            )
            thr_val = jax.lax.psum(
                jnp.where(owns, thresholds[fl, t_star], 0.0), feat_axis
            )
            # leaf statistics must be identical on every feature shard to
            # keep trees replicated: route the owner's values (the global
            # winner is the owner's local candidate) through one psum
            def _owner(x):
                return jax.lax.psum(jnp.where(owns, x, 0.0), feat_axis)

            l_grad, l_den = _owner(l_grad), _owner(l_den)
            t_grad, t_den = _owner(t_grad), _owner(t_den)
            first = (shard == 0).astype(jnp.float32)
            stop_num = jax.lax.psum(stop_num * first, feat_axis)
            stop_den = jax.lax.psum(stop_den * first, feat_axis)

        # write this level's internal nodes
        ids = base + jnp.arange(n_nodes)
        tree = tree.replace(
            feature=tree.feature.at[ids].set(jnp.where(can, f_star, -1)),
            threshold=tree.threshold.at[ids].set(
                jnp.where(can, thr_val, 0.0)
            ),
            threshold_bin=tree.threshold_bin.at[ids].set(
                jnp.where(can, t_star, -1)
            ),
            left=tree.left.at[ids].set(jnp.where(can, 2 * ids + 1, 0)),
            right=tree.right.at[ids].set(jnp.where(can, 2 * ids + 2, 0)),
            is_leaf=tree.is_leaf.at[ids].set(~can),
        )
        # nodes that stop here are leaves: value from their own totals
        leaf_num = leaf_num.at[ids].set(jnp.where(can, 0.0, stop_num))
        leaf_den = leaf_den.at[ids].set(jnp.where(can, 0.0, stop_den))
        if d == depth - 1:
            # final level: children of split nodes are leaves
            leaf_num = leaf_num.at[2 * ids + 1].set(
                jnp.where(can, l_grad, 0.0)
            )
            leaf_den = leaf_den.at[2 * ids + 1].set(
                jnp.where(can, l_den, 0.0)
            )
            leaf_num = leaf_num.at[2 * ids + 2].set(
                jnp.where(can, t_grad - l_grad, 0.0)
            )
            leaf_den = leaf_den.at[2 * ids + 2].set(
                jnp.where(can, t_den - l_den, 0.0)
            )
        # docs in un-split nodes keep routing left (bit forced 0) so their
        # leaf-range collapse matches the perfect-tree embedding convention
        bit = jnp.where(can[pos], bit, 0)
        pos = 2 * pos + bit

    eps = jnp.float32(_EPS)
    value = jnp.where(
        leaf_den >= eps, leaf_num / jnp.maximum(leaf_den, eps), 0.0
    )
    tree = tree.replace(
        leaf_value=jnp.where(tree.is_leaf, value, 0.0)
    )

    # Final doc node id: replay each doc's recorded path bits over the tree
    # arrays, stopping at the first ancestor that stayed a leaf.  No feature
    # gathers, so this works unchanged under feature sharding.
    node = jnp.zeros((N,), jnp.int32)
    for d in range(depth):
        b = (pos >> (depth - 1 - d)) & 1
        nxt = jnp.where(b == 1, tree.right[node], tree.left[node])
        node = jnp.where(tree.is_leaf[node], node, nxt).astype(jnp.int32)
    return tree, node
