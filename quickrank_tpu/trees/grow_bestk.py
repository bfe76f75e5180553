"""Best-k regression-tree growth: best-first priority, packed histogram passes.

The reference grows strictly one split per histogram pass: pop the
max-deviance leaf, split it, push its children (src/learning/tree/
rt.cc:49-90); its OpenMP parallelism is over features *within* one split
(rt.cc:209-313).  One histogram pass (ops/histogram.py::node_histograms)
builds several nodes' child histograms at once, so exact best-first's
``nleaves - 1`` sequential passes make the pass chain itself the critical
path.

This grower pops the top-k highest-deviance heap leaves per round and
computes ALL their left-child histograms in one packed pass, parallelizing
over *splits* as well as features.  Every individual split still maximizes
the same gain over the same histogram under the same minls rule, and the
leaf budget is enforced exactly like rt.cc:64-90: an unsplittable popped
leaf freezes and counts toward ``taken``; at most ``nleaves - (taken +
|heap|)`` splits apply per round, in deviance-rank order, so the final
leaf count matches exact best-first's.

Deviation from exact best-first (k > 1 only): children created in a round
cannot be popped in the same round, so when a child's deviance would have
outranked the round's rank-2..k leaves, exact best-first would split the
child first.  Child deviance never *exceeds* the parent's (sum g^2 splits
additively and (sum g)^2/c is superadditive by Cauchy-Schwarz), so the
difference is only in WHICH leaves consume the budget, never in how any
individual split is chosen.  ``k=1`` reproduces trees/grow.py::fit_tree
exactly (tests/test_bestk.py pins it).

Sharding contract matches fit_tree: ``axis_name`` psums histograms over the
doc/query axis; ``cfg.feat_axis`` resolves per-leaf split candidates via a
tiny all_gather and routes doc bits from the owning feature shard via psum.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from quickrank_tpu.ops.histogram import doc_channels, node_histograms
from quickrank_tpu.trees.grow import (
    NEG_INF,
    GrowConfig,
    _GrowState,
    _best_split,
    _collapse_leaves,
    _deviance,
    _feature_sample_mask,
    _node_stats,
)
from quickrank_tpu.trees.grow_level import _route_bits
from quickrank_tpu.trees.structs import Tree


def fit_tree_bestk(
    binned: jnp.ndarray,
    grad: jnp.ndarray,
    doc_mask: jnp.ndarray,
    thresholds: jnp.ndarray,
    cfg: GrowConfig,
    k: int,
    key: Optional[jnp.ndarray] = None,
    axis_name: Optional[str] = None,
) -> tuple[Tree, jnp.ndarray]:
    """Grow one tree, splitting up to ``k`` heap leaves per histogram pass.

    Same signature/return contract as trees/grow.py::fit_tree (tree without
    leaf values + node_of_doc over ALL docs); ``k=1`` is bit-identical to
    it.  ``k`` is clamped to [1, nleaves - 1].
    """
    N, F = binned.shape  # F is the LOCAL block when feat-sharded
    B = cfg.num_bins
    max_nodes = cfg.max_nodes
    minls = cfg.min_leaf_support
    feat_axis = cfg.feat_axis
    F_global = F * cfg.feat_axis_size
    k = int(min(max(k, 1), max(cfg.nleaves - 1, 1)))
    if key is None:
        key = jax.random.PRNGKey(0)

    # premasked per-doc channels (count, g, g^2) — built once per tree
    chan = doc_channels(grad, doc_mask)  # [N, 3], zero rows where masked

    def hists_of(pos, num_nodes):
        h = node_histograms(
            binned, chan, pos, doc_mask, num_nodes, B, values_premasked=True
        )
        if axis_name is not None:
            h = jax.lax.psum(h, axis_name)
        return h

    pos_root = jnp.where(doc_mask, 0, 1).astype(jnp.int32)
    root_hist = hists_of(pos_root, 1)[0]
    c0, s0, s20 = _node_stats(root_hist)

    hist = jnp.zeros((max_nodes, F, B, 3), jnp.float32).at[0].set(root_hist)
    deviance = jnp.zeros((max_nodes,), jnp.float32).at[0].set(
        _deviance(c0, s0, s20)
    )
    active = jnp.zeros((max_nodes,), bool).at[0].set(True)

    state = _GrowState(
        tree=Tree.empty(max_nodes),
        node_of_doc=jnp.zeros((N,), jnp.int32),
        hist=hist,
        deviance=deviance,
        active=active,
        frozen=jnp.zeros((max_nodes,), bool),
        depth=jnp.zeros((max_nodes,), jnp.int32),
        parent=jnp.full((max_nodes,), -1, jnp.int32),
        n_nodes=jnp.asarray(1, jnp.int32),
        taken=jnp.asarray(0, jnp.int32),
        key=key,
    )

    nfs = cfg.num_feature_samples(F_global)
    ranks = jnp.arange(k, dtype=jnp.int32)

    def cond(s: _GrowState):
        heap = s.active & ~s.frozen
        hs = jnp.sum(heap.astype(jnp.int32))
        return (hs > 0) & (s.taken + hs < cfg.nleaves)

    def body(s: _GrowState) -> _GrowState:
        heap = s.active & ~s.frozen
        hs = jnp.sum(heap.astype(jnp.int32))
        sel_dev, sel_ids = jax.lax.top_k(jnp.where(heap, s.deviance, NEG_INF), k)
        sel_valid = sel_dev > NEG_INF  # rank beyond |heap| -> -inf sentinel

        keys = jax.random.split(s.key, k + 1)
        key = keys[0]
        # one feature-sampling draw per POPPED leaf (rt.cc:235-244), same
        # key schedule as fit_tree at k=1
        masks_g = jax.vmap(
            lambda kk: _feature_sample_mask(kk, F_global, nfs)
        )(keys[1:])
        if feat_axis is None:
            masks = masks_g
        else:
            shard = jax.lax.axis_index(feat_axis)
            masks = jax.vmap(
                lambda mg: jax.lax.dynamic_slice(mg, (shard * F,), (F,))
            )(masks_g)

        h_sel = s.hist[sel_ids]  # [k, F, B, 3] node-axis row gather (small)
        has_l, f_l, t_l, g_l = jax.vmap(_best_split, in_axes=(0, 0, None))(
            h_sel, masks, minls
        )
        if feat_axis is None:
            has_split, f_star, t_star = has_l, f_l, t_l
        else:
            # local candidates -> tiny all_gather -> replicated argmax/leaf
            shard = jax.lax.axis_index(feat_axis)
            cand = jnp.stack(
                [
                    jnp.where(has_l, g_l, NEG_INF),
                    (shard * F + f_l).astype(jnp.float32),
                    t_l.astype(jnp.float32),
                ],
                axis=1,
            )  # [k, 3]
            allc = jax.lax.all_gather(cand, feat_axis)  # [nshards, k, 3]
            bidx = jnp.argmax(allc[:, :, 0], axis=0)  # [k]
            selc = jnp.take_along_axis(allc, bidx[None, :, None], axis=0)[0]
            has_split = jnp.isfinite(selc[:, 0])
            f_star = selc[:, 1].astype(jnp.int32)  # GLOBAL feature ids
            t_star = selc[:, 2].astype(jnp.int32)

        can = sel_valid & has_split & (sel_dev > 0)
        if cfg.max_depth:
            can = can & (s.depth[sel_ids] < cfg.max_depth)
        # leaf budget: exactly rt.cc:64-90's stopping rule — only
        # nleaves - (taken + |heap|) more splits may happen; apply them in
        # deviance-rank order.  Splittable-but-over-budget leaves stay
        # active (never frozen): exact best-first would simply not have
        # popped them.
        capacity = cfg.nleaves - (s.taken + hs)
        can_i = can.astype(jnp.int32)
        allowed = can & (jnp.cumsum(can_i) - can_i < capacity)
        to_freeze = sel_valid & ~can

        n_allowed = jnp.sum(allowed.astype(jnp.int32))
        prefix = jnp.cumsum(allowed.astype(jnp.int32)) - allowed.astype(
            jnp.int32
        )
        # new-node ids in rank order (k=1 matches fit_tree's a, b = n, n+1);
        # disallowed ranks get out-of-bounds ids so every scatter below
        # drops them (mode="drop")
        a_ids = jnp.where(allowed, s.n_nodes + 2 * prefix, max_nodes)
        b_ids = jnp.where(allowed, s.n_nodes + 2 * prefix + 1, max_nodes)
        ids_w = jnp.where(allowed, sel_ids, max_nodes)

        # per-doc rank among the allowed leaves ([N, k] compares)
        own = (s.node_of_doc[:, None] == sel_ids[None, :]) & allowed[None, :]
        in_sel = jnp.any(own, axis=1)
        pos_sel = jnp.where(
            in_sel,
            jnp.sum(jnp.where(own, ranks[None, :], 0), axis=1),
            k,
        ).astype(jnp.int32)

        t_safe = jnp.clip(t_star, 0, B - 1)
        if feat_axis is None:
            f_loc = jnp.where(allowed, f_star, 0)
            # bit = goes RIGHT (value > threshold), one-hot-matmul routed
            bit = _route_bits(binned, f_loc, t_safe, pos_sel, k)
            thr_val = thresholds[f_loc, t_safe]
        else:
            shard = jax.lax.axis_index(feat_axis)
            owns = ((f_star // F) == shard) & allowed  # [k]
            fl = jnp.where(owns, f_star % F, 0)
            my_bit = _route_bits(binned, fl, t_safe, pos_sel, k)
            owns_doc = jnp.any(own & owns[None, :], axis=1)
            bit = (
                jax.lax.psum((my_bit & owns_doc).astype(jnp.int32), feat_axis)
                > 0
            )
            thr_val = jax.lax.psum(
                jnp.where(owns, thresholds[fl, t_safe], 0.0), feat_axis
            )

        # ONE packed pass for all k left children; right = parent - left
        # (the sibling trick of rtnode_histogram.cc:72-87, batched)
        pos_left = jnp.where(in_sel & ~bit, pos_sel, k)
        left = hists_of(pos_left, k)  # [k, F, B, 3]
        right = h_sel - left
        ca, sa, s2a = jax.vmap(_node_stats)(left)
        cb, sb, s2b = jax.vmap(_node_stats)(right)

        tree = s.tree.replace(
            feature=s.tree.feature.at[ids_w].set(f_star, mode="drop"),
            threshold=s.tree.threshold.at[ids_w].set(thr_val, mode="drop"),
            threshold_bin=s.tree.threshold_bin.at[ids_w].set(
                t_star, mode="drop"
            ),
            left=s.tree.left.at[ids_w].set(a_ids, mode="drop"),
            right=s.tree.right.at[ids_w].set(b_ids, mode="drop"),
            is_leaf=s.tree.is_leaf.at[ids_w].set(False, mode="drop"),
            n_nodes=s.n_nodes + 2 * n_allowed,
        )
        a_of_doc = jnp.sum(jnp.where(own, a_ids[None, :], 0), axis=1)
        node_of_doc = jnp.where(
            in_sel, a_of_doc + bit.astype(jnp.int32), s.node_of_doc
        ).astype(jnp.int32)
        d_child = s.depth[sel_ids] + 1
        return s.replace(
            tree=tree,
            node_of_doc=node_of_doc,
            hist=s.hist.at[a_ids].set(left, mode="drop").at[b_ids].set(
                right, mode="drop"
            ),
            deviance=s.deviance.at[a_ids]
            .set(_deviance(ca, sa, s2a), mode="drop")
            .at[b_ids]
            .set(_deviance(cb, sb, s2b), mode="drop"),
            active=s.active.at[ids_w]
            .set(False, mode="drop")
            .at[a_ids]
            .set(True, mode="drop")
            .at[b_ids]
            .set(True, mode="drop"),
            frozen=s.frozen.at[
                jnp.where(to_freeze, sel_ids, max_nodes)
            ].set(True, mode="drop"),
            depth=s.depth.at[a_ids]
            .set(d_child, mode="drop")
            .at[b_ids]
            .set(d_child, mode="drop"),
            parent=s.parent.at[a_ids]
            .set(sel_ids, mode="drop")
            .at[b_ids]
            .set(sel_ids, mode="drop"),
            n_nodes=s.n_nodes + 2 * n_allowed,
            taken=s.taken + jnp.sum(to_freeze.astype(jnp.int32)),
            key=key,
        )

    final = jax.lax.while_loop(cond, body, state)
    tree = final.tree
    node_of_doc = final.node_of_doc
    if cfg.collapse_factor > 0:
        if feat_axis is not None:
            raise NotImplementedError(
                "collapse-leaves-factor under feature sharding not supported"
            )
        tree = _collapse_leaves(
            tree, final.deviance, final.depth, final.parent, final.n_nodes,
            cfg.collapse_factor, max_nodes,
        )
        from quickrank_tpu.ops.scoring import descend_tree_binned

        node_of_doc = descend_tree_binned(binned, tree, cfg.nleaves)
    return tree, node_of_doc
