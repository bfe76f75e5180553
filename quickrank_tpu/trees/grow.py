"""Best-first regression-tree growth as one jittable fixed-shape loop.

Re-design of ``RegressionTree::fit`` / ``split``
(src/learning/tree/rt.cc:49-140, :208-355): the deviance max-heap becomes a
masked argmax over a dense per-node deviance vector; per-node sample-id lists
become a ``node_of_doc`` assignment vector updated in place; child histograms
are one masked scatter-add for the left child plus a parent-minus-left
subtraction for the right (the sibling trick of rtnode_histogram.cc:72-87).

Reference semantics preserved:
  * split priority = node deviance (sum g^2 - (sum g)^2 / count), rt.cc:59-76;
  * gain = lsum^2/lcount + rsum^2/rcount, any split with both children
    >= min_leaf_support is acceptable (initvar = -1, rt.cc:261-291);
  * loop until ``taken + |heap| >= nleaves`` where ``taken`` counts
    unsplittable nodes (rt.cc:64-90);
  * per-split feature subsampling for max_features != 1 (rt.cc:222-244);
  * doc routing ``x[f] <= threshold`` (rt.cc:330).

Sharded training: pass ``axis_name`` — each device holds a shard of the docs,
the left-child histogram is ``psum``-reduced, and every split decision (being
derived from the reduced histogram) is replicated across devices.  This is the
all-reduce of SURVEY.md §2.9.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
from quickrank_tpu.utils import struct

from quickrank_tpu.ops.histogram import doc_channels, masked_histogram
from quickrank_tpu.trees.structs import Tree

# Plain float (not a jnp array): module import must not initialize a backend.
NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class GrowConfig:
    nleaves: int = 10
    min_leaf_support: int = 1
    num_bins: int = 256
    max_features: float = 1.0  # 1.0 = all; <1 fraction; >1 count (rt.cc:222-233)
    newton: bool = False  # leaf = sum(g)/sum(w) instead of mean(g)
    #: feature-axis sharding (the "tensor parallel" analog, SURVEY.md §2.9):
    #: the histogram/split scan works on a local F/k feature block and the
    #: best split is resolved by a tiny all_gather of per-shard candidates.
    feat_axis: str | None = None
    feat_axis_size: int = 1
    #: optional depth cap (0 = unbounded, the reference's behavior)
    max_depth: int = 0
    #: bottom-up leaf-merge pruning (rt.cc:93-152): 0 = off.  After growth,
    #: nodes pop deepest-first (ties by deviance); a popped node's parent is
    #: collapsed into a leaf while n_nodes <= (2^(depth+1)-1) * factor, and
    #: the pass stops at the first violation.
    collapse_factor: float = 0.0

    @property
    def max_nodes(self) -> int:
        return 2 * self.nleaves - 1

    def num_feature_samples(self, F: int) -> int:
        if self.max_features == 1.0:
            return F
        if self.max_features > 1.0:
            return min(int(self.max_features), F)
        return min(int(-(-self.max_features * F // 1)), F)


@struct.dataclass
class _GrowState:
    tree: Tree
    node_of_doc: jnp.ndarray  # i32 [N]
    hist: jnp.ndarray  # f32 [max_nodes, F, B, 3]
    deviance: jnp.ndarray  # f32 [max_nodes]
    active: jnp.ndarray  # bool [max_nodes] current leaves
    frozen: jnp.ndarray  # bool [max_nodes] unsplittable leaves ("taken")
    depth: jnp.ndarray  # i32 [max_nodes] node depth
    parent: jnp.ndarray  # i32 [max_nodes] parent node (-1 for root)
    n_nodes: jnp.ndarray  # i32
    taken: jnp.ndarray  # i32
    key: jnp.ndarray


def _node_stats(hist_node: jnp.ndarray):
    """(count, sum_g, sum_g2) of a node from its [F, B, 3] histogram (all
    features see every doc once; read feature 0)."""
    c = jnp.sum(hist_node[0, :, 0])
    s = jnp.sum(hist_node[0, :, 1])
    s2 = jnp.sum(hist_node[0, :, 2])
    return c, s, s2


def _deviance(c, s, s2):
    """Node deviance = sum g^2 - (sum g)^2/count (rtnode_histogram.cc's
    squares_sum_ bookkeeping feeding rt.cc:59)."""
    return jnp.where(c > 0, s2 - s * s / jnp.maximum(c, 1.0), 0.0)


def _feature_sample_mask(key, F: int, k: int):
    """Random k-of-F feature mask (per split, rt.cc:235-244)."""
    if k >= F:
        return jnp.ones((F,), bool)
    r = jax.random.uniform(key, (F,))
    kth = jnp.sort(r)[k - 1]
    return r <= kth


def _best_split(hist_node, feat_mask, minls: int):
    """Scan the cumulative histogram for the max-gain (feature, bin).

    Returns (can_split, f_star, t_star, gain).  Vectorized form of
    rt.cc:257-313's per-feature threshold loop.
    """
    cum = jnp.cumsum(hist_node, axis=1)  # [F, B, 3]
    lc = cum[:, :, 0]
    ls = cum[:, :, 1]
    tc = cum[:, -1:, 0]
    ts = cum[:, -1:, 1]
    rc = tc - lc
    rs = ts - ls
    valid = (lc >= minls) & (rc >= minls) & feat_mask[:, None]
    gain = ls * ls / jnp.maximum(lc, 1.0) + rs * rs / jnp.maximum(rc, 1.0)
    gain = jnp.where(valid, gain, NEG_INF)
    flat = jnp.argmax(gain)
    B = gain.shape[1]
    f_star = (flat // B).astype(jnp.int32)
    t_star = (flat % B).astype(jnp.int32)
    return jnp.any(valid), f_star, t_star, gain.reshape(-1)[flat]


def fit_tree(
    binned: jnp.ndarray,
    grad: jnp.ndarray,
    doc_mask: jnp.ndarray,
    thresholds: jnp.ndarray,
    cfg: GrowConfig,
    key: Optional[jnp.ndarray] = None,
    axis_name: Optional[str] = None,
) -> tuple[Tree, jnp.ndarray]:
    """Grow one tree on (possibly sharded) binned docs.

    binned: i32 [N, F] bin ids; grad: f32 [N] pseudoresponses;
    doc_mask: bool [N] (False = padding or subsampled-out doc);
    thresholds: f32 [F, B] split values per bin.

    Returns (tree *without* leaf values — see :func:`leaf_outputs`,
    node_of_doc i32 [N] leaf assignment).  EVERY doc is routed (also masked
    ones — they just contribute nothing to statistics), so the caller can
    update training scores from ``leaf_value[node_of_doc]`` without a
    descent pass.

    Sharding: ``axis_name`` = doc/query axis (histograms psum-reduced);
    ``cfg.feat_axis`` = optional feature axis (binned/thresholds hold the
    local F/k block; split decisions resolved via a per-shard candidate
    all_gather; doc routing bits come from the owning shard via psum).
    Feature ids recorded in the tree are always GLOBAL.
    """
    N, F = binned.shape  # F is the LOCAL block when feat-sharded
    B = cfg.num_bins
    max_nodes = cfg.max_nodes
    minls = cfg.min_leaf_support
    feat_axis = cfg.feat_axis
    F_global = F * cfg.feat_axis_size
    if key is None:
        key = jax.random.PRNGKey(0)

    # premasked channel rows built ONCE per tree; each split passes only
    # its doc subset, which the histogram pass reads as a node id
    chan = doc_channels(grad, doc_mask)

    def hist_of(mask):
        h = masked_histogram(binned, chan, mask, B)
        if axis_name is not None:
            h = jax.lax.psum(h, axis_name)
        return h

    root_hist = hist_of(doc_mask)
    c0, s0, s20 = _node_stats(root_hist)

    hist = jnp.zeros((max_nodes, F, B, 3), jnp.float32).at[0].set(root_hist)
    deviance = jnp.zeros((max_nodes,), jnp.float32).at[0].set(_deviance(c0, s0, s20))
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

    def cond(s: _GrowState):
        heap = s.active & ~s.frozen
        hs = jnp.sum(heap.astype(jnp.int32))
        return (hs > 0) & (s.taken + hs < cfg.nleaves)

    def body(s: _GrowState) -> _GrowState:
        heap = s.active & ~s.frozen
        leaf = jnp.argmax(jnp.where(heap, s.deviance, NEG_INF)).astype(jnp.int32)
        key, sub = jax.random.split(s.key)
        # global sampling mask (same key on every shard), local slice
        feat_mask_g = _feature_sample_mask(sub, F_global, nfs)
        if feat_axis is None:
            feat_mask = feat_mask_g
        else:
            shard = jax.lax.axis_index(feat_axis)
            feat_mask = jax.lax.dynamic_slice(feat_mask_g, (shard * F,), (F,))
        h_leaf = s.hist[leaf]
        if feat_axis is None:
            has_split, f_star, t_star, _ = _best_split(h_leaf, feat_mask, minls)
        else:
            # local candidate -> tiny all_gather -> replicated global argmax
            has_l, f_l, t_l, g_l = _best_split(h_leaf, feat_mask, minls)
            shard = jax.lax.axis_index(feat_axis)
            cand = jnp.stack(
                [
                    jnp.where(has_l, g_l, NEG_INF),
                    (shard * F + f_l).astype(jnp.float32),
                    t_l.astype(jnp.float32),
                ]
            )
            allc = jax.lax.all_gather(cand, feat_axis)  # [k, 3]
            bidx = jnp.argmax(allc[:, 0])
            has_split = jnp.isfinite(allc[bidx, 0])
            f_star = allc[bidx, 1].astype(jnp.int32)  # GLOBAL feature id
            t_star = allc[bidx, 2].astype(jnp.int32)
        can_split = has_split & (s.deviance[leaf] > 0)
        if cfg.max_depth:
            can_split = can_split & (s.depth[leaf] < cfg.max_depth)

        def do_split(s: _GrowState) -> _GrowState:
            a = s.n_nodes
            b = s.n_nodes + 1
            if feat_axis is None:
                fcol = jax.lax.dynamic_index_in_dim(
                    binned, f_star, axis=1, keepdims=False
                )
                goes_left = fcol <= t_star
                thr_val = thresholds[f_star, t_star]
            else:
                # the owning feature shard broadcasts routing bits + value
                shard = jax.lax.axis_index(feat_axis)
                owns = (f_star // F) == shard
                fl = jnp.where(owns, f_star % F, 0)
                col = jax.lax.dynamic_index_in_dim(
                    binned, fl, axis=1, keepdims=False
                )
                bit = ((col <= t_star) & owns).astype(jnp.int32)
                goes_left = jax.lax.psum(bit, feat_axis) > 0
                thr_val = jax.lax.psum(
                    jnp.where(owns, thresholds[fl, t_star], 0.0), feat_axis
                )
            in_leaf = s.node_of_doc == leaf
            node_of_doc = jnp.where(
                in_leaf, jnp.where(goes_left, a, b), s.node_of_doc
            ).astype(jnp.int32)
            left_hist = hist_of(in_leaf & goes_left & doc_mask)
            right_hist = h_leaf - left_hist
            ca, sa, s2a = _node_stats(left_hist)
            cb, sb, s2b = _node_stats(right_hist)
            tree = s.tree.replace(
                feature=s.tree.feature.at[leaf].set(f_star),
                threshold=s.tree.threshold.at[leaf].set(thr_val),
                threshold_bin=s.tree.threshold_bin.at[leaf].set(t_star),
                left=s.tree.left.at[leaf].set(a),
                right=s.tree.right.at[leaf].set(b),
                is_leaf=s.tree.is_leaf.at[leaf].set(False),
                n_nodes=s.n_nodes + 2,
            )
            return s.replace(
                tree=tree,
                node_of_doc=node_of_doc,
                hist=s.hist.at[a].set(left_hist).at[b].set(right_hist),
                deviance=s.deviance.at[a]
                .set(_deviance(ca, sa, s2a))
                .at[b]
                .set(_deviance(cb, sb, s2b)),
                active=s.active.at[leaf].set(False).at[a].set(True).at[b].set(True),
                depth=s.depth.at[a]
                .set(s.depth[leaf] + 1)
                .at[b]
                .set(s.depth[leaf] + 1),
                parent=s.parent.at[a].set(leaf).at[b].set(leaf),
                n_nodes=s.n_nodes + 2,
                key=key,
            )

        def freeze(s: _GrowState) -> _GrowState:
            return s.replace(
                frozen=s.frozen.at[leaf].set(True),
                taken=s.taken + 1,
                key=key,
            )

        return jax.lax.cond(can_split, do_split, freeze, s)

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


def _collapse_leaves(
    tree: Tree, deviance, depth, parent, n_nodes, factor: float, max_nodes: int
) -> Tree:
    """Bottom-up leaf-merge pruning (rt.cc:93-152 + tree_heap_nodes
    :364-384): pop nodes deepest-first (ties broken by deviance/max_deviance,
    the heap key ``depth + dev/max_dev``); a popped node's parent collapses
    into a leaf while ``n_nodes <= (2^(depth+1)-1) * factor``, stopping at
    the first violation."""
    idx = jnp.arange(max_nodes)
    exists = (idx < n_nodes) & (idx > 0)  # root entry is skipped (depth 0)
    max_dev = jnp.maximum(jnp.max(jnp.where(exists, deviance, 0.0)), 1e-30)
    prio = jnp.where(
        exists, depth.astype(jnp.float32) + deviance / max_dev, NEG_INF
    )

    def cond(s):
        tree, processed, n_eff, stop = s
        return jnp.any(~processed & exists) & ~stop

    def body(s):
        tree, processed, n_eff, stop = s
        i = jnp.argmax(jnp.where(~processed & exists, prio, NEG_INF))
        processed = processed.at[i].set(True)
        p = parent[i]
        eligible = (depth[i] > 0) & (p >= 0) & ~tree.is_leaf[jnp.maximum(p, 0)]

        max_n = jnp.left_shift(1, depth[i] + 1) - 1
        break_now = n_eff.astype(jnp.float32) > max_n.astype(jnp.float32) * factor

        def merge(args):
            tree, n_eff, stop = args
            t2 = tree.replace(
                is_leaf=tree.is_leaf.at[p].set(True),
                feature=tree.feature.at[p].set(-1),
                threshold=tree.threshold.at[p].set(0.0),
                threshold_bin=tree.threshold_bin.at[p].set(-1),
            )
            return t2, n_eff - 2, stop

        def brk(args):
            tree, n_eff, stop = args
            return tree, n_eff, True

        def act(args):
            return jax.lax.cond(break_now, brk, merge, args)

        tree, n_eff, stop = jax.lax.cond(
            eligible, act, lambda a: a, (tree, n_eff, stop)
        )
        return tree, processed, n_eff, stop

    tree, _, _, _ = jax.lax.while_loop(
        cond,
        body,
        (tree, jnp.zeros((max_nodes,), bool), n_nodes, jnp.asarray(False)),
    )
    return tree


def segment_sums(index: jnp.ndarray, values: jnp.ndarray, num_slots: int):
    """sum_n values[n, c] into slot index[n]: [num_slots, C] (one scatter-
    add; out-of-range indices clamp into the edge slots)."""
    C = values.shape[-1]
    out = jnp.zeros((num_slots, C), jnp.float32)
    return out.at[jnp.clip(index, 0, num_slots - 1)].add(
        values, mode="drop"
    )


def leaf_outputs(
    tree: Tree,
    node_of_doc: jnp.ndarray,
    grad: jnp.ndarray,
    doc_mask: jnp.ndarray,
    weights: Optional[jnp.ndarray] = None,
    axis_name: Optional[str] = None,
) -> Tree:
    """Fill leaf values: mean pseudoresponse (rt.cc:165-184) or the Newton
    step sum(lambda)/sum(w) when ``weights`` given (rt.cc:186-207)."""
    max_nodes = tree.max_nodes
    ok = doc_mask & (node_of_doc >= 0)
    g = jnp.where(ok, grad, 0.0)
    den_src = (
        ok.astype(jnp.float32)
        if weights is None
        else jnp.where(ok, weights, 0.0)
    )
    vals = jnp.stack([g, den_src], axis=-1)
    idx = jnp.where(ok, node_of_doc, max_nodes)
    both = segment_sums(idx, vals, max_nodes + 1)
    if axis_name is not None:
        both = jax.lax.psum(both, axis_name)
    sums, den = both[:max_nodes, 0], both[:max_nodes, 1]
    eps = jnp.float32(2.220446049250313e-16)  # DBL_EPSILON guard of rt.cc:200
    value = jnp.where(den >= eps, sums / jnp.maximum(den, eps), 0.0)
    return tree.replace(leaf_value=jnp.where(tree.is_leaf, value, 0.0))
