"""Oblivious (symmetric) regression trees: level-synchronous fit + dense SoA.

Re-design of ``ObliviousRT`` (src/learning/tree/ot.cc:32-201):
one (feature, threshold) is chosen per depth level by maximizing the gain
summed across every fringe node, then all nodes split synchronously.  The
per-level histogram walk becomes one batched ``node_histograms`` scatter-add
over all 2^d fringe nodes, and the (feature, bin) scan is a single masked
argmax over the summed gain tensor.

Reference semantics preserved (ot.cc:177-201 ``fill``):
  * gain(f, t) = sum over fringe nodes of lsum^2/lcount + rsum^2/rcount;
  * a (f, t) violating min_leaf_support in ANY fringe node is invalid;
  * growth stops early when no (f, t) is valid or max gain == 0 — dead
    levels get threshold +inf (every doc routes left), preserving depth-D
    static shapes;
  * leaf values = per-leaf mean (or Newton sum(lambda)/sum(w)) via
    :func:`oblivious_leaf_outputs`.

The dense layout (feature id + threshold per LEVEL, 2^D leaf values) is what
makes scoring traversal-free: leaf index = OR of per-level comparison bits —
exactly the quickscore oblivious trick (src/io/generate_oblivious.cc:306-312).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from quickrank_tpu.utils import struct

from quickrank_tpu.ops.histogram import node_histograms

NEG_INF = float("-inf")
FLT_MAX = float(3.4028235e38)


@struct.dataclass
class ObliviousEnsemble:
    """Stacked oblivious trees.

    fid: i32 [T, D] split feature per level; thr: f32 [T, D] (+FLT_MAX on
    dead levels); thr_bin: i32 [T, D]; leaf: f32 [T, 2^D]; weight: f32 [T];
    num_trees: i32 scalar (live prefix).
    """

    fid: jnp.ndarray
    thr: jnp.ndarray
    thr_bin: jnp.ndarray
    leaf: jnp.ndarray
    weight: jnp.ndarray
    num_trees: jnp.ndarray

    @property
    def capacity(self) -> int:
        return int(self.fid.shape[0])

    @property
    def depth(self) -> int:
        return int(self.fid.shape[1])

    @property
    def num_leaves(self) -> int:
        return int(self.leaf.shape[1])

    @staticmethod
    def empty(capacity: int, depth: int) -> "ObliviousEnsemble":
        return ObliviousEnsemble(
            fid=jnp.zeros((capacity, depth), jnp.int32),
            thr=jnp.full((capacity, depth), FLT_MAX, jnp.float32),
            thr_bin=jnp.full((capacity, depth), 2**30, jnp.int32),
            leaf=jnp.zeros((capacity, 2**depth), jnp.float32),
            weight=jnp.zeros((capacity,), jnp.float32),
            num_trees=jnp.asarray(0, jnp.int32),
        )

    def push(self, fid, thr, thr_bin, leaf, weight) -> "ObliviousEnsemble":
        t = self.num_trees
        return self.replace(
            fid=self.fid.at[t].set(fid),
            thr=self.thr.at[t].set(thr),
            thr_bin=self.thr_bin.at[t].set(thr_bin),
            leaf=self.leaf.at[t].set(leaf),
            weight=self.weight.at[t].set(jnp.asarray(weight, jnp.float32)),
            num_trees=t + 1,
        )


def fit_oblivious_tree(
    binned: jnp.ndarray,
    grad: jnp.ndarray,
    doc_mask: jnp.ndarray,
    thresholds: jnp.ndarray,
    depth: int,
    min_leaf_support: int = 1,
    axis_name: Optional[str] = None,
    feat_axis: Optional[str] = None,
):
    """Level-synchronous fit (ot.cc:46-175 semantics, fully batched).

    Returns (fid [D], thr [D], thr_bin [D], node_of_doc [N] in [0, 2^D)).
    Feature ids are GLOBAL when ``feat_axis`` shards the feature blocks
    (same candidate all_gather + owner-psum routing as trees/grow.py).
    """
    N, F = binned.shape  # F is the LOCAL block when feat-sharded
    B = thresholds.shape[1]
    # 2-channel stack (count, grad) — the shared-split gain scan below
    # never reads the grad^2 channel (only the best-first deviance
    # priority needs it, cf. grow_level.py's header): dropping it cuts a
    # third of the histogram bandwidth and packs 16 instead of 10 nodes
    # per kernel pass (per_pass = 32 // C)
    m = doc_mask.astype(grad.dtype)
    chan = jnp.stack([m, grad * m], axis=-1)
    node = jnp.zeros((N,), jnp.int32)
    fid = jnp.zeros((depth,), jnp.int32)
    thr = jnp.full((depth,), FLT_MAX, jnp.float32)
    thr_bin = jnp.full((depth,), B, jnp.int32)
    alive = jnp.asarray(True)

    for d in range(depth):
        n_nodes = 2**d
        # mask already baked into the channel rows
        hist = node_histograms(
            binned, chan, node, doc_mask, n_nodes, B, values_premasked=True
        )
        if axis_name is not None:
            hist = jax.lax.psum(hist, axis_name)
        cum = jnp.cumsum(hist, axis=2)  # [nodes, F, B, 2]
        lc = cum[..., 0]
        ls = cum[..., 1]
        tc = cum[:, :, -1:, 0]
        ts = cum[:, :, -1:, 1]
        rc = tc - lc
        rs = ts - ls
        node_gain = ls * ls / jnp.maximum(lc, 1.0) + rs * rs / jnp.maximum(rc, 1.0)
        ok = (lc >= min_leaf_support) & (rc >= min_leaf_support)
        valid = jnp.all(ok, axis=0)  # [F, B]: must hold for EVERY fringe node
        gain = jnp.where(valid, jnp.sum(node_gain, axis=0), NEG_INF)
        flat = jnp.argmax(gain)
        f_loc = (flat // B).astype(jnp.int32)
        t_loc = (flat % B).astype(jnp.int32)
        best = gain.reshape(-1)[flat]

        if feat_axis is None:
            f_star, t_star = f_loc, t_loc
            has_valid = jnp.any(valid)
            best_g = best
            fcol = jax.lax.dynamic_index_in_dim(
                binned, f_star, axis=1, keepdims=False
            )
            bit = (fcol > t_star).astype(jnp.int32)
            thr_val = thresholds[f_star, t_star]
        else:
            shard = jax.lax.axis_index(feat_axis)
            cand = jnp.stack(
                [
                    jnp.where(jnp.any(valid), best, NEG_INF),
                    (shard * F + f_loc).astype(jnp.float32),
                    t_loc.astype(jnp.float32),
                ]
            )
            allc = jax.lax.all_gather(cand, feat_axis)
            bidx = jnp.argmax(allc[:, 0])
            has_valid = jnp.isfinite(allc[bidx, 0])
            best_g = allc[bidx, 0]
            f_star = allc[bidx, 1].astype(jnp.int32)  # GLOBAL
            t_star = allc[bidx, 2].astype(jnp.int32)
            owns = (f_star // F) == shard
            fl = jnp.where(owns, f_star % F, 0)
            col = jax.lax.dynamic_index_in_dim(binned, fl, axis=1, keepdims=False)
            bit = jax.lax.psum(
                ((col > t_star) & owns).astype(jnp.int32), feat_axis
            )
            thr_val = jax.lax.psum(
                jnp.where(owns, thresholds[fl, t_star], 0.0), feat_axis
            )

        can = alive & has_valid & (best_g > 0)
        node = jnp.where(can, 2 * node + bit, 2 * node)
        fid = fid.at[d].set(jnp.where(can, f_star, 0))
        thr = thr.at[d].set(jnp.where(can, thr_val, FLT_MAX))
        thr_bin = thr_bin.at[d].set(jnp.where(can, t_star, B))
        alive = can

    return fid, thr, thr_bin, node


def oblivious_leaf_outputs(
    node_of_doc: jnp.ndarray,
    grad: jnp.ndarray,
    doc_mask: jnp.ndarray,
    num_leaves: int,
    weights: Optional[jnp.ndarray] = None,
    axis_name: Optional[str] = None,
) -> jnp.ndarray:
    """Leaf values: mean pseudoresponse (ot.cc:146-152) or Newton step."""
    from quickrank_tpu.trees.grow import segment_sums

    ok = doc_mask
    idx = jnp.where(ok, node_of_doc, num_leaves)
    g = jnp.where(ok, grad, 0.0)
    den_src = (
        ok.astype(jnp.float32)
        if weights is None
        else jnp.where(ok, weights, 0.0)
    )
    both = segment_sums(idx, jnp.stack([g, den_src], axis=-1), num_leaves + 1)
    if axis_name is not None:
        both = jax.lax.psum(both, axis_name)
    sums, den = both[:num_leaves, 0], both[:num_leaves, 1]
    eps = jnp.float32(2.220446049250313e-16)
    return jnp.where(den >= eps, sums / jnp.maximum(den, eps), 0.0)


# ---------------------------------------------------------------------------
# Conversion to the generic padded-binary-tree layout (shared ensemble/XML
# machinery): an oblivious tree IS the perfect tree that repeats (fid, thr)
# across each level.
# ---------------------------------------------------------------------------


def oblivious_to_tree(fid, thr, thr_bin, leaf):
    """(fid [D], thr [D], leaf [2^D]) -> dense Tree arrays (perfect tree,
    heap layout: node i children 2i+1 / 2i+2, leaves at the last level)."""
    from quickrank_tpu.trees.structs import Tree

    D = fid.shape[0]
    L = 2**D
    n_internal = L - 1
    max_nodes = 2 * L - 1

    idx = jnp.arange(max_nodes)
    internal = idx < n_internal
    # Heap layout: node i sits at depth floor(log2(i + 1)).
    lvl = jnp.clip(
        jnp.floor(jnp.log2(idx.astype(jnp.float32) + 1.0)).astype(jnp.int32),
        0,
        D - 1,
    )
    feature = jnp.where(internal, fid[lvl], -1).astype(jnp.int32)
    threshold = jnp.where(internal, thr[lvl], 0.0).astype(jnp.float32)
    tbin = jnp.where(internal, thr_bin[lvl], -1).astype(jnp.int32)
    left = jnp.where(internal, 2 * idx + 1, 0).astype(jnp.int32)
    right = jnp.where(internal, 2 * idx + 2, 0).astype(jnp.int32)
    is_leaf = ~internal
    leaf_value = jnp.concatenate([jnp.zeros((n_internal,), jnp.float32), leaf])
    return Tree(
        feature=feature,
        threshold=threshold,
        threshold_bin=tbin,
        left=left,
        right=right,
        is_leaf=is_leaf,
        leaf_value=leaf_value,
        n_nodes=jnp.asarray(max_nodes, jnp.int32),
    )
