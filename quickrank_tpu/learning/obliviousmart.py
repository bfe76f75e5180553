"""Oblivious MART / Oblivious LambdaMART — symmetric-tree boosting.

Counterparts of ``ObliviousMart`` / ``ObliviousLambdaMart``
(src/learning/forests/obliviousmart.cc, obliviouslambdamart.cc): identical
boosting loops to Mart/LambdaMart but the regressor is the level-synchronous
oblivious tree (trees/oblivious.py, ot.cc semantics).  The fitted tree is
stored in the shared dense ensemble layout (a perfect binary tree repeating
one (feature, threshold) per level), and inference can additionally use the
traversal-free bit-OR scorer (ops/oblivious.py) — the quickscore path.
"""

from __future__ import annotations

from functools import lru_cache as _lru_cache

import numpy as np
import jax.numpy as jnp

from quickrank_tpu.learning.lambdamart import LambdaMart
from quickrank_tpu.learning.mart import Mart, StepData
from quickrank_tpu.ops.oblivious import score_oblivious
from quickrank_tpu.trees.oblivious import (
    ObliviousEnsemble,
    fit_oblivious_tree,
    oblivious_to_tree,
)


@_lru_cache(maxsize=None)
def _oblivious_scorer(tree_chunk):
    """Stable function object per chunk size for score_rows_sharded's
    (fn, mesh) memoization: a fresh function per call would recompile
    the scorer on every mesh scoring call."""

    def fn(f, e):
        return score_oblivious(f, e, tree_chunk=tree_chunk)

    return fn


class _ObliviousFit:
    """Mixin: replace the best-first grower with the oblivious fit and use
    the bit-OR fast scorer for inference."""

    def __init__(self, *args, treedepth: int = 4, **kw):
        super().__init__(*args, **kw)
        self.treedepth = int(treedepth)
        # nleaves drives ensemble node capacity: a depth-D oblivious tree is
        # a perfect tree with 2^D leaves.
        self.nleaves = 2**self.treedepth

    def _descend_depth(self) -> int:
        return self.treedepth + 1

    def _info_dict(self) -> dict:
        d = super()._info_dict()
        d["depth"] = self.treedepth  # obliviousmart.cc:77
        return d

    @classmethod
    def _ctor_kwargs_from_info(cls, info) -> dict:
        kw = super()._ctor_kwargs_from_info(info)
        kw.pop("nleaves", None)  # derived from depth
        kw["treedepth"] = cls._info_get(info, "depth", int, 4)
        return kw

    def _fit_and_assign(
        self, tr: StepData, grad, smask, cfg, key, axis_name, weights=None
    ):
        fid, thr, tbin, leafidx = fit_oblivious_tree(
            tr.binned,
            grad,
            smask,
            tr.thresholds,
            self.treedepth,
            min_leaf_support=self.minleafsupport,
            axis_name=axis_name,
            feat_axis=cfg.feat_axis,
        )
        L = 2**self.treedepth
        tree = oblivious_to_tree(fid, thr, tbin, jnp.zeros((L,), jnp.float32))
        # Leaf node ids in the perfect-tree layout: internal nodes occupy
        # [0, L-1), leaves are (L-1) + leafidx.  Every doc is routed; the
        # sample mask only gates statistics.
        node = ((L - 1) + leafidx).astype(jnp.int32)
        return tree, node, False

    # -- fast inference ------------------------------------------------------

    def oblivious_ensemble(self) -> ObliviousEnsemble:
        """Extract the [T, D] level tables from the stored symmetric trees.

        Node-numbering agnostic (works for freshly-trained heap-layout trees
        and XML-loaded DFS-numbered ones): per level, (feature, threshold)
        is read off the leftmost path; leaf l is reached by walking l's bits.
        Cached per ensemble (like Mart's _qs_tables):
        the pure-Python extraction is ~T*(D + L*D) iterations, which a
        per-round quickscore mesh loop would otherwise repay every call.
        """
        ens = self._require_model()
        cached = getattr(self, "_obl_cache", None)
        if cached is not None and cached[0] is ens:
            return cached[1]
        T = int(ens.num_trees)
        D = self.treedepth
        L = 2**D
        feat = np.asarray(ens.feature)
        thrv = np.asarray(ens.threshold)
        tbv = np.asarray(ens.threshold_bin)
        lft = np.asarray(ens.left)
        rgt = np.asarray(ens.right)
        lv = np.asarray(ens.leaf_value)
        isl = np.asarray(ens.is_leaf)

        fid = np.zeros((T, D), np.int32)
        thr = np.full((T, D), np.finfo(np.float32).max, np.float32)
        tbin = np.full((T, D), 2**30, np.int32)
        leaf = np.zeros((T, L), np.float32)
        for t in range(T):
            node = 0
            for d in range(D):
                if isl[t, node]:
                    break  # shallower tree: dead levels keep +inf thresholds
                fid[t, d] = feat[t, node]
                thr[t, d] = thrv[t, node]
                tbin[t, d] = tbv[t, node]
                node = lft[t, node]
            for l in range(L):
                node = 0
                for d in range(D):
                    if isl[t, node]:
                        break
                    node = rgt[t, node] if (l >> (D - 1 - d)) & 1 else lft[t, node]
                leaf[t, l] = lv[t, node]
        obl = ObliviousEnsemble(
            fid=jnp.asarray(fid),
            thr=jnp.asarray(thr),
            thr_bin=jnp.asarray(tbin),
            leaf=jnp.asarray(leaf),
            weight=ens.weight[:T],
            num_trees=jnp.asarray(T, jnp.int32),
        )
        self._obl_cache = (ens, obl)
        return obl

    def _dispatch_scorer(self, ds, tree_chunk: int = 0):
        """Oblivious override of Mart's dispatch: the bit-OR level-table
        scorer (ops/oblivious.py).  Also serves device_scorer, so
        quickscore.py's timing loop stays device-side."""
        return _oblivious_scorer(tree_chunk), self.oblivious_ensemble(), ds.features

    def score_dataset(self, ds, tree_chunk: int = 0, mesh=None) -> np.ndarray:
        """Scores via the symmetric-tree fast path.  With ``mesh`` the doc
        rows fan out over every mesh axis (parallel/mesh.py::
        score_rows_sharded), the bit-OR scorer running per shard."""
        fn, obl, feats = self._dispatch_scorer(ds, tree_chunk)
        if mesh is not None:
            from quickrank_tpu.parallel.mesh import score_rows_sharded

            return score_rows_sharded(fn, feats, obl, mesh)
        return np.asarray(fn(jnp.asarray(feats), obl))


class ObliviousMart(_ObliviousFit, Mart):
    NAME = "OBVMART"


class ObliviousLambdaMart(_ObliviousFit, LambdaMart):
    NAME = "OBVLAMBDAMART"
