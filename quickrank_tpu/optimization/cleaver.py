"""CLEAVER — ensemble pruning + line-search re-weighting.

Re-design of ``Cleaver`` (src/optimization/post_learning/cleaver/
cleaver.cc:166-418) and its 8 pruning strategies (random_pruning.cc,
random_adv_pruning.cc, low_weights_pruning.cc, skip_pruning.cc,
last_pruning.cc, quality_loss_pruning.cc, quality_loss_adv_pruning.cc,
score_loss_pruning.cc).  Everything operates on the **partial-score matrix**
``P [num_docs, num_trees]`` (one batched scoring pass replaces the
per-doc/per-tree loop of Driver::extract_partial_scores, driver.cc:411-446);
each strategy's per-candidate rescoring is a masked broadcast + one batched
metric evaluation instead of an OpenMP loop.

Flow (cleaver.cc:166-418):
  1. weights <- algo weights (or preset);
  2. optional LineSearch *pre*-pruning for weight-sensitive strategies
     (LOW_WEIGHTS / QUALITY_LOSS(_ADV) / SCORE_LOSS);
  3. ``pruning`` picks ``estimators_to_prune`` trees from the last
     ``last_estimators_to_optimize`` ones;
  4. weights reset to their pre-LS values, pruned entries zeroed;
  5. optional LineSearch *post*-pruning on the column-filtered matrix;
  6. ``algo.update_weights`` writes back (dropping zero-weight trees).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from quickrank_tpu.data.dataset import Dataset, shard_and_pad
from quickrank_tpu.learning.linear import (
    LineSearch,
    matmul_highest,
    eval_padded_local,
    padded_specs,
    shard_padded,
)
from quickrank_tpu.metrics.metrics import Metric

PRUNING_METHODS = (
    "RANDOM",
    "RANDOM_ADV",
    "LOW_WEIGHTS",
    "SKIP",
    "LAST",
    "QUALITY_LOSS",
    "QUALITY_LOSS_ADV",
    "SCORE_LOSS",
)

#: strategies that need line-search-derived weights before pruning
#: (cleaver.cc:44-47 + each strategy's line_search_pre_pruning())
_PRE_LS = {"LOW_WEIGHTS", "QUALITY_LOSS", "QUALITY_LOSS_ADV", "SCORE_LOSS"}


class _PartialEval:
    """Device-resident metric evaluation over a partial-score dataset.

    Holds the padded [N, T] per-tree score matrix on device (sharded over a
    1-D data mesh when given) and exposes the jitted primitives every
    quality-aware pruning strategy needs.  This replaces the reference's
    OpenMP candidate loops over host memory (quality_loss_pruning.cc:49-79,
    random_adv_pruning.cc:43-76, score_loss_pruning.cc:58-77) with batched
    device passes whose only cross-chip traffic is the metric (num, den)
    psum — at MSLR scale the ~10 GB partial matrix stays sharded on device
    instead of living in host f64.
    """

    def __init__(self, metric: Metric, ds: Dataset, mesh=None):
        self.metric = metric
        self.mesh = mesh
        self.axis = axis = mesh.axis_names[0] if mesh is not None else None
        nsh = int(mesh.shape[axis]) if mesh is not None else 1
        padded = shard_and_pad(ds, num_shards=nsh)
        if mesh is not None:
            padded = shard_padded(padded, mesh, axis)
        self.padded = padded
        self.num_trees = ds.num_features

        if mesh is not None:
            from jax.sharding import PartitionSpec as P

            from quickrank_tpu.learning.mart import shard_map

            rep, dvec, mat = P(), P(axis), P(axis, None)
            tr = padded_specs(padded, axis)

            def wrap(f, in_specs, out_specs):
                return jax.jit(
                    shard_map(f, mesh, in_specs=in_specs, out_specs=out_specs)
                )
        else:
            rep = dvec = mat = tr = None

            def wrap(f, in_specs, out_specs):
                return jax.jit(f)

        def base_f(w, X):
            return matmul_highest(X, w)

        def metric_f(scores, padded):
            return eval_padded_local(metric, padded, scores, axis)

        def drop_one_f(base, w, X, idxs, padded):
            # only the candidate window's trees (idxs), not all T — with
            # --opt-last-only the window can be 20x smaller than T
            def one(f):
                col = jax.lax.dynamic_index_in_dim(X, f, 1, keepdims=False)
                return eval_padded_local(metric, padded, base - w[f] * col, axis)

            return jax.vmap(one)(idxs)

        def apply_drop_f(base, w, X, f):
            col = jax.lax.dynamic_index_in_dim(X, f, 1, keepdims=False)
            return base - w[f] * col

        def mask_metrics_f(base, w, masks, X, padded):
            # cand_b = base - X @ (w * m_b): one [N, T] x [T, B] matmul
            delta = matmul_highest(X, w[:, None] * masks.T)
            return jax.vmap(
                lambda d: eval_padded_local(metric, padded, base - d, axis)
            )(delta.T)

        def score_loss_f(base, w, X, padded):
            # sum_docs w_f * P[:, f] / score (score_loss_pruning.cc:58-77);
            # padding rows have X == 0 so they contribute nothing.
            safe = jnp.where(base == 0, 1e-12, base)
            s = jnp.sum((X * w[None, :]) / safe[:, None], axis=0)
            if axis is not None:
                s = jax.lax.psum(s, axis)
            return s

        self._base = wrap(base_f, (rep, mat), dvec)
        self._metric = wrap(metric_f, (dvec, tr), rep)
        self._drop_one = wrap(drop_one_f, (dvec, rep, mat, rep, tr), rep)
        self._apply_drop = wrap(apply_drop_f, (dvec, rep, mat, rep), dvec)
        self._mask_metrics = wrap(mask_metrics_f, (dvec, rep, rep, mat, tr), rep)
        self._score_loss = wrap(score_loss_f, (dvec, rep, mat, tr), rep)

    def base(self, w):
        return self._base(jnp.asarray(w, jnp.float32), self.padded.features)

    def metric_of(self, scores) -> float:
        return float(self._metric(scores, self.padded))

    def metric_of_weights(self, w) -> float:
        return self.metric_of(self.base(w))

    def drop_one_metrics(self, base, w, start: int = 0) -> np.ndarray:
        """Metric after removing tree f, for f in [start, T) — [T - start]
        host array (a mutable copy: QUALITY_LOSS_ADV masks already-pruned
        entries).  Entry i corresponds to tree start + i."""
        return np.array(
            self._drop_one(
                base, jnp.asarray(w, jnp.float32), self.padded.features,
                jnp.arange(start, self.num_trees, dtype=jnp.int32),
                self.padded,
            )
        )

    def apply_drop(self, base, w, f: int):
        return self._apply_drop(
            base, jnp.asarray(w, jnp.float32), self.padded.features,
            jnp.int32(f),
        )

    def mask_metrics(self, base, w, masks) -> np.ndarray:
        """Metric after removing each row-mask's tree set — [B] host array."""
        return np.asarray(
            self._mask_metrics(
                base, jnp.asarray(w, jnp.float32),
                jnp.asarray(masks, jnp.float32), self.padded.features,
                self.padded,
            )
        )

    def score_loss_sums(self, base, w) -> np.ndarray:
        return np.asarray(
            self._score_loss(
                base, jnp.asarray(w, jnp.float32), self.padded.features,
                self.padded,
            )
        )


class Optimization:
    """Base optimizer interface (include/optimization/optimization.h:19-55)."""

    def is_pre_learning(self) -> bool:
        return False

    def need_partial_score_dataset(self) -> bool:
        return False

    def optimize(self, algo, train, valid, metric) -> dict:
        raise NotImplementedError


class Cleaver(Optimization):
    NAME = "CLEAVER"

    def __init__(
        self,
        pruning_method: str = "QUALITY_LOSS",
        pruning_rate: float = 0.5,
        line_search: Optional[LineSearch] = None,
        last_estimators_to_optimize: int = 0,
        seed: int = 0,
    ):
        method = pruning_method.upper()
        if method not in PRUNING_METHODS:
            raise ValueError(
                f"unknown pruning method {method!r}; known: {PRUNING_METHODS}"
            )
        self.pruning_method = method
        self.pruning_rate = float(pruning_rate)
        self.line_search = line_search
        self.last_estimators_to_optimize = int(last_estimators_to_optimize)
        self.seed = int(seed)
        self.weights_: Optional[np.ndarray] = None
        #: MetaCleaver takes control of applying weights (meta_cleaver.cc:163)
        self.update_model = True
        self.metric_on_training_: float = float("-inf")
        self.metric_on_validation_: float = float("-inf")

    def is_pre_learning(self) -> bool:
        return False  # post_learning_opt.h:34

    def need_partial_score_dataset(self) -> bool:
        return True  # cleaver.h:70

    def line_search_pre_pruning(self) -> bool:
        return self.pruning_method in _PRE_LS

    def update_weights(self, weights) -> None:
        self.weights_ = np.asarray(weights, np.float64).copy()

    # ------------------------------------------------------------------

    @staticmethod
    def _partial_dataset(algo, ds: Dataset) -> Dataset:
        """Per-tree score dataset: rows=docs, cols=trees (driver.cc:411-446)."""
        P = algo.partial_scores_dataset(ds).astype(np.float32)
        qids = np.repeat(ds.qids, ds.docs_per_query())
        return Dataset.from_arrays(P, ds.labels, qids, name=f"partial:{ds.name}")

    def optimize(
        self,
        algo,
        train,
        valid=None,
        metric=None,
        verbose=True,
        ptrain=None,
        pvalid=None,
        mesh=None,
    ) -> dict:
        """Prune + re-weight.  ``ptrain``/``pvalid`` optionally supply
        precomputed partial-score datasets (the driver's --train-partial /
        --valid-partial reuse path, driver.cc:270-298).  With ``mesh`` the
        partial matrix, every candidate rescoring, and the embedded line
        searches shard docs over the (1-D) mesh."""
        metric = metric or algo.default_metric()
        if ptrain is None:
            ptrain = self._partial_dataset(algo, train)
        if pvalid is None and valid is not None:
            pvalid = self._partial_dataset(algo, valid)
        T = ptrain.num_features
        ev = _PartialEval(metric, ptrain, mesh)
        ev_valid = (
            _PartialEval(metric, pvalid, mesh) if pvalid is not None else None
        )

        window = self.last_estimators_to_optimize or T
        opt_last_only = self.last_estimators_to_optimize > 0
        if self.pruning_rate < 1:
            to_prune = int(round(self.pruning_rate * window))
        else:
            to_prune = int(self.pruning_rate)
            if to_prune >= window:
                raise ValueError("pruning rate too high (cleaver.cc:188-193)")

        if self.weights_ is None:
            weights = np.asarray(algo.get_weights(), np.float64)
        else:
            if len(self.weights_) != T:
                raise ValueError("preset Cleaver weights size mismatch")
            weights = self.weights_.copy()
        starting_weights = weights.copy()

        m_before = ev.metric_of_weights(weights)
        info = {"metric_before": m_before, "num_trees_before": T}
        if verbose:
            print(f"# CLEAVER[{self.pruning_method}] trees={T} prune={to_prune}")
            print(f"# before: train {m_before:.4f}")

        # -- optional pre-pruning line search -------------------------------
        if self.line_search_pre_pruning() and to_prune > 0 and self.line_search:
            ls = self.line_search
            if opt_last_only:
                ls.train_only_last = window
            lw = None if ls.best_weights is None else np.asarray(
                ls.get_weights()
            )
            if lw is None or lw.size == 0:
                # no pre-learned weights (incl. an XML-loaded LS whose
                # <ensemble> was empty — best_weights is a size-0 array,
                # not None): run the line search fresh
                ls.update_weights(weights)
                ls.learn(ptrain, pvalid, metric, verbose=False, mesh=mesh)
                weights = ls.get_weights().copy()
            else:
                # Reuse pre-learned LS weights, rescaled to the algo's weight
                # magnitude (cleaver.cc:265-291; the reference exits on a
                # size mismatch, cleaver.cc:268-273).
                if lw.size != weights.size:
                    raise ValueError(
                        f"--line-search-model: {lw.size} weights but the "
                        f"ensemble has {weights.size} trees "
                        "(cleaver.cc:268-273 rejects the same mismatch)"
                    )
                scale = (np.mean(lw) / max(np.mean(starting_weights), 1e-12))
                weights = lw / max(scale, 1e-12)

        # -- strategy selection ---------------------------------------------
        pruned = self._pruning(weights, ev, window, to_prune)
        info["pruned"] = sorted(int(i) for i in pruned)

        # -- zero pruned, keep pre-LS values for survivors ------------------
        weights = starting_weights.copy()
        weights[list(pruned)] = 0.0

        # -- post-pruning line search on the filtered matrix ----------------
        if self.line_search is not None:
            keep = np.asarray(
                [f for f in range(T) if f not in pruned], dtype=np.int64
            )
            ls = self.line_search
            ls.update_weights(weights[keep])
            if opt_last_only:
                ls.train_only_last = window - to_prune
            ftrain = _filter_columns(ptrain, keep)
            fvalid = _filter_columns(pvalid, keep) if pvalid is not None else None
            ls.learn(ftrain, fvalid, metric, verbose=False, mesh=mesh)
            weights[keep] = ls.get_weights()

        # -- write back (drops zero-weight trees, ensemble.cc:149-192) ------
        if self.update_model:
            algo.update_weights(weights)
        self.weights_ = weights

        m_after = ev.metric_of_weights(weights)
        self.metric_on_training_ = m_after
        if pvalid is not None:
            self.metric_on_validation_ = ev_valid.metric_of_weights(weights)
            info["metric_after_valid"] = self.metric_on_validation_
        info["metric_after"] = m_after
        info["num_trees_after"] = int(np.sum(weights != 0))
        if verbose:
            print(
                f"# after: train {m_after:.4f} "
                f"({info['num_trees_after']} trees)"
            )
        return info

    # -- strategies ------------------------------------------------------

    def _pruning(self, weights, ev: _PartialEval, window, k) -> set:
        T = ev.num_trees
        start = T - window
        rng = np.random.default_rng(self.seed)
        method = self.pruning_method

        if method == "RANDOM":
            return set(start + rng.choice(window, size=k, replace=False))

        if method == "LAST":
            return set(range(T - k, T))

        if method == "SKIP":
            # keep every (window/(window-k))-th (skip_pruning.cc:47-59)
            select = window - k
            step = window / select
            kept = {int(np.ceil(step * i + start)) for i in range(select)}
            return {f for f in range(start, T) if f not in kept}

        if method == "LOW_WEIGHTS":
            idx = np.argsort(weights[start:T], kind="stable")[:k]
            return set(start + idx)

        base = ev.base(weights)

        if method == "QUALITY_LOSS":
            ms = ev.drop_one_metrics(base, weights, start)
            # prune the k whose removal leaves the HIGHEST metric
            idx = np.argsort(-ms, kind="stable")[:k]
            return set(start + idx)

        if method == "QUALITY_LOSS_ADV":
            # greedy: re-evaluate removal metrics after each pick with the
            # already-pruned trees' contribution folded into the base
            # (quality_loss_adv: same loop, one device pass per pick)
            pruned: set = set()
            for _ in range(k):
                ms = ev.drop_one_metrics(base, weights, start)
                for f in pruned:
                    ms[f - start] = -np.inf
                best = start + int(np.argmax(ms))
                pruned.add(best)
                base = ev.apply_drop(base, weights, best)
            return pruned

        if method == "SCORE_LOSS":
            # sum of score-normalized per-tree contribution, prune smallest
            # (score_loss_pruning.cc:58-77's literal formula)
            fs = ev.score_loss_sums(base, weights)[start:T]
            idx = np.argsort(fs, kind="stable")[:k]
            return set(start + idx)

        if method == "RANDOM_ADV":
            # best of 100 random prune sets by resulting metric
            sets = [
                start + rng.choice(window, size=k, replace=False)
                for _ in range(100)
            ]
            masks = np.zeros((100, T), np.float32)
            for i, s in enumerate(sets):
                masks[i, s] = 1.0
            ms = ev.mask_metrics(base, weights, masks)
            best = int(np.argmax(ms))
            return set(int(x) for x in sets[best])

        raise AssertionError(method)

    # -- optimizer-model XML (Cleaver::get_xml_model, cleaver.cc:111-150;
    #    Optimization::save/load, optimization.cc:36-80) -----------------

    def _to_xml(self):
        import xml.etree.ElementTree as ET

        from quickrank_tpu.io.xml_model import _fmt_f

        root = ET.Element("optimizer")
        info = ET.SubElement(root, "info")
        ET.SubElement(info, "opt-algo").text = self.NAME
        ET.SubElement(info, "opt-method").text = self.pruning_method
        ET.SubElement(info, "pruning-rate").text = str(self.pruning_rate)
        if self.line_search is not None:
            # embed the line-search hyperparams as <line-search> — the
            # reference grafts the LS model's <info> under that tag
            # (cleaver.cc:126-135)
            ls_info = self.line_search._to_xml().find("info")
            ls_info.tag = "line-search"
            root.append(ls_info)
        ens = ET.SubElement(root, "ensemble")
        if self.weights_ is not None:
            for i, w in enumerate(self.weights_):
                t = ET.SubElement(ens, "tree")
                ET.SubElement(t, "index").text = str(i + 1)
                ET.SubElement(t, "weight").text = _fmt_f(w)
        return root

    def save(self, path: str) -> None:
        import xml.etree.ElementTree as ET

        tree = ET.ElementTree(self._to_xml())
        ET.indent(tree, space="\t")
        with open(path, "wb") as f:
            tree.write(f)

    @classmethod
    def _from_xml(cls, root) -> "Cleaver":
        info = root.find("info")
        get = lambda tag, cast, default: (  # noqa: E731
            cast(info.find(tag).text)
            if info.find(tag) is not None and info.find(tag).text
            else default
        )
        ls = None
        ls_el = root.find("line-search")
        if ls_el is not None:
            g = lambda t, c, d: (  # noqa: E731
                c(ls_el.find(t).text) if ls_el.find(t) is not None else d
            )
            ls = LineSearch(
                num_points=g("num-samples", int, 21),
                window_size=g("window-size", float, 10.0),
                reduction_factor=g("reduction-factor", float, 0.95),
                max_iterations=g("max-iterations", int, 100),
                max_failed_vali=g("max-failed-vali", int, 20),
                adaptive=g(
                    "adaptive",
                    lambda s: s.strip().lower() in ("1", "true"),
                    False,
                ),
                train_only_last=g("train-only-last", int, 0),
            )
        out = cls(
            pruning_method=get("opt-method", str, "QUALITY_LOSS"),
            pruning_rate=get("pruning-rate", float, 0.5),
            line_search=ls,
        )
        # full model: per-tree weights under <ensemble> (cleaver.cc:88-107)
        trees = root.findall("ensemble/tree")
        if trees:
            size = max(int(t.find("index").text) for t in trees)
            w = np.zeros(size, np.float64)
            for t in trees:
                w[int(t.find("index").text) - 1] = float(t.find("weight").text)
            out.weights_ = w
        return out

    @staticmethod
    def load(path: str) -> "Cleaver":
        """Optimization::load_model_from_file (optimization.cc:50-80)."""
        import xml.etree.ElementTree as ET

        root = ET.parse(path).getroot()
        if root.tag != "optimizer":
            raise ValueError(f"{path}: not an optimizer model")
        name = root.find("info/opt-algo").text.strip()
        if name not in ("CLEAVER", "EPRUNING"):
            raise ValueError(f"unknown optimizer type {name!r}")
        return Cleaver._from_xml(root)

    def apply_weights(self, algo) -> None:
        """Re-apply a loaded optimizer's weights to a ranker without
        re-running the search (the testing path of a saved --opt-model)."""
        if self.weights_ is None:
            raise RuntimeError("Cleaver: no stored weights to apply")
        algo.update_weights(self.weights_)


def _filter_columns(ds: Dataset, keep: np.ndarray) -> Dataset:
    """Drop pruned columns (Cleaver::filter_dataset, cleaver.cc:448-481)."""
    from quickrank_tpu.data.dataset import select_columns

    return select_columns(ds, keep, name=f"filtered:{ds.name}")
