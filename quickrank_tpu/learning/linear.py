"""Linear rankers: CoordinateAscent and LineSearch.

Re-designs of ``CoordinateAscent``
(src/learning/linear/coordinate_ascent.cc:116-248) and ``LineSearch``
(src/learning/linear/line_search.cc:153-419).  Both search weight vectors for
the linear model ``score = w . x`` by evaluating a grid of candidate weights;
the reference parallelizes candidate evaluation with OpenMP — here the whole
per-feature sweep is one jitted ``fori_loop`` and every candidate-grid metric
evaluation is a single batched [P, N] pass (vmap over candidates), which is
exactly the shape SURVEY.md §7.6 calls "perfect for vmap".

Semantics preserved:
  * CA: cyclic per-feature window search, candidates < 0 discarded, accept
    only strict improvement, L1-renormalize after each accepted update
    (coordinate_ascent.cc:166-199), shrinking window per epoch;
  * LS: step 1 independent per-feature search from ``weights_prev`` vs the
    *global* best metric; step 2 joint search along ``weights - weights_prev``
    (line_search.cc:249-344), optional adaptive reduction factor (:349-358),
    ``train_only_last`` restriction (:236-238), reusable weight import/export
    for Cleaver;
  * both: early stop after ``max_failed_vali`` non-improving validation
    epochs, best weights tracked on validation.

Multi-chip: pass ``mesh`` (1-D data mesh) to :meth:`learn` — docs/queries
shard over the mesh under ``shard_map`` and every candidate metric is a
(num, den) ``psum``, the cross-chip analog of the OpenMP-reduced candidate
loops (line_search.cc:264-279, coordinate_ascent.cc:149-165).  Weights stay
replicated because every device sees identical psum'd metrics.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from quickrank_tpu.data.dataset import (
    Dataset,
    PaddedDataset,
    gather_padded,
    shard_and_pad,
)
from quickrank_tpu.learning.base import LTRAlgorithm
from quickrank_tpu.metrics.metrics import Metric

NEG_INF = float("-inf")


def eval_padded_local(metric: Metric, padded: PaddedDataset, scores, axis=None):
    """Metric over a (possibly shard-local) padded block using the
    SHARD-LOCAL ``pad_index``; with ``axis`` the (num, den) aggregation is
    psum'd across the mesh (metric.h:77-106's mean, distributed)."""
    s = gather_padded(scores, padded.pad_index, padded.slot_mask)
    l = gather_padded(padded.labels, padded.pad_index, padded.slot_mask)
    pq = metric.evaluate_per_query(s, l, padded.slot_mask, padded.nvalid)
    num, den = metric.aggregate(pq, padded.query_mask, jnp.sum(padded.doc_mask))
    if axis is not None:
        num = jax.lax.psum(num, axis)
        den = jax.lax.psum(den, axis)
    return metric.finalize(num, den)


def padded_specs(padded: PaddedDataset, axis: str):
    """PartitionSpec pytree for a PaddedDataset: every doc/query-axis array
    sharded on ``axis`` (the shard blocks built by shard_and_pad)."""
    return padded.replace(
        features=P(axis, None),
        labels=P(axis),
        doc_mask=P(axis),
        pad_index=P(axis, None),
        slot_mask=P(axis, None),
        query_mask=P(axis),
        nvalid=P(axis),
        orig_index=P(axis),
        inv_q=P(axis),
        inv_slot=P(axis),
    )


def shard_padded(padded: PaddedDataset, mesh, axis: str) -> PaddedDataset:
    specs = padded_specs(padded, axis)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), padded, specs
    )


def matmul_highest(X, w):
    """``X @ w`` at full float32 precision: a default f32 matrix product
    may run in TF32 on the GPU (about three decimal digits), and the
    linear rankers' scores, and so their metric-driven weight search, must
    match the CPU's."""
    return jnp.matmul(X, w, precision=jax.lax.Precision.HIGHEST)


def _shard_map(f, mesh, in_specs, out_specs):
    from quickrank_tpu.learning.mart import shard_map

    return shard_map(f, mesh, in_specs=in_specs, out_specs=out_specs)


class _LinearRanker(LTRAlgorithm):
    def __init__(
        self,
        num_points: int = 21,
        window_size: float = 10.0,
        reduction_factor: float = 0.95,
        max_iterations: int = 100,
        max_failed_vali: int = 20,
    ):
        """Defaults mirror quicklearn's CA/LS group (src/quicklearn.cc:136-141)."""
        if int(num_points) < 2:
            # shared guard for BOTH linear rankers: CA divides its step by
            # num_points and LineSearch by the evened count — a 0/1-point
            # grid yields inf/NaN candidates inside jit (silent garbage
            # argmax), and a 1-point "search" is meaningless anyway
            raise ValueError(
                f"num_points={num_points} too small — at least 2 grid "
                "points are required (reference default 21)"
            )
        self.num_points = int(num_points)
        self.window_size = float(window_size)
        self.reduction_factor = float(reduction_factor)
        self.max_iterations = int(max_iterations)
        self.max_failed_vali = int(max_failed_vali)
        self.best_weights: Optional[np.ndarray] = None
        self.history: dict = {}

    def score_dataset(self, ds: Dataset) -> np.ndarray:
        if self.best_weights is None:
            raise RuntimeError(f"{self.NAME}: no trained model")
        return ds.features @ self.best_weights.astype(np.float64)

    def get_weights(self) -> np.ndarray:
        return np.asarray(self.best_weights)

    def update_weights(self, weights: np.ndarray) -> None:
        """Import a weight vector (LS: also changes dimensionality —
        line_search.cc:429-443)."""
        self.best_weights = np.asarray(weights, np.float64).copy()

    def reset_weights(self) -> None:
        self.best_weights = None

    def import_model_state(self, other) -> None:
        """Adopt a loaded linear model's weight vector for a resume (the
        same import path Cleaver uses, line_search.cc:429-443)."""
        if not isinstance(other, _LinearRanker) or getattr(
            other, "best_weights", None
        ) is None:
            raise ValueError(
                f"restart-train: {self.NAME} cannot import model state from "
                f"{other.NAME}"
            )
        self.best_weights = np.asarray(other.best_weights, np.float64).copy()

    @staticmethod
    def _prepare(ds: Dataset, mesh=None, axis=None):
        num_shards = int(mesh.shape[axis]) if mesh is not None else 1
        padded = shard_and_pad(ds, num_shards=num_shards)
        if mesh is not None:
            padded = shard_padded(padded, mesh, axis)
        X = padded.features  # padded rows are zero -> contribute nothing
        return padded, X

    @staticmethod
    def _metric_batch(metric: Metric, padded, scores_batch, axis=None):
        return jax.vmap(
            lambda s: eval_padded_local(metric, padded, s, axis)
        )(scores_batch)

    @staticmethod
    def _mesh_axis(mesh):
        if mesh is None:
            return None
        if len(mesh.axis_names) > 1:
            raise NotImplementedError(
                "linear rankers support 1-D (data) meshes only"
            )
        return mesh.axis_names[0]


class CoordinateAscent(_LinearRanker):
    NAME = "COORDASC"

    def learn(self, train, valid=None, metric=None, verbose=True, mesh=None):
        metric = metric or self.default_metric()
        axis = self._mesh_axis(mesh)
        padded, X = self._prepare(train, mesh, axis)
        F = train.num_features
        P_ = self.num_points
        if valid is not None:
            vpadded, Xv = self._prepare(valid, mesh, axis)

        # window is normalized by the feature count (coordinate_ascent.cc:123)
        window0 = self.window_size / F

        # X/padded are jit ARGUMENTS (closure constants would be
        # constant-folded at compile time — very slow for big matrices)
        def epoch_body(w, window, X, padded):
            step = 2.0 * window / P_

            def fstep(i, w):
                col = jax.lax.dynamic_index_in_dim(X, i, 1, keepdims=False)
                full = matmul_highest(X, w)
                wi = w[i]
                presum = full - wi * col
                current = eval_padded_local(metric, padded, full, axis)
                pts = wi - window + step * jnp.arange(P_ + 1, dtype=jnp.float32)
                valid_pts = pts >= 0
                cands = presum[None, :] + pts[:, None] * col[None, :]
                ms = self._metric_batch(metric, padded, cands, axis)
                ms = jnp.where(valid_pts, ms, NEG_INF)
                b = jnp.argmax(ms)
                better = ms[b] > current
                w2 = w.at[i].set(jnp.where(better, pts[b], wi))
                w2 = jnp.where(better, w2 / jnp.sum(w2), w2)
                return w2

            w = jax.lax.fori_loop(0, F, fstep, w)
            return w, eval_padded_local(metric, padded, matmul_highest(X, w), axis)

        def valid_body(w, Xv, vpadded):
            return eval_padded_local(metric, vpadded, matmul_highest(Xv, w), axis)

        if mesh is None:
            epoch = jax.jit(epoch_body)
            valid_metric = jax.jit(valid_body)
        else:
            rep = P()
            epoch = jax.jit(
                _shard_map(
                    epoch_body, mesh,
                    in_specs=(rep, rep, P(axis, None), padded_specs(padded, axis)),
                    out_specs=(rep, rep),
                )
            )
            if valid is not None:
                valid_metric = jax.jit(
                    _shard_map(
                        valid_body, mesh,
                        in_specs=(rep, P(axis, None), padded_specs(vpadded, axis)),
                        out_specs=rep,
                    )
                )

        w = jnp.full((F,), 1.0 / F, jnp.float32)
        best_w = np.asarray(w)
        best_va, fails = -np.inf, 0
        window = window0
        hist_tr, hist_va = [], []
        if verbose:
            print(f"# {self.NAME}: window={self.window_size} pts={P_}")
            print("# iter. training validation")
        for b in range(self.max_iterations):
            w, m_tr = epoch(w, jnp.float32(window), X, padded)
            m_tr = float(m_tr)
            hist_tr.append(m_tr)
            if valid is not None:
                m_va = float(valid_metric(w, Xv, vpadded))
                hist_va.append(m_va)
                improved = m_va > best_va
                if improved:
                    best_va, fails = m_va, 0
                    best_w = np.asarray(w)
                else:
                    fails += 1
                if verbose:
                    print(
                        f"# {b + 1:5d} {m_tr:.6f} {m_va:.6f}"
                        f"{' *' if improved else ''}"
                    )
                if fails >= self.max_failed_vali:
                    break
            elif verbose:
                print(f"# {b + 1:5d} {m_tr:.6f}")
            window *= self.reduction_factor
        if valid is None:
            best_w = np.asarray(w)
        self.best_weights = best_w.astype(np.float64)
        self.history = {"train": hist_tr, "valid": hist_va}
        return self.history

    # -- XML (coordinate_ascent.cc:270-302) ---------------------------------

    def _to_xml(self):
        import xml.etree.ElementTree as ET

        root = ET.Element("ranker")
        info = ET.SubElement(root, "info")
        ET.SubElement(info, "type").text = self.NAME
        ET.SubElement(info, "num-samples").text = str(self.num_points)
        ET.SubElement(info, "window-size").text = str(self.window_size)
        ET.SubElement(info, "reduction-factor").text = str(self.reduction_factor)
        ET.SubElement(info, "max-iterations").text = str(self.max_iterations)
        ET.SubElement(info, "max-failed-vali").text = str(self.max_failed_vali)
        model = ET.SubElement(root, "model")
        for i, wv in enumerate(self.best_weights):
            f = ET.SubElement(model, "feature")
            f.set("id", str(i + 1))
            f.set("weight", repr(float(wv)))
        return root

    @classmethod
    def _from_xml(cls, root):
        info = root.find("info")
        g = lambda t, c, d: (  # noqa: E731
            c(info.find(t).text) if info.find(t) is not None else d
        )
        algo = cls(
            num_points=g("num-samples", int, 21),
            window_size=g("window-size", float, 10.0),
            reduction_factor=g("reduction-factor", float, 0.95),
            max_iterations=g("max-iterations", int, 100),
            max_failed_vali=g("max-failed-vali", int, 20),
        )
        feats = root.findall("model/feature")
        w = np.zeros(len(feats), np.float64)
        for f in feats:
            w[int(f.get("id")) - 1] = float(f.get("weight"))
        algo.best_weights = w
        return algo


class LineSearch(_LinearRanker):
    NAME = "LINESEARCH"

    def __init__(
        self,
        num_points: int = 21,
        window_size: float = 10.0,
        reduction_factor: float = 0.95,
        max_iterations: int = 100,
        max_failed_vali: int = 20,
        adaptive: bool = False,
        train_only_last: int = 0,
    ):
        super().__init__(
            num_points, window_size, reduction_factor, max_iterations,
            max_failed_vali,
        )
        self.adaptive = bool(adaptive)
        self.train_only_last = int(train_only_last)

    def learn(self, train, valid=None, metric=None, verbose=True, mesh=None):
        metric = metric or self.default_metric()
        axis = self._mesh_axis(mesh)
        padded, X = self._prepare(train, mesh, axis)
        F = train.num_features
        # Force an even point count so the center is on the grid
        # (line_search.cc:162-165); >= 2 by the shared __init__ guard.
        P_ = self.num_points - (self.num_points % 2)
        if valid is not None:
            vpadded, Xv = self._prepare(valid, mesh, axis)

        if self.best_weights is not None and len(self.best_weights) != F:
            raise ValueError(
                f"LineSearch: imported weights size {len(self.best_weights)} "
                f"!= num_features {F} (line_search.cc:187-193)"
            )
        w0 = (
            np.ones(F) if self.best_weights is None else self.best_weights
        ).astype(np.float32)
        start_idx = max(0, F - self.train_only_last) if self.train_only_last else 0

        def iteration_body(w, w_prev, best_m, window, X, padded):
            step1 = 2.0 * window / P_
            full_prev = matmul_highest(X, w_prev)

            def fstep(f, w):
                col = jax.lax.dynamic_index_in_dim(X, f, 1, keepdims=False)
                presum = full_prev - w_prev[f] * col
                pts = w_prev[f] - window + step1 * jnp.arange(
                    P_ + 1, dtype=jnp.float32
                )
                valid_pts = pts >= 0
                cands = presum[None, :] + pts[:, None] * col[None, :]
                ms = self._metric_batch(metric, padded, cands, axis)
                ms = jnp.where(valid_pts, ms, NEG_INF)
                b = jnp.argmax(ms)
                return w.at[f].set(jnp.where(ms[b] > best_m, pts[b], w[f]))

            w = jax.lax.fori_loop(start_idx, F, fstep, w)

            # Step 2: joint search along (w - w_prev) in P+1 points.
            dstep = (w - w_prev) / P_
            zeros = jnp.all(dstep == 0)
            base = full_prev
            dscore = matmul_highest(X, dstep)
            pidx = jnp.arange(P_ + 1, dtype=jnp.float32)
            cands = base[None, :] + pidx[:, None] * dscore[None, :]
            ms2 = self._metric_batch(metric, padded, cands, axis)
            b2 = jnp.argmax(ms2)
            better = (~zeros) & (ms2[b2] > best_m)
            w_new = jnp.where(better, w_prev + dstep * pidx[b2], w)
            w_prev_new = jnp.where(better, w_new, w_prev)
            gain = jnp.where(better, ms2[b2] - best_m, 0.0)
            best_new = jnp.where(better, ms2[b2], best_m)
            return w_new, w_prev_new, best_new, gain

        def train_body(w, X, padded):
            return eval_padded_local(metric, padded, matmul_highest(X, w), axis)

        def valid_body(w, Xv, vpadded):
            return eval_padded_local(metric, vpadded, matmul_highest(Xv, w), axis)

        if mesh is None:
            iteration = jax.jit(iteration_body)
            train_metric = jax.jit(train_body)
            valid_metric = jax.jit(valid_body)
        else:
            rep = P()
            tr_specs = padded_specs(padded, axis)
            iteration = jax.jit(
                _shard_map(
                    iteration_body, mesh,
                    in_specs=(rep, rep, rep, rep, P(axis, None), tr_specs),
                    out_specs=(rep, rep, rep, rep),
                )
            )
            train_metric = jax.jit(
                _shard_map(
                    train_body, mesh,
                    in_specs=(rep, P(axis, None), tr_specs),
                    out_specs=rep,
                )
            )
            if valid is not None:
                valid_metric = jax.jit(
                    _shard_map(
                        valid_body, mesh,
                        in_specs=(rep, P(axis, None), padded_specs(vpadded, axis)),
                        out_specs=rep,
                    )
                )

        w = jnp.asarray(w0)
        w_prev = jnp.asarray(w0)
        best_m = float(train_metric(w, X, padded))
        best_w = np.asarray(w, np.float64)
        best_va = float(valid_metric(w, Xv, vpadded)) if valid is not None else -np.inf
        # window = mean weight * window factor (line_search.cc:232-236)
        window_start = float(np.mean(w0)) * self.window_size
        window = window_start
        fails = 0
        hist_tr, hist_va = [], []
        if verbose:
            print(f"# {self.NAME}: window={self.window_size} pts={P_}")
            print("# iter. training validation gain window")
        for it in range(self.max_iterations):
            w, w_prev, best_m_j, gain = iteration(
                w, w_prev, jnp.float32(best_m), jnp.float32(window), X, padded
            )
            best_m = float(best_m_j)
            gain = float(gain)
            hist_tr.append(best_m)
            red = self.reduction_factor
            if self.adaptive:
                # metric-relative speed-up/slow-down (line_search.cc:349-358)
                max_gain = 0.005
                rel = min((gain - max_gain) / max_gain, 1.0)
                red = 1.0 + max(rel, -0.5)
            if valid is not None:
                m_va = float(valid_metric(w, Xv, vpadded))
                hist_va.append(m_va)
                improved = m_va > best_va
                if improved:
                    best_va, fails = m_va, 0
                    best_w = np.asarray(w, np.float64)
                else:
                    fails += 1
                if verbose:
                    print(
                        f"# {it + 1:5d} {best_m:.6f} {m_va:.6f} {gain:.6f} "
                        f"{window:.5f}{' *' if improved else ''}"
                    )
                if fails >= self.max_failed_vali:
                    break
            elif verbose:
                print(f"# {it + 1:5d} {best_m:.6f} {gain:.6f} {window:.5f}")
            window *= red
            if self.adaptive and window < window_start / 10:
                break
        if valid is None:
            best_w = np.asarray(w, np.float64)
        self.best_weights = best_w
        self.history = {"train": hist_tr, "valid": hist_va}
        return self.history

    # -- XML (line_search.cc:102-132) ---------------------------------------

    def _to_xml(self):
        import xml.etree.ElementTree as ET

        root = ET.Element("ranker")
        info = ET.SubElement(root, "info")
        ET.SubElement(info, "type").text = self.NAME
        ET.SubElement(info, "num-samples").text = str(self.num_points)
        ET.SubElement(info, "window-size").text = str(self.window_size)
        ET.SubElement(info, "reduction-factor").text = str(self.reduction_factor)
        ET.SubElement(info, "max-iterations").text = str(self.max_iterations)
        ET.SubElement(info, "max-failed-vali").text = str(self.max_failed_vali)
        ET.SubElement(info, "adaptive").text = str(self.adaptive).lower()
        ET.SubElement(info, "train-only-last").text = str(self.train_only_last)
        ens = ET.SubElement(root, "ensemble")
        for i, wv in enumerate(self.best_weights):
            t = ET.SubElement(ens, "tree")
            ET.SubElement(t, "index").text = str(i + 1)
            ET.SubElement(t, "weight").text = repr(float(wv))
        return root

    @classmethod
    def _from_xml(cls, root):
        info = root.find("info")
        g = lambda t, c, d: (  # noqa: E731
            c(info.find(t).text) if info.find(t) is not None else d
        )
        algo = cls(
            num_points=g("num-samples", int, 21),
            window_size=g("window-size", float, 10.0),
            reduction_factor=g("reduction-factor", float, 0.95),
            max_iterations=g("max-iterations", int, 100),
            max_failed_vali=g("max-failed-vali", int, 20),
            adaptive=g("adaptive", lambda s: s.strip().lower() in ("1", "true"), False),
            train_only_last=g("train-only-last", int, 0),
        )
        trees = root.findall("ensemble/tree")
        w = np.zeros(len(trees), np.float64)
        for t in trees:
            w[int(t.find("index").text) - 1] = float(t.find("weight").text)
        algo.best_weights = w
        return algo
