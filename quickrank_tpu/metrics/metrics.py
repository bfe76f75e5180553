"""Metric classes and factory.

Counterpart of ``include/metric/ir/*`` + ``metric_factory.h:20-37``.
Each metric wraps the batched kernels in :mod:`quickrank_tpu.metrics.core`:

  * ``evaluate_per_query(scores, labels, slot_mask, nvalid) -> [Q]``
  * ``evaluate_dataset(padded, scores_flat) -> float``  (mean over queries,
    metric.h:77-106; RMSE overrides with the instance-level aggregate)
  * ``delta_matrix(...) -> [Q, D, D]`` rank-space swap deltas (the
    "jacobian", used by the lambda kernel)

All per-query computation is batched; dataset aggregation returns (sum,
count) pairs inside sharded code so the mean can be ``psum``-reduced.
"""

from __future__ import annotations

import jax.numpy as jnp

from quickrank_tpu.data.dataset import PaddedDataset, gather_padded
from quickrank_tpu.metrics import core
from quickrank_tpu.types import NO_CUTOFF


class Metric:
    """Base IR metric with cutoff (include/metric/ir/metric.h:43)."""

    NAME = "METRIC"
    #: larger is better for every metric (RMSE is negated to comply)
    HIGHER_IS_BETTER = True

    def __init__(self, cutoff: int = NO_CUTOFF):
        self.cutoff = int(cutoff) if cutoff and cutoff > 0 else NO_CUTOFF

    # -- per-query ---------------------------------------------------------
    def evaluate_per_query(self, scores, labels, slot_mask, nvalid):
        raise NotImplementedError

    # -- rank-space swap deltas -------------------------------------------
    def delta_matrix(self, sorted_scores, sorted_labels, sm, nvalid):
        """Signed metric change when ranks (i, j) swap. Default: none (rank
        insensitive)."""
        D = sorted_labels.shape[-1]
        return jnp.zeros(sorted_labels.shape[:-1] + (D, D), dtype=jnp.float32)

    # -- dataset aggregation ------------------------------------------------
    def aggregate(self, per_query, query_mask, num_docs_valid=None):
        """(numerator, denominator) so that metric = num/den after any
        cross-shard psum."""
        s = jnp.sum(jnp.where(query_mask, per_query, 0.0))
        c = jnp.sum(query_mask.astype(jnp.float32))
        return s, c

    def finalize(self, num, den):
        return jnp.where(den > 0, num / jnp.maximum(den, 1.0), 0.0)

    def evaluate_padded(self, padded: PaddedDataset, scores_flat):
        """Jittable dataset-level metric (mean over queries, metric.h:77-106)
        as a jnp scalar."""
        idx = padded.pad_index_global
        scores = gather_padded(scores_flat, idx, padded.slot_mask)
        labels = gather_padded(padded.labels, idx, padded.slot_mask)
        pq = self.evaluate_per_query(scores, labels, padded.slot_mask, padded.nvalid)
        num, den = self.aggregate(pq, padded.query_mask, padded.doc_mask.sum())
        return self.finalize(num, den)

    def evaluate_dataset(self, padded: PaddedDataset, scores_flat) -> float:
        return float(self.evaluate_padded(padded, scores_flat))

    def __repr__(self):
        if self.cutoff != NO_CUTOFF:
            return f"{self.NAME}@{self.cutoff}"
        return self.NAME


class Dcg(Metric):
    NAME = "DCG"

    def evaluate_per_query(self, scores, labels, slot_mask, nvalid):
        return core.dcg(scores, labels, slot_mask, nvalid, self.cutoff)

    def delta_matrix(self, sorted_scores, sorted_labels, sm, nvalid):
        return core.ndcg_delta_matrix(
            sorted_labels, sm, nvalid, self.cutoff, normalize=False
        )


class Ndcg(Dcg):
    NAME = "NDCG"

    def evaluate_per_query(self, scores, labels, slot_mask, nvalid):
        return core.ndcg(scores, labels, slot_mask, nvalid, self.cutoff)

    def delta_matrix(self, sorted_scores, sorted_labels, sm, nvalid):
        return core.ndcg_delta_matrix(
            sorted_labels, sm, nvalid, self.cutoff, normalize=True
        )


class Tndcg(Ndcg):
    NAME = "TNDCG"

    def evaluate_per_query(self, scores, labels, slot_mask, nvalid):
        return core.tndcg(scores, labels, slot_mask, nvalid, self.cutoff)

    def delta_matrix(self, sorted_scores, sorted_labels, sm, nvalid):
        return core.tndcg_delta_matrix(
            sorted_labels, sorted_scores, sm, nvalid, self.cutoff
        )


class Map(Metric):
    NAME = "MAP"

    def evaluate_per_query(self, scores, labels, slot_mask, nvalid):
        return core.average_precision(scores, labels, slot_mask, nvalid, self.cutoff)

    def delta_matrix(self, sorted_scores, sorted_labels, sm, nvalid):
        return core.map_delta_matrix(sorted_labels, sm, nvalid, self.cutoff)


class Rmse(Metric):
    """Negated RMSE over instances — rank-insensitive (rmse.cc:24-70)."""

    NAME = "RMSE"

    def evaluate_per_query(self, scores, labels, slot_mask, nvalid):
        return core.rmse_sse(scores, labels, slot_mask, nvalid, self.cutoff)

    def aggregate(self, per_query, query_mask, num_docs_valid=None):
        s = jnp.sum(jnp.where(query_mask, per_query, 0.0))
        return s, num_docs_valid.astype(jnp.float32)

    def finalize(self, num, den):
        return -jnp.sqrt(num / jnp.maximum(den, 1.0))


_METRICS = {m.NAME: m for m in (Dcg, Ndcg, Tndcg, Map, Rmse)}


def metric_factory(name: str, cutoff: int = NO_CUTOFF) -> Metric:
    """Uppercased-name lookup (include/metric/metric_factory.h:20-37).

    Accepts both ("NDCG", 10) and the combined "NDCG@10" spelling."""
    name = name.upper().strip()
    if "@" in name:
        name, _, k = name.partition("@")
        cutoff = int(k)
    if name not in _METRICS:
        raise ValueError(f"unknown metric {name!r}; known: {sorted(_METRICS)}")
    return _METRICS[name](cutoff)
