"""Abstract learning-to-rank algorithm interface.

Counterpart of ``LTR_Algorithm``
(include/learning/ltr_algorithm.h:33): ``learn`` / ``score_dataset`` /
``partial_scores_dataset`` / ensemble weight get/update / save/load.  Unlike
the reference's per-doc virtual ``score_document``, scoring is always a
batched dataset-level operation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from quickrank_tpu.data.dataset import Dataset
from quickrank_tpu.metrics.metrics import Metric, Ndcg


class LTRAlgorithm:
    NAME = "ABSTRACT"

    def learn(
        self,
        train: Dataset,
        valid: Optional[Dataset] = None,
        metric: Optional[Metric] = None,
        verbose: bool = True,
    ) -> dict:
        """Train; returns an info dict with per-iteration metric history."""
        raise NotImplementedError

    def score_dataset(self, ds: Dataset) -> np.ndarray:
        """f64-ish scores per doc in dataset order (ltr_algorithm.cc:44-52)."""
        raise NotImplementedError

    def partial_scores_dataset(self, ds: Dataset) -> np.ndarray:
        """[num_docs, num_trees] unweighted per-tree scores
        (partial_scores_document, ltr_algorithm.h + driver.cc:411-446)."""
        raise NotImplementedError

    # -- ensemble weight interface (used by Cleaver, ltr_algorithm.h) -------
    def get_weights(self) -> np.ndarray:
        raise NotImplementedError

    def update_weights(self, weights: np.ndarray) -> None:
        """Overwrite per-tree weights; zero-weight trees are filtered out
        (Ensemble::update_ensemble_weights, ensemble.cc:149-192)."""
        raise NotImplementedError

    def import_model_state(self, other: "LTRAlgorithm") -> None:
        """Move ``other``'s trained state into this fresh learner for a
        --restart-train resume (``LTR_Algorithm::import_model_state``).  The
        base refuses, like the reference's default-false virtual; compatible
        families override (Mart checks hyperparameters, mart.cc:493-517)."""
        raise ValueError(
            f"restart-train: {self.NAME} cannot import model state from "
            f"{other.NAME}"
        )

    def evaluate(self, ds: Dataset, metric: Metric) -> float:
        from quickrank_tpu.data.dataset import pack_doc_values, shard_and_pad

        padded = shard_and_pad(ds)
        scores = pack_doc_values(padded, self.score_dataset(ds))
        return float(metric.evaluate_dataset(padded, scores))

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> None:
        from quickrank_tpu.io import xml_model

        xml_model.save_model(self, path)

    @staticmethod
    def load(path: str) -> "LTRAlgorithm":
        from quickrank_tpu.io import xml_model

        return xml_model.load_model(path)

    @staticmethod
    def default_metric() -> Metric:
        return Ndcg(10)
