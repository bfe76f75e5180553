"""Random Forest — bagged regression trees on the raw labels.

Counterpart of ``RandomForest``
(src/learning/forests/randomforest.cc:35-52): identical to Mart except the
pseudoresponses are the labels on every iteration (no gradient feedback);
randomness comes from the ``subsample`` / ``max_features`` bagging knobs.
"""

from __future__ import annotations

import jax.numpy as jnp

from quickrank_tpu.learning.mart import Mart, StepData


class RandomForest(Mart):
    NAME = "RANDOMFOREST"

    def _gradients(self, sd: StepData, scores, sample_mask, key, **_unused):
        return sd.labels.astype(jnp.float32), None
