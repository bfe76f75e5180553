"""Stochastic negative sampling LambdaMART.

Counterpart of ``StochasticNegative``
(src/learning/forests/stochasticnegative.cc:285-330): every iteration, each
query keeps ALL its positive (label > 0) docs plus a ``subsample`` fraction
(count if > 1) of its negatives drawn uniformly; lambdas are computed only
among the kept docs (query "cleaning", inherited from LambdaMart).

The per-query sort+shuffle of the reference becomes a batched random-key
ranking over the padded [Q, D] view.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from quickrank_tpu.data.dataset import gather_padded, scatter_flat
from quickrank_tpu.learning.lambdamart import LambdaMart
from quickrank_tpu.learning.mart import TrainData


@partial(jax.jit, static_argnames=("num_docs_padded", "frac"))
def _sample_presence(key, idx, flat_labels, slot_mask, num_docs_padded, frac):
    """Keep-mask: all positives + a ``frac`` of negatives per query.

    Data tensors are jit ARGUMENTS (the learning-package rule: a closure
    over the padded arrays would constant-fold multi-MB tensors into the
    sampler executable — mart.py's StepData commentary)."""
    labels = gather_padded(flat_labels, idx, slot_mask)
    pos = (labels > 0) & slot_mask
    neg = (labels <= 0) & slot_mask
    r = jax.random.uniform(key, labels.shape)
    keyed = jnp.where(neg, r, jnp.inf)
    # rank of each negative inside its query (by random key)
    order = jnp.argsort(keyed, axis=-1)
    rank = jnp.argsort(order, axis=-1)
    nneg = jnp.sum(neg, axis=-1, keepdims=True)
    if frac > 1.0:
        k = jnp.minimum(jnp.asarray(int(frac)), nneg)
    else:
        k = jnp.floor(frac * nneg).astype(jnp.int32)
    keep = pos | (neg & (rank < k))
    return scatter_flat(
        keep.astype(jnp.float32), idx, slot_mask, num_docs_padded
    ) > 0.5


class StochasticNegative(LambdaMart):
    NAME = "STOCHASTIC-NEGATIVE"

    def __init__(self, *args, subsample: float = 0.5, **kw):
        super().__init__(*args, subsample=1.0, **kw)
        # Reference reuses the subsample flag as the negative fraction; the
        # base-class uniform subsampling is disabled in favor of this.
        self.negative_fraction = float(subsample)
        self._sampler = None

    def _info_dict(self) -> dict:
        d = super()._info_dict()
        # the base class would serialize self.subsample (forced to 1.0),
        # silently dropping the negative fraction on save/--restart-train;
        # the reference stores it under the same reused flag
        d["subsample"] = self.negative_fraction
        return d

    def _post_init(self, tr: TrainData) -> None:
        padded = tr.padded
        self._sampler = lambda key: _sample_presence(
            key, padded.pad_index_global, padded.labels, padded.slot_mask,
            padded.num_docs_padded, self.negative_fraction,
        )

    def _update_presence(self, m, tr, scores_tr, key):
        if self.negative_fraction == 1.0:
            return None
        return self._sampler(jax.random.fold_in(key, 977))
