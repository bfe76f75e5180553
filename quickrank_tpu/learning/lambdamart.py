"""LambdaMART — listwise boosting with metric-derived lambda gradients.

Re-design of ``LambdaMart`` (src/learning/forests/lambdamart.cc):
extends :class:`Mart`, replacing the pointwise pseudoresponses by the batched
pairwise lambda kernel (ops/lambdas.py) and switching leaf outputs to the
Newton step sum(lambda)/sum(w) (lambdamart.cc:47-60 -> rt.cc:186-207).

Subsampling follows the reference's query "cleaning" (lambdamart.cc:85-108):
lambdas are computed only among the sampled docs of each query, not merely
masked post-hoc — the pair set itself shrinks.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from quickrank_tpu.data.dataset import gather_padded, gather_unpad
from quickrank_tpu.learning.mart import Mart, StepData
from quickrank_tpu.ops.lambdas import lambda_gradients


class LambdaMart(Mart):
    NAME = "LAMBDAMART"
    _newton = True

    def __init__(self, *args, query_chunk: Optional[int] = None, **kw):
        """``query_chunk`` bounds the live [chunk, D, D] pair tensor in the
        lambda kernel (memory control for long result lists)."""
        super().__init__(*args, **kw)
        self.query_chunk = query_chunk

    def _gradients(self, sd: StepData, scores, sample_mask, key,
                   scores2d=None, full_mask=False):
        # pad_index is shard-local, so the whole lambda computation is
        # chip-local — per-query work never crosses shards (the SPMD analog
        # of the per-query OpenMP loop, lambdamart.cc:70).
        # ``scores2d``/``full_mask`` keep the expensive flat->view gathers
        # off the hot path: the step carries the score view across
        # iterations, labels are pre-viewed in StepData, and when no doc
        # subsampling/deselection is active the sample mask IS doc_mask, so
        # its view is just slot_mask.
        idx = sd.pad_index
        s = (
            scores2d
            if scores2d is not None
            else gather_padded(scores, idx, sd.slot_mask)
        )
        if full_mask:
            slot_mask, nvalid = sd.slot_mask, sd.nvalid
        else:
            present = gather_padded(sample_mask, idx, sd.slot_mask, fill=False)
            slot_mask = sd.slot_mask & present
            nvalid = jnp.sum(slot_mask, axis=-1).astype(jnp.int32)
        lam, w = lambda_gradients(
            s, sd.labels2d, slot_mask, nvalid, self._train_metric,
            self.query_chunk,
        )
        # one stacked view->flat gather instead of two
        lw = gather_unpad(
            jnp.stack([lam, w], axis=-1), sd.inv_q, sd.inv_slot, sd.doc_mask
        )
        return lw[..., 0], lw[..., 1]

    def _make_step(self, tr, va, metric, mesh, block_k=1):
        # The lambda kernel needs the training metric's delta matrix
        # (lambdamart.cc:110 uses the *training* scorer's jacobian).
        self._train_metric = metric
        return super()._make_step(tr, va, metric, mesh, block_k=block_k)
