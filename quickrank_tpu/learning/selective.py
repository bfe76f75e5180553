"""Selective Gradient Boosting (SIGIR'18) — LambdaMART with periodic
rank-aware negative sampling.

Counterpart of ``LambdaMartSelective``
(src/learning/forests/lambdamartselective.cc): every ``sampling_iterations``
boosting rounds, each query keeps ALL positives plus (a) its top-scored
negatives and (b) random extra negatives; the counts follow the
``negative_strategy``:

  * RATIO: round(factor * #negatives)                 (lms.cc:119-121)
  * MUL:   round(factor * #positives), capped         (lms.cc:123-127)
  * POS:   factor * #negatives ranked above the last positive (lms.cc:129-157)

and the ``adaptive_strategy`` (NO/FIXED/RATIO/MIX, lms.cc:344-369) modulates
the two factors by ``adapt_factor`` = fraction of improving iterations in the
last ``normalization_factor`` rounds (lms.cc:261-270).

The reference's per-query sort/shuffle machinery becomes batched rank
computations over the padded [Q, D] view.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from quickrank_tpu.data.dataset import gather_padded, scatter_flat
from quickrank_tpu.learning.lambdamart import LambdaMart
from quickrank_tpu.learning.mart import TrainData

NEGATIVE_STRATEGIES = ("RATIO", "MUL", "POS")
ADAPTIVE_STRATEGIES = ("NO", "FIXED", "RATIO", "MIX")


@partial(jax.jit, static_argnames=("num_docs_padded", "strategy"))
def _select_presence(
    scores_flat, key, rank_factor, random_factor,
    idx, flat_labels, slot_mask, num_docs_padded, strategy,
):
    """Keep-mask for one sampling round (data tensors as jit ARGUMENTS —
    a closure over the padded arrays would constant-fold multi-MB tensors
    into the sampler executable, the learning-package rule)."""
    labels = gather_padded(flat_labels, idx, slot_mask)
    scores = gather_padded(scores_flat, idx, slot_mask)
    sm = slot_mask
    pos = (labels > 0) & sm
    neg = (labels <= 0) & sm
    npos = jnp.sum(pos, axis=-1, keepdims=True)
    nneg = jnp.sum(neg, axis=-1, keepdims=True)

    # rank of each negative among negatives, by descending score
    keyed = jnp.where(neg, scores, -jnp.inf)
    order = jnp.argsort(-keyed, axis=-1, stable=True)
    neg_rank = jnp.argsort(order, axis=-1)

    if strategy == "RATIO":
        n_top = jnp.round(rank_factor * nneg).astype(jnp.int32)
        n_rand = jnp.round(random_factor * nneg).astype(jnp.int32)
    elif strategy == "MUL":
        n_top = jnp.minimum(
            jnp.round(rank_factor * npos).astype(jnp.int32), nneg
        )
        n_rand = jnp.minimum(
            jnp.round(random_factor * npos).astype(jnp.int32), nneg
        )
    else:  # POS: negatives ranked above the last positive
        all_rank = jnp.argsort(
            jnp.argsort(
                -jnp.where(sm, scores, -jnp.inf), axis=-1, stable=True
            ),
            axis=-1,
        )
        last_pos = jnp.max(
            jnp.where(pos, all_rank, -1), axis=-1, keepdims=True
        )
        n_before = jnp.maximum(last_pos + 1 - npos, 0)
        n_before = jnp.where(npos > 0, n_before, 0)
        n_top = jnp.minimum(
            jnp.round(rank_factor * n_before).astype(jnp.int32), nneg
        )
        n_rand = jnp.minimum(
            jnp.round(random_factor * n_before).astype(jnp.int32),
            nneg - n_top,
        )
    n_rand = jnp.minimum(n_rand, nneg - n_top)

    top_kept = neg & (neg_rank < n_top)
    # random extras among the remaining negatives
    rest = neg & ~top_kept
    r = jax.random.uniform(key, labels.shape)
    rk = jnp.where(rest, r, jnp.inf)
    rorder = jnp.argsort(rk, axis=-1)
    rrank = jnp.argsort(rorder, axis=-1)
    rand_kept = rest & (rrank < n_rand)

    keep = pos | top_kept | rand_kept
    return scatter_flat(
        keep.astype(jnp.float32), idx, sm, num_docs_padded
    ) > 0.5


class LambdaMartSelective(LambdaMart):
    NAME = "LAMBDAMART-SELECTIVE"

    def __init__(
        self,
        *args,
        sampling_iterations: int = 1,
        rank_sampling_factor: float = 1.0,
        random_sampling_factor: float = 0.0,
        normalization_factor: float = 100,
        adaptive_strategy: str = "NO",
        negative_strategy: str = "RATIO",
        **kw,
    ):
        super().__init__(*args, **kw)
        self.sampling_iterations = int(sampling_iterations)
        self.rank_sampling_factor = float(rank_sampling_factor)
        self.random_sampling_factor = float(random_sampling_factor)
        self.normalization_factor = float(normalization_factor)
        self.adaptive_strategy = adaptive_strategy.upper()
        self.negative_strategy = negative_strategy.upper()
        if self.adaptive_strategy not in ADAPTIVE_STRATEGIES:
            raise ValueError(f"unknown adaptive strategy {adaptive_strategy!r}")
        if self.negative_strategy not in NEGATIVE_STRATEGIES:
            raise ValueError(f"unknown negative strategy {negative_strategy!r}")
        self._improvements = None
        self._adapt_factor = 1.0
        self._cached_presence = None
        self._sampler = None

    def _factors(self) -> tuple[float, float]:
        """Adaptive modulation of (rank, random) factors (lms.cc:344-369)."""
        a = self._adapt_factor
        rk, rd = self.rank_sampling_factor, self.random_sampling_factor
        if self.adaptive_strategy == "NO":
            return rk, rd
        lo, hi = min(rk, rd), max(rk, rd)
        if self.adaptive_strategy == "FIXED":
            f = lo + (1 - a) * (hi - lo)
            return f, f
        if self.adaptive_strategy == "RATIO":
            s = rk + rd
            return s * a, s * (1 - a)
        # MIX
        f = lo + (1 - a) * (hi - lo)
        return f * a, f * (1 - a)

    def _post_init(self, tr: TrainData) -> None:
        self._improvements = [True] * max(1, int(self.normalization_factor))
        padded = tr.padded
        strategy = self.negative_strategy
        self._sampler = lambda scores_flat, key, rf, rdf: _select_presence(
            scores_flat, key, rf, rdf,
            padded.pad_index_global, padded.labels, padded.slot_mask,
            padded.num_docs_padded, strategy,
        )
        self._cached_presence = None

    def _update_presence(self, m, tr, scores_tr, key):
        if not self.sampling_iterations or (
            self.rank_sampling_factor <= 0 and self.random_sampling_factor <= 0
        ):
            return None
        if m > 0 and m % self.sampling_iterations == 0:
            rk, rd = self._factors()
            self._cached_presence = self._sampler(
                scores_tr, jax.random.fold_in(key, 1931),
                jnp.float32(rk), jnp.float32(rd),
            )
        return self._cached_presence

    def _post_iteration(self, m: int, improved: bool) -> None:
        if self.adaptive_strategy != "NO" and self.normalization_factor > 0:
            w = self._improvements
            w[m % len(w)] = improved
            self._adapt_factor = float(np.mean(w))

    def _info_dict(self) -> dict:
        d = super()._info_dict()
        d.update(
            {
                "sampling-iterations": self.sampling_iterations,
                "rank-sampling-factor": self.rank_sampling_factor,
                "random-sampling-factor": self.random_sampling_factor,
                "normalization-factor": self.normalization_factor,
                "adaptive-strategy": self.adaptive_strategy,
                "negative-strategy": self.negative_strategy,
            }
        )
        return d

    @classmethod
    def _ctor_kwargs_from_info(cls, info) -> dict:
        g = cls._info_get
        d = super()._ctor_kwargs_from_info(info)
        d.update(
            sampling_iterations=g(info, "sampling-iterations", int, 1),
            rank_sampling_factor=g(info, "rank-sampling-factor", float, 1.0),
            random_sampling_factor=g(info, "random-sampling-factor", float, 0.0),
            normalization_factor=g(info, "normalization-factor", float, 100),
            adaptive_strategy=g(info, "adaptive-strategy", str, "NO"),
            negative_strategy=g(info, "negative-strategy", str, "RATIO"),
        )
        return d
