"""Pairwise LambdaRank gradient kernel.

Vectorized replacement of ``LambdaMart::compute_pseudoresponses``
(src/learning/forests/lambdamart.cc:62-152): instead of a per-query OpenMP
loop with an O(n^2) scalar pair walk, all queries are processed as a batched
``[Q, D, D]`` pair tensor (optionally in query chunks to bound memory — the
analog of the reference's cutoff ``break`` at lambdamart.cc:124-126 is a
pair mask).

Per query, for every rank pair (j, k) with label_j > label_k and not both
beyond the metric cutoff:

    rho    = 1 / (1 + exp(s_j - s_k))          (lambdamart.cc:132-134)
    lambda_j += rho * |Delta_jk|,   lambda_k -= rho * |Delta_jk|
    w_j    += rho (1-rho) |Delta_jk|,  w_k    += the same

where Delta is the metric's rank-space swap-delta matrix ("jacobian").
Outputs are mapped from rank space back to doc slots via the score argsort
permutation (the pos_of_rank unmap of rankedresults.h:37-75).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from quickrank_tpu.metrics import core


def _lambda_block_banded(scores, labels, slot_mask, nvalid, metric):
    """Cutoff-banded lambda block for DCG/NDCG.

    The reference's pair loop breaks once both ranks are beyond the metric
    cutoff (lambdamart.cc:124-126) because their swap deltas are zero; the
    batched analog computes only the two rectangular pair blocks touching
    the cutoff — A (rows j < cut, all k) and B (all j, cols k < cut) —
    instead of the full [D, D] tensor:

        lambda[r<cut] = rowsum_A[r] - colsum_B[r]
        lambda[r>=cut] = rowsum_B[r] - colsum_A[r]
        w[r<cut]     = rowsum_Aw[r] + colsum_Bw[r]
        w[r>=cut]    = rowsum_Bw[r] + colsum_Aw[r]

    ~D/(2 cut) times less pair work/memory (65x at MSLR list lengths).
    """
    from quickrank_tpu.metrics.metrics import Dcg, Ndcg

    normalize = type(metric) is Ndcg
    # one multi-operand sort carries scores/labels into rank space
    order, sm, ss, sl = core.sort_by_score(scores, slot_mask, scores, labels)
    sl = jnp.where(sm, sl, 0.0)

    D = scores.shape[-1]
    cut = min(metric.cutoff, D)
    disc = core.discounts(D, metric.cutoff, nvalid)  # zero beyond cut/nvalid
    g = jnp.where(sm, jnp.exp2(sl), 0.0)
    if normalize:
        idcg = core.ideal_dcg(sl, sm, nvalid, metric.cutoff)
        inv = jnp.where(idcg > 0, 1.0 / jnp.maximum(idcg, 1e-30), 0.0)
    else:
        inv = jnp.ones(scores.shape[:-1], scores.dtype)

    # ONE [.., cut, D] pair block covers both rectangles: rows are the
    # cut slice, cols are all docs.  Block A is the (row label > col label)
    # half; block B — originally [D, cut] — is computed TRANSPOSED as the
    # (row label < col label) half of the same block, because delta is
    # symmetric in (j, k)
    # and sigmoid(-x) = 1 - sigmoid(x).  The two halves fold into a single
    # signed tensor G for lambdas and a single W for weights (the weight
    # product rho(1-rho) is symmetric), and the per-query 1/IDCG scales
    # linearly so it applies once after the sums, not per pair.
    c = lambda x: x[..., :cut]  # noqa: E731
    row_sl, row_ss, row_sm = c(sl), c(ss), c(sm)
    delta = jnp.abs(
        (disc[..., None, :] - c(disc)[..., :, None])
        * (c(g)[..., :, None] - g[..., None, :])
    )
    rho = jax.nn.sigmoid(ss[..., None, :] - row_ss[..., :, None])
    rd = rho * delta
    valid = row_sm[..., :, None] & sm[..., None, :]
    gt = row_sl[..., :, None] > sl[..., None, :]
    lt = row_sl[..., :, None] < sl[..., None, :]
    G = jnp.where(gt & valid, rd, 0.0) - jnp.where(lt & valid, delta - rd, 0.0)
    W = jnp.where((gt | lt) & valid, rd * (1.0 - rho), 0.0)

    in_cut = jnp.arange(D) < cut
    pad = lambda x: jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, D - cut)])  # noqa: E731
    # in-cut docs: +sum over their row; beyond-cut docs: -sum over their col
    lam_rank = jnp.where(
        in_cut, pad(jnp.sum(G, axis=-1)), -jnp.sum(G, axis=-2)
    ) * inv[..., None]
    w_rank = jnp.where(
        in_cut, pad(jnp.sum(W, axis=-1)), jnp.sum(W, axis=-2)
    ) * inv[..., None]

    # rank -> slot unmap rides a second sort (no inverse-perm gathers)
    lam, w = core.unsort_to_slots(order, lam_rank, w_rank)
    return (
        jnp.where(slot_mask, lam, 0.0).astype(jnp.float32),
        jnp.where(slot_mask, w, 0.0).astype(jnp.float32),
    )


def _lambda_block(scores, labels, slot_mask, nvalid, metric):
    """One query block: returns (lambdas, weights) in *slot* space [C, D]."""
    order, sm, ss, sl = core.sort_by_score(scores, slot_mask, scores, labels)
    sl = jnp.where(sm, sl, 0.0)

    delta = jnp.abs(metric.delta_matrix(ss, sl, sm, nvalid))  # [C, D, D]

    D = scores.shape[-1]
    cut = min(metric.cutoff, D)
    r = jnp.arange(D)
    beyond = r >= cut
    pair_mask = (
        (sl[..., :, None] > sl[..., None, :])
        & sm[..., :, None]
        & sm[..., None, :]
        & ~(beyond[None, :, None] & beyond[None, None, :])
    )

    # rho = sigmoid(s_k - s_j): large when the pair is mis-ordered.
    rho = jax.nn.sigmoid(ss[..., None, :] - ss[..., :, None])
    m = jnp.where(pair_mask, rho * delta, 0.0)
    mw = jnp.where(pair_mask, rho * (1.0 - rho) * delta, 0.0)

    lam_rank = jnp.sum(m, axis=-1) - jnp.sum(m, axis=-2)
    w_rank = jnp.sum(mw, axis=-1) + jnp.sum(mw, axis=-2)

    lam, w = core.unsort_to_slots(order, lam_rank, w_rank)
    return (
        jnp.where(slot_mask, lam, 0.0).astype(jnp.float32),
        jnp.where(slot_mask, w, 0.0).astype(jnp.float32),
    )


def lambda_gradients(
    scores: jnp.ndarray,
    labels: jnp.ndarray,
    slot_mask: jnp.ndarray,
    nvalid: jnp.ndarray,
    metric,
    query_chunk: Optional[int] = None,
):
    """Batched lambda/weight gradients over padded per-query views.

    scores/labels: f32 [Q, D]; slot_mask: bool [Q, D]; nvalid: i32 [Q].
    Returns (lambdas [Q, D], weights [Q, D]) in slot space.
    ``query_chunk`` bounds the live [chunk, D, D] pair tensor; by default a
    chunk is chosen automatically so the pair tensors stay under ~1 GB (the
    reference bounds the pair loop with the metric cutoff break,
    lambdamart.cc:124-126 — here padded blocks + masking play that role).
    """
    from quickrank_tpu.metrics.metrics import Dcg, Ndcg

    Q, D = scores.shape
    cut = min(metric.cutoff, D)
    # Cutoff-banded fast path for DCG/NDCG (swap deltas vanish beyond the
    # cutoff, mirroring the reference's loop break, lambdamart.cc:124-126).
    banded = type(metric) in (Dcg, Ndcg) and 3 * cut <= D
    block = _lambda_block_banded if banded else _lambda_block
    pair_elems = (cut * D) if banded else (D * D)
    if query_chunk is None:
        # ~4 live pair tensors of ~45 MB each bound the working set (the
        # size is not yet tuned on the GPU)
        budget = (45 << 20) // (4 * max(pair_elems, 1))
        query_chunk = Q if budget >= Q else max(1, budget)
    if query_chunk >= Q:
        return block(scores, labels, slot_mask, nvalid, metric)
    # Pad Q up to a chunk multiple instead of searching for a divisor: a
    # prime Q would otherwise collapse the chunk to 1 — thousands of
    # sequential single-query blocks per gradient pass.  Pad queries carry
    # all-False slot masks and nvalid=0, the same shape every sharded
    # layout already feeds through these blocks.
    pad = (-Q) % query_chunk
    if pad:
        scores = jnp.pad(scores, ((0, pad), (0, 0)))
        labels = jnp.pad(labels, ((0, pad), (0, 0)))
        slot_mask = jnp.pad(slot_mask, ((0, pad), (0, 0)))
        nvalid = jnp.pad(nvalid, (0, pad))
    C = (Q + pad) // query_chunk

    def one(args):
        s, l, m, n = args
        return block(s, l, m, n, metric)

    resh = lambda x: x.reshape((C, query_chunk) + x.shape[1:])  # noqa: E731
    lam, w = jax.lax.map(
        one, (resh(scores), resh(labels), resh(slot_mask), resh(nvalid))
    )
    return (
        lam.reshape(scores.shape)[:Q],
        w.reshape(scores.shape)[:Q],
    )
