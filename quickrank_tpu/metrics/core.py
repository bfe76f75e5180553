"""Batched IR-metric kernels over padded per-query views.

All functions operate on rank-space or doc-space arrays shaped ``[Q, D]``
(queries x padded doc slots) with a boolean validity mask, fully vectorized
over queries — the replacement of the reference's per-query serial
loops (include/metric/ir/metric.h:77-106).

Conventions (matching the reference):
  * gain(label)    = 2^label - 1                  (src/metric/ir/dcg.cc:35-39)
  * discount(rank) = 1 / log2(rank + 2), 0-based rank
  * metric cutoff k truncates the discount vector
  * swap-delta ("jacobian") matrices are *rank-space*: entry [i, j] is the
    signed metric change when the docs at ranks i and j swap scores
    (include/metric/ir/metric.h:114-137).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Plain float (not a jnp array): module import must not initialize a backend.
NEG_INF = float("-inf")


def rank_order(scores: jnp.ndarray, slot_mask: jnp.ndarray) -> jnp.ndarray:
    """Indices that sort each query's docs by descending score.

    Invalid (padding) slots sort last.  Stable: ties keep slot order, a
    deterministic stand-in for the reference's unstable std::sort
    (src/data/queryresults.cc:47-62).
    Returns ``order [Q, D]`` with ``order[q, r]`` = slot of the rank-r doc.
    """
    keyed = jnp.where(slot_mask, scores, NEG_INF)
    return jnp.argsort(-keyed, axis=-1, stable=True)


def inverse_permutation(order: jnp.ndarray) -> jnp.ndarray:
    """ranks[slot] given order[rank] = slot, batched over leading dims
    (the pos_of_rank/rank-of-pos unmap of include/data/rankedresults.h:37-75).
    """
    return jnp.argsort(order, axis=-1, stable=True)


def ranks_of_slots(scores: jnp.ndarray, slot_mask: jnp.ndarray) -> jnp.ndarray:
    """Rank (0-based, by descending score) of each doc slot; padding slots
    receive tail ranks."""
    return inverse_permutation(rank_order(scores, slot_mask))


def sort_by_score(scores, slot_mask, *extras):
    """ONE stable multi-operand sort by descending score.

    Returns ``(order, sorted_mask, *sorted_extras)`` — the same permutation
    as :func:`rank_order` (identical key and tie order), but the payloads
    ride the sort instead of being fetched with per-row ``take_along_axis``
    gathers afterwards (each a random-access gather; the sort's payload
    moves are fused).
    """
    D = scores.shape[-1]
    key = jnp.where(slot_mask, -scores, jnp.inf)
    iota = jnp.broadcast_to(
        jnp.arange(D, dtype=jnp.int32), scores.shape
    )
    out = jax.lax.sort(
        (key, iota, slot_mask) + tuple(extras),
        dimension=-1, is_stable=True, num_keys=1,
    )
    return out[1], out[2], *out[3:]


def unsort_to_slots(order, *vals):
    """Map rank-space arrays back to slot space: sorting ``(order, vals…)``
    by the permutation places ``vals[r]`` at slot ``order[r]`` — one fused
    sort instead of ``inverse_permutation`` + a gather per array."""
    out = jax.lax.sort(
        (order,) + tuple(vals), dimension=-1, is_stable=True, num_keys=1
    )
    return out[1:] if len(vals) > 1 else out[1]


def gains(labels: jnp.ndarray) -> jnp.ndarray:
    """2^label - 1 (exponential gain, dcg.cc:35-39)."""
    return jnp.exp2(labels) - 1.0


def discounts(D: int, cutoff: int, nvalid: jnp.ndarray) -> jnp.ndarray:
    """``[Q, D]`` discount per rank: 1/log2(r+2) for r < min(cutoff, nvalid),
    else 0."""
    r = jnp.arange(D, dtype=jnp.float32)
    disc = 1.0 / jnp.log2(r + 2.0)
    valid = (r[None, :] < jnp.minimum(cutoff, nvalid)[:, None])
    return jnp.where(valid, disc[None, :], 0.0)


def sorted_labels_by_score(scores, labels, slot_mask):
    """Labels re-ordered by descending score per query; padding tail is -inf
    gain-neutral (label 0 with mask False)."""
    order, sm, sl = sort_by_score(scores, slot_mask, labels)
    return jnp.where(sm, sl, 0.0), sm, order


def dcg_from_sorted(sorted_labels, nvalid, cutoff: int):
    """DCG of a rank-ordered label matrix ``[Q, D]`` (compute_dcg,
    dcg.cc:33-39)."""
    D = sorted_labels.shape[-1]
    disc = discounts(D, cutoff, nvalid)
    return jnp.sum(gains(sorted_labels) * disc, axis=-1)


def ideal_dcg(labels, slot_mask, nvalid, cutoff: int):
    """IDCG: DCG of labels sorted descending (compute_idcg, ndcg.cc:35-47)."""
    keyed = jnp.where(slot_mask, labels, NEG_INF)
    sl = jnp.sort(keyed, axis=-1)[..., ::-1]
    sl = jnp.where(jnp.isfinite(sl), sl, 0.0)
    return dcg_from_sorted(sl, nvalid, cutoff)


def dcg(scores, labels, slot_mask, nvalid, cutoff: int):
    sl, _, _ = sorted_labels_by_score(scores, labels, slot_mask)
    return dcg_from_sorted(sl, nvalid, cutoff)


def ndcg(scores, labels, slot_mask, nvalid, cutoff: int):
    """NDCG per query; 0 when IDCG == 0 (ndcg.cc:51-59)."""
    idcg = ideal_dcg(labels, slot_mask, nvalid, cutoff)
    d = dcg(scores, labels, slot_mask, nvalid, cutoff)
    return jnp.where(idcg > 0, d / jnp.maximum(idcg, 1e-30), 0.0)


def tndcg(scores, labels, slot_mask, nvalid, cutoff: int):
    """Tie-aware NDCG: gains averaged across tied-score groups
    (tndcg.cc:36-66)."""
    idcg = ideal_dcg(labels, slot_mask, nvalid, cutoff)
    order, sm, ss, sl = sort_by_score(
        scores, slot_mask, jnp.where(slot_mask, scores, NEG_INF), labels
    )
    g = jnp.where(sm, gains(sl), 0.0)
    # Tie groups among *valid* docs: equality matrix over rank-ordered scores.
    same = (ss[..., :, None] == ss[..., None, :]) & sm[..., :, None] & sm[..., None, :]
    group_size = jnp.maximum(jnp.sum(same, axis=-1), 1)
    avg_gain = jnp.sum(same * g[..., None, :], axis=-1) / group_size
    disc = discounts(ss.shape[-1], cutoff, nvalid)
    t = jnp.sum(avg_gain * disc, axis=-1)
    return jnp.where(idcg > 0, t / jnp.maximum(idcg, 1e-30), 0.0)


def average_precision(scores, labels, slot_mask, nvalid, cutoff: int):
    """AP@cutoff per query over score-ranked docs.

    NOTE: the reference's Map::evaluate_result_list (src/metric/ir/map.cc:34-46)
    reads labels in *dataset order* (it never applies the score ranking) — a
    long-standing quirk.  We evaluate the intended metric: labels in rank
    order.  Its jacobian (map.cc:58-76) does use rank order, consistent with
    this implementation."""
    sl, sm, _ = sorted_labels_by_score(scores, labels, slot_mask)
    D = sl.shape[-1]
    r = jnp.arange(D, dtype=jnp.float32)
    in_cut = (r[None, :] < jnp.minimum(cutoff, nvalid)[:, None]) & sm
    rel = jnp.where(in_cut & (sl > 0), 1.0, 0.0)
    relcount = jnp.cumsum(rel, axis=-1)
    ap = jnp.sum(rel * relcount / (r[None, :] + 1.0), axis=-1)
    nrel = jnp.sum(rel, axis=-1)
    return jnp.where(nrel > 0, ap / jnp.maximum(nrel, 1.0), 0.0)


def rmse_sse(scores, labels, slot_mask, nvalid, cutoff: int):
    """Per-query sum of squared errors over the first min(cutoff, n) docs in
    dataset order (rmse.cc:34-43).  Dataset-level aggregation (negated root
    of the instance mean) is done by the caller (rmse.cc:46-60)."""
    D = scores.shape[-1]
    r = jnp.arange(D)
    in_cut = (r[None, :] < jnp.minimum(cutoff, nvalid)[:, None]) & slot_mask
    err = jnp.where(in_cut, scores - labels, 0.0)
    return jnp.sum(err * err, axis=-1)


# ---------------------------------------------------------------------------
# Rank-space swap-delta matrices ("jacobians")
# ---------------------------------------------------------------------------


def ndcg_delta_matrix(sorted_labels, sm, nvalid, cutoff: int, normalize: bool = True):
    """Signed ΔDCG (or ΔNDCG when ``normalize``) for swapping ranks (i, j).

    Uniform closed form covering both reference cases (ndcg.cc:72-88,
    dcg.cc:66-80): with disc_r = 1/log2(r+2) for r < cutoff else 0,

        Δ_ij = (disc_j - disc_i) * (2^l_i - 2^l_j) [/ idcg]

    Pairs with equal labels and pairs entirely beyond the cutoff are
    automatically zero.  Upper triangular (i < j); we emit the full
    antisymmetric-in-magnitude matrix with Δ_ji = Δ_ij for convenience.
    """
    g = jnp.where(sm, jnp.exp2(sorted_labels), 0.0)
    D = sorted_labels.shape[-1]
    disc = discounts(D, cutoff, nvalid)
    dd = disc[..., None, :] - disc[..., :, None]  # disc_j - disc_i at [i, j]
    dg = g[..., :, None] - g[..., None, :]  # g_i - g_j
    delta = dd * dg
    pair_ok = sm[..., :, None] & sm[..., None, :]
    delta = jnp.where(pair_ok, delta, 0.0)
    if normalize:
        idcg = ideal_dcg(sorted_labels, sm, nvalid, cutoff)
        safe = jnp.maximum(idcg, 1e-30)
        delta = jnp.where(
            (idcg > 0)[..., None, None], delta / safe[..., None, None], 0.0
        )
    return delta


def tndcg_delta_matrix(sorted_labels, sorted_scores, sm, nvalid, cutoff: int):
    """Tie-aware ΔTNDCG swap matrix (tndcg.cc:76-124).

    w_r = mean of 1/log2(k+2) over r's tie group (no cutoff inside the
    group), / idcg; then Δ_ij = (w_j' - w_i) (2^l_i - 2^l_j) with w_j' = w_j
    if j < cutoff else 0, for i < cutoff."""
    D = sorted_labels.shape[-1]
    g = jnp.where(sm, jnp.exp2(sorted_labels), 0.0)
    r = jnp.arange(D, dtype=jnp.float32)
    disc_all = (1.0 / jnp.log2(r + 2.0))[None, :] * sm
    ss = jnp.where(sm, sorted_scores, NEG_INF)
    same = (ss[..., :, None] == ss[..., None, :]) & sm[..., :, None] & sm[..., None, :]
    gsize = jnp.maximum(jnp.sum(same, axis=-1), 1)
    w = jnp.sum(same * disc_all[..., None, :], axis=-1) / gsize

    idcg = ideal_dcg(sorted_labels, sm, nvalid, cutoff)
    safe = jnp.maximum(idcg, 1e-30)
    w = jnp.where((idcg > 0)[..., None], w / safe[..., None], 0.0)

    k = jnp.minimum(cutoff, nvalid)[:, None]
    in_cut = jnp.arange(D)[None, :] < k
    w_j = jnp.where(in_cut, w, 0.0)  # beyond-cutoff j contributes no discount
    delta = (w_j[..., None, :] - w[..., :, None]) * (
        g[..., :, None] - g[..., None, :]
    )
    # keep the defined region (i < j, i within cutoff, valid pair), then
    # mirror to a symmetric matrix like the NDCG delta
    iidx = jnp.arange(D)[None, :, None]
    jidx = jnp.arange(D)[None, None, :]
    ok = (
        (iidx < jidx)
        & in_cut[..., :, None]
        & sm[..., :, None]
        & sm[..., None, :]
    )
    upper = jnp.where(ok, delta, 0.0)
    return upper + jnp.swapaxes(upper, -1, -2)


def map_delta_matrix(sorted_labels, sm, nvalid, cutoff: int):
    """Exact ΔAP swap matrix. Binary relevance l = (label > 0).

    For i < j with l_i != l_j, diff = l_j - l_i ∈ {±1}:
        Δ = [ (rc_i + diff) l_j - rc_i l_i ] / (i+1)
          + diff * Σ_{i<k<j} l_k/(k+1)
          - rc_j diff / (j+1),   all / count

    NOTE: the reference's Map::jacobian (map.cc:58-76) writes the middle term
    as Σ l_k (rc_k + diff)/(k+1) — the *new* AP summands rather than the
    change — so it does not equal the true swap delta (MAP is untested in the
    reference's suite).  We implement the exact delta; it passes the
    brute-force swap-equivalence property test.  Like the reference, no
    cutoff is applied here."""
    D = sorted_labels.shape[-1]
    l = jnp.where(sm & (sorted_labels > 0), 1.0, 0.0)
    rc = jnp.cumsum(l, axis=-1)
    count = rc[..., -1:]
    pos = jnp.arange(D, dtype=jnp.float32) + 1.0

    # prefix sums of l_k/(k+1)
    Pl = jnp.cumsum(l / pos, axis=-1)

    li = l[..., :, None]
    lj = l[..., None, :]
    diff = lj - li
    rci = rc[..., :, None]
    rcj = rc[..., None, :]
    posi = pos[None, :, None]
    posj = pos[None, None, :]

    # middle term: diff * sum over i < k < j of l_k/(k+1)
    mid = diff * (Pl[..., None, :] - Pl[..., :, None] - lj / posj)

    delta = (
        ((rci + diff) * lj - rci * li) / posi
        + mid
        - rcj * diff / posj
    )
    delta = delta / jnp.maximum(count[..., None], 1.0)

    iidx = jnp.arange(D)[None, :, None]
    jidx = jnp.arange(D)[None, None, :]
    valid_pair = (
        (li != lj)
        & (iidx < jidx)
        & sm[..., :, None]
        & sm[..., None, :]
        & (count[..., None] > 0)
    )
    upper = jnp.where(valid_pair, delta, 0.0)
    # mirror to full matrix (sign convention matches upper triangle)
    return upper + jnp.swapaxes(upper, -1, -2)


def generic_swap_delta_matrix(metric_on_sorted, sorted_labels, sm, nvalid):
    """Brute-force swap jacobian (metric.h:114-137): for every pair (i, j)
    swap the rank-ordered labels and re-evaluate.  O(D^2) metric evals —
    testing/oracle use only.

    ``metric_on_sorted(sorted_labels [..., D], nvalid) -> [...]``.
    """
    D = sorted_labels.shape[-1]
    base = metric_on_sorted(sorted_labels, nvalid)

    ii, jj = jnp.meshgrid(jnp.arange(D), jnp.arange(D), indexing="ij")

    def one_pair(i, j):
        li = sorted_labels[..., i]
        ljv = sorted_labels[..., j]
        swapped = sorted_labels.at[..., i].set(ljv).at[..., j].set(li)
        return metric_on_sorted(swapped, nvalid) - base

    deltas = jax.vmap(
        jax.vmap(one_pair, in_axes=(None, 0)), in_axes=(0, None)
    )(jnp.arange(D), jnp.arange(D))
    # [D, D, Q] -> [Q, D, D]
    deltas = jnp.moveaxis(deltas, -1, 0)
    pair_ok = sm[..., :, None] & sm[..., None, :]
    return jnp.where(pair_ok, deltas, 0.0)
