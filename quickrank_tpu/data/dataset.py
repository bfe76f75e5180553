"""Host-side dataset container and device-side padded/sharded layout.

Reference counterparts:
  * ``Dataset`` — include/data/dataset.h:45 (row-major docs x features plus
    query offsets).  The vertical (feature-major) twin
    (include/data/vertical_dataset.h:46) is unnecessary here: XLA owns
    layout, so one logical array suffices.
  * ``QueryResults`` / ``RankedResults`` (include/data/queryresults.h:36,
    include/data/rankedresults.h:37) — replaced by the padded per-query
    gather map built in :func:`shard_and_pad`, which turns flat doc arrays
    into ``[num_queries_padded, max_docs]`` views with a validity mask.

Layout: docs live in one flat ``[num_docs_padded, num_features]``
array whose leading axis is sharded over the device mesh; queries are
assigned to shards contiguously so a query never straddles a shard.  The
``pad_index`` map is *shard-local*, so inside ``shard_map`` every gather and
scatter is local — the only cross-device traffic in training is the histogram
``psum`` and metric mean reductions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp
from quickrank_tpu.utils import struct

from quickrank_tpu.types import FEATURE_DTYPE, LABEL_DTYPE, QID_DTYPE


@dataclasses.dataclass
class Dataset:
    """Host-side (numpy) learning-to-rank dataset.

    features: float32 ``[num_docs, num_features]`` (1-based feature ids from
        SVML map to columns ``fid - 1``).
    labels: float32 ``[num_docs]`` relevance judgments.
    query_offsets: int64 ``[num_queries + 1]`` — docs of query ``q`` are rows
        ``query_offsets[q]:query_offsets[q+1]`` (mirrors dataset.h's
        offsets_ vector semantics).
    qids: original query identifiers ``[num_queries]``.
    """

    features: np.ndarray
    labels: np.ndarray
    query_offsets: np.ndarray
    qids: np.ndarray
    name: str = ""

    @property
    def num_docs(self) -> int:
        return int(self.features.shape[0])

    @property
    def num_features(self) -> int:
        return int(self.features.shape[1])

    @property
    def num_queries(self) -> int:
        return int(len(self.query_offsets) - 1)

    @property
    def max_docs_per_query(self) -> int:
        return int(np.max(np.diff(self.query_offsets)))

    def docs_per_query(self) -> np.ndarray:
        return np.diff(self.query_offsets).astype(np.int64)

    def query_slice(self, q: int) -> slice:
        return slice(int(self.query_offsets[q]), int(self.query_offsets[q + 1]))

    def validate(self) -> None:
        assert self.features.ndim == 2
        assert self.labels.shape == (self.features.shape[0],)
        assert self.query_offsets[0] == 0
        assert self.query_offsets[-1] == self.features.shape[0]
        assert np.all(np.diff(self.query_offsets) > 0)

    @staticmethod
    def from_arrays(features, labels, qids_per_doc, name: str = "") -> "Dataset":
        """Build from per-doc qid array (docs with equal consecutive qids form
        a query, mirroring Svml::read_horizontal's append semantics,
        src/io/svml.cc:38-161)."""
        features = np.ascontiguousarray(features, dtype=FEATURE_DTYPE)
        labels = np.ascontiguousarray(labels, dtype=LABEL_DTYPE)
        qids_per_doc = np.asarray(qids_per_doc)
        boundaries = np.flatnonzero(
            np.concatenate(([True], qids_per_doc[1:] != qids_per_doc[:-1]))
        )
        offsets = np.concatenate(
            (boundaries, [len(qids_per_doc)])
        ).astype(QID_DTYPE)
        qids = qids_per_doc[boundaries].astype(QID_DTYPE)
        ds = Dataset(features, labels, offsets, qids, name=name)
        ds.validate()
        return ds


def select_columns(ds: Dataset, keep: np.ndarray, name: str = "") -> Dataset:
    """Dataset restricted to the 0-based feature columns ``keep``
    (Cleaver::filter_dataset, cleaver.cc:448-481; also the driver's
    --features selection).  ``keep`` must be in [0, num_features)."""
    keep = np.asarray(keep)
    if keep.size and (keep.min() < 0 or keep.max() >= ds.num_features):
        raise ValueError(
            f"feature selection out of range [0, {ds.num_features}): "
            f"{int(keep.min())}..{int(keep.max())}"
        )
    qids = np.repeat(ds.qids, ds.docs_per_query())
    return Dataset.from_arrays(
        ds.features[:, keep], ds.labels, qids, name=name or ds.name
    )


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@struct.dataclass
class PaddedDataset:
    """Device-resident, statically-shaped, shard-friendly dataset layout.

    All arrays are stacked over ``num_shards`` equally-sized shard blocks so
    that sharding axis 0 of every array over a mesh axis gives each device a
    self-contained local block:

      features   f32 ``[S * docs_per_shard, F]``   (padding rows are zero)
      labels     f32 ``[S * docs_per_shard]``
      doc_mask   bool ``[S * docs_per_shard]``     (False for padding docs)
      pad_index  i32 ``[S * queries_per_shard, max_docs]`` — *shard-local*
                 row index of each (query, slot) within its shard block;
                 padding slots point at the shard's last (dummy) row.
      slot_mask  bool ``[S * queries_per_shard, max_docs]``
      query_mask bool ``[S * queries_per_shard]``
      nvalid     i32 ``[S * queries_per_shard]`` docs per query (0 for pad)

    Static (non-pytree) metadata: num_shards, docs_per_shard,
    queries_per_shard, max_docs, num_features.
    """

    features: jnp.ndarray
    labels: jnp.ndarray
    doc_mask: jnp.ndarray
    pad_index: jnp.ndarray
    slot_mask: jnp.ndarray
    query_mask: jnp.ndarray
    nvalid: jnp.ndarray
    #: i32 [S * docs_per_shard] original dataset row of each padded row
    #: (-1 for padding rows) — the inverse of the packing permutation.
    orig_index: jnp.ndarray = None
    #: inverse of pad_index: shard-LOCAL query index and slot of each padded
    #: doc row (0 for padding rows; gate with doc_mask).  Turns the padded
    #: [Q, D] -> flat [N] write-back into a pure gather (no scatter).
    inv_q: jnp.ndarray = None
    inv_slot: jnp.ndarray = None
    num_shards: int = struct.field(pytree_node=False, default=1)
    docs_per_shard: int = struct.field(pytree_node=False, default=0)
    queries_per_shard: int = struct.field(pytree_node=False, default=0)
    max_docs: int = struct.field(pytree_node=False, default=0)
    num_features: int = struct.field(pytree_node=False, default=0)
    num_real_docs: int = struct.field(pytree_node=False, default=0)
    num_real_queries: int = struct.field(pytree_node=False, default=0)

    @property
    def num_docs_padded(self) -> int:
        return self.num_shards * self.docs_per_shard

    @property
    def num_queries_padded(self) -> int:
        return self.num_shards * self.queries_per_shard

    @property
    def pad_index_global(self) -> jnp.ndarray:
        """pad_index with each query's rows offset into its shard's block of
        the stacked global doc axis — for host-side / unsharded use.  Inside
        ``shard_map`` use the local ``pad_index`` directly."""
        shard_of_q = jnp.arange(self.num_queries_padded) // self.queries_per_shard
        return self.pad_index + (shard_of_q * self.docs_per_shard)[:, None].astype(
            self.pad_index.dtype
        )


def assign_queries_to_shards(doc_counts: np.ndarray, num_shards: int) -> list:
    """Contiguously partition queries into ``num_shards`` groups with roughly
    balanced total doc counts (queries keep their original order; a query
    never straddles shards — per-query lambda computation is shard-local,
    like the per-query OpenMP loop at src/learning/forests/lambdamart.cc:70).
    """
    total = int(doc_counts.sum())
    target = total / num_shards
    groups: list = []
    cum = np.cumsum(doc_counts)
    start = 0
    for s in range(num_shards - 1):
        # Ideal boundary: first query index whose cumulative count reaches
        # (s+1) * target; keep at least one query per remaining shard.
        bound = int(np.searchsorted(cum, (s + 1) * target))
        remaining_shards = num_shards - s - 1
        bound = min(max(bound, start + 1), len(doc_counts) - remaining_shards)
        groups.append(list(range(start, bound)))
        start = bound
    groups.append(list(range(start, len(doc_counts))))
    return groups


def shard_and_pad(
    ds: Dataset,
    num_shards: int = 1,
    max_docs: Optional[int] = None,
    doc_align: int = 1024,
    features_on_device: bool = True,
    force_dims: Optional[tuple] = None,
) -> PaddedDataset:
    """Lay the host dataset out in the static sharded format above.

    ``features_on_device=False`` keeps the (large) feature matrix as a host
    numpy array — tree training reads only the binned tensor, and skipping
    the f32 transfer matters when the accelerator sits behind a slow link.

    ``doc_align`` rounds each shard's doc count up (default 1024), so
    datasets of similar size share compiled programs; the cost is <=1023
    zero rows per shard.
    """
    if not isinstance(ds, Dataset):
        # every non-Mart-family learner funnels through here: a multi-host
        # TrainData (parallel/multihost.py) is Mart-family-only, and the
        # AttributeError it would otherwise hit deep in layout code is not
        # an actionable message (docs/parallel.md §multi-host exclusions)
        raise TypeError(
            f"shard_and_pad expects a Dataset, got {type(ds).__name__} — "
            "multi-host TrainData feeds the Mart family only "
            "(docs/parallel.md)"
        )
    counts = ds.docs_per_query()
    if len(counts) < num_shards:
        raise ValueError(
            f"num_queries={len(counts)} < num_shards={num_shards}"
        )
    dmax = int(max_docs or counts.max())
    if counts.max() > dmax:
        raise ValueError(f"max_docs={dmax} < longest query ({counts.max()})")

    groups = assign_queries_to_shards(counts, num_shards)
    q_loc = max(len(g) for g in groups)
    # +1 dummy doc row per shard that padding slots point at.
    n_loc = _round_up(max(int(counts[g].sum()) for g in groups) + 1, doc_align)
    if force_dims is not None:
        # multi-host assembly: every process must agree on the padded
        # shard geometry (parallel/multihost.py allgathers the maxima)
        fq, fn, fd = force_dims
        if fq < q_loc or fn < n_loc or fd < dmax:
            raise ValueError(
                f"force_dims {force_dims} below local minima "
                f"{(q_loc, n_loc, dmax)}"
            )
        q_loc, n_loc, dmax = fq, fn, fd

    F = ds.num_features
    S = num_shards
    features = np.zeros((S * n_loc, F), dtype=FEATURE_DTYPE)
    labels = np.zeros((S * n_loc,), dtype=LABEL_DTYPE)
    doc_mask = np.zeros((S * n_loc,), dtype=bool)
    orig_index = np.full((S * n_loc,), -1, dtype=np.int32)
    inv_q = np.zeros((S * n_loc,), dtype=np.int32)
    inv_slot = np.zeros((S * n_loc,), dtype=np.int32)
    pad_index = np.full((S * q_loc, dmax), n_loc - 1, dtype=np.int32)
    slot_mask = np.zeros((S * q_loc, dmax), dtype=bool)
    query_mask = np.zeros((S * q_loc,), dtype=bool)
    nvalid = np.zeros((S * q_loc,), dtype=np.int32)

    for s, qs in enumerate(groups):
        row = 0
        for qi, q in enumerate(qs):
            sl = ds.query_slice(q)
            n = sl.stop - sl.start
            features[s * n_loc + row : s * n_loc + row + n] = ds.features[sl]
            labels[s * n_loc + row : s * n_loc + row + n] = ds.labels[sl]
            doc_mask[s * n_loc + row : s * n_loc + row + n] = True
            orig_index[s * n_loc + row : s * n_loc + row + n] = np.arange(
                sl.start, sl.stop, dtype=np.int32
            )
            inv_q[s * n_loc + row : s * n_loc + row + n] = qi  # shard-local
            inv_slot[s * n_loc + row : s * n_loc + row + n] = np.arange(
                n, dtype=np.int32
            )
            gq = s * q_loc + qi
            pad_index[gq, :n] = np.arange(row, row + n, dtype=np.int32)
            slot_mask[gq, :n] = True
            query_mask[gq] = True
            nvalid[gq] = n
            row += n

    return PaddedDataset(
        features=jnp.asarray(features) if features_on_device else features,
        labels=jnp.asarray(labels),
        doc_mask=jnp.asarray(doc_mask),
        pad_index=jnp.asarray(pad_index),
        slot_mask=jnp.asarray(slot_mask),
        query_mask=jnp.asarray(query_mask),
        nvalid=jnp.asarray(nvalid),
        orig_index=jnp.asarray(orig_index),
        inv_q=jnp.asarray(inv_q),
        inv_slot=jnp.asarray(inv_slot),
        num_shards=S,
        docs_per_shard=n_loc,
        queries_per_shard=q_loc,
        max_docs=dmax,
        num_features=F,
        num_real_docs=ds.num_docs,
        num_real_queries=ds.num_queries,
    )


def pack_doc_values(padded: PaddedDataset, values_dataset_order) -> jnp.ndarray:
    """Dataset-order per-doc values -> flat padded order (0 on pad rows)."""
    v = jnp.asarray(values_dataset_order)
    idx = jnp.maximum(padded.orig_index, 0)
    return jnp.where(padded.doc_mask, v[idx], 0).astype(v.dtype)


def unpack_doc_values(padded: PaddedDataset, values_padded_order) -> jnp.ndarray:
    """Flat padded-order per-doc values -> dataset order [num_real_docs]."""
    v = jnp.asarray(values_padded_order)
    out = jnp.zeros((padded.num_real_docs,), v.dtype)
    # Pad rows are routed out of bounds and dropped.
    idx = jnp.where(padded.doc_mask, padded.orig_index, padded.num_real_docs)
    return out.at[idx].set(v, mode="drop")


def gather_unpad(padded_vals, inv_q, inv_slot, doc_mask):
    """Padded [Q, D, ...] per-query values -> flat per-doc array via the
    inverse maps — a pure gather, replacing the sort-based scatter of
    :func:`scatter_flat` on the hot path.  Stack multiple arrays on a
    trailing axis to amortize the gather."""
    out = padded_vals[inv_q, inv_slot]
    mask = doc_mask.reshape(doc_mask.shape + (1,) * (out.ndim - 1))
    return jnp.where(mask, out, 0).astype(padded_vals.dtype)


def build_scatter_keys(padded: PaddedDataset) -> np.ndarray:
    """Static sort keys turning flat per-doc arrays into padded [Q, D] views.

    Row i of the flat layout carries slot ``inv_q[i] * D + inv_slot[i]``;
    flat pad rows and (when the slot space is larger than the flat space)
    appended filler rows are keyed with the UNUSED slot ids so the keys
    below ``Q*D`` form an exact permutation of the slot space.  Surplus rows
    get overflow keys >= Q*D and are sliced away after the sort.  Shape
    ``[S * M_loc]`` with ``M_loc = max(docs_per_shard, Q_loc * D)`` — each
    shard's block is self-contained, so :func:`scatter_padded` works
    unchanged inside ``shard_map``.

    Rationale: the training step applies the same (static) permutation
    every iteration; a one-key ``lax.sort`` replaces the doc-axis gather
    ``flat[pad_index]`` (not yet timed against it on the GPU).
    """
    S = padded.num_shards
    n_loc = padded.docs_per_shard
    q_loc = padded.queries_per_shard
    D = padded.max_docs
    QD = q_loc * D
    M = max(n_loc, QD)
    inv_q = np.asarray(padded.inv_q).reshape(S, n_loc)
    inv_slot = np.asarray(padded.inv_slot).reshape(S, n_loc)
    doc_mask = np.asarray(padded.doc_mask).reshape(S, n_loc)
    out = np.empty((S, M), np.int32)
    for s in range(S):
        real = doc_mask[s]
        used = inv_q[s][real].astype(np.int64) * D + inv_slot[s][real]
        unused = np.setdiff1d(np.arange(QD, dtype=np.int64), used)
        fill = np.concatenate(
            [unused, QD + np.arange(M - len(unused), dtype=np.int64)]
        )
        keys = np.empty(M, np.int64)
        kf = keys[:n_loc]
        kf[real] = used
        n_pad_flat = int((~real).sum())
        kf[~real] = fill[:n_pad_flat]
        keys[:n_loc] = kf
        keys[n_loc:] = fill[n_pad_flat : n_pad_flat + (M - n_loc)]
        out[s] = keys.astype(np.int32)
    return out.reshape(S * M)


def scatter_padded(
    flat: jnp.ndarray,
    scatter_key: jnp.ndarray,
    slot_shape: tuple,
    doc_mask: Optional[jnp.ndarray] = None,
):
    """Flat per-doc array -> padded ``[Q, D]`` view via one ``lax.sort`` on
    the precomputed :func:`build_scatter_keys` permutation — bitwise equal
    to ``gather_padded(flat, pad_index, slot_mask)`` (pad slots 0).  Pass
    ``doc_mask`` so flat pad rows land as zeros."""
    Q, D = slot_shape
    QD = Q * D
    M = scatter_key.shape[0]
    v = flat if doc_mask is None else jnp.where(doc_mask, flat, 0)
    if M > v.shape[0]:
        v = jnp.concatenate([v, jnp.zeros((M - v.shape[0],), v.dtype)])
    _, out = jax.lax.sort((scatter_key, v), num_keys=1, is_stable=False)
    return out[:QD].reshape(Q, D)


def gather_padded(flat: jnp.ndarray, pad_index: jnp.ndarray, slot_mask: jnp.ndarray, fill=0.0):
    """Flat per-doc array -> padded ``[Q, D]`` per-query view (shard-local).

    The training step avoids it on its hot path by carrying the [Q, D]
    score views across iterations and keeping a precomputed ``labels2d``
    in StepData."""
    out = flat[pad_index]
    return jnp.where(slot_mask, out, jnp.asarray(fill, dtype=out.dtype))


def scatter_flat(padded: jnp.ndarray, pad_index: jnp.ndarray, slot_mask: jnp.ndarray, num_docs: int):
    """Padded ``[Q, D]`` per-query values -> flat per-doc array.

    Every real doc appears in exactly one (query, slot); padding slots all
    collide on the dummy row, which stays masked downstream.
    """
    vals = jnp.where(slot_mask, padded, 0.0).astype(padded.dtype)
    flat = jnp.zeros((num_docs,), dtype=padded.dtype)
    return flat.at[pad_index.reshape(-1)].add(vals.reshape(-1))
