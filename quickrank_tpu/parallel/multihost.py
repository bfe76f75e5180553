"""Multi-host data path: per-process ingestion + global-array assembly.

Never run on GPUs: only CPU processes on one machine have exercised it
(tests/test_multihost.py).

The reference is single-process (SURVEY.md §2.9) — this is the framework's
"collective backend" deliverable.  Each process loads ONLY its own query
block (pre-split SVML files, or :func:`process_query_block` over a shared
file), builds its local padded shards, and the step tensors are assembled
into global ``jax.Array``s with ``jax.make_array_from_process_local_data``
— no process ever materializes the full dataset.  Training then runs the
UNCHANGED jitted step: under ``shard_map`` the histogram/metric ``psum``s
span every process's devices; split decisions stay
replicated because they derive only from the psum'd histograms.

Global agreements between processes (all via
``multihost_utils.process_allgather``, exchanged once at setup):
  * padded shard geometry (queries/docs per shard, max list length);
  * the threshold tables — per-process candidate tables are merged per
    feature and re-quantiled to ``nthresholds`` bins, the standard
    distributed-binning approximation (every process ends up with the
    SAME tables, so trees stay replicated).

Runbook: docs/parallel.md §multi-host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from quickrank_tpu.data.dataset import Dataset


def process_query_block(
    ds: Dataset, num_processes: int, process_id: int
) -> Dataset:
    """Contiguous, doc-count-balanced query block for one process.

    The split is by CUMULATIVE DOC COUNT (same policy as
    assign_queries_to_shards) so hosts stay load-balanced.  With
    pre-split per-host SVML files, skip this and read your own file."""
    counts = ds.docs_per_query()
    if num_processes > len(counts):
        # the bound cap below (len(counts) - (num_processes - pidx)) would
        # go negative and silently hand out wrapped/overlapping blocks
        raise ValueError(
            f"process_query_block: {num_processes} processes > "
            f"{len(counts)} queries — every process needs at least one "
            "whole query"
        )
    cum = np.concatenate([[0], np.cumsum(counts)])
    target = cum[-1] / num_processes
    bounds = [0]
    for pidx in range(1, num_processes):
        b = int(np.searchsorted(cum, pidx * target))
        b = min(max(b, bounds[-1] + 1), len(counts) - (num_processes - pidx))
        bounds.append(b)
    bounds.append(len(counts))
    q0, q1 = bounds[process_id], bounds[process_id + 1]
    sl = slice(int(ds.query_slice(q0).start), int(ds.query_slice(q1 - 1).stop))
    qids_per_doc = np.repeat(ds.qids, counts)[sl]
    return Dataset.from_arrays(
        ds.features[sl], ds.labels[sl], qids_per_doc,
        name=f"{ds.name}[proc{process_id}]",
    )


def merge_threshold_candidates(all_thr: np.ndarray) -> np.ndarray:
    """Deterministically merge per-process candidate threshold tables
    [P, F, B] into one [F, B] table: union the candidate values per
    feature and quantile-select ``B - 1`` of them, keeping the +FLT_MAX
    sentinel as the last entry (ops/binning.py contract).  The standard
    distributed-binning approximation — exact when the union has <= B
    distinct values."""
    all_thr = np.asarray(all_thr)
    P_, F, B = all_thr.shape
    out = np.empty((F, B), np.float32)
    for f in range(F):
        cand = np.unique(all_thr[:, f, :].reshape(-1))
        # drop the FLT_MAX sentinel/pad entries of the local tables: they
        # are FINITE (np.isfinite keeps them), and a surviving sentinel
        # always wins the top quantile slot, duplicating the out[:, B-1]
        # sentinel and silently losing one bin of resolution per feature
        cand = cand[np.isfinite(cand) & (cand < np.float32(3.4028235e38))]
        if len(cand) == 0:  # constant/empty feature: sentinel-only table
            out[f, :] = np.float32(3.4028235e38)
            continue
        if len(cand) >= B:
            idx = np.linspace(0, len(cand) - 1, B - 1).round().astype(int)
            vals = cand[idx]
        else:
            vals = np.pad(cand, (0, B - 1 - len(cand)), mode="edge")
        out[f, : B - 1] = vals
        out[f, B - 1] = np.float32(3.4028235e38)
    return out


def global_thresholds(
    local_features: np.ndarray, nthresholds: int
) -> np.ndarray:
    """Identical-on-every-process threshold tables from per-process
    candidates: build local tables, allgather them, merge — deterministic,
    so every process computes the same result."""
    from jax.experimental import multihost_utils

    from quickrank_tpu.ops.binning import build_thresholds

    local_thr, _ = build_thresholds(local_features, nthresholds)
    all_thr = np.asarray(
        multihost_utils.process_allgather(jnp.asarray(local_thr))
    )  # [P, F, B]
    return merge_threshold_candidates(all_thr)


def build_train_data_multihost(
    local_ds: Dataset,
    mesh: Mesh,
    nthresholds: int,
    thresholds: Optional[np.ndarray] = None,
):
    """Per-process TrainData whose step tensors are GLOBAL jax.Arrays over
    ``mesh``.  Every process passes its own query block; the returned
    TrainData feeds ``Mart.learn(..., mesh=mesh)`` directly (the learner
    detects the presharded step and skips local sharding).

    Consumers: the Mart family ONLY (MART / LambdaMART / their oblivious
    and DART variants accept TrainData).  RankBoost and the linear rankers
    take a plain ``Dataset`` — hand them ``local_ds`` per process is NOT
    equivalent (their pair potentials / weight sweeps are global) and a
    TrainData is rejected with a TypeError at shard_and_pad.  Warm starts
    are rejected by Mart.learn (host-side rescoring gathers need the global
    flat layout).  See docs/parallel.md §multi-host exclusions.

    Meshes: 1-D ``(data,)`` or 2-D ``(data, feat)``.  For 2-D every
    process must own whole data rows (its local devices span the full
    feature axis) — feature collectives then stay inside a process."""
    from jax.experimental import multihost_utils

    from quickrank_tpu.learning.mart import TrainData
    from quickrank_tpu.parallel.mesh import step_data_specs

    axis = mesh.axis_names[0]
    feat_axis = mesh.axis_names[1] if len(mesh.axis_names) > 1 else None
    feat_size = int(mesh.shape[feat_axis]) if feat_axis else 1
    n_local = max(1, len(mesh.local_devices))
    if n_local % feat_size:
        raise ValueError(
            f"2-D multi-host mesh: each process must own whole data rows "
            f"(local devices {n_local} not divisible by feature-axis size "
            f"{feat_size})"
        )
    n_local_shards = max(1, n_local // feat_size)

    # agree on the padded shard geometry
    from quickrank_tpu.data.dataset import (
        _round_up,
        assign_queries_to_shards,
    )

    counts = local_ds.docs_per_query()
    groups = assign_queries_to_shards(counts, n_local_shards)
    q_cand = max(len(g) for g in groups)
    n_cand = _round_up(
        max(int(counts[g].sum()) for g in groups) + 1, 1024
    )
    d_cand = int(counts.max())
    dims = np.asarray(
        multihost_utils.process_allgather(
            jnp.asarray([q_cand, n_cand, d_cand], jnp.int32)
        )
    ).reshape(-1, 3)
    force = (int(dims[:, 0].max()), int(dims[:, 1].max()),
             int(dims[:, 2].max()))

    if thresholds is None:
        thresholds = global_thresholds(local_ds.features, nthresholds)

    tr = TrainData.build(
        local_ds, nthresholds, num_shards=n_local_shards,
        thresholds=thresholds, num_feat_shards=feat_size, force_dims=force,
    )

    # assemble global arrays: each field's local block + its partition
    # spec (the same specs shard_map consumes).  The feature axis is fully
    # local to every process (whole-data-row requirement above), so the
    # local block always spans the full feature width.
    specs = step_data_specs(tr.step, axis, feat_axis)
    is_leaf = lambda x: isinstance(x, (jnp.ndarray, np.ndarray))  # noqa: E731

    # Replicated fields (spec without the data axis, e.g. the threshold
    # tables) must hold IDENTICAL bytes on every process — a silent
    # mismatch would diverge the trees without erroring.  Agree on a
    # digest up front, one allgather for all such fields.
    import zlib

    def _replicated(spec):
        return axis not in jax.tree.leaves(tuple(spec))

    digests = [
        zlib.crc32(np.ascontiguousarray(np.asarray(x)).tobytes())
        for x, spec in zip(
            jax.tree.leaves(tr.step, is_leaf=is_leaf),
            jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, P)),
        )
        if _replicated(spec)
    ]
    if digests:
        agreed = np.asarray(
            multihost_utils.process_allgather(
                jnp.asarray(digests, jnp.uint32)
            )
        ).reshape(-1, len(digests))
        if not (agreed == agreed[0]).all():
            raise ValueError(
                "multi-host TrainData: a replicated step field (e.g. the "
                "threshold table) differs between processes — pass the "
                "same `thresholds` everywhere or let global_thresholds "
                f"derive them (digests per process: {agreed.tolist()})"
            )

    def to_global(x, spec):
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_process_local_data(sh, np.asarray(x))

    step = jax.tree.map(to_global, tr.step, specs, is_leaf=is_leaf)
    import dataclasses

    return dataclasses.replace(tr, step=step, presharded=True)
