"""Device-mesh helpers: query-sharded data parallelism.

The reference has no distributed layer at all (SURVEY.md §2.9) — its only
parallelism is intra-node OpenMP.  Here the equivalent first-class component:
queries are packed into equal per-shard blocks (data/dataset.py
``shard_and_pad``), every per-doc / per-query array is sharded on axis 0 over
a 1-D mesh, and the boosting step runs under ``shard_map`` with exactly two
collective sites:

  1. the (feature, bin) split-statistics histogram ``psum`` per tree node
     (the cross-chip analog of the shared-memory accumulation in
     rtnode_histogram.cc:51-63), and
  2. the metric numerator/denominator ``psum`` per iteration (the analog of
     the mean over queries in metric.h:84-90).

Split decisions are derived from the reduced histograms, so every chip grows
an identical tree — the ensemble state stays replicated by construction.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
FEAT_AXIS = "feat"

def shard_map(f, mesh, in_specs, out_specs, check_rep=False):
    """``jax.shard_map`` with replication checking off by default (the
    step bodies return psum'd values the checker cannot prove
    replicated)."""
    return jax.shard_map(
        f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=check_rep,
    )


#: (fn, mesh) -> jitted shard_map wrapper; jax.jit then caches per
#: input shape/dtype under each wrapper as usual
_SCORE_SM_CACHE: dict = {}


def score_rows_sharded(fn, feats, model_tree, mesh: Mesh):
    """Data-parallel batch scoring: shard the doc rows of ``feats`` over
    EVERY axis of ``mesh`` (inference has no cross-doc coupling, so a 2-D
    training mesh is consumed as one flat doc axis), replicate the model
    pytree, run ``fn(local_feats, model_tree) -> [n_local]`` per device,
    reassemble.  No collectives — pure fan-out over the devices.

    The reference's scoring parallelism is an OpenMP loop over docs
    (ensemble.cc:96-123); this is its mesh equivalent, and the only
    reliable way to run a Pallas scorer kernel on sharded inputs (GSPMD
    cannot auto-partition a custom call, shard_map runs it per shard).

    The jitted wrapper is memoized on ``(fn, mesh)`` — callers must pass a
    STABLE function object (not a fresh lambda per call) or every scoring
    call retraces and recompiles the full ensemble scorer.
    """
    feats = np.asarray(feats, np.float32)
    N = feats.shape[0]
    axes = tuple(mesh.axis_names)
    n_dev = int(np.prod([mesh.shape[a] for a in axes]))
    n_pad = ((N + n_dev - 1) // n_dev) * n_dev
    if n_pad != N:
        feats = np.pad(feats, ((0, n_pad - N), (0, 0)))
    sharding = NamedSharding(mesh, P(axes, None))
    fd = jax.device_put(feats, sharding)
    key = (fn, mesh)
    jitted = _SCORE_SM_CACHE.get(key)
    if jitted is None:
        jitted = jax.jit(
            shard_map(
                fn, mesh=mesh,
                in_specs=(P(axes, None), P()),
                out_specs=P(axes),
            )
        )
        _SCORE_SM_CACHE[key] = jitted
    out = jitted(fd, model_tree)
    return np.asarray(out)[:N]


def make_mesh(num_devices: Optional[int] = None, axis: str = DATA_AXIS) -> Mesh:
    """1-D mesh over the first ``num_devices`` devices (default: all)."""
    devs = jax.devices()
    if num_devices is not None:
        if len(devs) < num_devices:
            raise ValueError(
                f"requested a {num_devices}-device mesh but only "
                f"{len(devs)} device(s) are visible "
                f"({[str(d) for d in devs]}); on CPU set "
                "--xla_force_host_platform_device_count (the CLI's "
                "--platform cpu does this from --num-shards)"
            )
        devs = devs[:num_devices]
    return Mesh(devs, (axis,))


def make_mesh_2d(
    data: int,
    feat: int,
    axes: tuple = (DATA_AXIS, FEAT_AXIS),
) -> Mesh:
    """2-D mesh: queries sharded over ``data``, the feature axis of the
    histogram/split scan over ``feat`` (mirrors the per-feature OpenMP loop
    of rt.cc:257-292 as a second mesh dimension)."""

    all_devs = jax.devices()
    need = data * feat
    if len(all_devs) < need:
        # same actionable message as make_mesh's 1-D check — a bare
        # reshape error would hide the device-count cause
        raise ValueError(
            f"make_mesh_2d({data}, {feat}) needs {need} devices but only "
            f"{len(all_devs)} are visible; on CPU set XLA_FLAGS="
            f"--xla_force_host_platform_device_count={need} before any "
            "device use (tests/conftest.py does this)"
        )
    devs = np.asarray(all_devs[:need]).reshape(data, feat)
    return Mesh(devs, axes)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Mesh:
    """Multi-host initialization: start the jax.distributed runtime and
    return the global data mesh (never run on GPUs yet).

    This is the framework's whole "communication backend" — the collectives
    themselves are the standard XLA psum/all-gather inserted by shard_map
    (SURVEY.md §2.9/§5: no custom transport needed).
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return make_mesh()


def step_data_specs(sd, axis: str = DATA_AXIS, feat_axis: Optional[str] = None):
    """PartitionSpec pytree for a :class:`~quickrank_tpu.learning.mart.StepData`:
    every doc/query-axis array sharded on ``axis``; with ``feat_axis`` the
    binned matrix and threshold table are additionally feature-sharded."""
    return sd.replace(
        binned=P(axis, feat_axis),
        labels=P(axis),
        labels2d=P(axis, None),
        doc_mask=P(axis),
        pad_index=P(axis, None),
        inv_q=P(axis),
        inv_slot=P(axis),
        slot_mask=P(axis, None),
        query_mask=P(axis),
        nvalid=P(axis),
        thresholds=P(feat_axis, None),
        scatter_key=P(axis),
    )


def shard_step_data(
    sd, mesh: Mesh, axis: str = DATA_AXIS, feat_axis: Optional[str] = None
):
    """Place a StepData's arrays on the mesh with the specs above."""
    specs = step_data_specs(sd, axis, feat_axis)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), sd, specs
    )
