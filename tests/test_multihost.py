"""Simulated multi-host training: two jax.distributed CPU processes
on localhost, per-process data ingestion, global-array assembly — asserts
sharded-equals-single-device for a small MART/LambdaMART run.

This is the test SURVEY.md §2.9's "collective backend" row calls for: the
subprocesses each load only THEIR query block (parallel/multihost.py),
assemble global step tensors with jax.make_array_from_process_local_data,
and run the unchanged jitted training step over a 4-device global mesh
(2 processes x 2 local CPU devices).  The parent compares each process's
metric history against a plain single-process run of the same data.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import json, os, sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
).strip()
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir", "/tmp/qrtpu_jax_cache")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)

coord, pid, nproc, out_path = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
mode = sys.argv[5] if len(sys.argv) > 5 else "1d"
jax.distributed.initialize(
    coordinator_address=coord, num_processes=nproc, process_id=pid
)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 2 * nproc, jax.devices()

import numpy as np
from jax.sharding import Mesh

from quickrank_tpu.data.synthetic import make_ranking_dataset
from quickrank_tpu.learning import LambdaMart
from quickrank_tpu.metrics import Ndcg
from quickrank_tpu.parallel.multihost import (
    build_train_data_multihost, process_query_block,
)

if mode == "2d":
    # (data, feat) with whole data rows per process: feature collectives
    # stay intra-process (fast links inside a host, slow ones across)
    mesh = Mesh(
        np.asarray(jax.devices()).reshape(nproc, 2), ("data", "feat")
    )
else:
    mesh = Mesh(np.asarray(jax.devices()), ("data",))

full = make_ranking_dataset(
    num_queries=48, avg_docs_per_query=30, num_features=12, seed=7
)
local = process_query_block(full, nproc, pid)  # per-process ingestion
tr = build_train_data_multihost(local, mesh, nthresholds=16)

va = None
if mode == "2d":
    # validation fold over the SAME multi-host builder (docs/parallel.md
    # multi-host exclusions: a host-local valid Dataset is rejected)
    vfull = make_ranking_dataset(
        num_queries=24, avg_docs_per_query=30, num_features=12, seed=8
    )
    va = build_train_data_multihost(
        process_query_block(vfull, nproc, pid), mesh, nthresholds=16,
        thresholds=np.asarray(tr.step.thresholds),
    )

if mode == "dart":
    # 13 iterations so the m > 11 periodic full rescore fires: the rescore
    # used to mix host-local QS tables with the multihost-global binned
    # array in one jit (incompatible-devices); it must take the scan path
    # under jax.process_count() > 1 (learning/dart.py::_full_rescore).
    from quickrank_tpu.learning import Dart

    lm = Dart(
        ntrees=13, nleaves=4, nthresholds=16, rate_drop=0.3, seed=0, esr=0
    )
else:
    lm = LambdaMart(ntrees=3, nleaves=4, nthresholds=16, seed=0, esr=0)
hist = lm.learn(tr, va, Ndcg(10), verbose=False, mesh=mesh)
if pid == 0:
    out = {"train": hist["train"]}
    if va is not None:
        out["valid"] = hist["valid"]
    with open(out_path, "w") as f:
        json.dump(out, f)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _run_workers(tmp_path, mode):
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    out_path = str(tmp_path / f"mh_{mode}.json")
    script = str(tmp_path / "worker.py")
    with open(script, "w") as f:
        f.write(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        + os.pathsep + env.get("PYTHONPATH", "")
    )
    # each worker writes to its own FILE (a PIPE could fill with jax/XLA
    # warnings and deadlock a worker mid-write while its peer waits at the
    # jax.distributed barrier), and a timeout kills BOTH workers instead
    # of leaking them (still holding the coordinator port) into the rest
    # of the suite
    logs = [str(tmp_path / f"worker{pid}_{mode}.log") for pid in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, script, coord, str(pid), "2", out_path, mode],
            env=env, stdout=open(logs[pid], "w"), stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    try:
        for p in procs:
            p.wait(timeout=560)
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        raise
    for pid, p in enumerate(procs):
        out = open(logs[pid]).read()
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
    with open(out_path) as f:
        return json.load(f)


def _single_process_dart_oracle():
    """Single-process DART run mirroring the "dart" worker mode (same
    merged thresholds, same seed -> identical host RNG dropout draws)."""
    from quickrank_tpu.data.synthetic import make_ranking_dataset
    from quickrank_tpu.learning import Dart
    from quickrank_tpu.learning.mart import TrainData
    from quickrank_tpu.metrics import Ndcg
    from quickrank_tpu.ops.binning import build_thresholds
    from quickrank_tpu.parallel.multihost import (
        merge_threshold_candidates,
        process_query_block,
    )

    full = make_ranking_dataset(
        num_queries=48, avg_docs_per_query=30, num_features=12, seed=7
    )
    cand = np.stack(
        [
            build_thresholds(
                process_query_block(full, 2, pid).features, 16
            )[0]
            for pid in range(2)
        ]
    )
    thr = merge_threshold_candidates(cand)
    tr = TrainData.build(full, 16, thresholds=thr)
    d = Dart(ntrees=13, nleaves=4, nthresholds=16, rate_drop=0.3, seed=0,
             esr=0)
    return d.learn(tr, None, Ndcg(10), verbose=False)


def _single_process_oracle():
    """Single-process run of the SAME full dataset, using the SAME
    distributed-binning threshold tables the workers agree on (the merge
    is deterministic and reproducible without jax.distributed)."""
    from quickrank_tpu.data.synthetic import make_ranking_dataset
    from quickrank_tpu.learning import LambdaMart
    from quickrank_tpu.learning.mart import TrainData
    from quickrank_tpu.metrics import Ndcg
    from quickrank_tpu.ops.binning import build_thresholds
    from quickrank_tpu.parallel.multihost import (
        merge_threshold_candidates,
        process_query_block,
    )

    full = make_ranking_dataset(
        num_queries=48, avg_docs_per_query=30, num_features=12, seed=7
    )
    cand = np.stack(
        [
            build_thresholds(
                process_query_block(full, 2, pid).features, 16
            )[0]
            for pid in range(2)
        ]
    )
    thr = merge_threshold_candidates(cand)
    tr = TrainData.build(full, 16, thresholds=thr)
    lm = LambdaMart(ntrees=3, nleaves=4, nthresholds=16, seed=0)
    return lm.learn(tr, None, Ndcg(10), verbose=False)


def test_two_process_training_matches_single(tmp_path):
    mh = _run_workers(tmp_path, "1d")
    h1 = _single_process_oracle()
    # identical thresholds -> only psum f32 reorder noise remains
    np.testing.assert_allclose(mh["train"], h1["train"], atol=6e-3)


def test_two_process_dart_matches_single(tmp_path):
    """DART across 2 processes, long enough (13 iters) that the periodic
    full rescore fires under process_count() == 2 — pinning the r5 gating
    that keeps host-built QS tables out of multihost jits (advisor r4)."""
    mh = _run_workers(tmp_path, "dart")
    h1 = _single_process_dart_oracle()
    np.testing.assert_allclose(mh["train"], h1["train"], atol=6e-3)


def test_two_process_2d_mesh_matches_single(tmp_path):
    """2 processes x (data=2, feat=2) mesh: the one multi-host path the
    1-D test doesn't touch — feature-sharded binned/threshold assembly +
    the per-leaf candidate all_gather riding intra-process devices."""
    mh = _run_workers(tmp_path, "2d")
    h1 = _single_process_oracle()
    np.testing.assert_allclose(mh["train"], h1["train"], atol=6e-3)
