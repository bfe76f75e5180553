"""Steady-state device profile of one LambdaMART training iteration.

Warms the jitted step past compile, wraps a few steady iterations in a
jax.profiler trace, then summarizes where device time goes (top XLA
ops/fusions) — run it before optimizing anything.  Needs a GPU.

Usage:  python scripts/profile_train.py
Env:    QRTPU_PROFILE_QUERIES (default 19000, ~2.56M docs)
        QRTPU_PROFILE_GROWTH  (level|best|bestk, default level)
        QRTPU_PROFILE_BINS    (default 255)
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import sys
import tempfile
import time

import numpy as np
import jax


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from quickrank_tpu.data.synthetic import make_timing_dataset
    from quickrank_tpu.learning.lambdamart import LambdaMart
    from quickrank_tpu.metrics.metrics import Ndcg
    from quickrank_tpu.utils.backend import enable_compile_cache

    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"profile_train.py profiles the GPU; JAX finds {jax.devices()}")
    nq = int(os.environ.get("QRTPU_PROFILE_QUERIES", 19000))
    growth = os.environ.get("QRTPU_PROFILE_GROWTH", "level")
    nthr = int(os.environ.get("QRTPU_PROFILE_BINS", 255))

    t0 = time.perf_counter()
    train = make_timing_dataset(nq)
    log(f"# data: {train.num_docs} docs in {time.perf_counter() - t0:.1f}s")

    warm, traced = 3, 3
    lm = LambdaMart(
        ntrees=warm + traced, nleaves=16, shrinkage=0.1, nthresholds=nthr,
        growth=growth, seed=1, max_depth=4 if growth == "level" else 0,
    )

    tdir = tempfile.mkdtemp(prefix="qrtpu_profile_")
    state = {"m": -1}
    orig_post = lm._post_iteration

    def post(m, improved):
        state["m"] = m
        if m == warm - 1:  # steady state reached -> start capture
            jax.profiler.start_trace(tdir)
        orig_post(m, improved)

    lm._post_iteration = post
    t0 = time.perf_counter()
    hist = lm.learn(train, None, Ndcg(10), verbose=False)
    jax.profiler.stop_trace()
    iters = hist["iter_seconds"]
    log(
        f"# {growth}: compile-iter {iters[0]:.1f}s, steady "
        f"{np.mean(iters[warm:]):.3f} s/tree (traced {traced} iters)"
    )

    path = glob.glob(f"{tdir}/plugins/profile/*/*.trace.json.gz")[0]
    data = json.load(gzip.open(path))
    ev = data["traceEvents"]
    # device events live under pids whose process_name names the device
    dev_pids = set()
    for e in ev:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            name = e.get("args", {}).get("name", "")
            if "/device" in name.lower() or "XLA Op" in name:
                dev_pids.add(e["pid"])
    dur = collections.Counter()
    total = 0.0
    for e in ev:
        if e.get("ph") == "X" and e.get("pid") in dev_pids and "dur" in e:
            dur[e.get("name", "?")] += e["dur"]
            total += e["dur"]
    per_iter = total / 1e6 / traced
    print(f"# device total {total / 1e6:.3f}s over {traced} iters "
          f"({per_iter:.3f} s/iter); trace: {path}")
    for n, d in dur.most_common(30):
        print(f"{d / 1e6 / traced:9.4f}s/iter  {100 * d / total:5.1f}%  {n[:110]}")


if __name__ == "__main__":
    main()
