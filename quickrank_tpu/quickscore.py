"""quickscore-equivalent batch-scoring micro-benchmark.

Counterpart of the reference's ``quickscore`` binary (src/quickscore.cc:
62-134): loads an SVML dataset and a model, scores every doc ``rounds``
times, and reports total / per-dataset / per-doc timing.  Instead of a
compiled-in ``double ranker(float*)``, scoring runs the batched ensemble
kernels (the oblivious bit-OR fast path when the model is symmetric).

Run: ``python -m quickrank_tpu.quickscore -d data.svml -m model.xml -r 10``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import jax


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="quickscore-tpu")
    p.add_argument("-d", "--dataset", required=True, help="SVML test set")
    p.add_argument("-m", "--model", required=True, help="XML model")
    p.add_argument("-r", "--rounds", type=int, default=10)
    p.add_argument("-s", "--scores", help="optional output scores file")
    p.add_argument("--num-shards", type=int, default=0,
                   help="fan doc rows over this many devices (0 = single)")
    args = p.parse_args(argv)

    from quickrank_tpu.utils.backend import enable_compile_cache

    enable_compile_cache()
    from quickrank_tpu.data.svml import read_svml
    from quickrank_tpu.learning.base import LTRAlgorithm

    ds = read_svml(args.dataset)
    model = LTRAlgorithm.load(args.model)
    print(
        f"#\t Dataset size: {ds.num_docs} x {ds.num_features} "
        f"(instances x features)"
    )
    print(
        f"#\t Num queries: {ds.num_queries} | Avg. len: "
        f"{ds.num_docs // max(ds.num_queries, 1)}"
    )

    import inspect

    kw = {}
    if args.num_shards:
        if "mesh" in inspect.signature(model.score_dataset).parameters:
            from quickrank_tpu.parallel import make_mesh

            kw["mesh"] = make_mesh(args.num_shards)
        else:
            # without this the user reads the reported throughput as
            # N-way-sharded when the model ran single-device
            print(
                f"# WARNING: --num-shards {args.num_shards} ignored — "
                f"{type(model).__name__}.score_dataset has no mesh "
                "support; timing below is SINGLE-device"
            )

    # report which scorer the dispatcher picked (docs/scoring.md)
    if hasattr(model, "oblivious_ensemble"):
        print("#\t Scorer path: oblivious bit-OR level tables")
    elif hasattr(model, "_qs_tables"):
        print("#\t Scorer path: QS bitvector tables (any depth)")

    if not kw and hasattr(model, "device_scorer"):
        # device-resident rounds, reference discipline (quickscore.cc:
        # 100-106 times pure in-memory scoring): features upload once,
        # rounds chain through a data dependency, one scalar fetch syncs at
        # the end.  The old loop re-uploaded features and
        # converted to numpy every round, inflating per-doc time.
        fn, X = model.device_scorer(ds)
        out = fn(X)  # warm-up (includes jit compile)
        # chained [N]-sized accumulator (bench.py's discipline): rounds
        # cannot be elided, the final scalar fetch syncs them, and the
        # per-round dependency costs O(N) on the small output — not an
        # [N, F] feature-array rebuild per round
        acc = out * 0.0
        for _ in range(2):  # burn-in (first timed loop reads inflated)
            acc = acc * 0.5 + fn(X)
        float(acc[0])
        t0 = time.perf_counter()
        for _ in range(args.rounds):
            acc = acc * 0.5 + fn(X)
        float(acc[0])  # sync
        total = time.perf_counter() - t0
        scores = np.asarray(out)
    else:
        scores = model.score_dataset(ds, **kw)  # warm-up (incl. jit compile)
        t0 = time.perf_counter()
        for _ in range(args.rounds):
            scores = model.score_dataset(ds, **kw)
        if hasattr(scores, "block_until_ready"):
            jax.block_until_ready(scores)
        total = time.perf_counter() - t0
    per_dataset = total / args.rounds
    per_doc = per_dataset / ds.num_docs
    print(f"       Total scoring time: {total:.6g} s.")
    print(f"Avg. Dataset scoring time: {per_dataset:.6g} s.")
    print(f"Avg.    Doc. scoring time: {per_doc:.6g} s.")
    if args.scores:
        np.savetxt(args.scores, scores, fmt="%.15g")
    return 0


if __name__ == "__main__":
    sys.exit(main())
