"""Headline benchmark: scoring throughput + LambdaMART training time.

Prints ONE JSON line.  The headline metric is batched ensemble-scoring
throughput (docs/sec/chip), the counterpart of the reference's quickscore
harness (src/quickscore.cc:96-121); ``vs_baseline`` compares against the
same-shape 1000-tree / depth-4 model scored by the reference's own generated-C
oblivious path compiled with its release flags (-O3 -march=native) on this
host — reproduce the constant with ``python scripts/c_baseline.py`` (same
model seed/shapes, serial scoring loop like quickscore.cc:100-106).

The ``extra`` object carries the training-time metric BASELINE.json names:
steady-state LambdaMART seconds/tree at MSLR-WEB30K scale (2.6M docs, 136
features, 255 bins, 16 leaves, NDCG@10), for both reference-faithful
best-first growth and the level-wise mode.  Steady state = MEDIAN
per-iteration wall time over iterations 4+ (iteration 0 carries the jit
compile), with the min and the raw tail reported alongside for variance
accounting.

Env knobs: QRTPU_BENCH_TRAIN=0 skips the training section;
QRTPU_BENCH_TRAIN_QUERIES overrides the query count (default 19000).

Needs a GPU: without one it exits with an error (no CPU fallback).
Secondary diagnostics go to stderr.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

# Fallback when the live measurement below fails (recorded once via
# scripts/c_baseline.py on an r1 bench host).  vs_baseline is normally
# computed against a LIVE same-host run of the reference-style compiled-C
# oblivious scorer (same 1000-tree model, single thread) because these VM
# hosts vary round to round (observed 205k-297k docs/s for identical code).
BASELINE_DOCS_PER_SEC = 296996.0


def measure_c_baseline() -> float:
    try:
        sys.path.insert(
            0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")
        )
        import c_baseline

        v = c_baseline.measure(docs=20000, rounds=5)
        log(f"# live C baseline: {v:,.0f} docs/s single-thread")
        return v
    except Exception as e:  # noqa: BLE001 — any toolchain failure
        log(f"# C baseline measurement failed ({e}); using recorded constant")
        return BASELINE_DOCS_PER_SEC


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _time_device_scorer(model, ds, rounds=10, repeats=3):
    """(median, min) seconds per scoring round through the learner's
    device scorer (the dispatch Mart.score_dataset uses), features
    uploaded once, rounds chained through an accumulator so none can be
    elided."""
    fn, X = model.device_scorer(ds)
    step = jax.jit(lambda acc, x: acc + fn(x))
    acc = jnp.zeros((X.shape[0],), jnp.float32)
    for _ in range(5):  # compile + warm
        acc = step(acc, X)
    jax.block_until_ready(acc)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(rounds):
            acc = step(acc, X)
        jax.block_until_ready(acc)
        times.append((time.perf_counter() - t0) / rounds)
    s = float(acc[0])
    if not np.isfinite(s):  # explicit: must survive python -O (no assert)
        raise RuntimeError(f"scoring bench produced non-finite sum {s}")
    return float(np.median(times)), float(min(times))


def _scoring_dataset(N, F, seed):
    from quickrank_tpu.data.dataset import Dataset

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, F), dtype=np.float32)
    return Dataset.from_arrays(X, np.zeros(N, np.float32), np.arange(N) // 100)


def bench_scoring() -> tuple:
    """1000-tree depth-4 oblivious model (the reference's own headline
    scoring strategy, generate_oblivious.cc / IPM'16) through
    ObliviousLambdaMart's device scorer."""
    from quickrank_tpu.learning import ObliviousLambdaMart
    from quickrank_tpu.trees.random_ensemble import random_balanced_ensemble

    N, F, T, DEPTH = 1 << 17, 136, 1000, 4
    dense = random_balanced_ensemble(T, DEPTH, F, seed=0)
    feat = np.asarray(dense.feature).copy()
    thr = np.asarray(dense.threshold).copy()
    for d in range(DEPTH):  # one (feature, threshold) per level
        lvl = slice(2**d - 1, 2 ** (d + 1) - 1)
        feat[:, lvl] = feat[:, 2**d - 1][:, None]
        thr[:, lvl] = thr[:, 2**d - 1][:, None]
    om = ObliviousLambdaMart(treedepth=DEPTH)
    om.ensemble = dense.replace(feature=jnp.asarray(feat), threshold=jnp.asarray(thr))
    dt_med, dt_min = _time_device_scorer(om, _scoring_dataset(N, F, 0))
    docs_per_sec = N / dt_med
    log(
        f"# scored {N} docs x {T} oblivious trees: median {dt_med * 1e3:.2f} / "
        f"min {dt_min * 1e3:.2f} ms/round -> {docs_per_sec:,.0f} docs/s"
    )
    return docs_per_sec, N / dt_min


def bench_deep_scoring() -> float:
    """ANY-depth model scoring through LambdaMart's device scorer (QS
    bitvector tables, trees/qs.py): 1000 best-first-shaped 16-leaf trees,
    depth up to 15 — the DEFAULT grower's output shape."""
    from quickrank_tpu.learning import LambdaMart
    from quickrank_tpu.trees.random_ensemble import random_bestfirst_ensemble

    N, F, T = 1 << 17, 136, 1000
    lm = LambdaMart(nleaves=16)
    lm.ensemble = random_bestfirst_ensemble(T, 16, F, seed=5)
    dt, _ = _time_device_scorer(lm, _scoring_dataset(N, F, 1), rounds=8)
    log(
        f"# deep-scored {N} docs x {T} depth<=15 trees: median "
        f"{dt * 1e3:.2f} ms/round -> {N / dt:,.0f} docs/s"
    )
    return N / dt


def bench_training() -> dict:
    from quickrank_tpu.data.synthetic import make_timing_dataset
    from quickrank_tpu.learning.lambdamart import LambdaMart
    from quickrank_tpu.metrics.metrics import Ndcg

    num_queries = int(os.environ.get("QRTPU_BENCH_TRAIN_QUERIES", 19000))
    t0 = time.perf_counter()
    train = make_timing_dataset(num_queries)
    gen_s = time.perf_counter() - t0
    log(
        f"# training bench: {train.num_docs} docs / {train.num_queries} "
        f"queries generated in {gen_s:.1f}s"
    )

    out: dict = {"train_docs": train.num_docs, "train_queries": train.num_queries}
    # Iteration 0 carries the jit compile — steady state is the MEDIAN of
    # iterations 4+, with min, p90 and the raw tail kept for variance
    # accounting.  Best-first gets a >= 30-iteration steady window: its
    # per-tree cost has heavy split-count variance.  The 255-bin rows are
    # the default configuration; the @63 rows the level-wise/best-k
    # configuration at 63 bins.
    for growth, nthr, ntrees in (
        ("level", 255, 12), ("bestk", 255, 16), ("best", 255, 34),
        ("level", 63, 16), ("bestk", 63, 16),
    ):
        tag = growth if nthr == 255 else f"{growth}{nthr}"
        lm = LambdaMart(
            ntrees=ntrees, nleaves=16, shrinkage=0.1, nthresholds=nthr,
            growth=growth, seed=1, max_depth=4 if growth == "level" else 0,
        )
        t0 = time.perf_counter()
        hist = lm.learn(train, None, Ndcg(10), verbose=False)
        total = time.perf_counter() - t0
        iters = hist["iter_seconds"]
        tail = iters[4:] if len(iters) > 4 else iters[-1:]
        steady = float(np.median(tail))
        out[f"lambdamart_train_seconds_per_tree_{tag}"] = steady
        out[f"lambdamart_train_seconds_per_tree_{tag}_min"] = float(
            min(tail)
        )
        out[f"lambdamart_train_seconds_per_tree_{tag}_p90"] = float(
            np.percentile(tail, 90)
        )
        out[f"lambdamart_train_iters_{tag}"] = [round(x, 4) for x in tail]
        out[f"lambdamart_train_docs_per_sec_{tag}"] = train.num_docs / steady
        log(
            f"# {tag}-growth: init {hist['init_seconds']:.1f}s, "
            f"compile-iter {iters[0]:.1f}s, steady median {steady:.3f} / min "
            f"{min(tail):.3f} / p90 "
            f"{np.percentile(tail, 90):.3f} s/tree ({total:.1f}s total for "
            f"{ntrees} trees)"
        )

    # DART per-iteration cost at the same MSLR-scale workload.  The
    # delta-scan pad ladder is pre-compiled at learn() entry
    # (learning/dart.py), so this window holds no pad-doubling recompiles;
    # 22 iterations also cover a periodic-rescore cycle.
    if os.environ.get("QRTPU_BENCH_DART", "1") != "0":
        from quickrank_tpu.learning.dart import Dart

        d = Dart(
            ntrees=22, nleaves=16, shrinkage=0.1, nthresholds=255,
            rate_drop=0.1, seed=1, esr=0,
        )
        hist = d.learn(train, None, Ndcg(10), verbose=False)
        it = np.asarray(hist["iter_seconds"])
        tail = it[4:]
        out["dart_seconds_per_iter"] = float(np.median(tail))
        out["dart_seconds_per_iter_p90"] = float(np.percentile(tail, 90))
        out["dart_iters"] = [round(float(x), 4) for x in tail]
        log(
            f"# dart: compile-iter {it[0]:.1f}s, steady median "
            f"{out['dart_seconds_per_iter']:.3f} / p90 "
            f"{out['dart_seconds_per_iter_p90']:.3f} s/iter"
        )

    # Reference-style multi-core C TRAINING baseline at the same workload
    # shape (scripts/c_train_baseline.c: OpenMP-over-features cumulative
    # histograms + sibling subtraction + max-deviance best-first; excludes
    # the reference's metric/lambda cost, so the ratio is conservative).
    if os.environ.get("QRTPU_BENCH_TRAINBASE", "1") != "0":
        try:
            sys.path.insert(
                0,
                os.path.join(
                    os.path.dirname(os.path.abspath(__file__)), "scripts"
                ),
            )
            import c_train_baseline

            cb = c_train_baseline.measure(docs=train.num_docs, trees=6)
            out["c_baseline_train_s_per_tree"] = cb["mean_s_per_tree"]
            out["c_baseline_train_threads"] = cb["threads"]
            best_ours = min(
                v for k, v in out.items()
                if k.startswith("lambdamart_train_seconds_per_tree_")
                and k.endswith(("_level", "_best", "_bestk"))
            )
            out["train_vs_baseline"] = cb["mean_s_per_tree"] / best_ours
            out["train_vs_baseline_best"] = (
                cb["mean_s_per_tree"]
                / out["lambdamart_train_seconds_per_tree_best"]
            )
            log(
                f"# C train baseline: {cb['mean_s_per_tree']:.3f} s/tree "
                f"({cb['threads']} threads) -> "
                f"{out['train_vs_baseline']:.1f}x ours"
            )
            # 63-bin head-to-head: the C trainer re-run with 63-bin
            # histograms (its scatter fill is bin-count independent, so
            # this mostly re-times the gain scan) vs our fastest @63 row
            best63 = min(
                (v for k, v in out.items()
                 if k.startswith("lambdamart_train_seconds_per_tree_")
                 and k.endswith(("_level63", "_bestk63"))), default=None
            )
            if best63:
                # 64 = 63 thresholds + the FLT_MAX sentinel bin, matching
                # the JAX run's effective num_bins (the 255-bin row's
                # default of 256 follows the same rule)
                cb63 = c_train_baseline.measure(
                    docs=train.num_docs, trees=6, bins=64
                )
                out["c_baseline_train_s_per_tree_63"] = cb63["mean_s_per_tree"]
                out["train_vs_baseline_63"] = (
                    cb63["mean_s_per_tree"] / best63
                )
                log(
                    f"# C train baseline @63 bins: "
                    f"{cb63['mean_s_per_tree']:.3f} s/tree -> "
                    f"{out['train_vs_baseline_63']:.1f}x ours"
                )
        except Exception as e:  # noqa: BLE001 — toolchain failure
            log(f"# C train baseline failed ({e}); omitting train_vs_baseline")
    return out


def main():
    # Persistent compile cache, by the same rule as the CLIs.
    from quickrank_tpu.utils.backend import enable_compile_cache

    enable_compile_cache()
    # measure the compiled-C comparison point first (pure host, no jax
    # backend touched — build_model uses numpy only)
    baseline = measure_c_baseline()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX finds {dev}")
    log(f"# device: {dev.platform} {dev.device_kind}")

    docs_per_sec, docs_per_sec_min = bench_scoring()

    extra: dict = {}
    if os.environ.get("QRTPU_BENCH_TRAIN", "1") != "0":
        extra = bench_training()
    extra["scoring_docs_per_sec_min_of_3"] = docs_per_sec_min
    if os.environ.get("QRTPU_BENCH_DEEP", "1") != "0":
        extra["deep_scoring_docs_per_sec"] = bench_deep_scoring()
        try:
            import c_baseline

            cb_deep = c_baseline.measure_deep(docs=20000, rounds=5)
            extra["c_baseline_deep_docs_per_sec"] = cb_deep
            extra["deep_vs_baseline"] = (
                extra["deep_scoring_docs_per_sec"] / cb_deep
            )
            log(
                f"# deep C baseline (condop, single thread): {cb_deep:,.0f} "
                f"docs/s -> {extra['deep_vs_baseline']:.1f}x ours"
            )
        except Exception as e:  # noqa: BLE001 — toolchain failure
            log(f"# deep C baseline failed ({e}); omitting deep_vs_baseline")
    extra["c_baseline_docs_per_sec"] = baseline
    extra["device"] = f"{dev.platform}:{dev.device_kind}"

    print(
        json.dumps(
            {
                "metric": "ensemble_scoring_throughput_1000tree",
                "value": docs_per_sec,
                "unit": "docs/sec/device",
                "vs_baseline": docs_per_sec / baseline,
                "extra": extra,
            }
        )
    )


if __name__ == "__main__":
    main()
