"""Driver — orchestrates training / optimization / testing / codegen.

Counterpart of ``Driver::run`` (src/driver/driver.cc:45-226) and
its phases: build the algorithm (factory, with model-in / restart-train
handling), load datasets, build metrics, train, run the post-learning
optimizer, test (with optional scores file and per-tree detailed output),
and generate standalone scoring code.
"""

from __future__ import annotations

import inspect
import sys
import time
from typing import Optional

import numpy as np

from quickrank_tpu.data.dataset import Dataset, pack_doc_values, shard_and_pad
from quickrank_tpu.data.svml import read_svml, write_svml
from quickrank_tpu.learning.base import LTRAlgorithm
from quickrank_tpu.learning.factory import ltr_algorithm_factory, meta_factory
from quickrank_tpu.metrics.metrics import metric_factory
from quickrank_tpu.optimization.factory import optimization_factory


def load_dataset(path: str, verbose: bool = True) -> Dataset:
    """Driver::load_dataset (driver.cc:387-409)."""
    t0 = time.time()
    ds = read_svml(path)
    if verbose:
        print(
            f"# reading dataset {path}: {ds.num_docs} docs, "
            f"{ds.num_queries} queries, {ds.num_features} features "
            f"({time.time() - t0:.2f} s)"
        )
    return ds


def _read_feature_file(path: str) -> np.ndarray:
    """1-based feature ids, one per line ('#' comments allowed) -> 0-based."""
    ids = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                ids.append(int(line))
    if not ids:
        raise ValueError(f"{path}: empty feature file")
    if min(ids) < 1:
        # '0' is almost always a 0-based/1-based confusion; as a Python
        # index it would silently select the LAST column
        raise ValueError(
            f"{path}: feature ids are 1-based (svml convention); got "
            f"{min(ids)}"
        )
    return np.asarray(sorted(set(ids)), np.int64) - 1


def _select_features(ds: Dataset, keep: np.ndarray) -> Dataset:
    from quickrank_tpu.data.dataset import select_columns

    return select_columns(ds, keep)


def _model_max_feature(algo):
    """Highest feature id a loaded model reads, or None when unknown —
    used to validate --features compatibility (ids are selection-local
    for models trained under --features)."""
    ens = getattr(algo, "ensemble", None)
    if ens is not None and int(getattr(ens, "num_trees", 0) or 0) > 0:
        T = int(ens.num_trees)
        f = np.asarray(ens.feature)[:T]
        leaf = np.asarray(ens.is_leaf)[:T]
        vals = f[(~leaf) & (f >= 0)]
        return int(vals.max()) if vals.size else None
    w = getattr(algo, "best_weights", None)
    if w is not None and len(w):
        return len(w) - 1
    fe = getattr(algo, "features_", None)
    if fe is not None and len(fe):
        return int(np.max(fe))
    return None


def run(params: dict) -> dict:
    """Full pipeline from a flat parameter dict (the pmap equivalent).

    Every phase is wall-clocked into ``results["timings"]`` (the reference's
    std::chrono phase prints, mart.cc:216-258 / driver.cc:239-246), and
    ``trace=DIR`` wraps the training phase in a jax.profiler device trace.
    """
    import contextlib

    from quickrank_tpu.utils.backend import enable_compile_cache
    from quickrank_tpu.utils.profiling import phase_timer, trace

    # persistent jit cache: a second run of the same config skips the
    # growers' compiles
    enable_compile_cache()
    p = params
    results: dict = {}
    timings: dict = {}
    results["timings"] = timings
    verbose = not p.get("quiet", False)

    train_metric = metric_factory(
        p.get("train_metric", "NDCG"), p.get("train_cutoff", 10)
    )
    test_metric = metric_factory(
        p.get("test_metric", "NDCG"), p.get("test_cutoff", 10)
    )

    rest = {
        k: v
        for k, v in p.items()
        if k not in ("algo", "model_in", "restart_train")
    }
    algo = ltr_algorithm_factory(
        algo=p.get("algo", "LAMBDAMART"),
        model_in=p.get("model_in"),
        restart_train=p.get("restart_train", False),
        **rest,
    )

    meta_algo = p.get("meta_algo")
    optimizer = None
    if p.get("opt_model") and not p.get("opt_algo") and not meta_algo:
        # --opt-model doubles as the optimizer-model INPUT when no --opt-algo
        # asks for a fresh search (optimization_factory.cc:85-92)
        import os

        from quickrank_tpu.optimization.cleaver import Cleaver

        if os.path.exists(p["opt_model"]):
            optimizer = Cleaver.load(p["opt_model"])
            if verbose:
                print(f"# optimizer model loaded from {p['opt_model']}")
    if optimizer is None and (p.get("opt_algo") or meta_algo):
        optimizer = optimization_factory(
            opt_algo=p.get("opt_algo", "EPRUNING"),
            opt_method=p.get("opt_method", "QUALITY_LOSS"),
            # 0.5 = the CLI/reference default (prune half the ensemble);
            # a 1.0 default would mean "prune exactly ONE tree" under the
            # count semantics of rates >= 1
            pruning_rate=p.get("pruning_rate", 0.5),
            with_line_search=p.get("with_line_search", False)
            or bool(p.get("line_search_model")),
            line_search_kwargs=dict(
                num_points=p.get("num_samples", 21),
                window_size=p.get("window_size", 10.0),
                reduction_factor=p.get("reduction_factor", 0.95),
                max_iterations=p.get("max_iterations", 100),
                max_failed_vali=p.get("max_failed_valid", 20),
                adaptive=p.get("adaptive", False),
            ),
            seed=p.get("seed", 0),
        )
        if p.get("line_search_model") and optimizer.line_search is not None:
            loaded_ls = LTRAlgorithm.load(p["line_search_model"])
            optimizer.line_search = loaded_ls

    if meta_algo:
        meta_params = {k: v for k, v in p.items() if k != "meta_algo"}
        algo = meta_factory(meta_algo, algo, optimizer, **meta_params)
        optimizer = None  # consumed by the meta algorithm

    # -- datasets ------------------------------------------------------------
    train = valid = test = None
    with phase_timer("load-data", sink=timings, verbose=False):
        if p.get("train"):
            train = load_dataset(p["train"], verbose)
        if p.get("valid"):
            valid = load_dataset(p["valid"], verbose)
        if p.get("test"):
            test = load_dataset(p["test"], verbose)
    if p.get("features"):
        # Restrict every split to the listed feature columns (quicklearn
        # declares --features, quicklearn.cc:197, but leaves the filtering
        # TODO in driver.cc:110 — implemented here).
        keep = _read_feature_file(p["features"])
        if p.get("model_in"):
            # a loaded model is compatible with --features only when it
            # was trained under the SAME selection (its split ids are
            # compacted to 0..K-1 at train time).  A model referencing
            # ids >= len(keep) was trained on a wider space and column
            # compaction would silently misroute every split (jit's
            # out-of-range gathers clamp — wrong metrics, no error).
            needed = _model_max_feature(algo)
            if needed is not None and needed >= len(keep):
                raise SystemExit(
                    f"--features: the loaded model references feature id "
                    f"{needed} but only {len(keep)} columns are selected — "
                    "it was not trained under this feature selection"
                )
        train, valid, test = (
            _select_features(ds, keep) if ds is not None else None
            for ds in (train, valid, test)
        )
        if verbose:
            print(f"# restricted to {len(keep)} features from {p['features']}")

    # -- device mesh (shared by training + optimization) ----------------------
    mesh = None
    nfs = int(p.get("num_feat_shards", 0) or 0)
    if nfs > 1:
        # 2-D (data x feature) mesh: validate excluded combinations up
        # front with actionable messages (quicklearn rejects bad flag
        # combinations at parse time, src/quicklearn.cc:142-504); the
        # matrix lives in PARITY.md "known exclusions".
        algo_name = str(p.get("algo", "LAMBDAMART")).upper()
        no_2d = ("RANKBOOST", "COORDASC", "LINESEARCH")
        if algo_name in no_2d:
            raise SystemExit(
                f"--num-feat-shards: {algo_name} supports 1-D (data) "
                "meshes only (PARITY.md known exclusions)"
            )
        if p.get("restart_train"):
            raise SystemExit(
                "--num-feat-shards with --restart-train is not supported "
                "(warm starts need feature-replicated descent; PARITY.md "
                "known exclusions)"
            )
        if float(p.get("collapse_leaves_factor", 0) or 0) > 0:
            raise SystemExit(
                "--num-feat-shards with --collapse-leaves-factor is not "
                "supported (PARITY.md known exclusions)"
            )
        from quickrank_tpu.parallel import make_mesh_2d

        mesh = make_mesh_2d(max(1, int(p.get("num_shards") or 1)), nfs)
    elif p.get("num_shards", 0):
        from quickrank_tpu.parallel import make_mesh

        mesh = make_mesh(int(p["num_shards"]))

    # -- training phase (driver.cc:228-246) ----------------------------------
    # A model loaded via --model-in trains ONLY under --restart-train: the
    # reference driver skips training otherwise (driver.cc: `!pmap.isSet
    # ("model-in") || pmap.isSet("restart-train")`) — without this guard a
    # "--model-in m.xml --train t.svml --opt-model o.xml" invocation would
    # silently retrain from scratch and prune the wrong model.
    if (
        train is not None
        and not p.get("skip_train", False)
        and (not p.get("model_in") or p.get("restart_train"))
    ):
        # Optional kwargs are gated on each learner's signature: quicklearn
        # drives every algorithm through the same flag surface
        # (driver.cc:45-226), but e.g. the linear rankers have no partial
        # saves to do — the flags are inert there, not an error.
        supported = inspect.signature(algo.learn).parameters
        kwargs = {}
        if p.get("partial", 0) and p.get("model_out"):
            kwargs.update(
                partial_save=int(p["partial"]),
                output_basename=str(p["model_out"]).removesuffix(".xml"),
            )
        if p.get("restart_train"):
            kwargs["warm_start"] = True
        if mesh is not None:
            kwargs["mesh"] = mesh
        dropped = [k for k in kwargs if k not in supported]
        for k in dropped:
            kwargs.pop(k)
        if dropped and verbose:
            print(
                f"# note: {type(algo).__name__}.learn has no "
                f"{'/'.join(dropped)} support; ignoring those flags"
            )
        tracer = (
            trace(p["trace"]) if p.get("trace") else contextlib.nullcontext()
        )
        with tracer, phase_timer("train", sink=timings, verbose=False):
            info = algo.learn(
                train, valid, train_metric, verbose=verbose, **kwargs
            )
        if p.get("trace") and verbose:
            print(f"# device trace captured to {p['trace']}")
        results["training"] = info
        if p.get("model_out"):
            algo.save(p["model_out"])
            if verbose:
                print(f"# model saved to {p['model_out']}")

    # -- optimization phase (driver.cc:248-324) ------------------------------
    if optimizer is not None and (
        train is not None or p.get("train_partial")
    ):
        import os

        # Partial-score datasets: load from --train-partial/--valid-partial
        # when the file exists, else extract (and persist when a path is
        # given) — driver.cc:270-298.
        ptrain = pvalid = None
        if optimizer.need_partial_score_dataset():
            tp, vp = p.get("train_partial"), p.get("valid_partial")
            if tp and os.path.exists(tp):
                ptrain = load_dataset(tp, verbose)
            elif train is not None:
                ptrain = optimizer._partial_dataset(algo, train)
                if tp:
                    write_svml(ptrain, tp)
                    if verbose:
                        print(f"# partial train scores saved to {tp}")
            if vp and os.path.exists(vp):
                pvalid = load_dataset(vp, verbose)
            elif valid is not None:
                pvalid = optimizer._partial_dataset(algo, valid)
                if vp:
                    write_svml(pvalid, vp)
                    if verbose:
                        print(f"# partial valid scores saved to {vp}")
        with phase_timer("optimize", sink=timings, verbose=False):
            opt_info = optimizer.optimize(
                algo, train, valid, train_metric, verbose=verbose,
                ptrain=ptrain, pvalid=pvalid, mesh=mesh,
            )
        results["optimization"] = opt_info
        if p.get("opt_model"):
            optimizer.save(p["opt_model"])
            if verbose:
                print(f"# optimizer model saved to {p['opt_model']}")
        # --opt-algo-model: the optimized ranker (--opt-model-out kept as a
        # back-compat alias; falls back to --model-out)
        out = (
            p.get("opt_algo_model")
            or p.get("opt_model_out")
            or p.get("model_out")
        )
        if out:
            algo.save(out)

    # -- testing phase (driver.cc:326-385) -----------------------------------
    if test is not None:
        with phase_timer("test", sink=timings, verbose=False):
            # fan test scoring over the mesh when the scorer supports it
            if mesh is not None and "mesh" in inspect.signature(
                algo.score_dataset
            ).parameters:
                scores = algo.score_dataset(test, mesh=mesh)
            else:
                scores = algo.score_dataset(test)
            padded = shard_and_pad(test)
            m = float(
                test_metric.evaluate_dataset(
                    padded, pack_doc_values(padded, scores)
                )
            )
        results["test_metric"] = m
        if verbose:
            print(f"# {test_metric!r} on test data: {m:.4f}")
        if p.get("scores"):
            np.savetxt(p["scores"], scores, fmt="%.15g")
            if verbose:
                print(f"# scores saved to {p['scores']}")
        if p.get("detailed"):
            # per-tree partial scores as an SVML dataset (driver.cc:336-360)
            P = algo.partial_scores_dataset(test).astype(np.float32)
            qids = np.repeat(test.qids, test.docs_per_query())
            pds = Dataset.from_arrays(P, test.labels, qids)
            write_svml(pds, p["detailed"])
            if verbose:
                print(f"# detailed per-tree scores saved to {p['detailed']}")

    # -- codegen phase (driver.cc:199-223) -----------------------------------
    if p.get("code_file") and p.get("model_file"):
        from quickrank_tpu.io import codegen

        generator = p.get("generator", "condop")
        with phase_timer("codegen", sink=timings, verbose=False):
            model = LTRAlgorithm.load(p["model_file"])
            if generator.lower() == "stablehlo":
                # AOT-compiled artifact instead of C source (io/export.py)
                from quickrank_tpu.io.export import export_scorer

                export_scorer(model, path=p["code_file"])
            else:
                code = codegen.generate(model, generator)
                with open(p["code_file"], "w") as f:
                    f.write(code)
        if verbose:
            print(f"# {generator} code saved to {p['code_file']}")

    if verbose and timings:
        parts = " ".join(f"{k}={v:.2f}s" for k, v in timings.items())
        print(f"# phase timings: {parts}")
    results["algo"] = algo
    return results
