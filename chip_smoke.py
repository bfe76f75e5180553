"""Smoke test of quickrank_tpu on an NVIDIA GPU (built for one H100).

    python chip_smoke.py              # one card
    python chip_smoke.py --cards 4    # the sharded path over four cards only

One card: LambdaMART trains through the learner API at MSLR-WEB30K width
(136 features, queries of 38-232 docs, ~2.56M docs from 19,000 queries,
random data from a seed) with the best-first, best-k and level-wise
growers; a short CLI run trains, saves, reloads and tests an XML model;
then every correctness check runs against a plain reference: the GPU
histogram kernel against an f64 numpy histogram, a GPU training run
against the same run on the CPU, and 1000-tree oblivious and best-first
scorers against a host tree walk.  ``--cards 4`` runs only sharded
LambdaMART and mesh-fanned scoring on a 1-D mesh of four cards against
the single-card run.

Every phase prints its numbers with the tolerance it is held to; any
failure ends the script with a non-zero exit before the last line.  The
last line is one JSON object: ``{"ok": true, "device": {...}}``.  Without
a GPU the script fails at once and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

T_START = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:8.1f}s] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")
    log(f"ok: {what}")


def device_phase(cards: int):
    import jax
    import jax.extend.backend

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"FAILED: JAX finds no GPU (devices: {devs}); this smoke test "
            "measures the card and has no CPU fallback"
        )
    if len(devs) < cards:
        raise SystemExit(f"FAILED: --cards {cards} but JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    backend = jax.extend.backend.get_backend()
    log(f"jax {jax.__version__}, {backend.platform_version}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"devices: {[d.device_kind for d in devs]}")
    from quickrank_tpu.utils.backend import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    return devs


def train_growers(train, Ndcg, LambdaMart):
    """LambdaMART at MSLR width with each grower; per-tree seconds."""
    runs = (("best", 255, 7), ("bestk", 255, 7), ("level", 63, 7))
    for growth, bins, ntrees in runs:
        lm = LambdaMart(
            ntrees=ntrees, nleaves=16, shrinkage=0.1, nthresholds=bins,
            growth=growth, seed=1, esr=0,
        )
        h = lm.learn(train, None, Ndcg(10), verbose=False)
        it = h["iter_seconds"]
        steady = float(np.median(it[2:]))
        log(
            f"train {growth}@{bins}: set-up (bin+build) {h['init_seconds']:.2f}s, "
            f"first tree (compile) {it[0]:.2f}s, steady median {steady:.4f} "
            f"s/tree (trees 3..{ntrees}: {[round(x, 4) for x in it[2:]]}), "
            f"{train.num_docs / steady:,.0f} docs/s, "
            f"train NDCG@10 {h['train'][0]:.4f} -> {h['train'][-1]:.4f}"
        )
        check(
            np.isfinite(h["train"]).all() and h["train"][-1] > 0.0,
            f"{growth}@{bins} trains with finite NDCG",
        )


def cli_phase():
    """Train, save, reload and test through the CLI entry point (in this
    process: one process per card)."""
    from quickrank_tpu import cli
    from quickrank_tpu.data.svml import read_svml, write_svml
    from quickrank_tpu.data.synthetic import make_train_valid_test

    with tempfile.TemporaryDirectory() as d:
        names = ("train", "valid", "test")
        for name, ds in zip(names, make_train_valid_test((200, 60, 60), seed=3)):
            write_svml(ds, os.path.join(d, f"{name}.svml"))
        model = os.path.join(d, "lm.xml")
        t = time.perf_counter()
        rc = cli.main([
            "--algo", "LAMBDAMART", "--train", f"{d}/train.svml",
            "--valid", f"{d}/valid.svml", "--test", f"{d}/test.svml",
            "--model-out", model, "--num-trees", "20", "--num-leaves", "8",
            "--quiet",
        ])
        check(rc == 0 and os.path.exists(model), "CLI trains and saves XML")
        log(f"CLI train + save: {time.perf_counter() - t:.1f}s")
        rc = cli.main(["--model-in", model, "--test", f"{d}/test.svml",
                       "--quiet", "--scores", f"{d}/scores.txt"])
        check(rc == 0, "CLI reloads the XML and tests it")
        from quickrank_tpu.learning.base import LTRAlgorithm
        from quickrank_tpu.metrics.metrics import Ndcg

        test = read_svml(f"{d}/test.svml")
        lm = LTRAlgorithm.load(model)
        cli_scores = np.loadtxt(f"{d}/scores.txt", dtype=np.float64)
        api = lm.score_dataset(test).astype(np.float64)
        err = float(np.max(np.abs(cli_scores - api)))
        check(err <= 1e-6, f"CLI scores == reloaded-model scores (max err {err:.2e}, tol 1e-6: %.9g text)")
        log(f"reloaded model test NDCG@10 {lm.evaluate(test, Ndcg(10)):.4f}")


def histogram_phase(rng, N=2_560_000):
    """GPU kernel (through the dispatch) vs f64 numpy at MSLR width, and
    kernel vs XLA scatter time per pass."""
    import jax

    from quickrank_tpu.ops import histogram as H

    F = 136
    for B, C, k in ((255, 3, 4), (63, 3, 16)):
        binned_h = rng.integers(0, B + 1, size=(N, F), dtype=np.uint8)  # B = dropped
        vals_h = rng.normal(size=(N, C)).astype(np.float32)
        vals_h[:, 0] = 1.0
        vals_h[rng.random(N) < 0.1] = 0.0  # masked docs
        pos_h = rng.integers(-1, k + 1, size=N).astype(np.int32)
        binned, vals, pos = (jax.device_put(x) for x in (binned_h, vals_h, pos_h))
        nodes = jax.jit(
            lambda b, v, p: H.node_histograms(
                b, v, p, None, k, B, values_premasked=True
            )
        )
        got = np.asarray(nodes(binned, vals, pos)).astype(np.float64)
        ok = (pos_h >= 0) & (pos_h < k)
        ref = np.zeros((k, F, B, C))
        ref_abs = np.zeros((k, F, B, C))
        v64 = vals_h.astype(np.float64)[ok]
        for f in range(F):
            b = binned_h[ok, f].astype(np.int64)
            keep = b < B
            key = pos_h[ok][keep].astype(np.int64) * B + b[keep]
            for c in range(C):
                w = v64[keep, c]
                ref[:, f, :, c] = np.bincount(key, w, k * B).reshape(k, B)
                ref_abs[:, f, :, c] = np.bincount(key, np.abs(w), k * B).reshape(k, B)
        cnt_err = float(np.max(np.abs(got[..., 0] - ref[..., 0])))
        tol = 2.0 ** -16
        rel = float(np.max(np.abs(got[..., 1:] - ref[..., 1:]) / (ref_abs[..., 1:] + 1e-30)))
        log(f"histogram k={k}@{B} bins, C={C}, {N} docs x {F} feats vs f64 numpy: "
            f"count max err {cnt_err} (exact), grad max err / sum|g| {rel:.2e} (tol {tol:.2e})")
        check(cnt_err == 0.0 and rel <= tol, f"histogram k={k}@{B} matches f64 reference")

        def timed(fn, reps):
            out = fn(binned, vals, pos)
            jax.block_until_ready(out)
            t = time.perf_counter()
            for _ in range(reps):
                out = fn(binned, vals, pos)
            jax.block_until_ready(out)
            return (time.perf_counter() - t) / reps * 1e3

        xla = jax.jit(lambda b, v, p: H.histogram_pass_xla(b, v, p, 0, k, B))
        log(f"histogram pass k={k}@{B}: CUDA kernel {timed(nodes, 10):.3f} ms, "
            f"XLA scatter {timed(xla, 3):.3f} ms")
        del binned, vals, pos


def parity_phase(LambdaMart, Ndcg, num_queries=300):
    """A moderate run on the GPU against the same run on the CPU."""
    import jax

    from quickrank_tpu.data.synthetic import make_ranking_dataset

    train = make_ranking_dataset(num_queries=num_queries, seed=5)
    runs = {}
    devices = (("gpu", jax.devices()[0]), ("gpu again", jax.devices()[0]),
               ("cpu", jax.devices("cpu")[0]))
    for name, dev in devices:
        with jax.default_device(dev):
            lm = LambdaMart(ntrees=20, nleaves=16, nthresholds=255, seed=2, esr=0)
            h = lm.learn(train, None, Ndcg(10), verbose=False)
        runs[name] = (h["train"], np.asarray(lm.ensemble.feature),
                      np.asarray(lm.ensemble.threshold_bin),
                      np.asarray(lm.ensemble.is_leaf),
                      np.asarray(lm.ensemble.leaf_value))

    def compare(a, b):
        same = [
            all(np.array_equal(a[i][t], b[i][t]) for i in (1, 2, 3))
            for t in range(len(a[1]))
        ]
        first = same.index(False) if False in same else len(same)
        d = float(np.max(np.abs(np.asarray(a[0]) - np.asarray(b[0]))))
        return same, first, d

    g, c = runs["gpu"], runs["cpu"]
    same, first_diff, d_ndcg = compare(g, c)
    log(f"GPU vs CPU, {train.num_docs} docs, 20 trees: identical split "
        f"structure in {sum(same)}/20 trees (first difference at tree "
        f"{first_diff}); max |train NDCG@10 diff| {d_ndcg:.2e} (tol 2e-3); "
        f"final {g[0][-1]:.6f} vs {c[0][-1]:.6f}")
    check(same[0] and d_ndcg <= 2e-3,
          "GPU training matches CPU training (first tree identical, NDCG within tol)")
    same2, first2, d2 = compare(g, runs["gpu again"])
    bitwise = bool(np.array_equal(g[4], runs["gpu again"][4]))
    log(f"two GPU runs (float atomics add in run-dependent order): identical "
        f"split structure in {sum(same2)}/20 trees (first difference at tree "
        f"{first2}), leaf values bitwise equal: {bitwise}, max |NDCG@10 "
        f"diff| {d2:.2e} (reported, not checked)")


def _host_descent_leaves(X, ens):
    """[N, T] leaf value each doc reaches, by a host walk (rt.cc:330)."""
    feat = np.asarray(ens.feature)
    thr = np.asarray(ens.threshold)
    left = np.asarray(ens.left)
    right = np.asarray(ens.right)
    leaf = np.asarray(ens.is_leaf)
    val = np.asarray(ens.leaf_value)
    T = feat.shape[0]
    N = X.shape[0]
    out = np.empty((N, T), np.float32)
    rows = np.arange(N)
    for t in range(T):
        node = np.zeros(N, np.int64)
        while True:
            live = ~leaf[t, node]
            if not live.any():
                break
            f = np.maximum(feat[t, node], 0)
            nxt = np.where(X[rows, f] <= thr[t, node], left[t, node], right[t, node])
            node = np.where(live, nxt, node)
        out[:, t] = val[t, node]
    return out


def scoring_phase(rng, N=131072):
    """1000-tree oblivious and 16-leaf best-first models at 131,072 docs:
    routing bitwise equal to a host walk, summed scores within f32
    tolerance, and docs/s through the learners' device scorers."""
    import jax
    import jax.numpy as jnp

    from quickrank_tpu.data.dataset import Dataset
    from quickrank_tpu.learning import LambdaMart, ObliviousLambdaMart
    from quickrank_tpu.ops.oblivious import oblivious_leaf_indices
    from quickrank_tpu.trees.qs import partial_scores_qs
    from quickrank_tpu.trees.random_ensemble import (
        random_balanced_ensemble,
        random_bestfirst_ensemble,
    )

    F, T = 136, 1000
    X = rng.standard_normal((N, F), dtype=np.float32)
    ds = Dataset.from_arrays(X, np.zeros(N, np.float32), np.arange(N) // 100)

    def docs_per_s(model):
        fn, Xd = model.device_scorer(ds)
        jax.block_until_ready(fn(Xd))
        t = time.perf_counter()
        for _ in range(5):
            out = fn(Xd)
        jax.block_until_ready(out)
        return N * 5 / (time.perf_counter() - t)

    # best-first shaped 16-leaf trees (depth up to 15), QS tables
    ens = random_bestfirst_ensemble(T, 16, F, seed=5)
    lm = LambdaMart(nleaves=16)
    lm.ensemble = ens
    ref_leaf = _host_descent_leaves(X, ens)
    dev_leaf = np.asarray(partial_scores_qs(jnp.asarray(X), lm._qs_tables()))
    bad = int(np.sum(dev_leaf != ref_leaf))
    log(f"best-first 1000x16 leaves, {N} docs: routing mismatches {bad} of {N * T} (must be 0)")
    check(bad == 0, "QS leaf routing bitwise equals the host walk")
    w = np.asarray(ens.weight, np.float64)
    contrib = ref_leaf.astype(np.float64) * w[None, :]
    ref = contrib.sum(axis=1)
    got = lm.score_dataset(ds).astype(np.float64)
    err = np.abs(got - ref) / np.abs(contrib).sum(axis=1)
    tol = 8 * 2.0 ** -24
    log(f"best-first summed scores: max err / sum|w*leaf| {err.max():.2e} (tol {tol:.2e}, Kahan f32)")
    check(err.max() <= tol, "best-first scores within f32 tolerance")
    log(f"best-first QS scoring: {docs_per_s(lm):,.0f} docs/s")

    # oblivious depth-4 trees
    depth = 4
    dense = random_balanced_ensemble(T, depth, F, seed=6)
    feat = np.asarray(dense.feature).copy()
    thr = np.asarray(dense.threshold).copy()
    for d in range(depth):  # one (feature, threshold) per level
        lvl = slice(2 ** d - 1, 2 ** (d + 1) - 1)
        feat[:, lvl] = feat[:, 2 ** d - 1][:, None]
        thr[:, lvl] = thr[:, 2 ** d - 1][:, None]
    dense = dense.replace(feature=jnp.asarray(feat), threshold=jnp.asarray(thr))
    om = ObliviousLambdaMart(treedepth=depth)
    om.ensemble = dense
    obl = om.oblivious_ensemble()
    fid, othr = np.asarray(obl.fid), np.asarray(obl.thr)
    ref_idx = np.zeros((N, T), np.int32)
    for d in range(depth):
        ref_idx = ref_idx * 2 + (X[:, fid[:, d]] > othr[None, :, d])
    got_idx = np.asarray(oblivious_leaf_indices(jnp.asarray(X), obl))
    bad = int(np.sum(got_idx != ref_idx))
    log(f"oblivious 1000 x depth {depth}, {N} docs: routing mismatches {bad} (must be 0)")
    check(bad == 0, "oblivious leaf routing bitwise equals the host walk")
    leafv = np.asarray(obl.leaf, np.float64)
    contrib = leafv[np.arange(T)[None, :], ref_idx] * np.asarray(obl.weight, np.float64)[None, :]
    ref = contrib.sum(axis=1)
    got = om.score_dataset(ds).astype(np.float64)
    err = np.abs(got - ref) / np.abs(contrib).sum(axis=1)
    tol = T * 2.0 ** -24
    log(f"oblivious summed scores: max err / sum|w*leaf| {err.max():.2e} (tol {tol:.2e}, plain f32 sum of {T} trees)")
    check(err.max() <= tol, "oblivious scores within f32 tolerance")
    log(f"oblivious scoring: {docs_per_s(om):,.0f} docs/s")


def four_card_phase(train, LambdaMart, Ndcg):
    """Sharded LambdaMART and mesh-fanned scoring on four cards against
    the single-card run."""
    import jax
    import jax.numpy as jnp

    from quickrank_tpu.learning.mart import TrainData
    from quickrank_tpu.parallel.mesh import make_mesh, shard_step_data

    mesh = make_mesh(4)
    td = TrainData.build(train, 255, num_shards=4)
    sd = shard_step_data(td.step, mesh)
    spans = {d.id for d in sd.binned.sharding.device_set}
    shard_rows = {s.data.shape for s in sd.binned.addressable_shards}
    log(f"binned {sd.binned.shape} {sd.binned.dtype} sharded over devices "
        f"{sorted(spans)}, shard shapes {shard_rows}")
    check(len(spans) == 4 and len(shard_rows) == 1, "binned tensor spans four cards")
    del td, sd
    with jax.default_device(jax.devices()[0]):
        for growth, bins in (("best", 255), ("level", 63)):
            out = {}
            for name, m in (("1 card", None), ("4 cards", mesh)):
                lm = LambdaMart(ntrees=6, nleaves=16, nthresholds=bins,
                                growth=growth, seed=1, esr=0)
                h = lm.learn(train, None, Ndcg(10), verbose=False, mesh=m)
                it = h["iter_seconds"]
                log(f"{growth}@{bins} {name}: set-up {h['init_seconds']:.2f}s, "
                    f"first tree {it[0]:.2f}s, steady median "
                    f"{np.median(it[2:]):.4f} s/tree, NDCG@10 {h['train'][-1]:.6f}")
                out[name] = (lm, np.asarray(h["train"]))
            a, b = out["1 card"], out["4 cards"]
            same0 = bool(
                np.array_equal(np.asarray(a[0].ensemble.feature[0]),
                               np.asarray(b[0].ensemble.feature[0]))
                and np.array_equal(np.asarray(a[0].ensemble.threshold_bin[0]),
                                   np.asarray(b[0].ensemble.threshold_bin[0]))
            )
            d = float(np.max(np.abs(a[1] - b[1])))
            log(f"{growth}@{bins}: first tree identical {same0}; max |NDCG@10 "
                f"diff| {d:.2e} (tol 2e-3)")
            check(same0 and d <= 2e-3, f"sharded {growth}@{bins} matches one card")
            s1 = a[0].score_dataset(train)
            s4 = a[0].score_dataset(train, mesh=mesh)
            err = float(np.max(np.abs(s1 - s4)))
            log(f"{growth}@{bins}: mesh-fanned scores vs one card, max err {err:.2e} (tol 0: same per-doc program)")
            check(err == 0.0, f"mesh-fanned scoring of the {growth} model matches one card")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cards", type=int, default=1, choices=(1, 4),
                   help="4 runs only the sharded path over four cards")
    args = p.parse_args()

    devs = device_phase(args.cards)
    from quickrank_tpu.data.synthetic import make_timing_dataset
    from quickrank_tpu.learning import LambdaMart
    from quickrank_tpu.metrics.metrics import Ndcg

    t = time.perf_counter()
    train = make_timing_dataset()
    log(f"generated {train.num_docs} docs x {train.num_features} features, "
        f"{train.num_queries} queries in {time.perf_counter() - t:.1f}s")
    rng = np.random.default_rng(0)
    if args.cards == 4:
        four_card_phase(train, LambdaMart, Ndcg)
    else:
        train_growers(train, Ndcg, LambdaMart)
        del train
        cli_phase()
        histogram_phase(rng)
        parity_phase(LambdaMart, Ndcg)
        scoring_phase(rng)
    log("all phases passed")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
