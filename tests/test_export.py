"""AOT scorer export (io/export.py) — the counterpart of the
reference's code generators (SURVEY §2.2): export -> deserialize -> call
must reproduce the model's scores without the model object, across batch
sizes (symbolic batch dim), for tree ensembles and linear models."""

import numpy as np
import pytest

from quickrank_tpu.io.export import export_scorer, load_scorer, _model_num_features
from quickrank_tpu.learning.factory import ltr_algorithm_factory
from quickrank_tpu.metrics import metric_factory


@pytest.fixture(scope="module")
def trained_mart(splits):
    train, valid, _ = splits
    algo = ltr_algorithm_factory(
        "MART", ntrees=5, nleaves=4, shrinkage=0.3, nthresholds=16
    )
    algo.learn(train, valid, metric=metric_factory("NDCG@10"), verbose=False)
    return algo


def test_export_tree_scorer_roundtrip(trained_mart, splits, tmp_path):
    _, _, test = splits
    model = trained_mart
    F = _model_num_features(model)
    assert 1 <= F <= test.num_features

    path = str(tmp_path / "scorer.shlo")
    blob = export_scorer(model, path=path)
    assert len(blob) > 0

    scorer = load_scorer(path)
    X = test.features[:, :F].astype(np.float32)
    got = scorer(X)
    ref = np.asarray(model.score_dataset(test))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)

    # symbolic batch: any other batch size runs through the same artifact
    got_small = scorer(X[:7])
    np.testing.assert_allclose(got_small, ref[:7], rtol=1e-5, atol=1e-5)


def test_export_linear_scorer_roundtrip(splits, tmp_path):
    train, valid, test = splits
    algo = ltr_algorithm_factory("COORDASC", max_iterations=2, num_samples=5)
    algo.learn(train, valid, metric=metric_factory("NDCG@10"), verbose=False)
    blob = export_scorer(algo)
    scorer = load_scorer(blob)
    got = scorer(test.features.astype(np.float32))
    ref = np.asarray(algo.score_dataset(test))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_export_rankboost_scorer_roundtrip(splits, tmp_path):
    train, valid, test = splits
    algo = ltr_algorithm_factory("RANKBOOST", ntrees=4, nthresholds=16)
    algo.learn(train, valid, metric=metric_factory("NDCG@10"), verbose=False)
    scorer = load_scorer(export_scorer(algo))
    F = _model_num_features(algo)
    got = scorer(test.features[:, :F].astype(np.float32))
    ref = np.asarray(algo.score_dataset(test))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_cli_generator_stablehlo(trained_mart, splits, tmp_path):
    """--generator stablehlo through the driver writes a loadable artifact
    (the codegen phase of driver.cc:199-223 with the AOT backend)."""
    from quickrank_tpu.cli import main

    _, _, test = splits
    model_path = str(tmp_path / "m.xml")
    trained_mart.save(model_path)
    art = str(tmp_path / "scorer.shlo")
    rc = main(
        ["--model-file", model_path, "--code-file", art,
         "--generator", "stablehlo", "--quiet"]
    )
    assert rc == 0
    scorer = load_scorer(art)
    F = _model_num_features(trained_mart)
    got = scorer(test.features[:, :F].astype(np.float32))
    # the XML round-trip quantizes thresholds to 9 significant digits;
    # scores must still match closely
    ref = np.asarray(trained_mart.score_dataset(test))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_exported_artifact_needs_only_jax(trained_mart, tmp_path):
    """The serving contract: a fresh process with only jax (no
    quickrank_tpu import) deserializes and calls the artifact."""
    import subprocess
    import sys

    path = str(tmp_path / "scorer.shlo")
    export_scorer(trained_mart, path=path)
    F = _model_num_features(trained_mart)
    code = (
        "import os\n"
        "os.environ['XLA_FLAGS'] = os.environ.get('XLA_FLAGS','') "
        "+ ' --xla_force_host_platform_device_count=1'\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from jax import export\n"
        "import numpy as np\n"
        f"exp = export.deserialize(open({path!r}, 'rb').read())\n"
        f"out = np.asarray(exp.call(np.zeros((3, {F}), np.float32)))\n"
        "assert out.shape == (3,) and np.isfinite(out).all()\n"
        "print('SERVE-OK')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "SERVE-OK" in r.stdout


def test_export_rejects_too_narrow_num_features(trained_mart):
    """A num_features below the model's max used feature id must raise —
    under jit the OOB gathers would clamp and return wrong scores."""
    F = _model_num_features(trained_mart)
    if F < 2:
        pytest.skip("model uses only feature 0")
    with pytest.raises(ValueError, match="narrower"):
        export_scorer(trained_mart, num_features=F - 1)


def test_export_untrained_rankboost_raises_cleanly():
    from quickrank_tpu.learning.rankboost import RankBoost

    with pytest.raises(RuntimeError, match="no trained model"):
        export_scorer(RankBoost())
