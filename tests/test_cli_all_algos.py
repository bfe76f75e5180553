"""End-to-end CLI coverage: every --algo value trains under DEFAULT flags
(notably --partial's default of 100, which once crashed non-Mart learners),
saves a model, and the model round-trips through XML to produce scores —
the uniform driver surface of quicklearn (src/driver/driver.cc:45-226)."""

import numpy as np
import pytest

from quickrank_tpu.cli import main
from quickrank_tpu.data import write_svml
from quickrank_tpu.learning.base import LTRAlgorithm

ALGOS = [
    "MART",
    "LAMBDAMART",
    "OBVMART",
    "OBVLAMBDAMART",
    "DART",
    "RANKBOOST",
    "RANDOMFOREST",
    "LAMBDAMART-SELECTIVE",
    "STOCHASTIC-NEGATIVE",
    "COORDASC",
    "LINESEARCH",
    "CUSTOM",
]


@pytest.fixture(scope="module")
def svml_dir(tmp_path_factory, splits):
    d = tmp_path_factory.mktemp("e2e")
    train, valid, test = splits
    write_svml(train, str(d / "train.svml"))
    write_svml(valid, str(d / "valid.svml"))
    write_svml(test, str(d / "test.svml"))
    return d


def _run_cli(d, out, extra):
    # NOTE: no --partial escape hatch — the default (100) must be harmless
    # for every learner.
    rc = main(
        [
            "--train", str(d / "train.svml"),
            "--valid", str(d / "valid.svml"),
            "--test", str(d / "test.svml"),
            "--model-out", str(out),
            "--num-trees", "4",
            "--num-leaves", "4",
            "--num-thresholds", "16",
            "--tree-depth", "2",
            "--end-after-rounds", "0",
            "--max-iterations", "3",
            "--num-samples", "6",
            "--quiet",
        ]
        + extra
    )
    assert rc == 0


@pytest.mark.parametrize("growth", ["level", "bestk"])
def test_cli_growth_flag(svml_dir, tmp_path, splits, growth):
    """--growth level/bestk train end-to-end through the CLI and produce
    loadable, scoreable models that remember their grower config."""
    out = tmp_path / f"g_{growth}.xml"
    _run_cli(
        svml_dir, out,
        ["--algo", "LAMBDAMART", "--growth", growth, "--split-pack", "2"],
    )
    loaded = LTRAlgorithm.load(str(out))
    assert loaded.growth == growth
    scores = loaded.score_dataset(splits[2])
    assert np.isfinite(scores).all()


@pytest.mark.parametrize("algo", ALGOS)
def test_cli_trains_all_algos_default_flags(svml_dir, tmp_path, splits, algo):
    out = tmp_path / f"{algo}.xml"
    _run_cli(svml_dir, out, ["--algo", algo])
    assert out.exists()
    loaded = LTRAlgorithm.load(str(out))
    scores = loaded.score_dataset(splits[2])
    assert scores.shape == (splits[2].num_docs,)
    assert np.isfinite(scores).all()


def test_cli_metacleaver_default_flags(svml_dir, tmp_path, splits):
    out = tmp_path / "meta.xml"
    _run_cli(
        svml_dir,
        out,
        [
            "--algo", "LAMBDAMART",
            "--meta-algo", "METACLEAVER",
            "--final-num-trees", "6",
            "--meta-end-after-rounds", "2",
        ],
    )
    assert out.exists()
    loaded = LTRAlgorithm.load(str(out))
    scores = loaded.score_dataset(splits[2])
    assert scores.shape == (splits[2].num_docs,)
    assert np.isfinite(scores).all()


def test_cli_restart_train_non_mart_warns_not_crashes(svml_dir, tmp_path):
    """--restart-train on a learner without warm_start must not crash
    (the flag is reported as unsupported, not forwarded blindly)."""
    out = tmp_path / "ca.xml"
    _run_cli(svml_dir, out, ["--algo", "COORDASC"])
    rc = main(
        [
            "--algo", "COORDASC",
            "--train", str(svml_dir / "train.svml"),
            "--model-in", str(out),
            "--restart-train",
            "--max-iterations", "2",
            "--num-samples", "6",
            "--model-out", str(tmp_path / "ca2.xml"),
            "--quiet",
        ]
    )
    assert rc == 0


def test_cli_features_file_restricts_columns(svml_dir, tmp_path, splits):
    """--features keeps only the listed columns (quicklearn.cc:197; the
    reference left the filtering TODO, driver.cc:108-110)."""
    feats = tmp_path / "feats.txt"
    feats.write_text("1\n3\n5\n7\n# comment\n9\n")
    out = tmp_path / "m.xml"
    rc = main([
        "--algo", "MART", "--train", str(svml_dir / "train.svml"),
        "--num-trees", "3", "--num-leaves", "4", "--num-thresholds", "16",
        "--features", str(feats), "--model-out", str(out), "--quiet",
    ])
    assert rc == 0
    loaded = LTRAlgorithm.load(str(out))
    # the model only references the 5 kept columns (0-based < 5)
    f = np.asarray(loaded.ensemble.feature)
    assert f.max() < 5


def test_cli_features_file_rejects_zero_id(svml_dir, tmp_path):
    """A '0' in a feature file is a 0-based/1-based confusion; as a Python
    index it would silently pick the LAST column — must raise instead."""
    feats = tmp_path / "feats.txt"
    feats.write_text("0\n2\n")
    with pytest.raises(ValueError, match="1-based"):
        main([
            "--algo", "MART", "--train", str(svml_dir / "train.svml"),
            "--num-trees", "2", "--num-leaves", "4",
            "--num-thresholds", "16", "--features", str(feats), "--quiet",
        ])


def test_select_columns_validates_range(splits):
    from quickrank_tpu.data.dataset import select_columns

    train, _, _ = splits
    sub = select_columns(train, np.asarray([0, 2]))
    assert sub.num_features == 2
    np.testing.assert_array_equal(sub.features[:, 1], train.features[:, 2])
    with pytest.raises(ValueError, match="out of range"):
        select_columns(train, np.asarray([train.num_features]))
    with pytest.raises(ValueError, match="out of range"):
        select_columns(train, np.asarray([-1]))


def test_cli_num_shards_matches_single_device(svml_dir, tmp_path, splits):
    """--num-shards N: sharded training AND mesh-fanned test scoring through
    the CLI must reproduce the single-device run (driver mesh threading)."""
    from quickrank_tpu import driver

    def run(extra):
        return driver.run({
            "train": str(svml_dir / "train.svml"),
            "valid": str(svml_dir / "valid.svml"),
            "test": str(svml_dir / "test.svml"),
            "algo": "LAMBDAMART",
            "num_trees": 5, "num_leaves": 4, "num_thresholds": 16,
            "quiet": True, **extra,
        })

    r1 = run({})
    r4 = run({"num_shards": 4})
    assert abs(r1["test_metric"] - r4["test_metric"]) < 1e-3


def test_cli_2d_mesh_trains(svml_dir, tmp_path):
    """--num-shards x --num-feat-shards builds a 2-D mesh from the CLI."""
    out = tmp_path / "lm2d.xml"
    _run_cli(
        svml_dir, out,
        ["--algo", "LAMBDAMART", "--num-shards", "2",
         "--num-feat-shards", "2"],
    )
    assert out.exists()


def test_cli_2d_mesh_trains_dart(svml_dir, tmp_path):
    """DART over the CLI-built 2-D mesh (feature-sharded dropout descent)."""
    out = tmp_path / "dart2d.xml"
    _run_cli(
        svml_dir, out,
        ["--algo", "DART", "--num-shards", "2",
         "--num-feat-shards", "2"],
    )
    assert out.exists()


@pytest.mark.parametrize(
    "algo,extra",
    [
        ("RANKBOOST", []),
        ("COORDASC", []),
        ("LINESEARCH", []),
        ("LAMBDAMART", ["--restart-train"]),
        ("LAMBDAMART", ["--collapse-leaves-factor", "2.0"]),
    ],
)
def test_cli_2d_mesh_exclusions_rejected(svml_dir, tmp_path, algo, extra):
    """Excluded --num-feat-shards combinations fail at flag validation with
    an actionable message, never a NotImplementedError stack trace from
    inside learn() (PARITY.md known exclusions; quicklearn.cc:142-504's
    parse-time rejection discipline)."""
    with pytest.raises(SystemExit) as e:
        _run_cli(
            svml_dir, tmp_path / "x.xml",
            ["--algo", algo, "--num-shards", "2", "--num-feat-shards", "2"]
            + extra,
        )
    assert "PARITY.md" in str(e.value)
