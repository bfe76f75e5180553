"""Coverage for the remaining algorithm families: RandomForest,
StochasticNegative, Selective, DART/X-DART, RankBoost, CustomLTR,
MetaCleaver, warm starts, and the algorithm factory."""

import numpy as np
import pytest

from quickrank_tpu.learning import (
    CustomLTR,
    Dart,
    LambdaMart,
    LambdaMartSelective,
    LineSearch,
    MetaCleaver,
    RandomForest,
    RankBoost,
    StochasticNegative,
)
from quickrank_tpu.learning.base import LTRAlgorithm
from quickrank_tpu.learning.factory import ltr_algorithm_factory
from quickrank_tpu.metrics import Ndcg
from quickrank_tpu.optimization import Cleaver


def test_random_forest(splits):
    train, valid, test = splits
    rf = RandomForest(
        ntrees=15, nleaves=8, nthresholds=32, subsample=0.6, max_features=0.5,
        seed=1,
    )
    info = rf.learn(train, valid, Ndcg(10), verbose=False)
    assert rf.evaluate(test, Ndcg(10)) >= 0.6


def test_stochastic_negative(splits):
    train, valid, _ = splits
    sn = StochasticNegative(ntrees=12, nleaves=8, nthresholds=32,
                            subsample=0.3, seed=1)
    info = sn.learn(train, valid, Ndcg(10), verbose=False)
    assert info["train"][-1] > info["train"][0]


@pytest.mark.parametrize("neg", ["RATIO", "MUL", "POS"])
def test_selective_strategies(splits, neg):
    train, valid, _ = splits
    sel = LambdaMartSelective(
        ntrees=8, nleaves=8, nthresholds=32, sampling_iterations=2,
        rank_sampling_factor=0.5, random_sampling_factor=0.2,
        adaptive_strategy="RATIO", negative_strategy=neg, seed=1,
    )
    info = sel.learn(train, valid, Ndcg(10), verbose=False)
    assert np.isfinite(info["train"][-1])


def test_dart_default(splits):
    train, valid, test = splits
    d = Dart(ntrees=15, nleaves=8, nthresholds=32, rate_drop=0.15, seed=1)
    info = d.learn(train, valid, Ndcg(10), verbose=False)
    assert int(d.ensemble.num_trees) >= 1
    assert d.evaluate(test, Ndcg(10)) >= 0.55


@pytest.mark.parametrize("growth", ["level", "bestk"])
def test_dart_alternate_growers(splits, growth):
    """DART composes with the level-wise and best-k growers through the
    shared Mart-family dispatch (_fit_and_assign): trains, improves, and
    scores sanely.  The reference only ever grows best-first
    (dart.cc:318-323); growth modes are an extension."""
    train, valid, test = splits
    d = Dart(
        ntrees=12, nleaves=8, nthresholds=32, rate_drop=0.15, seed=1,
        growth=growth, max_depth=3 if growth == "level" else 0,
    )
    info = d.learn(train, valid, Ndcg(10), verbose=False)
    assert int(d.ensemble.num_trees) >= 1
    assert info["train"][-1] > info["train"][0]
    assert d.evaluate(test, Ndcg(10)) >= 0.5


def test_xdart_keep_drop(splits):
    train, valid, _ = splits
    d = Dart(
        ntrees=10, nleaves=8, nthresholds=32, rate_drop=2, keep_drop=True,
        sample_type="WEIGHTED", normalize_type="LINESEARCH",
        adaptive_type="PLUSHALF_RESET_LB1_UB5", seed=1,
    )
    info = d.learn(train, valid, Ndcg(10), verbose=False)
    assert np.isfinite(info["train"][-1])


def test_dart_xml_roundtrip(tmp_path, splits):
    train, valid, test = splits
    d = Dart(ntrees=6, nleaves=8, nthresholds=32, rate_drop=0.2, seed=1)
    d.learn(train, valid, Ndcg(10), verbose=False)
    p = str(tmp_path / "dart.xml")
    d.save(p)
    d2 = LTRAlgorithm.load(p)
    np.testing.assert_allclose(
        d.score_dataset(test), d2.score_dataset(test), rtol=1e-5, atol=1e-6
    )


def test_rankboost(splits):
    train, valid, test = splits
    rb = RankBoost(ntrees=25, nthresholds=64, seed=1)
    info = rb.learn(train, valid, Ndcg(10), verbose=False)
    assert rb.evaluate(test, Ndcg(10)) >= 0.55
    # weak rankers are (feature, theta, alpha) triples; scores must be the
    # alpha-weighted sum of threshold indicators
    s = rb.score_dataset(test)
    bits = (test.features[:, rb.features_] > rb.thetas_[None, :]).astype(float)
    np.testing.assert_allclose(s, bits @ rb.alphas_, rtol=1e-5)


def test_custom_ltr(splits):
    train, valid, _ = splits
    c = CustomLTR()
    c.learn(train, valid, Ndcg(10), verbose=False)
    s = c.score_dataset(train)
    assert (s == CustomLTR.FIXED_SCORE).all()


def test_warm_start_continues(splits):
    train, _, _ = splits
    lm = LambdaMart(ntrees=5, nleaves=8, nthresholds=32, seed=1)
    lm.learn(train, None, Ndcg(10), verbose=False)
    first = int(lm.ensemble.num_trees)
    lm.ntrees = 9
    info = lm.learn(train, None, Ndcg(10), verbose=False, warm_start=True)
    assert first == 5
    assert int(lm.ensemble.num_trees) == 9
    assert len(info["train"]) == 4  # only the new iterations


def test_warm_start_rebins_against_new_tables(splits):
    """Warm starts force-recompute EVERY bin-space split id against the
    resumed run's threshold tables (rebin_ensemble(force=True), r5): an
    in-process model carries bin ids from its training run's tables,
    which silently misroute against a different dataset's quantization
    (XML loads were safe only via the -1 sentinel)."""
    from quickrank_tpu.data.synthetic import make_ranking_dataset
    from quickrank_tpu.learning.mart import rebin_ensemble
    from quickrank_tpu.ops.binning import build_thresholds

    train, _, _ = splits
    lm = LambdaMart(ntrees=4, nleaves=8, nthresholds=32, seed=1)
    lm.learn(train, None, Ndcg(10), verbose=False)
    ens = lm.ensemble

    # a different dataset -> different threshold tables
    other = make_ranking_dataset(num_queries=80, avg_docs_per_query=25,
                                 seed=77)
    thrB, _ = build_thresholds(other.features, 32)

    re = rebin_ensemble(ens, thrB, force=True)
    feat = np.asarray(ens.feature)
    thr = np.asarray(ens.threshold)
    leaf = np.asarray(ens.is_leaf)
    tbin = np.asarray(re.threshold_bin)
    T = int(ens.num_trees)
    checked = 0
    for t in range(T):
        for n in range(ens.max_nodes):
            if leaf[t, n] or feat[t, n] < 0:
                continue
            want = max(int((thrB[feat[t, n]] <= thr[t, n]).sum()) - 1, 0)
            assert tbin[t, n] == want, (t, n, tbin[t, n], want)
            checked += 1
    assert checked > 0

    # same-table recompute is a bitwise no-op (warm start on the same data
    # must stay bit-reproducible); rebuild the run's own tables the same
    # deterministic way TrainData.build does
    thrA, _ = build_thresholds(train.features, 32)
    # TrainData pads the table rows; only real features matter here
    same = rebin_ensemble(ens, thrA, force=True)
    np.testing.assert_array_equal(
        np.asarray(same.threshold_bin)[:T], np.asarray(ens.threshold_bin)[:T]
    )

    # end-to-end: warm-start training on the other dataset stays sane
    lm.ntrees = 8
    info = lm.learn(other, None, Ndcg(10), verbose=False, warm_start=True)
    assert np.isfinite(info["train"]).all()
    assert int(lm.ensemble.num_trees) == 8


def test_meta_cleaver(splits):
    train, valid, test = splits
    algo = LambdaMart(ntrees=8, nleaves=8, nthresholds=32, seed=1)
    cl = Cleaver(
        pruning_method="QUALITY_LOSS", pruning_rate=0.5,
        line_search=LineSearch(max_iterations=3, num_points=10),
    )
    mc = MetaCleaver(algo, cl, final_ntrees=12, ntrees_per_iter=6,
                     pruning_rate_per_iter=0.5, meta_esr=2)
    info = mc.learn(train, valid, Ndcg(10), verbose=False)
    assert info["final_size"] <= 12
    assert mc.evaluate(test, Ndcg(10)) > 0.4


@pytest.mark.parametrize(
    "name",
    [
        "MART", "LAMBDAMART", "OBVMART", "OBVLAMBDAMART", "DART",
        "RANDOMFOREST", "RANKBOOST", "LAMBDAMART-SELECTIVE",
        "STOCHASTIC-NEGATIVE", "COORDASC", "LINESEARCH", "CUSTOM",
    ],
)
def test_factory_constructs_all(name):
    a = ltr_algorithm_factory(name, num_trees=5)
    assert a.NAME == name


def test_partial_saves_and_restart(tmp_path, splits):
    """Periodic partial model saves (<base>.T<k>.xml, mart.cc:378-381) and
    resuming from one (--restart-train semantics)."""
    train, _, _ = splits
    base = str(tmp_path / "model")
    lm = LambdaMart(ntrees=6, nleaves=4, nthresholds=16, seed=1)
    lm.learn(
        train, None, Ndcg(10), verbose=False,
        partial_save=2, output_basename=base,
    )
    import os

    snaps = sorted(p for p in os.listdir(tmp_path) if ".T" in p)
    assert snaps == ["model.T2.xml", "model.T4.xml", "model.T6.xml"]
    partial = LTRAlgorithm.load(str(tmp_path / "model.T4.xml"))
    assert int(partial.ensemble.num_trees) == 4
    # resume to 6 trees from the 4-tree snapshot
    resumed = LambdaMart(ntrees=6, nleaves=4, nthresholds=16, seed=1)
    resumed.ensemble = partial.ensemble
    info = resumed.learn(train, None, Ndcg(10), verbose=False, warm_start=True)
    assert int(resumed.ensemble.num_trees) == 6
    assert len(info["train"]) == 2  # only the resumed iterations


def test_restart_from_xml_matches_uninterrupted(tmp_path, splits):
    """save -> load -> warm restart must CONTINUE identically: loaded trees
    get their bin-space split points rebuilt (rebin_ensemble), so the
    rescoring pass and all later split decisions match the uninterrupted
    run bit-for-bit."""
    train, _, _ = splits
    full = LambdaMart(ntrees=6, nleaves=4, nthresholds=16, seed=1)
    full.learn(train, None, Ndcg(10), verbose=False)

    part = LambdaMart(ntrees=3, nleaves=4, nthresholds=16, seed=1)
    part.learn(train, None, Ndcg(10), verbose=False)
    path = str(tmp_path / "part.xml")
    part.save(path)

    resumed = LambdaMart(ntrees=6, nleaves=4, nthresholds=16, seed=1)
    resumed.ensemble = LTRAlgorithm.load(path).ensemble
    resumed.learn(train, None, Ndcg(10), verbose=False, warm_start=True)

    np.testing.assert_allclose(
        resumed.score_dataset(train), full.score_dataset(train),
        rtol=1e-6, atol=1e-7,
    )


def test_dart_partial_saves_and_resume(tmp_path, splits):
    """DART snapshots (<base>.T<k>.xml) and mid-run resume — the Mart-family
    --partial/--restart-train surface applied to the DART loop."""
    import os

    from quickrank_tpu.learning.dart import Dart

    train, _, _ = splits
    base = str(tmp_path / "dart")
    a = Dart(ntrees=6, nleaves=4, nthresholds=16, seed=3, rate_drop=0.3)
    a.learn(
        train, None, Ndcg(10), verbose=False,
        partial_save=2, output_basename=base,
    )
    snaps = sorted(p for p in os.listdir(tmp_path) if ".T" in p)
    assert snaps, "no DART snapshots written"
    mid = snaps[len(snaps) // 2]
    partial = LTRAlgorithm.load(str(tmp_path / mid))
    assert type(partial) is Dart
    n0 = int(partial.ensemble.num_trees)

    resumed = Dart(ntrees=6, nleaves=4, nthresholds=16, seed=3, rate_drop=0.3)
    resumed.ensemble = partial.ensemble
    info = resumed.learn(train, None, Ndcg(10), verbose=False, warm_start=True)
    # rollback keeps the best model, which is never worse than the imported one
    assert int(resumed.ensemble.num_trees) >= n0
    s = resumed.score_dataset(train)
    assert np.isfinite(s).all()
    assert info["train"], "no resumed iterations recorded"


def test_dart_compaction_protects_best_snapshot():
    """The capacity-guard compaction keeps zero-weighted trees inside the
    protected (best-snapshot) prefix but removes later zero-weight slots,
    preserving slot order so the end-of-training rollback stays valid."""
    from quickrank_tpu.trees.structs import EnsembleTensors, Tree

    cap, T = 8, 6
    ens = EnsembleTensors.empty(cap, 7)
    for t in range(T):
        tree = Tree.empty(7)
        tree = tree.replace(leaf_value=tree.leaf_value.at[0].set(float(t + 1)))
        ens = ens.push(tree, 0.1)
    w_host = np.array([0.3, 0.0, 0.2, 0.0, 0.0, 0.4, 0.0, 0.0], np.float32)
    contributions = [float(i) for i in range(T)]

    # protect=3: slot 1 (zero weight, inside the best prefix) must survive;
    # slots 3 and 4 (zero weight, after the prefix) must be dropped.
    new, contr, w2, T2 = Dart._compact_zero_weights(
        ens, contributions, w_host.copy(), T, protect=3
    )
    assert T2 == 4
    np.testing.assert_allclose(w2[:T2], np.float32([0.3, 0.0, 0.2, 0.4]))
    assert contr == [0.0, 1.0, 2.0, 5.0]
    # tree contents follow their weights (leaf_value marks identity)
    np.testing.assert_array_equal(
        np.asarray(new.leaf_value)[:T2, 0], [1.0, 2.0, 3.0, 6.0]
    )
    assert int(new.num_trees) == 4
    # weights beyond the new count are zeroed on device
    assert float(np.abs(np.asarray(new.weight)[T2:]).max()) == 0.0

    # without protection all zero-weight trees go
    new0, contr0, w0, T0 = Dart._compact_zero_weights(
        ens, contributions, w_host.copy(), T
    )
    assert T0 == 3
    np.testing.assert_allclose(w0[:T0], np.float32([0.3, 0.2, 0.4]))
    np.testing.assert_array_equal(
        np.asarray(new0.leaf_value)[:T0, 0], [1.0, 3.0, 6.0]
    )


def test_feature_importances_splits(splits):
    """Split-count importances: nonnegative, normalized, and dominated by
    the features the synthetic generator actually makes informative."""
    import numpy as np

    from quickrank_tpu.learning import Mart
    from quickrank_tpu.metrics import Ndcg

    train, valid, _ = splits
    m = Mart(ntrees=10, nleaves=8, nthresholds=32, seed=0)
    m.learn(train, valid, Ndcg(10), verbose=False)
    imp = m.feature_importances(num_features=train.num_features)
    assert imp.shape == (train.num_features,)
    assert np.all(imp >= 0) and abs(imp.sum() - 1.0) < 1e-9
    # raw counts must equal the number of internal nodes
    raw = m.feature_importances(num_features=train.num_features,
                                normalize=False)
    ens = m.ensemble
    internal = (~np.asarray(ens.is_leaf)[: int(ens.num_trees)]).sum()
    assert raw.sum() == internal


def test_restart_hyperparameter_mismatch_rejected(tmp_path, splits):
    """--restart-train with mismatched hyperparameters must error up front
    (mart.cc:493-517 + ltr_algorithm_factory.cc:250-258), naming the diff —
    a silent resume with a different shrinkage would corrupt the model."""
    train, _, _ = splits
    part = LambdaMart(ntrees=3, nleaves=4, nthresholds=16, seed=1)
    part.learn(train, None, Ndcg(10), verbose=False)
    path = str(tmp_path / "part.xml")
    part.save(path)

    with pytest.raises(ValueError, match="shrinkage"):
        ltr_algorithm_factory(
            "LAMBDAMART", model_in=path, restart_train=True,
            num_trees=6, num_leaves=4, num_thresholds=16, shrinkage=0.05,
        )
    with pytest.raises(ValueError, match="nleaves"):
        ltr_algorithm_factory(
            "LAMBDAMART", model_in=path, restart_train=True,
            num_trees=6, num_leaves=8, num_thresholds=16,
        )
    # cross-family import is rejected by type (dynamic_cast analog)
    with pytest.raises(ValueError, match="cannot import"):
        ltr_algorithm_factory(
            "COORDASC", model_in=path, restart_train=True,
        )
    # matching hyperparameters load fine and actually resume
    ok = ltr_algorithm_factory(
        "LAMBDAMART", model_in=path, restart_train=True,
        num_trees=6, num_leaves=4, num_thresholds=16,
    )
    info = ok.learn(train, None, Ndcg(10), verbose=False, warm_start=True)
    assert int(ok.ensemble.num_trees) == 6
    assert len(info["train"]) == 3


def test_device_scorer_matches_score_dataset(splits):
    """Mart.device_scorer (the quickscore timing path: pre-uploaded
    features, device-resident fn) must produce exactly score_dataset's
    scores through the same dispatch — for the descent path (CPU) and
    the oblivious override."""
    import jax.numpy as jnp

    from quickrank_tpu.learning.obliviousmart import ObliviousLambdaMart

    train, _, test = splits
    lm = LambdaMart(ntrees=8, nleaves=8, nthresholds=32, seed=1, esr=0)
    lm.learn(train, None, Ndcg(10), verbose=False)
    ref = lm.score_dataset(test)
    fn, X = lm.device_scorer(test)
    np.testing.assert_allclose(np.asarray(fn(X)), ref, rtol=0, atol=0)

    ob = ObliviousLambdaMart(ntrees=6, treedepth=3, nthresholds=32, seed=1,
                             esr=0)
    ob.learn(train, None, Ndcg(10), verbose=False)
    ref = ob.score_dataset(test)
    fn, X = ob.device_scorer(test)
    np.testing.assert_allclose(np.asarray(fn(jnp.asarray(X))), ref,
                               rtol=0, atol=0)


def test_dart_dropout_rounding_matches_reference():
    """dart.cc:1176-1181 semantics: C round() (half AWAY from zero — not
    Python's banker's rounding) and an INTEGER-division half-model cap.
    r5: int(round(2.5)) == 2 and a fractional cap let 3.5 round past
    model_size // 2."""
    import numpy as np

    class _R:  # rng whose skip-draw never skips
        def random(self):
            return 1.0

    d = Dart(ntrees=10, rate_drop=0.1)
    # x = 0.1 * 25 = 2.5 -> C round -> 3 (banker's would give 2)
    assert d._trees_to_dropout(_R(), 25, [0.0], [0.0], -np.inf) == 3
    # cap: x = 0.5 * 7 = 3.5, cap = 7 // 2 = 3 (a fractional 3.5 cap
    # would round to 4 > half the model)
    d2 = Dart(ntrees=10, rate_drop=0.5)
    assert d2._trees_to_dropout(_R(), 7, [0.0], [0.0], -np.inf) == 3


def test_stochastic_negative_xml_roundtrip_keeps_fraction(splits, tmp_path):
    """StochasticNegative reuses the subsample flag as the negative
    fraction (the reference's convention); r5: the base class serialized
    the forced subsample=1.0, so a --restart-train reload silently ran
    as plain LambdaMART."""
    train, _, _ = splits
    sn = StochasticNegative(ntrees=4, nleaves=8, nthresholds=32,
                            subsample=0.3, seed=1)
    sn.learn(train, None, Ndcg(10), verbose=False)
    p = tmp_path / "sn.xml"
    sn.save(str(p))
    loaded = LTRAlgorithm.load(str(p))
    assert isinstance(loaded, StochasticNegative)
    assert abs(loaded.negative_fraction - 0.3) < 1e-9
