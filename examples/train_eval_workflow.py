"""End-to-end workflow example: train, validate, prune, export, score.

Mirrors the reference's documented quicklearn + quickscore workflow
(documentation/*.md) on a synthetic LETOR-style dataset.  Swap the synthetic
splits for `read_svml("<MSLR fold>/train.txt")` etc. on real data.

Run:  PYTHONPATH=. python examples/train_eval_workflow.py
"""

from quickrank_tpu.data.synthetic import make_train_valid_test
from quickrank_tpu.learning import LambdaMart, LineSearch
from quickrank_tpu.learning.base import LTRAlgorithm
from quickrank_tpu.metrics import Ndcg, metric_factory
from quickrank_tpu.optimization import Cleaver


def main():
    train, valid, test = make_train_valid_test()

    # 1. Train LambdaMART with early stopping on the validation split.
    model = LambdaMart(
        ntrees=150, nleaves=16, shrinkage=0.1, nthresholds=255, esr=50,
        max_depth=5,  # depth cap -> fast traversal-free inference kernel
    )
    model.learn(train, valid, Ndcg(10))

    # 2. Evaluate on the held-out split with several metrics.
    for spec in ("NDCG@10", "DCG@10", "MAP", "TNDCG@10"):
        m = metric_factory(spec)
        print(f"{spec:>8}: {model.evaluate(test, m):.4f}")

    # 3. CLEAVER: prune half the ensemble and re-weight with line search.
    cleaver = Cleaver(
        pruning_method="QUALITY_LOSS",
        pruning_rate=0.5,
        line_search=LineSearch(max_iterations=10, num_points=20),
    )
    info = cleaver.optimize(model, train, valid, Ndcg(10))
    print(
        f"pruned {info['num_trees_before']} -> {info['num_trees_after']} trees, "
        f"train NDCG {info['metric_before']:.4f} -> {info['metric_after']:.4f}"
    )

    # 4. Persist as QuickRank-compatible XML + standalone C scorer.
    model.save("/tmp/model.xml")
    reloaded = LTRAlgorithm.load("/tmp/model.xml")
    from quickrank_tpu.io import codegen

    with open("/tmp/model.cc", "w") as f:
        f.write(codegen.generate(reloaded, "condop"))
    print("saved /tmp/model.xml and /tmp/model.cc")

    # 5. Batch scoring (QS bitvector tables for best-first trees).  Pass a
    #    device mesh to fan doc rows out over every device:
    #    scores = reloaded.score_dataset(test, mesh=make_mesh())
    scores = reloaded.score_dataset(test)
    print("scored", len(scores), "docs; top:", scores.max())

    # 6. AOT serving artifact: the batched scorer + model constants as
    #    portable StableHLO — deserializable with jax alone (io/export.py).
    from quickrank_tpu.io.export import export_scorer, load_scorer

    export_scorer(
        reloaded, path="/tmp/scorer.shlo", num_features=test.num_features
    )
    serve = load_scorer("/tmp/scorer.shlo")
    print("AOT scorer:", serve(test.features)[:3])


if __name__ == "__main__":
    main()
