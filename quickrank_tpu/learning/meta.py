"""MetaCleaver (X-CLEaVER) — iterative grow-and-prune meta-algorithm.

Counterpart of ``MetaCleaver`` (src/learning/meta/
meta_cleaver.cc:118-373): wraps a Mart-family learner and a Cleaver
optimizer; each meta-iteration (1) warm-starts the learner to grow
``ntrees_per_iter`` more trees, (2) extracts the partial-score matrix and
runs Cleaver to prune ``pruning_rate_per_iter`` of the new trees and
re-weight via line search, (3) keeps the result only if the metric improved
(with ``opt_last_only`` allowing backtracking), until ``final_ntrees`` trees
or early stop; finally backtracks to the best model by zero-masking trees
added after it (meta_cleaver.cc:337-347).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from quickrank_tpu.learning.base import LTRAlgorithm
from quickrank_tpu.learning.mart import Mart
from quickrank_tpu.optimization.cleaver import Cleaver


class MetaCleaver(LTRAlgorithm):
    NAME = "METACLEAVER"

    def __init__(
        self,
        ltr_algo: Mart,
        cleaver: Cleaver,
        final_ntrees: int = 1000,
        ntrees_per_iter: int = 100,
        pruning_rate_per_iter: float = 0.5,
        opt_last_only: bool = True,
        meta_esr: int = 0,
        meta_verbose: bool = False,
    ):
        self.ltr_algo = ltr_algo
        self.cleaver = cleaver
        self.final_ntrees = int(final_ntrees)
        self.ntrees_per_iter = int(ntrees_per_iter)
        self.pruning_rate_per_iter = float(pruning_rate_per_iter)
        self.opt_last_only = bool(opt_last_only)
        self.meta_esr = int(meta_esr)
        self.meta_verbose = bool(meta_verbose)
        self.history: dict = {}

    def _ensemble_size(self) -> int:
        return (
            int(self.ltr_algo.ensemble.num_trees)
            if self.ltr_algo.ensemble is not None
            else 0
        )

    def learn(self, train, valid=None, metric=None, verbose=True, mesh=None):
        metric = metric or self.default_metric()
        algo = self.ltr_algo
        cleaver = self.cleaver
        cleaver.update_model = False  # meta controls weight application

        meta_esr = self.meta_esr
        if not self.opt_last_only:
            # cannot backtrack when optimizing the full model each iteration
            # (meta_cleaver.cc:148-151)
            meta_esr = 1

        best_tr, best_va = -np.inf, -np.inf
        best_model = self._ensemble_size()
        best_weights = (
            algo.get_weights().copy() if best_model > 0 else np.zeros(0)
        )
        best_iter = 0
        it = 0
        hist = []
        while True:
            it += 1
            if meta_esr and it > best_iter + meta_esr:
                break
            last_size = self._ensemble_size()

            # grow ntrees_per_iter more trees (no valid: meta handles es)
            algo.ntrees = last_size + self.ntrees_per_iter
            algo.learn(
                train, None, metric, verbose=self.meta_verbose,
                warm_start=True, mesh=mesh,
            )
            new_size = self._ensemble_size()
            diff = new_size - last_size
            if diff == 0:
                break

            if self.pruning_rate_per_iter < 1:
                trees_to_keep = int(
                    round((1.0 - self.pruning_rate_per_iter) * self.ntrees_per_iter)
                )
            else:
                trees_to_keep = self.ntrees_per_iter - int(
                    self.pruning_rate_per_iter
                )
                if trees_to_keep < 0:
                    raise ValueError("pruning rate per iter too high")
            trees_to_prune = diff - trees_to_keep
            if new_size - trees_to_prune > self.final_ntrees:
                trees_to_prune = new_size - self.final_ntrees
            trees_to_prune = max(trees_to_prune, 0)

            cleaver.pruning_rate = float(trees_to_prune)
            cleaver.update_weights(algo.get_weights())
            if self.opt_last_only:
                cleaver.last_estimators_to_optimize = diff
            if cleaver.line_search is not None:
                cleaver.line_search.reset_weights()

            cleaver.optimize(
                algo, train, valid, metric, verbose=self.meta_verbose, mesh=mesh
            )

            improvement = False
            if valid is not None:
                if cleaver.metric_on_validation_ > best_va:
                    best_va = cleaver.metric_on_validation_
                    best_tr = cleaver.metric_on_training_
                    improvement = True
            elif cleaver.metric_on_training_ > best_tr:
                best_tr = cleaver.metric_on_training_
                improvement = True

            if improvement or self.opt_last_only:
                algo.update_weights(cleaver.weights_)
            if not improvement and not self.opt_last_only:
                break

            cur_size = self._ensemble_size()
            if improvement:
                best_model = cur_size
                best_weights = algo.get_weights().copy()
                best_iter = it
            hist.append(
                {
                    "iter": it,
                    "size": cur_size,
                    "train": cleaver.metric_on_training_,
                    "valid": cleaver.metric_on_validation_
                    if valid is not None
                    else None,
                    "improved": improvement,
                }
            )
            if verbose:
                vtxt = (
                    f" valid {cleaver.metric_on_validation_:.4f}"
                    if valid is not None
                    else ""
                )
                print(
                    f"# meta-iter {it}: size={cur_size} "
                    f"train {cleaver.metric_on_training_:.4f}{vtxt}"
                    f"{' *' if improvement else ''}"
                )
            if self._ensemble_size() >= self.final_ntrees:
                break

        # backtrack to the best model (meta_cleaver.cc:337-347)
        cur_size = self._ensemble_size()
        if cur_size > best_model:
            mask = np.zeros(cur_size)
            mask[:best_model] = best_weights[:best_model]
            algo.update_weights(mask)

        self.history = {
            "iterations": hist,
            "best_train": best_tr,
            "best_valid": best_va if valid is not None else None,
            "final_size": self._ensemble_size(),
        }
        return self.history

    # -- delegation ----------------------------------------------------------

    def score_dataset(self, ds):
        return self.ltr_algo.score_dataset(ds)

    def partial_scores_dataset(self, ds):
        return self.ltr_algo.partial_scores_dataset(ds)

    def get_weights(self):
        return self.ltr_algo.get_weights()

    def update_weights(self, w):
        self.ltr_algo.update_weights(w)

    def _to_xml(self):
        """Composite model XML: meta info + the inner LtR model
        (meta_cleaver.cc:75-105 wraps ltr-model + cleaver + line-search)."""
        import xml.etree.ElementTree as ET

        root = ET.Element("ranker")
        info = ET.SubElement(root, "info")
        ET.SubElement(info, "type").text = self.NAME
        ET.SubElement(info, "final-num-trees").text = str(self.final_ntrees)
        ET.SubElement(info, "num-trees-per-iter").text = str(self.ntrees_per_iter)
        ET.SubElement(info, "pruning-rate-per-iter").text = str(
            self.pruning_rate_per_iter
        )
        ET.SubElement(info, "opt-last-only").text = str(int(self.opt_last_only))
        inner = self.ltr_algo._to_xml()
        inner.tag = "ltr-model"
        root.append(inner)
        return root

    @classmethod
    def _from_xml(cls, root):
        from quickrank_tpu.io.xml_model import _registry

        info = root.find("info")
        inner_el = root.find("ltr-model")
        inner_type = inner_el.find("info/type").text.strip()
        inner = _registry()[inner_type]._from_xml(inner_el)
        g = lambda t, c, d: (  # noqa: E731
            c(info.find(t).text) if info.find(t) is not None else d
        )
        return cls(
            ltr_algo=inner,
            cleaver=Cleaver(),
            final_ntrees=g("final-num-trees", int, 1000),
            ntrees_per_iter=g("num-trees-per-iter", int, 100),
            pruning_rate_per_iter=g("pruning-rate-per-iter", float, 0.5),
            opt_last_only=g("opt-last-only", lambda s: bool(int(s)), True),
        )
