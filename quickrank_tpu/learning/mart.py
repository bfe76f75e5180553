"""MART — pointwise gradient-boosted regression trees (squared loss).

Re-design of ``Mart`` (src/learning/forests/mart.cc:208-416).
The per-iteration pipeline (pseudoresponses -> histogram/tree fit -> leaf
outputs -> incremental rescoring -> metric eval) is one jit-compiled step; the
host loop only does early-stopping bookkeeping and logging, mirroring the
process/device boundary SURVEY.md §3.1 prescribes.

Semantics preserved from the reference:
  * pseudoresponse = label - current score (mart.cc:418-431);
  * per-iteration doc subsampling (mart.cc:312-329) as a random k-of-N mask;
  * shrinkage ("learning rate") as the pushed tree weight (mart.cc:342);
  * early stop after ``esr`` non-improving validation iterations with
    rollback to the best model by popping trees (mart.cc:347-395).

Multi-chip: pass ``mesh`` to :meth:`learn` — the same step body runs under
``shard_map`` with queries sharded over the mesh and histograms/metrics
``psum``-reduced (see parallel/mesh.py).  Every chip grows an identical tree,
so the ensemble stays replicated.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from quickrank_tpu.utils import struct
from jax.sharding import Mesh, PartitionSpec as P

from quickrank_tpu.data.dataset import (
    Dataset,
    PaddedDataset,
    build_scatter_keys,
    gather_padded,
    scatter_padded,
    shard_and_pad,
)
from quickrank_tpu.learning.base import LTRAlgorithm
from quickrank_tpu.metrics.metrics import Metric
from quickrank_tpu.ops.binning import apply_bins, build_thresholds
from quickrank_tpu.ops.scoring import tree_delta_binned
from quickrank_tpu.parallel.mesh import (
    DATA_AXIS,
    shard_map,
    shard_step_data,
    step_data_specs,
)
from quickrank_tpu.trees.grow import GrowConfig, fit_tree, leaf_outputs
from quickrank_tpu.trees.structs import EnsembleTensors


@struct.dataclass
class StepData:
    """The device tensors one boosting step reads (train or valid split).

    Under ``shard_map`` each chip sees its local block of every array;
    ``pad_index`` is shard-local by construction (data/dataset.py), so all
    gathers stay on-chip.
    """

    binned: jnp.ndarray  # i32 [N, F]
    labels: jnp.ndarray  # f32 [N]
    labels2d: jnp.ndarray  # f32 [Q, D] — precomputed padded view (labels
    #   never change, so the flat->view gather is paid once here instead
    #   of in every metric/lambda pass)
    doc_mask: jnp.ndarray  # bool [N]
    pad_index: jnp.ndarray  # i32 [Q, D] (shard-local row ids)
    inv_q: jnp.ndarray  # i32 [N] shard-local query of each doc row
    inv_slot: jnp.ndarray  # i32 [N] slot of each doc row
    slot_mask: jnp.ndarray  # bool [Q, D]
    query_mask: jnp.ndarray  # bool [Q]
    nvalid: jnp.ndarray  # i32 [Q]
    thresholds: jnp.ndarray  # f32 [F, B] (replicated)
    scatter_key: jnp.ndarray  # i32 [max(N, Q*D)] — static sort keys for the
    #   flat -> [Q, D] scatter (data/dataset.py::build_scatter_keys)


def build_valid_traindata(
    tr: "TrainData", valid, nthresholds: int, num_shards: int
):
    """Validation-fold TrainData against the TRAIN run's thresholds
    (feature-replicated; the train-side feature-pad rows are sliced off),
    with the guards every learner shares: a presharded train requires a
    presharded valid (docs/parallel.md multi-host exclusions), and a
    validation matrix narrower than the training feature count would
    silently misroute global split ids."""
    if isinstance(valid, TrainData):
        return valid
    if valid is None:
        return None
    if tr.presharded:
        raise ValueError(
            "multi-host training: the validation fold must also be a "
            "build_train_data_multihost TrainData (same mesh, same "
            "thresholds) — a host-local Dataset cannot join the global "
            "step (docs/parallel.md multi-host exclusions)"
        )
    if valid.num_features < tr.num_real_features:
        raise ValueError(
            f"validation set has {valid.num_features} features but "
            f"training used {tr.num_real_features}: trees split on global "
            "feature ids, so a narrower validation matrix would silently "
            "misroute (pad the validation features to the training width)"
        )
    return TrainData.build(
        valid,
        nthresholds,
        num_shards=num_shards,
        # valid thresholds stay unpadded/replicated: its descent scoring
        # uses global feature ids over the full matrix
        thresholds=np.asarray(tr.step.thresholds)[: valid.num_features],
    )


def eval_metric(metric: Metric, sd: StepData, scores, axis_name=None,
                scores2d=None):
    """Dataset-level metric on (possibly sharded) step data: per-query eval,
    then a (num, den) psum across chips (metric.h:77-106's mean).

    Pass ``scores2d`` when the [Q, D] view is already live (the training
    step carries it) — the flat->view gather is the expensive part."""
    s = (
        scores2d
        if scores2d is not None
        else gather_padded(scores, sd.pad_index, sd.slot_mask)
    )
    pq = metric.evaluate_per_query(s, sd.labels2d, sd.slot_mask, sd.nvalid)
    num, den = metric.aggregate(pq, sd.query_mask, jnp.sum(sd.doc_mask))
    if axis_name is not None:
        num = jax.lax.psum(num, axis_name)
        den = jax.lax.psum(den, axis_name)
    return jnp.asarray(metric.finalize(num, den), jnp.float32)


@dataclasses.dataclass
class TrainData:
    """Host-side handle: padded layout + binned device tensors."""

    padded: PaddedDataset
    step: StepData
    num_real_docs: int
    num_real_features: int = 0
    #: step tensors are already global jax.Arrays laid out over a mesh
    #: (multi-host assembly, parallel/multihost.py) — learn() must not
    #: re-shard them
    presharded: bool = False

    @staticmethod
    def build(
        ds: Dataset,
        nthresholds: int,
        num_shards: int = 1,
        thresholds: Optional[np.ndarray] = None,
        num_feat_shards: int = 1,
        force_dims: Optional[tuple] = None,
    ) -> "TrainData":
        # Tree training never reads raw features on device — keep them on
        # host and ship only the (u8-packed) binned tensor, which matters
        # when the chip is behind a slow transfer link.
        padded = shard_and_pad(
            ds, num_shards=num_shards, features_on_device=False,
            force_dims=force_dims,
        )
        if thresholds is None:
            thresholds, _ = build_thresholds(ds.features, nthresholds)
        else:
            thresholds = np.asarray(thresholds)
        binned = apply_bins(np.asarray(padded.features), thresholds)
        # Pad the feature axis to a multiple of the feature-shard count.
        # Pad features bin every doc to 0 and carry +inf thresholds, so any
        # split on them sends everything left (rcount=0 -> never chosen).
        F = binned.shape[1]
        k = num_feat_shards
        Fp = (F + k - 1) // k * k
        if Fp != F:
            binned = np.pad(binned, ((0, 0), (0, Fp - F)))
            thresholds = np.pad(
                thresholds,
                ((0, Fp - F), (0, 0)),
                constant_values=np.float32(3.4028235e38),
            )
        B = thresholds.shape[1]
        if B <= 256:
            wire = binned.astype(np.uint8)
        elif B <= 65536:
            wire = binned.astype(np.uint16)
        else:
            wire = binned
        sd = StepData(
            # stays u8/u16 on device (4x memory at MSLR scale); kernels widen
            binned=jnp.asarray(wire),
            labels=padded.labels,
            # built host-side over the GLOBAL flat layout, so the global
            # index map applies (shard-local pad_index is for inside
            # shard_map only, CLAUDE.md)
            labels2d=gather_padded(
                padded.labels, padded.pad_index_global, padded.slot_mask
            ),
            doc_mask=padded.doc_mask,
            pad_index=padded.pad_index,
            inv_q=padded.inv_q,
            inv_slot=padded.inv_slot,
            slot_mask=padded.slot_mask,
            query_mask=padded.query_mask,
            nvalid=padded.nvalid,
            thresholds=jnp.asarray(thresholds),
            scatter_key=jnp.asarray(build_scatter_keys(padded)),
        )
        return TrainData(
            padded=padded, step=sd, num_real_docs=ds.num_docs,
            num_real_features=ds.num_features,
        )

    @property
    def num_bins(self) -> int:
        return int(self.step.thresholds.shape[1])


class Mart(LTRAlgorithm):
    NAME = "MART"
    #: Newton leaf outputs (sum lambda / sum w) — LambdaMART turns this on.
    _newton = False

    def __init__(
        self,
        ntrees: int = 1000,
        shrinkage: float = 0.1,
        nthresholds: int = 255,
        nleaves: int = 10,
        minleafsupport: int = 1,
        esr: int = 100,
        subsample: float = 1.0,
        max_features: float = 1.0,
        seed: int = 0,
        max_depth: int = 0,
        collapse_leaves_factor: float = 0.0,
        growth: str = "best",
        split_pack: int = 4,
    ):
        """Defaults mirror quicklearn's training group (src/quicklearn.cc:97-140)
        except ``nthresholds``: the reference's 0 = "all unique values" is
        hostile to a dense [nodes, F, B] histogram tensor, so we default to
        255 bins (standard GBDT quantization).  ``max_depth`` (extension, 0 =
        unbounded like the reference) caps best-first depth."""
        self.ntrees = int(ntrees)
        self.shrinkage = float(shrinkage)
        self.nthresholds = int(nthresholds)
        self.nleaves = int(nleaves)
        self.minleafsupport = int(minleafsupport)
        self.esr = int(esr)
        self.subsample = float(subsample)
        self.max_features = float(max_features)
        self.seed = int(seed)
        self.max_depth = int(max_depth)
        self.collapse_leaves_factor = float(collapse_leaves_factor)
        #: "best" = reference-faithful best-first growth; "level" = the
        #: throughput mode (one packed histogram pass per level, ~4x fewer
        #: passes; depth = max_depth or ceil(log2(nleaves))); "bestk" =
        #: best-first priority with up to ``split_pack`` heap leaves split
        #: per packed histogram pass (trees/grow_bestk.py — same gain/minls/
        #: budget rules, ~3x fewer passes than exact best-first)
        if growth == "best-k":
            growth = "bestk"
        if growth not in ("best", "level", "bestk"):
            raise ValueError(
                f"growth must be 'best', 'level' or 'bestk', got {growth!r}"
            )
        self.growth = growth
        #: max heap leaves split per histogram pass under growth="bestk"
        #: (clamped to nleaves - 1; 1 = exact best-first).  The default 4
        #: is not yet tuned on the GPU.
        self.split_pack = int(split_pack)
        self.ensemble: Optional[EnsembleTensors] = None
        self.best_iteration: int = -1
        self.history: dict = {}
        #: depth bound of a model loaded from XML (trees of unknown shape)
        self._depth_bound: Optional[int] = None

    # -- hooks for subclasses ------------------------------------------------

    def _gradients(self, sd: StepData, scores, sample_mask, key, **_unused):
        """(pseudoresponses, newton_weights|None) — MART: label - score
        (mart.cc:418-431).  Extra kwargs (scores2d/full_mask fast-path hints
        used by the LambdaMart override) are ignored here."""
        return (sd.labels - scores).astype(jnp.float32), None

    def _grow_config(
        self,
        num_bins: int,
        feat_axis: Optional[str] = None,
        feat_axis_size: int = 1,
    ) -> GrowConfig:
        nleaves = self.nleaves
        if self.growth == "level":
            # level-wise trees are bounded by their depth, not a leaf budget
            nleaves = 2 ** self._level_depth()
        return GrowConfig(
            nleaves=nleaves,
            min_leaf_support=self.minleafsupport,
            num_bins=num_bins,
            max_features=self.max_features,
            newton=self._newton,
            feat_axis=feat_axis,
            feat_axis_size=feat_axis_size,
            max_depth=self.max_depth,
            collapse_factor=self.collapse_leaves_factor,
        )

    def _tree_weight(self) -> float:
        return self.shrinkage

    def _descend_depth(self) -> int:
        """Static bound on tree depth for the descent scorer (best-first
        chain depth <= nleaves - 1, or the explicit cap; XML-loaded models
        carry their own)."""
        if self._depth_bound:
            return self._depth_bound
        if self.growth == "level":
            return self._level_depth() + 1
        if self.max_depth:
            return min(self.max_depth + 1, self.nleaves)
        return self.nleaves

    def _level_depth(self) -> int:
        return self.max_depth or max(1, (self.nleaves - 1).bit_length())

    def _fit_and_assign(
        self, tr: StepData, grad, smask, cfg, key, axis_name, weights=None
    ):
        """Fit one tree; returns (tree, node_of_doc, leaves_done).  The
        level-wise grower fills leaf values itself (from its level
        histograms); best-first leaves them for :func:`leaf_outputs`."""
        if self.growth == "level":
            from quickrank_tpu.trees.grow_level import fit_tree_levelwise

            tree, node = fit_tree_levelwise(
                tr.binned, grad, smask, tr.thresholds, self._level_depth(),
                cfg, key=key, axis_name=axis_name, weights=weights,
            )
            return tree, node, True
        if self.growth == "bestk":
            from quickrank_tpu.trees.grow_bestk import fit_tree_bestk

            tree, node = fit_tree_bestk(
                tr.binned, grad, smask, tr.thresholds, cfg, self.split_pack,
                key=key, axis_name=axis_name,
            )
            return tree, node, False
        tree, node = fit_tree(
            tr.binned, grad, smask, tr.thresholds, cfg, key=key, axis_name=axis_name
        )
        return tree, node, False

    # -- sampling ------------------------------------------------------------

    def _sample_mask(self, sd: StepData, key, presence):
        """Random doc subset of size subsample*N (count if subsample > 1),
        mirroring the shuffle-and-take of mart.cc:312-329.  ``presence`` is
        the algorithm-level doc pool (e.g. selective negative sampling) that
        subsampling further thins; count is the local shard's present docs."""
        if self.subsample == 1.0:
            return presence
        n = jnp.sum(presence.astype(jnp.int32))
        if self.subsample > 1.0:
            k = jnp.minimum(jnp.asarray(int(self.subsample), jnp.int32), n)
        else:
            k = jnp.clip((self.subsample * n).astype(jnp.int32), 1, n)
        r = jnp.where(presence, jax.random.uniform(key, presence.shape), jnp.inf)
        kth = jnp.sort(r)[jnp.maximum(k - 1, 0)]
        return presence & (r <= kth)

    # -- the boosting step ---------------------------------------------------

    def _step_body(
        self,
        ens: EnsembleTensors,
        scores_tr,
        scores_va,
        key,
        m,
        presence,
        tr: StepData,
        va: Optional[StepData],
        metric: Metric,
        cfg: GrowConfig,
        axis_name: Optional[str],
    ):
        md = self._descend_depth()
        shrinkage = self._tree_weight()
        # per-iteration key derived INSIDE the step: an eager host-side
        # fold_in would be a separate device dispatch every iteration
        key = jax.random.fold_in(key, m)
        k1, k2, k3 = jax.random.split(key, 3)
        if axis_name is not None:
            # Per-shard doc subsampling; split decisions stay replicated
            # because they derive from psum'd histograms.
            k1 = jax.random.fold_in(k1, jax.lax.axis_index(axis_name))
        smask = self._sample_mask(tr, k1, presence & tr.doc_mask)
        # When nothing deselects docs (no subsampling, no presence hook),
        # the sample mask IS doc_mask — its [Q, D] view is slot_mask, so
        # the lambda kernel can skip that flat->view gather entirely.
        full_presence = (
            self.subsample == 1.0
            and type(self)._update_presence is Mart._update_presence
        )
        grad, w = self._gradients(
            tr, scores_tr[0], smask, k2,
            scores2d=scores_tr[2], full_mask=full_presence,
        )
        tree, node, leaves_done = self._fit_and_assign(
            tr, grad, smask, cfg, k3, axis_name,
            weights=w if self._newton else None,
        )
        if not leaves_done:
            tree = leaf_outputs(
                tree,
                node,
                grad,
                smask,
                weights=w if self._newton else None,
                axis_name=axis_name,
            )
        ens2 = ens.push(tree, shrinkage)
        # every doc is routed during the fit, so the train update is a pure
        # leaf-value gather — no descent pass (and it stays correct under
        # feature sharding, where local binned blocks can't be descended).
        # Scores carry a Kahan compensation term across iterations: the f32
        # analog of the reference's double score accumulator
        # (Score = double, include/types.h:28-35) — at 1000 trees the
        # uncompensated f32 partial-sum drift is measurable
        # (tests/test_precision.py).
        from quickrank_tpu.ops.scoring import kahan_add

        # Scores are carried in BOTH layouts — flat [N] (the truth, feeds
        # gradients/tree fitting) and the padded [Q, D] view (feeds metric +
        # lambda passes).  Identical f32/Kahan updates keep the view
        # bitwise equal to re-gathering the flat array, at the cost of ONE
        # increment gather per iteration instead of one per consumer.
        from quickrank_tpu.ops.scoring import leaf_values

        d_tr = leaf_values(node, tree)
        inc_tr = shrinkage * d_tr
        s_tr = kahan_add(scores_tr[0], scores_tr[1], inc_tr)
        s2_tr = kahan_add(
            scores_tr[2], scores_tr[3],
            scatter_padded(
                inc_tr, tr.scatter_key, tr.slot_mask.shape, tr.doc_mask
            ),
        )
        m_tr = eval_metric(metric, tr, s_tr[0], axis_name, scores2d=s2_tr[0])
        if va is None:
            return ens2, s_tr + s2_tr, scores_va, m_tr, jnp.float32(jnp.nan)
        # the per-iteration valid rescore: one bin-space descent
        d_va = tree_delta_binned(va.binned, tree, md)
        inc_va = shrinkage * d_va
        s_va = kahan_add(scores_va[0], scores_va[1], inc_va)
        s2_va = kahan_add(
            scores_va[2], scores_va[3],
            scatter_padded(
                inc_va, va.scatter_key, va.slot_mask.shape, va.doc_mask
            ),
        )
        m_va = eval_metric(metric, va, s_va[0], axis_name, scores2d=s2_va[0])
        return ens2, s_tr + s2_tr, s_va + s2_va, m_tr, m_va

    def _make_step(
        self,
        tr: TrainData,
        va: Optional[TrainData],
        metric: Metric,
        mesh: Optional[Mesh],
        block_k: int = 1,
    ):
        """Build the jitted training dispatch.  With ``block_k > 1`` the
        returned callable runs ``block_k`` boosting iterations per device
        dispatch via ``lax.scan`` and returns STACKED [k] metric pairs —
        per-dispatch host overhead amortizes over k trees.  Iteration semantics are unchanged: the
        scan body is the same ``_step_body``, keys derive from the absolute
        iteration index, and the host consumes the k metric pairs one by
        one (early stopping may discard already-computed tail iterations,
        exactly like the one-deep pipeline already does)."""
        va_sd = va.step if va is not None else None

        def scanned(ens, s_tr, s_va, key, m0, presence, tr_sd, va_sd_, cfg,
                    axis_name):
            def body(carry, mi):
                e, st, sv = carry
                e2, st2, sv2, mt, mv = self._step_body(
                    e, st, sv, key, mi, presence, tr_sd, va_sd_, metric,
                    cfg, axis_name,
                )
                return (e2, st2, sv2), (mt, mv)

            (ens, s_tr, s_va), (mts, mvs) = jax.lax.scan(
                body, (ens, s_tr, s_va), m0 + jnp.arange(block_k)
            )
            return ens, s_tr, s_va, mts, mvs

        if mesh is None:
            cfg = self._grow_config(tr.num_bins)

            # Data tensors are jit ARGUMENTS, not closure constants — XLA
            # would otherwise embed + constant-fold the multi-MB arrays at
            # compile time (slow) and duplicate them in the executable.
            if va_sd is not None:
                def step_args(ens, s_tr, s_va, key, m, presence, tr_sd, va_sd_):
                    return scanned(
                        ens, s_tr, s_va, key, m, presence, tr_sd, va_sd_,
                        cfg, None,
                    )

                jitted = jax.jit(step_args, donate_argnums=(0, 1, 2))
                return lambda e, s, v, k, m, p: jitted(
                    e, s, v, k, m, p, tr.step, va.step
                )

            def step_args(ens, s_tr, s_va, key, m, presence, tr_sd):
                return scanned(
                    ens, s_tr, s_va, key, m, presence, tr_sd, None,
                    cfg, None,
                )

            jitted = jax.jit(step_args, donate_argnums=(0, 1, 2))
            return lambda e, s, v, k, m, p: jitted(e, s, v, k, m, p, tr.step)

        axis = mesh.axis_names[0]
        feat_axis = mesh.axis_names[1] if len(mesh.axis_names) > 1 else None
        feat_size = int(mesh.shape[feat_axis]) if feat_axis else 1
        cfg = self._grow_config(tr.num_bins, feat_axis, feat_size)
        sd_specs = step_data_specs(tr.step, axis, feat_axis)
        # valid split stays feature-replicated (its scoring descends trees
        # with global feature ids)
        va_specs = step_data_specs(va_sd, axis) if va_sd is not None else None
        rep = P()
        ens_specs = jax.tree.map(lambda _: rep, EnsembleTensors.empty(1, 1))

        def sharded(ens, s_tr, s_va, key, m, presence, tr_sd, va_sd_):
            return scanned(
                ens, s_tr, s_va, key, m, presence, tr_sd, va_sd_, cfg, axis,
            )

        # training/valid scores are (sum, comp, sum2d, comp2d) — flat Kahan
        # pair sharded with the docs, [Q, D] view pair sharded with the
        # queries
        sc_tr = (P(axis), P(axis), P(axis, None), P(axis, None))
        sc_va = (
            (P(axis), P(axis), P(axis, None), P(axis, None))
            if va_sd is not None
            else (rep, rep, rep, rep)
        )
        in_specs = (
            ens_specs,
            sc_tr,
            sc_va,
            rep,
            rep,
            P(axis),
        )
        out_specs = (
            ens_specs,
            sc_tr,
            sc_va,
            rep,
            rep,
        )
        if va_sd is not None:
            mapped = shard_map(
                sharded,
                mesh=mesh,
                in_specs=in_specs + (sd_specs, va_specs),
                out_specs=out_specs,
                check_rep=False,
            )
        else:
            mapped = shard_map(
                partial(sharded, va_sd_=None),
                mesh=mesh,
                in_specs=in_specs + (sd_specs,),
                out_specs=out_specs,
                check_rep=False,
            )

        # step data passed as jit ARGUMENTS (same as the single-device
        # branch): besides the const-folding hazard, closing over a global
        # jax.Array is illegal in multi-process runs (non-addressable
        # shards)
        if va_sd is not None:
            jitted = jax.jit(
                lambda e, s, v, k, m, p, tr_sd, va_: mapped(
                    e, s, v, k, m, p, tr_sd, va_
                ),
                donate_argnums=(0, 1, 2),
            )
            return lambda e, s, v, k, m, p: jitted(
                e, s, v, k, m, p, tr.step, va_sd
            )
        jitted = jax.jit(
            lambda e, s, v, k, m, p, tr_sd: mapped(e, s, v, k, m, p, tr_sd),
            donate_argnums=(0, 1, 2),
        )
        return lambda e, s, v, k, m, p: jitted(e, s, v, k, m, p, tr.step)

    # -- training ------------------------------------------------------------

    def learn(
        self,
        train: Dataset,
        valid: Optional[Dataset] = None,
        metric: Optional[Metric] = None,
        verbose: bool = True,
        mesh: Optional[Mesh] = None,
        warm_start: bool = False,
        partial_save: int = 0,
        output_basename: str = "",
    ) -> dict:
        """Train.  With ``warm_start`` and a non-empty ensemble, training
        resumes from iteration ``len(ensemble)`` after a full rescoring pass
        — the reference's --restart-train semantics (mart.cc:237-253,
        ltr_algorithm_factory.cc:250-258); also used by MetaCleaver's
        grow-k-trees loop (meta_cleaver.cc:170-179)."""
        metric = metric or self.default_metric()
        t_init = time.time()
        if mesh is not None:
            axis = mesh.axis_names[0]
            feat_axis = mesh.axis_names[1] if len(mesh.axis_names) > 1 else None
            num_shards = int(mesh.shape[axis])
            num_feat_shards = int(mesh.shape[feat_axis]) if feat_axis else 1
        else:
            feat_axis = None
            num_shards, num_feat_shards = 1, 1
        # Feature-sharding exclusions, validated host-side up front (not as
        # trace-time stack traces from inside jit) — see PARITY.md §known
        # exclusions for the full matrix.
        if feat_axis is not None and self.collapse_leaves_factor > 0:
            raise NotImplementedError(
                "collapse-leaves-factor under feature-axis sharding is not "
                "supported — drop --num-feat-shards or "
                "--collapse-leaves-factor (PARITY.md known exclusions)"
            )
        if feat_axis is not None and warm_start:
            raise NotImplementedError(
                "warm start (--restart-train / MetaCleaver) under "
                "feature-axis sharding is not supported — drop "
                "--num-feat-shards (PARITY.md known exclusions)"
            )
        if isinstance(train, TrainData):
            # pre-assembled step tensors (multi-host path,
            # parallel/multihost.py) — geometry fixed by the builder
            tr = train
            if warm_start and tr.presharded:
                raise NotImplementedError(
                    "warm start with a presharded multi-host TrainData is "
                    "not supported (host-side rescoring gathers need the "
                    "global flat layout)"
                )
        else:
            tr = TrainData.build(
                train,
                self.nthresholds,
                num_shards=num_shards,
                num_feat_shards=num_feat_shards,
            )
        va = build_valid_traindata(tr, valid, self.nthresholds, num_shards)
        if mesh is not None and not tr.presharded:
            tr = dataclasses.replace(
                tr, step=shard_step_data(tr.step, mesh, axis, feat_axis)
            )
            if va is not None:
                va = dataclasses.replace(
                    va, step=shard_step_data(va.step, mesh, axis)
                )
        cfg = self._grow_config(tr.num_bins)
        # capacity padded so the final (possibly partial) dispatch block can
        # push its full block_k trees; extras are sliced away by _compact
        ens = EnsembleTensors.empty(
            self.ntrees + self._dispatch_block_size() - 1, cfg.max_nodes
        )

        def _zero_scores(n, qd):
            # distinct buffers: the jitted step donates all four components
            # (flat Kahan pair + [Q, D] view Kahan pair)
            return (
                jnp.zeros((n,), jnp.float32),
                jnp.zeros((n,), jnp.float32),
                jnp.zeros(qd, jnp.float32),
                jnp.zeros(qd, jnp.float32),
            )

        if tr.presharded:
            # multi-host: score buffers must be GLOBAL sharded arrays laid
            # out like the step tensors (a process-local jnp.zeros cannot
            # feed a multi-process jit); each component gets its own jit
            # execution so the four donated buffers never alias
            from jax.sharding import NamedSharding

            def _zeros_global(n, qd):
                sf = NamedSharding(mesh, P(axis))
                s2 = NamedSharding(mesh, P(axis, None))
                mk = lambda shp, sh: jax.jit(  # noqa: E731
                    lambda: jnp.zeros(shp, jnp.float32), out_shardings=sh
                )()
                return (mk((n,), sf), mk((n,), sf), mk(qd, s2), mk(qd, s2))

            scores_tr = _zeros_global(
                tr.step.binned.shape[0], tr.step.slot_mask.shape
            )
            scores_va = (
                _zeros_global(
                    va.step.binned.shape[0], va.step.slot_mask.shape
                )
                if va is not None
                else _zero_scores(1, (1, 1))
            )
        else:
            scores_tr = _zero_scores(
                tr.padded.num_docs_padded, tr.step.slot_mask.shape
            )
            scores_va = (
                _zero_scores(
                    va.padded.num_docs_padded, va.step.slot_mask.shape
                )
                if va is not None
                else _zero_scores(1, (1, 1))
            )
        start_iter = 0
        if warm_start and self.ensemble is not None and int(
            self.ensemble.num_trees
        ) > 0:
            # XML-loaded models carry no bin-space thresholds — rebuild them
            # against this run's threshold tables so binned rescoring/descent
            # routes exactly like the value-space model.
            src = rebin_ensemble(
                self.ensemble, np.asarray(tr.step.thresholds), force=True
            )
            ens = _copy_into(ens, src)
            start_iter = int(ens.num_trees)
            md = self._descend_depth()
            # host-side gathers over the GLOBAL flat layout -> global map
            s0 = rescore_binned(ens, tr.step, md)
            scores_tr = (
                s0, scores_tr[1],
                gather_padded(
                    s0, tr.padded.pad_index_global, tr.step.slot_mask
                ),
                scores_tr[3],
            )
            if va is not None:
                v0 = rescore_binned(ens, va.step, md)
                scores_va = (
                    v0, scores_va[1],
                    gather_padded(
                        v0, va.padded.pad_index_global, va.step.slot_mask
                    ),
                    scores_va[3],
                )
        self._post_init(tr)
        # Learners whose presence / post-iteration hooks feed the NEXT
        # iteration (Selective's adaptive factor, StochasticNegative's
        # resampling, the profiler's instance-level capture hook) must see
        # each iteration's result before dispatching the next — no
        # pipelining or iteration blocking for them.
        uses_presence = (
            type(self)._update_presence is not Mart._update_presence
        )
        pipelined = (
            not uses_presence
            and getattr(self._post_iteration, "__func__", None)
            is Mart._post_iteration
        )
        # Iteration blocking: run block_k boosting iterations per device
        # dispatch (lax.scan inside the jitted step) so per-dispatch host
        # overhead amortizes.  Early stopping is evaluated per
        # consumed iteration, so it can discard up to block_k-1 computed
        # tail iterations — the rollback to the best prefix makes that
        # waste invisible in the final model (mart.cc:380-395).
        block_k = self._dispatch_block_size() if pipelined else 1
        block_k = max(1, min(block_k, self.ntrees - start_iter or 1))
        step = self._make_step(tr, va, metric, mesh, block_k=block_k)
        init_time = time.time() - t_init

        root_key = jax.random.PRNGKey(self.seed)
        hist_tr, hist_va = [], []
        iter_seconds: list[float] = []
        best_va, best_it = -np.inf, -1
        if verbose:
            print(f"# {self.NAME}: {self!r}")
            print("# iter. training validation")
        t_train = time.time()
        presence = tr.step.doc_mask
        # One-deep dispatch pipeline: reading a block's metric scalars
        # waits for the device, so block b+1 is dispatched BEFORE block b's
        # metrics are fetched, overlapping the fetch with device compute.  When early
        # stopping fires, already-dispatched work is discarded unconsumed,
        # so history, best_it, and the rolled-back model are identical to
        # the serial loop.
        pending = None  # (first iter index, device m_tr [k], device m_va [k])

        def _consume(ens_now):
            """Consume one dispatched block; True when early stopping
            fired at some iteration inside it."""
            nonlocal best_va, best_it, pending
            m0b, d_tr, d_va = pending
            pending = None
            mts = np.asarray(d_tr).reshape(-1)
            mvs = np.asarray(d_va).reshape(-1)
            for j in range(len(mts)):
                pm = m0b + j
                if pm >= self.ntrees:
                    break  # capacity-padded tail of the final block
                m_tr = float(mts[j])
                m_va = float(mvs[j])
                hist_tr.append(m_tr)
                hist_va.append(m_va)
                improved = False
                if va is not None and m_va > best_va:
                    best_va, best_it, improved = m_va, pm, True
                elif va is None and m_tr > max(hist_tr[:-1], default=-np.inf):
                    improved = True
                self._post_iteration(pm, improved)
                if (
                    partial_save
                    and output_basename
                    and (pm + 1) % partial_save == 0
                ):
                    # periodic partial model save as <base>.T<iter>.xml
                    # (mart.cc:378-381, suffix ltr_algorithm.cc:54-65);
                    # trees are append-only, so slicing the CURRENT buffers
                    # to pm+1 trees reproduces the ensemble as of pm even
                    # when ens_now is a later block's state
                    snapshot = self.ensemble
                    self.ensemble = _compact(
                        ens_now.replace(
                            num_trees=jnp.asarray(pm + 1, jnp.int32)
                        )
                    )
                    self.save(f"{output_basename}.T{pm + 1}.xml")
                    self.ensemble = snapshot
                if verbose and (pm < 5 or (pm + 1) % 10 == 0 or improved):
                    vtxt = f" {m_va:.6f}" if va is not None else ""
                    print(
                        f"# {pm + 1:5d} {m_tr:.6f}{vtxt}"
                        f"{' *' if improved else ''}"
                    )
                if (
                    va is not None
                    and self.esr
                    and pm >= start_iter
                    and pm - best_it >= self.esr
                ):
                    return True
            return False

        stopped_early = False
        m0 = start_iter
        while m0 < self.ntrees and not stopped_early:
            t_iter = time.time()
            if uses_presence:
                key = jax.random.fold_in(root_key, m0)
                new_presence = self._update_presence(
                    m0, tr, scores_tr[0], key
                )
                if new_presence is not None:
                    presence = new_presence
            ens, scores_tr, scores_va, m_tr, m_va = step(
                ens, scores_tr, scores_va, root_key, np.int32(m0), presence
            )
            just_dispatched = (m0, m_tr, m_va)
            if pending is not None:
                stopped_early = _consume(ens)
            if not stopped_early:
                pending = just_dispatched
                if not pipelined:
                    stopped_early = _consume(ens)
            k_eff = min(block_k, self.ntrees - m0)
            dt = time.time() - t_iter
            iter_seconds.extend([dt / k_eff] * k_eff)
            m0 += block_k
        if pending is not None and not stopped_early:
            _consume(ens)

        # drop the capacity-padded tail of the final dispatch block (trees
        # past ntrees exist only to keep the scan shape static)
        if int(ens.num_trees) > self.ntrees:
            ens = ens.replace(num_trees=jnp.asarray(self.ntrees, jnp.int32))
        if va is not None and best_it >= 0:
            # Rollback to the best model (mart.cc:390-395).
            ens = ens.replace(num_trees=jnp.asarray(best_it + 1, jnp.int32))
        self.ensemble = _compact(ens)
        self.best_iteration = best_it if va is not None else self.ntrees - 1
        train_time = time.time() - t_train
        self.history = {
            "train": hist_tr,
            "valid": hist_va,
            "best_iteration": self.best_iteration,
            "best_valid": best_va if va is not None else None,
            "init_seconds": init_time,
            "train_seconds": train_time,
            # per-iteration wall time; [0] includes the one-time jit compile
            "iter_seconds": iter_seconds,
            "metric": repr(metric),
        }
        if verbose:
            print(
                f"# done: {int(self.ensemble.num_trees)} trees kept, "
                f"init {init_time:.2f}s, train {train_time:.2f}s"
            )
        return self.history

    #: hyperparameters that must match for a --restart-train resume
    #: (mart.cc:499-504: shrinkage within 1e-6, plus exact nthresholds /
    #: nleaves / minleafsupport / esr)
    _RESTART_EXACT = ("nthresholds", "nleaves", "minleafsupport", "esr")

    def import_model_state(self, other: LTRAlgorithm) -> None:
        """Adopt ``other``'s ensemble for a training resume, refusing on a
        hyperparameter mismatch (mart.cc:493-517) — a silent resume with,
        say, a different shrinkage would corrupt the model without erroring.
        Runs host-side, before any device work."""
        if not isinstance(other, Mart):
            raise ValueError(
                f"restart-train: {self.NAME} cannot import model state from "
                f"{other.NAME}"
            )
        diffs = []
        if abs(self.shrinkage - other.shrinkage) > 1e-6:
            diffs.append(
                f"shrinkage: {self.shrinkage} (requested) != "
                f"{other.shrinkage} (loaded model)"
            )
        for name in self._RESTART_EXACT:
            a, b = getattr(self, name), getattr(other, name)
            if a != b:
                diffs.append(f"{name}: {a} (requested) != {b} (loaded model)")
        if diffs:
            raise ValueError(
                "restart-train: models not compatible for restart "
                "(mart.cc:493-517): " + "; ".join(diffs)
            )
        self.ensemble = other.ensemble
        self._depth_bound = other._depth_bound

    def _dispatch_block_size(self) -> int:
        """Boosting iterations per device dispatch (lax.scan block).

        Default 1: the one-deep dispatch pipeline hides the per-dispatch
        latency.  QRTPU_BLOCK_K overrides it (not yet measured on the GPU);
        early-stop/partial-save semantics hold for any k."""
        import os

        return int(os.environ.get("QRTPU_BLOCK_K", 1))

    def _post_init(self, tr: TrainData) -> None:
        """Subclass hook run once after data prep (e.g. DART bookkeeping)."""

    def _update_presence(self, m: int, tr: TrainData, scores_tr, key):
        """Subclass hook: per-iteration doc pool (bool [N] or None = keep).
        Used by the negative-sampling learners (selective/stochastic)."""
        return None

    def _post_iteration(self, m: int, improved: bool) -> None:
        """Subclass hook after each boosting iteration (adaptive samplers)."""

    # -- inference -----------------------------------------------------------

    def _require_model(self) -> EnsembleTensors:
        if self.ensemble is None:
            raise RuntimeError(f"{self.NAME}: no trained model")
        return self.ensemble

    def score_dataset(
        self, ds: Dataset, mesh: Optional[Mesh] = None
    ) -> np.ndarray:
        """Batch scores.  With ``mesh``, doc rows are sharded over every
        mesh axis and scored collectives-free (parallel/mesh.py::
        score_rows_sharded — the mesh analog of the per-doc OpenMP loop,
        ensemble.cc:96-123); the same fast-path dispatch applies per shard.
        """
        if mesh is not None:
            from quickrank_tpu.parallel.mesh import score_rows_sharded

            fn, tables, feats = self._dispatch_scorer(ds)
            return score_rows_sharded(fn, feats, tables, mesh)
        fn, X = self.device_scorer(ds)
        return np.asarray(fn(X))

    def _dispatch_scorer(self, ds: Dataset):
        """(scorer_fn, model_tables, host_feats): QS bitvector tables
        (trees/qs.py, any depth, bitwise the compensated descent); the
        oblivious bit-OR scorer is the _ObliviousFit override."""
        from quickrank_tpu.trees.qs import score_qs

        return score_qs, self._qs_tables(), ds.features

    def device_scorer(self, ds: Dataset):
        """(fn, dev_feats) for device-resident loops: ``fn`` maps the
        pre-uploaded (possibly feature-compacted) array to device scores
        with no host round-trip, same dispatch as score_dataset.
        quickscore.py chains timing rounds through it so the reported
        per-doc time matches the reference's pure in-memory loop
        (quickscore.cc:100-106) instead of paying a features upload and
        numpy conversion per round."""
        fn, tables, feats = self._dispatch_scorer(ds)
        return (lambda X: fn(X, tables)), jnp.asarray(feats)

    def _qs_tables(self):
        """QuickScorer bitvector tables (trees/qs.py; Kahan-compensated
        like the reference's double score accumulator).  Cached per
        ensemble."""
        ens = self._require_model()
        cached = getattr(self, "_qs_cache", None)
        if cached is not None and cached[0] is ens:
            return cached[1]
        from quickrank_tpu.trees.qs import ensemble_to_qs

        qs = ensemble_to_qs(ens)
        self._qs_cache = (ens, qs)
        return qs

    def feature_importances(
        self, num_features: Optional[int] = None, normalize: bool = True
    ) -> np.ndarray:
        """Split-count feature importances over the live trees: how many
        internal nodes split on each (global) feature id.  Returns f64
        ``[num_features]`` (width defaults to max used id + 1), normalized
        to sum to 1 unless ``normalize=False``.  Beyond reference parity —
        the dense SoA ensemble makes this a bincount."""
        ens = self._require_model()
        T = int(ens.num_trees)
        feat = np.asarray(ens.feature[:T])
        internal = ~np.asarray(ens.is_leaf[:T])
        used = feat[internal]
        used = used[used >= 0]
        width = int(num_features) if num_features else (
            int(used.max()) + 1 if used.size else 0
        )
        imp = np.bincount(used, minlength=width).astype(np.float64)[:width]
        if normalize and imp.sum() > 0:
            imp /= imp.sum()
        return imp

    def partial_scores_dataset(self, ds: Dataset) -> np.ndarray:
        # per-tree columns (Cleaver/LineSearch input), bitwise the
        # descent's leaf_value[node] per tree
        from quickrank_tpu.trees.qs import partial_scores_qs

        return np.asarray(
            partial_scores_qs(jnp.asarray(ds.features), self._qs_tables())
        )

    def get_weights(self) -> np.ndarray:
        ens = self._require_model()
        return np.asarray(ens.weight)[: int(ens.num_trees)]

    def update_weights(self, weights: np.ndarray) -> None:
        """Set per-tree weights, dropping zero-weighted trees
        (ensemble.cc:149-192)."""
        ens = self._require_model()
        T = int(ens.num_trees)
        w = np.zeros((ens.capacity,), np.float32)
        w[:T] = np.asarray(weights, np.float32)[:T]
        keep = np.flatnonzero(w != 0.0)
        sel = lambda x: jnp.asarray(np.asarray(x)[keep])  # noqa: E731
        self.ensemble = EnsembleTensors(
            feature=sel(ens.feature),
            threshold=sel(ens.threshold),
            threshold_bin=sel(ens.threshold_bin),
            left=sel(ens.left),
            right=sel(ens.right),
            is_leaf=sel(ens.is_leaf),
            leaf_value=sel(ens.leaf_value),
            weight=jnp.asarray(w[keep]),
            num_trees=jnp.asarray(len(keep), jnp.int32),
        )

    # -- XML interop (QuickRank format, io/xml_model.py) ---------------------

    def _info_dict(self) -> dict:
        """<ranker><info> payload (mart.cc:474-486)."""
        return {
            "trees": self.ntrees,
            "leaves": self.nleaves,
            "shrinkage": self.shrinkage,
            "leafsupport": self.minleafsupport,
            "discretization": self.nthresholds,
            "estop": self.esr,
            "subsample": self.subsample,
            "max_features": self.max_features,
            "collapse_leaves_factor": self.collapse_leaves_factor,
            # extensions (harmless extra <info> tags for the
            # reference parser, like collapse_leaves_factor above): keep
            # the grower configuration with the model so load + resume
            # reconstructs the same training setup
            "growth": self.growth,
            "split_pack": self.split_pack,
            "max_depth": self.max_depth,
        }

    def _to_xml(self):
        from quickrank_tpu.io.xml_model import ensemble_to_xml

        return ensemble_to_xml(self._require_model(), self._info_dict(), self.NAME)

    @staticmethod
    def _info_get(info, tag, cast, default):
        el = info.find(tag)
        return cast(el.text) if el is not None and el.text else default

    @classmethod
    def _ctor_kwargs_from_info(cls, info) -> dict:
        g = cls._info_get
        return dict(
            ntrees=g(info, "trees", int, 1000),
            shrinkage=g(info, "shrinkage", float, 0.1),
            nthresholds=g(info, "discretization", int, 255),
            nleaves=g(info, "leaves", int, 10),
            minleafsupport=g(info, "leafsupport", int, 1),
            esr=g(info, "estop", int, 100),
            subsample=g(info, "subsample", float, 1.0),
            max_features=g(info, "max_features", float, 1.0),
            growth=g(info, "growth", str, "best"),
            split_pack=g(info, "split_pack", int, 4),
            max_depth=g(info, "max_depth", int, 0),
        )

    @classmethod
    def _from_xml(cls, root):
        from quickrank_tpu.io.xml_model import parse_ensemble

        info = root.find("info")
        algo = cls(**cls._ctor_kwargs_from_info(info))
        ens, max_depth = parse_ensemble(root)
        algo.ensemble = ens
        algo._depth_bound = max_depth + 1
        return algo

    def __repr__(self):
        return (
            f"{self.NAME}(ntrees={self.ntrees}, shrinkage={self.shrinkage}, "
            f"nleaves={self.nleaves}, minls={self.minleafsupport}, "
            f"nthresholds={self.nthresholds}, esr={self.esr}, "
            f"subsample={self.subsample}, max_features={self.max_features})"
        )


def rescore_binned(ens: EnsembleTensors, sd: StepData, max_depth: int):
    """Full scoring pass over binned docs (used by warm restarts — the
    reference recomputes scores rather than checkpointing them,
    mart.cc:237-253).  Kahan-compensated over trees, matching the training
    loop's compensated score carry.

    Single-process runs ride bin-space QS bitvector tables (trees/qs.py:
    ``bin <= threshold_bin`` is exactly the value routing; the per-tree
    Kahan chain is preserved, so scores are BITWISE the descent scan's —
    tests/test_qs.py) instead of one descent per tree; MetaCleaver pays
    this every grow-prune cycle."""
    if jax.process_count() == 1 and int(ens.num_trees) > 0:
        # Single-controller only (see Dart._full_rescore): the host-built
        # QS tables are process-local; a multihost-global ``sd.binned``
        # in the same jit would raise incompatible-devices.
        from quickrank_tpu.trees.qs import ensemble_to_qs, score_qs

        qs = ensemble_to_qs(ens, space="bin")
        # raw binned: the f32 cast fuses inside the jitted score_qs
        # (an eager astype would materialize a ~1.4 GB copy at MSLR
        # scale) and the i32 signature shares one executable with
        # DART's QS dropped-set deltas
        return score_qs(sd.binned, qs)

    return _rescore_scan_j(ens, sd.binned, max_depth)


@partial(jax.jit, static_argnames=("max_depth",))
def _rescore_scan_j(ens: EnsembleTensors, binned, max_depth: int):
    """Kahan-compensated per-tree rescoring scan (the multi-process path
    of rescore_binned).  Jitted with ens/binned as ARGUMENTS: an eager
    scan would close over the ensemble tensors as constants and re-trace
    on every periodic rescore."""
    from quickrank_tpu.ops.scoring import kahan_add

    def body(carry, t):
        tree = ens.tree(t)
        d = tree_delta_binned(binned, tree, max_depth)
        w = jnp.where(t < ens.num_trees, ens.weight[t], 0.0)
        return kahan_add(carry[0], carry[1], w * d), None

    z = jnp.zeros((binned.shape[0],), jnp.float32)
    (out, _), _ = jax.lax.scan(body, (z, z), jnp.arange(ens.capacity))
    return out


def rebin_ensemble(
    ens: EnsembleTensors, thresholds: np.ndarray, force: bool = False
) -> EnsembleTensors:
    """Fill missing bin-space split points (threshold_bin == -1, the XML
    load sentinel) from the value-space thresholds.

    By ops/binning.py construction ``bin(v) <= t  <=>  v <= thresholds[t]``,
    so the bin-space twin of a split at value ``thr`` is the largest ``t``
    with ``thresholds[f][t] <= thr`` — exact when ``thr`` is itself a table
    entry (always true for self-trained models), and the closest
    quantization for foreign models (the reference re-quantizes imported
    models through stmap the same way, rtnode_histogram.cc:227-253).

    ``force=True`` recomputes EVERY internal node's bin id — required on
    warm starts: an in-process model carries bin ids from its *training*
    run's tables, which silently misroute against a different dataset's
    tables (XML loads are safe only because the sentinel forces the
    recompute).  For identical data the recompute is a bitwise no-op
    (``thr`` is an entry of the same table)."""
    feat = np.asarray(ens.feature)
    tbin = np.asarray(ens.threshold_bin).copy()
    need = (~np.asarray(ens.is_leaf)) & (feat >= 0)
    if not force:
        need &= tbin < 0
    if not need.any():
        return ens
    ti, ni = np.nonzero(need)
    rows = np.asarray(thresholds)[feat[ti, ni]]  # [K, B]
    thr = np.asarray(ens.threshold)[ti, ni][:, None]
    tbin[ti, ni] = np.clip((rows <= thr).sum(axis=1) - 1, 0, None)
    return ens.replace(threshold_bin=jnp.asarray(tbin))


def _copy_into(dst: EnsembleTensors, src: EnsembleTensors) -> EnsembleTensors:
    """Copy src's live trees into the head of dst (capacity grow for warm
    starts; src's node budget must fit dst's)."""
    T = int(src.num_trees)
    assert dst.max_nodes >= src.max_nodes, (dst.max_nodes, src.max_nodes)
    assert dst.capacity >= T, (dst.capacity, T)
    n = src.max_nodes
    put = lambda d, s: d.at[:T, :n].set(s[:T])  # noqa: E731
    return dst.replace(
        feature=put(dst.feature, src.feature),
        threshold=put(dst.threshold, src.threshold),
        threshold_bin=put(dst.threshold_bin, src.threshold_bin),
        left=put(dst.left, src.left),
        right=put(dst.right, src.right),
        is_leaf=put(dst.is_leaf, src.is_leaf),
        leaf_value=put(dst.leaf_value, src.leaf_value),
        weight=dst.weight.at[:T].set(src.weight[:T]),
        num_trees=jnp.asarray(T, jnp.int32),
    )


def _compact(ens: EnsembleTensors) -> EnsembleTensors:
    """Trim dead capacity beyond num_trees (host-side, post-training)."""
    T = int(ens.num_trees)
    cut = lambda x: jnp.asarray(np.asarray(x)[:T])  # noqa: E731
    return EnsembleTensors(
        feature=cut(ens.feature),
        threshold=cut(ens.threshold),
        threshold_bin=cut(ens.threshold_bin),
        left=cut(ens.left),
        right=cut(ens.right),
        is_leaf=cut(ens.is_leaf),
        leaf_value=cut(ens.leaf_value),
        weight=cut(ens.weight),
        num_trees=jnp.asarray(T, jnp.int32),
    )
