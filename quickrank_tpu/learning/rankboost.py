"""RankBoost — pairwise boosting of binary threshold weak rankers.

Re-design of ``Rankboost`` (src/learning/forests/rankboost.cc).
The reference keeps explicit per-query pair-weight matrices ``D[q][i][j]``
(rankboost.cc:276-292) and updates them multiplicatively every round
(rankboost.cc:419-445).  Materializing that tensor is O(Q * Dmax^2) — ~100 GB
at MSLR scale — so this implementation never builds it.  Instead it exploits
that the update is *separable*:

    D_t(i, j)  =  D_0(i, j) * exp(alpha_1 (h_1(i)-h_1(j))) * ... / Z
               ∝  exp(s_i - s_j) * pair_mask(i, j)

where ``s`` is exactly the cumulative weak-ranker score already tracked for
the metric.  Every quantity the algorithm reads off D factorizes:

  * the potential ``pi(d) = sum_j D(j,d) - sum_j D(d,j)`` (rankboost.cc:
    349-361) becomes ``exp(-s_d) * col(d) - exp(s_d) * row(d)`` where
    ``row``/``col`` are per-query prefix/suffix sums of ``exp(±s)`` over
    docs with lower/higher labels — computed per label level (LTR labels
    are graded) in O(Q * Dm * L) work and O(Q * Dm) memory;
  * the normalizer ``Z_t`` is the ratio ``S_t / S_{t-1}`` of consecutive
    pair-exponential sums ``S_t = sum_pairs exp(s_i - s_j)``;
  * the weak-ranker search — the reference's per-feature sorted-document
    walk over every threshold (rankboost.cc:365-415) — is a histogram of
    ``pi`` over (feature, bin) + suffix sum: ``r(f, t) = sum of pi over
    docs with bin(doc, f) > t``, maximized by one argmax over [F, B].
    The histogram reuses the pass tree growth uses (ops/histogram.py).

Reference semantics preserved:
  * pairs (i, j): i < j in dataset order with label_j > label_i
    (rankboost.cc:276-292 — the upper-triangular loop);
  * alpha = 0.5 ln((z + r)/(z - r)), with the r >= 1 escape hatch
    ``alpha = max_alpha * r`` (rankboost.cc:150-160);
  * weak ranker h(x) = 1 if x[f] > theta else 0 (sign fixed at +1, as the
    sign-flip branch is commented out in the reference :258-262);
  * best_T tracking on validation, model truncated to best_T.

Deviation: the reference holds D in double; here the factorized
exponentials are f32 with a per-query score recentering plus a ±20 clamp
on the centered scores, which bounds every partial sum well inside f32
range.  The clamp only binds when one pair's weight exceeds e^40 times
another's — i.e. when D has already collapsed onto a few pairs.

Multi-chip: pass ``mesh`` (1-D data mesh) — queries shard over the mesh;
the per-query prefix/suffix sums are shard-local and the only collectives
are the S / pair-histogram / metric psums (the cross-chip analog of the
reference's per-query OpenMP loops, rankboost.cc:300-347).

The trained model scores as  score(x) = sum_t alpha_t [x[f_t] > theta_t] —
batched as one column-gather + compare + matvec (the same shape as the
oblivious bit kernel).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from quickrank_tpu.data.dataset import Dataset, gather_padded, shard_and_pad
from quickrank_tpu.learning.base import LTRAlgorithm
from quickrank_tpu.metrics.metrics import Metric

#: centered-score clamp: exp bounded by e^20, any product of two by e^40,
#: and S (sum over ~1e7 pairs) by ~1e27 — safely inside f32.
_SCORE_CLAMP = 20.0
_MAX_LABEL_LEVELS = 64


def pair_potentials(s_flat, sd, levels: tuple, num_bins: int, axis=None):
    """Factorized weak-ranker search: from cumulative scores ``s_flat`` and
    a :class:`~quickrank_tpu.learning.mart.StepData`, return
    ``(f_star, t_star, best_r, S, pi)`` where ``pi`` is the flat [N]
    per-doc potential of the implicit pair-weight matrix
    ``D(i, j) = exp(s_i - s_j) * pair_mask / S`` and
    ``S = sum_pairs exp(s_i - s_j)`` (the running normalizer).

    Equivalent to materializing D, taking its column-minus-row sums
    (rankboost.cc:349-361) and walking every (feature, threshold)
    (rankboost.cc:365-415), but in O(Q*Dm*len(levels)) work and O(Q*Dm)
    memory.  ``levels`` must be the sorted distinct label values.
    """
    sp = gather_padded(s_flat, sd.pad_index, sd.slot_mask)  # [Q, Dm]
    lp = gather_padded(sd.labels, sd.pad_index, sd.slot_mask)
    # per-query recentering keeps exp() in range; the shift cancels inside
    # every u_i * v_j product, so S and pi are exact (up to the clamp)
    neg = jnp.float32(-3.0e38)
    smax = jnp.max(jnp.where(sd.slot_mask, sp, neg), axis=1)
    smin = jnp.min(jnp.where(sd.slot_mask, sp, -neg), axis=1)
    c = jnp.where(sd.query_mask, 0.5 * (smax + smin), 0.0)
    d = jnp.clip(sp - c[:, None], -_SCORE_CLAMP, _SCORE_CLAMP)
    u = jnp.where(sd.slot_mask, jnp.exp(d), 0.0)
    v = jnp.where(sd.slot_mask, jnp.exp(-d), 0.0)
    row = jnp.zeros_like(u)
    col = jnp.zeros_like(u)
    for lev in levels:  # static unroll, L is small (graded labels)
        is_l = (lp == lev) & sd.slot_mask
        vl = jnp.where(is_l, v, 0.0)
        ul = jnp.where(is_l, u, 0.0)
        # exclusive suffix/prefix sums along the slot (dataset-order) axis:
        # docs after i with this label / before i with it
        suf = jnp.flip(jnp.cumsum(jnp.flip(vl, 1), axis=1), 1) - vl
        pre = jnp.cumsum(ul, axis=1) - ul
        row = row + jnp.where(lp < lev, suf, 0.0)
        col = col + jnp.where(lp > lev, pre, 0.0)
    rowsum = u * row  # sum_j>i, l_j>l_i  exp(s_i - s_j)   (i first)
    colsum = v * col  # sum_j<i, l_j<l_i  exp(s_j - s_i)   (i second)
    S = jnp.sum(rowsum)
    if axis is not None:
        S = jax.lax.psum(S, axis)
    # no label-discordant pair anywhere -> zero potentials (and alpha = 0
    # downstream), matching the explicit-D formulation where every D entry
    # is zero; an unguarded 0/0 would poison scores and the saved model
    pi_p = jnp.where(S > 0.0, (colsum - rowsum) / jnp.maximum(S, 1e-30), 0.0)
    # padded [Q, Dm] -> flat [N] is a pure gather via the inverse map
    pi = pi_p[sd.inv_q, sd.inv_slot] * sd.doc_mask

    from quickrank_tpu.ops.histogram import doc_channels, masked_histogram

    hist = masked_histogram(
        sd.binned, doc_channels(pi, sd.doc_mask), sd.doc_mask, num_bins
    )[:, :, 1]
    if axis is not None:
        hist = jax.lax.psum(hist, axis)
    cum = jnp.cumsum(hist, axis=1)
    r = cum[:, -1:] - cum  # sum over bins strictly greater than t
    best = jnp.argmax(r)
    f_star = (best // num_bins).astype(jnp.int32)
    t_star = (best % num_bins).astype(jnp.int32)
    return f_star, t_star, r.reshape(-1)[best], S, pi


class RankBoost(LTRAlgorithm):
    NAME = "RANKBOOST"

    def __init__(self, ntrees: int = 1000, nthresholds: int = 255, seed: int = 0):
        """``ntrees`` = max weak rankers (reference flag num-trees -> T)."""
        self.T = int(ntrees)
        self.nthresholds = int(nthresholds)
        self.seed = int(seed)
        self.features_: Optional[np.ndarray] = None  # [T] i32
        self.thetas_: Optional[np.ndarray] = None  # [T] f32
        self.signs_: Optional[np.ndarray] = None  # [T] i32
        self.alphas_: Optional[np.ndarray] = None  # [T] f32
        self.best_T: int = 0
        self.history: dict = {}

    def learn(self, train, valid=None, metric=None, verbose=True, mesh=None):
        metric = metric or self.default_metric()
        num_shards = 1
        axis = None
        if mesh is not None:
            if len(mesh.axis_names) > 1:
                raise NotImplementedError(
                    "RANKBOOST supports 1-D (data) meshes only"
                )
            axis = mesh.axis_names[0]
            num_shards = int(mesh.shape[axis])

        from quickrank_tpu.learning.mart import TrainData, eval_metric

        tr = TrainData.build(train, self.nthresholds, num_shards=num_shards)
        thresholds_np = np.asarray(tr.step.thresholds)
        if mesh is not None:
            import dataclasses as _dc

            from quickrank_tpu.parallel.mesh import shard_step_data

            tr = _dc.replace(tr, step=shard_step_data(tr.step, mesh, axis))
        sd = tr.step
        B = tr.num_bins
        N_docs = tr.padded.num_docs_padded

        levels = [float(x) for x in np.unique(train.labels)]
        if len(levels) > _MAX_LABEL_LEVELS:
            raise ValueError(
                f"RANKBOOST: {len(levels)} distinct labels; the label-level "
                f"potential sums unroll per level (cap {_MAX_LABEL_LEVELS}). "
                "Quantize the labels first."
            )

        def _potentials_body(s_flat, sd):
            f_star, t_star, best_r, S, _ = pair_potentials(
                s_flat, sd, tuple(levels), B, axis
            )
            return f_star, t_star, best_r, S

        def _apply_body(s_flat, f_star, t_star, alpha, sd):
            fcol = jax.lax.dynamic_index_in_dim(
                sd.binned, f_star, axis=1, keepdims=False
            ).astype(jnp.int32)
            h = (fcol > t_star).astype(jnp.float32) * sd.doc_mask
            s2 = s_flat + alpha * h
            return s2, eval_metric(metric, sd, s2, axis)

        if mesh is None:
            _pot_j = jax.jit(_potentials_body)
            weak_search = lambda s: _pot_j(s, sd)  # noqa: E731
            _apply_j = jax.jit(_apply_body)
            apply_ranker = lambda s, f, t, a: _apply_j(s, f, t, a, sd)  # noqa: E731
        else:
            from quickrank_tpu.learning.mart import shard_map
            from quickrank_tpu.parallel.mesh import step_data_specs

            rep = P()
            Pd = P(axis)
            specs = step_data_specs(sd, axis)
            _pot_j = jax.jit(
                shard_map(
                    _potentials_body, mesh,
                    in_specs=(Pd, specs), out_specs=(rep, rep, rep, rep),
                )
            )
            weak_search = lambda s: _pot_j(s, sd)  # noqa: E731
            _apply_j = jax.jit(
                shard_map(
                    _apply_body, mesh,
                    in_specs=(Pd, rep, rep, rep, specs),
                    out_specs=(Pd, rep),
                )
            )
            apply_ranker = lambda s, f, t, a: _apply_j(s, f, t, a, sd)  # noqa: E731

        if valid is not None:
            from quickrank_tpu.data.dataset import pack_doc_values

            vpadded = shard_and_pad(valid)

        scores_flat = jnp.zeros((N_docs,), jnp.float32)
        features, thetas, alphas = [], [], []
        S_last = None
        z_t = 1.0
        max_alpha = 0.0
        best_va, best_T = -np.inf, 0
        hist_tr, hist_va = [], []
        valid_scores = (
            np.zeros(valid.num_docs, np.float64) if valid is not None else None
        )
        if verbose:
            print(f"# {self.NAME}: T={self.T}")
        for t in range(self.T):
            f_star, t_star, best_r, S = weak_search(scores_flat)
            # z_t = S_t / S_{t-1}: the reference's running Z (the sum of the
            # multiplicatively-updated D before renormalization) expressed
            # as a ratio of pair-exponential sums (rankboost.cc:419-445)
            S = float(S)
            if S_last:  # S == 0 (no discordant pairs) keeps z_t at 1
                z_t = S / S_last
            S_last = S
            f_star_i, t_star_i = int(f_star), int(t_star)
            theta = float(thresholds_np[f_star_i, t_star_i])
            r_t = z_t * float(best_r)
            if r_t >= 1:
                alpha = max_alpha * r_t
            else:
                alpha = float(np.log((z_t + r_t) / (z_t - r_t)) / 2.0)
                max_alpha = max(max_alpha, alpha)
            scores_flat, m_tr = apply_ranker(
                scores_flat, f_star, t_star, jnp.float32(alpha)
            )
            m_tr = float(m_tr)
            features.append(f_star_i)
            thetas.append(theta)
            alphas.append(alpha)
            hist_tr.append(m_tr)
            improved = False
            if valid is not None:
                valid_scores += alpha * (
                    valid.features[:, f_star_i] > theta
                ).astype(np.float64)
                m_va = float(
                    metric.evaluate_dataset(
                        vpadded, pack_doc_values(vpadded, valid_scores)
                    )
                )
                hist_va.append(m_va)
                if m_va > best_va:
                    best_va, best_T, improved = m_va, t + 1, True
            else:
                best_T = t + 1
            if verbose and (t < 5 or (t + 1) % 10 == 0 or improved):
                vtxt = f" {hist_va[-1]:.6f}" if valid is not None else ""
                print(
                    f"# {t + 1:5d} f={f_star_i} theta={theta:.4g} "
                    f"alpha={alpha:.4g} {m_tr:.6f}{vtxt}"
                    f"{' *' if improved else ''}"
                )

        self.best_T = best_T
        self.features_ = np.asarray(features[:best_T], np.int32)
        self.thetas_ = np.asarray(thetas[:best_T], np.float32)
        self.signs_ = np.ones(best_T, np.int32)
        self.alphas_ = np.asarray(alphas[:best_T], np.float32)
        self.history = {"train": hist_tr, "valid": hist_va, "best_T": best_T}
        return self.history

    # -- inference -----------------------------------------------------------

    def score_dataset(self, ds: Dataset) -> np.ndarray:
        if self.features_ is None:
            raise RuntimeError("RANKBOOST: no trained model")
        X = ds.features
        # one column gather + compare + matvec (weak rankers are bit features)
        bits = (X[:, self.features_] > self.thetas_[None, :]).astype(np.float32)
        return bits @ (self.alphas_ * self.signs_)

    def partial_scores_dataset(self, ds: Dataset) -> np.ndarray:
        X = ds.features
        bits = (X[:, self.features_] > self.thetas_[None, :]).astype(np.float32)
        return bits * self.signs_[None, :]

    def get_weights(self) -> np.ndarray:
        return np.asarray(self.alphas_, np.float64)

    def update_weights(self, weights) -> None:
        """Overwrite alphas (rankboost.cc:564-576; no removal semantics)."""
        w = np.asarray(weights, np.float32)
        if len(w) != self.best_T:
            raise ValueError("weight size mismatch")
        self.alphas_ = w

    # -- XML (rankboost.cc:540-562) -----------------------------------------

    def _to_xml(self):
        import xml.etree.ElementTree as ET

        root = ET.Element("ranker")
        info = ET.SubElement(root, "info")
        ET.SubElement(info, "type").text = self.NAME
        ET.SubElement(info, "maxweakrankers").text = str(self.T)
        ens = ET.SubElement(root, "ensemble")
        for t in range(self.best_T):
            wr = ET.SubElement(ens, "weakranker")
            ET.SubElement(wr, "id").text = str(t)
            ET.SubElement(wr, "featureid").text = str(int(self.features_[t]))
            ET.SubElement(wr, "theta").text = repr(float(self.thetas_[t]))
            ET.SubElement(wr, "sign").text = str(int(self.signs_[t]))
            ET.SubElement(wr, "alpha").text = repr(float(self.alphas_[t]))
        return root

    @classmethod
    def _from_xml(cls, root):
        info = root.find("info")
        T = int(info.find("maxweakrankers").text)
        algo = cls(ntrees=T)
        wrs = root.findall("ensemble/weakranker")
        algo.best_T = len(wrs)
        algo.features_ = np.asarray(
            [int(w.find("featureid").text) for w in wrs], np.int32
        )
        algo.thetas_ = np.asarray(
            [float(w.find("theta").text) for w in wrs], np.float32
        )
        algo.signs_ = np.asarray([int(w.find("sign").text) for w in wrs], np.int32)
        algo.alphas_ = np.asarray(
            [float(w.find("alpha").text) for w in wrs], np.float32
        )
        return algo
