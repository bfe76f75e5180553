"""Feature binning: threshold construction + doc->bin quantization.

Replacement of the reference's per-feature radix argsort +
threshold tables + ``stmap`` (src/learning/forests/mart.cc:127-170 and the
RTRootHistogram stmap build, src/learning/tree/rtnode_histogram.cc:227-253).
Instead of keeping per-feature sorted doc-id lists, we quantize every feature
value to a small bin id **once** per training run; all split statistics are
then dense ``[nodes, F, B]`` tensors and the sorted order is never needed.

Threshold semantics mirror the reference exactly:
  * collect sorted unique values of the feature;
  * if ``nthresholds == 0`` or #unique <= nthresholds: thresholds = unique
    values (every distinct value is a candidate split);
  * else: ``nthresholds`` equi-width points between fmin and fmax
    (mart.cc:158-168);
  * a final +inf sentinel threshold holds the "everything" cumulative bin
    (mart.cc:156,169 uses FLT_MAX).

A doc with value ``v`` lands in bin ``t`` iff ``thresholds[t-1] < v <=
thresholds[t]`` — i.e. a split at threshold ``t`` sends bins ``<= t`` left,
matching the reference's ``v <= threshold`` routing (rt.cc:330).
"""

from __future__ import annotations

import dataclasses

import numpy as np

FLT_MAX = np.float32(np.finfo(np.float32).max)


@dataclasses.dataclass
class BinnedFeatures:
    """Host-side binning result.

    thresholds: f32 ``[F, B]``; column ``f`` holds ``counts[f]`` real
        thresholds (ascending, last real one is +FLT_MAX) then +FLT_MAX pads.
    counts: i32 ``[F]`` number of real thresholds per feature.
    binned: i32 ``[N, F]`` bin id of each doc (0 .. counts[f]-1).
    """

    thresholds: np.ndarray
    counts: np.ndarray
    binned: np.ndarray

    @property
    def num_bins(self) -> int:
        return int(self.thresholds.shape[1])


def build_thresholds(
    features: np.ndarray, nthresholds: int = 0,
    min_table_width: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-feature threshold tables (mart.cc:136-170 semantics).

    Returns ``(thresholds [F, B], counts [F])`` with B = max real count;
    ``min_table_width`` (if given) is a FLOOR on B — extra columns carry
    the FLT_MAX sentinel.  (It is not a cap: capping is what
    ``nthresholds`` itself does.  The parameter was named ``max_bins``
    through r4, which read as a cap it never was.)

    Dispatches to the multithreaded C++ binner (native/binner.cc) when
    ``nthresholds > 0``; the per-feature numpy loop below is the fallback
    and the ``nthresholds == 0`` ("all unique values") path.
    """
    N, F = features.shape
    if not np.isfinite(features).all():
        # Threshold GRIDS must be finite: equi-width binning of a feature
        # containing ±inf yields inf/NaN steps and collapses the feature.
        # Build the tables from a finite-clamped copy; the raw values
        # still quantize correctly through apply_bins' [0, B-1] clamp
        # (non-finite -> top/bottom bin, the route-right contract).
        features = np.nan_to_num(
            features, nan=np.float32(3.4028235e38),
            posinf=np.float32(3.4028235e38),
            neginf=np.float32(-3.4028235e38),
        )
    if nthresholds > 0:
        try:
            from quickrank_tpu.ops._binning_native import (
                build_thresholds as _native_build,
            )

            out, counts = _native_build(features, nthresholds)
        except Exception:
            pass
        else:
            B = int(counts.max())
            if min_table_width is not None:
                B = max(B, min_table_width)
            if B < out.shape[1]:
                out = np.ascontiguousarray(out[:, :B])
            elif B > out.shape[1]:
                out = np.pad(
                    out, ((0, 0), (0, B - out.shape[1])),
                    constant_values=FLT_MAX,
                )
            return out, counts
    per_feature = []
    counts = np.zeros(F, dtype=np.int64)
    for f in range(F):
        uniq = np.unique(features[:, f].astype(np.float32))
        if nthresholds == 0 or len(uniq) <= nthresholds:
            th = np.concatenate([uniq, [FLT_MAX]]).astype(np.float32)
        else:
            # DOUBLE grid arithmetic (the native binner matches this
            # bit-for-bit): fmax - fmin can exceed FLT_MAX for full-range
            # features, overflowing a float32 step to inf and the first
            # entry to NaN (inf * 0)
            fmin, fmax = np.float64(uniq[0]), np.float64(uniq[-1])
            step = np.float64(abs(fmax - fmin)) / np.float64(nthresholds)
            th = (fmin + step * np.arange(nthresholds, dtype=np.float64)).astype(
                np.float32
            )
            th = np.concatenate([th, [FLT_MAX]]).astype(np.float32)
        per_feature.append(th)
        counts[f] = len(th)
    B = int(counts.max())
    if min_table_width is not None:
        B = max(B, min_table_width)
    out = np.full((F, B), FLT_MAX, dtype=np.float32)
    for f in range(F):
        out[f, : counts[f]] = per_feature[f]
    return out, counts.astype(np.int32)


def apply_bins(features: np.ndarray, thresholds: np.ndarray) -> np.ndarray:
    """Quantize values to bin ids: smallest t with value <= thresholds[t].

    Equivalent to the stmap built by RTRootHistogram
    (rtnode_histogram.cc:227-253): cumulative-bin id per doc per feature.
    Native C++ fast path; per-feature numpy searchsorted fallback.

    Ids are clamped to [0, B-1]: non-finite values (+inf past the FLT_MAX
    sentinel; NaN, which numpy sorts last) land in the TOP bin, so in bin
    space they route right at every real split — exactly the value-space
    descent's ``v <= thr -> False`` behavior.  Without the clamp they got
    id == B, which histogram passes drop per-element, leaving growers'
    per-feature statistics inconsistent with routing.
    """
    N, F = features.shape
    B = thresholds.shape[1]
    try:
        from quickrank_tpu.ops._binning_native import apply_bins as _native_apply

        return _native_apply(features, thresholds)
    except Exception:
        pass
    out = np.empty((N, F), dtype=np.int32)
    for f in range(F):
        # side='left': first index where thresholds[idx] >= v
        out[:, f] = np.searchsorted(
            thresholds[f], features[:, f].astype(np.float32), side="left"
        )
    np.minimum(out, B - 1, out=out)
    return out


def bin_dataset(
    features: np.ndarray, nthresholds: int = 0,
    min_table_width: int | None = None,
) -> BinnedFeatures:
    thresholds, counts = build_thresholds(
        features, nthresholds, min_table_width
    )
    binned = apply_bins(features, thresholds)
    return BinnedFeatures(thresholds=thresholds, counts=counts, binned=binned)
