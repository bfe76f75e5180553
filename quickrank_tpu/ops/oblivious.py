"""Traversal-free oblivious-ensemble scoring — the quickscore fast path.

The reference's fastest inference strategy compiles oblivious models into
branch-free C: ``leafidx |= (v[fid] > thresh) << (m-1-i)`` per level plus a
table lookup (src/io/generate_oblivious.cc:306-312, IPM'16).  Here it is
fully batched:

  1. gather the T*D split-feature columns (doc-independent indices: no
     per-doc feature gather);
  2. compare against the T*D thresholds -> bit planes;
  3. OR bits into leaf indices [N, T];
  4. leaf-value lookup as a one-hot contraction (fused into a matvec, no
     per-doc gather).

Tree chunking (scan) bounds the live [N, Tc, L] one-hot intermediate.
Value-space and bin-space scoring share one implementation (the threshold
table is the only difference: ``thr`` vs ``thr_bin``, exact either way).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from quickrank_tpu.trees.oblivious import ObliviousEnsemble


def _leaf_index(data: jnp.ndarray, fid: jnp.ndarray, thr: jnp.ndarray):
    """Leaf index of every doc in every tree: i32 [N, Tc] from fid/thr
    [Tc, D] — bit d (MSB first) is ``data[:, fid[t, d]] > thr[t, d]``."""
    D = fid.shape[1]
    shifts = (2 ** jnp.arange(D - 1, -1, -1, dtype=jnp.int32))[None, None, :]
    sel = jnp.take(data, fid.reshape(-1), axis=1)  # [N, Tc*D]
    bits = (sel > thr.reshape(-1)[None, :]).astype(jnp.int32)
    return jnp.sum(bits.reshape(data.shape[0], -1, D) * shifts, axis=-1)


@jax.jit
def oblivious_leaf_indices(
    features: jnp.ndarray, ens: ObliviousEnsemble
) -> jnp.ndarray:
    """i32 [N, T]: the leaf each doc reaches in each tree (value space) —
    the routing :func:`score_oblivious` sums over."""
    return _leaf_index(features, ens.fid, ens.thr)


def _score_impl(
    data: jnp.ndarray, thr_table: jnp.ndarray, ens: ObliviousEnsemble,
    tree_chunk: int,
) -> jnp.ndarray:
    T, D = ens.fid.shape
    L = ens.num_leaves
    live = (jnp.arange(T) < ens.num_trees).astype(jnp.float32)
    wleaf = ens.leaf * (ens.weight * live)[:, None]  # [T, L]

    def score_block(fid, thr, wl):
        # fid/thr: [Tc, D]; wl: [Tc, L]
        idx = _leaf_index(data, fid, thr)  # [N, Tc]
        onehot = (idx[..., None] == jnp.arange(L)[None, None, :]).astype(
            jnp.float32
        )
        # [N, Tc*L] @ [Tc*L] — XLA fuses the one-hot into the matvec
        # operand.  HIGHEST precision: a default f32 matmul may round the
        # leaf weights (TF32 on the GPU) before accumulating.
        return jnp.matmul(
            onehot.reshape(data.shape[0], -1), wl.reshape(-1),
            precision=jax.lax.Precision.HIGHEST,
        )

    if tree_chunk <= 0 or tree_chunk >= T:
        return score_block(ens.fid, thr_table, wleaf)

    assert T % tree_chunk == 0, (T, tree_chunk)
    C = T // tree_chunk

    def body(acc, args):
        fid, thr, wl = args
        return acc + score_block(fid, thr, wl), None

    resh = lambda x: x.reshape((C, tree_chunk) + x.shape[1:])  # noqa: E731
    out, _ = jax.lax.scan(
        body,
        jnp.zeros((data.shape[0],), jnp.float32),
        (resh(ens.fid), resh(thr_table), resh(wleaf)),
    )
    return out


@partial(jax.jit, static_argnames=("tree_chunk",))
def score_oblivious(
    features: jnp.ndarray, ens: ObliviousEnsemble, tree_chunk: int = 0
) -> jnp.ndarray:
    """Weighted scores f32 [N] = sum_t w_t * leaf[t, leafidx(doc, t)]."""
    return _score_impl(features, ens.thr, ens, tree_chunk)


@partial(jax.jit, static_argnames=("tree_chunk",))
def score_oblivious_binned(
    binned: jnp.ndarray, ens: ObliviousEnsemble, tree_chunk: int = 0
) -> jnp.ndarray:
    """Same scorer in bin space (training-time path): bit = bin > thr_bin."""
    return _score_impl(binned, ens.thr_bin, ens, tree_chunk)
