"""Split-statistics histograms over binned features.

Replacement of ``RTNodeHistogram`` (include/learning/tree/
rtnode_histogram.h:26, src/learning/tree/rtnode_histogram.cc:41-217): instead
of per-node cumulative ``sumlbl[f][t]`` / ``count[f][t]`` arrays rebuilt with
OpenMP loops, histograms are dense ``[F, B, C]`` tensors built by one pass
over the doc axis and cumulative sums are taken at gain-scan time.

Channels (C axis): 0 = doc count, 1 = sum of gradients (pseudoresponses),
2 = sum of squared gradients (backs the node deviance used as the best-first
split priority, rt.cc:59-76).

Every histogram is built by passes of one contract (:func:`histogram_pass`):
the [k, F, B, C] histograms of the docs whose node id is n0 .. n0+k-1.  On
the GPU a pass is the CUDA kernel of ops/cuda_histogram.py (shared-memory
partial sums per block); on the CPU it is the plain XLA scatter-add
:func:`histogram_pass_xla`, which is also the kernel's reference.  The
choice is made when the program is lowered for its device
(``lax.platform_dependent``), so a run on ``jax.devices("cpu")`` in a GPU
process takes the CPU branch.

In sharded training each device builds the histogram of its local docs and
the results are ``psum``-reduced over the mesh axis — the single cross-
device collective of the training loop (SURVEY.md §2.9).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from quickrank_tpu.ops import cuda_histogram


def doc_channels(grad: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Per-doc channel values ``[N, 3]`` = (1, g, g^2), zeroed where masked."""
    m = mask.astype(grad.dtype)
    return jnp.stack([m, grad * m, grad * grad * m], axis=-1)


def histogram_pass_xla(
    binned: jnp.ndarray,
    values: jnp.ndarray,
    pos: jnp.ndarray,
    n0: int,
    k: int,
    num_bins: int,
) -> jnp.ndarray:
    """``out[i, f, b, c]`` = sum of ``values[n, c]`` over docs with
    ``pos[n] == n0 + i`` and ``binned[n, f] == b``: ``[k, F, B, C]`` f32.

    The plain XLA reference of the pass contract: one flat scatter-add
    keyed by (node, feature, bin).  Docs outside the node range and
    out-of-range bin ids (bin == num_bins happens for features past the
    FLT_MAX sentinel, e.g. +inf values) are DROPPED per (doc, feature)
    element — a clamp would count them in the top bin.  ``values`` must be
    zero for docs outside the doc mask."""
    binned = binned.astype(jnp.int32)  # u8 storage would overflow the keys
    N, F = binned.shape
    C = values.shape[-1]
    node = pos.astype(jnp.int32) - n0
    node_ok = (node >= 0) & (node < k)
    ok = node_ok[:, None] & (binned >= 0) & (binned < num_bins)
    fidx = jnp.arange(F, dtype=jnp.int32)[None, :]
    flat = (jnp.where(node_ok, node, 0)[:, None] * F + fidx) * num_bins + (
        jnp.clip(binned, 0, num_bins - 1)
    )
    flat = jnp.where(ok, flat, k * F * num_bins)  # trash slot, sliced away
    vals = jnp.broadcast_to(values.astype(jnp.float32)[:, None, :], (N, F, C))
    hist = jnp.zeros((k * F * num_bins + 1, C), dtype=jnp.float32)
    hist = hist.at[flat.reshape(-1)].add(
        vals.reshape(-1, C), mode="drop", unique_indices=False
    )
    return hist[:-1].reshape(k, F, num_bins, C)


def kernel_takes(binned_dtype, num_bins: int, num_channels: int) -> bool:
    """Whether the GPU kernel serves a pass of this input: a bin dtype it
    reads, and one node's [B, C] partial sums per feature in one block's
    shared memory (up to 8191 bins at three channels).  Otherwise the GPU
    takes the XLA scatter too."""
    return jnp.dtype(binned_dtype) in [
        jnp.dtype(d) for d in cuda_histogram.BIN_DTYPES
    ] and cuda_histogram.max_nodes_per_pass(num_bins, num_channels) >= 1


def node_passes(num_nodes: int, num_bins: int, num_channels: int):
    """``[(n0, k), ...]``: the node ranges of the passes that build
    ``num_nodes`` histograms, each small enough for the GPU kernel's shared
    memory (one pass when not even one node fits: the XLA scatter takes
    it).  The same split runs on every device, so the CPU tests cover
    it."""
    per = cuda_histogram.max_nodes_per_pass(num_bins, num_channels) or num_nodes
    return [(n0, min(per, num_nodes - n0)) for n0 in range(0, num_nodes, per)]


def histogram_pass(binned, values, pos, n0: int, k: int, num_bins: int):
    """One pass of the contract of :func:`histogram_pass_xla`: the CUDA
    kernel on the GPU, the XLA scatter on the CPU (chosen at lowering)."""
    args = (binned, values, pos)

    def xla(b, v, p):
        return histogram_pass_xla(b, v, p, n0, k, num_bins)

    if not kernel_takes(binned.dtype, num_bins, values.shape[-1]):
        return xla(*args)

    def cuda(b, v, p):
        return cuda_histogram.histogram_pass_cuda(b, v, p, n0, k, num_bins)

    return jax.lax.platform_dependent(*args, cpu=xla, cuda=cuda)


def node_histograms(
    binned: jnp.ndarray,
    values: jnp.ndarray,
    node_of_doc: jnp.ndarray,
    doc_mask: jnp.ndarray,
    num_nodes: int,
    num_bins: int,
    values_premasked: bool = False,
) -> jnp.ndarray:
    """Histograms for every node at once: ``[num_nodes, F, B, C]``.

    The batched equivalent of building an RTNodeHistogram per fringe node
    (rtnode_histogram.cc:41-70).  binned: ``[N, F]`` bin ids (u8/u16/i32);
    values: ``[N, C]``; node_of_doc: i32 ``[N]``.  Docs with node id
    outside [0, num_nodes) or masked out contribute nothing.  Pass
    ``values_premasked=True`` when value rows of docs outside ``doc_mask``
    are already zero — it skips an [N, C] select."""
    if not values_premasked:
        values = jnp.where(doc_mask[:, None], values, 0.0)
    outs = [
        histogram_pass(binned, values, node_of_doc, n0, k, num_bins)
        for n0, k in node_passes(num_nodes, num_bins, values.shape[-1])
    ]
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)


def masked_histogram(
    binned: jnp.ndarray,
    values: jnp.ndarray,
    mask: jnp.ndarray,
    num_bins: int,
) -> jnp.ndarray:
    """Histogram of one doc subset: ``hist[f, b, c] = sum over docs in mask
    with bin(doc, f) == b of values[doc, c]`` — ``[F, B, C]`` float32.

    Docs outside ``mask`` contribute nothing: the mask is folded in as a
    node id (in-subset docs are node 0, the rest node -1), so the best-
    first grower builds its channel rows once per tree and passes only the
    per-split subset."""
    pos = jnp.where(mask, 0, -1).astype(jnp.int32)
    return histogram_pass(binned, values, pos, 0, 1, num_bins)[0]
