"""Histogram passes (ops/histogram.py): the wrapper's shapes, padding, node
packing and choice of kernel against an f64 numpy reference.

On the CPU every pass is the XLA scatter reference; the CUDA kernel's own
checks are the ``gpu``-marked tests at the end (and chip_smoke.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from quickrank_tpu.ops import cuda_histogram
from quickrank_tpu.ops import histogram as H


def _numpy_hist(binned, values, pos, num_nodes, num_bins):
    """f64 reference: [num_nodes, F, B, C]; out-of-range nodes and bins
    add nothing."""
    N, F = binned.shape
    C = values.shape[1]
    out = np.zeros((num_nodes, F, num_bins, C))
    ok = (pos >= 0) & (pos < num_nodes)
    for f in range(F):
        b = binned[:, f].astype(np.int64)
        keep = ok & (b >= 0) & (b < num_bins)
        key = pos[keep].astype(np.int64) * num_bins + b[keep]
        for c in range(C):
            out[:, f, :, c] = np.bincount(
                key, values[keep, c].astype(np.float64), num_nodes * num_bins
            ).reshape(num_nodes, num_bins)
    return out


def _problem(rng, N, F, num_bins, C, num_nodes, dtype):
    binned = rng.integers(0, num_bins + 1, size=(N, F)).astype(dtype)
    values = rng.normal(size=(N, C)).astype(np.float32)
    values[:, 0] = 1.0
    pos = rng.integers(-1, num_nodes + 2, size=N).astype(np.int32)
    return binned, values, pos


@pytest.mark.parametrize(
    "num_bins,C,num_nodes,dtype",
    [
        (255, 3, 1, np.uint8),
        (255, 3, 4, np.uint8),
        (255, 3, 40, np.uint8),  # more nodes than one kernel pass holds
        (63, 2, 16, np.uint8),
        (63, 3, 9, np.int32),
        (17, 3, 5, np.uint16),
        (2, 2, 3, np.uint8),
        (300, 3, 3, np.uint16),
    ],
)
def test_node_histograms_match_numpy(num_bins, C, num_nodes, dtype):
    rng = np.random.default_rng(num_bins * 100 + num_nodes)
    binned, values, pos = _problem(rng, 700, 6, num_bins, C, num_nodes, dtype)
    got = np.asarray(
        H.node_histograms(
            jnp.asarray(binned), jnp.asarray(values), jnp.asarray(pos),
            None, num_nodes, num_bins, values_premasked=True,
        )
    )
    ref = _numpy_hist(binned, values, pos, num_nodes, num_bins)
    assert got.shape == (num_nodes, 6, num_bins, C)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])  # counts exact
    np.testing.assert_allclose(got[..., 1:], ref[..., 1:], rtol=1e-5, atol=1e-5)


def test_doc_mask_applies_unless_premasked(rng):
    binned, values, pos = _problem(rng, 300, 4, 31, 3, 2, np.uint8)
    mask = rng.uniform(size=300) < 0.6
    got = np.asarray(
        H.node_histograms(
            jnp.asarray(binned), jnp.asarray(values), jnp.asarray(pos),
            jnp.asarray(mask), 2, 31,
        )
    )
    ref = _numpy_hist(binned, values * mask[:, None], pos, 2, 31)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_pass_n0_offset_selects_node_range(rng):
    """A pass over nodes [n0, n0 + k) is the slice of the whole histogram."""
    binned, values, pos = _problem(rng, 400, 5, 15, 3, 8, np.uint8)
    whole = _numpy_hist(binned, values, pos, 8, 15)
    got = np.asarray(
        H.histogram_pass_xla(
            jnp.asarray(binned), jnp.asarray(values), jnp.asarray(pos), 3, 4, 15
        )
    )
    np.testing.assert_allclose(got, whole[3:7], rtol=1e-5, atol=1e-5)


def test_masked_histogram_is_single_node_pass(rng):
    binned, values, _ = _problem(rng, 500, 5, 63, 3, 1, np.uint8)
    mask = rng.uniform(size=500) < 0.3
    got = np.asarray(
        H.masked_histogram(
            jnp.asarray(binned), jnp.asarray(values), jnp.asarray(mask), 63
        )
    )
    ref = _numpy_hist(binned, values, np.where(mask, 0, -1), 1, 63)[0]
    assert got.shape == (5, 63, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "num_nodes,num_bins,C",
    [(1, 255, 3), (32, 255, 3), (33, 255, 3), (100, 255, 3), (512, 63, 2),
     (7, 8191, 3), (3, 20000, 3)],
)
def test_node_passes_cover_nodes_within_shared_memory(num_nodes, num_bins, C):
    passes = H.node_passes(num_nodes, num_bins, C)
    covered = [n for n0, k in passes for n in range(n0, n0 + k)]
    assert covered == list(range(num_nodes))
    per = cuda_histogram.max_nodes_per_pass(num_bins, C)
    for _, k in passes:
        assert k >= 1
        # one feature's [B, k, C] partial sums (odd stride) fit a block
        assert per == 0 or ((num_bins * k * C) | 1) <= cuda_histogram.SMEM_FLOATS
    assert len(passes) == (1 if per == 0 else -(-num_nodes // per))


@pytest.mark.parametrize(
    "dtype,num_bins,C,expect",
    [
        (np.uint8, 255, 3, True),
        (np.uint16, 8191, 3, True),
        (np.int32, 63, 2, True),
        (np.uint16, 8192, 3, False),  # one node's sums exceed shared memory
        (np.int64, 63, 3, False),
        (np.float32, 63, 3, False),
    ],
)
def test_kernel_choice_by_input(dtype, num_bins, C, expect):
    assert H.kernel_takes(dtype, num_bins, C) is expect


def _pass_fn(num_bins=31):
    return lambda b, v, p: H.histogram_pass(b, v, p, 0, 2, num_bins)


def _pass_args():
    return (
        jax.ShapeDtypeStruct((64, 4), jnp.uint8),
        jax.ShapeDtypeStruct((64, 3), jnp.float32),
        jax.ShapeDtypeStruct((64,), jnp.int32),
    )


def test_cuda_lowering_calls_the_kernel():
    """Lowered for CUDA (possible without a GPU), the pass is the FFI
    kernel; lowered for the CPU it is the scatter and names no kernel."""
    traced = jax.jit(_pass_fn()).trace(*_pass_args())
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    cpu = traced.lower(lowering_platforms=("cpu",)).as_text()
    assert cuda_histogram.TARGET in cuda
    assert cuda_histogram.TARGET not in cpu
    assert "scatter" in cpu


def test_inputs_the_kernel_refuses_stay_on_xla_for_cuda():
    traced = jax.jit(_pass_fn(num_bins=9000)).trace(*_pass_args())
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    assert cuda_histogram.TARGET not in cuda


@pytest.mark.gpu
@pytest.mark.parametrize("num_bins,C,k", [(255, 3, 4), (63, 2, 16)])
def test_cuda_kernel_matches_numpy(num_bins, C, k):
    rng = np.random.default_rng(k)
    binned, values, pos = _problem(rng, 50_000, 136, num_bins, C, k, np.uint8)
    got = np.asarray(
        jax.jit(
            lambda b, v, p: cuda_histogram.histogram_pass_cuda(b, v, p, 0, k, num_bins)
        )(jnp.asarray(binned), jnp.asarray(values), jnp.asarray(pos))
    )
    ref = _numpy_hist(binned, values, pos, k, num_bins)
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])
    np.testing.assert_allclose(got[..., 1:], ref[..., 1:], rtol=1e-5, atol=1e-4)
