"""The pytree dataclass helper (utils/struct.py) that carries every device
container (Tree, EnsembleTensors, StepData, PaddedDataset, QS tables)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from quickrank_tpu.utils import struct


@struct.dataclass
class _Pair:
    a: jnp.ndarray
    b: jnp.ndarray
    n: int = struct.field(pytree_node=False, default=3)


def test_pytree_round_trip():
    p = _Pair(a=jnp.arange(4.0), b=jnp.ones((2, 2)), n=5)
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2  # the static field is not a leaf
    q = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(q, _Pair) and q.n == 5
    np.testing.assert_array_equal(np.asarray(q.a), np.arange(4.0))
    doubled = jax.tree.map(lambda x: 2 * x, p)
    np.testing.assert_array_equal(np.asarray(doubled.b), 2 * np.ones((2, 2)))
    assert doubled.n == 5


def test_replace_and_frozen():
    p = _Pair(a=jnp.zeros(2), b=jnp.zeros(2))
    q = p.replace(a=jnp.ones(2))
    np.testing.assert_array_equal(np.asarray(q.a), np.ones(2))
    np.testing.assert_array_equal(np.asarray(p.a), np.zeros(2))  # copy
    assert q.n == 3
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.ones(2)


def test_static_field_is_compile_time_under_jit():
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.n)
        return p.a * p.n  # p.n is a Python int while tracing

    p = _Pair(a=jnp.ones(3), b=jnp.zeros(1), n=4)
    np.testing.assert_array_equal(np.asarray(f(p)), 4 * np.ones(3))
    f(p.replace(a=jnp.zeros(3)))  # same static value: no retrace
    assert traces == [4]
    np.testing.assert_array_equal(np.asarray(f(p.replace(n=2))), 2 * np.ones(3))
    assert traces == [4, 2]  # a new static value retraces


def test_device_containers_use_the_helper():
    from quickrank_tpu.trees.structs import EnsembleTensors

    ens = EnsembleTensors.empty(3, 5)
    out = jax.jit(lambda e: e.replace(num_trees=e.num_trees + 1))(ens)
    assert int(out.num_trees) == 1 and out.capacity == 3
