"""Test configuration.

The suite runs on the CPU with 8 virtual devices, so the multi-device
sharding paths (mesh + shard_map + psum) run without a GPU:

    JAX_PLATFORMS=cpu python -m pytest tests/ -m 'not slow'

The virtual device count is set here, before any backend starts.  Tests
marked ``gpu`` need the card and skip without one; on the card they run
with ``python -m pytest tests/ -m gpu``.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from quickrank_tpu.utils.backend import enable_compile_cache  # noqa: E402

# persistent compilation cache, by the same rule as the CLIs
enable_compile_cache()

from quickrank_tpu.data.synthetic import make_train_valid_test  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``@pytest.mark.gpu`` tests where JAX has no GPU (decided per
    test, never at import: every xdist worker must collect the same
    tests)."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    try:
        jax.devices("gpu")
    except RuntimeError:
        pytest.skip("needs a GPU (run with `python -m pytest tests/ -m gpu`)")


@pytest.fixture(scope="session")
def splits():
    """Deterministic synthetic train/valid/test LETOR-style splits."""
    return make_train_valid_test()


@pytest.fixture()
def rng():
    """Function-scoped: a session-scoped shared stream made every
    rng-consuming test's data depend on which tests ran before it — a
    failure seen in a full run could not be reproduced by running the
    failing test alone (different draws), and adding any rng-using test
    reshuffled inputs for all later ones."""
    return np.random.default_rng(1234)
