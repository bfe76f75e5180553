"""The CUDA histogram pass (native/histogram_cuda.cu) as a JAX operation.

The library is compiled with ``nvcc`` for Hopper (``sm_90a``) on first use
into ``native/`` (git-ignored, like the other native builds) and bound
through ``jax.ffi``.  The compile counts as set-up time: about half a
minute, once per checkout.  ``nvcc`` is taken from ``PATH``, else from
``/usr/local/cuda/bin``.

The kernel has no interpret mode; ops/histogram.py::histogram_pass_xla is
its plain reference and runs wherever the kernel does not (the CPU).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np
import jax
import jax.numpy as jnp

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.normpath(
    os.path.join(_HERE, "..", "..", "native", "histogram_cuda.cu")
)
_LIB_PATH = os.path.join(os.path.dirname(_SRC), "libqrhist_cuda.so")
TARGET = "qr_node_histogram"

#: floats of shared memory one block may hold (kSmemFloats in the .cu)
SMEM_FLOATS = 24 * 1024
#: bin dtypes the kernel reads
BIN_DTYPES = (jnp.uint8, jnp.uint16, jnp.int32)

_lock = threading.Lock()
_registered = False


def max_nodes_per_pass(num_bins: int, num_channels: int) -> int:
    """Most nodes one kernel pass can hold: one feature's [B, k, C] partial
    sums (odd stride) must fit the block's shared memory.  0 when even one
    node does not fit."""
    return (SMEM_FLOATS - 1) // max(1, num_bins * num_channels)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the GPU histogram kernel is compiled on first use "
        "(put the CUDA toolkit's bin/ on PATH)"
    )


def build_library() -> str:
    """Compile the kernel library if it is missing or older than its
    source; returns its path.  The result is written under a temporary
    name and renamed, so concurrent builders never load a partial file."""
    if os.path.exists(_LIB_PATH) and (
        os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)
    ):
        return _LIB_PATH
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-o", tmp, _SRC,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def register() -> None:
    """Build (if needed) and register the FFI target; idempotent."""
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(build_library())
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.QrNodeHistogram), platform="CUDA"
        )
        _registered = True


def _gpu_present() -> bool:
    try:
        return bool(jax.devices("gpu"))
    except RuntimeError:
        return False


def histogram_pass_cuda(
    binned: jnp.ndarray,
    values: jnp.ndarray,
    pos: jnp.ndarray,
    n0: int,
    k: int,
    num_bins: int,
) -> jnp.ndarray:
    """[k, F, B, C] histogram of the docs with ``pos == n0 + i`` (the
    contract of ops/histogram.py::histogram_pass_xla), on the GPU."""
    if _gpu_present():
        # traced for every platform by lax.platform_dependent; only a
        # process that has a GPU compiles this branch and needs the library
        register()
    N, F = binned.shape
    C = values.shape[-1]
    return jax.ffi.ffi_call(
        TARGET, jax.ShapeDtypeStruct((k, F, num_bins, C), jnp.float32)
    )(
        binned,
        values.astype(jnp.float32),
        pos.astype(jnp.int32),
        n0=np.int32(n0),
        k=np.int32(k),
        num_bins=np.int32(num_bins),
    )
