"""The compile-cache rule (utils/backend.py) and chip_smoke.py's refusal
to run without a GPU."""

import os
import shutil
import subprocess
import sys
import tempfile

import jax

from quickrank_tpu.utils import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _recorded_updates(monkeypatch):
    seen = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: seen.__setitem__(k, v))
    return seen


def test_cache_dir_from_env_is_left_to_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    seen = _recorded_updates(monkeypatch)
    assert backend.enable_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in seen  # jax reads the env itself


def test_cache_dir_without_env_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    seen = _recorded_updates(monkeypatch)
    path = backend.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert seen["jax_compilation_cache_dir"] == path


def test_cache_dir_is_no_temporary_name(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = backend.compile_cache_dir()
    assert not path.startswith(tempfile.gettempdir() + os.sep)
    assert str(os.getpid()) not in path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    r = _smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stdout + r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _smoke(tmp_path, "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
