"""Process set-up of the entry points: the compile cache's location and
the --platform choice (a missing card is an error, not a CPU run)."""

import os
import subprocess
import sys

import pytest

from haslr_tpu import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_dir_from_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert runtime.compile_cache_dir() == os.path.join(REPO, ".jax_cache")


def _cache_dir_in_fresh_process(env_value):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = (
        "import jax; from haslr_tpu import runtime; "
        "print(runtime.init_compile_cache()); "
        "print(jax.config.jax_compilation_cache_dir)"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return res.stdout.split()


@pytest.mark.parametrize("set_var", [True, False])
def test_init_compile_cache(tmp_path, set_var):
    """Set: JAX uses the variable and the helper sets nothing.  Unset:
    the helper points JAX at <checkout>/.jax_cache."""
    want = str(tmp_path / "cache") if set_var else os.path.join(
        REPO, ".jax_cache")
    helper, jax_dir = _cache_dir_in_fresh_process(want if set_var else None)
    assert helper == want and jax_dir == want


@pytest.mark.parametrize("cli", ["haslr", "haslr_assemble"])
def test_platform_gpu_without_a_card_fails(cli, tmp_path):
    """--platform gpu (the default) must fail when JAX cannot start a
    CUDA backend, before any work and without falling back."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    args = {
        "haslr": ["-o", str(tmp_path / "o"), "-g", "10k", "-l", "x.fa",
                  "-x", "pacbio", "-s", "y.fq"],
        "haslr_assemble": ["-c", "c.fa", "-l", "x.fa", "-m", "m.paf",
                           "-d", str(tmp_path / "d")],
    }[cli]
    res = subprocess.run(
        [sys.executable, "-m", f"haslr_tpu.cli.{cli}", *args,
         "--platform", "gpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert "--platform gpu" in res.stderr
    assert not (tmp_path / "o").exists() and not (tmp_path / "d").exists()
