"""Process-level JAX set-up for the entry points (both CLIs and the
benchmark scripts): the platform the device stages run on, and where
compiled programs are cached."""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# --platform value -> jax_platforms value
PLATFORMS = {"gpu": "cuda", "cpu": "cpu"}


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself),
    else ``<checkout>/.jax_cache``."""
    return (
        os.environ.get("JAX_COMPILATION_CACHE_DIR")
        or os.path.join(CHECKOUT, ".jax_cache")
    )


def init_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    :func:`compile_cache_dir`; sets nothing when the environment variable
    already does.  Call before the first compile: JAX fixes the cache
    location when it first uses it."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def select_platform(name: str) -> None:
    """Pin JAX to one platform: ``gpu`` (CUDA) or ``cpu``.  A missing
    card is an error, never a silent run on the CPU."""
    import jax

    jax.config.update("jax_platforms", PLATFORMS[name])
    try:
        got = jax.default_backend()
    except Exception as e:  # JAX reports a failed backend start oddly
        raise RuntimeError(
            f"--platform {name}: JAX could not start its "
            f"{PLATFORMS[name]} backend ({type(e).__name__}: {e})"
        ) from e
    if got != name:
        raise RuntimeError(f"--platform {name}: JAX runs on {got!r}")
