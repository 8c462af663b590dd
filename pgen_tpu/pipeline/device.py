"""Backend selection and the persistent compile cache for the device provider.

Every ``--provider device`` entry calls :func:`device_backend` before it
compiles anything. A user who asked for the device and has no GPU gets an
error, never a silent run on the CPU; the one exception is an explicit
``JAX_PLATFORMS=cpu``, which is how the tests drive the device path.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


class DeviceUnavailableError(RuntimeError):
    """--provider device was asked for and JAX found no accelerator."""


def compilation_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``.

    The default is a fixed path: a cache under a temporary, per-process or
    per-run name would never be hit again."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(CHECKOUT / ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set JAX already reads it, and no
    other directory is set here. Must run before the process's first
    compile: JAX decides once per process whether the cache is used."""
    cache = compilation_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        import jax

        jax.config.update("jax_compilation_cache_dir", cache)
    return cache


def device_backend() -> str:
    """The JAX backend ``--provider device`` runs on (e.g. ``"gpu"``).

    Enables the compile cache on an accelerator. Raises
    :class:`DeviceUnavailableError` when JAX found only the CPU, unless
    ``JAX_PLATFORMS`` names ``cpu`` explicitly."""
    import jax

    backend = jax.default_backend()
    if backend != "cpu":
        enable_compilation_cache()
        return backend
    platforms = os.environ.get("JAX_PLATFORMS", "").replace(" ", "").split(",")
    if "cpu" not in platforms:
        raise DeviceUnavailableError(
            "--provider device needs a GPU, but JAX found only the CPU "
            "backend; use --provider native, or set JAX_PLATFORMS=cpu to run "
            "the device path on the CPU on purpose"
        )
    return backend


def gpu_name_and_power_limit() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit`` output (one line per
    card), or None where nvidia-smi is absent. Reads no JAX state, so it
    never opens the card. A card set below its maximum power limit runs
    slower under load: every device number is reported beside this."""
    import subprocess

    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() if r.returncode == 0 else None
