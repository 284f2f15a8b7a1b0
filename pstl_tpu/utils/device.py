"""Device identity and the persistent compile cache, for the entry points.

``bench.py``, ``chip_smoke.py`` and ``pstl_tpu.cli`` call
:func:`configure_compile_cache` before their first compile.  The two
measurement scripts also call :func:`require_gpu`, so that a run without a
GPU stops instead of printing a CPU number under a device metric's name.
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict

#: the checkout's root (the directory that holds the ``pstl_tpu`` package)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at ``JAX_COMPILATION_CACHE_DIR``
    when that is set, else at the fixed ``<checkout>/.jax_cache`` (the
    directory is part of the cache's key); returns the directory."""
    import jax

    d = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
         or os.path.join(ROOT, ".jax_cache"))
    jax.config.update("jax_compilation_cache_dir", d)
    return d


def device_info() -> Dict:
    """The first device as JAX reports it, plus the device count."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> Dict:
    """:func:`device_info`, or ``SystemExit`` when JAX's first device is
    not a GPU (a measurement never falls back to the CPU)."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is a "
                         f"{info['platform']} ({info['kind']})")
    return info


def gpu_card() -> str:
    """``name, power.limit`` of the card as ``nvidia-smi`` reports them.
    A card below its full power limit runs slower under load, so every
    time measured on it is printed beside this line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip()
