"""Where the codec's batched device stages run, and where JAX keeps its
compile cache.

The encoder analysis (encode/device_analysis.py) and the chained decode
pipeline (decode/device_pipeline.py) are integer-exact twins of host code,
so running them is a pure speed choice. `Encoder` and `Decoder` take that
choice as an argument; `None` leaves it to the backend JAX finds.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

REPO_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = REPO_ROOT / ".jax_cache"


def device_stages_on(choice: Optional[bool]) -> bool:
    """Resolve an entry point's device argument: True/False force the
    choice; None means on exactly when JAX's default backend is the GPU."""
    if choice is not None:
        return bool(choice)
    import jax
    return jax.default_backend() == "gpu"


def describe_choice(on: bool) -> str:
    """One line for a command's stderr: the backend and the choice made."""
    import jax
    return (f"backend {jax.default_backend()}: device stages "
            f"{'on' if on else 'off'}")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at JAX_COMPILATION_CACHE_DIR
    when that is set (JAX reads it itself; nothing else is changed), else
    at the fixed `.jax_cache/` of the checkout. Returns the directory.

    Called by the command-line entry points, never at package import, so
    library users and the tests keep JAX's defaults."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
