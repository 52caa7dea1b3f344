"""Where JAX keeps its persistent compilation cache.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this module
sets nothing.  Otherwise accelerator runs cache at the fixed path
<checkout>/.cache/jax_cache: the path is part of the cache key, so it
must not move between runs.  CPU runs keep no persistent cache: XLA:CPU
entries are specific to the host's instruction set, and CPU compiles are
cheap.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".cache", "jax_cache")
)


def apply_cache_dir(platform: str) -> None:
    """Point JAX's persistent cache for `platform` (a JAX_PLATFORMS value,
    "" when JAX picks the backend itself)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    cpu = platform.split(",")[0].strip() == "cpu"
    jax.config.update("jax_compilation_cache_dir", None if cpu else DEFAULT_DIR)
