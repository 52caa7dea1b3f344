"""Where the persistent compilation cache goes, decided in a fresh process.

JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and the package
must not override it; otherwise accelerator runs cache at the fixed path
<checkout>/.cache/jax_cache and CPU runs keep no persistent cache.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT = os.path.join(REPO, ".cache", "jax_cache")

PROBE = (
    "import jax, bfc_jax\n"
    "from bfc_jax.utils.cache import apply_cache_dir\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
    "apply_cache_dir({platform!r})\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
)


@pytest.mark.parametrize("env_dir,platform,want", [
    ("/tmp/bfc-cache-probe", "", ["/tmp/bfc-cache-probe"] * 2),
    ("/tmp/bfc-cache-probe", "cpu", ["/tmp/bfc-cache-probe"] * 2),
    (None, "", ["None", DEFAULT]),
    (None, "cpu", ["None", "None"]),
], ids=["env-accel", "env-cpu", "default-accel", "default-cpu"])
def test_cache_dir_rule(env_dir, platform, want):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    p = subprocess.run(
        [sys.executable, "-c", PROBE.format(platform=platform)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split() == want
