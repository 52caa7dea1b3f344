"""bfc-jax: Illumina read error correction in JAX.

A from-scratch JAX/XLA re-design of the capabilities of lh3/bfc: two-pass
k-mer spectrum error correction (blocked-Bloom + count-hash spectrum
build, then a penalty-minimizing best-first per-read search), k-mer
trimming, spectrum dump/restore, refine mode, and a drop-in compatible
CLI.

Instead of pthreads over spin-locked shared tables, the engine runs
reads in lockstep batches per device, builds the spectrum with sort-based
exact counting (replicating the reference's sequential insert-order
semantics, including Bloom false-positive promotion), and scales over a
device mesh by hash-prefix sharding with all-to-all k-mer shuffles.
"""

import os as _os

# glibc malloc tuning, applied before numpy/jax allocate anything big:
# glibc's default mmap threshold makes every large numpy temporary a
# fresh mmap that is returned to the OS on free, so every multi-MB host
# pass re-pays its first-touch page faults.  Keeping large blocks on the
# heap free list (huge mmap threshold, never trim) pays them once per
# process.
try:
    import ctypes as _ctypes

    _libc = _ctypes.CDLL("libc.so.6", use_errno=True)
    _libc.mallopt(-3, 1 << 30)       # M_MMAP_THRESHOLD: 1 GiB
    _libc.mallopt(-1, 0x7FFFFFFF)    # M_TRIM_THRESHOLD: never trim
except (OSError, AttributeError):  # non-glibc platform
    pass

import jax

# The k-mer/hash pipeline is 64-bit integer arithmetic end to end.
jax.config.update("jax_enable_x64", True)

from .utils.cache import apply_cache_dir as _apply_cache_dir  # noqa: E402

_apply_cache_dir(_os.environ.get("JAX_PLATFORMS", ""))

from .opts import Opts  # noqa: E402,F401

__version__ = "0.1.0"
