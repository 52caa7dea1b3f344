"""Oracle harness: build and run the reference bfc binary.

The reference sources are read-only at /root/reference; objects and the
binary are built inside the repo under .ref_build/ (gitignored).  Used
only by tests/benches to produce golden outputs - no reference code is
linked into the framework itself.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
REF = Path("/root/reference")
BUILD = REPO / ".ref_build"
BIN = BUILD / "bfc"
HASH2CNT = BUILD / "hash2cnt"


def build_reference() -> Path:
    """Build the reference binaries once; skips the calling test when the
    reference sources are not on this machine."""
    import fcntl

    if not (REF / "bfc.c").is_file():
        import pytest

        pytest.skip(f"reference bfc sources not found at {REF}")
    BUILD.mkdir(exist_ok=True)
    # parallel test workers (pytest-xdist) race the one-time build:
    # serialize it with an exclusive file lock
    lk = open(BUILD / ".lock", "w")
    fcntl.flock(lk, fcntl.LOCK_EX)
    try:
        _build_locked()
    finally:
        fcntl.flock(lk, fcntl.LOCK_UN)
        lk.close()
    return BIN


def _build_locked() -> None:
    srcs = [REF / f for f in ["bfc.c", "bbf.c", "bseq.c", "correct.c", "count.c", "htab.c", "kthread.c", "utils.c"]]
    if not BIN.exists() or any(s.stat().st_mtime > BIN.stat().st_mtime for s in srcs):
        subprocess.run(
            ["gcc", "-g", "-O2", "-Wno-unused-function", "-o", str(BIN)]
            + [str(s) for s in srcs]
            + ["-lm", "-lz", "-lpthread"],
            check=True,
            cwd=str(BUILD),
        )
    if not HASH2CNT.exists():
        subprocess.run(
            ["gcc", "-g", "-O2", "-o", str(HASH2CNT), str(REF / "hash2cnt.c"), "-lz"],
            check=True,
            cwd=str(BUILD),
        )


def run_bfc(args, stdin=None, timeout=600):
    """Run the reference binary; returns (stdout_bytes, stderr_bytes)."""
    build_reference()
    p = subprocess.run(
        [str(BIN)] + [str(a) for a in args],
        input=stdin,
        capture_output=True,
        timeout=timeout,
    )
    if p.returncode != 0:
        raise RuntimeError(f"bfc failed: {p.stderr.decode()}")
    return p.stdout, p.stderr


def run_hash2cnt(dump_path, extra=()):
    build_reference()
    p = subprocess.run(
        [str(HASH2CNT)] + list(extra) + [str(dump_path)], capture_output=True, timeout=600
    )
    if p.returncode != 0:
        raise RuntimeError(f"hash2cnt failed: {p.stderr.decode()}")
    return p.stdout
