"""CLI surface tests: flags, stdout contract, device choice, hash2cnt.

The byte comparisons against the reference binary skip where its
sources are absent (tests/oracle.py); the device CLI is also compared
with its own scalar model (--scalar) on the same data.
"""

import os
import subprocess
import sys

import pytest

import chip_smoke

from . import datagen, oracle


@pytest.fixture(scope="module")
def fq(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    return datagen.standard_dataset(str(d), genome_len=6000, n_reads=1500)


def run_cli(args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    p = subprocess.run(
        [sys.executable, "-m", "bfc_jax"] + args,
        capture_output=True, env=env, timeout=900,
    )
    assert p.returncode == 0, p.stderr.decode()
    return p.stdout


def test_cli_version():
    out = run_cli(["-v"])
    assert b"r181-compat" in out


def test_cli_correct_matches_reference(fq):
    ref_out, _ = oracle.run_bfc(["-k17", "-b22", "-t1", fq])
    mine = run_cli(["-k17", "-b22", fq])
    assert mine == ref_out


@pytest.mark.parametrize("mode", [[], ["-1"]], ids=["correct", "trim"])
def test_cli_device_matches_scalar(fq, tmp_path, mode):
    """The device path and the scalar model (--scalar) print identical
    bytes for correction and for trim (-1) on the same data."""
    argv = ["-k17", "-b22"] + mode + [fq]
    dev, sca = str(tmp_path / "dev.fq"), str(tmp_path / "sca.fq")
    chip_smoke.run_cli(argv, dev, str(tmp_path / "dev.log"))
    chip_smoke.run_cli(["--scalar"] + argv, sca, str(tmp_path / "sca.log"))
    chip_smoke.assert_same(dev, sca, " ".join(argv))
    assert os.path.getsize(dev) > 0


def test_cli_refuses_cpu_fallback(fq):
    """Without --cpu or JAX_PLATFORMS=cpu, a run that finds no GPU stops
    with a message instead of computing on the CPU."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run(
        [sys.executable, "-m", "bfc_jax", "-k17", "-b22", fq],
        capture_output=True, env=env, timeout=300,
    )
    assert p.returncode != 0
    assert p.stdout == b""
    assert b"pass --cpu" in p.stderr


def test_cli_trim_and_hash2cnt(fq, tmp_path):
    ref_out, _ = oracle.run_bfc(["-k17", "-b22", "-t1", "-1", fq])
    mine = run_cli(["-k17", "-b22", "-1", fq])
    assert mine == ref_out
    dump = tmp_path / "d.hash"
    run_cli(["-k17", "-b22", "-E", "-d", str(dump), fq])
    ref_txt = oracle.run_hash2cnt(dump)
    p = subprocess.run(
        [sys.executable, "-m", "bfc_jax.tools.hash2cnt", str(dump)],
        capture_output=True, timeout=300,
    )
    assert p.returncode == 0
    assert sorted(p.stdout.split()) == sorted(ref_txt.split())


def test_parse_size_suffix_forms():
    """strtod + first-suffix-char parsing (bfc.c:112-121)."""
    from bfc_jax.cli import parse_size

    assert parse_size("5m") == 5_000_001
    assert parse_size("3gb") == 3_000_000_001
    assert parse_size("4.5Mbp") == 4_500_001
    assert parse_size("1e3") == 1001
    assert parse_size("250k") == 250_001
    assert parse_size("7") == 8


def _trace_lines(stderr_bytes: bytes):
    """Extract the -V4 per-read search trace from stderr.

    Trace lines (correct.c:284-287,302-306,321-322,380-384) start with
    spaces or '*'; everything else on stderr is [M::...] progress logs
    or the version/CMD epilogue."""
    return [
        ln for ln in stderr_bytes.splitlines()
        if ln.startswith(b" ") or ln.startswith(b"*")
    ]


def test_v4_trace_parity(tmp_path):
    """-V4 stderr search trace is byte-identical to the reference's
    (correct.c:284-287 pop lines, 302-306 original-base lines, 321-322
    alternative-count lines, 380-384 path summary + masked sequence)."""
    fq = datagen.standard_dataset(
        str(tmp_path), genome_len=2000, n_reads=500, name="v4.fq"
    )
    ref_out, ref_err = oracle.run_bfc(["-k17", "-b20", "-t1", "-V4", fq])
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    p = subprocess.run(
        [sys.executable, "-m", "bfc_jax", "-k17", "-b20", "-V4", fq],
        capture_output=True, env=env, timeout=900,
    )
    assert p.returncode == 0, p.stderr.decode()
    assert p.stdout == ref_out
    mine = _trace_lines(p.stderr)
    ref = _trace_lines(ref_err)
    assert len(mine) == len(ref), (len(mine), len(ref))
    assert mine == ref
