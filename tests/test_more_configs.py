"""Remaining BASELINE configs: -1 -k51 trimming, stdin input, -E count-only."""

import subprocess
import sys

import pytest

from bfc_jax.models import device_pipeline as DP
from bfc_jax.opts import Opts

from . import datagen, oracle


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("cfg")
    return datagen.standard_dataset(str(d), genome_len=12000, n_reads=3000,
                                    read_len=120)


@pytest.mark.slow
def test_trim_k51(dataset):
    """BASELINE config 2: k-mer trimming with -1 -k51 (k > 32 path)."""
    ref_out, _ = oracle.run_bfc(["-1", "-k51", "-b24", "-t1", dataset])
    opt = Opts()
    opt.k = 51
    opt.bf_shift = 24
    opt.filter_mode = True
    mine = DP.run_device(opt, dataset)
    assert mine.encode() == ref_out


@pytest.mark.slow
def test_stdin_input(dataset):
    import os

    ref_out, _ = oracle.run_bfc(["-k21", "-b24", "-t1", "-"],
                                stdin=open(dataset, "rb").read())
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ""
    p = subprocess.run(
        [sys.executable, "-m", "bfc_jax", "-k21", "-b24", "-"],
        input=open(dataset, "rb").read(), capture_output=True, env=env,
        timeout=900,
    )
    assert p.returncode == 0, p.stderr.decode()
    assert p.stdout == ref_out
