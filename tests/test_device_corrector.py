"""Batched device correction vs the exact scalar model, read by read."""

import dataclasses

import numpy as np
import pytest

from bfc_jax.models import corrector as DC
from bfc_jax.models import counter as C
from bfc_jax.models import refmodel as M
from bfc_jax.opts import Opts

from . import datagen


@pytest.fixture(scope="module")
def setup():
    genome = datagen.make_genome(9000, seed=15)
    reads = datagen.simulate_reads(genome, 3000, read_len=100, err_rate=0.015, seed=16)
    opt = Opts()
    opt.k = 19
    opt.bf_shift = 23
    _, ch = M.count_reads(iter(reads), opt)
    ds = C.count_stream(iter(reads), opt, batch_reads=1024)
    _, _, mode = ch.hist()
    assert mode == ds.mode
    return opt, ch, ds, reads, mode


def _compare(opt, ch, ds, reads, mode, n_check):
    corr = DC.Corrector(opt, ds)
    seqs = [r[0] for r in reads[:n_check]]
    quals = [r[1] for r in reads[:n_check]]
    got = corr.correct_batch(seqs, quals)
    n_bad = 0
    for i, (st, s2, q2) in enumerate(got):
        mst, ms2, mq2 = M.ec1(opt, ch, mode, seqs[i], quals[i])
        if (dataclasses.astuple(st) != dataclasses.astuple(mst)
                or s2 != ms2 or q2 != mq2):
            n_bad += 1
            if n_bad <= 3:
                print(f"read {i}: got {st}\n        want {mst}")
                print(f"  in : {seqs[i]}")
                print(f"  got: {s2}")
                print(f"  want:{ms2}")
                print(f"  gotq: {q2}")
                print(f"  wantq:{mq2}")
    assert n_bad == 0, f"{n_bad}/{n_check} reads mismatch"


@pytest.mark.slow
def test_device_correction_matches_model(setup):
    opt, ch, ds, reads, mode = setup
    _compare(opt, ch, ds, reads, mode, 400)


@pytest.mark.slow
def test_device_correction_with_ns(setup):
    opt, ch, ds, reads, mode = setup
    # inject Ns and low-quality stretches to hit the edge paths
    import random

    rng = random.Random(77)
    mod = []
    for seq, qual in reads[:200]:
        s = list(seq)
        q = list(qual)
        for _ in range(rng.randrange(0, 6)):
            p = rng.randrange(len(s))
            s[p] = "N"
        mod.append(("".join(s), "".join(q)))
    _compare(opt, ch, ds, mod, mode, len(mod))
