"""State-resume straggler scheduling vs the exact scalar model.

Forces tiny soft iteration caps and a tiny resume pool so the
straggler path runs many absorb/flush cycles, and compares the full
correct_many window (the production path) read-for-read against the
scalar reference model — including the resume-overflow routes (scalar
fallback for reads iteration-capped again, full-cap re-batch for reads
that outgrow the soft stack during a resume).
"""

import dataclasses
import os

import numpy as np
import pytest

from bfc_jax.models import corrector as DC
from bfc_jax.models import counter as C
from bfc_jax.models import refmodel as M
from bfc_jax.opts import Opts

from . import datagen


@pytest.fixture(scope="module")
def setup():
    genome = datagen.make_genome(9000, seed=51)
    reads = datagen.simulate_reads(
        genome, 2048, read_len=100, err_rate=0.02, seed=52
    )
    opt = Opts()
    opt.k = 19
    opt.bf_shift = 23
    _, ch = M.count_reads(iter(reads), opt)
    ds = C.count_stream(iter(reads), opt, batch_reads=1024)
    _, _, mode = ch.hist()
    return opt, ch, ds, reads, mode


def _window_vs_model(opt, ch, ds, reads, mode, env):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        corr = DC.Corrector(opt, ds)
        assert corr._resume, "resume should be active in this config"
        seqs = [r[0] for r in reads]
        quals = [r[1] for r in reads]
        n = len(reads)
        from bfc_jax.ops import kmer as kops

        bases0, _, lens0 = kops.encode_batch(seqs, None, opt.q)
        rawq0 = np.zeros(bases0.shape, np.uint8)
        for i, q in enumerate(quals):
            rawq0[i, : len(q)] = np.frombuffer(q.encode(), np.uint8)
        has_q = np.ones((n,), bool)
        win = corr.correct_many(
            bases0, rawq0, lens0, has_q,
            lambda i: (seqs[i], quals[i]), 512,
            bucketed=True, as_arrays=True,
        )
        n_bad = 0
        for i in range(n):
            st, s2, q2 = win.tuple_of(i)
            mst, ms2, mq2 = M.ec1(opt, ch, mode, seqs[i], quals[i])
            if (dataclasses.astuple(st) != dataclasses.astuple(mst)
                    or s2 != ms2 or q2 != mq2):
                n_bad += 1
                if n_bad <= 3:
                    print(f"read {i}: got {st}\n        want {mst}")
        assert n_bad == 0, f"{n_bad}/{n} reads mismatch"
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_resume_heavy_traffic(setup):
    """Tiny soft cap + tiny pool: many absorb/flush cycles, plus reads
    that get iteration-capped again on resume (scalar fallback)."""
    opt, ch, ds, reads, mode = setup
    _window_vs_model(opt, ch, ds, reads, mode, {
        "BFC_SOFT_ITERS": "8",
        "BFC_RESUME_POOL": "64",
    })


def test_resume_soft_stack_overflow(setup):
    """A soft stack small enough that some resumed reads outgrow it:
    exercises the resume -> full-cap re-batch route."""
    opt, ch, ds, reads, mode = setup
    _window_vs_model(opt, ch, ds, reads, mode, {
        "BFC_SOFT_ITERS": "16",
        "BFC_SOFT_STACK": "48",
        "BFC_RESUME_POOL": "64",
    })


def test_resume_off_matches(setup):
    """BFC_RESUME=0 (the full-cap re-batch path) stays byte-exact."""
    opt, ch, ds, reads, mode = setup
    old = os.environ.get("BFC_RESUME")
    os.environ["BFC_RESUME"] = "0"
    try:
        corr = DC.Corrector(opt, ds)
        assert not corr._resume
        got = corr.correct_batch(
            [r[0] for r in reads[:256]], [r[1] for r in reads[:256]]
        )
        for i, (st, s2, q2) in enumerate(got):
            mst, ms2, mq2 = M.ec1(opt, ch, mode, reads[i][0], reads[i][1])
            assert dataclasses.astuple(st) == dataclasses.astuple(mst)
            assert s2 == ms2 and q2 == mq2
    finally:
        if old is None:
            os.environ.pop("BFC_RESUME", None)
        else:
            os.environ["BFC_RESUME"] = old
