"""Fallback paths: long reads (>504 bp) and forced device-capacity
overflow must stay byte-exact (they re-run on the scalar model).

These paths are the rot-prone ones: nothing else exercises them."""

import numpy as np
import pytest

from bfc_jax.models import corrector as DC
from bfc_jax.models import counter as C
from bfc_jax.models import device_pipeline as DP
from bfc_jax.opts import Opts

from . import datagen, oracle


@pytest.fixture(scope="module")
def long_dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("longreads")
    genome = datagen.make_genome(8000, seed=91)
    # 600 bp reads: beyond the 504 bp packed-position limit of the
    # lockstep search (ops/search.py), forcing the direct scalar path
    reads = datagen.simulate_reads(genome, 300, read_len=600,
                                   err_rate=0.01, seed=92)
    fq = f"{d}/long.fq"
    datagen.write_fastq(fq, reads)
    return fq


@pytest.mark.slow
def test_e2e_long_reads_direct_scalar(long_dataset):
    """Reads longer than 504 bp take dispatch_arrays' direct scalar path
    (models/corrector.py); output must match the reference byte-for-byte."""
    fq = long_dataset
    ref_out, _ = oracle.run_bfc(["-k21", "-b24", "-t1", fq])
    opt = Opts()
    opt.k = 21
    opt.bf_shift = 24
    mine = DP.run_device(opt, fq)
    assert mine.encode() == ref_out


@pytest.fixture(scope="module")
def overflow_dataset():
    genome = datagen.make_genome(15000, seed=51)
    reads = datagen.simulate_reads(genome, 1500, read_len=100,
                                   err_rate=0.02, seed=52)
    return reads


def _count(reads, opt):
    return C.count_stream(iter(reads), opt,
                          batch_reads=2048)


def test_forced_overflow_scalar_fallback(overflow_dataset):
    """Tiny stack/iteration caps force device overflow -> M.ec1 re-run
    (models/corrector.py finalize_batch); results must equal the
    default-capacity corrector's."""
    reads = overflow_dataset
    opt = Opts()
    opt.k = 21
    opt.bf_shift = 24
    ds = _count(reads, opt)
    seqs = [s for s, _ in reads]
    quals = [q for _, q in reads]
    corr_ref = DC.Corrector(opt, ds)
    expected = corr_ref.correct_batch(seqs, quals)

    corr_tiny = DC.Corrector(opt, ds, stack_cap=24, iter_cap=16)
    # count overflows via the raw device output before fallback
    ctx = corr_tiny.dispatch_batch(seqs, quals)
    n_overflow = int(np.asarray(ctx["out"]["overflow"])[: len(seqs)].sum())
    assert n_overflow > 0, "caps not small enough to force overflow"
    got = corr_tiny.finalize_batch(ctx)
    assert got == expected


def test_greedy_pool_overflow_exact():
    """More no-island reads than the greedy pool (G=1024, batches >
    1024 lanes): the overflowed lanes must take the exact scalar
    fallback, byte-identical to an all-device run of the same reads."""
    import random

    rng = random.Random(17)
    genome = datagen.make_genome(9000, seed=61)
    good = datagen.simulate_reads(genome, 1200, read_len=100,
                                  err_rate=0.01, seed=62)
    # junk reads share no k-mers with the genome: no solid island, so
    # every one of them needs the greedy loop (and immediately fails it)
    junk = [("".join(rng.choice("ACGT") for _ in range(100)), "I" * 100)
            for _ in range(1300)]
    reads = good + junk
    rng.shuffle(reads)
    opt = Opts()
    opt.k = 19
    opt.bf_shift = 23
    ds = _count(good, opt)
    corr = DC.Corrector(opt, ds)
    # one 2048-lane batch: > 1024 greedy lanes guaranteed
    batch = reads[:2048]
    got = corr.correct_batch([r[0] for r in batch], [r[1] for r in batch])
    # oracle: the exact scalar model per read
    from bfc_jax.models import refmodel as M

    ch = corr._fallback_table()
    for (st, s2, q2), (s_in, q_in) in zip(got, batch):
        st_ref, s_ref, q_ref = M.ec1(opt, ch, ds.mode, s_in, q_in)
        assert (s2, q2) == (s_ref, q_ref)
        assert st.__dict__ == st_ref.__dict__
