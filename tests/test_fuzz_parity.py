"""Adversarial fuzz parity: hostile inputs must still match the reference."""

import random

import pytest

from bfc_jax.models import device_pipeline as DP
from bfc_jax.opts import Opts

from . import datagen, oracle


def _hostile_reads(rng, genome, n):
    """Reads with mixed lengths, error bursts, N runs, quality extremes."""
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    out = []
    for i in range(n):
        ln = rng.choice([36, 50, 75, 100, 151, 250])
        if ln >= len(genome):
            ln = len(genome) - 1
        p = rng.randrange(0, len(genome) - ln)
        frag = genome[p : p + ln]
        if rng.random() < 0.5:
            frag = "".join(comp[c] for c in reversed(frag))
        s = list(frag)
        q = []
        err = rng.choice([0.0, 0.01, 0.05, 0.15])
        for j in range(ln):
            if rng.random() < err:
                s[j] = rng.choice("ACGT")
                q.append(chr(33 + rng.randrange(0, 41)))
            else:
                q.append(chr(33 + rng.choice([2, 5, 19, 20, 21, 40])))
        # N runs
        if rng.random() < 0.3:
            st = rng.randrange(ln)
            for j in range(st, min(ln, st + rng.randrange(1, 8))):
                s[j] = "N"
        # homopolymer tail
        if rng.random() < 0.1:
            s[-5:] = ["A"] * 5
        out.append(("".join(s), "".join(q)))
    return out


@pytest.mark.slow
@pytest.mark.parametrize("seed", [101, 202])
def test_fuzz_correct_parity(tmp_path, seed):
    rng = random.Random(seed)
    genome = datagen.make_genome(12000, seed=seed)
    reads = datagen.simulate_reads(genome, 2500, read_len=100, err_rate=0.01,
                                   seed=seed + 1)
    reads += _hostile_reads(rng, genome, 600)
    fq = tmp_path / f"fuzz{seed}.fq"
    datagen.write_fastq(str(fq), reads)
    ref_out, _ = oracle.run_bfc(["-k19", "-b23", "-t1", str(fq)])
    opt = Opts()
    opt.k = 19
    opt.bf_shift = 23
    mine = DP.run_device(opt, str(fq), batch_reads=1024)
    assert mine.encode() == ref_out


@pytest.mark.slow
def test_fuzz_repetitive_genome(tmp_path):
    """Tandem-repeat-heavy genome: stresses the heap-explosion guard and
    multi-path search (heap sizes beyond the shallow sift levels)."""
    rng = random.Random(7)
    unit = datagen.make_genome(120, seed=77)
    genome = (unit * 60) + datagen.make_genome(5000, seed=78)
    reads = datagen.simulate_reads(genome, 2500, read_len=100, err_rate=0.02,
                                   seed=79)
    fq = tmp_path / "rep.fq"
    datagen.write_fastq(str(fq), reads)
    ref_out, _ = oracle.run_bfc(["-k19", "-b23", "-t1", str(fq)])
    opt = Opts()
    opt.k = 19
    opt.bf_shift = 23
    mine = DP.run_device(opt, str(fq), batch_reads=1024)
    assert mine.encode() == ref_out
