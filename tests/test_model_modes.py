"""Model-vs-reference parity for the remaining CLI modes.

Covers the k>32 key-packing path (k=33), cross-set correction,
dump/restore interop, FASTA output, and discard mode.
"""

import pytest

from bfc_jax.models import pipeline as P
from bfc_jax.opts import Opts

from . import datagen, oracle


@pytest.fixture(scope="module")
def k33_dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("k33")
    genome = datagen.make_genome(12000, seed=21)
    reads = datagen.simulate_reads(genome, 3500, read_len=100, err_rate=0.01, seed=22)
    fq = f"{d}/reads.fq"
    datagen.write_fastq(fq, reads)
    reads2 = datagen.simulate_reads(genome, 600, read_len=100, err_rate=0.01, seed=33)
    fq2 = f"{d}/reads2.fq"
    datagen.write_fastq(fq2, reads2)
    return str(d), fq, fq2


def _opts_k33():
    opt = Opts()
    opt.k = 33
    opt.bf_shift = 26
    return opt


@pytest.mark.slow
def test_k33_correct_matches_reference(k33_dataset):
    d, fq, _ = k33_dataset
    ref_out, _ = oracle.run_bfc(["-k33", "-b26", "-t1", fq])
    mine = P.run(_opts_k33(), fq)
    assert mine.encode() == ref_out


@pytest.mark.slow
def test_cross_set_correction(k33_dataset):
    d, fq, fq2 = k33_dataset
    ref_out, _ = oracle.run_bfc(["-k33", "-b26", "-t1", fq, fq2])
    mine = P.run(_opts_k33(), fq, correct_fn=fq2)
    assert mine.encode() == ref_out


@pytest.mark.slow
def test_dump_restore_interop(k33_dataset, tmp_path):
    """Our dump restores in the reference binary and vice versa."""
    d, fq, fq2 = k33_dataset
    ref_dump = tmp_path / "ref.hash"
    my_dump = tmp_path / "my.hash"
    oracle.run_bfc(["-k33", "-b26", "-t1", "-E", "-d", str(ref_dump), fq])
    opt = _opts_k33()
    _, ch = P.count_file(fq, opt)
    P.dump_table(ch, str(my_dump))
    # reference consumes our dump
    ref_out, _ = oracle.run_bfc(["-t1", "-r", str(my_dump), fq2])
    # we consume the reference dump
    mine = P.run(_opts_k33(), fq2, in_hash=str(ref_dump))
    assert mine.encode() == ref_out
    # both dumps decode to the same k-mer multiset
    a = sorted(oracle.run_hash2cnt(ref_dump).split())
    b = sorted(oracle.run_hash2cnt(my_dump).split())
    assert a == b


@pytest.mark.slow
def test_fasta_output_and_discard(k33_dataset):
    d, fq, _ = k33_dataset
    ref_out, _ = oracle.run_bfc(["-k33", "-b26", "-t1", "-Q", "-D", fq])
    opt = _opts_k33()
    opt.no_qual = True
    opt.discard = True
    mine = P.run(opt, fq)
    assert mine.encode() == ref_out


@pytest.mark.slow
def test_refine_roundtrip(k33_dataset, tmp_path):
    """Correct, then refine the corrected output; match the reference."""
    d, fq, _ = k33_dataset
    first, _ = oracle.run_bfc(["-k33", "-b26", "-t1", fq])
    corrected = tmp_path / "corrected.fq"
    corrected.write_bytes(first)
    ref_out, _ = oracle.run_bfc(["-k33", "-b26", "-t1", "-R", fq, str(corrected)])
    opt = _opts_k33()
    opt.refine_ec = True
    mine = P.run(opt, fq, correct_fn=str(corrected))
    assert mine.encode() == ref_out
