"""Edge-case parity vs the reference: short reads, odd records, stdin."""

import pytest

from bfc_jax.models import device_pipeline as DP
from bfc_jax.opts import Opts

from . import datagen, oracle


@pytest.mark.slow
def test_short_and_weird_reads(tmp_path):
    """Reads shorter than k, all-N reads, N-riddled reads, empty-adjacent."""
    genome = datagen.make_genome(4000, seed=61)
    reads = datagen.simulate_reads(genome, 1200, read_len=100, err_rate=0.01, seed=62)
    fq = tmp_path / "mix.fq"
    with open(fq, "w") as f:
        for i, (s, q) in enumerate(reads):
            f.write(f"@n{i}\n{s}\n+\n{q}\n")
        f.write("@short1\nACGT\n+\nIIII\n")                       # < k
        f.write("@short2\n" + "A" * 16 + "\n+\n" + "I" * 16 + "\n")
        f.write("@alln\n" + "N" * 50 + "\n+\n" + "#" * 50 + "\n")  # many-N
        f.write("@halfn\n" + "ACGTN" * 20 + "\n+\n" + "IIIII" * 20 + "\n")
        f.write("@onebase\nA\n+\nI\n")
    ref_out, _ = oracle.run_bfc(["-k17", "-b22", "-t1", str(fq)])
    opt = Opts()
    opt.k = 17
    opt.bf_shift = 22
    mine = DP.run_device(opt, str(fq))
    assert mine.encode() == ref_out


@pytest.mark.slow
def test_gzip_input(tmp_path):
    fq = datagen.standard_dataset(
        str(tmp_path), genome_len=5000, n_reads=1200, gz=True, name="r.fq.gz"
    )
    ref_out, _ = oracle.run_bfc(["-k17", "-b22", "-t1", fq])
    opt = Opts()
    opt.k = 17
    opt.bf_shift = 22
    mine = DP.run_device(opt, fq)
    assert mine.encode() == ref_out


@pytest.mark.slow
def test_no_qual_fasta_input(tmp_path):
    genome = datagen.make_genome(5000, seed=63)
    reads = [(s, None) for s, _ in datagen.simulate_reads(genome, 1200, seed=64)]
    fa = f"{tmp_path}/r.fa"
    datagen.write_fastq(fa, reads)
    ref_out, _ = oracle.run_bfc(["-k17", "-b22", "-t1", fa])
    opt = Opts()
    opt.k = 17
    opt.bf_shift = 22
    mine = DP.run_device(opt, fa)
    assert mine.encode() == ref_out
