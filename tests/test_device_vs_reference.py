"""End-to-end device pipeline vs the compiled reference binary (byte-equality)."""

import pytest

from bfc_jax.models import device_pipeline as DP
from bfc_jax.opts import Opts

from . import datagen, oracle


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("e2e")
    genome = datagen.make_genome(15000, seed=31)
    reads = datagen.simulate_reads(genome, 5000, read_len=100, err_rate=0.01, seed=32)
    fq = f"{d}/reads.fq"
    datagen.write_fastq(fq, reads)
    reads2 = datagen.simulate_reads(genome, 800, read_len=100, err_rate=0.01, seed=44)
    fq2 = f"{d}/reads2.fq"
    datagen.write_fastq(fq2, reads2)
    return fq, fq2


def _opts():
    opt = Opts()
    opt.k = 21
    opt.bf_shift = 24
    return opt


@pytest.mark.slow
def test_e2e_correct(dataset):
    fq, _ = dataset
    ref_out, _ = oracle.run_bfc(["-k21", "-b24", "-t1", fq])
    mine = DP.run_device(_opts(), fq)
    assert mine.encode() == ref_out


@pytest.mark.slow
def test_e2e_cross_set(dataset):
    fq, fq2 = dataset
    ref_out, _ = oracle.run_bfc(["-k21", "-b24", "-t1", fq, fq2])
    mine = DP.run_device(_opts(), fq, correct_fn=fq2)
    assert mine.encode() == ref_out


@pytest.mark.slow
def test_e2e_trim(dataset):
    fq, _ = dataset
    opt = _opts()
    opt.filter_mode = True
    ref_out, _ = oracle.run_bfc(["-k21", "-b24", "-t1", "-1", fq])
    mine = DP.run_device(opt, fq)
    assert mine.encode() == ref_out


@pytest.mark.slow
def test_e2e_refine(dataset, tmp_path):
    fq, _ = dataset
    first, _ = oracle.run_bfc(["-k21", "-b24", "-t1", fq])
    corrected = tmp_path / "corrected.fq"
    corrected.write_bytes(first)
    ref_out, _ = oracle.run_bfc(["-k21", "-b24", "-t1", "-R", fq, str(corrected)])
    opt = _opts()
    opt.refine_ec = True
    mine = DP.run_device(opt, fq, correct_fn=str(corrected))
    assert mine.encode() == ref_out


@pytest.mark.slow
def test_e2e_dump_restore(dataset, tmp_path):
    fq, fq2 = dataset
    my_dump = tmp_path / "my.hash"
    ref_dump = tmp_path / "ref.hash"
    oracle.run_bfc(["-k21", "-b24", "-t1", "-E", "-d", str(ref_dump), fq])
    mine1 = DP.run_device(_opts(), fq, correct_fn=fq2, out_hash=str(my_dump))
    # reference restores our dump and must produce identical output
    ref_out, _ = oracle.run_bfc(["-t1", "-r", str(my_dump), fq2])
    assert mine1.encode() == ref_out
    # we restore the reference dump
    mine2 = DP.run_device(_opts(), fq2, in_hash=str(ref_dump))
    assert mine2.encode() == ref_out


@pytest.mark.slow
def test_e2e_refine_missing_tags(dataset, tmp_path):
    """-R with dropped/foreign comment tags: the reference compares against
    its per-thread ori_st, which is calloc-zeroed before the first parsed
    ec:Z tag and stale (carried over) for tagless reads (correct.c:438-442,
    640-642)."""
    fq, _ = dataset
    first, _ = oracle.run_bfc(["-k21", "-b24", "-t1", fq])
    lines = first.decode().splitlines()
    out_lines = []
    rec = 0
    for i in range(0, len(lines), 4):
        hdr = lines[i]
        if rec % 3 == 0:
            hdr = hdr.split("\t")[0].split(" ")[0]  # drop the ec:Z comment
        elif rec % 7 == 0:
            hdr = hdr.split("\t")[0].split(" ")[0] + "\txx:Z:foo"
        out_lines.append(hdr)
        out_lines.extend(lines[i + 1 : i + 4])
        rec += 1
    mangled = tmp_path / "mangled.fq"
    mangled.write_text("\n".join(out_lines) + "\n")
    ref_out, _ = oracle.run_bfc(["-k21", "-b24", "-t1", "-R", fq, str(mangled)])
    opt = _opts()
    opt.refine_ec = True
    mine = DP.run_device(opt, fq, correct_fn=str(mangled))
    assert mine.encode() == ref_out
