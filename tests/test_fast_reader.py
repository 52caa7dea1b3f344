"""Native FASTQ batch parser vs the tolerant Python parser."""

import numpy as np
import pytest

from bfc_jax.io import fast_reader as FR
from bfc_jax.io import fastq as slow_io
from bfc_jax.native.build import get_lib

from . import datagen


def collect(fn, batch_reads=257):
    out = []
    for b in FR.iter_batches(fn, batch_reads):
        for i in range(b.n):
            out.append((b.name(i), b.comment(i), b.seq(i), b.qual(i)))
    return out


def reference(fn):
    return [(r.name, r.comment, r.seq, r.qual) for r in slow_io.read_fastx(fn)]


def test_native_lib_builds():
    assert get_lib() is not None


@pytest.mark.parametrize("gz", [False, True])
def test_fastq_parity(tmp_path, gz):
    path = datagen.standard_dataset(
        str(tmp_path), genome_len=3000, n_reads=700,
        name="reads.fq.gz" if gz else "reads.fq", gz=gz,
    )
    assert collect(path) == reference(path)


def test_fasta_parity(tmp_path):
    genome = datagen.make_genome(2000, seed=9)
    reads = [(s, None) for s, _ in datagen.simulate_reads(genome, 300, seed=10)]
    path = f"{tmp_path}/reads.fa"
    datagen.write_fastq(path, reads)
    assert collect(path) == reference(path)


def test_comments_and_arrays(tmp_path):
    path = f"{tmp_path}/c.fq"
    with open(path, "w") as f:
        f.write("@r1 some comment here\nACGTN\n+\nIIII#\n")
        f.write("@r2\nGGGG\n+\n!!!!\n")
    got = collect(path)
    assert got == [("r1", "some comment here", "ACGTN", "IIII#"),
                   ("r2", None, "GGGG", "!!!!")]
    b = next(FR.iter_batches(path, 16))
    np.testing.assert_array_equal(b.bases[0, :5], [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(b.lens, [5, 4])
    assert bytes(b.quals[0, :5]) == b"IIII#"


def test_multiline_fallback(tmp_path):
    path = f"{tmp_path}/m.fa"
    with open(path, "w") as f:
        f.write(">long record\nACGTACGT\nGGGGCCCC\nTTTT\n>x\nACGT\n")
    got = collect(path)
    # "x" inherits the stale comment "record": kseq only resets comment.l
    # and bseq tests the buffer pointer (kseq.h:194-197 + bseq.c:66)
    assert got == [("long", "record", "ACGTACGTGGGGCCCCTTTT", None),
                   ("x", "record", "ACGT", None)]


def test_split_by_bases(tmp_path):
    """-L chunking: each piece stops once cumulative bases reach the bound
    (bseq.c:52-76 semantics: may exceed by one read)."""
    from bfc_jax.io import fast_reader as FR

    path = f"{tmp_path}/r.fq"
    with open(path, "w") as f:
        for i in range(10):
            f.write(f"@r{i}\n{'ACGT' * 25}\n+\n{'I' * 100}\n")
    batches = list(FR.iter_batches(path, 100, max_bases=250))
    assert [b.n for b in batches] == [3, 3, 3, 1]
    names = [b.name(i) for b in batches for i in range(b.n)]
    assert names == [f"r{i}" for i in range(10)]
    # no bound: single batch
    assert [b.n for b in FR.iter_batches(path, 100)] == [10]


def test_decode_range_stride(tmp_path):
    """Multi-host stride decode: rows outside decode_range keep padding
    in bases/quals but full record structure (offsets/lens/text), and
    ensure_decoded repairs any owned rows the parser skipped."""
    path = datagen.standard_dataset(
        str(tmp_path), genome_len=3000, n_reads=700, name="dr.fq"
    )
    full = list(FR.iter_batches(path, 256))
    part = list(FR.iter_batches(path, 256, decode_range=(64, 128)))
    assert len(full) == len(part)
    for fb, pb in zip(full, part):
        assert pb.n == fb.n
        np.testing.assert_array_equal(pb.lens, fb.lens)
        lo, hi = pb.decoded
        assert (lo, hi) == (min(64, pb.n), min(128, pb.n))
        np.testing.assert_array_equal(pb.bases[lo:hi], fb.bases[lo:hi])
        np.testing.assert_array_equal(pb.quals[lo:hi], fb.quals[lo:hi])
        # undecoded rows: bases still at the pad value, text intact
        if lo > 0:
            assert (pb.bases[:lo] == 4).all()
            assert pb.seq(0) == fb.seq(0)
            assert pb.qual(0) == fb.qual(0)
        # repair arbitrary rows (disjoint from the decoded stride)
        pb.ensure_decoded(0, pb.n)
        np.testing.assert_array_equal(pb.bases, fb.bases)
        np.testing.assert_array_equal(pb.quals, fb.quals)


def test_decode_range_with_split(tmp_path):
    """decode_range composed with the -L max_bases split: pieces carry
    shifted decoded ranges and ensure_decoded restores full parity."""
    path = datagen.standard_dataset(
        str(tmp_path), genome_len=3000, n_reads=700, name="drs.fq"
    )
    full = list(FR.iter_batches(path, 256, max_bases=10_000))
    part = list(FR.iter_batches(path, 256, max_bases=10_000,
                                decode_range=(0, 128)))
    assert len(full) == len(part)
    for fb, pb in zip(full, part):
        assert pb.n == fb.n
        pb.ensure_decoded(0, pb.n)
        np.testing.assert_array_equal(pb.bases, fb.bases)
        np.testing.assert_array_equal(pb.quals, fb.quals)
