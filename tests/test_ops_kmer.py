"""Vectorized k-mer stream vs the scalar model, position by position."""

import random

import numpy as np

from bfc_jax.models import refmodel as M
from bfc_jax.ops import kmer as K


def scalar_stream_arrays(seq, qual, k, q, l_pre, L):
    """Per-position reference values as numpy arrays (valid-masked)."""
    valid = np.zeros(L, bool)
    is_high = np.zeros(L, bool)
    ret = np.zeros(L, np.uint64)
    h0a = np.zeros(L, np.uint64)
    h1a = np.zeros(L, np.uint64)
    sh = np.zeros(L, np.uint32)
    kb = np.zeros(L, np.uint64)
    x = M.kmer_null()
    qmer = 0
    run = 0
    mask = (1 << k) - 1
    for i, ch in enumerate(seq):
        c = M.BASE_CODE[ord(ch)]
        if c < 4:
            M.kmer_append(k, x, c)
            qbit = 1 if (qual is None or ord(qual[i]) - 33 >= q) else 0
            qmer = ((qmer << 1) | qbit) & mask
            run += 1
        else:
            run, qmer = 0, 0
            x = M.kmer_null()
        if run >= k:
            r, h0, h1 = M.kmer_hash(k, x)
            shard, ident = M.ch_shard_key(k, l_pre, h0, h1)
            valid[i] = True
            is_high[i] = qmer == mask
            ret[i] = r & ((1 << 64) - 1)
            h0a[i], h1a[i], sh[i], kb[i] = h0, h1, shard, ident
    return valid, is_high, ret, h0a, h1a, sh, kb


def make_reads(rng, n, L, with_n=True):
    reads = []
    for _ in range(n):
        ln = rng.randrange(L // 2, L + 1)
        seq = "".join(
            rng.choice("ACGTACGTACGTACGTN" if with_n else "ACGT") for _ in range(ln)
        )
        qual = "".join(chr(33 + rng.randrange(2, 41)) for _ in range(ln))
        reads.append((seq, qual))
    return reads


def check_batch(reads, k, l_pre, quals_none=False):
    seqs = [r[0] for r in reads]
    quals = None if quals_none else [r[1] for r in reads]
    bases, qok, lens = K.encode_batch(seqs, quals, 20)
    s = {kk: np.asarray(v) for kk, v in K.kmer_stream(bases, qok, lens, k, l_pre).items()}
    L = bases.shape[1]
    for b, (seq, qual) in enumerate(reads):
        valid, is_high, ret, h0, h1, sh, kb = scalar_stream_arrays(
            seq, None if quals_none else qual, k, 20, l_pre, L
        )
        np.testing.assert_array_equal(s["valid"][b], valid, err_msg=f"valid k={k} b={b}")
        m = valid
        np.testing.assert_array_equal(s["is_high"][b][m], is_high[m])
        np.testing.assert_array_equal(s["ret"][b][m], ret[m])
        np.testing.assert_array_equal(s["h0"][b][m], h0[m])
        np.testing.assert_array_equal(s["h1"][b][m], h1[m])
        np.testing.assert_array_equal(s["shard"][b][m], sh[m])
        np.testing.assert_array_equal(s["keybody"][b][m], kb[m])


def test_kmer_stream_matches_model():
    rng = random.Random(42)
    for k in (15, 33):
        l_pre = M.ch_clamped_l_pre(k, 20)
        check_batch(make_reads(rng, 12, 120), k, l_pre)


def test_kmer_stream_large_k():
    rng = random.Random(9)
    # k=55 exercises the k>32 packing with near-full 64-bit planes
    check_batch(make_reads(rng, 6, 150), 55, M.ch_clamped_l_pre(55, 20))


def test_kmer_stream_no_qual():
    rng = random.Random(1)
    check_batch(make_reads(rng, 4, 60), 17, 20, quals_none=True)
