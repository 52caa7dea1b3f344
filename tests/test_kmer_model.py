"""Unit tests for the scalar k-mer codec/hash model (self-checking properties).

These pin the semantics of /root/reference/kmer.h without running the C
code: the Wang hash is verified against its exact inverse, the canonical
hash against strand invariance, and the rolling append against direct
re-encoding.
"""

import random

from bfc_jax.models import refmodel as M


def encode_kmer(k, s):
    x = M.kmer_null()
    for ch in s:
        M.kmer_append(k, x, M.BASE_CODE[ord(ch)])
    return x


def revcomp(s):
    return "".join({"A": "T", "C": "G", "G": "C", "T": "A"}[c] for c in reversed(s))


def rand_kmer(rng, k):
    return "".join(rng.choice("ACGT") for _ in range(k))


def test_hash64_invertible():
    rng = random.Random(1)
    for k in (5, 21, 33, 55, 63):
        mask = (1 << k) - 1
        for _ in range(50):
            v = rng.getrandbits(k)
            h = M.hash64(v, mask)
            assert M.hash64_inv(h, mask) == v


def test_append_planes_consistent():
    rng = random.Random(2)
    for k in (15, 33, 55):
        s = rand_kmer(rng, k)
        x = encode_kmer(k, s)
        # plane 0/1 = low/high bits of forward bases, newest at bit 0
        for j, ch in enumerate(reversed(s)):
            c = M.BASE_CODE[ord(ch)]
            assert (x[0] >> j) & 1 == (c & 1)
            assert (x[1] >> j) & 1 == (c >> 1)
        # planes 2/3 must equal planes 0/1 of the reverse complement
        xrc = encode_kmer(k, revcomp(s))
        assert x[2] == xrc[0] and x[3] == xrc[1]


def test_canonical_hash_strand_invariant():
    rng = random.Random(3)
    for k in (15, 33, 55):  # odd k as the reference enforces
        for _ in range(30):
            s = rand_kmer(rng, k)
            a = M.kmer_hash(k, encode_kmer(k, s))
            b = M.kmer_hash(k, encode_kmer(k, revcomp(s)))
            assert a == b


def test_kmer_hash_invertible_roundtrip():
    rng = random.Random(4)
    for k in (15, 33):
        for _ in range(30):
            s = rand_kmer(rng, k)
            x = encode_kmer(k, s)
            _, h0, h1 = M.kmer_hash(k, x)
            y0, y1 = M.kmer_hash_inv(k, h0, h1)
            txt = M.kmer_2str(k, y0, y1)
            assert txt in (s, revcomp(s))


def test_kmer_change():
    rng = random.Random(5)
    k = 21
    for _ in range(20):
        s = rand_kmer(rng, k)
        x = encode_kmer(k, s)
        d = rng.randrange(k)
        c = rng.randrange(4)
        M.kmer_change(k, x, d, c)
        s2 = list(s)
        s2[k - 1 - d] = "ACGT"[c]  # d counts from the 3' end
        assert x[:2] == encode_kmer(k, "".join(s2))[:2]
        assert x[2:] == encode_kmer(k, "".join(s2))[2:]


def test_bloom_probe_structure():
    # probes never land in byte 0 and there are exactly n_hashes of them
    rng = random.Random(6)
    for _ in range(200):
        h = rng.getrandbits(64)
        block, offs = M.bloom_probes(33, 4, h)
        assert len(offs) == 4
        assert all(o >= 8 for o in offs)
        assert 0 <= block < 1 << 24
