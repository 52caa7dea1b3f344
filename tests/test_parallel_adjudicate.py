"""Partitioned thread-pool adjudication == single-sort adjudication.

adjudicate_np switches to bit-id-prefix partitions sorted on a thread
pool above _PAR_MIN keys; segments are keyed by the full bit id so a
prefix partition can never split one, and the verdicts must be
bit-identical to the single-sort path (and to the general reduceat
path) on any input.
"""

import numpy as np
import pytest

from bfc_jax.ops import spectrum_host as sph


@pytest.mark.parametrize("seed", [1, 2])
def test_partitioned_matches_single(monkeypatch, seed):
    rng = np.random.default_rng(seed)
    C = 5000
    bf_shift = 22
    n_hashes = 4
    ret = rng.integers(0, 1 << 63, C, dtype=np.uint64)
    # clustered arrivals with plenty of exact collisions/ties
    first_arr = rng.integers(0, 300, C).astype(np.uint64)
    valid = rng.random(C) < 0.9

    got_single = sph.adjudicate_np(ret, first_arr, valid, bf_shift, n_hashes)
    monkeypatch.setattr(sph, "_PAR_MIN", 1)
    got_par = sph.adjudicate_np(ret, first_arr, valid, bf_shift, n_hashes)
    np.testing.assert_array_equal(got_par, got_single)

    # the general (wide-key) path as a third witness: force it by
    # making the packed key not fit (first_arr with high bits set)
    big = first_arr + (np.uint64(1) << np.uint64(50))
    ref = sph.adjudicate_np(ret, big, valid, bf_shift, n_hashes)
    # verdicts only depend on arrival ORDER, which the offset preserves
    np.testing.assert_array_equal(got_single, ref)


def _rand_sorted_agg(rng, n, l_pre, kb_bits, key_space):
    shard = rng.integers(0, 1 << l_pre, n).astype(np.uint32)
    keybody = rng.integers(0, key_space, n).astype(np.uint64)
    order = np.lexsort((keybody, shard))
    shard, keybody = shard[order], keybody[order]
    # dedup within one agg (aggregates hold distinct keys)
    keep = np.ones(n, bool)
    keep[1:] = (shard[1:] != shard[:-1]) | (keybody[1:] != keybody[:-1])
    shard, keybody = shard[keep], keybody[keep]
    m = len(shard)
    return sph.HostAgg(
        shard=shard, keybody=keybody,
        ret=rng.integers(0, 1 << 60, m).astype(np.uint64),
        n=rng.integers(1, 50, m).astype(np.uint32),
        n_high=rng.integers(0, 20, m).astype(np.uint32),
        first_arr=rng.integers(0, 1 << 30, m).astype(np.uint64),
        first_high=rng.integers(0, 2, m).astype(np.uint32),
    )


def test_partitioned_merge_matches_sequential(monkeypatch):
    rng = np.random.default_rng(9)
    l_pre, kb_bits = 8, 30
    # small key space forces plenty of duplicate keys across a and b
    a = _rand_sorted_agg(rng, 4000, l_pre, kb_bits, 3000)
    b = _rand_sorted_agg(rng, 4000, l_pre, kb_bits, 3000)
    seq = sph.merge_host_aggs(a, b, l_pre=l_pre, kb_bits=kb_bits,
                              parallel=False)
    monkeypatch.setattr(sph, "_PAR_MIN", 1)
    par = sph.merge_host_aggs(a, b, l_pre=l_pre, kb_bits=kb_bits)
    for f_seq, f_par in zip(seq, par):
        np.testing.assert_array_equal(f_seq, f_par)
