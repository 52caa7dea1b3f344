"""Counting-run primitives (ops/spectrum_dense.py) against numpy.

The combine (group equal keys, sum counts, compact the heads left), the
run merge (concatenate + sort + combine) and the whole per-batch
chunk_run are each checked against a straightforward numpy version of
the same record semantics.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from bfc_jax.ops import kmer as kops
from bfc_jax.ops import spectrum_dense as sdn

INV = 0xFFFFFFFF


def _np_combine(planes, n_id):
    """Reference combine over numpy planes already sorted by key."""
    planes = [np.asarray(p, np.uint32) for p in planes]
    N = planes[0].shape[0]
    valid = planes[0] != INV
    rows = []
    i = 0
    while i < N and valid[i]:
        j = i + 1
        while (j < N and valid[j]
               and all(p[j] == p[i] for p in planes[:n_id])):
            j += 1
        rec = [int(p[i]) for p in planes]
        rec[n_id + 2] = int(planes[n_id + 2][i:j].astype(np.uint64).sum()
                            & 0xFFFFFFFF)
        nh = int((planes[n_id + 3][i:j] & 0x7FFFFFFF).astype(np.uint64).sum())
        rec[n_id + 3] = (nh & 0x7FFFFFFF) | (int(planes[n_id + 3][i])
                                             & 0x80000000)
        rows.append(rec)
        i = j
    fill = [INV] * n_id + [0] * (len(planes) - n_id)
    out = np.array([fill] * N, np.uint32).T.copy()
    for r, rec in enumerate(rows):
        out[:, r] = rec
    return out, len(rows)


def _rand_run(rng, cap, n_valid, n_id, n_planes, arr_hi=0, pool=None):
    """A sorted run: n_valid records drawn (with repeats) from `pool`
    keys, padded with all-ones rows up to cap."""
    if pool is None:
        pool = rng.integers(0, 1 << 40, max(n_valid // 2, 1), dtype=np.uint64)
    ids = np.sort(rng.choice(pool, n_valid))
    planes = np.full((n_planes, cap), INV, np.uint32)
    planes[0, :n_valid] = (ids >> np.uint64(32)).astype(np.uint32)
    for p in range(1, n_id):
        planes[p, :n_valid] = ((ids >> np.uint64(8 * (p - 1)))
                               & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    planes[n_id, :n_valid] = arr_hi
    planes[n_id + 1, :n_valid] = np.arange(n_valid, dtype=np.uint32)
    planes[n_id + 2, :n_valid] = rng.integers(1, 4, n_valid)
    planes[n_id + 3, :n_valid] = (
        rng.integers(0, 3, n_valid).astype(np.uint32)
        | (rng.integers(0, 2, n_valid).astype(np.uint32) << np.uint32(31)))
    for p in range(n_id + 4, n_planes):
        planes[p, :n_valid] = rng.integers(0, 1 << 32, n_valid,
                                           dtype=np.uint64).astype(np.uint32)
    v = planes[:, :n_valid]
    order = np.lexsort(tuple(v[i] for i in reversed(range(n_id + 2))))
    planes[:, :n_valid] = v[:, order]
    return planes


def _check(got_planes, got_count, want, want_count):
    assert int(got_count) == want_count
    for i, p in enumerate(got_planes):
        np.testing.assert_array_equal(np.asarray(p), want[i],
                                      err_msg=f"plane {i}")


@pytest.mark.parametrize("n,frac", [(256, 0.3), (1024, 0.9), (512, 0.0),
                                    (512, 1.0)])
def test_combine_matches_numpy(n, frac):
    """Groups collapse to their head with summed counts; heads compact
    left in order; the rest is padding."""
    rng = np.random.default_rng(int(n * 7 + frac * 100))
    n_valid = int(round(n * (1 - frac)))
    planes = _rand_run(rng, n, n_valid, 2, 6)
    got, cnt = sdn._combine_sorted([jnp.asarray(p) for p in planes], 2)
    want, wc = _np_combine(planes, 2)
    _check(got, cnt, want, wc)


def test_combine_counts_wrap_modulo_2_32():
    """Occurrence totals add modulo 2^32, like the counters they model."""
    planes = np.full((6, 8), INV, np.uint32)
    planes[:2, :4] = [[1, 1, 1, 2], [5, 5, 5, 6]]
    planes[2:4, :4] = 0
    planes[4, :4] = [0xFFFFFFF0, 0x20, 3, 7]
    planes[5, :4] = [0x7FFFFFF0 | 0x80000000, 0x20, 1, 0]
    got, cnt = sdn._combine_sorted([jnp.asarray(p) for p in planes], 2)
    want, wc = _np_combine(planes, 2)
    _check(got, cnt, want, wc)
    assert int(np.asarray(got[4])[0]) == (0xFFFFFFF0 + 0x20 + 3) & 0xFFFFFFFF


@pytest.mark.parametrize("na,nb,n_id", [(512, 512, 2), (1024, 1024, 3),
                                        (768, 256, 2)])
def test_merge_matches_numpy(na, nb, n_id):
    """merge_runs == numpy lexsort of the concatenation, then combine;
    the older run (arr_hi 0) supplies every shared key's head."""
    rng = np.random.default_rng(na * 31 + nb + n_id)
    n_planes = n_id + 4 + (2 if n_id == 3 else 0)
    pool = rng.integers(0, 1 << 40, (na + nb) // 3, dtype=np.uint64)
    a = _rand_run(rng, na, na * 3 // 4, n_id, n_planes, 0, pool)
    b = _rand_run(rng, nb, nb * 3 // 4, n_id, n_planes, 1, pool)
    got, cnt = sdn.merge_runs([jnp.asarray(p) for p in a],
                              [jnp.asarray(p) for p in b], n_id=n_id)
    cat = np.concatenate([a, b], axis=1)
    order = np.lexsort(tuple(cat[i] for i in reversed(range(n_id + 2))))
    want, wc = _np_combine(cat[:, order], n_id)
    _check(got, cnt, want, wc)


def _np_chunk_run(bases, qok, lens, arrival_base, k, l_pre):
    """Reference per-batch run: one record per distinct k-mer with its
    occurrence count, high-quality count and first arrival."""
    s = {key: np.asarray(v) for key, v in
         kops.kmer_stream(jnp.asarray(bases), jnp.asarray(qok),
                          jnp.asarray(lens), k, l_pre).items()}
    n_id, n_planes, carry = sdn.run_layout(k, l_pre)
    two = sdn.n_kb_planes(kops.keybody_bits(k, l_pre)) == 2
    recs = {}
    flat = np.flatnonzero(s["valid"].reshape(-1))
    for i in flat:
        key = (int(s["shard"].reshape(-1)[i]), int(s["keybody"].reshape(-1)[i]))
        hi = int(s["is_high"].reshape(-1)[i])
        if key not in recs:
            recs[key] = [arrival_base + int(i), 0, 0, hi,
                         int(s["ret"].reshape(-1)[i])]
        recs[key][1] += 1
        recs[key][2] += hi
    cap = sdn.next_pow2(bases.shape[0] * bases.shape[1])
    out = np.full((n_planes, cap), INV, np.uint32)
    out[n_id:, :] = 0
    for r, (key, (arr, n, nh, fh, ret)) in enumerate(sorted(recs.items())):
        col = [key[0]]
        col += ([key[1] >> 32, key[1] & INV] if two else [key[1]])
        col += [arr >> 32, arr & INV, n, nh | (fh << 31)]
        if carry:
            col += [ret >> 32, ret & INV]
        out[:, r] = col
    return out, len(recs)


@pytest.mark.parametrize("n_reads,L,k", [(64, 32, 17), (96, 64, 25),
                                         (48, 96, 41)])
def test_chunk_run_matches_numpy(n_reads, L, k):
    """One read batch -> sorted, combined, compacted run."""
    rng = np.random.default_rng(n_reads + L + k)
    genome = rng.integers(0, 4, 400).astype(np.uint8)
    starts = rng.integers(0, 400 - L, n_reads)
    bases = genome[starts[:, None] + np.arange(L)[None, :]]
    bases[rng.random(bases.shape) < 0.01] = 4
    lens = rng.integers(L // 2, L + 1, n_reads).astype(np.int32)
    bases = np.where(np.arange(L)[None, :] < lens[:, None], bases, 4
                     ).astype(np.uint8)
    qok = rng.random(bases.shape) < 0.8
    l_pre = 10 if k <= 32 else 20
    got, cnt = sdn.chunk_run(jnp.asarray(bases), jnp.asarray(qok),
                             jnp.asarray(lens), jnp.uint64(1000), k, l_pre)
    want, wc = _np_chunk_run(bases, qok, lens, 1000, k, l_pre)
    _check(got, cnt, want, wc)
