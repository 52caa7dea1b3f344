"""Batched pre-search annotation: k-mer coverage, solid island, greedy seed.

Vectorized equivalents of bfc_ec_kcov / bfc_ec_best_island /
bfc_ec_first_kmer / bfc_ec_greedy_k (/root/reference/correct.c:63-130).
All sequential rolling loops become windowed cumulative ops; the greedy
single-substitution sweep becomes one [B, k, 3] lookup batch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import kmer as kops
from . import spectrum as spec

I32 = jnp.int32
U64 = jnp.uint64


def _hash_of(x0, x1, x2, x3, k: int):
    """(h0, h1) in the planes' own width: u32 planes (k <= 31) keep the
    whole hash -> slot -> gather chain 32-bit."""
    if x0.dtype == jnp.uint32:
        return kops.canonical_hash32(x0, x1, x2, x3, k)
    _, h0, h1 = kops.canonical_hash(x0, x1, x2, x3, k)
    return h0, h1


def _occ_lookup(table, k, l_pre, s_bits, kb_bits, h0, h1, axis_name="",
                n_dev=1, slack=2, valid=None):
    """Returns (occ, overflow-scalar); see search._occ_of."""
    no_ovf = jnp.zeros((), bool)
    import os

    probe_off = os.environ.get("BFC_PROBE_NO_ANN_OCC", "0") == "1"
    if (h0.dtype == jnp.uint32 and isinstance(table, spec.CuckooTable)
            and k <= 31 and s_bits <= 32 and not probe_off):
        # all-32-bit probe: the fast-gather path (see search._occ_of)
        return spec.cuckoo_lookup32(table, h0, h1, k, s_bits), no_ovf
    if h0.dtype == jnp.uint32:
        h0 = h0.astype(U64)
        h1 = h1.astype(U64)
    q_shard, q_kb = kops.shard_and_keybody(h0, h1, k, l_pre)
    if probe_off:
        # measurement-only (trace-time): expose the kcov/greedy gather
        # share of the per-batch fixed cost on real hardware
        return (q_shard.astype(jnp.int32) & 0xFF) | 0x700, no_ovf
    if isinstance(table, spec.ShardedCuckoo):
        return spec.sharded_cuckoo_lookup(
            table, q_shard, q_kb, s_bits, l_pre, kb_bits, axis_name, n_dev,
            slack=slack, valid=valid,
        )
    if isinstance(table, spec.CuckooTable):
        return spec.cuckoo_lookup(table, q_shard, q_kb, s_bits, l_pre, kb_bits), no_ovf
    if isinstance(table, spec.PackedTable):
        return spec.packed_lookup(table, q_shard, q_kb, s_bits, l_pre, kb_bits), no_ovf
    return spec.table_lookup(table, q_shard, q_kb, s_bits, l_pre, kb_bits), no_ovf


@functools.partial(jax.jit, static_argnames=(
    "k", "l_pre", "s_bits", "kb_bits", "min_cov", "axis_name", "n_dev",
    "slack"))
def kcov_batch(table, seq_b, lens, k: int, l_pre: int, s_bits: int, kb_bits: int,
               min_cov: int, axis_name: str = "", n_dev: int = 1,
               slack: int = 2, planes=None):
    """Per-base solid coverage annotation (bfc_ec_kcov, correct.c:96-117).

    Returns (solid_end, high_end, lcov, hcov, occ, ovf) where occ is the
    raw per-position k-mer payload (-1 absent) reused by later stages."""
    B, L = seq_b.shape
    if planes is None:
        planes = kops.kmer_planes(seq_b, k,
                                  jnp.uint32 if k <= 31 else U64)
    x0, x1, x2, x3 = planes
    valid = kops.valid_kmer_mask(seq_b, lens, k)
    h0, h1 = _hash_of(x0, x1, x2, x3, k)
    occ, ovf = _occ_lookup(table, k, l_pre, s_bits, kb_bits, h0, h1,
                           axis_name, n_dev, slack, valid=valid)
    occ = jnp.where(valid, occ, -1)
    present = occ >= 0
    high_end = present & (((occ >> 8) & 0x3F) >= min_cov + 1)
    solid_end = present & ((occ & 0xFF) >= min_cov)
    # lcov[j] = # solid k-mer ends in [j, j+k-1]; hcov with high_end too
    # (6-bit fields in the reference: wrap mod 64)
    se = solid_end.astype(I32)
    he = (solid_end & high_end).astype(I32)
    cs = jnp.cumsum(se, axis=-1)
    ch = jnp.cumsum(he, axis=-1)
    idx = jnp.arange(L, dtype=jnp.int32)
    hi = jnp.minimum(idx + k - 1, L - 1)
    lcov = (cs[:, hi] - cs + se) & 63
    hcov = (ch[:, hi] - ch + he) & 63
    return solid_end, high_end, lcov, hcov, occ, ovf


@functools.partial(jax.jit, static_argnames=("k",))
def best_island_batch(solid_end, lens, k: int):
    """Longest solid run (bfc_ec_best_island, correct.c:119-130).

    Returns (start, end, found): candidates are evaluated at every
    non-solid position in [k-1, n) plus the sentinel position n, taking
    the first strict maximum, exactly like the reference scan."""
    B, L = solid_end.shape
    idx = jnp.arange(L + 1, dtype=jnp.int32)
    # solid within the scanned domain [k-1, n)
    sol = jnp.pad(solid_end, ((0, 0), (0, 1)))
    in_dom = (idx[None, :] >= k - 1) & (idx[None, :] < lens[:, None])
    sol = sol & in_dom
    # run of consecutive solid positions ending at i (inclusive)
    brk = jnp.where(~sol, idx[None, :], -1)
    last_brk = jax.lax.associative_scan(jnp.maximum, brk, axis=-1)
    run_end = idx[None, :] - last_brk - 1  # run length ending at i (if sol[i])
    run_before = jnp.concatenate(
        [jnp.zeros((B, 1), I32), jnp.where(sol, run_end + 1, 0).astype(I32)[:, :-1]],
        axis=1,
    )
    # candidate positions: non-solid in domain, or i == n
    cand = (~sol & in_dom) | (idx[None, :] == lens[:, None])
    l_cand = jnp.where(cand, run_before, 0)
    # first maximum wins (strict > in the reference): key on (l, -i)
    key = l_cand.astype(jnp.int64) * (L + 2) + (L + 1 - idx[None, :])
    key = jnp.where(cand & (l_cand > 0), key, -1)
    best = jnp.argmax(key, axis=-1).astype(I32)
    found = jnp.max(key, axis=-1) >= 0
    maxl = l_cand[jnp.arange(B, dtype=jnp.int32), best]
    start = best - maxl - (k - 1)
    return jnp.where(found, start, 0), jnp.where(found, best, 0), found


def first_kmer_batch(seq_b, lens, start, k: int, planes=None):
    """First full k-mer at/after start (bfc_ec_first_kmer, correct.c:82-94).

    Returns (end_pos, x0, x1, x2, x3, found): end_pos is the index of
    the k-mer's last base (== n when absent).  Pass `planes` (the
    kmer_planes of seq_b) when calling inside a loop - the window
    packing is position-independent, so recomputing it per call is
    wasted work; plane extraction uses flat gathers."""
    B, L = seq_b.shape
    idx = jnp.arange(L, dtype=jnp.int32)
    bad = (seq_b > 3) | (idx[None, :] >= lens[:, None]) | (idx[None, :] < start[:, None])
    last_bad = jax.lax.associative_scan(
        jnp.maximum, jnp.where(bad, idx[None, :], -1), axis=-1
    )
    run = idx[None, :] - last_bad
    ok = (run >= k) & (idx[None, :] < lens[:, None])
    end_pos = jnp.argmax(ok, axis=-1).astype(I32)
    found = jnp.any(ok, axis=-1)
    if planes is None:
        planes = kops.kmer_planes(seq_b, k,
                                  jnp.uint32 if k <= 31 else U64)
    x0, x1, x2, x3 = planes
    r = jnp.arange(B, dtype=jnp.int32)
    flat = (r * L + jnp.where(found, end_pos, 0)).astype(jnp.uint32)
    return (
        jnp.where(found, end_pos, lens),
        x0.reshape(-1)[flat], x1.reshape(-1)[flat],
        x2.reshape(-1)[flat], x3.reshape(-1)[flat],
        found,
    )


@functools.partial(jax.jit, static_argnames=(
    "k", "l_pre", "s_bits", "kb_bits", "axis_name", "n_dev", "slack"))
def greedy_k_batch(table, x0, x1, x2, x3, mode, k: int, l_pre: int, s_bits: int,
                   kb_bits: int, axis_name: str = "", n_dev: int = 1,
                   slack: int = 2, valid=None):
    """Single-substitution brute-force repair (bfc_ec_greedy_k, correct.c:63-80).

    Tries all (position, alt-base) substitutions of the k-mer; accepts
    iff 3*best_count > mode and second_best_count < 3.  Returns
    (pos<<2|base or -1, ovf), replicating the scan's first-wins
    tie-breaking.  All 4k candidates go through ONE batched lookup
    (one gather round / one routing round instead of 4k).
    """
    B = x0.shape[0]
    D = x0.dtype.type
    cand_h0 = []
    cand_h1 = []
    cand_skip = []
    cand_code = []
    for i in range(k):
        cur = (((x1 >> D(i)) & D(1)) << D(1)) | ((x0 >> D(i)) & D(1))
        for j in range(4):
            nx = kops.change_base(x0, x1, x2, x3, i, jnp.full((B,), j, I32), k)
            h0, h1 = _hash_of(*nx, k)
            cand_h0.append(h0)
            cand_h1.append(h1)
            cand_skip.append(cur == j)  # j == c: skipped
            cand_code.append((i << 2) | j)
    occ, ovf = _occ_lookup(
        table, k, l_pre, s_bits, kb_bits,
        jnp.stack(cand_h0, axis=1), jnp.stack(cand_h1, axis=1),
        axis_name, n_dev, slack,
        valid=None if valid is None else valid[:, None],
    )                                             # [B, 4k]
    occ = jnp.where(jnp.stack(cand_skip, axis=1), -1, occ)
    codes = jnp.asarray(cand_code, I32)           # [4k]
    cnt = jnp.where(occ >= 0, occ & 0xFF, -1)
    # running max with strict > (first wins) == argmax with lowest index
    best_idx = jnp.argmax(cnt, axis=1)
    best_cnt = jnp.max(cnt, axis=1)
    # second best including duplicates of the max
    cnt2 = cnt.at[jnp.arange(B, dtype=jnp.int32), best_idx].set(-1)
    second_cnt = jnp.max(cnt2, axis=1)
    best_cnt = jnp.maximum(best_cnt, 0)           # max starts at 0 in the ref
    second_cnt = jnp.maximum(second_cnt, 0)
    ok = (best_cnt * 3 > mode) & (second_cnt < 3)
    # max_ec stays -1 unless some candidate raised max above 0
    has = jnp.max(cnt, axis=1) > 0
    return jnp.where(ok & has, codes[best_idx], -1), ovf
