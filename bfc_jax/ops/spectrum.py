"""Sort-based exact k-mer spectrum build + device lookup table.

Replacement for the reference's spin-locked Bloom filter +
sharded count hash (/root/reference/bbf.c, htab.c, count.c:54-70).  The
reference's insert-order semantics (documented at count.c:9-18) are made
*deterministic and parallel* by defining them under sequential stream
order (== `bfc -t1`) and computing them exactly:

  * per distinct k-mer, occurrences 2..n always enter the table
    (their Bloom probes were set by occurrence 1);
  * occurrence 1 enters iff all its probe bits were set by strictly
    earlier-arriving k-mers - a pure function of (probe bits, arrival)
    resolved with a sort + segmented-min over exploded probe bits,
    instead of a shared mutable filter.

The count table is a flat, displacement-bounded sorted layout addressed
by the uniform hash bits (an idiomatic gather-friendly replacement for
khash open addressing): entries sorted by (shard, keybody) are placed at
slot = max(ideal, prev_slot+1) via a cumulative max, so lookups gather
one aligned window and almost always resolve in a single probe.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..opts import BFC_BLK_SHIFT
from . import kmer as kops

U64 = jnp.uint64
U32 = jnp.uint32
INVALID_SHARD = jnp.uint32(0xFFFFFFFF)


def stable_order(*keys_lsb_first):
    """Permutation sorting lexicographically by keys (most-significant last).

    Implemented as LSD-radix passes of a single stable (u32 key, u32
    perm) lax.sort plus a gather per pass.  On an H100 that is 2-5x
    faster than one multi-key stable lax.sort with an iota payload at
    two and three keys and 2^20-2^22 rows (PERF.md).

    Keys are u32 arrays, least-significant first.  Wider keys must be
    pre-split into u32 halves by the caller.
    """
    N = keys_lsb_first[0].shape[0]
    perm = jnp.arange(N, dtype=jnp.uint32)
    for key in keys_lsb_first:
        kcur = key[perm]
        _, perm = jax.lax.sort((kcur, perm), num_keys=1, is_stable=True)
    return perm


def _split64(x):
    return (x & U64(0xFFFFFFFF)).astype(U32), (x >> U64(32)).astype(U32)


class Aggregate(NamedTuple):
    """Per-distinct-k-mer partial aggregates (padded; valid where shard != INVALID)."""

    shard: jax.Array      # u32 [C]
    keybody: jax.Array    # u64 [C]
    ret: jax.Array        # u64 [C] Bloom-addressing hash (low 64 bits)
    n: jax.Array          # u32 [C] total occurrences
    n_high: jax.Array     # u32 [C] high-quality occurrences
    first_arr: jax.Array  # u64 [C] arrival index of first occurrence
    first_high: jax.Array  # u32 [C] is_high of the first occurrence


def _segment_combine(shard, keybody, ret, n, n_high, first_arr, first_high, cap: int):
    """Sort entries by (shard, keybody, first_arr) and merge equal keys.

    Entries with shard == INVALID_SHARD are padding and combine to
    nothing.  Returns an Aggregate of capacity cap (>= #groups).

    PRECONDITION: entries with equal (shard, keybody) appear in
    ascending first_arr order in the input (true for the raw k-mer
    stream, which is in arrival order, and for aggregate merges, where
    the earlier aggregate precedes the later chunk) - the stable radix
    order then makes the first element of each group the earliest
    occurrence without sorting on first_arr."""
    N = shard.shape[0]
    kb_lo, kb_hi = _split64(keybody)
    src = stable_order(kb_lo, kb_hi, shard)
    shard = shard[src]
    keybody = keybody[src]
    first_arr = first_arr[src]
    ret = ret[src]
    n = n[src]
    n_high = n_high[src]
    first_high = first_high[src]
    valid = shard != INVALID_SHARD
    prev_same = jnp.concatenate(
        [
            jnp.zeros((1,), bool),
            (shard[1:] == shard[:-1]) & (keybody[1:] == keybody[:-1]),
        ]
    )
    first = valid & ~prev_same
    # compact group-start indices to the front (stable argsort of ~first)
    order = jnp.argsort(~first, stable=True)
    starts = order  # starts[g] = index of group g's first element (g < G)
    G = jnp.sum(first)
    idx = jnp.arange(N, dtype=jnp.int32)
    gvalid = idx < G
    s_g = jnp.where(gvalid, starts, N - 1)
    # group end = next group's start - 1; last group ends at last valid index
    n_valid = jnp.sum(valid)
    e_g = jnp.where(idx + 1 < G, jnp.roll(starts, -1) - 1, n_valid - 1)
    e_g = jnp.where(gvalid, e_g, N - 1)

    def segsum(v):
        # i32 cumulative sums: this caps exact totals at 2^31
        # occurrences per device per run (sharding divides the stream)
        c = jnp.cumsum(v.astype(jnp.int32))
        return (c[e_g] - c[s_g] + v[s_g].astype(jnp.int64)).astype(v.dtype)

    out_n = segsum(n)
    out_nh = segsum(n_high)
    out = Aggregate(
        shard=jnp.where(gvalid, shard[s_g], INVALID_SHARD),
        keybody=jnp.where(gvalid, keybody[s_g], U64(0xFFFFFFFFFFFFFFFF)),
        ret=jnp.where(gvalid, ret[s_g], U64(0)),
        n=jnp.where(gvalid, out_n, U32(0)),
        n_high=jnp.where(gvalid, out_nh, U32(0)),
        first_arr=jnp.where(gvalid, first_arr[s_g], U64(0xFFFFFFFFFFFFFFFF)),
        first_high=jnp.where(gvalid, first_high[s_g], U32(0)),
    )
    # pad or truncate to cap (caller guarantees G <= cap; overflow detected
    # by the driver via the returned count)
    def fit(a, fill):
        if cap <= N:
            return a[:cap]
        return jnp.concatenate([a, jnp.full((cap - N,), fill, a.dtype)])

    out = Aggregate(
        shard=fit(out.shard, INVALID_SHARD),
        keybody=fit(out.keybody, U64(0xFFFFFFFFFFFFFFFF)),
        ret=fit(out.ret, U64(0)),
        n=fit(out.n, U32(0)),
        n_high=fit(out.n_high, U32(0)),
        first_arr=fit(out.first_arr, U64(0xFFFFFFFFFFFFFFFF)),
        first_high=fit(out.first_high, U32(0)),
    )
    return out, G


@functools.partial(jax.jit, static_argnames=("k", "l_pre", "cap"))
def chunk_aggregate(bases, qual_ok, lengths, arrival_base, k: int, l_pre: int, cap: int):
    """Aggregate one read batch into per-distinct-k-mer stats."""
    s = kops.kmer_stream(bases, qual_ok, lengths, k, l_pre)
    B, L = bases.shape
    arrival = arrival_base + jnp.arange(B * L, dtype=jnp.uint64)
    valid = s["valid"].reshape(-1)
    shard = jnp.where(valid, s["shard"].reshape(-1), INVALID_SHARD)
    keybody = s["keybody"].reshape(-1)
    ret = s["ret"].reshape(-1)
    is_high = s["is_high"].reshape(-1).astype(U32)
    one = valid.astype(U32)
    return _segment_combine(shard, keybody, ret, one, is_high, arrival, is_high, cap)


@functools.partial(jax.jit, static_argnames=("cap",))
def merge_aggregates(a: Aggregate, b: Aggregate, cap: int):
    """Merge two aggregates (concatenate + segment-combine)."""
    cat = Aggregate(*[jnp.concatenate([x, y]) for x, y in zip(a, b)])
    return _segment_combine(
        cat.shard, cat.keybody, cat.ret, cat.n, cat.n_high, cat.first_arr,
        cat.first_high, cap,
    )


# ---------------------------------------------------------------------------
# Bloom probe expansion + first-occurrence adjudication
# ---------------------------------------------------------------------------

def bloom_probe_bits(ret, bf_shift: int, n_hashes: int):
    """Global bit indices probed by each hash (bbf.c:27-37 addressing).

    ret: u64 [...]; returns u64 [..., n_hashes] of block*512+offset.
    The variable-skip probe walk (byte 0 of each block is skipped) is
    unrolled to n_hashes+8 candidates, of which the first n_hashes valid
    ones are selected - within 12 steps of a >=32-long probe cycle at
    most 8 land in byte 0, so this is always enough.
    """
    x = bf_shift - BFC_BLK_SHIFT
    block = ret & U64((1 << x) - 1)
    h1 = (ret >> U64(x)) & U64(511)
    h2 = (ret >> U64(bf_shift)) & U64(511)
    h2 = jnp.where((h2 & U64(31)) == 0, (h2 + U64(1)) & U64(511), h2)
    n_steps = n_hashes + 8
    zs = []
    z = h1
    for _ in range(n_steps):
        zs.append(z)
        z = (z + h2) & U64(511)
    zs = jnp.stack(zs, axis=-1)                       # [..., n_steps]
    ok = zs >= U64(8)
    # rank among valid candidates; pick ranks 0..n_hashes-1
    rank = jnp.cumsum(ok.astype(jnp.int32), axis=-1) - 1
    sel = jnp.where(ok, rank, -1)
    out = jnp.zeros(ret.shape + (n_hashes,), dtype=U64)
    for j in range(n_hashes):
        pick = jnp.sum(jnp.where(sel == j, zs, U64(0)), axis=-1)
        out = out.at[..., j].set(pick)
    return (block[..., None] << U64(BFC_BLK_SHIFT)) | out


@functools.partial(jax.jit, static_argnames=("bf_shift", "n_hashes"))
def adjudicate_first_occurrence(agg: Aggregate, bf_shift: int, n_hashes: int):
    """Was each distinct k-mer's first Bloom insert already fully set?

    For each group: explode its n_hashes probe bits; a bit was set
    before arrival a iff some other group's first occurrence with a
    smaller arrival probes the same bit.  Returns bool [C]: the
    false-positive promotion flag for the group's first occurrence.
    """
    C = agg.shard.shape[0]
    valid = agg.shard != INVALID_SHARD
    bits = bloom_probe_bits(agg.ret, bf_shift, n_hashes)      # [C, H]
    H = n_hashes
    flat_bits = bits.reshape(-1)
    flat_arr = jnp.broadcast_to(agg.first_arr[:, None], (C, H)).reshape(-1)
    flat_valid = jnp.broadcast_to(valid[:, None], (C, H)).reshape(-1)
    sent = U64(0xFFFFFFFFFFFFFFFF)
    key_bits = jnp.where(flat_valid, flat_bits, sent)
    a_lo, a_hi = _split64(flat_arr)
    b_lo, b_hi = _split64(key_bits)
    ssrc = stable_order(a_lo, a_hi, b_lo, b_hi)
    sb = key_bits[ssrc]
    sa = flat_arr[ssrc]
    first = jnp.concatenate([jnp.ones((1,), bool), sb[1:] != sb[:-1]])
    # forward-fill each bit-group's min arrival (= first element's arrival,
    # since the sort is keyed by (bit, arrival))
    min_arr = _forward_fill(jnp.where(first, sa, U64(0)), first)
    was_set = min_arr < sa
    # scatter back to original order
    hit = jnp.zeros((C * H,), bool).at[ssrc].set(was_set)
    return jnp.all(hit.reshape(C, H), axis=-1) & valid


def _forward_fill(vals, first):
    """Broadcast each group-start value forward over its segment.

    Computed as an i32 cumulative max of start indices followed by one
    gather, so the scan never runs over 64-bit values."""
    N = vals.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)
    seg_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(first, idx, 0), axis=0
    )
    return vals[seg_start]


# ---------------------------------------------------------------------------
# Finalization: payloads, histogram, lookup table
# ---------------------------------------------------------------------------

class Table(NamedTuple):
    """Flat displacement-addressed spectrum table (device-resident)."""

    kb_payload: jax.Array  # u64 [S+margin]: keybody<<14 | payload (like htab keys)
    shard: jax.Array       # u32 [S+margin]; INVALID_SHARD = empty


class PackedTable(NamedTuple):
    """Single-u64-entry table: the dominant cost of the correction search
    is random HBM gathers into the spectrum, so the entry packs
    displacement(6) << 58 | identity_low << 14 | payload(14) into one
    word - the identity's top s_bits are implied by the slot position
    (ideal slot = entry slot - displacement), making lookups exact with
    half the gather traffic of the two-array layout.  Usable whenever
    identity_bits - s_bits <= 44; empty slots have payload == 0."""

    entries: jax.Array  # u64 [S+margin]


class CuckooTable(NamedTuple):
    """Two-choice (partial-key cuckoo) spectrum table.

    The lookup hot path is a random HBM gather, so the layout is chosen
    to make every lookup EXACTLY two probes with no continuation loop.
    Conceptual entry: identity_low << 15 | nest(1) << 14 | payload(14);
    payload == 0 marks an empty slot.  Slot s1 = top c_bits of the
    position key (nest 0); slot s2 = s1 ^ alt_hash(identity_low)
    (nest 1).  The (slot, nest, identity_low) triple reconstructs the
    full identity, so matches are exact - same guarantee as the khash
    key compare (htab.c:84-92).

    Stored as TWO u32 PLANES, not one u64 array, so the hot lookup
    (cuckoo_lookup32) keeps its whole hash -> slot -> gather chain in
    32-bit arithmetic.  lo holds entry bits 0-31 (payload | nest<<14 |
    qlow<<15 low bits), hi bits 32-63."""

    lo: jax.Array  # u32 [1 << c_bits]
    hi: jax.Array  # u32 [1 << c_bits]


class ShardedCuckoo(NamedTuple):
    """Hash-prefix-sharded cuckoo table for meshes where the spectrum
    does not fit one device (the reference's whole design sizes for
    this: htab.c:28-33 prefix sharding, 67-84 GB peak on human).

    Each device block is an INDEPENDENT cuckoo sub-table over the keys
    of its hash-prefix range - the reference's 1<<l_pre independent
    khash shards, at mesh granularity.  Both probe slots of a key live
    inside its owner's block, so a lookup routes ONE request (the
    64-bit position key) to the owner and gets ONE occ word back -
    half the collective traffic of routing raw slot fetches, and the
    per-destination load is hash-uniform by construction.

    Globally each plane is u32 [n_dev << cb_local]; under shard_map
    each device sees its block [1 << cb_local].  The global c_bits (as
    carried in SearchConfig.s_bits / DeviceSpectrum.s_bits) is
    log2(n_dev) + cb_local.  Sub-table hash: for position key pk,
    dest = pk >> (64 - log2(n_dev)); s1 = next cb_local bits of pk;
    s2 = s1 ^ (mult_hash(qlow) >> (64 - cb_local)); entry layout is
    CuckooTable's (qlow << 15 | nest << 14 | payload), and
    (dest, slot, nest, qlow) reconstructs the full identity, so matches
    stay exact.

    Stored as lo/hi u32 planes, like CuckooTable."""

    lo: jax.Array  # u32, entry bits 0-31; globally [n_dev << cb_local]
    hi: jax.Array  # u32, entry bits 32-63


def sharded_from_u64(entries) -> "ShardedCuckoo":
    """Split u64 sub-table entries into the lo/hi probe planes
    (elementwise, so any device sharding of `entries` is preserved)."""
    if isinstance(entries, np.ndarray):
        return ShardedCuckoo(
            lo=(entries & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            hi=(entries >> np.uint64(32)).astype(np.uint32),
        )
    return ShardedCuckoo(
        lo=(entries & U64(0xFFFFFFFF)).astype(U32),
        hi=(entries >> U64(32)).astype(U32),
    )


def _dest_bits(n_dev: int) -> int:
    assert n_dev & (n_dev - 1) == 0, "sharded table needs 2^k devices"
    return n_dev.bit_length() - 1


def sharded_cuckoo_lookup(table: ShardedCuckoo, q_shard, q_keybody,
                          c_bits: int, l_pre: int, kb_bits: int,
                          axis_name: str, n_dev: int, slack: int = 2,
                          valid=None):
    """Batched payload lookup against a prefix-sharded cuckoo table.

    Inside shard_map over `axis_name`.  Routes each query's position
    key to its prefix owner with a paired all_to_all (sort-based
    bucketing: one radix pass, O(N) independent of n_dev); the owner
    answers with the occ word after two local probes.  Returns
    (occ i32 [...], overflow bool scalar): overflow=True when a
    destination bucket exceeded its capacity (requests dropped -
    callers must treat the round as unusable and retry with more
    slack or fall back).  Buckets are hash-uniform over VALID queries,
    so overflow needs pathological key skew at slack >= 2; pass
    `valid` so dead lanes (padding reads, finished search lanes, which
    often share one constant window and would all route to one owner)
    never enter a bucket - their occ returns -1."""
    shape = q_shard.shape
    qs = q_shard.reshape(-1)
    qk = q_keybody.reshape(-1)
    pk = posk64(qs, qk, l_pre, kb_bits)
    db = _dest_bits(n_dev)
    Sl = table.lo.shape[0]
    cb_local = c_bits - db
    assert Sl == 1 << cb_local, (Sl, c_bits, db)
    N = pk.shape[0]
    cap = max(64, (N + n_dev - 1) // n_dev * slack)
    dest = (
        (pk >> U64(64 - db)).astype(U32) if db else jnp.zeros((N,), U32)
    )
    if valid is not None:
        vflat = jnp.broadcast_to(valid, shape).reshape(-1)
        dest = jnp.where(vflat, dest, U32(n_dev))
    order = stable_order(dest)
    dest_s = dest[order].astype(jnp.int32)
    rank = (
        jnp.arange(N, dtype=jnp.int32)
        - jnp.searchsorted(dest_s, dest_s, side="left").astype(jnp.int32)
    )
    counts = jnp.bincount(jnp.minimum(dest_s, n_dev), length=n_dev + 1)[:n_dev]
    overflow = jnp.any(counts > cap)
    slot = jnp.where(
        (dest_s < n_dev) & (rank < cap), dest_s * cap + rank, n_dev * cap + 1
    )
    # identity bits can exceed 64 (big k): qlow is then not derivable
    # from pk at the owner and must ride along as a second plane
    carry_qlow = identity_bits(l_pre, kb_bits) > 64
    qlow_mine = _id_low(qs, qk, l_pre, kb_bits, c_bits)
    buf = jnp.zeros((n_dev * cap,), U64).at[slot].set(pk[order], mode="drop")

    def xch(b):
        return jax.lax.all_to_all(
            b.reshape(n_dev, cap), axis_name, split_axis=0, concat_axis=0,
            tiled=True,
        ).reshape(-1)

    req = xch(buf)
    if carry_qlow:
        bufq = jnp.zeros((n_dev * cap,), U64).at[slot].set(
            qlow_mine[order], mode="drop"
        )
        qlow_r = xch(bufq)
    else:
        idb = identity_bits(l_pre, kb_bits)
        nlow = idb - c_bits
        qlow_r = (
            (req >> U64(64 - idb)) & U64((1 << nlow) - 1)
            if nlow > 0 else jnp.zeros_like(req)
        )
    # owner-side probes: both slots are local to this block; the u64
    # entries are recombined after the u32 gathers.
    s1 = ((req >> U64(64 - c_bits)) & U64(Sl - 1)).astype(U32)
    alt = ((qlow_r * _CUCKOO_GOLD) >> U64(64 - cb_local)).astype(U32)
    s2 = s1 ^ alt
    e1 = table.lo[s1].astype(U64) | (table.hi[s1].astype(U64) << U64(32))
    e2 = table.lo[s2].astype(U64) | (table.hi[s2].astype(U64) << U64(32))

    def match(e, nest):
        return (
            ((e & U64(0x3FFF)) != 0)
            & (((e >> U64(14)) & U64(1)) == U64(nest))
            & ((e >> U64(15)) == qlow_r)
        )

    v1 = (e1 & U64(0x3FFF)).astype(jnp.int32)
    v2 = (e2 & U64(0x3FFF)).astype(jnp.int32)
    ans = jnp.where(match(e1, 0), v1, jnp.where(match(e2, 1), v2, -1))
    resp = xch(ans)
    got_sorted = jnp.where(
        slot < n_dev * cap, resp[jnp.minimum(slot, n_dev * cap - 1)], -1
    )
    occ = jnp.zeros((N,), jnp.int32).at[order].set(got_sorted)
    return occ.reshape(shape), overflow


def cuckoo_build_local(shard, keybody, payload, c_bits: int, cb_local: int,
                       l_pre: int, kb_bits: int, max_rounds: int = 256,
                       axis_name: str = ""):
    """Build one device's cuckoo sub-table (shard_map body; no
    collectives, so devices may take different trip counts).

    Inputs are the device's compacted kept entries (padding rows have
    payload == 0).  Vectorized random-walk insertion, the device twin
    of spectrum_host.build_cuckoo_table_host: every unplaced key claims
    its preferred slot, losers and evicted keys flip to their alternate
    slot.  The host build breaks eviction cycles by randomizing the
    WRITE ORDER each round; here the per-slot winner is the max of a
    round-hashed priority (a scatter-max, deterministic regardless of
    XLA's duplicate-scatter order) - same distribution, reproducible.
    Placement is layout-only, never output-visible.  Returns
    (entries u64 [Sl], ok)."""
    Sl = 1 << cb_local
    n = shard.shape[0]
    valid = payload != 0
    pk = posk64(shard, keybody, l_pre, kb_bits)
    s1 = ((pk >> U64(64 - c_bits)) & U64(Sl - 1)).astype(jnp.int32)
    qlow = _id_low(shard, keybody, l_pre, kb_bits, c_bits)
    alt = ((qlow * _CUCKOO_GOLD) >> U64(64 - cb_local)).astype(jnp.int32)
    s2 = s1 ^ alt
    ids = jnp.arange(n, dtype=jnp.int32)
    idb = max(int(n).bit_length(), 1)  # id+1 fits idb+1 bits
    idmask = U64((1 << (idb + 1)) - 1)
    ids_u = ids.astype(U64) + U64(1)   # 0 = "no claim" sentinel

    def pending(occupant, cur):
        return valid & (occupant[cur] != ids)

    def cond(state):
        occupant, cur, pref, rnd = state
        return jnp.any(pending(occupant, cur)) & (rnd < max_rounds)

    def body(state):
        occupant, cur, pref, rnd = state
        pend = pending(occupant, cur)
        # random per-round winner among contenders (splitmix-style hash)
        prio = (ids.astype(U64) + U64(0x9E3779B97F4A7C15)) * (
            rnd.astype(U64) * U64(2) + U64(0xBF58476D1CE4E5B9)
        )
        wval = ((prio >> U64(idb + 1)) << U64(idb + 1)) | ids_u
        claim = jnp.zeros((Sl,), U64).at[
            jnp.where(pend, cur, Sl)
        ].max(wval, mode="drop")
        won = (claim & idmask).astype(jnp.int32) - 1
        occupant = jnp.where(claim > 0, won, occupant)
        pend2 = pending(occupant, cur)
        pref = pref ^ pend2.astype(jnp.int32)
        cur = jnp.where(pend2, jnp.where(pref == 0, s1, s2), cur)
        return occupant, cur, pref, rnd + 1

    init = (jnp.full((Sl,), -1, jnp.int32), s1,
            jnp.zeros((n,), jnp.int32), jnp.zeros((), jnp.int32))
    if axis_name:
        # constant-initialized carries must be marked device-varying to
        # match the body outputs under shard_map (see search._pvary_all)
        init = tuple(
            x if axis_name in getattr(jax.typeof(x), "vma", frozenset())
            else jax.lax.pvary(x, axis_name)
            for x in init
        )
    occupant, cur, pref, _ = jax.lax.while_loop(cond, body, init)
    placed = valid & (occupant[cur] == ids)
    ok = ~jnp.any(valid & ~placed)
    entry = (qlow << U64(15)) | (pref.astype(U64) << U64(14)) | payload.astype(U64)
    entries = jnp.zeros((Sl,), U64).at[
        jnp.where(placed, cur, Sl)
    ].set(entry, mode="drop")
    return entries, ok


@functools.partial(jax.jit, static_argnames=("c_bits", "l_pre", "kb_bits",
                                              "max_rounds"))
def cuckoo_build_device(shard, keybody, payload, c_bits: int, l_pre: int,
                        kb_bits: int, max_rounds: int = 256):
    """Single full-size cuckoo table built ON DEVICE (the no-spill
    counting fast path): the device twin of build_cuckoo_table_host,
    with the SAME alternate-slot hash as cuckoo_lookup/cuckoo_lookup32
    (cuckoo_alt_u64) so lookups match the host-built table bit-for-bit.
    Placement order differs from the host build (random-walk with
    scatter-max winners, like cuckoo_build_local) - layout-only, never
    output-visible.  Padding rows have payload == 0.  Returns
    (lo u32 [S], hi u32 [S], ok)."""
    assert c_bits <= 31
    S = 1 << c_bits
    n = shard.shape[0]
    valid = payload != 0
    pk = posk64(shard, keybody, l_pre, kb_bits)
    s1 = (pk >> U64(64 - c_bits)).astype(jnp.int32)
    qlow = _id_low(shard, keybody, l_pre, kb_bits, c_bits)
    alt = cuckoo_alt_u64(qlow, c_bits).astype(jnp.int32)
    s2 = s1 ^ alt
    ids = jnp.arange(n, dtype=jnp.int32)
    idb = max(int(n).bit_length(), 1)
    idmask = U64((1 << (idb + 1)) - 1)
    ids_u = ids.astype(U64) + U64(1)

    def pending(occupant, cur):
        # cur is always in [0, S): unsigned indices skip the
        # negative-index wrap
        return valid & (occupant[cur.astype(U32)] != ids)

    def cond(state):
        occupant, cur, pref, rnd = state
        return jnp.any(pending(occupant, cur)) & (rnd < max_rounds)

    def body(state):
        occupant, cur, pref, rnd = state
        pend = pending(occupant, cur)
        prio = (ids.astype(U64) + U64(0x9E3779B97F4A7C15)) * (
            rnd.astype(U64) * U64(2) + U64(0xBF58476D1CE4E5B9)
        )
        wval = ((prio >> U64(idb + 1)) << U64(idb + 1)) | ids_u
        claim = jnp.zeros((S,), U64).at[
            jnp.where(pend, cur, S)
        ].max(wval, mode="drop")
        won = (claim & idmask).astype(jnp.int32) - 1
        occupant = jnp.where(claim > 0, won, occupant)
        pend2 = pending(occupant, cur)
        pref = pref ^ pend2.astype(jnp.int32)
        cur = jnp.where(pend2, jnp.where(pref == 0, s1, s2), cur)
        return occupant, cur, pref, rnd + 1

    init = (jnp.full((S,), -1, jnp.int32), s1,
            jnp.zeros((n,), jnp.int32), jnp.zeros((), jnp.int32))
    occupant, cur, pref, _ = jax.lax.while_loop(cond, body, init)
    placed = valid & (occupant[cur.astype(U32)] == ids)
    ok = ~jnp.any(valid & ~placed)
    entry = (qlow << U64(15)) | (pref.astype(U64) << U64(14)) | payload.astype(U64)
    entries = jnp.zeros((S,), U64).at[
        jnp.where(placed, cur, S)
    ].set(entry, mode="drop")
    lo = (entries & U64(0xFFFFFFFF)).astype(U32)
    hi = (entries >> U64(32)).astype(U32)
    return lo, hi, ok


_CUCKOO_GOLD = U64(0x9E3779B97F4A7C15)

# CuckooTable alternate-slot hash for c_bits <= 32: a pure-u32 mix of
# the two qlow words, so the search's slot computation never touches a
# 64-bit op.  Must match _alt32_np /
# cuckoo_lookup32 / build_cuckoo_table_host bit-for-bit.  c_bits > 32
# tables keep the original 64-bit GOLD multiply.  Layout-only: the
# placement hash is never output-visible.
_ALT_C1 = 0x9E3779B9
_ALT_C2 = 0x85EBCA6B


def cuckoo_alt_u64(qlow, c_bits: int):
    """Alternate-slot offset from a u64 qlow (build/generic-lookup side)."""
    if c_bits > 32:
        return (qlow * _CUCKOO_GOLD) >> U64(64 - c_bits)
    h = (
        ((qlow & U64(0xFFFFFFFF)) * U64(_ALT_C1))
        ^ ((qlow >> U64(32)) * U64(_ALT_C2))
    ) & U64(0xFFFFFFFF)
    return h >> U64(32 - c_bits)


def cuckoo_alt_np(qlow, c_bits: int):
    import numpy as np

    if c_bits > 32:
        return (qlow * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(64 - c_bits)
    h = (
        ((qlow & np.uint64(0xFFFFFFFF)) * np.uint64(_ALT_C1))
        ^ ((qlow >> np.uint64(32)) * np.uint64(_ALT_C2))
    ) & np.uint64(0xFFFFFFFF)
    return h >> np.uint64(32 - c_bits)


def cuckoo_from_u64(entries) -> CuckooTable:
    """Split a u64 entry array (host build output) into the u32 planes."""
    import numpy as np

    e = np.asarray(entries)
    lo = (e & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (e >> np.uint64(32)).astype(np.uint32)
    return CuckooTable(lo=jnp.asarray(lo), hi=jnp.asarray(hi))


def identity_bits(l_pre: int, kb_bits: int) -> int:
    return l_pre + kb_bits


def packed_ok(s_bits: int, l_pre: int, kb_bits: int) -> bool:
    return identity_bits(l_pre, kb_bits) - s_bits <= 44


def cuckoo_ok(c_bits: int, l_pre: int, kb_bits: int) -> bool:
    return identity_bits(l_pre, kb_bits) - c_bits <= 49


@functools.partial(jax.jit, static_argnames=("c_bits", "l_pre", "kb_bits"))
def cuckoo_lookup(table: CuckooTable, q_shard, q_keybody, c_bits: int,
                  l_pre: int, kb_bits: int):
    """Batched payload lookup: two probes, no loop (generic u64 path).

    Serves big-k / big-table configs and cold callers (tests, tools).
    The correction hot loop uses cuckoo_lookup32 (all-32-bit chain)."""
    pk = posk64(q_shard, q_keybody, l_pre, kb_bits)
    # i64 slots: c_bits >= 32 (multi-billion-entry tables) must not wrap
    s1 = (pk >> U64(64 - c_bits)).astype(jnp.int64)
    qlow = _id_low(q_shard, q_keybody, l_pre, kb_bits, c_bits)
    alt = cuckoo_alt_u64(qlow, c_bits).astype(jnp.int64)
    s2 = s1 ^ alt

    def fetch(s):
        return table.lo[s].astype(U64) | (table.hi[s].astype(U64) << U64(32))

    e1 = fetch(s1)
    e2 = fetch(s2)

    def match(e, nest):
        return (
            ((e & U64(0x3FFF)) != 0)
            & (((e >> U64(14)) & U64(1)) == U64(nest))
            & ((e >> U64(15)) == qlow)
        )

    v1 = (e1 & U64(0x3FFF)).astype(jnp.int32)
    v2 = (e2 & U64(0x3FFF)).astype(jnp.int32)
    return jnp.where(match(e1, 0), v1, jnp.where(match(e2, 1), v2, -1))


@functools.partial(jax.jit, static_argnames=("k", "c_bits"))
def cuckoo_lookup32(table: CuckooTable, h0, h1, k: int, c_bits: int):
    """Batched payload lookup with an ALL-32-BIT dataflow (the hot path).

    h0/h1: u32 [...] canonical-hash words (k bits each, k <= 31;
    kops.canonical_hash32).  Requires c_bits <= 32.  Equivalent to
    cuckoo_lookup for k <= 32 identities: there the position key is
    z = (h0 << k) | h1 left-justified, so slot = top c_bits of z and
    qlow = low (2k - c_bits) bits of z (htab.c:45-58 split composed
    with posk64/_id_low).  Every op feeding the gather indices is
    unsigned 32-bit arithmetic: half the bytes of the u64 chain."""
    assert k <= 31 and c_bits <= 32 and c_bits <= 2 * k
    U32_ = U32
    nbits = 2 * k - c_bits  # qlow width, <= 49 by cuckoo_ok
    # top c_bits of z = (h0 << k) | h1
    if c_bits <= k:
        s1 = h0 >> U32_(k - c_bits)
    else:
        s1 = (h0 << U32_(c_bits - k)) | (h1 >> U32_(2 * k - c_bits))
    # qlow as two u32 words (z's low 32 bits, then bits 32..)
    z_lo32 = h1 | (h0 << U32_(k)) if 2 * k > 32 else (h1 | (h0 << U32_(k)))
    z_hi = h0 >> U32_(32 - k) if 2 * k > 32 else jnp.zeros_like(h0)
    if nbits >= 32:
        ql_lo = z_lo32
        ql_hi = z_hi & U32_((1 << (nbits - 32)) - 1)
    else:
        ql_lo = z_lo32 & U32_((1 << nbits) - 1)
        ql_hi = jnp.zeros_like(z_lo32)
    alt = ((ql_lo * U32_(_ALT_C1)) ^ (ql_hi * U32_(_ALT_C2)))
    if c_bits < 32:
        alt = alt >> U32_(32 - c_bits)
    s2 = s1 ^ alt
    e1l = table.lo[s1]
    e1h = table.hi[s1]
    e2l = table.lo[s2]
    e2h = table.hi[s2]

    def match(el, eh, nest):
        # entry = qlow << 15 | nest << 14 | payload(14), split lo/hi
        q_lo32 = (el >> U32_(15)) | (eh << U32_(17))
        q_hi17 = eh >> U32_(15)
        return (
            ((el & U32_(0x3FFF)) != 0)
            & (((el >> U32_(14)) & U32_(1)) == U32_(nest))
            & (q_lo32 == ql_lo) & (q_hi17 == ql_hi)
        )

    v1 = (e1l & U32_(0x3FFF)).astype(jnp.int32)
    v2 = (e2l & U32_(0x3FFF)).astype(jnp.int32)
    return jnp.where(match(e1l, e1h, 0), v1,
                     jnp.where(match(e2l, e2h, 1), v2, -1))


def _id_low(shard, keybody, l_pre: int, kb_bits: int, s_bits: int):
    """Low identity_bits - s_bits bits of the (shard || keybody) string."""
    nbits = identity_bits(l_pre, kb_bits) - s_bits
    if nbits <= 0:
        return jnp.zeros_like(keybody)
    if nbits <= kb_bits:
        return keybody & U64((1 << nbits) - 1)
    extra = nbits - kb_bits
    return ((shard.astype(U64) & U64((1 << extra) - 1)) << U64(kb_bits)) | keybody


@functools.partial(
    jax.jit, static_argnames=("s_bits", "l_pre", "kb_bits", "window")
)
def packed_lookup(table: PackedTable, q_shard, q_keybody, s_bits: int,
                  l_pre: int, kb_bits: int, window: int = 4):
    """Batched payload lookup against a PackedTable (htab.c:84-92)."""
    pk = posk64(q_shard, q_keybody, l_pre, kb_bits)
    q_ideal = (pk >> U64(64 - s_bits)).astype(jnp.int32)
    q_low = _id_low(q_shard, q_keybody, l_pre, kb_bits, s_bits)
    S = table.entries.shape[0]
    nbits = max(identity_bits(l_pre, kb_bits) - s_bits, 0)
    low_mask = U64((1 << nbits) - 1) if nbits else U64(0)

    def probe_window(start):
        offs = start[..., None] + jnp.arange(window, dtype=jnp.int32)
        offs = jnp.minimum(offs, S - 1)
        e = table.entries[offs]
        empty = (e & U64(0x3FFF)) == 0
        disp = (e >> U64(58)).astype(jnp.int32)
        ideal_e = offs - disp
        low_e = (e >> U64(14)) & low_mask
        eq = ~empty & (ideal_e == q_ideal[..., None]) & (low_e == q_low[..., None])
        gt = (ideal_e > q_ideal[..., None]) | (
            (ideal_e == q_ideal[..., None]) & (low_e > q_low[..., None])
        )
        gt = (gt | empty) & ~eq
        found = jnp.any(eq, axis=-1)
        val = jnp.max(
            jnp.where(eq, (e & U64(0x3FFF)).astype(jnp.int32), -1), axis=-1
        )
        miss = jnp.any(gt, axis=-1)
        return found | miss, val

    done, val = probe_window(q_ideal)
    state = (done, val, q_ideal + window)

    def body(stt):
        done, val, nxt = stt
        d2, v2 = probe_window(nxt)
        val = jnp.where(~done & d2, v2, val)
        return done | d2, val, nxt + window

    done, val, _ = jax.lax.while_loop(lambda s: ~jnp.all(s[0]), body, state)
    return val


@functools.partial(jax.jit, static_argnames=("bf_shift", "n_hashes"))
def adjudicate_sketch(agg: Aggregate, bf_shift: int, n_hashes: int):
    """Sort-free first-occurrence adjudication (device sketch).

    Dense per-Bloom-bit minimum-arrival table (the device twin of
    spectrum_host.BloomMinSketch, inverted storage: dense = ~min_arr,
    0 = never probed) - one scatter-max + one u32 gather instead of the
    (bit, arrival) sort.  EXACT
    only while every first arrival fits u32 (the caller checks the
    stream's arrival ceiling and falls back to the sort)."""
    C = agg.shard.shape[0]
    valid = agg.shard != INVALID_SHARD
    bits = bloom_probe_bits(agg.ret, bf_shift, n_hashes)  # u64 [C,H]
    bits32 = bits.astype(U32)  # bit ids < 2^bf_shift <= 2^32
    inv = ~agg.first_arr.astype(U32)  # ~arr: min(arr) == ~max(~arr)
    upd = jnp.where(valid, inv, U32(0))
    dense = jnp.zeros((1 << bf_shift,), U32).at[bits32.reshape(-1)].max(
        jnp.broadcast_to(upd[:, None], (C, n_hashes)).reshape(-1)
    )
    got = dense[bits32]
    was_set = got > inv[:, None]  # min_arr < own arr (0 unset is never >)
    return jnp.all(was_set, axis=-1) & valid


@functools.partial(jax.jit, static_argnames=())
def finalize_counts_fp(agg: Aggregate, fp):
    """Payload/keep/histogram computation given the adjudication
    verdict (split out so the big-C device finalize composes from
    small programs; semantics documented at finalize_counts)."""
    fp = fp.astype(U32)
    valid = agg.shard != INVALID_SHARD
    m = agg.n - 1 + fp
    high = agg.n_high - (1 - fp) * agg.first_high
    keep = valid & (m >= 1)
    count = jnp.minimum(m, 255)
    high = jnp.minimum(high, 63)
    payload = jnp.where(keep, count | (high << 8), U32(0))
    shard = jnp.where(keep, agg.shard, INVALID_SHARD)
    hist = jnp.bincount(jnp.where(keep, count, U32(0)), length=256)
    hist = hist.at[0].set(0)
    hist_high = jnp.bincount(jnp.where(keep, high, U32(0)), length=64)
    hist_high = hist_high.at[0].set(jnp.sum(keep & (high == 0)))
    return shard, agg.keybody, payload, keep, hist, hist_high


def finalize_counts(agg: Aggregate, bf_shift: int, n_hashes: int):
    """Compute reference-exact payloads for every distinct k-mer.

    count = min(n-1+fp, 255); high = min(n_high - (1-fp)*first_high, 63)
    (inserted occurrences are 2..n plus the first iff it was a Bloom
    false positive; saturation as in htab.c:77-78).  Entries with
    count==0 are dropped (shard set to INVALID)."""
    fp = adjudicate_first_occurrence(agg, bf_shift, n_hashes).astype(U32)
    valid = agg.shard != INVALID_SHARD
    m = agg.n - 1 + fp
    high = agg.n_high - (1 - fp) * agg.first_high
    keep = valid & (m >= 1)
    count = jnp.minimum(m, 255)
    high = jnp.minimum(high, 63)
    payload = jnp.where(keep, count | (high << 8), U32(0))
    shard = jnp.where(keep, agg.shard, INVALID_SHARD)
    # histogram of counts (hist mode: htab.c:110-127); kept entries always
    # have count >= 1 so dropped entries (bin 0) are simply zeroed out
    hist = jnp.bincount(jnp.where(keep, count, U32(0)), length=256)
    hist = hist.at[0].set(0)
    hist_high = jnp.bincount(jnp.where(keep, high, U32(0)), length=64)
    hist_high = hist_high.at[0].set(jnp.sum(keep & (high == 0)))
    return shard, agg.keybody, payload, keep, hist, hist_high


def table_mode(hist) -> jax.Array:
    """Coverage-peak mode: first argmax of hist[3:256] (htab.c:123-126)."""
    h = hist[3:256]
    # argmax returns the first maximum; mode -1 when all zero
    m = jnp.argmax(h)
    return jnp.where(jnp.max(h) > 0, m + 3, -1)


def posk64(shard, keybody, l_pre: int, kb_bits: int):
    """Uniform 64-bit position key: shard then keybody, left-justified."""
    hi = shard.astype(U64) << U64(64 - l_pre)
    rem = 64 - l_pre - kb_bits
    if rem >= 0:
        lo = keybody << U64(rem)
    else:
        lo = keybody >> U64(-rem)
    return hi | lo


@functools.partial(jax.jit, static_argnames=("s_bits", "margin", "l_pre", "kb_bits"))
def build_table(shard, keybody, payload, keep, s_bits: int, margin: int,
                l_pre: int, kb_bits: int):
    """Place sorted entries at slot = max(ideal, prev+1) via cumulative max.

    Inputs are the finalize_counts outputs (already sorted by
    (shard, keybody) with dropped entries marked INVALID)."""
    C = shard.shape[0]
    # compact kept entries to the front, preserving sorted order
    order = stable_order((~keep).astype(U32))
    shard = shard[order]
    keybody = keybody[order]
    payload = payload[order]
    n = jnp.sum(keep)
    idx = jnp.arange(C, dtype=jnp.int32)
    live = idx < n
    pk = posk64(shard, keybody, l_pre, kb_bits)
    assert s_bits <= 30, "table slots must fit i32 for the placement scan"
    ideal = (pk >> U64(64 - s_bits)).astype(jnp.int32)
    ideal = jnp.where(live, ideal, jnp.int32(1 << 30))
    slot = idx + jax.lax.associative_scan(jnp.maximum, ideal - idx)
    slot = jnp.where(live, slot, 0)
    S = (1 << s_bits) + margin
    max_slot = jnp.max(jnp.where(live, slot, 0))
    tab_kbp = jnp.zeros((S,), U64)
    tab_shard = jnp.full((S,), INVALID_SHARD, U32)
    # dead (padding) entries all write the reserved sentinel slot S-1,
    # which is reset to empty afterwards; the driver asserts
    # max_slot <= S-2 so no live entry ever occupies it
    write_slot = jnp.where(live, slot, S - 1)
    tab_kbp = tab_kbp.at[write_slot].set((keybody << U64(14)) | payload.astype(U64))
    tab_shard = tab_shard.at[write_slot].set(shard)
    tab_shard = tab_shard.at[S - 1].set(INVALID_SHARD)
    tab_kbp = tab_kbp.at[S - 1].set(U64(0))
    return Table(kb_payload=tab_kbp, shard=tab_shard), n, max_slot


@functools.partial(jax.jit, static_argnames=("s_bits", "l_pre", "kb_bits", "window"))
def table_lookup(table: Table, q_shard, q_keybody, s_bits: int, l_pre: int,
                 kb_bits: int, window: int = 8):
    """Batched lookup: payload (int32) or -1 per query (htab.c:84-92).

    Entries are stored in (shard, keybody) order with linear
    displacement, so scanning forward from the ideal slot terminates at
    a match, an empty slot, or an entry comparing greater."""
    pk = posk64(q_shard, q_keybody, l_pre, kb_bits)
    ideal = (pk >> U64(64 - s_bits)).astype(jnp.int64)
    S = table.kb_payload.shape[0]

    def probe_window(start):
        offs = start[..., None] + jnp.arange(window, dtype=jnp.int32)
        offs = jnp.minimum(offs, S - 1)
        e_kbp = table.kb_payload[offs]
        e_shard = table.shard[offs]
        e_kb = e_kbp >> U64(14)
        empty = e_shard == INVALID_SHARD
        eq = (e_shard == q_shard[..., None]) & (e_kb == q_keybody[..., None]) & ~empty
        gt = (e_shard > q_shard[..., None]) | (
            (e_shard == q_shard[..., None]) & (e_kb > q_keybody[..., None])
        )
        gt = (gt | empty) & ~eq
        found = jnp.any(eq, axis=-1)
        val = jnp.max(jnp.where(eq, (e_kbp & U64(0x3FFF)).astype(jnp.int32), -1), axis=-1)
        miss = jnp.any(gt, axis=-1)  # sorted order: first greater/empty => absent
        done = found | miss
        return done, val

    done, val = probe_window(ideal)
    state = (done, val, ideal + window)

    def cond(st):
        return ~jnp.all(st[0])

    def body(st):
        done, val, nxt = st
        d2, v2 = probe_window(nxt)
        val = jnp.where(~done & d2, v2, val)
        done = done | d2
        return done, val, nxt + window

    done, val, _ = jax.lax.while_loop(cond, body, state)
    return val
