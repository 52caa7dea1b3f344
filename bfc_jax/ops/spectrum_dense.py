"""Device-resident streaming k-mer aggregation.

Each read batch is sorted and combined on device into a run, runs are
merged on device (concatenate + sort + combine), and the aggregate
leaves the device once, at finalization (or span by span when it
spills; see models.counter.AggBuilder).  Matches the reference counting
pass semantics (/root/reference/count.c:127-157) under sequential
stream order.

Record layout: a run is a tuple of u32 planes, sorted by its leading
key planes, padded with all-ones rows:

    [shard] [kb_hi]? [kb_lo] [arr_hi] [arr_lo] [n] [nhfh] [ret_hi ret_lo]?

  * kb_hi present iff keybody_bits > 32.
  * (arr_hi, arr_lo) = u64 arrival index of the k-mer's first
    occurrence; part of the sort key so the earliest occurrence comes
    first in every equal-key group whatever the sort's stability.
  * nhfh = n_high | first_high << 31 (n_high < 2^31 documented limit).
  * ret planes present only when the Bloom-addressing hash is NOT
    derivable from the identity (k > 32 with 2k - l_pre >= 50, where
    the reference's own table key is lossy - htab.c:45-58).

Occurrence totals add modulo 2^32 (the documented exactness limit is
2^31 occurrences per k-mer per device; payloads saturate at 255 far
below that).
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import kmer as kops

U32 = jnp.uint32
U64 = jnp.uint64
INVALID_SHARD = 0xFFFFFFFF


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def ret_derivable(k: int, l_pre: int) -> bool:
    """Can ret be recomputed from (shard, keybody)?  (kmer.h:79-88)"""
    return k <= 32 or (k - l_pre) + k < 50


def n_kb_planes(kb_bits: int) -> int:
    return 2 if kb_bits > 32 else 1


def run_layout(k: int, l_pre: int) -> Tuple[int, int, bool]:
    """(n_id_planes, n_planes_total, carry_ret) for this config."""
    kb_bits = kops.keybody_bits(k, l_pre)
    n_id = 1 + n_kb_planes(kb_bits)
    carry = not ret_derivable(k, l_pre)
    return n_id, n_id + 4 + (2 if carry else 0), carry


def _split_u64(x):
    return (x >> U64(32)).astype(U32), (x & U64(0xFFFFFFFF)).astype(U32)


def _join_u64(hi, lo):
    return (hi.astype(U64) << U64(32)) | lo.astype(U64)


def _shift_up(x, sh: int, fill):
    return jnp.concatenate([x[sh:], jnp.full((sh,), fill, x.dtype)])


def _shift_down(x, sh: int, fill):
    return jnp.concatenate([jnp.full((sh,), fill, x.dtype), x[:-sh]])


def _combine_sorted(planes, n_id: int):
    """Merge equal-key adjacent groups of a sorted run into their head
    row and compact the heads left, in order.  planes follow the run
    layout (n / nhfh populated); rows past the count get the padding
    fill.  Returns (planes, count).

    Group totals are differences of exclusive u32 cumulative sums (the
    same modulo-2^32 adds as the occurrence counts); the heads' row ids
    are scattered once to their compacted slots and every plane is
    gathered through them."""
    shard = planes[0]
    N = shard.shape[0]
    valid = shard != U32(INVALID_SHARD)
    same_prev = jnp.ones_like(valid)
    for p in planes[:n_id]:
        same_prev = same_prev & (p == _shift_down(p, 1, U32(INVALID_SHARD)))
    same_prev = same_prev.at[0].set(False)
    head = valid & ~same_prev
    n = jnp.where(valid, planes[n_id + 2], U32(0))
    nh = jnp.where(valid, planes[n_id + 3] & U32(0x7FFFFFFF), U32(0))
    cn = jnp.cumsum(n, dtype=U32)
    cnh = jnp.cumsum(nh, dtype=U32)
    hc = jnp.cumsum(head.astype(jnp.int32))
    count = hc[-1]
    slot = jnp.where(head, hc - 1, N)
    rows = jnp.full((N,), N - 1, jnp.int32).at[slot].set(
        jnp.arange(N, dtype=jnp.int32), mode="drop")
    j = jnp.arange(N, dtype=jnp.int32)
    live = j < count
    fill = [INVALID_SHARD] * n_id + [0] * (len(planes) - n_id)
    out = [jnp.where(live, p[rows], U32(f)) for p, f in zip(planes, fill)]
    last = j + 1 == count

    def group_total(csum, vals):
        start = (csum - vals)[rows]  # exclusive sum at each head
        nxt = jnp.where(last, csum[-1], _shift_up(start, 1, U32(0)))
        return jnp.where(live, nxt - start, U32(0))

    out[n_id + 2] = group_total(cn, n)
    out[n_id + 3] = jnp.where(
        live, (group_total(cnh, nh) & U32(0x7FFFFFFF))
        | (out[n_id + 3] & U32(0x80000000)), U32(0))
    return out, count


@functools.partial(jax.jit, static_argnames=("k", "l_pre"))
def chunk_run(bases, qual_ok, lengths, arrival_base, k: int, l_pre: int):
    """One read batch -> a sorted, combined, compacted run (device).

    Returns (planes, count); planes have capacity next_pow2(B*L).
    arrival_base: u64 scalar, the flat arrival index of slot (0, 0)."""
    kb_bits = kops.keybody_bits(k, l_pre)
    n_id, _, carry = run_layout(k, l_pre)
    s = kops.kmer_stream(bases, qual_ok, lengths, k, l_pre)
    B, L = bases.shape
    N = B * L
    Np = next_pow2(N)
    valid = s["valid"].reshape(-1)
    shard = jnp.where(valid, s["shard"].reshape(-1), U32(INVALID_SHARD))
    kb = s["keybody"].reshape(-1)
    is_high = s["is_high"].reshape(-1).astype(U32)
    assert N < (1 << 30), "chunk slots must fit 30 bits for packed arrival"
    arrp = (jnp.arange(N, dtype=U32) << U32(1)) | is_high

    key_planes = [shard]
    if n_kb_planes(kb_bits) == 2:
        kb_hi, kb_lo = _split_u64(kb)
        key_planes += [jnp.where(valid, kb_hi, U32(INVALID_SHARD)),
                       jnp.where(valid, kb_lo, U32(INVALID_SHARD))]
    else:
        key_planes.append(jnp.where(valid, kb.astype(U32), U32(INVALID_SHARD)))
    key_planes.append(arrp)
    payload_planes = []
    if carry:
        r_hi, r_lo = _split_u64(s["ret"].reshape(-1))
        payload_planes += [r_hi, r_lo]

    def pad(p, fill):
        return jnp.concatenate([p, jnp.full((Np - N,), fill, p.dtype)]) if Np > N else p

    key_planes = [pad(p, 0xFFFFFFFF) for p in key_planes]
    payload_planes = [pad(p, 0) for p in payload_planes]

    srt = list(jax.lax.sort(tuple(key_planes) + tuple(payload_planes),
                            num_keys=len(key_planes)))
    arrp_s = srt[n_id]
    is_high_s = arrp_s & U32(1)
    arr64 = arrival_base + (arrp_s >> U32(1)).astype(U64)
    a_hi, a_lo = _split_u64(arr64)
    shard_s = srt[0]
    valid_s = shard_s != U32(INVALID_SHARD)
    one = valid_s.astype(U32)
    planes = (srt[:n_id]
              + [a_hi, a_lo, one, is_high_s | (is_high_s << U32(31))]
              + srt[n_id + 1:])
    return _combine_sorted(planes, n_id)


@functools.partial(jax.jit, static_argnames=("n_id",))
def merge_runs(planes_a: Sequence[jax.Array], planes_b: Sequence[jax.Array],
               n_id: int):
    """Merge two sorted runs (any capacities) into one combined run:
    concat + multi-operand u32 lax.sort + combine.  Returns (planes,
    count) at capacity capA+capB.

    Keys include the arrival planes, so ordering is deterministic
    regardless of sort stability and the first element of each group
    stays the earliest occurrence (the _segment_combine precondition)."""
    nk = n_id + 2
    cat = [jnp.concatenate([a, b]) for a, b in zip(planes_a, planes_b)]
    srt = jax.lax.sort(tuple(cat), num_keys=nk)
    return _combine_sorted(list(srt), n_id)


def pad_run(planes, cap: int):
    """Pad a run's planes with all-ones rows up to cap (host-side driver
    helper; eager device concat)."""
    n = planes[0].shape[0]
    if n == cap:
        return list(planes)
    return [
        jnp.concatenate([p, jnp.full((cap - n,), 0xFFFFFFFF, p.dtype)])
        for p in planes
    ]


@functools.partial(jax.jit, static_argnames=("n_id",))
def pack_pull(planes: Sequence[jax.Array], n_id: int):
    """Pack the payload planes for the device->host pull.

    (arr_hi, n, nhfh) fold into ONE u32 plane next to arr_lo:
    n saturates at 511 and n_high at 127 - explicitly ABOVE every
    payload-visible threshold (count caps at 255 via m = n-1+fp, high
    at 63; saturating per-span counters compose: min(a,S)+min(b,S)
    crosses S iff a+b does), so the finalized table is bit-identical
    while the pull drops one-to-two u32 planes (~20-30% of the final
    transfer, the counting tail's dominant cost).  arr_hi rides in the
    top 15 bits (valid while the stream holds < 2^47 bases; the caller
    checks arrival_base and falls back to the unpacked pull)."""
    a_hi, a_lo = planes[n_id], planes[n_id + 1]
    n, nhfh = planes[n_id + 2], planes[n_id + 3]
    nh = nhfh & U32(0x7FFFFFFF)
    fh = nhfh >> U32(31)
    nfh = (
        jnp.minimum(n, U32(511))
        | (jnp.minimum(nh, U32(127)) << U32(9))
        | (fh << U32(16))
        | (a_hi << U32(17))
    )
    return list(planes[:n_id]) + [a_lo, nfh] + list(planes[n_id + 4:])


def packed_run_to_host_agg(planes_np: List[np.ndarray], count: int, k: int,
                           l_pre: int):
    """Host twin of pack_pull: pulled packed planes -> HostAgg.

    HostAgg.n / n_high carry the saturated (511 / 127) per-span values;
    merge_host_aggs' saturating adds preserve the payload thresholds
    exactly (see pack_pull)."""
    from . import spectrum_host as sph

    kb_bits = kops.keybody_bits(k, l_pre)
    n_id, _, carry = run_layout(k, l_pre)
    p = [np.asarray(x)[:count] for x in planes_np]
    shard = p[0].astype(np.uint32)
    if n_kb_planes(kb_bits) == 2:
        keybody = (p[1].astype(np.uint64) << np.uint64(32)) | p[2]
    else:
        keybody = p[1].astype(np.uint64)
    a_lo, nfh = p[n_id], p[n_id + 1]
    first_arr = ((nfh >> np.uint32(17)).astype(np.uint64) << np.uint64(32)) | a_lo
    if carry:
        ret = (p[n_id + 2].astype(np.uint64) << np.uint64(32)) | p[n_id + 3]
    else:
        # derivable from the identity: leave None so the host merge
        # chain never carries the 8-byte column; finalize_host derives
        # it once over the final aggregate (spectrum_host.finalize_host)
        ret = None
    return sph.HostAgg(
        shard=shard, keybody=keybody, ret=ret,
        n=(nfh & np.uint32(511)).astype(np.uint32),
        n_high=((nfh >> np.uint32(9)) & np.uint32(127)).astype(np.uint32),
        first_arr=first_arr,
        first_high=((nfh >> np.uint32(16)) & np.uint32(1)).astype(np.uint32),
    )


def derive_ret_device(shard, keybody, k: int, l_pre: int):
    """Device twin of derive_ret_np (jnp; see below for the math)."""
    mask = U64((1 << k) - 1)
    shard = shard.astype(U64)
    if k <= 32:
        t = 2 * k - l_pre
        z = (shard << U64(t)) | keybody
        h0 = z >> U64(k)
        h1 = z & mask
    else:
        t = k - l_pre
        assert ret_derivable(k, l_pre)
        h0 = (shard << U64(t)) | (keybody >> U64(k))
        h1 = keybody & U64((1 << k) - 1)
    w0 = (h0 - h1) & mask
    return ((w0 ^ h1) << U64(k)) | h0


@functools.partial(jax.jit, static_argnames=("k", "l_pre"))
def run_to_aggregate(planes, k: int, l_pre: int):
    """Device run planes -> spec.Aggregate, entirely on device (for the
    device finalize).  Padding rows keep shard == INVALID_SHARD, the
    Aggregate validity convention."""
    from . import spectrum as spec

    kb_bits = kops.keybody_bits(k, l_pre)
    n_id, _, carry = run_layout(k, l_pre)
    shard = planes[0]
    if n_kb_planes(kb_bits) == 2:
        keybody = _join_u64(planes[1], planes[2])
    else:
        keybody = planes[1].astype(U64)
    a_hi, a_lo = planes[n_id], planes[n_id + 1]
    n, nhfh = planes[n_id + 2], planes[n_id + 3]
    first_arr = _join_u64(a_hi, a_lo)
    if carry:
        ret = _join_u64(planes[n_id + 4], planes[n_id + 5])
    else:
        ret = derive_ret_device(shard, keybody, k, l_pre)
    return spec.Aggregate(
        shard=shard, keybody=keybody, ret=ret,
        n=n, n_high=nhfh & U32(0x7FFFFFFF), first_arr=first_arr,
        first_high=(nhfh >> U32(31)),
    )


# ---------------------------------------------------------------------------
# Host conversion
# ---------------------------------------------------------------------------

def derive_ret_np(shard: np.ndarray, keybody: np.ndarray, k: int,
                  l_pre: int) -> np.ndarray:
    """Recompute the Bloom-addressing hash from the table identity.

    Inverts shard_and_keybody (kmer.py:143-154) back to (h0, h1), then
    re-applies the ret formula of canonical_hash (kmer.h:79-88)."""
    mask = np.uint64((1 << k) - 1)
    shard = shard.astype(np.uint64)
    if k <= 32:
        t = 2 * k - l_pre
        z = (shard << np.uint64(t)) | keybody
        h0 = z >> np.uint64(k)
        h1 = z & mask
    else:
        t = k - l_pre
        shift = k  # derivable only when t + k < 50, where shift == k
        assert ret_derivable(k, l_pre)
        h0_low = keybody >> np.uint64(shift)
        h0 = (shard << np.uint64(t)) | h0_low
        h1 = keybody & np.uint64((1 << shift) - 1)
    w0 = (h0 - h1) & mask
    return ((w0 ^ h1) << np.uint64(k)) | h0


def run_to_host_agg(planes_np: List[np.ndarray], count: int, k: int,
                    l_pre: int):
    """Convert a pulled run (numpy planes) into a spectrum_host.HostAgg."""
    from . import spectrum_host as sph

    kb_bits = kops.keybody_bits(k, l_pre)
    n_id, _, carry = run_layout(k, l_pre)
    p = [np.asarray(x)[:count] for x in planes_np]
    shard = p[0].astype(np.uint32)
    if n_kb_planes(kb_bits) == 2:
        keybody = (p[1].astype(np.uint64) << np.uint64(32)) | p[2]
    else:
        keybody = p[1].astype(np.uint64)
    a_hi, a_lo, n, nhfh = p[n_id], p[n_id + 1], p[n_id + 2], p[n_id + 3]
    first_arr = (a_hi.astype(np.uint64) << np.uint64(32)) | a_lo
    if carry:
        ret = (p[n_id + 4].astype(np.uint64) << np.uint64(32)) | p[n_id + 5]
    else:
        ret = derive_ret_np(shard, keybody, k, l_pre)
    return sph.HostAgg(
        shard=shard, keybody=keybody, ret=ret,
        n=n.astype(np.uint32),
        n_high=(nhfh & np.uint32(0x7FFFFFFF)).astype(np.uint32),
        first_arr=first_arr,
        first_high=(nhfh >> np.uint32(31)).astype(np.uint32),
    )
