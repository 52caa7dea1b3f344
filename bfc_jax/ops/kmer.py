"""Vectorized k-mer encoding and canonical hashing over read batches.

Vectorized reformulation of the reference's per-base rolling loop
(/root/reference/kmer.h:10-17, count.c:72-89): instead of a sequential
scan, the k-base window bit-planes at *every* position are materialized
with a log2(k)-step shifted-OR doubling, so the whole batch is pure
element-wise u64 vector work with no data-dependent control flow.

Plane convention (kmer.h:6-17): at position i, plane0/plane1 hold the
low/high bits of the last k forward-strand bases (newest base at bit 0),
plane2/plane3 the complement bits in reversed order (newest at bit k-1)
- i.e. plane2/3 equal plane0/1 of the reverse-complement k-mer.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

U64 = jnp.uint64


def _u64(x):
    return jnp.asarray(x, dtype=U64)


def window_pack_backward(bits, k: int, dtype=U64):
    """Pack bits[i-j] into bit j of out[i] for j in [0, k).

    bits: [..., L] containing 0/1.  Positions i < k-1 contain partial
    windows (upper bits zero-filled).  dtype=uint32 requires k <= 31
    (the all-32-bit probe path)."""
    assert dtype == U64 or k <= 31
    acc = jnp.asarray(bits, dtype=dtype)
    width = 1
    while width < k:
        shifted = jnp.roll(acc, width, axis=-1)
        # zero the wrapped-around columns
        idx = jnp.arange(acc.shape[-1], dtype=jnp.int32)
        shifted = jnp.where(idx >= width, shifted, dtype(0))
        acc = acc | (shifted << dtype(width))
        width <<= 1
    return acc & dtype((1 << k) - 1)


def window_pack_forward(bits, k: int, dtype=U64):
    """Pack bits[i+j] into bit j of out[i] for j in [0, k)."""
    assert dtype == U64 or k <= 31
    acc = jnp.asarray(bits, dtype=dtype)
    L = acc.shape[-1]
    width = 1
    while width < k:
        shifted = jnp.roll(acc, -width, axis=-1)
        idx = jnp.arange(L, dtype=jnp.int32)
        shifted = jnp.where(idx < L - width, shifted, dtype(0))
        acc = acc | (shifted << dtype(width))
        width <<= 1
    return acc & dtype((1 << k) - 1)


def kmer_planes(bases, k: int, dtype=U64):
    """All four bit-planes of the k-mer ending at each position.

    bases: uint8 [..., L] with values 0..4 (4 = N/invalid).  Returns
    (x0, x1, x2, x3) [..., L] of `dtype`; only positions where the
    trailing k bases are all valid hold meaningful planes (see
    valid_kmer_mask).  dtype=uint32 (k <= 31) keeps the downstream
    hash -> table-slot dataflow free of 64-bit ops.
    """
    b = jnp.asarray(bases)
    lo = (b & 1).astype(dtype)
    hi = ((b >> 1) & 1).astype(dtype)
    x0 = window_pack_backward(lo, k, dtype)
    x1 = window_pack_backward(hi, k, dtype)
    # complement bits, forward-packed then aligned to the window start:
    # x2[i] = sum_m comp_lo(b[i-k+1+m]) << m = fwd[i-k+1]
    clo = window_pack_forward((lo ^ 1) & dtype(1), k, dtype)
    chi = window_pack_forward((hi ^ 1) & dtype(1), k, dtype)
    L = b.shape[-1]
    idx = jnp.arange(L, dtype=jnp.int32)
    x2 = jnp.roll(clo, k - 1, axis=-1)
    x3 = jnp.roll(chi, k - 1, axis=-1)
    x2 = jnp.where(idx >= k - 1, x2, dtype(0))
    x3 = jnp.where(idx >= k - 1, x3, dtype(0))
    return x0, x1, x2, x3


def valid_kmer_mask(bases, lengths, k: int):
    """True where a full k-mer of ACGT bases ends (count.c:81-88 rolling run).

    bases: uint8 [B, L]; lengths: int32 [B]."""
    B, L = bases.shape
    idx = jnp.arange(L, dtype=jnp.int32)
    is_n = (bases > 3) | (idx[None, :] >= lengths[:, None])
    # last invalid position at or before i (exclusive run-length reset)
    pos_if_n = jnp.where(is_n, idx[None, :], -1)
    last_n = jax.lax.associative_scan(jnp.maximum, pos_if_n, axis=-1)
    run = idx[None, :] - last_n
    return (run >= k) & (idx[None, :] < lengths[:, None])


def high_quality_mask(bases, qual_ok, lengths, k: int):
    """True where the k-mer ending here has all k bases quality-OK.

    Mirrors the qmer mask of count.c:85-86 (N bases reset the window)."""
    B, L = bases.shape
    idx = jnp.arange(L, dtype=jnp.int32)
    bad = (bases > 3) | ~qual_ok | (idx[None, :] >= lengths[:, None])
    pos_if_bad = jnp.where(bad, idx[None, :], -1)
    last_bad = jax.lax.associative_scan(jnp.maximum, pos_if_bad, axis=-1)
    return idx[None, :] - last_bad >= k


def wang_hash(key, mask):
    """Vectorized invertible Thomas Wang mix under mask (kmer.h:30-40).

    Dtype-generic: in uint32 (k <= 31) the intermediate wraps mod 2^32
    only discard bits the & mask discards anyway (mask < 2^31), so the
    result is bit-identical to the u64 computation."""
    D = key.dtype.type
    key = (~key + (key << D(21))) & mask
    key = key ^ (key >> D(24))
    key = (key + (key << D(3)) + (key << D(8))) & mask
    key = key ^ (key >> D(14))
    key = (key + (key << D(2)) + (key << D(4))) & mask
    key = key ^ (key >> D(28))
    key = (key + (key << D(31))) & mask
    return key


def canonical_hash(x0, x1, x2, x3, k: int):
    """Strand-canonical hash of the 4-plane k-mer (kmer.h:79-88).

    Returns (ret_lo64, h0, h1): ret_lo64 is the low 64 bits of the
    2k-bit Bloom-addressing hash (only the low bf_shift+9 <= 46 bits are
    ever consumed); h0 = (w0+h1) & mask and h1 key the count table.
    """
    mask = U64((1 << k) - 1)
    t = U64(k >> 1)
    u = ((x1 >> t) & U64(1)) > ((x3 >> t) & U64(1))
    a0 = jnp.where(u, x2, x0)
    a1 = jnp.where(u, x3, x1)
    w0 = wang_hash((a0 + a1) & mask, mask)
    h1 = wang_hash(w0 ^ a1, mask)
    h0 = (w0 + h1) & mask
    ret = ((w0 ^ h1) << U64(k)) | h0
    return ret, h0, h1


def canonical_hash32(x0, x1, x2, x3, k: int):
    """canonical_hash in pure uint32 (k <= 31): returns (h0, h1) only.

    Bit-identical to the u64 canonical_hash's h0/h1 (wang_hash is
    mask-equivalent across widths); the 2k-bit Bloom `ret` cannot fit
    u32 and counting keeps the u64 path.  The all-32-bit dataflow keeps
    the downstream table-probe index chain in 32-bit arithmetic."""
    assert k <= 31
    U = jnp.uint32
    mask = U((1 << k) - 1)
    t = U(k >> 1)
    u = ((x1 >> t) & U(1)) > ((x3 >> t) & U(1))
    a0 = jnp.where(u, x2, x0)
    a1 = jnp.where(u, x3, x1)
    w0 = wang_hash((a0 + a1) & mask, mask)
    h1 = wang_hash(w0 ^ a1, mask)
    h0 = (w0 + h1) & mask
    return h0, h1


def shard_and_keybody(h0, h1, k: int, l_pre: int):
    """Split the hash pair into (shard, in-shard identity) - htab.c:45-58.

    l_pre must already be clamped (Opts.effective_l_pre)."""
    if k <= 32:
        t = 2 * k - l_pre
        z = (h0 << U64(k)) | h1
        return (z >> U64(t)).astype(jnp.uint32), z & U64((1 << t) - 1)
    t = k - l_pre
    shift = k if t + k < 50 else 50 - t
    ident = ((h0 & U64((1 << t) - 1)) << U64(shift)) ^ h1
    return (h0 >> U64(t)).astype(jnp.uint32), ident


def keybody_bits(k: int, l_pre: int) -> int:
    """Bit-width of the in-shard identity."""
    if k <= 32:
        return 2 * k - l_pre
    t = k - l_pre
    shift = k if t + k < 50 else 50 - t
    return t + shift


@functools.partial(jax.jit, static_argnames=("k", "l_pre"))
def kmer_stream(bases, qual_ok, lengths, k: int, l_pre: int):
    """Full per-position k-mer stream for a read batch.

    Returns dict of [B, L] arrays: valid, is_high, ret, h0, h1, shard,
    keybody.  Invalid positions hold arbitrary plane data; consumers
    must mask with `valid`.
    """
    x0, x1, x2, x3 = kmer_planes(bases, k)
    valid = valid_kmer_mask(bases, lengths, k)
    is_high = high_quality_mask(bases, qual_ok, lengths, k) & valid
    ret, h0, h1 = canonical_hash(x0, x1, x2, x3, k)
    shard, keybody = shard_and_keybody(h0, h1, k, l_pre)
    return dict(
        valid=valid, is_high=is_high, ret=ret, h0=h0, h1=h1,
        shard=shard, keybody=keybody,
    )


def bitrev64(x):
    """Bit-reverse each uint64 lane."""
    x = ((x & U64(0x5555555555555555)) << U64(1)) | ((x >> U64(1)) & U64(0x5555555555555555))
    x = ((x & U64(0x3333333333333333)) << U64(2)) | ((x >> U64(2)) & U64(0x3333333333333333))
    x = ((x & U64(0x0F0F0F0F0F0F0F0F)) << U64(4)) | ((x >> U64(4)) & U64(0x0F0F0F0F0F0F0F0F))
    x = ((x & U64(0x00FF00FF00FF00FF)) << U64(8)) | ((x >> U64(8)) & U64(0x00FF00FF00FF00FF))
    x = ((x & U64(0x0000FFFF0000FFFF)) << U64(16)) | ((x >> U64(16)) & U64(0x0000FFFF0000FFFF))
    return (x << U64(32)) | (x >> U64(32))


def bitrev32(x):
    """Bit-reverse each uint32 lane."""
    U = jnp.uint32
    x = ((x & U(0x55555555)) << U(1)) | ((x >> U(1)) & U(0x55555555))
    x = ((x & U(0x33333333)) << U(2)) | ((x >> U(2)) & U(0x33333333))
    x = ((x & U(0x0F0F0F0F)) << U(4)) | ((x >> U(4)) & U(0x0F0F0F0F))
    x = ((x & U(0x00FF00FF)) << U(8)) | ((x >> U(8)) & U(0x00FF00FF))
    return (x << U(16)) | (x >> U(16))


def reverse_k(x, k: int):
    """Reverse the low k bits of each lane (high bits must be zero).

    Dtype-follows-input: uint32 lanes (k <= 31) stay uint32."""
    if x.dtype == jnp.uint32:
        return bitrev32(x) >> jnp.uint32(32 - k)
    return bitrev64(x) >> U64(64 - k)


def append_base(x0, x1, x2, x3, c, k: int):
    """Vectorized single-base roll of 4-plane k-mer states (kmer.h:10-17).

    x*: u64 or u32 (k <= 31) arrays; c: integer array of base codes
    0..3.  Output dtype follows x0."""
    D = x0.dtype.type
    mask = D((1 << k) - 1)
    c = jnp.asarray(c).astype(x0.dtype)
    lo = c & D(1)
    hi = (c >> D(1)) & D(1)
    n0 = ((x0 << D(1)) | lo) & mask
    n1 = ((x1 << D(1)) | hi) & mask
    n2 = (x2 >> D(1)) | ((lo ^ D(1)) << D(k - 1))
    n3 = (x3 >> D(1)) | ((hi ^ D(1)) << D(k - 1))
    return n0, n1, n2, n3


def change_base(x0, x1, x2, x3, d, c, k: int):
    """Vectorized substitution d positions from the 3' end (kmer.h:19-27)."""
    D = x0.dtype.type
    d = jnp.asarray(d).astype(x0.dtype)
    c = jnp.asarray(c).astype(x0.dtype)
    lo = c & D(1)
    hi = (c >> D(1)) & D(1)
    t = ~(D(1) << d)
    n0 = (lo << d) | (x0 & t)
    n1 = (hi << d) | (x1 & t)
    e = D(k - 1) - d
    t2 = ~(D(1) << e)
    n2 = ((lo ^ D(1)) << e) | (x2 & t2)
    n3 = ((hi ^ D(1)) << e) | (x3 & t2)
    return n0, n1, n2, n3


# ---------------------------------------------------------------------------
# Host-side encoding
# ---------------------------------------------------------------------------

_BASE_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _BASE_LUT[_c] = _i
for _i, _c in enumerate(b"acgt"):
    _BASE_LUT[_c] = _i


def encode_batch(seqs, quals, q_thres: int, pad_to=None):
    """Encode python reads into padded (bases, qual_ok, lengths) arrays.

    Whole-batch vectorized: one flat decode + a single scatter, no
    per-read numpy calls."""
    B = len(seqs)
    lens = np.fromiter((len(s) for s in seqs), np.int32, count=B) if B else np.zeros(0, np.int32)
    L = int(lens.max()) if B else 0
    if pad_to is not None:
        L = max(L, pad_to)
    bases = np.full((B, L), 4, dtype=np.uint8)
    qok = np.zeros((B, L), dtype=bool)
    if B == 0:
        return bases, qok, lens
    total = int(lens.sum())
    rows = np.repeat(np.arange(B), lens)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    cols = np.arange(total) - np.repeat(offs, lens)
    flat_seq = np.frombuffer("".join(seqs).encode("ascii"), np.uint8)
    bases[rows, cols] = _BASE_LUT[flat_seq]
    if quals is None:
        qok[rows, cols] = True
    else:
        # per-read None entries are allowed (FASTA records): treat as all-OK
        flat_q = np.frombuffer(
            "".join(q if q is not None else "\x7f" * l
                    for q, l in zip(quals, lens)).encode("ascii"),
            np.uint8,
        )
        qok[rows, cols] = flat_q.astype(np.int32) - 33 >= q_thres
    return bases, qok, lens
