"""Exact scalar model of the BFC algorithm (pure Python).

This module is the *semantic specification* for the JAX engine: a
bit-exact, sequential (single-"thread") re-implementation of the
reference algorithm, used as

  1. the oracle for unit tests of every vectorized kernel,
  2. the host fallback for pathological reads that overflow the fixed
     capacities of the lockstep device search.

Every function cites the reference code (file:line under
/root/reference/) whose observable behavior it reproduces.  The code is
written from the behavioral spec in SURVEY.md - it is not a copy: the
reference is C with macro-generated containers; this is plain Python
operating on integers and lists.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

from ..opts import (
    BFC_BLK_MASK,
    BFC_BLK_SHIFT,
    BFC_CH_KEYBITS,
    BFC_EC_HIST,
    BFC_EC_HIST_HIGH,
    BFC_MAX_PATHS,
    Opts,
)

U64 = (1 << 64) - 1

# mirrors the reference's global bfc_verbose (bfc.c:13); >= 4 prints the
# full per-read search trace in the reference's stderr format
# (correct.c:284-287,302-306,321-322,380-384) - available on the
# --scalar CLI path for read-level debugging parity
verbose = 3


def _tr(msg: str) -> None:
    import sys

    sys.stderr.write(msg + "\n")

# ---------------------------------------------------------------------------
# Base codec (reference bseq.c:9-26; values are nt6-1: A=0 C=1 G=2 T=3, else 4)
# ---------------------------------------------------------------------------

BASE_CODE = [4] * 256
for _i, _ch in enumerate("ACGT"):
    BASE_CODE[ord(_ch)] = _i
    BASE_CODE[ord(_ch.lower())] = _i
BASES = "ACGTN"
BASES_LOWER = "acgtn"


# ---------------------------------------------------------------------------
# k-mer codec: 4-plane bit-sliced encoding (reference kmer.h:6-27)
# ---------------------------------------------------------------------------

def kmer_null() -> List[int]:
    return [0, 0, 0, 0]


def kmer_append(k: int, x: List[int], c: int) -> None:
    """Roll base c (0..3) into the 4-plane k-mer state (kmer.h:10-17).

    Planes 0/1 hold the low/high bit of each forward base (newest at bit
    0... no: newest base enters at bit 0 end by left-shift, so bit 0 is
    the newest base); planes 2/3 hold the complement bits of the
    reverse-complement strand, shifted the other way (newest at bit k-1).
    """
    mask = (1 << k) - 1
    x[0] = ((x[0] << 1) | (c & 1)) & mask
    x[1] = ((x[1] << 1) | (c >> 1)) & mask
    x[2] = (x[2] >> 1) | ((1 ^ (c & 1)) << (k - 1))
    x[3] = (x[3] >> 1) | ((1 ^ (c >> 1)) << (k - 1))


def kmer_change(k: int, x: List[int], d: int, c: int) -> None:
    """Substitute the base d positions from the 3'-end (kmer.h:19-27)."""
    t = ~(1 << d) & U64
    x[0] = ((c & 1) << d) | (x[0] & t)
    x[1] = ((c >> 1) << d) | (x[1] & t)
    t = ~(1 << (k - 1 - d)) & U64
    x[2] = ((1 ^ (c & 1)) << (k - 1 - d)) | (x[2] & t)
    x[3] = ((1 ^ (c >> 1)) << (k - 1 - d)) | (x[3] & t)


def hash64(key: int, mask: int) -> int:
    """Thomas Wang's invertible 64-bit mix under a 2^k-1 mask (kmer.h:30-40)."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def hash64_inv(key: int, mask: int) -> int:
    """Exact inverse of hash64 (kmer.h:42-77)."""
    tmp = (key - (key << 31)) & U64
    key = (key - ((tmp << 31) & U64)) & mask
    tmp = key ^ (key >> 28)
    key = key ^ (tmp >> 28)
    key = (key * 14933078535860113213) & mask
    tmp = key ^ (key >> 14)
    tmp = key ^ (tmp >> 14)
    tmp = key ^ (tmp >> 14)
    key = key ^ (tmp >> 14)
    key = (key * 15244667743933553977) & mask
    tmp = key ^ (key >> 24)
    key = key ^ (tmp >> 24)
    tmp = ~key & U64
    tmp = ~(key - ((tmp << 21) & U64)) & U64
    tmp = ~(key - ((tmp << 21) & U64)) & U64
    key = ~(key - ((tmp << 21) & U64)) & mask
    return key


def kmer_hash(k: int, x: List[int]) -> Tuple[int, int, int]:
    """Canonical strand-independent hash (kmer.h:79-88).

    Returns (ret, h0, h1) where ret is the 2k-bit Bloom-addressing hash
    and (h0, h1) is the pair used for hash-table keying; h0 is already
    the (orig_h0 + h1) & mask value the reference leaves in h[0].
    """
    t = k >> 1
    u = 1 if ((x[1] >> t) & 1) > ((x[3] >> t) & 1) else 0
    mask = (1 << k) - 1
    h0 = hash64((x[2 * u] + x[2 * u + 1]) & mask, mask)
    h1 = hash64(h0 ^ x[2 * u + 1], mask)
    ret = ((h0 ^ h1) << k) | ((h0 + h1) & mask)
    return ret, (h0 + h1) & mask, h1


def kmer_hash_inv(k: int, h0: int, h1: int) -> Tuple[int, int]:
    """Invert the canonical hash back to 2-plane k-mer bits (kmer.h:90-95)."""
    mask = (1 << k) - 1
    t = (h0 - h1) & mask
    y1 = hash64_inv(h1, mask) ^ t
    y0 = (hash64_inv(t, mask) - y1) & mask
    return y0, y1


def kmer_2str(k: int, y0: int, y1: int) -> str:
    """Decode 2-plane bits into an ACGT string (kmer.h:97-104)."""
    return "".join(
        "ACGT"[(((y1 >> l) & 1) << 1) | ((y0 >> l) & 1)] for l in range(k - 1, -1, -1)
    )


# ---------------------------------------------------------------------------
# Blocked Bloom filter (reference bbf.c)
# ---------------------------------------------------------------------------

def bloom_probes(n_shift: int, n_hashes: int, h: int) -> Tuple[int, List[int]]:
    """Compute the (block, bit-offset list) probed for hash h.

    Mirrors the addressing of bfc_bf_insert/get (bbf.c:27-33,35-37,55-58):
    low n_shift-9 bits pick the 512-bit block, h1 is the start offset,
    h2 the double-hashing stride (bumped if divisible by 32); offsets in
    the first byte (the reference's spin-lock byte) are skipped.
    """
    x = n_shift - BFC_BLK_SHIFT
    block = h & ((1 << x) - 1)
    h1 = (h >> x) & BFC_BLK_MASK
    h2 = (h >> n_shift) & BFC_BLK_MASK
    if (h2 & 31) == 0:
        h2 = (h2 + 1) & BFC_BLK_MASK
    offsets = []
    z = h1
    while len(offsets) < n_hashes:
        if (z >> 3) != 0:  # byte 0 of the block is reserved (lock byte)
            offsets.append(z)
        z = (z + h2) & BFC_BLK_MASK
    return block, offsets


class Bloom:
    """Blocked Bloom filter with reference-identical addressing (bbf.c)."""

    def __init__(self, n_shift: int, n_hashes: int):
        self.n_shift = n_shift
        self.n_hashes = n_hashes
        self.blocks: Dict[int, int] = {}  # block index -> 512-bit int

    def insert(self, h: int) -> int:
        """Set the probe bits; return how many were already set (bbf.c:25-45)."""
        block, offsets = bloom_probes(self.n_shift, self.n_hashes, h)
        state = self.blocks.get(block, 0)
        cnt = 0
        for z in offsets:
            if (state >> z) & 1:
                cnt += 1
            state |= 1 << z
        self.blocks[block] = state
        return cnt

    def get(self, h: int) -> int:
        """Count how many probe bits are set, without inserting (bbf.c:47-63)."""
        block, offsets = bloom_probes(self.n_shift, self.n_hashes, h)
        state = self.blocks.get(block, 0)
        return sum((state >> z) & 1 for z in offsets)


# ---------------------------------------------------------------------------
# Counting hash table (reference htab.c)
# ---------------------------------------------------------------------------

def ch_clamped_l_pre(k: int, l_pre: int) -> int:
    if k * 2 - l_pre > BFC_CH_KEYBITS:
        l_pre = k * 2 - BFC_CH_KEYBITS
    if l_pre > 24:
        l_pre = 24
    return l_pre


def ch_shard_key(k: int, l_pre: int, h0: int, h1: int) -> Tuple[int, int]:
    """Split the canonical-hash pair into (shard, in-shard identity).

    Mirrors get_subhash (htab.c:45-58).  The returned identity is the
    stored key >> 14 (i.e. without the 14 payload bits).
    """
    if k <= 32:
        t = k * 2 - l_pre
        z = (h0 << k) | h1
        return z >> t, z & ((1 << t) - 1)
    t = k - l_pre
    shift = k if t + k < BFC_CH_KEYBITS else BFC_CH_KEYBITS - t
    ident = ((h0 & ((1 << t) - 1)) << shift) ^ h1
    return h0 >> t, ident


class CountHash:
    """Sharded k-mer count table with the reference payload packing.

    Payload: low 8 bits = occurrence count (saturating at 255), bits
    8-13 = high-quality count (saturating at 63) - htab.c:60-82.
    """

    def __init__(self, k: int, l_pre: int):
        self.k = k
        self.l_pre = ch_clamped_l_pre(k, l_pre)
        self.shards: List[Dict[int, int]] = [dict() for _ in range(1 << self.l_pre)]

    def insert(self, h0: int, h1: int, is_high: bool) -> None:
        shard, ident = ch_shard_key(self.k, self.l_pre, h0, h1)
        d = self.shards[shard]
        cur = d.get(ident)
        if cur is None:
            d[ident] = 1 | (256 if is_high else 0)
        else:
            cnt, high = cur & 0xFF, (cur >> 8) & 0x3F
            if cnt != 0xFF:
                cur += 1
            if is_high and high != 0x3F:
                cur += 1 << 8
            d[ident] = cur

    def get(self, h0: int, h1: int) -> int:
        """Return the 14-bit payload or -1 if absent (htab.c:84-92)."""
        shard, ident = ch_shard_key(self.k, self.l_pre, h0, h1)
        return self.shards[shard].get(ident, -1)

    def kmer_occ(self, x: List[int]) -> int:
        _, h0, h1 = kmer_hash(self.k, x)
        return self.get(h0, h1)

    def count(self) -> int:
        return sum(len(d) for d in self.shards)

    def hist(self) -> Tuple[List[int], List[int], int]:
        """Count histogram and its mode (htab.c:110-127).

        Mode = smallest i >= 3 maximizing cnt[i] (strict > comparison)."""
        cnt = [0] * 256
        high = [0] * 64
        for d in self.shards:
            for payload in d.values():
                cnt[payload & 0xFF] += 1
                high[(payload >> 8) & 0x3F] += 1
        best, mode = 0, -1
        for i in range(3, 256):
            if cnt[i] > best:
                best, mode = cnt[i], i
        return cnt, high, mode

    def items(self):
        """Yield (shard, ident, payload) over all entries."""
        for s, d in enumerate(self.shards):
            for ident, payload in d.items():
                yield s, ident, payload


# ---------------------------------------------------------------------------
# Counting pass (reference count.c, sequential single-thread semantics)
# ---------------------------------------------------------------------------

def count_reads(
    reads,
    opt: Opts,
):
    """Counting pass over (seq, qual) pairs in stream order.

    Reproduces worker_count + bfc_kmer_insert (count.c:54-89) under
    sequential order (== bfc -t1): every canonical k-mer is rolled into
    the Bloom filter; only when all n_hashes probed bits were already
    set does it enter the count table (or, in filter mode, the
    high-occurrence Bloom filter).

    Returns (bloom, table) in normal mode or (bloom, bloom_high) in
    filter mode.
    """
    bf = Bloom(opt.bf_shift, opt.n_hashes)
    ch = None if opt.filter_mode else CountHash(opt.k, opt.l_pre)
    bf_high = Bloom(opt.bf_shift, opt.n_hashes) if opt.filter_mode else None
    k = opt.k
    mask = (1 << k) - 1
    for seq, qual in reads:
        x = kmer_null()
        qmer = 0
        run = 0
        for i, ch_chr in enumerate(seq):
            c = BASE_CODE[ord(ch_chr)]
            if c < 4:
                kmer_append(k, x, c)
                qbit = 1 if (qual is None or ord(qual[i]) - 33 >= opt.q) else 0
                qmer = ((qmer << 1) | qbit) & mask
                run += 1
                if run >= k:
                    ret, h0, h1 = kmer_hash(k, x)
                    hit = bf.insert(ret) == opt.n_hashes
                    if hit:
                        if ch is not None:
                            ch.insert(h0, h1, qmer == mask)
                        elif bf_high is not None:
                            bf_high.insert(ret)
            else:
                run = 0
                qmer = 0
                x = kmer_null()
    return (bf, ch) if ch is not None else (bf, bf_high)


# ---------------------------------------------------------------------------
# Correction engine (reference correct.c)
# ---------------------------------------------------------------------------

ECCODE_MISC = 1
ECCODE_MANY_N = 2
ECCODE_NO_SOLID = 3
ECCODE_UNCORR_N = 4
ECCODE_MANY_FAIL = 5


@dataclasses.dataclass
class EcBase:
    b: int = 0
    q: int = 0
    ob: int = 0
    oq: int = 0
    lcov: int = 0
    hcov: int = 0
    solid_end: int = 0
    high_end: int = 0
    ec: int = 0
    absent: int = 0


@dataclasses.dataclass
class EcStat:
    ec_code: int = ECCODE_MISC
    brute: int = 0
    n_ec: int = 0
    n_ec_high: int = 0
    n_absent: int = 0
    rf_code: int = 0
    max_heap: int = 0


def seq_conv(seq: str, qual: Optional[str], qthres: int, b_from_q: bool) -> List[EcBase]:
    """Build the ec sequence (bfc_seq_conv, correct.c:23-37).

    In refine mode a quality char <= '&' encodes the original base as
    qchar-34 (stored through a 3-bit field, hence the & 7)."""
    out = []
    for i, ch_chr in enumerate(seq):
        if b_from_q and qual is not None and ord(qual[i]) - 33 <= 5:
            b = (ord(qual[i]) - 34) & 7
        else:
            b = BASE_CODE[ord(ch_chr)]
        q = 1 if qual is None else (1 if ord(qual[i]) - 33 >= qthres else 0)
        if b > 3:
            q = 0
        out.append(EcBase(b=b, q=q, ob=b, oq=q))
    return out


def seq_revcomp(s: List[EcBase]) -> None:
    """In-place reverse complement (correct.c:39-57)."""
    s.reverse()
    for c in s:
        c.b = 3 - c.b if c.b < 4 else 4
        c.ob = 3 - c.ob if c.ob < 4 else 4


def ec_kcov(k: int, min_occ: int, s: List[EcBase], ch: CountHash) -> None:
    """Annotate per-base solid coverage (bfc_ec_kcov, correct.c:96-117)."""
    x = kmer_null()
    run = 0
    for i, c in enumerate(s):
        c.high_end = c.solid_end = c.lcov = c.hcov = 0
        if c.b < 4:
            kmer_append(k, x, c.b)
            run += 1
            if run >= k:
                r = ch.kmer_occ(x)
                if r >= 0:
                    if ((r >> 8) & 0x3F) >= min_occ + 1:
                        c.high_end = 1
                    if (r & 0xFF) >= min_occ:
                        c.solid_end = 1
                        for j in range(i - k + 1, i + 1):
                            s[j].lcov = (s[j].lcov + 1) & 0x3F
                            s[j].hcov = (s[j].hcov + c.high_end) & 0x3F
        else:
            run = 0
            x = kmer_null()


def ec_best_island(k: int, s: List[EcBase]) -> int:
    """Longest run of solid k-mer ends (correct.c:119-130).

    Returns start<<32|end (end = index one past the last solid_end) or 0."""
    maxv = 0
    max_i = -1
    l = 0
    i = k - 1
    for i in range(k - 1, len(s)):
        if not s[i].solid_end:
            if l > maxv:
                maxv, max_i = l, i
            l = 0
        else:
            l += 1
    i = len(s)
    if l > maxv:
        maxv, max_i = l, i
    return ((max_i - maxv - k + 1) << 32) | max_i if maxv > 0 else 0


def ec_first_kmer(k: int, s: List[EcBase], start: int) -> Tuple[int, List[int]]:
    """Find the first full k-mer at or after start (correct.c:82-94).

    Returns (index of the k-mer's last base, kmer) -- index == len(s)
    means no full k-mer exists."""
    x = kmer_null()
    run = 0
    i = start
    for i in range(start, len(s)):
        if s[i].b < 4:
            kmer_append(k, x, s[i].b)
            run += 1
            if run == k:
                return i, x
        else:
            run = 0
            x = kmer_null()
    return len(s), x


def ec_greedy_k(k: int, mode: int, x: List[int], ch: CountHash) -> int:
    """Single-substitution brute-force repair (correct.c:63-80).

    Returns pos<<2|base (pos counted from the 3' end) or -1."""
    maxv = max2 = 0
    max_ec = -1
    for i in range(k):
        c = (((x[1] >> i) & 1) << 1) | ((x[0] >> i) & 1)
        for j in range(4):
            if j == c:
                continue
            y = list(x)
            kmer_change(k, y, i, j)
            ret = ch.kmer_occ(y)
            if ret < 0:
                continue
            if (maxv & 0xFF) < (ret & 0xFF):
                max2, maxv, max_ec = maxv, ret, (i << 2) | j
            elif (max2 & 0xFF) < (ret & 0xFF):
                max2 = ret
    return max_ec if (maxv & 0xFF) * 3 > mode and (max2 & 0xFF) < 3 else -1


# --- best-first search -----------------------------------------------------

@dataclasses.dataclass
class HeapEnt:
    tot_pen: int
    i: int
    k: int                      # stack back-pointer
    ecpos_high: Tuple[int, ...]
    ecpos: Tuple[int, ...]
    x: Tuple[int, int, int, int]


@dataclasses.dataclass
class StackEnt:
    parent: int
    i: int
    b: int
    pen_ec: int
    pen_ec_high: int
    pen_absent: int
    pen_absent_high: int
    cnt: int
    tot_pen: int


def _heap_up(heap: List[HeapEnt]) -> None:
    """ks_heapup with lt(a,b) = a.tot_pen > b.tot_pen (ksort.h:137-146).

    A new element rises past parents with >= penalty (ties rise)."""
    k = len(heap) - 1
    tmp = heap[k]
    while k:
        i = (k - 1) >> 1
        if tmp.tot_pen > heap[i].tot_pen:
            break
        heap[k] = heap[i]
        k = i
    heap[k] = tmp


def _heap_down(heap: List[HeapEnt], n: int) -> None:
    """ks_heapdown from root with the same comparator (ksort.h:125-136).

    On equal children the left child is chosen; an equal child rises."""
    i = 0
    k = 0
    tmp = heap[0]
    while True:
        k = (k << 1) + 1
        if k >= n:
            break
        if k != n - 1 and heap[k].tot_pen > heap[k + 1].tot_pen:
            k += 1
        if heap[k].tot_pen > tmp.tot_pen:
            break
        heap[i] = heap[k]
        i = k
    heap[i] = tmp


def _weighted_penalty(opt: Opts, ec: int, ec_high: int, absent: int, absent_high: int) -> int:
    return (
        opt.w_ec * ec
        + opt.w_ec_high * ec_high
        + opt.w_absent * absent
        + opt.w_absent_high * absent_high
    )


class SearchStats:
    """Instrumentation for sizing the fixed-capacity device search."""

    def __init__(self):
        self.iters = 0
        self.max_stack = 0
        self.max_heap = 0


def ec1dir(
    opt: Opts,
    ch: CountHash,
    seq: List[EcBase],
    ec: List[EcBase],
    start: int,
    end: int,
    stats: Optional[SearchStats] = None,
) -> Tuple[int, int]:
    """One-direction best-first spectrum search (bfc_ec1dir, correct.c:249-386).

    Fills ec with the corrected bases (4 = masked/uncorrected region);
    returns (rv, max_heap): rv >= 0 is n_absent, rv in {-1,-2,-3} are the
    reference failure codes.
    """
    k = opt.k
    n = len(seq)
    assert end <= n and end - start >= k
    heap: List[HeapEnt] = []
    stack: List[StackEnt] = []
    max_heap_seen = 0
    paths: List[int] = []
    min_path = -1
    min_path_pen = 1 << 60
    n_failures = 0
    rv = -1

    # initial state: first k-1 valid bases rolled in, z.i at the k-th
    # (correct.c:260-266: the increment/break precedes the append)
    zx = kmer_null()
    zi = start
    l = 0
    while zi < end:
        c = seq[zi].b
        if c < 4:
            l += 1
            if l == k:
                break
            kmer_append(k, zx, c)
        else:
            l = 0
            zx = kmer_null()
        zi += 1
    assert zi < end
    z = HeapEnt(
        tot_pen=0,
        i=zi,
        k=-1,
        ecpos_high=tuple([-1] * BFC_EC_HIST_HIGH),
        ecpos=tuple([-1] * BFC_EC_HIST),
        x=tuple(zx),
    )
    heap.append(z)
    for i in range(n):
        ec[i].b = seq[i].b
        ec[i].ob = seq[i].ob
        ec[i].ec = 0
        ec[i].absent = 0

    def buf_update(prev: HeapEnt, pen_b, pen_ec, pen_ec_high, pen_absent, pen_absent_high, cnt):
        # stack push (buf_update, correct.c:198-230)
        tot = prev.tot_pen + _weighted_penalty(opt, pen_ec, pen_ec_high, pen_absent, pen_absent_high)
        stack.append(
            StackEnt(
                parent=prev.k,
                i=prev.i,
                b=pen_b,
                pen_ec=pen_ec,
                pen_ec_high=pen_ec_high,
                pen_absent=pen_absent,
                pen_absent_high=pen_absent_high,
                cnt=(cnt & 0xFF) if cnt > 0 else 0,
                tot_pen=tot,
            )
        )
        nx = list(prev.x)
        kmer_append(k, nx, pen_b)
        if pen_ec_high:
            eph = (prev.i,) + prev.ecpos_high[: BFC_EC_HIST_HIGH - 1]
        else:
            eph = prev.ecpos_high
        if pen_ec:
            ep = (prev.i,) + prev.ecpos[: BFC_EC_HIST - 1]
        else:
            ep = prev.ecpos
        heap.append(
            HeapEnt(tot_pen=tot, i=prev.i + 1, k=len(stack) - 1, ecpos_high=eph, ecpos=ep, x=tuple(nx))
        )
        if verbose >= 4:
            _tr("     <= base:%c penalty:%d"
                % (("acgtn" if pen_ec else "ACGTN")[pen_b], tot))
        _heap_up(heap)

    if verbose >= 4:
        _tr(f"* bfc_ec1dir(): len:{n} start:{start} end:{end}")
    while True:
        if stats is not None:
            stats.iters += 1
            stats.max_stack = max(stats.max_stack, len(stack))
            stats.max_heap = max(stats.max_heap, len(heap))
        # raw running max, like the reference's int counter; the 8-bit
        # ecstat bitfield wrap (& 0xFF) happens at pack time (correct.c:553)
        max_heap_seen = max(max_heap_seen, len(heap))
        if not heap:
            rv = -2
            break
        z = heap[0]
        last = heap.pop()
        if heap:
            heap[0] = last
            _heap_down(heap, len(heap))
        if verbose >= 4:
            _tr(
                "  => pos:%d stack_size:%d heap_size:%d penalty:%d last_base:%c "
                "ecpos_high:[%d,%d] ecpos:[%d,%d,%d,%d,%d]"
                % (z.i, len(stack), len(heap), z.tot_pen,
                   "ACGT"[((z.x[1] & 1) << 1) | (z.x[0] & 1)],
                   z.ecpos_high[0], z.ecpos_high[1],
                   z.ecpos[0], z.ecpos[1], z.ecpos[2], z.ecpos[3], z.ecpos[4])
            )
        if min_path >= 0 and z.tot_pen > min_path_pen + opt.max_path_diff:
            break
        stop = z.i - end > opt.max_end_ext
        if not stop:
            c = seq[z.i] if z.i < n else None
            fixed = 0
            os = -1
            other_ext = 0
            added = []  # (b, ec, ec_high, absent, absent_high, cnt)
            if z.i > end:
                fixed = 1
            if c is not None and c.b < 4:
                x2 = list(z.x)
                kmer_append(k, x2, c.b)
                os = ch.kmer_occ(x2)
                # NOTE: the reference tests (os & 0xff) with os possibly -1,
                # so an absent k-mer reads as count 255 here (correct.c:300)
                if c.q and (os & 0xFF) >= opt.min_cov + 1 and c.lcov >= opt.min_cov + 1:
                    fixed = 1
                elif c.hcov > k * 0.75:
                    fixed = 1
                if verbose >= 4:
                    occs = f"{os & 0xFF},{(os >> 8) & 0x3F}" if os >= 0 else "-1,-1"
                    _tr(f"     Original base:%c qual:%d fixed:%d count:%s"
                        % ("ACGTN"[c.b], c.q, fixed, occs))
            for b in range(4):
                if fixed and c is not None and b != c.b:
                    continue
                if c is None or b != c.b:
                    if c is not None:
                        if (
                            c.q
                            and z.ecpos_high[BFC_EC_HIST_HIGH - 1] >= 0
                            and z.i - z.ecpos_high[BFC_EC_HIST_HIGH - 1] < opt.win_multi_ec
                        ):
                            continue
                        if (
                            z.ecpos[BFC_EC_HIST - 1] >= 0
                            and z.i - z.ecpos[BFC_EC_HIST - 1] < opt.win_multi_ec
                        ):
                            continue
                    x2 = list(z.x)
                    kmer_append(k, x2, b)
                    s_occ = ch.kmer_occ(x2)
                    if verbose >= 4 and s_occ >= 0:
                        _tr("     Alternative k-mer count: %c,%d:%d"
                            % ("ACGTN"[b], s_occ & 0xFF, (s_occ >> 8) & 0x3F))
                    if s_occ < 0 or (s_occ & 0xFF) < opt.min_cov:
                        continue
                    pen_ec = 1 if (c is not None and c.b < 4) else 0
                    pen_ec_high = c.oq if pen_ec else 0
                    pen_absent = 0
                    pen_absent_high = 1 if ((s_occ >> 8) & 0xFF) < opt.min_cov else 0
                    added.append((b, pen_ec, pen_ec_high, pen_absent, pen_absent_high, s_occ))
                    other_ext += 1
                else:
                    pen_absent = 1 if (os < 0 or (os & 0xFF) < opt.min_cov) else 0
                    pen_absent_high = 1 if (os < 0 or ((os >> 8) & 0xFF) < opt.min_cov) else 0
                    added.append((b, 0, 0, pen_absent, pen_absent_high, os))
            if fixed == 0 and other_ext == 0:
                n_failures += 1
            if n_failures > n * 2:
                rv = -3
                break
            if c is not None or len(added) == 1:
                if len(added) > 1 and len(heap) > opt.max_heap:
                    # heap-explosion guard: push only the min-penalty branch
                    min_b = -1
                    minv = 1 << 60
                    for bi, a in enumerate(added):
                        t = _weighted_penalty(opt, a[1], a[2], a[3], a[4])
                        if minv > t:
                            minv, min_b = t, bi
                    a = added[min_b]
                    buf_update(z, a[0], a[1], a[2], a[3], a[4], a[5])
                else:
                    for a in added:
                        buf_update(z, a[0], a[1], a[2], a[3], a[4], a[5])
            else:
                if not added:
                    stack[z.k].tot_pen += opt.w_absent * (opt.max_end_ext - (z.i - end))
                stop = True
        if stop:
            if stack[z.k].tot_pen < min_path_pen:
                min_path_pen = stack[z.k].tot_pen
                min_path = len(paths)
            paths.append(z.k)
            if verbose >= 4:
                _tr(f"  @@ n_paths={len(paths)} penalty={stack[z.k].tot_pen}")
            if len(paths) == BFC_MAX_PATHS:
                break

    if not paths:
        return rv, max_heap_seen
    assert 0 <= min_path < len(paths) and stack[paths[min_path]].tot_pen == min_path_pen
    # backtrack (buf_backtrack, correct.c:232-247)
    n_absent = 0
    endk = paths[min_path]
    while endk >= 0:
        node = stack[endk]
        if node.i < n:
            ec[node.i].b = node.b
            ec[node.i].ec = node.pen_ec
            ec[node.i].absent = node.pen_absent
            n_absent += node.pen_absent
        endk = node.parent
    for i in range(n):
        if i < start + k or i >= end:
            ec[i].b = 4
    if verbose >= 4:
        # per-direction path summary + masked sequence (correct.c:380-384)
        _tr(f"* {len(paths)} path(s); lowest penalty: {min_path_pen}")
        _tr("  " + "".join(
            (BASES if seq[i].b == ec[i].b else BASES_LOWER)[ec[i].b]
            for i in range(n)
        ))
    return n_absent, max_heap_seen


def ec1(
    opt: Opts,
    ch: CountHash,
    mode: int,
    seq: str,
    qual: Optional[str],
    ori_st: Optional[EcStat] = None,
    stats: Optional[SearchStats] = None,
) -> Tuple[EcStat, str, Optional[str]]:
    """Correct one read (bfc_ec1, correct.c:388-472).

    Returns (stats, corrected_seq, corrected_qual)."""
    st = EcStat()
    st.rf_code = 1 if opt.refine_ec else 0
    s = seq_conv(seq, qual, opt.q, opt.refine_ec)
    n = len(s)
    n_n = sum(1 for c in s if c.ob > 3)
    if n_n > n * 0.05:
        st.ec_code = ECCODE_MANY_N
        return st, seq, qual
    ec_kcov(opt.k, opt.min_cov, s, ch)
    r = ec_best_island(opt.k, s)
    start = end = 0
    if r == 0:
        # greedy fallback over successive k-mer windows (correct.c:406-421)
        ecv = -1
        start = 0
        while True:
            end, x = ec_first_kmer(opt.k, s, start)
            if end >= n:
                break
            ecv = ec_greedy_k(opt.k, mode, x, ch)
            if ecv >= 0:
                break
            if end + (opt.k >> 1) >= n:
                break
            start = end - (opt.k >> 1)
        if ecv >= 0:
            s[end - (ecv >> 2)].b = ecv & 3
            end += 1
            start = end - opt.k
            st.brute = 1
        else:
            st.ec_code = ECCODE_NO_SOLID
            return st, seq, qual
    else:
        start, end = r >> 32, r & 0xFFFFFFFF
    if verbose >= 4:
        _tr(f"* Longest solid island: [{start},{end})")
    ec0 = [EcBase() for _ in range(n)]
    ec1v = [EcBase() for _ in range(n)]
    rv0, mh0 = ec1dir(opt, ch, s, ec0, start, n, stats)
    if rv0 < 0:
        st.ec_code = (
            ECCODE_UNCORR_N if rv0 == -2 else ECCODE_MANY_FAIL if rv0 == -3 else ECCODE_MISC
        )
        return st, seq, qual
    seq_revcomp(s)
    rv1, mh1 = ec1dir(opt, ch, s, ec1v, n - end, n, stats)
    if rv1 < 0:
        st.ec_code = (
            ECCODE_UNCORR_N if rv1 == -2 else ECCODE_MANY_FAIL if rv1 == -3 else ECCODE_MISC
        )
        return st, seq, qual
    st.max_heap = max(mh0, mh1)
    st.ec_code = 0
    st.n_absent = rv0 + rv1
    seq_revcomp(ec1v)
    seq_revcomp(s)
    if opt.refine_ec and ori_st is not None and ori_st.ec_code == 0 and st.n_absent > ori_st.n_absent:
        st = dataclasses.replace(ori_st)
        st.rf_code = 2
        return st, seq, qual
    # merge the two directions (correct.c:443-450)
    for i in range(n):
        if ec0[i].b == ec1v[i].b:
            s[i].b = s[i].b if ec0[i].b > 3 else ec0[i].b
        elif ec1v[i].b > 3:
            s[i].b = ec0[i].b
        elif ec0[i].b > 3:
            s[i].b = ec1v[i].b
        else:
            s[i].b = s[i].ob
    # rewrite seq/qual in place (correct.c:451-459)
    out_seq = []
    out_qual = [] if qual is not None else None
    for i in range(n):
        is_diff = s[i].b != s[i].ob
        if is_diff:
            st.n_ec += 1
            if s[i].q:
                st.n_ec_high += 1
        out_seq.append((BASES_LOWER if is_diff else BASES)[s[i].b])
        if out_qual is not None:
            out_qual.append(chr(34 + s[i].ob) if is_diff else "+?"[s[i].q])
    if verbose >= 4:
        # final per-read summary: case-marked corrected sequence + the
        # re-annotated lcov digit line (correct.c:460-468; note the
        # reference reruns bfc_ec_kcov on the CORRECTED bases first)
        ec_kcov(opt.k, opt.min_cov, s, ch)
        _tr(f"* ec_code:{st.ec_code} n_ec:{st.n_ec} n_ec_high:{st.n_ec_high}")
        _tr("  " + "".join(
            (BASES if s[i].b == s[i].ob else BASES_LOWER)[s[i].b]
            for i in range(n)
        ))
        _tr("  " + "".join(
            chr(ord("0") + int(10.0 * s[i].lcov / opt.k + 0.499))
            for i in range(n)
        ))
    if opt.refine_ec:
        st.rf_code = 3
    return st, "".join(out_seq), "".join(out_qual) if out_qual is not None else None


# ---------------------------------------------------------------------------
# Trim / filter mode (reference correct.c:478-497,554-570)
# ---------------------------------------------------------------------------

def max_streak(k: int, bf: Bloom, seq: str) -> int:
    """Longest run of k-mers fully present in the Bloom filter.

    Returns len<<32 | end_pos, exactly as the reference max_streak."""
    maxv = 0
    t = 0
    x = kmer_null()
    run = 0
    for i, ch_chr in enumerate(seq):
        c = BASE_CODE[ord(ch_chr)]
        if c < 4:
            kmer_append(k, x, c)
            run += 1
            if run >= k:
                ret, _, _ = kmer_hash(k, x)
                if bf.get(ret) == bf.n_hashes:
                    t += 1 << 32
                else:
                    t = i + 1
            else:
                t = i + 1
        else:
            run = 0
            x = kmer_null()
            t = i + 1
        if t > maxv:
            maxv = t
    return maxv


def trim_read(opt: Opts, bf: Bloom, seq: str, qual: Optional[str]):
    """Apply filter-mode trimming (worker_ec filter branch, correct.c:554-570).

    Returns (kept, seq, qual)."""
    m = max_streak(opt.k, bf, seq)
    streak = m >> 32
    # min_frac is a C float in the reference (bfc.h:21), so the survival
    # threshold is the float32 rounding of 0.9, not the double
    min_frac32 = struct.unpack("f", struct.pack("f", opt.min_frac))[0]
    if streak and (streak + opt.k) / len(seq) > min_frac32:
        start = (m & 0xFFFFFFFF) - (opt.k - 1)
        end = (m & 0xFFFFFFFF) + streak
        assert start >= 0 and end <= len(seq)
        return True, seq[start:end], qual[start:end] if qual is not None else None
    return False, seq, qual
