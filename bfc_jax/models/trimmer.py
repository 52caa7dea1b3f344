"""Filter/trim mode (-1): device Bloom of repeated k-mers + batched trim.

Mirrors the reference's second Bloom filter path (count.c:67-68,148-153)
and max_streak trimming (correct.c:478-497,554-570).  The spin-locked
bit array becomes a deduplicated scatter build; the per-read rolling
streak scan becomes a windowed cumulative-max computation.
"""

from __future__ import annotations

import functools
import struct
from typing import Iterable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..io.fastq import Read, format_corrected, read_fastx
from ..opts import Opts
from ..utils.log import log
from ..ops import kmer as kops
from ..ops import spectrum as spec

U64 = jnp.uint64
I32 = jnp.int32


class DeviceBloom:
    """Immutable blocked-Bloom bit array (query-only, reference addressing)."""

    def __init__(self, words, bf_shift: int, n_hashes: int):
        self.words = words  # u32 [2^(bf_shift-5)]
        self.bf_shift = bf_shift
        self.n_hashes = n_hashes

    @staticmethod
    def from_rets(rets, keep, bf_shift: int, n_hashes: int) -> "DeviceBloom":
        """OR the probe bits of all kept hashes into a dense bit array."""
        words = _bloom_build(rets, keep, bf_shift, n_hashes)
        return DeviceBloom(words, bf_shift, n_hashes)

    def query_all_set(self, rets):
        """True where all n_hashes probe bits are set (bbf.c:47-63)."""
        return _bloom_query(self.words, rets, self.bf_shift, self.n_hashes)


@functools.partial(jax.jit, static_argnames=("bf_shift", "n_hashes"))
def _bloom_build(rets, keep, bf_shift: int, n_hashes: int):
    bits = spec.bloom_probe_bits(rets, bf_shift, n_hashes)  # [N, H]
    flat = bits.reshape(-1)
    keep_f = jnp.broadcast_to(keep[:, None], bits.shape).reshape(-1)
    # dedupe exact bit ids so a scatter-add performs a bitwise OR
    sent = U64((1 << bf_shift) + 1)
    key = jnp.where(keep_f, flat, sent)
    lo = (key & U64(0xFFFFFFFF)).astype(jnp.uint32)
    hi = (key >> U64(32)).astype(jnp.uint32)
    skey = key[spec.stable_order(lo, hi)]
    first = jnp.concatenate([jnp.ones((1,), bool), skey[1:] != skey[:-1]])
    uniq = first & (skey != sent)
    word = (skey >> U64(5)).astype(jnp.int64)
    bit = (skey & U64(31)).astype(jnp.uint32)
    n_words = 1 << (bf_shift - 5)
    word = jnp.where(uniq, word, n_words + 1)
    return jnp.zeros((n_words,), jnp.uint32).at[word].add(
        jnp.where(uniq, jnp.uint32(1) << bit, 0), mode="drop"
    )


@functools.partial(jax.jit, static_argnames=("bf_shift", "n_hashes"))
def _bloom_query(words, rets, bf_shift: int, n_hashes: int):
    bits = spec.bloom_probe_bits(rets, bf_shift, n_hashes)
    word = (bits >> U64(5)).astype(jnp.int64)
    bit = (bits & U64(31)).astype(jnp.uint32)
    got = (words[word] >> bit) & 1
    return jnp.all(got == 1, axis=-1)


@functools.partial(jax.jit, static_argnames=("bf_shift", "n_hashes",
                                              "sketch"))
def filter_keep_rets(agg: spec.Aggregate, bf_shift: int, n_hashes: int,
                     sketch: bool = False):
    """Hashes that would enter bf_high: >= 1 Bloom-hit occurrence.

    sketch=True uses the sort-free dense-sketch adjudicate (exact while
    first arrivals fit u32; the caller checks) - the sort program does
    not compile at device-resident big-C aggregates."""
    if sketch:
        fp = spec.adjudicate_sketch(agg, bf_shift, n_hashes)
    else:
        fp = spec.adjudicate_first_occurrence(agg, bf_shift, n_hashes)
    valid = agg.shard != spec.INVALID_SHARD
    keep = valid & ((agg.n - 1 + fp.astype(jnp.uint32)) >= 1)
    return agg.ret, keep


def count_file_filter_device(fn: str, opt: Opts, batch_reads: int = 8192) -> DeviceBloom:
    """Filter-mode counting: build the high-occurrence Bloom filter."""
    from .counter import count_batches_aggregate

    agg, n_reads = count_batches_aggregate(fn, opt, batch_reads=batch_reads)
    if agg.ret is None:  # derivable config: materialize once (HostAgg)
        from ..ops.spectrum_dense import derive_ret_np

        agg = agg._replace(ret=derive_ret_np(
            np.asarray(agg.shard), np.asarray(agg.keybody, dtype=np.uint64),
            opt.k, opt.effective_l_pre(),
        ))
    sketch = getattr(agg, "bloom_min", None)
    if (sketch is not None and sketch.valid
            and sketch.bf_shift == opt.bf_shift
            and sketch.n_hashes == opt.n_hashes):
        # incremental adjudication (spectrum_host.BloomMinSketch): the
        # verdict is a host gather, skipping the device adjudicate sort
        valid = np.asarray(agg.shard) != 0xFFFFFFFF
        fp = sketch.verdict(np.asarray(agg.ret), np.asarray(agg.first_arr),
                            valid)
        keep = valid & ((np.asarray(agg.n) - 1 + fp.astype(np.uint32)) >= 1)
        rets = jnp.asarray(agg.ret)
        keep = jnp.asarray(keep)
    else:
        if sketch is not None:  # host object, not a pytree leaf: strip
            agg = agg._replace(bloom_min=None)
        # device reduce (a scalar pull), NOT np.asarray of the column -
        # that would pull the whole aggregate to the host
        valid_a = jnp.asarray(agg.shard) != jnp.uint32(0xFFFFFFFF)
        arr_max = int(jnp.max(jnp.where(valid_a, jnp.asarray(agg.first_arr),
                                        jnp.uint64(0))))
        rets, keep = filter_keep_rets(agg, opt.bf_shift, opt.n_hashes,
                                      sketch=arr_max < 0xFFFFFFFF)
    log(f"processed {n_reads} sequences (filter mode)")
    return DeviceBloom.from_rets(rets, keep, opt.bf_shift, opt.n_hashes)


@functools.partial(jax.jit, static_argnames=("k", "bf_shift", "n_hashes"))
def max_streak_batch(words, bases, lens, k: int, bf_shift: int, n_hashes: int):
    """Longest Bloom-hit k-mer run per read (max_streak, correct.c:478-497).

    Returns the packed len<<32|reset_pos maximum, replicating the
    reference's tie behavior (numeric max: equal lengths resolve to the
    later run)."""
    B, L = bases.shape
    x0, x1, x2, x3 = kops.kmer_planes(bases, k)
    valid = kops.valid_kmer_mask(bases, lens, k)
    ret, _, _ = kops.canonical_hash(x0, x1, x2, x3, k)
    hit = valid & _bloom_query(words, ret, bf_shift, n_hashes)
    idx = jnp.arange(L, dtype=jnp.int32)
    inb = idx[None, :] < lens[:, None]
    nonhit = ~hit
    last_nonhit = jax.lax.associative_scan(
        jnp.maximum, jnp.where(nonhit, idx[None, :], -1), axis=-1
    )
    runlen = (idx[None, :] - last_nonhit).astype(jnp.int64)
    t = jnp.where(
        hit,
        (runlen << 32) | (last_nonhit + 1).astype(jnp.int64),
        (idx[None, :] + 1).astype(jnp.int64),
    )
    t = jnp.where(inb, t, 0)
    return jnp.max(t, axis=-1)


class Trimmer:
    def __init__(self, opt: Opts, bloom: DeviceBloom):
        self.opt = opt
        self.bloom = bloom
        # min_frac is a C float in the reference (bfc.h:21)
        self.min_frac32 = struct.unpack("f", struct.pack("f", opt.min_frac))[0]

    def trim_batch(self, reads: List[Read]) -> None:
        opt = self.opt
        seqs = [r.seq for r in reads]
        bases, _, lens = kops.encode_batch(seqs, None, opt.q)
        self._apply(reads, bases, lens)

    def _apply(self, reads: List[Read], bases, lens) -> None:
        m = np.asarray(
            max_streak_batch(
                self.bloom.words, jnp.asarray(bases), jnp.asarray(lens),
                self.opt.k, self.bloom.bf_shift, self.bloom.n_hashes,
            )
        )
        self._apply_m(reads, m)

    def trim_file(self, fn: str, out: List[str], batch_reads: int = 8192) -> None:
        from ..io import fast_reader as FR

        pad_L = 0
        comments = FR.CommentCarry()
        for rb in FR.iter_batches_prefetch(fn, batch_reads,
                                           max_bases=self.opt.chunk_size):
            n = rb.n
            # bucketed shapes: one device compile for the whole stream
            pad_L = max(pad_L, (int(rb.lens.max()) + 31) // 32 * 32)
            Lc = min(pad_L, rb.bases.shape[1])
            bases = np.full((batch_reads, pad_L), 4, np.uint8)
            bases[:n, :Lc] = rb.bases[:, :Lc]
            lens = np.zeros((batch_reads,), np.int32)
            lens[:n] = rb.lens
            m = np.asarray(
                max_streak_batch(
                    self.bloom.words, jnp.asarray(bases), jnp.asarray(lens),
                    self.opt.k, self.bloom.bf_shift, self.bloom.n_hashes,
                )
            )[:n]
            if self._emit_native(rb, m, comments, out):
                continue
            reads = [
                Read(name=rb.name(i), comment=comments.get(rb, i), seq=rb.seq(i),
                     qual=rb.qual(i))
                for i in range(n)
            ]
            self._apply_m(reads, m)
            for r in reads:
                format_corrected(r, self.opt.no_qual, True, self.opt.discard, out)

    def _emit_native(self, rb, m, comments, out) -> bool:
        """Batch emit via the native trim formatter (the counterpart of
        correct.c:596-611 in filter mode).  Falls back to the per-read
        Python path for slow-parser batches, any comment in flight
        (kseq stale-comment semantics need Python state), or any slice
        that would rely on Python's negative/clamped slicing."""
        import ctypes
        import os

        from ..native.build import get_lib

        opt = self.opt
        n = rb.n
        lib = get_lib()
        if (lib is None or rb._strings is not None or n == 0
                or not hasattr(out, "write_bytes")
                or os.environ.get("BFC_NO_NATIVE_WRITER")
                or comments.stale is not None
                or int(rb.comm_len[:n].max(initial=-1)) >= 0):
            return False
        streak = (m >> 32).astype(np.int64)
        seqlen = rb.lens[:n].astype(np.float64)
        keep = (streak > 0) & (
            (streak + opt.k) / np.maximum(seqlen, 1) > self.min_frac32
        )
        start = ((m & 0xFFFFFFFF).astype(np.int64) - (opt.k - 1))
        tlen = streak + opt.k - 1
        bad = keep & ((start < 0) | (start + tlen > rb.lens[:n]))
        if bad.any():
            return False
        is_fq = (rb.qual_off[:n] >= 0) & (not opt.no_qual)
        mode = keep.astype(np.uint8) | (is_fq.astype(np.uint8) << 2)
        name_off = np.ascontiguousarray(rb.name_off[:n], dtype=np.int64)
        name_len = np.ascontiguousarray(rb.name_len[:n], dtype=np.int32)
        seq_off = np.ascontiguousarray(rb.seq_off[:n], dtype=np.int64)
        qual_off = np.ascontiguousarray(rb.qual_off[:n], dtype=np.int64)
        start32 = np.ascontiguousarray(np.where(keep, start, 0), dtype=np.int32)
        tlen32 = np.ascontiguousarray(np.where(keep, tlen, 0), dtype=np.int32)
        cap = int((name_len.astype(np.int64) + 2 * tlen32 + 8).sum()) + 16
        buf = ctypes.create_string_buffer(cap)

        def p(arr, ct):
            return arr.ctypes.data_as(ctypes.POINTER(ct))

        ret = lib.fastx_format_trim(
            n, rb.buf,
            p(name_off, ctypes.c_int64), p(name_len, ctypes.c_int32),
            p(seq_off, ctypes.c_int64), p(qual_off, ctypes.c_int64),
            p(start32, ctypes.c_int32), p(tlen32, ctypes.c_int32),
            p(mode, ctypes.c_ubyte),
            buf, cap,
        )
        if ret < 0:
            return False
        out.write_bytes(buf.raw[:ret])
        return True

    def _apply_m(self, reads: List[Read], m: np.ndarray) -> None:
        opt = self.opt
        for i, r in enumerate(reads):
            streak = int(m[i]) >> 32
            if streak and (streak + opt.k) / len(r.seq) > self.min_frac32:
                start = (int(m[i]) & 0xFFFFFFFF) - (opt.k - 1)
                end = start + streak + opt.k - 1
                r.seq = r.seq[start:end]
                if r.qual is not None:
                    r.qual = r.qual[start:end]
                r.aux = 0
            else:
                r.aux = 1
