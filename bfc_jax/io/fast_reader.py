"""Batched FASTQ reader over the native C parser (Python fallback).

Yields ReadBatch objects carrying encoded padded arrays (ready for the
device) plus lazy access to names/comments/raw text, so the hot path
never materializes per-read Python strings.  Falls back to the general
parser in bfc_jax.io.fastq for multi-line records or when the native
library is unavailable.
"""

from __future__ import annotations

import gzip
from typing import Iterator, List, Optional

import numpy as np

from ..native.build import get_lib
from . import fastq as slow_io

_BLOCK = 4 << 20

_BASE_CODE = None


def _base_code_table() -> np.ndarray:
    """ASCII -> base code LUT (the native parser's BASE_CODE twin)."""
    global _BASE_CODE
    if _BASE_CODE is None:
        t = np.full(256, 4, np.uint8)
        for i, c in enumerate(b"ACGT"):
            t[c] = i
            t[c + 32] = i  # lower case
        _BASE_CODE = t
    return _BASE_CODE


class ReadBatch:
    """A parsed batch: padded arrays + lazy per-read text accessors.

    `decoded` is the row range [lo, hi) whose bases/quals matrices were
    actually filled by the parser (multi-host readers decode only their
    owned stride; record structure - lens, offsets, raw text - is always
    complete for every row).  None means all rows."""

    __slots__ = ("n", "bases", "quals", "lens", "buf", "name_off", "name_len",
                 "comm_off", "comm_len", "seq_off", "qual_off", "_strings",
                 "decoded")

    def __init__(self, n, bases, quals, lens, buf, name_off, name_len,
                 comm_off, comm_len, seq_off, qual_off, strings=None,
                 decoded=None):
        self.decoded = decoded
        self.n = n
        self.bases = bases        # u8 [n, L] codes 0..4
        self.quals = quals        # u8 [n, L] raw qual chars (0 = none/pad)
        self.lens = lens          # i32 [n]
        self.buf = buf
        self.name_off = name_off
        self.name_len = name_len
        self.comm_off = comm_off
        self.comm_len = comm_len
        self.seq_off = seq_off
        self.qual_off = qual_off
        self._strings = strings   # fallback path: list of Read objects

    def name(self, i: int) -> str:
        if self._strings is not None:
            return self._strings[i].name
        o = self.name_off[i]
        return self.buf[o : o + self.name_len[i]].decode("ascii")

    def comment(self, i: int) -> Optional[str]:
        if self._strings is not None:
            return self._strings[i].comment
        ln = self.comm_len[i]
        if ln < 0:
            return None
        o = self.comm_off[i]
        return self.buf[o : o + ln].decode("ascii")

    def seq(self, i: int) -> str:
        if self._strings is not None:
            return self._strings[i].seq
        o = self.seq_off[i]
        return self.buf[o : o + int(self.lens[i])].decode("ascii")

    def qual(self, i: int) -> Optional[str]:
        if self._strings is not None:
            return self._strings[i].qual
        o = self.qual_off[i]
        if o < 0:
            return None
        return self.buf[o : o + int(self.lens[i])].decode("ascii")

    def has_qual(self) -> np.ndarray:
        if self._strings is not None:
            return np.array([r.qual is not None for r in self._strings])
        return self.qual_off[: self.n] >= 0

    def ensure_decoded(self, lo: int, hi: int) -> None:
        """Fill bases/quals for rows [lo, hi) from the raw buffer if the
        parser skipped them (split batches can shift a stride-decoded
        range off a consumer's owned rows; this is the rare repair
        path).  No-op when the rows are already decoded."""
        if self._strings is not None or self.decoded is None:
            return
        dlo, dhi = self.decoded
        lo, hi = max(lo, 0), min(hi, self.n)
        if lo >= hi or (dlo <= lo and hi <= dhi):
            return
        base_code = _base_code_table()
        mv = np.frombuffer(self.buf, np.uint8)
        # decode the whole union range so `decoded` stays one interval
        tlo = min(lo, dlo) if dlo < dhi else lo
        thi = max(hi, dhi) if dlo < dhi else hi
        for i in range(tlo, thi):
            if dlo <= i < dhi:
                continue
            ln = int(self.lens[i])
            o = int(self.seq_off[i])
            self.bases[i, :ln] = base_code[mv[o : o + ln]]
            qo = int(self.qual_off[i])
            if qo >= 0:
                self.quals[i, :ln] = mv[qo : qo + ln]
        self.decoded = (tlo, thi)


class CommentCarry:
    """Stale-comment inheritance of the reference parser: kseq resets only
    comment.l, and bseq tests the buffer pointer (kseq.h:194-197 +
    bseq.c:66), so a comment-less record reuses the most recent comment
    text seen in the stream.  One instance per input file."""

    def __init__(self):
        self.stale: Optional[str] = None

    def get(self, rb: "ReadBatch", i: int) -> Optional[str]:
        c = rb.comment(i)
        if c is None:
            return self.stale
        self.stale = c
        return c


def _open_raw(fn: Optional[str]):
    """Open a (possibly gzipped) file; (stream, owns_handle)."""
    import sys

    if fn is None or fn == "-":
        # stdin: never closed, and a second pass sees the consumed stream
        # (the reference behaves the same way: bseq_open(stdin) twice)
        return sys.stdin.buffer, False
    raw = open(fn, "rb")
    magic = raw.read(2)
    raw.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.GzipFile(fileobj=raw), True
    return raw, True


def _split_by_bases(rb: ReadBatch, max_bases: int) -> Iterator[ReadBatch]:
    """Split a batch so each piece holds <= max_bases sequence bases
    (the -L chunk-size bound of bseq_read, /root/reference/bseq.c:52-76:
    the reference stops a chunk once cumulative length >= chunk_size,
    so a chunk may exceed the bound by at most one read)."""
    n = rb.n
    if n == 0 or int(rb.lens.sum()) <= max_bases:
        yield rb
        return
    cum = np.cumsum(rb.lens.astype(np.int64))
    i0 = 0
    while i0 < n:
        # include reads until the running total passes max_bases
        base = cum[i0 - 1] if i0 else 0
        i1 = int(np.searchsorted(cum - base, max_bases, side="left")) + 1
        i1 = min(max(i1, i0 + 1), n)
        if rb._strings is not None:
            yield ReadBatch(i1 - i0, rb.bases[i0:i1], rb.quals[i0:i1],
                            rb.lens[i0:i1], rb.buf, None, None, None, None,
                            None, None, strings=rb._strings[i0:i1])
        else:
            dec = rb.decoded
            if dec is not None:  # shift the decoded range into piece coords
                dec = (max(dec[0] - i0, 0), max(min(dec[1], i1) - i0, 0))
            yield ReadBatch(i1 - i0, rb.bases[i0:i1], rb.quals[i0:i1],
                            rb.lens[i0:i1], rb.buf,
                            rb.name_off[i0:i1], rb.name_len[i0:i1],
                            rb.comm_off[i0:i1], rb.comm_len[i0:i1],
                            rb.seq_off[i0:i1], rb.qual_off[i0:i1],
                            decoded=dec)
        i0 = i1


def iter_batches_prefetch(fn: Optional[str], batch_reads: int,
                          depth: int = 2,
                          max_bases: Optional[int] = None,
                          decode_range=None) -> Iterator[ReadBatch]:
    """iter_batches with a background reader thread (the host-side
    analogue of the reference's kt_pipeline I/O step overlapping
    compute, kthread.c:118-146).  Parsing/encoding of the next batch
    proceeds while the caller runs the device step."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def producer():
        try:
            for rb in iter_batches(fn, batch_reads, max_bases=max_bases,
                                   decode_range=decode_range):
                q.put(rb)
            q.put(_END)
        except BaseException as e:  # surface errors in the consumer
            q.put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
    t.join()


def iter_batches(fn: Optional[str], batch_reads: int, max_len: int = 512,
                 max_bases: Optional[int] = None,
                 decode_range=None) -> Iterator[ReadBatch]:
    """Batches of <= batch_reads reads and (when max_bases is given, the
    -L chunk bound) <= max_bases + one read of sequence.

    decode_range=(lo, hi): fill bases/quals only for rows [lo, hi) of
    each batch (multi-host stride decode; the byte scan and all offsets
    stay complete).  Consumers must ensure_decoded() any rows they read
    outside the range (splits can shift it - see ReadBatch.decoded)."""
    it = _iter_batches_impl(fn, batch_reads, max_len,
                            decode_range=decode_range)
    if max_bases is None:
        yield from it
    else:
        for rb in it:
            yield from _split_by_bases(rb, max_bases)


def _iter_batches_impl(fn: Optional[str], batch_reads: int, max_len: int = 512,
                       decode_range=None) -> Iterator[ReadBatch]:
    lib = get_lib()
    if lib is None:
        yield from _iter_batches_slow(fn, batch_reads)
        return
    import ctypes

    fp, owns = _open_raw(fn)
    tail = b""
    eof = False
    slow_mode = False
    while not eof or tail:
        if slow_mode:
            break
        block = fp.read(_BLOCK) if not eof else b""
        if not block:
            eof = True
        buf = tail + block
        if not buf:
            break
        consumed_total = 0
        while True:
            sub = buf[consumed_total:]
            if not sub:
                break
            B = batch_reads
            bases = np.full((B, max_len), 4, np.uint8)
            quals = np.zeros((B, max_len), np.uint8)
            lens = np.zeros((B,), np.int32)
            name_off = np.zeros((B,), np.int64)
            name_len = np.zeros((B,), np.int32)
            comm_off = np.zeros((B,), np.int64)
            comm_len = np.zeros((B,), np.int32)
            seq_off = np.zeros((B,), np.int64)
            qual_off = np.zeros((B,), np.int64)
            consumed = ctypes.c_int64(0)
            ptrs = (
                sub, len(sub), int(eof), B, max_len,
                bases.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                quals.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                name_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                name_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                comm_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                comm_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                seq_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                qual_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ctypes.byref(consumed),
            )
            if decode_range is not None:
                r = lib.fastx_parse_range(
                    *ptrs, int(decode_range[0]), int(decode_range[1])
                )
            else:
                r = lib.fastx_parse(*ptrs)
            if r < 0:
                slow_mode = True
                break
            if r == 0:
                # incomplete record (needs more input) or over-long seq
                if eof and consumed.value == 0 and len(sub) > 0:
                    if max_len < 1 << 20:
                        max_len *= 2
                        continue
                    slow_mode = True
                break
            dec = None
            if decode_range is not None:
                dec = (min(int(decode_range[0]), int(r)),
                       min(int(decode_range[1]), int(r)))
            yield ReadBatch(
                int(r), bases[:r], quals[:r], lens[:r], sub,
                name_off[:r], name_len[:r], comm_off[:r], comm_len[:r],
                seq_off[:r], qual_off[:r], decoded=dec,
            )
            consumed_total += int(consumed.value)
            if r < B:
                break
        tail = buf[consumed_total:]
        if eof and (slow_mode or not block):
            break
    if slow_mode:
        # re-parse the remaining text with the tolerant parser
        yield from _batches_from_reads(
            _reads_from_text(tail.decode("ascii", "replace"), fn, fp),
            batch_reads,
        )
    if owns:
        fp.close()


def _reads_from_text(text: str, fn, fp) -> Iterator[slow_io.Read]:
    """Re-parse the unconsumed tail + the rest of the stream with the
    tolerant parser, streaming (no temp file, no whole-file slurp)."""

    def lines():
        carry = text
        while True:
            block = fp.read(_BLOCK)
            if not block:
                break
            carry += block.decode("ascii", "replace")
            parts = carry.split("\n")
            carry = parts.pop()  # last (possibly partial) line
            for p in parts:
                yield p + "\n"
        for p in carry.split("\n"):
            if p:
                yield p + "\n"

    yield from slow_io.read_fastx(lines())


def _iter_batches_slow(fn, batch_reads: int) -> Iterator[ReadBatch]:
    yield from _batches_from_reads(slow_io.read_fastx(fn), batch_reads)


def _batches_from_reads(reads, batch_reads: int) -> Iterator[ReadBatch]:
    from ..ops.kmer import encode_batch

    pending: List[slow_io.Read] = []

    def make(pending):
        bases, _, lens = encode_batch([r.seq for r in pending], None, 0)
        L = bases.shape[1] if bases.size else 1
        quals = np.zeros((len(pending), L), np.uint8)
        for i, r in enumerate(pending):
            if r.qual is not None:
                quals[i, : len(r.qual)] = np.frombuffer(
                    r.qual.encode("ascii"), np.uint8
                )
        return ReadBatch(
            len(pending), bases, quals, lens, b"", None, None, None, None,
            None, None, strings=list(pending),
        )

    for r in reads:
        pending.append(r)
        if len(pending) >= batch_reads:
            yield make(pending)
            pending = []
    if pending:
        yield make(pending)
