"""Device-resident spectrum build: the counting pass.

Streams FASTQ chunks through the vectorized k-mer pipeline
(ops.kmer.kmer_stream), maintains a running per-distinct-k-mer
aggregate via sort/merge (ops.spectrum), and finalizes into the
reference-exact count table with Bloom first-occurrence adjudication.

Replaces the reference counting pass (/root/reference/count.c:127-157)
under sequential-order semantics (== bfc -t1).
"""

from __future__ import annotations

import struct
from typing import Iterable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..io.fastq import read_fastx
from ..opts import Opts
from ..ops import kmer as kops
from ..ops import spectrum as spec
from ..utils.log import log

# process-global merge-executable cache + background compile pool (see
# AggBuilder: .lower().compile() bypasses the jit cache, so executables
# must outlive individual builders for warm-up passes to be effective)
_MERGE_EXE: dict = {}
_MERGE_POOL = None

# tail anatomy of the most recent counting pass (seconds), for bench.py
# and regression tracking: {"tree_finish", "adjudicate", "table"}
TAIL_TIMINGS: dict = {}


def await_merge_ladder() -> None:
    """Block until every in-flight background merge compile has landed
    (warm-up helper: keeps ladder compiles out of timed/streamed regions).
    A failed speculative compile (e.g. a ladder cap whose merge program
    exceeds device memory) is dropped, not raised: the cap may never be
    reached, and if it is, the on-demand compile reports the real error."""
    for key, exe in list(_MERGE_EXE.items()):
        if hasattr(exe, "result"):
            try:
                _MERGE_EXE[key] = exe.result()
            except Exception as e:
                log(f"ladder compile cap={key[0]} failed ({type(e).__name__}); "
                    "dropped", func="AggBuilder")
                del _MERGE_EXE[key]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class DeviceSpectrum:
    """Finalized spectrum: flat lookup table + metadata (device arrays)."""

    def __init__(self, table, k: int, l_pre: int, s_bits: int,
                 n_entries: int, hist: np.ndarray, hist_high: np.ndarray,
                 mode: int,
                 compact: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
                 packed: bool = False):
        self.table = table
        self.k = k
        self.l_pre = l_pre
        self.kb_bits = kops.keybody_bits(k, l_pre)
        self.s_bits = s_bits
        self.n_entries = n_entries
        self.hist = hist
        self.hist_high = hist_high
        self.mode = mode
        self.packed = packed
        self._compact = compact  # host (shard, keybody, payload) sorted arrays

    def lookup_hash(self, h0, h1):
        """Batched payload lookup from canonical-hash pairs (u64 arrays)."""
        q_shard, q_kb = kops.shard_and_keybody(h0, h1, self.k, self.l_pre)
        if isinstance(self.table, spec.CuckooTable):
            return spec.cuckoo_lookup(
                self.table, q_shard, q_kb, self.s_bits, self.l_pre, self.kb_bits
            )
        if self.packed:
            return spec.packed_lookup(
                self.table, q_shard, q_kb, self.s_bits, self.l_pre, self.kb_bits
            )
        return spec.table_lookup(
            self.table, q_shard, q_kb, self.s_bits, self.l_pre, self.kb_bits
        )

    # -- host-side helpers (tests, dump) ------------------------------------

    def compact_entries(self):
        if callable(self._compact):
            # lazy host copy (sharded human-scale tables never gather
            # unless a dump/test explicitly asks)
            self._compact = self._compact()
        assert self._compact is not None
        return self._compact

    def dump(self, fn: str) -> None:
        """Write the bfc -d binary dump format (htab.c:129-146)."""
        shard, keybody, payload = self.compact_entries()
        keys = (keybody.astype(np.uint64) << np.uint64(14)) | payload.astype(np.uint64)
        with open(fn, "wb") as f:
            f.write(struct.pack("<II", self.k, self.l_pre))
            counts = np.bincount(shard, minlength=1 << self.l_pre)
            offs = np.concatenate([[0], np.cumsum(counts)])
            for s in range(1 << self.l_pre):
                sz = int(counts[s])
                f.write(struct.pack("<II", _kh_n_buckets(sz), sz))
                if sz:
                    f.write(keys[offs[s] : offs[s + 1]].tobytes())


def _kh_n_buckets(size: int) -> int:
    if size == 0:
        return 0
    need = int(size / 0.77 + 0.5) + 1
    n = 4
    while n < need:
        n <<= 1
    return n


def _spectrum_from_sorted(shard: np.ndarray, keybody: np.ndarray,
                          payload: np.ndarray, k: int, l_pre: int,
                          c_bits_hint: int = 0) -> DeviceSpectrum:
    """Build a DeviceSpectrum from host-sorted compact entries.

    c_bits_hint (from Opts.predicted_c_bits) rounds the cuckoo table UP
    to a size knowable before counting ran, so a cold-start prewarm
    compiled against the predicted shape hits the jit cache; a bigger
    table never changes lookups, only its HBM footprint."""
    from ..ops import spectrum_host as sph

    n = len(shard)
    s_bits = max(8, int(np.ceil(np.log2(max(n, 1) * 2 + 1))))
    margin = 4096
    kb_bits = kops.keybody_bits(k, l_pre)
    # prefer the two-choice cuckoo layout: every lookup is exactly two
    # single-element gathers with no continuation round (the lookup
    # gather is the dominant per-iteration cost of the search)
    c_bits = max(8, int(np.ceil(np.log2(max(n, 1) * 2.5 + 1))), c_bits_hint)
    if spec.cuckoo_ok(c_bits, l_pre, kb_bits):
        entries, ok = sph.build_cuckoo_table_host(
            shard.astype(np.uint32), keybody.astype(np.uint64),
            payload.astype(np.uint32), c_bits, l_pre, kb_bits,
        )
        if ok:
            table = spec.cuckoo_from_u64(entries)
            hist = np.bincount(np.minimum(payload & 0xFF, 255), minlength=256)[:256]
            hist[0] = 0
            hist_high = np.bincount((payload >> 8) & 0x3F, minlength=64)[:64]
            return DeviceSpectrum(table, k, l_pre, c_bits, n, hist, hist_high,
                                  _mode_from_hist(hist),
                                  compact=(shard, keybody, payload), packed=False)
    # fall back: packed single-u64-entry displacement layout; then the
    # two-array layout when the identity does not fit (big k, small table)
    packed = spec.packed_ok(s_bits, l_pre, kb_bits)
    if packed:
        entries, max_slot = sph.build_packed_table_host(
            shard.astype(np.uint32), keybody.astype(np.uint64),
            payload.astype(np.uint32), s_bits, margin, l_pre, kb_bits,
        )
        table = spec.PackedTable(entries=jnp.asarray(entries))
    else:
        tab_kbp, tab_shard, max_slot = sph.build_table_host(
            shard.astype(np.uint32), keybody.astype(np.uint64),
            payload.astype(np.uint32), s_bits, margin, l_pre, kb_bits,
        )
        table = spec.Table(kb_payload=jnp.asarray(tab_kbp), shard=jnp.asarray(tab_shard))
    assert int(max_slot) <= (1 << s_bits) + margin - 2
    hist = np.bincount(np.minimum(payload & 0xFF, 255), minlength=256)[:256]
    hist[0] = 0
    hist_high = np.bincount((payload >> 8) & 0x3F, minlength=64)[:64]
    mode = _mode_from_hist(hist)
    return DeviceSpectrum(table, k, l_pre, s_bits, n, hist, hist_high, mode,
                          compact=(shard, keybody, payload), packed=packed)


def _mode_from_hist(hist: np.ndarray) -> int:
    best, mode = 0, -1
    for i in range(3, 256):
        if hist[i] > best:
            best, mode = int(hist[i]), i
    return mode


def restore_spectrum(fn: str) -> DeviceSpectrum:
    """Load a bfc -r dump into a DeviceSpectrum (htab.c:151-176)."""
    with open(fn, "rb") as f:
        k, l_pre = struct.unpack("<II", f.read(8))
        shards: List[np.ndarray] = []
        sharding: List[np.ndarray] = []
        for s in range(1 << l_pre):
            _, sz = struct.unpack("<II", f.read(8))
            keys = np.frombuffer(f.read(8 * sz), dtype=np.uint64)
            shards.append(keys)
            sharding.append(np.full((sz,), s, np.uint32))
    keys = np.concatenate(shards) if shards else np.zeros((0,), np.uint64)
    shard = np.concatenate(sharding) if sharding else np.zeros((0,), np.uint32)
    keybody = keys >> np.uint64(14)
    payload = (keys & np.uint64(0x3FFF)).astype(np.uint32)
    order = np.lexsort((keybody, shard))
    return _spectrum_from_sorted(shard[order], keybody[order], payload[order], k, l_pre)


# ---------------------------------------------------------------------------
# Streaming counting driver
# ---------------------------------------------------------------------------

class AggBuilder:
    """Incremental per-distinct-k-mer aggregation over padded batches.

    DEVICE-resident binary-counter merge tree: each add() runs ONE
    fixed-shape dense pass (sort + segmented combine + compaction,
    spectrum_dense.chunk_run), then folds the PREVIOUS batch's run into
    the tree with device merges (spectrum_dense.merge_runs) - level i
    holds 2^i merged batches, so total merge work is
    O(distinct * log batches), entirely on device.  The aggregate
    crosses the device->host boundary once, in finish() (or span by
    span when it outgrows the merge cap and spills).  Deferring each
    fold by one batch keeps a chunk in flight (the reference's
    kt_pipeline overlap, kthread.c:118-146).  Arrival order
    across add() calls must be the stream order."""

    def __init__(self, opt: Opts):
        import os

        from ..ops import spectrum_dense as sdn

        self.sdn = sdn
        self.opt = opt
        self.k = opt.k
        self.l_pre = opt.effective_l_pre()
        self.n_id, self.n_planes, _ = sdn.run_layout(self.k, self.l_pre)
        self.arrival_base = 0
        self._pending = None     # (device run planes at full cap, device count)
        self.n_batches = 0
        # LSM-style host spill: when the device counter would merge past
        # this cap it drains COMPLETELY into the host counter (so every
        # spill is the next contiguous stream span - merge_host_aggs'
        # ordering contract holds) and restarts empty.  The 2^22 value
        # predates the GPU port and has not been tuned on the H100
        # (ROADMAP S4).
        self.max_dev_cap = int(
            os.environ.get("BFC_MAX_MERGE_CAP", str(1 << 22))
        )
        # asymmetric top-of-tree merges let ONE run grow to twice the
        # equal-merge cap before the tree spills (same provenance as
        # max_dev_cap: not tuned on the H100).  0 disables.
        self.max_top_cap = int(
            os.environ.get("BFC_MAX_TOP_CAP",
                           str(self.max_dev_cap * 2))
        )
        from ..ops import spectrum_host as sph
        from ..ops.lsm import LsmTree

        kb_bits = kops.keybody_bits(self.k, self.l_pre)
        # eager spill: a run whose row count exceeds the device merge
        # cap can never device-merge again (the next merge attempt
        # would spill it anyway) - spill it the moment it forms, so its
        # pull and host merge overlap the still-running stream instead
        # of landing in the finish tail
        eager = os.environ.get("BFC_EAGER_SPILL", "1") == "1"
        # eager threshold: rows above which a run is spilled mid-stream;
        # lowering it moves more pull/merge work off the finish tail and
        # onto the overlapped spill worker at the price of more total
        # host merge work.  Default = the device cap (only runs that can
        # NEVER device-merge again spill early).
        eager_min = int(os.environ.get(
            "BFC_EAGER_MIN",
            str(max(self.max_dev_cap, self.max_top_cap))))
        # incremental adjudication: per-Bloom-bit min-arrival folded in
        # span-by-span on the spill worker (spectrum_host.BloomMinSketch)
        # so finalize's verdict is a gather, not a sort of every probe
        self._sketch = sph.BloomMinSketch.create(opt.bf_shift, opt.n_hashes)
        self.tree = LsmTree(
            merge=self._merge_bounded,
            to_host=self._run_to_host,
            host_merge=lambda a, b: sph.merge_host_aggs(
                a, b, l_pre=self.l_pre, kb_bits=kb_bits),
            async_spill=True,  # plain pulls + numpy merges: thread-safe
            name="AggBuilder",
            size=lambda run: run[1],
            eager_min=eager_min if eager else 0,
            prep=self._scatter_sketch,  # merge-worker: overlaps pulls
            eager_min_after=self.max_dev_cap if eager else 0,
        )
        # merge-executable cache: the cap ladder (cap0, 2*cap0, ...) is
        # compiled ahead of need in background threads, so the growing
        # aggregate never stalls the stream on a fresh merge compile.
        # The cache is PROCESS-GLOBAL (keyed by cap and plane layout):
        # .lower().compile() bypasses the jit cache, so a per-instance
        # dict would recompile the whole ladder for every builder - a
        # warm-up pass (bench.py) must be able to pay it once

    def add(self, bases, qok, lens) -> None:
        B, L = bases.shape
        planes, g = self.sdn.chunk_run(
            jnp.asarray(bases), jnp.asarray(qok), jnp.asarray(lens),
            jnp.uint64(self.arrival_base), self.k, self.l_pre,
        )
        self.arrival_base += B * L
        prev = self._pending
        self._pending = (planes, g)
        if prev is not None:
            self._fold(prev)

    @staticmethod
    def _bucket(n: int) -> int:
        # one merge-jit shape per power of two
        return 1 << max(10, (max(n, 1) - 1).bit_length())

    def _slice(self, planes, g):
        gi = int(g)
        cap = self._bucket(gi)
        return [p[:cap] for p in planes], gi

    def _key(self, cap: int):
        return (cap, self.n_planes, self.n_id)

    def _merge_compiled(self, cap: int):
        """The merge executable for capacity cap (compile if absent)."""
        exe = _MERGE_EXE.get(self._key(cap))
        if exe is None:
            exe = self._compile_cap(cap)
            _MERGE_EXE[self._key(cap)] = exe
        elif hasattr(exe, "result"):  # in-flight background compile
            try:
                exe = exe.result()
            except Exception:
                # speculative compile failed; retry in the foreground so
                # a genuinely-needed cap reports its real error
                exe = self._compile_cap(cap)
            _MERGE_EXE[self._key(cap)] = exe
        return exe

    def _prefetch_ladder(self, cap0: int, steps: int = 7) -> None:
        """Background-compile merges for caps cap0 .. cap0 << steps.

        Speculative caps stop at self.max_dev_cap (BFC_MAX_MERGE_CAP);
        past the cap the builder LSM-spills to the host tree."""
        global _MERGE_POOL
        import os
        from concurrent.futures import ThreadPoolExecutor

        if jax.default_backend() == "cpu":
            # CPU compiles are fast and on-demand; a background compile
            # racing a foreground one can abort XLA-CPU (observed in the
            # test suite).  The ladder is an accelerator-compile-latency
            # tool.
            return
        max_cap = self.max_dev_cap
        if _MERGE_POOL is None:
            _MERGE_POOL = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="bfc-merge-compile"
            )
        for i in range(steps + 1):
            cap = cap0 << i
            if cap > max_cap:
                break
            if self._key(cap) not in _MERGE_EXE:
                _MERGE_EXE[self._key(cap)] = _MERGE_POOL.submit(
                    lambda c=cap: self._compile_cap(c)
                )
        # asym top merges: (top_cap, cap0 .. max_dev_cap)
        top = self.max_top_cap
        if top > max_cap:
            for i in range(steps + 1):
                cap = cap0 << i
                if cap > max_cap:
                    break
                if self._key_asym(top, cap) not in _MERGE_EXE:
                    _MERGE_EXE[self._key_asym(top, cap)] = _MERGE_POOL.submit(
                        lambda a=top, b=cap: self._compile_asym(a, b)
                    )

    def _compile_cap(self, cap: int):
        import jax

        spec = [jax.ShapeDtypeStruct((cap,), jnp.uint32)] * self.n_planes
        return self.sdn.merge_runs.lower(spec, spec, n_id=self.n_id).compile()

    def _key_asym(self, ca: int, cb: int):
        return ("asym", ca, cb, self.n_planes, self.n_id)

    def _compile_asym(self, ca: int, cb: int):
        import jax

        sa = [jax.ShapeDtypeStruct((ca,), jnp.uint32)] * self.n_planes
        sb = [jax.ShapeDtypeStruct((cb,), jnp.uint32)] * self.n_planes
        return self.sdn.merge_runs.lower(sa, sb, n_id=self.n_id).compile()

    def _merge_asym(self, a, b):
        """Unequal-capacity merge (older span a first) at the runs' OWN
        capacities (spectrum_dense.merge_runs)."""
        import time

        pa, ca_n = a
        pb, cb_n = b
        ca, cb = pa[0].shape[0], pb[0].shape[0]
        key = self._key_asym(ca, cb)
        exe = _MERGE_EXE.get(key)
        if exe is None:
            exe = self._compile_asym(ca, cb)
            _MERGE_EXE[key] = exe
        elif hasattr(exe, "result"):
            try:
                exe = exe.result()
            except Exception:
                exe = self._compile_asym(ca, cb)
            _MERGE_EXE[key] = exe
        t0 = time.time()
        planes, g = exe(list(pa), list(pb))
        out = self._slice(planes, g)
        import os

        if os.environ.get("BFC_COUNT_DEBUG"):
            log(f"asym merge ({ca},{cb}) ca={ca_n} cb={cb_n} -> {out[1]} "
                f"in {time.time() - t0:.2f}s", func="AggBuilder")
        return out

    await_ladder = staticmethod(await_merge_ladder)

    def _merge_bounded(self, a, b):
        """LsmTree merge callback: None when the merge would exceed the
        per-device merge cap (the tree then spills to the host counter)."""
        ca, cb = a[0][0].shape[0], b[0][0].shape[0]
        big, small = max(ca, cb), min(ca, cb)
        if big <= self.max_dev_cap:
            return self._merge(a, b)
        if big <= self.max_top_cap and small <= self.max_dev_cap:
            return self._merge_asym(a, b)
        return None

    def _merge(self, a, b):
        """Merge two (planes, count) runs; a must be the earlier span."""
        import os
        import time

        pa, ca = a
        pb, cb = b
        cap = max(pa[0].shape[0], pb[0].shape[0])
        t0 = time.time()
        planes, g = self._merge_compiled(cap)(
            self.sdn.pad_run(pa, cap), self.sdn.pad_run(pb, cap)
        )
        out = self._slice(planes, g)
        if os.environ.get("BFC_COUNT_DEBUG"):
            log(f"merge cap={cap} ca={ca} cb={cb} -> {out[1]} "
                f"in {time.time() - t0:.2f}s", func="AggBuilder")
        return out

    def _pull_run(self, planes, cnt):
        """Device run -> host planes with async-first transfers.

        The first_arr high-u32 plane is identically zero while the
        stream holds < 2^32 bases (arrival_base is a host-side running
        total, so this is exact at pull time) - skip its transfer and
        substitute zeros: one less plane to pull (~17% of the final-pull
        bytes in the common case)."""
        skip = self.n_id if self.arrival_base <= 0xFFFFFFFF else -1
        sliced = [p[:cnt] for p in planes]
        wait = [p for i, p in enumerate(sliced) if i != skip]
        jax.block_until_ready(wait)
        for p in wait:
            try:
                p.copy_to_host_async()
            except Exception:
                break
        return [
            np.zeros((cnt,), np.uint32) if i == skip else np.asarray(p)
            for i, p in enumerate(sliced)
        ]

    def _run_to_host(self, run):
        """Pull a device run to a HostAgg (async-first plane transfers).

        The packed layout (pack_pull) folds (arr_hi, n, nhfh) into one
        u32 plane - ~20-30% fewer bytes to pull, payload-exact
        (saturation thresholds sit above every payload cap).  Falls
        back to the unpacked pull past 2^47 stream bases."""
        planes, cnt = run
        if self.arrival_base < (1 << 47):
            packed = self.sdn.pack_pull(tuple(planes), n_id=self.n_id)
            sliced = [p[:cnt] for p in packed]
            jax.block_until_ready(sliced)
            for p in sliced:
                try:
                    p.copy_to_host_async()
                except Exception:
                    break
            ha = self.sdn.packed_run_to_host_agg(
                [np.asarray(p) for p in sliced], cnt, self.k, self.l_pre
            )
        else:
            ha = self.sdn.run_to_host_agg(
                self._pull_run(planes, cnt), cnt, self.k, self.l_pre
            )
        return ha

    def _scatter_sketch(self, ha) -> None:
        """Fold one spilled span's per-bit min arrivals into the sketch.

        Every aggregate row crosses device->host through _run_to_host
        exactly once (LSM spills and the final pull), so the sketch sees
        each span-local first_arr exactly once; min over spans == the
        global first arrival, which is all the verdict needs.  Runs on
        the niced pull worker for spills (overlapping the stream)."""
        sk = self._sketch
        if sk is None or not sk.valid:
            return
        ret = ha.ret
        if ret is None:
            ret = self.sdn.derive_ret_np(
                np.asarray(ha.shard), np.asarray(ha.keybody, dtype=np.uint64),
                self.k, self.l_pre,
            )
        sk.scatter(np.asarray(ret), np.asarray(ha.first_arr))

    def _fold(self, pending) -> None:
        import os
        import time

        t0 = time.time()
        run = self._slice(*pending)
        if os.environ.get("BFC_COUNT_DEBUG"):
            log(f"chunk wait {time.time() - t0:.2f}s", func="AggBuilder")
        gi = run[1]
        if self.n_batches == 0:
            self._prefetch_ladder(self._bucket(gi))
        self.tree.push(run)
        self.n_batches += 1
        log(f"aggregated batch {self.n_batches}: {gi} distinct in chunk",
            func="AggBuilder")

    def _ensure_ret(self, ha):
        """Materialize the derivable ret column once, at the very end:
        the host merge chain never carried it (HostAgg.ret is None for
        derivable configs), but every finalize consumer expects it."""
        if ha is not None and ha.ret is None:
            ha = ha._replace(ret=self.sdn.derive_ret_np(
                np.asarray(ha.shard), np.asarray(ha.keybody, dtype=np.uint64),
                self.k, self.l_pre,
            ))
        return ha

    def finish(self):
        import time

        from ..ops import spectrum_host as sph

        if self._pending is not None:
            self._fold(self._pending)
            self._pending = None
        t0 = time.time()
        acc, hacc = self.tree.finish()
        hacc = self._ensure_ret(hacc)
        TAIL_TIMINGS["tree_finish"] = round(time.time() - t0, 2)
        TAIL_TIMINGS["lsm"] = dict(self.tree.timings)  # cumulative anatomy
        TAIL_TIMINGS["spills"] = self.tree.n_spills
        log(f"counting tree finish: {time.time() - t0:.1f}s",
            func="AggBuilder")
        # the compile pool and executable cache are process-global and
        # deliberately survive this builder: a warm-up pass's ladder
        # compiles must be reusable by the next stream
        if hacc is not None:
            log(f"{len(hacc.shard)} distinct k-mers aggregated (host tree)",
                func="AggBuilder")
            return self._attach_sketch(hacc)
        if acc is None:
            return self._attach_sketch(sph.empty_host_agg())
        planes, count = acc
        log(f"{count} distinct k-mers aggregated", func="AggBuilder")
        import os

        if os.environ.get("BFC_DEVICE_FINALIZE", "0") == "1":
            # keep the aggregate on device and finalize there (device
            # vs host finalize is not yet measured on the H100: ROADMAP
            # S3)
            return self.sdn.run_to_aggregate(
                tuple(planes), self.k, self.l_pre
            )
        # the single device->host pull of the whole counting pass
        # (packed layout; see _run_to_host); the sketch fold normally
        # rides the spill worker (LsmTree.prep) - this direct pull must
        # fold it explicitly
        ha = self._run_to_host((planes, count))
        self._scatter_sketch(ha)
        return self._attach_sketch(self._ensure_ret(ha))

    def _attach_sketch(self, ha):
        """Ride the converged sketch out on the final aggregate so
        finalize_spectrum's verdict can gather instead of sort."""
        if self._sketch is not None and self._sketch.valid:
            ha = ha._replace(bloom_min=self._sketch)
        return ha


def count_stream_aggregate(
    read_iter: Iterable[Tuple[str, Optional[str]]],
    opt: Opts,
    batch_reads: int = 4096,
):
    """Stream (seq, qual) pairs into the per-distinct-k-mer aggregate.

    Returns (aggregate, n_reads); shared by the normal counting pass and
    the filter-mode Bloom build."""
    builder = AggBuilder(opt)
    pending: List[Tuple[str, Optional[str]]] = []
    n_reads = 0
    pad_L = [0]  # sticky shape buckets: one compile per run in the common case

    def flush(pending):
        seqs = [p[0] for p in pending]
        quals = [p[1] for p in pending]
        if all(q is None for q in quals):
            quals = None
        pad_L[0] = max(pad_L[0], _round_up(max(len(s) for s in seqs), 32))
        B = batch_reads  # always the full batch: the tail is padded, not reshaped
        seqs = seqs + [""] * (B - len(seqs))
        if quals is not None:
            quals = quals + [""] * (B - len(quals))
        bases, qok, lens = kops.encode_batch(seqs, quals, opt.q, pad_to=pad_L[0])
        builder.add(bases, qok, lens)

    for seq, qual in read_iter:
        pending.append((seq, qual))
        n_reads += 1
        if len(pending) >= batch_reads:
            flush(pending)
            pending = []
    if pending:
        flush(pending)
    return builder.finish(), n_reads


def count_batches_aggregate(fn: str, opt: Opts, batch_reads: int = 8192):
    """Aggregate a FASTQ file via the native batched reader (hot path)."""
    from ..io import fast_reader as FR

    builder = AggBuilder(opt)
    n_reads = 0
    pad_L = [0]
    for rb in FR.iter_batches_prefetch(fn, batch_reads, max_bases=opt.chunk_size):
        n = rb.n
        n_reads += n
        lens0 = rb.lens
        pad_L[0] = max(pad_L[0], _round_up(int(lens0.max()) if n else 1, 32))
        L = pad_L[0]
        B = batch_reads
        Lc = min(L, rb.bases.shape[1])
        bases = np.full((B, L), 4, np.uint8)
        bases[:n, :Lc] = rb.bases[:, :Lc]
        lens = np.zeros((B,), np.int32)
        lens[:n] = lens0
        qok = np.zeros((B, L), bool)
        has_q = rb.has_qual()
        inb = np.arange(Lc)[None, :] < lens0[:, None]
        qok[:n, :Lc] = np.where(
            has_q[:, None],
            rb.quals[:, :Lc].astype(np.int32) - 33 >= opt.q,
            inb,
        )
        builder.add(bases, qok, lens)
    return builder.finish(), n_reads


def count_stream(
    read_iter: Iterable[Tuple[str, Optional[str]]],
    opt: Opts,
    batch_reads: int = 4096,
) -> DeviceSpectrum:
    """Counting pass over (seq, qual) pairs in stream order."""
    agg, n_reads = count_stream_aggregate(read_iter, opt, batch_reads=batch_reads)
    log(f"processed {n_reads} sequences")
    return finalize_spectrum(agg, opt)


def finalize_spectrum(agg, opt: Opts, host: bool = None) -> DeviceSpectrum:
    """Adjudicate + payloads + lookup-table build from an aggregate
    (spectrum_host.HostAgg from AggBuilder, or a padded device
    spec.Aggregate from the mesh path - the fields are dtype twins).

    By default finalization runs on the host (numpy twin in
    ops.spectrum_host): it happens once per job, and its one-time
    device compile is far more expensive than the computation.  Set
    BFC_DEVICE_FINALIZE=1 (or host=False) to keep it on device."""
    import os

    if host is None:
        if isinstance(agg, spec.Aggregate):
            # a device aggregate (the mesh path, or AggBuilder under
            # BFC_DEVICE_FINALIZE=1): finalize where it already lives
            host = False
        else:
            host = os.environ.get("BFC_DEVICE_FINALIZE", "0") != "1"
    k = opt.k
    l_pre = opt.effective_l_pre()
    if host:
        import time

        from ..ops import spectrum_host as sph

        t0 = time.time()
        shard_c, keybody_c, payload_c, hist, hist_high = sph.finalize_host(
            agg, opt.bf_shift, opt.n_hashes, k=k, l_pre=l_pre
        )
        t1 = time.time()
        ds = _spectrum_from_sorted(shard_c, keybody_c, payload_c, k, l_pre,
                                   c_bits_hint=opt.predicted_c_bits())
        TAIL_TIMINGS["adjudicate"] = round(t1 - t0, 2)
        TAIL_TIMINGS["table"] = round(time.time() - t1, 2)
        log(f"# distinct k-mers in table: {len(shard_c)} "
            f"(adjudicate {t1 - t0:.1f}s, table {time.time() - t1:.1f}s)")
        return ds
    if getattr(agg, "bloom_min", None) is not None:
        # the sketch is a host object, not a pytree leaf: strip it
        # before the jitted device finalize
        agg = agg._replace(bloom_min=None)
    import time as _time

    t0 = _time.time()
    # adjudicate: sort-free sketch whenever every first arrival fits
    # u32 (checked against the aggregate itself - a tiny reduce).  The
    # sort-based path stays for the over-u32 case, but streams that big
    # spill to the host tree and finalize there anyway.
    valid_a = agg.shard != spec.INVALID_SHARD
    arr_max = int(jnp.max(jnp.where(valid_a, agg.first_arr, 0)))
    TAIL_TIMINGS["dev_fin"] = _dt = {}
    _dt["agg_sync"] = round(_time.time() - t0, 2)
    _t1 = _time.time()
    if arr_max < 0xFFFFFFFF:
        fp = spec.adjudicate_sketch(agg, opt.bf_shift, opt.n_hashes)
    else:
        fp = spec.adjudicate_first_occurrence(agg, opt.bf_shift,
                                              opt.n_hashes)
    jax.block_until_ready(fp)
    _dt["sketch"] = round(_time.time() - _t1, 2)
    _t1 = _time.time()
    (shard, keybody, payload, keep, hist,
     hist_high) = spec.finalize_counts_fp(agg, fp)
    jax.block_until_ready(payload)
    _dt["fp"] = round(_time.time() - _t1, 2)
    _t1 = _time.time()
    kb_bits = kops.keybody_bits(k, l_pre)
    # preferred layout: cuckoo, built ON DEVICE.  c_bits is static from
    # the padded capacity (>= the host build's exact-n sizing; a bigger
    # table never changes lookups, only HBM) so the program compiles
    # once per capacity bucket.
    # C is the padded capacity (a power of two >= kept n): 4*C slots
    # keep the worst-case cuckoo load factor <= 0.25, and the device
    # capacity is bounded by the merge cap so the table never exceeds
    # ~2 x 128 MB planes (human-scale aggregates take the spill + host
    # path with exact-n sizing)
    C = int(shard.shape[0])
    c_bits = max(8, C.bit_length() + 1, opt.predicted_c_bits())
    if spec.cuckoo_ok(c_bits, l_pre, kb_bits):
        lo, hi, ok = spec.cuckoo_build_device(
            shard, keybody, payload, c_bits, l_pre, kb_bits
        )
        n = int(jnp.sum(keep))
        _dt["build"] = round(_time.time() - _t1, 2)
        if bool(ok):
            table = spec.CuckooTable(lo=lo, hi=hi)
            hist_np = np.asarray(hist)
            hh_np = np.asarray(hist_high)
            t1 = _time.time()
            TAIL_TIMINGS["adjudicate"] = round(t1 - t0, 2)
            TAIL_TIMINGS["table"] = 0.0

            def _pull_compact(shard=shard, keybody=keybody,
                              payload=payload, keep=keep):
                # lazy host copy for dump/tests: entries are already
                # (shard, keybody)-sorted in the run
                kp = np.asarray(keep)
                sel = np.flatnonzero(kp)
                return (np.asarray(shard)[sel],
                        np.asarray(keybody)[sel],
                        np.asarray(payload)[sel].astype(np.uint32))

            log(f"# distinct k-mers in table: {n} "
                f"(device finalize {t1 - t0:.1f}s, c_bits {c_bits})")
            return DeviceSpectrum(
                table, k, l_pre, c_bits, n, hist_np, hh_np,
                _mode_from_hist(hist_np), compact=_pull_compact,
                packed=False,
            )
        log(f"device cuckoo placement failed at c_bits {c_bits}; "
            "falling back to the displacement build")
    n = int(jnp.sum(keep))
    s_bits = max(8, int(np.ceil(np.log2(n * 2 + 1))))
    margin = 4096
    table, n_dev, max_slot = spec.build_table(
        shard, keybody, payload, keep, s_bits, margin, l_pre, kb_bits
    )
    assert int(max_slot) <= (1 << s_bits) + margin - 2, "table displacement overflow"
    hist = np.asarray(hist)
    hist_high = np.asarray(hist_high)
    mode = _mode_from_hist(hist)
    log(f"# distinct k-mers in table: {n}")
    # host compact copy for dump/tests
    keep_np = np.asarray(keep)
    order = np.argsort(~keep_np, kind="stable")[:n]
    compact = (
        np.asarray(shard)[order],
        np.asarray(keybody)[order],
        np.asarray(payload)[order].astype(np.uint32),
    )
    return DeviceSpectrum(table, k, l_pre, s_bits, n, hist, hist_high, mode,
                          compact=compact, packed=False)


def count_file_device(fn: str, opt: Opts, batch_reads: int = 8192) -> DeviceSpectrum:
    """Counting pass over a FASTQ file (native batched reader)."""
    agg, n_reads = count_batches_aggregate(fn, opt, batch_reads=batch_reads)
    log(f"processed {n_reads} sequences")
    return finalize_spectrum(agg, opt)
