"""End-to-end device pipeline: count -> correct/trim -> formatted output.

The device analogue of the scalar models.pipeline, mirroring main() of
the reference CLI (/root/reference/bfc.c:126-150).  Reads stream through
the device corrector in batches; output records are emitted in input
order (the reference's kt_pipeline ordering guarantee).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..io.fastq import Read, format_corrected, pack_stats, read_fastx
from ..opts import Opts
from ..utils.log import log
from . import refmodel as M
from .corrector import Corrector
from .counter import DeviceSpectrum, count_file_device, restore_spectrum
from .pipeline import parse_stats
from .trimmer import DeviceBloom, Trimmer, count_file_filter_device


def correct_file_device(fn: str, opt: Opts, ds: DeviceSpectrum,
                        out: List[str], batch_reads: int = 8192,
                        mesh=None) -> None:
    from ..io import fast_reader as FR

    import numpy as np

    corr = Corrector(opt, ds, mesh=mesh)
    n_done = 0
    WINDOW = 4  # batches per difficulty-bucketing window

    def process_window(rbs):
        nonlocal n_done
        ns = [rb.n for rb in rbs]
        offs = np.concatenate([[0], np.cumsum(ns)]).astype(int)
        total = int(offs[-1])
        Lm = max(rb.bases.shape[1] for rb in rbs)
        bases = np.full((total, Lm), 4, np.uint8)
        rawq = np.zeros((total, Lm), np.uint8)
        lens = np.zeros((total,), np.int32)
        has_q = np.zeros((total,), bool)
        for w, rb in enumerate(rbs):
            Lr = rb.bases.shape[1]
            bases[offs[w]:offs[w + 1], :Lr] = rb.bases
            rawq[offs[w]:offs[w + 1], :Lr] = rb.quals
            lens[offs[w]:offs[w + 1]] = rb.lens
            has_q[offs[w]:offs[w + 1]] = rb.has_qual()

        def text_of(i):
            w = int(np.searchsorted(offs, i, side="right")) - 1
            return rbs[w].seq(i - int(offs[w])), rbs[w].qual(i - int(offs[w]))

        res = corr.correct_many(bases, rawq, lens, has_q, text_of, batch_reads,
                                as_arrays=True)
        import jax

        H = jax.process_count()
        if H > 1 and res is not None and not isinstance(res, list):
            # multi-host emit scaling: every host FORMATS a contiguous
            # slice of the window (the expensive per-record text work),
            # then rank 0 stitches the byte segments in host order -
            # the reference's ordered single writer (kthread.c:92-101)
            # with the formatting fanned out across hosts
            from ..io.writer import OutputWriter
            from ..parallel.multihost import gather_segments

            pid = jax.process_index()
            lo = total * pid // H
            hi = total * (pid + 1) // H
            seg = OutputWriter(None)
            i0 = 0
            for rb in rbs:
                a = max(lo - i0, 0)
                b = min(hi - i0, rb.n)
                if b > a and not _emit_rb_native(rb, i0, res, opt, seg,
                                                 a, b):
                    _emit_rb_python(rb, i0, res, opt, seg, a, b)
                i0 += rb.n
            for sb in gather_segments(seg.getbytes()):
                out.write_bytes(sb)  # rank 0 writes; others got []
        else:
            i0 = 0
            for rb in rbs:
                if res is None or isinstance(res, list):
                    _emit_rb_python(rb, i0, res, opt, out)
                elif not _emit_rb_native(rb, i0, res, opt, out):
                    _emit_rb_python(rb, i0, res, opt, out)
                i0 += rb.n
        n_done += total
        log(f"processed {n_done} sequences", func="correct_file_device")

    buf = []
    # refine-mode carry-over of the last parsed ec:Z stats across the whole
    # stream (the reference's calloc-zeroed per-thread ori_st under -t1)
    refine_carry = [M.EcStat(ec_code=0)]
    comments = FR.CommentCarry()
    for rb in FR.iter_batches_prefetch(fn, batch_reads, max_bases=opt.chunk_size):
        if opt.refine_ec:
            _refine_batch(rb, opt, corr, out, refine_carry, comments)
            n_done += rb.n
            log(f"processed {n_done} sequences", func="correct_file_device")
            continue
        buf.append(rb)
        if len(buf) >= WINDOW:
            process_window(buf)
            buf = []
    if buf:
        process_window(buf)
    log(f"{corr.n_scalar_fallback} reads took the scalar fallback",
        func="correct_file_device")


def _emit_rb_native(rb, w0: int, res, opt: Opts, out,
                    a: int = 0, b: int = -1) -> bool:
    """Emit one ReadBatch's records via the native formatter
    (native/fastxio.c:fastx_format, the counterpart of the reference's
    output loop correct.c:596-611).  Requires the fast-parser offsets
    (names/original text live in rb.buf) and a write_bytes-capable
    sink; returns False to fall back to the per-read Python path
    (slow-parser batches, scalar-fallback reads in range, no lib)."""
    import ctypes

    import numpy as np

    from ..native.build import get_lib

    import os

    if b < 0:
        b = rb.n
    nr = b - a
    lib = get_lib()
    if (lib is None or rb._strings is not None or nr == 0
            or not hasattr(out, "write_bytes")
            or os.environ.get("BFC_NO_NATIVE_WRITER")):
        return nr == 0
    if any(w0 + a <= i < w0 + b for i in res.exceptional):
        return False
    sl = slice(w0 + a, w0 + b)
    code = res.code[sl]
    is_fq = res.has_q[sl] & (not opt.no_qual)
    mode = np.where(code == 0, 0, 1).astype(np.uint8) | (
        is_fq.astype(np.uint8) << 2
    )
    if opt.discard:
        mode = np.where(code != 0, 3, mode).astype(np.uint8)
    lens = np.ascontiguousarray(res.lens[sl], dtype=np.int32)
    if res.seq_rows.shape[1] < int(lens.max(initial=0)):
        return False  # row matrix narrower than a read: python path
    name_off = np.ascontiguousarray(rb.name_off[a:b], dtype=np.int64)
    name_len = np.ascontiguousarray(rb.name_len[a:b], dtype=np.int32)
    seq_off = np.ascontiguousarray(rb.seq_off[a:b], dtype=np.int64)
    qual_off = np.ascontiguousarray(rb.qual_off[a:b], dtype=np.int64)
    seq_rows = np.ascontiguousarray(res.seq_rows[sl])
    qual_rows = np.ascontiguousarray(res.qual_rows[sl])
    aux = np.ascontiguousarray(res.aux[sl])
    aux2 = np.ascontiguousarray(res.aux2[sl])
    cap = int((name_len.astype(np.int64) + 2 * lens + 96).sum()) + 16
    buf = ctypes.create_string_buffer(cap)

    def p(arr, ct):
        return arr.ctypes.data_as(ctypes.POINTER(ct))

    ret = lib.fastx_format(
        nr, rb.buf,
        p(name_off, ctypes.c_int64), p(name_len, ctypes.c_int32),
        p(seq_off, ctypes.c_int64), p(qual_off, ctypes.c_int64),
        p(seq_rows, ctypes.c_ubyte), p(qual_rows, ctypes.c_ubyte),
        seq_rows.shape[1],
        p(lens, ctypes.c_int32),
        p(aux, ctypes.c_uint64), p(aux2, ctypes.c_uint64),
        p(mode, ctypes.c_ubyte),
        buf, cap,
    )
    if ret < 0:
        return False
    out.write_bytes(buf.raw[:ret])
    return True


def _emit_rb_python(rb, w0: int, res, opt: Opts, out,
                    a: int = 0, b: int = -1) -> None:
    """Per-read emit path (slow-parser batches and fallback reads)."""
    if b < 0:
        b = rb.n
    for i in range(a, b):
        st, s2, q2 = (
            res[w0 + i] if isinstance(res, list) else res.tuple_of(w0 + i)
        )
        r = Read(name=rb.name(i), comment=None, seq=s2, qual=q2)
        r.aux, r.aux2 = pack_stats(st)
        format_corrected(r, opt.no_qual, False, opt.discard, out)


def _refine_batch(rb, opt: Opts, corr: Corrector, out: List[str],
                  carry: List[M.EcStat], comments) -> None:
    """Refine-mode batch: per-read ec:Z parsing, skip/revert bookkeeping
    (correct.c:438-442,470,542-545; rf_code 1 = failed, 2 = reverted,
    3 = refined).  carry[0] threads the last parsed stats across reads
    in stream order - reads with a missing/unparseable tag compare
    against the stale per-thread ori_st, exactly like the reference's
    single-thread arena (calloc-zeroed before the first parsed tag)."""
    n = rb.n
    todo_idx = []
    ori_sts: List[M.EcStat] = []
    reads: List[Read] = []
    for i in range(n):
        r = Read(name=rb.name(i), comment=comments.get(rb, i), seq=rb.seq(i),
                 qual=rb.qual(i))
        reads.append(r)
        skip = False
        if r.comment and r.comment.startswith("ec:Z:"):
            carry[0] = parse_stats(r.comment[5:])
            if carry[0].ec_code == 0 and carry[0].max_heap < 50:
                skip = True
        if not skip:
            r.comment = None
            todo_idx.append(i)
            ori_sts.append(carry[0])
    if todo_idx:
        res = corr.correct_batch(
            [reads[i].seq for i in todo_idx],
            [reads[i].qual for i in todo_idx],
        )
        for j, i in enumerate(todo_idx):
            st, s2, q2 = res[j]
            r = reads[i]
            st.rf_code = 1
            ori = ori_sts[j]
            if st.ec_code == 0:
                if ori.ec_code == 0 and st.n_absent > ori.n_absent:
                    st = dataclasses.replace(ori)
                    st.rf_code = 2
                    s2, q2 = r.seq, r.qual
                else:
                    st.rf_code = 3
            r.seq, r.qual = s2, q2
            r.aux, r.aux2 = pack_stats(st)
    for r in reads:
        format_corrected(r, opt.no_qual, False, opt.discard, out)


def _prewarm_async(opt: Opts, count_fn: str, batch_reads: int):
    """Compile the correction programs DURING the counting stream.

    The search program is the largest compile of a run, while the
    reference binary starts in milliseconds (bfc.c:77); with -s given,
    the cuckoo-table size is predictable (Opts.predicted_c_bits) and the
    read length is peeked from the input, so both hot programs can
    compile on a background thread while counting streams - cold process
    to first corrected read drops from counting+compile to
    ~max(counting, compile).  Compilation is pure host work; the thread
    is niced so it only uses cycles the device stream leaves idle."""
    import os
    import threading

    c_bits = opt.predicted_c_bits()
    if (os.environ.get("BFC_PREWARM", "1") != "1" or not c_bits
            or count_fn == "-" or not os.path.isfile(count_fn)):
        return None
    import jax

    if jax.default_backend() == "cpu":
        # CPU compiles are fast and on-demand; a background compile
        # racing a foreground one can abort XLA-CPU (see
        # counter._prefetch_ladder) - this is an accelerator-latency tool
        return None
    try:  # peek the first read's length (uniform-length data in practice)
        first = next(read_fastx(count_fn), None)
    except Exception:
        return None
    if first is None:
        return None
    read_len = len(first.seq)
    if read_len > 504:
        return None  # long reads take the scalar path; nothing to warm

    def bg():
        try:
            try:
                os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 10)
            except Exception:
                pass
            import jax.numpy as jnp
            import numpy as np

            from ..ops import kmer as kops
            from ..ops import spectrum as spec

            l_pre = opt.effective_l_pre()
            kb_bits = kops.keybody_bits(opt.k, l_pre)
            if not spec.cuckoo_ok(c_bits, l_pre, kb_bits):
                return
            dummy = DeviceSpectrum(
                spec.CuckooTable(lo=jnp.zeros((1 << c_bits,), jnp.uint32),
                                 hi=jnp.zeros((1 << c_bits,), jnp.uint32)),
                opt.k, l_pre, c_bits, 0,
                np.zeros(256, np.int64), np.zeros(64, np.int64), -1,
                compact=(np.zeros(0, np.uint32), np.zeros(0, np.uint64),
                         np.zeros(0, np.uint32)),
            )
            Corrector(opt, dummy).prewarm(batch_reads, read_len=read_len)
        except Exception as e:  # noqa: BLE001 - the foreground compiles anyway
            log(f"prewarm failed ({type(e).__name__}: {e}); the programs "
                "compile on first use", func="_prewarm_async", level=3)

    t = threading.Thread(target=bg, daemon=True, name="bfc-prewarm")
    t.start()
    return t


def run_device(opt: Opts, count_fn: str, correct_fn: Optional[str] = None,
               in_hash: Optional[str] = None, out_hash: Optional[str] = None,
               no_ec: bool = False, batch_reads: int = 8192,
               mesh_devices: int = 0, shard_table: Optional[bool] = None,
               sink=None) -> str:
    """Full device pipeline; returns the output text (reference stdout).

    With `sink` (a binary file-like), records stream out as batches
    finish - O(batch) memory, the reference's pipeline behavior - and
    the return value is "".

    mesh_devices > 1 shards the counting pass by hash prefix over a
    device mesh (all-to-all k-mer shuffle) and runs the correction pass
    data-parallel.  shard_table=True (or BFC_SHARD_TABLE=1) keeps
    the finalized spectrum SHARDED across the mesh for correction -
    lookups route over the device interconnect (the human-scale layout
    where the table does not fit one device) - instead of replicating
    it; output is identical either way."""
    import os

    if shard_table is None:
        shard_table = os.environ.get("BFC_SHARD_TABLE", "0") == "1"
    from ..io.writer import OutputWriter

    mesh = None
    if mesh_devices and mesh_devices > 1:
        from ..parallel import mesh as pmesh

        mesh = pmesh.make_mesh(mesh_devices)
    out = OutputWriter(sink)
    next_fn = correct_fn if correct_fn is not None else count_fn
    if opt.filter_mode:
        bf_high = count_file_filter_device(count_fn, opt)
        trimmer = Trimmer(opt, bf_high)
        trimmer.trim_file(next_fn, out)
    else:
        if (not no_ec and in_hash is None and mesh is None
                and not opt.refine_ec):
            # cold-start: compile the correction programs while counting
            _prewarm_async(opt, count_fn, batch_reads)
        if in_hash is not None:
            ds = restore_spectrum(in_hash)
            opt.k = ds.k
        elif mesh is not None:
            from ..parallel.mesh import count_file_mesh

            ds = count_file_mesh(count_fn, opt, mesh,
                                 batch_reads=max(batch_reads, 8 * mesh_devices),
                                 shard_table=shard_table and not no_ec)
        else:
            ds = count_file_device(count_fn, opt)
        if out_hash is not None:
            ds.dump(out_hash)
        if not no_ec:
            if mesh is not None and shard_table:
                from ..ops import spectrum as _spec
                from ..parallel import mesh as pmesh

                if not isinstance(ds.table, _spec.ShardedCuckoo):
                    ok = pmesh.shard_cuckoo_table(ds, mesh)
                    if not ok:
                        log("table layout not shardable; correcting with a "
                            "replicated table", func="run_device")
            correct_file_device(next_fn, opt, ds, out, batch_reads=batch_reads,
                                mesh=mesh)
    if sink is not None:
        out.flush()
        return ""
    return out.getvalue()
