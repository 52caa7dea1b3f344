"""Multi-chip scaling: hash-prefix-sharded counting + data-parallel correction.

Device-mesh replacement for the reference's shared-memory concurrency
(spin-locked Bloom blocks / hash shards + per-thread insert buffers,
/root/reference/bbf.c:34, htab.c:67-71, count.c:20-66).  The reference
already partitions its table by a hash prefix (htab.c:28-33); here that
prefix becomes the device-sharding key:

  counting   each device rolls k-mers from its read slice, buckets them
             by table-shard prefix, and exchanges buckets with a single
             jax.lax.all_to_all; every per-shard combine is
             then purely local (the per-thread insbuf trick, writ large).
  adjudicate Bloom first-occurrence adjudication routes first-occurrence
             events by Bloom-block prefix (a second all_to_all), computes
             per-bit min arrivals locally, and routes verdicts back.
  correction data-parallel over reads with the finalized table
             replicated (sharded-table lookup via all-to-all gather is
             the human-scale path; see SURVEY.md §5.8).

Determinism: arrival indices are global (read-major over the unsharded
stream), so the sequential-order counting semantics are preserved
exactly regardless of device count.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import kmer as kops
from ..ops import spectrum as spec

U64 = jnp.uint64
U32 = jnp.uint32
I32 = jnp.int32


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("d",))


def gput(arr, mesh: Mesh, pspec) -> jax.Array:
    """Build a global device array from host data, multi-process aware.

    Single process: a plain device_put.  Multi-process (jax.distributed
    initialized): every process passes the SAME full host array; for a
    row-sharded spec each process contributes only the row range owned
    by its local devices (jax.make_array_from_process_local_data), for a
    replicated spec the full array.  Device order in the mesh must be
    process-major (jax.devices() order) so global row order equals the
    host array's row order."""
    sh = NamedSharding(mesh, pspec)
    if jax.process_count() == 1:
        return jax.device_put(jnp.asarray(arr), sh)
    arr = np.asarray(arr)
    if pspec == P():
        return jax.make_array_from_process_local_data(sh, arr)
    n_proc = jax.process_count()
    pid = jax.process_index()
    B = arr.shape[0]
    assert B % n_proc == 0, (B, n_proc)
    step = B // n_proc
    return jax.make_array_from_process_local_data(
        sh, arr[pid * step : (pid + 1) * step]
    )


def to_host(x) -> np.ndarray:
    """Pull a (possibly non-fully-addressable) global array to every
    host: allgather under multi-process, np.asarray otherwise."""
    if jax.process_count() == 1 or not isinstance(x, jax.Array):
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def _dev_of_shard(shard, l_pre: int, n_dev: int):
    """Owning device of a table shard = top log2(n_dev) bits of the prefix."""
    shift = max(l_pre - int(np.log2(n_dev)), 0)
    return (shard >> U32(shift)).astype(I32) % n_dev


@functools.partial(
    jax.jit, static_argnames=("k", "l_pre", "cap", "bucket_cap", "mesh_ref")
)
def sharded_chunk_aggregate(bases, qual_ok, lens, arrival_base, k: int,
                            l_pre: int, cap: int, bucket_cap: int, mesh_ref):
    """One sharded counting step: local k-mer roll -> all-to-all by hash
    prefix -> local combine.  Inputs are sharded over reads (axis 0 of
    [B, L]); the returned Aggregate is sharded over hash-prefix ranges
    (axis 0 of [n_dev * cap])."""
    mesh = mesh_ref.mesh
    n_dev = mesh.shape["d"]

    def step(bases, qual_ok, lens, arrival_base):
        # local shard of the batch
        s = kops.kmer_stream(bases, qual_ok, lens, k, l_pre)
        Bl, L = bases.shape
        my = jax.lax.axis_index("d")
        arrival = (
            arrival_base
            + my.astype(U64) * U64(Bl * L)
            + jnp.arange(Bl * L, dtype=U64)
        )
        valid = s["valid"].reshape(-1)
        shard = jnp.where(valid, s["shard"].reshape(-1), spec.INVALID_SHARD)
        keybody = s["keybody"].reshape(-1)
        ret = s["ret"].reshape(-1)
        is_high = s["is_high"].reshape(-1).astype(U32)
        dest = jnp.where(valid, _dev_of_shard(shard, l_pre, n_dev), n_dev)
        # bucket by destination: sort by dest, then scatter into fixed
        # [n_dev, bucket_cap] send buffers (per-dest overflow detected)
        order = spec.stable_order(dest.astype(jnp.uint32))
        dest_s = dest[order]
        rank = jnp.arange(dest_s.shape[0]) - jnp.searchsorted(
            dest_s, dest_s, side="left"
        )
        counts = jnp.bincount(jnp.minimum(dest_s, n_dev), length=n_dev + 1)[:n_dev]
        overflow = jnp.any(counts > bucket_cap)
        slot = jnp.where(
            (dest_s < n_dev) & (rank < bucket_cap),
            dest_s * bucket_cap + rank,
            n_dev * bucket_cap + 1,
        )

        def bucketize(v, fill):
            buf = jnp.full((n_dev * bucket_cap,), fill, v.dtype)
            return buf.at[slot].set(v[order], mode="drop").reshape(n_dev, bucket_cap)

        b_shard = bucketize(shard, spec.INVALID_SHARD)
        b_kb = bucketize(keybody, U64(0xFFFFFFFFFFFFFFFF))
        b_ret = bucketize(ret, U64(0))
        b_high = bucketize(is_high, U32(0))
        b_arr = bucketize(arrival, U64(0xFFFFFFFFFFFFFFFF))
        # exchange: row j of the result = row my of device j's buffer
        def xch(b):
            return jax.lax.all_to_all(b, "d", split_axis=0, concat_axis=0, tiled=True)

        r_shard = xch(b_shard).reshape(-1)
        r_kb = xch(b_kb).reshape(-1)
        r_ret = xch(b_ret).reshape(-1)
        r_high = xch(b_high).reshape(-1)
        r_arr = xch(b_arr).reshape(-1)
        one = (r_shard != spec.INVALID_SHARD).astype(U32)
        agg, g = spec._segment_combine(
            r_shard, r_kb, r_ret, one, r_high, r_arr, r_high, cap
        )
        return tuple(x[None] for x in agg) + (g[None], overflow[None])

    out = shard_map(
        step, mesh=mesh,
        in_specs=(P("d"), P("d"), P("d"), P()),
        out_specs=tuple([P("d")] * 7) + (P("d"), P("d")),
    )(bases, qual_ok, lens, arrival_base)
    agg = spec.Aggregate(*[x.reshape(-1) for x in out[:7]])
    return agg, out[7], jnp.any(out[8])


@functools.partial(jax.jit, static_argnames=("cap", "mesh_ref"))
def sharded_merge(a: spec.Aggregate, b: spec.Aggregate, cap: int, mesh_ref):
    """Merge two prefix-sharded aggregates; combines stay device-local."""
    mesh = mesh_ref.mesh

    def step(*cols):
        ca = cols[:7]
        cb = cols[7:]
        cat = [jnp.concatenate([x.reshape(-1), y.reshape(-1)]) for x, y in zip(ca, cb)]
        agg, g = spec._segment_combine(
            cat[0], cat[1], cat[2], cat[3], cat[4], cat[5], cat[6], cap
        )
        return tuple(x[None] for x in agg) + (g[None],)

    out = shard_map(
        step, mesh=mesh,
        in_specs=tuple([P("d")] * 14),
        out_specs=tuple([P("d")] * 7) + (P("d"),),
    )(*(list(a) + list(b)))
    return spec.Aggregate(*[x.reshape(-1) for x in out[:7]]), out[7]


@functools.partial(jax.jit, static_argnames=("bf_shift", "n_hashes", "mesh_ref",
                                              "ev_slack"))
def sharded_adjudicate(agg: spec.Aggregate, bf_shift: int, n_hashes: int, mesh_ref,
                       ev_slack: int = 2):
    """Distributed Bloom first-occurrence adjudication.

    Routes (probe-bit, arrival) events to the device owning the Bloom
    block (low ret bits), computes per-bit min arrivals locally, and
    routes verdicts back to the k-mers' owners."""
    mesh = mesh_ref.mesh
    n_dev = mesh.shape["d"]

    def step(shard, ret, first_arr):
        shard = shard.reshape(-1)
        ret = ret.reshape(-1)
        first_arr = first_arr.reshape(-1)
        C = shard.shape[0]
        valid = shard != spec.INVALID_SHARD
        bits = spec.bloom_probe_bits(ret, bf_shift, n_hashes)  # [C, H]
        H = n_hashes
        flat_bits = bits.reshape(-1)
        flat_arr = jnp.broadcast_to(first_arr[:, None], (C, H)).reshape(-1)
        flat_ok = jnp.broadcast_to(valid[:, None], (C, H)).reshape(-1)
        # destination = block owner; block = bit_id >> 9
        dest = jnp.where(
            flat_ok,
            ((flat_bits >> U64(9)) % U64(n_dev)).astype(I32),
            n_dev,
        )
        cap_ev = (C * H) // n_dev * ev_slack + 64
        order = spec.stable_order(dest.astype(jnp.uint32))
        dest_s = dest[order]
        rank = jnp.arange(dest_s.shape[0]) - jnp.searchsorted(dest_s, dest_s, "left")
        counts = jnp.bincount(jnp.minimum(dest_s, n_dev), length=n_dev + 1)[:n_dev]
        overflow = jnp.any(counts > cap_ev)
        slot = jnp.where(
            (dest_s < n_dev) & (rank < cap_ev),
            dest_s * cap_ev + rank, n_dev * cap_ev + 1,
        )

        def bucketize(v, fill):
            buf = jnp.full((n_dev * cap_ev,), fill, v.dtype)
            return buf.at[slot].set(v[order], mode="drop").reshape(n_dev, cap_ev)

        sent = U64(0xFFFFFFFFFFFFFFFF)
        b_bit = bucketize(jnp.where(flat_ok, flat_bits, sent), sent)
        b_arr = bucketize(flat_arr, sent)

        def xch(b):
            return jax.lax.all_to_all(b, "d", split_axis=0, concat_axis=0, tiled=True)

        r_bit = xch(b_bit).reshape(-1)
        r_arr = xch(b_arr).reshape(-1)
        # local per-bit min arrival; events with identical bits collide here
        a_lo = (r_arr & U64(0xFFFFFFFF)).astype(U32)
        a_hi = (r_arr >> U64(32)).astype(U32)
        b_lo = (r_bit & U64(0xFFFFFFFF)).astype(U32)
        b_hi = (r_bit >> U64(32)).astype(U32)
        ksrc = spec.stable_order(a_lo, a_hi, b_lo, b_hi)
        kb = r_bit[ksrc]
        ka = r_arr[ksrc]
        first = jnp.concatenate([jnp.ones((1,), bool), kb[1:] != kb[:-1]])
        min_arr = spec._forward_fill(jnp.where(first, ka, U64(0)), first)
        was_set = (min_arr < ka) & (kb != sent)
        verdict = jnp.zeros((r_bit.shape[0],), bool).at[ksrc].set(was_set)
        # route verdicts back: the bucket layout is symmetric, so a
        # second all_to_all returns slot (j, i) to its origin device
        v_back = xch(verdict.reshape(n_dev, cap_ev)).reshape(-1)
        # undo the local bucketization: slot maps sorted position -> buffer
        in_range = slot < n_dev * cap_ev
        hit_sorted = jnp.where(
            in_range, v_back[jnp.minimum(slot, n_dev * cap_ev - 1)], False
        )
        hit = jnp.zeros((C * H,), bool).at[order].set(hit_sorted)
        fp = jnp.all(hit.reshape(C, H), axis=-1) & valid
        return fp[None], overflow[None]

    out = shard_map(
        step, mesh=mesh,
        in_specs=(P("d"), P("d"), P("d")),
        out_specs=(P("d"), P("d")),
    )(agg.shard, agg.ret, agg.first_arr)
    return out[0].reshape(-1), jnp.any(out[1])


def replicate_table(table, mesh: Mesh):
    """Replicate the finalized table across the mesh for dp correction."""
    return type(table)(*[gput(np.asarray(x), mesh, P()) for x in table])


def shard_cuckoo_table(ds, mesh: Mesh) -> bool:
    """Re-layout ds.table as a prefix-sharded ShardedCuckoo.

    The human-scale path (htab.c:28-33): each device holds an
    INDEPENDENT cuckoo sub-table over its hash-prefix range of the
    spectrum; correction lookups route one request per query to the
    owner (spectrum.sharded_cuckoo_lookup).  Builds the sub-tables on
    the host from the compact entries (small-scale / restore path; the
    mesh counting pass builds them distributed on device instead -
    _finalize_sharded).  Returns False (table left as-is) when the
    layout does not apply - callers then keep the replicated path."""
    from ..ops import spectrum_host as sph

    n_dev = mesh.shape["d"]
    if n_dev & (n_dev - 1):
        return False
    shard, keybody, payload = ds.compact_entries()
    db = n_dev.bit_length() - 1
    kb_bits = ds.kb_bits
    pk = sph.posk64_np(shard.astype(np.uint32), keybody.astype(np.uint64),
                       ds.l_pre, kb_bits)
    dest = (pk >> np.uint64(64 - db)).astype(np.int64) if db else np.zeros(
        len(pk), np.int64)
    max_local = int(np.bincount(dest, minlength=n_dev).max()) if len(pk) else 1
    cb_local = max(8, int(np.ceil(np.log2(max(max_local, 1) * 2.5 + 1))))
    c_bits = db + cb_local
    if cb_local > 30 or not spec.cuckoo_ok(c_bits, ds.l_pre, kb_bits):
        return False
    entries, ok = sph.build_sharded_cuckoo_host(
        shard.astype(np.uint32), keybody.astype(np.uint64),
        payload.astype(np.uint32), n_dev, cb_local, ds.l_pre, kb_bits,
    )
    if not ok:
        return False
    planes = spec.sharded_from_u64(entries)  # host split, then shard
    ds.table = spec.ShardedCuckoo(
        lo=gput(planes.lo, mesh, P("d")), hi=gput(planes.hi, mesh, P("d")),
    )
    ds.s_bits = c_bits  # lookups derive slots from the GLOBAL c_bits
    return True


class MeshRef:
    """Hashable wrapper so a Mesh can be a static jit argument."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __hash__(self):
        return hash(tuple(d.id for d in self.mesh.devices.flat))

    def __eq__(self, other):
        return isinstance(other, MeshRef) and self.mesh == other.mesh


# ---------------------------------------------------------------------------
# Mesh counting driver
# ---------------------------------------------------------------------------

def count_file_mesh(fn: str, opt, mesh: Mesh, batch_reads: int = 8192,
                    shard_table: bool = False):
    """Counting pass sharded over the mesh from a FASTQ file (native
    batched reader); see count_encoded_mesh for the core."""
    import numpy as np

    from ..io import fast_reader as FR
    from ..models.counter import _round_up

    import jax

    # multi-host: every process shares the byte scan (record offsets)
    # but DECODES and pads only the row stride its local devices own -
    # input work per host is 1/n_hosts instead of replicated (SURVEY
    # §5.8; the reference's one reader thread never replicates work,
    # bseq.c:52-76).  gput row-shards each padded batch process-major,
    # so rows outside [row_lo, row_hi) never leave this host anyway.
    n_proc = jax.process_count()
    pid = jax.process_index()
    assert batch_reads % max(n_proc, 1) == 0
    step = batch_reads // max(n_proc, 1)
    row_lo, row_hi = pid * step, (pid + 1) * step
    dec = (row_lo, row_hi) if n_proc > 1 else None

    def batches():
        pad_L = 0
        for rb in FR.iter_batches_prefetch(fn, batch_reads,
                                           max_bases=opt.chunk_size,
                                           decode_range=dec):
            n = rb.n
            if dec is not None:
                # -L splits can shift the decoded stride off this rb's
                # rows; repair the owned range (rare, cheap)
                rb.ensure_decoded(row_lo, min(row_hi, n))
            lo, hi = (0, n) if dec is None else (min(row_lo, n),
                                                 min(row_hi, n))
            pad_L = max(pad_L, _round_up(int(rb.lens.max()) if n else 1, 32))
            L = pad_L
            Lc = min(L, rb.bases.shape[1])
            bases = np.full((batch_reads, L), 4, np.uint8)
            bases[lo:hi, :Lc] = rb.bases[lo:hi, :Lc]
            lens = np.zeros((batch_reads,), np.int32)
            lens[:n] = rb.lens  # lens are global metadata (cheap, complete)
            qok = np.zeros((batch_reads, L), bool)
            has_q = rb.has_qual()[lo:hi]
            inb = np.arange(Lc)[None, :] < rb.lens[lo:hi, None]
            qok[lo:hi, :Lc] = np.where(
                has_q[:, None],
                rb.quals[lo:hi, :Lc].astype(np.int32) - 33 >= opt.q, inb,
            )
            yield bases, qok, lens, n
    return count_encoded_mesh(batches(), opt, mesh, batch_reads=batch_reads,
                              shard_table=shard_table)


def count_encoded_mesh(batch_iter, opt, mesh: Mesh, batch_reads: int = 8192,
                       shard_table: bool = False):
    """Counting pass sharded over the mesh: reads data-parallel in, the
    aggregate hash-prefix-sharded out, Bloom adjudication distributed,
    and finalize/table-build per prefix range on the owning device
    (_finalize_sharded) - the full aggregate is never gathered.

    batch_iter yields (bases u8 [batch_reads, L], qok bool, lens i32)
    encoded batches in stream order (L may grow monotonically), with an
    optional trailing true record count (zero-length records occupy a
    row but have lens == 0; the reference logs every record).

    With shard_table the spectrum stays a prefix-sharded ShardedCuckoo
    for correction (the human-scale layout); otherwise the kept compact
    entries build a replicated table.  Output is bit-identical to the
    single-device pass either way: arrival indices stay global, so the
    sequential-order semantics are preserved."""
    import numpy as np

    from ..models.counter import finalize_spectrum
    from ..utils.log import log

    import os

    from ..ops import spectrum_host as sph

    mref = MeshRef(mesh)
    n_dev = mesh.shape["d"]
    assert batch_reads % n_dev == 0
    k = opt.k
    l_pre = opt.effective_l_pre()
    kb_bits = kops.keybody_bits(k, l_pre)
    # per-device merge capacity: same HBM bound as the single-device
    # tree; past it the binary counter LSM-spills complete spans to a
    # host counter (see models.counter.AggBuilder)
    max_dev_cap = int(os.environ.get("BFC_MAX_MERGE_CAP", str(1 << 22)))
    ccap = 1 << 18
    arrival_base = jnp.uint64(0)
    pad_L = 0
    n_reads = 0

    def _to_host_agg(agg):
        """Pull a prefix-sharded aggregate as a compact sorted HostAgg.

        Device blocks are contiguous ascending shard-prefix ranges and
        each block is sorted, so the concatenation (minus padding) is
        globally sorted - merge_host_aggs' input contract."""
        shard = to_host(agg.shard)
        valid = shard != 0xFFFFFFFF
        return sph.HostAgg(
            shard[valid], to_host(agg.keybody)[valid],
            to_host(agg.ret)[valid], to_host(agg.n)[valid],
            to_host(agg.n_high)[valid], to_host(agg.first_arr)[valid],
            to_host(agg.first_high)[valid],
        )

    def _merge_runs(a, b):
        """LsmTree merge callback: device merge with output-capacity
        doubling (a = earlier span); None once the union would need a
        merge beyond the per-device HBM cap -> the tree spills."""
        cap = max(a[1], b[1])
        if cap > max_dev_cap:
            return None
        while True:
            merged, g2 = sharded_merge(a[0], b[0], cap, mref)
            if int(jnp.max(g2)) <= cap:
                return (merged, cap)
            cap *= 2
            if cap > max_dev_cap:
                return None

    from ..ops.lsm import LsmTree

    tree = LsmTree(
        merge=_merge_runs,
        to_host=lambda run: _to_host_agg(run[0]),
        host_merge=lambda a, b: sph.merge_host_aggs(
            a, b, l_pre=l_pre, kb_bits=kb_bits),
        async_spill=False,  # to_host allgathers: collectives stay on the
                            # main thread in identical order on every host
        name="count_file_mesh",
    )

    for tup in batch_iter:
        bases, qok, lens = tup[:3]
        # true record count when the iterator provides it (zero-length
        # records must still be logged); lens>0 is the legacy fallback
        n_reads += int(tup[3]) if len(tup) > 3 else int(np.sum(lens > 0))
        L = bases.shape[1]
        bases_s = gput(bases, mesh, P("d"))
        qok_s = gput(qok, mesh, P("d"))
        lens_s = gput(lens, mesh, P("d"))
        while True:
            chunk, g, ovf = sharded_chunk_aggregate(
                bases_s, qok_s, lens_s, arrival_base, k, l_pre,
                ccap, batch_reads // n_dev * L, mref,
            )
            if int(jnp.max(g)) <= ccap and not bool(ovf):
                break
            ccap *= 2  # per-device overflow: redo at doubled capacity
        arrival_base = arrival_base + jnp.uint64(batch_reads * L)
        tree.push((chunk, ccap))
    log(f"processed {n_reads} sequences over {n_dev} devices",
        func="count_file_mesh")
    acc, hacc = tree.finish()
    if hacc is not None:
        from ..models.counter import finalize_spectrum

        log(f"{len(hacc.shard)} distinct k-mers aggregated (host tree)",
            func="count_file_mesh")
        ds = finalize_spectrum(hacc, opt)
        if not (shard_table and shard_cuckoo_table(ds, mesh)):
            ds.table = replicate_table(ds.table, mesh)
        return ds
    if acc is None:
        from ..models.counter import count_stream

        return count_stream(iter(()), opt)
    agg = acc[0]
    # adjudication events hash-route by Bloom bit; pathological skew can
    # overflow a destination bucket - retry with more slack instead of
    # aborting (graceful re-bucketing)
    ev_slack = 2
    while True:
        fp, ovf2 = sharded_adjudicate(agg, opt.bf_shift, opt.n_hashes, mref,
                                      ev_slack=ev_slack)
        if not bool(ovf2):
            break
        ev_slack *= 2
        log(f"adjudication bucket overflow; retrying with slack {ev_slack}",
            func="count_file_mesh")
        assert ev_slack <= 64, "adjudication bucket overflow beyond 64x slack"
    # distributed finalize: payloads + table per prefix range on its
    # owning device; nothing gathers unless the replicated layout asks
    ds, sharded = _finalize_sharded(agg, fp, opt, mesh, shard_table)
    if not sharded:
        ds.table = replicate_table(ds.table, mesh)
    return ds


@functools.partial(jax.jit, static_argnames=("mesh_ref",))
def _payloads_sharded(agg: spec.Aggregate, fp, mesh_ref):
    """Per-device payloads + keep-compaction + histograms, all local.

    Every step of the reference's hash finalization (htab.c:77-78,
    110-127) runs on the shard owner; nothing is gathered.  Returns
    device-blocked (shard_c, keybody_c, payload_c) compact arrays
    (padding: INVALID/0/0), per-device kept counts and histograms."""
    mesh = mesh_ref.mesh

    def step(shard, keybody, n, n_high, first_high, fp):
        shard = shard.reshape(-1)
        keybody = keybody.reshape(-1)
        n = n.reshape(-1)
        n_high = n_high.reshape(-1)
        first_high = first_high.reshape(-1)
        fp = fp.reshape(-1).astype(U32)
        valid = shard != spec.INVALID_SHARD
        m = n - 1 + fp
        high = n_high - (1 - fp) * first_high
        keep = valid & (m >= 1)
        count = jnp.minimum(m, 255)
        high = jnp.minimum(high, 63)
        payload = jnp.where(keep, count | (high << 8), U32(0))
        order = spec.stable_order((~keep).astype(U32))
        keep_s = keep[order]
        shard_c = jnp.where(keep_s, shard[order], spec.INVALID_SHARD)
        kb_c = jnp.where(keep_s, keybody[order], U64(0))
        pl_c = jnp.where(keep_s, payload[order], U32(0))
        cnt = jnp.sum(keep, dtype=jnp.int32)
        hist = jnp.bincount(jnp.where(keep, count, U32(0)), length=256)
        hist = hist.at[0].set(0)
        hist_high = jnp.bincount(jnp.where(keep, high, U32(0)), length=64)
        hist_high = hist_high.at[0].set(jnp.sum(keep & (high == 0)))
        return (shard_c[None], kb_c[None], pl_c[None], cnt[None],
                hist[None], hist_high[None])

    return shard_map(
        step, mesh=mesh,
        in_specs=tuple([P("d")] * 6),
        out_specs=tuple([P("d")] * 6),
    )(agg.shard, agg.keybody, agg.n, agg.n_high, agg.first_high, fp)


@functools.partial(
    jax.jit, static_argnames=("c_bits", "cb_local", "l_pre", "kb_bits",
                              "mesh_ref")
)
def _build_sharded_table(shard_c, kb_c, pl_c, c_bits: int, cb_local: int,
                         l_pre: int, kb_bits: int, mesh_ref):
    mesh = mesh_ref.mesh

    def step(shard, keybody, payload):
        entries, ok = spec.cuckoo_build_local(
            shard.reshape(-1), keybody.reshape(-1), payload.reshape(-1),
            c_bits, cb_local, l_pre, kb_bits, axis_name="d",
        )
        return entries[None], ok[None]

    entries, oks = shard_map(
        step, mesh=mesh, in_specs=(P("d"), P("d"), P("d")),
        out_specs=(P("d"), P("d")),
    )(shard_c, kb_c, pl_c)
    # flatten [n_dev, Sl] -> [n_dev * Sl]: block-contiguous, so the
    # sharding is preserved without data movement (ShardedCuckoo's
    # global layout; shard_map consumers see a [Sl] local block)
    return entries.reshape(-1), oks


def _finalize_sharded(agg: spec.Aggregate, fp, opt, mesh: Mesh,
                      shard_table: bool):
    """Distributed finalize: payloads, histograms, and the lookup table
    are all built per hash-prefix range on the range's owning device -
    the full aggregate is NEVER gathered to a host (the reference's
    sizing wall, 67-84 GB on one node, tex/bfc.tex:188-189, removed).

    Returns (DeviceSpectrum, sharded: bool).  With shard_table, the
    table stays a prefix-sharded ShardedCuckoo built on device
    (spectrum.cuckoo_build_local) and only O(n_dev) counters plus the
    [256] histograms cross to the host; otherwise the KEPT compact
    entries (typically 5-10x smaller than the aggregate) are gathered
    once for the replicated-table build."""
    from ..models.counter import (DeviceSpectrum, _mode_from_hist,
                                  _spectrum_from_sorted)

    k = opt.k
    l_pre = opt.effective_l_pre()
    kb_bits = kops.keybody_bits(k, l_pre)
    mref = MeshRef(mesh)
    n_dev = mesh.shape["d"]
    shard_c, kb_c, pl_c, cnts, hist, hist_high = _payloads_sharded(
        agg, fp, mref
    )
    cnts_np = to_host(cnts)
    hist_np = to_host(hist).sum(axis=0)
    hist_np[0] = 0
    hh_np = to_host(hist_high).sum(axis=0)
    total = int(cnts_np.sum())
    mode = _mode_from_hist(hist_np)

    def lazy_compact():
        sh = to_host(shard_c).reshape(-1)
        valid = sh != 0xFFFFFFFF
        return (
            sh[valid],
            to_host(kb_c).reshape(-1)[valid],
            to_host(pl_c).reshape(-1)[valid].astype(np.uint32),
        )

    if shard_table and n_dev & (n_dev - 1) == 0:
        db = n_dev.bit_length() - 1
        max_local = int(cnts_np.max()) if len(cnts_np) else 1
        cb_local = max(8, int(np.ceil(np.log2(max(max_local, 1) * 2.5 + 1))))
        c_bits = db + cb_local
        if cb_local <= 30 and spec.cuckoo_ok(c_bits, l_pre, kb_bits):
            entries, oks = _build_sharded_table(
                shard_c, kb_c, pl_c, c_bits, cb_local, l_pre, kb_bits, mref
            )
            if bool(jnp.all(oks)):
                table = spec.sharded_from_u64(entries)
                ds = DeviceSpectrum(
                    table, k, l_pre, c_bits, total, hist_np, hh_np, mode,
                    compact=lazy_compact, packed=False,
                )
                return ds, True
    sh, kb, pl = lazy_compact()
    return _spectrum_from_sorted(sh, kb, pl, k, l_pre), False
