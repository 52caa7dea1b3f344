"""Sharded-table correction: lookups routed over the mesh, byte parity.

The human-scale layout (htab.c:28-33): the finalized cuckoo spectrum is
slot-range-sharded across 8 CPU devices and every correction lookup
routes requests with a paired all_to_all (spectrum.sharded_cuckoo_lookup).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from bfc_jax.ops import spectrum as spec

from . import datagen, oracle


def _random_entries(rng, n, l_pre, kb_bits):
    shard = rng.integers(0, 1 << l_pre, n).astype(np.uint32)
    keybody = rng.integers(0, 1 << kb_bits, n).astype(np.uint64)
    uniq = np.unique((shard.astype(np.uint64) << np.uint64(kb_bits)) | keybody)
    shard = (uniq >> np.uint64(kb_bits)).astype(np.uint32)
    keybody = uniq & np.uint64((1 << kb_bits) - 1)
    payload = rng.integers(1, 1 << 14, len(shard)).astype(np.uint32)
    return shard, keybody, payload


def test_sharded_lookup_matches_local():
    """sharded_cuckoo_lookup == cuckoo_lookup on random keys + queries.

    The sharded layout is per-device independent sub-tables (prefix
    routing); the local table is the flat global cuckoo.  Both must
    return identical payloads - placement is layout-only."""
    from bfc_jax.parallel import mesh as pmesh
    from bfc_jax.ops import spectrum_host as sph

    rng = np.random.default_rng(42)
    c_bits, l_pre, kb_bits = 14, 8, 20
    shard, keybody, payload = _random_entries(rng, 5000, l_pre, kb_bits)
    n = len(shard)
    entries, ok = sph.build_cuckoo_table_host(
        shard, keybody, payload, c_bits, l_pre, kb_bits
    )
    assert ok
    table = spec.cuckoo_from_u64(entries)
    # queries: hits + misses
    m = 4096
    qs = rng.integers(0, 1 << l_pre, m).astype(np.uint32)
    qk = rng.integers(0, 1 << kb_bits, m).astype(np.uint64)
    sel = rng.integers(0, n, m // 2)
    qs[: m // 2] = shard[sel]
    qk[: m // 2] = keybody[sel]
    want = np.asarray(
        spec.cuckoo_lookup(table, jnp.asarray(qs), jnp.asarray(qk),
                           c_bits, l_pre, kb_bits)
    )

    n_dev = 8
    cb_local = c_bits - 3
    sh_entries, ok2 = sph.build_sharded_cuckoo_host(
        shard, keybody, payload, n_dev, cb_local, l_pre, kb_bits
    )
    assert ok2
    mesh = pmesh.make_mesh(n_dev)
    ent_sh = jax.device_put(jnp.asarray(sh_entries), NamedSharding(mesh, P("d")))

    def step(entries_local, s, k):
        occ, ovf = spec.sharded_cuckoo_lookup(
            spec.sharded_from_u64(entries_local), s, k,
            c_bits, l_pre, kb_bits, "d", n_dev,
        )
        return occ, ovf[None]

    got, ovf = jax.jit(shard_map(
        step, mesh=mesh, in_specs=(P("d"), P("d"), P("d")),
        out_specs=(P("d"), P("d")),
    ))(ent_sh, jnp.asarray(qs), jnp.asarray(qk))
    assert not bool(jnp.any(ovf))
    np.testing.assert_array_equal(np.asarray(got), want)


def test_device_build_matches_host_lookups():
    """spectrum.cuckoo_build_local (device build) produces sub-tables
    whose lookups agree with the host-built sharded layout."""
    from bfc_jax.parallel import mesh as pmesh
    from bfc_jax.ops import spectrum_host as sph

    rng = np.random.default_rng(7)
    c_bits, l_pre, kb_bits = 13, 8, 20
    shard, keybody, payload = _random_entries(rng, 3000, l_pre, kb_bits)
    n = len(shard)
    n_dev = 8
    db, cb_local = 3, c_bits - 3
    mesh = pmesh.make_mesh(n_dev)
    # device blocks: entries routed to their prefix owner, padded
    pk = sph.posk64_np(shard, keybody, l_pre, kb_bits)
    dest = (pk >> np.uint64(64 - db)).astype(np.int64)
    cap = int(np.bincount(dest, minlength=n_dev).max()) + 8
    sh_b = np.full((n_dev, cap), 0xFFFFFFFF, np.uint32)
    kb_b = np.zeros((n_dev, cap), np.uint64)
    pl_b = np.zeros((n_dev, cap), np.uint32)
    for d in range(n_dev):
        sel = np.flatnonzero(dest == d)
        sh_b[d, : len(sel)] = shard[sel]
        kb_b[d, : len(sel)] = keybody[sel]
        pl_b[d, : len(sel)] = payload[sel]

    def build(s, k, p):
        e, ok = spec.cuckoo_build_local(
            s.reshape(-1), k.reshape(-1), p.reshape(-1),
            c_bits, cb_local, l_pre, kb_bits, axis_name="d",
        )
        return e[None], ok[None]

    ent, oks = jax.jit(shard_map(
        build, mesh=mesh, in_specs=(P("d"), P("d"), P("d")),
        out_specs=(P("d"), P("d")),
    ))(jnp.asarray(sh_b), jnp.asarray(kb_b), jnp.asarray(pl_b))
    assert bool(jnp.all(oks))
    ent = ent.reshape(-1)

    m = 2048
    qs = rng.integers(0, 1 << l_pre, m).astype(np.uint32)
    qk = rng.integers(0, 1 << kb_bits, m).astype(np.uint64)
    sel = rng.integers(0, n, m // 2)
    qs[: m // 2] = shard[sel]
    qk[: m // 2] = keybody[sel]
    entries_h, okh = sph.build_cuckoo_table_host(
        shard, keybody, payload, c_bits, l_pre, kb_bits
    )
    assert okh
    want = np.asarray(spec.cuckoo_lookup(
        spec.cuckoo_from_u64(entries_h),
        jnp.asarray(qs), jnp.asarray(qk), c_bits, l_pre, kb_bits,
    ))

    def step(entries_local, s, k):
        occ, ovf = spec.sharded_cuckoo_lookup(
            spec.sharded_from_u64(entries_local), s, k,
            c_bits, l_pre, kb_bits, "d", n_dev,
        )
        return occ, ovf[None]

    got, ovf = jax.jit(shard_map(
        step, mesh=mesh, in_specs=(P("d"), P("d"), P("d")),
        out_specs=(P("d"), P("d")),
    ))(ent, jnp.asarray(qs), jnp.asarray(qk))
    assert not bool(jnp.any(ovf))
    np.testing.assert_array_equal(np.asarray(got), want)


def test_forced_skew_overflows_then_retries():
    """All queries aimed at ONE prefix range must overflow the routing
    bucket at slack 1 and succeed at a larger slack - the driver's
    doubling retry path, with no scalar fallback."""
    from bfc_jax.parallel import mesh as pmesh
    from bfc_jax.ops import spectrum_host as sph

    rng = np.random.default_rng(5)
    c_bits, l_pre, kb_bits = 13, 8, 20
    shard, keybody, payload = _random_entries(rng, 2000, l_pre, kb_bits)
    n_dev = 8
    cb_local = c_bits - 3
    sh_entries, ok = sph.build_sharded_cuckoo_host(
        shard, keybody, payload, n_dev, cb_local, l_pre, kb_bits
    )
    assert ok
    mesh = pmesh.make_mesh(n_dev)
    ent_sh = jax.device_put(jnp.asarray(sh_entries), NamedSharding(mesh, P("d")))
    # skew: every query is the same key (prefix 0 owner gets them all)
    m = 1024
    qs = np.full((m,), int(shard[0]), np.uint32)
    qk = np.full((m,), int(keybody[0]), np.uint64)

    def mk(slack):
        def step(entries_local, s, k):
            occ, ovf = spec.sharded_cuckoo_lookup(
                spec.sharded_from_u64(entries_local), s, k,
                c_bits, l_pre, kb_bits, "d", n_dev, slack=slack,
            )
            return occ, ovf[None]

        return jax.jit(shard_map(
            step, mesh=mesh, in_specs=(P("d"), P("d"), P("d")),
            out_specs=(P("d"), P("d")),
        ))

    got1, ovf1 = mk(1)(ent_sh, jnp.asarray(qs), jnp.asarray(qk))
    assert bool(jnp.any(ovf1)), "skewed load must overflow at slack 1"
    got, ovf = mk(16)(ent_sh, jnp.asarray(qs), jnp.asarray(qk))
    assert not bool(jnp.any(ovf))
    np.testing.assert_array_equal(np.asarray(got), np.full((m,), int(payload[0])))


def test_corrector_retries_routing_overflow():
    """A skewed batch (every read the same homopolymer-ish sequence, so
    every lookup routes to one prefix owner) must overflow the routing
    buckets and be retried with doubled slack on DEVICE - no read may
    take the scalar-fallback path."""
    from bfc_jax.models import corrector as DC
    from bfc_jax.models import counter as C
    from bfc_jax.opts import Opts
    from bfc_jax.parallel import mesh as pmesh

    from . import datagen

    genome = datagen.make_genome(4000, seed=9)
    reads = datagen.simulate_reads(genome, 800, read_len=80,
                                   err_rate=0.01, seed=10)
    opt = Opts()
    opt.k = 17
    opt.bf_shift = 22
    ds = C.count_stream(iter(reads), opt, batch_reads=800)
    mesh = pmesh.make_mesh(8)
    assert pmesh.shard_cuckoo_table(ds, mesh)
    corr = DC.Corrector(opt, ds, mesh=mesh)
    # reference behavior for these reads (unsharded corrector)
    ds2 = C.count_stream(iter(reads), opt, batch_reads=800)
    corr_ref = DC.Corrector(opt, ds2)
    skew = [(reads[0][0][:17] * 5)[:80], None]
    seqs = [skew[0]] * 64
    want = corr_ref.correct_batch(seqs, [None] * 64)
    got = corr.correct_batch(seqs, [None] * 64)
    assert corr._route_slack > corr.cfg.route_slack, "retry must trigger"
    assert [g[1:] for g in got] == [w[1:] for w in want]
    assert [g[0].__dict__ for g in got] == [w[0].__dict__ for w in want]


@pytest.mark.slow
def test_sharded_pipeline_matches_reference(tmp_path):
    """Full pipeline with the table SHARDED (not replicated): byte parity."""
    from bfc_jax.models import device_pipeline as DP
    from bfc_jax.opts import Opts

    assert len(jax.devices()) >= 8
    fq = datagen.standard_dataset(
        str(tmp_path), genome_len=8000, n_reads=2400, name="s.fq"
    )
    ref_out, _ = oracle.run_bfc(["-k17", "-b22", "-t1", fq])
    opt = Opts()
    opt.k = 17
    opt.bf_shift = 22
    mine = DP.run_device(opt, fq, mesh_devices=8, batch_reads=1024,
                         shard_table=True)
    assert mine.encode() == ref_out
