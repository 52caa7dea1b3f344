"""Sharded counting path vs single-device, on the 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bfc_jax.models import refmodel as M
from bfc_jax.ops import kmer as kops
from bfc_jax.ops import spectrum as spec
from bfc_jax.parallel import mesh as pmesh
from bfc_jax.opts import Opts

from . import datagen


@pytest.fixture(scope="module")
def batch():
    genome = datagen.make_genome(5000, seed=51)
    reads = datagen.simulate_reads(genome, 1024, read_len=100, err_rate=0.015, seed=52)
    seqs = [r[0] for r in reads]
    quals = [r[1] for r in reads]
    bases, qok, lens = kops.encode_batch(seqs, quals, 20, pad_to=128)
    return jnp.asarray(bases), jnp.asarray(qok), jnp.asarray(lens)


def _compact(shard, keybody, payload, keep):
    shard, keybody, payload, keep = map(np.asarray, (shard, keybody, payload, keep))
    return {
        (int(s), int(kb)): int(p)
        for s, kb, p, kp in zip(shard, keybody, payload, keep) if kp
    }


def test_sharded_count_matches_single(batch):
    assert len(jax.devices()) >= 8
    bases, qok, lens = batch
    k, l_pre, bf_shift, n_hashes = 17, 20, 22, 4
    B, L = bases.shape
    # single-device reference path
    agg1, _ = spec.chunk_aggregate(bases, qok, lens, jnp.uint64(0), k, l_pre, B * L)
    s1 = spec.finalize_counts(agg1, bf_shift, n_hashes)
    want = _compact(s1[0], s1[1], s1[2], s1[3])

    # sharded path
    mesh = pmesh.make_mesh(8)
    mref = pmesh.MeshRef(mesh)
    cap = B * L // 8
    bucket_cap = B * L // 8  # generous
    agg, g, ovf = pmesh.sharded_chunk_aggregate(
        bases, qok, lens, jnp.uint64(0), k, l_pre, cap, bucket_cap, mref
    )
    assert not bool(ovf)
    fp, ovf2 = pmesh.sharded_adjudicate(agg, bf_shift, n_hashes, mref)
    assert not bool(ovf2)
    valid = np.asarray(agg.shard) != 0xFFFFFFFF
    m = np.asarray(agg.n) - 1 + np.asarray(fp).astype(np.uint32)
    high = np.asarray(agg.n_high) - (1 - np.asarray(fp)) * np.asarray(agg.first_high)
    keep = valid & (m >= 1)
    payload = np.minimum(m, 255) | (np.minimum(high, 63) << 8)
    got = _compact(agg.shard, agg.keybody, payload, keep)
    assert got == want


def test_sharded_merge_matches(batch):
    bases, qok, lens = batch
    k, l_pre = 17, 20
    B, L = bases.shape
    mesh = pmesh.make_mesh(8)
    mref = pmesh.MeshRef(mesh)
    cap = B * L // 8
    half = B // 2
    a1, _, o1 = pmesh.sharded_chunk_aggregate(
        bases[:half], qok[:half], lens[:half], jnp.uint64(0), k, l_pre,
        cap, cap, mref,
    )
    a2, _, o2 = pmesh.sharded_chunk_aggregate(
        bases[half:], qok[half:], lens[half:], jnp.uint64(half * L), k, l_pre,
        cap, cap, mref,
    )
    assert not bool(o1) and not bool(o2)
    merged, g = pmesh.sharded_merge(a1, a2, cap, mref)
    # compare against the single-device whole-batch aggregate
    agg1, _ = spec.chunk_aggregate(bases, qok, lens, jnp.uint64(0), k, l_pre, B * L)
    def aggmap(a):
        out = {}
        sh = np.asarray(a.shard); kb = np.asarray(a.keybody)
        n = np.asarray(a.n); nh = np.asarray(a.n_high)
        fa = np.asarray(a.first_arr); fh = np.asarray(a.first_high)
        for i in range(len(sh)):
            if sh[i] != 0xFFFFFFFF:
                out[(int(sh[i]), int(kb[i]))] = (int(n[i]), int(nh[i]), int(fa[i]), int(fh[i]))
        return out
    assert aggmap(merged) == aggmap(agg1)
