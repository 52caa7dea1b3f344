"""Device counting pass vs the exact scalar model."""

import random

import numpy as np
import jax.numpy as jnp
import pytest

from bfc_jax.models import counter as C
from bfc_jax.models import refmodel as M
from bfc_jax.opts import Opts

from . import datagen


@pytest.fixture(scope="module")
def dataset():
    genome = datagen.make_genome(8000, seed=5)
    reads = datagen.simulate_reads(genome, 2500, read_len=100, err_rate=0.012, seed=6)
    return reads


def _opts(k=17, bf_shift=22):
    opt = Opts()
    opt.k = k
    opt.bf_shift = bf_shift
    return opt


@pytest.mark.parametrize("k,bf_shift", [(17, 22), (33, 24)])
def test_device_table_matches_model(dataset, k, bf_shift):
    opt = _opts(k, bf_shift)
    _, ch = M.count_reads(iter(dataset), opt)
    ds = C.count_stream(iter(dataset), opt, batch_reads=600)
    model_entries = {(s, i): p for s, i, p in ch.items()}
    assert ds.n_entries == len(model_entries)
    shard, keybody, payload = ds.compact_entries()
    dev_entries = {
        (int(s), int(kb)): int(p) for s, kb, p in zip(shard, keybody, payload)
    }
    assert dev_entries == model_entries
    # histogram + mode parity
    cnt, high, mode = ch.hist()
    assert ds.mode == mode
    np.testing.assert_array_equal(ds.hist, np.array(cnt))
    np.testing.assert_array_equal(ds.hist_high, np.array(high))


def test_device_lookup_matches_model(dataset):
    opt = _opts(19, 23)
    _, ch = M.count_reads(iter(dataset), opt)
    ds = C.count_stream(iter(dataset), opt, batch_reads=600)
    rng = random.Random(3)
    # query k-mers from real reads plus random (mostly absent) ones
    queries = []
    for _ in range(3000):
        if rng.random() < 0.7:
            seq, _ = dataset[rng.randrange(len(dataset))]
            p = rng.randrange(0, len(seq) - opt.k)
            s = seq[p : p + opt.k]
            if "N" in s:
                continue
        else:
            s = "".join(rng.choice("ACGT") for _ in range(opt.k))
        x = M.kmer_null()
        for chh in s:
            M.kmer_append(opt.k, x, M.BASE_CODE[ord(chh)])
        _, h0, h1 = M.kmer_hash(opt.k, x)
        queries.append((h0, h1, ch.get(h0, h1)))
    h0s = jnp.asarray(np.array([q[0] for q in queries], np.uint64))
    h1s = jnp.asarray(np.array([q[1] for q in queries], np.uint64))
    got = np.asarray(ds.lookup_hash(h0s, h1s))
    want = np.array([q[2] for q in queries], np.int32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_single_device_lsm_spill_byte_exact(tmp_path, monkeypatch):
    """Force the single-device async LSM spill (worker thread + host
    merge tree) every couple of batches; output must stay byte-identical
    to the reference."""
    from bfc_jax.models import device_pipeline as DP

    from . import datagen, oracle

    monkeypatch.setenv("BFC_MAX_MERGE_CAP", str(1 << 15))
    fq = datagen.standard_dataset(
        str(tmp_path), genome_len=6000, n_reads=1600, name="sp.fq"
    )
    ref_out, _ = oracle.run_bfc(["-k17", "-b22", "-t1", fq])
    opt = Opts()
    opt.k = 17
    opt.bf_shift = 22
    mine = DP.run_device(opt, fq, batch_reads=256)
    assert mine.encode() == ref_out


def test_packed_pull_matches_unpacked():
    """pack_pull + packed_run_to_host_agg == run_to_host_agg on every
    payload-visible field (n/n_high saturate at 511/127, above every
    payload threshold; small counts here stay exact)."""
    import numpy as np

    from bfc_jax.models.counter import AggBuilder
    from bfc_jax.ops import kmer as kops

    opt = _opts(17, 22)
    b = AggBuilder(opt)
    seqs = ["ACGTACGTACGTACGTACGTAGGCA", "TTGCACGTACGTACGTACGTACGTA"] * 6
    bases, qok, lens = kops.encode_batch(seqs, None, opt.q, pad_to=32)
    b.add(bases, qok, lens)
    planes, g = b._pending
    cnt = int(g)
    want = b.sdn.run_to_host_agg(
        [np.asarray(p[:cnt]) for p in planes], cnt, b.k, b.l_pre
    )
    got = b._run_to_host((planes, cnt))
    for f in ("shard", "keybody", "n", "n_high", "first_arr", "first_high"):
        np.testing.assert_array_equal(
            getattr(want, f), getattr(got, f), err_msg=f
        )
    # ret is derivable here: dropped from the merge chain (None)
    assert got.ret is None
    from bfc_jax.ops.spectrum_dense import derive_ret_np

    np.testing.assert_array_equal(
        want.ret, derive_ret_np(got.shard, got.keybody, b.k, b.l_pre)
    )


def test_lsm_eager_spill_order_and_content():
    """Eager spill of merge-dead levels must preserve oldest-first span
    order: the tree's final aggregate equals the no-eager tree's."""
    from bfc_jax.ops.lsm import LsmTree

    def mk(eager):
        # runs are (sorted list of (key, arrival), count)
        def merge(a, b):
            if max(len(a[0]), len(b[0])) > 4:
                return None
            m = sorted(a[0] + b[0])
            return (m, len(m))

        def to_host(run):
            return list(run[0])

        def host_merge(a, b):
            # the LSM contract: `a` covers the strictly earlier span
            assert a[-1] < b[0], "span order violated"
            return a + b

        return LsmTree(merge=merge, to_host=to_host, host_merge=host_merge,
                       size=lambda r: r[1], eager_min=4 if eager else 0)

    runs = [([(i, i)], 1) for i in range(37)]
    out = []
    for eager in (False, True):
        t = mk(eager)
        for r in runs:
            t.push(r)
        acc, hacc = t.finish()
        assert acc is None
        out.append(hacc)
    assert out[0] == out[1]


def test_pull_run_carries_high_arrival_plane():
    """_pull_run skips the first_arr high-u32 plane only while it is
    provably zero (stream < 2^32 bases); past that it must transfer it."""
    import numpy as np

    from bfc_jax.models.counter import AggBuilder
    from bfc_jax.ops import kmer as kops

    opt = Opts()
    opt.k = 17
    opt.bf_shift = 22
    b = AggBuilder(opt)
    seqs = ["ACGTACGTACGTACGTACGTA"] * 4
    bases, qok, lens = kops.encode_batch(seqs, None, opt.q, pad_to=32)
    b.add(bases, qok, lens)
    planes, g = b._pending
    cnt = int(g)
    direct = [np.asarray(p[:cnt]).copy() for p in planes]
    # below the threshold: the a_hi plane substitutes zeros (and the
    # real plane is zero anyway, so the HostAgg is unchanged)
    got = b._pull_run(planes, cnt)
    for i, (d, h) in enumerate(zip(direct, got)):
        np.testing.assert_array_equal(d, h, err_msg=f"plane {i}")
    # above the threshold: every plane must come from the device
    b.arrival_base = 1 << 33
    got_hi = b._pull_run(planes, cnt)
    for i, (d, h) in enumerate(zip(direct, got_hi)):
        np.testing.assert_array_equal(d, h, err_msg=f"plane {i}")
