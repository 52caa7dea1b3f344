"""Host (numpy) finalize path vs the device finalize path: exact equality."""

import numpy as np
import jax.numpy as jnp

from bfc_jax.models import counter as C
from bfc_jax.ops import spectrum as spec
from bfc_jax.ops import spectrum_host as sph
from bfc_jax.opts import Opts

from . import datagen


def test_host_vs_device_finalize():
    genome = datagen.make_genome(6000, seed=71)
    reads = datagen.simulate_reads(genome, 1500, read_len=100, err_rate=0.02, seed=72)
    opt = Opts()
    opt.k = 19
    opt.bf_shift = 22
    agg, _ = C.count_stream_aggregate(iter(reads), opt, batch_reads=512)
    # device path
    shard, keybody, payload, keep, hist_d, hh_d = spec.finalize_counts(
        agg, opt.bf_shift, opt.n_hashes
    )
    keep = np.asarray(keep)
    dev = {
        (int(s), int(kb)): int(p)
        for s, kb, p, kp in zip(
            np.asarray(shard), np.asarray(keybody), np.asarray(payload), keep
        )
        if kp
    }
    # host path
    sh, kb, pl, hist_h, hh_h = sph.finalize_host(agg, opt.bf_shift, opt.n_hashes)
    host = {(int(a), int(b)): int(c) for a, b, c in zip(sh, kb, pl)}
    assert host == dev
    np.testing.assert_array_equal(np.asarray(hist_d), hist_h)
    np.testing.assert_array_equal(np.asarray(hh_d), hh_h)
    # table builds agree slot for slot
    s_bits = 13
    margin = 4096
    kbb = C.kops.keybody_bits(opt.k, opt.effective_l_pre())
    t_dev, n_dev, ms_dev = spec.build_table(
        shard, keybody, payload, jnp.asarray(keep), s_bits, margin,
        opt.effective_l_pre(), kbb,
    )
    kbp_h, shard_h, ms_h = sph.build_table_host(
        sh, kb, pl, s_bits, margin, opt.effective_l_pre(), kbb
    )
    np.testing.assert_array_equal(np.asarray(t_dev.kb_payload), kbp_h)
    np.testing.assert_array_equal(np.asarray(t_dev.shard), shard_h)
    assert int(ms_dev) == ms_h


def test_incremental_sketch_vs_sort_adjudicate(monkeypatch):
    """The span-incremental BloomMinSketch verdict must equal the
    one-shot sort adjudicate bit for bit, including under forced LSM
    spills (many partial-min folds) and u32-overflow fallback."""
    monkeypatch.setenv("BFC_MAX_MERGE_CAP", "2048")  # force spills
    genome = datagen.make_genome(8000, seed=91)
    reads = datagen.simulate_reads(genome, 2500, read_len=100,
                                   err_rate=0.02, seed=92)
    opt = Opts()
    opt.k = 19
    opt.bf_shift = 22
    agg, _ = C.count_stream_aggregate(iter(reads), opt, batch_reads=256)
    assert agg.bloom_min is not None and agg.bloom_min.valid
    sk_out = sph.finalize_host(agg, opt.bf_shift, opt.n_hashes)
    sort_out = sph.finalize_host(agg._replace(bloom_min=None),
                                 opt.bf_shift, opt.n_hashes)
    for a, b in zip(sk_out, sort_out):
        np.testing.assert_array_equal(a, b)
    # disabled by knob: no sketch is attached at all
    monkeypatch.setenv("BFC_INC_ADJ", "0")
    agg0, _ = C.count_stream_aggregate(iter(reads), opt, batch_reads=256)
    assert agg0.bloom_min is None
    off_out = sph.finalize_host(agg0, opt.bf_shift, opt.n_hashes)
    for a, b in zip(off_out, sort_out):
        np.testing.assert_array_equal(a, b)


def test_replay_adjudicate_matches_sort():
    """The C bit-array replay (human-scale adjudicate) == the sort."""
    import numpy as np

    from bfc_jax.ops import spectrum_host as sph

    rng = np.random.default_rng(99)
    for bf_shift, H, C in ((18, 4, 120000), (14, 3, 40000)):
        ret = rng.integers(0, 1 << 63, C, dtype=np.uint64)
        arr = rng.permutation(C).astype(np.uint64) * 3
        valid = rng.random(C) < 0.9
        want = sph.adjudicate_np(ret, arr, valid, bf_shift, H)
        got = sph.adjudicate_replay_np(ret, arr, valid, bf_shift, H)
        assert got is not None and (got == want).all()
