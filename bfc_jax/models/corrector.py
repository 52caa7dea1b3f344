"""Batched device correction driver (the correction pass).

Orchestrates the vectorized pipeline per read batch: conversion +
many-N gate -> coverage annotation -> best solid island (greedy
fallback) -> two-direction lockstep best-first search -> merge ->
output re-encoding.  Mirrors bfc_ec1 (/root/reference/correct.c:388-472)
read-for-read; reads that overflow the fixed device search capacities
are re-run on the exact scalar model (bfc_jax.models.refmodel).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..opts import Opts
from ..ops import annotate as ann
from ..ops import kmer as kops
from ..ops import search as srch
from ..ops import spectrum as spec
from . import refmodel as M
from .counter import DeviceSpectrum

I32 = jnp.int32

ECCODE_MISC = 1
ECCODE_MANY_N = 2
ECCODE_NO_SOLID = 3
ECCODE_UNCORR_N = 4
ECCODE_MANY_FAIL = 5


def make_config(opt: Opts, ds: DeviceSpectrum, stack_cap: int = 1000,
                iter_cap: int = 1024) -> srch.SearchConfig:
    """Search capacities sized from measured distributions (p99 stack
    ~185, p99 iterations ~205 for 100bp reads at 2% error); overflowing
    reads fall back to the exact scalar model."""
    import os

    ff_step = int(os.environ.get("BFC_FF_STEP", "63"))
    fused = os.environ.get("BFC_FUSED_DIRS", "1") == "1"
    ff_fold = os.environ.get("BFC_FF_FOLD", "1") == "1"
    ff_paths = os.environ.get("BFC_FF_PATHS", "1") == "1"
    return srch.SearchConfig(
        k=opt.k, min_cov=opt.min_cov, win_multi_ec=opt.win_multi_ec,
        max_end_ext=opt.max_end_ext, w_ec=opt.w_ec, w_ec_high=opt.w_ec_high,
        w_absent=opt.w_absent, w_absent_high=opt.w_absent_high,
        max_path_diff=opt.max_path_diff, max_heap=opt.max_heap,
        heap_cap=128, stack_cap=stack_cap, iter_cap=iter_cap,
        s_bits=ds.s_bits, l_pre=ds.l_pre, kb_bits=ds.kb_bits,
        packed=ds.packed, ff_step=ff_step, fused_dirs=fused,
        ff_fold=ff_fold, ff_paths=ff_paths,
    )


def rev_rows(vals, lens):
    """Per-row reversal out[b, j] = v[b, lens[b]-1-j] as i32, 0 where
    j >= lens[b], for each [B, L] array in vals."""
    L = vals[0].shape[1]
    j = jnp.arange(L, dtype=I32)
    ridx = lens[:, None] - 1 - j[None, :]
    ok = ridx >= 0
    ridx = jnp.maximum(ridx, 0)
    return [
        jnp.where(ok, jnp.take_along_axis(v, ridx, axis=1).astype(I32), 0)
        for v in vals
    ]


@functools.partial(jax.jit, static_argnames=("cfg", "save_state"))
def correct_core(table, cfg: srch.SearchConfig, seq_b, seq_q, lens, mode,
                 soft_cap=None, save_state: bool = False):
    """Device correction of one batch.

    seq_b: u8 [B,L] converted bases (refine substitution already applied
    by the host); seq_q: bool [B,L] quality flags; mode: i32 scalar
    coverage peak.  Returns a dict of per-read outputs."""
    B, L = seq_b.shape
    k = cfg.k
    r = jnp.arange(B, dtype=jnp.int32)
    idx = jnp.arange(L, dtype=jnp.int32)
    inb = idx[None, :] < lens[:, None]
    ob = seq_b  # conversion sets b == ob (correct.c:31)

    # many-N gate (correct.c:397-401); float64 to match the C double test
    n_n = jnp.sum((ob > 3) & inb, axis=1)
    many_n = n_n.astype(jnp.float64) > lens.astype(jnp.float64) * 0.05

    # window planes computed ONCE: kcov, the greedy island hops, and the
    # search precompute all share them (the log2(k) window packing costs
    # ~ms per [B,L] recompute and used to run once per greedy trip).
    # u32 planes for k <= 31: keeps every downstream probe's index
    # dataflow in 32-bit arithmetic (ops.spectrum.cuckoo_lookup32)
    planes = kops.kmer_planes(seq_b, k, jnp.uint32 if k <= 31 else jnp.uint64)
    solid_end, high_end, lcov, hcov, occv, kovf = ann.kcov_batch(
        table, seq_b, lens, k, cfg.l_pre, cfg.s_bits, cfg.kb_bits, cfg.min_cov,
        cfg.axis_name, cfg.n_dev, slack=cfg.route_slack, planes=planes,
    )
    isl_start, isl_end, isl_found = ann.best_island_batch(solid_end, lens, k)

    # ---- greedy fallback for reads with no solid k-mer (correct.c:406-421)
    #
    # POOLED: no-island reads are rare (~0.1-1%), but an island-hop
    # loop over every lane would probe 4k candidates for all B lanes per
    # hop.  The loop runs on a fixed G-lane pool of the needy reads;
    # reads beyond the pool take the exact scalar fallback (the
    # overflow contract, byte-identical).
    need_greedy = ~many_n & ~isl_found
    import os as _os

    if _os.environ.get("BFC_PROBE_NO_GREEDY", "0") == "1":
        # measurement-only (trace-time): skip the greedy loop entirely
        # to expose its share of the per-batch fixed cost
        need_greedy = need_greedy & False
    # pool size knob: batches with more than G no-solid-kmer reads
    # (high-error/contaminated input) route the excess through the
    # scalar fallback (byte-exact but slow) - raise it for such inputs
    G = min(int(_os.environ.get("BFC_GREEDY_POOL", "1024")), B)
    ordg = spec.stable_order((~need_greedy).astype(jnp.uint32))
    pool_ids = ordg[:G].astype(I32)
    pool_on = need_greedy[pool_ids]
    in_pool = jnp.zeros((B,), bool).at[pool_ids].set(pool_on)
    pool_lens = lens[pool_ids]
    g_start = jnp.zeros((B,), I32)
    g_ec_p = jnp.full((G,), -1, I32)
    g_end_p = jnp.zeros((G,), I32)
    p_active = pool_on
    g_ovf = jnp.zeros((), bool)
    if cfg.axis_name:
        # constants must be marked device-varying to match the loop
        # body's outputs under shard_map
        g_start, g_ec_p, g_end_p, g_ovf = srch._pvary_all(
            (g_start, g_ec_p, g_end_p, g_ovf), cfg.axis_name
        )

    def _gany(act):
        """Globally-reduced 'any device still active' (sharded table:
        the loop body contains collectives, so all devices must run the
        same trip count)."""
        a = jnp.any(act)
        if cfg.axis_name:
            a = jax.lax.psum(a.astype(I32), cfg.axis_name) > 0
        return a

    def g_cond(c):
        return c[5]

    def g_body(c):
        p_active, g_start, g_ec_p, g_end_p, g_ovf, _ = c
        end_pos, x0, x1, x2, x3, found = ann.first_kmer_batch(
            seq_b, lens, g_start, k, planes=planes
        )
        pe = end_pos[pool_ids]
        pf = found[pool_ids]
        ec, ovf1 = ann.greedy_k_batch(
            table, x0[pool_ids], x1[pool_ids], x2[pool_ids], x3[pool_ids],
            mode, k, cfg.l_pre, cfg.s_bits, cfg.kb_bits,
            cfg.axis_name, cfg.n_dev, slack=cfg.route_slack,
            valid=p_active & pf,
        )
        g_ovf = g_ovf | ovf1
        ec = jnp.where(pf, ec, -1)
        hit = p_active & pf & (ec >= 0)
        g_ec_p = jnp.where(hit, ec, g_ec_p)
        g_end_p = jnp.where(p_active, pe, g_end_p)
        stop = p_active & (~pf | hit | (pe + (k >> 1) >= pool_lens))
        adv = p_active & ~stop
        g_start = g_start.at[jnp.where(adv, pool_ids, B)].set(
            jnp.where(adv, pe - (k >> 1), 0), mode="drop"
        )
        p_active = p_active & ~stop
        return p_active, g_start, g_ec_p, g_end_p, g_ovf, _gany(p_active)

    p_active, g_start, g_ec_p, g_end_p, g_ovf, _ = jax.lax.while_loop(
        g_cond, g_body,
        (p_active, g_start, g_ec_p, g_end_p, g_ovf, _gany(p_active)),
    )
    g_ec = jnp.full((B,), -1, I32).at[pool_ids].set(
        jnp.where(pool_on, g_ec_p, -1)
    )
    g_end = jnp.zeros((B,), I32).at[pool_ids].set(
        jnp.where(pool_on, g_end_p, 0)
    )
    greedy_ok = need_greedy & (g_ec >= 0)
    no_solid = need_greedy & ~greedy_ok & in_pool
    pool_miss = need_greedy & ~in_pool  # pool overflow: scalar fallback
    # apply the greedy fix: seq[end - (ec>>2)].b = ec&3 (correct.c:415)
    fix_pos = jnp.where(greedy_ok, g_end - (g_ec >> 2), L + 1)
    seq_fix = seq_b.at[r, fix_pos].set(
        (jnp.maximum(g_ec, 0) & 3).astype(seq_b.dtype), mode="drop"
    )
    start = jnp.where(greedy_ok, g_end + 1 - k, isl_start)
    end = jnp.where(greedy_ok, g_end + 1, isl_end)

    searchable = ~many_n & ~no_solid
    # ---- fast-forward window bits, derived once from the kcov occ pass
    # (canonical hashing is strand-independent, so the reverse
    # direction's bits are a reversal + static k-1 shift of the forward
    # ones); windows overlapping the greedy fix are marked stale so
    # fast-forward defers to the exact in-loop lookup there
    use_ffbits = cfg.ff_step > 0 and L <= 160
    win_f = win_r = None
    if use_ffbits:
        w_cnthi = (occv & 0xFF) >= cfg.min_cov + 1  # occ -1 reads 255 (quirk)
        w_abs = (occv < 0) | ((occv & 0xFF) < cfg.min_cov)
        w_absh = (occv < 0) | (((occv >> 8) & 0xFF) < cfg.min_cov)
        ff_ok = ~(
            (idx[None, :] >= fix_pos[:, None])
            & (idx[None, :] < fix_pos[:, None] + k)
        )
        win_f = (w_cnthi, w_abs, w_absh, ff_ok)
    # ---- reverse-complement direction inputs over [n-end, n)
    srr, qrr, lrr, hrr = rev_rows([seq_fix, seq_q, lcov, hcov], lens)
    seq_r = jnp.where(inb, jnp.where(srr < 4, 3 - srr, srr), 4).astype(seq_b.dtype)
    q_r = inb & (qrr > 0)
    lcov_r = jnp.where(inb, lrr, 0)
    hcov_r = jnp.where(inb, hrr, 0)
    start_r = lens - end
    if use_ffbits:
        # reverse coords: window ending at j <=> forward window ending
        # at lens+k-2-j; shifted-in (j < k-1) windows are invalid, whose
        # occ==-1 semantics are all-True bits (the 255 quirk)
        rbits = rev_rows([w_cnthi, w_abs, w_absh, ff_ok], lens)
        ones = jnp.ones((B, k - 1), jnp.int32)
        win_r = tuple(
            jnp.concatenate([ones, a], axis=1)[:, :L] > 0 for a in rbits
        )
    if cfg.fused_dirs:
        # ---- both directions as ONE [2B]-lane lockstep loop.  Legal
        # because direction 2 reads only pre-search inputs; its outputs
        # for lanes whose forward pass failed (~ok0) are discarded below
        # exactly as the reference never runs them (correct.c:429-431),
        # so the output bytes are identical.  The win: the per-trip
        # fixed overhead of the while loop is paid once per batch, not
        # once per direction.
        cat = lambda a, b: jnp.concatenate([a, b], axis=0)
        win_cat = (
            tuple(cat(a, b) for a, b in zip(win_f, win_r))
            if win_f is not None else None
        )
        res = srch.ec1dir_batch(
            table, cfg, cat(seq_fix, seq_r), cat(seq_q, q_r),
            cat(seq_q, q_r), cat(lcov, lcov_r), cat(hcov, hcov_r),
            cat(lens, lens), cat(start, start_r),
            cat(searchable, searchable), win_bits=win_cat,
            soft_cap=soft_cap, save_state=save_state,
        )
        ecC, naC, rvC, mhC, ovC, rsC, itC, rvfC = res[:8]
        bundle = res[8] if save_state else None
        ec0, ec1r = ecC[:B], ecC[B:]
        na0, na1 = naC[:B], naC[B:]
        rv0, rv1 = rvC[:B], rvC[B:]
        mh0, mh1 = mhC[:B], mhC[B:]
        ov0, ov1 = ovC[:B], ovC[B:]
        rs0l, rs1l = rsC[:B], rsC[B:]
        it0 = it1 = itC
        s_rovf = rvfC
    else:
        # ---- forward direction over [start, n)
        assert not save_state, "state-resume requires fused_dirs"
        ec0, na0, rv0, mh0, ov0, rs0l, it0, rovf0 = srch.ec1dir_batch(
            table, cfg, seq_fix, seq_q, seq_q, lcov, hcov, lens, start,
            searchable, win_bits=win_f, soft_cap=soft_cap,
        )
        ok0_ = searchable & (rv0 >= 0) & ~ov0
        ec1r, na1, rv1, mh1, ov1, rs1l, it1, rovf1 = srch.ec1dir_batch(
            table, cfg, seq_r, q_r, q_r, lcov_r, hcov_r, lens, start_r,
            ok0_, win_bits=win_r, soft_cap=soft_cap,
        )
        bundle = None
        s_rovf = rovf0 | rovf1
    ok0 = searchable & (rv0 >= 0) & ~ov0
    # direction-2 results for ~ok0 lanes are discarded here: ok1 gates
    # every merged output, and failed-read stats are zeroed at pack time
    # (finalize_batch_arrays), so fused-mode garbage in na1/mh1/rv1 for
    # those lanes never reaches the output bytes
    ok1 = ok0 & (rv1 >= 0) & ~ov1
    # flip direction-2 output back (complement bases < 4)
    (ec1b,) = rev_rows([ec1r], lens)
    ec1b = jnp.where(inb, jnp.where(ec1b < 4, 3 - ec1b, ec1b), 4).astype(jnp.uint8)

    # ---- merge the two directions (correct.c:443-450)
    agree = ec0 == ec1b
    merged = jnp.where(
        agree,
        jnp.where(ec0 > 3, seq_fix, ec0),
        jnp.where(
            ec1b > 3, ec0, jnp.where(ec0 > 3, ec1b, ob)
        ),
    )
    final_b = jnp.where(ok1[:, None] & inb, merged, seq_b)
    is_diff = (final_b != ob) & inb & ok1[:, None]
    n_ec = jnp.sum(is_diff, axis=1)
    n_ec_high = jnp.sum(is_diff & seq_q, axis=1)
    # pack the four per-base output planes into ONE u8 plane: the
    # device->host pull (and the multi-host allgather) carries 1 byte
    # per base instead of 4
    packed_bq = (
        final_b.astype(jnp.uint8)
        | (is_diff.astype(jnp.uint8) << 3)
        | (seq_q.astype(jnp.uint8) << 4)
        | (ob.astype(jnp.uint8) << 5)
    )

    # ---- status assembly (correct.c:425-435)
    def code_of(rv):
        return jnp.where(rv == -2, ECCODE_UNCORR_N,
                         jnp.where(rv == -3, ECCODE_MANY_FAIL, ECCODE_MISC))

    ec_code = jnp.zeros((B,), I32)
    ec_code = jnp.where(~ok1, code_of(rv1), ec_code)
    ec_code = jnp.where(~ok0, code_of(rv0), ec_code)
    ec_code = jnp.where(no_solid, ECCODE_NO_SOLID, ec_code)
    ec_code = jnp.where(many_n, ECCODE_MANY_N, ec_code)
    # routing-bucket overflows poison the whole local batch's lookups:
    # push every read to the exact scalar fallback (rare; capacity 2x).
    # ov1 is masked by ok0: a fused-mode direction-2 overflow on a lane
    # whose forward pass already failed is discarded, matching the
    # non-fused path where direction 2 never runs there
    overflow = ((ov0 | (ov1 & ok0)) & searchable) | kovf | g_ovf | pool_miss
    # scalar routing-bucket overflow: the driver retries the whole batch
    # with doubled slack (compiled once per slack) before any per-read
    # scalar fallback (count.c:42-52 insbuf retry ethos)
    route_ovf = kovf | g_ovf | s_rovf
    extra = {}
    if save_state:
        # state-resume classification: an overflowed read is resumable
        # iff every overflow that CONTRIBUTED to it is an iteration-cap
        # overflow (clean trip boundary).  A rev-direction overflow only
        # contributes when the forward pass succeeded (ok0), matching
        # the overflow definition above; kcov/greedy/pool overflows are
        # never resumable.
        bad = (ov0 & ~rs0l) | (ov1 & ok0 & ~rs1l)
        extra["resum"] = overflow & ~bad & ~(kovf | g_ovf | pool_miss)
        st_s, pl_s, alive_s, nohave_s = bundle
        extra["bundle"] = dict(
            st=st_s, pl=pl_s, alive=alive_s, nohave=nohave_s,
            start2=jnp.concatenate([start, start_r], axis=0),
            ob=ob, brute_in=greedy_ok, lens=lens,
        )
    return dict(
        **extra,
        packed_bq=packed_bq,
        ec_code=ec_code, brute=greedy_ok.astype(I32),
        n_ec=n_ec.astype(I32), n_ec_high=n_ec_high.astype(I32),
        n_absent=(na0 + na1).astype(I32),
        max_heap=jnp.maximum(mh0, mh1).astype(I32),
        overflow=overflow,
        it=jnp.stack([it0, it1]),  # per-direction lockstep trip counts
        route_ovf=route_ovf[None],  # [1]: stacks per-device under shard_map
    )


@functools.partial(jax.jit, static_argnames=("cfg", "mesh_ref"))
def correct_core_sharded(table, cfg: srch.SearchConfig, seq_b, seq_q, lens,
                         mode, mesh_ref, soft_cap=None):
    """correct_core under shard_map: reads data-parallel over the mesh,
    the spectrum slot-sharded (each device holds 1/n_dev of the cuckoo
    entries); every lookup routes slot requests with a paired all_to_all
    (the reference's hash-prefix table sharding, htab.c:28-33, as a
    collective).  cfg.axis_name/n_dev must be set so the search and
    greedy loops run globally-synchronized trip counts."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def step(lo_local, hi_local, seq_b, seq_q, lens, mode, sc):
        t = spec.ShardedCuckoo(lo=lo_local, hi=hi_local)
        return correct_core(t, cfg, seq_b, seq_q, lens, mode, soft_cap=sc)

    sc = jnp.int32(cfg.iter_cap if soft_cap is None else soft_cap)
    return shard_map(
        step, mesh=mesh_ref.mesh,
        in_specs=(P("d"), P("d"), P("d"), P("d"), P("d"), P(), P()),
        out_specs=P("d"),
    )(table.lo, table.hi, seq_b, seq_q, lens, mode, sc)


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BatchResult:
    """Vectorized per-batch results: final ASCII rows + packed stats.

    seq_rows/qual_rows are uint8 [n, Lrow] matrices holding the output
    text (sliced by lens); aux/aux2 are the reference's packed stat
    words (correct.c:552-553); code is the ec_code (aux & 7).  Reads in
    `exceptional` (device-capacity overflows re-run on the scalar
    model) carry their full (EcStat, seq, qual) tuple instead."""

    n: int
    lens: np.ndarray
    seq_rows: np.ndarray
    qual_rows: np.ndarray
    aux: np.ndarray
    aux2: np.ndarray
    code: np.ndarray
    has_q: np.ndarray
    text_of: object
    exceptional: dict
    requeue: list = dataclasses.field(default_factory=list)
    # soft-pass reads whose ONLY overflow was the iteration cap: they
    # resume from saved state (models/resume.py) instead of re-running
    requeue_resume: list = dataclasses.field(default_factory=list)
    # multi-host: only rank 0 assembles/emits output text; other ranks
    # carry control-flow results only (requeue, overflow, codes) and
    # dummy row matrices - never read their text fields
    emit: bool = True

    def tuple_of(self, i: int):
        """Legacy per-read view: (EcStat, seq, qual)."""
        if i in self.exceptional:
            return self.exceptional[i]
        code = int(self.code[i])
        brute = int(self.aux[i] >> np.uint64(3)) & 1
        if code != 0:
            st = M.EcStat(ec_code=code, brute=brute)
            s_in, q_in = self.text_of(i)
            return (st, s_in, q_in)
        a, a2 = int(self.aux[i]), int(self.aux2[i])
        st = M.EcStat(
            ec_code=0, brute=brute,
            n_ec=(a >> 18) & 0x3FFF, n_ec_high=(a >> 4) & 0x3FFF,
            n_absent=a2 >> 10, rf_code=0, max_heap=a2 & 0xFF,
        )
        ln = int(self.lens[i])
        s2 = self.seq_rows[i, :ln].tobytes().decode("ascii")
        q2 = (
            self.qual_rows[i, :ln].tobytes().decode("ascii")
            if self.has_q[i] else None
        )
        return (st, s2, q2)


@dataclasses.dataclass
class WindowResult:
    """correct_many results scattered back to input order, as arrays."""

    n: int
    lens: np.ndarray
    seq_rows: np.ndarray
    qual_rows: np.ndarray
    aux: np.ndarray
    aux2: np.ndarray
    code: np.ndarray
    has_q: np.ndarray
    text_of: object
    exceptional: dict
    emit: bool = True

    tuple_of = BatchResult.tuple_of


class Corrector:
    def __init__(self, opt: Opts, ds: DeviceSpectrum, stack_cap: int = 1000,
                 iter_cap: int = 1024, mesh=None):
        import os

        self.opt = opt
        self.ds = ds
        self.cfg = make_config(opt, ds, stack_cap, iter_cap)
        self._model_ch: Optional[M.CountHash] = None
        self.n_scalar_fallback = 0  # reads corrected by _scalar_ec1
        self.mesh = mesh  # data-parallel correction over a device mesh
        if mesh is not None and isinstance(ds.table, spec.ShardedCuckoo):
            self.cfg = self.cfg._replace(
                axis_name="d", n_dev=int(mesh.shape["d"])
            )
        # soft-capped first pass: the lockstep loop runs to the batch's
        # max lane, and every batch carries a long iteration tail (most
        # lanes finish well before the max trip count), so window batches
        # run with a SMALL iteration cap and the "straggler" reads that
        # hit it are re-batched once at full caps (exact same per-read
        # search; see correct_many).  The cap is a TRACED scalar (no
        # recompile) adapted per batch toward ~10% stragglers.  0 disables.
        self._soft_cap = int(os.environ.get("BFC_SOFT_ITERS", "64"))
        # sharded-lookup bucket slack; doubled (sticky) on routing
        # overflow and the batch re-dispatched - one compile per slack,
        # only ever paid under pathological key skew
        self._route_slack = self.cfg.route_slack
        # the soft pass also runs with a small stack pool: every pool
        # write/extract is a dense pass over [B, stack_cap], and p99
        # stack depth is ~185, so a 256-slot pool is 4x cheaper than the
        # full 1000; stack-overflow reads ride the same requeue path
        soft_stack = int(os.environ.get("BFC_SOFT_STACK", "256"))
        self.cfg_main = (
            self.cfg._replace(stack_cap=soft_stack)
            if 0 < soft_stack < stack_cap else self.cfg
        )
        # state-resume straggler scheduling (models/resume.py): the soft
        # pass saves its search state and iteration-capped reads resume
        # from the saved trip boundary instead of re-running the whole
        # search at full caps.  Single-host, local-table, fused-dirs
        # only; every other configuration keeps the re-batch path.
        self._resume = (
            os.environ.get("BFC_RESUME", "1") == "1"
            and self._soft_cap > 0
            and self.cfg.fused_dirs
            and mesh is None
            and not isinstance(ds.table, spec.ShardedCuckoo)
        )

    def prewarm(self, batch_reads: int, read_len: int = 100) -> None:
        """Compile the hot device programs for a production stream.

        Two programs dominate cold-start latency (the lockstep search
        is the largest program to compile): the soft-capped main pass at
        batch_reads and the full-cap straggler pass at batch_reads//4.
        They are DIFFERENT executables (cfg + shape), so compile them in
        parallel threads - XLA releases the GIL during compilation and
        the host has cores to spare (the reference binary needs no
        warm-up at all, bfc.c:77; this halves the gap)."""
        import threading

        L = max(read_len, 1)

        def mk(n):
            # hash-diverse dummy reads: constant bases would aim every
            # sharded-table lookup at ONE prefix owner and trip the
            # routing-overflow retry during warm-up
            rng = np.random.default_rng(0xBFC)
            bases = rng.integers(0, 4, (n, L)).astype(np.uint8)
            rawq = np.full((n, L), 70, np.uint8)
            lens = np.full((n,), L, np.int32)
            has_q = np.ones((n,), bool)
            return bases, rawq, lens, has_q

        def run(n, soft):
            b, q, l, h = mk(n)
            # prewarm=True: random reads have no solid k-mers, so nearly
            # every lane pool-misses; the scalar-fallback loop (and the
            # full scalar CountHash mirror it builds) would burn host
            # CPU inside the very cold-start window prewarm shrinks
            ctx = self.dispatch_arrays(
                b, q, l, h, lambda i: ("A" * L, None),
                soft=soft, min_b=n, prewarm=True,
            )
            self.finalize_batch_arrays(ctx)
            if soft and ctx.get("bundle") is not None:
                # compile the absorb + resume programs too (the resume
                # pool shapes are fixed per batch size); the absorbed
                # read's saved state is done, so the dispatch is cheap
                from . import resume as RES

                rp = RES.ResumePool(max(n // 8, 256))
                rp.absorb(self, ctx["bundle"], [0], [0])
                for r_out, _w in rp.flush_all(self):
                    jax.block_until_ready(r_out["packed_bq"])

        th = [
            threading.Thread(
                target=run, args=(max(batch_reads // 4, 256), False),
                name="bfc-prewarm-full",
            ),
            threading.Thread(
                target=run, args=(batch_reads, True), name="bfc-prewarm-soft",
            ),
        ]
        for t in th:
            t.start()
        for t in th:
            t.join()

    def _fallback_table(self) -> M.CountHash:
        """Scalar CountHash mirror for overflow fallback (built lazily)."""
        if self._model_ch is None:
            ch = M.CountHash(self.ds.k, self.ds.l_pre)
            shard, keybody, payload = self.ds.compact_entries()
            for s, kb, p in zip(shard, keybody, payload):
                ch.shards[int(s)][int(kb)] = int(p)
            self._model_ch = ch
        return self._model_ch

    def _scalar_ec1(self, seq: str, qual: Optional[str]):
        """Correct one read that overflowed a device capacity on the
        exact scalar model; counted in n_scalar_fallback."""
        self.n_scalar_fallback += 1
        return M.ec1(self.opt, self._fallback_table(), self.ds.mode, seq,
                     qual)

    def correct_batch(self, seqs: List[str], quals: List[Optional[str]]):
        """Correct a batch of python strings; returns [(EcStat, seq, qual)]."""
        return self.finalize_batch(self.dispatch_batch(seqs, quals))

    def dispatch_batch(self, seqs: List[str], quals: List[Optional[str]]):
        """Encode + launch the device step for a batch of strings."""
        opt = self.opt
        n = len(seqs)
        bases0, _, lens0 = kops.encode_batch(seqs, None, opt.q)
        L0 = bases0.shape[1] if bases0.size else 1
        rawq0 = np.zeros((n, L0), np.uint8)
        has_q = np.array([q is not None for q in quals], bool)
        if has_q.any():
            rows = np.repeat(np.arange(n), lens0)
            offs = np.concatenate([[0], np.cumsum(lens0)[:-1]])
            cols = np.arange(int(lens0.sum())) - np.repeat(offs, lens0)
            flat_q = np.frombuffer(
                "".join(q if q is not None else "\x00" * l
                        for q, l in zip(quals, lens0)).encode("latin-1"),
                np.uint8,
            )
            rawq0[rows, cols] = flat_q

        def text_of(i):
            return seqs[i], quals[i]

        return self.dispatch_arrays(bases0, rawq0, lens0, has_q, text_of)

    def correct_arrays(self, bases0, rawq0, lens0, has_q, text_of):
        return self.finalize_batch(
            self.dispatch_arrays(bases0, rawq0, lens0, has_q, text_of)
        )

    def correct_many(self, bases0, rawq0, lens0, has_q, text_of,
                     batch_reads: int, bucketed: bool = True,
                     as_arrays: bool = False):
        """Correct a window of reads; results in input order.

        With bucketed=True, reads are ordered by a difficulty proxy
        (count of low-quality bases - errors are low-quality, and the
        lockstep search runs to the max iteration count in the batch)
        before being cut into device batches, so easy batches drain in
        few iterations instead of tracking the window's worst read.
        One batch is kept in flight (dispatch/finalize overlap).

        as_arrays=True returns a WindowResult (batch matrices scattered
        back to input order, for the native formatter); falls back to
        the per-read tuple list when any sub-batch took the direct
        scalar path."""
        n = len(lens0)
        if n == 0:
            return None if as_arrays else []
        if bucketed and n > batch_reads:
            L0 = rawq0.shape[1]
            inb = np.arange(L0)[None, :] < lens0[:, None]
            lowq = ((rawq0.astype(np.int32) - 33) < self.opt.q) & inb
            proxy = np.where(has_q, lowq.sum(axis=1), lens0)
            order = np.argsort(proxy, kind="stable")
        else:
            order = np.arange(n)
        win: Optional[WindowResult] = None
        results: List = [None] * n
        stragglers: List[int] = []  # window indices re-batched at full caps
        import os as _os2

        rp = None  # straggler resume pool (models/resume.py), lazy
        rp_P = int(_os2.environ.get("BFC_RESUME_POOL", "0")) or max(
            batch_reads // 8, 256
        )

        def land_flush(fr):
            """Land one resume dispatch: scatter occupied rows into win,
            route its own overflows (scalar / full re-batch)."""
            nonlocal win
            r_out, wids = fr
            occ = wids >= 0
            P = len(wids)
            lens_p = np.zeros((P,), np.int32)
            lens_p[occ] = np.asarray(lens0)[wids[occ]]
            hq_p = np.zeros((P,), bool)
            hq_p[occ] = np.asarray(has_q)[wids[occ]]
            ctx2 = dict(
                out=r_out, n=P, lens=lens_p, has_q=hq_p,
                text_of=lambda j: text_of(int(wids[j])),
                soft=False, resume=True,
            )
            br2 = self.finalize_batch_arrays(ctx2)
            rows = np.nonzero(occ)[0]
            sel2 = wids[rows]
            Lb = br2.seq_rows.shape[1]
            if Lb > win.seq_rows.shape[1]:  # sticky pad grew
                ns = np.zeros((n, Lb), np.uint8)
                nq = np.zeros((n, Lb), np.uint8)
                ns[:, : win.seq_rows.shape[1]] = win.seq_rows
                nq[:, : win.qual_rows.shape[1]] = win.qual_rows
                win.seq_rows, win.qual_rows = ns, nq
            win.seq_rows[sel2, :Lb] = br2.seq_rows[rows]
            win.qual_rows[sel2, :Lb] = br2.qual_rows[rows]
            win.aux[sel2] = br2.aux[rows]
            win.aux2[sel2] = br2.aux2[rows]
            win.code[sel2] = br2.code[rows]
            for i, t in br2.exceptional.items():
                if occ[i]:
                    win.exceptional[int(wids[i])] = t
            for i in br2.requeue:
                if occ[i]:
                    stragglers.append(int(wids[i]))

        def land(ctx, sel):
            nonlocal win, as_arrays
            if as_arrays:
                br = self.finalize_batch_arrays(ctx)
                if br is not None:
                    if win is None:
                        Lw = br.seq_rows.shape[1]
                        win = WindowResult(
                            n=n, lens=np.asarray(lens0),
                            seq_rows=np.zeros((n, Lw), np.uint8),
                            qual_rows=np.zeros((n, Lw), np.uint8),
                            aux=np.zeros((n,), np.uint64),
                            aux2=np.zeros((n,), np.uint64),
                            code=np.zeros((n,), np.int64),
                            has_q=np.asarray(has_q),
                            text_of=text_of, exceptional={},
                            emit=br.emit,
                        )
                    Lb = br.seq_rows.shape[1]
                    if Lb > win.seq_rows.shape[1]:  # sticky pad grew
                        ns = np.zeros((n, Lb), np.uint8)
                        nq = np.zeros((n, Lb), np.uint8)
                        ns[:, : win.seq_rows.shape[1]] = win.seq_rows
                        nq[:, : win.qual_rows.shape[1]] = win.qual_rows
                        win.seq_rows, win.qual_rows = ns, nq
                    win.seq_rows[sel, :Lb] = br.seq_rows
                    win.qual_rows[sel, :Lb] = br.qual_rows
                    win.aux[sel] = br.aux
                    win.aux2[sel] = br.aux2
                    win.code[sel] = br.code
                    for i, t in br.exceptional.items():
                        win.exceptional[int(sel[i])] = t
                    for i in br.requeue:
                        stragglers.append(int(sel[i]))
                    if br.requeue_resume:
                        nonlocal rp
                        from . import resume as RES

                        if rp is None:
                            rp = RES.ResumePool(rp_P)
                        for fr in rp.absorb(
                            self, ctx["bundle"], br.requeue_resume,
                            [int(sel[i]) for i in br.requeue_resume],
                        ):
                            land_flush(fr)
                    if ctx.get("soft"):
                        # raise the cap when stragglers exceed ~10%; never
                        # decay - batches arrive easy-to-hard (difficulty
                        # bucketing), so a cap that was enough for an easy
                        # batch underestimates the next one.
                        # BFC_SOFT_ESC=0 pins the cap (probe knob:
                        # with state-resume the escalation is no longer
                        # load-bearing for correctness or completion)
                        frac = (len(br.requeue) + len(br.requeue_resume)
                                ) / max(br.n, 1)
                        if frac > 0.10 and os.environ.get(
                                "BFC_SOFT_ESC", "1") == "1":
                            self._soft_cap = min(
                                self._soft_cap * 2, self.cfg.iter_cap
                            )
                    return
                # direct scalar sub-batch (reads > 504 bp): downgrade the
                # whole window to per-read tuples
                as_arrays = False
                if win is not None:
                    if rp is not None:  # pooled resumes: exact scalar path
                        for j in list(rp.wids):
                            win.exceptional[j] = self._scalar_ec1(*text_of(j))
                        rp.pool, rp.wids = None, []
                    for j in stragglers:  # no re-batch stage in tuple mode
                        win.exceptional[j] = self._scalar_ec1(*text_of(j))
                    stragglers.clear()
                    for j in landed_sels:
                        results[j] = win.tuple_of(j)
                    win = None
                for j, res in enumerate(ctx["direct"]):
                    results[sel[j]] = res
                return
            for j, res in enumerate(self.finalize_batch(ctx)):
                results[sel[j]] = res

        import os
        import time as _t

        timing = os.environ.get("BFC_TIMING")
        landed_sels: List[int] = []
        pending = None  # (ctx, orig indices)
        for off in range(0, n, batch_reads):
            t0 = _t.time()
            sel = order[off : off + batch_reads]
            ctx = self.dispatch_arrays(
                bases0[sel], rawq0[sel], lens0[sel], has_q[sel],
                lambda j, sel=sel: text_of(int(sel[j])),
                soft=as_arrays,
            )
            t1 = _t.time()
            if pending is not None:
                land(*pending)
                landed_sels.extend(int(x) for x in pending[1])
            if timing:
                from ..utils.log import log

                log(f"dispatch {t1-t0:.3f}s land {_t.time()-t1:.3f}s "
                    f"cap={self._soft_cap} stragglers={len(stragglers)}",
                    func="correct_many")
            pending = (ctx, sel)
        t1 = _t.time()
        land(*pending)
        if timing:
            from ..utils.log import log

            log(f"final land {_t.time()-t1:.3f}s stragglers={len(stragglers)}",
                func="correct_many")
        # drain the resume pool: every batch has landed, so every
        # resumable straggler is pooled; their continuations finish (or
        # route to the full-cap re-batch / scalar paths) before the
        # re-batch stage below runs
        if as_arrays and rp is not None:
            for fr in rp.flush_all(self):
                land_flush(fr)
        # straggler pass: reads that overflowed a NON-resumable capacity
        # (stack/penalty/heap, or a resume that outgrew the soft stack)
        # re-run once at full caps (byte-identical per-read search; only
        # batch composition changes).  Chunked at batch_reads//4 so
        # stragglers add exactly one device shape (compiled once per
        # process)
        s_chunk = max(batch_reads // 4, 256)
        while as_arrays and stragglers:
            todo, stragglers = stragglers, []
            sarr = np.asarray(todo)
            for off in range(0, len(sarr), s_chunk):
                sel = sarr[off : off + s_chunk]
                # min_b pins the device shape to s_chunk: a short last
                # chunk must not compile a fresh smaller program
                ctx = self.dispatch_arrays(
                    bases0[sel], rawq0[sel], lens0[sel], has_q[sel],
                    lambda j, sel=sel: text_of(int(sel[j])),
                    min_b=s_chunk,
                )
                land(ctx, sel)
        if as_arrays and win is not None:
            return win
        return results

    def dispatch_arrays(self, bases0, rawq0, lens0, has_q, text_of,
                        soft: bool = False, min_b: int = 256,
                        prewarm: bool = False):
        """Launch the device step for an encoded batch WITHOUT blocking.

        The returned context is finished by finalize_batch; keeping one
        batch in flight overlaps the host-side result assembly of batch
        i with the device compute of batch i+1 (the kt_pipeline
        ordered-output overlap of the reference, correct.c:573-618).

        bases0: u8 [n, L0] base codes; rawq0: u8 [n, L0] raw quality
        ASCII (0 where absent); text_of(i) -> (seq, qual) provides the
        original text, needed only for failed/overflowed reads.
        Shapes are bucketed (power-of-two batch, sticky max length) so
        the device step compiles once and is reused for every batch.
        """
        opt = self.opt
        n, L0 = bases0.shape
        L = (max(int(lens0.max()) if n else 1, 1) + 31) // 32 * 32
        if L > 504:
            # reads longer than the packed position field: exact scalar path
            ch = self._fallback_table()
            return dict(direct=[
                M.ec1(opt, ch, self.ds.mode, *text_of(i)) for i in range(n)
            ])
        self._pad_L = max(getattr(self, "_pad_L", 0), L)
        L = self._pad_L
        B = 256
        while B < max(n, min_b):  # power of two: mesh divisibility
            B *= 2
        Lc = min(L, L0)
        bases = np.full((B, L), 4, np.uint8)
        bases[:n, :Lc] = bases0[:, :Lc]
        lens = np.zeros((B,), np.int32)
        lens[:n] = lens0
        qflag = np.zeros((B, L), bool)
        qv = rawq0[:, :Lc].astype(np.int32) - 33
        inb = np.arange(Lc)[None, :] < lens0[:, None]
        qflag[:n, :Lc] = np.where(
            has_q[:, None], qv >= opt.q, inb
        )
        if opt.refine_ec:
            enc = (qv <= 5) & has_q[:, None] & inb
            bases[:n, :Lc] = np.where(
                enc, ((qv - 1) & 7).astype(np.uint8), bases[:n, :Lc]
            )
        qflag &= bases <= 3
        if self.mesh is not None:
            from jax.sharding import PartitionSpec as P

            from ..parallel.mesh import gput

            j_bases = gput(bases, self.mesh, P("d"))
            j_qflag = gput(qflag, self.mesh, P("d"))
            j_lens = gput(lens, self.mesh, P("d"))
        else:
            j_bases = jnp.asarray(bases)
            j_qflag = jnp.asarray(qflag)
            j_lens = jnp.asarray(lens)
        soft = soft and self._soft_cap > 0
        use_resume = soft and self._resume and jax.process_count() == 1
        use_cfg = self.cfg_main if soft else self.cfg
        if self._route_slack != use_cfg.route_slack:
            use_cfg = use_cfg._replace(route_slack=self._route_slack)
        sc = jnp.int32(min(self._soft_cap, self.cfg.iter_cap) if soft
                       else self.cfg.iter_cap)
        if isinstance(self.ds.table, spec.ShardedCuckoo):
            from ..parallel.mesh import MeshRef

            out = correct_core_sharded(
                self.ds.table, use_cfg, j_bases, j_qflag, j_lens,
                jnp.int32(self.ds.mode), MeshRef(self.mesh), soft_cap=sc,
            )
        elif use_resume:
            out = correct_core(
                self.ds.table, use_cfg, j_bases, j_qflag, j_lens,
                jnp.int32(self.ds.mode), soft_cap=sc, save_state=True,
            )
        else:
            out = correct_core(
                self.ds.table, use_cfg, j_bases, j_qflag, j_lens,
                jnp.int32(self.ds.mode), soft_cap=sc,
            )
        bundle = out.pop("bundle", None)  # device-resident; never pulled
        # start the device->host transfers now: each np.asarray in
        # finalize is otherwise a separate synchronous round trip;
        # issued here they overlap the device compute of the NEXT batch
        for v in out.values():
            try:
                v.copy_to_host_async()
            except Exception:
                break
        return dict(out=out, n=n, lens=lens, has_q=has_q, text_of=text_of,
                    soft=soft, bundle=bundle,
                    slack=self._route_slack, prewarm=prewarm,
                    redispatch=lambda: self.dispatch_arrays(
                        bases0, rawq0, lens0, has_q, text_of,
                        soft=soft, min_b=min_b, prewarm=prewarm))

    def finalize_batch_arrays(self, ctx) -> Optional["BatchResult"]:
        """Block on the device step; assemble results as BATCH ARRAYS.

        The whole-batch form of the reference's worker_ec output packing
        (correct.c:451-459,552-553): final ASCII seq/qual matrices plus
        packed aux/aux2 stat words, with only the rare overflow-fallback
        reads handled per read (exceptional dict).  Returns None when
        the batch took the direct scalar path (reads > 504 bp)."""
        if "direct" in ctx:
            return None
        n = ctx["n"]
        lens = ctx["lens"]
        text_of = ctx["text_of"]
        import os as _os
        import time as _t

        if _os.environ.get("BFC_TIMING"):
            from ..utils.log import log as _lg

            t0 = _t.time()
            jax.block_until_ready(ctx["out"]["packed_bq"])
            t1 = _t.time()
            _ = {k: np.asarray(v) for k, v in ctx["out"].items()}
            _lg(f"device wait {t1-t0:.3f}s pull {_t.time()-t1:.3f}s",
                func="finalize")
        emit = True
        if jax.process_count() > 1:
            # multi-host: batch rows are sharded across processes.  The
            # device-level allgather (to_host) must run identically on
            # every host - it is a collective.  EVERY host assembles the
            # full row matrices (vectorized numpy, cheap); the expensive
            # per-record TEXT formatting is split by host downstream
            # (device_pipeline emits a contiguous window slice per host
            # and rank 0 stitches the byte segments - the reference's
            # ordered single-writer, kthread.c:92-101, with the
            # formatting fanned out)
            from ..parallel.mesh import to_host

            out = {k: to_host(v) for k, v in ctx["out"].items()}
        else:
            out = {k: np.asarray(v) for k, v in ctx["out"].items()}
        if bool(np.asarray(out["route_ovf"]).any()) and "redispatch" in ctx:
            # a sharded-lookup bucket overflowed: every lookup of the
            # round is unusable.  Double the slack (sticky) and re-run
            # the batch on device rather than dumping it to the scalar
            # fallback; give up past 32x (per-read overflow flags then
            # route reads to the exact scalar path as before).  The
            # escalation is relative to the slack THIS batch was
            # dispatched at: with one batch in flight, batch i+1 was
            # dispatched before batch i's overflow landed, and doubling
            # the already-doubled sticky value would skip a level
            # (each skipped level = an unnecessary multi-minute search
            # recompile + permanently larger routing buffers)
            ctx_slack = ctx.get("slack", self._route_slack)
            if ctx_slack < 32:
                from ..utils.log import log

                self._route_slack = max(self._route_slack, 2 * ctx_slack)
                log(f"routing bucket overflow; retrying batch with "
                    f"slack {self._route_slack}", func="Corrector")
                return self.finalize_batch_arrays(ctx["redispatch"]())
        quals_present = ctx["has_q"]
        import os

        if os.environ.get("BFC_SEARCH_STATS"):
            from ..utils.log import log

            trips = out["it"].reshape(-1)[:2].tolist()
            if self.cfg.fused_dirs:
                # fused mode runs both directions as one lockstep loop:
                # there is a single combined trip count
                log(f"search trips (fused dirs) = {trips[0]}",
                    func="correct_core")
            else:
                log(f"search trips fwd/rev = {trips}", func="correct_core")
        # whole-batch output re-encoding (correct.c:451-459), then per-read
        # slicing; avoids per-read numpy work on the hot path.  The four
        # per-base planes arrive packed in one u8 plane (see correct_core)
        U = np.uint64
        code = out["ec_code"][:n].astype(np.int64)
        if emit:
            pk = out["packed_bq"][:n]
            fb = pk & 7
            isd = (pk & 8) != 0
            upper = np.frombuffer(b"ACGTN", np.uint8)[fb]
            lower = np.frombuffer(b"acgtn", np.uint8)[fb]
            seq_rows = np.where(isd, lower, upper)
            qual_rows = np.where(
                isd,
                34 + (pk >> 5),
                np.frombuffer(b"+?", np.uint8)[((pk >> 4) & 1).astype(np.int32)],
            )
            ok = code == 0
            brute = (out["brute"][:n].astype(U) & U(1)) << U(3)
            # aux/aux2 packed exactly as worker_ec (correct.c:552-553); on
            # failure the reference keeps the zero-initialized stats
            # (correct.c:394 + early returns), so only brute|code survive
            aux_ok = (
                ((out["n_ec"][:n].astype(U) & U(0x3FFF)) << U(18))
                | ((out["n_ec_high"][:n].astype(U) & U(0x3FFF)) << U(4))
            )
            aux = np.where(ok, aux_ok, U(0)) | brute | (code.astype(U) & U(7))
            aux2_ok = (out["n_absent"][:n].astype(U) << U(10)) | (
                out["max_heap"][:n].astype(U) & U(0xFF)
            )
            aux2 = np.where(ok, aux2_ok, U(0))
        else:
            Lp = out["packed_bq"].shape[1]
            seq_rows = np.zeros((n, Lp), np.uint8)
            qual_rows = np.zeros((n, Lp), np.uint8)
            aux = np.zeros((n,), U)
            aux2 = np.zeros((n,), U)
        exceptional = {}
        requeue: List[int] = []
        requeue_resume: List[int] = []
        resum_arr = out["resum"][:n] if "resum" in out else None
        ovf = out["overflow"][:n]
        n_ovf = int(ovf.sum())
        if n_ovf and os.environ.get("BFC_TIMING"):
            from ..utils.log import log as _lg

            _lg(f"overflow reads: {n_ovf} (soft={bool(ctx.get('soft'))})",
                func="finalize")
        if ctx.get("prewarm"):
            ovf = np.zeros_like(ovf)  # warm-up results are discarded
        for i in np.nonzero(ovf)[0]:
            if ctx.get("soft"):
                # soft-capped first pass: resumable (iteration-cap-only)
                # reads continue from saved state; every other overflow
                # kind re-batches at full caps (device), not the scalar
                # fallback - see correct_many.  Requeue is CONTROL FLOW
                # (it shapes later device batches) and runs on every
                # host; the scalar fallback below is output-only and
                # runs on the emitting rank alone
                if resum_arr is not None and bool(resum_arr[i]) \
                        and ctx.get("bundle") is not None:
                    requeue_resume.append(int(i))
                else:
                    requeue.append(int(i))
                continue
            if ctx.get("resume") and not (
                resum_arr is not None and bool(resum_arr[i])
            ):
                # non-resumable overflow DURING a resume (soft stack or
                # penalty cap): re-batch at full caps like the soft pass
                # would have (byte-identical; only batch composition
                # changes).  Iteration-capped-again reads fall through
                # to the exact scalar fallback below.
                requeue.append(int(i))
                continue
            if not emit:
                continue
            exceptional[int(i)] = self._scalar_ec1(*text_of(int(i)))
        return BatchResult(
            n=n, lens=np.asarray(lens)[:n],
            seq_rows=seq_rows, qual_rows=qual_rows,
            aux=aux, aux2=aux2, code=code,
            has_q=np.asarray(quals_present)[:n],
            text_of=text_of, exceptional=exceptional, requeue=requeue,
            requeue_resume=requeue_resume,
            emit=emit,
        )

    def finalize_batch(self, ctx):
        """Block on the device step; per-read (EcStat, seq, qual) tuples."""
        if "direct" in ctx:
            return ctx["direct"]
        br = self.finalize_batch_arrays(ctx)
        # tuple consumers have no re-batch or resume stage
        for i in br.requeue + br.requeue_resume:
            br.exceptional[i] = self._scalar_ec1(*br.text_of(i))
        return [br.tuple_of(i) for i in range(br.n)]
