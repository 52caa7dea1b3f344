"""State-resume straggler scheduling for the lockstep search.

The soft-capped main pass leaves ~3-10% of reads un-finished at the
iteration cap; round 1-4 re-ran those from scratch at full caps
(re-paying the whole search prefix, 64+ trips per read).  This module
resumes them instead: the saved post-loop State (ops/search.py) is at
a clean trip boundary, so continuing the while loop from it is
bit-identical to never having stopped (the lockstep body is
deterministic and lanes are independent).

Mechanics (all shapes fixed, everything stays on device):

  * each landed batch's resumable reads are ABSORBED into a P-read
    pool: one flat u32-indexed gather per state/plane array (the
    parallel-gather fast path; 64-bit leaves ride a u32 bitcast) picks
    the straggler rows out of the batch bundle, a select folds them
    over the pool's free slots;
  * when the pool fills (host-tracked occupancy), resume_core continues
    the search at the FULL iteration cap, then runs backtrack +
    direction-merge + packing exactly like correct_core's tail;
  * reads that overflow a non-resumable capacity (stack/penalty/heap)
    keep the old full-cap re-batch path, and reads that exhaust the
    full cap on resume take the exact scalar fallback - the same
    classification as before, so output bytes are unchanged.

Replaces the requeue re-run of correct.c:274-373 semantics with a
continuation; the per-read search sequence is identical either way.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import search as srch

I32 = jnp.int32
U32 = jnp.uint32


# ---------------------------------------------------------------------------
# Row compaction: flat u32 gathers
# ---------------------------------------------------------------------------


def _take_rows(arr, rows):
    """arr[rows] for a [N, ...] array via ONE flat u32-indexed gather.

    64-bit leaves are bitcast to u32 pairs; bool/u8 ride a u32 upcast
    (tiny arrays)."""
    dt = arr.dtype
    small = dt in (jnp.bool_, jnp.uint8, jnp.int8)
    a = arr.astype(U32) if small else arr
    wide = a.dtype.itemsize == 8
    if wide:
        a = jax.lax.bitcast_convert_type(a, U32)  # [..., 2]
    elif a.dtype != U32:
        a = jax.lax.bitcast_convert_type(a, U32)
    rest = 1
    for d in a.shape[1:]:
        rest *= d
    flat = a.reshape((a.shape[0] * rest,))
    ix = rows.astype(U32)[:, None] * U32(rest) + jnp.arange(
        rest, dtype=U32)[None, :]
    g = flat[ix.reshape(-1)].reshape((rows.shape[0],) + a.shape[1:])
    if wide:
        return jax.lax.bitcast_convert_type(g, dt)
    if small:
        return g.astype(dt)
    return jax.lax.bitcast_convert_type(g, dt)


def _mix(taken, old, fill):
    m = fill.reshape(fill.shape + (1,) * (taken.ndim - 1))
    return jnp.where(m, taken, old)


@functools.partial(jax.jit, static_argnames=("init",), donate_argnums=(0,))
def _absorb(pool, bundle, src, fill, init: bool = False):
    """Fold the batch bundle's rows src[fill] into the pool's slots.

    src: u32 [P] batch READ index per pool slot (dummy where ~fill);
    fill: bool [P].  Lane arrays move as (src, src+B) -> (slot, slot+P).
    With init=True the pool argument is ignored and unfilled slots get
    dead defaults (done=True, alive=False)."""
    st = bundle["st"]
    B2 = st.done.shape[0]
    B = B2 // 2
    P = src.shape[0]
    lane = jnp.concatenate([src.astype(U32), src.astype(U32) + U32(B)])
    fill2 = jnp.concatenate([fill, fill])

    def lane_leaf(new, old, dead=None):
        if init:
            old = jnp.ones_like(new) if dead else jnp.zeros_like(new)
        return _mix(new, old, fill2)

    def read_leaf(new, old):
        if init:
            old = jnp.zeros_like(new)
        return _mix(new, old, fill)

    ost = pool["st"]
    new_st_leaves = []
    for name in srch.State._fields:
        leaf = getattr(st, name)
        if leaf.ndim == 0:  # it / rovf: reset per resume dispatch
            new_st_leaves.append(jnp.zeros_like(leaf))
            continue
        taken = _take_rows(leaf, lane)
        new_st_leaves.append(
            lane_leaf(taken, getattr(ost, name), dead=(name == "done"))
        )
    new_st = srch.State(*new_st_leaves)
    opl = pool["pl"]
    new_pl = srch.SearchPlanes(*[
        lane_leaf(_take_rows(getattr(bundle["pl"], n), lane),
                  getattr(opl, n))
        for n in srch.SearchPlanes._fields
    ])
    return dict(
        st=new_st,
        pl=new_pl,
        alive=lane_leaf(_take_rows(bundle["alive"], lane), pool["alive"]),
        nohave=lane_leaf(_take_rows(bundle["nohave"], lane), pool["nohave"]),
        start2=lane_leaf(_take_rows(bundle["start2"], lane), pool["start2"]),
        ob=read_leaf(_take_rows(bundle["ob"], src), pool["ob"]),
        brute_in=read_leaf(_take_rows(bundle["brute_in"], src),
                           pool["brute_in"]),
        lens=read_leaf(_take_rows(bundle["lens"], src), pool["lens"]),
    )


# ---------------------------------------------------------------------------
# Resume program: continue the while loop, then correct_core's tail
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("cfg",))
def resume_core(table, cfg: srch.SearchConfig, pool):
    """Continue a pool of saved straggler states at the full iteration
    cap; returns the same per-read output dict as correct_core (the
    dead-slot rows carry garbage the driver never reads)."""
    from .corrector import rev_rows

    st = pool["st"]
    pl = pool["pl"]
    P2, L = pl.cand_pk.shape
    P = P2 // 2
    lens = pool["lens"]
    lens2 = jnp.concatenate([lens, lens])
    alive = pool["alive"]
    nohave = pool["nohave"]
    # re-arm the resumable lanes; everything else stays done
    st = st._replace(
        done=st.done & ~st.resum,
        overflow=st.overflow & ~st.resum,
        resum=jnp.zeros_like(st.resum),
        it=jnp.zeros((), I32),
        rovf=jnp.zeros((), bool),
    )
    st = srch._search_loop(table, cfg, st, pl, lens2,
                           jnp.int32(cfg.iter_cap))
    ecC, naC, rvC, mhC, ovC, rsC, itC, rvfC = srch._search_backtrack(
        cfg, st, pl, lens2, pool["start2"], alive, nohave
    )

    # ---- direction merge + packing (correct_core's tail on [P] reads;
    # many-N / no-solid / greedy never apply here: resumed reads were
    # searchable by construction)
    idx = jnp.arange(L, dtype=I32)
    inb = idx[None, :] < lens[:, None]
    cand_f = pl.cand_pk[:P]
    seq_fix = (cand_f & 7).astype(jnp.uint8)
    seq_q = ((cand_f >> 3) & 1).astype(bool)
    ob = pool["ob"]
    searchable = alive[:P] | nohave[:P]
    ec0, ec1r = ecC[:P], ecC[P:]
    na0, na1 = naC[:P], naC[P:]
    rv0, rv1 = rvC[:P], rvC[P:]
    mh0, mh1 = mhC[:P], mhC[P:]
    ov0, ov1 = ovC[:P], ovC[P:]
    rs0, rs1 = rsC[:P], rsC[P:]
    ok0 = searchable & (rv0 >= 0) & ~ov0
    ok1 = ok0 & (rv1 >= 0) & ~ov1
    # flip direction-2 output back
    (ec1b,) = rev_rows([ec1r], lens)
    ec1b = jnp.where(inb, jnp.where(ec1b < 4, 3 - ec1b, ec1b), 4).astype(
        jnp.uint8)

    agree = ec0 == ec1b
    merged = jnp.where(
        agree,
        jnp.where(ec0 > 3, seq_fix, ec0),
        jnp.where(ec1b > 3, ec0, jnp.where(ec0 > 3, ec1b, ob)),
    )
    final_b = jnp.where(ok1[:, None] & inb, merged, ob)
    is_diff = (final_b != ob) & inb & ok1[:, None]
    n_ec = jnp.sum(is_diff, axis=1)
    n_ec_high = jnp.sum(is_diff & seq_q, axis=1)
    packed_bq = (
        final_b.astype(jnp.uint8)
        | (is_diff.astype(jnp.uint8) << 3)
        | (seq_q.astype(jnp.uint8) << 4)
        | (ob.astype(jnp.uint8) << 5)
    )

    from .corrector import ECCODE_MANY_FAIL, ECCODE_MISC, ECCODE_UNCORR_N

    def code_of(rv):
        return jnp.where(rv == -2, ECCODE_UNCORR_N,
                         jnp.where(rv == -3, ECCODE_MANY_FAIL, ECCODE_MISC))

    ec_code = jnp.zeros((P,), I32)
    ec_code = jnp.where(~ok1, code_of(rv1), ec_code)
    ec_code = jnp.where(~ok0, code_of(rv0), ec_code)
    overflow = (ov0 | (ov1 & ok0)) & searchable
    bad = (ov0 & ~rs0) | (ov1 & ok0 & ~rs1)
    return dict(
        packed_bq=packed_bq,
        ec_code=ec_code,
        brute=pool["brute_in"].astype(I32),
        n_ec=n_ec.astype(I32), n_ec_high=n_ec_high.astype(I32),
        n_absent=(na0 + na1).astype(I32),
        max_heap=jnp.maximum(mh0, mh1).astype(I32),
        overflow=overflow,
        resum=overflow & ~bad,  # iter-capped AGAIN -> scalar fallback
        it=jnp.stack([itC, itC]),
        route_ovf=rvfC[None],
    )


# ---------------------------------------------------------------------------
# Driver-side pool
# ---------------------------------------------------------------------------


class ResumePool:
    """Host bookkeeping for one correct_many window's straggler pool.

    absorb() returns a list of flushed results (resume dispatches that
    had to happen to make room); flush_all() drains the rest.  Each
    flushed item is (out_dict_device, window_ids: np.ndarray[P] with -1
    for dead slots)."""

    def __init__(self, P: int):
        self.P = P
        self.pool = None
        self.wids: List[int] = []  # window read id per occupied slot

    def _dispatch(self, corrector):
        import os

        if os.environ.get("BFC_TIMING"):
            from ..utils.log import log

            log(f"resume dispatch: {len(self.wids)}/{self.P} reads",
                func="ResumePool")
        # cfg_main: the saved states were shaped by the soft pass's
        # stack/heap caps; _search_loop re-derives them from the state
        # shapes, and iter_cap rides cfg (full cap - soft_cap is a
        # traced input the resume does not pass)
        out = resume_core(corrector.ds.table, corrector.cfg_main,
                          self.pool)
        wids = np.full((self.P,), -1, np.int64)
        wids[: len(self.wids)] = self.wids
        self.wids = []
        # the pool arrays were donated into _absorb only; resume_core
        # does not donate, so the buffers stay valid for reuse - but a
        # fresh init-absorb follows anyway
        self.pool = None
        for v in out.values():
            try:
                v.copy_to_host_async()
            except Exception:
                break
        return out, wids

    def absorb(self, corrector, bundle, batch_rows: List[int],
               window_ids: List[int]):
        """Pull the given batch rows into the pool; returns flushed
        (out, wids) results dispatched to make room (usually none)."""
        flushed = []
        if self.pool is not None and (
            self.pool["pl"].cand_pk.shape[1] != bundle["pl"].cand_pk.shape[1]
        ):
            # sticky pad length grew mid-window: shapes no longer match
            flushed.append(self._dispatch(corrector))
        i = 0
        while i < len(batch_rows):
            free = self.P - len(self.wids)
            if free == 0:
                flushed.append(self._dispatch(corrector))
                free = self.P
            take = min(free, len(batch_rows) - i)
            rows = batch_rows[i : i + take]
            src = np.zeros((self.P,), np.uint32)
            fill = np.zeros((self.P,), bool)
            lo = len(self.wids)
            src[lo : lo + take] = rows
            fill[lo : lo + take] = True
            init = self.pool is None
            self.pool = _absorb(
                self.pool if not init else _dead_pool_like(bundle, self.P),
                bundle, jnp.asarray(src), jnp.asarray(fill), init=init,
            )
            self.wids.extend(window_ids[i : i + take])
            i += take
        return flushed

    def flush_all(self, corrector):
        if self.pool is None or not self.wids:
            self.pool = None
            self.wids = []
            return []
        return [self._dispatch(corrector)]


def _dead_pool_like(bundle, P: int):
    """Zero-filled pool pytree for the init absorb: its VALUES are
    ignored (init replaces unfilled slots with dead defaults inside the
    jit); only shapes/dtypes matter."""
    st = bundle["st"]

    def l_of(a):
        if a.ndim == 0:
            return jnp.zeros((), a.dtype)
        return jnp.zeros((2 * P,) + a.shape[1:], a.dtype)

    def r_of(a):
        return jnp.zeros((P,) + a.shape[1:], a.dtype)

    return dict(
        st=srch.State(*[l_of(getattr(st, n)) for n in srch.State._fields]),
        pl=srch.SearchPlanes(*[
            l_of(getattr(bundle["pl"], n))
            for n in srch.SearchPlanes._fields
        ]),
        alive=l_of(bundle["alive"]),
        nohave=l_of(bundle["nohave"]),
        start2=l_of(bundle["start2"]),
        ob=r_of(bundle["ob"]),
        brute_in=r_of(bundle["brute_in"]),
        lens=r_of(bundle["lens"]),
    )
