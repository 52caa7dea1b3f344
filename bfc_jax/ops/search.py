"""Lockstep vectorized best-first spectrum search (the correction core).

Batched recast of bfc_ec1dir (/root/reference/correct.c:249-386): a
whole batch of reads runs the penalty-ordered search simultaneously,
one heap operation per read per step, with per-read active masks
instead of data-dependent control flow.  The binary-heap arithmetic
replicates ks_heapup/ks_heapdown (/root/reference/ksort.h:125-146)
exactly - including tie behavior (new/equal elements rise, heapdown
prefers the left child on ties) - because the reference's output
depends on structural tie-breaking among equal penalties.

Performance layout (the search is bound by per-iteration gather/scatter
work, so state is packed to minimize row operations):

  * the heap is ONE i32 array per read: pen(12) << 19 | i(9) << 10 |
    (k+1)(10); the comparator shifts out the position/index bits so
    penalty ties keep the reference's structural resolution;
  * full per-state payload lives in the stack pool, written once per
    push with all <=4 pushes batched into a single scatter per array;
  * only forward k-mer planes are stored - every stack state holds a
    full k-base window, so the RC planes are recomputed at pop as
    rev_k(plane) ^ mask;
  * sift loops run 3 levels and fall into the deep 4-level continuation
    only when some lane's heap is large (p99 heap size is 4; the
    explosion guard caps it near 104, hence 7 total levels).

Fixed capacities with per-read overflow flags (penalty >= 4096, stack
or iteration caps, read length > 504); overflowed reads are re-run on
the exact scalar model by the driver.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import kmer as kops
from . import spectrum as spec

I32 = jnp.int32
U64 = jnp.uint64
BIG = jnp.int32(1 << 30)
HEAP_LEVELS = 7      # ceil(log2(heap_cap)); heap_cap fixed at 128
SHALLOW_LEVELS = 3   # covers heaps up to 15 entries without the deep phase
PEN_CAP = 4096       # packed-penalty overflow threshold (12 bits)

# packed ecpos layout: bits [44:0] five 9-bit ec slots (newest at bits
# [8:0]), bits [62:45] two 9-bit high-quality slots (newest at [53:45]);
# each slot stores pos+1 (0 = none), mirroring ecpos[]/ecpos_high[]
_EC_MASK = U64((1 << 45) - 1)
_EPH_MASK = U64((1 << 18) - 1)


class SearchConfig(NamedTuple):
    """Static search parameters (mirrors the bfc_opt_t search fields)."""

    k: int
    min_cov: int
    win_multi_ec: int
    max_end_ext: int
    w_ec: int
    w_ec_high: int
    w_absent: int
    w_absent_high: int
    max_path_diff: int
    max_heap: int
    heap_cap: int
    stack_cap: int
    iter_cap: int
    s_bits: int
    l_pre: int
    kb_bits: int
    packed: bool
    ff_step: int  # fast-forward run length (0 = disabled)
    # fold the fast-forward pre-step into the loop body: the run advance
    # shares the pop's payload extracts and the candidate pool-write
    # pass instead of running its own (saves ~8 dense [B,S]/[B,L]
    # passes per trip); byte-exact (see body comments)
    ff_fold: bool = True
    # allow fast-forward after the first complete path (n_paths > 0):
    # safe because eligibility requires pen_end within the path-diff
    # break threshold, and run penalties are monotone, so no skipped
    # intermediate pop could have broken where the folded one doesn't
    ff_paths: bool = True
    # sharded-table correction (table sharded over a mesh axis; lookups
    # routed by paired all_to_all): empty axis_name = single-device
    axis_name: str = ""
    n_dev: int = 1
    # routing-bucket slack for sharded lookups; the driver doubles it
    # and retries on bucket overflow (count.c:42-52 insbuf retry ethos)
    route_slack: int = 2
    # run both search directions as ONE lockstep loop over [2B] lanes
    # (directions are data-independent: the reverse pass reads only the
    # pre-search seq_fix/coverage rows, and its outputs are discarded
    # for lanes whose forward pass failed) - pays the per-trip fixed
    # overhead once instead of twice per batch
    fused_dirs: bool = True


def _he_pack(pen, zi, zk):
    return (pen << 19) | (zi << 10) | (zk + 1)


def _he_pen(he):
    return he >> 19


def _he_i(he):
    return (he >> 10) & 511


def _he_k(he):
    return (he & 1023) - 1


class State(NamedTuple):
    # the heap is stored SPLIT: hp16 holds entries [0,16) (p99 heap size
    # is 4, so nearly every push/pop runs entirely inside it) and hpr
    # the cold tail [16,H).  Measured: rebuilding one [B,128] array per
    # heap op via concatenate cost ~0.8 ms/trip at B=16k - the split
    # keeps the hot ops on a [B,16] array and touches hpr only in the
    # rare deep-sift cond branch.
    hp16: jax.Array     # i32 [B,16] packed heap entries (hot window)
    hpr: jax.Array      # i32 [B,H-16] packed heap entries (cold tail)
    heap_n: jax.Array   # i32 [B]
    # stack pool (ecstack1_t + the per-state payload)
    st_meta: jax.Array  # i32 [B,S]: i<<16 | (parent+1)<<6 | b<<4 | flags
    st_ecp: jax.Array   # u64 [B,S] packed correction-position history
    st_x0: jax.Array    # [B,S] forward k-mer planes (u32 for k<=31)
    st_x1: jax.Array
    st_n: jax.Array     # i32 [B]
    # root (initial) state payload, addressed by k == -1
    root_x0: jax.Array  # u64 [B]
    root_x1: jax.Array
    root_x2: jax.Array
    root_x3: jax.Array
    # per-read search registers
    min_path_pen: jax.Array  # i32 [B]
    min_path_k: jax.Array    # i32 [B]
    n_paths: jax.Array       # i32 [B]
    n_failures: jax.Array    # i32 [B]
    rv: jax.Array            # i32 [B]
    done: jax.Array          # bool [B]
    overflow: jax.Array      # bool [B]
    resum: jax.Array         # bool [B]: overflowed ONLY on the iteration
                             # cap - the state is at a clean trip boundary
                             # and the search can be resumed from it
                             # (state-resume straggler scheduling)
    max_heap: jax.Array      # i32 [B]
    it: jax.Array            # i32 scalar
    rovf: jax.Array          # bool scalar: a routing bucket overflowed
                             # (results unusable; driver retries with
                             # doubled slack before any scalar fallback)


class SearchPlanes(NamedTuple):
    """Per-position planes the lockstep loop body reads (and nothing
    else): saved alongside a State to make the search resumable."""

    cand_pk: jax.Array  # i32 [B,L]: base|q<<3|oq<<4|lcov<<5|hcov<<11
    cum_pk: jax.Array   # i32 [B,L]: pencum|abscum<<13|ffrun<<22|valid<<28
    x0w_p: jax.Array    # PT [B,L] forward k-mer planes (pool dtype)
    x1w_p: jax.Array


def _pvary_all(xs, axis_name: str):
    """Mark each leaf as varying over the shard_map axis (no-op for
    leaves already varying): while_loop carries must have uniform
    varying-manual-axes types when the body contains collectives."""
    return tuple(
        x if axis_name in getattr(jax.typeof(x), "vma", frozenset())
        else jax.lax.pvary(x, axis_name)
        for x in xs
    )


def _rows(n):
    return jnp.arange(n, dtype=jnp.int32)


def _hcols(H):
    return jnp.arange(H, dtype=jnp.int32)


def _flatget_u32ish(arr, pos):
    """arr[b, pos[b]] via one flat u32-indexed gather; 0 where pos is
    out of [0, n) (the one-hot reduces' semantics for masked-off rows).
    arr must be i32/u32 ([B, n], row-major); the i32 case bitcasts
    through u32 (packed heap/meta words are non-negative)."""
    B, n = arr.shape
    is_i32 = arr.dtype == jnp.int32
    u = jax.lax.bitcast_convert_type(arr, jnp.uint32) if is_i32 else arr
    ok = (pos >= 0) & (pos < n)
    posc = jnp.clip(pos, 0, n - 1).astype(jnp.uint32)
    ix = jnp.arange(B, dtype=jnp.uint32) * jnp.uint32(n) + posc
    v = u.reshape(-1)[ix]
    v = jnp.where(ok, v, jnp.uint32(0))
    return jax.lax.bitcast_convert_type(v, jnp.int32) if is_i32 else v


def _hget(hp, pos):
    """Per-row heap-entry extraction (flat u32 gather)."""
    return _flatget_u32ish(hp, pos)


def _rowget(arr, pos):
    """Per-row element extraction for any non-negative-valued pool
    array, 0 where pos is out of range.  32-bit arrays take one flat
    gather, which made the soft-pass correction step 13% faster than
    one-hot masked reduces on an H100 (PERF.md); the u64 pool (st_ecp)
    keeps the one-hot reduce it had in that measurement."""
    if arr.dtype in (jnp.int32, jnp.uint32):
        return _flatget_u32ish(arr, pos)
    n = arr.shape[1]
    oh = jnp.arange(n, dtype=I32)[None, :] == pos[:, None]
    zero = jnp.zeros((), arr.dtype)
    return jnp.max(jnp.where(oh, arr, zero), axis=1)


def _hset(hp, pos, val, mask):
    H = hp.shape[1]
    oh = (_hcols(H)[None, :] == pos[:, None]) & mask[:, None]
    return jnp.where(oh, val[:, None], hp)


def _sift_up(hp, k, pen, sifting, levels):
    """ks_heapup levels: move parents with >= pen down (ties rise)."""
    for _ in range(levels):
        parent = jnp.maximum((k - 1) >> 1, 0)
        par = _hget(hp, parent)
        move = sifting & (k > 0) & (pen <= _he_pen(par))
        hp = _hset(hp, k, par, move)
        k = jnp.where(move, parent, k)
        sifting = move
    return hp, k, sifting


H_SLICE = 16  # sliced fast-path heap window (covers heaps of < 16 entries)


def heap_push(st: State, he, mask) -> State:
    """ks_heapup insert of a packed entry (ksort.h:137-146).

    Lanes inserting at position < 16 (p99 heap size is 4) run the whole
    sift on the [B,16] hot window - 4 sliced levels fully resolve any
    sift within it, and the cold tail hpr is untouched.  Rare larger
    heaps take a full 7-level phase under a cond (the only place the
    split heap is ever reassembled)."""
    B = he.shape[0]
    H = H_SLICE + st.hpr.shape[1]
    k0 = jnp.where(mask, st.heap_n, 0)
    pen = _he_pen(he)
    small = k0 < H_SLICE
    m_s = mask & small
    hp16, k_s, _ = _sift_up(st.hp16, jnp.minimum(k0, H_SLICE - 1), pen, m_s, 4)
    hp16 = _hset(hp16, k_s, he, m_s)
    m_l = mask & ~small

    def full(ops):
        h16, hr = ops
        hpf = jnp.concatenate([h16, hr], axis=1)
        hpf, k_l, _ = _sift_up(hpf, k0, pen, m_l, HEAP_LEVELS)
        hpf = _hset(hpf, k_l, he, m_l)
        return hpf[:, :H_SLICE], hpf[:, H_SLICE:]

    hp16, hpr = jax.lax.cond(
        jnp.any(m_l), full, lambda ops: ops, (hp16, st.hpr)
    )
    return st._replace(hp16=hp16, hpr=hpr,
                       heap_n=st.heap_n + mask.astype(I32))


def _sift_down(hp, i, n2, l_pen, sifting, levels):
    """ks_heapdown levels (left child wins ties; equal children rise)."""
    for _ in range(levels):
        child = 2 * i + 1
        act = sifting & (child < n2)
        top = jnp.maximum(n2 - 1, 0)
        cc = jnp.minimum(child, top)
        left = _hget(hp, cc)
        right = _hget(hp, jnp.minimum(cc + 1, top))
        pick_right = act & (child != n2 - 1) & (_he_pen(left) > _he_pen(right))
        c = jnp.where(pick_right, cc + 1, cc)
        ce = jnp.where(pick_right, right, left)
        cont = act & ~(_he_pen(ce) > l_pen)
        hp = _hset(hp, i, ce, cont)
        i = jnp.where(cont, c, i)
        sifting = cont
    return hp, i, sifting


def heap_pop(st: State, mask):
    """Pop the root; sift the last element down (ksort.h:125-136).

    Same split-heap fast path as heap_push: lanes with n2 < 16 sift
    entirely within the [B,16] hot window (4 levels fully resolve a
    15-entry heap); larger heaps take the full 7-level phase under a
    cond.  Returns (state, z_pen, z_k, z_i)."""
    B = st.heap_n.shape[0]
    H = H_SLICE + st.hpr.shape[1]
    root = st.hp16[:, 0]
    n2 = jnp.where(mask, st.heap_n - 1, st.heap_n)
    small = n2 < H_SLICE
    act = mask & (n2 > 0)
    m_s = act & small
    m_l = act & ~small
    i0 = jnp.zeros((B,), I32)
    last16 = _hget(st.hp16, jnp.minimum(jnp.maximum(n2, 0), H_SLICE - 1))
    hp16, i_s, _ = _sift_down(st.hp16, i0, n2, _he_pen(last16), m_s, 4)
    hp16 = _hset(hp16, i_s, last16, m_s)

    def full(ops):
        h16, hr = ops
        hpf = jnp.concatenate([h16, hr], axis=1)
        last = _hget(hpf, jnp.minimum(jnp.maximum(n2, 0), H - 1))
        hpf, i_l, _ = _sift_down(hpf, i0, n2, _he_pen(last), m_l, HEAP_LEVELS)
        hpf = _hset(hpf, i_l, last, m_l)
        return hpf[:, :H_SLICE], hpf[:, H_SLICE:]

    hp16, hpr = jax.lax.cond(
        jnp.any(m_l), full, lambda ops: ops, (hp16, st.hpr)
    )
    st = st._replace(hp16=hp16, hpr=hpr, heap_n=n2)
    return st, _he_pen(root), _he_k(root), _he_i(root)


def _weighted(cfg: SearchConfig, ec, ec_high, absent, absent_high):
    return (
        cfg.w_ec * ec.astype(I32)
        + cfg.w_ec_high * ec_high.astype(I32)
        + cfg.w_absent * absent.astype(I32)
        + cfg.w_absent_high * absent_high.astype(I32)
    )


def _shift_ecp(ecp, zi, pen_ec, pen_ec_high):
    """Update the packed correction-position history (buf_update,
    correct.c:217-224): shift in pos+1 at the newest slot per class."""
    slot = (zi + 1).astype(U64)
    ec_part = ecp & _EC_MASK
    eph_part = (ecp >> U64(45)) & _EPH_MASK
    new_ec = jnp.where(pen_ec, ((ec_part << U64(9)) & _EC_MASK) | slot, ec_part)
    new_eph = jnp.where(
        pen_ec_high, ((eph_part << U64(9)) & _EPH_MASK) | slot, eph_part
    )
    return new_ec | (new_eph << U64(45))


def _fast_probe_ok(table, cfg: SearchConfig) -> bool:
    """Eligibility of the all-32-bit probe path: the u32 canonical hash
    needs k <= 31 and the u32 slot math c_bits <= 32.
    All static properties - the choice is baked per compiled program."""
    return (
        isinstance(table, spec.CuckooTable)
        and cfg.k <= 31
        and cfg.s_bits <= 32
    )


def _occ_of(table, cfg: SearchConfig, x0, x1, x2, x3, valid=None):
    """Batched occ lookup; returns (occ, overflow-scalar).

    overflow is always False for local tables; for a ShardedCuckoo it
    flags an exhausted routing bucket (results unusable -> the driver
    retries the batch with doubled slack).  `valid` (sharded only)
    keeps dead lanes out of the routing buckets - dead lanes often
    share one constant window, which would skew one destination.

    When the planes arrive as uint32 (k <= 31 callers) and the table
    is an eligible CuckooTable, the whole hash -> slot -> gather chain
    runs in unsigned 32-bit arithmetic (cuckoo_lookup32)."""
    no_ovf = jnp.zeros((), bool)
    import os

    probe_off = os.environ.get("BFC_PROBE_NO_OCC", "0") == "1"
    if x0.dtype == jnp.uint32 and _fast_probe_ok(table, cfg) and not probe_off:
        h0, h1 = kops.canonical_hash32(x0, x1, x2, x3, cfg.k)
        return spec.cuckoo_lookup32(table, h0, h1, cfg.k, cfg.s_bits), no_ovf
    if x0.dtype == jnp.uint32:
        x0, x1, x2, x3 = (a.astype(jnp.uint64) for a in (x0, x1, x2, x3))
    _, h0, h1 = kops.canonical_hash(x0, x1, x2, x3, cfg.k)
    q_shard, q_kb = kops.shard_and_keybody(h0, h1, cfg.k, cfg.l_pre)
    if probe_off:
        # measurement-only (trace-time): skip the table gathers entirely
        # (garbage results) to expose the gather share of the trip time
        return (q_shard.astype(jnp.int32) & 0xFF) | 0x700, no_ovf
    if isinstance(table, spec.ShardedCuckoo):
        return spec.sharded_cuckoo_lookup(
            table, q_shard, q_kb, cfg.s_bits, cfg.l_pre, cfg.kb_bits,
            cfg.axis_name, cfg.n_dev, slack=cfg.route_slack, valid=valid,
        )
    if isinstance(table, spec.CuckooTable):
        return spec.cuckoo_lookup(table, q_shard, q_kb, cfg.s_bits, cfg.l_pre,
                                  cfg.kb_bits), no_ovf
    if cfg.packed:
        return spec.packed_lookup(table, q_shard, q_kb, cfg.s_bits, cfg.l_pre,
                                  cfg.kb_bits), no_ovf
    return spec.table_lookup(table, q_shard, q_kb, cfg.s_bits, cfg.l_pre,
                             cfg.kb_bits), no_ovf


@functools.partial(jax.jit, static_argnames=("cfg", "debug", "save_state"))
def ec1dir_batch(
    table,
    cfg: SearchConfig,
    seq_b,      # u8  [B,L] current bases (greedy fix applied)
    seq_q,      # bool [B,L] quality flag
    seq_oq,     # bool [B,L] original quality flag
    lcov,       # i32 [B,L]
    hcov,       # i32 [B,L]
    lens,       # i32 [B]
    start,      # i32 [B]
    active_in,  # bool [B] which reads participate
    win_bits=None,  # optional (w_cnthi, w_abs, w_absh, ff_ok) bool [B,L]
    soft_cap=None,  # i32 scalar: dynamic iteration cap <= cfg.iter_cap;
                    # lanes hitting it overflow (driver re-batches them at
                    # full caps - exact same per-read search).  TRACED, so
                    # the driver adapts it per batch without recompiling.
    debug: bool = False,
    save_state: bool = False,
):
    """One direction of the batched best-first search.

    win_bits, when given, carries the fast-forward window predicates
    derived by the caller from the kcov occ pass (canonical hashing is
    strand-independent, so the reverse direction's bits are a reversal
    of the forward ones) - avoiding a full per-direction table lookup.
    ff_ok=False marks windows whose precomputed occ is stale (e.g.
    overlapping a greedy fix): fast-forward is disabled there and the
    lockstep loop computes them exactly.

    Returns (ec_b u8 [B,L], n_absent i32 [B], status i32 [B], max_heap
    i32 [B], overflow bool [B]); status: 0 ok, -1/-2/-3 reference
    failure codes (correct.c:277-280,288,342-347)."""
    B, L = seq_b.shape
    H, S = cfg.heap_cap, cfg.stack_cap
    assert S <= 1023, "stack_cap must fit the 10-bit parent field"
    assert H > H_SLICE, "heap_cap must exceed the hot window"
    assert L <= 504, "read length exceeds the packed position field"
    k = cfg.k
    # pool/window plane dtype: a k-bit window fits u32 for k <= 31, and
    # the pool extracts/writes are bandwidth-bound dense passes - half
    # the bytes is half the pass cost (u64 kept for larger k).  For
    # k <= 31 the WHOLE candidate chain (planes -> append -> hash ->
    # table slots) stays u32 (see _occ_of)
    PT = jnp.uint32 if k <= 31 else U64
    kmask = PT((1 << k) - 1)
    end = lens  # the search end is always the read length (correct.c:425,430)
    r = _rows(B)
    iter_cap = (
        jnp.int32(cfg.iter_cap) if soft_cap is None
        else jnp.minimum(jnp.int32(soft_cap), cfg.iter_cap)
    )

    # ---- initial state: first k-1 valid bases rolled in (correct.c:260-266)
    idx = jnp.arange(L, dtype=jnp.int32)
    bad = (seq_b > 3) | (idx[None, :] >= lens[:, None]) | (idx[None, :] < start[:, None])
    last_bad = jax.lax.associative_scan(
        jnp.maximum, jnp.where(bad, idx[None, :], -1), axis=-1
    )
    run = idx[None, :] - last_bad
    ok = (run >= k) & (idx[None, :] < end[:, None])
    init_i = jnp.argmax(ok, axis=-1).astype(I32)
    have = jnp.any(ok, axis=-1)
    active = active_in & have
    # planes of the k-1 bases before init_i, as k-bit append-state.
    # The RC planes come from bit-reversing the backward window pack of
    # the complement bits (full-window planes are undefined near the
    # read start); bit 0 is zeroed: only k-1 bases are rolled in.
    lo = (seq_b & 1).astype(PT)
    hi = ((seq_b >> 1) & 1).astype(PT)
    bw_lo = kops.window_pack_backward(lo, k, PT)
    bw_hi = kops.window_pack_backward(hi, k, PT)
    bw_clo = kops.window_pack_backward(lo ^ PT(1), k, PT)
    bw_chi = kops.window_pack_backward(hi ^ PT(1), k, PT)
    prev = jnp.maximum(init_i - 1, 0)
    maskk1 = PT((1 << (k - 1)) - 1)
    st = State(
        hp16=jnp.zeros((B, H_SLICE), I32),
        hpr=jnp.zeros((B, H - H_SLICE), I32),
        heap_n=jnp.zeros((B,), I32),
        st_meta=jnp.zeros((B, S), I32),
        st_ecp=jnp.zeros((B, S), U64),
        st_x0=jnp.zeros((B, S), PT), st_x1=jnp.zeros((B, S), PT),
        st_n=jnp.zeros((B,), I32),
        root_x0=_rowget(bw_lo, prev) & maskk1,
        root_x1=_rowget(bw_hi, prev) & maskk1,
        root_x2=kops.reverse_k(_rowget(bw_clo, prev), k) & ~PT(1),
        root_x3=kops.reverse_k(_rowget(bw_chi, prev), k) & ~PT(1),
        min_path_pen=jnp.full((B,), BIG, I32),
        min_path_k=jnp.full((B,), -2, I32),
        n_paths=jnp.zeros((B,), I32),
        n_failures=jnp.zeros((B,), I32),
        rv=jnp.full((B,), -1, I32),
        done=~active,
        overflow=jnp.zeros((B,), bool),
        resum=jnp.zeros((B,), bool),
        max_heap=jnp.zeros((B,), I32),
        it=jnp.zeros((), I32),
        rovf=jnp.zeros((), bool),
    )
    if cfg.axis_name:
        # mark every leaf device-varying BEFORE the first heap op: the
        # split-heap cond branches must see uniform varying-manual-axes
        # types (and the while carry requires it anyway)
        st = State(*_pvary_all(st, cfg.axis_name))
    st = heap_push(st, _he_pack(jnp.zeros((B,), I32), init_i, jnp.full((B,), -1, I32)),
                   active)

    # ---- fast-forward precomputation ------------------------------------
    # Most pops are forced keep-steps at "fixed" positions with a
    # single-entry heap; those iterations are exactly equivalent to
    # replacing the heap root and appending stack nodes, and their
    # decision inputs depend only on the position when the state's
    # k-window is uncorrected ("clean").  Precompute, per position j:
    # would a clean state at j be fixed, what penalty does its keep step
    # cost, and how long is the forced run starting at j.
    #
    # A whole forced run becomes ONE "run" stack node (run_len packed in
    # meta bits 25-30): keep-steps write the read base back (a no-op on
    # ec_b) and their only backtrack effect is the absent count, which
    # is a prefix-sum difference - so the per-step chain nodes of the
    # reference are pure bookkeeping and a single node with a length
    # field reproduces the search byte-exactly while skipping
    # run_len iterations of the lockstep loop.
    FF_STEP = cfg.ff_step
    assert FF_STEP <= 63, "run length must fit the 6-bit meta field"
    FF_FOLD = cfg.ff_fold and FF_STEP > 0
    FF_PATHS = cfg.ff_paths
    x0w, x1w, x2w, x3w = kops.kmer_planes(seq_b, k, PT)
    x0w_p = x0w.astype(PT)  # pool-dtype copies for the per-iteration extracts
    x1w_p = x1w.astype(PT)
    wvalid = kops.valid_kmer_mask(seq_b, lens, k)
    if win_bits is None:
        occ_pre0, pre_ovf = _occ_of(table, cfg, x0w, x1w, x2w, x3w,
                                    valid=wvalid & active[:, None])
        st = st._replace(
            overflow=st.overflow | (pre_ovf & active),
            done=st.done | (pre_ovf & active),
            rovf=st.rovf | pre_ovf,
        )
        occ_pre = jnp.where(wvalid, occ_pre0, -1)
        # -1 & 0xFF reads as 255 (the correct.c:300 quirk)
        w_cnthi = (occ_pre & 0xFF) >= cfg.min_cov + 1
        p_abs_pre = (occ_pre < 0) | ((occ_pre & 0xFF) < cfg.min_cov)
        p_absh_pre = (occ_pre < 0) | (((occ_pre >> 8) & 0xFF) < cfg.min_cov)
        ff_ok = jnp.ones((B, L), bool)
    else:
        w_cnthi, p_abs_pre, p_absh_pre, ff_ok = win_bits
    q_pos = seq_q & (seq_b <= 3)
    fixed_pre = (seq_b < 4) & (
        (q_pos & w_cnthi & (lcov >= cfg.min_cov + 1))
        | (hcov > k * 3 // 4)
    )
    ffable = fixed_pre & ff_ok & (idx[None, :] < lens[:, None])
    pen_step = cfg.w_absent * p_abs_pre.astype(I32) + cfg.w_absent_high * p_absh_pre.astype(I32)
    pencum = jnp.cumsum(pen_step, axis=-1).astype(I32)  # inclusive prefix
    abscum = jnp.cumsum(p_abs_pre.astype(I32), axis=-1)  # inclusive prefix
    # forced-run length starting at j, via a reversed run-length scan
    rev_bad = jnp.where(~ffable[:, ::-1], jnp.arange(L, dtype=I32)[None, :], -1)
    last_bad_rev = jax.lax.associative_scan(jnp.maximum, rev_bad, axis=-1)
    # in reversed coordinates, last bad at or before position p; run at
    # original j = (L-1-p): distance to previous bad in reversed = run
    ff_run_rev = jnp.arange(L, dtype=I32)[None, :] - last_bad_rev
    ff_run = ff_run_rev[:, ::-1]
    # ONE packed per-position plane for every fast-forward input, so the
    # per-trip read is a single [B,L] one-hot pass at position zi-1:
    # pencum clamped to 13 bits (a clamped value disables eligibility -
    # the per-step path then computes the true penalty), abscum exact
    # (<= L <= 504), run length clamped to the 6-bit meta cap and
    # SHIFTED one left (slot j holds the run starting at j+1, since the
    # consumer reads at zi-1 while the run starts at zi), and the
    # window-validity bit for the clean check
    ff_next = jnp.concatenate(
        [jnp.minimum(ff_run, 63)[:, 1:], jnp.zeros((B, 1), I32)], axis=1
    )
    cum_pk = (
        jnp.minimum(pencum, 8191)
        | (abscum << 13)
        | (ff_next << 22)
        | (wvalid.astype(I32) << 28)
    )


    # packed per-position candidate plane: base(3) | q(1)<<3 | oq(1)<<4 |
    # lcov(6)<<5 | hcov(6)<<11 - the body's five per-position extracts
    # share one one-hot mask, so one masked reduce replaces five
    # (coverages are <= k <= 63, so 6 bits each)
    cand_pk = (
        seq_b.astype(I32)
        | (seq_q.astype(I32) << 3)
        | (seq_oq.astype(I32) << 4)
        | (jnp.minimum(lcov, 63) << 5)
        | (jnp.minimum(hcov, 63) << 11)
    )

    pl = SearchPlanes(cand_pk=cand_pk, cum_pk=cum_pk,
                      x0w_p=x0w_p, x1w_p=x1w_p)
    st = _search_loop(table, cfg, st, pl, lens, iter_cap)
    nohave = active_in & ~have
    out = _search_backtrack(cfg, st, pl, lens, start, active, nohave)
    if save_state:
        # resume bundle: the post-loop state plus every plane the loop
        # body reads, so iteration-capped lanes can be continued from
        # the saved trip boundary without re-running the prefix
        return out + ((st, pl, active, nohave),)
    if debug:
        return out + (st,)
    return out


def _search_loop(table, cfg: SearchConfig, st: State, pl: 'SearchPlanes',
                 lens, iter_cap):
    """The lockstep while loop, from any trip boundary (a fresh init
    or a saved straggler state).  Shared by ec1dir_batch and the
    state-resume path (models/resume.py); byte-exact either way."""
    cand_pk, cum_pk, x0w_p, x1w_p = pl
    B, L = cand_pk.shape
    S = st.st_meta.shape[1]
    H = H_SLICE + st.hpr.shape[1]
    k = cfg.k
    # the scalar-type constructor, not the numpy dtype object
    PT = jnp.uint32 if x0w_p.dtype == jnp.uint32 else U64
    kmask = PT((1 << k) - 1)
    end = lens
    FF_STEP = cfg.ff_step
    FF_FOLD = cfg.ff_fold and FF_STEP > 0
    FF_PATHS = cfg.ff_paths

    def ff_prestep(st: State) -> State:
        # ---- fast-forward pre-step (exact: heap of one, clean window)
        root = st.hp16[:, 0]
        f_zi = _he_i(root)
        f_zk = _he_k(root)
        f_pen = _he_pen(root)
        f_zkc = jnp.maximum(f_zk, 0)
        f_ecp = jnp.where(f_zk < 0, U64(0), _rowget(st.st_ecp, f_zkc))
        newest = (f_ecp & U64(511)).astype(I32)  # pos+1, 0 = none
        # clean = the state's window equals the precomputed one: no
        # correction in the last k positions AND no N crossed (crossing
        # an N substitutes a base without an ecpos record - the
        # reference's pen.ec is 0 when the read base is N)
        prev_i = jnp.maximum(f_zi - 1, 0)
        cum_a = _rowget(cum_pk, prev_i)
        clean = ((newest == 0) | (f_zi - (newest - 1) > k)) & (
            (f_zi >= 1) & (((cum_a >> 28) & 1) == 1)
        )
        # run length for a run starting at f_zi lives at slot f_zi - 1
        # (cum_a); garbage when f_zi == 0, which `clean` already excludes
        steps = jnp.minimum(
            jnp.minimum((cum_a >> 22) & 63, FF_STEP), S - st.st_n
        )
        elig = (
            ~st.done
            & (st.heap_n == 1)
            & (st.n_paths == 0)
            & clean
            & (steps > 0)
            & (f_zi < lens)
        )
        base_cum = jnp.where(f_zi > 0, cum_a & 8191, 0)
        last_pos = jnp.minimum(f_zi + steps - 1, L - 1)
        cum_b = _rowget(cum_pk, last_pos)
        pen_end = f_pen + (cum_b & 8191) - base_cum
        # a clamped pencum (8191) would corrupt pen_end: disable ff there
        elig = elig & (pen_end < PEN_CAP) & ((cum_b & 8191) < 8191)
        stepsm = jnp.where(elig, steps, 0)
        # the whole forced-keep run becomes ONE run node: run_len in
        # meta bits 25-30, end position in bits 16-24; keep-steps never
        # change ec_b and their absent count is a prefix-sum difference,
        # so backtrack reproduces the per-step chain exactly
        slot = st.st_n
        meta_run = (
            (stepsm << 25)
            | (last_pos << 16)
            | ((f_zk + 1) << 6)
        )
        oh_slot = (jnp.arange(S, dtype=I32)[None, :] == slot[:, None]) & elig[:, None]
        st = st._replace(
            st_meta=jnp.where(oh_slot, meta_run[:, None], st.st_meta),
            st_ecp=jnp.where(oh_slot, f_ecp[:, None], st.st_ecp),
            st_x0=jnp.where(oh_slot, _rowget(x0w_p, last_pos)[:, None], st.st_x0),
            st_x1=jnp.where(oh_slot, _rowget(x1w_p, last_pos)[:, None], st.st_x1),
            st_n=st.st_n + elig.astype(I32),
        )
        new_root = _he_pack(pen_end, f_zi + stepsm, st.st_n - 1)
        # root replacement = a column-0 write (no one-hot pass)
        col0 = jnp.where(elig, new_root, st.hp16[:, 0])
        return st._replace(
            hp16=jnp.concatenate([col0[:, None], st.hp16[:, 1:]], axis=1)
        )

    def body(st: State) -> State:
        if FF_STEP > 0 and not FF_FOLD:
            st = ff_prestep(st)
        act = ~st.done
        st = st._replace(
            max_heap=jnp.where(
                act, jnp.minimum(jnp.maximum(st.max_heap, st.heap_n), 255),
                st.max_heap,
            )
        )
        # empty heap: uncorrectable N (correct.c:277-280)
        empty = act & (st.heap_n == 0)
        st = st._replace(rv=jnp.where(empty, -2, st.rv), done=st.done | empty)
        act = act & ~empty
        st, z_pen, z_k, zi = heap_pop(st, act)
        # ---- fetch the popped state's payload (stack pool or root)
        is_root = z_k < 0
        zkc = jnp.maximum(z_k, 0)
        z_x0 = jnp.where(is_root, st.root_x0, _rowget(st.st_x0, zkc))
        z_x1 = jnp.where(is_root, st.root_x1, _rowget(st.st_x1, zkc))
        # stack states always hold full k-base windows: RC = rev_k ^ mask
        z_x2 = jnp.where(is_root, st.root_x2, kops.reverse_k(z_x0, k) ^ kmask)
        z_x3 = jnp.where(is_root, st.root_x3, kops.reverse_k(z_x1, k) ^ kmask)
        z_ecp = jnp.where(is_root, U64(0), _rowget(st.st_ecp, zkc))
        # give up when past the best path by max_path_diff (correct.c:288)
        brk = act & (st.min_path_k >= -1) & (
            z_pen > st.min_path_pen + cfg.max_path_diff
        )
        st = st._replace(done=st.done | brk)
        act = act & ~brk
        early_stop = zi - end > cfg.max_end_ext
        ext = act & ~early_stop

        # ---- folded fast-forward: advance the popped state along its
        # forced-keep run BEFORE candidate generation.  Equivalent to
        # ff_prestep + the body pop (the pre-step replaced the root of a
        # one-entry heap and the pop immediately consumed it), but the
        # run advance now shares the pop's payload extracts and the
        # candidate pool-write pass below instead of paying its own.
        # The whole run still becomes ONE run stack node; the candidate
        # step then runs at the advanced position with the run node as
        # parent - exactly the reference's state after run_len forced
        # keep-steps (correct.c:291-341 with the fixed branch taken).
        ffsh = jnp.zeros((B,), I32)  # 1 where a run node fills slot st_n
        if FF_FOLD:
            newest = (z_ecp & U64(511)).astype(I32)  # pos+1, 0 = none
            prev_i = jnp.maximum(zi - 1, 0)
            cum_a = _rowget(cum_pk, prev_i)
            # clean = the state's window equals the precomputed one: no
            # correction in the last k positions AND no N crossed
            clean = ((newest == 0) | (zi - (newest - 1) > k)) & (
                (zi >= 1) & (((cum_a >> 28) & 1) == 1)
            )
            steps = jnp.minimum(
                jnp.minimum((cum_a >> 22) & 63, FF_STEP), S - st.st_n
            )
            elig = (
                ext
                & (st.heap_n == 0)  # post-pop: the heap held exactly one
                & clean
                & (steps > 0)
                & (zi < lens)
            )
            if not FF_PATHS:
                elig = elig & (st.n_paths == 0)
            base_cum = cum_a & 8191
            last_pos = jnp.minimum(zi + steps - 1, L - 1)
            cum_b = _rowget(cum_pk, last_pos)
            pen_end = z_pen + (cum_b & 8191) - base_cum
            # clamped pencum would corrupt pen_end: per-step path instead
            elig = elig & (pen_end < PEN_CAP) & ((cum_b & 8191) < 8191)
            if FF_PATHS:
                # never advance past the path-diff break threshold: run
                # penalties are monotone, so this guarantees no skipped
                # intermediate pop would have broken (correct.c:288) -
                # the outputs (min path, n_paths, max_heap) stay exact
                elig = elig & (
                    (st.min_path_k < -1)
                    | (pen_end <= st.min_path_pen + cfg.max_path_diff)
                )
            stepsm = jnp.where(elig, steps, 0)
            run_meta = (stepsm << 25) | (last_pos << 16) | ((z_k + 1) << 6)
            ext0 = _rowget(x0w_p, last_pos)
            ext1 = _rowget(x1w_p, last_pos)
            z_x0 = jnp.where(elig, ext0, z_x0)
            z_x1 = jnp.where(elig, ext1, z_x1)
            z_x2 = jnp.where(elig, kops.reverse_k(ext0, k) ^ kmask, z_x2)
            z_x3 = jnp.where(elig, kops.reverse_k(ext1, k) ^ kmask, z_x3)
            z_pen = jnp.where(elig, pen_end, z_pen)
            z_k = jnp.where(elig, st.st_n, z_k)  # children chain to the run node
            zi = zi + stepsm
            ffsh = elig.astype(I32)

        # ---- candidate generation (correct.c:291-341)
        zic = jnp.minimum(zi, L - 1)
        c_none = zi >= lens
        c_pk = _rowget(cand_pk, zic)
        c_b = jnp.where(c_none, 4, c_pk & 7)
        c_q = ~c_none & ((c_pk & 8) != 0)
        c_oq = ~c_none & ((c_pk & 16) != 0)
        c_lcov = jnp.where(c_none, 0, (c_pk >> 5) & 63)
        c_hcov = jnp.where(c_none, 0, (c_pk >> 11) & 63)
        # one fused table probe for all 4 candidate bases ([B,4] queries in
        # a single gather round instead of 4 separate lookup while-loops)
        bb = jnp.broadcast_to(jnp.arange(4, dtype=I32)[None, :], (B, 4))
        nx = kops.append_base(z_x0[:, None], z_x1[:, None],
                              z_x2[:, None], z_x3[:, None], bb, k)
        occ, it_ovf = _occ_of(table, cfg, *nx, valid=act[:, None])  # i32 [B,4]
        lost = it_ovf & act  # routing-bucket overflow: driver retry
        st = st._replace(overflow=st.overflow | lost, done=st.done | lost,
                         rovf=st.rovf | it_ovf)
        act = act & ~lost
        ext = ext & ~lost
        cb_ok = ~c_none & (c_b < 4)
        # occ holds -1 for absent k-mers, violating _rowget's
        # non-negative contract (its one-hot branch is a max-reduce
        # that would read -1 as 0, breaking the os==-1 -> 255 quirk
        # below); bias by +1 around the extract so both branches are
        # exact (caught by CLI byte-parity at k=19, round 4)
        os = jnp.where(
            cb_ok, _rowget(occ + 1, jnp.minimum(c_b, 3)) - 1, -1
        )
        os_cnt = os & 0xFF          # NB: os==-1 reads as 255 (correct.c:300 quirk)
        fixed = (zi > end) | (
            cb_ok
            & (
                (c_q & (os_cnt >= cfg.min_cov + 1) & (c_lcov >= cfg.min_cov + 1))
                | (c_hcov > k * 3 // 4)  # hcov > k*.75 with integer hcov
            )
        )
        # clustered-correction windows (correct.c:316-317)
        ep_old = (z_ecp >> U64(36)).astype(I32) & 511
        eph_old = (z_ecp >> U64(54)).astype(I32) & 511
        win_block = (~c_none) & (
            (c_q & (eph_old > 0) & (zi - (eph_old - 1) < cfg.win_multi_ec))
            | ((ep_old > 0) & (zi - (ep_old - 1) < cfg.win_multi_ec))
        )
        valid = []
        pens = []
        for b in range(4):
            is_keep = ~c_none & (b == c_b)
            s_occ = occ[:, b]
            solid = (s_occ >= 0) & ((s_occ & 0xFF) >= cfg.min_cov)
            branch_ok = (
                ~(fixed & ~c_none & (b != c_b))
                & ~win_block
                & solid
            )
            p_ec = jnp.where(is_keep, False, cb_ok)
            p_ech = p_ec & c_oq
            p_abs = jnp.where(
                is_keep, (os < 0) | ((os & 0xFF) < cfg.min_cov), False
            )
            p_absh = jnp.where(
                is_keep,
                (os < 0) | (((os >> 8) & 0xFF) < cfg.min_cov),
                ((s_occ >> 8) & 0xFF) < cfg.min_cov,
            )
            valid.append(jnp.where(is_keep, True, branch_ok))
            pens.append((p_ec, p_ech, p_abs, p_absh))
        valid = jnp.stack(valid, axis=1)  # [B,4]
        keep_col = (~c_none)[:, None] & (
            jnp.arange(4, dtype=jnp.int32)[None, :] == c_b[:, None]
        )
        other_ext = jnp.sum((valid & ~keep_col).astype(I32), axis=1)
        n_added = jnp.sum(valid.astype(I32), axis=1)

        failed = ext & (~fixed) & (other_ext == 0)
        n_failures = st.n_failures + failed.astype(I32)
        give_up = ext & (n_failures > lens * 2)
        st = st._replace(
            n_failures=n_failures,
            rv=jnp.where(give_up, -3, st.rv),
            done=st.done | give_up,
        )
        ext = ext & ~give_up

        add_cond = ext & (~c_none | (n_added == 1))
        # heap-explosion guard (correct.c:349-356)
        guard = add_cond & (n_added > 1) & (st.heap_n > cfg.max_heap)
        wp = jnp.stack([_weighted(cfg, *pens[b]) for b in range(4)], axis=1)
        wp_masked = jnp.where(valid, wp, BIG)
        winner = jnp.argmin(wp_masked, axis=1).astype(I32)
        push = valid & add_cond[:, None] & (
            ~guard[:, None] | (winner[:, None] == jnp.arange(4, dtype=I32)[None, :])
        )
        tot4 = z_pen[:, None] + wp                              # [B,4]
        pen_of = tot4
        flags4 = jnp.stack(
            [
                pens[b][0].astype(I32)
                | (pens[b][1].astype(I32) << 1)
                | (pens[b][2].astype(I32) << 2)
                | (pens[b][3].astype(I32) << 3)
                for b in range(4)
            ],
            axis=1,
        )
        # slot assignment preserves the b-ascending push order (candidates
        # land after the run node when this trip fast-forwarded)
        rank = (jnp.cumsum(push.astype(I32), axis=1) - push.astype(I32)).astype(I32)
        n_push = jnp.sum(push.astype(I32), axis=1).astype(I32)
        slot4 = st.st_n[:, None] + ffsh[:, None] + rank
        over = (st.st_n + ffsh + n_push > S) & (n_push > 0)
        pen_over = jnp.any(push & (tot4 >= PEN_CAP), axis=1)
        over = over | pen_over
        push = push & ~over[:, None]
        n_push = jnp.where(over, 0, n_push)
        st = st._replace(overflow=st.overflow | over, done=st.done | over)
        meta4 = (
            (zi[:, None] << 16)
            | ((z_k + 1)[:, None] << 6)
            | (jnp.arange(4, dtype=I32)[None, :] << 4)
            | flags4
        )
        ecp4 = jnp.stack(
            [_shift_ecp(z_ecp, zi, pens[b][0], pens[b][1]) for b in range(4)],
            axis=1,
        )
        nx0_4 = jnp.stack(
            [((z_x0 << PT(1)) | PT(b & 1)) & kmask for b in range(4)], axis=1
        )
        nx1_4 = jnp.stack(
            [((z_x1 << PT(1)) | PT(b >> 1)) & kmask for b in range(4)], axis=1
        )
        # pushed slots are consecutive (slot4 = st_n + ffsh + rank), so
        # the pool write is a fused dense select on columns
        # [st_n, st_n + ffsh + n_push): the run node (if any) at st_n,
        # then the rank-t pushed bases.  One elementwise pass per array
        # instead of a row scatter; the run node rides the same pass for
        # free.
        def _by_rank(vals4):
            zero = jnp.zeros((), vals4.dtype)
            return [
                jnp.max(jnp.where(push & (rank == t), vals4, zero), axis=1)
                for t in range(4)
            ]

        scols = jnp.arange(S, dtype=I32)[None, :]
        rel = scols - st.st_n[:, None]

        def _pool_write(arr, vals4, run_val=None):
            vbr = _by_rank(vals4)
            out = arr
            if FF_FOLD:
                m0 = (rel == 0) & elig[:, None]
                out = jnp.where(m0, run_val[:, None], out)
                shifted = rel - ffsh[:, None]
            else:
                shifted = rel
            for t in range(4):
                m = (shifted == t) & (n_push > t)[:, None]
                out = jnp.where(m, vbr[t][:, None], out)
            return out

        run_vals = (
            (run_meta, z_ecp, ext0.astype(PT), ext1.astype(PT))
            if FF_FOLD else (None, None, None, None)
        )
        st = st._replace(
            st_meta=_pool_write(st.st_meta, meta4, run_vals[0]),
            st_ecp=_pool_write(st.st_ecp, ecp4, run_vals[1]),
            st_x0=_pool_write(st.st_x0, nx0_4.astype(PT), run_vals[2]),
            st_x1=_pool_write(st.st_x1, nx1_4.astype(PT), run_vals[3]),
            st_n=st.st_n + ffsh + n_push,
        )
        # heap inserts, sequential in b order (each with its own sift-up)
        for b in range(4):
            push_b = push[:, b]
            over2 = push_b & (st.heap_n >= H)
            push_b = push_b & ~over2
            st = st._replace(overflow=st.overflow | over2, done=st.done | over2)
            he = _he_pack(tot4[:, b], zi + 1, slot4[:, b])
            st = heap_push(st, he, push_b)
        # dead end past the read (correct.c:361-363).  The stack carries
        # no tot column: a heap entry's penalty always equals its stack
        # node's, and the dead-end adjustment is only ever read by the
        # stop bookkeeping of this same pop.
        dead = ext & ~add_cond
        dead_pen = dead & (n_added == 0)
        stop = (act & early_stop) | dead
        stop_pen = z_pen + jnp.where(
            dead_pen, cfg.w_absent * (cfg.max_end_ext - (zi - end)), 0
        )
        better = stop & (stop_pen < st.min_path_pen)
        st = st._replace(
            min_path_pen=jnp.where(better, stop_pen, st.min_path_pen),
            min_path_k=jnp.where(better, z_k, st.min_path_k),
            n_paths=st.n_paths + stop.astype(I32),
        )
        full = st.n_paths >= 4
        st = st._replace(done=st.done | (stop & full), it=st.it + 1)
        iter_over = (st.it >= iter_cap) & ~st.done
        # an iteration-cap overflow leaves the state at a clean trip
        # boundary: mark the lane resumable (every other overflow kind
        # set done earlier and is excluded by ~st.done here)
        st = st._replace(
            overflow=st.overflow | iter_over, done=st.done | iter_over,
            resum=st.resum | iter_over,
        )
        return st

    if cfg.axis_name:
        # Sharded table: the body contains collectives, so every device
        # must run the same trip count.  Carry a globally-reduced done
        # flag (collectives are not allowed in the loop condition).
        # Constant-initialized state fields must be marked
        # device-varying to match the body outputs under shard_map.
        st = State(*_pvary_all(st, cfg.axis_name))

        def _gdone(s):
            ld = jnp.all(s.done).astype(I32)
            return jax.lax.psum(ld, cfg.axis_name) == cfg.n_dev

        def gbody(c):
            s = body(c[0])
            return s, _gdone(s)

        st, _ = jax.lax.while_loop(
            lambda c: ~c[1], gbody, (st, _gdone(st))
        )
    else:
        st = jax.lax.while_loop(lambda s: ~jnp.all(s.done), body, st)
    return st


def _search_backtrack(cfg: SearchConfig, st: State, pl: 'SearchPlanes',
                      lens, start, alive, nohave):
    """Backtrack + status assembly from a finished search state.

    alive = lanes that participated and had a valid initial window;
    nohave = lanes that participated but had none (status -2).  The
    direction-local sequence is recovered from cand_pk bits [2:0]
    (exact: base codes are <= 4)."""
    cand_pk, cum_pk = pl.cand_pk, pl.cum_pk
    B, L = cand_pk.shape
    k = cfg.k
    end = lens
    idx = jnp.arange(L, dtype=jnp.int32)
    active = alive
    # ---- backtrack the best stopped path (correct.c:232-247,374-379)
    success = active & (st.n_paths > 0) & ~st.overflow
    ec_b = cand_pk & 7
    n_absent = jnp.zeros((B,), I32)
    cur = jnp.where(success, st.min_path_k, -1)

    def bt_cond(c):
        cur, ec_b, n_absent = c
        return jnp.any(cur >= 0)

    def bt_body(c):
        cur, ec_b, n_absent = c
        m = cur >= 0
        curc = jnp.maximum(cur, 0)
        meta = jnp.where(m, _rowget(st.st_meta, curc), 0)
        ni = (meta >> 16) & 511
        run = (meta >> 25) & 63  # run node: run positions ni-run+1..ni
        nb = (meta >> 4) & 3
        write = m & (ni < lens) & (run == 0)
        wi = jnp.where(write, ni, L + 1)
        ec_b = jnp.where(idx[None, :] == wi[:, None], nb[:, None], ec_b)
        if cfg.ff_step > 0:
            nic = jnp.minimum(ni, L - 1)
            run_abs = ((_rowget(cum_pk, nic) >> 13) & 511) - (
                (_rowget(cum_pk, jnp.maximum(nic - run, 0)) >> 13) & 511
            )
            n_absent = n_absent + jnp.where(m & (run > 0), run_abs, 0)
        n_absent = n_absent + jnp.where(write, (meta >> 2) & 1, 0)
        cur = jnp.where(m, ((meta >> 6) & 1023) - 1, cur)
        return cur, ec_b, n_absent

    bt0 = (cur, ec_b, n_absent)
    if cfg.axis_name:
        bt0 = _pvary_all(bt0, cfg.axis_name)
    cur, ec_b, n_absent = jax.lax.while_loop(bt_cond, bt_body, bt0)
    # mask the region this pass is not responsible for (correct.c:378-379)
    ec_b = jnp.where(
        (idx[None, :] < start[:, None] + k) | (idx[None, :] >= end[:, None]),
        4, ec_b,
    )
    status = jnp.where(success, 0, st.rv)
    status = jnp.where(nohave, -2, status)
    out = (
        ec_b.astype(jnp.uint8),
        n_absent,
        status,
        st.max_heap,
        st.overflow & active,
        st.resum & active,  # resumable (iteration-cap-only)
        st.it,  # lockstep trip count (batch scheduling diagnostics)
        st.rovf,  # routing-bucket overflow (driver retries with 2x slack)
    )
    return out
