"""Fill the full (r=1) suffix array ON DEVICE from a subsampled slice.

The fast locate path resolves every BWT row with one gather into a full
SA (``ops/locate.py``), but at Gbp scale that array is 4 GB that the blob
does not hold.  This module uploads only ``SA[R*i]`` (any multiple ``R``
of the blob's sampling ratio, e.g. 250-500 MB) and reconstructs the rest
with LF steps on device.

Algorithm — forward PUSH along the LF cycle (total work is ~n decode+LF
ops regardless of R):

    LF maps the row holding SA value v to the row holding v-1
    (``locate/mod.rs:23-25``), and with the sentinel the LF walk is one
    n-cycle.  Start one chain at every known row; each step decodes the
    BWT symbol at the chain head (``bwm/mod.rs:217-236``), LF-steps, and
    writes ``value-1`` into the next row.  A chain dies when it lands on
    another known row (``row % R == 0``) or on the sentinel row (value 0,
    where the reference walk short-circuits, ``locate/mod.rs:27-30``).
    Every row is filled exactly once: chains partition the cycle into the
    segments between consecutive known rows.

    One segment is special: the value-0 -> value-(n-1) wrap has no chain
    entering it (no row holds value n).  Those <~R rows are finished by a
    tiny backward PULL: walk LF from each until landing on a filled row f
    after k steps, then value = SA[f] + k.

The push runs as host-driven rounds over a compacting lane array (live
chains shrink geometrically, rate 1/R per round); every decode is one
fused-row gather (``ops.rank.pre_rank_and_symidx``), ~n rank ops in all.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops.rank import U32, pre_rank_and_symidx
from ..ops.search import take_small

_UNFILLED = jnp.uint32(0xFFFFFFFF)


def _compact_to(pos, val, active, cap: int):
    """In-jit compaction to a STATIC smaller width ``cap``.  Only valid
    when the live count fits ``cap`` (nonzero truncates silently beyond
    it); the caller checks the returned count before adopting."""
    idx = jnp.nonzero(active, size=cap, fill_value=0)[0]
    count = jnp.sum(active.astype(jnp.int32))
    new_active = jnp.arange(cap, dtype=jnp.int32) < count
    return jnp.take(pos, idx), jnp.take(val, idx), new_active, count


@functools.partial(jax.jit, donate_argnums=(7,),
                   static_argnums=(0, 8, 9, 10))
def _push_rounds(meta, fused, count_arr, sentinel, pos, val, active, out,
                 R: int, rounds: int, compact_cap: int):
    """Advance every live chain ``rounds`` LF steps, scattering values.

    Also returns the state compacted to ``compact_cap`` lanes plus the
    live count — fusing the ladder's compaction into this program keeps
    the number of distinct executables (each compiled once) low.
    """
    n = out.shape[0]

    def body(_, carry):
        pos, val, active, out = carry
        posq = jnp.where(active, pos, U32(0))
        rank, sym, is_sent = pre_rank_and_symidx(meta, fused, sentinel, posq)
        alive = active & ~is_sent
        nxt = take_small(count_arr, sym, meta.sigma + 1) + rank
        # dead lanes scatter out of bounds -> dropped
        tgt = jnp.where(alive, nxt, U32(n))
        out = out.at[tgt].set(val - U32(1), mode="drop")
        cont = alive & (nxt % U32(R) != 0)
        pos = jnp.where(cont, nxt, pos)
        val = jnp.where(cont, val - U32(1), val)
        return pos, val, cont, out

    pos, val, active, out = jax.lax.fori_loop(
        0, rounds, body, (pos, val, active, out))
    cpos, cval, cactive, count = _compact_to(pos, val, active, compact_cap)
    return pos, val, active, out, cpos, cval, cactive, count


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _seed(sa_up, n: int, R: int, width: int):
    m = sa_up.shape[0]
    known = jnp.arange(m, dtype=jnp.uint32) * U32(R)
    out = jnp.full(n, _UNFILLED, dtype=jnp.uint32).at[known].set(sa_up)
    pos = jnp.zeros(width, U32).at[:m].set(known)
    val = jnp.zeros(width, U32).at[:m].set(sa_up)
    active = jnp.arange(width, dtype=jnp.int32) < m
    return out, pos, val, active


@functools.partial(jax.jit, donate_argnums=(4,), static_argnums=(0, 5))
def _pull_wrap(meta, fused, count_arr, sentinel, out, limit: int):
    """Resolve the unfilled wrap-segment rows by walking LF to a filled row."""
    n = out.shape[0]
    size = min(n, 1 << 16)
    unfilled = out == _UNFILLED
    n_unfilled = jnp.sum(unfilled.astype(jnp.int32))
    rows = jnp.nonzero(unfilled, size=size, fill_value=0)[0].astype(jnp.uint32)
    lane_ok = jnp.arange(size, dtype=jnp.int32) < n_unfilled

    def cond(carry):
        cur, off, res, resolved, it = carry
        return jnp.any(~resolved) & (it < limit)

    def body(carry):
        cur, off, res, resolved, it = carry
        # the sentinel row holds SA value 0 (locate/mod.rs:27-30)
        is_sent = (cur == sentinel - U32(1)) & ~resolved
        res = jnp.where(is_sent, off, res)
        resolved = resolved | is_sent
        curq = jnp.where(resolved, U32(0), cur)
        rank, sym, _ = pre_rank_and_symidx(meta, fused, sentinel, curq)
        nxt = take_small(count_arr, sym, meta.sigma + 1) + rank
        off2 = off + U32(1)
        lv = jnp.take(out, jnp.minimum(nxt, U32(n - 1)))
        hit = ~resolved & (lv != _UNFILLED)
        res = jnp.where(hit, lv + off2, res)
        resolved = resolved | hit
        cur = jnp.where(resolved, cur, nxt)
        off = jnp.where(resolved, off, off2)
        return cur, off, res, resolved, it + 1

    cur = rows
    off = jnp.zeros(size, U32)
    res = jnp.zeros(size, U32)
    resolved = ~lane_ok
    cur, off, res, resolved, _ = jax.lax.while_loop(
        cond, body, (cur, off, res, resolved, jnp.int32(0)))
    tgt = jnp.where(lane_ok & resolved, rows, U32(n))
    out = out.at[tgt].set(res, mode="drop")
    return out, n_unfilled, jnp.sum((lane_ok & ~resolved).astype(jnp.int32))


def fill_sa_full_device(meta, fused, count_arr, sentinel, sa_up, n: int,
                        R: int, rounds_per_call: int = 4,
                        ladder_jump: int = 16,
                        ladder_floor: int = 1 << 19):
    """uint32 [n] device array == the full suffix array.

    ``sa_up``: device uint32 [m] with ``sa_up[i] == SA[R*i]`` (i.e. the
    blob's sampled SA strided down to ratio R).  ``R`` must satisfy
    ``R*i < n`` for all i.  Results are bit-exact vs the builder's
    ``sa_full`` output (tested).  ``ladder_jump``/``ladder_floor`` tune
    the width-compaction ladder (defaults bound the distinct-executable
    count at ~3-4 for any text size — see the ladder comment below).
    """
    import os
    import time

    verbose = os.environ.get("SVIEW_SA_FILL_LOG", "") not in ("", "0")
    m = sa_up.shape[0]
    width = 1 << max((m - 1).bit_length(), 10)
    # one jitted program: eager .at[].set on a 4 GB buffer double-allocates
    # (no donation outside jit); fused full+scatter peaks at ONE buffer
    out, pos, val, active = _seed(sa_up, n, R, width)
    if n <= 1:
        return out

    # Ladder granularity: every distinct width is a distinct executable.
    # 16x jumps with the compaction FUSED into the push program (the push
    # returns its state compacted to width/16 plus the live count) bound
    # the program count at ~3-4 for any text size; the 2^19 floor keeps
    # the tail a single cheap program.
    JUMP = max(int(ladder_jump), 2)
    FLOOR = max(int(ladder_floor), 4)
    while True:
        t0 = time.time()
        shrinkable = width > FLOOR
        cap = max(width // JUMP, FLOOR) if shrinkable else 1
        # at the floor width a call is cheap but each one ends in a host
        # sync of the live count — take 4x the rounds per call there (the
        # extinction tail is ~R*log2(width) rounds)
        rpc = rounds_per_call if shrinkable else rounds_per_call * 4
        pos, val, active, out, cpos, cval, cactive, cnt = _push_rounds(
            meta, fused, count_arr, sentinel, pos, val, active, out,
            R, rpc, cap)
        c = int(cnt)
        if verbose:
            print(f"[sa_fill] width={width} active={c} "
                  f"({time.time()-t0:.2f}s)", flush=True)
        if c == 0:
            break
        if shrinkable and c <= cap and cap < width:
            pos, val, active = cpos, cval, cactive
            width = cap

    # wrap segment: at most ~R + a geometric tail of rows remain
    out, n_unfilled, n_unresolved = _pull_wrap(
        meta, fused, count_arr, sentinel, out, limit=64 * R + 1024)
    if int(n_unfilled) >= (1 << 16):
        raise RuntimeError(
            f"sa fill: {int(n_unfilled)} unfilled rows exceed the wrap-"
            "segment bound — push phase incomplete")
    if int(n_unresolved):
        raise RuntimeError(
            f"sa fill: {int(n_unresolved)} wrap rows failed to resolve")
    return out
