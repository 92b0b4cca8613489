"""Motion estimation: batched full search + subpel refinement.

Batched inversion of the reference's sequential pattern searches (x265
source/encoder/motion.cpp:923 motionEstimate, StarPatternSearch; sad_x4
multi-candidate primitives): ALL blocks of a frame search ALL candidate
MVs of a dense window simultaneously — the batched generalization of the
reference's FULL search (`--me full`, x265.h:516), which on a wide
accelerator is cheaper per candidate than pattern searches are per step
on CPU.  Subpel then evaluates the 8 half + 8 quarter offsets with SATD
on interpolated references (reference motion.cpp:1775 subpelCompare).

MV cost: lambda-weighted exp-Golomb bit estimate against the predictor
(reference's BitCost/bitcost.cpp precomputed tables).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .cost import satd_batch
from .interp import mc_batch

ME_CHUNK = 16384      # max lanes per window gather / SAD-grid buffer
                      # (bounds HLO temp memory; a 4K frame maps over
                      # bands — see full_search_batch)


def mv_bits(dx, dy):
    """Approximate MVD bit count (qpel units): EG1-ish
    2*ceil(log2(|v|+1))+1 per component (reference bitcost.h s_bitsizes
    analog).  ceil(log2(a+1)) is the bit length of a, taken in integers
    so no device's log2 rounding can move an ME decision."""
    def bitlen(v):
        return 32 - jax.lax.clz(jnp.abs(jnp.asarray(v, jnp.int32)))
    return 2 * (bitlen(dx) + bitlen(dy)) + 2


def mv_bits_np(dx, dy):
    bx = 2 * np.ceil(np.log2(np.abs(dx).astype(np.float64) + 1.0)) + 1
    by = 2 * np.ceil(np.log2(np.abs(dy).astype(np.float64) + 1.0)) + 1
    return (bx + by).astype(np.int64)


@functools.partial(jax.jit, static_argnames=("n", "search_range"))
def full_search_batch(ref, orig, x0, y0, pred_mv_x, pred_mv_y,
                      lambda_x256: int, n: int, search_range: int = 16,
                      center_x=None, center_y=None):
    """Integer full search for a batch of blocks.

    ref/orig: (H, W) int32 planes; x0/y0: (B,) block origins;
    pred_mv_*: (B,) MV predictors in QPEL units (bit-cost reference).
    center_x/center_y: optional (B,) FULLPEL window centers (HME seed
    from a coarser tier, x265 --hme analog) — the search window shifts
    to (x0 + center, y0 + center) and returned MVs include the shift.
    Returns (mv_x, mv_y) int32 (B,) in QPEL units (integer*4) and the
    best SAD cost (B,).

    Cost = SAD + (lambda_x256 * bits) >> 8  (reference rdcost.h lambda
    fixed-point convention).
    """
    nb_all = x0.shape[0]
    # byte-budgeted lane chunk: the window gather + SAD grid cost
    # ~((n+2r)^2*2 + (2r+1)*128) ints per lane, so the viable chunk
    # shrinks with the search radius (r=32 at 4K: one flat gather is
    # ~1 GB; the config-4 P core measured 9.9 GiB of temps unchunked)
    per_lane = ((n + 2 * search_range) ** 2 * 2
                + (2 * search_range + 1) * 128) * 4
    chunk = max(2048, min(ME_CHUNK, (320 << 20) // per_lane))
    if nb_all > chunk:
        nch = -(-nb_all // chunk)
        pad = nch * chunk - nb_all

        def padv(a):
            return jnp.pad(a, (0, pad)).reshape(nch, chunk)

        ops = (padv(x0), padv(y0), padv(pred_mv_x), padv(pred_mv_y),
               padv(x0 * 0 if center_x is None else center_x),
               padv(y0 * 0 if center_y is None else center_y))

        def one(args):
            xk, yk, px, py, cx, cy = args
            return full_search_batch(
                ref, orig, xk, yk, px, py, lambda_x256, n,
                search_range,
                None if center_x is None else cx,
                None if center_y is None else cy)

        mvx, mvy, cost = jax.lax.map(one, ops)
        return (mvx.reshape(-1)[:nb_all], mvy.reshape(-1)[:nb_all],
                cost.reshape(-1)[:nb_all])
    r = search_range
    h, w = ref.shape
    nb = x0.shape[0]
    cx0 = jnp.zeros_like(x0) if center_x is None else \
        jnp.asarray(center_x, jnp.int32)
    cy0 = jnp.zeros_like(y0) if center_y is None else \
        jnp.asarray(center_y, jnp.int32)
    # candidate window gathered once per block: (B, n+2r, n+2r)
    dy = jnp.arange(n + 2 * r)[None, :, None]
    dx = jnp.arange(n + 2 * r)[None, None, :]
    ys = jnp.clip((y0 + cy0)[:, None, None] - r + dy, 0, h - 1)
    xs = jnp.clip((x0 + cx0)[:, None, None] - r + dx, 0, w - 1)
    win = ref[ys, xs].astype(jnp.int32)

    gy = y0[:, None, None] + jnp.arange(n)[None, :, None]
    gx = x0[:, None, None] + jnp.arange(n)[None, None, :]
    org = orig[jnp.clip(gy, 0, h - 1),
               jnp.clip(gx, 0, w - 1)].astype(jnp.int32)

    n_cand = 2 * r + 1

    def row_cost(iy, best):
        # SADs of all horizontal offsets at vertical offset iy - r
        rows = jax.lax.dynamic_slice_in_dim(win, iy, n, axis=1)  # (B,n,n+2r)
        # build (B, n_cand, n, n) via gather on the x axis
        cx = jnp.arange(n_cand)[None, :, None, None] + \
            jnp.arange(n)[None, None, None, :]                   # (1,C,1,n)
        cand = rows[:, None, :, :]                               # (B,1,n,n+2r)
        cand = jnp.take_along_axis(
            jnp.broadcast_to(cand, (nb, n_cand, n, n + 2 * r)),
            jnp.broadcast_to(cx, (nb, n_cand, n, n)), axis=3)
        sad = jnp.sum(jnp.abs(cand - org[:, None]), axis=(2, 3))  # (B,C)
        mvx_q = ((jnp.arange(n_cand) - r)[None, :] + cx0[:, None]) * 4
        mvy_q = ((iy - r) + cy0) * 4                              # (B,)
        bits = mv_bits(mvx_q - pred_mv_x[:, None],
                       mvy_q[:, None] - pred_mv_y[:, None])
        cost = sad + ((lambda_x256 * bits) >> 8)
        best_cost, best_x, best_y = best
        row_best = jnp.min(cost, axis=1)
        row_arg = jnp.argmin(cost, axis=1)
        upd = row_best < best_cost
        best_cost = jnp.where(upd, row_best, best_cost)
        best_x = jnp.where(upd, ((row_arg - r) + cx0) * 4, best_x)
        best_y = jnp.where(upd, mvy_q, best_y)
        return best_cost, best_x, best_y

    init = (jnp.full((nb,), 1 << 30, jnp.int32),
            jnp.zeros((nb,), jnp.int32), jnp.zeros((nb,), jnp.int32))
    best_cost, best_x, best_y = jax.lax.fori_loop(0, n_cand, row_cost, init)
    return best_x, best_y, best_cost


@functools.partial(jax.jit, static_argnames=("n", "bit_depth", "subme"))
def subpel_refine_batch(ref, orig, x0, y0, mv_x, mv_y,
                        pred_mv_x, pred_mv_y, lambda_x256: int, n: int,
                        bit_depth: int = 8, subme: int = 2):
    """Half- then quarter-pel refinement with SATD (one iteration each,
    reference subme-2 equivalent).  MVs in/out in QPEL units.

    subme (reference --subme / MotionEstimate::setSearchMethod):
    0 = integer-pel only (SATD re-cost), 1 = half-pel, >=2 = quarter-pel.

    ONE superset window gather per block covers every refinement
    candidate (their integer parts differ by at most +-1 px from the
    half-stage center), so the 18 candidate evaluations filter static
    crops of it — no per-candidate gathers."""
    from .interp import _mc_core, LUMA_FILTER, LUMA_TAPS
    h, w = ref.shape
    nt = LUMA_TAPS
    nb_all = x0.shape[0]
    # byte-budgeted lane chunk (see full_search_batch): the superset
    # window + per-candidate crops cost ~3*(n+nt+1)^2 ints per lane
    per_lane = 3 * (n + nt + 1) ** 2 * 4
    chunk = max(4096, (160 << 20) // per_lane)
    if nb_all > chunk:
        nch = -(-nb_all // chunk)
        pad = nch * chunk - nb_all

        def padv(a):
            return jnp.pad(a, (0, pad)).reshape(nch, chunk)

        mvx_c, mvy_c, cost_c = jax.lax.map(
            lambda t: subpel_refine_batch(ref, orig, t[0], t[1], t[2],
                                          t[3], t[4], t[5], lambda_x256,
                                          n, bit_depth, subme),
            (padv(x0), padv(y0), padv(mv_x), padv(mv_y),
             padv(pred_mv_x), padv(pred_mv_y)))
        return (mvx_c.reshape(-1)[:nb_all], mvy_c.reshape(-1)[:nb_all],
                cost_c.reshape(-1)[:nb_all])
    half = nt // 2 - 1
    gy = y0[:, None, None] + jnp.arange(n)[None, :, None]
    gx = x0[:, None, None] + jnp.arange(n)[None, None, :]
    org = orig[jnp.clip(gy, 0, h - 1), jnp.clip(gx, 0, w - 1)] \
        .astype(jnp.int32)

    # superset window around the integer-pel search result: candidates
    # span int offsets {-1, 0, +1} relative to it (clamped coordinate
    # reads commute with slicing, so edge replication stays exact)
    sz = n + nt + 1
    base_ix = x0 + (mv_x >> 2)
    base_iy = y0 + (mv_y >> 2)
    dy = jnp.arange(sz)[None, :, None]
    dx = jnp.arange(sz)[None, None, :]
    ys = jnp.clip(base_iy[:, None, None] - half - 1 + dy, 0, h - 1)
    xs = jnp.clip(base_ix[:, None, None] - half - 1 + dx, 0, w - 1)
    win9 = ref[ys, xs].astype(jnp.int32)
    base_int_x = mv_x >> 2
    base_int_y = mv_y >> 2

    def cost_at(mx, my):
        rx = (mx >> 2) - base_int_x + 1          # {0, 1, 2}
        ry = (my >> 2) - base_int_y + 1
        we = n + nt - 1
        # select the candidate's (n+nt-1)^2 window among 9 static crops
        rows = jnp.where((ry == 0)[:, None, None], win9[:, 0:we, :],
                         jnp.where((ry == 1)[:, None, None],
                                   win9[:, 1:we + 1, :],
                                   win9[:, 2:we + 2, :]))
        wc = jnp.where((rx == 0)[:, None, None], rows[:, :, 0:we],
                       jnp.where((rx == 1)[:, None, None],
                                 rows[:, :, 1:we + 1],
                                 rows[:, :, 2:we + 2]))
        pred = _mc_core(wc, mx & 3, my & 3, n, nt, LUMA_FILTER,
                        bit_depth)
        satd = satd_batch(org, pred)
        bits = mv_bits(mx - pred_mv_x, my - pred_mv_y)
        return satd + ((lambda_x256 * bits) >> 8)

    offs8 = [(0, 0), (0, -2), (0, 2), (-2, 0), (2, 0),
             (-2, -2), (2, -2), (-2, 2), (2, 2)]
    offs4 = [(0, 0), (0, -1), (0, 1), (-1, 0), (1, 0),
             (-1, -1), (1, -1), (-1, 1), (1, 1)]

    def refine(mx, my, offs):
        # one traced body scanned over the 9 candidates (compile-size
        # control: the 18-candidate unrolled graph blew up XLA compile)
        offs_a = jnp.asarray(offs, jnp.int32)

        def body(carry, o):
            best, bx, by = carry
            cx = mx + o[0]
            cy = my + o[1]
            c = cost_at(cx, cy)
            first = best < 0
            upd = first | (c < best)
            return (jnp.where(upd, c, best),
                    jnp.where(upd, cx, bx),
                    jnp.where(upd, cy, by)), None

        init = (jnp.full(mx.shape, -1, jnp.int32), mx, my)
        (best, bx, by), _ = jax.lax.scan(body, init, offs_a)
        return bx, by, best

    if subme <= 0:
        return mv_x, mv_y, cost_at(mv_x, mv_y)
    mx, my, cost = refine(mv_x, mv_y, offs8)
    if subme >= 2:
        mx, my, cost = refine(mx, my, offs4)
    return mx, my, cost


# ---------------------------------------------------------------------------
# Golden brute force (small ranges; validates the batched search)
# ---------------------------------------------------------------------------

def full_search_ref(ref, orig, x0, y0, pred_mv, lambda_x256, n,
                    search_range, center=(0, 0)):
    """center: FULLPEL window center (the HME seed of full_search_batch)."""
    best = None
    h, w = ref.shape
    ys = np.clip(np.arange(y0, y0 + n), 0, h - 1)
    xs = np.clip(np.arange(x0, x0 + n), 0, w - 1)
    org = orig[np.ix_(ys, xs)].astype(np.int64)
    cx, cy = center
    for my in range(cy - search_range, cy + search_range + 1):
        for mx in range(cx - search_range, cx + search_range + 1):
            ys = np.clip(np.arange(y0 + my, y0 + my + n), 0, h - 1)
            xs = np.clip(np.arange(x0 + mx, x0 + mx + n), 0, w - 1)
            blk = ref[np.ix_(ys, xs)].astype(np.int64)
            sad = int(np.abs(blk - org).sum())
            bits = int(mv_bits_np(np.array(mx * 4 - pred_mv[0]),
                                  np.array(my * 4 - pred_mv[1])))
            cost = sad + ((lambda_x256 * bits) >> 8)
            # tie-break identical to the batched scan order (row-major,
            # first occurrence wins)
            if best is None or cost < best[0]:
                best = (cost, mx * 4, my * 4)
    return best[1], best[2], best[0]
