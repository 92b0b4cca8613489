"""SEA / ADS motion search (integral-image candidate pruning).

The reference accelerates large-range ME with Successive Elimination:
integral images give every candidate window's pixel sum in O(1), and
|sum(ref window) - sum(src block)| is a lower bound on its SAD, so
exact SADs are computed only for promising candidates (x265
`pu[].ads` slots, common/x86/seaintegral.asm integral_initv/inith,
motion.cpp:923 X265_SEA method).

Batched form: the bound is computed DENSELY for all (2r+1)^2
candidates (four integral gathers + abs-diff — one fused elementwise
pass), then `jax.lax.top_k` selects the K best lower bounds per block
and exact SAD runs only on those K windows.  Pruning is arithmetic
masking, not branching, so the whole search stays one jittable
program; vs the dense full search the exact-SAD work drops from
(2r+1)^2 to K windows per block.

The reference plane is edge-padded by r before the integral so window
sums match the dense search's clamped reads exactly; with K equal to
the full candidate count the result is bit-identical to
full_search_batch (enforced by tests/test_sea.py).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .me import mv_bits, mv_bits_np


def integral_ref(plane: np.ndarray) -> np.ndarray:
    """Scalar golden: (H+1, W+1) exclusive 2-D prefix sums (the
    concatenation of the reference's integral_initv/inith passes).
    int64 so 4K planes cannot overflow."""
    p = np.asarray(plane, np.int64)
    out = np.zeros((p.shape[0] + 1, p.shape[1] + 1), np.int64)
    out[1:, 1:] = p.cumsum(0).cumsum(1)
    return out


def integral_batch(plane: jnp.ndarray) -> jnp.ndarray:
    """(H+1, W+1) exclusive 2-D prefix sums on device.  int32 with
    wraparound: window sums are DIFFERENCES of four entries, and
    int32 addition wraps, so any window whose true sum fits int32
    (always: <= 64*64*65535) comes out exact regardless of plane
    size."""
    p = plane.astype(jnp.int32)
    s = jnp.cumsum(jnp.cumsum(p, axis=0, dtype=jnp.int32), axis=1,
                   dtype=jnp.int32)
    return jnp.pad(s, ((1, 0), (1, 0)))


@functools.partial(jax.jit, static_argnames=("n", "search_range", "k"))
def sea_search_batch(ref, orig, x0, y0, pred_mv_x, pred_mv_y,
                     lambda_x256, n: int, search_range: int = 16,
                     k: int = 48):
    """SEA-pruned integer search; same contract as full_search_batch
    (returns qpel (mv_x, mv_y, cost); cost = SAD + lambda*mvd-bits).

    k: exact-SAD candidates per block.  k >= (2r+1)^2 degrades to the
    exact dense search."""
    r = search_range
    h, w = ref.shape
    nb = x0.shape[0]
    n_cand = 2 * r + 1
    ncc = n_cand * n_cand
    k = min(k, ncc)

    # edge-padded reference: candidate windows then match the dense
    # search's clamped gathers exactly
    refp = jnp.pad(ref, r, mode="edge")
    integ = integral_batch(refp)

    gy = y0[:, None, None] + jnp.arange(n)[None, :, None]
    gx = x0[:, None, None] + jnp.arange(n)[None, None, :]
    org = orig[jnp.clip(gy, 0, h - 1),
               jnp.clip(gx, 0, w - 1)].astype(jnp.int32)

    # quadrant-granular bound (the reference ADS uses sub-block sums,
    # x264-style: sum_q |sum(ref quadrant) - sum(src quadrant)| <= SAD
    # and is far tighter than the whole-block sum on noisy content)
    hn = n // 2
    dy = jnp.arange(n_cand)[None, :, None]
    dx = jnp.arange(n_cand)[None, None, :]
    bound = jnp.zeros((nb, n_cand, n_cand), jnp.int32)
    for (qy, qx) in ((0, 0), (0, hn), (hn, 0), (hn, hn)):
        oq = jnp.sum(org[:, qy:qy + hn, qx:qx + hn], axis=(1, 2))
        ty = y0[:, None, None] + dy + qy                      # (B,C,1)
        tx = x0[:, None, None] + dx + qx                      # (B,1,C)
        ws = (integ[ty + hn, tx + hn] - integ[ty, tx + hn]
              - integ[ty + hn, tx] + integ[ty, tx])           # (B,C,C)
        bound = bound + jnp.abs(ws - oq[:, None, None])

    mvx_q = (jnp.arange(n_cand) - r) * 4
    bits = mv_bits(mvx_q[None, None, :] - pred_mv_x[:, None, None],
                   mvx_q[None, :, None] - pred_mv_y[:, None, None])
    bound = bound + ((lambda_x256 * bits) >> 8)

    # top-K most promising lower bounds -> exact SAD on those only
    _, idx = jax.lax.top_k(-bound.reshape(nb, ncc), k)        # (B,K)
    ky = idx // n_cand
    kx = idx % n_cand
    cy = y0[:, None, None, None] + ky[:, :, None, None] + \
        jnp.arange(n)[None, None, :, None]
    cx = x0[:, None, None, None] + kx[:, :, None, None] + \
        jnp.arange(n)[None, None, None, :]
    cand = refp[cy, cx].astype(jnp.int32)                     # (B,K,n,n)
    sad = jnp.sum(jnp.abs(cand - org[:, None]), axis=(2, 3))
    kb = jnp.take_along_axis(bits.reshape(nb, ncc), idx, 1)
    cost = sad + ((lambda_x256 * kb) >> 8)
    # dense-search tie-break: scan order is (dy, dx) ascending; among
    # equal costs prefer the lowest linear candidate index
    best = jnp.min(cost, axis=1)
    sel = jnp.min(jnp.where(cost == best[:, None], idx, ncc), axis=1)
    return ((sel % n_cand - r) * 4).astype(jnp.int32), \
        ((sel // n_cand - r) * 4).astype(jnp.int32), best


def sea_search_ref(ref, orig, x0, y0, pred_mv, lambda_x256, n,
                   search_range=16, k=48):
    """Scalar golden for one block (numpy; exact same pruning rule)."""
    r = search_range
    refp = np.pad(np.asarray(ref, np.int64), r, mode="edge")
    integ = integral_ref(refp)
    org = np.asarray(orig, np.int64)[y0:y0 + n, x0:x0 + n]
    hn = n // 2
    n_cand = 2 * r + 1
    rows = []
    for dy in range(n_cand):
        for dx in range(n_cand):
            b = 0
            for (qy, qx) in ((0, 0), (0, hn), (hn, 0), (hn, hn)):
                ty, tx = y0 + dy + qy, x0 + dx + qx
                ws = (integ[ty + hn, tx + hn] - integ[ty, tx + hn]
                      - integ[ty + hn, tx] + integ[ty, tx])
                b += abs(int(ws -
                             org[qy:qy + hn, qx:qx + hn].sum()))
            bits = mv_bits_np((dx - r) * 4 - pred_mv[0],
                              (dy - r) * 4 - pred_mv[1])
            rows.append((b + ((lambda_x256 * bits) >> 8),
                         dy * n_cand + dx))
    rows.sort(key=lambda t: (t[0], t[1]))
    best = (1 << 60, -1)
    for _, ci in rows[:k]:
        dy, dx = ci // n_cand, ci % n_cand
        cand = refp[y0 + dy:y0 + dy + n, x0 + dx:x0 + dx + n]
        sad = int(np.abs(cand - org).sum())
        bits = mv_bits_np((dx - r) * 4 - pred_mv[0],
                          (dy - r) * 4 - pred_mv[1])
        cost = sad + ((lambda_x256 * bits) >> 8)
        if cost < best[0] or (cost == best[0] and ci < best[1]):
            best = (cost, ci)
    ci = best[1]
    return ((ci % n_cand - r) * 4, (ci // n_cand - r) * 4, best[0])
