"""Block cost metrics: SAD, SATD (Hadamard), SA8D, SSE, variance.

Analog of the reference pixel-cost primitive families (x265 source/common/
pixel.cpp sad/satd/sa8d/sse templates; primitives.h pu[].sad/satd,
cu[].sa8d/sse_pp slots).  Batched-over-blocks JAX implementations; the
Hadamard stages are expressed as integer matmuls over arbitrary batches.
Scales match x265's conventions (satd/2, (sa8d+2)/4) so lambda
tables carry over.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1]], dtype=np.int32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


H4 = _hadamard(4)
H8 = _hadamard(8)


# -- numpy golden -----------------------------------------------------------

def sad_ref(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).sum())


def satd_ref(a: np.ndarray, b: np.ndarray) -> int:
    """SATD over 4x4 Hadamard tiles (x265 satd scale: sum/2 per tile)."""
    d = a.astype(np.int32) - b.astype(np.int32)
    h, w = d.shape
    total = 0
    for y in range(0, h, 4):
        for x in range(0, w, 4):
            t = H4 @ d[y:y + 4, x:x + 4] @ H4
            total += (np.abs(t).sum() + 1) // 2
    return int(total)


def sa8d_ref(a: np.ndarray, b: np.ndarray) -> int:
    """8x8 Hadamard cost ((sum+2)/4 per tile; falls back to satd below 8)."""
    d = a.astype(np.int32) - b.astype(np.int32)
    h, w = d.shape
    if h < 8 or w < 8:
        return satd_ref(a, b)
    total = 0
    for y in range(0, h, 8):
        for x in range(0, w, 8):
            t = H8 @ d[y:y + 8, x:x + 8] @ H8
            total += (np.abs(t).sum() + 2) // 4
    return int(total)


def sse_ref(a: np.ndarray, b: np.ndarray) -> int:
    d = a.astype(np.int64) - b.astype(np.int64)
    return int((d * d).sum())


# -- JAX batched ------------------------------------------------------------

@jax.jit
def sad_batch(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(..., H, W) x2 -> (...) int32 SAD."""
    d = jnp.abs(a.astype(jnp.int32) - b.astype(jnp.int32))
    return jnp.sum(d, axis=(-2, -1))


@jax.jit
def sse_batch(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    d = a.astype(jnp.int32) - b.astype(jnp.int32)
    return jnp.sum(d * d, axis=(-2, -1))


@jax.jit
def satd_batch(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(..., H, W) -> (...) SATD over 4x4 tiles; H, W multiples of 4."""
    d = a.astype(jnp.int32) - b.astype(jnp.int32)
    *lead, h, w = d.shape
    t = d.reshape(*lead, h // 4, 4, w // 4, 4)
    t = jnp.moveaxis(t, -3, -2)                       # (..., h/4, w/4, 4, 4)
    h4 = jnp.asarray(H4)
    ht = jnp.einsum("ij,...jk,kl->...il", h4, t, h4,
                    preferred_element_type=jnp.int32)
    tile = (jnp.sum(jnp.abs(ht), axis=(-2, -1)) + 1) >> 1
    return jnp.sum(tile, axis=(-2, -1))


@jax.jit
def sa8d_batch(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(..., H, W) -> (...) SA8D over 8x8 tiles; H, W multiples of 8."""
    d = a.astype(jnp.int32) - b.astype(jnp.int32)
    *lead, h, w = d.shape
    t = d.reshape(*lead, h // 8, 8, w // 8, 8)
    t = jnp.moveaxis(t, -3, -2)
    h8 = jnp.asarray(H8)
    ht = jnp.einsum("ij,...jk,kl->...il", h8, t, h8,
                    preferred_element_type=jnp.int32)
    tile = (jnp.sum(jnp.abs(ht), axis=(-2, -1)) + 2) >> 2
    return jnp.sum(tile, axis=(-2, -1))


@jax.jit
def variance_batch(a: jnp.ndarray) -> jnp.ndarray:
    """Per-block pixel variance (AQ energy; x265 pixel.cpp var)."""
    x = a.astype(jnp.int32)
    n = x.shape[-1] * x.shape[-2]
    s = jnp.sum(x, axis=(-2, -1))
    ss = jnp.sum(x * x, axis=(-2, -1))
    return ss - (s * s) // n


# -- psy-rd energy (x265 pixel.cpp psyCost_pp) ------------------------------
#
# Per 8x8 tile: energy = sa8d(tile vs 0) - (sad(tile vs 0) >> 2); the
# sad>>2 term removes the DC component at the sa8d scale, leaving the AC
# "texture energy".  The psy cost between source and prediction/recon is
# the per-tile |energy difference| summed over the block — preserved
# energy means preserved visual texture.  4x4 tiles (blocks < 8) use
# satd - (sad >> 2), matching the reference exactly (the DC removal is
# deliberately partial there).

def psy_energy_ref(a: np.ndarray) -> int:
    """Scalar golden: total AC energy of one block (tiled)."""
    a = a.astype(np.int32)
    h, w = a.shape
    z8 = np.zeros((8, 8), np.int32)
    z4 = np.zeros((4, 4), np.int32)
    total = 0
    if h >= 8 and w >= 8:
        for y in range(0, h, 8):
            for x in range(0, w, 8):
                t = a[y:y + 8, x:x + 8]
                total += sa8d_ref(t, z8) - (int(t.sum()) >> 2)
    else:
        for y in range(0, h, 4):
            for x in range(0, w, 4):
                t = a[y:y + 4, x:x + 4]
                total += satd_ref(t, z4) - (int(t.sum()) >> 2)
    return int(total)


def psy_cost_ref(a: np.ndarray, b: np.ndarray) -> int:
    """Scalar golden: summed per-tile |energy(a) - energy(b)|."""
    a = a.astype(np.int32)
    b = b.astype(np.int32)
    h, w = a.shape
    ts = 8 if (h >= 8 and w >= 8) else 4
    total = 0
    for y in range(0, h, ts):
        for x in range(0, w, ts):
            ea = psy_energy_ref(a[y:y + ts, x:x + ts])
            eb = psy_energy_ref(b[y:y + ts, x:x + ts])
            total += abs(ea - eb)
    return int(total)


def _tile_energy(x: jnp.ndarray) -> jnp.ndarray:
    """(..., H, W) -> (..., H/ts, W/ts) per-tile AC energy."""
    *lead, h, w = x.shape
    x = x.astype(jnp.int32)
    if h >= 8 and w >= 8:
        t = jnp.moveaxis(x.reshape(*lead, h // 8, 8, w // 8, 8), -3, -2)
        hm = jnp.asarray(H8)
        ht = jnp.einsum("ij,...jk,kl->...il", hm, t, hm,
                        preferred_element_type=jnp.int32)
        sa = (jnp.sum(jnp.abs(ht), axis=(-2, -1)) + 2) >> 2
        dc = jnp.sum(t, axis=(-2, -1)) >> 2
    else:
        t = jnp.moveaxis(x.reshape(*lead, h // 4, 4, w // 4, 4), -3, -2)
        hm = jnp.asarray(H4)
        ht = jnp.einsum("ij,...jk,kl->...il", hm, t, hm,
                        preferred_element_type=jnp.int32)
        sa = (jnp.sum(jnp.abs(ht), axis=(-2, -1)) + 1) >> 1
        dc = jnp.sum(t, axis=(-2, -1)) >> 2
    return sa - dc


def psy_cost_batch(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(..., H, W) x2 -> (...) int32 psy energy difference (batched
    analog of x265 psyCost_pp)."""
    return jnp.sum(jnp.abs(_tile_energy(a) - _tile_energy(b)),
                   axis=(-2, -1))
