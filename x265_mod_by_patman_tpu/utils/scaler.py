"""Polyphase plane resampler (ABR-ladder downscale).

Analog of the reference's swscale-derived Scaler (common/scaler.cpp
ScalerFilterManager, driven by the ABR-ladder app's Scaler thread,
abrEncApp.cpp:1034): separable polyphase resampling with a bicubic
kernel, fixed-point 14-bit coefficients, batched as two matmuls — a
resample IS a pair of (H_out x H_in) / (W_in x W_out) matrix
multiplies.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

SHIFT = 14
TAPS = 4


def _bicubic(x: float, a: float = -0.6) -> float:
    x = abs(x)
    if x < 1.0:
        return (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1
    if x < 2.0:
        return a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a
    return 0.0


@functools.lru_cache(maxsize=None)
def _filter_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) int32 polyphase matrix, rows sum to 1<<SHIFT."""
    m = np.zeros((n_out, n_in), np.int64)
    scale = n_in / n_out
    support = max(1.0, scale)             # widen kernel when downscaling
    for o in range(n_out):
        center = (o + 0.5) * scale - 0.5
        lo = int(np.floor(center - 2 * support)) + 1
        hi = int(np.ceil(center + 2 * support))
        xs = np.arange(lo, hi + 1)
        w = np.array([_bicubic((x - center) / support) for x in xs])
        w = w / w.sum()
        wq = np.rint(w * (1 << SHIFT)).astype(np.int64)
        wq[len(wq) // 2] += (1 << SHIFT) - wq.sum()    # exact row sum
        for x, q in zip(xs, wq):
            m[o, min(max(x, 0), n_in - 1)] += q
    return m.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _scale_jit(h_in, w_in, h_out, w_out, bit_depth):
    fv = jnp.asarray(_filter_matrix(h_in, h_out))
    fh = jnp.asarray(_filter_matrix(w_in, w_out).T)
    maxv = (1 << bit_depth) - 1

    @jax.jit
    def fn(plane):
        # int32 accumulation is exact here: |coef| sums ~1<<SHIFT and
        # samples are <= 10 bits, well inside 2^31
        t = fv @ plane.astype(jnp.int32)                      # vertical
        t = (t + (1 << (SHIFT - 1))) >> SHIFT
        t = t @ fh                                            # horizontal
        t = (t + (1 << (SHIFT - 1))) >> SHIFT
        return jnp.clip(t, 0, maxv).astype(jnp.int32)
    return fn


def scale_plane(plane: np.ndarray, w_out: int, h_out: int,
                bit_depth: int = 8) -> np.ndarray:
    h_in, w_in = plane.shape
    if (h_in, w_in) == (h_out, w_out):
        return np.asarray(plane)
    fn = _scale_jit(h_in, w_in, h_out, w_out, bit_depth)
    dt = np.uint8 if bit_depth <= 8 else np.uint16
    return np.asarray(fn(jnp.asarray(np.asarray(plane, np.int32)))) \
        .astype(dt)


def scale_frame(frame, w_out: int, h_out: int, bit_depth: int = 8):
    """(y, u, v) 4:2:0 frame -> new resolution."""
    y, u, v = frame
    return (scale_plane(y, w_out, h_out, bit_depth),
            scale_plane(u, w_out // 2, h_out // 2, bit_depth),
            scale_plane(v, w_out // 2, h_out // 2, bit_depth))
