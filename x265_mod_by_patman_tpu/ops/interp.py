"""Subpel interpolation for motion compensation (spec 8.5.4.2.2).

Analog of the reference's largest kernel family: 8-tap luma / 4-tap chroma
interpolation (x265 source/common/ipfilter.cpp:518 C templates;
ipfilter8.asm 14.9 KLoC).  Batched formulation: a filter along an axis
is a sum of taps shifted multiply-adds over a gathered (B, N+taps-1,
N+taps-1) window, which XLA fuses with the gather that feeds it.

Conventions (match the reference exactly for bit-exact recon):
  B = bit depth; shift1 = B-8; two-stage keeps 14-bit intermediates;
  final rounding (v + 32) >> 6 with clip.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..constants.hevc_tables import LUMA_FILTER, CHROMA_FILTER

LUMA_TAPS = 8
CHROMA_TAPS = 4


# ---------------------------------------------------------------------------
# Golden scalar (numpy) — validation decoder's MC path
# ---------------------------------------------------------------------------

def _filt1d_ref(win: np.ndarray, taps: np.ndarray, axis: int) -> np.ndarray:
    """Correlate along axis with the given taps (valid mode), int64."""
    t = len(taps)
    out_len = win.shape[axis] - t + 1
    sl = [slice(None)] * win.ndim
    acc = np.zeros([out_len if a == axis else s
                    for a, s in enumerate(win.shape)], dtype=np.int64)
    for i in range(t):
        sl[axis] = slice(i, i + out_len)
        acc += int(taps[i]) * win[tuple(sl)].astype(np.int64)
    return acc


def mc_block_ref(ref: np.ndarray, x: int, y: int, mv_x: int, mv_y: int,
                 w: int, h: int, c_idx: int = 0,
                 bit_depth: int = 8) -> np.ndarray:
    """Golden MC of one block: ref plane, block origin (x, y), MV in
    quarter-pel luma units (eighth-pel chroma units for c_idx>0).

    Out-of-bounds reads use edge clamping (the reference pads planes;
    clamping is equivalent for border extension, picyuv.cpp padding).
    """
    taps_tbl = LUMA_FILTER if c_idx == 0 else CHROMA_FILTER
    nt = LUMA_TAPS if c_idx == 0 else CHROMA_TAPS
    frac_bits = 2 if c_idx == 0 else 3
    fx = mv_x & ((1 << frac_bits) - 1)
    fy = mv_y & ((1 << frac_bits) - 1)
    ix = x + (mv_x >> frac_bits)
    iy = y + (mv_y >> frac_bits)
    half = nt // 2 - 1
    ph, pw = ref.shape
    shift1 = bit_depth - 8
    maxv = (1 << bit_depth) - 1

    ys = np.clip(np.arange(iy - half, iy + h + nt - 1 - half), 0, ph - 1)
    xs = np.clip(np.arange(ix - half, ix + w + nt - 1 - half), 0, pw - 1)
    win = ref[np.ix_(ys, xs)].astype(np.int64)   # (h+nt-1, w+nt-1)

    # final stage per spec 8.5.4.3 (default weighted pred): the 14-bit
    # intermediate is truncated to 14-bit FIRST, then rounded to B bits
    off2 = 1 << (13 - bit_depth)
    sh2 = 14 - bit_depth
    if fx == 0 and fy == 0:
        return win[half:half + h, half:half + w].astype(np.int32)
    if fy == 0:
        acc = _filt1d_ref(win[half:half + h, :], taps_tbl[fx], axis=1)
        return np.clip(((acc >> shift1) + off2) >> sh2,
                       0, maxv).astype(np.int32)
    if fx == 0:
        acc = _filt1d_ref(win[:, half:half + w], taps_tbl[fy], axis=0)
        return np.clip(((acc >> shift1) + off2) >> sh2,
                       0, maxv).astype(np.int32)
    tmp = _filt1d_ref(win, taps_tbl[fx], axis=1) >> shift1
    acc = _filt1d_ref(tmp, taps_tbl[fy], axis=0)
    return np.clip(((acc >> 6) + off2) >> sh2, 0, maxv).astype(np.int32)


# ---------------------------------------------------------------------------
# Batched JAX
# ---------------------------------------------------------------------------

def _gather_windows(ref, x0, y0, n: int, nt: int):
    """(B,) block origins -> (B, n+nt-1, n+nt-1) windows with clamped
    (edge-replicated) coordinates."""
    ph, pw = ref.shape
    half = nt // 2 - 1
    dy = jnp.arange(n + nt - 1)[None, :, None]
    dx = jnp.arange(n + nt - 1)[None, None, :]
    ys = jnp.clip(y0[:, None, None] - half + dy, 0, ph - 1)
    xs = jnp.clip(x0[:, None, None] - half + dx, 0, pw - 1)
    return ref[ys, xs].astype(jnp.int32)


def _filt1d(win, taps, axis: int):
    """Correlate along axis (valid); win int32, taps (T,) int32 array."""
    t = taps.shape[0]
    out_len = win.shape[axis] - t + 1
    idx = [slice(None)] * win.ndim
    acc = None
    for i in range(t):
        idx[axis] = slice(i, i + out_len)
        term = taps[i] * win[tuple(idx)]
        acc = term if acc is None else acc + term
    return acc


@functools.partial(jax.jit, static_argnames=("n", "c_idx", "bit_depth"))
def mc_batch(ref, x0, y0, mv_x, mv_y, n: int, c_idx: int = 0,
             bit_depth: int = 8):
    """Batched MC: (B,) origins + (B,) MVs -> (B, n, n) predictions.

    MVs in quarter-pel (luma) / eighth-pel (chroma) units.  All 4
    (frac_x!=0, frac_y!=0) cases are computed branch-free and selected
    per block (compute the superset, mask the result).
    """
    taps_np = (LUMA_FILTER if c_idx == 0 else CHROMA_FILTER).astype(np.int32)
    nt = LUMA_TAPS if c_idx == 0 else CHROMA_TAPS
    fb = 2 if c_idx == 0 else 3
    half = nt // 2 - 1
    shift1 = bit_depth - 8
    maxv = (1 << bit_depth) - 1

    fx = mv_x & ((1 << fb) - 1)
    fy = mv_y & ((1 << fb) - 1)
    ix = x0 + (mv_x >> fb)
    iy = y0 + (mv_y >> fb)
    win = _gather_windows(ref, ix, iy, n, nt)
    return _mc_core(win, fx, fy, n, nt, taps_np, bit_depth)


def _mc_core(win, fx, fy, n: int, nt: int, taps_np, bit_depth: int):
    """Exact pixel-output MC on pre-gathered windows (the filtering +
    two-stage rounding core of mc_batch)."""
    half = nt // 2 - 1
    shift1 = bit_depth - 8
    maxv = (1 << bit_depth) - 1
    taps = jnp.asarray(taps_np)                      # (F, nt)
    tx = taps[fx]                                    # (B, nt)
    ty = taps[fy]                                    # (B, nt)

    # horizontal stage on all rows (for the hv path), int32 is enough:
    # |tap|<=64? (8-bit samples * 8 taps * 64) < 2^18
    def filt_h(w_, t_):
        out_len = w_.shape[2] - nt + 1
        acc = None
        for i in range(nt):
            term = t_[:, i, None, None] * w_[:, :, i:i + out_len]
            acc = term if acc is None else acc + term
        return acc

    def filt_v(w_, t_):
        out_len = w_.shape[1] - nt + 1
        acc = None
        for i in range(nt):
            term = t_[:, i, None, None] * w_[:, i:i + out_len, :]
            acc = term if acc is None else acc + term
        return acc

    center = win[:, half:half + n, half:half + n]
    off2 = 1 << (13 - bit_depth)
    sh2 = 14 - bit_depth

    # h-only
    h_acc = filt_h(win[:, half:half + n, :], tx)
    h_only = jnp.clip(((h_acc >> shift1) + off2) >> sh2, 0, maxv)
    # v-only
    v_acc = filt_v(win[:, :, half:half + n], ty)
    v_only = jnp.clip(((v_acc >> shift1) + off2) >> sh2, 0, maxv)
    # hv
    tmp = filt_h(win, tx) >> shift1                   # (B, n+nt-1, n)
    hv_acc = filt_v(tmp, ty)
    hv = jnp.clip(((hv_acc >> 6) + off2) >> sh2, 0, maxv)

    fx_nz = (fx != 0)[:, None, None]
    fy_nz = (fy != 0)[:, None, None]
    out = jnp.where(fx_nz & fy_nz, hv,
                    jnp.where(fx_nz, h_only,
                              jnp.where(fy_nz, v_only, center)))
    return out


@functools.partial(jax.jit, static_argnames=("n", "c_idx", "bit_depth"))
def mc_batch_14(ref, x0, y0, mv_x, mv_y, n: int, c_idx: int = 0,
                bit_depth: int = 8):
    """Batched MC keeping the 14-bit intermediate (spec predSamplesLX),
    for bi-prediction combining (8.5.4.3: bi output = (L0 + L1 +
    offset2) >> (15 - B))."""
    taps_np = (LUMA_FILTER if c_idx == 0 else CHROMA_FILTER).astype(np.int32)
    nt = LUMA_TAPS if c_idx == 0 else CHROMA_TAPS
    fb = 2 if c_idx == 0 else 3
    half = nt // 2 - 1
    shift1 = bit_depth - 8

    fx = mv_x & ((1 << fb) - 1)
    fy = mv_y & ((1 << fb) - 1)
    ix = x0 + (mv_x >> fb)
    iy = y0 + (mv_y >> fb)
    win = _gather_windows(ref, ix, iy, n, nt)
    taps = jnp.asarray(taps_np)
    tx = taps[fx]
    ty = taps[fy]

    def filt_h(w_, t_):
        out_len = w_.shape[2] - nt + 1
        acc = None
        for i in range(nt):
            term = t_[:, i, None, None] * w_[:, :, i:i + out_len]
            acc = term if acc is None else acc + term
        return acc

    def filt_v(w_, t_):
        out_len = w_.shape[1] - nt + 1
        acc = None
        for i in range(nt):
            term = t_[:, i, None, None] * w_[:, i:i + out_len, :]
            acc = term if acc is None else acc + term
        return acc

    center = win[:, half:half + n, half:half + n] << (14 - bit_depth)
    h_only = filt_h(win[:, half:half + n, :], tx) >> shift1
    v_only = filt_v(win[:, :, half:half + n], ty) >> shift1
    tmp = filt_h(win, tx) >> shift1
    hv = filt_v(tmp, ty) >> 6

    fx_nz = (fx != 0)[:, None, None]
    fy_nz = (fy != 0)[:, None, None]
    return jnp.where(fx_nz & fy_nz, hv,
                     jnp.where(fx_nz, h_only,
                               jnp.where(fy_nz, v_only, center)))


def bi_combine(p0_14, p1_14, bit_depth: int = 8):
    """Default bi-prediction combine of two 14-bit predictions."""
    sh = 15 - bit_depth
    off = 1 << (sh - 1)
    return jnp.clip((p0_14 + p1_14 + off) >> sh, 0, (1 << bit_depth) - 1)


def mc_block_ref_14(ref: np.ndarray, x: int, y: int, mv_x: int, mv_y: int,
                    w: int, h: int, c_idx: int = 0,
                    bit_depth: int = 8) -> np.ndarray:
    """Golden 14-bit MC (decoder bi path)."""
    taps_tbl = LUMA_FILTER if c_idx == 0 else CHROMA_FILTER
    nt = LUMA_TAPS if c_idx == 0 else CHROMA_TAPS
    frac_bits = 2 if c_idx == 0 else 3
    fx = mv_x & ((1 << frac_bits) - 1)
    fy = mv_y & ((1 << frac_bits) - 1)
    ix = x + (mv_x >> frac_bits)
    iy = y + (mv_y >> frac_bits)
    half = nt // 2 - 1
    ph, pw = ref.shape
    shift1 = bit_depth - 8
    ys = np.clip(np.arange(iy - half, iy + h + nt - 1 - half), 0, ph - 1)
    xs = np.clip(np.arange(ix - half, ix + w + nt - 1 - half), 0, pw - 1)
    win = ref[np.ix_(ys, xs)].astype(np.int64)
    if fx == 0 and fy == 0:
        return (win[half:half + h, half:half + w]
                << (14 - bit_depth)).astype(np.int32)
    if fy == 0:
        acc = _filt1d_ref(win[half:half + h, :], taps_tbl[fx], axis=1)
        return (acc >> shift1).astype(np.int32)
    if fx == 0:
        acc = _filt1d_ref(win[:, half:half + w], taps_tbl[fy], axis=0)
        return (acc >> shift1).astype(np.int32)
    tmp = _filt1d_ref(win, taps_tbl[fx], axis=1) >> shift1
    return (_filt1d_ref(tmp, taps_tbl[fy], axis=0) >> 6).astype(np.int32)


def bi_combine_ref(p0_14: np.ndarray, p1_14: np.ndarray,
                   bit_depth: int = 8) -> np.ndarray:
    sh = 15 - bit_depth
    off = 1 << (sh - 1)
    return np.clip((p0_14.astype(np.int64) + p1_14 + off) >> sh, 0,
                   (1 << bit_depth) - 1).astype(np.int32)


# -- weighted prediction (spec 8.5.4.3.2 explicit uni; reference
# weight_pp/weight_sp primitives, pixel.cpp) --------------------------------

def wp_apply_ref(pred14, w: int, o: int, denom: int, bit_depth: int = 8):
    """Golden: weight a 14-bit uni prediction down to pixels."""
    import numpy as np
    shift1 = 14 - bit_depth
    log2wd = denom + shift1
    rnd = 1 << (log2wd - 1)
    maxv = (1 << bit_depth) - 1
    return np.clip(((pred14.astype(np.int64) * w + rnd) >> log2wd) + o,
                   0, maxv).astype(np.int32)


def wp_apply_batch(pred14, w, o, denom: int, bit_depth: int = 8):
    """Batched weighted downshift of mc_batch_14 output."""
    shift1 = 14 - bit_depth
    log2wd = denom + shift1
    rnd = 1 << (log2wd - 1)
    maxv = (1 << bit_depth) - 1
    v = (pred14.astype(jnp.int32) * w + rnd) >> log2wd
    return jnp.clip(v + o, 0, maxv).astype(jnp.int32)


def wp_bi_combine_ref(p0_14, p1_14, w0: int, o0: int, w1: int, o1: int,
                      denom: int, bit_depth: int = 8):
    """Golden weighted bidir combine (spec 8.5.4.3.2 explicit bi arm):
    ((p0*w0 + p1*w1 + ((o0+o1+1) << log2Wd)) >> (log2Wd + 1))."""
    import numpy as np
    log2wd = denom + 14 - bit_depth
    maxv = (1 << bit_depth) - 1
    acc = (p0_14.astype(np.int64) * w0 + p1_14.astype(np.int64) * w1 +
           ((o0 + o1 + 1) << log2wd))
    return np.clip(acc >> (log2wd + 1), 0, maxv).astype(np.int32)


def wp_bi_combine(p0_14, p1_14, w0, o0, w1, o1, denom: int,
                  bit_depth: int = 8):
    """Batched weighted bidir combine (traced weights)."""
    log2wd = denom + 14 - bit_depth
    maxv = (1 << bit_depth) - 1
    acc = (p0_14.astype(jnp.int32) * w0 + p1_14.astype(jnp.int32) * w1 +
           ((o0 + o1 + 1) << log2wd))
    return jnp.clip(acc >> (log2wd + 1), 0, maxv).astype(jnp.int32)
