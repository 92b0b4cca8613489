"""Intra prediction: 35 HEVC modes (spec 8.4.4.2).

Batched analog of the reference's intra_pred[35] / intra_pred_allangs
kernel family (x265 source/common/intrapred.cpp:31-270 C kernels;
common/x86/intrapred8_allangs.asm).  Instead of 35 scalar kernels, the
batched path computes ALL modes for a batch of blocks with two gathers and
one fused multiply-add over precomputed (mode, size) index/weight tables —
the natural allangs formulation for a wide device.

Canonical neighbor layout used everywhere ("S vector", length 4N+1):
    S[0 .. 2N-1]   = left column bottom-up:  S[k] = p[-1][2N-1-k]
    S[2N]          = corner p[-1][-1]
    S[2N+1 .. 4N]  = top row: S[2N+1+x] = p[x][-1]
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..constants.hevc_tables import (
    INTRA_PRED_ANGLE, INTRA_INV_ANGLE, intra_filter_flag,
)

# ---------------------------------------------------------------------------
# Reference sample management (golden; spec 8.4.4.2.2/8.4.4.2.3)
# ---------------------------------------------------------------------------


def substitute_refs(samples: np.ndarray, available: np.ndarray,
                    bit_depth: int = 8) -> np.ndarray:
    """Reference sample substitution over the S vector (spec 8.4.4.2.2):
    scan from bottom-left (S[0]) to top-right (S[4N]); unavailable samples
    inherit the previous value in scan order."""
    s = samples.astype(np.int32).copy()
    if not available.any():
        s[:] = 1 << (bit_depth - 1)
        return s
    if not available[0]:
        first = np.argmax(available)
        s[0] = s[first]
    for k in range(1, len(s)):
        if not available[k]:
            s[k] = s[k - 1]
    return s


def filter_refs(s: np.ndarray, log2_size: int, strong: bool = False,
                bit_depth: int = 8) -> np.ndarray:
    """[1 2 1]/4 smoothing of the S vector; optional strong (linear) mode
    for 32x32 (spec 8.4.4.2.3)."""
    n = 1 << log2_size
    if strong and log2_size == 5:
        bl, corner, tr = int(s[0]), int(s[2 * n]), int(s[4 * n])
        out = s.astype(np.int32).copy()
        for i in range(1, 2 * n):          # left: S[k]=p[-1][2N-1-k]
            y = 2 * n - 1 - i
            out[i] = ((63 - y) * corner + (y + 1) * bl + 32) >> 6
        for x in range(2 * n - 1):
            out[2 * n + 1 + x] = ((63 - x) * corner + (x + 1) * tr + 32) >> 6
        return out
    out = s.astype(np.int32).copy()
    out[1:-1] = (s[:-2].astype(np.int32) + 2 * s[1:-1] + s[2:] + 2) >> 2
    return out


def strong_smoothing_condition(s: np.ndarray, log2_size: int,
                               bit_depth: int = 8) -> bool:
    if log2_size != 5:
        return False
    n = 1 << log2_size
    corner = int(s[2 * n])
    thresh = 1 << (bit_depth - 5)
    top_ok = abs(corner + int(s[4 * n]) - 2 * int(s[3 * n])) < thresh
    left_ok = abs(corner + int(s[0]) - 2 * int(s[n])) < thresh
    return top_ok and left_ok


# ---------------------------------------------------------------------------
# Golden scalar prediction (per mode)
# ---------------------------------------------------------------------------

def _refs_from_s(s: np.ndarray, n: int):
    left = s[2 * n - 1::-1]        # p[-1][y], y = 0..2N-1
    corner = int(s[2 * n])
    top = s[2 * n + 1:]            # p[x][-1], x = 0..2N-1
    return left, corner, top


def intra_pred_ref(mode: int, s: np.ndarray, log2_size: int, c_idx: int = 0,
                   bit_depth: int = 8) -> np.ndarray:
    """Golden prediction of one mode from a (substituted, pre-filtered as
    appropriate) S vector.  Returns (N, N) int array [y][x]."""
    n = 1 << log2_size
    left, corner, top = _refs_from_s(s.astype(np.int32), n)
    maxval = (1 << bit_depth) - 1

    if mode == 0:  # planar
        x = np.arange(n)[None, :]
        y = np.arange(n)[:, None]
        pred = ((n - 1 - x) * left[y] + (x + 1) * top[n]
                + (n - 1 - y) * top[x] + (y + 1) * left[n] + n) >> (log2_size + 1)
        return pred

    if mode == 1:  # DC
        dc = (int(top[:n].sum()) + int(left[:n].sum()) + n) >> (log2_size + 1)
        pred = np.full((n, n), dc, dtype=np.int32)
        if c_idx == 0 and n < 32:
            pred[0, 0] = (left[0] + 2 * dc + top[0] + 2) >> 2
            pred[0, 1:] = (top[1:n] + 3 * dc + 2) >> 2
            pred[1:, 0] = (left[1:n] + 3 * dc + 2) >> 2
        return pred

    angle = int(INTRA_PRED_ANGLE[mode - 2])
    vertical = mode >= 18
    main = np.zeros(3 * n + 2, dtype=np.int32)   # ref[-N .. 2N+1]
    base, side = (top, left) if vertical else (left, top)
    main[n] = corner
    main[n + 1: 3 * n + 1] = base[:2 * n]
    main[3 * n + 1] = base[2 * n - 1]            # clamp pad
    if angle < 0:
        inv = int(INTRA_INV_ANGLE[mode - 11]) if 11 <= mode <= 25 else 0
        low = (n * angle) >> 5
        for x in range(-1, low - 1, -1):
            idx = ((x * inv + 128) >> 8) - 1
            main[n + x] = side[min(idx, 2 * n - 1)]
    pred = np.zeros((n, n), dtype=np.int32)
    for k in range(n):                            # k = y (vert) or x (hor)
        pos = (k + 1) * angle
        i_idx = pos >> 5
        i_fact = pos & 31
        idx0 = n + 1 + i_idx + np.arange(n)
        row = ((32 - i_fact) * main[idx0] + i_fact * main[idx0 + 1] + 16) >> 5
        if vertical:
            pred[k, :] = row
        else:
            pred[:, k] = row
    # DPCM edge filters for exactly-horizontal/vertical modes (luma, <32)
    if c_idx == 0 and n < 32:
        if mode == 26:
            pred[:, 0] = np.clip(top[0] + ((left[:n] - corner) >> 1), 0, maxval)
        elif mode == 10:
            pred[0, :] = np.clip(left[0] + ((top[:n] - corner) >> 1), 0, maxval)
    return pred


def predict_block_ref(mode: int, s_unfilt: np.ndarray, log2_size: int,
                      c_idx: int = 0, bit_depth: int = 8,
                      strong_smoothing: bool = False,
                      filt_chroma: bool = False) -> np.ndarray:
    """Golden full path: choose filtered/unfiltered refs per spec, then
    predict.  filt_chroma: 4:4:4 chroma filters its reference samples
    like luma (spec 8.4.4.2.3: cIdx==0 || ChromaArrayType==3); the
    luma-only DC/edge post-filters stay off for chroma either way."""
    use_filter = (c_idx == 0 or filt_chroma) and \
        intra_filter_flag(mode, log2_size)
    if use_filter:
        strong = strong_smoothing and \
            strong_smoothing_condition(s_unfilt, log2_size, bit_depth)
        s = filter_refs(s_unfilt, log2_size, strong, bit_depth)
    else:
        s = s_unfilt
    return intra_pred_ref(mode, s, log2_size, c_idx, bit_depth)


# ---------------------------------------------------------------------------
# Batched all-modes prediction (JAX)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _angular_tables(log2_size: int):
    """Precompute per-(mode) gather/weight tables for a block size.

    Returns:
      gather_idx: (33, 3N+2) int32 — builds the extended main ref from S
      pix_idx:    (33, N) int32   — i_idx per row position k
      pix_fact:   (33, N) int32   — i_fact per row position k
      is_vertical:(33,) bool
    """
    n = 1 << log2_size
    slen = 4 * n + 1
    gather = np.zeros((33, 3 * n + 2), dtype=np.int32)
    pix_idx = np.zeros((33, n), dtype=np.int32)
    pix_fact = np.zeros((33, n), dtype=np.int32)
    vert = np.zeros(33, dtype=bool)
    for m33 in range(33):
        mode = m33 + 2
        angle = int(INTRA_PRED_ANGLE[m33])
        vertical = mode >= 18
        vert[m33] = vertical
        # S indices of corner / base ref / side ref
        if vertical:
            def base_ix(x):  # top[x]
                return 2 * n + 1 + min(x, 2 * n - 1)

            def side_ix(y):  # left[y]
                return 2 * n - 1 - min(y, 2 * n - 1)
        else:
            def base_ix(x):  # left[x]
                return 2 * n - 1 - min(x, 2 * n - 1)

            def side_ix(y):  # top[y]
                return 2 * n + 1 + min(y, 2 * n - 1)
        g = np.zeros(3 * n + 2, dtype=np.int32)
        g[n] = 2 * n                     # corner
        for x in range(2 * n):
            g[n + 1 + x] = base_ix(x)
        g[3 * n + 1] = base_ix(2 * n - 1)
        if angle < 0:
            inv = int(INTRA_INV_ANGLE[mode - 11])
            low = (n * angle) >> 5
            for x in range(-1, low - 1, -1):
                g[n + x] = side_ix(((x * inv + 128) >> 8) - 1)
        gather[m33] = g
        for k in range(n):
            pos = (k + 1) * angle
            pix_idx[m33, k] = pos >> 5
            pix_fact[m33, k] = pos & 31
    return gather, pix_idx, pix_fact, vert


@functools.partial(jax.jit, static_argnames=("log2_size", "c_idx", "bit_depth"))
def intra_pred_all_batch(s_unfilt: jnp.ndarray, s_filt: jnp.ndarray,
                         log2_size: int, c_idx: int = 0,
                         bit_depth: int = 8) -> jnp.ndarray:
    """All 35 intra modes for a batch of blocks.

    s_unfilt/s_filt: (B, 4N+1) int32 substituted S vectors (filtered copy
    precomputed by the caller; pass s_unfilt twice for chroma).
    Returns (B, 35, N, N) int32 predictions, [y][x] layout.
    """
    n = 1 << log2_size
    maxval = (1 << bit_depth) - 1
    gather, pix_idx, pix_fact, vert = _angular_tables(log2_size)
    filt_sel = np.array([intra_filter_flag(m + 2, log2_size) and c_idx == 0
                         for m in range(33)])

    su = s_unfilt.astype(jnp.int32)
    sf = s_filt.astype(jnp.int32)
    left_u = su[:, 2 * n - 1::-1]
    corner_u = su[:, 2 * n]
    top_u = su[:, 2 * n + 1:]

    # ---- angular modes 2..34 ------------------------------------------------
    s_sel = jnp.where(jnp.asarray(filt_sel)[None, :, None], sf[:, None, :],
                      su[:, None, :])                       # (B, 33, 4N+1)
    emain = jnp.take_along_axis(s_sel, jnp.asarray(gather)[None], axis=2)
    # pred[b,m,k,x] from emain[b,m, n+1+i_idx[m,k]+x] lerp next
    k_idx = jnp.asarray(pix_idx)[:, :, None] + \
        jax.lax.broadcasted_iota(jnp.int32, (33, n, n), 2)   # (33, N, N)
    j0 = jnp.clip(n + 1 + k_idx, 0, 3 * n + 1)
    j1 = jnp.clip(j0 + 1, 0, 3 * n + 1)
    f = jnp.asarray(pix_fact)[:, :, None]                    # (33, N, 1)
    # gather per (m, k, x): flatten (k,x) per mode
    jj0 = j0.reshape(33, n * n)
    jj1 = j1.reshape(33, n * n)
    p0 = jnp.take_along_axis(emain, jj0[None], axis=2).reshape(-1, 33, n, n)
    p1 = jnp.take_along_axis(emain, jj1[None], axis=2).reshape(-1, 33, n, n)
    ang = ((32 - f)[None] * p0 + f[None] * p1 + 16) >> 5     # (B,33,N,N)
    # horizontal modes: transpose x/y
    ang = jnp.where(jnp.asarray(vert)[None, :, None, None], ang,
                    jnp.swapaxes(ang, 2, 3))

    # DPCM edge filters for modes 10/26 (luma, N<32)
    if c_idx == 0 and n < 32:
        m26 = ang[:, 24]  # mode 26
        col0 = jnp.clip(top_u[:, :1] + ((left_u[:, :n] - corner_u[:, None]) >> 1),
                        0, maxval)
        m26 = m26.at[:, :, 0].set(col0)
        ang = ang.at[:, 24].set(m26)
        m10 = ang[:, 8]   # mode 10
        row0 = jnp.clip(left_u[:, :1] + ((top_u[:, :n] - corner_u[:, None]) >> 1),
                        0, maxval)
        m10 = m10.at[:, 0, :].set(row0)
        ang = ang.at[:, 8].set(m10)

    # ---- planar (uses filtered refs when filter flag set for mode 0) -------
    s_pl = sf if (c_idx == 0 and intra_filter_flag(0, log2_size)) else su
    left_p = s_pl[:, 2 * n - 1::-1]
    top_p = s_pl[:, 2 * n + 1:]
    x = jnp.arange(n)[None, None, :]
    y = jnp.arange(n)[None, :, None]
    planar = ((n - 1 - x) * left_p[:, :n][:, :, None]
              + (x + 1) * top_p[:, n][:, None, None]
              + (n - 1 - y) * top_p[:, :n][:, None, :]
              + (y + 1) * left_p[:, n][:, None, None]
              + n) >> (log2_size + 1)

    # ---- DC (always unfiltered refs) ---------------------------------------
    dc = (jnp.sum(top_u[:, :n], axis=1) + jnp.sum(left_u[:, :n], axis=1)
          + n) >> (log2_size + 1)
    dcp = jnp.broadcast_to(dc[:, None, None], (dc.shape[0], n, n))
    if c_idx == 0 and n < 32:
        dcp = dcp.at[:, 0, :].set((top_u[:, :n] + 3 * dc[:, None] + 2) >> 2)
        dcp = dcp.at[:, 1:, 0].set((left_u[:, 1:n] + 3 * dc[:, None] + 2) >> 2)
        dcp = dcp.at[:, 0, 0].set(
            (left_u[:, 0] + 2 * dc + top_u[:, 0] + 2) >> 2)

    return jnp.concatenate([planar[:, None], dcp[:, None], ang], axis=1)


@functools.partial(jax.jit, static_argnames=("log2_size", "c_idx",
                                             "bit_depth", "filt_chroma"))
def intra_pred_select_batch(s_unfilt: jnp.ndarray, s_filt: jnp.ndarray,
                            modes: jnp.ndarray, log2_size: int,
                            c_idx: int = 0,
                            bit_depth: int = 8,
                            filt_chroma: bool = False) -> jnp.ndarray:
    """Predict ONE selected mode per block (recon path).

    s_unfilt/s_filt: (B, 4N+1) int32 substituted S vectors; modes: (B,)
    int32.  Returns (B, N, N) int32, bit-exact to intra_pred_ref.
    filt_chroma: 4:4:4 chroma reference filtering (8.4.4.2.3)."""
    n = 1 << log2_size
    maxval = (1 << bit_depth) - 1
    gather, pix_idx, pix_fact, vert = _angular_tables(log2_size)
    use_f = c_idx == 0 or filt_chroma
    filt_sel = np.array([intra_filter_flag(m, log2_size) and use_f
                         for m in range(35)])

    su = s_unfilt.astype(jnp.int32)
    sf = s_filt.astype(jnp.int32)
    left_u = su[:, 2 * n - 1::-1]
    corner_u = su[:, 2 * n]
    top_u = su[:, 2 * n + 1:]

    m33 = jnp.clip(modes - 2, 0, 32)                 # angular table row
    use_filt = jnp.asarray(filt_sel)[modes]          # (B,)
    s_sel = jnp.where(use_filt[:, None], sf, su)     # (B, 4N+1)

    g = jnp.asarray(gather)[m33]                     # (B, 3N+2)
    emain = jnp.take_along_axis(s_sel, g, axis=1)    # (B, 3N+2)
    k_idx = jnp.asarray(pix_idx)[m33][:, :, None] + \
        jax.lax.broadcasted_iota(jnp.int32, (1, n, n), 2)    # (B, N, N)
    j0 = jnp.clip(n + 1 + k_idx, 0, 3 * n + 1).reshape(-1, n * n)
    j1 = jnp.clip(j0 + 1, 0, 3 * n + 2 - 1)
    f = jnp.asarray(pix_fact)[m33][:, :, None]               # (B, N, 1)
    p0 = jnp.take_along_axis(emain, j0, axis=1).reshape(-1, n, n)
    p1 = jnp.take_along_axis(emain, j1, axis=1).reshape(-1, n, n)
    ang = ((32 - f) * p0 + f * p1 + 16) >> 5
    ang = jnp.where(jnp.asarray(vert)[m33][:, None, None], ang,
                    jnp.swapaxes(ang, 1, 2))

    if c_idx == 0 and n < 32:
        col0 = jnp.clip(top_u[:, :1] + ((left_u[:, :n] - corner_u[:, None]) >> 1),
                        0, maxval)
        row0 = jnp.clip(left_u[:, :1] + ((top_u[:, :n] - corner_u[:, None]) >> 1),
                        0, maxval)
        ang = jnp.where((modes == 26)[:, None, None],
                        ang.at[:, :, 0].set(col0), ang)
        ang = jnp.where((modes == 10)[:, None, None],
                        ang.at[:, 0, :].set(row0), ang)

    # planar
    s_pl = sf if (use_f and intra_filter_flag(0, log2_size)) else su
    left_p = s_pl[:, 2 * n - 1::-1]
    top_p = s_pl[:, 2 * n + 1:]
    x = jnp.arange(n)[None, None, :]
    y = jnp.arange(n)[None, :, None]
    planar = ((n - 1 - x) * left_p[:, :n][:, :, None]
              + (x + 1) * top_p[:, n][:, None, None]
              + (n - 1 - y) * top_p[:, :n][:, None, :]
              + (y + 1) * left_p[:, n][:, None, None]
              + n) >> (log2_size + 1)

    # DC
    dc = (jnp.sum(top_u[:, :n], axis=1) + jnp.sum(left_u[:, :n], axis=1)
          + n) >> (log2_size + 1)
    dcp = jnp.broadcast_to(dc[:, None, None], (dc.shape[0], n, n))
    if c_idx == 0 and n < 32:
        dcp = dcp.at[:, 0, :].set((top_u[:, :n] + 3 * dc[:, None] + 2) >> 2)
        dcp = dcp.at[:, 1:, 0].set((left_u[:, 1:n] + 3 * dc[:, None] + 2) >> 2)
        dcp = dcp.at[:, 0, 0].set(
            (left_u[:, 0] + 2 * dc + top_u[:, 0] + 2) >> 2)

    pred = jnp.where((modes == 0)[:, None, None], planar,
                     jnp.where((modes == 1)[:, None, None], dcp, ang))
    return pred


@functools.partial(jax.jit,
                   static_argnames=("log2_size", "bit_depth", "strong"))
def substitute_filter_batch(s_raw: jnp.ndarray, avail: jnp.ndarray,
                            log2_size: int, bit_depth: int = 8,
                            strong: bool = False):
    """Batched reference substitution (spec 8.4.4.2.2) + [1 2 1] smoothing.

    s_raw: (B, 4N+1) gathered samples (garbage where unavailable);
    avail:  (B, 4N+1) bool.  strong: apply the conditional bi-linear
    strong smoothing for 32x32 luma (spec 8.4.4.2.3; golden analog
    filter_refs(strong=True) + strong_smoothing_condition).
    Returns (s_unfilt, s_filt) both (B, 4N+1) int32.
    """
    slen = s_raw.shape[-1]
    s = s_raw.astype(jnp.int32)
    idx = jnp.where(avail, jax.lax.broadcasted_iota(jnp.int32, s.shape, 1),
                    -1)
    fill = jax.lax.cummax(idx, axis=1)               # last avail idx <= k
    first = jnp.argmax(avail, axis=1)                # first avail index
    take = jnp.where(fill >= 0, fill, first[:, None])
    s_sub = jnp.take_along_axis(s, take, axis=1)
    mid = 1 << (bit_depth - 1)
    any_avail = jnp.any(avail, axis=1, keepdims=True)
    s_sub = jnp.where(any_avail, s_sub, mid)
    # [1 2 1] / 4 smoothing, endpoints passthrough
    sm = (s_sub[:, :-2] + 2 * s_sub[:, 1:-1] + s_sub[:, 2:] + 2) >> 2
    s_filt = jnp.concatenate(
        [s_sub[:, :1], sm, s_sub[:, -1:]], axis=1)
    if strong and log2_size == 5:
        n = 1 << log2_size
        bl = s_sub[:, 0]                             # p[-1][2N-1]
        corner = s_sub[:, 2 * n]
        tr = s_sub[:, 4 * n]
        thresh = 1 << (bit_depth - 5)
        cond = (jnp.abs(corner + tr - 2 * s_sub[:, 3 * n]) < thresh) & \
            (jnp.abs(corner + bl - 2 * s_sub[:, n]) < thresh)
        k = jnp.arange(slen)
        # left segment S[1..2N-1]: y = 2N-1-k; top S[2N+1+x]: x = k-2N-1
        y = 2 * n - 1 - k
        x = k - 2 * n - 1
        left_lin = ((63 - y)[None] * corner[:, None]
                    + (y + 1)[None] * bl[:, None] + 32) >> 6
        top_lin = ((63 - x)[None] * corner[:, None]
                   + (x + 1)[None] * tr[:, None] + 32) >> 6
        lin = jnp.where((k >= 1) & (k < 2 * n), left_lin,
                        jnp.where((k > 2 * n) & (k < 4 * n), top_lin,
                                  s_sub))
        s_filt = jnp.where(cond[:, None], lin, s_filt)
    return s_sub, s_filt
