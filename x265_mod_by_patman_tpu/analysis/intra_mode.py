"""Batched intra mode decision.

Batched inversion of the reference's per-CU sequential mode search
(x265 Search::estIntraPredQT search.cpp:1855, intra_pred_allangs
primitive): ALL blocks of the frame evaluate ALL 35 modes in one batched
pass, using ORIGINAL pixels as prediction references (decouples the
decision from the recon feedback chain; the recon pass then uses true
reconstructed neighbors with the chosen mode).  This is the standard
parallel-intra decoupling — slightly suboptimal RD, massively parallel.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.intra import intra_pred_all_batch, substitute_filter_batch
from ..ops.cost import satd_batch
from ..frame.zscan import frame_avail_masks


MODE_CHUNK = 8192     # lanes per 35-mode sweep: the all-modes
                      # prediction stack is 35*n^2 ints per lane
                      # (a flat 4K frame of 16-blocks is ~1.2 GB of
                      # HLO temps — config-4 OOM); larger frames map
                      # over lane bands


@functools.partial(jax.jit, static_argnames=("log2n", "bit_depth"))
def _mode_costs(orig, avail, bx, by, log2n: int, bit_depth: int = 8):
    """SATD cost of all 35 modes for a batch of blocks predicted from
    original neighbors.  Returns (B, 35) int32."""
    nb_all = bx.shape[0]
    if nb_all > MODE_CHUNK:
        nch = -(-nb_all // MODE_CHUNK)
        pad = nch * MODE_CHUNK - nb_all

        def padv(a):
            return jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1)) \
                .reshape((nch, MODE_CHUNK) + a.shape[1:])

        out = jax.lax.map(
            lambda t: _mode_costs(orig, t[2], t[0], t[1], log2n,
                                  bit_depth),
            (padv(bx), padv(by), padv(avail)))
        return out.reshape(nch * MODE_CHUNK, 35)[:nb_all]
    n = 1 << log2n
    h, w = orig.shape
    x0 = bx * n
    y0 = by * n
    ks = np.arange(4 * n + 1)
    k_x = np.where(ks <= 2 * n, -1, ks - (2 * n + 1))
    k_y = np.where(ks < 2 * n, 2 * n - 1 - ks, -1)
    xs = jnp.clip(x0[:, None] + jnp.asarray(k_x)[None, :], 0, w - 1)
    ys = jnp.clip(y0[:, None] + jnp.asarray(k_y)[None, :], 0, h - 1)
    s_raw = orig[ys, xs]
    s_sub, s_filt = substitute_filter_batch(s_raw, avail, log2n, bit_depth)
    preds = intra_pred_all_batch(s_sub, s_filt, log2n, 0, bit_depth)
    gy = y0[:, None, None] + jnp.arange(n)[None, :, None]
    gx = x0[:, None, None] + jnp.arange(n)[None, None, :]
    org = orig[gy, gx].astype(jnp.int32)
    return satd_batch(org[:, None], preds)


@functools.partial(jax.jit, static_argnames=("log2n", "bit_depth"))
def _tu_rd_for_modes(orig, avail, bx, by, modes, qp, log2n: int,
                     bit_depth: int = 8):
    """Level-units transform+quant RD (tu_rd_levels) of coding each
    block with its GIVEN mode, predictions from original neighbors.
    The real-RD replacement for SATD in CU-split decisions (the
    reference's compressIntraCU rd-cost compare, analysis.cpp:878)."""
    from ..ops.rdoq import tu_rd_levels
    from ..ops.transform import dct_batch
    from ..ops.intra import intra_pred_select_batch
    n = 1 << log2n
    h, w = orig.shape
    x0 = bx * n
    y0 = by * n
    ks = np.arange(4 * n + 1)
    k_x = np.where(ks <= 2 * n, -1, ks - (2 * n + 1))
    k_y = np.where(ks < 2 * n, 2 * n - 1 - ks, -1)
    xs = jnp.clip(x0[:, None] + jnp.asarray(k_x)[None, :], 0, w - 1)
    ys = jnp.clip(y0[:, None] + jnp.asarray(k_y)[None, :], 0, h - 1)
    s_sub, s_filt = substitute_filter_batch(orig[ys, xs], avail, log2n,
                                            bit_depth)
    pred = intra_pred_select_batch(s_sub, s_filt, modes, log2n, 0,
                                   bit_depth)
    gy = y0[:, None, None] + jnp.arange(n)[None, :, None]
    gx = x0[:, None, None] + jnp.arange(n)[None, None, :]
    resi = orig[gy, gx].astype(jnp.int32) - pred
    return tu_rd_levels(dct_batch(resi, log2n, bit_depth), qp, log2n,
                        bit_depth)


@functools.partial(jax.jit, static_argnames=("log2n", "bit_depth"))
def _mode_costs_multi(origs, avail, bx, by, log2n: int, bit_depth: int = 8):
    """_mode_costs vmapped over a leading frame axis of origs."""
    def fn(o):
        return _mode_costs(o, avail, bx, by, log2n, bit_depth)
    return jax.vmap(fn)(origs)


def decide_modes_batch(ys, sps, block: int = 16,
                       qp: int = None) -> np.ndarray:
    """Batched mode decision for (F, h, w) frame stacks -> (F, nby, nbx);
    with qp given, applies the MPM-aware second pass per frame."""
    h, w = sps.height, sps.width
    nbx, nby = w // block, h // block
    log2n = block.bit_length() - 1
    avail = frame_avail_masks(w, h, block, sps.log2_ctu_size, 0)
    bys, bxs = np.mgrid[0:nby, 0:nbx]
    costs = np.asarray(_mode_costs_multi(
        jnp.asarray(ys).astype(jnp.int32),
        jnp.asarray(avail.reshape(-1, avail.shape[-1])),
        jnp.asarray(bxs.ravel().astype(np.int32)),
        jnp.asarray(bys.ravel().astype(np.int32)),
        log2n, sps.bit_depth)).reshape(-1, nby, nbx, 35)
    pass1 = np.argmin(costs, axis=-1).astype(np.int32)
    if qp is None:
        return pass1
    from .inter_mode import lambda_qp
    lam = lambda_qp(qp)[0] * (1 << (sps.bit_depth - 8))
    modes_axis = np.arange(35)[None, None, :]
    out = np.empty_like(pass1)
    for f in range(pass1.shape[0]):
        mpm = _mpm_grid(pass1[f], sps.log2_ctu_size, block)
        bits = np.full((nby, nbx, 35), 6.0)
        bits = np.where(modes_axis == mpm[..., 2:3], 3.0, bits)
        bits = np.where(modes_axis == mpm[..., 1:2], 3.0, bits)
        bits = np.where(modes_axis == mpm[..., 0:1], 2.0, bits)
        total = costs[f] + lam * bits
        out[f] = np.argmin(total, axis=-1)
        _homogenize_ctus(out[f], total, lam, sps, block)
    return out


def _mpm_grid(modes: np.ndarray, log2_ctu: int, block: int) -> np.ndarray:
    """Vectorized MPM derivation (spec 8.4.2) over a (nby, nbx) mode grid.
    Returns (nby, nbx, 3)."""
    nby, nbx = modes.shape
    left = np.empty_like(modes)
    left[:, 1:] = modes[:, :-1]
    left[:, 0] = 1                                  # DC when unavailable
    top = np.empty_like(modes)
    top[1:, :] = modes[:-1, :]
    top[0, :] = 1
    # above PU in a different CTU row -> DC
    ys = (np.arange(nby) * block) % (1 << log2_ctu) == 0
    top[ys, :] = 1
    a, b = left, top
    eq = a == b
    lt2 = a < 2
    m0 = np.where(eq & lt2, 0, np.where(eq, a, a))
    m1 = np.where(eq & lt2, 1,
                  np.where(eq, 2 + ((a + 29) % 32), b))
    # a != b third candidate
    c = np.where((a != 0) & (b != 0), 0,
                 np.where((a != 1) & (b != 1), 1, 26))
    m2 = np.where(eq & lt2, 26,
                  np.where(eq, 2 + ((a - 1) % 32), c))
    return np.stack([m0, m1, m2], axis=-1)


def decide_modes_rd(y: np.ndarray, sps, qp: int,
                    block: int = 16, topk: int = 0):
    """Two-pass mode decision: SATD sweep, then re-argmin with MPM-aware
    mode-bit costs derived from pass-1 neighbor modes (the batched
    stand-in for the reference's sequential MPM-bit costing,
    search.cpp:1855)."""
    from .inter_mode import lambda_qp
    h, w = sps.height, sps.width
    nbx, nby = w // block, h // block
    log2n = block.bit_length() - 1
    avail = frame_avail_masks(w, h, block, sps.log2_ctu_size, 0)
    bys, bxs = np.mgrid[0:nby, 0:nbx]
    orig = jnp.asarray(np.asarray(y, dtype=np.int32))
    costs = np.asarray(_mode_costs(
        orig, jnp.asarray(avail.reshape(-1, avail.shape[-1])),
        jnp.asarray(bxs.ravel().astype(np.int32)),
        jnp.asarray(bys.ravel().astype(np.int32)),
        log2n, sps.bit_depth)).reshape(nby, nbx, 35)
    pass1 = np.argmin(costs, axis=-1).astype(np.int32)
    mpm = _mpm_grid(pass1, sps.log2_ctu_size, block)
    lam = lambda_qp(qp)[0] * (1 << (sps.bit_depth - 8))
    modes_axis = np.arange(35)[None, None, :]
    bits = np.full((nby, nbx, 35), 6.0)             # non-MPM: flag + 5 FL
    bits = np.where(modes_axis == mpm[..., 2:3], 3.0, bits)
    bits = np.where(modes_axis == mpm[..., 1:2], 3.0, bits)
    bits = np.where(modes_axis == mpm[..., 0:1], 2.0, bits)
    total = costs + lam * bits
    modes = np.argmin(total, axis=-1).astype(np.int32)
    _homogenize_ctus(modes, total, lam, sps, block)
    if topk:
        # top-K candidate list + per-candidate mode-bin charges for the
        # in-wavefront RD selection (the sa8d candidate list handed to
        # estIntraPredQT in the reference, search.cpp:1577/1855); slot
        # 0 is the SATD winner.  CTU-homogenized blocks keep a single
        # candidate so RD selection cannot break the 32x32 merge.
        cand = np.argsort(total, axis=-1)[..., :topk].astype(np.int32)
        cand[..., 0] = modes
        hom = modes != np.argmin(total, axis=-1).astype(np.int32)
        cand[hom] = modes[hom][:, None]
        cbits = np.take_along_axis(bits, cand, axis=-1) \
            .astype(np.float32)
        return modes, cand, cbits
    return modes


def _homogenize_ctus(modes, total, lam, sps, block) -> None:
    """CTU-homogenization (in place): when one common mode costs less
    than four individual ones plus the syntax saved by a 32x32 CU merge
    (three fewer mode signalings + CU flags, ~20 bins), unify the CTU —
    the batched analog of the reference preferring a depth-0 CU when its
    RD cost beats the sum of depth-1 children (analysis.cpp
    compressIntraCU)."""
    nby, nbx = modes.shape
    bpc = (1 << sps.log2_ctu_size) // block
    if bpc != 2 or nby < 2 or nbx < 2:
        return
    cy, cx = nby // 2, nbx // 2
    t = total[:cy * 2, :cx * 2].reshape(cy, 2, cx, 2, 35)
    group = t.sum(axis=(1, 3))                    # (cy, cx, 35)
    best_common = group.min(axis=-1)
    common_mode = group.argmin(axis=-1)
    chosen = np.take_along_axis(total, modes[..., None], axis=-1)[..., 0]
    indiv = chosen[:cy * 2, :cx * 2].reshape(cy, 2, cx, 2).sum(axis=(1, 3))
    unify = best_common <= indiv + lam * 20.0
    mm = modes[:cy * 2, :cx * 2].reshape(cy, 2, cx, 2)
    cm = common_mode[:, None, :, None]
    mm[...] = np.where(unify[:, None, :, None], cm, mm)


def _mpm_grid_jnp(modes, log2_ctu: int, block: int):
    """_mpm_grid on device (jnp), same spec 8.4.2 derivation."""
    nby, nbx = modes.shape
    left = jnp.concatenate(
        [jnp.ones((nby, 1), modes.dtype), modes[:, :-1]], axis=1)
    top = jnp.concatenate(
        [jnp.ones((1, nbx), modes.dtype), modes[:-1, :]], axis=0)
    ctu_top = (jnp.arange(nby) * block) % (1 << log2_ctu) == 0
    top = jnp.where(ctu_top[:, None], 1, top)
    a, b = left, top
    eq = a == b
    lt2 = a < 2
    m0 = jnp.where(eq & lt2, 0, a)
    m1 = jnp.where(eq & lt2, 1, jnp.where(eq, 2 + ((a + 29) % 32), b))
    c = jnp.where((a != 0) & (b != 0), 0,
                  jnp.where((a != 1) & (b != 1), 1, 26))
    m2 = jnp.where(eq & lt2, 26, jnp.where(eq, 2 + ((a - 1) % 32), c))
    return jnp.stack([m0, m1, m2], axis=-1)


@functools.partial(jax.jit, static_argnames=(
    "log2n", "log2_ctu", "bit_depth", "nby", "nbx", "homog"))
def _modes_rd_multi(origs, avail, bx, by, lam, log2n: int, log2_ctu: int,
                    bit_depth: int, nby: int, nbx: int, homog: bool):
    """Whole decide_modes_rd for F frames as ONE device program (SATD
    sweep + MPM-bit re-argmin + CTU homogenization) — no host syncs, so
    the batched pipeline chains modes -> wavefront -> deblock without
    waiting on the device (lam traced: RC never recompiles)."""
    block = 1 << log2n
    f = origs.shape[0]
    costs = jax.vmap(
        lambda o: _mode_costs(o, avail, bx, by, log2n, bit_depth))(origs)
    costs = costs.reshape(f, nby, nbx, 35).astype(jnp.float32)
    pass1 = jnp.argmin(costs, axis=-1).astype(jnp.int32)
    mpm = jax.vmap(lambda m: _mpm_grid_jnp(m, log2_ctu, block))(pass1)
    ma = jnp.arange(35)[None, None, None, :]
    bits = jnp.full((f, nby, nbx, 35), 6.0, jnp.float32)
    bits = jnp.where(ma == mpm[..., 2:3], 3.0, bits)
    bits = jnp.where(ma == mpm[..., 1:2], 3.0, bits)
    bits = jnp.where(ma == mpm[..., 0:1], 2.0, bits)
    total = costs + lam * bits
    modes = jnp.argmin(total, axis=-1).astype(jnp.int32)
    if not homog:
        return modes
    cy, cx = nby // 2, nbx // 2

    def homog_one(mo, to):
        t = to[:cy * 2, :cx * 2].reshape(cy, 2, cx, 2, 35)
        group = t.sum(axis=(1, 3))
        best_common = group.min(axis=-1)
        common = group.argmin(axis=-1).astype(jnp.int32)
        chosen = jnp.take_along_axis(to, mo[..., None], axis=-1)[..., 0]
        indiv = chosen[:cy * 2, :cx * 2].reshape(cy, 2, cx, 2) \
            .sum(axis=(1, 3))
        unify = best_common <= indiv + lam * 20.0
        mm = mo[:cy * 2, :cx * 2].reshape(cy, 2, cx, 2)
        mm = jnp.where(unify[:, None, :, None], common[:, None, :, None],
                       mm).reshape(cy * 2, cx * 2)
        return mo.at[:cy * 2, :cx * 2].set(mm)

    return jax.vmap(homog_one)(modes, total)


_GEOM_CACHE: dict = {}


def decide_modes_rd_multi(ys, sps, qp, block: int = 16):
    """decide_modes_rd for (F, h, w) stacks, fully on device — returns a
    DEVICE (F, nby, nbx) int32 array (async; do not block on it)."""
    from .inter_mode import lambda_qp
    h, w = sps.height, sps.width
    nbx, nby = w // block, h // block
    log2n = block.bit_length() - 1
    key = (w, h, block, sps.log2_ctu_size)
    if key not in _GEOM_CACHE:
        avail = frame_avail_masks(w, h, block, sps.log2_ctu_size, 0)
        bys, bxs = np.mgrid[0:nby, 0:nbx]
        _GEOM_CACHE[key] = (
            jnp.asarray(avail.reshape(-1, avail.shape[-1])),
            jnp.asarray(bxs.ravel().astype(np.int32)),
            jnp.asarray(bys.ravel().astype(np.int32)))
    avail, bx, by = _GEOM_CACHE[key]
    lam = lambda_qp(qp)[0] * (1 << (sps.bit_depth - 8))
    bpc = (1 << sps.log2_ctu_size) // block
    return _modes_rd_multi(
        jnp.asarray(ys).astype(jnp.int32), avail, bx, by,
        jnp.float32(lam), log2n, sps.log2_ctu_size, sps.bit_depth,
        nby, nbx, bpc == 2 and nby >= 2 and nbx >= 2)


def decide_modes(y: np.ndarray, sps, block: int = 16) -> np.ndarray:
    """Choose the SATD-best of 35 modes per block.  Returns (nby, nbx)."""
    h, w = sps.height, sps.width
    nbx, nby = w // block, h // block
    log2n = block.bit_length() - 1
    avail = frame_avail_masks(w, h, block, sps.log2_ctu_size, 0)
    bys, bxs = np.mgrid[0:nby, 0:nbx]
    orig = jnp.asarray(np.asarray(y, dtype=np.int32))
    costs = _mode_costs(orig,
                        jnp.asarray(avail.reshape(-1, avail.shape[-1])),
                        jnp.asarray(bxs.ravel().astype(np.int32)),
                        jnp.asarray(bys.ravel().astype(np.int32)),
                        log2n, sps.bit_depth)
    modes = np.asarray(jnp.argmin(costs, axis=1), dtype=np.int32)
    return modes.reshape(nby, nbx)


def decide_modes_tree(y: np.ndarray, sps, qp: int, nxn: bool = False):
    """Variable CU-tree intra decision over depths {32, 16(, 8 NxN)}:
    dense 35-mode sweeps at each size, then a bottom-up split DP (the
    batched analog of compressIntraCU's depth recursion with RD compare,
    analysis.cpp:878/4271 — SATD + lambda * syntax-bit costs here, like
    the reference's rd<=4 sa8d decisions).

    Returns (modes16 (nby,nbx), split_map8 or None, modes8 or None,
    split32 (n32y,n32x) bool, mode32 (n32y,n32x) int32)."""
    from .inter_mode import lambda_qp
    h, w = sps.height, sps.width
    nbx, nby = w // 16, h // 16
    n32x, n32y = w // 32, h // 32
    lam = lambda_qp(qp)[0] * (1 << (sps.bit_depth - 8))
    if nxn:
        modes16, split_map, modes8 = decide_modes_split(y, sps, qp, 16)
        cand16 = cbits16 = None
    else:
        modes16, cand16, cbits16 = decide_modes_rd(y, sps, qp, 16,
                                                   topk=3)
        split_map = modes8 = None

    # 16-level totals of the CHOSEN modes (mode-bit charge ~4 bins each)
    avail = frame_avail_masks(w, h, 16, sps.log2_ctu_size, 0)
    bys, bxs = np.mgrid[0:nby, 0:nbx]
    orig = jnp.asarray(np.asarray(y, dtype=np.int32))
    c16 = np.asarray(_mode_costs(
        orig, jnp.asarray(avail.reshape(-1, avail.shape[-1])),
        jnp.asarray(bxs.ravel().astype(np.int32)),
        jnp.asarray(bys.ravel().astype(np.int32)),
        4, sps.bit_depth)).reshape(nby, nbx, 35)
    best16 = np.take_along_axis(c16, modes16[..., None],
                                axis=-1)[..., 0] + lam * 4.0

    # 32-level sweep
    avail32 = frame_avail_masks(w, h, 32, sps.log2_ctu_size, 0)
    b32y, b32x = np.mgrid[0:n32y, 0:n32x]
    c32 = np.asarray(_mode_costs(
        orig, jnp.asarray(avail32.reshape(-1, avail32.shape[-1])),
        jnp.asarray(b32x.ravel().astype(np.int32)),
        jnp.asarray(b32y.ravel().astype(np.int32)),
        5, sps.bit_depth)).reshape(n32y, n32x, 35)
    mpm32 = _mpm_grid(np.argmin(c32, axis=-1).astype(np.int32),
                      sps.log2_ctu_size, 32)
    bits32 = np.full((n32y, n32x, 35), 6.0)
    ma = np.arange(35)[None, None, :]
    bits32 = np.where(ma == mpm32[..., 2:3], 3.0, bits32)
    bits32 = np.where(ma == mpm32[..., 1:2], 3.0, bits32)
    bits32 = np.where(ma == mpm32[..., 0:1], 2.0, bits32)
    t32 = c32 + lam * bits32
    mode32 = np.argmin(t32, axis=-1).astype(np.int32)
    best32 = t32.min(axis=-1)

    # bottom-up DP on REAL transform+quant RD (tu_rd_levels, level
    # units — the rd-cost compare of compressIntraCU, analysis.cpp:878;
    # SATD over-merged to 32 by ~3.5% BD on detailed content): unsplit
    # saves 3 per-CU syntax sets (~22 bins); boundary regions split
    K = 0.134
    rd16 = np.asarray(_tu_rd_for_modes(
        orig, jnp.asarray(avail.reshape(-1, avail.shape[-1])),
        jnp.asarray(bxs.ravel().astype(np.int32)),
        jnp.asarray(bys.ravel().astype(np.int32)),
        jnp.asarray(modes16.ravel().astype(np.int32)),
        qp, 4, sps.bit_depth)).reshape(nby, nbx)
    rd32 = np.asarray(_tu_rd_for_modes(
        orig, jnp.asarray(avail32.reshape(-1, avail32.shape[-1])),
        jnp.asarray(b32x.ravel().astype(np.int32)),
        jnp.asarray(b32y.ravel().astype(np.int32)),
        jnp.asarray(mode32.ravel().astype(np.int32)),
        qp, 5, sps.bit_depth)).reshape(n32y, n32x)
    if cbits16 is not None:
        chosen_bits16 = cbits16[..., 0]
    else:
        chosen_bits16 = np.full((nby, nbx), 4.0)
    bits32_chosen = np.take_along_axis(
        bits32, mode32[..., None], axis=-1)[..., 0]

    def q16(a):
        return (a[0:2 * n32y:2, 0:2 * n32x:2]
                + a[0:2 * n32y:2, 1:2 * n32x:2]
                + a[1:2 * n32y:2, 0:2 * n32x:2]
                + a[1:2 * n32y:2, 1:2 * n32x:2])

    cost32 = rd32 + K * bits32_chosen
    cost16 = q16(rd16) + K * (q16(chosen_bits16) + 22.0)
    split32 = cost32 > cost16
    if split_map is not None:
        # a 16-block that chose NxN carries TU8/TU4 levels in its slot;
        # the unsplit-32 assembly can't represent that — and NxN means
        # detail where a TU32 CU loses anyway
        nxn_any = (split_map[0:2 * n32y:2, 0:2 * n32x:2]
                   | split_map[0:2 * n32y:2, 1:2 * n32x:2]
                   | split_map[1:2 * n32y:2, 0:2 * n32x:2]
                   | split_map[1:2 * n32y:2, 1:2 * n32x:2])
        split32 = split32 | nxn_any
    return (modes16, split_map, modes8, split32, mode32,
            cand16, cbits16)


@functools.partial(jax.jit, static_argnames=("bit_depth",))
def _tu4_costs(orig, avail, bx, by, modes, qp, bit_depth: int = 8):
    """TU8(DCT) vs 4xTU4(DST) level-units RD per 8x8 sub-PU (orig
    neighbors, shared 8x8 prediction — an estimate of the reference's
    per-TB codeIntraLumaQT recursion, search.cpp:646).  Returns
    (rd8, rd4) float32 (B,) pairs; rd4 excludes the split syntax
    charge (the caller adds it)."""
    from ..ops.rdoq import tu_rd_levels
    from ..ops.transform import dct_batch
    h, w = orig.shape
    n = 8
    x0 = bx * n
    y0 = by * n
    ks = np.arange(4 * n + 1)
    k_x = np.where(ks <= 2 * n, -1, ks - (2 * n + 1))
    k_y = np.where(ks < 2 * n, 2 * n - 1 - ks, -1)
    xs = jnp.clip(x0[:, None] + jnp.asarray(k_x)[None, :], 0, w - 1)
    ys = jnp.clip(y0[:, None] + jnp.asarray(k_y)[None, :], 0, h - 1)
    s_sub, s_filt = substitute_filter_batch(orig[ys, xs], avail, 3,
                                            bit_depth)
    from ..ops.intra import intra_pred_select_batch
    pred = intra_pred_select_batch(s_sub, s_filt, modes, 3, 0,
                                   bit_depth)
    gy = y0[:, None, None] + jnp.arange(n)[None, :, None]
    gx = x0[:, None, None] + jnp.arange(n)[None, None, :]
    resi = orig[gy, gx].astype(jnp.int32) - pred
    coef8 = dct_batch(resi, 3, bit_depth)
    rd8 = tu_rd_levels(coef8, qp, 3, bit_depth)
    q = resi.reshape(-1, 2, 4, 2, 4).transpose(0, 1, 3, 2, 4) \
        .reshape(-1, 4, 4)
    coef4 = dct_batch(q, 2, bit_depth, dst=True)
    rd4 = tu_rd_levels(coef4, qp, 2, bit_depth).reshape(-1, 4).sum(-1)
    return rd8, rd4


def decide_tu4_split(y: np.ndarray, sps, qp: int, modes8: np.ndarray,
                     split_map: np.ndarray) -> np.ndarray:
    """Per-NxN-quad TU4(DST) split decision (nby, nbx, 4) bool: split
    the 8x8 luma TU into four DST 4x4 TBs when the level-units RD
    (tu_rd_levels) plus the split syntax charge wins."""
    h, w = sps.height, sps.width
    nbx, nby = w // 16, h // 16
    avail8 = frame_avail_masks(w, h, 8, sps.log2_ctu_size, 0)
    bys, bxs = np.mgrid[0:2 * nby, 0:2 * nbx]
    orig = jnp.asarray(np.asarray(y, dtype=np.int32))
    m8 = np.empty((2 * nby, 2 * nbx), np.int32)
    m8[0::2, 0::2] = modes8[..., 0]
    m8[0::2, 1::2] = modes8[..., 1]
    m8[1::2, 0::2] = modes8[..., 2]
    m8[1::2, 1::2] = modes8[..., 3]
    rd8, rd4 = _tu4_costs(
        orig, jnp.asarray(avail8.reshape(-1, avail8.shape[-1])),
        jnp.asarray(bxs.ravel().astype(np.int32)),
        jnp.asarray(bys.ravel().astype(np.int32)),
        jnp.asarray(m8.ravel()), jnp.int32(qp), sps.bit_depth)
    # split charge: split_transform_flag + 3 extra cbf/last overheads
    # ~ 8 bins at K=0.134 level units
    win = (np.asarray(rd4) + 0.134 * 8.0 <
           np.asarray(rd8)).reshape(2 * nby, 2 * nbx)
    tu4 = np.stack([win[0::2, 0::2], win[0::2, 1::2],
                    win[1::2, 0::2], win[1::2, 1::2]], axis=-1)
    return tu4 & split_map[..., None]


@functools.partial(jax.jit, static_argnames=("bit_depth",))
def _nxn_rd_costs(orig, avail16, bx16, by16, modes16,
                  avail8, bx8, by8, modes8_flat, qp,
                  bit_depth: int = 8):
    """Level-units RD of the 2Nx2N TU16 vs the 4x TU8 NxN path per
    16x16 block (orig-neighbor predictions, the same estimate family as
    _tu4_costs).  Returns (rd16 (B16,), rd8 (B8,)) — the caller z-sums
    rd8 per quad and adds the NxN syntax charge."""
    from ..ops.rdoq import tu_rd_levels
    from ..ops.transform import dct_batch
    from ..ops.intra import intra_pred_select_batch
    h, w = orig.shape

    def tb_rd(bx, by, modes, avail, log2n):
        n = 1 << log2n
        x0 = bx * n
        y0 = by * n
        ks = np.arange(4 * n + 1)
        k_x = np.where(ks <= 2 * n, -1, ks - (2 * n + 1))
        k_y = np.where(ks < 2 * n, 2 * n - 1 - ks, -1)
        xs = jnp.clip(x0[:, None] + jnp.asarray(k_x)[None, :], 0, w - 1)
        ys = jnp.clip(y0[:, None] + jnp.asarray(k_y)[None, :], 0, h - 1)
        s_sub, s_filt = substitute_filter_batch(orig[ys, xs], avail,
                                                log2n, bit_depth)
        pred = intra_pred_select_batch(s_sub, s_filt, modes, log2n, 0,
                                       bit_depth)
        gy = y0[:, None, None] + jnp.arange(n)[None, :, None]
        gx = x0[:, None, None] + jnp.arange(n)[None, None, :]
        resi = orig[gy, gx].astype(jnp.int32) - pred
        coef = dct_batch(resi, log2n, bit_depth)
        return tu_rd_levels(coef, qp, log2n, bit_depth)

    return (tb_rd(bx16, by16, modes16, avail16, 4),
            tb_rd(bx8, by8, modes8_flat, avail8, 3))


def decide_modes_split(y: np.ndarray, sps, qp: int, block: int = 16,
                       tu4: bool = False):
    """Mode decision with the NxN (4x 8x8 PU) candidate per block: the
    batched analog of the reference comparing the 2Nx2N intra cost with
    the NxN sum at min CU size (compressIntraCU, analysis.cpp:878).

    tu4: --tu-intra-depth 2 active — the RD gate credits the split side
    with its best-of {TU8, 4xTU4 DST} cost (codeIntraLumaQT recursion),
    otherwise thin 4-px detail that only TU4 captures never survives
    the 16-vs-8 compare.

    Returns (modes (nby,nbx) int32 — PU0's mode for split blocks,
    split_map (nby,nbx) bool, modes8 (nby,nbx,4) int32)."""
    from .inter_mode import lambda_qp
    h, w = sps.height, sps.width
    nbx, nby = w // block, h // block
    lam = lambda_qp(qp)[0] * (1 << (sps.bit_depth - 8))
    modes = decide_modes_rd(y, sps, qp, block)
    # 8x8 sweep on the doubled grid (orig-neighbor estimate)
    avail8 = frame_avail_masks(w, h, 8, sps.log2_ctu_size, 0)
    bys, bxs = np.mgrid[0:2 * nby, 0:2 * nbx]
    orig = jnp.asarray(np.asarray(y, dtype=np.int32))
    c8 = np.asarray(_mode_costs(
        orig, jnp.asarray(avail8.reshape(-1, avail8.shape[-1])),
        jnp.asarray(bxs.ravel().astype(np.int32)),
        jnp.asarray(bys.ravel().astype(np.int32)),
        3, sps.bit_depth)).reshape(2 * nby, 2 * nbx, 35)
    best8 = (c8 + lam * 5.5).min(axis=-1)
    m8 = c8.argmin(axis=-1).astype(np.int32)
    # z-order gather of the 4 sub-blocks per 16x16 block
    sum8 = (best8[0::2, 0::2] + best8[0::2, 1::2] +
            best8[1::2, 0::2] + best8[1::2, 1::2])
    modes8 = np.stack([m8[0::2, 0::2], m8[0::2, 1::2],
                       m8[1::2, 0::2], m8[1::2, 1::2]], axis=-1)
    # 16x16 side: SATD of the chosen mode + its bits (~4)
    c16 = np.asarray(_mode_costs(
        orig, jnp.asarray(frame_avail_masks(
            w, h, block, sps.log2_ctu_size, 0)
            .reshape(-1, 4 * block + 1)),
        jnp.asarray((np.mgrid[0:nby, 0:nbx][1]).ravel()
                    .astype(np.int32)),
        jnp.asarray((np.mgrid[0:nby, 0:nbx][0]).ravel()
                    .astype(np.int32)),
        block.bit_length() - 1, sps.bit_depth)) \
        .reshape(nby, nbx, 35)
    cost16 = np.take_along_axis(c16, modes[..., None],
                                axis=-1)[..., 0] + lam * 4.0
    # NxN extra syntax: part bin + deeper-TU cbf flags ~ 6 bins
    split = sum8 + lam * 6.0 < cost16
    if split.any():
        # RD gate (the reference RD-arbitrates partSize via checkIntra,
        # search.cpp:1577): the SATD sum undercosts four independent
        # noise-chasing modes on grain — ungated NxN measured +26.9%
        # BD-rate Y on the park clip (BENCH_NOTES round-4 s3).  Verify
        # every SATD-proposed split with level-units RD (quant path +
        # rate model, tu_rd_levels) before letting it code.
        rd16, rd8f = _nxn_rd_costs(
            orig, jnp.asarray(frame_avail_masks(
                w, h, block, sps.log2_ctu_size, 0)
                .reshape(-1, 4 * block + 1)),
            jnp.asarray((np.mgrid[0:nby, 0:nbx][1]).ravel()
                        .astype(np.int32)),
            jnp.asarray((np.mgrid[0:nby, 0:nbx][0]).ravel()
                        .astype(np.int32)),
            jnp.asarray(modes.ravel()),
            jnp.asarray(avail8.reshape(-1, avail8.shape[-1])),
            jnp.asarray(bxs.ravel().astype(np.int32)),
            jnp.asarray(bys.ravel().astype(np.int32)),
            jnp.asarray(m8.ravel()), jnp.int32(qp), sps.bit_depth)
        rd16 = np.asarray(rd16).reshape(nby, nbx)
        rd8f = np.asarray(rd8f)
        if tu4:
            _, rd4f = _tu4_costs(
                orig, jnp.asarray(avail8.reshape(-1, avail8.shape[-1])),
                jnp.asarray(bxs.ravel().astype(np.int32)),
                jnp.asarray(bys.ravel().astype(np.int32)),
                jnp.asarray(m8.ravel()), jnp.int32(qp), sps.bit_depth)
            # split charge mirrors decide_tu4_split (8 bins)
            rd8f = np.minimum(rd8f, np.asarray(rd4f) + 0.134 * 8.0)
        r8 = rd8f.reshape(2 * nby, 2 * nbx)
        rd8 = (r8[0::2, 0::2] + r8[0::2, 1::2]
               + r8[1::2, 0::2] + r8[1::2, 1::2])
        # NxN syntax + model-bias charge, in level units.  Calibrated
        # on the park sweep (round 5): 24 bins still regressed +6.3%
        # BD-rate Y (the orig-neighbor estimate undercosts the split
        # side), 64 turns NxN into a measured WIN (+25.0%Y vs +25.8%Y
        # baseline without NxN); 128 gates nearly everything (neutral).
        _ov = float(os.environ.get("X265TPU_NXN_BINS", "64")) \
            if os.environ.get("X265TPU_NXN_BINS") else 64.0
        split &= rd8 + 0.134 * _ov < rd16
    out = modes.copy()
    out[split] = modes8[split][:, 0]
    return out, split, modes8
