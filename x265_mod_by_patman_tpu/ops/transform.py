"""Forward/inverse transforms and (de)quantization.

Batched analog of the reference kernel families dct/idct/dst/quant/
dequant (x265 source/common/dct.cpp:418-614 partial butterflies,
source/common/quant.cpp quant/dequant; table registry primitives.h
cu[].dct/idct/quant slots).

Two implementations of each op:
  *_ref  — numpy golden, scalar-faithful to the spec's integer arithmetic
           (the "C kernel" of the checkasm strategy, SURVEY.md §4.1)
  jax fns — batched over a leading axis of blocks, same bit-exact integer
           math in int32, shaped as matmuls (batch, N, N) x (N, N).

All transforms are expressed as two rounded integer matmuls instead of the
reference's butterfly factorization: on a wide device the full matmul
is the fast path; butterflies are a scalar-ISA optimization we
deliberately do not port.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..constants.hevc_tables import (
    DCT4, DCT8, DCT16, DCT32, DST4, QUANT_SCALES, INV_QUANT_SCALES,
    dct_matrix,
)

MAX_TR_DYNAMIC_RANGE = 15
QUANT_SHIFT = 14
IQUANT_SHIFT = 20


# ---------------------------------------------------------------------------
# numpy golden
# ---------------------------------------------------------------------------

def _rshift_round(x: np.ndarray, shift: int) -> np.ndarray:
    return (x + (1 << (shift - 1))) >> shift


def dct_ref(resi: np.ndarray, bit_depth: int = 8, dst: bool = False) -> np.ndarray:
    """Forward core transform of an NxN residual block -> int16 coeffs.

    Matches HM/x265 two-stage arithmetic: stage shifts log2N-9+bitDepth
    and log2N+6 with round-half-up, intermediate kept in int32.
    """
    n = resi.shape[0]
    log2n = n.bit_length() - 1
    t = (DST4 if dst else dct_matrix(log2n)).astype(np.int64)
    s1 = log2n - 9 + bit_depth
    s2 = log2n + 6
    src = resi.astype(np.int64)
    tmp = _rshift_round(t @ src.T, s1)
    out = _rshift_round(t @ tmp.T, s2)
    return out.astype(np.int16)


def idct_ref(coef: np.ndarray, bit_depth: int = 8, dst: bool = False) -> np.ndarray:
    """Inverse core transform -> int16 residual (clipped per spec)."""
    n = coef.shape[0]
    log2n = n.bit_length() - 1
    t = (DST4 if dst else dct_matrix(log2n)).astype(np.int64)
    s1 = 7
    s2 = 20 - bit_depth
    tmp = np.clip(_rshift_round((t.T @ coef.astype(np.int64)).T, s1),
                  -32768, 32767)
    out = np.clip(_rshift_round((t.T @ tmp).T, s2), -32768, 32767)
    return out.astype(np.int16)


def quant_ref(coef: np.ndarray, qp: int, log2_size: int, bit_depth: int = 8,
              is_intra: bool = True) -> np.ndarray:
    """Scalar RDO-free quantization (x265 quant.cpp quant_c path, flat
    scaling list)."""
    per, rem = qp // 6, qp % 6
    transform_shift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    qbits = QUANT_SHIFT + per + transform_shift
    add = (171 if is_intra else 85) << (qbits - 9)
    scale = int(QUANT_SCALES[rem])
    c = coef.astype(np.int64)
    level = (np.abs(c) * scale + add) >> qbits
    level = np.clip(level, 0, 32767)
    return (np.sign(c) * level).astype(np.int16)


def dequant_ref(level: np.ndarray, qp: int, log2_size: int,
                bit_depth: int = 8, mat=None) -> np.ndarray:
    """Flat-list dequant (x265 dequant_normal_c); with mat: spec 8.6.3
    scaling-list dequant (x265 dequant_scaling_c)."""
    per, rem = qp // 6, qp % 6
    transform_shift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    shift = IQUANT_SHIFT - QUANT_SHIFT - transform_shift
    lv = level.astype(np.int64)
    if mat is None:
        scale = int(INV_QUANT_SCALES[rem]) << per
        coef = (lv * scale + (1 << (shift - 1))) >> shift
    else:
        scale = (mat.astype(np.int64) * int(INV_QUANT_SCALES[rem])) << per
        coef = (lv * scale + (1 << (shift + 3))) >> (shift + 4)
    return np.clip(coef, -32768, 32767).astype(np.int16)


# ---------------------------------------------------------------------------
# JAX batched (leading blocks axis); integer math in int32
# ---------------------------------------------------------------------------

def _jr(x, shift):
    return (x + (1 << (shift - 1))) >> shift


@functools.partial(jax.jit, static_argnames=("log2n", "bit_depth", "dst"))
def dct_batch(resi: jnp.ndarray, log2n: int, bit_depth: int = 8,
              dst: bool = False) -> jnp.ndarray:
    """(B, N, N) int residual -> (B, N, N) int32 coeffs, bit-exact to
    dct_ref.  Two integer matmuls with integer rounding."""
    t = jnp.asarray((DST4 if dst else dct_matrix(log2n)).astype(np.int32))
    s1 = log2n - 9 + bit_depth
    s2 = log2n + 6
    src = resi.astype(jnp.int32)
    # stage 1: tmp[b, k, j] = sum_i T[k,i] src[b, j, i]
    tmp = _jr(jnp.einsum("ki,bji->bkj", t, src,
                         preferred_element_type=jnp.int32), s1)
    out = _jr(jnp.einsum("ki,bji->bkj", t, tmp,
                         preferred_element_type=jnp.int32), s2)
    return out


@functools.partial(jax.jit, static_argnames=("log2n", "bit_depth", "dst"))
def idct_batch(coef: jnp.ndarray, log2n: int, bit_depth: int = 8,
               dst: bool = False) -> jnp.ndarray:
    t = jnp.asarray((DST4 if dst else dct_matrix(log2n)).astype(np.int32))
    s2 = 20 - bit_depth
    c = coef.astype(jnp.int32)
    tmp = jnp.clip(_jr(jnp.einsum("ik,bij->bjk", t, c,
                                  preferred_element_type=jnp.int32), 7),
                   -32768, 32767)
    out = jnp.clip(_jr(jnp.einsum("ik,bij->bjk", t, tmp,
                                  preferred_element_type=jnp.int32), s2),
                   -32768, 32767)
    return out


@functools.partial(jax.jit,
                   static_argnames=("qp", "log2_size", "bit_depth", "is_intra"))
def quant_batch(coef: jnp.ndarray, qp: int, log2_size: int,
                bit_depth: int = 8, is_intra: bool = True) -> jnp.ndarray:
    per, rem = qp // 6, qp % 6
    transform_shift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    qbits = QUANT_SHIFT + per + transform_shift
    add = (171 if is_intra else 85) << (qbits - 9)
    scale = int(QUANT_SCALES[rem])
    c = coef.astype(jnp.int32)
    # abs(coef)<2^15 and scale<2^15 so the product fits int32; the rounding
    # bias add < 2^27 keeps the sum in range (no int64 needed)
    level = jnp.clip((jnp.abs(c) * scale + add) >> qbits, 0, 32767)
    return (jnp.sign(c) * level).astype(jnp.int32)


@functools.partial(jax.jit,
                   static_argnames=("qp", "log2_size", "bit_depth"))
def quant_batch_mask(coef: jnp.ndarray, intra_mask: jnp.ndarray, qp: int,
                     log2_size: int, bit_depth: int = 8) -> jnp.ndarray:
    """quant_batch with a per-block intra/inter rounding selector
    (intra 171/512, inter 85/512; x265 quant.cpp setQPforQuant)."""
    per, rem = qp // 6, qp % 6
    transform_shift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    qbits = QUANT_SHIFT + per + transform_shift
    add = jnp.where(intra_mask, 171, 85).astype(jnp.int32) << (qbits - 9)
    scale = int(QUANT_SCALES[rem])
    c = coef.astype(jnp.int32)
    level = jnp.clip((jnp.abs(c) * scale + add[:, None, None]) >> qbits,
                     0, 32767)
    return (jnp.sign(c) * level).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("qp", "log2_size", "bit_depth"))
def dequant_batch(level: jnp.ndarray, qp: int, log2_size: int,
                  bit_depth: int = 8) -> jnp.ndarray:
    per, rem = qp // 6, qp % 6
    transform_shift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    shift = IQUANT_SHIFT - QUANT_SHIFT - transform_shift
    scale = int(INV_QUANT_SCALES[rem]) << per
    lv = level.astype(jnp.int32)
    coef = (lv * scale + (1 << (shift - 1))) >> shift
    return jnp.clip(coef, -32768, 32767).astype(jnp.int32)


# --- dynamic-QP variants (qp as a traced scalar: ONE compiled program for
# all QPs — the requirement for rate control / AQ without recompiles) ------

def quant_mats(log2_size: int):
    """(2, 6, n, n) int32 forward-quant coefficient tables for the spec
    DEFAULT scaling lists, [intra/inter][qp%6] (reference
    ScalingList::setupQuantMatrices, scalinglist.cpp)."""
    from ..constants.scaling import default_matrix
    out = np.zeros((2, 6, 1 << log2_size, 1 << log2_size), np.int32)
    for ii, intra in enumerate((True, False)):
        m = default_matrix(log2_size, intra).astype(np.float64)
        for r in range(6):
            out[ii, r] = np.round(QUANT_SCALES[r] * 16.0 / m)
    return out


def quant_dyn(coef: jnp.ndarray, intra_mask: jnp.ndarray, qp,
              log2_size: int, bit_depth: int = 8,
              mats=None) -> jnp.ndarray:
    """quant with traced qp (scalar or per-block (B,) array) + per-block
    intra/inter rounding; mats: optional (2, 6, n, n) scaling-list quant
    tables from quant_mats()."""
    qp = jnp.asarray(qp, jnp.int32)
    if qp.ndim == 0:
        qp = jnp.broadcast_to(qp, coef.shape[:1])
    per, rem = qp // 6, qp % 6
    transform_shift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    qbits = (QUANT_SHIFT + per + transform_shift)[:, None, None]
    add = (jnp.where(intra_mask, 171, 85).astype(jnp.int32)[:, None, None]
           << (qbits - 9))
    if mats is None:
        scale = jnp.asarray(QUANT_SCALES)[rem][:, None, None]
    else:
        mj = jnp.asarray(mats)
        sel = jnp.where(intra_mask, 0, 1)
        scale = mj[sel, rem]
    c = coef.astype(jnp.int32)
    level = jnp.clip((jnp.abs(c) * scale + add) >> qbits, 0, 32767)
    return (jnp.sign(c) * level).astype(jnp.int32)


@functools.lru_cache(maxsize=None)
def _diag_scan_idx(log2_size: int):
    from ..constants.hevc_tables import scan_raster_index, SCAN_DIAG
    return np.ascontiguousarray(scan_raster_index(log2_size, SCAN_DIAG))


def sbh_adjust(lev: jnp.ndarray, coef: jnp.ndarray, intra_mask, qp,
               log2_size: int, bit_depth: int = 8,
               scan_sel=None) -> jnp.ndarray:
    """Sign-bit-hiding quantizer adjustment (x265 signBitHidingHDQ,
    quant.cpp:247): for every 4x4 coefficient group where hiding
    triggers (last-first sig span > 3 in the TB's scan order), force
    the parity of the absolute-level sum to encode the first
    coefficient's sign, adjusting the single coefficient whose
    quantization error changes least.

    scan_sel: None for diagonal-scan TBs (16x16 luma / 8x8 chroma — the
    uniform grid), else a (B,) int32 of SCAN_DIAG/HOR/VER per lane for
    mode-dependent-scan TBs (4x4, and 8x8 luma; spec 7.4.9.11).  The
    hide trigger and the hidden-sign source are scan-dependent, so the
    parity must be enforced along the scan the entropy coder will
    actually use.
    """
    qp = jnp.asarray(qp, jnp.int32)
    if qp.ndim == 0:
        qp = jnp.broadcast_to(qp, lev.shape[:1])
    per, rem = qp // 6, qp % 6
    tshift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    qbits = (QUANT_SHIFT + per + tshift)[:, None, None]
    scale = jnp.asarray(QUANT_SCALES)[rem][:, None, None]

    n = 1 << log2_size
    b = lev.shape[0]
    lev_f = lev.reshape(b, n * n)
    coef_f = coef.reshape(b, n * n)
    if scan_sel is None:
        scan = jnp.asarray(_diag_scan_idx(log2_size))  # (n*n,) raster
        lev_s = jnp.take(lev_f, scan, axis=1)          # scan order
        coef_s = jnp.take(coef_f, scan, axis=1)
    else:
        from ..constants.hevc_tables import (scan_raster_index,
                                             SCAN_DIAG, SCAN_HOR,
                                             SCAN_VER)
        scans3 = jnp.asarray(np.stack(
            [np.ascontiguousarray(scan_raster_index(log2_size, si))
             for si in (SCAN_DIAG, SCAN_HOR, SCAN_VER)]))
        scan = scans3[jnp.clip(jnp.asarray(scan_sel), 0, 2)]  # (B, n*n)
        lev_s = jnp.take_along_axis(lev_f, scan, axis=1)
        coef_s = jnp.take_along_axis(coef_f, scan, axis=1)
    ncg = (n * n) // 16
    lev_cg = lev_s.reshape(b, ncg, 16)
    coef_cg = coef_s.reshape(b, ncg, 16)

    sig = lev_cg != 0
    pos = jnp.arange(16)
    first = jnp.min(jnp.where(sig, pos, 99), axis=-1)          # (b, ncg)
    last = jnp.max(jnp.where(sig, pos, -1), axis=-1)
    hide = (last - first) >= 4
    absl = jnp.abs(lev_cg)
    parity = jnp.sum(absl, axis=-1) & 1
    first_lev = jnp.take_along_axis(
        lev_cg, jnp.minimum(first, 15)[..., None], axis=-1)[..., 0]
    want = (first_lev < 0).astype(jnp.int32)
    mismatch = hide & (parity != want)

    # per-coefficient adjustment cost from the quant rounding residue;
    # down-adjustments get a rate credit (one less level bin), mirroring
    # the reference's rate-aware pick (quant.cpp signBitHidingHDQ)
    delta_u = jnp.abs(coef_cg) * scale - (absl << qbits)
    half = jnp.int32(1) << (qbits - 1)
    up_bias = half >> 1                        # ~ rate cost of +1
    prefer_up = delta_u >= half + up_bias
    can_down = absl >= 2                       # never zero a coefficient
    go_up = prefer_up | ~can_down
    cost = jnp.where(go_up,
                     (jnp.int32(1) << qbits) - delta_u + up_bias,
                     delta_u)
    in_win = (pos[None, None] >= first[..., None]) & \
        (pos[None, None] <= last[..., None]) & sig
    cost = jnp.where(in_win, cost, jnp.int32(1) << 30)
    pick = jnp.argmin(cost, axis=-1)                           # (b, ncg)
    onehot = (pos[None, None] == pick[..., None]) & \
        mismatch[..., None] & in_win
    step = jnp.where(go_up, 1, -1)
    new_abs = absl + jnp.where(onehot, step, 0)
    out_cg = jnp.where(lev_cg < 0, -new_abs, new_abs)

    out_s = out_cg.reshape(b, n * n)
    if scan_sel is None:
        inv = jnp.zeros(n * n, jnp.int32).at[scan].set(
            jnp.arange(n * n, dtype=jnp.int32))
        out_f = jnp.take(out_s, inv, axis=1)
    else:
        out_f = jnp.zeros_like(out_s).at[
            jnp.arange(b)[:, None], scan].set(out_s)
    return out_f.reshape(b, n, n)


def dequant_dyn(level: jnp.ndarray, qp, log2_size: int,
                bit_depth: int = 8, dmats=None,
                intra_mask=None) -> jnp.ndarray:
    """dmats: optional (2, n, n) [intra, inter] raw scaling matrices —
    spec 8.6.3 per-coefficient dequant (m == 16 is flat/disabled; the
    flat path folds the 16 into a 4-bit smaller shift)."""
    qp = jnp.asarray(qp, jnp.int32)
    if qp.ndim == 0:
        qp = jnp.broadcast_to(qp, level.shape[:1])
    per, rem = qp // 6, qp % 6
    transform_shift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    shift = IQUANT_SHIFT - QUANT_SHIFT - transform_shift
    lv = level.astype(jnp.int32)
    if dmats is None:
        scale = (jnp.asarray(INV_QUANT_SCALES)[rem] << per)[:, None, None]
        coef = (lv * scale + (1 << (shift - 1))) >> shift
    else:
        mj = jnp.asarray(dmats)
        sel = jnp.where(jnp.ones(lv.shape[:1], bool) if intra_mask is None
                        else intra_mask, 0, 1)
        m = mj[sel]
        base = jnp.asarray(INV_QUANT_SCALES)[rem][:, None, None]
        scale = (m * base) << per[:, None, None]
        coef = (lv * scale + (1 << (shift + 3))) >> (shift + 4)
    return jnp.clip(coef, -32768, 32767).astype(jnp.int32)
