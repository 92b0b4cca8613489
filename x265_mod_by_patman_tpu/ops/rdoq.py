"""Rate-distortion optimized quantization, batched for the device.

Analog of the reference RDOQ (common/quant.cpp rdoQuant:610 and the
nonPsyRdoQuant primitives, dct.cpp:988): instead of the reference's
serial per-coefficient walk with live CABAC-state bit estimates, every
coefficient of every TU in the batch decides among {ceil, floor, zero}
candidate levels simultaneously under a static fractional-bit model,
followed by a vectorized per-CG zero-out pass (the reference's
"cost of coding this 4x4 group at all" test).

Working domain: "level units".  quant_dyn computes
    level = round(|c| * quantScale / 2^qbits)
so c_scaled = |c| * quantScale / 2^qbits is the ideal real-valued level.
Distortion of choosing integer L is (c_scaled - L)^2 * step^2 in pixel
units with step = 2^((qp-4)/6); with lambda2 = 0.85 * 2^((qp-12)/3)
(the SSE lambda, reference x265_lambda2_tab) the bit weight in level
units is qp-INDEPENDENT:

    K = lambda2 / step^2 = 0.85 * 2^(-8/3) ~= 0.134

(the HEVC lambda schedule tracks the quantizer step energy exactly).
Consistency check: with the bit model below this places the level-0/1
decision at c_scaled ~ 0.67, the reference's intra deadzone (171/512);
the inter K uses the inter deadzone's implied weight the same way.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from .transform import (
    MAX_TR_DYNAMIC_RANGE, QUANT_SCALES, QUANT_SHIFT)

# static fractional-bit estimates (post-adaptation CABAC averages):
# sig=0 / sig=1, gt1=0 / gt1=1, gt2=0 / gt2=1, sign (bypass)
_SIG0, _SIG1 = 0.55, 1.45
_GT1_0, _GT1_1 = 0.6, 1.5
_GT2_0, _GT2_1 = 0.7, 1.4
_SIGN = 1.0
_CG_FLAG = 1.0                      # coded_sub_block_flag saving

# level-units bit weights.  The lambda-consistent derivation gives
# K = lambda2/step^2 ~= 0.134 (module docstring), but measured against
# the real CABAC cost of the chosen levels the static bit model
# overestimates ~2x: at K=0.134 RDOQ output lands ~2 QP down-curve
# from the requested point (verified by transplant calibration against
# x265 anchors on park: K=0.06 reproduces the deadzone operating point
# with a slight quality edge at matched bits).
K_INTRA = 0.06
K_INTER = 0.12


def _level_bits(lv: jnp.ndarray) -> jnp.ndarray:
    """Approximate bits to code absolute level lv >= 0 (float)."""
    lv = lv.astype(jnp.float32)
    rem = jnp.maximum(lv - 3.0, 0.0)
    # EG0-ish remaining-level length: 2*floor(log2(rem+1)) + 1
    rem_bits = 2.0 * jnp.floor(jnp.log2(rem + 1.0)) + 1.0
    b = jnp.where(
        lv == 0, _SIG0,
        _SIG1 + _SIGN + jnp.where(
            lv == 1, _GT1_0,
            _GT1_1 + jnp.where(lv == 2, _GT2_0, _GT2_1 + rem_bits)))
    return b


def _diag4_scan() -> np.ndarray:
    """Raster indices of the 4x4 diagonal scan (spec up-right diagonal),
    scan position -> raster index within the CG."""
    from ..constants.hevc_tables import scan_order, SCAN_DIAG
    s = scan_order(2, SCAN_DIAG)
    return (s[:, 1] * 4 + s[:, 0]).astype(np.int32)


def rdoq_levels(coef: jnp.ndarray, intra_mask: jnp.ndarray, qp,
                log2_size: int, bit_depth: int = 8, c_idx: int = 0,
                init_type=None, sign_hide: bool = False,
                psy_rdoq=None, qmats=None, rawmats=None,
                bits_table=None) -> jnp.ndarray:
    """RD-quantize a batch of TUs.  coef: (B, n, n) int32 transform
    output; qp scalar or (B,); returns signed levels (B, n, n) int32,
    drop-in for quant_dyn (transform.py) when rdoq_level > 0.

    With init_type (traced scalar, 0=B/1=P/2=I), per-context fractional
    bits come from the slice-start CABAC states via the baked
    (init_type, qp) tables (entropy/est_bits.py — the EstBitsSbac
    analog); otherwise the static average-bit model applies.

    psy_rdoq (traced float scalar or None): psy-RDOQ bias toward keeping
    AC coefficients (reference quant.cpp:631-643 PSYVALUE, luma non-DC
    only).  The reference subtracts psyRdoq * lambda * |reconCoef| from
    each candidate's cost in transform-coefficient units; divided by
    step^2 (-> level units, like K above) that is exactly
    psyRdoq * sqrt(K) * L — qp-independent, like K itself.  The SBH
    flip pass sees the same psy term in its +-1 candidate costs."""
    qp = jnp.asarray(qp, jnp.int32)
    if qp.ndim == 0:
        qp = jnp.broadcast_to(qp, coef.shape[:1])
    per, rem6 = qp // 6, qp % 6
    transform_shift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    qbits = (QUANT_SHIFT + per + transform_shift)[:, None, None]
    if qmats is None:
        scale = jnp.asarray(QUANT_SCALES)[rem6][:, None, None]
    else:
        # scaling-list-aware RDOQ (reference quant.cpp rdoq uses the
        # per-coefficient quantCoef tables): forward scale per coef
        sel_m = jnp.zeros(coef.shape[:1], jnp.int32) \
            if intra_mask is None else \
            jnp.where(jnp.asarray(intra_mask), 0, 1)
        scale = jnp.asarray(qmats)[sel_m, rem6]
    c = coef.astype(jnp.int32)
    # ideal real-valued level, in level units
    cs = jnp.abs(c).astype(jnp.float32) * scale.astype(jnp.float32) \
        / jnp.exp2(qbits.astype(jnp.float32))
    if intra_mask is None:
        k = jnp.full(coef.shape[:1], K_INTRA, jnp.float32)
    else:
        k = jnp.where(jnp.asarray(intra_mask), K_INTRA, K_INTER) \
            .astype(jnp.float32)
    k = k[:, None, None]
    if rawmats is not None:
        # per-coefficient distortion weight: a level-unit error on a
        # coefficient with scaling m costs (m/16)^2 the distortion of
        # the flat step (spec 8.6.3 dequant applies m/16)
        sel_m = jnp.zeros(coef.shape[:1], jnp.int32) \
            if intra_mask is None else \
            jnp.where(jnp.asarray(intra_mask), 0, 1)
        w = jnp.asarray(rawmats)[sel_m].astype(jnp.float32) / 16.0
        k = k * w * w

    hi = jnp.ceil(cs)
    lo = jnp.floor(cs)

    if init_type is None:
        level_bits = _level_bits
        cg_save = _CG_FLAG
    else:
        from ..entropy.est_bits import (BITS_TABLE, sig_ctx_map,
                                        residual_ctx_scalars)
        if bits_table is not None:
            # adapted contexts (previous same-type slice's states;
            # est_bits.bits_table_from_states): either one (C, 2) table
            # for the whole frame or per-lane (B, C, 2) tables gathered
            # from the per-WPP-row refresh
            bits_table = jnp.asarray(bits_table)
            if bits_table.ndim == 3:
                bt = bits_table
            else:
                bt = jnp.broadcast_to(bits_table[None],
                                      (coef.shape[0],) +
                                      bits_table.shape)
        else:
            tbl = jnp.asarray(BITS_TABLE)           # (3, 52, C, 2)
            bt = tbl[init_type, jnp.clip(qp, 0, 51)]   # (B, C, 2)
        smap = jnp.asarray(sig_ctx_map(log2_size, c_idx))
        sig0 = bt[:, smap, 0]                       # (B, n, n)
        sig1 = bt[:, smap, 1]
        g1c, g2c, cgc = residual_ctx_scalars(log2_size, c_idx)
        g1_0 = bt[:, g1c, 0][:, None, None]
        g1_1 = bt[:, g1c, 1][:, None, None]
        g2_0 = bt[:, g2c, 0][:, None, None]
        g2_1 = bt[:, g2c, 1][:, None, None]
        cg_save = bt[:, cgc, 1] - bt[:, cgc, 0]     # (B,)

        def level_bits(lv):
            # exact coeff_abs_level_remaining length at rice 0:
            # v = lv-3; v+1 bins below 3, else 4 + 2*floor(log2(v-2))
            v = jnp.maximum(lv - 3.0, 0.0)
            rem = jnp.where(
                v < 3.0, v + 1.0,
                4.0 + 2.0 * jnp.floor(
                    jnp.log2(jnp.maximum(v - 2.0, 1.0))))
            return jnp.where(
                lv == 0, sig0,
                sig1 + _SIGN + jnp.where(
                    lv == 1, g1_0,
                    g1_1 + jnp.where(lv == 2, g2_0, g2_1 + rem)))

    if psy_rdoq is not None and c_idx == 0:
        n_ = 1 << log2_size
        nondc = jnp.ones((n_, n_), jnp.float32).at[0, 0].set(0.0)
        psy_k = (psy_rdoq * jnp.sqrt(k)) * nondc[None]

        def cost(lv):
            return (cs - lv) ** 2 + k * level_bits(lv) - psy_k * lv
    else:
        def cost(lv):
            return (cs - lv) ** 2 + k * level_bits(lv)

    zero = jnp.zeros_like(cs)
    c_hi, c_lo, c_z = cost(hi), cost(lo), cost(zero)
    lv = jnp.where(c_hi < c_lo, hi, lo)
    cbest = jnp.minimum(c_hi, c_lo)
    lv = jnp.where(c_z <= cbest, zero, lv)
    cbest = jnp.minimum(c_z, cbest)

    # per-CG zero-out: zeroing a whole 4x4 group drops all its sig bits
    # and the coded_sub_block_flag (reference rdoQuant group loop)
    n = 1 << log2_size
    if n > 4:
        g = n // 4
        cb = cbest.reshape(-1, g, 4, g, 4)
        czb = (cs ** 2).reshape(-1, g, 4, g, 4)
        keep = cb.sum(axis=(2, 4))
        saving = k[:, 0, 0] * cg_save if init_type is not None \
            else k[:, 0, 0] * _CG_FLAG
        kill = czb.sum(axis=(2, 4)) - saving[:, None, None]
        zero_cg = (kill < keep)[:, :, None, :, None]
        lv = jnp.where(zero_cg, 0.0, lv.reshape(-1, g, 4, g, 4)) \
            .reshape(-1, n, n)

    if sign_hide:
        # RDOQ-integrated sign-bit hiding (reference signBitHidingHDQ,
        # quant.cpp:247, with RD deltas instead of quant-residue
        # heuristics): where a CG's level-sum parity mismatches the
        # first coefficient's sign, flip the single level +-1 whose
        # (cs - L)^2 + K*bits delta is smallest, under window guards
        # that keep first/last scan positions (and thus the hide
        # trigger and hidden-sign source) unchanged.
        n = 1 << log2_size
        g = max(1, n // 4)
        diag = jnp.asarray(_diag4_scan())
        b = lv.shape[0]

        def tiles(a):
            t = a.reshape(b, g, 4, g, 4).transpose(0, 1, 3, 2, 4) \
                .reshape(b, g, g, 16)
            return t[..., diag]                     # scan order per CG

        lv_t = tiles(lv)                            # |levels|, float
        cs_t = tiles(cs)
        sgn_t = tiles(jnp.sign(c).astype(jnp.float32))
        pos = jnp.arange(16)
        sig = lv_t != 0
        first = jnp.min(jnp.where(sig, pos, 99), axis=-1)
        last = jnp.max(jnp.where(sig, pos, -1), axis=-1)
        hide = (last - first) >= 4
        parity = (jnp.sum(lv_t, axis=-1).astype(jnp.int32)) & 1
        first_sgn = jnp.take_along_axis(
            sgn_t, jnp.minimum(first, 15)[..., None], axis=-1)[..., 0]
        want = (first_sgn < 0).astype(jnp.int32)
        mismatch = hide & (parity != want)

        kt = k[:, 0, 0][:, None, None, None]
        if psy_rdoq is not None and c_idx == 0:
            # psy bias in the flip deltas too.  This EXTENDS the
            # reference, which keeps its sign-hiding deltas psy-free
            # (quant.cpp:318 signBitHidingHDQ uses pure quant-residue
            # deltaU; the RDOQ sign-hiding DELTARDCOST path likewise):
            # a +-1 flip on an AC coefficient changes retained energy,
            # so for internal consistency the candidate costs here see
            # the same psy term as the level decision above
            psy_t = tiles(jnp.broadcast_to(psy_k, lv.shape))
        else:
            psy_t = jnp.float32(0.0)
        bits_t = (lambda q: tiles(level_bits(q)))
        cost_cur = (cs_t - lv_t) ** 2 + kt * bits_t(lv) - psy_t * lv_t
        cost_up = (cs_t - (lv_t + 1)) ** 2 + \
            kt * tiles(level_bits(lv + 1)) - psy_t * (lv_t + 1)
        cost_dn = (cs_t - (lv_t - 1)) ** 2 + \
            kt * tiles(level_bits(jnp.maximum(lv - 1, 0))) - \
            psy_t * jnp.maximum(lv_t - 1, 0)
        in_win = (pos >= first[..., None]) & (pos <= last[..., None])
        edge = (pos == first[..., None]) | (pos == last[..., None])
        big = jnp.float32(1e30)
        du = jnp.where(in_win, cost_up - cost_cur, big)
        dd = jnp.where(in_win & (lv_t >= 1) & ~(edge & (lv_t == 1)),
                       cost_dn - cost_cur, big)
        step = jnp.where(du <= dd, 1.0, -1.0)
        delta = jnp.minimum(du, dd)
        pick = jnp.argmin(delta, axis=-1)           # (b, g, g)
        onehot = (pos == pick[..., None]) & mismatch[..., None]
        new_t = lv_t + jnp.where(onehot, step, 0.0)
        # scatter back: scan order -> raster tiles -> full block
        inv = jnp.zeros(16, jnp.int32).at[diag].set(
            jnp.arange(16, dtype=jnp.int32))
        new_r = new_t[..., inv].reshape(b, g, g, 4, 4) \
            .transpose(0, 1, 3, 2, 4).reshape(b, n, n)
        lv = new_r

    lv = jnp.clip(lv, 0, 32767).astype(jnp.int32)
    return jnp.sign(c) * lv


@functools.lru_cache(maxsize=None)
def _scan_idx_map(log2_size: int) -> np.ndarray:
    """(n, n) map raster position -> diagonal scan index (CG-major)."""
    from ..constants.hevc_tables import scan_order, SCAN_DIAG
    s = scan_order(log2_size, SCAN_DIAG)
    n = 1 << log2_size
    m = np.zeros((n, n), np.int32)
    m[s[:, 1], s[:, 0]] = np.arange(s.shape[0], dtype=np.int32)
    return m


# last_sig_coeff_{x,y}_prefix group index per coordinate (spec 9.3.3.1.2)
_LAST_GROUP_IDX = np.array(
    [0, 1, 2, 3, 4, 4, 5, 5] + [6] * 4 + [7] * 4 + [8] * 8 + [9] * 8,
    np.int32)
# prefix ctx bins at ~0.9 bit (slice-start states are near-uniform) plus
# exact bypass suffix length
_LAST_BITS_LUT = ((_LAST_GROUP_IDX + 1).astype(np.float32) * 0.9
                  + np.maximum(0, (_LAST_GROUP_IDX >> 1) - 1)
                  .astype(np.float32))


def tb_bits_est(lev: jnp.ndarray, qp, log2_size: int, c_idx: int = 0,
                init_type=None, bits_table=None) -> jnp.ndarray:
    """Rate-true estimate (float32 bits, (B,)) of coding a TB's chosen
    levels: last_sig_pos + coded_sub_block_flags + sig/gt1/gt2/sign/
    remaining over the coded scan region only — the counting-mode
    Entropy walk (reference entropy.h:107-133 EstBitsSbac, used by
    analysis.cpp:3485 merge/skip preference) collapsed to slice-start
    context states (entropy/est_bits.py tables) so it stays one fused
    gather per batch.  Returns 0 for all-zero TBs (cbf=0)."""
    from ..entropy.est_bits import (BITS_TABLE, sig_ctx_map,
                                    residual_ctx_scalars)
    from ..constants.hevc_tables import scan_order
    qp = jnp.asarray(qp, jnp.int32)
    if qp.ndim == 0:
        qp = jnp.broadcast_to(qp, lev.shape[:1])
    it = init_type if init_type is not None else 2
    if bits_table is not None:
        bits_table = jnp.asarray(bits_table)
        if bits_table.ndim == 3:
            # per-lane tables (the per-WPP-row adapted states, gathered
            # by block row upstream)
            bt = bits_table
        else:
            bt = jnp.broadcast_to(bits_table[None],
                                  (lev.shape[0],) + bits_table.shape)
    else:
        tbl = jnp.asarray(BITS_TABLE)
        bt = tbl[it, jnp.clip(qp, 0, 51)]           # (B, C, 2)
    smap = jnp.asarray(sig_ctx_map(log2_size, c_idx))
    sig0 = bt[:, smap, 0]                           # (B, n, n)
    sig1 = bt[:, smap, 1]
    g1c, g2c, cgc = residual_ctx_scalars(log2_size, c_idx)
    g1_0 = bt[:, g1c, 0][:, None, None]
    g1_1 = bt[:, g1c, 1][:, None, None]
    g2_0 = bt[:, g2c, 0][:, None, None]
    g2_1 = bt[:, g2c, 1][:, None, None]

    n = 1 << log2_size
    al = jnp.abs(lev).astype(jnp.float32)
    S = jnp.asarray(_scan_idx_map(log2_size))       # (n, n)
    nz = al > 0
    any_nz = jnp.any(nz, axis=(1, 2))
    last = jnp.max(jnp.where(nz, S[None], -1), axis=(1, 2))     # (B,)
    region = S[None] <= last[:, None, None]

    # per-coefficient bits inside coded CGs of the scan region
    v = jnp.maximum(al - 3.0, 0.0)
    rem = jnp.where(v < 3.0, v + 1.0,
                    4.0 + 2.0 * jnp.floor(
                        jnp.log2(jnp.maximum(v - 2.0, 1.0))))
    lb = jnp.where(
        al == 0, sig0,
        sig1 + _SIGN + jnp.where(
            al == 1, g1_0,
            g1_1 + jnp.where(al == 2, g2_0, g2_1 + rem)))

    if n > 4:
        g = n // 4
        cg_nz = jnp.any(nz.reshape(-1, g, 4, g, 4), axis=(2, 4))
        cg_reg = jnp.any(region.reshape(-1, g, 4, g, 4), axis=(2, 4))
        cg_nz_b = jnp.repeat(jnp.repeat(cg_nz, 4, axis=1), 4, axis=2)
        pos = jnp.asarray(
            np.stack(np.meshgrid(np.arange(g), np.arange(g),
                                 indexing="ij"), -1))   # (g, g, 2) y,x
        dc_cg = (pos[..., 0] == 0) & (pos[..., 1] == 0)
        # the DC CG's csbf is inferred to 1 (spec 7.4.9.11), so its sig
        # bins are coded even when the whole CG is zero
        dc_cg_b = jnp.repeat(jnp.repeat(dc_cg[None], 4, axis=1), 4,
                             axis=2)
        coeff_bits = jnp.sum(
            jnp.where(region & (cg_nz_b | dc_cg_b), lb, 0.0),
            axis=(1, 2))
        # coded_sub_block_flag per in-region CG; DC CG and the last CG
        # are inferred (spec 7.4.9.11)
        cg0b = bt[:, cgc, 0][:, None, None]
        cg1b = bt[:, cgc, 1][:, None, None]
        sc = jnp.asarray(scan_order(log2_size, 0))
        lxy = sc[jnp.clip(last, 0, n * n - 1)]          # (B, 2) x,y
        last_cg = ((pos[None, ..., 0] == (lxy[:, 1] >> 2)[:, None, None])
                   & (pos[None, ..., 1] == (lxy[:, 0] >> 2)[:, None, None]))
        cg_mask = cg_reg & ~dc_cg[None] & ~last_cg
        cg_bits = jnp.sum(
            jnp.where(cg_mask, jnp.where(cg_nz, cg1b, cg0b), 0.0),
            axis=(1, 2))
    else:
        coeff_bits = jnp.sum(jnp.where(region, lb, 0.0), axis=(1, 2))
        cg_bits = 0.0
        sc = jnp.asarray(scan_order(log2_size, 0))
        lxy = sc[jnp.clip(last, 0, n * n - 1)]

    # the last coefficient's significance is implied by last_sig_pos
    bidx = jnp.arange(lev.shape[0])
    sig1_last = sig1[bidx, jnp.clip(lxy[:, 1], 0, n - 1),
                     jnp.clip(lxy[:, 0], 0, n - 1)]
    lut = jnp.asarray(_LAST_BITS_LUT)
    last_bits = lut[jnp.clip(lxy[:, 0], 0, 31)] + \
        lut[jnp.clip(lxy[:, 1], 0, 31)]
    total = coeff_bits + cg_bits + last_bits - sig1_last + 0.8  # + cbf
    return jnp.where(any_nz, total, 0.0)


def tu_rd_levels(coef: jnp.ndarray, qp, log2_size: int,
                 bit_depth: int = 8, k: float = 0.134) -> jnp.ndarray:
    """Level-units RD estimate of coding a TU's coefficients:
    sum((cs - round(cs))^2 + K * bits(level)) per block (B,).  Used by
    TU-split decisions (estimateResidualQT / codeIntraLumaQT cost
    compare, reference search.cpp:5437/646) — same working domain as
    rdoq_levels above."""
    qp = jnp.asarray(qp, jnp.int32)
    if qp.ndim == 0:
        qp = jnp.broadcast_to(qp, coef.shape[:1])
    per, rem6 = qp // 6, qp % 6
    tshift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    qbits = (QUANT_SHIFT + per + tshift)[:, None, None]
    scale = jnp.asarray(QUANT_SCALES)[rem6][:, None, None]
    cs = jnp.abs(coef).astype(jnp.float32) * scale.astype(jnp.float32) \
        / jnp.exp2(qbits.astype(jnp.float32))
    lv = jnp.round(cs)
    rd = (cs - lv) ** 2 + k * _level_bits(lv)
    return jnp.sum(rd, axis=(-2, -1))
