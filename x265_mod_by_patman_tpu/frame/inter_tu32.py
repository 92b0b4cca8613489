"""Inter TU32 pre-pass: code 32x32 same-motion inter regions as ONE
luma TU32 (+ TU16 chroma) instead of the four-TU16 voluntary split.

The reference keeps TU == CU size for inter CUs at its default
tu-inter-depth (x265 search.cpp:5437 estimateResidualQT evaluates the
depth-0 TU first and only splits when the split RD wins) — one TU32
pays one last_sig_pos + one cbf set where the quad split pays four,
and the larger transform compacts low-frequency residual energy far
better on noisy content.  Our wavefront quantizes on a fixed 16-grid
(frame/recon_intra.py), so this pre-pass computes the TU32 residual
coding OUTSIDE the wavefront for every uniform-motion 32-region and
the wavefront is then forced to reproduce the TU32 reconstruction
exactly: the caller splices the TU32 recon into both the mc
prediction AND the source planes for those blocks, making the
in-wavefront residual identically zero (a natural skip) while intra
neighbors keep predicting from the true final reconstruction.

The TU32-vs-quad decision itself is transform-domain RD with the same
rate models the wavefront uses for its zero-residual test, so the two
tiers price residuals consistently.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.transform import (dct_batch, idct_batch, quant_dyn,
                             dequant_dyn, sbh_adjust)
from ..ops.rdoq import rdoq_levels, tb_bits_est


def _plane_rd(org, pred, qp_b, log2n: int, c_idx: int, bd: int,
              sign_hide: bool, rdoq: bool, init_type, psy256,
              psy_rdoq, qmats=None, dmats=None, ebits=None):
    """Residual-code one TB per batch row with the wavefront's exact
    machinery (RDOQ/SBH + per-plane zero-residual RD, recon_intra.py
    _substep_body inter branch) and return (lev, recon, cost) where
    cost = min(coded, zero) in SSE + lam2*bits units (no CU syntax)."""
    maxval = (1 << bd) - 1
    imask = jnp.zeros(org.shape[:1], bool)
    resi = org - pred
    coef = dct_batch(resi, log2n, bd)
    lev = rdoq_levels(coef, imask, qp_b, log2n, bd, c_idx, init_type,
                      psy_rdoq=psy_rdoq, qmats=qmats,
                      rawmats=dmats, bits_table=ebits) if rdoq \
        else quant_dyn(coef, imask, qp_b, log2n, bd, qmats)
    if sign_hide:
        lev = sbh_adjust(lev, coef, imask, qp_b, log2n, bd)
    deq0 = dequant_dyn(lev, qp_b, log2n, bd, dmats, imask)
    rec0 = jnp.clip(pred + idct_batch(deq0, log2n, bd), 0, maxval)
    sse_coded = jnp.sum((org - rec0) ** 2, axis=(1, 2))
    sse_skip = jnp.sum((org - pred) ** 2, axis=(1, 2))
    nz = jnp.sum((lev != 0).astype(jnp.int32), axis=(1, 2))
    lam2 = 0.85 * jnp.exp2((qp_b.astype(jnp.float32) - 12.0) / 3.0) \
        * (1 << (2 * (bd - 8)))
    base_bits = 6.0 if c_idx == 0 else 2.0
    if c_idx != 0:
        bits = base_bits + tb_bits_est(lev, qp_b, log2n, c_idx,
                                       init_type, bits_table=ebits)
    else:
        nzf = nz.astype(jnp.float32)
        lin = jnp.where(nzf > 0.0, 10.0, 0.0) + 4.5 * nzf
        est = tb_bits_est(lev, qp_b, log2n, c_idx, init_type,
                          bits_table=ebits)
        bits = base_bits + jnp.maximum(lin, est)
    cost_skip = sse_skip.astype(jnp.float32)
    cost_coded = sse_coded.astype(jnp.float32) + lam2 * bits
    if psy256 is not None and c_idx == 0:
        from ..ops.cost import psy_cost_batch
        styp = jnp.asarray([300.0, 256.0, 96.0], jnp.float32)[
            jnp.clip(init_type if init_type is not None else 2,
                     0, 2)] / 256.0
        qpf = qp_b.astype(jnp.float32)
        roll = jnp.where(
            qpf >= 40.0,
            jnp.clip((51.0 - qpf) * 23.0 / 256.0, 0.0, 1.0), 1.0)
        psy_w = jnp.sqrt(lam2) * \
            (psy256.astype(jnp.float32) / 256.0) * 0.33 * styp * roll
        cost_skip = cost_skip + psy_w * \
            psy_cost_batch(org, pred).astype(jnp.float32)
        cost_coded = cost_coded + psy_w * \
            psy_cost_batch(org, rec0).astype(jnp.float32)
    skip = cost_skip <= cost_coded
    lev = jnp.where(skip[:, None, None], 0, lev)
    recon = jnp.where(skip[:, None, None], jnp.clip(pred, 0, maxval),
                      rec0)
    return lev, recon, jnp.minimum(cost_skip, cost_coded)


@functools.partial(
    jax.jit, static_argnames=("bd", "sign_hide", "rdoq", "have_mats"))
def _tu32_core(oy32, py32, ou16, pu16, ov16, pv16, qp_y, qp_cb, qp_cr,
               init_type, psy256, psy_rdoq, mats32, bd: int,
               sign_hide: bool, rdoq: bool, have_mats: bool,
               ebits=None):
    """(R,32,32)/(R,16,16) region stacks -> TU32 coding + use32 RD pick."""
    qm_l = mats32[0] if have_mats else None
    dm_l = mats32[1] if have_mats else None
    qm_c = mats32[2] if have_mats else None
    dm_c = mats32[3] if have_mats else None
    levy, recy, cost32 = _plane_rd(oy32, py32, qp_y, 5, 0, bd,
                                   sign_hide, rdoq, init_type, psy256,
                                   psy_rdoq, qm_l, dm_l, ebits)
    # luma quad-TU16 alternative for the split decision (the wavefront
    # would produce exactly this path when use32 is False)
    def quads(a):
        r = a.shape[0]
        return a.reshape(r, 2, 16, 2, 16).transpose(0, 1, 3, 2, 4) \
            .reshape(r * 4, 16, 16)
    qp4 = jnp.repeat(qp_y, 4)
    _, _, c16 = _plane_rd(quads(oy32), quads(py32), qp4, 4, 0, bd,
                          sign_hide, rdoq, init_type, psy256, psy_rdoq,
                          ebits=ebits)
    cost16 = c16.reshape(-1, 4).sum(1)
    lam2 = 0.85 * jnp.exp2((qp_y.astype(jnp.float32) - 12.0) / 3.0) \
        * (1 << (2 * (bd - 8)))
    # split syntax the quad path pays on top: +3 luma cbf bins and the
    # TU32 path's split_transform_flag=0 vs =1 is a wash
    use32 = cost32 <= cost16 + lam2 * 3.0
    levu, recu, _ = _plane_rd(ou16, pu16, qp_cb, 4, 1, bd, sign_hide,
                              rdoq, init_type, psy256, psy_rdoq,
                              qm_c, dm_c, ebits)
    levv, recv, _ = _plane_rd(ov16, pv16, qp_cr, 4, 2, bd, sign_hide,
                              rdoq, init_type, psy256, psy_rdoq,
                              qm_c, dm_c, ebits)
    nzy = jnp.any(levy != 0, (1, 2))
    nzu = jnp.any(levu != 0, (1, 2))
    nzv = jnp.any(levv != 0, (1, 2))
    return (use32, levy, recy, nzy, levu, recu, nzu, levv, recv, nzv)


def region_uniform_mask(inter_mask, mvs, mvs1, dirs, ref_sel,
                        part_map, width: int, height: int,
                        ref_sel1=None):
    """(nry, nrx) bool: 32-regions whose four 16-blocks will merge into
    one 2Nx2N inter CU in build_region (encoder/top.py) — all inter,
    part 2Nx2N, identical canonical motion (_motion_key), fully inside
    the picture."""
    nby, nbx = inter_mask.shape
    nry, nrx = nby // 2, nbx // 2
    if nry == 0 or nrx == 0:
        return np.zeros((max(nry, 1), max(nrx, 1)), bool)[:nry, :nrx]
    c = lambda a: a[:nry * 2, :nrx * 2]
    dirs_m = np.ones((nby, nbx), np.int32) if dirs is None \
        else np.asarray(dirs, np.int32)
    mvs1_m = np.zeros_like(mvs) if mvs1 is None else np.asarray(mvs1)
    rs = np.zeros((nby, nbx), np.int32) if ref_sel is None \
        else np.asarray(ref_sel, np.int32)
    rs1 = np.zeros((nby, nbx), np.int32) if ref_sel1 is None \
        else np.asarray(ref_sel1, np.int32)
    # canonical motion per block (unused list zeroed, like _motion_key)
    l0_on = (dirs_m & 1) > 0
    l1_on = (dirs_m & 2) > 0
    m0 = np.where(l0_on[..., None], np.asarray(mvs), 0)
    r0 = np.where(l0_on, rs, -1)
    m1 = np.where(l1_on[..., None], mvs1_m, 0)
    r1 = np.where(l1_on, rs1, -1)
    fields = [dirs_m, m0[..., 0], m0[..., 1], r0,
              m1[..., 0], m1[..., 1], r1]
    ok = c(np.asarray(inter_mask, bool))
    if part_map is not None:
        ok = ok & (c(np.asarray(part_map)) == 0)
    q = lambda a: c(a).reshape(nry, 2, nrx, 2)
    okq = q(ok).all((1, 3))
    for f in fields:
        fq = q(f)
        okq &= (fq == fq[:, :1, :, :1]).all((1, 3))
    # region fully inside the picture
    xs = (np.arange(nrx) + 1) * 32 <= width
    ys = (np.arange(nry) + 1) * 32 <= height
    return okq & ys[:, None] & xs[None, :]


def prepare_inter_tu32(y, u, v, mc, region_mask, qp_map, recon,
                       init_type: int, ebits=None):
    """Run the TU32 pre-pass for the masked regions.  Returns None when
    no region qualifies, else a dict of per-region stores + the spliced
    (y2, u2, v2, mc2) arrays for the wavefront (TU32 recon written over
    both source and prediction => forced zero residual).

    recon: the frame's IntraReconstructor (supplies qp maps, psy/RDOQ
    configuration and scaling-list mats so this pass prices residuals
    identically to the wavefront)."""
    nry, nrx = region_mask.shape
    if not region_mask.any():
        return None
    qp_y16, qp_cb16, qp_cr16 = recon._qp_maps(qp_map)
    qp_y16 = np.asarray(qp_y16)
    qp_cb16 = np.asarray(qp_cb16)
    qp_cr16 = np.asarray(qp_cr16)
    ys, xs = np.nonzero(region_mask)
    R = len(ys)
    oy = np.asarray(y, np.int32)
    ou = np.asarray(u, np.int32)
    ov = np.asarray(v, np.int32)
    mc_y = np.asarray(mc[0])
    mc_u = np.asarray(mc[1])
    mc_v = np.asarray(mc[2])
    # mc arrays are per-16-block stacks (nby, nbx, 16, 16): assemble the
    # 32/16 region views
    def lum32(src_blocks):
        out = np.empty((R, 32, 32), np.int32)
        for i, (ry, rx) in enumerate(zip(ys, xs)):
            b = src_blocks[2 * ry:2 * ry + 2, 2 * rx:2 * rx + 2]
            out[i] = np.block([[b[0, 0], b[0, 1]], [b[1, 0], b[1, 1]]])
        return out
    def chr16(src_blocks):
        out = np.empty((R, 16, 16), np.int32)
        for i, (ry, rx) in enumerate(zip(ys, xs)):
            b = src_blocks[2 * ry:2 * ry + 2, 2 * rx:2 * rx + 2]
            out[i] = np.block([[b[0, 0], b[0, 1]], [b[1, 0], b[1, 1]]])
        return out
    def plane32(pl):
        out = np.empty((R, 32, 32), np.int32)
        for i, (ry, rx) in enumerate(zip(ys, xs)):
            out[i] = pl[32 * ry:32 * ry + 32, 32 * rx:32 * rx + 32]
        return out
    def plane16(pl):
        out = np.empty((R, 16, 16), np.int32)
        for i, (ry, rx) in enumerate(zip(ys, xs)):
            out[i] = pl[16 * ry:16 * ry + 16, 16 * rx:16 * rx + 16]
        return out
    oy32 = plane32(oy)
    py32 = lum32(mc_y)
    ou16 = plane16(ou)
    pu16 = chr16(mc_u)
    ov16 = plane16(ov)
    pv16 = chr16(mc_v)
    qp_y = qp_y16[2 * ys, 2 * xs].astype(np.int32)
    qp_cb = qp_cb16[2 * ys, 2 * xs].astype(np.int32)
    qp_cr = qp_cr16[2 * ys, 2 * xs].astype(np.int32)
    have_mats = recon.mats32 is not None
    # pad the region batch to a power-of-two lane count: R varies per
    # frame and a traced leading dim would otherwise compile a fresh
    # _tu32_core program per distinct R (a recompile per frame)
    rp = 1 << max(3, (R - 1).bit_length())
    pad = rp - R
    if pad:
        z32 = np.zeros((pad, 32, 32), np.int32)
        z16 = np.zeros((pad, 16, 16), np.int32)
        zq = np.full(pad, 32, np.int32)
        oy32 = np.concatenate([oy32, z32])
        py32 = np.concatenate([py32, z32])
        ou16 = np.concatenate([ou16, z16])
        pu16 = np.concatenate([pu16, z16])
        ov16 = np.concatenate([ov16, z16])
        pv16 = np.concatenate([pv16, z16])
        qp_y = np.concatenate([qp_y, zq])
        qp_cb = np.concatenate([qp_cb, zq])
        qp_cr = np.concatenate([qp_cr, zq])
    out = _tu32_core(jnp.asarray(oy32), jnp.asarray(py32),
                     jnp.asarray(ou16), jnp.asarray(pu16),
                     jnp.asarray(ov16), jnp.asarray(pv16),
                     jnp.asarray(qp_y), jnp.asarray(qp_cb),
                     jnp.asarray(qp_cr), jnp.int32(init_type),
                     recon.psy256, recon.psy_rdoq,
                     recon.mats32 if have_mats else (0, 0, 0, 0),
                     recon.bd, recon.sign_hide, recon.rdoq, have_mats,
                     None if ebits is None else
                     jnp.asarray(np.asarray(ebits, np.float32)))
    (use32, levy, recy, nzy, levu, recu, nzu, levv, recv,
     nzv) = (np.asarray(a)[:R] for a in out)
    if not use32.any():
        return None
    # dense stores for build_region
    st = {
        "use": np.zeros((nry, nrx), bool),
        "levy": {}, "levu": {}, "levv": {},
        "nzy": np.zeros((nry, nrx), bool),
        "nzu": np.zeros((nry, nrx), bool),
        "nzv": np.zeros((nry, nrx), bool),
    }
    y2 = oy.copy()
    u2 = ou.copy()
    v2 = ov.copy()
    mc_y2 = mc_y.copy()
    mc_u2 = mc_u.copy()
    mc_v2 = mc_v.copy()
    dt = np.uint8 if recon.bd == 8 else np.uint16
    for i, (ry, rx) in enumerate(zip(ys, xs)):
        if not use32[i]:
            continue
        st["use"][ry, rx] = True
        st["nzy"][ry, rx] = bool(nzy[i])
        st["nzu"][ry, rx] = bool(nzu[i])
        st["nzv"][ry, rx] = bool(nzv[i])
        if nzy[i]:
            st["levy"][(ry, rx)] = levy[i]
        if nzu[i]:
            st["levu"][(ry, rx)] = levu[i]
        if nzv[i]:
            st["levv"][(ry, rx)] = levv[i]
        # splice: TU32 recon over BOTH source and prediction for the
        # region's blocks — the wavefront then sees zero residual and
        # reconstructs exactly this
        y2[32 * ry:32 * ry + 32, 32 * rx:32 * rx + 32] = recy[i]
        u2[16 * ry:16 * ry + 16, 16 * rx:16 * rx + 16] = recu[i]
        v2[16 * ry:16 * ry + 16, 16 * rx:16 * rx + 16] = recv[i]
        for (zy, zx) in ((0, 0), (0, 1), (1, 0), (1, 1)):
            mc_y2[2 * ry + zy, 2 * rx + zx] = \
                recy[i][16 * zy:16 * zy + 16, 16 * zx:16 * zx + 16]
            mc_u2[2 * ry + zy, 2 * rx + zx] = \
                recu[i][8 * zy:8 * zy + 8, 8 * zx:8 * zx + 8]
            mc_v2[2 * ry + zy, 2 * rx + zx] = \
                recv[i][8 * zy:8 * zy + 8, 8 * zx:8 * zx + 8]
    st["spliced"] = (y2.astype(dt), u2.astype(dt), v2.astype(dt),
                     (mc_y2, mc_u2, mc_v2))
    return st
