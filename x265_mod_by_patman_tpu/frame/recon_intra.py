"""Batched intra reconstruction over CTU wavefronts.

Batched replacement of the reference's sequential per-CTU intra coding
loop (x265 FrameEncoder::processRowEncoder frameencoder.cpp:1638 +
Search::codeIntraLumaQT search.cpp:646): CTUs on a wavefront diagonal
(d = cx + 2*cy, the WPP schedule) are processed as one batched step;
within a CTU the z-order block positions are sequential substeps.  The
ENTIRE wavefront schedule runs as one lax.fori_loop under a single jit —
one device dispatch per frame, no host round-trips (the analog of x265
keeping the whole row loop inside one thread, but batched).

Bit-exactness contract: identical integer math to the scalar golden path
used by the validation decoder (ops.intra.predict_block_ref /
ops.transform.*_ref).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..constants.hevc_tables import CHROMA_QP_TABLE
from ..ops.intra import intra_pred_select_batch, substitute_filter_batch
from ..ops.transform import (
    dct_batch, quant_dyn, dequant_dyn, idct_batch, sbh_adjust)
from ..ops.rdoq import rdoq_levels
from .zscan import frame_avail_masks, ctu_wavefront_order


def chroma_qp(qp: int, offset: int = 0, csp: int = 1) -> int:
    """QpC derivation (spec 8.6.1): the Table 8-10 remap applies only
    for ChromaArrayType == 1 (4:2:0); 4:2:2/4:4:4 clip qPi at 51."""
    if csp == 1:
        return int(CHROMA_QP_TABLE[min(max(qp + offset, 0), 69)])
    return int(min(max(qp + offset, 0), 51))


def _scan_sel_of(modes):
    """Mode-dependent scan id per lane (spec 7.4.9.11 for 4x4 and 8x8
    luma intra TBs): near-horizontal modes 6..14 -> vertical scan (2),
    near-vertical 22..30 -> horizontal (1), else diagonal (0)."""
    return jnp.where((modes >= 6) & (modes <= 14), 2,
                     jnp.where((modes >= 22) & (modes <= 30), 1, 0)) \
        .astype(jnp.int32)


def _substep_body(plane, levels, orig, bx, by, modes, avail,
                  log2n: int, qp, c_idx: int, bit_depth: int = 8,
                  mc_pred=None, inter_mask=None, sign_hide: bool = False,
                  skip_in=None, rdoq: bool = False, qmats=None,
                  dmats=None, split_map=None, modes8=None, av8=None,
                  m8=(None, None), lossless: bool = False,
                  init_type=None, psy256=None, psy_rdoq=None,
                  tu4_map=None, av4y=None, fchroma: bool = False,
                  cand_bits=None, nr=None, ebits=None):
    """One wavefront substep for one component (traced inline).

    plane:  (Hp, Wp) int32 recon plane (Hp includes an N-row dump area)
    levels: (nby+1, nbx, N, N) int32 quantized-level store (dump row nby)
    orig:   (H, W) int32 source samples
    bx/by:  (B,) int32 block coords (invalid lanes redirected to dump)
    modes:  (B,) int32 intra modes
    avail:  (B, 4N+1) bool reference availability (False on invalid lanes)
    mc_pred: optional (nby+1, nbx, N, N) precomputed inter predictions
    inter_mask: optional (nby+1, nbx) bool — True = block uses mc_pred
    """
    n = 1 << log2n
    maxval = (1 << bit_depth) - 1
    hp, wp = plane.shape
    x0 = bx * n
    y0 = by * n

    ks = np.arange(4 * n + 1)
    k_x = np.where(ks <= 2 * n, -1, ks - (2 * n + 1))
    k_y = np.where(ks < 2 * n, 2 * n - 1 - ks, -1)
    xs = jnp.clip(x0[:, None] + jnp.asarray(k_x)[None, :], 0, wp - 1)
    ys = jnp.clip(y0[:, None] + jnp.asarray(k_y)[None, :], 0, hp - 1)
    s_raw = plane[ys, xs]
    s_sub, s_filt = substitute_filter_batch(s_raw, avail, log2n, bit_depth)

    md_sel = None
    if cand_bits is not None:
        # RD-true mode selection among the analysis' top-K candidates
        # (modes is (B, K)): full quant/recon per candidate, pick
        # argmin(SSE + lambda2 * (coeff-rate estimate + mode bins)) —
        # the batched analog of the reference's checkIntra RD pass at
        # rd-level 2+ (search.cpp:1577 estIntraPredQT on the sa8d
        # candidate list).  The winner then takes the normal
        # RDOQ/sign-hide coding path below.
        gy0 = y0[:, None, None] + jnp.arange(n)[None, :, None]
        gx0 = x0[:, None, None] + jnp.arange(n)[None, None, :]
        org0 = orig[jnp.clip(gy0, 0, orig.shape[0] - 1),
                    jnp.clip(gx0, 0, orig.shape[1] - 1)] \
            .astype(jnp.int32)
        ones = jnp.ones(bx.shape, bool)
        mv = (1 << bit_depth) - 1
        lam2 = 0.85 * jnp.exp2((qp.astype(jnp.float32) - 12.0) / 3.0) \
            * (1 << (2 * (bit_depth - 8)))
        best = None
        for kk in range(modes.shape[1]):
            md_k = modes[:, kk]
            pred_k = intra_pred_select_batch(s_sub, s_filt, md_k,
                                             log2n, c_idx, bit_depth)
            coef_k = dct_batch(org0 - pred_k, log2n, bit_depth)
            lev_k = quant_dyn(coef_k, ones, qp, log2n, bit_depth, qmats)
            deq_k = dequant_dyn(lev_k, qp, log2n, bit_depth, dmats,
                                ones)
            rec_k = jnp.clip(pred_k + idct_batch(deq_k, log2n,
                                                 bit_depth), 0, mv)
            sse = jnp.sum((org0 - rec_k) ** 2,
                          axis=(1, 2)).astype(jnp.float32)
            # coefficient-rate estimate: ~3 bins per significant coeff
            # plus ~2 bins per magnitude doubling (EG suffix growth)
            al = jnp.abs(lev_k).astype(jnp.float32)
            rate = jnp.sum(jnp.where(al > 0.0,
                                     3.0 + 2.0 * jnp.log2(al + 1.0),
                                     0.0), axis=(1, 2))
            cost = sse + lam2 * (rate + cand_bits[:, kk])
            if best is None:
                best = (cost, md_k)
            else:
                u = cost < best[0]
                best = (jnp.where(u, cost, best[0]),
                        jnp.where(u, md_k, best[1]))
        md_sel = best[1]
        modes = md_sel

    pred = intra_pred_select_batch(s_sub, s_filt, modes, log2n, c_idx,
                                   bit_depth,
                                   filt_chroma=fchroma and c_idx > 0)
    if mc_pred is not None:
        is_inter = inter_mask[by, bx]                       # (B,)
        pred = jnp.where(is_inter[:, None, None], mc_pred[by, bx], pred)
        intra_mask = ~is_inter
    else:
        intra_mask = jnp.ones(bx.shape, bool)
    gy = y0[:, None, None] + jnp.arange(n)[None, :, None]
    gx = x0[:, None, None] + jnp.arange(n)[None, None, :]
    gyc = jnp.clip(gy, 0, orig.shape[0] - 1)
    gxc = jnp.clip(gx, 0, orig.shape[1] - 1)
    org = orig[gyc, gxc].astype(jnp.int32)
    resi = org - pred
    if lossless:
        # transquant bypass (spec 8.6.1): residual samples ARE the
        # coded coefficients; reconstruction is exact
        lev = resi
        recon = org
        skip = None
        if mc_pred is not None:
            skip = (~intra_mask) & \
                (jnp.sum(jnp.abs(resi), axis=(1, 2)) == 0)
            lev = jnp.where(skip[:, None, None], 0, lev)
        plane = plane.at[jnp.clip(gy, 0, hp - 1), gx].set(recon)
        levels = levels.at[by, bx].set(lev)
        return plane, levels, skip
    coef = dct_batch(resi, log2n, bit_depth)
    nr_out = None
    if nr is not None:
        # noise reduction (x265 --nr-intra/--nr-inter, quant.cpp:449 +
        # dct.cpp:746 denoiseDct): subtract the running per-position
        # noise offset from |coef| before quantization and accumulate
        # this frame's |coef| sums for the next frame's offsets
        # (batched form: offsets update once per FRAME, not per TU —
        # a one-frame lag on the running average)
        off_i, off_p = nr                 # (n*n,) each, intra/inter
        ac = jnp.abs(coef)
        acf = ac.reshape(ac.shape[0], -1)
        lane_ok = (by < levels.shape[0] - 1).astype(jnp.int32)
        imask_f = (intra_mask.astype(jnp.int32) * lane_ok)[:, None]
        pmask_f = ((1 - intra_mask.astype(jnp.int32)) * lane_ok)[:, None]
        nr_out = (jnp.sum(acf * imask_f, axis=0),
                  jnp.sum(acf * pmask_f, axis=0),
                  jnp.sum(imask_f[:, 0]),
                  jnp.sum(pmask_f[:, 0]))
        off = jnp.where(intra_mask[:, None], off_i[None, :],
                        off_p[None, :]).reshape(ac.shape)
        coef = jnp.sign(coef) * jnp.maximum(ac - off, 0)
    lev = rdoq_levels(coef, intra_mask, qp, log2n, bit_depth, c_idx,
                      init_type, psy_rdoq=psy_rdoq, qmats=qmats,
                      rawmats=dmats, bits_table=ebits) if rdoq \
        else quant_dyn(coef, intra_mask, qp, log2n, bit_depth, qmats)
    if sign_hide:
        lev = sbh_adjust(lev, coef, intra_mask, qp, log2n, bit_depth)

    # inter zero-residual RD test: drop the residual when the distortion
    # increase is cheaper than its rate (x265 rd0-4 sa8d-based merge/skip
    # preference, analysis.cpp:3485).  EVERY component decides for itself
    # with its own qp/lambda — a CU becomes SKIP only when all three
    # planes independently chose zero (x265 folds chroma distortion into
    # one CU decision; per-plane is the batched equivalent and avoids
    # chroma drift on chroma-busy content).
    skip = None
    if mc_pred is not None:
        deq0 = dequant_dyn(lev, qp, log2n, bit_depth, dmats, intra_mask)
        rres0 = idct_batch(deq0, log2n, bit_depth)
        rec0 = jnp.clip(pred + rres0, 0, maxval)
        sse_coded = jnp.sum((org - rec0) ** 2, axis=(1, 2))
        sse_skip = jnp.sum((org - pred) ** 2, axis=(1, 2))
        nz = jnp.sum((lev != 0).astype(jnp.int32), axis=(1, 2))
        lam2 = 0.85 * jnp.exp2((qp.astype(jnp.float32) - 12.0) / 3.0) \
            * (1 << (2 * (bit_depth - 8)))
        if c_idx != 0:
            import os as _os
            # chroma skip-RD lambda scale experiment knob: x265 folds
            # chroma into ONE CU decision at the luma lambda with a
            # chroma distortion weight (rdcost.h
            # setCbDistortionWeight); our per-plane chroma lambda (from
            # the lower chroma QP) is effectively smaller, which
            # overcodes chroma in the grain-on-smooth regime (the
            # round-5 1080p park diagnosis, BENCH_NOTES)
            lam2 = lam2 * float(
                _os.environ.get("X265TPU_CHROMA_SKIP_LAM", "1.0"))
        # B slices charge the coded-CU syntax delta the per-plane
        # decision cannot see (skip_flag vs merge_flag+cbf+TU flags ~8
        # extra bins when ANY plane codes; x265 folds all three planes
        # into one checkMerge2Nx2N RD).  Calibrated round 5: park
        # -0.28% BD-rate Y at (14, 6), nat neutral; saturates by
        # (20, 8).  P keeps the round-2 calibration.
        base_bits = 6.0 if c_idx == 0 else 2.0
        if init_type is not None:
            import os as _os
            _sb = _os.environ.get("X265TPU_SKIP_BITS", "14,6")
            by_, bc_ = (float(t) for t in _sb.split(","))
            base_bits = jnp.where(
                jnp.asarray(init_type) == 0,
                by_ if c_idx == 0 else bc_, base_bits)
        if init_type is not None and c_idx != 0:
            # chroma: rate-true residual bits from the EstBitsSbac
            # tables over the actual chosen levels (last_pos + CG flags
            # + sig/gt1/gt2/sign/remaining on the coded scan region).
            # Measured on the park clip this is worth ~5 BD points
            # global (the linear model, calibrated on luma statistics,
            # overcharged sparse chroma TBs and skipped too much).
            # LUMA keeps the density-calibrated linear model: the
            # frozen slice-start states undercharge sig=1 in the
            # sparse-grain regime where real adapted contexts have
            # drifted toward all-zero (measured +4.7 BD-rate Y when
            # the table estimate drives the luma decision too).
            from ..ops.rdoq import tb_bits_est
            bits = base_bits + tb_bits_est(lev, qp, log2n, c_idx,
                                           init_type, bits_table=ebits)
        elif init_type is not None:
            # luma: structural CABAC estimate over the chosen levels.
            # With the per-WPP-row adapted tables this matches the old
            # max(linear, est) hybrid on the park sweep (+25.72%Y vs
            # +25.78%Y, round-5 A/B) — the row-lagged states fixed the
            # frozen-state sig=1 undercharge the linear floor guarded
            # against, so the floor is retired.
            from ..ops.rdoq import tb_bits_est
            bits = base_bits + tb_bits_est(lev, qp, log2n, c_idx,
                                           init_type, bits_table=ebits)
        else:
            nzf = nz.astype(jnp.float32)
            bits = base_bits + jnp.where(nzf > 0.0, 10.0, 0.0) \
                + 4.5 * nzf
        cost_skip = sse_skip.astype(jnp.float32)
        cost_coded = sse_coded.astype(jnp.float32) + lam2 * bits
        if psy256 is not None and c_idx == 0:
            # psy-rd (reference rdcost.h:115 calcPsyRdCost with
            # pixel.cpp:736 psyCost_pp): dist + lambda*psyRd*0.33*
            # sliceTypeScale*E, E = per-8x8-tile |AC-energy(org) -
            # AC-energy(recon)|.  Keeps the skip decision honest on
            # texture: a blurry MC prediction that loses grain energy
            # pays for it even when its SSE looks fine.  Slice-type
            # scale {B,P,I} = {300,256,96}>>8 and the qp>=40 rolloff
            # follow rdcost.h:57-65.
            from ..ops.cost import psy_cost_batch
            styp = jnp.asarray([300.0, 256.0, 96.0], jnp.float32)[
                jnp.clip(init_type if init_type is not None else 2,
                         0, 2)] / 256.0
            qpf = qp.astype(jnp.float32)
            roll = jnp.where(
                qpf >= 40.0,
                jnp.clip((51.0 - qpf) * 23.0 / 256.0, 0.0, 1.0), 1.0)
            psy_w = jnp.sqrt(lam2) * \
                (psy256.astype(jnp.float32) / 256.0) * 0.33 * styp * roll
            cost_skip = cost_skip + psy_w * \
                psy_cost_batch(org, pred).astype(jnp.float32)
            cost_coded = cost_coded + psy_w * \
                psy_cost_batch(org, rec0).astype(jnp.float32)
        skip = (~intra_mask) & (cost_skip <= cost_coded)
        lev = jnp.where(skip[:, None, None], 0, lev)
    deq = dequant_dyn(lev, qp, log2n, bit_depth, dmats, intra_mask)
    rres = idct_batch(deq, log2n, bit_depth)
    recon = jnp.clip(pred + rres, 0, maxval)

    if split_map is not None:
        # NxN path: the block is 4 z-order sub-TUs (luma 8x8, chroma
        # 4x4), each predicted from recon neighbors INCLUDING earlier
        # sub-blocks (spec 8.4.4.2 per-TB intra).  Both paths are
        # computed for all lanes; the split flag selects (batched
        # branchless form of the reference's compressIntraCU NxN
        # candidate, analysis.cpp:878).
        ns = n // 2
        l2s = log2n - 1
        split = split_map[by, bx] & intra_mask            # (B,)
        plane8 = plane
        lev8 = jnp.zeros_like(lev)
        ks8 = np.arange(4 * ns + 1)
        k8x = np.where(ks8 <= 2 * ns, -1, ks8 - (2 * ns + 1))
        k8y = np.where(ks8 < 2 * ns, 2 * ns - 1 - ks8, -1)
        ones = jnp.ones(bx.shape, bool)
        for k, (dxs, dys) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
            x8 = x0 + dxs * ns
            y8 = y0 + dys * ns
            xs8 = jnp.clip(x8[:, None] + jnp.asarray(k8x)[None, :],
                           0, wp - 1)
            ys8 = jnp.clip(y8[:, None] + jnp.asarray(k8y)[None, :],
                           0, hp - 1)
            s_raw8 = plane8[ys8, xs8]
            ss8, sf8 = substitute_filter_batch(s_raw8, av8[:, k], l2s,
                                               bit_depth)
            if c_idx == 0:
                md8 = modes8[jnp.clip(by, 0, levels.shape[0] - 2),
                             jnp.clip(bx, 0, levels.shape[1] - 1), k]
            else:
                md8 = modes                 # chroma DM mode per block
            pred8 = intra_pred_select_batch(ss8, sf8, md8, l2s, c_idx,
                                            bit_depth)
            gy8 = y8[:, None, None] + jnp.arange(ns)[None, :, None]
            gx8 = x8[:, None, None] + jnp.arange(ns)[None, None, :]
            org8 = orig[jnp.clip(gy8, 0, orig.shape[0] - 1),
                        jnp.clip(gx8, 0, orig.shape[1] - 1)] \
                .astype(jnp.int32)
            coef8 = dct_batch(org8 - pred8, l2s, bit_depth)
            # sub-TU scaling tables (per size, not per component) are
            # threaded via m8 (flat/None when lists are off)
            lv8 = rdoq_levels(coef8, ones, qp, l2s, bit_depth, c_idx,
                              init_type, qmats=m8[0],
                              rawmats=m8[1]) if rdoq \
                else quant_dyn(coef8, ones, qp, l2s, bit_depth, m8[0])
            if sign_hide:
                # TU8 luma / TU4 chroma scans are mode-dependent (spec
                # 7.4.9.11) — SBH parity must follow the real scan
                lv8 = sbh_adjust(lv8, coef8, ones, qp, l2s, bit_depth,
                                 scan_sel=_scan_sel_of(md8))
            deq8 = dequant_dyn(lv8, qp, l2s, bit_depth, m8[1], ones)
            rec8 = jnp.clip(pred8 + idct_batch(deq8, l2s, bit_depth),
                            0, maxval)
            keep = plane8[jnp.clip(gy8, 0, hp - 1), gx8]
            if c_idx == 0 and tu4_map is not None:
                # voluntary TU4(DST) split of this 8x8 luma TU (spec
                # 7.3.8.8 split_transform_flag at trafoDepth 1 under
                # PART_NxN; reference codeIntraLumaQT recursion,
                # search.cpp:646): the four 4x4 TBs re-predict from
                # recon neighbors sequentially, with the DST transform
                t4 = tu4_map[jnp.clip(by, 0, levels.shape[0] - 2),
                             jnp.clip(bx, 0, levels.shape[1] - 1),
                             k] & split
                plane8 = plane8.at[jnp.clip(gy8, 0, hp - 1), gx8].set(
                    jnp.where((split & ~t4)[:, None, None], rec8, keep))
                lev4 = jnp.zeros_like(lv8)
                ks4 = np.arange(17)
                k4x = np.where(ks4 <= 8, -1, ks4 - 9)
                k4y = np.where(ks4 < 8, 7 - ks4, -1)
                for j, (dxq, dyq) in enumerate(((0, 0), (1, 0),
                                                (0, 1), (1, 1))):
                    x4 = x8 + dxq * 4
                    y4 = y8 + dyq * 4
                    xs4 = jnp.clip(x4[:, None] +
                                   jnp.asarray(k4x)[None, :], 0, wp - 1)
                    ys4 = jnp.clip(y4[:, None] +
                                   jnp.asarray(k4y)[None, :], 0, hp - 1)
                    ss4, sf4 = substitute_filter_batch(
                        plane8[ys4, xs4], av4y[:, k, j], 2, bit_depth)
                    pred4 = intra_pred_select_batch(ss4, sf4, md8, 2,
                                                    0, bit_depth)
                    gy4 = y4[:, None, None] + jnp.arange(4)[None, :,
                                                            None]
                    gx4 = x4[:, None, None] + jnp.arange(4)[None, None,
                                                            :]
                    org4 = orig[jnp.clip(gy4, 0, orig.shape[0] - 1),
                                jnp.clip(gx4, 0, orig.shape[1] - 1)] \
                        .astype(jnp.int32)
                    coef4 = dct_batch(org4 - pred4, 2, bit_depth,
                                      dst=True)
                    lv4 = rdoq_levels(coef4, ones, qp, 2, bit_depth, 0,
                                      init_type, psy_rdoq=psy_rdoq) \
                        if rdoq \
                        else quant_dyn(coef4, ones, qp, 2, bit_depth,
                                       None)
                    if sign_hide:
                        lv4 = sbh_adjust(lv4, coef4, ones, qp, 2,
                                         bit_depth,
                                         scan_sel=_scan_sel_of(md8))
                    deq4 = dequant_dyn(lv4, qp, 2, bit_depth, None,
                                       ones)
                    rec4 = jnp.clip(
                        pred4 + idct_batch(deq4, 2, bit_depth,
                                           dst=True), 0, maxval)
                    keep4 = plane8[jnp.clip(gy4, 0, hp - 1), gx4]
                    plane8 = plane8.at[
                        jnp.clip(gy4, 0, hp - 1), gx4].set(
                        jnp.where(t4[:, None, None], rec4, keep4))
                    lev4 = lev4.at[:, dyq * 4:dyq * 4 + 4,
                                   dxq * 4:dxq * 4 + 4].set(lv4)
                lv8 = jnp.where(t4[:, None, None], lev4, lv8)
            else:
                plane8 = plane8.at[jnp.clip(gy8, 0, hp - 1), gx8].set(
                    jnp.where(split[:, None, None], rec8, keep))
            lev8 = lev8.at[:, dys * ns:dys * ns + ns,
                           dxs * ns:dxs * ns + ns].set(lv8)
        rec_split = plane8[jnp.clip(gy, 0, hp - 1), gx]
        recon = jnp.where(split[:, None, None], rec_split, recon)
        lev = jnp.where(split[:, None, None], lev8, lev)

    plane = plane.at[jnp.clip(gy, 0, hp - 1), gx].set(recon)
    levels = levels.at[by, bx].set(lev)
    out = (plane, levels, skip)
    if cand_bits is not None:
        out = out + (md_sel,)
    if nr is not None:
        out = out + (nr_out,)
    return out




# standalone-jitted variant for unit tests / kernel benches
_component_substep = jax.jit(
    _substep_body,
    static_argnames=("log2n", "c_idx", "bit_depth"),
    donate_argnums=(0, 1),
)


def _intra_tb_whole(plane, orig, x0, y0, modes, avail, log2n: int,
                    qp, c_idx: int, bit_depth: int, sign_hide: bool,
                    rdoq: bool, qm, dm, strong: bool,
                    init_type=None, psy_rdoq=None):
    """Whole-TB intra predict + transform + recon for (B,) lanes at pixel
    coords (x0, y0).  Unlike _substep_body this does NOT write the plane —
    the caller commits the result under the CU-tree split mask.

    Returns (rec (B,N,N), lev (B,N,N), gy, gx index grids)."""
    n = 1 << log2n
    maxval = (1 << bit_depth) - 1
    hp, wp = plane.shape
    ks = np.arange(4 * n + 1)
    k_x = np.where(ks <= 2 * n, -1, ks - (2 * n + 1))
    k_y = np.where(ks < 2 * n, 2 * n - 1 - ks, -1)
    xs = jnp.clip(x0[:, None] + jnp.asarray(k_x)[None, :], 0, wp - 1)
    ys = jnp.clip(y0[:, None] + jnp.asarray(k_y)[None, :], 0, hp - 1)
    s_sub, s_filt = substitute_filter_batch(plane[ys, xs], avail, log2n,
                                            bit_depth, strong=strong)
    pred = intra_pred_select_batch(s_sub, s_filt, modes, log2n, c_idx,
                                   bit_depth)
    gy = y0[:, None, None] + jnp.arange(n)[None, :, None]
    gx = x0[:, None, None] + jnp.arange(n)[None, None, :]
    org = orig[jnp.clip(gy, 0, orig.shape[0] - 1),
               jnp.clip(gx, 0, orig.shape[1] - 1)].astype(jnp.int32)
    coef = dct_batch(org - pred, log2n, bit_depth)
    ones = jnp.ones(x0.shape, bool)
    lev = rdoq_levels(coef, ones, qp, log2n, bit_depth, c_idx,
                      init_type, psy_rdoq=psy_rdoq) if rdoq \
        else quant_dyn(coef, ones, qp, log2n, bit_depth, qm)
    if sign_hide:
        lev = sbh_adjust(lev, coef, ones, qp, log2n, bit_depth)
    deq = dequant_dyn(lev, qp, log2n, bit_depth, dm, ones)
    rec = jnp.clip(pred + idct_batch(deq, log2n, bit_depth), 0, maxval)
    return rec, lev, gy, gx


def _wavefront_tree_body(yp, up, vp, lev_y, lev_u, lev_v, oy, ou, ov,
                         modes, s16_bx, s16_by, s16_avy, s16_avc,
                         r_px, r_py, r_valid, r_avy, r_avc,
                         split32, mode32,
                         qp, qp_cb, qp_cr, bit_depth: int = 8,
                         sign_hide: bool = False, rdoq: bool = False,
                         mats=None, mats32=None, split_map=None,
                         modes8=None, s16_av8=None, s16_av4c=None,
                         strong: bool = False, init_type=None,
                         psy_rdoq=None, cand16=None, cbits16=None):
    """Variable CU-tree wavefront (intra): steps iterate 32x32 regions in
    wavefront + z order; each step evaluates BOTH the four z-ordered
    16x16 CU substeps (with their optional NxN splits) AND the whole
    region as one 32x32 CU (TU32 luma + TU16 chroma), committing per the
    split32 decision — the batched branchless form of the reference's
    compressIntraCU depth recursion (analysis.cpp:878; SURVEY §7
    'pruning masks, not branches').

    s16_*: (S, 4, B) per-16-block schedule; r_px/r_py: (S, B) region
    pixel coords (invalid lanes redirected into the dump area);
    split32/mode32: (n32y, n32x) maps; r_valid: (S, B) bool.
    """
    nby = lev_y.shape[0] - 1
    nbx = lev_y.shape[1]
    n32y, n32x = split32.shape
    skip_map = jnp.zeros((nby + 1, nbx), bool)
    # RD mode selection: modes becomes a carry map (dump row nby) that
    # luma substeps write their winner into; chroma DM reads from it
    m_map = jnp.concatenate(
        [modes, jnp.zeros((1, nbx), modes.dtype)], 0)

    def step(s, carry):
        yp, up, vp, lev_y, lev_u, lev_v, m_map = carry
        # -- the 4 z-ordered 16x16 substeps (identical to the legacy body)
        for z in range(4):
            bx = s16_bx[s, z]
            by = s16_by[s, z]
            cy = jnp.clip(by, 0, qp.shape[0] - 1)
            cx = jnp.clip(bx, 0, qp.shape[1] - 1)
            if cand16 is not None:
                md_k = cand16[jnp.clip(by, 0, nby - 1),
                              jnp.clip(bx, 0, nbx - 1)]
                cb_k = cbits16[jnp.clip(by, 0, nby - 1),
                               jnp.clip(bx, 0, nbx - 1)]
                yp, lev_y, _, md_w = _substep_body(
                    yp, lev_y, oy, bx, by, md_k, s16_avy[s, z],
                    4, qp[cy, cx], 0, bit_depth, None, None, sign_hide,
                    None, rdoq, mats[0] if mats else None,
                    mats[1] if mats else None,
                    split_map, modes8,
                    s16_av8[s, z] if s16_av8 is not None else None,
                    (mats[2] if mats else None,
                     mats[3] if mats else None),
                    init_type=init_type, psy_rdoq=psy_rdoq,
                    cand_bits=cb_k)
                m_map = m_map.at[by, bx].set(md_w)
            md = m_map[jnp.clip(by, 0, nby - 1),
                       jnp.clip(bx, 0, nbx - 1)]
            if cand16 is None:
                yp, lev_y, _ = _substep_body(
                    yp, lev_y, oy, bx, by, md, s16_avy[s, z],
                    4, qp[cy, cx], 0, bit_depth, None, None, sign_hide,
                    None, rdoq, mats[0] if mats else None,
                    mats[1] if mats else None,
                    split_map, modes8,
                    s16_av8[s, z] if s16_av8 is not None else None,
                    (mats[2] if mats else None,
                     mats[3] if mats else None),
                    init_type=init_type, psy_rdoq=psy_rdoq)
            up, lev_u, _ = _substep_body(
                up, lev_u, ou, bx, by, md, s16_avc[s, z],
                3, qp_cb[cy, cx], 1, bit_depth, None, None, sign_hide,
                None, rdoq, mats[2] if mats else None,
                mats[3] if mats else None,
                split_map, modes8,
                s16_av4c[s, z] if s16_av4c is not None else None,
                (None, None), init_type=init_type)
            vp, lev_v, _ = _substep_body(
                vp, lev_v, ov, bx, by, md, s16_avc[s, z],
                3, qp_cr[cy, cx], 2, bit_depth, None, None, sign_hide,
                None, rdoq, mats[2] if mats else None,
                mats[3] if mats else None,
                split_map, modes8,
                s16_av4c[s, z] if s16_av4c is not None else None,
                (None, None), init_type=init_type)

        # -- whole-region 32x32 CU path -----------------------------------
        px = r_px[s]
        py = r_py[s]
        valid = r_valid[s]
        r32x = jnp.clip(px >> 5, 0, n32x - 1)
        r32y = jnp.clip(py >> 5, 0, n32y - 1)
        commit = valid & ~split32[r32y, r32x]
        md32 = mode32[r32y, r32x]
        cy = jnp.clip(py >> 4, 0, qp.shape[0] - 1)
        cx = jnp.clip(px >> 4, 0, qp.shape[1] - 1)
        rec32, lv32, gy, gx = _intra_tb_whole(
            yp, oy, px, py, md32, r_avy[s], 5, qp[cy, cx], 0,
            bit_depth, sign_hide, rdoq,
            mats32[0] if mats32 else None,
            mats32[1] if mats32 else None, strong, init_type,
            psy_rdoq=psy_rdoq)
        cur = yp[jnp.clip(gy, 0, yp.shape[0] - 1), gx]
        yp = yp.at[jnp.clip(gy, 0, yp.shape[0] - 1), gx].set(
            jnp.where(commit[:, None, None], rec32, cur))
        for (cpl, lev_c, opl, qpc, mi) in ((up, lev_u, ou, qp_cb, 1),
                                           (vp, lev_v, ov, qp_cr, 2)):
            recc, lvc, gyc, gxc = _intra_tb_whole(
                cpl, opl, px >> 1, py >> 1, md32, r_avc[s], 4,
                qpc[cy, cx], mi, bit_depth, sign_hide, rdoq,
                mats32[2] if mats32 else None,
                mats32[3] if mats32 else None, False, init_type)
            curc = cpl[jnp.clip(gyc, 0, cpl.shape[0] - 1), gxc]
            cpl = cpl.at[jnp.clip(gyc, 0, cpl.shape[0] - 1), gxc].set(
                jnp.where(commit[:, None, None], recc, curc))
            # store TU16 chroma levels as 8x8 quadrants of the 4 blocks
            for (dy, dx) in ((0, 0), (0, 1), (1, 0), (1, 1)):
                bq_x = jnp.where(valid, (px >> 4) + dx, 0)
                bq_y = jnp.where(valid, (py >> 4) + dy, nby)
                q = lvc[:, dy * 8:dy * 8 + 8, dx * 8:dx * 8 + 8]
                curl = lev_c[bq_y, bq_x]
                lev_c = lev_c.at[bq_y, bq_x].set(
                    jnp.where(commit[:, None, None], q, curl))
            if mi == 1:
                up, lev_u = cpl, lev_c
            else:
                vp, lev_v = cpl, lev_c
        # store TU32 luma levels as 16x16 quadrants of the 4 blocks
        for (dy, dx) in ((0, 0), (0, 1), (1, 0), (1, 1)):
            bq_x = jnp.where(valid, (px >> 4) + dx, 0)
            bq_y = jnp.where(valid, (py >> 4) + dy, nby)
            q = lv32[:, dy * 16:dy * 16 + 16, dx * 16:dx * 16 + 16]
            curl = lev_y[bq_y, bq_x]
            lev_y = lev_y.at[bq_y, bq_x].set(
                jnp.where(commit[:, None, None], q, curl))
        return yp, up, vp, lev_y, lev_u, lev_v, m_map

    carry = (yp, up, vp, lev_y, lev_u, lev_v, m_map)
    carry = jax.lax.fori_loop(0, s16_bx.shape[0], step, carry)
    return carry


_wavefront_tree_run = jax.jit(
    _wavefront_tree_body,
    static_argnames=("bit_depth", "sign_hide", "rdoq", "strong"),
    donate_argnums=(0, 1, 2, 3, 4, 5),
)


def _wavefront_body(yp, up, vp, lev_y, lev_u, lev_v, oy, ou, ov, modes,
                    sb_bx, sb_by, sb_avy, sb_avc,
                    mc_y, mc_u, mc_v, inter_mask,
                    qp, qp_cb, qp_cr, bit_depth: int = 8,
                    sign_hide: bool = False, rdoq: bool = False,
                    mats=None, split_map=None, modes8=None, sb_av8=None,
                    sb_av4c=None, lossless: bool = False,
                    init_type=None, psy256=None, psy_rdoq=None,
                    tu4_map=None, sb_av4y=None, clog2: int = 3,
                    fchroma: bool = False, csp422: bool = False,
                    imask_c=None, cand16=None, cbits16=None,
                    nr_y=None, nr_c=None, ebits=None):
    """Run the full wavefront schedule in one compiled loop.
    mats: None, or (qm_y, dm_y, qm_c, dm_c) scaling-list tables.
    split_map/modes8/sb_av8: NxN intra decisions — (nby+1, nbx) bool,
    (nby, nbx, 4) int32, (S, B, 4, 33) bool sub-block availability.

    sb_bx/sb_by: (S, B) int32 block coords per substep
    sb_avy:      (S, B, 65) bool luma availability
    sb_avc:      (S, B, 33) bool chroma availability
    mc_*:        (nby+1, nbx, N, N) inter predictions (zeros for I frames)
    inter_mask:  (nby+1, nbx) bool
    qp/qp_cb/qp_cr: (nCtuY, nCtuX) int32 per-CTU QP maps (AQ); uniform
    maps reproduce the flat-QP behavior exactly.
    """
    nby = lev_y.shape[0] - 1
    nbx = lev_y.shape[1]
    skip_map = jnp.zeros((nby + 1, nbx), bool)
    # RD mode selection: modes becomes a carry map (dump row nby) that
    # luma substeps write their winner into; chroma DM reads from it
    m_map = jnp.concatenate(
        [modes, jnp.zeros((1, nbx), modes.dtype)], 0)
    have_nr = nr_y is not None
    nl2 = lev_y.shape[2] * lev_y.shape[3]
    nc2 = lev_u.shape[2] * lev_u.shape[3]
    nr_acc0 = (jnp.zeros(nl2, jnp.int32), jnp.zeros(nl2, jnp.int32),
               jnp.zeros(nc2, jnp.int32), jnp.zeros(nc2, jnp.int32),
               jnp.zeros(4, jnp.int32)) if have_nr else None


    def _nr_add(acc, out, luma):
        si, sp, ci, cp = out
        ys_i, ys_p, cs_i, cs_p, cnt = acc
        if luma:
            ys_i = ys_i + si
            ys_p = ys_p + sp
            cnt = cnt + jnp.stack([ci, cp, 0, 0])
        else:
            cs_i = cs_i + si
            cs_p = cs_p + sp
            cnt = cnt + jnp.stack([0, 0, ci, cp])
        return (ys_i, ys_p, cs_i, cs_p, cnt)

    def step(s, carry):
        if have_nr:
            (yp, up, vp, lev_y, lev_u, lev_v, skip_map, m_map,
             nr_acc) = carry
        else:
            yp, up, vp, lev_y, lev_u, lev_v, skip_map, m_map = carry
        bx = sb_bx[s]
        by = sb_by[s]
        eb_s = ebits
        if ebits is not None and ebits.ndim == 3:
            # per-WPP-row adapted rate tables: gather each lane's block
            # row's table (entropy.cpp:2624 estBit refresh, row-lagged)
            eb_s = ebits[jnp.clip(by, 0, ebits.shape[0] - 1)]
        cy = jnp.clip(by, 0, qp.shape[0] - 1)
        cx = jnp.clip(bx, 0, qp.shape[1] - 1)
        qp_b = qp[cy, cx]
        qpcb_b = qp_cb[cy, cx]
        qpcr_b = qp_cr[cy, cx]
        nr_l = (nr_y[0], nr_y[1]) if have_nr else None
        nr_cc = (nr_c[0], nr_c[1]) if have_nr else None
        if cand16 is not None:
            md_k = cand16[jnp.clip(by, 0, nby - 1),
                          jnp.clip(bx, 0, nbx - 1)]
            cb_k = cbits16[jnp.clip(by, 0, nby - 1),
                           jnp.clip(bx, 0, nbx - 1)]
            res_l = _substep_body(
                yp, lev_y, oy, bx, by, md_k, sb_avy[s],
                4, qp_b, 0, bit_depth, mc_y, inter_mask, sign_hide,
                None, rdoq, mats[0] if mats else None,
                mats[1] if mats else None,
                split_map, modes8,
                sb_av8[s] if sb_av8 is not None else None,
                (mats[2] if mats else None, mats[3] if mats else None),
                lossless, init_type, psy256=psy256, psy_rdoq=psy_rdoq,
                tu4_map=tu4_map,
                av4y=sb_av4y[s] if sb_av4y is not None else None,
                cand_bits=cb_k, nr=nr_l, ebits=eb_s)
            yp, lev_y, skip, md_w = res_l[:4]
            if have_nr:
                nr_acc = _nr_add(nr_acc, res_l[4], True)
            m_map = m_map.at[by, bx].set(md_w)
        md = m_map[jnp.clip(by, 0, nby - 1), jnp.clip(bx, 0, nbx - 1)]
        if cand16 is None:
            res_l = _substep_body(
                yp, lev_y, oy, bx, by, md, sb_avy[s],
                4, qp_b, 0, bit_depth, mc_y, inter_mask, sign_hide,
                None, rdoq, mats[0] if mats else None,
                mats[1] if mats else None,
                split_map, modes8,
                sb_av8[s] if sb_av8 is not None else None,
                (mats[2] if mats else None, mats[3] if mats else None),
                lossless, init_type, psy256=psy256, psy_rdoq=psy_rdoq,
                tu4_map=tu4_map,
                av4y=sb_av4y[s] if sb_av4y is not None else None,
                nr=nr_l, ebits=eb_s)
            yp, lev_y, skip = res_l[:3]
            if have_nr:
                nr_acc = _nr_add(nr_acc, res_l[3], True)
        if skip is not None:
            skip_map = skip_map.at[by, bx].set(skip)
        m4 = (None, None)                    # 4x4 lists are flat
        if csp422:
            # 4:2:2: each 16x16 luma block carries TWO stacked 8x8
            # chroma TBs (spec 7.3.8.10 ChromaArrayType==2); the
            # chroma level/pred stores use a row-doubled block grid,
            # and prediction uses the Table 8-3 remapped mode
            from ..constants.hevc_tables import CHROMA_422_ANGLE_MAP
            md_c = jnp.asarray(np.asarray(CHROMA_422_ANGLE_MAP,
                                          np.int32))[jnp.clip(md, 0,
                                                              34)]
            for j in (0, 1):
                byc = by * 2 + j
                up, lev_u, _ = _substep_body(
                    up, lev_u, ou, bx, byc, md_c, sb_avc[s][:, j],
                    clog2, qpcb_b, 1, bit_depth, mc_u, imask_c,
                    sign_hide, skip_map, rdoq,
                    mats[2] if mats else None,
                    mats[3] if mats else None, None, None, None, m4,
                    lossless, init_type)
                vp, lev_v, _ = _substep_body(
                    vp, lev_v, ov, bx, byc, md_c, sb_avc[s][:, j],
                    clog2, qpcr_b, 2, bit_depth, mc_v, imask_c,
                    sign_hide, skip_map, rdoq,
                    mats[2] if mats else None,
                    mats[3] if mats else None, None, None, None, m4,
                    lossless, init_type)
            return yp, up, vp, lev_y, lev_u, lev_v, skip_map, m_map
        res_u = _substep_body(
            up, lev_u, ou, bx, by, md, sb_avc[s],
            clog2, qpcb_b, 1, bit_depth, mc_u, inter_mask, sign_hide,
            skip_map, rdoq, mats[2] if mats else None,
            mats[3] if mats else None,
            split_map, modes8,
            sb_av4c[s] if sb_av4c is not None else None, m4, lossless,
            init_type, fchroma=fchroma, nr=nr_cc, ebits=eb_s)
        up, lev_u = res_u[0], res_u[1]
        if have_nr:
            nr_acc = _nr_add(nr_acc, res_u[3], False)
        res_v = _substep_body(
            vp, lev_v, ov, bx, by, md, sb_avc[s],
            clog2, qpcr_b, 2, bit_depth, mc_v, inter_mask, sign_hide,
            skip_map, rdoq, mats[2] if mats else None,
            mats[3] if mats else None,
            split_map, modes8,
            sb_av4c[s] if sb_av4c is not None else None, m4, lossless,
            init_type, fchroma=fchroma, nr=nr_cc, ebits=eb_s)
        vp, lev_v = res_v[0], res_v[1]
        if have_nr:
            nr_acc = _nr_add(nr_acc, res_v[3], False)
        out = (yp, up, vp, lev_y, lev_u, lev_v, skip_map, m_map)
        return out + ((nr_acc,) if have_nr else ())

    carry = (yp, up, vp, lev_y, lev_u, lev_v, skip_map, m_map)
    carry = carry + ((nr_acc0,) if have_nr else ())
    carry = jax.lax.fori_loop(0, sb_bx.shape[0], step, carry)
    out = carry[:6] + (carry[7],)
    return out + ((carry[8],) if have_nr else ())


_wavefront_run = jax.jit(
    _wavefront_body,
    static_argnames=("bit_depth", "sign_hide", "rdoq", "lossless",
                     "clog2", "fchroma", "csp422"),
    donate_argnums=(0, 1, 2, 3, 4, 5),
)


@functools.partial(jax.jit,
                   static_argnames=("bit_depth", "sign_hide", "rdoq",
                                    "clog2", "fchroma"),
                   donate_argnums=(0, 1, 2, 3, 4, 5))
def _wavefront_run_multi(yp, up, vp, lev_y, lev_u, lev_v, oy, ou, ov,
                         modes, sb_bx, sb_by, sb_avy, sb_avc,
                         mc_y, mc_u, mc_v, inter_mask,
                         qp, qp_cb, qp_cr, init_type=None,
                         bit_depth: int = 8,
                         sign_hide: bool = False, rdoq: bool = False,
                         mats=None, psy_rdoq=None, clog2: int = 3,
                         fchroma: bool = False):
    """Multi-frame wavefront: every per-frame arg carries a leading F
    axis; the schedule and QPs are shared.  All frames' wavefronts advance
    in lockstep — the multi-frame batching lever from SURVEY.md §7
    ('need big CTU batches to fill the device at small resolutions')."""
    def fn(*args):
        return _wavefront_body(*args, init_type=init_type,
                               bit_depth=bit_depth,
                               sign_hide=sign_hide, rdoq=rdoq, mats=mats,
                               psy_rdoq=psy_rdoq, clog2=clog2,
                               fchroma=fchroma)[:6]
    return jax.vmap(fn, in_axes=(0,) * 10 + (None,) * 4 + (0,) * 4 +
                    (None,) * 3)(
        yp, up, vp, lev_y, lev_u, lev_v, oy, ou, ov, modes,
        sb_bx, sb_by, sb_avy, sb_avc, mc_y, mc_u, mc_v, inter_mask,
        qp, qp_cb, qp_cr)


class IntraReconstructor:
    """Runs the wavefront over a frame; produces recon planes + levels.
    QP is a per-run traced argument — one compiled program serves every
    QP (rate-control requirement)."""

    def __init__(self, sps, cb_qp_offset: int = 0,
                 cr_qp_offset: int = 0, sign_hide: bool = False,
                 rdoq: bool = False, slice_tops: tuple = (),
                 nxn: bool = False, lossless: bool = False,
                 tree: bool = False, psy_rd: float = 0.0,
                 psy_rdoq: float = 0.0, tu4: bool = False) -> None:
        self.tu4 = bool(tu4)
        self.sps = sps
        self.cb_qp_offset = cb_qp_offset
        self.cr_qp_offset = cr_qp_offset
        self.sign_hide = bool(sign_hide)
        self.rdoq = bool(rdoq)
        # psy-rd weight (Q8) for the inter zero-residual RD test;
        # psy-rdoq bias for the RDOQ level decisions (both None = off,
        # which keeps the traced program identical to the psy-free one)
        self.psy256 = jnp.int32(round(psy_rd * 256.0)) \
            if psy_rd > 0 else None
        self.psy_rdoq = jnp.float32(psy_rdoq) \
            if (psy_rdoq > 0 and rdoq) else None
        self.mats = None
        self.mats32 = None
        if getattr(sps, "scaling_list_enabled", False):
            from ..ops.transform import quant_mats
            from ..constants.scaling import default_matrix
            sl = getattr(sps, "scaling_lists", None)
            if sl is not None:
                # custom lists (x265 --scaling-list <file>): per-slot
                # quant/raw matrices from the parsed lists, luma and
                # chroma each from their own listId
                from ..constants.scaling import (quant_mats_custom,
                                                 list_matrix)
                qm = lambda l2, c: quant_mats_custom(l2, sl[0], sl[1], c)
                raw = lambda l2, c: np.stack(
                    [list_matrix(sl[0], sl[1], l2, True, c),
                     list_matrix(sl[0], sl[1], l2, False, c)])
            else:
                qm = lambda l2, c: quant_mats(l2)
                raw = lambda l2, c: np.stack(
                    [default_matrix(l2, True),
                     default_matrix(l2, False)])
            self.mats = tuple(jnp.asarray(a) for a in (
                qm(4, 0), raw(4, 0), qm(3, 1), raw(3, 1)))
            if tree:
                self.mats32 = tuple(jnp.asarray(a) for a in (
                    qm(5, 0), raw(5, 0), qm(4, 1), raw(4, 1)))
        self.bd = sps.bit_depth
        self.log2_ctu = sps.log2_ctu_size
        self.csp = getattr(sps, "chroma_format_idc", 1)
        # horizontal chroma shift (0 only for 4:4:4); 4:2:2 halves x
        # but keeps full-height chroma on a row-doubled 8x8 block grid
        self.cshift = 0 if self.csp == 3 else 1
        self.is422 = self.csp == 2
        self.nl = 16                       # luma block size (v1 uniform)
        self.nc = self.nl >> self.cshift   # chroma block size
        w, h = sps.width, sps.height
        assert w % self.nl == 0 and h % self.nl == 0, \
            "v1 requires 16-aligned dimensions"
        self.nbx = w // self.nl
        self.nby = h // self.nl
        self.n_ctu_x = sps.pic_width_in_ctus
        self.n_ctu_y = sps.pic_height_in_ctus
        self.bpc = (1 << self.log2_ctu) // self.nl
        self.slice_tops = tuple(slice_tops)
        self.nxn = bool(nxn)
        self.lossless = bool(lossless)
        self.tree = bool(tree)
        if self.tree:
            assert self.log2_ctu >= 5 and not self.lossless
            self.n32x = w // 32
            self.n32y = h // 32
            self._build_tree_schedule()
        self._build_schedule()

    def _build_tree_schedule(self) -> None:
        """Stacked (S, 4, B) 16-block + (S, B) 32-region schedule: regions
        iterate in wavefront-diagonal order, then z within the CTU; the 4
        16-blocks of each region in z order (same total order as the
        legacy schedule, grouped by region)."""
        w, h = self.sps.width, self.sps.height
        avail_y = frame_avail_masks(w, h, self.nl, self.log2_ctu, 0,
                                    self.slice_tops)
        avail_c = frame_avail_masks(w, h, self.nc, self.log2_ctu, 1,
                                    self.slice_tops)
        av32 = frame_avail_masks(w, h, 32, self.log2_ctu, 0,
                                 self.slice_tops)
        av16c = frame_avail_masks(w, h, 16, self.log2_ctu, 1,
                                  self.slice_tops)
        av8_full = av4c_full = None
        if self.nxn:
            av8_full = frame_avail_masks(w, h, 8, self.log2_ctu, 0,
                                         self.slice_tops)
            av4c_full = frame_avail_masks(w, h, 4, self.log2_ctu, 1,
                                          self.slice_tops)
        waves = ctu_wavefront_order(self.n_ctu_x, self.n_ctu_y)
        B = max(len(wv[0]) for wv in waves)
        rpc = self.bpc // 2                 # 32-regions per CTU axis
        st = {"bx": [], "by": [], "avy": [], "avc": [], "av8": [],
              "av4c": [], "px": [], "py": [], "valid": [], "ravy": [],
              "ravc": []}
        for (cxs, cys) in waves:
            nb = len(cxs)
            pad = B - nb
            for q in range(rpc * rpc):
                qx = ((q >> 0) & 1) | (((q >> 2) & 1) << 1)
                qy = ((q >> 1) & 1) | (((q >> 3) & 1) << 1)
                rx = cxs * rpc + qx
                ry = cys * rpc + qy
                rvalid = ((rx + 1) * 32 <= w) & ((ry + 1) * 32 <= h)
                # skip steps whose region AND all 4 sub-blocks are outside
                any_blk = False
                zb = {"bx": [], "by": [], "avy": [], "avc": [], "av8": [],
                      "av4c": []}
                for z in range(4):
                    zx, zy = z & 1, z >> 1
                    bx = rx * 2 + zx
                    by = ry * 2 + zy
                    valid = (bx < self.nbx) & (by < self.nby)
                    any_blk |= valid.any()
                    bxp = np.where(valid, bx, 0).astype(np.int32)
                    byp = np.where(valid, by, self.nby).astype(np.int32)
                    avy = avail_y[np.where(valid, byp, 0),
                                  np.where(valid, bxp, 0)] & valid[:, None]
                    avc = avail_c[np.where(valid, byp, 0),
                                  np.where(valid, bxp, 0)] & valid[:, None]
                    if pad:
                        bxp = np.concatenate([bxp, np.zeros(pad, np.int32)])
                        byp = np.concatenate(
                            [byp, np.full(pad, self.nby, np.int32)])
                        avy = np.concatenate(
                            [avy, np.zeros((pad, avy.shape[1]), bool)])
                        avc = np.concatenate(
                            [avc, np.zeros((pad, avc.shape[1]), bool)])
                    zb["bx"].append(bxp)
                    zb["by"].append(byp)
                    zb["avy"].append(avy)
                    zb["avc"].append(avc)
                    if av8_full is not None:
                        a8 = np.zeros((B, 4, 33), bool)
                        a4 = np.zeros((B, 4, 17), bool)
                        for k, (dx8, dy8) in enumerate(
                                ((0, 0), (1, 0), (0, 1), (1, 1))):
                            a8[:nb, k] = av8_full[
                                np.where(valid, 2 * byp[:nb] + dy8, 0),
                                np.where(valid, 2 * bxp[:nb] + dx8, 0)] \
                                & valid[:, None]
                            a4[:nb, k] = av4c_full[
                                np.where(valid, 2 * byp[:nb] + dy8, 0),
                                np.where(valid, 2 * bxp[:nb] + dx8, 0)] \
                                & valid[:, None]
                        zb["av8"].append(a8)
                        zb["av4c"].append(a4)
                if not any_blk:
                    continue
                px = np.where(rvalid, rx * 32, 0).astype(np.int32)
                py = np.where(rvalid, ry * 32, h).astype(np.int32)
                ravy = av32[np.where(rvalid, np.minimum(ry, self.n32y - 1),
                                     0),
                            np.where(rvalid, np.minimum(rx, self.n32x - 1),
                                     0)] & rvalid[:, None]
                ravc = av16c[np.where(rvalid,
                                      np.minimum(ry, self.n32y - 1), 0),
                             np.where(rvalid,
                                      np.minimum(rx, self.n32x - 1), 0)] \
                    & rvalid[:, None]
                if pad:
                    px = np.concatenate([px, np.zeros(pad, np.int32)])
                    py = np.concatenate([py, np.full(pad, h, np.int32)])
                    rvalid = np.concatenate([rvalid, np.zeros(pad, bool)])
                    ravy = np.concatenate(
                        [ravy, np.zeros((pad, 129), bool)])
                    ravc = np.concatenate(
                        [ravc, np.zeros((pad, 65), bool)])
                st["bx"].append(np.stack(zb["bx"]))
                st["by"].append(np.stack(zb["by"]))
                st["avy"].append(np.stack(zb["avy"]))
                st["avc"].append(np.stack(zb["avc"]))
                if av8_full is not None:
                    st["av8"].append(np.stack(zb["av8"]))
                    st["av4c"].append(np.stack(zb["av4c"]))
                st["px"].append(px)
                st["py"].append(py)
                st["valid"].append(rvalid)
                st["ravy"].append(ravy)
                st["ravc"].append(ravc)
        self.t_bx = jnp.asarray(np.stack(st["bx"]))
        self.t_by = jnp.asarray(np.stack(st["by"]))
        self.t_avy = jnp.asarray(np.stack(st["avy"]))
        self.t_avc = jnp.asarray(np.stack(st["avc"]))
        self.t_av8 = jnp.asarray(np.stack(st["av8"])) \
            if av8_full is not None else None
        self.t_av4c = jnp.asarray(np.stack(st["av4c"])) \
            if av8_full is not None else None
        self.t_px = jnp.asarray(np.stack(st["px"]))
        self.t_py = jnp.asarray(np.stack(st["py"]))
        self.t_valid = jnp.asarray(np.stack(st["valid"]))
        self.t_ravy = jnp.asarray(np.stack(st["ravy"]))
        self.t_ravc = jnp.asarray(np.stack(st["ravc"]))

    def _build_schedule(self) -> None:
        """Static (per frame geometry) stacked wavefront schedule."""
        w, h = self.sps.width, self.sps.height
        avail_y = frame_avail_masks(w, h, self.nl, self.log2_ctu, 0,
                                    self.slice_tops)
        avail_c = frame_avail_masks(w, h, self.nc, self.log2_ctu, self.cshift,
                                    self.slice_tops)
        if self.is422:
            # 4:2:2 chroma availability on the row-doubled 8x8 grid
            avail_c = frame_avail_masks(w, h, 8, self.log2_ctu, 1,
                                        self.slice_tops,
                                        comp_shift_y=0)
        av8_full = av4c_full = av4y_full = None
        if self.nxn:
            av8_full = frame_avail_masks(w, h, 8, self.log2_ctu, 0,
                                         self.slice_tops)
            av4c_full = frame_avail_masks(w, h, 4, self.log2_ctu, 1,
                                          self.slice_tops)
            if self.tu4:
                av4y_full = frame_avail_masks(w, h, 4, self.log2_ctu,
                                              0, self.slice_tops)
        waves = ctu_wavefront_order(self.n_ctu_x, self.n_ctu_y)
        B = max(len(wv[0]) for wv in waves)
        bxs, bys, avys, avcs, av8s, av4cs = [], [], [], [], [], []
        av4ys = []
        for (cxs, cys) in waves:
            nb = len(cxs)
            for z in range(self.bpc * self.bpc):
                    # true z-scan order within the CTU (coincides with
                    # raster only for bpc == 2): deinterleave the index
                    zx = ((z >> 0) & 1) | (((z >> 2) & 1) << 1)
                    zy = ((z >> 1) & 1) | (((z >> 3) & 1) << 1)
                    bx = cxs * self.bpc + zx
                    by = cys * self.bpc + zy
                    valid = (bx < self.nbx) & (by < self.nby)
                    bxp = np.where(valid, bx, 0).astype(np.int32)
                    byp = np.where(valid, by, self.nby).astype(np.int32)
                    if nb < B:
                        pad = B - nb
                        bxp = np.concatenate([bxp, np.zeros(pad, np.int32)])
                        byp = np.concatenate(
                            [byp, np.full(pad, self.nby, np.int32)])
                        valid = np.concatenate([valid, np.zeros(pad, bool)])
                    if not valid.any():
                        continue
                    avy = avail_y[np.where(valid, byp, 0),
                                  np.where(valid, bxp, 0)] & valid[:, None]
                    if self.is422:
                        # both stacked 8x8 chroma TBs' masks (B, 2, 33)
                        avc = np.stack(
                            [avail_c[np.where(valid, 2 * byp + j, 0),
                                     np.where(valid, bxp, 0)]
                             & valid[:, None] for j in (0, 1)], axis=1)
                    else:
                        avc = avail_c[np.where(valid, byp, 0),
                                      np.where(valid, bxp, 0)] \
                            & valid[:, None]
                    bxs.append(bxp)
                    bys.append(byp)
                    avys.append(avy)
                    avcs.append(avc)
                    if av8_full is not None:
                        a8 = np.zeros((len(bxp), 4, 33), bool)
                        a4 = np.zeros((len(bxp), 4, 17), bool)
                        a4y = np.zeros((len(bxp), 4, 4, 17), bool) \
                            if av4y_full is not None else None
                        for k, (dx8, dy8) in enumerate(
                                ((0, 0), (1, 0), (0, 1), (1, 1))):
                            a8[:, k] = av8_full[
                                np.where(valid, 2 * byp + dy8, 0),
                                np.where(valid, 2 * bxp + dx8, 0)] \
                                & valid[:, None]
                            a4[:, k] = av4c_full[
                                np.where(valid, 2 * byp + dy8, 0),
                                np.where(valid, 2 * bxp + dx8, 0)] \
                                & valid[:, None]
                            if a4y is not None:
                                for j, (dxq, dyq) in enumerate(
                                        ((0, 0), (1, 0), (0, 1),
                                         (1, 1))):
                                    a4y[:, k, j] = av4y_full[
                                        np.where(valid, 4 * byp +
                                                 2 * dy8 + dyq, 0),
                                        np.where(valid, 4 * bxp +
                                                 2 * dx8 + dxq, 0)] \
                                        & valid[:, None]
                        av8s.append(a8)
                        av4cs.append(a4)
                        if a4y is not None:
                            av4ys.append(a4y)
        self.sb_bx = jnp.asarray(np.stack(bxs))
        self.sb_by = jnp.asarray(np.stack(bys))
        self.sb_avy = jnp.asarray(np.stack(avys))
        self.sb_avc = jnp.asarray(np.stack(avcs))
        self.sb_av8 = jnp.asarray(np.stack(av8s)) if av8_full is not None \
            else None
        self.sb_av4c = jnp.asarray(np.stack(av4cs)) \
            if av8_full is not None else None
        self.sb_av4y = jnp.asarray(np.stack(av4ys)) if av4ys else None

    def _qp_maps(self, qp):
        """(luma, cb, cr) per-16-BLOCK QP maps from a scalar or a
        (nCtuY, nCtuX) array.  Expanded here (not in the jitted bodies)
        so partial edge CTUs can't skew a blocks-per-CTU guess — the
        old ceil-div inference broke at CTU64 on non-multiple widths."""
        if np.isscalar(qp):
            qy = np.full((self.nby, self.nbx), qp, np.int32)
        else:
            qc = np.asarray(qp, np.int32)
            bpc = self.bpc
            qy = np.repeat(np.repeat(qc, bpc, 0), bpc, 1)[
                :self.nby, :self.nbx]
        if self.csp == 1:
            tab = CHROMA_QP_TABLE
            qcb = tab[np.clip(qy + self.cb_qp_offset, 0, 69)]
            qcr = tab[np.clip(qy + self.cr_qp_offset, 0, 69)]
        else:                        # 4:4:4: qPi clipped, no remap
            qcb = np.clip(qy + self.cb_qp_offset, 0, 51)
            qcr = np.clip(qy + self.cr_qp_offset, 0, 51)
        return (jnp.asarray(qy), jnp.asarray(qcb.astype(np.int32)),
                jnp.asarray(qcr.astype(np.int32)))

    def run_tree(self, y, u, v, modes, split32, mode32, qp=32,
                 split_map=None, modes8=None, materialize: bool = True,
                 init_type: int = 2, cand=None):
        """Intra variable-CU-tree reconstruction: 32x32 CUs (TU32 luma /
        TU16 chroma) where split32 is False, the 16-grid (with optional
        NxN sub-splits) elsewhere.  Arguments mirror run()."""
        assert self.tree
        qp_map = self._qp_maps(qp)
        nl, nc = self.nl, self.nc
        w, h = self.sps.width, self.sps.height
        wc, hc = w // 2, h // 2
        yp = jnp.zeros((h + 32, w), jnp.int32)
        up = jnp.zeros((hc + 16, wc), jnp.int32)
        vp = jnp.zeros((hc + 16, wc), jnp.int32)
        lev_y = jnp.zeros((self.nby + 1, self.nbx, nl, nl), jnp.int32)
        lev_u = jnp.zeros((self.nby + 1, self.nbx, nc, nc), jnp.int32)
        lev_v = jnp.zeros((self.nby + 1, self.nbx, nc, nc), jnp.int32)
        from .planes import dev_i32
        oy = dev_i32(y)
        ou = dev_i32(u)
        ov = dev_i32(v)
        sm = m8j = None
        if split_map is not None:
            sm = jnp.concatenate(
                [jnp.asarray(np.asarray(split_map, bool)),
                 jnp.zeros((1, self.nbx), bool)], axis=0)
            m8j = jnp.asarray(np.asarray(modes8, np.int32))
        c16 = cb16 = None
        if cand is not None and split_map is None:
            c16 = jnp.asarray(np.asarray(cand[0], np.int32))
            cb16 = jnp.asarray(np.asarray(cand[1], np.float32))
        yp, up, vp, lev_y, lev_u, lev_v, m_map = _wavefront_tree_run(
            yp, up, vp, lev_y, lev_u, lev_v, oy, ou, ov,
            jnp.asarray(np.asarray(modes, np.int32)),
            self.t_bx, self.t_by, self.t_avy, self.t_avc,
            self.t_px, self.t_py, self.t_valid, self.t_ravy, self.t_ravc,
            jnp.asarray(np.asarray(split32, bool)),
            jnp.asarray(np.asarray(mode32, np.int32)),
            qp_map[0], qp_map[1], qp_map[2], self.bd,
            self.sign_hide, self.rdoq, self.mats, self.mats32,
            sm, m8j,
            self.t_av8 if split_map is not None else None,
            self.t_av4c if split_map is not None else None,
            bool(getattr(self.sps, "strong_intra_smoothing", True)),
            jnp.int32(init_type), self.psy_rdoq, c16, cb16)
        rd = {"recon_y": yp[:h], "recon_u": up[:hc], "recon_v": vp[:hc],
              "lev_y": lev_y[:self.nby], "lev_u": lev_u[:self.nby],
              "lev_v": lev_v[:self.nby]}
        if c16 is not None:
            rd["modes_sel"] = m_map[:self.nby]
        return self.materialize(rd) if materialize else rd

    def run(self, y: np.ndarray, u: np.ndarray, v: np.ndarray,
            modes: np.ndarray, mc_pred=None, inter_mask=None,
            qp=32, materialize: bool = True, split_map=None,
            modes8=None, init_type: int = 2, tu4_map=None, cand=None,
            nr=None, ebits=None):
        """y/u/v: source planes (h, w) uint8/int; modes: (nby, nbx) int32
        luma modes (chroma uses DM); mc_pred: optional (mc_y, mc_u, mc_v)
        inter predictions (nby, nbx, N, N); inter_mask: (nby, nbx) bool.
        Returns dict of recon planes and level arrays."""
        qp_map = self._qp_maps(qp)
        nl, nc = self.nl, self.nc
        w, h = self.sps.width, self.sps.height
        wc = w >> self.cshift
        hc = h if self.is422 else h >> self.cshift
        # 4:2:2: chroma stores live on a row-doubled 8x8 block grid
        nbc = 2 * self.nby if self.is422 else self.nby
        cdump = 2 if self.is422 else 1
        yp = jnp.zeros((h + nl, w), jnp.int32)
        up = jnp.zeros((hc + cdump * nc, wc), jnp.int32)
        vp = jnp.zeros((hc + cdump * nc, wc), jnp.int32)
        lev_y = jnp.zeros((self.nby + 1, self.nbx, nl, nl), jnp.int32)
        lev_u = jnp.zeros((nbc + cdump, self.nbx, nc, nc), jnp.int32)
        lev_v = jnp.zeros((nbc + cdump, self.nbx, nc, nc), jnp.int32)
        from .planes import dev_i32
        oy = dev_i32(y)
        ou = dev_i32(u)
        ov = dev_i32(v)
        modes_j = jnp.asarray(modes.astype(np.int32))

        def padb(a, k=1):                 # add dump block row(s)
            return jnp.concatenate(
                [a, jnp.zeros((k,) + a.shape[1:], a.dtype)], axis=0)

        def chroma_blocks(a):
            """(nby, nbx, 16, 8) 4:2:2 chroma preds -> row-doubled
            (2*nby + 2, nbx, 8, 8) block store."""
            a = jnp.asarray(a)
            t = a.reshape(self.nby, self.nbx, 2, nc, nc) \
                .transpose(0, 2, 1, 3, 4) \
                .reshape(2 * self.nby, self.nbx, nc, nc)
            return padb(t, 2)

        imask_c = None
        if mc_pred is None:
            mc_y = jnp.zeros((self.nby + 1, self.nbx, nl, nl), jnp.int32)
            mc_u = jnp.zeros((nbc + cdump, self.nbx, nc, nc), jnp.int32)
            mc_v = jnp.zeros((nbc + cdump, self.nbx, nc, nc), jnp.int32)
            imask = jnp.zeros((self.nby + 1, self.nbx), bool)
            if self.is422:
                imask_c = jnp.zeros((nbc + cdump, self.nbx), bool)
        else:
            mc_y = padb(jnp.asarray(mc_pred[0]))
            imask = padb(jnp.asarray(inter_mask))
            if self.is422:
                mc_u = chroma_blocks(mc_pred[1])
                mc_v = chroma_blocks(mc_pred[2])
                imask_c = padb(jnp.repeat(jnp.asarray(inter_mask), 2,
                                          axis=0), 2)
            else:
                mc_u = padb(jnp.asarray(mc_pred[1]))
                mc_v = padb(jnp.asarray(mc_pred[2]))

        sm = m8j = t4j = None
        if split_map is not None:
            sm = padb(jnp.asarray(np.asarray(split_map, bool)))
            m8j = jnp.asarray(np.asarray(modes8, np.int32))
            if tu4_map is not None and self.tu4:
                t4j = jnp.asarray(np.asarray(tu4_map, bool))
        c16 = cb16 = None
        if cand is not None and split_map is None and not self.lossless:
            c16 = jnp.asarray(np.asarray(cand[0], np.int32))
            cb16 = jnp.asarray(np.asarray(cand[1], np.float32))
        nr_y = nr_c = None
        if nr is not None and not self.is422 and self.cshift == 1 \
                and not self.lossless:
            # (2, 256) / (2, 64) int32 [intra, inter] offsets
            nr_y = jnp.asarray(np.asarray(nr[0], np.int32))
            nr_c = jnp.asarray(np.asarray(nr[1], np.int32))
        wf_out = _wavefront_run(
            yp, up, vp, lev_y, lev_u, lev_v, oy, ou, ov, modes_j,
            self.sb_bx, self.sb_by, self.sb_avy, self.sb_avc,
            mc_y, mc_u, mc_v, imask,
            qp_map[0], qp_map[1], qp_map[2], self.bd,
            self.sign_hide, self.rdoq, self.mats, sm, m8j,
            self.sb_av8 if split_map is not None else None,
            self.sb_av4c if split_map is not None else None,
            self.lossless, jnp.int32(init_type), self.psy256,
            self.psy_rdoq, t4j,
            self.sb_av4y if t4j is not None else None,
            4 - self.cshift, self.cshift == 0, self.is422, imask_c,
            c16, cb16, nr_y, nr_c,
            None if ebits is None else
            jnp.asarray(np.asarray(ebits, np.float32)))
        yp, up, vp, lev_y, lev_u, lev_v, m_map = wf_out[:7]
        nr_stats = wf_out[7] if nr_y is not None else None

        if not materialize:
            # device handles only — JAX async dispatch means the caller
            # can enqueue the NEXT frame's work before forcing these
            # (the device/host pipeline lever, SURVEY.md §7)
            out = {"recon_y": yp[:h], "recon_u": up[:hc],
                   "recon_v": vp[:hc], "lev_y": lev_y[:self.nby],
                   "lev_u": lev_u[:nbc], "lev_v": lev_v[:nbc]}
            if c16 is not None:
                out["modes_sel"] = m_map[:self.nby]
            if nr_stats is not None:
                out["nr_stats"] = nr_stats
            return out
        dt = np.uint8 if self.bd == 8 else np.uint16
        out = {
            "recon_y": np.asarray(yp[:h]).astype(dt),
            "recon_u": np.asarray(up[:hc]).astype(dt),
            "recon_v": np.asarray(vp[:hc]).astype(dt),
            "lev_y": np.asarray(lev_y[:self.nby]),
            "lev_u": np.asarray(lev_u[:nbc]),
            "lev_v": np.asarray(lev_v[:nbc]),
        }
        if c16 is not None:
            out["modes_sel"] = np.asarray(m_map[:self.nby])
        if nr_stats is not None:
            out["nr_stats"] = tuple(np.asarray(a) for a in nr_stats)
        return out

    def materialize(self, rd: dict) -> dict:
        dt = np.uint8 if self.bd == 8 else np.uint16
        out = {
            "recon_y": np.asarray(rd["recon_y"]).astype(dt),
            "recon_u": np.asarray(rd["recon_u"]).astype(dt),
            "recon_v": np.asarray(rd["recon_v"]).astype(dt),
            "lev_y": np.asarray(rd["lev_y"]),
            "lev_u": np.asarray(rd["lev_u"]),
            "lev_v": np.asarray(rd["lev_v"]),
        }
        if "modes_sel" in rd:
            out["modes_sel"] = np.asarray(rd["modes_sel"])
        return out

    def run_batch(self, ys, us, vs, modes, qp=32, materialize: bool = True):
        """Intra-reconstruct F frames in one fused multi-frame program.

        ys/us/vs: (F, h, w) source stacks; modes: (F, nby, nbx) int32
        (numpy or device array).  Returns a list of per-frame result
        dicts (same keys as run()), or device stacks when
        materialize=False."""
        qp_map = self._qp_maps(qp)
        nl, nc = self.nl, self.nc
        w, h = self.sps.width, self.sps.height
        wc, hc = w >> self.cshift, h >> self.cshift
        f = ys.shape[0]
        yp = jnp.zeros((f, h + nl, w), jnp.int32)
        up = jnp.zeros((f, hc + nc, wc), jnp.int32)
        vp = jnp.zeros((f, hc + nc, wc), jnp.int32)
        lev_y = jnp.zeros((f, self.nby + 1, self.nbx, nl, nl), jnp.int32)
        lev_u = jnp.zeros((f, self.nby + 1, self.nbx, nc, nc), jnp.int32)
        lev_v = jnp.zeros((f, self.nby + 1, self.nbx, nc, nc), jnp.int32)
        mc_y = jnp.zeros((f, self.nby + 1, self.nbx, nl, nl), jnp.int32)
        mc_u = jnp.zeros((f, self.nby + 1, self.nbx, nc, nc), jnp.int32)
        mc_v = jnp.zeros((f, self.nby + 1, self.nbx, nc, nc), jnp.int32)
        imask = jnp.zeros((f, self.nby + 1, self.nbx), bool)

        yp, up, vp, lev_y, lev_u, lev_v = _wavefront_run_multi(
            yp, up, vp, lev_y, lev_u, lev_v,
            jnp.asarray(ys).astype(jnp.int32),
            jnp.asarray(us).astype(jnp.int32),
            jnp.asarray(vs).astype(jnp.int32),
            jnp.asarray(modes).astype(jnp.int32),
            self.sb_bx, self.sb_by, self.sb_avy, self.sb_avc,
            mc_y, mc_u, mc_v, imask,
            qp_map[0], qp_map[1], qp_map[2], jnp.int32(2), self.bd,
            self.sign_hide, self.rdoq, self.mats, self.psy_rdoq,
            4 - self.cshift, self.cshift == 0)

        if not materialize:
            # device handles only — the batched pipeline materializes a
            # whole batch later, overlapping host entropy of the previous
            # batch with this batch's device execution
            return {"recon_y": yp, "recon_u": up, "recon_v": vp,
                    "lev_y": lev_y, "lev_u": lev_u, "lev_v": lev_v}
        return self.materialize_batch(self.pack_batch(
            {"recon_y": yp, "recon_u": up, "recon_v": vp,
             "lev_y": lev_y, "lev_u": lev_u, "lev_v": lev_v}))

    def pack_batch(self, rd) -> dict:
        """Device-side dtype packing before the host fetch: recon to the
        pixel width, levels to int16 (4x/2x fewer bytes over the
        RPC-attached chip's link, which dominates the batched pipeline's
        host time), then start async device->host copies so the
        transfers overlap the previous batch's entropy coding."""
        dt = jnp.uint8 if self.bd == 8 else jnp.uint16
        out = {k: (rd[k].astype(dt) if k.startswith("recon")
                   else rd[k].astype(jnp.int16)) for k in rd}
        for a in out.values():
            try:
                a.copy_to_host_async()
            except Exception:       # backend without async copies
                break
        return out

    def materialize_batch(self, rd) -> list:
        """Pull a (packed) run_batch(materialize=False) result to the
        host and split it into per-frame dicts (same keys as run())."""
        h = self.sps.height
        hc = h // 2
        dt = np.uint8 if self.bd == 8 else np.uint16
        yp = np.asarray(rd["recon_y"])
        up = np.asarray(rd["recon_u"])
        vp = np.asarray(rd["recon_v"])
        lev_y = np.asarray(rd["lev_y"])
        lev_u = np.asarray(rd["lev_u"])
        lev_v = np.asarray(rd["lev_v"])
        return [{
            "recon_y": yp[i, :h].astype(dt, copy=False),
            "recon_u": up[i, :hc].astype(dt, copy=False),
            "recon_v": vp[i, :hc].astype(dt, copy=False),
            "lev_y": lev_y[i, :self.nby],
            "lev_u": lev_u[i, :self.nby],
            "lev_v": lev_v[i, :self.nby],
        } for i in range(yp.shape[0])]
