"""P-frame analysis: batched ME + inter/intra decision + MC prediction.

Batched replacement of the reference's per-CU compressInterCU_rd0_4
(x265 source/encoder/analysis.cpp:1663): every block of the frame runs
full-search ME, subpel refinement, a neighbor-MV coherence pass (the
batched stand-in for merge estimation, reference analysis.cpp:3485
checkMerge2Nx2N), and an inter-vs-intra SATD decision — all as dense
tensor ops.  The recon wavefront then consumes the per-block decisions.
"""
from __future__ import annotations

import math
from typing import Tuple

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.me import full_search_batch, subpel_refine_batch, mv_bits
from ..ops.interp import bi_combine, mc_batch, mc_batch_14
from ..ops.cost import satd_batch
from .intra_mode import _mode_costs
from ..frame.zscan import frame_avail_masks


def lambda_qp(qp: int) -> Tuple[float, float]:
    """(lambda, lambda2) — SAD/SATD and SSE lambdas (reference
    constants.cpp:34 x265_lambda_tab / x265_lambda2_tab derivation)."""
    lam2 = 0.85 * (2.0 ** ((qp - 12) / 3.0))
    return math.sqrt(lam2), lam2


def _neigh_field(f2d, sy: int, sx: int):
    """Coding-order neighbor gather on a (nby, nbx) block field:
    out[y, x] = f2d[y - sy, x - sx], plus a validity mask for in-frame
    positions.  The batched stand-in for CUData neighbor walks."""
    nby, nbx = f2d.shape[:2]
    s = jnp.roll(f2d, (sy, sx), (0, 1))
    ys = jnp.arange(nby)[:, None]
    xs = jnp.arange(nbx)[None, :]
    iy = ys - sy
    ix = xs - sx
    ok = (iy >= 0) & (iy < nby) & (ix >= 0) & (ix < nbx)
    return s, ok


def _chain(dep, *vals):
    """Thread a scheduling dependency through optimization_barrier so
    unrolled per-reference loop iterations cannot be interleaved by the
    XLA scheduler.  Without it the 4K P/B cores measured ~8 GiB of HLO
    temps: every ref's search windows / MC gathers were scheduled
    concurrently.  Returns vals (semantically unchanged)."""
    if dep is None:
        return vals if len(vals) > 1 else vals[0]
    out = jax.lax.optimization_barrier((dep,) + tuple(vals))
    return out[1:] if len(vals) > 1 else out[1]


def _stack_refs(planes, m: int):
    """Stack reference planes vertically with per-plane edge padding of
    `m` rows, so one MC gather serves per-block reference indices:
    block at (bx, by) on ref r reads the tall plane at
    y = by + r*strip + m.  Clamped out-of-window reads stay inside the
    ref's own padded strip for |mv_y| <= 4*(m - taps)."""
    padded = [jnp.pad(p, ((m, m), (0, 0)), mode="edge") for p in planes]
    tall = jnp.concatenate(padded, axis=0)
    strip = padded[0].shape[0]
    return tall, strip


def _scale_mv_np(mvx, mvy, tb: int, td):
    """Vectorized POC-distance MV scaling (spec 8.5.3.2.8; the batched
    form of entropy.mv_pred._scale_mv, kept numerically identical so an
    analysis-adopted temporal candidate matches the syntax encoder's
    derived merge candidate exactly)."""
    td = np.asarray(td, np.int64)
    same = td == tb
    tds = np.where(td == 0, 1, td)
    num = 16384 + (np.abs(tds) >> 1)
    tx = np.where(tds < 0, -(num // -tds), num // tds)
    dsf = np.clip((tb * tx + 32) >> 6, -4096, 4095)
    out = []
    for c in (np.asarray(mvx, np.int64), np.asarray(mvy, np.int64)):
        v = dsf * c
        s = (np.abs(v) + 127) >> 8
        out.append(np.clip(np.where(v < 0, -s, s), -32768, 32767))
    return (np.where(same, mvx, out[0]).astype(np.int32),
            np.where(same, mvy, out[1]).astype(np.int32))


def temporal_merge_field(col, nby: int, nbx: int, n: int, pic_w: int,
                         pic_h: int, log2_ctu: int, lst: int,
                         target_poc: int, cur_poc: int,
                         low_delay: bool):
    """Per-block temporal merge candidate for list `lst` over the whole
    (nby, nbx) grid of n-pel blocks — the batched analog of
    entropy.mv_pred.temporal_candidate (spec 8.5.3.2.8): bottom-right
    col block C0 (same CTU row only), center C1 fallback, listCol
    selection per 8.5.3.2.9, POC-distance scaling.  Returns
    (valid (nby,nbx) bool, mvx, mvy int32)."""
    bys, bxs = np.mgrid[0:nby, 0:nbx]
    x0 = bxs * n
    y0 = bys * n
    val = np.zeros((nby, nbx), bool)
    omx = np.zeros((nby, nbx), np.int32)
    omy = np.zeros((nby, nbx), np.int32)
    ch, cw = col.dir.shape
    tb = cur_poc - target_poc
    for i, (xc, yc) in enumerate(((x0 + n, y0 + n),
                                  (x0 + (n >> 1), y0 + (n >> 1)))):
        ok = (xc < pic_w) & (yc < pic_h)
        if i == 0:
            ok &= (yc >> log2_ctu) == (y0 >> log2_ctu)
        cby = np.clip(yc >> 4, 0, ch - 1)
        cbx = np.clip(xc >> 4, 0, cw - 1)
        d = col.dir[cby, cbx]
        ok &= d != 0
        if low_delay:
            bi_l = lst
        else:
            bi_l = 1 if col.from_l0 else 0
        l = np.where(d == 1, 0, np.where(d == 2, 1, bi_l))
        rp = col.ref_poc[cby, cbx]                 # (nby, nbx, 2)
        crf = np.where(l == 0, rp[..., 0], rp[..., 1])
        td = col.poc - crf
        ok &= td != 0
        mv = col.mv[cby, cbx]                      # (nby, nbx, 2, 2)
        mvx = np.where(l == 0, mv[..., 0, 0], mv[..., 1, 0])
        mvy = np.where(l == 0, mv[..., 0, 1], mv[..., 1, 1])
        smx, smy = _scale_mv_np(mvx, mvy, tb, td)
        newly = ok & ~val
        omx = np.where(newly, smx, omx)
        omy = np.where(newly, smy, omy)
        val |= ok
    return val, omx, omy


def _rd_resid_cost(org, pred, qp_b, log2n: int, bd: int, lam2):
    """Transform-domain RD of one motion option's luma residual (the
    encodeResAndCalcRdInterCU / rd-skip arbitration of x265
    analysis.cpp:3485 checkMerge2Nx2N, collapsed to one TU): returns
    (coded_cost_sans_syntax, zero_residual_sse) per block.  Uses the
    same linear luma rate model as the wavefront's zero-residual test
    (frame/recon_intra.py) so analysis and recon agree on when a
    residual is worth coding."""
    from ..ops.transform import (dct_batch, quant_dyn, dequant_dyn,
                                 idct_batch)
    imask = jnp.zeros(org.shape[:1], bool)
    coef = dct_batch(org - pred, log2n, bd)
    lev = quant_dyn(coef, imask, qp_b, log2n, bd)
    deq = dequant_dyn(lev, qp_b, log2n, bd)
    rec = jnp.clip(pred + idct_batch(deq, log2n, bd), 0, (1 << bd) - 1)
    sse_c = jnp.sum((org - rec).astype(jnp.float32) ** 2, (1, 2))
    sse_z = jnp.sum((org - pred).astype(jnp.float32) ** 2, (1, 2))
    nz = jnp.sum(lev != 0, (1, 2)).astype(jnp.float32)
    # density-calibrated rate: sparse TBs cost ~8 bits/coeff (full
    # last_sig_pos + CG map amortized over few levels — what the
    # EstBitsSbac structural estimate measures, ops/rdoq.py
    # tb_bits_est), decaying toward the dense-TB ~4.5 bits/coeff the
    # old flat model assumed.  Undercharging sparse residuals made
    # coded AMVP candidates beat zero-residual merges too often
    # (BENCH_NOTES round-4: MV_RES/B +487 bits, skip rate 72% vs
    # x265's 84%).
    bits = (10.0 + 8.0 * jnp.minimum(nz, 4.0)
            + 6.0 * jnp.clip(nz - 4.0, 0.0, 12.0)
            + 4.5 * jnp.maximum(nz - 16.0, 0.0))
    bits = jnp.where(nz > 0, bits, 0.0)
    return sse_c + lam2 * bits, sse_z

WINDOW_NBY_LIMIT = 32     # block rows per banded analysis dispatch:
                          # the 4K cores measured 6.5 (P) / 13 (B) GiB
                          # of HLO temps whole-frame (tools/mem_probe);
                          # sequential row bands cap the working set
                          # like the reference's CTU-row processing
                          # (frameencoder.cpp:1638)


def _analysis_bands(sps, block: int, search_range: int):
    """None (whole-frame fits), or a list of
    (r0, r1, halo_top_rows, halo_bot_rows) block-row bands."""
    nby = sps.height // block
    nbx = sps.width // block
    if nby * nbx <= 9000:        # 1080p (8040 blocks) stays one dispatch
        return None
    halo = -(-(search_range + 24) // block) + 1
    per = max(4, (WINDOW_NBY_LIMIT - 2 * halo) & ~3)
    bands = []
    r0 = 0
    while r0 < nby:
        r1 = min(nby, r0 + per)
        bands.append((r0, r1, min(halo, r0), min(halo, nby - r1)))
        r0 = r1
    return bands


def _banded_analysis(fn, bands, sps, block, plane_args, col_field,
                     grid_outs, **kw):
    """Run `fn` per row band on device-sliced planes and concatenate
    the block-grid outputs.  plane_args: dict name -> (plane | list of
    (y,u,v) tuples).  col_field: precomputed full-frame TMVP tuple of
    (nby, nbx)-shaped arrays, or None.  grid_outs: indices of outputs
    whose leading axis is block rows (all of them, here).  Band edges
    clamp reads beyond the halo (decision-only effect — entropy derives
    the true spec candidates; the encode stays bit-exact by
    construction)."""
    import dataclasses
    from ..frame.planes import dev_i32
    idc = getattr(sps, "chroma_format_idc", 1)
    cs_y = 1 if idc == 1 else 0

    def dev_planes(t):
        return (dev_i32(t[0]), dev_i32(t[1]), dev_i32(t[2]))

    devved = {}
    for name, val in plane_args.items():
        if isinstance(val, list):
            devved[name] = [dev_planes(t) for t in val]
        else:
            devved[name] = dev_planes(val)
    outs = None
    for (r0, r1, ht, hb) in bands:
        y0 = (r0 - ht) * block
        y1 = (r1 + hb) * block
        sl = slice(y0, y1)
        csl = slice(y0 >> cs_y, y1 >> cs_y)

        def cut(t):
            return (t[0][sl], t[1][csl], t[2][csl])

        args = {}
        for name, val in devved.items():
            args[name] = [cut(t) for t in val] if isinstance(val, list) \
                else cut(val)
        sub_sps = dataclasses.replace(sps, height=y1 - y0)
        tm = None
        if col_field is not None:
            tm = tuple(a[r0 - ht:r1 + hb] for a in col_field)
        got = fn(sub_sps, args, tm)
        got = [o[ht:ht + (r1 - r0)] if i in grid_outs else o
               for i, o in enumerate(got)]
        if outs is None:
            outs = [[o] for o in got]
        else:
            for acc, o in zip(outs, got):
                acc.append(o)
    join = []
    for i, acc in enumerate(outs):
        if len(acc) == 1:
            join.append(acc[0])
        elif isinstance(acc[0], jnp.ndarray):
            join.append(jnp.concatenate(acc, 0))
        else:
            join.append(np.concatenate(acc, 0))
    return join


def analyse_p_frame(y, u, v, refs, sps, qp: int,
                    search_range: int = 16, block: int = 16,
                    weights=None, subme: int = 2, rect: bool = False,
                    amp: bool = False, chroma_weights=None,
                    me_sea: bool = False, col=None, ref_pocs=None,
                    cur_poc: int = 0, pad_refs: int = 0,
                    hme: bool = False, rounds=(2, 1),
                    _tmvp_field=None):
    """Multi-reference P analysis (reference predInterSearch's per-ref
    loop, search.cpp:2554, batched).

    refs: list of (ref_y, ref_u, ref_v) tuples, L0 order (closest first).
    weights: optional per-ref luma (w, o) explicit-weight pairs (denom 6)
    or None entries — ME searches a pre-weighted plane, final luma MC
    applies the exact 14-bit weighting (spec 8.5.4.3.2).
    Returns (intra_modes (nby,nbx), inter_mask (nby,nbx) bool,
    mvs (nby,nbx,2) qpel, ref_sel (nby,nbx) int32,
    (mc_y, mc_u, mc_v) per-block predictions).

    The whole analysis is ONE jitted program (a single device dispatch
    instead of ~30 per frame in the unfused form); frames beyond ~1080p
    run as sequential row-band dispatches (see WINDOW_NBY_LIMIT)."""
    bands = None if _tmvp_field is not None \
        else _analysis_bands(sps, block, search_range)
    if bands is not None:
        field = None
        if col is not None and ref_pocs is not None and ref_pocs[0]:
            low_delay = all(rp <= cur_poc for lst_p in ref_pocs
                            for rp in lst_p)
            tval, tmx, tmy = temporal_merge_field(
                col, sps.height // block, sps.width // block, block,
                sps.width, sps.height, sps.log2_ctu_size, 0,
                ref_pocs[0][0], cur_poc, low_delay)
            field = (np.asarray(tval), np.asarray(tmx),
                     np.asarray(tmy))

        def run(sub_sps, args, tm):
            out = analyse_p_frame(
                args["cur"][0], args["cur"][1], args["cur"][2],
                args["refs"], sub_sps, qp, search_range=search_range,
                block=block, weights=weights, subme=subme, rect=rect,
                amp=amp, chroma_weights=chroma_weights, me_sea=me_sea,
                col=None, ref_pocs=ref_pocs, cur_poc=cur_poc,
                pad_refs=pad_refs, hme=hme, rounds=rounds,
                _tmvp_field=tm if tm is not None else ())
            return list(out[:4]) + list(out[4]) + list(out[5:])

        o = _banded_analysis(run, bands, sps, block,
                             {"cur": (y, u, v), "refs": list(refs)},
                             field, grid_outs=set(range(9)))
        return (o[0], o[1], o[2], o[3], (o[4], o[5], o[6]), o[7], o[8])
    bd = sps.bit_depth
    if weights is None:
        weights = [None] * len(refs)
    if chroma_weights is None:
        chroma_weights = [None] * len(refs)
    n_real = len(refs)
    if pad_refs > n_real:
        # pad the ref stack to a FIXED lane count (repeat the last
        # ref): the DPB fills 1->2->..->max_refs over the first GOPs
        # and each distinct count would compile its own _p_core — a
        # large program.  Padded lanes are
        # masked out of the provisional (ref, mv) pick inside the
        # core, so decisions and streams are unchanged.
        refs = list(refs) + [refs[-1]] * (pad_refs - n_real)
        weights = list(weights) + [None] * (pad_refs - n_real)
        chroma_weights = (list(chroma_weights)
                          + [None] * (pad_refs - n_real))
    wpat = tuple(wp is not None for wp in weights)
    cpat = tuple(cw is not None for cw in chroma_weights)
    wq = jnp.asarray([wp[0] if wp else 64 for wp in weights], jnp.int32)
    wo = jnp.asarray([wp[1] if wp else 0 for wp in weights], jnp.int32)
    wc = jnp.asarray([[cw[0][0], cw[0][1], cw[1][0], cw[1][1]]
                      if cw else [64, 0, 64, 0]
                      for cw in chroma_weights], jnp.int32)
    from ..frame.planes import dev_i32
    oy = dev_i32(y)
    rys = jnp.stack([dev_i32(r[0]) for r in refs])
    rus = jnp.stack([dev_i32(r[1]) for r in refs])
    rvs = jnp.stack([dev_i32(r[2]) for r in refs])
    avail = frame_avail_masks(sps.width, sps.height, block,
                              sps.log2_ctu_size, 0)
    lam, _ = lambda_qp(qp)
    lam256 = int(round(lam * 256)) << (bd - 8)
    # rect PUs search on unweighted planes only (weightP fires on fades
    # where rect rarely helps; keeps the weighted 14-bit path simple)
    rect_eff = rect and not any(wpat) and block == 16
    amp_eff = amp and rect_eff
    idc = getattr(sps, "chroma_format_idc", 1)
    cshift = 0 if idc == 3 else 1
    tmvp = None
    if _tmvp_field is not None:
        # banded call: the full-frame TMVP field was derived once and
        # row-sliced by the band driver ((): band with no TMVP)
        if len(_tmvp_field):
            tmvp = tuple(jnp.asarray(a) for a in _tmvp_field)
    elif col is not None and ref_pocs is not None and ref_pocs[0]:
        # per-block temporal merge candidate (TMVP, targeting L0 ref 0
        # as the spec merge derivation does): x265's merge estimation
        # sees this candidate via the real list (search.cpp:2237); the
        # batched analysis proposes it explicitly so static/consistent
        # motion rides merge/skip instead of paying AMVP syntax
        low_delay = all(rp <= cur_poc for lst_p in ref_pocs
                        for rp in lst_p)
        tval, tmx, tmy = temporal_merge_field(
            col, y.shape[0] // block, y.shape[1] // block, block,
            sps.width, sps.height, sps.log2_ctu_size, 0,
            ref_pocs[0][0], cur_poc, low_delay)
        tmvp = (jnp.asarray(tval), jnp.asarray(tmx), jnp.asarray(tmy))
    out = _p_core(oy, rys, rus, rvs, wq, wo,
                  jnp.asarray(avail.reshape(-1, avail.shape[-1])),
                  jnp.int32(lam256), jnp.int32(qp), wpat,
                  search_range, block, bd,
                  sps.log2_ctu_size, subme,
                  rect_eff,
                  amp_eff, wc=wc, cpat=cpat, cshift=cshift,
                  is422=idc == 2, me_sea=me_sea, tmvp=tmvp,
                  n_real=jnp.int32(n_real), hme=hme,
                  rounds=tuple(rounds))
    modes, inter, mvs, rsel, mcy, mcu, mcv, part, mvs_b = out
    # mc stays ON DEVICE: the wavefront re-uploads it otherwise
    # (~12 MB/frame at 1080p); consumers that
    # need host values (TU32 pre-pass, tests) np.asarray themselves
    return (np.asarray(modes), np.asarray(inter), np.asarray(mvs),
            np.asarray(rsel),
            (mcy, mcu, mcv),
            np.asarray(part), np.asarray(mvs_b))


@functools.partial(
    jax.jit, static_argnames=("wpat", "search_range", "block", "bd",
                              "log2_ctu", "subme", "rect",
                              "amp", "band", "cpat", "cshift",
                              "is422", "me_sea", "hme", "rounds"))
def _p_core(oy, rys, rus, rvs, wq, wo, avail, lam256, qp32, wpat,
            search_range: int, block: int, bd: int, log2_ctu: int,
            subme: int = 2, rect: bool = False,
            amp: bool = False, band=None, wc=None, cpat=None,
            cshift: int = 1, is422: bool = False,
            me_sea: bool = False, tmvp=None, n_real=None,
            hme: bool = False, rounds=(2, 1)):
    """band: None for a whole-frame call, else (axis_name, nby_total,
    halo_blocks, n_devices) — the planes are then per-device SLABS
    (band rows + halo_blocks block-rows of real neighbor pixels top
    and bottom, exchanged by the shard_map wrapper via ppermute), and
    the merge neighbor pass exchanges boundary MV rows between rounds
    (the collective analog of the reference's frame-parallel recon-row lag,
    frameencoder.h:213 m_refLagRows)."""
    h, w = oy.shape
    n = block
    nbx = w // n
    if band is None:
        hb = 0
        nby = h // n
        nby_total = nby
        gby0 = 0
        nd = 1
        axis = None
    else:
        axis, nby_total, hb, nd = band
        nby = h // n - 2 * hb          # analyzed band block-rows
        gby0 = jax.lax.axis_index(axis) * nby
    nb = nbx * nby
    nref = rys.shape[0]

    bys, bxs = np.mgrid[0:nby, 0:nbx]
    bx = jnp.asarray((bxs.ravel() * n).astype(np.int32))
    by = jnp.asarray(((bys.ravel() + hb) * n).astype(np.int32))
    from .weightp import weighted_plane_jnp
    weights = [(wq[i], wo[i]) if wpat[i] else None for i in range(nref)]
    ry_all = []
    for i in range(nref):
        ry = rys[i]
        if wpat[i]:
            ry = weighted_plane_jnp(ry, wq[i], wo[i], bit_depth=bd)
        ry_all.append(ry)
    refs = [(rys[i], rus[i], rvs[i]) for i in range(nref)]

    gy = by[:, None, None] + jnp.arange(n)[None, :, None]
    gx = bx[:, None, None] + jnp.arange(n)[None, None, :]
    org = oy[jnp.clip(gy, 0, h - 1), jnp.clip(gx, 0, w - 1)].astype(jnp.int32)

    # 1. per-ref full search + subpel (zero-pred regularized); recover
    # pure SATD by subtracting the exact bit charge the search applied
    cands = []
    pz = jnp.zeros(nb, jnp.int32)
    dep = None
    for ridx, ry in enumerate(ry_all):
        ry = _chain(dep, ry)
        ctr = None
        if hme and band is None and n == 16:
            ctr = _hme_center_fullres(ry, oy, nby, nbx, lam256,
                                      search_range)
        if me_sea:
            # SEA/ADS integral-pruned search (--me sea; ops/sea.py)
            from ..ops.sea import sea_search_batch
            imx, imy, _ = sea_search_batch(ry, oy, bx, by, pz, pz,
                                           lam256, n, search_range,
                                           k=64)
        else:
            imx, imy, _ = full_search_batch(
                ry, oy, bx, by, pz, pz, lam256, n, search_range,
                center_x=None if ctr is None else ctr[0],
                center_y=None if ctr is None else ctr[1])
        mvx, mvy, cost = subpel_refine_batch(ry, oy, bx, by, imx, imy,
                                             pz, pz, lam256, n, bd,
                                             subme)
        satd = cost - ((lam256 * mv_bits(mvx, mvy)) >> 8)
        cands.append((mvx, mvy, satd))
        dep = cost

    # provisional joint (ref, mv): SATD + zero-pred mvd + ref_idx bins
    satd_r = jnp.stack([c[2] for c in cands])         # (R, nb)
    mvx_r = jnp.stack([c[0] for c in cands])
    mvy_r = jnp.stack([c[1] for c in cands])
    prov = satd_r + ((lam256 * (mv_bits(mvx_r, mvy_r) +
                                jnp.arange(nref)[:, None] + 4)) >> 8)
    if n_real is not None:
        # padded ref lanes (see analyse_p_frame pad_refs) never win
        prov = jnp.where(jnp.arange(nref)[:, None] < n_real, prov,
                         1 << 30)
    ref_sel = jnp.argmin(prov, axis=0).astype(jnp.int32)
    mvx = jnp.take_along_axis(mvx_r, ref_sel[None], 0)[0]
    mvy = jnp.take_along_axis(mvy_r, ref_sel[None], 0)[0]
    satd_me = jnp.take_along_axis(satd_r, ref_sel[None], 0)[0]

    # 2. merge/AMVP-true candidate selection (batched mergeEstimation +
    # selectMVP analog, reference search.cpp:2237/2347): candidates are
    # the coding-order neighbors' (mv, ref) with merge_idx bin charges
    # vs the ME winner with real AMVP-predictor mvd charges.  Two
    # rounds so merge regions can grow along the coding order.
    # seeded MVs reach ~5*sr; the tall-strip pad must cover them so
    # candidate/region MC gathers stay inside the right ref's strip
    m_pad = (6 * search_range + 12) if hme else (search_range + 12)
    tall, strip = _stack_refs(ry_all, m_pad)
    me_mvx, me_mvy, me_ref = mvx, mvy, ref_sel

    def neigh2(f2d, sy: int, sx: int, ext=None, ext_down=None):
        """Band-aware coding-order neighbor gather: whole-frame calls
        use _neigh_field; banded calls read the up-neighbor's boundary
        row from `ext` (down-neighbor's from `ext_down`, both
        ppermute'd) and mask validity globally."""
        if band is None:
            return _neigh_field(f2d, sy, sx)
        if sy == 0:
            shifted = jnp.roll(f2d, sx, 1)
        elif sy > 0:
            shifted = jnp.roll(jnp.concatenate([ext, f2d], 0),
                               sx, 1)[:nby]
        else:
            shifted = jnp.roll(jnp.concatenate([f2d, ext_down], 0),
                               sx, 1)[1:nby + 1]
        ys = jnp.arange(nby)[:, None] + gby0
        xs = jnp.arange(nbx)[None, :]
        iy = ys - sy
        ix = xs - sx
        ok = (iy >= 0) & (iy < nby_total) & (ix >= 0) & (ix < nbx)
        return shifted, ok

    def boundary_ext(f2d):
        """Up-neighbor's last block-row (devices 1.. receive; device 0
        gets zeros, masked invalid by neigh2's global bounds)."""
        if band is None:
            return None
        return jax.lax.ppermute(f2d[-1:], axis,
                                [(i, i + 1) for i in range(nd - 1)])

    def boundary_ext_down(f2d):
        """Down-neighbor's first block-row (for the A0 bottom-left
        merge position; last device gets zeros, masked by bounds)."""
        if band is None:
            return None
        return jax.lax.ppermute(f2d[:1], axis,
                                [(i + 1, i) for i in range(nd - 1)])

    # S-vector availability indices of the spatial merge positions
    # (spec 8.5.3.2.3; frame_avail_masks layout — left column bottom-up,
    # corner, top row): A1=(x0-1,y0+n-1), A0=(x0-1,y0+n), B2=(x0-1,y0-1),
    # B1=(x0+n-1,y0-1), B0=(x0+n,y0-1).  The masks already encode the
    # exact in-frame + z-scan-coding-order test (zscan.py), so A0/B0
    # validity matches the syntax walk's motion_at() availability.
    AV_A1, AV_A0, AV_B2, AV_B1, AV_B0 = n, n - 1, 2 * n, 3 * n, 3 * n + 1

    # provisional intra/inter estimate per block: the syntax-time merge
    # list takes NO candidates from intra-coded neighbors (motion_at
    # returns None), so the batched mirror masks likely-intra donors
    # out of candidate validity (ADVICE r3: intra-area neighbors were
    # donating list slots the real list does not have)
    icosts = _mode_costs(oy, avail,
                         jnp.asarray(bxs.ravel().astype(np.int32)),
                         jnp.asarray((bys.ravel() + hb).astype(np.int32)),
                         n.bit_length() - 1, bd)
    intra_best = jnp.min(icosts, axis=1)
    intra_modes = jnp.argmin(icosts, axis=1).astype(jnp.int32)
    inter_est = (satd_me + ((lam256 * 4) >> 8)) <= \
        (intra_best + ((lam256 * 5) >> 8))

    def cand_round(mvx, mvy, rsel, rd: bool = False):
        f2x = mvx.reshape(nby, nbx)
        f2y = mvy.reshape(nby, nbx)
        f2r = rsel.reshape(nby, nbx)
        ext = (boundary_ext(f2x), boundary_ext(f2y), boundary_ext(f2r))
        extd = (boundary_ext_down(f2x), boundary_ext_down(f2y),
                boundary_ext_down(f2r))

        f2i = inter_est.reshape(nby, nbx)
        exti = boundary_ext(f2i)
        extdi = boundary_ext_down(f2i)

        def gat(sy, sx):
            return (neigh2(f2x, sy, sx, ext[0], extd[0])[0].ravel(),
                    neigh2(f2y, sy, sx, ext[1], extd[1])[0].ravel(),
                    jnp.clip(neigh2(f2r, sy, sx, ext[2],
                                    extd[2])[0].ravel(), 0, nref - 1))

        def gat_ie(sy, sx):
            return neigh2(f2i, sy, sx, exti, extdi)[0].ravel()

        # exact merge candidate derivation (spec 8.5.3.2.3, the batched
        # mirror of entropy.mv_pred.merge_candidates): spatial A1, B1,
        # B0, A0, B2 with availability from the z-scan S masks and the
        # spec's pairwise pruning, then TMVP, then the zero-fill entry
        # — each with its true LIST POSITION so candidates beyond
        # max_merge (3, top.py MAX_MERGE) are never proposed and the
        # merge_idx bin charge is exact.  This is what makes the
        # analysis-adopted motion actually MATCH the syntax encoder's
        # list membership test (x265 mergeEstimation, search.cpp:2237,
        # iterates the real list the same way).
        a1, b1, b0 = gat(0, 1), gat(1, 0), gat(1, -1)
        a0, b2 = gat(-1, 1), gat(1, 1)
        av2 = avail.reshape(nb, -1)
        v_a1 = av2[:, AV_A1] & gat_ie(0, 1)
        v_b1r = av2[:, AV_B1] & gat_ie(1, 0)
        v_b0r = av2[:, AV_B0] & gat_ie(1, -1)
        v_a0r = av2[:, AV_A0] & gat_ie(-1, 1)
        v_b2r = av2[:, AV_B2] & gat_ie(1, 1)
        eq = lambda c, d: ((c[0] == d[0]) & (c[1] == d[1]) &
                           (c[2] == d[2]))
        v_b1 = v_b1r & ~(v_a1 & eq(b1, a1))
        v_b0 = v_b0r & ~(v_b1r & eq(b0, b1))
        v_a0 = v_a0r & ~(v_a1 & eq(a0, a1))
        i32 = lambda b_: b_.astype(jnp.int32)
        n4 = i32(v_a1) + i32(v_b1) + i32(v_b0) + i32(v_a0)
        v_b2 = (v_b2r & (n4 < 4) & ~(v_a1 & eq(b2, a1))
                & ~(v_b1r & eq(b2, b1)))
        idx_a1 = jnp.zeros(nb, jnp.int32)
        idx_b1 = i32(v_a1)
        idx_b0 = idx_b1 + i32(v_b1)
        idx_a0 = idx_b0 + i32(v_b0)
        idx_b2 = idx_a0 + i32(v_a0)
        n_sp = idx_b2 + i32(v_b2)
        zz = jnp.zeros(nb, jnp.int32)
        if tmvp is not None:
            tval, tmx_, tmy_ = [a.reshape(-1) for a in tmvp]
            # vertical window guard: the stacked-ref gather only
            # edge-replicates within one strip's m_pad rows; a scaled
            # temporal MV beyond it would read the neighboring ref's
            # strip and corrupt the cost (decision-only, but reject)
            tval = tval & (jnp.abs(tmy_) <= 4 * (m_pad - 8))
        else:
            tval, tmx_, tmy_ = zz != 0, zz, zz
        v_t = tval & (n_sp < 3)
        idx_t = n_sp
        idx_z = n_sp + i32(v_t)
        v_z = idx_z < 3
        mcands = [(a1, v_a1, idx_a1), (b1, v_b1, idx_b1),
                  (b0, v_b0, idx_b0), (a0, v_a0, idx_a0),
                  (b2, v_b2, idx_b2),
                  ((tmx_, tmy_, zz), v_t, idx_t),
                  ((zz, zz, zz), v_z, idx_z)]

        # AMVP predictors ~ (A1, B1) neighbor MVs (zero when absent)
        p0x = jnp.where(v_a1, a1[0], 0)
        p0y = jnp.where(v_a1, a1[1], 0)
        p1x = jnp.where(v_b1r, b1[0], 0)
        p1y = jnp.where(v_b1r, b1[1], 0)
        mvd_bits_best = jnp.minimum(mv_bits(me_mvx - p0x, me_mvy - p0y),
                                    mv_bits(me_mvx - p1x, me_mvy - p1y))
        # merge_flag=0 + mvp_idx + part/pred bins + ref_idx TR bins
        cost_me = satd_me + ((lam256 * (mvd_bits_best + 3 + me_ref)) >> 8)
        best_cost = cost_me
        best_x, best_y, best_r = me_mvx, me_mvy, me_ref
        if rd:
            # final round decides with transform-domain RD instead of
            # SATD (x265 checkMerge2Nx2N + encodeResAndCalcRdSkipCU,
            # analysis.cpp:3485): a unique AMVP mv whose residual
            # quantizes to ~zero pays mvd+ref+mvp syntax for nothing —
            # a coding-order neighbor's mv rides merge/skip for 2-4
            # bins.  The satd rounds can't see this because the rate
            # difference is small in satd units while the RATE share
            # of a zero-residual CU's cost is total.
            lam2 = (lam256.astype(jnp.float32) / 256.0) ** 2
            qp_b = jnp.broadcast_to(qp32, (nb,))
            pr_me = mc_batch(tall, bx, by + me_ref * strip + m_pad,
                             me_mvx, me_mvy, n, 0, bd)
            cc, sz = _rd_resid_cost(org, pr_me, qp_b,
                                    n.bit_length() - 1, bd, lam2)
            syn_me = (mvd_bits_best + 3 + me_ref).astype(jnp.float32)
            best_rd = jnp.minimum(cc + lam2 * syn_me,
                                  sz + lam2 * (syn_me + 1.0))
        # candidate evaluation as ONE vmapped batch (MC gather + SATD
        # + residual RD), argmin scan preserving the sequential loop's
        # first-minimum tie-breaking — see the B-side b_cand_round note
        cmx_s = jnp.stack([c[0][0] for c in mcands])
        cmy_s = jnp.stack([c[0][1] for c in mcands])
        crf_s = jnp.stack([c[0][2] for c in mcands])
        idx_s = jnp.stack([c[2] for c in mcands])
        ok_s = jnp.stack([c[1] for c in mcands]) & (idx_s < 3)
        # merge_idx TR bins at the candidate's true list position
        # (cmax = MAX_MERGE-1 = 2: idx0 -> 1 bin, idx1/2 -> 2)
        idxb_s = jnp.where(idx_s == 0, 1, 2)

        def eval_cand(cmx, cmy, crf):
            pr = mc_batch(tall, bx, by + crf * strip + m_pad, cmx, cmy,
                          n, 0, bd)
            sc_satd = satd_batch(org, pr)
            if rd:
                cc, sz = _rd_resid_cost(org, pr, qp_b,
                                        n.bit_length() - 1, bd, lam2)
                return sc_satd, cc, sz
            return sc_satd, sc_satd, sc_satd

        if nb <= 130 * 130:
            sc_r, cc_r, sz_r = jax.vmap(eval_cand)(cmx_s, cmy_s, crf_s)
        else:
            rows = []
            dep = None
            for k in range(len(mcands)):
                cmk = _chain(dep, cmx_s[k])
                rows.append(eval_cand(cmk, cmy_s[k], crf_s[k]))
                dep = rows[-1][0]
            sc_r, cc_r, sz_r = (jnp.stack(x) for x in zip(*rows))
        # skip/merge_flag + merge_idx TR bins
        sc_all = sc_r + ((lam256 * (2 + idxb_s)) >> 8)
        sc_all = jnp.where(ok_s, sc_all, 1 << 30)
        if rd:
            mb = (2 + idxb_s).astype(jnp.float32)
            rdk_all = jnp.minimum(cc_r + lam2 * (mb + 4.0),
                                  sz_r + lam2 * mb)
            rdk_all = jnp.where(ok_s, rdk_all, jnp.float32(3e38))
        for k in range(len(mcands)):
            if rd:
                upd = rdk_all[k] < best_rd
                best_rd = jnp.where(upd, rdk_all[k], best_rd)
            else:
                upd = sc_all[k] < best_cost
            best_cost = jnp.where(upd, sc_all[k], best_cost)
            best_x = jnp.where(upd, cmx_s[k], best_x)
            best_y = jnp.where(upd, cmy_s[k], best_y)
            best_r = jnp.where(upd, crf_s[k], best_r)
        return (best_x, best_y, best_r, best_cost,
                best_rd if rd else None)

    for _ in range(rounds[0]):
        mvx, mvy, ref_sel, cost, _ = cand_round(mvx, mvy, ref_sel)
    for _ in range(rounds[1]):
        mvx, mvy, ref_sel, cost, cost_rd = cand_round(mvx, mvy,
                                                      ref_sel, rd=True)

    # 2b. rect PU candidates (2NxN / Nx2N): 8x8 sub-block ME on each
    # block's chosen reference, then PU costs from own+partner SATD
    # pairings (batched checkInter per-shape analog, x265
    # analysis.cpp:1663 / search.cpp:2554 rect loop)
    part = jnp.zeros(nb, jnp.int32)
    mvbx = jnp.zeros(nb, jnp.int32)
    mvby = jnp.zeros(nb, jnp.int32)
    if rect:
        offs = ((0, 0), (0, 8), (8, 0), (8, 8))       # (dy, dx), k-order
        sx4 = (bx[:, None] +
               jnp.asarray([o[1] for o in offs], jnp.int32)[None, :]) \
            .reshape(-1)
        sy4 = (by[:, None] +
               jnp.asarray([o[0] for o in offs], jnp.int32)[None, :]) \
            .reshape(-1)
        rsel4 = jnp.repeat(ref_sel, 4)
        otall = jnp.concatenate(
            [jnp.pad(oy, ((m_pad, m_pad), (0, 0)), mode="edge")] * nref, 0)
        ytall = sy4 + rsel4 * strip + m_pad
        pz4 = jnp.zeros(nb * 4, jnp.int32)
        im8x, im8y, _ = full_search_batch(tall, otall, sx4, ytall, pz4,
                                          pz4, lam256, 8, search_range)
        mv8x, mv8y, c8 = subpel_refine_batch(tall, otall, sx4, ytall,
                                             im8x, im8y, pz4, pz4,
                                             lam256, 8, bd, subme)
        own = (c8 - ((lam256 * mv_bits(mv8x, mv8y)) >> 8)).reshape(nb, 4)
        g8y = jnp.clip(sy4[:, None, None] + jnp.arange(8)[None, :, None],
                       0, h - 1)
        g8x = jnp.clip(sx4[:, None, None] + jnp.arange(8)[None, None, :],
                       0, w - 1)
        org8 = oy[g8y, g8x].astype(jnp.int32)

        def cross_satd(perm):
            px_ = mv8x.reshape(nb, 4)[:, perm].reshape(-1)
            py_ = mv8y.reshape(nb, 4)[:, perm].reshape(-1)
            pr = mc_batch(tall, sx4, ytall, px_, py_, 8, 0, bd)
            return satd_batch(org8, pr).reshape(nb, 4)

        crossH = cross_satd((1, 0, 3, 2))
        crossV = cross_satd((2, 3, 0, 1))
        m8 = (mv8x.reshape(nb, 4), mv8y.reshape(nb, 4))
        pu_bits = ((lam256 * (3 + ref_sel)) >> 8)

        def pu_best(sa, sb, candA, candB):
            """PU of sub-blocks (a, b): candA = a's MV over both, candB
            = b's MV; returns (cost, mvx, mvy)."""
            cA = sa[0] + sb[0] + ((lam256 * mv_bits(
                m8[0][:, candA], m8[1][:, candA])) >> 8) + pu_bits
            cB = sa[1] + sb[1] + ((lam256 * mv_bits(
                m8[0][:, candB], m8[1][:, candB])) >> 8) + pu_bits
            useA = cA <= cB
            return (jnp.where(useA, cA, cB),
                    jnp.where(useA, m8[0][:, candA], m8[0][:, candB]),
                    jnp.where(useA, m8[1][:, candA], m8[1][:, candB]))

        # 2NxN: top PU = subs (0, 1), bottom = (2, 3)
        cT, mTx, mTy = pu_best((own[:, 0], crossH[:, 0]),
                               (crossH[:, 1], own[:, 1]), 0, 1)
        cBt, mBx, mBy = pu_best((own[:, 2], crossH[:, 2]),
                                (crossH[:, 3], own[:, 3]), 2, 3)
        costH = cT + cBt + ((lam256 * 2) >> 8)
        # Nx2N: left PU = subs (0, 2), right = (1, 3)
        cL, mLx, mLy = pu_best((own[:, 0], crossV[:, 0]),
                               (crossV[:, 2], own[:, 2]), 0, 2)
        cR, mRx, mRy = pu_best((own[:, 1], crossV[:, 1]),
                               (crossV[:, 3], own[:, 3]), 1, 3)
        costV = cL + cR + ((lam256 * 2) >> 8)
        # degenerate rect (both PUs same MV) re-encodes 2Nx2N with extra
        # bins — never pick it
        costH = jnp.where((mTx == mBx) & (mTy == mBy), 1 << 30, costH)
        costV = jnp.where((mLx == mRx) & (mLy == mRy), 1 << 30, costV)

        zero = jnp.zeros_like(mvx)
        cands = [(0, mvx, mvy, zero, zero, cost),
                 (1, mTx, mTy, mBx, mBy, costH),
                 (2, mLx, mLy, mRx, mRy, costV)]
        if amp:
            # AMP shapes (2NxnU/2NxnD/nLx2N/nRx2N, x265 analysis.cpp
            # checkInter AMP loop): each quarter strip and its
            # complementary body pick the best MV from a candidate set
            # {2Nx2N, the four rect PU MVs, the coding-order top/left
            # neighbor MVs} by per-strip SATD — a thin strip usually
            # continues the neighboring object's motion, which is the
            # geometry AMP exists for.  SATD is evaluated once per
            # candidate as a 4x4-tile map, then strips sum tile rows.
            y0c = by + ref_sel * strip + m_pad
            f2x = mvx.reshape(nby, nbx)
            f2y = mvy.reshape(nby, nbx)
            extx, exty = boundary_ext(f2x), boundary_ext(f2y)
            tnx, tok = neigh2(f2x, 1, 0, extx)
            tny, _ = neigh2(f2y, 1, 0, exty)
            lnx, lok = neigh2(f2x, 0, 1)
            lny, _ = neigh2(f2y, 0, 1)
            topx = jnp.where(tok, tnx, f2x).reshape(-1)
            topy = jnp.where(tok, tny, f2y).reshape(-1)
            lefx = jnp.where(lok, lnx, f2x).reshape(-1)
            lefy = jnp.where(lok, lny, f2y).reshape(-1)
            cmvs = [(mvx, mvy), (mTx, mTy), (mBx, mBy), (mLx, mLy),
                    (mRx, mRy), (topx, topy), (lefx, lefy)]
            preds = jnp.stack([
                mc_batch(tall, bx, y0c, ax, ay, n, 0, bd)
                for ax, ay in cmvs])
            # (C, nb, nt, nt) 4x4-tile SATD maps
            ddd = org[None].astype(jnp.int32) - preds
            nt = n // 4
            t4 = jnp.moveaxis(
                ddd.reshape(len(cmvs), nb, nt, 4, nt, 4), -3, -2)
            from ..ops.cost import H4
            h4m = jnp.asarray(H4)
            ht = jnp.einsum("ij,...jk,kl->...il", h4m, t4, h4m,
                            preferred_element_type=jnp.int32)
            ts = (jnp.sum(jnp.abs(ht), axis=(-2, -1)) + 1) >> 1
            cax = jnp.stack([c[0] for c in cmvs])        # (C, nb)
            cay = jnp.stack([c[1] for c in cmvs])
            cbits = mv_bits(cax, cay) + 3 + ref_sel[None]

            def region_best(rows, cols):
                r = ts[:, :, rows[0]:rows[1], cols[0]:cols[1]] \
                    .sum(axis=(-2, -1))
                tot = r + ((lam256 * cbits) >> 8)
                ci = jnp.argmin(tot, axis=0)
                mvx_ = jnp.take_along_axis(cax, ci[None], 0)[0]
                mvy_ = jnp.take_along_axis(cay, ci[None], 0)[0]
                return jnp.min(tot, axis=0), mvx_, mvy_

            part_bins = (lam256 * 4) >> 8
            for code, r0, r1 in ((4, (0, 1), (1, nt)),
                                 (5, (0, nt - 1), (nt - 1, nt))):
                c0, m0x, m0y = region_best(r0, (0, nt))
                c1, m1x, m1y = region_best(r1, (0, nt))
                cc = jnp.where((m0x == m1x) & (m0y == m1y), 1 << 30,
                               c0 + c1 + part_bins)
                cands.append((code, m0x, m0y, m1x, m1y, cc))
            for code, c0_, c1_ in ((6, (0, 1), (1, nt)),
                                   (7, (0, nt - 1), (nt - 1, nt))):
                c0, m0x, m0y = region_best((0, nt), c0_)
                c1, m1x, m1y = region_best((0, nt), c1_)
                cc = jnp.where((m0x == m1x) & (m0y == m1y), 1 << 30,
                               c0 + c1 + part_bins)
                cands.append((code, m0x, m0y, m1x, m1y, cc))
        allc = jnp.stack([c[5] for c in cands])
        idx = jnp.argmin(allc, axis=0)
        part = jnp.asarray([c[0] for c in cands], jnp.int32)[idx]
        cost = jnp.min(allc, axis=0)

        def pick(f):
            return jnp.take_along_axis(
                jnp.stack([c[f] for c in cands]), idx[None], 0)[0]

        pu0x, pu0y = pick(1), pick(2)
        mvbx, mvby = pick(3), pick(4)
        mvx, mvy = pu0x, pu0y

    # 2c. motion homogenization: adopt one sub-block's (mv, ref) for a
    # whole 32 (and, at CTU64, 64) region when the SATD loss is smaller
    # than the CU-syntax saving — this is what lets build_region's
    # same-motion merges (and 64x64 skips) actually fire on low-motion
    # content (the batched analog of x265's large-CU early-skip RDO,
    # analysis.cpp:1663 rd0-4 2Nx2N/skip at upper depths)
    def _region_uniform(mvx, mvy, ref_sel, cost, cost_rd, part, g):
        gh, gw = nby // g, nbx // g
        if gh == 0 or gw == 0 or n != 16:
            return mvx, mvy, ref_sel, cost, cost_rd
        f2 = lambda a: a.reshape(nby, nbx)
        crop = lambda a: f2(a)[:gh * g, :gw * g]
        rep2 = lambda a: jnp.repeat(jnp.repeat(a, g, 0), g, 1)
        gsum = lambda a: a.reshape(gh, g, gw, g).sum((1, 3))
        ok = (crop(part) == 0).reshape(gh, g, gw, g).all((1, 3))
        if band is not None:
            # banded calls: the group must lie fully inside the real
            # frame rows (padded bands replicate edge rows)
            gy = jnp.arange(gh)[:, None]
            ok = ok & ((gby0 + (gy + 1) * g) <= nby_total)
        # region decisions compare TRANSFORM-DOMAIN RD (SSE + lam2 *
        # bits), not satd + lam*bits: at medium/high QP the rate share
        # of a zero-residual region's cost dominates, and the satd
        # scale undervalues it — exactly why x265's merge-first RDO
        # (analysis.cpp:3485 checkMerge2Nx2N, :1663 upper-depth skip)
        # accepts a slightly worse merge prediction for a whole-region
        # SKIP.  indiv comes from the rd cand_round (per-block min of
        # coded/zero cost incl. each block's own syntax bins).
        indiv_rd = gsum(crop(cost_rd))
        lam2 = (lam256.astype(jnp.float32) / 256.0) ** 2
        qp_b = jnp.broadcast_to(qp32, (nb,))
        log2n = n.bit_length() - 1
        s = g // 2

        def eval_cand(rmx, rmy, rrf, gbits, valid=None):
            fmx = f2(mvx).at[:gh * g, :gw * g].set(rep2(rmx)).ravel()
            fmy = f2(mvy).at[:gh * g, :gw * g].set(rep2(rmy)).ravel()
            frf = f2(ref_sel).at[:gh * g, :gw * g].set(rep2(rrf)) \
                .ravel()
            pr = mc_batch(tall, bx, by + frf * strip + m_pad, fmx, fmy,
                          n, 0, bd)
            sbc = crop(satd_batch(org, pr))
            cc, sz = _rd_resid_cost(org, pr, qp_b, log2n, bd, lam2)
            blk_rd = crop(f2(jnp.minimum(cc, sz)))
            tot = gsum(blk_rd) + lam2 * gbits.astype(jnp.float32)
            if valid is not None:
                tot = jnp.where(valid, tot, jnp.float32(3e38))
            return [tot, rmx, rmy, rrf, sbc, gbits, blk_rd]

        def merge_best(best, cand):
            if best is None:
                return cand
            u = cand[0] < best[0]
            ub = rep2(u)
            return [jnp.where(u, cand[0], best[0]),
                    jnp.where(u, cand[1], best[1]),
                    jnp.where(u, cand[2], best[2]),
                    jnp.where(u, cand[3], best[3]),
                    jnp.where(ub, cand[4], best[4]),
                    jnp.where(u, cand[5], best[5]),
                    jnp.where(ub, cand[6], best[6])]

        best = None   # [tot, rmx, rmy, rrf, satd_blocks, gbits, blk_rd]
        for c in range(4):
            sy, sx = (c >> 1) * s, (c & 1) * s
            rmx = crop(mvx)[sy::g, sx::g]
            rmy = crop(mvy)[sy::g, sx::g]
            rrf = crop(ref_sel)[sy::g, sx::g]
            # region-CU syntax estimate: the merged CU codes its motion
            # via merge/skip (a few bins) or AMVP with a well-predicted
            # mvd, NOT a full unpredicted mv — charging mv_bits here
            # made tot > indiv for near-identical motion and blocked
            # nearly every large-CU merge (x265's analysis reaches skip
            # first for the same reason, analysis.cpp:1663)
            best = merge_best(best, eval_cand(rmx, rmy, rrf, 8 + rrf))
        # A1/B1 merge-aligned candidates: the motion of the block left
        # of the region's bottom-left / above its top-right IS the
        # region CU's spatial merge candidate at syntax time (spec
        # 8.5.3.2.3) — adopting it lets the whole region code as
        # merge/SKIP (2-4 bins) where a corner mv that differs from
        # every candidate pays AMVP mvd+ref+mvp syntax for a region
        # whose residual is usually zero (the mz32/mz64 waste vs x265,
        # analysis.cpp:3485 checkMerge2Nx2N-first ordering)
        ry_i = jnp.arange(gh) * g
        rx_i = jnp.arange(gw) * g
        fx2, fy2, fr2 = f2(mvx), f2(mvy), f2(ref_sel)
        a1_r = ry_i + (g - 1)
        a1_c = rx_i - 1
        va1 = jnp.broadcast_to((a1_c >= 0)[None, :], (gh, gw))
        ac = jnp.clip(a1_c, 0, nbx - 1)
        mb3 = jnp.full((gh, gw), 3, jnp.int32)
        best = merge_best(best, eval_cand(
            fx2[a1_r[:, None], ac[None, :]],
            fy2[a1_r[:, None], ac[None, :]],
            fr2[a1_r[:, None], ac[None, :]], mb3, va1))
        b1_r = ry_i - 1
        b1_c = rx_i + (g - 1)
        if band is None:
            vb1 = jnp.broadcast_to((b1_r >= 0)[:, None], (gh, gw))
            fx2b, fy2b, fr2b = fx2, fy2, fr2
            br = jnp.clip(b1_r, 0, nby - 1)
        else:
            # banded: the first group row's B1 lives on the UP device's
            # last block-row (ppermute'd); validity is the GLOBAL row
            fx2b = jnp.concatenate([boundary_ext(fx2), fx2], 0)
            fy2b = jnp.concatenate([boundary_ext(fy2), fy2], 0)
            fr2b = jnp.concatenate([boundary_ext(fr2), fr2], 0)
            vb1 = jnp.broadcast_to(((gby0 + b1_r) >= 0)[:, None],
                                   (gh, gw))
            br = b1_r + 1
        best = merge_best(best, eval_cand(
            fx2b[br[:, None], b1_c[None, :]],
            fy2b[br[:, None], b1_c[None, :]],
            fr2b[br[:, None], b1_c[None, :]], mb3, vb1))
        # zero-mv candidate: the spec merge list's zero-fill entry
        # (8.5.3.2.3 step 5) — catches static regions whose spatial
        # neighbors carry a different list/ref and would otherwise
        # code AMVP syntax for (0,0)
        zz = jnp.zeros((gh, gw), jnp.int32)
        best = merge_best(best, eval_cand(zz, zz, zz, mb3 + 1))
        tot, rmx, rmy, rrf, sbc, gbits, blk_rd = best
        # merging also saves the sub-CUs' own split syntax; small slack
        # so an already-uniform region doesn't tie-block the merge
        acc = ok & (tot <= indiv_rd + lam2 * 4.0)
        accb = rep2(acc)
        pb_bits = rep2(((lam256 * gbits) >> 8) // (g * g))
        new = []
        for a, r in ((mvx, rmx), (mvy, rmy), (ref_sel, rrf)):
            new.append(f2(a).at[:gh * g, :gw * g].set(
                jnp.where(accb, rep2(r), crop(a))).ravel())
        new_cost = f2(cost).at[:gh * g, :gw * g].set(
            jnp.where(accb, sbc + pb_bits, crop(cost))).ravel()
        new_rd = f2(cost_rd).at[:gh * g, :gw * g].set(
            jnp.where(accb,
                      blk_rd + lam2 * rep2(gbits).astype(jnp.float32)
                      / (g * g),
                      crop(cost_rd))).ravel()
        return new[0], new[1], new[2], new_cost, new_rd

    mvx, mvy, ref_sel, cost, cost_rd = _region_uniform(
        mvx, mvy, ref_sel, cost, cost_rd, part, 2)
    if log2_ctu == 6:
        mvx, mvy, ref_sel, cost, cost_rd = _region_uniform(
            mvx, mvy, ref_sel, cost, cost_rd, part, 4)

    # 4. decision: inter unless intra clearly wins (intra pays ~5 bits of
    # mode signalling in P slices)
    use_inter = cost <= (intra_best + ((lam256 * 5) >> 8))

    # 5. MC predictions of the chosen (ref, mv) per block; weighted refs
    # take the exact 14-bit path for luma (chroma stays unweighted)
    from ..ops.interp import mc_batch_14, wp_apply_batch
    nc = n >> cshift
    if rect:
        # per-sub-block final MVs: PU1 covers the bottom row (2NxN) or
        # the right column (Nx2N) of the 2x2 sub-block grid
        subB = jnp.where(
            (part == 1)[:, None], jnp.asarray([0, 0, 1, 1])[None, :],
            jnp.where((part == 2)[:, None],
                      jnp.asarray([0, 1, 0, 1])[None, :], 0))
        fmvx = jnp.where(subB == 1, mvbx[:, None],
                         mvx[:, None]).reshape(-1)
        fmvy = jnp.where(subB == 1, mvby[:, None],
                         mvy[:, None]).reshape(-1)
        m_c = m_pad // 2
        strip_c = (h // 2) + 2 * m_c
        tall_c = [None,
                  jnp.concatenate([jnp.pad(rus[i], ((m_c, m_c), (0, 0)),
                                           mode="edge")
                                   for i in range(nref)], 0),
                  jnp.concatenate([jnp.pad(rvs[i], ((m_c, m_c), (0, 0)),
                                           mode="edge")
                                   for i in range(nref)], 0)]
        ytall_c = sy4 // 2 + rsel4 * strip_c + m_c
    mc = []
    for pi in range(3):
        c_idx = 0 if pi == 0 else pi
        if is422 and pi != 0:
            # 4:2:2 chroma: two stacked 8x8 TBs per block; vertical
            # MV component doubles into the eighth-pel chroma path
            halves = []
            for j in (0, 1):
                preds = [mc_batch(refs[ridx][pi], bx >> 1,
                                  by + 8 * j, mvx, mvy * 2, 8, c_idx,
                                  bd)
                         for ridx in range(nref)]
                sel_j = preds[0]
                for ridx in range(1, nref):
                    sel_j = jnp.where((ref_sel == ridx)[:, None, None],
                                      preds[ridx], sel_j)
                halves.append(sel_j)
            sel = jnp.concatenate(halves, axis=1)
            mc.append(sel.reshape(nby, nbx, 2 * nc, nc))
            continue
        sz = n if pi == 0 else nc
        bx_ = bx if pi == 0 else bx >> cshift
        by_ = by if pi == 0 else by >> cshift
        # 4:4:4 chroma: quarter-pel MVs on the full grid -> double into
        # the chroma MC path's eighth-pel convention
        mvs_x = mvx if (pi == 0 or cshift) else mvx * 2
        mvs_y = mvy if (pi == 0 or cshift) else mvy * 2
        sel = None
        for ridx in range(nref):
            rp = refs[ridx][pi]
            wp = weights[ridx]
            rp = _chain(sel, rp)      # serialize refs (peak memory)
            if pi == 0 and wp is not None:
                p14 = mc_batch_14(rp, bx_, by_, mvx, mvy, sz, c_idx, bd)
                pr = wp_apply_batch(p14, wp[0], wp[1], 6, bd)
            elif pi != 0 and cpat is not None and cpat[ridx]:
                # chroma explicit weights (spec 8.5.4.3.2 chroma arm;
                # wc row = [w_cb, o_cb, w_cr, o_cr])
                p14 = mc_batch_14(rp, bx_, by_, mvs_x, mvs_y, sz, c_idx,
                                  bd)
                pr = wp_apply_batch(
                    p14, wc[ridx, 2 * (pi - 1)],
                    wc[ridx, 2 * (pi - 1) + 1], 6, bd)
            else:
                pr = mc_batch(rp, bx_, by_, mvs_x, mvs_y, sz,
                              c_idx, bd)
            sel = pr if sel is None else jnp.where(
                (ref_sel == ridx)[:, None, None], pr, sel)
        if rect:
            if pi == 0:
                rp8 = mc_batch(tall, sx4, ytall, fmvx, fmvy, 8, 0, bd)
                half = 8
            else:
                rp8 = mc_batch(tall_c[pi], sx4 // 2, ytall_c, fmvx,
                               fmvy, 4, pi, bd)
                half = 4
            ra = rp8.reshape(nb, 2, 2, half, half) \
                .transpose(0, 1, 3, 2, 4).reshape(nb, sz, sz)
            sel = jnp.where(((part > 0) & (part < 4))[:, None, None],
                            ra, sel)
            if amp:
                # AMP winners: quarter-strip combine of two full-block
                # MCs with the final PU MVs (mirrors the decoder's
                # per-PU MC on the 7.4.9.5 geometry)
                q_ = sz // 4
                yy_ = jnp.arange(sz)[None, :, None]
                xx_ = jnp.arange(sz)[None, None, :]
                pm = part[:, None, None]
                mask1 = jnp.where(
                    pm == 4, yy_ >= q_,
                    jnp.where(pm == 5, yy_ >= 3 * q_,
                              jnp.where(pm == 6, xx_ >= q_,
                                        xx_ >= 3 * q_)))
                if pi == 0:
                    a0 = mc_batch(tall, bx, y0c, mvx, mvy, sz, 0, bd)
                    a1 = mc_batch(tall, bx, y0c, mvbx, mvby, sz, 0, bd)
                else:
                    y0cc = by // 2 + ref_sel * strip_c + m_c
                    a0 = mc_batch(tall_c[pi], bx // 2, y0cc, mvx, mvy,
                                  sz, pi, bd)
                    a1 = mc_batch(tall_c[pi], bx // 2, y0cc, mvbx,
                                  mvby, sz, pi, bd)
                ampp = jnp.where(mask1, a1, a0)
                sel = jnp.where((part >= 4)[:, None, None], ampp, sel)
        mc.append(sel.reshape(nby, nbx, sz, sz))

    mvs = jnp.stack([mvx, mvy], axis=-1).reshape(nby, nbx, 2) \
        .astype(jnp.int32)
    mvs_b = jnp.stack([mvbx, mvby], axis=-1).reshape(nby, nbx, 2) \
        .astype(jnp.int32)
    return (intra_modes.reshape(nby, nbx),
            use_inter.reshape(nby, nbx),
            mvs,
            ref_sel.reshape(nby, nbx),
            mc[0], mc[1], mc[2],
            part.reshape(nby, nbx),
            mvs_b)



def _hme_center_fullres(ry, oy, nby: int, nbx: int, lam256, sr: int):
    """Quarter-res HME tier for the MAIN per-ref search (x265 --hme,
    motionEstimate HME levels): 8x8 blocks on 1/4-res planes (each
    covering a 2x2 group of 16-blocks) full-search +-sr, MVs upsampled
    to FULLPEL window centers — extends the effective range to ~5*sr
    without growing the (2r+1)^2 SAD grid."""
    q = lambda a: (a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2]
                   + a[1::2, 1::2] + 2) >> 2
    rq, oq = q(q(ry)), q(q(oy))
    gh, gw = max(nby // 2, 1), max(nbx // 2, 1)
    bys, bxs = np.mgrid[0:gh, 0:gw]
    x0 = jnp.asarray((bxs.ravel() * 8).astype(np.int32))
    y0 = jnp.asarray((bys.ravel() * 8).astype(np.int32))
    zero = jnp.zeros_like(x0)
    mvx, mvy, _ = full_search_batch(rq, oq, x0, y0, zero, zero,
                                    lam256, 8, sr)
    sx = ((mvx >> 2) * 4).reshape(gh, gw)
    sy = ((mvy >> 2) * 4).reshape(gh, gw)
    up = lambda a: jnp.pad(
        jnp.repeat(jnp.repeat(a, 2, 0), 2, 1)[:nby, :nbx],
        ((0, max(0, nby - 2 * gh)), (0, max(0, nbx - 2 * gw))),
        mode="edge").ravel()
    return up(sx), up(sy)

from ..ops.me import ME_CHUNK as _ME_CHUNK
# lanes per search-window gather: a 1080p frame's 16-blocks fit one
# chunk; 4K maps over bands so the (B, n+2r, n+2r) window buffer stays
# bounded (one flat 4K gather at r=32 is ~0.8 GB)


def _me_one_ref(oy, ry, bx, by, n, lam256, search_range, bit_depth=8,
                subme=2, me_sea=False, hme=None):
    """Full search + subpel + neighbor coherence against one reference.
    hme: optional (cx, cy) fullpel window centers from the quarter-res
    tier (_hme_center_fullres).  Returns (mvx, mvy, cost) arrays."""
    nb = bx.shape[0]
    if nb > _ME_CHUNK:
        nch = -(-nb // _ME_CHUNK)
        pad = nch * _ME_CHUNK - nb

        def padv(a):
            return jnp.pad(a, (0, pad)).reshape(nch, _ME_CHUNK)

        ops = (padv(bx), padv(by),
               padv(hme[0]) if hme is not None else padv(bx) * 0,
               padv(hme[1]) if hme is not None else padv(bx) * 0)

        def one(args):
            bxk, byk, hx, hy = args
            return _me_one_ref(oy, ry, bxk, byk, n, lam256,
                               search_range, bit_depth, subme, me_sea,
                               None if hme is None else (hx, hy))

        mvx, mvy, cost, org = jax.lax.map(one, ops)
        return (mvx.reshape(-1)[:nb], mvy.reshape(-1)[:nb],
                cost.reshape(-1)[:nb],
                org.reshape(-1, n, n)[:nb])
    pz = jnp.zeros(nb, jnp.int32)
    if me_sea:
        from ..ops.sea import sea_search_batch
        imx, imy, _ = sea_search_batch(ry, oy, bx, by, pz, pz, lam256,
                                       n, search_range, k=64)
    else:
        imx, imy, _ = full_search_batch(
            ry, oy, bx, by, pz, pz, lam256, n, search_range,
            center_x=None if hme is None else hme[0],
            center_y=None if hme is None else hme[1])
    mvx, mvy, cost = subpel_refine_batch(ry, oy, bx, by, imx, imy,
                                         pz, pz, lam256, n, bit_depth,
                                         subme)
    h, w = oy.shape
    gy = by[:, None, None] + jnp.arange(n)[None, :, None]
    gx = bx[:, None, None] + jnp.arange(n)[None, None, :]
    org = oy[jnp.clip(gy, 0, h - 1), jnp.clip(gx, 0, w - 1)] \
        .astype(jnp.int32)
    return mvx, mvy, cost, org


def _b_tmvp_field(col, sps, block, ref_pocs, cur_poc):
    """Full-frame 2-D B TMVP field (td, m0x, m0y, m1x, m1y) for the
    band driver to row-slice (same derivation as the whole-frame
    analyse_b_frame path)."""
    low_delay = all(rp <= cur_poc for lst_p in ref_pocs
                    for rp in lst_p)
    nby_ = sps.height // block
    nbx_ = sps.width // block
    v0, m0x_, m0y_ = temporal_merge_field(
        col, nby_, nbx_, block, sps.width, sps.height,
        sps.log2_ctu_size, 0, ref_pocs[0][0], cur_poc, low_delay)
    v1 = np.zeros_like(v0)
    m1x_ = np.zeros_like(m0x_)
    m1y_ = np.zeros_like(m0y_)
    if ref_pocs[1]:
        v1, m1x_, m1y_ = temporal_merge_field(
            col, nby_, nbx_, block, sps.width, sps.height,
            sps.log2_ctu_size, 1, ref_pocs[1][0], cur_poc, low_delay)
    td_ = (v0.astype(np.int32) | (v1.astype(np.int32) << 1))
    return (td_, np.asarray(m0x_), np.asarray(m0y_),
            np.asarray(m1x_), np.asarray(m1y_))


def analyse_b_frame(y, u, v, refs0, refs1, sps, qp: int,
                    search_range: int = 16, block: int = 16,
                    subme: int = 2, weights_b=None, rect: bool = False,
                    me_sea: bool = False, amp: bool = False,
                    col=None, ref_pocs=None, cur_poc: int = 0,
                    pad_refs=(0, 0), hme: bool = False,
                    rounds=(2, 2), _tmvp_field=None):
    """B-frame analysis: per-list multi-reference ME (the batched analog
    of x265 predInterSearch's per-ref loop, search.cpp:2554) +
    bi-prediction test + merge/AMVP-true candidate rounds + intra
    fallback (checkBidir2Nx2N, analysis.cpp:4007); ONE jitted program
    like analyse_p_frame.

    refs0/refs1: LISTS of (y, u, v) plane tuples in L0/L1 order
    (closest first); a bare (y, u, v) tuple is accepted too.
    ref_pocs: (l0_pocs, l1_pocs) matching the lists — used for TMVP
    scaling and the combined-bi same-picture pruning (the mirror of
    entropy.mv_pred.merge_candidates' POC compare).
    weights_b: optional ((w0, o0)-or-None, (w1, o1)-or-None) explicit
    luma weights per list (x265 --weightb); multi-ref collapses to the
    first ref per list when weights are present (weights are per-list
    single-set in our table writer).
    rect: evaluate 2NxN/Nx2N PU shapes with a per-PU list choice (the
    B-slice arm of x265's checkInter rect loop, analysis.cpp:2368 —
    uni-pred per rect PU on the block's chosen ref of that list).
    Returns (intra_modes, inter_mask, dirs, mv_l0, mv_l1, ref_sel0,
    ref_sel1, (mc_y, mc_u, mc_v), part, (dirs_b, mv0_b, mv1_b))."""

    def _norm(rl):
        if len(rl) == 3 and hasattr(rl[0], "ndim") \
                and getattr(rl[0], "ndim", 0) == 2:
            return [rl]
        return list(rl)
    refs0 = _norm(refs0)
    refs1 = _norm(refs1)
    bd = sps.bit_depth
    lam, _ = lambda_qp(qp)
    lam256 = int(round(lam * 256)) << (bd - 8)
    bands = None if _tmvp_field is not None \
        else _analysis_bands(sps, block, search_range)
    if bands is not None:
        field = None
        if col is not None and ref_pocs is not None and ref_pocs[0]:
            field = _b_tmvp_field(col, sps, block, ref_pocs, cur_poc)

        def run(sub_sps, args, tm):
            out = analyse_b_frame(
                args["cur"][0], args["cur"][1], args["cur"][2],
                args["refs0"], args["refs1"], sub_sps, qp,
                search_range=search_range, block=block, subme=subme,
                weights_b=weights_b, rect=rect, amp=amp,
                me_sea=me_sea, col=None, ref_pocs=ref_pocs,
                cur_poc=cur_poc, pad_refs=pad_refs, hme=hme,
                rounds=rounds,
                _tmvp_field=tm if tm is not None else ())
            return (list(out[:7]) + list(out[7]) + [out[8]]
                    + list(out[9]))

        o = _banded_analysis(run, bands, sps, block,
                             {"cur": (y, u, v),
                              "refs0": list(refs0),
                              "refs1": list(refs1)},
                             field, grid_outs=set(range(14)))
        return (o[0], o[1], o[2], o[3], o[4], o[5], o[6],
                (o[7], o[8], o[9]), o[10], (o[11], o[12], o[13]))
    avail = frame_avail_masks(sps.width, sps.height, block,
                              sps.log2_ctu_size, 0)
    from ..frame.planes import dev_i32
    oy = dev_i32(y)
    if weights_b is None:
        weights_b = (None, None)
    idc = getattr(sps, "chroma_format_idc", 1)
    # multi-ref assumes 4:2:0 16-blocks and unweighted lists (same
    # constraint family as rect); otherwise collapse to 1+1
    if any(wp is not None for wp in weights_b) or idc != 1 \
            or block != 16:
        refs0 = refs0[:1]
        refs1 = refs1[:1]
        if ref_pocs is not None:
            ref_pocs = (tuple(ref_pocs[0][:1]), tuple(ref_pocs[1][:1]))
    wb = tuple(wp is not None for wp in weights_b)
    wv = jnp.asarray([[wp[0] if wp else 64, wp[1] if wp else 0]
                      for wp in weights_b], jnp.int32)
    # rect searches/combines assume 4:2:0 sub-block chroma geometry and
    # unweighted planes (same constraint as the P path)
    rect_eff = rect and not any(wb) and block == 16 and idc == 1
    amp_eff = amp and rect_eff
    if ref_pocs is not None and ref_pocs[0] and ref_pocs[1]:
        l0p = tuple(int(p) for p in ref_pocs[0])
        l1p = tuple(int(p) for p in ref_pocs[1])
    else:
        l0p = tuple(range(len(refs0)))
        l1p = tuple(-1 - i for i in range(len(refs1)))
    n_real0, n_real1 = len(refs0), len(refs1)
    if pad_refs[0] > n_real0:
        # fixed lane counts avoid per-ref-count _b_core recompiles
        # (see analyse_p_frame pad_refs); padded lanes masked below
        refs0 = list(refs0) + [refs0[-1]] * (pad_refs[0] - n_real0)
        l0p = l0p + (l0p[-1],) * (pad_refs[0] - n_real0)
    if pad_refs[1] > n_real1:
        refs1 = list(refs1) + [refs1[-1]] * (pad_refs[1] - n_real1)
        l1p = l1p + (l1p[-1],) * (pad_refs[1] - n_real1)
    tmvp = None
    if _tmvp_field is not None:
        if len(_tmvp_field):
            tmvp = tuple(jnp.asarray(np.ascontiguousarray(a).ravel())
                         for a in _tmvp_field)
    elif col is not None and ref_pocs is not None and ref_pocs[0]:
        # bi temporal merge candidate (both lists scaled independently,
        # spec 8.5.3.2.3/8): B-frame static regions ride this to SKIP
        low_delay = all(rp <= cur_poc for lst_p in ref_pocs
                        for rp in lst_p)
        nby_, nbx_ = y.shape[0] // block, y.shape[1] // block
        v0, m0x_, m0y_ = temporal_merge_field(
            col, nby_, nbx_, block, sps.width, sps.height,
            sps.log2_ctu_size, 0, ref_pocs[0][0], cur_poc, low_delay)
        v1 = np.zeros_like(v0)
        m1x_ = np.zeros_like(m0x_)
        m1y_ = np.zeros_like(m0y_)
        if ref_pocs[1]:
            v1, m1x_, m1y_ = temporal_merge_field(
                col, nby_, nbx_, block, sps.width, sps.height,
                sps.log2_ctu_size, 1, ref_pocs[1][0], cur_poc,
                low_delay)
        td_ = (v0.astype(np.int32) | (v1.astype(np.int32) << 1))
        tmvp = tuple(jnp.asarray(a.ravel()) for a in
                     (td_, m0x_, m0y_, m1x_, m1y_))
    st = lambda rl, i: jnp.stack([dev_i32(r[i]) for r in rl])
    out = _b_core(oy,
                  st(refs0, 0), st(refs0, 1), st(refs0, 2),
                  st(refs1, 0), st(refs1, 1), st(refs1, 2),
                  jnp.asarray(avail.reshape(-1, avail.shape[-1])),
                  jnp.int32(lam256), jnp.int32(qp),
                  search_range, block, bd,
                  subme, wb, wv,
                  0 if idc == 3 else 1, idc == 2, rect_eff,
                  sps.log2_ctu_size, me_sea, amp_eff, tmvp,
                  jnp.asarray(l0p, jnp.int32),
                  jnp.asarray(l1p, jnp.int32),
                  jnp.int32(n_real0), jnp.int32(n_real1), hme,
                  tuple(rounds))
    (modes, inter, dirs, mv0, mv1, rs0, rs1, mcy, mcu, mcv, part,
     dirs_b, mv0_b, mv1_b) = out
    return (np.asarray(modes), np.asarray(inter), np.asarray(dirs),
            np.asarray(mv0), np.asarray(mv1),
            np.asarray(rs0), np.asarray(rs1),
            (mcy, mcu, mcv),
            np.asarray(part),
            (np.asarray(dirs_b), np.asarray(mv0_b), np.asarray(mv1_b)))


@functools.partial(
    jax.jit, static_argnames=("search_range", "block", "bd",
                              "subme", "wb", "cshift",
                              "is422", "rect", "log2_ctu",
                              "me_sea", "amp", "hme", "rounds"))
def _b_core(oy, r0ys, ru0s, rv0s, r1ys, ru1s, rv1s, avail, lam256,
            qp32, search_range: int, block: int, bd: int,
            subme: int = 2, wb=(False, False),
            wv=None, cshift: int = 1, is422: bool = False,
            rect: bool = False, log2_ctu: int = 5,
            me_sea: bool = False, amp: bool = False, tmvp=None,
            poc0=None, poc1=None, n_real0=None, n_real1=None,
            hme: bool = False, rounds=(2, 2)):
    h, w = oy.shape
    n = block
    nbx, nby = w // n, h // n
    nb = nbx * nby
    nref0 = r0ys.shape[0]
    nref1 = r1ys.shape[0]

    bys, bxs = np.mgrid[0:nby, 0:nbx]
    bx = jnp.asarray((bxs.ravel() * n).astype(np.int32))
    by = jnp.asarray((bys.ravel() * n).astype(np.int32))

    use_w = any(wb)
    me0 = [r0ys[i] for i in range(nref0)]
    me1 = [r1ys[i] for i in range(nref1)]
    if use_w:
        # ME searches pre-weighted planes (analysis approximation, as
        # in the P path); MC applies the exact 14-bit weighting below
        from .weightp import weighted_plane_jnp
        if wb[0]:
            me0 = [weighted_plane_jnp(p, wv[0, 0], wv[0, 1],
                                      bit_depth=bd) for p in me0]
        if wb[1]:
            me1 = [weighted_plane_jnp(p, wv[1, 0], wv[1, 1],
                                      bit_depth=bd) for p in me1]

    # per-(list, ref) full search + subpel, then a provisional joint
    # (ref, mv) pick per list with ref_idx bin charges (the batched
    # x265 predInterSearch per-ref loop, search.cpp:2554)
    def list_me(planes, nr_real=None):
        cands = []
        dep = None
        for ry in planes:
            ry = _chain(dep, ry)
            ctr = None
            if hme and n == 16:
                ctr = _hme_center_fullres(ry, oy, nby, nbx, lam256,
                                          search_range)
            mvx, mvy, cost, org_ = _me_one_ref(
                oy, ry, bx, by, n, lam256, search_range, bd,
                subme, me_sea, hme=ctr)
            cands.append((mvx, mvy, cost, org_))
            dep = cost
        satd_r = jnp.stack(
            [c[2] - ((lam256 * mv_bits(c[0], c[1])) >> 8)
             for c in cands])
        mvx_r = jnp.stack([c[0] for c in cands])
        mvy_r = jnp.stack([c[1] for c in cands])
        nr = len(planes)
        prov = satd_r + ((lam256 * (mv_bits(mvx_r, mvy_r) +
                                    jnp.arange(nr)[:, None] + 4)) >> 8)
        if nr_real is not None:
            # padded ref lanes never win (analyse_b_frame pad_refs)
            prov = jnp.where(jnp.arange(nr)[:, None] < nr_real, prov,
                             1 << 30)
        rsel = jnp.argmin(prov, axis=0).astype(jnp.int32)
        mvx = jnp.take_along_axis(mvx_r, rsel[None], 0)[0]
        mvy = jnp.take_along_axis(mvy_r, rsel[None], 0)[0]
        satd = jnp.take_along_axis(satd_r, rsel[None], 0)[0]
        return mvx, mvy, rsel, satd, cands[0][3]

    mv0x, mv0y, rsel0, satd0, org = list_me(me0, n_real0)
    mv1x, mv1y, rsel1, satd1, _ = list_me(me1, n_real1)

    # stacked tall planes per list: one MC gather serves per-block ref
    # indices (candidate rounds, rect, homogenization); the FINAL MC
    # uses the per-ref full planes below so clamping matches the
    # decoder's spec MC exactly
    m_pad = (6 * search_range + 12) if hme else (search_range + 12)
    tall0, strip0 = _stack_refs(me0, m_pad)
    tall1, strip1 = _stack_refs(me1, m_pad)
    # unweighted talls for candidate-round 14-bit MC (bi combine and
    # exact weighting are applied on top)
    tall0u, _ = _stack_refs([r0ys[i] for i in range(nref0)], m_pad)
    tall1u, _ = _stack_refs([r1ys[i] for i in range(nref1)], m_pad)

    off2 = 1 << (13 - bd)
    sh2 = 14 - bd
    maxv = (1 << bd) - 1
    from ..ops.interp import wp_apply_batch, wp_bi_combine

    def uni_of(p14, lst: int = 0):
        if use_w:
            return wp_apply_batch(p14, wv[lst, 0], wv[lst, 1], 6, bd)
        return jnp.clip((p14 + off2) >> sh2, 0, maxv)

    def bi_of(p0, p1):
        if use_w:
            return wp_bi_combine(p0, p1, wv[0, 0], wv[0, 1],
                                 wv[1, 0], wv[1, 1], 6, bd)
        return bi_combine(p0, p1, bd)

    def mc14_l0(cmx, cmy, crf):
        return mc_batch_14(tall0u, bx, by + crf * strip0 + m_pad,
                           cmx, cmy, n, 0, bd)

    def mc14_l1(cmx, cmy, crf):
        return mc_batch_14(tall1u, bx, by + crf * strip1 + m_pad,
                           cmx, cmy, n, 0, bd)

    # bi-prediction of the two best uni (ref, mv) pairs (checkBidir2Nx2N)
    p0_14 = mc14_l0(mv0x, mv0y, rsel0)
    p1_14 = mc14_l1(mv1x, mv1y, rsel1)
    satd_bi = satd_batch(org, bi_of(p0_14, p1_14))

    # merge/AMVP-true selection over full (dir, mv0, ref0, mv1, ref1)
    # motion (batched mergeEstimation/selectMVP analog,
    # search.cpp:2237/2347): ME candidates L0/L1/BI with real
    # AMVP-predictor mvd + ref_idx charges vs the coding-order
    # neighbors' motion with merge_idx charges.

    # S-mask availability indices (see the P-side note)
    AV_A1, AV_A0, AV_B2, AV_B1, AV_B0 = n, n - 1, 2 * n, 3 * n, 3 * n + 1
    av2 = avail.reshape(nb, -1)

    # provisional intra/inter estimate (see the P-side note: the
    # syntax merge list takes no candidates from intra neighbors)
    icosts = _mode_costs(oy, avail,
                         jnp.asarray(bxs.ravel().astype(np.int32)),
                         jnp.asarray(bys.ravel().astype(np.int32)),
                         n.bit_length() - 1, bd)
    intra_best = jnp.min(icosts, axis=1) + ((lam256 * 5) >> 8)
    intra_modes = jnp.argmin(icosts, axis=1).astype(jnp.int32)
    inter_est = (jnp.minimum(jnp.minimum(satd0, satd1), satd_bi)
                 + ((lam256 * 6) >> 8)) <= intra_best

    def b_cand_round(dirs, c0x, c0y, c1x, c1y, r0f, r1f,
                     rd: bool = False):
        f = lambda a: a.reshape(nby, nbx)

        def gat(sy, sx):
            return tuple(_neigh_field(f(a), sy, sx)[0].ravel()
                         for a in (dirs, c0x, c0y, c1x, c1y, r0f, r1f))

        def gat_ie(sy, sx):
            return _neigh_field(f(inter_est), sy, sx)[0].ravel()

        # exact merge candidate derivation over full
        # (dir, mv0, ref0, mv1, ref1) motion (spec 8.5.3.2.3, batched
        # mirror of entropy.mv_pred.merge_candidates; see the P-side
        # note): spatial A1/B1/B0/A0/B2 with z-scan availability +
        # pairwise pruning, TMVP, the first two combined-bi candidates
        # (8.5.3.2.4 order (0,1)/(1,0) — with max_merge 3 the combined
        # stage only ever fires when exactly two candidates exist), and
        # the bi zero-fill entry — each at its true list position.
        a1, b1, b0 = gat(0, 1), gat(1, 0), gat(1, -1)
        a0, b2 = gat(-1, 1), gat(1, 1)
        v_a1 = av2[:, AV_A1] & gat_ie(0, 1)
        v_b1r = av2[:, AV_B1] & gat_ie(1, 0)
        v_b0r = av2[:, AV_B0] & gat_ie(1, -1)
        v_a0r = av2[:, AV_A0] & gat_ie(-1, 1)
        v_b2r = av2[:, AV_B2] & gat_ie(1, 1)
        eq = lambda c, d: ((c[0] == d[0]) & (c[1] == d[1]) &
                           (c[2] == d[2]) & (c[3] == d[3]) &
                           (c[4] == d[4]) & (c[5] == d[5]) &
                           (c[6] == d[6]))
        v_b1 = v_b1r & ~(v_a1 & eq(b1, a1))
        v_b0 = v_b0r & ~(v_b1r & eq(b0, b1))
        v_a0 = v_a0r & ~(v_a1 & eq(a0, a1))
        i32 = lambda b_: b_.astype(jnp.int32)
        n4 = i32(v_a1) + i32(v_b1) + i32(v_b0) + i32(v_a0)
        v_b2 = (v_b2r & (n4 < 4) & ~(v_a1 & eq(b2, a1))
                & ~(v_b1r & eq(b2, b1)))
        idx_a1 = jnp.zeros(nb, jnp.int32)
        idx_b1 = i32(v_a1)
        idx_b0 = idx_b1 + i32(v_b1)
        idx_a0 = idx_b0 + i32(v_b0)
        idx_b2 = idx_a0 + i32(v_a0)
        n_sp = idx_b2 + i32(v_b2)
        zz_ = jnp.zeros(nb, jnp.int32)
        if tmvp is not None:
            td_, t0x, t0y, t1x, t1y = tmvp
            # vertical window guard (shared rationale with the P side,
            # inter_mode.py cand_round): candidate MC gathers read the
            # stacked tall planes, whose edge replication only covers
            # m_pad rows per strip — a scaled temporal MV beyond the
            # window would read the neighboring ref's strip
            tok = ((jnp.abs(t0y) <= 4 * (m_pad - 8)) &
                   (jnp.abs(t1y) <= 4 * (m_pad - 8)))
            tm = (td_, t0x, t0y, t1x, t1y, zz_, zz_)
            v_t = (td_ > 0) & tok & (n_sp < 3)
        else:
            tm = (zz_, zz_, zz_, zz_, zz_, zz_, zz_)
            v_t = zz_ != 0
        idx_t = n_sp
        cnt = n_sp + i32(v_t)
        # combined-bi (0,1)/(1,0): base0/base1 = the list's first two
        # entries, selected across the six candidate slots by position
        spat = [(a1, v_a1, idx_a1), (b1, v_b1, idx_b1),
                (b0, v_b0, idx_b0), (a0, v_a0, idx_a0),
                (b2, v_b2, idx_b2), (tm, v_t, idx_t)]
        stk = [jnp.stack([c[0][i] for c in spat]) for i in range(7)]
        vstk = jnp.stack([c[1] for c in spat])
        istk = jnp.stack([c[2] for c in spat])

        def base(k):
            sel = jnp.argmax(vstk & (istk == k), axis=0)
            return [jnp.take_along_axis(s, sel[None], 0)[0]
                    for s in stk]

        b0_, b1_ = base(0), base(1)
        c01 = (zz_ + 3, b0_[1], b0_[2], b1_[3], b1_[4], b0_[5], b1_[6])
        c10 = (zz_ + 3, b1_[1], b1_[2], b0_[3], b0_[4], b1_[5], b0_[6])
        # same-picture pruning by POC (spec 8.5.3.2.4; the mirror of
        # mv_pred.merge_candidates' ref_pocs compare)
        sp01 = (poc0[jnp.clip(b0_[5], 0, nref0 - 1)] ==
                poc1[jnp.clip(b1_[6], 0, nref1 - 1)])
        sp10 = (poc0[jnp.clip(b1_[5], 0, nref0 - 1)] ==
                poc1[jnp.clip(b0_[6], 0, nref1 - 1)])
        v_c01 = ((cnt == 2) & ((b0_[0] & 1) != 0) & ((b1_[0] & 2) != 0))
        v_c01 &= ~(sp01 & (b0_[1] == b1_[3]) & (b0_[2] == b1_[4]))
        v_c10 = ((cnt == 2) & ~v_c01 & ((b1_[0] & 1) != 0)
                 & ((b0_[0] & 2) != 0))
        v_c10 &= ~(sp10 & (b1_[1] == b0_[3]) & (b1_[2] == b0_[4]))
        idx_c = cnt
        idx_z = cnt + i32(v_c01 | v_c10)
        v_z = idx_z < 3
        bcands = spat + [(c01, v_c01, idx_c), (c10, v_c10, idx_c),
                         ((zz_ + 3, zz_, zz_, zz_, zz_, zz_, zz_),
                          v_z, idx_z)]

        # per-list AMVP predictors ~ A1/B1 neighbor MVs of that list
        def preds(lst):
            out = []
            for (cand, vr) in ((a1, v_a1), (b1, v_b1r)):
                has = vr & ((cand[0] & (1 << lst)) != 0)
                px = jnp.where(has, cand[1] if lst == 0 else cand[3], 0)
                py = jnp.where(has, cand[2] if lst == 0 else cand[4], 0)
                out.append((px, py))
            return out
        pl0 = preds(0)
        pl1 = preds(1)
        mvd0 = jnp.minimum(
            mv_bits(mv0x - pl0[0][0], mv0y - pl0[0][1]),
            mv_bits(mv0x - pl0[1][0], mv0y - pl0[1][1]))
        mvd1 = jnp.minimum(
            mv_bits(mv1x - pl1[0][0], mv1y - pl1[0][1]),
            mv_bits(mv1x - pl1[1][0], mv1y - pl1[1][1]))
        # ME modes: satd + merge_flag0/pred/part + inter_pred_idc(2) +
        # mvd + mvp_idx + ref_idx TR bins per used list
        cL0 = satd0 + ((lam256 * (mvd0 + 6 + rsel0)) >> 8)
        cL1 = satd1 + ((lam256 * (mvd1 + 6 + rsel1)) >> 8)
        cBI = satd_bi + ((lam256 * (mvd0 + mvd1 + 7 + rsel0
                                    + rsel1)) >> 8)
        best = jnp.stack([cL0, cL1, cBI], 0)
        if rd:
            # final round: transform-domain RD arbitration (see the P
            # path's cand_round rd=True — same checkMerge2Nx2N /
            # rd-skip rationale, here over {L0, L1, BI, merge nbrs})
            lam2 = (lam256.astype(jnp.float32) / 256.0) ** 2
            qp_b = jnp.broadcast_to(qp32, (nb,))
            log2n = n.bit_length() - 1
            syn_me = [(mvd0 + 6 + rsel0).astype(jnp.float32),
                      (mvd1 + 6 + rsel1).astype(jnp.float32),
                      (mvd0 + mvd1 + 7 + rsel0 + rsel1)
                      .astype(jnp.float32)]
            rds = []
            for p, s in zip((uni_of(p0_14, 0), uni_of(p1_14, 1),
                             bi_of(p0_14, p1_14)), syn_me):
                cc, sz = _rd_resid_cost(org, p, qp_b, log2n, bd, lam2)
                rds.append(jnp.minimum(cc + lam2 * s,
                                       sz + lam2 * (s + 1.0)))
            rd_stack = jnp.stack(rds, 0)
            mi = jnp.argmin(rd_stack, 0)
            best_rd = jnp.min(rd_stack, 0)
        else:
            mi = jnp.argmin(best, 0)
        best_cost = jnp.take_along_axis(best, mi[None], 0)[0]
        best_dir = (mi + 1).astype(jnp.int32)     # 1=L0, 2=L1, 3=BI
        best_0x = jnp.where(mi != 1, mv0x, 0)
        best_0y = jnp.where(mi != 1, mv0y, 0)
        best_1x = jnp.where(mi != 0, mv1x, 0)
        best_1y = jnp.where(mi != 0, mv1y, 0)
        best_r0 = jnp.where(mi != 1, rsel0, 0)
        best_r1 = jnp.where(mi != 0, rsel1, 0)
        # merge-candidate evaluation: stack the K candidates and run
        # the MC gathers + SATD (+ residual RD) as ONE vmapped batch
        # instead of sequential per-candidate gathers.  The argmin scan
        # below preserves the sequential loop's first-minimum
        # tie-breaking exactly.  4K stays sequential: 9 full-frame
        # 14-bit candidate stacks at once multiply its working set.
        stk = lambda i: jnp.stack([c[0][i] for c in bcands])
        nd_s, n0x_s, n0y_s, n1x_s, n1y_s, nr0_s, nr1_s = (
            stk(i) for i in range(7))
        idx_s = jnp.stack([c[2] for c in bcands])
        ok_s = jnp.stack([c[1] for c in bcands]) & (idx_s < 3) \
            & (nd_s > 0)
        idxb_s = jnp.where(idx_s == 0, 1, 2)

        def eval_cand(nd, n0x, n0y, n1x, n1y, nr0, nr1):
            cr0 = jnp.clip(nr0, 0, nref0 - 1)
            cr1 = jnp.clip(nr1, 0, nref1 - 1)
            q0 = mc14_l0(n0x, n0y, cr0)
            q1 = mc14_l1(n1x, n1y, cr1)
            pred = jnp.where((nd == 3)[:, None, None],
                             bi_of(q0, q1),
                             jnp.where((nd == 1)[:, None, None],
                                       uni_of(q0, 0), uni_of(q1, 1)))
            sc_satd = satd_batch(org, pred)
            if rd:
                cc, sz = _rd_resid_cost(org, pred, qp_b, log2n, bd,
                                        lam2)
                return sc_satd, cc, sz
            return sc_satd, sc_satd, sc_satd

        if nb <= 130 * 130:
            sc_r, cc_r, sz_r = jax.vmap(eval_cand)(
                nd_s, n0x_s, n0y_s, n1x_s, n1y_s, nr0_s, nr1_s)
        else:
            rows = []
            dep = None
            for k in range(len(bcands)):
                ndk = _chain(dep, nd_s[k])
                rows.append(eval_cand(ndk, n0x_s[k], n0y_s[k],
                                      n1x_s[k], n1y_s[k], nr0_s[k],
                                      nr1_s[k]))
                dep = rows[-1][0]
            sc_r, cc_r, sz_r = (jnp.stack(x) for x in zip(*rows))
        sc_all = sc_r + ((lam256 * (2 + idxb_s)) >> 8)
        sc_all = jnp.where(ok_s, sc_all, 1 << 30)
        if rd:
            mb = (2 + idxb_s).astype(jnp.float32)
            rdk_all = jnp.minimum(cc_r + lam2 * (mb + 4.0),
                                  sz_r + lam2 * mb)
            rdk_all = jnp.where(ok_s, rdk_all, jnp.float32(3e38))
        for k in range(len(bcands)):
            if rd:
                upd = rdk_all[k] < best_rd
                best_rd = jnp.where(upd, rdk_all[k], best_rd)
            else:
                upd = sc_all[k] < best_cost
            best_cost = jnp.where(upd, sc_all[k], best_cost)
            best_dir = jnp.where(upd, nd_s[k], best_dir)
            best_0x = jnp.where(upd, n0x_s[k], best_0x)
            best_0y = jnp.where(upd, n0y_s[k], best_0y)
            best_1x = jnp.where(upd, n1x_s[k], best_1x)
            best_1y = jnp.where(upd, n1y_s[k], best_1y)
            best_r0 = jnp.where(upd, nr0_s[k], best_r0)
            best_r1 = jnp.where(upd, nr1_s[k], best_r1)
        return (best_dir, best_0x, best_0y, best_1x, best_1y,
                best_r0, best_r1, best_cost, best_rd if rd else None)

    # provisional direction field from the pure ME costs (zero-pred
    # charges), so round-1 neighbor predictors aren't list-biased
    cost0 = satd0 + ((lam256 * mv_bits(mv0x, mv0y)) >> 8)
    cost1 = satd1 + ((lam256 * mv_bits(mv1x, mv1y)) >> 8)
    me_b0 = mv_bits(mv0x, mv0y)
    me_b1 = mv_bits(mv1x, mv1y)
    prov = jnp.stack([cost0, cost1,
                      satd_bi + ((lam256 * (me_b0 + me_b1 + 2)) >> 8)], 0)
    dirs = (jnp.argmin(prov, 0) + 1).astype(jnp.int32)
    has0 = dirs != 2
    has1 = dirs != 1
    c0x = jnp.where(has0, mv0x, 0)
    c0y = jnp.where(has0, mv0y, 0)
    c1x = jnp.where(has1, mv1x, 0)
    c1y = jnp.where(has1, mv1y, 0)
    r0f = jnp.where(has0, rsel0, 0)
    r1f = jnp.where(has1, rsel1, 0)
    for _ in range(rounds[0]):
        (dirs, c0x, c0y, c1x, c1y, r0f, r1f, inter_cost,
         _) = b_cand_round(dirs, c0x, c0y, c1x, c1y, r0f, r1f)
    for _ in range(rounds[1]):
        (dirs, c0x, c0y, c1x, c1y, r0f, r1f, inter_cost,
         cost_rd) = b_cand_round(dirs, c0x, c0y, c1x, c1y, r0f, r1f,
                                 rd=True)
    mv0x, mv0y, mv1x, mv1y = c0x, c0y, c1x, c1y
    ref0_f, ref1_f = r0f, r1f
    inter_cost_2n = inter_cost

    # 2b. rect PU candidates (2NxN / Nx2N) with a per-PU list choice:
    # 8x8 sub-block ME on each list's per-block chosen ref, PU costs
    # from own+partner SATD pairings per list, then argmin over
    # {L0, L1} per PU (B arm of the x265 checkInter rect loop,
    # analysis.cpp:2368; uni-pred per rect PU — bidir stays 2Nx2N as
    # in checkBidir2Nx2N)
    part = jnp.zeros(nb, jnp.int32)
    dirs_b = jnp.zeros(nb, jnp.int32)
    pu1_0x = pu1_0y = pu1_1x = pu1_1y = jnp.zeros(nb, jnp.int32)
    if rect:
        offs = ((0, 0), (0, 8), (8, 0), (8, 8))       # (dy, dx), k-order
        sx4 = (bx[:, None] +
               jnp.asarray([o[1] for o in offs], jnp.int32)[None, :]) \
            .reshape(-1)
        sy4 = (by[:, None] +
               jnp.asarray([o[0] for o in offs], jnp.int32)[None, :]) \
            .reshape(-1)
        pz4 = jnp.zeros(nb * 4, jnp.int32)
        otall0 = jnp.concatenate(
            [jnp.pad(oy, ((m_pad, m_pad), (0, 0)), mode="edge")]
            * nref0, 0)
        otall1 = jnp.concatenate(
            [jnp.pad(oy, ((m_pad, m_pad), (0, 0)), mode="edge")]
            * nref1, 0)
        g8y = jnp.clip(sy4[:, None, None] + jnp.arange(8)[None, :, None],
                       0, h - 1)
        g8x = jnp.clip(sx4[:, None, None] + jnp.arange(8)[None, None, :],
                       0, w - 1)
        org8 = oy[g8y, g8x].astype(jnp.int32)

        # rect PUs search ref 0 of each list (per-PU ref_idx would need
        # its own rect_info/deblock plumbing; the multi-ref win lives
        # in the 2Nx2N/merge path) — keeps analysis refs consistent
        # with the syntax encoder's ref_idx_b/ref_idx1_b = 0
        rs4 = (pz4, pz4)
        sub = []          # per list: (own, crossH, crossV, m8x, m8y)
        for li, (tl, ot, strip_l) in enumerate(
                ((tall0, otall0, strip0), (tall1, otall1, strip1))):
            ytall = sy4 + rs4[li] * strip_l + m_pad
            i8x, i8y, _ = full_search_batch(tl, ot, sx4, ytall, pz4,
                                            pz4, lam256, 8,
                                            search_range)
            m8x, m8y, c8 = subpel_refine_batch(tl, ot, sx4, ytall, i8x,
                                               i8y, pz4, pz4, lam256, 8,
                                               bd, subme)
            own = (c8 - ((lam256 * mv_bits(m8x, m8y)) >> 8)) \
                .reshape(nb, 4)

            def cross_satd(perm, m8x=m8x, m8y=m8y, tl=tl, yt=ytall):
                px_ = m8x.reshape(nb, 4)[:, perm].reshape(-1)
                py_ = m8y.reshape(nb, 4)[:, perm].reshape(-1)
                pr = mc_batch(tl, sx4, yt, px_, py_, 8, 0, bd)
                return satd_batch(org8, pr).reshape(nb, 4)

            sub.append((own, cross_satd((1, 0, 3, 2)),
                        cross_satd((2, 3, 0, 1)),
                        m8x.reshape(nb, 4), m8y.reshape(nb, 4)))

        # merge_flag + inter_pred_idc (2) + mvp_idx + ref_idx bins per
        # uni rect PU
        pu_bits = [(lam256 * 4) >> 8, (lam256 * 4) >> 8]

        def pu_best_l(lst, horiz, first):
            """Best (cost, mvx, mvy) for one rect PU on one list: the
            PU's two sub-blocks covered by either sub's MV."""
            own, crH, crV, m8x, m8y = sub[lst]
            cr = crH if horiz else crV
            if horiz:
                a, b2 = (0, 1) if first else (2, 3)
            else:
                a, b2 = (0, 2) if first else (1, 3)
            cA = own[:, a] + cr[:, b2] + \
                ((lam256 * mv_bits(m8x[:, a], m8y[:, a])) >> 8) + \
                pu_bits[lst]
            cB = cr[:, a] + own[:, b2] + \
                ((lam256 * mv_bits(m8x[:, b2], m8y[:, b2])) >> 8) + \
                pu_bits[lst]
            useA = cA <= cB
            return (jnp.where(useA, cA, cB),
                    jnp.where(useA, m8x[:, a], m8x[:, b2]),
                    jnp.where(useA, m8y[:, a], m8y[:, b2]))

        def pu_best(horiz, first):
            """argmin over the two lists: (cost, list, mvx, mvy)."""
            c0, x0_, y0_ = pu_best_l(0, horiz, first)
            c1, x1_, y1_ = pu_best_l(1, horiz, first)
            use0 = c0 <= c1
            return (jnp.where(use0, c0, c1),
                    jnp.where(use0, 0, 1).astype(jnp.int32),
                    jnp.where(use0, x0_, x1_),
                    jnp.where(use0, y0_, y1_))

        part_bins = (lam256 * 2) >> 8
        cT, lT, xT, yT = pu_best(True, True)
        cB_, lB, xB, yB = pu_best(True, False)
        costH = cT + cB_ + part_bins
        cL, lL, xL, yL = pu_best(False, True)
        cR, lR, xR, yR = pu_best(False, False)
        costV = cL + cR + part_bins
        # degenerate rect (both PUs same list+MV) re-encodes 2Nx2N with
        # extra bins — never pick it
        costH = jnp.where((lT == lB) & (xT == xB) & (yT == yB),
                          1 << 30, costH)
        costV = jnp.where((lL == lR) & (xL == xR) & (yL == yR),
                          1 << 30, costV)

        allc = jnp.stack([inter_cost_2n, costH, costV])
        pidx = jnp.argmin(allc, axis=0)
        part = pidx.astype(jnp.int32)
        inter_cost = jnp.min(allc, axis=0)
        p0l = jnp.where(part == 1, lT, lL)        # PU0 list
        p0x = jnp.where(part == 1, xT, xL)
        p0y = jnp.where(part == 1, yT, yL)
        p1l = jnp.where(part == 1, lB, lR)        # PU1 list
        p1x = jnp.where(part == 1, xB, xR)
        p1y = jnp.where(part == 1, yB, yR)
        if amp:
            # AMP shapes for B (B arm of the x265 checkInter AMP loop):
            # per-strip 4x4-tile SATD over (list, sub-MV) candidates;
            # each quarter strip and its complementary body pick the
            # best uni (list, mv) pair independently
            cl = []                   # (list, mvx, mvy) per candidate
            for l in range(2):
                m8x_l, m8y_l = sub[l][3], sub[l][4]
                for c in range(4):
                    cl.append((l, m8x_l[:, c], m8y_l[:, c]))
            from ..ops.cost import H4
            h4m = jnp.asarray(H4)
            ts = []
            # AMP candidates ride ref 0 too (see the rect note)
            y0t = (by + m_pad, by + m_pad)
            talls_me = (tall0, tall1)
            for (l, ax, ay) in cl:
                pr = mc_batch(talls_me[l], bx, y0t[l], ax, ay, n, 0,
                              bd)
                dd = org.astype(jnp.int32) - pr
                nt = n // 4
                t4 = jnp.moveaxis(dd.reshape(nb, nt, 4, nt, 4), -3, -2)
                ht = jnp.einsum("ij,...jk,kl->...il", h4m, t4, h4m,
                                preferred_element_type=jnp.int32)
                ts.append((jnp.sum(jnp.abs(ht), axis=(-2, -1)) + 1)
                          >> 1)
            ts = jnp.stack(ts)                       # (C, nb, nt, nt)
            cax = jnp.stack([c[1] for c in cl])
            cay = jnp.stack([c[2] for c in cl])
            clist = jnp.asarray([c[0] for c in cl],
                                jnp.int32)[:, None]
            cbits = mv_bits(cax, cay) + 4

            def region_best(rows, cols):
                rsum = ts[:, :, rows[0]:rows[1], cols[0]:cols[1]] \
                    .sum(axis=(-2, -1))
                tot = rsum + ((lam256 * cbits) >> 8)
                ci = jnp.argmin(tot, axis=0)
                take = lambda a: jnp.take_along_axis(a, ci[None], 0)[0]
                return (jnp.min(tot, axis=0), take(clist *
                        jnp.ones_like(cax)), take(cax), take(cay))

            nt = n // 4
            part_bins = (lam256 * 4) >> 8
            amp_cands = []
            for code, r0_, r1_ in ((4, (0, 1), (1, nt)),
                                   (5, (0, nt - 1), (nt - 1, nt))):
                a0 = region_best(r0_, (0, nt))
                a1 = region_best(r1_, (0, nt))
                amp_cands.append((code, a0, a1))
            for code, c0_, c1_ in ((6, (0, 1), (1, nt)),
                                   (7, (0, nt - 1), (nt - 1, nt))):
                a0 = region_best((0, nt), c0_)
                a1 = region_best((0, nt), c1_)
                amp_cands.append((code, a0, a1))
            for code, (c0, l0_, x0_, y0_), (c1, l1_, x1_, y1_) \
                    in amp_cands:
                cc = c0 + c1 + part_bins
                cc = jnp.where((l0_ == l1_) & (x0_ == x1_) &
                               (y0_ == y1_), 1 << 30, cc)
                u = cc < inter_cost
                inter_cost = jnp.where(u, cc, inter_cost)
                part = jnp.where(u, code, part)
                p0l = jnp.where(u, l0_, p0l)
                p0x = jnp.where(u, x0_, p0x)
                p0y = jnp.where(u, y0_, p0y)
                p1l = jnp.where(u, l1_, p1l)
                p1x = jnp.where(u, x1_, p1x)
                p1y = jnp.where(u, y1_, p1y)
        # PU0 motion replaces the CU 2Nx2N fields where rect wins; the
        # per-list refs stay the block's rsel (the rect search rode it)
        rw = part > 0
        dirs = jnp.where(rw, p0l + 1, dirs)
        mv0x = jnp.where(rw, jnp.where(p0l == 0, p0x, 0), mv0x)
        mv0y = jnp.where(rw, jnp.where(p0l == 0, p0y, 0), mv0y)
        mv1x = jnp.where(rw, jnp.where(p0l == 1, p0x, 0), mv1x)
        mv1y = jnp.where(rw, jnp.where(p0l == 1, p0y, 0), mv1y)
        ref0_f = jnp.where(rw, 0, ref0_f)
        ref1_f = jnp.where(rw, 0, ref1_f)
        dirs_b = jnp.where(rw, p1l + 1, 0)
        pu1_0x = jnp.where(rw & (p1l == 0), p1x, 0)
        pu1_0y = jnp.where(rw & (p1l == 0), p1y, 0)
        pu1_1x = jnp.where(rw & (p1l == 1), p1x, 0)
        pu1_1y = jnp.where(rw & (p1l == 1), p1y, 0)
        # per-sub-block final (list, ref, mv) for the MC composite
        subB = jnp.where(
            (part == 1)[:, None], jnp.asarray([0, 0, 1, 1])[None, :],
            jnp.where((part == 2)[:, None],
                      jnp.asarray([0, 1, 0, 1])[None, :], 0))
        s_l = jnp.where(subB == 1, p1l[:, None], p0l[:, None]) \
            .reshape(-1)
        s_x = jnp.where(subB == 1, p1x[:, None], p0x[:, None]) \
            .reshape(-1)
        s_y = jnp.where(subB == 1, p1y[:, None], p0y[:, None]) \
            .reshape(-1)

    # 2c. motion homogenization across 32 (and 64) regions — adopt one
    # sub-block's (dir, mv0, ref0, mv1, ref1) for the region when the
    # RD loss is smaller than the CU-syntax saving, so build_region's
    # same-motion merges / 64x64 skips fire on B frames too (where
    # per-block near-tie direction flips otherwise block every merge)
    def _b_region_uniform(dirs, m0x, m0y, m1x, m1y, r0m, r1m, cost,
                          cost_rd, part, g):
        gh, gw = nby // g, nbx // g
        if gh == 0 or gw == 0 or n != 16 or use_w:
            return dirs, m0x, m0y, m1x, m1y, r0m, r1m, cost, cost_rd
        f2 = lambda a: a.reshape(nby, nbx)
        crop = lambda a: f2(a)[:gh * g, :gw * g]
        rep2 = lambda a: jnp.repeat(jnp.repeat(a, g, 0), g, 1)
        gsum = lambda a: a.reshape(gh, g, gw, g).sum((1, 3))
        ok = (crop(part) == 0).reshape(gh, g, gw, g).all((1, 3))
        # transform-domain RD comparison (see the P-side note)
        indiv_rd = gsum(crop(cost_rd))
        lam2 = (lam256.astype(jnp.float32) / 256.0) ** 2
        qp_b = jnp.broadcast_to(qp32, (nb,))
        log2n = n.bit_length() - 1
        s = g // 2

        def eval_cand(rdd, rm0x, rm0y, rm1x, rm1y, rr0, rr1, gbits,
                      valid=None):
            fd = f2(dirs).at[:gh * g, :gw * g].set(rep2(rdd)).ravel()
            f0x = f2(m0x).at[:gh * g, :gw * g].set(rep2(rm0x)).ravel()
            f0y = f2(m0y).at[:gh * g, :gw * g].set(rep2(rm0y)).ravel()
            f1x = f2(m1x).at[:gh * g, :gw * g].set(rep2(rm1x)).ravel()
            f1y = f2(m1y).at[:gh * g, :gw * g].set(rep2(rm1y)).ravel()
            fr0 = f2(r0m).at[:gh * g, :gw * g].set(rep2(rr0)).ravel()
            fr1 = f2(r1m).at[:gh * g, :gw * g].set(rep2(rr1)).ravel()
            q0 = mc14_l0(f0x, f0y, jnp.clip(fr0, 0, nref0 - 1))
            q1 = mc14_l1(f1x, f1y, jnp.clip(fr1, 0, nref1 - 1))
            pred = jnp.where((fd == 3)[:, None, None], bi_of(q0, q1),
                             jnp.where((fd == 1)[:, None, None],
                                       uni_of(q0, 0), uni_of(q1, 1)))
            sbc = crop(satd_batch(org, pred))
            cc, sz = _rd_resid_cost(org, pred, qp_b, log2n, bd, lam2)
            blk_rd = crop(f2(jnp.minimum(cc, sz)))
            tot = gsum(blk_rd) + lam2 * gbits.astype(jnp.float32)
            if valid is not None:
                tot = jnp.where(valid, tot, jnp.float32(3e38))
            return [tot, rdd, rm0x, rm0y, rm1x, rm1y, rr0, rr1, sbc,
                    gbits, blk_rd]

        def merge_best(best, cand):
            if best is None:
                return cand
            u = cand[0] < best[0]
            ub = rep2(u)
            return ([jnp.where(u, cand[i], best[i]) for i in range(8)]
                    + [jnp.where(ub, cand[8], best[8]),
                       jnp.where(u, cand[9], best[9]),
                       jnp.where(ub, cand[10], best[10])])

        best = None
        for c in range(4):
            sy, sx = (c >> 1) * s, (c & 1) * s
            # merge/skip-realistic region syntax charge (see the P-side
            # _region_uniform note): full mv_bits blocked the merges
            best = merge_best(best, eval_cand(
                crop(dirs)[sy::g, sx::g],
                crop(m0x)[sy::g, sx::g], crop(m0y)[sy::g, sx::g],
                crop(m1x)[sy::g, sx::g], crop(m1y)[sy::g, sx::g],
                crop(r0m)[sy::g, sx::g], crop(r1m)[sy::g, sx::g],
                jnp.full((gh, gw), 10, jnp.int32)))
        # A1/B1 merge-aligned candidates (see the P-side note): the
        # region CU's actual spatial merge candidates; adopting one
        # lets the region code as merge/SKIP instead of AMVP
        ry_i = jnp.arange(gh) * g
        rx_i = jnp.arange(gw) * g
        flds = (f2(dirs), f2(m0x), f2(m0y), f2(m1x), f2(m1y),
                f2(r0m), f2(r1m))
        mb3 = jnp.full((gh, gw), 3, jnp.int32)
        a1_r = ry_i + (g - 1)
        a1_c = rx_i - 1
        va1 = jnp.broadcast_to((a1_c >= 0)[None, :], (gh, gw))
        ac = jnp.clip(a1_c, 0, nbx - 1)
        ga1 = lambda f: f[a1_r[:, None], ac[None, :]]
        best = merge_best(best, eval_cand(
            *(ga1(f) for f in flds), mb3, va1 & (ga1(flds[0]) > 0)))
        b1_r = ry_i - 1
        b1_c = rx_i + (g - 1)
        vb1 = jnp.broadcast_to((b1_r >= 0)[:, None], (gh, gw))
        br = jnp.clip(b1_r, 0, nby - 1)
        gb1 = lambda f: f[br[:, None], b1_c[None, :]]
        best = merge_best(best, eval_cand(
            *(gb1(f) for f in flds), mb3, vb1 & (gb1(flds[0]) > 0)))
        # bi zero-mv candidate (the B-slice merge list's zero-fill
        # entry is bidirectional, spec 8.5.3.2.3 step 5)
        zz = jnp.zeros((gh, gw), jnp.int32)
        best = merge_best(best, eval_cand(zz + 3, zz, zz, zz, zz,
                                          zz, zz, mb3 + 1))
        (tot, rdd, rm0x, rm0y, rm1x, rm1y, rr0, rr1, sbc, gbits,
         blk_rd) = best
        # tie-accepting compare with sub-CU syntax slack (see the
        # P-side note)
        acc = ok & (tot <= indiv_rd + lam2 * 4.0)
        accb = rep2(acc)
        pb_bits = rep2(((lam256 * gbits) >> 8) // (g * g))
        out = []
        for a, r in ((dirs, rdd), (m0x, rm0x), (m0y, rm0y),
                     (m1x, rm1x), (m1y, rm1y), (r0m, rr0),
                     (r1m, rr1)):
            out.append(f2(a).at[:gh * g, :gw * g].set(
                jnp.where(accb, rep2(r), crop(a))).ravel())
        new_cost = f2(cost).at[:gh * g, :gw * g].set(
            jnp.where(accb, sbc + pb_bits, crop(cost))).ravel()
        new_rd = f2(cost_rd).at[:gh * g, :gw * g].set(
            jnp.where(accb,
                      blk_rd + lam2 * rep2(gbits).astype(jnp.float32)
                      / (g * g),
                      crop(cost_rd))).ravel()
        return (out[0], out[1], out[2], out[3], out[4], out[5],
                out[6], new_cost, new_rd)

    (dirs, mv0x, mv0y, mv1x, mv1y, ref0_f, ref1_f, inter_cost,
     cost_rd) = _b_region_uniform(
        dirs, mv0x, mv0y, mv1x, mv1y, ref0_f, ref1_f, inter_cost,
        cost_rd, part, 2)
    if log2_ctu == 6:
        (dirs, mv0x, mv0y, mv1x, mv1y, ref0_f, ref1_f, inter_cost,
         cost_rd) = _b_region_uniform(
            dirs, mv0x, mv0y, mv1x, mv1y, ref0_f, ref1_f, inter_cost,
            cost_rd, part, 4)

    use_inter = inter_cost <= intra_best
    dirs = jnp.where(use_inter, dirs, 0)
    if rect:
        part = jnp.where(use_inter, part, 0)
        dirs_b = jnp.where(use_inter, dirs_b, 0)

    # MC predictions of the chosen (dir, ref, mv) per block.  Uses the
    # per-ref FULL planes with a select (not the tall stacks) so edge
    # clamping matches the decoder's spec MC exactly (the tall strips
    # only edge-replicate m_pad rows).
    nc = n >> cshift
    is_bi = (dirs == 3)
    use_l0 = (dirs == 1) | is_bi
    refs0_p = [(r0ys[i], ru0s[i], rv0s[i]) for i in range(nref0)]
    refs1_p = [(r1ys[i], ru1s[i], rv1s[i]) for i in range(nref1)]

    def sel_ref_mc(planes, rsel_f, fn):
        # running select with a serialization chain: materializing all
        # refs' full-frame MC buffers concurrently was a top 4K
        # device-memory cost (see _chain)
        sel = None
        for ridx, rp in enumerate(planes):
            rp = _chain(sel, rp)
            pr = fn(rp)
            sel = pr if sel is None else jnp.where(
                (rsel_f == ridx)[:, None, None], pr, sel)
        return sel

    mc = []
    for (pls0, pls1, c_idx, sz, bx_, by_) in (
            ([r[0] for r in refs0_p], [r[0] for r in refs1_p], 0, n,
             bx, by),
            ([r[1] for r in refs0_p], [r[1] for r in refs1_p], 1, nc,
             bx >> cshift, by >> cshift),
            ([r[2] for r in refs0_p], [r[2] for r in refs1_p], 2, nc,
             bx >> cshift, by >> cshift)):
        if is422 and c_idx:
            halves = []
            for j in (0, 1):
                b0j = mc_batch_14(pls0[0], bx >> 1, by + 8 * j, mv0x,
                                  mv0y * 2, 8, c_idx, bd)
                b1j = mc_batch_14(pls1[0], bx >> 1, by + 8 * j, mv1x,
                                  mv1y * 2, 8, c_idx, bd)
                u0j = mc_batch(pls0[0], bx >> 1, by + 8 * j, mv0x,
                               mv0y * 2, 8, c_idx, bd)
                u1j = mc_batch(pls1[0], bx >> 1, by + 8 * j, mv1x,
                               mv1y * 2, 8, c_idx, bd)
                bij = bi_combine(b0j, b1j, bd)
                halves.append(jnp.where(is_bi[:, None, None], bij,
                                        jnp.where(use_l0[:, None,
                                                         None],
                                                  u0j, u1j)))
            mc.append(jnp.concatenate(halves, axis=1)
                      .reshape(nby, nbx, 2 * nc, nc))
            continue
        mvsc = 2 if (c_idx and not cshift) else 1   # 4:4:4 chroma MVs
        b0 = sel_ref_mc(pls0, ref0_f,
                        lambda p: mc_batch_14(p, bx_, by_, mv0x * mvsc,
                                              mv0y * mvsc, sz, c_idx,
                                              bd))
        b1 = sel_ref_mc(pls1, ref1_f,
                        lambda p: mc_batch_14(p, bx_, by_, mv1x * mvsc,
                                              mv1y * mvsc, sz, c_idx,
                                              bd))
        if c_idx == 0 and use_w:
            # weightB is luma-only (chroma flags stay 0 in the table)
            u0, u1 = uni_of(b0, 0), uni_of(b1, 1)
            bi = bi_of(b0, b1)
        else:
            u0 = sel_ref_mc(pls0, ref0_f,
                            lambda p: mc_batch(p, bx_, by_,
                                               mv0x * mvsc,
                                               mv0y * mvsc, sz, c_idx,
                                               bd))
            u1 = sel_ref_mc(pls1, ref1_f,
                            lambda p: mc_batch(p, bx_, by_,
                                               mv1x * mvsc,
                                               mv1y * mvsc, sz, c_idx,
                                               bd))
            bi = bi_combine(b0, b1, bd)
        sel = jnp.where(is_bi[:, None, None], bi,
                        jnp.where(use_l0[:, None, None], u0, u1))
        if rect:
            # rect winners: per-sub-block uni MC from each sub's chosen
            # (list, ref), reassembled into the full block.  MVs are
            # ME-bounded (|mv_y| <= 4*(search_range+2) < 4*(m_pad-8)),
            # so the tall-strip gather equals spec clamping here.
            if c_idx == 0:
                yt0 = sy4 + rs4[0] * strip0 + m_pad
                yt1 = sy4 + rs4[1] * strip1 + m_pad
                s0 = mc_batch(tall0u, sx4, yt0, s_x, s_y, 8, 0, bd)
                s1 = mc_batch(tall1u, sx4, yt1, s_x, s_y, 8, 0, bd)
                half = 8
            else:
                m_c = m_pad // 2
                strip_c = (h >> 1) + 2 * m_c
                tc0 = jnp.concatenate(
                    [jnp.pad(pls0[i], ((m_c, m_c), (0, 0)),
                             mode="edge") for i in range(nref0)], 0)
                tc1 = jnp.concatenate(
                    [jnp.pad(pls1[i], ((m_c, m_c), (0, 0)),
                             mode="edge") for i in range(nref1)], 0)
                ytc0 = (sy4 >> 1) + rs4[0] * strip_c + m_c
                ytc1 = (sy4 >> 1) + rs4[1] * strip_c + m_c
                s0 = mc_batch(tc0, sx4 >> 1, ytc0, s_x, s_y, 4,
                              c_idx, bd)
                s1 = mc_batch(tc1, sx4 >> 1, ytc1, s_x, s_y, 4,
                              c_idx, bd)
                half = 4
            s8 = jnp.where((s_l == 0)[:, None, None], s0, s1)
            ra = s8.reshape(nb, 2, 2, half, half) \
                .transpose(0, 1, 3, 2, 4).reshape(nb, sz, sz)
            sel = jnp.where(((part > 0) & (part < 4))[:, None, None],
                            ra, sel)
            if amp:
                # AMP winners: quarter-strip combine of the two PUs'
                # full-block uni MCs (7.4.9.5 geometry, as in P)
                q_ = sz // 4
                yy_ = jnp.arange(sz)[None, :, None]
                xx_ = jnp.arange(sz)[None, None, :]
                pm = part[:, None, None]
                mask1 = jnp.where(
                    pm == 4, yy_ >= q_,
                    jnp.where(pm == 5, yy_ >= 3 * q_,
                              jnp.where(pm == 6, xx_ >= q_,
                                        xx_ >= 3 * q_)))
                u0a = mc_batch(pls0[0], bx_, by_, p0x * mvsc,
                               p0y * mvsc, sz, c_idx, bd)
                u1a = mc_batch(pls1[0], bx_, by_, p0x * mvsc,
                               p0y * mvsc, sz, c_idx, bd)
                v0a = mc_batch(pls0[0], bx_, by_, p1x * mvsc,
                               p1y * mvsc, sz, c_idx, bd)
                v1a = mc_batch(pls1[0], bx_, by_, p1x * mvsc,
                               p1y * mvsc, sz, c_idx, bd)
                a0 = jnp.where((p0l == 0)[:, None, None], u0a, u1a)
                a1 = jnp.where((p1l == 0)[:, None, None], v0a, v1a)
                ampp = jnp.where(mask1, a1, a0)
                sel = jnp.where((part >= 4)[:, None, None], ampp, sel)
        mc.append(sel.reshape(nby, nbx, sz, sz))

    mv_l0 = jnp.stack([mv0x, mv0y], -1).reshape(nby, nbx, 2) \
        .astype(jnp.int32)
    mv_l1 = jnp.stack([mv1x, mv1y], -1).reshape(nby, nbx, 2) \
        .astype(jnp.int32)
    mv0_b = jnp.stack([pu1_0x, pu1_0y], -1).reshape(nby, nbx, 2) \
        .astype(jnp.int32)
    mv1_b = jnp.stack([pu1_1x, pu1_1y], -1).reshape(nby, nbx, 2) \
        .astype(jnp.int32)
    return (intra_modes.reshape(nby, nbx),
            use_inter.reshape(nby, nbx),
            dirs.reshape(nby, nbx).astype(jnp.int32),
            mv_l0, mv_l1,
            ref0_f.reshape(nby, nbx).astype(jnp.int32),
            ref1_f.reshape(nby, nbx).astype(jnp.int32),
            mc[0], mc[1], mc[2],
            part.reshape(nby, nbx),
            dirs_b.reshape(nby, nbx),
            mv0_b, mv1_b)
