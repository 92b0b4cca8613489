"""CTU tile-row sharded P-frame analysis with halo exchange.

The declared multi-chip north star (SURVEY.md §2.3 P1/P2 mapping): a
frame's analysis is sharded over a 1-D device mesh by CTU block rows.
Each device holds its band of the original + reference planes; the
reference-pixel halo a band needs (search range + interp margin) is
exchanged between devices with `ppermute` — the collective analog of the
reference encoder's frame-parallel recon-row lag handshake
(x265 frameencoder.h:213 m_refLagRows, doc/reST/threading.rst:124-215).

The banded core is `analysis.inter_mode._p_core` itself (band != None),
so sharded analysis is arithmetically IDENTICAL to the whole-frame
call: the encoder's bitstream does not change with the device count
(the reference's own determinism contract, threading.rst:180-190).

Why there is deliberately NO tile-row B variant: the B frames of a
mini-GOP are mutually independent once their anchors exist, so the
natural mesh axis for B is the FRAME axis — encoder.top._encode_b_jobs
pins each B picture's whole device program to its own mesh device
(dryrun stage 4, byte-identical to sequential).  That saturates the
same device count with ZERO halo exchanges, while row-sharding one B
frame would add two ppermute halos per reference list per frame for
the identical parallel width.  P frames have no such sibling axis
(each P depends on the previous anchor), which is exactly why P gets
the row-sharded path and B does not.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..analysis.inter_mode import _p_core, lambda_qp
from ..frame.zscan import frame_avail_masks
from .mesh import make_mesh

HALO_BLOCKS = 2          # 32 px luma: search 16 + 8-tap margin + slack


def _slab(xb, halo: int, axis: str, nd: int):
    """Extend a device's band with `halo` rows of real neighbor pixels
    (ppermute up/down); frame-edge devices replicate their edge row —
    exactly the whole-frame clamp semantics."""
    if halo == 0:
        return xb
    top = jax.lax.ppermute(xb[-halo:], axis,
                           [(i, i + 1) for i in range(nd - 1)])
    bot = jax.lax.ppermute(xb[:halo], axis,
                           [(i + 1, i) for i in range(nd - 1)])
    idx = jax.lax.axis_index(axis)
    top = jnp.where(idx == 0, jnp.broadcast_to(xb[0:1], top.shape), top)
    bot = jnp.where(idx == nd - 1, jnp.broadcast_to(xb[-1:], bot.shape),
                    bot)
    return jnp.concatenate([top, xb, bot], 0)


def analyse_p_frame_tiles(y, u, v, refs, sps, qp: int,
                          n_devices: int = 8, search_range: int = 16,
                          block: int = 16, weights=None, subme: int = 2,
                          rect: bool = False, mesh=None, col=None,
                          ref_pocs=None, cur_poc: int = 0):
    """Tile-row sharded analyse_p_frame (drop-in, same returns).

    Rows are padded (edge replication) to a multiple of n_devices
    block-rows; padded rows' decisions are discarded.  Pixel values any
    in-band read can touch are identical to the whole-frame call, so
    the outputs are bit-identical to analyse_p_frame."""
    if mesh is None:
        mesh = make_mesh(n_devices, axis="rows")
    axis = mesh.axis_names[0]
    nd = mesh.devices.size
    bd = sps.bit_depth
    n = block
    if weights is None:
        weights = [None] * len(refs)
    wpat = tuple(wp is not None for wp in weights)
    wq = jnp.asarray([wp[0] if wp else 64 for wp in weights], jnp.int32)
    wo = jnp.asarray([wp[1] if wp else 0 for wp in weights], jnp.int32)
    rect_eff = rect and not any(wpat) and block == 16

    h, w = y.shape
    nby = h // n
    # each band must span >= HALO_BLOCKS rows so the one-hop ppermute
    # halo exchange covers the full read extent; bands are padded to a
    # multiple of 4 block-rows so the in-core motion-homogenization
    # groups (32/64 regions) align with the global grid on every
    # device — keeps banded analysis bit-identical to whole-frame
    per_band = max(-(-nby // nd), HALO_BLOCKS)
    per_band = -(-per_band // 4) * 4
    nby_pad = nd * per_band
    pad_rows = (nby_pad - nby) * n

    def padr(a, rows):
        if rows == 0:
            return np.asarray(a)
        return np.concatenate([a, np.repeat(a[-1:], rows, 0)], 0)

    oy = jnp.asarray(padr(np.asarray(y, np.int32), pad_rows))
    rys = jnp.stack([jnp.asarray(padr(np.asarray(r[0], np.int32),
                                      pad_rows)) for r in refs])
    rus = jnp.stack([jnp.asarray(padr(np.asarray(r[1], np.int32),
                                      pad_rows // 2)) for r in refs])
    rvs = jnp.stack([jnp.asarray(padr(np.asarray(r[2], np.int32),
                                      pad_rows // 2)) for r in refs])
    # availability masks stay GLOBAL (original frame geometry); padded
    # block-rows reuse the last real row's masks (results discarded)
    avail = frame_avail_masks(sps.width, sps.height, block,
                              sps.log2_ctu_size, 0)
    if pad_rows:
        avail = np.concatenate(
            [avail, np.repeat(avail[-1:], nby_pad - nby, 0)], 0)
    avail = jnp.asarray(avail)

    lam, _ = lambda_qp(qp)
    lam256 = jnp.int32(int(round(lam * 256)) << (bd - 8))
    band = (axis, nby_pad, HALO_BLOCKS, nd)
    halo_y = HALO_BLOCKS * n
    halo_c = halo_y // 2

    # temporal merge candidate field (same derivation as the
    # whole-frame call, sharded by block rows like avail so banded
    # analysis stays bit-identical)
    if col is not None and ref_pocs is not None and ref_pocs[0]:
        from ..analysis.inter_mode import temporal_merge_field
        low_delay = all(rp <= cur_poc for lst_p in ref_pocs
                        for rp in lst_p)
        tval, tmx, tmy = temporal_merge_field(
            col, nby, avail.shape[1], n, sps.width, sps.height,
            sps.log2_ctu_size, 0, ref_pocs[0][0], cur_poc, low_delay)
        pr = nby_pad - nby
        if pr:
            tval = np.concatenate([tval, np.repeat(tval[-1:], pr, 0)], 0)
            tmx = np.concatenate([tmx, np.repeat(tmx[-1:], pr, 0)], 0)
            tmy = np.concatenate([tmy, np.repeat(tmy[-1:], pr, 0)], 0)
        tmvp_in = (jnp.asarray(tval), jnp.asarray(tmx),
                   jnp.asarray(tmy))
    else:
        z2 = jnp.zeros((nby_pad, avail.shape[1]), jnp.int32)
        tmvp_in = (z2 != 0, z2, z2)
    has_tmvp = col is not None and ref_pocs is not None \
        and bool(ref_pocs[0])

    def kernel(oy_b, rys_b, rus_b, rvs_b, avail_b, lam_b, tmvp_b):
        oy_s = _slab(oy_b, halo_y, axis, nd)
        rys_s = jnp.stack([_slab(rys_b[i], halo_y, axis, nd)
                           for i in range(rys_b.shape[0])])
        rus_s = jnp.stack([_slab(rus_b[i], halo_c, axis, nd)
                           for i in range(rus_b.shape[0])])
        rvs_s = jnp.stack([_slab(rvs_b[i], halo_c, axis, nd)
                           for i in range(rvs_b.shape[0])])
        nbx_ = avail_b.shape[1]
        return _p_core(oy_s, rys_s, rus_s, rvs_s, wq, wo,
                       avail_b.reshape(-1, avail_b.shape[-1]), lam_b,
                       jnp.int32(qp),
                       wpat, search_range, block, bd,
                       sps.log2_ctu_size, subme, rect_eff,
                       False, band,
                       tmvp=tmvp_b if has_tmvp else None)

    rows = P(axis)
    # check_rep off: fori_loop carries inside the ME kernels start as
    # replicated zeros and become device-varying (VMA check artifact)
    fn = jax.jit(jax.shard_map(
        kernel, mesh=mesh,
        in_specs=(rows, P(None, axis), P(None, axis), P(None, axis),
                  rows, P(), (rows, rows, rows)),
        out_specs=(rows,) * 9, check_vma=False))
    out = fn(oy, rys, rus, rvs, avail, lam256, tmvp_in)
    modes, inter, mvs, rsel, mcy, mcu, mcv, part, mvs_b = \
        [np.asarray(o)[:nby] for o in out]
    return (modes, inter, mvs, rsel, (mcy, mcu, mcv), part, mvs_b)
