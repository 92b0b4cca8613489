"""Sample-adaptive offset (spec 7.3.8.3 syntax, 8.7.3 filtering).

Analog of the reference's SAO (x265 source/encoder/sao.cpp: stats
calcSaoStatsCTU:729, RDO rdoSaoUnitCu:1214, apply applyPixelOffsets:268;
saoCuOrgE0..B0 primitives), restructured batch-first: SAO reads the
deblocked picture and writes an independent output, so classification,
per-CTU statistics, and offset application are all whole-frame batched
tensor ops; only the tiny per-CTU type decision runs on host.

v1 scope: explicit per-CTU params (merge flags coded 0), luma + chroma
(shared chroma type/class per spec).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

SAO_OFF, SAO_BAND, SAO_EDGE = 0, 1, 2
MAX_OFFSET = 7                     # 8-bit: (1 << (min(bd,10)-5)) - 1

# EO class neighbor offsets: (ax, ay, bx, by)
EO_NEIGHBORS = ((-1, 0, 1, 0), (0, -1, 0, 1), (-1, -1, 1, 1),
                (1, -1, -1, 1))


@dataclass
class SaoParams:
    """Per-CTU, per-component SAO decision."""
    type_idx: int = SAO_OFF        # 0 off, 1 band, 2 edge
    eo_class: int = 0              # 0..3 (edge)
    band_pos: int = 0              # 0..31 (band)
    offsets: Tuple[int, ...] = (0, 0, 0, 0)


# ---------------------------------------------------------------------------
# Classification (shared by stats and apply) — batched
# ---------------------------------------------------------------------------

def _eo_categories(plane: jnp.ndarray, pic_h: int, pic_w: int
                   ) -> jnp.ndarray:
    """Per-pixel EO category for all 4 classes.

    Returns (4, H, W) int32 in 0..4 (0 = no offset).  Picture-boundary
    pixels (vs the TRUE picture dims pic_h/pic_w, not the CTU-padded
    plane) where a neighbor falls outside get category 0 (spec 8.7.3:
    such samples are not filtered).
    """
    h, w = plane.shape
    p = plane.astype(jnp.int32)
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    cats = []
    for (ax, ay, bx, by) in EO_NEIGHBORS:
        a = p[jnp.clip(ys + ay, 0, h - 1), jnp.clip(xs + ax, 0, w - 1)]
        b = p[jnp.clip(ys + by, 0, h - 1), jnp.clip(xs + bx, 0, w - 1)]
        edge = 2 + jnp.sign(p - a) + jnp.sign(p - b)
        cat = jnp.where(edge == 0, 1,
                        jnp.where(edge == 1, 2,
                                  jnp.where(edge == 3, 3,
                                            jnp.where(edge == 4, 4, 0))))
        inside = ((ys + ay >= 0) & (ys + ay < pic_h) & (xs + ax >= 0) &
                  (xs + ax < pic_w) & (ys + by >= 0) & (ys + by < pic_h) &
                  (xs + bx >= 0) & (xs + bx < pic_w))
        cats.append(jnp.where(inside, cat, 0))
    return jnp.stack(cats)


def _tile_hw(ctu):
    """SAO tile size: int (square) or (tile_h, tile_w) — 4:2:2 chroma
    CTUs are ctu tall x ctu/2 wide."""
    return (ctu, ctu) if isinstance(ctu, int) else ctu


def _ctu_reduce(arr: jnp.ndarray, ctu, h: int, w: int) -> jnp.ndarray:
    """(..., H, W) -> (..., nCtuY, nCtuX) sum over CTU tiles (H/W padded
    to CTU multiples by the caller)."""
    th, tw = _tile_hw(ctu)
    lead = arr.shape[:-2]
    a = arr.reshape(*lead, h // th, th, w // tw, tw)
    return a.sum(axis=(-3, -1))


@functools.partial(jax.jit,
                   static_argnames=("ctu", "pic_h", "pic_w", "bit_depth"))
def sao_stats_batch(orig: jnp.ndarray, rec: jnp.ndarray, ctu: int,
                    pic_h: int, pic_w: int, bit_depth: int = 8):
    """Per-CTU SAO statistics on (orig - rec).

    Returns (eo_sum, eo_cnt, bo_sum, bo_cnt):
      eo_*: (4, 5, nCtuY, nCtuX)  per class x category
      bo_*: (32, nCtuY, nCtuX)    per band
    Planes must be CTU-aligned (pad before calling; padded area zeros out
    via orig==rec there).
    """
    h, w = rec.shape
    inpic = (jnp.arange(h)[:, None] < pic_h) & \
        (jnp.arange(w)[None, :] < pic_w)
    diff = jnp.where(inpic,
                     orig.astype(jnp.int32) - rec.astype(jnp.int32), 0)
    cats = jnp.where(inpic[None], _eo_categories(rec, pic_h, pic_w), 0)
    cat_axis = jnp.arange(5)[None, :, None, None]
    onehot = (cats[:, None] == cat_axis)             # (4, 5, H, W)
    eo_sum = _ctu_reduce(jnp.where(onehot, diff[None, None], 0),
                         ctu, h, w)
    eo_cnt = _ctu_reduce(onehot.astype(jnp.int32), ctu, h, w)
    band = (rec.astype(jnp.int32) >> (bit_depth - 5))          # (H, W)
    bhot = (band[None] == jnp.arange(32)[:, None, None]) & inpic[None]
    bo_sum = _ctu_reduce(jnp.where(bhot, diff[None], 0), ctu, h, w)
    bo_cnt = _ctu_reduce(bhot.astype(jnp.int32), ctu, h, w)
    return eo_sum, eo_cnt, bo_sum, bo_cnt


@functools.partial(jax.jit,
                   static_argnames=("ctu", "pic_h", "pic_w", "bit_depth"))
def sao_apply_batch(rec: jnp.ndarray, type_map: jnp.ndarray,
                    class_map: jnp.ndarray, band_map: jnp.ndarray,
                    off_map: jnp.ndarray, ctu: int, pic_h: int,
                    pic_w: int, bit_depth: int = 8):
    """Apply per-CTU SAO params to a deblocked plane.

    type_map/class_map/band_map: (nCtuY, nCtuX) int32;
    off_map: (nCtuY, nCtuX, 4) int32.  Returns the filtered plane."""
    h, w = rec.shape
    maxv = (1 << bit_depth) - 1
    th, tw = _tile_hw(ctu)
    p = rec.astype(jnp.int32)
    cats = _eo_categories(rec, pic_h, pic_w)         # (4, H, W)
    cy = jnp.arange(h)[:, None] // th
    cx = jnp.arange(w)[None, :] // tw
    t = type_map[cy, cx]                             # (H, W)
    cls = class_map[cy, cx]
    bpos = band_map[cy, cx]
    offs = off_map[cy, cx]                           # (H, W, 4)

    # edge: offset by (category of the CTU's class) - 1
    cat_sel = jnp.take_along_axis(
        cats, cls[None], axis=0)[0]                  # (H, W)
    eo_off = jnp.where(cat_sel > 0,
                       jnp.take_along_axis(
                           offs, jnp.maximum(cat_sel - 1, 0)[..., None],
                           axis=-1)[..., 0], 0)
    # band: offset index = band - band_pos in 0..3 (mod 32)
    band = p >> (bit_depth - 5)
    bidx = (band - bpos) % 32
    bo_off = jnp.where(bidx < 4,
                       jnp.take_along_axis(
                           offs, jnp.minimum(bidx, 3)[..., None],
                           axis=-1)[..., 0], 0)
    out = jnp.where(t == SAO_EDGE, p + eo_off,
                    jnp.where(t == SAO_BAND, p + bo_off, p))
    return jnp.clip(out, 0, maxv)


# ---------------------------------------------------------------------------
# Golden scalar apply (decoder)
# ---------------------------------------------------------------------------

def sao_apply_ref(rec: np.ndarray, params: List[List[SaoParams]],
                  ctu: int, bit_depth: int = 8) -> np.ndarray:
    """Scalar reference apply; params indexed [ctu_y][ctu_x]."""
    h, w = rec.shape
    maxv = (1 << bit_depth) - 1
    th, tw = _tile_hw(ctu)
    src = rec.astype(np.int64)
    out = src.copy()
    for cy in range(len(params)):
        for cx in range(len(params[0])):
            pr = params[cy][cx]
            if pr.type_idx == SAO_OFF:
                continue
            y1 = min((cy + 1) * th, h)
            x1 = min((cx + 1) * tw, w)
            for y in range(cy * th, y1):
                for x in range(cx * tw, x1):
                    v = src[y, x]
                    if pr.type_idx == SAO_BAND:
                        bidx = ((v >> (bit_depth - 5)) - pr.band_pos) % 32
                        if bidx < 4:
                            out[y, x] = min(max(v + pr.offsets[bidx], 0),
                                            maxv)
                        continue
                    ax, ay, bx, by = EO_NEIGHBORS[pr.eo_class]
                    if not (0 <= y + ay < h and 0 <= x + ax < w and
                            0 <= y + by < h and 0 <= x + bx < w):
                        continue
                    a = src[y + ay, x + ax]
                    b = src[y + by, x + bx]
                    edge = 2 + int(np.sign(v - a)) + int(np.sign(v - b))
                    cat = {0: 1, 1: 2, 3: 3, 4: 4}.get(edge, 0)
                    if cat:
                        out[y, x] = min(max(v + pr.offsets[cat - 1], 0),
                                        maxv)
    return out.astype(np.int32)


# ---------------------------------------------------------------------------
# Per-CTU RDO decision (host)
# ---------------------------------------------------------------------------

def _best_offset(s: int, c: int, lam: float, sign: int = 0,
                 max_off: int = MAX_OFFSET) -> Tuple[int, float]:
    """Optimal clipped offset and its RD cost for one category.

    Distortion delta of offset o on (sum, count): c*o^2 - 2*o*s
    (x265 estSaoDist); iterate |o| downward charging ~1 bin per magnitude
    (estIterOffset analog)."""
    if c == 0:
        return 0, 0.0
    o = int(round(s / c))
    o = min(max(o, -max_off), max_off)
    if sign > 0:
        o = max(o, 0)
    elif sign < 0:
        o = min(o, 0)
    best = (0, 0.0)
    while o != 0:
        cost = c * o * o - 2 * o * s + lam * (abs(o) + 1)
        if cost < best[1]:
            best = (o, cost)
        o += 1 if o < 0 else -1
    return best


def _best_offset_vec(s: np.ndarray, c: np.ndarray, lam: float,
                     sign: int = 0, max_off: int = MAX_OFFSET):
    """Vectorized optimal clipped offset + cost over stat arrays.

    Evaluates the RD cost of every candidate offset and takes the min
    (cost(o) = c*o^2 - 2*o*s + lam*(|o|+1); off = 0 cost baseline)."""
    s = s.astype(np.float64)
    c = c.astype(np.float64)
    os_ = np.arange(-max_off, max_off + 1)
    if sign > 0:
        os_ = os_[os_ >= 0]
    elif sign < 0:
        os_ = os_[os_ <= 0]
    shape = (len(os_),) + (1,) * s.ndim
    ob = os_.reshape(shape)
    cost = c[None] * ob * ob - 2.0 * ob * s[None] + lam * (np.abs(ob) + 1)
    cost = np.where(ob == 0, 0.0, cost)
    k = np.argmin(cost, axis=0)
    return os_[k].astype(np.int32), np.take_along_axis(
        cost, k[None], axis=0)[0]


def sao_decide(eo_sum, eo_cnt, bo_sum, bo_cnt, lam: float,
               bit_depth: int = 8
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                          np.ndarray]:
    """Choose per-CTU type/class/offsets from stats (vectorized host RDO).

    Returns (type_map, class_map, band_map, off_map, cost_map); cost is
    the chosen alternative's RD cost (0 for OFF) for the merge pass."""
    eo_sum = np.asarray(eo_sum).astype(np.float64)
    eo_cnt = np.asarray(eo_cnt).astype(np.float64)
    bo_sum = np.asarray(bo_sum).astype(np.float64)
    bo_cnt = np.asarray(bo_cnt).astype(np.float64)
    max_off = (1 << (min(bit_depth, 10) - 5)) - 1
    ncy, ncx = eo_sum.shape[-2:]

    # EO: offsets per (cls, cat, cy, cx) with sign constraints
    eo_off = np.zeros((4, 4, ncy, ncx), np.int32)
    eo_cost = np.zeros((4, 4, ncy, ncx))
    for cat in range(1, 5):
        sgn = 1 if cat <= 2 else -1
        o, c = _best_offset_vec(eo_sum[:, cat], eo_cnt[:, cat], lam, sgn,
                                max_off)
        eo_off[:, cat - 1] = o
        eo_cost[:, cat - 1] = c
    eo_total = eo_cost.sum(axis=1) + lam * 2.0          # (4, ncy, ncx)
    best_cls = np.argmin(eo_total, axis=0)              # (ncy, ncx)
    best_eo_cost = np.take_along_axis(eo_total, best_cls[None], 0)[0]

    # BO: per-band offsets, best 4-consecutive window
    bo_o, bo_c = _best_offset_vec(bo_sum, bo_cnt, lam, 0, max_off)
    win = np.stack([bo_c[s0:s0 + 4].sum(axis=0) for s0 in range(29)])
    best_start = np.argmin(win, axis=0)                 # (ncy, ncx)
    best_bo_cost = np.take_along_axis(win, best_start[None], 0)[0] \
        + lam * 7.0

    type_map = np.zeros((ncy, ncx), np.int32)
    class_map = np.zeros((ncy, ncx), np.int32)
    band_map = np.zeros((ncy, ncx), np.int32)
    off_map = np.zeros((ncy, ncx, 4), np.int32)
    use_eo = (best_eo_cost < 0) & (best_eo_cost <= best_bo_cost)
    use_bo = (best_bo_cost < 0) & ~use_eo
    type_map[use_eo] = SAO_EDGE
    type_map[use_bo] = SAO_BAND
    class_map[use_eo] = best_cls[use_eo]
    band_map[use_bo] = best_start[use_bo]
    for k in range(4):
        eo_k = np.take_along_axis(eo_off[:, k], best_cls[None], 0)[0]
        bo_k = np.take_along_axis(
            bo_o, np.minimum(best_start + k, 31)[None], 0)[0]
        off_map[..., k] = np.where(use_eo, eo_k,
                                   np.where(use_bo, bo_k, 0))
    cost_map = np.where(use_eo, best_eo_cost,
                        np.where(use_bo, best_bo_cost, 0.0))
    return type_map, class_map, band_map, off_map, cost_map


def sao_decide_chroma(stats_cb, stats_cr, lam: float,
                      bit_depth: int = 8):
    """Joint Cb/Cr decision (vectorized): type and EO class are shared
    (spec syntax), offsets/band position are per component.

    Returns per-plane (type, class, band, off) map tuples (cb_maps,
    cr_maps) plus the joint chroma RD cost map."""
    max_off = (1 << (min(bit_depth, 10) - 5)) - 1
    planes = []
    for stats in (stats_cb, stats_cr):
        eo_sum, eo_cnt, bo_sum, bo_cnt = (np.asarray(a).astype(np.float64)
                                          for a in stats)
        eo_off = np.zeros((4, 4) + eo_sum.shape[-2:], np.int32)
        eo_cost = np.zeros((4, 4) + eo_sum.shape[-2:])
        for cat in range(1, 5):
            sgn = 1 if cat <= 2 else -1
            o, c = _best_offset_vec(eo_sum[:, cat], eo_cnt[:, cat], lam,
                                    sgn, max_off)
            eo_off[:, cat - 1] = o
            eo_cost[:, cat - 1] = c
        bo_o, bo_c = _best_offset_vec(bo_sum, bo_cnt, lam, 0, max_off)
        win = np.stack([bo_c[s0:s0 + 4].sum(axis=0) for s0 in range(29)])
        planes.append((eo_off, eo_cost.sum(axis=1), bo_o, win))

    ncy, ncx = planes[0][1].shape[-2:]
    eo_joint = planes[0][1] + planes[1][1] + lam * 2.0    # (4, ncy, ncx)
    best_cls = np.argmin(eo_joint, axis=0)
    best_eo = np.take_along_axis(eo_joint, best_cls[None], 0)[0]
    start_b = np.argmin(planes[0][3], axis=0)
    start_r = np.argmin(planes[1][3], axis=0)
    best_bo = np.take_along_axis(planes[0][3], start_b[None], 0)[0] + \
        np.take_along_axis(planes[1][3], start_r[None], 0)[0] + lam * 12.0

    use_eo = (best_eo < 0) & (best_eo <= best_bo)
    use_bo = (best_bo < 0) & ~use_eo
    out = []
    for pi, start in ((0, start_b), (1, start_r)):
        eo_off, _, bo_o, _ = planes[pi]
        tm = np.zeros((ncy, ncx), np.int32)
        cm = np.zeros((ncy, ncx), np.int32)
        bm = np.zeros((ncy, ncx), np.int32)
        om = np.zeros((ncy, ncx, 4), np.int32)
        tm[use_eo] = SAO_EDGE
        tm[use_bo] = SAO_BAND
        cm[use_eo] = best_cls[use_eo]
        bm[use_bo] = start[use_bo]
        for k in range(4):
            eo_k = np.take_along_axis(eo_off[:, k], best_cls[None], 0)[0]
            bo_k = np.take_along_axis(
                bo_o, np.minimum(start + k, 31)[None], 0)[0]
            om[..., k] = np.where(use_eo, eo_k,
                                  np.where(use_bo, bo_k, 0))
        out.append((tm, cm, bm, om))
    cost_map = np.where(use_eo, best_eo, np.where(use_bo, best_bo, 0.0))
    return out[0], out[1], cost_map


# ---------------------------------------------------------------------------
# Merge RDO (x265 sao.cpp rdoSaoUnitCu:1214 merge-left/up decisions)
# ---------------------------------------------------------------------------

def _param_dist(stats, cy: int, cx: int, t: int, cls: int, band: int,
                offs) -> float:
    """RD distortion delta of applying a given param set to one CTU's
    stats: sum over categories of c*o^2 - 2*o*s (x265 estSaoDist)."""
    eo_sum, eo_cnt, bo_sum, bo_cnt = stats
    d = 0.0
    if t == SAO_EDGE:
        for cat in range(1, 5):
            o = int(offs[cat - 1])
            c = float(eo_cnt[cls, cat, cy, cx])
            sm = float(eo_sum[cls, cat, cy, cx])
            d += c * o * o - 2.0 * o * sm
    elif t == SAO_BAND:
        for k in range(4):
            o = int(offs[k])
            b = (band + k) % 32
            c = float(bo_cnt[b, cy, cx])
            sm = float(bo_sum[b, cy, cx])
            d += c * o * o - 2.0 * o * sm
    return d


def sao_merge_pass(stats3, maps3, cost_new, lam: float,
                   slice_top_rows=()) -> np.ndarray:
    """Raster merge-left/up RDO over the CTU grid (merge applies to all
    three components jointly, spec 7.3.8.3).

    stats3: per-plane (eo_sum, eo_cnt, bo_sum, bo_cnt) numpy stats.
    maps3: per-plane [type, class, band, off] maps — REWRITTEN in place
    to the merged params where a merge wins.
    cost_new: (ncy, ncx) summed RD cost of the explicit decision.
    slice_top_rows: CTU rows starting a new slice (merge-up forbidden
    across; merge-left allowed, slices are whole rows).
    Returns merge_map (ncy, ncx) int8: 0 none, 1 left, 2 up."""
    ncy, ncx = cost_new.shape
    tops = set(slice_top_rows)
    merge_map = np.zeros((ncy, ncx), np.int8)

    def params_at(cy, cx):
        return [(int(m[0][cy, cx]), int(m[1][cy, cx]), int(m[2][cy, cx]),
                 tuple(int(o) for o in m[3][cy, cx])) for m in maps3]

    def dist_of(cy, cx, prm3):
        return sum(_param_dist(stats3[pi], cy, cx, *prm3[pi])
                   for pi in range(3))

    for cy in range(ncy):
        for cx in range(ncx):
            has_left = cx > 0
            has_up = cy > 0 and cy not in tops
            nflags = int(has_left) + int(has_up)
            best = float(cost_new[cy, cx]) + lam * nflags
            choice, src = 0, None
            if has_left:
                prm = params_at(cy, cx - 1)
                c = dist_of(cy, cx, prm) + lam * 1.0
                if c < best:
                    best, choice, src = c, 1, prm
            if has_up:
                prm = params_at(cy - 1, cx)
                c = dist_of(cy, cx, prm) + lam * (1.0 + int(has_left))
                if c < best:
                    best, choice, src = c, 2, prm
            if choice:
                merge_map[cy, cx] = choice
                for pi, m in enumerate(maps3):
                    t, cls, band, offs = src[pi]
                    m[0][cy, cx] = t
                    m[1][cy, cx] = cls
                    m[2][cy, cx] = band
                    m[3][cy, cx] = offs
    return merge_map
