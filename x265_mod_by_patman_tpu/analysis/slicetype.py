"""Slicetype decision lookahead: lowres (p0, p1, b) cost lattice +
b-adapt path DP + cost-based scenecut.

Batched analog of the reference lookahead decision core (x265
slicetype.cpp slicetypeDecide:1996, slicetypePath:3468,
scenecutInternal:2832, CostEstimateGroup::estimateFrameCost):

 - the reference estimates each (p0, p1, b) frame cost with per-block
   worker threads as the DP asks for it; here ALL triples a decision
   round needs are evaluated in ONE batched device dispatch (triples are
   a batch axis padded to a fixed lane count so shapes stay static);
 - per-block cost = min(intra, me(p0), me(p1), bi-average) exactly as
   the reference's lowres model (bidir = SATD against the averaged
   predictions, slicetype.cpp:2287);
 - the path search is a dense bottom-up DP over P-anchor placements
   (cost of covering frames i..N) instead of the reference's recursive
   string enumeration — same optimum, no branching.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.cost import satd_batch
from ..ops.interp import mc_batch
from ..ops.me import full_search_batch, subpel_refine_batch
from .lookahead import LowresStore, hme_seeds, \
    LOG2N, N, LOOKAHEAD_LAMBDA_X256, SEARCH_RANGE

MAX_TRIPLES = 16          # lattice dispatch lane count (padded)


@partial(jax.jit, static_argnums=(4, 5, 7))
def _lattice_costs(stack, triples, is_b, valid, nby: int, nbx: int,
                   intra, hme: bool = False):
    """Frame costs for a padded batch of (b, p0, p1) triples.

    stack:   (F, h, w) int32 lowres planes
    triples: (T, 3) int32 indices into stack (b, p0, p1)
    is_b:    (T,) bool — p1 is a distinct future ref (else P: list0 only)
    valid:   (T,) bool — lane is live (padding lanes recompute lane 0)
    intra:   (F, nby, nbx) int32 lowres intra costs
    Returns (T,) float32 frame costs and (T, nby, nbx) block costs.
    """
    h, w = stack.shape[1:]
    bys, bxs = jnp.mgrid[0:nby, 0:nbx]
    x0 = (bxs.ravel() * N).astype(jnp.int32)
    y0 = (bys.ravel() * N).astype(jnp.int32)
    zero = jnp.zeros_like(x0)
    oy = y0[:, None, None] + jnp.arange(N)[None, :, None]
    ox = x0[:, None, None] + jnp.arange(N)[None, None, :]

    def one(tr, b_flag):
        b, p0, p1 = tr[0], tr[1], tr[2]
        cur = stack[b]
        org = cur[oy, ox]

        def me_pred(ref):
            # integer full search then qpel refinement: the reference
            # lookahead is qpel-accurate on lowres (lowres.h:74-120
            # lowresQPelCost) — integer-only ME misses odd-pixel
            # fullres motion (0.5 px at lowres) and misfires scenecut
            cx = cy = None
            if hme:
                # 1/4-of-lowres HME tier seeds the window center
                # (x265 --hme; analysis.lookahead.hme_seeds)
                cx, cy = hme_seeds(cur, ref, nby, nbx)
            mvx, mvy, _ = full_search_batch(
                ref, cur, x0, y0, zero, zero, LOOKAHEAD_LAMBDA_X256, N,
                SEARCH_RANGE, center_x=cx, center_y=cy)
            mvx, mvy, cost = subpel_refine_batch(
                ref, cur, x0, y0, mvx, mvy, zero, zero,
                LOOKAHEAD_LAMBDA_X256, N, 8, subme=2)
            return mc_batch(ref, x0, y0, mvx, mvy, N), cost

        pr0, c0 = me_pred(stack[p0])
        pr1, c1 = me_pred(stack[p1])
        cbi = satd_batch(org, (pr0 + pr1 + 1) >> 1)
        ic = intra[b].reshape(-1)
        best = jnp.where(b_flag,
                         jnp.minimum(jnp.minimum(c0, c1),
                                     jnp.minimum(cbi, ic)),
                         jnp.minimum(c0, ic))
        return best.reshape(nby, nbx)

    blocks = jax.vmap(one)(jnp.where(valid[:, None], triples,
                                     triples[0][None, :]), is_b)
    return blocks.sum(axis=(1, 2)).astype(jnp.float32), blocks


class SlicetypeLookahead:
    """Sliding lowres window keyed by display index.

    push() registers a frame's padded luma; decide_gop() returns the
    length k of the next mini-GOP (frames start..start+k-1 are B,
    frame start+k-1 is the P anchor) using the b-adapt DP; scenecut()
    applies the reference's intra/inter cost ratio test."""

    def __init__(self, pad_w: int, pad_h: int, bframes: int,
                 b_adapt: int = 1, scenecut_bias: float = 0.05,
                 scenecut_threshold: int = 40,
                 b_frame_bias: int = 0, hme: bool = False,
                 store: Optional[LowresStore] = None) -> None:
        self.hme = bool(hme)
        self.store = store if store is not None \
            else LowresStore(pad_w, pad_h)
        self.store.register("slicetype")
        self.w, self.h = self.store.w, self.store.h
        self.nbx, self.nby = self.store.nbx, self.store.nby
        self.bframes = bframes
        self.b_adapt = b_adapt
        self.b_frame_bias = b_frame_bias
        self.bias = scenecut_bias
        self.thresh = scenecut_threshold / 100.0
        self._have: set = set()        # display indices pushed (window)
        self._cost: Dict[Tuple[int, int, int], float] = {}

    def push(self, disp: int, y_padded: np.ndarray) -> None:
        """Register a frame.  Nothing here blocks on the device: the
        lowres decimation + intra sweep are dispatched asynchronously
        and the host scalars download lazily on first use."""
        self.store.ensure(disp, y_padded)
        self._have.add(disp)

    def has(self, disp: int) -> bool:
        return disp in self._have

    def fade_state(self, disp: int) -> int:
        """+1 fade-in / -1 fade-out / 0 none, from the lowres luma DC
        trend over the trailing 4 frames (reference x265 --fades
        detection, slicetype.cpp:917 lowres DC walk): a sustained
        monotonic brightness ramp is a fade, not a scene change, so
        scenecut must hold fire until the ramp ends (and weightP picks
        up the luminance shift)."""
        ds = [d for d in (disp - 3, disp - 2, disp - 1, disp)
              if d in self._have]
        if len(ds) < 3:
            return 0
        means = [self.store.dc(d) for d in ds]
        deltas = [b - a for a, b in zip(means, means[1:])]
        if all(d > 0.7 for d in deltas) and means[-1] - means[0] > 3.5:
            return 1
        if all(d < -0.7 for d in deltas) and means[0] - means[-1] > 3.5:
            return -1
        return 0

    def drop_before(self, disp: int) -> None:
        self._have = {d for d in self._have if d >= disp}
        self._cost = {k: v for k, v in self._cost.items()
                      if min(k) >= disp}
        self.store.release("slicetype", disp)

    def intra_cost(self, disp: int) -> float:
        return self.store.intra_sum(disp)

    def _eval_triples(self, triples: List[Tuple[int, int, int]]) -> None:
        """Batch-evaluate uncached (b, p0, p1) triples (display idx)."""
        todo = [t for t in dict.fromkeys(triples) if t not in self._cost
                and t[0] in self._have and t[1] in self._have
                and t[2] in self._have]
        if not todo:
            return
        for base in range(0, len(todo), MAX_TRIPLES):
            chunk = todo[base:base + MAX_TRIPLES]
            # power-of-two lane buckets: the rate-control path asks for
            # ONE triple per ingested frame, and a fixed 16-lane pad
            # would compute 16 lattice lanes for it (10+ s/frame at
            # 1080p); distinct bucket sizes compile once each
            lanes = 1 << max(0, (len(chunk) - 1).bit_length())
            # the plane stack holds only the frames THIS chunk touches,
            # padded to a pow2 frame count: a stack of the whole
            # sliding window would recompile the lattice program for
            # every window length and
            # copy the full window per dispatch
            keys = sorted({d for tr in chunk for d in tr})
            nf = 1 << max(0, (len(keys) - 1).bit_length())
            keys = keys + [keys[0]] * (nf - len(keys))
            kidx = {d: i for i, d in enumerate(keys)}
            stack = jnp.stack([self.store.low(d) for d in keys])
            intra = jnp.stack([self.store.intra_dev(d) for d in keys])
            t = np.zeros((lanes, 3), np.int32)
            is_b = np.zeros(lanes, bool)
            valid = np.zeros(lanes, bool)
            for i, (b, p0, p1) in enumerate(chunk):
                t[i] = (kidx[b], kidx[p0], kidx[p1])
                is_b[i] = p1 != b
                valid[i] = True
            fc, _ = _lattice_costs(stack, jnp.asarray(t),
                                   jnp.asarray(is_b), jnp.asarray(valid),
                                   self.nby, self.nbx, intra, self.hme)
            fc = np.asarray(fc)
            for i, key in enumerate(chunk):
                c = float(fc[i])
                if is_b[i]:
                    # B-frame cost discount before any path/GOP
                    # comparison (reference estimateFrameCost,
                    # slicetype.cpp:4322: score = score*100/(130+bias)
                    # when b != p1) — B frames code cheaper per unit
                    # SATD (higher QP, no propagation), so raw-sum
                    # paths would otherwise always favor P chains
                    c = c * 100.0 / (130.0 + self.b_frame_bias)
                self._cost[key] = c

    def frame_cost(self, b: int, p0: int, p1: int) -> float:
        key = (b, p0, p1)
        if key not in self._cost:
            self._eval_triples([key])
        got = self._cost.get(key)
        if got is None:
            got = self.store.intra_sum(b) if b in self._have else 0.0
        return got

    def gop_cost(self, p0: int, frames: List[int]) -> float:
        """Cost of a mini-GOP: frames[:-1] are B (refs p0/frames[-1]),
        frames[-1] is P (ref p0)."""
        anchor = frames[-1]
        c = self.frame_cost(anchor, p0, anchor)
        for b in frames[:-1]:
            c += self.frame_cost(b, p0, anchor)
        return c

    def decide_gop(self, p0: int, queue: List[int]) -> int:
        """Length of the next mini-GOP covering queue[0:k] given the
        last anchor p0.  b_adapt 0: always the max; 1: single-GOP
        horizon argmin; 2: full-path DP over the queue (slicetypePath
        analog)."""
        maxk = min(len(queue), self.bframes + 1)
        if self.b_adapt == 0 or maxk == 1:
            return maxk
        # prefetch every triple any path can ask for, in one dispatch
        want = []
        horizon = queue if self.b_adapt == 2 else queue[:maxk]
        n = len(horizon)
        starts = [p0] + horizon
        for i in range(n):
            for k in range(1, min(self.bframes + 1, n - i) + 1):
                a = starts[i]          # anchor before frame i
                anchor = horizon[i + k - 1]
                want.append((anchor, a, anchor))
                for j in range(i, i + k - 1):
                    want.append((horizon[j], a, anchor))
        self._eval_triples(want)
        if self.b_adapt == 1:
            best_k, best = 1, float("inf")
            for k in range(1, maxk + 1):
                c = self.gop_cost(p0, queue[:k]) / k
                if c < best:
                    best, best_k = c, k
            return best_k
        # b_adapt 2: DP C[i] = min_k gop(i, k) + C[i+k]
        INF = float("inf")
        C = [0.0] * (n + 1)
        choice = [1] * (n + 1)
        for i in range(n - 1, -1, -1):
            C[i], choice[i] = INF, 1
            a = starts[i]
            for k in range(1, min(self.bframes + 1, n - i) + 1):
                c = self.gop_cost(a, horizon[i:i + k]) + C[i + k]
                if c < C[i]:
                    C[i], choice[i] = c, k
        return choice[0]

    def scenecut(self, b: int, p0: int, dist_to_key: int,
                 min_key: int, max_key: int) -> bool:
        """Reference scenecutInternal (slicetype.cpp:2832): I when the
        P cost is no better than (1 - bias) of the intra cost, the bias
        ramping from threshMin/4 near the last keyframe up to threshMax
        as the frame approaches keyint-max."""
        if b not in self._have or p0 not in self._have:
            return False
        icost = self.intra_cost(b)
        if icost <= 0:
            return False
        pcost = self.frame_cost(b, p0, b)
        thresh_max = self.thresh
        thresh_min = thresh_max * 0.25
        if min_key > 0 and dist_to_key <= min_key / 4:
            bias = thresh_min / 4
        elif min_key > 0 and dist_to_key <= min_key:
            bias = thresh_min * dist_to_key / min_key
        elif max_key > min_key:
            bias = thresh_min + (thresh_max - thresh_min) \
                * (dist_to_key - min_key) / (max_key - min_key)
        else:
            bias = thresh_max
        return pcost >= (1.0 - min(max(bias, 0.0), thresh_max)) * icost
