"""Deterministic synthetic test clips for the RD harness.

The round-2 measurements used a downscaled real 1080p clip that lived in
/tmp and did not survive the host swap; these generators are checked in
so every future round measures on byte-identical content (same seeds,
same procedure — SURVEY §6 requires the sweep procedure to be
reproducible, not a particular clip).

Four profiles:
  park   — "real content" stand-in: multi-octave value-noise ground +
           smooth sky gradient, slow global pan with varying velocity,
           two moving occluders, mild static grain.  MC-friendly
           structure with fine texture (the regime where skip/merge
           decisions and residual rate models matter).
  nat    — static noise texture, no motion (intra-ish inter content).
  bench  — pan + per-frame re-randomized noise (MC-adversarial).
  field  — smooth world + per-frame sensor grain (the 1080p-park
           regime at any size); not in the default --clips set.

Usage: python tools/make_clips.py [--frames 12] [--w 416 --h 240]
       [--out-dir /tmp]
Writes <out-dir>/{park,nat,bench}_<w>x<h>.y4m (8-bit 4:2:0).
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def _value_noise(rng, h, w, octaves=(8, 16, 32, 64), amp=(80, 40, 20, 10)):
    """Multi-octave value noise in [0,255] float."""
    out = np.zeros((h, w), np.float32)
    for cell, a in zip(octaves, amp):
        gh, gw = h // cell + 2, w // cell + 2
        g = rng.random((gh, gw)).astype(np.float32)
        yy = np.arange(h, dtype=np.float32) / cell
        xx = np.arange(w, dtype=np.float32) / cell
        y0 = yy.astype(np.int32)
        x0 = xx.astype(np.int32)
        fy = (yy - y0)[:, None]
        fx = (xx - x0)[None, :]
        fy = fy * fy * (3 - 2 * fy)
        fx = fx * fx * (3 - 2 * fx)
        v = (g[y0][:, x0] * (1 - fy) * (1 - fx)
             + g[y0][:, x0 + 1] * (1 - fy) * fx
             + g[y0 + 1][:, x0] * fy * (1 - fx)
             + g[y0 + 1][:, x0 + 1] * fy * fx)
        out += a * (v - 0.5)
    return out


def _write_y4m(path, frames, w, h):
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F25:1 Ip A1:1 C420\n".encode())
        for (y, u, v) in frames:
            f.write(b"FRAME\n")
            f.write(y.astype(np.uint8).tobytes())
            f.write(u.astype(np.uint8).tobytes())
            f.write(v.astype(np.uint8).tobytes())


def make_park(w, h, n, seed=7):
    rng = np.random.default_rng(seed)
    # world 2x wider than the frame; camera pans across it
    ww, wh = w * 2 + 64, h + 64
    ground = _value_noise(rng, wh, ww) + 110.0
    sky = (np.linspace(180, 120, wh, dtype=np.float32)[:, None]
           * np.ones((1, ww), np.float32))
    horizon = wh // 3
    world = np.where(np.arange(wh)[:, None] < horizon, sky, ground)
    wu = _value_noise(rng, wh // 2, ww // 2, (16, 32), (24, 12)) + 118.0
    wv = _value_noise(rng, wh // 2, ww // 2, (16, 32), (20, 10)) + 134.0
    grain = rng.normal(0, 2.0, (wh, ww)).astype(np.float32)
    world = world + grain
    frames = []
    # varying pan velocity (px/frame), quarter-ish positions via rounding
    xs = np.cumsum(2.0 + 1.5 * np.sin(np.arange(n) / 4.0))
    for i in range(n):
        # clamp the pan so long clips can't walk off the 2w+64 world
        # (no-op at the default 12-frame / 416x240 geometry)
        ox, oy = min(int(round(xs[i])) + 8, ww - w), 16
        y = world[oy:oy + h, ox:ox + w].copy()
        u = wu[oy // 2:oy // 2 + h // 2, ox // 2:ox // 2 + w // 2].copy()
        v = wv[oy // 2:oy // 2 + h // 2, ox // 2:ox // 2 + w // 2].copy()
        # two occluders moving against the pan
        for k, (spd, y0, sz, val) in enumerate(
                ((-3, h // 2, 40, 60), (5, h // 4, 24, 200))):
            # clamp occluder geometry to the frame for small --w/--h
            # (no-op at the default 416x240)
            sz = min(sz, h - y0, w - 1)
            if sz < 2:
                continue
            x0 = (40 + 120 * k + spd * i) % (w - sz)
            yy, xx = np.mgrid[0:sz, 0:sz]
            mask = ((yy - sz / 2) ** 2 + (xx - sz / 2) ** 2) < (sz / 2) ** 2
            blk = y[y0:y0 + sz, x0:x0 + sz]
            blk[mask] = val + 8 * np.sin(xx[mask] / 3.0)
            u[y0 // 2:(y0 + sz) // 2, x0 // 2:(x0 + sz) // 2] += \
                (20 if k == 0 else -16)
        # per-frame sensor noise: the non-compensable residual floor
        # that makes coded-vs-skip decisions non-trivial on real footage
        y += rng.normal(0, 1.8, y.shape)
        u += rng.normal(0, 1.0, u.shape)
        v += rng.normal(0, 1.0, v.shape)
        frames.append((np.clip(y, 0, 255), np.clip(u, 0, 255),
                       np.clip(v, 0, 255)))
    return frames


def make_field(w, h, n, seed=13):
    """Smooth world + per-frame sensor grain: the 1080p-park regime at
    any resolution.  Content detail lives on LARGE cells (low per-pixel
    gradient) so MC/intra residuals are dominated by the per-frame
    grain; this is the rate-model x lambda regime where the round-5
    1080p BD measurement found a 2.6x overspend vs the anchor (the
    default park profile has strong 8-px texture that masks it)."""
    rng = np.random.default_rng(seed)
    ww, wh = w * 2 + 64, h + 64
    ground = _value_noise(rng, wh, ww, octaves=(48, 96, 192),
                          amp=(40, 25, 15)) + 110.0
    sky = (np.linspace(180, 120, wh, dtype=np.float32)[:, None]
           * np.ones((1, ww), np.float32))
    horizon = wh // 3
    world = np.where(np.arange(wh)[:, None] < horizon, sky, ground)
    wu = _value_noise(rng, wh // 2, ww // 2, (64, 128), (18, 10)) + 118.0
    wv = _value_noise(rng, wh // 2, ww // 2, (64, 128), (14, 8)) + 134.0
    world = world + rng.normal(0, 2.0, (wh, ww)).astype(np.float32)
    frames = []
    xs = np.cumsum(2.0 + 1.5 * np.sin(np.arange(n) / 4.0))
    for i in range(n):
        ox, oy = min(int(round(xs[i])) + 8, ww - w), 16
        y = world[oy:oy + h, ox:ox + w].copy()
        u = wu[oy // 2:oy // 2 + h // 2, ox // 2:ox // 2 + w // 2].copy()
        v = wv[oy // 2:oy // 2 + h // 2, ox // 2:ox // 2 + w // 2].copy()
        y += rng.normal(0, 1.8, y.shape)
        u += rng.normal(0, 1.0, u.shape)
        v += rng.normal(0, 1.0, v.shape)
        frames.append((np.clip(y, 0, 255), np.clip(u, 0, 255),
                       np.clip(v, 0, 255)))
    return frames


def make_nat(w, h, n, seed=11):
    rng = np.random.default_rng(seed)
    y = np.clip(_value_noise(rng, h, w, (4, 8, 16), (60, 40, 25))
                + 128 + rng.normal(0, 6, (h, w)), 0, 255)
    u = np.clip(_value_noise(rng, h // 2, w // 2, (8, 16), (30, 15))
                + 128, 0, 255)
    v = np.full((h // 2, w // 2), 128.0)
    return [(y, u, v)] * n


def make_bench(w, h, n, seed=42):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for i in range(n):
        y = ((xx + 3 * i) * 255 // w + yy * 80 // h) % 256
        y = np.clip(y + rng.normal(0, 8, (h, w)), 0, 255)
        u = np.clip(128 + ((xx[::2, ::2] + 5 * i) % 64) - 32
                    + rng.normal(0, 4, (h // 2, w // 2)), 0, 255)
        v = np.full((h // 2, w // 2), 128.0)
        frames.append((y, u, v))
    return frames


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--w", type=int, default=416)
    ap.add_argument("--h", type=int, default=240)
    ap.add_argument("--out-dir", default="/tmp")
    ap.add_argument("--clips", default="park,nat,bench")
    a = ap.parse_args()
    os.makedirs(a.out_dir, exist_ok=True)
    gen = {"park": make_park, "nat": make_nat, "bench": make_bench,
           "field": make_field}
    for name in a.clips.split(","):
        frames = gen[name](a.w, a.h, a.frames)
        path = os.path.join(a.out_dir, f"{name}_{a.w}x{a.h}.y4m")
        _write_y4m(path, frames, a.w, a.h)
        print(path)


if __name__ == "__main__":
    main()
