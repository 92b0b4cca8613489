"""Measurements for BASELINE.md configs 2-4 (1080p fast CRF, 1080p10
medium ABR, 4K slow VBV): fps, warm fps, bitrate and the device time of
the whole-frame P analysis program.

  python tools/bench_configs.py [--configs 2,3] [--frames 24] \
      [--out results.json]

Per config prints one JSON line:
  {"config": N, "fps": ..., "warm_fps": ..., "kbps": ...,
   "device_kind": ..., "analysis_ms_per_frame": ...}
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

def synth_clip(w, h, n, bd=8, seed=9):
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 255, (h + 64, w + 64)).astype(np.int32)
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) // 3
    mx = (1 << bd) - 1
    sh = bd - 8
    dt = np.uint8 if bd == 8 else np.uint16
    frames = []
    for i in range(n):
        y = big[4 + i:4 + i + h, 4 + 2 * i:4 + 2 * i + w]
        y = np.clip((y << sh) + rng.integers(-4 << sh, (4 << sh) + 1,
                                             (h, w)), 0, mx)
        u = np.full((h // 2, w // 2), 100 << sh, np.int32)
        v = np.full((h // 2, w // 2), 140 << sh, np.int32)
        frames.append((y.astype(dt), u.astype(dt), v.astype(dt)))
    return frames


def make_params(cfg: int, w, h):
    from x265_mod_by_patman_tpu.params import default_params
    if cfg == 2:
        p = default_params(w, h, rc_mode="crf", crf=23.0)
        p.apply_preset("fast")
        p.max_num_references = 2
        p.open_gop = True
    elif cfg == 3:
        p = default_params(w, h, rc_mode="abr", bitrate_kbps=6000,
                           internal_bit_depth=10)
        p.apply_preset("medium")
        p.b_pyramid = True
        p.rdoq_level = 2
        p.master_display = ("G(13250,34500)B(7500,3000)R(34000,16000)"
                            "WP(15635,16450)L(10000000,1)")
        p.max_cll = 1000
        p.max_fall = 400
    else:
        p = default_params(w, h, rc_mode="crf", crf=24.0)
        p.apply_preset("slow")
        p.hme = True
        p.rc_lookahead = 40
        p.vbv_bufsize = 25000
        p.vbv_maxrate = 25000
    p.info_sei = False
    p.scenecut = True
    # device/host overlap via frame-parallel B (the x265 auto
    # frame-threads analog: 2 for a 4-core host, threading.rst:199)
    p.frame_parallel_window = 2
    return p


def bench_config(cfg: int, frames_n: int):
    import jax
    from x265_mod_by_patman_tpu.encoder.top import Encoder
    if cfg in (2, 3):
        w, h = 1920, 1080
    else:
        w, h = 3840, 2160
    scale = int(os.environ.get("BENCH_CONFIGS_SCALE", "1"))
    if scale > 1:                     # CPU smoke-testing only
        w, h = w // scale, h // scale
    bd = 10 if cfg == 3 else 8
    clip = synth_clip(w, h, frames_n, bd=bd)
    p = make_params(cfg, w, h)
    p.validate()
    enc = Encoder(p)
    t0 = time.time()
    out_stamps = []
    nbytes = 0
    for (y, u, v) in clip:
        for f in enc.encode_frame(y, u, v):
            nbytes += len(f.bitstream)
            out_stamps.append(time.time())
    for f in enc.flush():
        nbytes += len(f.bitstream)
        out_stamps.append(time.time())
    t_end = time.time()
    nout = len(out_stamps)
    total = t_end - t0
    fps = nout / total
    # warm fps: encode the SAME clip again in this process with a fresh
    # encoder — every program is already compiled, so the second pass
    # is the honest steady-state end-to-end rate (the old emission-
    # window heuristic collapsed into the flush burst on short clips)
    enc2 = Encoder(p.validate())
    t2 = time.time()
    n2 = 0
    for (y, u, v) in clip:
        n2 += len(enc2.encode_frame(y, u, v))
    n2 += len(enc2.flush())
    warm_fps = n2 / (time.time() - t2)

    # device time of the dominant device program: whole-frame P
    # analysis (full search + subpel + candidate rounds + MC)
    from x265_mod_by_patman_tpu.analysis.inter_mode import analyse_p_frame
    dev = jax.devices()[0]
    ypad = enc._pad(clip[0][0], 0).astype(np.int32)
    upad = enc._pad(clip[0][1], 1).astype(np.int32)
    vpad = enc._pad(clip[0][2], 1).astype(np.int32)
    refp = (enc._pad(clip[1][0], 0).astype(np.int32), upad, vpad)
    sr = enc._me_range
    analyse_p_frame(ypad, upad, vpad, [refp], enc.sps, 32,
                    search_range=sr, subme=p.subpel_refine)   # compile
    t1 = time.time()
    reps = 3
    for _ in range(reps):
        analyse_p_frame(ypad, upad, vpad, [refp], enc.sps, 32,
                        search_range=sr, subme=p.subpel_refine)
    d_s = (time.time() - t1) / reps
    return {
        "config": cfg,
        "geometry": f"{w}x{h}@{bd}bit",
        "frames": nout,
        "fps": round(fps, 3),
        "warm_fps": round(warm_fps, 3),
        "kbps": round(nbytes * 8 * (p.fps_num / p.fps_denom)
                      / max(nout, 1) / 1000.0, 1),
        "total_s": round(total, 1),
        "device_kind": dev.device_kind,
        "analysis_ms_per_frame": round(d_s * 1000.0, 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="2,3")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--out", default="")
    a = ap.parse_args()
    from x265_mod_by_patman_tpu.utils.device import use_compile_cache
    use_compile_cache()
    results = []
    for cfg in [int(c) for c in a.configs.split(",")]:
        r = bench_config(cfg, a.frames)
        results.append(r)
        print(json.dumps(r), flush=True)
    if a.out:
        json.dump(results, open(a.out, "w"), indent=1)


if __name__ == "__main__":
    main()
