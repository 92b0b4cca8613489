"""Benchmark: intra-only CQP encode throughput (north-star config 1 shape).

Encodes synthetic 416x240 8-bit frames at QP32 intra-only (the
BasketballPass configuration from BASELINE.md) and reports frames/s.

Prints ONE JSON line:
  {"metric": ..., "value": fps, "unit": "frames/s", "vs_baseline": ratio}

vs_baseline compares against the reference x265 (CPU, --preset ultrafast
--qp 32 --keyint 1) measured on this host when BASELINE_X265_FPS is set or
a cached measurement exists in baseline_x265.json; 0.0 = baseline not yet
measured.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

from x265_mod_by_patman_tpu.utils.device import (  # noqa: E402
    gpu_card, use_compile_cache)

use_compile_cache()

W, H, QP, FRAMES = 416, 240, 32, 8


def synth_frames(n, w=W, h=H):
    rng = np.random.default_rng(42)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for i in range(n):
        y = ((xx + 3 * i) * 255 // w + yy * 80 // h) % 256
        y[h // 4:h // 2, w // 4 + i:w // 2 + i] = 200
        y = np.clip(y + rng.integers(-8, 9, (h, w)), 0, 255).astype(np.uint8)
        u = ((xx[::2, ::2] + 2 * yy[::2, ::2] + i) % 200 + 20).astype(np.uint8)
        v = ((2 * xx[::2, ::2] - yy[::2, ::2] - i) % 180 + 30).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def main():
    import jax as _jax
    from x265_mod_by_patman_tpu.params import default_params
    from x265_mod_by_patman_tpu.encoder.top import Encoder
    from x265_mod_by_patman_tpu.analysis.intra_mode import \
        decide_modes_rd_multi

    n_bench = max(FRAMES, 48)
    frames = synth_frames(n_bench + 16)
    # ultrafast-equivalent intra config (matches the x265 baseline run:
    # deblock on, SAO off at ultrafast).  Production multi-frame path:
    # batched mode decision + vmapped wavefront + batched deblock chained
    # on device, device->host transfers packed + async, host entropy
    # overlapping device compute.  The repo DEFAULTS are
    # medium-equivalent (ctu 64, rd 3) and would benchmark a different
    # operating point.
    p = default_params(W, H, qp=QP, keyframe_max=1, sao=False,
                       ctu_size=32, rd_level=2)
    enc = Encoder(p)

    # batch choice by measured median-of-3 at BOTH 8 and 16; the spread
    # is reported so a noisy capture is visible in the JSON
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: no GPU found (default device {dev})")
    card = gpu_card()
    batches = (8, 16)
    reps = 3
    runs = {}
    nbytes = 0
    for batch in batches:
        enc.encode_intra_batched(frames[:batch], batch=batch)  # compile
        runs[batch] = []
        for _ in range(reps):
            t0 = time.time()
            nb = 0
            for out in enc.encode_intra_batched(
                    frames[16:16 + n_bench], batch=batch):
                nb += len(out.bitstream)
            runs[batch].append(n_bench / (time.time() - t0))
            nbytes = nb
    med = {b: sorted(v)[len(v) // 2] for b, v in runs.items()}
    batch = max(med, key=lambda b: med[b])
    fps = med[batch]
    all_runs = [round(x, 2) for b in batches for x in runs[b]]
    spread = (max(runs[batch]) - min(runs[batch])) / fps if fps else 0.0

    # device-only time for one batch (separates kernel cost from the
    # host floor)
    ys = np.stack([enc._pad(f[0], 0) for f in frames[:batch]])
    us = np.stack([enc._pad(f[1], 1) for f in frames[:batch]])
    vs = np.stack([enc._pad(f[2], 1) for f in frames[:batch]])
    td = time.time()
    md = decide_modes_rd_multi(ys, enc.sps, QP)
    rd = enc.recon.run_batch(ys, us, vs, md, qp=QP, materialize=False)
    _jax.block_until_ready(rd["recon_y"])
    dev_s = (time.time() - td) / batch

    baseline = float(os.environ.get("BASELINE_X265_FPS", 0) or 0)
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "baseline_x265.json")
    if not baseline and os.path.exists(cache):
        try:
            baseline = float(json.load(open(cache)).get(
                "intra_fps_416x240_qp32", 0))
        except Exception:
            baseline = 0.0
    print(json.dumps({
        "metric": "intra_fps_416x240_qp32",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / baseline, 4) if baseline else 0.0,
        "device_s_per_frame": round(dev_s, 4),
        "device_only_fps": round(1.0 / dev_s, 2) if dev_s else 0.0,
        "kbps": round(nbytes * 8 * 25.0 / n_bench / 1000.0, 1),
        "batch": batch,
        "runs_fps": all_runs,
        "spread_pct": round(100.0 * spread, 1),
        "backend": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
    }))


if __name__ == "__main__":
    main()
