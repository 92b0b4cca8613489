"""Smoke test: the encoder's main path on one NVIDIA GPU.

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # four cards, multi-device paths only

One process.  Any failed check raises, and the script exits non-zero.
Phases, in order:

  device   card name and power limit, JAX devices, the native entropy
           library (required)
  kernels  at 1920x1080, as compiled for the card: integer full search
           (r=16 and r=32, with and without HME centres) and the
           integer transform, quant, SATD and MC paths equal their
           numpy goldens and the CPU backend; full-search timings
  encode   BASELINE config 2 (--preset fast --crf 23 --ref 2 --open-gop)
           on a 1080p park clip through cli.main, twice; the stream
           decodes with every picture's MD5 equal to its SEI MD5 and
           holds I, P and B slices
  parity   a 416x240 IPB clip encoded on the GPU and on the CPU backend
           gives identical bytes

With --four-cards: multi-stream P/B (one stream per card), tile-row
sharded P analysis and frame-parallel B at 1080p, each byte-identical
to its one-device encode.

Timings are smoke readings, printed beside the card name and power
limit.  The last line of stdout is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

import jax  # noqa: E402

from x265_mod_by_patman_tpu.utils.device import (  # noqa: E402
    gpu_card, use_compile_cache)

W, H = 1920, 1080
CONFIG2 = ["--preset", "fast", "--crf", "23", "--ref", "2", "--open-gop"]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def median_s(fn, reps: int = 7) -> float:
    """Median seconds of fn() after one warm-up call; every run ends in
    block_until_ready."""
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


# -- device -------------------------------------------------------------------

def device_phase(card: str):
    from x265_mod_by_patman_tpu import native
    dev = jax.devices()[0]
    log(f"card: {card}")
    log(f"jax {jax.__version__}: {jax.devices()}")
    log(f"device_kind: {dev.device_kind}")
    check(dev.platform == "gpu", f"default device is {dev}, not a GPU")
    lib = native.get_lib()
    log(f"native entropy library: {'loaded' if lib else 'MISSING'}")
    check(lib is not None,
          f"native entropy library did not load: {native.build_error}")
    return dev


# -- kernels ------------------------------------------------------------------

def _park_luma(w: int, h: int):
    from make_clips import make_park
    frames = make_park(w, h, 3)
    return (np.asarray(frames[0][0], np.int32),
            np.asarray(frames[2][0], np.int32))


def search_phase(dev, card: str, w: int = W, h: int = H, n: int = 16,
                 golden_blocks: int = 6, reps: int = 7):
    """Integer full search over every n x n block of a w x h plane, as
    compiled for the card: equal to full_search_ref on a sample and (at
    r=16) to the CPU backend on every block.  Returns {(r, hme): s}."""
    from x265_mod_by_patman_tpu.ops.me import (
        full_search_batch, full_search_ref)
    ref, cur = _park_luma(w, h)
    bys, bxs = np.mgrid[0:-(-h // n), 0:w // n]
    x0 = (bxs.ravel() * n).astype(np.int32)
    y0 = (bys.ravel() * n).astype(np.int32)
    nb = x0.size
    rng = np.random.default_rng(0)
    pmx = rng.integers(-64, 65, nb).astype(np.int32)
    pmy = rng.integers(-64, 65, nb).astype(np.int32)
    lam = 4 * 256
    nbx = w // n
    sample = np.unique(np.concatenate([      # the four corners + random
        [0, nbx - 1, nb - nbx, nb - 1], rng.integers(0, nb, golden_blocks)]))
    out = {}
    for r in (16, 32):
        for hme in (False, True):
            cx = (rng.integers(-24, 25, nb) if hme
                  else np.zeros(nb)).astype(np.int32)
            cy = (rng.integers(-24, 25, nb) if hme
                  else np.zeros(nb)).astype(np.int32)

            def run(d):
                a = [jax.device_put(v, d)
                     for v in (ref, cur, x0, y0, pmx, pmy, cx, cy)]
                ctr = dict(center_x=a[6], center_y=a[7]) if hme else {}
                return lambda: full_search_batch(*a[:6], lam, n, r, **ctr)
            on_card = run(dev)
            got = [np.asarray(v) for v in on_card()]
            for i in sample:
                want = full_search_ref(ref, cur, int(x0[i]), int(y0[i]),
                                       (int(pmx[i]), int(pmy[i])), lam,
                                       n, r, center=(int(cx[i]),
                                                     int(cy[i])))
                have = (int(got[0][i]), int(got[1][i]), int(got[2][i]))
                check(have == want, f"block {i} r={r} hme={hme}: "
                      f"{have} != full_search_ref {want}")
            what = f"full_search_ref on {len(sample)} blocks"
            if r == 16:
                cpu = [np.asarray(v)
                       for v in run(jax.devices("cpu")[0])()]
                for a, b, name in zip(got, cpu, ("mv_x", "mv_y", "cost")):
                    check(np.array_equal(a, b),
                          f"full search r={r} hme={hme} {name}: GPU != "
                          f"CPU on {int((a != b).sum())} of {nb} blocks")
                what += f" and the CPU backend on all {nb}"
            out[(r, hme)] = median_s(on_card, reps)
            log(f"full search {w}x{h} {nb} blocks r={r} hme={hme}: "
                f"equal to {what}; {out[(r, hme)] * 1e3:.3f} ms [{card}]")
    return out


def _on(fn, dev, *arrays, **kw):
    return np.asarray(fn(*[jax.device_put(a, dev) for a in arrays], **kw))


def integer_phase(dev, card: str, w: int = W, h: int = H,
                  golden_blocks: int = 64):
    """Transform, quant, SATD/SA8D/psy and MC at 1080p batch sizes:
    the card's result equals the CPU backend's on the whole batch and
    the numpy golden on a sample."""
    from x265_mod_by_patman_tpu.ops import transform as tf
    from x265_mod_by_patman_tpu.ops import cost, interp
    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(1)

    def both(name, fn, *arrays, **kw):
        g = _on(fn, dev, *arrays, **kw)
        c = _on(fn, cpu, *arrays, **kw)
        check(np.array_equal(g, c), f"{name}: GPU != CPU backend "
              f"({int((g != c).sum())} values differ)")
        return g

    pick = lambda nb: rng.choice(nb, min(golden_blocks, nb), replace=False)
    for log2n in (2, 3, 4, 5):
        nn = 1 << log2n
        nb = -(-w // nn) * -(-h // nn)
        for dst in ((False, True) if log2n == 2 else (False,)):
            resi = rng.integers(-255, 256, (nb, nn, nn)).astype(np.int32)
            coef = both(f"dct{nn}", tf.dct_batch, resi, log2n=log2n,
                        dst=dst)
            lev = both(f"quant{nn}", tf.quant_batch, coef, qp=32,
                       log2_size=log2n)
            rec = both(f"idct{nn}", tf.idct_batch,
                       both(f"dequant{nn}", tf.dequant_batch, lev, qp=32,
                            log2_size=log2n), log2n=log2n, dst=dst)
            for i in pick(nb):
                check(np.array_equal(coef[i], tf.dct_ref(resi[i],
                                                         dst=dst)),
                      f"dct{nn} block {i} != dct_ref")
                check(np.array_equal(lev[i], tf.quant_ref(coef[i], 32,
                                                          log2n)),
                      f"quant{nn} block {i} != quant_ref")
                check(np.array_equal(
                    rec[i], tf.idct_ref(tf.dequant_ref(lev[i], 32, log2n),
                                        dst=dst)),
                      f"idct{nn} block {i} != idct_ref")
            log(f"transform {nn}x{nn}{' DST' if dst else ''}: {nb} blocks "
                f"exact vs CPU backend and numpy golden")
    nb = -(-w // 16) * -(-h // 16)
    a = rng.integers(0, 256, (nb, 16, 16)).astype(np.int32)
    b = rng.integers(0, 256, (nb, 16, 16)).astype(np.int32)
    for name, fn, ref in (("satd", cost.satd_batch, cost.satd_ref),
                          ("sa8d", cost.sa8d_batch, cost.sa8d_ref),
                          ("psy", cost.psy_cost_batch, cost.psy_cost_ref)):
        got = both(name, fn, a, b)
        for i in pick(nb):
            check(int(got[i]) == ref(a[i], b[i]),
                  f"{name} block {i} != {ref.__name__}")
        log(f"{name} 16x16: {nb} blocks exact vs CPU backend and golden")
    ref, _ = _park_luma(w, h)
    bys, bxs = np.mgrid[0:-(-h // 16), 0:w // 16]
    x0 = (bxs.ravel() * 16).astype(np.int32)
    y0 = (bys.ravel() * 16).astype(np.int32)
    mvx = rng.integers(-256, 257, nb).astype(np.int32)
    mvy = rng.integers(-256, 257, nb).astype(np.int32)
    for name, fn, gold in (("mc", interp.mc_batch, interp.mc_block_ref),
                           ("mc14", interp.mc_batch_14,
                            interp.mc_block_ref_14)):
        got = both(name, fn, ref, x0, y0, mvx, mvy, n=16)
        for i in pick(nb):
            want = gold(ref, int(x0[i]), int(y0[i]), int(mvx[i]),
                        int(mvy[i]), 16, 16)
            check(np.array_equal(got[i], want),
                  f"{name} block {i} != {gold.__name__}")
        log(f"{name} luma 16x16: {nb} blocks exact vs CPU backend and "
            f"golden [{card}]")


# -- encode -------------------------------------------------------------------

def _write_clip(path: str, w: int, h: int, n: int) -> None:
    from make_clips import make_park, _write_y4m
    _write_y4m(path, make_park(w, h, n), w, h)


def _decode_checked(stream: bytes, n: int, label: str):
    from x265_mod_by_patman_tpu.decoder.decoder import Decoder
    pics = Decoder().decode(stream)
    check(len(pics) == n, f"{label}: decoded {len(pics)} of {n} pictures")
    for p in pics:
        check(p.sei_md5 == p.md5,
              f"{label}: POC {p.poc} decoded MD5 != SEI MD5")
    return pics


def encode_phase(dev, card: str, workdir: str, w: int = W, h: int = H,
                 frames: int = 8):
    """BASELINE config 2 through cli.main: a cold pass (compile + set-up
    + encode) and a warm pass; both streams identical and decodable."""
    from x265_mod_by_patman_tpu import cli
    src = os.path.join(workdir, f"park_{w}x{h}.y4m")
    _write_clip(src, w, h, frames)
    times, streams = [], []
    for k in range(2):
        out = os.path.join(workdir, f"config2_{k}.hevc")
        t0 = time.perf_counter()
        rc = cli.main(["--input", src, "--output", out, "--frames",
                       str(frames), "--no-progress"] + CONFIG2)
        times.append(time.perf_counter() - t0)
        check(rc == 0, f"cli.main returned {rc}")
        with open(out, "rb") as f:
            streams.append(f.read())
    check(streams[0] == streams[1], "cold and warm streams differ")
    t0 = time.perf_counter()
    pics = _decode_checked(streams[1], frames, "config 2")
    t_dec = time.perf_counter() - t0
    types = {p.slice_type for p in pics}
    check(types == {"I", "P", "B"}, f"slice types {sorted(types)}")
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use", 0)
    log(f"config 2 {w}x{h} x{frames}: {len(streams[1])} bytes, slices "
        f"{''.join(p.slice_type for p in pics)} (decode order), "
        f"every MD5 == SEI MD5 (decode {t_dec:.1f} s on the host)")
    log(f"config 2 smoke: cold pass {times[0]:.2f} s (compile + set-up + "
        f"encode), warm {times[1] / frames:.3f} s/frame, peak device "
        f"memory {peak / 2**30:.2f} GiB [{card}]")
    return times[1] / frames


def parity_phase(dev, workdir: str, w: int = 416, h: int = 240,
                 frames: int = 6):
    """The same CLI encode on the GPU and on the CPU backend."""
    from x265_mod_by_patman_tpu import cli
    src = os.path.join(workdir, f"park_{w}x{h}.y4m")
    _write_clip(src, w, h, frames)
    streams = {}
    for name, d in (("gpu", dev), ("cpu", jax.devices("cpu")[0])):
        out = os.path.join(workdir, f"parity_{name}.hevc")
        jax.config.update("jax_default_device", d)
        try:
            rc = cli.main(["--input", src, "--output", out,
                           "--no-progress"] + CONFIG2)
        finally:
            jax.config.update("jax_default_device", None)
        check(rc == 0, f"cli.main returned {rc} on {name}")
        with open(out, "rb") as f:
            streams[name] = f.read()
    if streams["gpu"] != streams["cpu"]:
        pg = _decode_checked(streams["gpu"], frames, "parity gpu")
        pc = _decode_checked(streams["cpu"], frames, "parity cpu")
        first = next((a.poc for a, b in zip(pg, pc) if a.md5 != b.md5),
                     None)
        raise AssertionError(f"GPU and CPU streams differ; first "
                             f"differing picture POC {first}")
    pics = _decode_checked(streams["gpu"], frames, "parity")
    types = {p.slice_type for p in pics}
    check(types == {"I", "P", "B"}, f"parity slice types {sorted(types)}")
    log(f"GPU vs CPU {w}x{h} x{frames}: identical "
        f"{len(streams['gpu'])}-byte streams, slices "
        f"{''.join(p.slice_type for p in pics)}")


# -- four cards -----------------------------------------------------------

def pb_params(w: int, h: int, **kw):
    """IPBBB mini-GOPs at CQP 32 (multi-stream and frame-parallel B)."""
    from x265_mod_by_patman_tpu.params import default_params
    return default_params(w, h, qp=32, keyframe_max=250, bframes=3,
                          scenecut=False, info_sei=False, **kw)


def tile_params(w: int, h: int, rows: int):
    """P-only with rect PUs: the tile-row sharded analysis path."""
    from x265_mod_by_patman_tpu.params import default_params
    return default_params(w, h, qp=32, keyframe_max=250, bframes=0,
                          rect=True, scenecut=False, weightp=False,
                          mesh_tile_rows=rows, info_sei=False)


def encode_clip(p, frames):
    """Whole stream (headers + every emitted frame) of one Encoder."""
    from x265_mod_by_patman_tpu.encoder.top import Encoder
    enc = Encoder(p)
    out = []
    for f in frames:
        out.extend(enc.encode_frame(*f))
    out.extend(enc.flush())
    return enc.headers() + b"".join(f.bitstream for f in out)


def park_clips(w: int, h: int, frames: int, n: int):
    from make_clips import make_park
    return [[tuple(np.asarray(c, np.uint8) for c in f)
             for f in make_park(w, h, frames, seed=7 + s)]
            for s in range(n)]


def _decode_worker(stream: bytes, n: int, label: str) -> str:
    jax.config.update("jax_platforms", "cpu")     # never touch the card
    return "".join(p.slice_type for p in _decode_checked(stream, n, label))


def decode_all(jobs):
    """Decode-check (stream, n_pictures, label) jobs in parallel host
    processes that stay off the card.  Returns each job's slice types."""
    import concurrent.futures as cf
    import multiprocessing as mp
    with cf.ProcessPoolExecutor(len(jobs),
                                mp_context=mp.get_context("spawn")) as ex:
        return list(ex.map(_decode_worker, *zip(*jobs)))


def four_card_phase(devs, card: str, w: int = W, h: int = H,
                    frames: int = 5):
    """Multi-device paths, each against its one-device encode."""
    from x265_mod_by_patman_tpu.parallel.mesh import make_mesh
    from x265_mod_by_patman_tpu.parallel.streams import MultiStreamEncoder
    nd = len(devs)
    clips = park_clips(w, h, frames, nd)

    t0 = time.perf_counter()
    mse = MultiStreamEncoder(pb_params(w, h), nd, make_mesh(nd, "stream"))
    outs = [[] for _ in range(nd)]
    for t in range(frames):
        for s, lst in enumerate(mse.encode_step([c[t] for c in clips])):
            outs[s].extend(lst)
    for s, lst in enumerate(mse.flush()):
        outs[s].extend(lst)
    t_multi = time.perf_counter() - t0
    single = [encode_clip(pb_params(w, h), c) for c in clips]
    for s in range(nd):
        bs = mse.encoders[s].headers() + b"".join(
            f.bitstream for f in outs[s])
        check(bs == single[s], f"multi-stream stream {s} != one-device")
    log(f"multi-stream: {nd} P/B streams {w}x{h} x{frames} on {nd} cards "
        f"({t_multi:.1f} s incl. compile), each byte-identical to its "
        f"one-device encode [{card}]")

    p = pb_params(w, h)
    p.frame_parallel_window = nd
    check(encode_clip(p, clips[0]) == single[0],
          "frame-parallel B != sequential")
    log(f"frame-parallel B (frame_parallel_window={nd}) {w}x{h} "
        f"x{frames}: byte-identical to sequential")

    sharded = encode_clip(tile_params(w, h, nd), clips[0][:3])
    whole = encode_clip(tile_params(w, h, 1), clips[0][:3])
    check(sharded == whole, "tile-row sharded != one-device")
    log(f"tile-row sharded P analysis (mesh_tile_rows={nd}, ppermute "
        f"halos) {w}x{h} x3: byte-identical to one device")

    types = decode_all([(b, frames, f"stream {s}")
                        for s, b in enumerate(single)]
                       + [(whole, 3, "tile rows")])
    check(all(set(t) == {"I", "P", "B"} for t in types[:nd]),
          f"multi-stream slice types {types[:nd]}")
    check(set(types[nd]) == {"I", "P"}, f"tile-row slices {types[nd]}")
    log(f"decoded: every picture's MD5 == SEI MD5; slices {types}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths, on 4 cards")
    args = ap.parse_args(argv)
    use_compile_cache()
    card = gpu_card()
    dev = device_phase(card)
    t0 = time.perf_counter()

    def phase(name, fn, *a):
        t = time.perf_counter()
        fn(*a)
        log(f"phase {name} passed in {time.perf_counter() - t:.1f} s "
            f"({time.perf_counter() - t0:.1f} s since start)")

    if args.four_cards:
        devs = jax.devices()
        check(len(devs) >= 4, f"--four-cards needs 4 GPUs, have {devs}")
        phase("four-cards", four_card_phase, devs[:4], card)
        count = 4
    else:
        phase("kernels/search", search_phase, dev, card)
        phase("kernels/integer", integer_phase, dev, card)
        with tempfile.TemporaryDirectory() as wd:
            phase("encode", encode_phase, dev, card, wd)
            phase("parity", parity_phase, dev, wd)
        count = 1
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
