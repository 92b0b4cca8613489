"""AOT device-memory probe: compile the analysis cores at config-4 (4K)
shapes and print XLA's memory analysis (argument/output/temp bytes)
without executing — shows which program needs how much device memory.

Usage: python tools/mem_probe.py [--w 3840 --h 2160] [--b]
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--w", type=int, default=3840)
    ap.add_argument("--h", type=int, default=2160)
    ap.add_argument("--b", action="store_true", help="probe the B core")
    ap.add_argument("--no-rect", action="store_true")
    ap.add_argument("--no-hme", action="store_true")
    ap.add_argument("--rounds1", action="store_true")
    ap.add_argument("--subme0", action="store_true")
    a = ap.parse_args()
    import jax
    import x265_mod_by_patman_tpu.analysis.inter_mode as im
    from x265_mod_by_patman_tpu.params import default_params
    from x265_mod_by_patman_tpu.bitstream.headers import build_sps_info

    p = default_params(a.w, a.h, rc_mode="crf", crf=24.0)
    p.apply_preset("slow")
    p.hme = not a.no_hme
    if a.no_rect:
        p.rect = False
        p.amp = False
    if a.subme0:
        p.subpel_refine = 0
    p.validate()
    sps = build_sps_info(p)
    rng = np.random.default_rng(0)
    mk = lambda h, w: rng.integers(0, 255, (h, w)).astype(np.uint8)
    y = mk(sps.height, sps.width)
    u = mk(sps.height // 2, sps.width // 2)
    v = mk(sps.height // 2, sps.width // 2)
    ref = (mk(sps.height, sps.width), mk(sps.height // 2, sps.width // 2),
           mk(sps.height // 2, sps.width // 2))

    core = im._b_core if a.b else im._p_core
    captured = {}
    orig = core

    def capture(*args, **kw):
        captured["args"] = args
        captured["kw"] = kw
        raise _Stop()

    class _Stop(Exception):
        pass

    name = "_b_core" if a.b else "_p_core"
    setattr(im, name, capture)
    try:
        mr = max(4, min(p.search_range, 32))
        rnds = (1, 1) if a.rounds1 else (2, 2)
        if a.b:
            im.analyse_b_frame(y, u, v, [ref], [ref], sps, 32,
                               search_range=mr, subme=p.subpel_refine,
                               rect=p.rect, amp=p.amp,
                               pad_refs=(4, 2), hme=p.hme, rounds=rnds)
        else:
            im.analyse_p_frame(y, u, v, [ref], sps, 32,
                               search_range=mr, subme=p.subpel_refine,
                               rect=p.rect, amp=p.amp, pad_refs=4,
                               hme=p.hme, rounds=rnds)
    except _Stop:
        pass
    finally:
        setattr(im, name, orig)

    lowered = orig.lower(*captured["args"], **captured["kw"])
    comp = lowered.compile()
    ma = comp.memory_analysis()
    gb = 1 << 30
    print(f"{name} @ {a.w}x{a.h}:")
    print(f"  arguments: {ma.argument_size_in_bytes / gb:.2f} GiB")
    print(f"  outputs:   {ma.output_size_in_bytes / gb:.2f} GiB")
    print(f"  temps:     {ma.temp_size_in_bytes / gb:.2f} GiB")
    print(f"  total:     {(ma.argument_size_in_bytes + ma.output_size_in_bytes + ma.temp_size_in_bytes) / gb:.2f} GiB")


if __name__ == "__main__":
    main()
