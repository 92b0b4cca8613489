"""SEA/ADS integral-image search (ops/sea.py): golden parity and exact
degradation to the dense full search at k = all."""
import numpy as np
import jax.numpy as jnp

from x265_mod_by_patman_tpu.ops.sea import (
    integral_ref, integral_batch, sea_search_batch, sea_search_ref)
from x265_mod_by_patman_tpu.ops.me import full_search_batch


def test_integral_parity():
    rng = np.random.default_rng(0)
    p = rng.integers(0, 256, (64, 80)).astype(np.int32)
    gold = integral_ref(p)
    dev = np.asarray(integral_batch(jnp.asarray(p))).astype(np.int64)
    # int32 wraparound only matters beyond 2^31; this plane stays exact
    assert np.array_equal(dev, gold)


def test_sea_equals_full_search_at_k_all():
    rng = np.random.default_rng(1)
    h, w, n, r = 96, 112, 16, 8
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    # orig = shifted ref + noise so the search has real minima
    orig = np.roll(ref, (3, -5), (0, 1)) + \
        rng.integers(-6, 7, (h, w))
    orig = np.clip(orig, 0, 255).astype(np.int32)
    bys, bxs = np.mgrid[0:h // n, 0:w // n]
    x0 = jnp.asarray((bxs.ravel() * n).astype(np.int32))
    y0 = jnp.asarray((bys.ravel() * n).astype(np.int32))
    pz = jnp.zeros_like(x0)
    lam = 64 * 256
    fx, fy, fc = full_search_batch(jnp.asarray(ref), jnp.asarray(orig),
                                   x0, y0, pz, pz, lam, n, r)
    sx, sy, sc = sea_search_batch(jnp.asarray(ref), jnp.asarray(orig),
                                  x0, y0, pz, pz, lam, n, r,
                                  k=(2 * r + 1) ** 2)
    assert np.array_equal(np.asarray(fc), np.asarray(sc))
    assert np.array_equal(np.asarray(fx), np.asarray(sx))
    assert np.array_equal(np.asarray(fy), np.asarray(sy))


def test_sea_batch_matches_scalar_golden():
    rng = np.random.default_rng(2)
    h, w, n, r, k = 64, 64, 16, 6, 24
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    orig = np.clip(np.roll(ref, (2, 1), (0, 1)) +
                   rng.integers(-8, 9, (h, w)), 0, 255).astype(np.int32)
    bys, bxs = np.mgrid[0:h // n, 0:w // n]
    x0 = (bxs.ravel() * n).astype(np.int32)
    y0 = (bys.ravel() * n).astype(np.int32)
    lam = 100 * 256
    sx, sy, sc = sea_search_batch(
        jnp.asarray(ref), jnp.asarray(orig), jnp.asarray(x0),
        jnp.asarray(y0), jnp.zeros(len(x0), jnp.int32),
        jnp.zeros(len(x0), jnp.int32), lam, n, r, k=k)
    for i in range(len(x0)):
        gx, gy, gc = sea_search_ref(ref, orig, int(x0[i]), int(y0[i]),
                                    (0, 0), lam, n, r, k=k)
        assert (int(sx[i]), int(sy[i]), int(sc[i])) == (gx, gy, gc), i


def test_sea_pruned_close_to_exact():
    """k = 32 of 289 candidates must stay within 2% mean cost of the
    dense search on video-like (spatially correlated) content."""
    rng = np.random.default_rng(3)
    h, w, n, r = 96, 96, 16, 8
    ref = rng.integers(0, 256, (h, w)).astype(np.float64)
    for _ in range(4):                     # video-like smoothness
        ref = (ref + np.roll(ref, 1, 0) + np.roll(ref, 1, 1)
               + np.roll(ref, (1, 1), (0, 1))) / 4
    ref = ref.astype(np.int32)
    orig = np.clip(np.roll(ref, (4, -3), (0, 1)) +
                   rng.integers(-2, 3, (h, w)), 0, 255).astype(np.int32)
    bys, bxs = np.mgrid[0:h // n, 0:w // n]
    x0 = jnp.asarray((bxs.ravel() * n).astype(np.int32))
    y0 = jnp.asarray((bys.ravel() * n).astype(np.int32))
    pz = jnp.zeros_like(x0)
    lam = 64 * 256
    _, _, fc = full_search_batch(jnp.asarray(ref), jnp.asarray(orig),
                                 x0, y0, pz, pz, lam, n, r)
    fc = np.asarray(fc, np.float64)
    for k, want in ((32, 0.7), (96, 0.9)):
        _, _, sc = sea_search_batch(jnp.asarray(ref),
                                    jnp.asarray(orig),
                                    x0, y0, pz, pz, lam, n, r, k=k)
        sc = np.asarray(sc, np.float64)
        assert (sc >= fc - 1e-9).all()      # SEA can never beat exact
        frac = (sc == fc).mean()
        assert frac >= want, (k, frac)


def test_me_sea_e2e_bitexact():
    """--me sea drives the SEA-pruned search in P and B analysis; the
    stream still decodes bit-exact."""
    from x265_mod_by_patman_tpu.params import default_params
    from x265_mod_by_patman_tpu.encoder.top import Encoder
    from x265_mod_by_patman_tpu.decoder.decoder import Decoder
    from tests.test_e2e_intra import synth_frame
    w, h = 96, 64
    frames = [synth_frame(w, h, seed=i, motion=2 * i) for i in range(5)]
    p = default_params(w, h, qp=32, keyframe_max=250, bframes=2,
                       b_adapt=0, scenecut=False, search_method="sea")
    enc = Encoder(p)
    out = []
    for f in frames:
        out.extend(enc.encode_frame(*f))
    out.extend(enc.flush())
    pics = Decoder().decode(b"".join(f.bitstream for f in out))
    for pc, f in zip(pics, out):
        assert pc.md5 == pc.sei_md5 == f.md5
