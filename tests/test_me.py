"""Motion estimation: batched full search vs brute-force golden."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from x265_mod_by_patman_tpu.ops.me import (
    full_search_batch, full_search_ref, subpel_refine_batch)
from x265_mod_by_patman_tpu.ops.interp import mc_block_ref
from x265_mod_by_patman_tpu.ops.cost import satd_ref
from x265_mod_by_patman_tpu.ops.me import mv_bits_np


def shifted_scene(rng, h, w, dx, dy):
    base = rng.integers(0, 256, (h + 32, w + 32)).astype(np.int32)
    ref = base[16:16 + h, 16:16 + w]
    cur = base[16 + dy:16 + dy + h, 16 + dx:16 + dx + w]
    return ref, cur


def test_full_search_matches_golden():
    rng = np.random.default_rng(0)
    ref, cur = shifted_scene(rng, 64, 96, 3, -2)
    n, r, lam = 16, 8, 256 * 4
    blocks = [(16, 16), (0, 0), (64, 32), (80, 48)]
    x0 = np.array([b[0] for b in blocks], np.int32)
    y0 = np.array([b[1] for b in blocks], np.int32)
    pz = np.zeros(len(blocks), np.int32)
    mx, my, cost = full_search_batch(
        jnp.asarray(ref), jnp.asarray(cur), jnp.asarray(x0),
        jnp.asarray(y0), jnp.asarray(pz), jnp.asarray(pz), lam, n, r)
    for i, (bx, by) in enumerate(blocks):
        gx, gy, gc = full_search_ref(ref, cur, bx, by, (0, 0), lam, n, r)
        assert (int(mx[i]), int(my[i]), int(cost[i])) == (gx, gy, gc), i
        # the true displacement should be found for interior blocks
    assert (int(mx[0]), int(my[0])) == (3 * 4, -2 * 4)


def test_subpel_refine_improves_or_keeps():
    rng = np.random.default_rng(1)
    # build a reference, then derive "current" by qpel-shifting via MC
    ref = rng.integers(0, 256, (64, 96)).astype(np.int32)
    # smooth it so interpolation behaves
    ref = (ref + np.roll(ref, 1, 0) + np.roll(ref, 1, 1) +
           np.roll(ref, (1, 1), (0, 1))) // 4
    true_mv = (6, -3)    # 1.5 px right, 0.75 px up
    cur = np.zeros_like(ref)
    for by in range(0, 64, 16):
        for bx in range(0, 96, 16):
            cur[by:by + 16, bx:bx + 16] = mc_block_ref(
                ref, bx, by, true_mv[0], true_mv[1], 16, 16, 0)
    blocks = [(16, 16), (48, 32), (64, 16)]
    x0 = np.array([b[0] for b in blocks], np.int32)
    y0 = np.array([b[1] for b in blocks], np.int32)
    pz = np.zeros(len(blocks), np.int32)
    mx, my, cost = full_search_batch(
        jnp.asarray(ref), jnp.asarray(cur), jnp.asarray(x0),
        jnp.asarray(y0), jnp.asarray(pz), jnp.asarray(pz), 1024, 16, 8)
    rx, ry, rcost = subpel_refine_batch(
        jnp.asarray(ref), jnp.asarray(cur), jnp.asarray(x0),
        jnp.asarray(y0), mx, my, jnp.asarray(pz), jnp.asarray(pz),
        1024, 16)
    # subpel must find the exact fractional MV for interior blocks
    for i in range(len(blocks)):
        assert (int(rx[i]), int(ry[i])) == true_mv, \
            (i, int(rx[i]), int(ry[i]))


def test_hme_seeded_full_search_finds_large_motion():
    """Seeded full search (center_x/center_y) reaches motion beyond the
    unseeded window."""
    import numpy as np
    import jax.numpy as jnp
    from x265_mod_by_patman_tpu.ops.me import full_search_batch
    rng = np.random.default_rng(5)
    ref = rng.integers(0, 255, (96, 160)).astype(np.int32)
    # orig[x] = ref[x + 40]: the match lies +40 px right in ref
    orig = np.roll(ref, -40, axis=1)
    x0 = jnp.asarray([64], jnp.int32)
    y0 = jnp.asarray([32], jnp.int32)
    z = jnp.zeros(1, jnp.int32)
    cx = jnp.asarray([40], jnp.int32)
    mvx, mvy, cost = full_search_batch(
        jnp.asarray(ref), jnp.asarray(orig), x0, y0, z, z, 0, 16, 8,
        center_x=cx, center_y=z)
    assert int(mvx[0]) == 160 and int(mvy[0]) == 0    # qpel
    assert int(cost[0]) == 0


def test_mv_bits_integer_matches_float_golden():
    """mv_bits takes the bit length in integers; it equals the float
    ceil(log2(|v|+1)) golden for every component value an MV search
    can produce (checked here past +-2^16 qpel)."""
    from x265_mod_by_patman_tpu.ops.me import mv_bits
    v = np.arange(-70000, 70001, dtype=np.int32)
    w = v[::-1].copy()
    got = np.asarray(mv_bits(jnp.asarray(v), jnp.asarray(w)))
    assert np.array_equal(got, mv_bits_np(v, w))


@pytest.mark.parametrize("hme", [False, True], ids=["plain", "hme"])
@pytest.mark.parametrize("r", [4, 16, 32])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_full_search_edges_and_centres_match_golden(n, r, hme):
    """Full search == full_search_ref for blocks at every edge of a
    plane smaller than the search window, with MV predictors and HME
    centres that push the window far outside the plane."""
    rng = np.random.default_rng(n * 100 + r)
    h, w = 48, 80
    base = rng.integers(0, 256, (h + 8, w + 8)).astype(np.int32)
    ref = base[:h, :w]
    cur = np.clip(base[3:3 + h, 5:5 + w]
                  + rng.integers(-3, 4, (h, w)), 0, 255).astype(np.int32)
    blocks = [(0, 0), (w - n, h - n), (w // 2, 8), (w - n // 2, h - 4)]
    x0 = np.array([b[0] for b in blocks], np.int32)
    y0 = np.array([b[1] for b in blocks], np.int32)
    if hme:
        cx = np.array([3, -70, 9, 2 * r + 40], np.int32)
        cy = np.array([-2, 5, -60, 1], np.int32)
    else:
        cx = cy = np.zeros(len(blocks), np.int32)
    pmx = np.array([0, 8, -12, 4], np.int32)
    pmy = np.array([0, -4, 0, 16], np.int32)
    lam = 4 * 256
    mx, my, cost = full_search_batch(
        jnp.asarray(ref), jnp.asarray(cur), jnp.asarray(x0),
        jnp.asarray(y0), jnp.asarray(pmx), jnp.asarray(pmy), lam, n, r,
        center_x=jnp.asarray(cx) if hme else None,
        center_y=jnp.asarray(cy) if hme else None)
    for i in range(len(blocks)):
        want = full_search_ref(ref, cur, int(x0[i]), int(y0[i]),
                               (int(pmx[i]), int(pmy[i])), lam, n, r,
                               center=(int(cx[i]), int(cy[i])))
        assert (int(mx[i]), int(my[i]), int(cost[i])) == want, i


@pytest.mark.gpu
def test_full_search_on_gpu_equals_cpu_backend(gpu_device):
    """At 1080p block count (8160 16x16 blocks, r=16, HME centres) the
    search compiled for the card returns exactly the CPU backend's MVs
    and costs."""
    rng = np.random.default_rng(4)
    h, w, n, r = 1080, 1920, 16, 16
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    cur = np.roll(ref, (2, -5), (0, 1))
    bys, bxs = np.mgrid[0:-(-h // n), 0:w // n]
    host = ((ref, cur, (bxs.ravel() * n).astype(np.int32),
             (bys.ravel() * n).astype(np.int32))
            + (rng.integers(-8, 9, bxs.size).astype(np.int32),) * 2)
    outs = []
    for dev in (gpu_device, jax.devices("cpu")[0]):
        a, c, x, y, px, py = (jax.device_put(v, dev) for v in host)
        outs.append([np.asarray(v) for v in full_search_batch(
            a, c, x, y, px, py, 1024, n, r, center_x=px, center_y=py)])
    for g, c in zip(*outs):
        assert np.array_equal(g, c)
