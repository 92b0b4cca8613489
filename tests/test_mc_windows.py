"""MC window reads (ops/interp.py _gather_windows): clamped windows for
starts outside the plane and for right-edge blocks at 1080p width."""
import numpy as np
import jax.numpy as jnp
import pytest

from x265_mod_by_patman_tpu.ops.interp import (
    LUMA_TAPS, _gather_windows, mc_batch, mc_block_ref)


def _want(ref, x, y, size, half):
    h, w = ref.shape
    yy = np.clip(y - half + np.arange(size)[:, None], 0, h - 1)
    xx = np.clip(x - half + np.arange(size)[None, :], 0, w - 1)
    return ref[yy, xx]


@pytest.mark.parametrize("x, y", [(-3, -7), (0, 0), (40, 10), (61, 43),
                                  (-1, 52), (74, -30), (-100, 200)])
def test_gather_windows_out_of_bounds_starts(x, y):
    rng = np.random.default_rng(0)
    h, w, n = 48, 64, 16
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    got = np.asarray(_gather_windows(jnp.asarray(ref),
                                     jnp.asarray([x], jnp.int32),
                                     jnp.asarray([y], jnp.int32),
                                     n, LUMA_TAPS))
    assert np.array_equal(got[0], _want(ref, x, y, n + LUMA_TAPS - 1,
                                        LUMA_TAPS // 2 - 1))


def test_gather_windows_right_edge_1080p_width():
    rng = np.random.default_rng(1)
    h, w, n = 32, 1920, 16
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    xs = np.array([1760, 1800, 1856, 1900, w - 16, w + 10], np.int32)
    ys = np.full_like(xs, 4)
    got = np.asarray(_gather_windows(jnp.asarray(ref), jnp.asarray(xs),
                                     jnp.asarray(ys), n, LUMA_TAPS))
    for k in range(len(xs)):
        assert np.array_equal(got[k], _want(ref, xs[k], ys[k],
                                            n + LUMA_TAPS - 1,
                                            LUMA_TAPS // 2 - 1)), k


def test_mc_right_edge_1080p_width_matches_golden():
    """Fractional MVs that pull the window across the right edge of a
    1920-wide plane: batched MC == the golden block MC."""
    rng = np.random.default_rng(2)
    h, w, n = 32, 1920, 16
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    x0 = np.array([1888, 1904, 1904, 1872], np.int32)
    y0 = np.array([0, 16, 8, 16], np.int32)
    mvx = np.array([5, 30, -3, 63], np.int32)
    mvy = np.array([-6, 2, 7, 1], np.int32)
    got = np.asarray(mc_batch(jnp.asarray(ref), jnp.asarray(x0),
                              jnp.asarray(y0), jnp.asarray(mvx),
                              jnp.asarray(mvy), n))
    for k in range(len(x0)):
        want = mc_block_ref(ref, int(x0[k]), int(y0[k]), int(mvx[k]),
                            int(mvy[k]), n, n)
        assert np.array_equal(got[k], want), k
