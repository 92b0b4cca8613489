"""Multi-chip sharded encode steps (jax.sharding mesh layer).

The framework's distributed backend — the reference has none (its
parallelism is intra-host threads, SURVEY.md §2.3); this module maps those
strategies onto a device mesh:

  axis "gop"    — GOP / segment sharding across hosts (P10 analog;
                  reference chunkStart/chunkEnd x265.h:2171)
  axis "stream" — multi-stream batch encode (P9 / abrEncApp analog)

Rate-control statistics cross shards via psum (the reference's cross
-process RingMem cuTree share, ratecontrol.cpp:380, becomes a collective).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.transform import dct_batch, quant_batch
from ..ops.cost import satd_batch
from ..ops.intra import intra_pred_all_batch, substitute_filter_batch


def make_mesh(n_devices: int, axis: str = "gop") -> Mesh:
    """1-D mesh over the first n_devices devices of the default backend
    (CPU tests get virtual devices from
    --xla_force_host_platform_device_count)."""
    devs = jax.devices()
    if len(devs) < n_devices:
        raise ValueError(f"need {n_devices} devices on the "
                         f"{devs[0].platform} backend, have {len(devs)}")
    return Mesh(np.array(devs[:n_devices]), (axis,))


def _frame_analysis(y, qp: int, block: int = 16):
    """Per-frame batched intra analysis + transform: the flagship compute
    step (mode decision SATD sweep -> residual transform -> quant ->
    coded-bit proxy).  y: (H, W) int32.  Returns (modes, levels, satd_sum,
    nz_count)."""
    h, w = y.shape
    n = block
    log2n = n.bit_length() - 1
    nby, nbx = h // n, w // n
    bys, bxs = np.mgrid[0:nby, 0:nbx]
    bx = jnp.asarray(bxs.ravel().astype(np.int32))
    by = jnp.asarray(bys.ravel().astype(np.int32))
    x0 = bx * n
    y0 = by * n
    ks = np.arange(4 * n + 1)
    k_x = np.where(ks <= 2 * n, -1, ks - (2 * n + 1))
    k_y = np.where(ks < 2 * n, 2 * n - 1 - ks, -1)
    xs = jnp.clip(x0[:, None] + jnp.asarray(k_x)[None, :], 0, w - 1)
    ys = jnp.clip(y0[:, None] + jnp.asarray(k_y)[None, :], 0, h - 1)
    avail = (x0[:, None] + jnp.asarray(k_x)[None, :] >= 0) & \
            (y0[:, None] + jnp.asarray(k_y)[None, :] >= 0) & \
            (x0[:, None] + jnp.asarray(k_x)[None, :] < w) & \
            (y0[:, None] + jnp.asarray(k_y)[None, :] < h)
    s_raw = y[ys, xs]
    s_sub, s_filt = substitute_filter_batch(s_raw, avail, log2n)
    preds = intra_pred_all_batch(s_sub, s_filt, log2n, 0)
    gy = y0[:, None, None] + jnp.arange(n)[None, :, None]
    gx = x0[:, None, None] + jnp.arange(n)[None, None, :]
    org = y[gy, gx].astype(jnp.int32)
    costs = satd_batch(org[:, None], preds)
    modes = jnp.argmin(costs, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(preds, modes[:, None, None, None],
                               axis=1)[:, 0]
    resi = org - best
    coef = dct_batch(resi, log2n)
    lev = quant_batch(coef, qp, log2n)
    satd_sum = jnp.sum(jnp.min(costs, axis=1))
    nz = jnp.sum((lev != 0).astype(jnp.int32))
    return modes.reshape(nby, nbx), lev.reshape(nby, nbx, n, n), \
        satd_sum, nz


def sharded_encode_step(mesh: Mesh, qp: int, block: int = 16):
    """Build a pjit'd multi-frame analysis step: frames batched on the
    leading axis, sharded over the mesh's first axis; RC stats psum'd
    across shards (the collective analog of m_startEndOrder/RingMem)."""
    axis = mesh.axis_names[0]

    def step(frames):
        # frames: (B, H, W) int32, sharded on B across `axis`
        def per_frame(y):
            modes, lev, satd, nz = _frame_analysis(y, qp, block)
            return modes, lev, satd, nz
        modes, lev, satd, nz = jax.vmap(per_frame)(frames)
        # global rate-control statistics cross devices (psum collective)
        total_satd = jax.lax.psum(jnp.sum(satd), axis)
        total_nz = jax.lax.psum(jnp.sum(nz), axis)
        return modes, lev, total_satd, total_nz

    pspec = P(axis)
    return jax.jit(jax.shard_map(step, mesh=mesh,
                                 in_specs=(pspec,),
                                 out_specs=(pspec, pspec, P(), P())))
