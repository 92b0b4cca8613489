"""Host/device dual pixel planes.

The reference keeps every picture (sources, references, recon) in host
memory and hands pointers around (common/picyuv.cpp PicYuv).  Here
every host<->device copy of a 1080p plane costs a transfer, so planes
that several device programs consume (source: analysis + wavefront + SAO stats;
references: analysis + MC for every frame that lists them) must be
uploaded ONCE and then referenced by device handle.

`DevPlane` is an np.ndarray subclass that carries a per-device cache of
its int32 device copy; `dev_i32()` is the single accessor every device
program uses in place of `jnp.asarray(np.asarray(x, np.int32))`.  Views
and slices of a DevPlane drop the cache (``__array_finalize__``), so
stale device copies can never alias reshaped host data.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


def _target_device():
    """The device new uploads should land on: the thread's
    jax.default_device when set (frame-parallel jobs pin one per
    worker), else the process default."""
    try:
        d = jax.config.jax_default_device
    except Exception:
        d = None
    if d is not None:
        return d
    return jax.local_devices()[0]


class DevPlane(np.ndarray):
    """Host pixel plane with a cached device-side int32 copy per device."""

    _devs = None

    def __array_finalize__(self, obj):
        self._devs = None

    def __array_wrap__(self, obj, context=None, return_scalar=False):
        # computation results (ufuncs, reductions) are ordinary arrays /
        # scalars — only the wrapped plane itself carries a device cache
        r = obj.view(np.ndarray)
        return r[()] if r.ndim == 0 else r


def as_devplane(a: np.ndarray) -> DevPlane:
    if isinstance(a, DevPlane) and a._devs is not None:
        return a
    v = np.asarray(a).view(DevPlane)
    v._devs = {}
    return v


def attach_dev(host: np.ndarray, dev_arr) -> DevPlane:
    """Wrap `host` and seed its cache with `dev_arr` (int32 device copy
    already living on some device — e.g. the recon the wavefront just
    produced)."""
    v = as_devplane(host)
    try:
        d = next(iter(dev_arr.devices()))
    except Exception:
        d = None
    if d is not None:
        v._devs[d] = dev_arr
    return v


@jax.jit
def pack_levels(ly, lu, lv):
    """Device-side packing of the wavefront's level arrays for the
    host fetch: int16 (TransCoeffLevel fits int16 exactly; half the
    bytes over the link) plus the per-block nonzero maps the deblock
    BS derivation / derived-QP chain / skip stats consume."""
    nz = lambda a: (a.reshape(a.shape[0], a.shape[1], -1) != 0).any(-1)
    return (ly.astype(jnp.int16), lu.astype(jnp.int16),
            lv.astype(jnp.int16), nz(ly), nz(lu), nz(lv))


@partial(jax.jit, static_argnums=(3,))
def pack_recon(dy, du, dv, bd: int):
    """Pack three int32 recon planes into one flat pixel-width buffer
    (single device->host transfer)."""
    dt = jnp.uint8 if bd == 8 else jnp.uint16
    return jnp.concatenate([dy.ravel(), du.ravel(),
                            dv.ravel()]).astype(dt)


def dev_i32(x):
    """Device int32 view of a plane, uploading (and caching) at most
    once per device.  Accepts jax arrays (pass-through), DevPlane
    (cache), or any array-like (plain upload)."""
    if isinstance(x, jax.Array):
        return x if x.dtype == jnp.int32 else x.astype(jnp.int32)
    if isinstance(x, DevPlane) and x._devs is not None:
        tgt = _target_device()
        got = x._devs.get(tgt)
        if got is None:
            # ship the native (narrow) dtype over the link, widen on
            # device: a uint8 1080p plane is 2 MB up vs 8 MB as int32
            got = jax.device_put(
                np.ascontiguousarray(x.view(np.ndarray)), tgt)
            if got.dtype != jnp.int32:
                got = got.astype(jnp.int32)
            x._devs[tgt] = got
        return got
    return jnp.asarray(np.asarray(x, np.int32))
