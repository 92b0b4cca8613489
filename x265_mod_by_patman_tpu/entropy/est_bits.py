"""CABAC fractional-bit estimation tables for RD decisions — the
"counting mode" rate model (reference entropy.h:107-133 EstBitsSbac,
entropy.cpp sbacGetEntropyBits / estBit).

Batched form: instead of a live stateful estimator threaded through a
serial coefficient walk, the slice-start context states for EVERY
(init_type, qp) pair are baked into one dense table at import time;
jitted code gathers per-context bit costs with the *traced* qp and
init_type, so rate-true costs never trigger recompiles under rate
control (CLAUDE.md invariant 3).

Units: plain bits (float32).  ENTROPY_BITS is 1/32768-bit fixed point.
"""
from __future__ import annotations

import numpy as np

from ..constants.hevc_tables import ENTROPY_BITS
from .contexts import NUM_CONTEXTS, OFF, init_states
from .residual import _CTX_IDX_MAP_4x4


def _build_bits_table() -> np.ndarray:
    """(init_type 3, qp 52, ctx, bin 2) float32 fractional bits of coding
    `bin` in context `ctx` at its slice-start state."""
    t = np.empty((3, 52, NUM_CONTEXTS, 2), np.float32)
    eb = ENTROPY_BITS.astype(np.float32) / 32768.0
    for it in range(3):
        for qp in range(52):
            st = init_states(it, qp).astype(np.int32)
            t[it, qp, :, 0] = eb[st ^ 0]
            t[it, qp, :, 1] = eb[st ^ 1]
    return t


BITS_TABLE = _build_bits_table()


def sig_ctx_map(log2_tb: int, c_idx: int) -> np.ndarray:
    """(n, n) sig_coeff_flag ctxIdx map under the neighbour-CG-flags = 0
    approximation (spec 9.3.4.2.5 pattern 0; diag scan for 8x8 luma).
    The data-dependent prev_csbf patterns only redistribute positions
    within the same 3-context band, so the static map is the right
    batched estimate (the reference's RDOQ uses the live map, which a
    dense batch cannot see)."""
    n = 1 << log2_tb
    base = OFF["SIG"] + (27 if c_idx else 0)
    m = np.zeros((n, n), np.int32)
    if log2_tb == 2:
        for y in range(4):
            for x in range(4):
                m[y, x] = base + _CTX_IDX_MAP_4x4[(y << 2) + x]
        return m
    for y in range(n):
        for x in range(n):
            if x == 0 and y == 0:
                m[y, x] = base
                continue
            xp, yp = x & 3, y & 3
            s = 2 if xp + yp == 0 else (1 if xp + yp < 3 else 0)
            if c_idx == 0 and (x >= 4 or y >= 4):
                s += 3
            if log2_tb == 3:
                s += 9 if c_idx == 0 else 9
            else:
                s += 21 if c_idx == 0 else 12
            m[y, x] = base + s
    return m


def residual_ctx_scalars(log2_tb: int, c_idx: int):
    """Context indices of the per-CG scalar flags used by the batched
    RDOQ bit model: (g1_base+1 with c1=1, g2, coded_sub_block_flag).
    ctx_set approximation: the dominant set for the size (set 2 for
    multi-CG luma, 0 otherwise; reference Quant::rdoQuant tracks the
    live set per CG)."""
    ctx_set = 2 if (c_idx == 0 and log2_tb > 2) else 0
    g1 = OFF["ONE"] + (16 if c_idx else 0) + 4 * ctx_set + 1
    g2 = OFF["ABS"] + (4 if c_idx else 0) + ctx_set
    cg = OFF["SIG_CG"] + (2 if c_idx else 0)
    return g1, g2, cg


def bits_table_from_states(states: np.ndarray) -> np.ndarray:
    """(C, 2) float32 fractional bits per (context, bin) at the GIVEN
    context states — the adapted-table analog of BITS_TABLE's
    slice-start rows (reference entropy.cpp:2624 estBit refresh from
    live contexts; we refresh with a one-frame lag from the previous
    same-type slice's end-of-stream states)."""
    eb = ENTROPY_BITS.astype(np.float32) / 32768.0
    st = np.asarray(states, np.int32)
    return np.stack([eb[st ^ 0], eb[st ^ 1]], axis=1)
