"""Accelerator capability detection/report.

Analog of the reference's CPU feature detection (common/cpu.cpp
x265::cpu_detect + names table -> param->cpuid): on this framework the
"SIMD capability" is the attached accelerator set, reported once at
startup the way x265 logs its detected CPU capabilities.
"""
from __future__ import annotations

import os
from typing import List

# persistent compile cache when JAX_COMPILATION_CACHE_DIR is unset: one
# fixed, git-ignored directory in the checkout (the path is part of the
# cache key, so a moving directory would never hit)
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def use_compile_cache() -> None:
    """Turn on JAX's persistent compilation cache.  JAX itself reads
    JAX_COMPILATION_CACHE_DIR when it is set; only otherwise is the
    directory set here (CACHE_DIR)."""
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def detect() -> List[dict]:
    import jax
    out = []
    for d in jax.devices():
        info = {
            "id": d.id,
            "platform": d.platform,
            "kind": getattr(d, "device_kind", "unknown"),
        }
        try:
            stats = d.memory_stats() or {}
            if "bytes_limit" in stats:
                info["mem_gib"] = round(stats["bytes_limit"] / 2**30, 2)
        except Exception:
            pass
        out.append(info)
    return out


def capability_line() -> str:
    """x265-style one-line capability report."""
    devs = detect()
    parts = [f"{d['platform']}:{d['kind']}" +
             (f" {d['mem_gib']}GiB" if "mem_gib" in d else "")
             for d in devs]
    return "detected devices: " + ", ".join(parts)


def gpu_card() -> str:
    """The first GPU's name and power limit as nvidia-smi reports them
    (a card below its maximum limit runs slower under load, so every
    timing is printed beside this line)."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
