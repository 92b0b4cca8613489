"""Tracing hooks + device detection."""
import json
import os
import subprocess
import sys

import numpy as np


def test_trace_file_written(tmp_path):
    """Run a tiny encode in a child with X265TPU_TRACE set."""
    out = tmp_path / "trace.json"
    code = """
import numpy as np
from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu.encoder.top import Encoder
enc = Encoder(default_params(64, 64, qp=32, keyframe_max=1))
y = np.full((64, 64), 100, np.uint8)
c = np.full((32, 32), 128, np.uint8)
enc.encode_frame(y, c, c)
"""
    env = dict(os.environ, X265TPU_TRACE=str(out), JAX_PLATFORMS="cpu",
               PYTHONPATH=os.getcwd() + ":" +
               os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=300)
    doc = json.loads(out.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert "picture" in names and "entropy" in names


def test_device_detect():
    from x265_mod_by_patman_tpu.utils.device import (
        detect, capability_line)
    devs = detect()
    assert len(devs) >= 1
    assert all("platform" in d for d in devs)
    assert "detected devices:" in capability_line()
