import os
import sys

# XLA:CPU JIT-maps two+ regions per compiled executable; the full suite
# compiles enough programs to blow through a stock vm.max_map_count
# (65530), which surfaces as a SIGSEGV inside XLA compile around the
# 90% mark.  Raise it best-effort (root container).
try:
    with open("/proc/sys/vm/max_map_count") as _f:
        if int(_f.read()) < 262144:
            with open("/proc/sys/vm/max_map_count", "w") as _g:
                _g.write("1048576")
except OSError:
    pass

# Tests run on the CPU backend, sharding on 8 virtual CPU devices (the
# XLA flag below).  Tests marked `gpu` need the card and skip elsewhere
# (see the gpu_device fixture).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault(
    "XLA_FLAGS",
    (os.environ.get("XLA_FLAGS", "") +
     " --xla_force_host_platform_device_count=8").strip(),
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

# Persistent compile cache: many small specialized kernels (per size/qp)
# compile once per machine instead of once per pytest run.
from x265_mod_by_patman_tpu.utils.device import use_compile_cache  # noqa: E402

use_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running encode; deselected with -m 'not slow'")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; run on the card with "
        "JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when the process has none."""
    import jax
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU")


@pytest.fixture
def virtual_mesh():
    """Skips unless the CPU backend has at least 4 (virtual) devices."""
    import jax
    if len(jax.devices("cpu")) < 4:
        pytest.skip("needs a virtual device mesh")
