"""Test config: run everything on a virtual 8-device CPU mesh.

Must set the env vars before jax initializes its backends, so this conftest
performs the setup at import time (pytest imports conftest first).
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# persistent compilation cache: the big decode/train programs compile
# once per (shape, code) across test runs instead of once per process
from kaldi_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_secs=2.0)

import pytest  # noqa: E402


REF = "/root/reference"


@pytest.fixture(scope="session")
def ref_test_data():
    path = os.path.join(REF, "src/feat/test_data")
    if not os.path.isdir(path):
        pytest.skip("reference test_data not available")
    return path


@pytest.fixture(autouse=True, scope="module")
def _release_jax_memory():
    """Full-suite runs accumulate hundreds of compiled XLA programs and
    device buffers in one process; on this host that eventually
    segfaults allocation inside native extensions. Dropping the jit
    caches after each module keeps the peak bounded (modules recompile
    their own programs anyway)."""
    yield
    import gc
    jax.clear_caches()
    gc.collect()
