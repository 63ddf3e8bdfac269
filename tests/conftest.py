import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402
import pytest  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))

from rrtmg_lw_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# JAX_PLATFORMS picks the backend when set (JAX_PLATFORMS=cuda for the
# card-only tests); otherwise the suite runs on a virtual 8-device CPU
# mesh (fast f64, sharding-testable).
if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# persistent compile cache: the suite is compile-dominated on CPU and
# most programs repeat run-to-run (same shapes/configs)
enable_compile_cache()


@pytest.fixture(autouse=True)
def _needs_gpu(request):
    """Tests marked ``gpu`` run only where JAX's default device is a
    GPU; decided here, per test, never while modules are imported."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on a card)")
