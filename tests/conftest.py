import os
import sys

# NOTE: do NOT set --xla_force_host_platform_device_count here — smoke tests
# and benches must see the host's real (single) device; only launch/dryrun.py
# requests 512 placeholder devices, and only for itself.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax
jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")
