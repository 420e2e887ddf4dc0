"""Test configuration: CPU backend with 8 virtual devices.

Multi-device sharding is validated on a virtual CPU mesh
(xla_force_host_platform_device_count); the GPU runs are `chip_smoke.py`
(one card) and `chip_smoke.py --devices 4`.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
