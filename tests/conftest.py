"""Test configuration: force CPU with 8 virtual devices for mesh tests.

The tests run on the CPU: the environment may name another platform
(JAX_PLATFORMS) before this file runs, so the env var alone is not
enough — override the jax config directly before any device is touched.
What only the GPU can show is checked by ``python chip_smoke.py``.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
