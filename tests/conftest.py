"""Test configuration: force CPU with 8 virtual devices (multi-device
sharding tests without accelerators) and enable x64 so float64 golden parity
is testable."""

import os

# jax may already be imported by the time this runs (a site hook, another
# plugin), in which case the environment variables alone are too late; the
# jax.config update below also pins the platform before any backend
# initializes. Tests run on a virtual 8-device CPU mesh.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

assert jax.devices()[0].platform == "cpu", "tests must run on CPU"
assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"
