"""Test configuration: run all tests on CPU with 8 virtual devices.

Mirrors the reference's strategy of exercising distributed code multi-rank on
a single host (`mpiexec -np 3`, the reference's test/CMakeLists.txt:42-50):
we use XLA's host-platform device partitioning so mesh/collective code paths
compile and run without accelerator hardware.

The platform is forced through jax.config as well as the environment, in
case jax was imported before this file runs.  XLA_FLAGS is still honored
because the CPU backend itself initializes lazily.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# several test modules need f64 solves; enable globally so results don't
# depend on test collection order
jax.config.update("jax_enable_x64", True)

assert jax.devices()[0].platform == "cpu", (
    "tests must run on CPU; got " + str(jax.devices())
)
assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"
