"""Test configuration: the tests run on the CPU backend with 8 virtual
devices, so the sharding tests exercise real multi-device code paths
without accelerator hardware."""

import os

# Hard-set (not setdefault): a preset accelerator platform would take
# the tests off the CPU.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags += " --xla_force_host_platform_device_count=8"
# Multi-threaded Eigen kernels on the CPU backend can give a different
# last bit from one run of the same executable to the next when the
# machine is loaded (seen in the fft2 stage), which breaks the
# bit-exact resume and invariance tests.  One thread per kernel keeps
# every run identical.
if "xla_cpu_multi_thread_eigen" not in flags:
    flags += " --xla_cpu_multi_thread_eigen=false"
os.environ["XLA_FLAGS"] = flags.strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

# In case jax was imported (and read the environment) before this file.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
