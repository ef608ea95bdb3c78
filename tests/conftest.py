"""Test harness setup: force CPU with 8 virtual devices.

``JAX_PLATFORMS=cuda`` keeps the GPU instead, for the ``gpu``-marked tests
(``python -m pytest -m gpu tests/`` on a machine with the card).

The reference tests multi-node behavior with mpirun -n N on one host
(SURVEY.md §4); our analog is XLA's virtual host-platform device count,
giving a real 8-device mesh for shard_map tests without accelerator
hardware.
Must run before any JAX backend initialization.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms",
                  "cuda" if os.environ.get("JAX_PLATFORMS") == "cuda"
                  else "cpu")
