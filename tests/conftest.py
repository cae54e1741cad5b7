"""Test harness config: run on a virtual 8-device CPU mesh.

Multi-device sharding is validated without real cards by forcing the host
platform to expose 8 virtual devices (``__graft_entry__.dryrun_multichip``
does the same).  The platform is pinned through jax.config after import as
well as the environment, so an attached GPU is never used by the tests.
"""
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
