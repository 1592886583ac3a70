"""Test env: run everything on CPU with 8 virtual devices so pjit/shard_map
data-parallel paths are exercised without accelerator hardware (SURVEY.md §4)."""

import os

# Tests run on the CPU backend unless JAX_PLATFORMS names another: the tests
# marked `gpu` run on the card with
#   JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
# and skip where there is no GPU.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags += " --xla_force_host_platform_device_count=8"
# 8 virtual replicas share the host's intra-op pool, so a replica can take
# minutes to reach its first all-reduce; the default rendezvous terminate
# timeout CHECK-aborts the whole process. Give collectives room.
if "collective_call_terminate" not in flags:
    flags += (" --xla_cpu_collective_timeout_seconds=1200"
              " --xla_cpu_collective_call_terminate_timeout_seconds=1200"
              # time-shared replica threads trip the 20s "may be stuck"
              # rendezvous warning spuriously; keep the test logs clean
              " --xla_cpu_collective_call_warn_stuck_timeout_seconds=1200")
os.environ["XLA_FLAGS"] = flags.strip()

import pytest  # noqa: E402
import jax  # noqa: E402

# Persistent compilation cache (utils/cache.py rule: JAX_COMPILATION_CACHE_DIR
# or the checkout's .jax_cache/): model inits dominate test time on CPU.
from scrabblegan.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache(min_compile_secs=0.5)


@pytest.fixture
def gpu():
    """The first GPU; skips the test where there is none."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest -m gpu tests/")
    return devices[0]


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)
