import os

# Smoke tests and benches must see the real (single) CPU device — the 512-way
# host-device override belongs ONLY to repro.launch.dryrun.
assert "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""), \
    "do not set the dry-run XLA_FLAGS globally"

try:
    import hypothesis  # noqa: F401 — prefer the real library when present
except ImportError:
    from _hypothesis_fallback import install as _install_hypothesis_fallback
    _install_hypothesis_fallback()

import pytest

from repro.core import MemoryObjectStore, Namespace


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA CUDA card; skips where there is none")


@pytest.fixture
def store():
    return MemoryObjectStore()


@pytest.fixture
def ns(store):
    return Namespace(store, "runs/test")
