import numpy as np
import pytest

# NOTE: do NOT set --xla_force_host_platform_device_count here; smoke tests
# and benchmarks must see the single real CPU device.  Only launch/dryrun.py
# fakes 512 devices (in its own process).


@pytest.fixture
def rng():
    return np.random.default_rng(0xC0FFEE)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")
