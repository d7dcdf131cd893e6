import os
import sys

# Tests run single-device (the dry-run sets its own XLA_FLAGS in a subprocess).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: multi-device subprocess tests")
    config.addinivalue_line(
        "markers",
        "timeout(seconds): per-test watchdog (enforced by pytest-timeout "
        "in CI; inert locally when the plugin is absent)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where torch sees none")
