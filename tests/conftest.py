"""Test bootstrap: make ``src/`` and the tests dir importable.

Lets ``python -m pytest`` work without the ``PYTHONPATH=src`` env var (the
tier-1 command still sets it; scripts/ci.sh uses it) and lets test modules
import the ``hypothesis_shim`` helper.

Also splits the host CPU into two XLA devices (before any jax import) so
the data-parallel serving tests exercise REAL sharding — a 1-device mesh
would make the sharded-vs-single-device equivalence test vacuous. A
caller-provided XLA_FLAGS is preserved (the device-count flag is appended
unless the caller already forces one).
"""
import os
import sys

_FLAGS = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _FLAGS:
    os.environ["XLA_FLAGS"] = (
        _FLAGS + " --xla_force_host_platform_device_count=2").strip()

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
_SRC = os.path.join(_ROOT, "src")
# repo root makes ``benchmarks`` importable (tests share its helpers,
# e.g. the reconstructed pre-fix double-conv baseline)
for path in (_HERE, _SRC, _ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

import pytest  # noqa: E402  (after the XLA_FLAGS/path bootstrap above)


@pytest.fixture
def trace_recorder():
    """A live ``repro.analysis.tracecheck`` recorder: jitted calls made
    inside the test are recorded so ``tracecheck.assert_jit_cache(fn,
    recorder=trace_recorder)`` can name WHICH argument forced a retrace."""
    from repro.analysis import tracecheck
    with tracecheck.capture() as rec:
        yield rec


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long fleet Monte-Carlo runs — excluded from the tier-1 "
        "command; select explicitly with `-m slow`")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA GPU (the PyTorch port's hand-written kernels); "
        "skips without one — on the card: `-m cuda tests/test_torch_*.py`")


def pytest_collection_modifyitems(config, items):
    """Keep tier-1 fast: `slow` tests are skipped unless the caller passes
    a marker expression (e.g. ``-m slow``) that opts into them."""
    if config.getoption("-m"):
        return
    skip = pytest.mark.skip(reason="slow fleet Monte-Carlo: run with -m slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
