import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax
import pytest

jax.config.update("jax_platforms", "cpu")

try:
    import hypothesis
    import hypothesis.strategies as _hst
except ModuleNotFoundError:  # pragma: no cover - exercised in minimal envs
    hypothesis = None
    _hst = None


# --------------------------------------------------------- capability probes
#
# The repo targets current jax APIs; CI pins jax 0.4.37 (see ci.yml), where
# some of them don't exist yet.  Each probe names ONE api gap; tests that
# need it are skip-marked with the probe's reason so the suite is green on
# the pinned runtime and a *new* failure is never hidden inside known-red.

def _probe_pallas_supported() -> bool:
    """repro.kernels.common.pallas_supported() — true when either spelling
    of the TPU compiler-params class (``pltpu.CompilerParams`` on current
    jax, ``pltpu.TPUCompilerParams`` on 0.4.x) exists; the kernels route
    through ``common.tpu_compiler_params`` which papers over the rename, so
    on jax 0.4.37 the kernel suites now really run (interpret mode)."""
    try:
        from repro.kernels.common import pallas_supported
    except Exception:  # pragma: no cover - pallas missing entirely
        return False
    return pallas_supported()


HAS_PALLAS = _probe_pallas_supported()
# The other 0.4.37 gaps this PR met — jax.sharding.AxisType and
# jax.lax.axis_size — need no skip probes: launch/mesh.py and
# train/compression.py carry runtime fallbacks, so those tests really pass.

#: test files whose every case drives a Pallas kernel through
#: common.tpu_compiler_params (run in interpret mode off-TPU)
_PALLAS_KERNEL_FILES = frozenset(
    ["test_kernels.py", "test_ssd_kernel.py", "test_wgrad_kernel.py",
     "test_radix_kernel.py"])

_PALLAS_SKIP = pytest.mark.skip(
    reason="this jax has neither pltpu.CompilerParams nor the old "
           "TPUCompilerParams spelling — pallas tier unlaunchable")


def pytest_collection_modifyitems(config, items):
    if HAS_PALLAS:
        return
    for item in items:
        if os.path.basename(str(item.fspath)) in _PALLAS_KERNEL_FILES:
            item.add_marker(_PALLAS_SKIP)


def property_test(argnames, cases, strategies, max_examples=15):
    """Property-test decorator that degrades gracefully without hypothesis.

    With ``hypothesis`` installed (requirements-dev.txt) the test runs under
    ``@given(**strategies(st))``; without it, it runs as a plain parametrize
    over the deterministic ``cases`` so the suite still collects and covers
    the path.

    argnames:   "a,b,c" — pytest parametrize signature (fallback mode).
    cases:      deterministic fallback tuples matching ``argnames``.
    strategies: callable ``st_module -> dict`` of hypothesis strategies
                (lazy so the module is only touched when present).
    """
    def deco(f):
        if hypothesis is None:
            return pytest.mark.parametrize(argnames, cases)(f)
        return hypothesis.settings(max_examples=max_examples, deadline=None)(
            hypothesis.given(**strategies(_hst))(f))
    return deco


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips with a reason without one")
