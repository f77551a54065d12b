"""Shared pytest helpers.

THE one hypothesis-availability shim (repo convention: the property-based
dependency is optional, and its absence must degrade to *visible per-test
skips* -- never a module-level ``importorskip`` that silently drops a whole
file, and never per-file copies of the try/except boilerplate).  Test
modules use it as a drop-in import:

    from conftest import HAVE_HYPOTHESIS, given, settings, st

With hypothesis installed these are the real ``given``/``settings``/
``strategies``.  Without it, ``given(...)`` swaps the test for a zero-arg
stub marked ``skip(reason="hypothesis not installed")`` (keeping the test's
name and docstring, so the skip is attributed to the right test in reports),
``settings`` is an identity decorator, and ``st`` absorbs any strategy
construction -- calls and attribute lookups alike return the absorber, so
module-level strategy expressions (including ``@st.composite`` builders)
evaluate harmlessly without ever running.
"""

import pytest

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

    class _AbsorbingStrategy:
        """Stands in for ``hypothesis.strategies`` when it isn't installed:
        every call and attribute access returns the absorber itself, so any
        strategy expression type-checks at collection time."""

        def __call__(self, *args, **kwargs):
            return self

        def __getattr__(self, name):
            return self

    st = _AbsorbingStrategy()

    def settings(*args, **kwargs):
        """Identity decorator standing in for ``hypothesis.settings``."""
        return lambda fn: fn

    def given(*args, **kwargs):
        """Replace the decorated property test with a visible skip stub."""

        def deco(fn):
            @pytest.mark.skip(reason="hypothesis not installed")
            def stub():
                pass  # pragma: no cover - never executes

            stub.__name__ = fn.__name__
            stub.__doc__ = fn.__doc__
            return stub

        return deco


def pytest_configure(config):
    """Register the one marker for tests that need an NVIDIA card (they skip,
    with a reason, where none is attached)."""
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips with a reason where none is attached"
    )
