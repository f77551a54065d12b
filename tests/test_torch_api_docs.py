"""Public-API docstring coverage for ``repro_torch.plan``, ``repro_torch.dist``
and ``repro_torch.serve``: the counterpart of ``tests/test_api_docs.py``.

Every name a package exports through ``__all__`` is a documented contract:
functions and classes must carry a non-empty docstring, and so must the
public methods/properties a class defines itself (inherited members are the
parent's responsibility).  Plain data exports (ALGORITHMS/GATHERS/...) are
covered by the module docstrings instead.
"""

import importlib
import inspect

import pytest

PACKAGES = ["repro_torch.plan", "repro_torch.dist", "repro_torch.serve"]


def _missing_docs(modname: str) -> list[str]:
    mod = importlib.import_module(modname)
    missing = []
    for name in mod.__all__:
        obj = getattr(mod, name)
        if not (inspect.isfunction(obj) or inspect.isclass(obj)):
            continue  # data exports: documented in the module docstring
        if not (inspect.getdoc(obj) or "").strip():
            missing.append(f"{modname}.{name}")
        if inspect.isclass(obj):
            for mname, member in vars(obj).items():
                if mname.startswith("_"):
                    continue
                fn = member.fget if isinstance(member, property) else member
                if not callable(fn):
                    continue
                if not (getattr(fn, "__doc__", None) or "").strip():
                    missing.append(f"{modname}.{name}.{mname}")
    return missing


@pytest.mark.parametrize("modname", PACKAGES)
def test_public_api_has_docstrings(modname):
    missing = _missing_docs(modname)
    assert not missing, f"undocumented public API: {missing}"


@pytest.mark.parametrize("modname", PACKAGES)
def test_all_names_resolve(modname):
    """__all__ must not advertise names the package fails to define."""
    mod = importlib.import_module(modname)
    for name in mod.__all__:
        assert hasattr(mod, name), f"{modname}.__all__ lists missing {name!r}"
