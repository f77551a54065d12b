"""The port's executable docs (``docs/repro_torch/*.md``) on the CPU.

Runs ``tools/check_docs_torch.py`` in a subprocess: one case a document
(its links and its ``python`` snippets, the distributed document in the 8
gloo ranks its first line declares) and one for the links of all of them.
The checker imports neither jax nor ``repro``.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CHECKER = ROOT / "tools" / "check_docs_torch.py"
DOCS = sorted(p.stem for p in (ROOT / "docs" / "repro_torch").glob("*.md"))
TIMEOUT = 300  # seconds a document may take


def _check(*args: str, device: tuple = ("--device", "cpu"), **env) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), **env}
    return subprocess.run([sys.executable, str(CHECKER), *device, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=TIMEOUT)


def test_the_three_documents_are_there():
    assert DOCS == ["architecture", "distributed", "serving"]


def test_links_resolve():
    proc = _check("--links-only")
    assert proc.returncode == 0, proc.stdout[-4000:]
    assert "docs check OK (3 files)" in proc.stdout


@pytest.mark.parametrize("doc", DOCS)
def test_snippets_execute(doc):
    proc = _check("--doc", doc)
    assert proc.returncode == 0, proc.stdout[-6000:] + proc.stderr[-2000:]
    assert ("in 8 ranks" in proc.stdout) == (doc == "distributed")


def test_device_defaults_to_the_card():
    """With no ``--device`` the snippets run on ``cuda``, as the port's
    entry points do: where no card is visible the document fails; the
    checker does not carry on on the CPU."""
    proc = _check("--doc", "serving", device=(), CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 1, proc.stdout[-4000:]
    assert "executing snippets: docs/repro_torch/serving.md on cuda" in proc.stdout
    assert "snippet raised" in proc.stdout
