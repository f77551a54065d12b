"""Docs checker of the PyTorch port: link check + executable fenced snippets.

The counterpart of ``tools/check_docs.py`` for ``docs/repro_torch/*.md``:

1. **Links** -- every ``[text](target)`` in those files must resolve:
   relative paths must exist on disk, ``#anchors`` must match a heading
   slug (GitHub slugification) in the target file.  External ``http(s)://``
   / ``mailto:`` links are skipped.
2. **Snippets** -- every fenced block whose info string is exactly
   ``python`` is executed, top to bottom, in one namespace a file, with
   ``DEVICE`` bound to ``--device`` (``"cpu"`` or ``"cuda"``).  A raised
   exception fails the run with the file and the snippet's first line.

A document whose first line is ``<!-- world: N -->`` is an SPMD program:
its snippets run in N ranks, one process each (gloo on the CPU, NCCL with
one card a rank on CUDA), spawned with a ``file://`` store (no TCP port)
and the default process group started before the first snippet.  A rank
stops at its first failing snippet; any rank's failure fails the
document, with the rank, the file and the snippet line, and a failed or
overdue world is killed with its whole process group.

Run from the repo root:

    PYTHONPATH=src python tools/check_docs_torch.py [--device cuda|cpu] [--doc NAME] [--links-only]

``--device`` defaults to ``cuda``, as the port's entry points do; pass
``--device cpu`` for the CPU.

This tool imports neither ``jax`` nor ``repro``.  Its link check and
snippet runner are a copy of ``tools/check_docs.py``'s and not an import:
that module sets JAX's platform flags when it is imported and belongs to
the reference, which the port does not depend on.  The copy differs
where the port needs it to: headings inside fences are not anchors,
snippets see ``DEVICE``, and a rank stops at its first failing snippet.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DOCS = ROOT / "docs" / "repro_torch"
WORLD_TIMEOUT = 600  # seconds a world of ranks may take

LINK_RE = re.compile(r"\[[^\]]*\]\(([^)\s]+)\)")
HEADING_RE = re.compile(r"^#{1,6}\s+(.*)$", re.MULTILINE)
FENCE_RE = re.compile(r"^```(\w*)[^\n]*\n(.*?)^```\s*$", re.MULTILINE | re.DOTALL)
WORLD_RE = re.compile(r"\A<!--\s*world:\s*(\d+)\s*-->")
EXTERNAL = ("http://", "https://", "mailto:")


def github_slug(heading: str) -> str:
    """GitHub's anchor slug: lowercase, spaces to dashes, drop punctuation."""
    text = re.sub(r"[`*_]", "", heading.strip()).lower()
    text = re.sub(r"[^\w\- ]", "", text)
    return text.replace(" ", "-")


def anchors_of(md_path: Path) -> set[str]:
    return {github_slug(h) for h in HEADING_RE.findall(FENCE_RE.sub("", md_path.read_text()))}


def check_links(md_path: Path) -> list[str]:
    """Return human-readable problems for every unresolvable link."""
    problems = []
    # fenced code often contains pseudo-links (dict literals etc.); drop it
    prose = FENCE_RE.sub("", md_path.read_text())
    for target in LINK_RE.findall(prose):
        if target.startswith(EXTERNAL):
            continue
        path_part, _, anchor = target.partition("#")
        dest = md_path if not path_part else (md_path.parent / path_part).resolve()
        if not dest.exists():
            problems.append(f"{md_path}: broken link -> {target}")
            continue
        if anchor and dest.suffix == ".md" and github_slug(anchor) not in anchors_of(dest):
            problems.append(f"{md_path}: missing anchor -> {target}")
    return problems


def world_of(md_path: Path) -> int:
    """The ranks a document runs in: its ``<!-- world: N -->`` line, else 1."""
    m = WORLD_RE.match(md_path.read_text())
    return int(m.group(1)) if m else 1


def run_snippets(md_path: Path, device: str, *, who: str = "", first_only: bool = False
                 ) -> list[str]:
    """Execute the file's ``python`` fences in one shared namespace; with
    ``first_only`` stop at the first one that raises."""
    problems = []
    text = md_path.read_text()
    ns: dict = {"__name__": f"docs_snippet[{md_path.name}]", "DEVICE": device}
    for m in FENCE_RE.finditer(text):
        if m.group(1) != "python":
            continue
        line = text[: m.start()].count("\n") + 2  # first line inside the fence
        try:
            exec(compile(m.group(2), f"{md_path}:{line}", "exec"), ns)  # noqa: S102
        except Exception:
            problems.append(f"{who}{md_path}:{line}: snippet raised\n{traceback.format_exc()}")
            if first_only:
                break
    return problems


def _rank_main(rank: int, doc: str, root: str, device: str, world: int) -> None:
    """One rank of a world: start the default process group, run the
    document's snippets, write what failed to ``<root>/rank<r>.txt``."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{root}/store", rank=rank, world_size=world)
    problems = run_snippets(Path(doc), device, who=f"rank {rank}: ", first_only=True)
    if problems:
        Path(root, f"rank{rank}.txt").write_text("\n".join(problems))
        os._exit(1)  # the other ranks may wait in a collective: do not tear down the group
    dist.destroy_process_group()


def run_world(md_path: Path, device: str, world: int) -> list[str]:
    """Run a document in ``world`` ranks: one subprocess (its own process
    group) spawns them; any failure, or the time limit, kills the group."""
    if device == "cuda":
        import torch

        if torch.cuda.device_count() < world:
            return [f"{md_path}: needs {world} cards, one a rank; "
                    f"{torch.cuda.device_count()} here (run it with --device cpu)"]
    root = tempfile.mkdtemp(prefix="check_docs_torch_")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p)}
    proc = subprocess.Popen(
        [sys.executable, __file__, "--world-run", str(md_path), root, "--device", device],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        process_group=0,
    )
    problems = []
    try:
        _, err = proc.communicate(timeout=WORLD_TIMEOUT)
    except subprocess.TimeoutExpired:
        _, err = "", ""
        problems.append(f"{md_path}: the world of {world} ranks ran over {WORLD_TIMEOUT} s")
    if proc.returncode != 0 or problems:
        try:
            os.killpg(proc.pid, signal.SIGKILL)  # the spawner and every rank it started
        except ProcessLookupError:
            pass
        proc.communicate()
        ranks = sorted(Path(root).glob("rank*.txt"))
        problems.extend(p.read_text() for p in ranks)
        if not ranks and not problems:
            problems.append(f"{md_path}: the world of {world} ranks failed "
                            f"(exit {proc.returncode})\n{err[-4000:]}")
    shutil.rmtree(root, ignore_errors=True)
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the DEVICE the snippets run on (default cuda)")
    ap.add_argument("--doc", action="append",
                    help="a document of docs/repro_torch by name (e.g. serving); repeatable; "
                         "default all")
    ap.add_argument("--links-only", action="store_true", help="check links, run no snippet")
    ap.add_argument("--world-run", nargs=2, metavar=("DOC", "DIR"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT / "src"))
    if args.world_run:  # the spawner of one document's ranks
        import torch.multiprocessing as mp

        doc, root = args.world_run
        world = world_of(Path(doc))
        mp.spawn(_rank_main, args=(doc, root, args.device, world), nprocs=world)
        return 0

    md_files = sorted(DOCS.glob("*.md"))
    if args.doc:
        names = {d.removesuffix(".md") for d in args.doc}
        md_files = [f for f in md_files if f.stem in names]
        if len(md_files) != len(names):
            ap.error(f"no such document in {DOCS.relative_to(ROOT)}: {sorted(names)}")
    problems: list[str] = []
    for f in md_files:
        problems.extend(check_links(f))
    if not args.links_only:
        for f in md_files:
            world = world_of(f)
            print(f"executing snippets: {f.relative_to(ROOT)} on {args.device}"
                  + (f" in {world} ranks" if world > 1 else ""), flush=True)
            problems.extend(run_world(f, args.device, world) if world > 1
                            else run_snippets(f, args.device))
    if problems:
        print("\n--- docs check FAILED ---")
        for p in problems:
            print(p)
        return 1
    print(f"docs check OK ({len(md_files)} files)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
