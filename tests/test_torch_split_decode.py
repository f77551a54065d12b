"""The split-K decode cache (``attention.SeqKVCache``) in 8-rank gloo worlds.

The dry-run's decode cells cut the KV cache by slots over ``"model"``
(``launch/specs.py``): each rank attends every query head against its own
slots and the ranks' partial softmax statistics meet by log-sum-exp in
rank order.  One subprocess, ``python tests/test_torch_split_decode.py
decode <dir>``, spawns 8 gloo ranks (as ``tests/test_torch_fsdp.py``'s)
and rank 0 writes ``<dir>/out.npz``: the reference's prefilled cache cut
into each rank's slots, ``DECODE_STEPS`` decode steps at (1, 8) and (2,
4) for reduced qwen3-8b (2 kv heads: they do not divide), h2o-danube-3-4b
(a window of 16 slots: the ring wraps) and whisper-base (self and cross
caches), against the reference's unsharded ``decode_step`` (run in this
process, jitted) at the fp32 bound, and bitwise a repeat of the port's run.

By hand (inputs first, as the fixture writes them): ``PYTHONPATH=src python
tests/test_torch_split_decode.py decode <dir>``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_fsdp import CASE_TIMEOUT, ROOT, TOL, WORLD, _all, _gather_objects, _np, \
    _reference_model

DECODE_ARCHS = ("qwen3-8b", "h2o-danube-3-4b", "whisper-base")
DECODE_MESHES = ((1, 8), (2, 4))
DECODE_BATCH, PROMPT, MAX_LEN, DECODE_STEPS, FRAMES = 2, 8, 32, 24, 16


# ---------------------------------------------------------- the rank side
def _seq_blocks(entry, rows, mesh):
    """This rank's slots of a whole ``(k, v)`` cache entry (B, W, Hk, hd),
    its data rows, as a ``SeqKVCache``."""
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.attention import SeqKVCache

    tp, r = meshlib.model_coord(mesh)
    w = entry[0].shape[1] // tp
    return SeqKVCache(*(torch.from_numpy(np.array(x[rows, r * w:(r + 1) * w]))  # a copy
                        for x in entry))


def _case_decode(root: str, out: dict) -> None:
    from repro_torch.configs import get_config
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model
    from repro_torch.models.encdec import EncDecCache
    from repro_torch.models.transformer import DecodeCache

    for arch in DECODE_ARCHS:
        cfg = get_config(arch).reduced()
        model = build_model(cfg, device="cpu")
        params_from_numpy(model, dict(np.load(f"{root}/params_{arch}.npz")))
        cache = dict(np.load(f"{root}/cache_{arch}.npz"))
        steps = np.load(f"{root}/decode_tokens.npz")[arch]
        for shape in DECODE_MESHES:
            mesh = meshlib._mesh(shape, ("data", "model"), "cpu")
            n, i = meshlib.dp_coord(mesh)
            rows = slice(i * DECODE_BATCH // n, (i + 1) * DECODE_BATCH // n)
            p = meshlib.shard_tree(model.params, model.partition_specs(mesh, drop_fsdp=True), mesh)
            runs = []
            for _ in range(2):
                if cfg.is_encdec:
                    c = EncDecCache(
                        [_seq_blocks((cache[f"self/{j}/k"], cache[f"self/{j}/v"]), rows, mesh)
                         for j in range(cfg.dec_layers)],
                        [_seq_blocks((cache[f"cross/{j}/k"], cache[f"cross/{j}/v"]), rows, mesh)
                         for j in range(cfg.dec_layers)], int(cache["length"]))
                else:
                    c = DecodeCache(
                        [_seq_blocks((cache["k"][j], cache["v"][j]), rows, mesh)
                         for j in range(cfg.n_layers)], int(cache["length"]))
                got = []
                with meshlib.use_mesh(mesh):
                    for t in range(DECODE_STEPS):
                        logits, c = model.decode_step(p, torch.from_numpy(steps[rows, t:t + 1]), c)
                        got.append(_np(meshlib.NamedSharding.of(mesh, (None, None, "model"))
                                       .assemble(logits)))
                runs.append(np.stack(got))
            repeat = all(np.array_equal(x, y) for x, y in zip(*runs))
            tag = f"{arch}/{shape[0]}x{shape[1]}"
            out[f"{tag}/repeat_bitwise"] = _all(repeat)
            seen = dict(_gather_objects((i, runs[0])))  # each data group's rows
            out[f"{tag}/logits"] = np.concatenate([seen[d] for d in range(n)], axis=1)


def _rank_main(rank: int, case: str, root: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/store", rank=rank,
                            world_size=WORLD)
    try:
        out = {}
        _case_decode(root, out)
        if rank == 0:
            np.savez(f"{root}/out.npz", **out)
    finally:
        dist.destroy_process_group()


# -------------------------------------------------------- the pytest side
def _inputs(root: Path) -> dict:
    """The reference's initial parameters, prefilled caches and decode
    tokens, written for the ranks; returns the reference's decode logits
    ``{arch: (steps, B, V)}``."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint.manager import _flatten

    rng = np.random.default_rng(0)
    decode_tokens, logits = {}, {}
    for i, arch in enumerate(DECODE_ARCHS):
        jm = _reference_model(arch)
        params = jm.init(jax.random.PRNGKey(i))
        np.savez(root / f"params_{arch}.npz",
                 **{k: np.asarray(v) for k, v in _flatten(params).items()})
        cfg = jm.cfg
        batch = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab, (DECODE_BATCH, PROMPT))
                                       .astype(np.int32))}
        if cfg.is_encdec:
            batch["frames"] = jnp.asarray(rng.standard_normal(
                (DECODE_BATCH, FRAMES, cfg.d_model)).astype(np.float32))
        cache, _ = jm.prefill(params, batch, max_len=MAX_LEN)
        steps = rng.integers(0, cfg.vocab, (DECODE_BATCH, DECODE_STEPS)).astype(np.int32)
        decode_tokens[arch] = steps
        if cfg.is_encdec:
            flat = {"length": np.asarray(cache.length)}
            for j, (kv, cross) in enumerate(zip(cache.self_kv, cache.cross_kv)):
                flat[f"self/{j}/k"], flat[f"self/{j}/v"] = np.asarray(kv.k), np.asarray(kv.v)
                flat[f"cross/{j}/k"], flat[f"cross/{j}/v"] = map(np.asarray, cross)
        else:
            e = cache.entries
            k = np.stack([np.asarray(x.k) for x in e]) if isinstance(e, list) else np.asarray(e.k)
            v = np.stack([np.asarray(x.v) for x in e]) if isinstance(e, list) else np.asarray(e.v)
            flat = {"k": k, "v": v, "length": np.asarray(cache.length)}
        np.savez(root / f"cache_{arch}.npz", **flat)
        step = jax.jit(jm.decode_step)
        got = []
        for t in range(DECODE_STEPS):
            lg, cache = step(params, jnp.asarray(steps[:, t:t + 1]), cache)
            got.append(np.asarray(lg, np.float32))
        logits[arch] = np.stack(got)
    np.savez(root / "decode_tokens.npz", **decode_tokens)
    return logits


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``get()`` -> the 8-rank case's results (``get.decode``: the
    reference's decode logits, made before the ranks start)."""
    root = tmp_path_factory.mktemp("split_decode")
    decode = _inputs(root)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.Popen([sys.executable, __file__, "decode", str(root)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            process_group=0)
    done = {}

    def get():
        if "result" not in done:
            try:
                _, err = proc.communicate(timeout=CASE_TIMEOUT)
                if proc.returncode != 0:
                    done["result"] = AssertionError(f"case decode failed:\n{err[-4000:]}")
                else:
                    done["result"] = dict(np.load(root / "out.npz"))
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, 9)  # the case and the ranks it spawned
                proc.communicate()
                done["result"] = AssertionError(f"case decode ran over {CASE_TIMEOUT} s")
        if isinstance(done["result"], Exception):
            raise done["result"]
        return done["result"]

    get.decode = decode
    yield get
    if proc.poll() is None:
        os.killpg(proc.pid, 9)
        proc.communicate()


DECODE_RUNS = [(a, m) for a in DECODE_ARCHS for m in DECODE_MESHES]


@pytest.mark.parametrize("case", DECODE_RUNS, ids=lambda c: f"{c[0]}/{c[1][0]}x{c[1][1]}")
def test_split_k_decode_holds_the_references_unsharded_decode(run, case):
    arch, (dp, tp) = case
    port = run()
    got = port[f"{arch}/{dp}x{tp}/logits"]
    want = run.decode[arch]
    v = _reference_model(arch).cfg.vocab
    np.testing.assert_allclose(got[..., :v], want[..., :v], **TOL)


@pytest.mark.parametrize("case", DECODE_RUNS, ids=lambda c: f"{c[0]}/{c[1][0]}x{c[1][1]}")
def test_split_k_decode_repeats_bitwise(run, case):
    arch, (dp, tp) = case
    assert bool(run()[f"{arch}/{dp}x{tp}/repeat_bitwise"])


if __name__ == "__main__":
    case_, root_ = sys.argv[1], sys.argv[2]
    torch.multiprocessing.spawn(_rank_main, args=(case_, root_), nprocs=WORLD)
