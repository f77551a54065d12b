"""Batched LM serving engine: prefill + greedy/temperature decode.

Port of ``repro.serve.engine``.  The engine serves fixed-shape batches:
queued prompts are packed into the next batch of ``batch_size`` rows
through the shared :class:`repro_torch.serve.queue.RequestQueue` (the same
machinery drives the CP service).  As in the reference, a batch's prompts
are left-padded with token 0 to its longest prompt, the pads are attended
(no padding mask) and positions count from the first pad.  An enc-dec
model gets zero frames of the batch's prompt length (the reference's stub
frontend); its prefill decodes only the first prompt token.

Greedy decoding (``temperature <= 0``) is the argmax; sampling draws from
one ``torch.Generator`` seeded with ``gen.seed`` on the logits' device, so
one seed gives one sequence within the port (it cannot give the
reference's ``jax.random`` draws).

On an ambient mesh (``repro_torch.launch.mesh.use_mesh``) the parameters
are each rank's blocks of the serving layout (``Model.partition_specs(mesh,
drop_fsdp=True)``): the decode cache holds this rank's kv heads where they
divide over ``"model"`` (else all of them) and its channels of an SSM or
RG-LRU state (an enc-dec model's cross-attention K/V as its self-attention
cache), the MoE decodes on its experts, the logits of a step are
gathered whole over ``"model"`` before a token is chosen, each data group
serves its rows of a batch (``batch_size`` divides by the data-parallel
size), and the groups' tokens are gathered so that every rank returns every
result.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.dist.collectives import gather_cat
from repro_torch.launch import mesh as meshlib
from repro_torch.models import Model

from .queue import RequestQueue

Tensor = torch.Tensor


@dataclass
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 => greedy
    eos_id: int = -1  # -1 => never stops early
    seed: int = 0


@torch.no_grad()
def generate(
    model: Model,
    params: Any,
    batch: dict,
    gen: GenerationConfig,
) -> np.ndarray:
    """Generate continuations for a batch of equal-length prompts.

    batch: {"tokens": (B, S) int tensor on the params' device, ...family
    extras...}.  Returns (B, max_new_tokens) int32.
    """
    prompt_len = batch["tokens"].shape[1]
    max_len = prompt_len + gen.max_new_tokens + 1
    cache, logits = model.prefill(params, batch, max_len=max_len)
    generator = None
    if gen.temperature > 0.0:
        generator = torch.Generator(device=logits.device).manual_seed(gen.seed)
    outs = []
    tok = _select(_whole(logits[:, -1, :]), gen, generator)
    for _ in range(gen.max_new_tokens):
        outs.append(tok[:, 0])
        logits, cache = model.decode_step(params, tok, cache)
        tok = _select(_whole(logits[:, -1, :]), gen, generator)
    return torch.stack(outs, 1).to(torch.int32).cpu().numpy()


def _whole(logits: Tensor) -> Tensor:
    """A step's logits over the whole vocab: on an active mesh the ranks'
    vocab blocks gathered over ``"model"``."""
    mesh = meshlib.active_mesh()
    return logits if mesh is None else gather_cat(logits, ("model",), mesh, dim=-1)


def _select(logits: Tensor, gen: GenerationConfig, generator: torch.Generator | None) -> Tensor:
    if gen.temperature <= 0.0:
        return torch.argmax(logits, -1).to(torch.int32)[:, None]
    probs = torch.softmax(logits.float() / gen.temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


@dataclass
class Request:
    """One LM generation request: prompt tokens in, generated tokens out."""

    rid: int
    tokens: np.ndarray  # (S,)
    done: bool = False
    output: np.ndarray | None = None


@dataclass
class ServeEngine:
    """Micro engine: enqueue prompts, flush() packs them into fixed batches.

    ``submit`` returns an int rid, ``flush`` returns ``{rid: generated
    tokens}``; a single bucket serves every prompt.  Batches run on the
    device of the model's parameters.
    """

    model: Model
    params: Any
    gen: GenerationConfig
    batch_size: int = 4
    max_pending: int | None = None
    _queue: RequestQueue = field(default_factory=RequestQueue)

    def __post_init__(self):
        self._queue = RequestQueue(self.max_pending)

    def submit(self, tokens: np.ndarray) -> int:
        """Enqueue one prompt; returns its request id.

        Raises :class:`repro_torch.serve.queue.QueueFull` when
        ``max_pending`` requests are already waiting.
        """
        req = self._queue.submit(
            Request(rid=-1, tokens=np.asarray(tokens, np.int32))
        )
        req.payload.rid = req.rid  # the queue owns rid assignment
        return req.rid

    def flush(self) -> dict[int, np.ndarray]:
        """Serve every queued request; returns rid -> generated tokens."""
        results: dict[int, np.ndarray] = {}
        device = self.params["embed"].device
        mesh = meshlib.active_mesh()
        groups, group = meshlib.dp_coord(mesh) if mesh is not None else (1, 0)
        if self.batch_size % groups:
            raise ValueError(f"batch_size {self.batch_size} does not divide over {groups} "
                             "data-parallel groups")
        rows = self.batch_size // groups
        while True:
            chunk = self._queue.take(self.batch_size)
            if not chunk:
                break
            s = max(len(r.payload.tokens) for r in chunk)
            toks = np.zeros((self.batch_size, s), np.int32)
            for i, r in enumerate(chunk):
                toks[i, s - len(r.payload.tokens) :] = r.payload.tokens  # left-pad
            toks = toks[group * rows:(group + 1) * rows]
            batch = {"tokens": torch.from_numpy(toks).to(device)}
            if self.model.cfg.is_encdec:  # the stubbed frontend: zero frames
                batch["frames"] = torch.zeros((rows, s, self.model.cfg.d_model),
                                              dtype=torch.float32, device=device)
            out = generate(self.model, self.params, batch, self.gen)
            if mesh is not None:
                out = gather_cat(torch.from_numpy(out).to(device), meshlib.dp_axes(mesh),
                                 mesh).cpu().numpy()
            for i, r in enumerate(chunk):
                results[r.rid] = out[i]
        return results
