"""Linear-recurrence scan  h_t = a_t * h_{t-1} + b_t  (elementwise).

Port of ``repro.models.scan_utils``.  The reference solves a block with
``lax.associative_scan`` (log depth) and, when ``chunk`` divides the
sequence, carries the boundary state across chunks with ``lax.scan``; the
chunk bound caps the materialized (B, S_c, ...) discretized-state
intermediates.  The port runs the same odd/even recursion as
``associative_scan`` over the same combine ``(a1*a2, a2*b1 + b2)`` in plain
torch, and a Python loop over the chunks under the same divisibility rule.
Parity with the reference holds at tolerance, not bitwise: XLA fuses and
rounds the elementwise steps its own way.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _combine(lhs, rhs):
    a1, b1 = lhs
    a2, b2 = rhs
    return a1 * a2, a2 * b1 + b2


def _slice(x: Tensor, axis: int, start: int, stop: int | None, step: int = 1) -> Tensor:
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(start, stop, step)
    return x[tuple(idx)]


def _interleave(a: Tensor, b: Tensor, axis: int) -> Tensor:
    """``a0, b0, a1, b1, ...`` along ``axis``; ``a`` has as many entries as
    ``b`` or one more."""
    na, nb = a.shape[axis], b.shape[axis]
    if na == nb + 1:
        b = torch.cat([b, torch.zeros_like(_slice(a, axis, 0, 1))], axis)
    out = torch.stack([a, b], axis + 1).flatten(axis, axis + 1)
    return _slice(out, axis, 0, na + nb)


def _associative_scan(elems: tuple[Tensor, Tensor], axis: int) -> tuple[Tensor, Tensor]:
    """Inclusive scan of ``elems`` under :func:`_combine` along ``axis``, by
    the odd/even recursion of ``jax.lax.associative_scan``."""
    n = elems[0].shape[axis]
    if n < 2:
        return elems
    reduced = _combine(tuple(_slice(e, axis, 0, n - 1, 2) for e in elems),
                       tuple(_slice(e, axis, 1, None, 2) for e in elems))
    odd = _associative_scan(reduced, axis)
    if n % 2 == 0:
        even = _combine(tuple(_slice(e, axis, 0, -1) for e in odd),
                        tuple(_slice(e, axis, 2, None, 2) for e in elems))
    else:
        even = _combine(odd, tuple(_slice(e, axis, 2, None, 2) for e in elems))
    even = tuple(torch.cat([_slice(e, axis, 0, 1), r], axis) for e, r in zip(elems, even))
    return tuple(_interleave(e, o, axis) for e, o in zip(even, odd))


def linear_scan(
    a: Tensor, b: Tensor, h0: Tensor | None = None, *, axis: int = 1, chunk: int = 0
) -> tuple[Tensor, Tensor]:
    """Returns (h_all, h_last); a/b shaped (..., S, ...) along ``axis``.

    ``h0`` (same shape as one step) seeds the recurrence.  ``chunk`` > 0
    that divides S (and is below it) runs the chunks one after the other,
    each solved with the parallel scan; otherwise the whole sequence is one
    block.
    """
    s = a.shape[axis]
    if h0 is None:
        h0 = torch.zeros_like(a.select(axis, 0))

    def block(a_blk: Tensor, b_blk: Tensor, carry: Tensor) -> tuple[Tensor, Tensor]:
        first = b_blk.select(axis, 0) + a_blk.select(axis, 0) * carry
        b_blk = torch.cat([first.unsqueeze(axis), _slice(b_blk, axis, 1, None)], axis)
        _, h = _associative_scan((a_blk, b_blk), axis)
        return h, h.select(axis, -1)

    if not chunk or s <= chunk or s % chunk != 0:
        return block(a, b, h0)

    hs, last = [], h0
    for start in range(0, s, chunk):
        h, last = block(a.narrow(axis, start, chunk), b.narrow(axis, start, chunk), last)
        hs.append(h)
    return torch.cat(hs, axis), last


def causal_conv1d(
    x: Tensor, w: Tensor, b: Tensor | None, *, buf: Tensor | None = None
) -> tuple[Tensor, Tensor]:
    """Depthwise causal 1-D conv.  x: (B, S, D); w: (D, K); returns (y, new_buf).

    ``buf`` is the (B, K-1, D) tail of the previous segment (decode carries
    it); the returned new_buf is the updated tail.
    """
    batch, s, d = x.shape
    k = w.shape[1]
    if buf is None:
        buf = torch.zeros((batch, k - 1, d), dtype=x.dtype, device=x.device)
    xp = torch.cat([buf, x], 1)  # (B, S+K-1, D)
    y = torch.zeros_like(x)
    for j in range(k):  # K is 4: unrolled shift-mul-accumulate, as the reference
        y = y + xp[:, j : j + s, :] * w[:, j].to(x.dtype)[None, None, :]
    if b is not None:
        y = y + b.to(x.dtype)
    new_buf = xp[:, s:, :] if k > 1 else buf
    return y, new_buf
