"""Kernel KA (``csrc/adam_update.cu``): the optimizer's Adam update over
every leaf of a step in one launch.

:class:`~quantize_tpu_torch.optim.Optimizer` sends the leaves of each chain
that ``optim.py``'s registry builds for ``adam`` and ``adamw`` (and of such
a chain followed by ``Scale``) here as a table of ``(p, g, mu, nu)``
records, with the step's scalars (:class:`AdamScalars`), each rounded to
float32 on the host as the per-leaf transforms round it. On CUDA tensors
:func:`adam_update` launches the kernel, one launch a chunk of
:data:`ADAM_CHUNK` leaves; on CPU tensors it runs :func:`adam_update_plain`,
the same operations in the same order over the same table. Both are
bit-equal to the per-leaf chain. A leaf the update does not take
(:func:`takes`) is left as it was and its position returned: the caller's
to update leaf by leaf.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import profiling
from . import _build

# leaves a launch: csrc/adam_update.cu's MAX_LEAVES
ADAM_CHUNK = 640

Leaf = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor, torch.Tensor]


class AdamScalars(NamedTuple):
    """One step's scalars, each a float32 value: ``b1``, ``b2``, ``omb1 =
    f32(1 - b1)``, ``omb2 = f32(1 - b2)``, ``eps``, the bias corrections
    ``c1``, ``c2`` (``1 - b ** count``), the weight decay ``wd`` (AdamW;
    None: no decay), ``neg_lr`` (``-lr`` at the schedule's count) and the
    ``Scale`` factor ``qs`` (None: no scale)."""

    b1: float
    b2: float
    omb1: float
    omb2: float
    eps: float
    c1: float
    c2: float
    wd: Optional[float]
    neg_lr: float
    qs: Optional[float]


def takes(p: torch.Tensor, g: Optional[torch.Tensor], mu: torch.Tensor, nu: torch.Tensor,
          device: torch.device) -> bool:
    """Whether the fused update takes a leaf: ``p``, ``mu``, ``nu`` and ``g``
    (unless None) float32, contiguous, of ``p``'s shape and on ``device``."""
    for t in (p, mu, nu) if g is None else (p, g, mu, nu):
        if (t.dtype != torch.float32 or t.device != device or not t.is_contiguous()
                or t.shape != p.shape):
            return False
    return True


def adam_update_plain(leaves: Sequence[Leaf], s: AdamScalars) -> None:
    """Plain version of kernel KA: each leaf in place, ``g`` None as zeros.
    The bias corrections divide as 0-d tensors on the leaves' device, as the
    chain divides: CUDA PyTorch turns a division by a Python scalar into a
    multiplication by its reciprocal."""
    c = {}
    for p, g, mu, nu in leaves:
        if p.device not in c:
            c[p.device] = [torch.full((), x, dtype=p.dtype, device=p.device) for x in (s.c1, s.c2)]
        c1, c2 = c[p.device]
        if g is None:
            g = torch.zeros_like(p)
        mu.mul_(s.b1).add_(g * s.omb1)
        nu.mul_(s.b2).add_(g * g * s.omb2)
        u = (mu / c1) / (torch.sqrt(nu / c2) + s.eps)
        if s.wd is not None:
            u = u + s.wd * p
        u = s.neg_lr * u
        if s.qs is not None:
            u = s.qs * u
        p.add_(u)


@profiling.spanned("op.adam_update")
def adam_update(leaves: Sequence[Leaf], s: AdamScalars) -> List[int]:
    """Kernel KA over each of ``leaves`` (``(p, g, mu, nu)``, ``g`` None
    where the leaf has no gradient) that :func:`takes` accepts on the first
    leaf's device, ``p``, ``mu`` and ``nu`` updated in place: on CPU tensors
    by :func:`adam_update_plain`, on CUDA tensors by ``csrc/adam_update.cu``
    on the current stream (no host sync, nothing copied to the card).
    Returns the positions of the leaves it left as they were (every leaf on
    another device type)."""
    if not leaves:
        return []
    dev = leaves[0][0].device
    if dev.type not in ("cpu", "cuda"):
        return list(range(len(leaves)))
    taken, rows, refused = [], [], []
    for i, (p, g, mu, nu) in enumerate(leaves):
        if not takes(p, g, mu, nu, dev):
            refused.append(i)
            continue
        taken.append((p, g, mu, nu))
        if p.numel():
            rows.append((p.data_ptr(), 0 if g is None else g.data_ptr(), mu.data_ptr(),
                         nu.data_ptr(), p.numel()))
    if dev.type == "cpu":
        adam_update_plain(taken, s)
        return refused
    if rows:
        table = np.array(rows, dtype=np.int64)
        fn = _build.kernel_fn("adam_update")
        with _build.device_guard(dev):
            err = fn(table.ctypes.data, len(rows), s.b1, s.b2, s.omb1, s.omb2, s.eps, s.c1, s.c2,
                     0.0 if s.wd is None else s.wd, s.neg_lr, 1.0 if s.qs is None else s.qs,
                     int(s.wd is not None), int(s.qs is not None), _build.current_stream(dev))
        _build.check(err, "adam_update")
        adam_update.launches += -(-len(rows) // ADAM_CHUNK)
    # written through pointers: bump the version counters as in-place ops do
    torch.autograd.graph.increment_version([t for p, _, mu, nu in taken for t in (p, mu, nu)])
    return refused


adam_update.launches = 0
