"""Model export through ``torch.export``.

PyTorch counterpart of ``quantize_tpu/export.py``, which serializes the
jitted packed forward to StableHLO bytes with the deploy variables baked in
and the Pallas calls kept. Here :func:`export_forward` traces
``model(x, mode=mode)`` with ``torch.export`` and saves the program to
bytes: every hand-written kernel the forward launches is one node of the
graph, a ``torch.ops.qtt`` custom op (:mod:`quantize_tpu_torch.ops.library`),
and the tensors the forward reads (the packed weights, their K-major kernel
copies, qparams, the correction maps) travel in the payload.
:func:`load_exported` turns the bytes back into a callable that runs the
same kernels on the device the program was traced on.

What the trace reads from Python is fixed in the program, as JAX's trace
fixes it: the input's shape, dtype and device, the precision switches of
:mod:`quantize_tpu_torch.nn.precision` (carry dtype, fused tail, int8
carry) and ``QTPU_ATTN_INT8``. There are no dynamic shapes. A process that
loads a program must import ``quantize_tpu_torch`` (``load_exported`` does),
which registers the ``qtt`` ops.
"""
from __future__ import annotations

import io
from typing import Any, Dict, Optional

import torch
from torch.export.graph_signature import ExportGraphSignature, InputKind

# graph inputs the program holds itself (the rest are the caller's x)
_STATE = (InputKind.PARAMETER, InputKind.BUFFER, InputKind.CONSTANT_TENSOR)


class _Forward(torch.nn.Module):
    """``model(x, mode=mode)`` as a module of one tensor input."""

    def __init__(self, model: torch.nn.Module, mode: str):
        super().__init__()
        self.model, self.mode = model, mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x, mode=self.mode)


def _without_unread_state(ep):
    """``ep`` without the parameters, buffers and constants its graph does
    not read (a packed layer's float kernel, observer state) and without
    the sample input, as JAX's export keeps only the variables its trace
    reads."""
    gm = ep.graph_module
    keep = []
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    for node, spec in zip(placeholders, ep.graph_signature.input_specs):
        if spec.kind in _STATE and not node.users:
            gm.graph.erase_node(node)
        else:
            keep.append(spec)
    gm.recompile()
    read = {spec.target for spec in keep}
    return torch.export.ExportedProgram(
        root=gm, graph=gm.graph,
        graph_signature=ExportGraphSignature(input_specs=keep,
                                             output_specs=ep.graph_signature.output_specs),
        state_dict={k: v for k, v in ep.state_dict.items() if k in read},
        range_constraints=ep.range_constraints, module_call_graph=ep.module_call_graph,
        example_inputs=None,
        constants={k: v for k, v in ep.constants.items() if k in read},
        verifiers=ep.verifiers)


def export_program(model: torch.nn.Module, variables: Optional[Dict[str, Any]],
                   sample_x: torch.Tensor, mode: str = "packed"):
    """The ``torch.export.ExportedProgram`` of ``model(x, mode=mode)`` over
    ``sample_x``'s shape, dtype and device, holding only the tensors the
    forward reads. ``variables`` (the deploy variables of
    :func:`~quantize_tpu_torch.deploy.pack_model`, or JAX's) are loaded
    into the model first, as ``model.apply(variables, ...)`` runs on them;
    None traces the model's own state."""
    if variables is not None:
        from .convert import from_jax_variables

        from_jax_variables(model, variables)
    ep = torch.export.export(_Forward(model, mode), (sample_x,), strict=False)
    return _without_unread_state(ep)


def export_forward(model: torch.nn.Module, variables: Optional[Dict[str, Any]],
                   sample_x: torch.Tensor, mode: str = "packed") -> bytes:
    """Serialize ``model(x, mode=mode)`` to bytes (``torch.export.save``).

    The variables travel in the payload, the kernel calls are ``qtt`` ops,
    and the input shape, dtype and device are ``sample_x``'s. The
    precision switches and ``QTPU_ATTN_INT8`` are read while tracing and
    fixed in the program."""
    buf = io.BytesIO()
    torch.export.save(export_program(model, variables, sample_x, mode), buf)
    return buf.getvalue()


def load_exported(payload: bytes):
    """Deserialize an exported forward; returns a callable ``f(x)``. It
    registers the ``qtt`` ops first (importing this package does too)."""
    from .ops import library  # noqa: F401

    return torch.export.load(io.BytesIO(payload)).module()


def export_mlir_text(model: torch.nn.Module, variables: Optional[Dict[str, Any]],
                     sample_x: torch.Tensor, mode: str = "packed") -> str:
    """The readable text of the exported forward (debug and inspection).

    JAX's function of this name prints StableHLO (MLIR); this is the
    ``torch.export`` FX graph, each node annotated with its dtype and shape
    (``i8[...]`` for an int8 tensor) and each kernel a ``torch.ops.qtt``
    call."""
    return export_program(model, variables, sample_x, mode).graph_module.print_readable(
        print_output=False)
