"""The program's own spans over a traced run's stretch.

The port marks its work with spans (``quantize_tpu_torch.profiling.span``:
the forward, each block, each kernel wrapper, the phases of a training
step), open only while PyTorch's profiler is on, and keeps their host time
for the latest profiler session (``profiling.span_totals()``: ``{name:
(count, host seconds)}``). A run's drivers profile a warm-up call, run the
window unprofiled, then profile the stretch, so after the run the totals
are the stretch's. A program without spans has no totals, and the readers
of ``program_span`` metrics then read nothing.
"""
from __future__ import annotations


def totals() -> dict:
    """``{name: (count, host seconds)}`` of the latest profiled stretch;
    empty where the program keeps none."""
    from quantize_tpu_torch import profiling

    read = getattr(profiling, "span_totals", None)
    return read() if read is not None else {}


def host_ms_per(outcome: dict, match, per: str):
    """Host ms in the spans whose names ``match`` accepts, over the calls of
    span ``per``; None without a traced stretch or either span."""
    if not outcome.get("stretch"):
        return None
    spans = totals()
    count = spans.get(per, (0, 0.0))[0]
    ms = 1e3 * sum(s for name, (_, s) in spans.items() if match(name))
    return ms / count if count and ms > 0 else None
