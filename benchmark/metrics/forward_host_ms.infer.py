"""Host time a packed forward: the program's span ``forward.packed``
(``quantize_tpu_torch.profiling.span_totals``) over the traced stretch's
forwards, the profiler's cost inside (offline cells)."""
from benchmark.core.spans import host_ms_per


def read(cell, outcome):
    return host_ms_per(outcome, lambda name: name == "forward.packed", "forward.packed")
