"""Host time a packed forward in the kernel wrappers: the program's spans
``op.<kernel>`` summed, over the traced stretch's ``forward.packed`` calls
(offline cells); at most ``forward_host_ms.infer``."""
from benchmark.core.spans import host_ms_per


def read(cell, outcome):
    return host_ms_per(outcome, lambda name: name.startswith("op."), "forward.packed")
