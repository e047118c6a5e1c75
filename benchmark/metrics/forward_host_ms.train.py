"""Host time a training step in its forward phase (the quant-mode forward and
its loss): the program's span ``qat.forward`` over the traced stretch's
``qat.step`` calls (the QAT cell)."""
from benchmark.core.spans import host_ms_per


def read(cell, outcome):
    return host_ms_per(outcome, lambda name: name == "qat.forward", "qat.step")
