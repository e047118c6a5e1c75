"""Host time a training step in its backward phase (the gradients, and their
all-reduce on a mesh): the program's span ``qat.backward`` over the traced
stretch's ``qat.step`` calls (the QAT cell)."""
from benchmark.core.spans import host_ms_per


def read(cell, outcome):
    return host_ms_per(outcome, lambda name: name == "qat.backward", "qat.step")
