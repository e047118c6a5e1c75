"""Host time a training step in its optimizer phase (the trainable leaves
gathered and the optimizer's update): the program's span ``qat.optimizer``
over the traced stretch's ``qat.step`` calls (the QAT cell)."""
from benchmark.core.spans import host_ms_per


def read(cell, outcome):
    return host_ms_per(outcome, lambda name: name == "qat.optimizer", "qat.step")
