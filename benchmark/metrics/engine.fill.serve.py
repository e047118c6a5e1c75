"""Share of the batch rows that carried requests, over the window's
batches (``InferenceEngine.stats()``: processed / batches / batch size,
before and after the window)."""


def read(cell, outcome):
    engine = outcome.get("engine")
    return engine["fill"] if engine and engine["batches"] else None
