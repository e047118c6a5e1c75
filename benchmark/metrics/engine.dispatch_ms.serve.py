"""Host time the serving engine's dispatch thread spends on a batch, over
the window's batches (``InferenceEngine.stats()["dispatch_ms"]``, the
program's own counter, before and after the window)."""


def read(cell, outcome):
    engine = outcome.get("engine")
    return engine["dispatch_ms"] if engine and engine["batches"] else None
