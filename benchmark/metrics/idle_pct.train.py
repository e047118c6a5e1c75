"""Share of the traced stretch in which no kernel, copy or set ran on the
card (training cells)."""


def read(cell, outcome):
    s = outcome.get("stretch")
    if not s or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
