"""The whole forward's share of the chip's int8 peak: the model's operations
an image from its published shapes (2 x the multiply-accumulates of every
conv, linear and attention product, ``benchmark/core/work.py``) times the
run's ``img_per_s``, over 1,979 TOP/s."""
from benchmark.core import work


def read(cell, outcome):
    rate = outcome["e2e"].get("img_per_s")
    if not rate:
        return None
    return 100.0 * work.ops_per_image(cell.config) * rate / work.PEAKS["int8"]
