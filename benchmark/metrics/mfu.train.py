"""The whole training step's share of the chip's float32 peak: 3 x the
forward's operations an image from the model's published shapes
(``benchmark/core/work.py``: the backward costs twice the forward) times
the run's ``train_img_per_s``, over 67 TFLOP/s (quant mode runs in float32,
TF32 off, as the configuration states)."""
from benchmark.core import work


def read(cell, outcome):
    rate = outcome["e2e"].get("train_img_per_s")
    if not rate:
        return None
    return 100.0 * 3 * work.ops_per_image(cell.config) * rate / work.PEAKS["f32"]
