"""K8 (``mha_rows``) against its roofline: the least time of ViT's attention
(QK^T and PV over every head at the model's 197 rows, in float32
arithmetic outside the tensor cores; q, k, v and the output in float32;
bound by operations at 67 TFLOP/s), over the device time of its kernel a
forward."""
from benchmark.core import work
from benchmark.core.trace import named, seconds_per_unit

KERNEL = named("mha_rows_kernel")


def read(cell, outcome):
    t = seconds_per_unit(outcome.get("stretch"), KERNEL)
    if t is None:
        return None
    batch = int(cell.traffic["batch"])
    bound = sum(work.bound_s(layer, batch, "f32", "float32", "float32", "float32")[0]
                for layer in work.model_layers(cell.config) if layer.kind == "attention")
    return 100.0 * bound / t
