"""K4 (``w4a8_gemm``) against its roofline: the least time of ViT's q/k/v,
MLP and head projections at the model's 197 rows an image (int8 input, int4
weight, output in the carry dtype; bound by bytes), over the device time of
its kernels a forward."""
from benchmark.core import work
from benchmark.core.trace import named, seconds_per_unit

KERNEL = named("w4a8_wgmma_kernel", "w4a8_gemm_kernel")


def read(cell, outcome):
    t = seconds_per_unit(outcome.get("stretch"), KERNEL)
    if t is None:
        return None
    carry, batch = cell.config.get("carry", "float32"), int(cell.traffic["batch"])
    bound = sum(work.bound_s(layer, batch, "int8", "int8", "int4", carry)[0]
                for layer in work.model_layers(cell.config) if layer.kind == "linear")
    return 100.0 * bound / t
