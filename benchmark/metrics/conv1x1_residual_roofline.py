"""K2 (``conv1x1_residual``) against its roofline: the least time of every
bottleneck's last 1x1 conv with its residual add and ReLU (int8 input and
weight, residual and output in the carry dtype; bound by bytes), over the
device time of its kernels a forward."""
from benchmark.core import work
from benchmark.core.trace import named, seconds_per_unit

KERNEL = named("conv1x1_res_wgmma_kernel", "conv1x1_res_kernel")


def read(cell, outcome):
    t = seconds_per_unit(outcome.get("stretch"), KERNEL)
    if t is None:
        return None
    carry, batch = cell.config.get("carry", "float32"), int(cell.traffic["batch"])
    bound = sum(work.bound_s(layer, batch, "int8", "int8", "int8", carry, carry)[0]
                for layer in work.model_layers(cell.config) if layer.kind == "conv_residual")
    return 100.0 * bound / t
