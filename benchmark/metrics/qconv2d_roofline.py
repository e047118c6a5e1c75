"""K3 (``qconv2d``) against its roofline: the least time of the convs the
model's math puts on it (ResNet's stem, every conv1, conv2 and downsample:
int8 input and weight, output in the carry dtype; bound by bytes at
ResNet-50's shapes), over the device time of its kernels a forward."""
from benchmark.core import work
from benchmark.core.trace import named, seconds_per_unit

KERNEL = named("qconv2d_wgmma_kernel")


def read(cell, outcome):
    t = seconds_per_unit(outcome.get("stretch"), KERNEL)
    if t is None:
        return None
    carry, batch = cell.config.get("carry", "float32"), int(cell.traffic["batch"])
    bound = sum(work.bound_s(layer, batch, "int8", "int8", "int8", carry)[0]
                for layer in work.model_layers(cell.config) if layer.kind == "conv")
    return 100.0 * bound / t
