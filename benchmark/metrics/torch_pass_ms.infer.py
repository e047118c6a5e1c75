"""Device milliseconds a forward in kernels that are not the port's own
(the clamp of ReLU, pools, GELU, adds, casts, pads), from the traced
stretch; copies and sets are not counted."""
from benchmark.core.trace import named, seconds_per_unit

# the port's CUDA kernels (quantize_tpu_torch/csrc/*.cu), frozen
PORT = named("absmax_kernel", "conv1x1_res_kernel", "conv1x1_res_wgmma_kernel",
             "grouped_wgmma_kernel", "ln_kernel", "ln_q_kernel", "ln_q_vec_kernel",
             "mha_rows_int8_kernel", "mha_rows_int8_streamed_kernel", "mha_rows_kernel",
             "qconv2d_grouped_kernel", "qconv2d_wgmma_kernel", "quantize_act_kernel",
             "w4a8_gemm_kernel", "w4a8_wgmma_kernel", "w8a8_gemm_kernel", "w8a8_wgmma_kernel",
             "w8a8_wgmma_split_kernel", "wo_gemm_kernel")


def read(cell, outcome):
    s = seconds_per_unit(outcome.get("stretch"),
                         lambda n: not PORT(n) and not n.startswith(("Memcpy", "Memset")))
    return None if s is None else s * 1e3
