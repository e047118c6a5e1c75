"""MobileNetV2 (``width_mult`` 0.25) in the port, held against the JAX
package on the CPU (batch 2, 32 x 32, 10 classes), through
``tests/_torch_parity.py``:

* W8A8 (``mobile_stack_w8a8``'s quant section): fp32 logits at rtol 1e-4,
  calibrated qparams at rtol 1e-5 (float32 reassociation of the calibrate
  convs), quant logits within the network's quantization noise with the
  same argmax, pack buffers bit-equal, and the packed logits (the 1 x 1
  convs on K3's plain version, the depthwise convs on the float path,
  the classifier on K1's) bit-equal to eager JAX's, from the port's pack
  and from JAX's deploy variables;
* W8 weight-only (``ptq_mbv2_w8only_in1k.yaml``'s quant section: every
  conv a dequantized weight and a float32 library conv, as in JAX; the
  classifier on K5's plain version): the packed logits within float32
  reassociation (rtol 1e-5) of JAX's.
"""
import numpy as np
import pytest
import torch

from _torch_parity import check_calibrated, check_fp32_and_quant, check_packed, run_both

torch.set_num_threads(2)

W8 = {"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel",
      "range": {"name": "minmax"}}
A8 = {"n_bits": 8, "symmetric": False, "signed": False, "granularity": "layer",
      "range": {"name": "minmax"}}
CASES = {"w8a8": ({"weight": W8, "activation": A8, "bn_folding": True}, "exact"),
         "w8_weight_only": ({"weight": W8, "activation": {"n_bits": 32}, "bn_folding": True},
                            "float")}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    cfg, logits = CASES[request.param]
    rng = np.random.default_rng(20)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    x_cal = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    out = run_both("mobilenet_v2", {"default": cfg}, x, x_cal, {"width_mult": 0.25})
    out["logits"] = logits
    return out


def test_mobilenet_v2_calibrates_as_jax(case):
    check_calibrated(case)


def test_mobilenet_v2_fp32_and_quant_logits_match_jax(case):
    check_fp32_and_quant(case)


def test_mobilenet_v2_packs_and_serves_as_jax(case):
    check_packed(case, case["logits"])
