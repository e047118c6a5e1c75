"""MobileNetV3 small and large W8A8 in the port, held against the JAX
package on the CPU (batch 2, 32 x 32, 10 classes), through
``tests/_torch_parity.py``: the hard-swish blocks, the squeeze-excite 1 x
1 convs with bias (on K3's plain version at 1 x 1 spatial size), the 5 x 5
depthwise convs (the float path) and the two dense heads. JAX's pack and
packed forward run under ``jit`` here (its eager packed forward of V3
takes tens of seconds): the pack buffers bit-equal, the packed logits
within the network's quantization noise with the same argmax (XLA
contracts the epilogues into FMAs, which may move a value across a
round() boundary).
"""
import numpy as np
import pytest
import torch

from _torch_parity import check_calibrated, check_fp32_and_quant, check_packed, run_both

torch.set_num_threads(2)

W8 = {"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel",
      "range": {"name": "minmax"}}
A8 = {"n_bits": 8, "symmetric": False, "granularity": "layer", "range": {"name": "minmax"}}


@pytest.fixture(scope="module", params=["mobilenet_v3_small", "mobilenet_v3_large"])
def case(request):
    rng = np.random.default_rng(30)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    x_cal = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    return run_both(request.param, {"default": {"weight": W8, "activation": A8,
                                                "bn_folding": True}},
                    x, x_cal, eager_packed=False)


def test_mobilenet_v3_calibrates_as_jax(case):
    check_calibrated(case)


def test_mobilenet_v3_fp32_and_quant_logits_match_jax(case):
    check_fp32_and_quant(case)


def test_mobilenet_v3_packs_and_serves_as_jax(case):
    mine, _ = case["packed_buffers"]
    assert any(k.endswith("se/fc1/conv/w_int") for k in mine)
    check_packed(case, "noise")
