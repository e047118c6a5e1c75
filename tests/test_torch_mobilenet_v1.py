"""MobileNetV1 (the reference's custom V1) W4A8 in the port, held against
the JAX package on the CPU (batch 2, 32 x 32, 10 classes), through
``tests/_torch_parity.py``. Every pointwise conv has an even input width,
so its 4-bit weight is stored as int4 pairs along the input channels
(``packed/w_p4c``, ``quant/pack.py:pack_int4_pairs``), bytes equal to
JAX's; the depthwise convs (one input channel a group) keep ``w_int``.
The packed forward unpacks them, then runs K3's plain version (the
pointwise convs and the stem) and the float path (the depthwise convs):
bit-equal to eager JAX's.
"""
import numpy as np
import pytest
import torch

from _torch_parity import check_calibrated, check_fp32_and_quant, check_packed, run_both

torch.set_num_threads(2)

W4 = {"n_bits": 4, "symmetric": True, "signed": True, "granularity": "channel",
      "range": {"name": "minmax"}}
A8 = {"n_bits": 8, "symmetric": False, "granularity": "layer", "range": {"name": "minmax"}}


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    x_cal = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    return run_both("mobilenet_v1", {"default": {"weight": W4, "activation": A8,
                                                 "bn_folding": True}}, x, x_cal)


def test_mobilenet_v1_w4_calibrates_as_jax(case):
    check_calibrated(case)


def test_mobilenet_v1_w4_fp32_and_quant_logits_match_jax(case):
    check_fp32_and_quant(case)


def test_mobilenet_v1_w4_packs_int4_pairs_and_serves_as_jax(case):
    mine, theirs = case["packed_buffers"]
    p4c = sorted(k for k in theirs if k.endswith("w_p4c"))
    # the 13 pointwise convs (even input widths); the stem (3 channels) and
    # the depthwise convs (1 a group) keep int8
    assert len(p4c) == 13 and all(k.startswith("pw") for k in p4c)
    assert not any(k.startswith("pw") and k.endswith("w_int") for k in theirs)
    assert mine["dw0_conv/w_int"].dtype == np.int8
    check_packed(case)
