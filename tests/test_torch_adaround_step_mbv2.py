"""One joint AdaRound step in the port against the JAX package's on
MobileNetV2 (width 0.25, 32 x 32) W4 weight-only with BN folded, at the
criteria of ``tests/test_torch_adaround_step.py``, whose checks it runs."""
import pytest

import test_torch_adaround_step as base
from _torch_train_parity import A32


@pytest.fixture(scope="module")
def step():
    return base.run_step("mobilenet_v2", A32)


test_init_calibrates_as_jax_and_h_v_is_the_fraction = (
    base.test_init_calibrates_as_jax_and_h_v_is_the_fraction)
test_init_writes_jax_v = base.test_init_writes_jax_v
test_trainable_leaves_are_the_adaround_collection = (
    base.test_trainable_leaves_are_the_adaround_collection)
test_loss_and_calibration_match_jax = base.test_loss_and_calibration_match_jax
test_v_gradients_match_jax = base.test_v_gradients_match_jax
