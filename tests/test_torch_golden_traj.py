"""The reference's golden training trajectories (``tests/golden/traj.json``)
replayed through the port's AdaRound (joint mode) and QAT runners on the
CPU, at exactly ``tests/test_golden_traj.py``'s criteria.

``adaround_traj_w4``: the per-step losses (rtol/atol 2e-3), the final V on
the active sigmoid region (97% of the pooled differences within 5e-3, none
above 0.05, at least 60% active), the rounding decisions exact where the
reference's |V| > 2e-2 (over 1000 elements), the calibrated qparams
(rtol 2e-3) and held-out quant logits within the reference's quantization
noise with argmax agreement on the decided rows.

``qat_traj_w8a8``: the calibration epoch, then the per-step cross-entropy
losses (rtol/atol 2e-3), scale and zero after one SGD step (rtol 2e-3,
atol 1e-4), the final weights and biases (99.5% within 5e-4, none above
5e-3) and the held-out fp32 logits (rtol/atol 2e-3).
"""
import numpy as np
import torch
from test_golden_models import _flat_qparams
from test_golden_traj import (_CASES, _FixtureLoader, _batches, _check_logits, _check_qparams,
                              _nhwc, _runner_cfg, _state_dict, _torch_order, _trajnet_params)
from weightgen import gen_input

from quantize_tpu_torch import convert
from quantize_tpu_torch.nn.quantizer import reset_observers
from quantize_tpu_torch.runners.adaround import AdaRound
from quantize_tpu_torch.runners.qat import QAT
from quantize_tpu_torch.utils import Config

torch.set_num_threads(2)


def _runner(cls, tmp_path, c, name, batches, extra_train=None):
    """The port's runner on the fixture's config and batches, from the
    fixture's weights with fresh observers (as the JAX test sets them)."""
    runner = cls(Config(_runner_cfg(tmp_path, c, name, extra_train).to_dict()),
                 _FixtureLoader(batches), device="cpu")
    runner.init_variables(batches[0], seed=0)
    convert.from_jax_variables(runner.model, {"params": _trajnet_params(_state_dict(c))})
    reset_observers(runner.model)
    return runner


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _eval_x(c):
    return torch.from_numpy(_nhwc(gen_input(c["eval_seed"], tuple(c["x_shape"]), c["in_scale"],
                                            c["in_loc"])))


def test_adaround_trajectory_replays_through_the_port(tmp_path):
    c = _CASES["adaround_traj_w4"]
    batches = _batches(c, c["traj_seeds"])
    runner = _runner(AdaRound, tmp_path, c, "adaround", batches)
    losses = [runner.train_step(_t(b), 0, it, len(batches))[0] for it, b in enumerate(batches)]
    np.testing.assert_allclose(losses, c["losses"], rtol=2e-3, atol=2e-3,
                               err_msg="per-step AdaRound loss trajectory")

    variables = convert.to_numpy(runner.model)
    ada = variables["adaround"]
    layer_shapes = {name: tuple(shape) for name, shape in c["param_names"]}
    n_checked, pooled = 0, []
    for ref_path, v_flat in c["v_final"].items():
        layer = ref_path.split(".")[0]
        ours = _torch_order(ada[layer]["w_quantizer"]["V"], layer_shapes[f"{layer}.weight"])
        ref_v = np.asarray(v_flat, np.float64)
        assert ours.shape == ref_v.shape
        active = (np.abs(ref_v) < 2.2) & (np.abs(ours) < 2.2)
        assert active.mean() > 0.6, "most V elements must stay active"
        pooled.append(np.abs(ours[active] - ref_v[active]))
        ref_mask = np.asarray(c["round_masks"][ref_path], bool)
        decided = np.abs(ref_v) > 2e-2
        assert np.array_equal((ours >= 0.0)[decided], ref_mask[decided]), (
            f"{ref_path}: rounding decisions diverge on "
            f"{((ours >= 0.0)[decided] != ref_mask[decided]).sum()} elements")
        n_checked += decided.sum()
    assert n_checked > 1000
    diff = np.concatenate(pooled)
    assert (diff <= 5e-3).mean() >= 0.97 and diff.max() <= 0.05, (
        f"final V (active, pooled): {(diff > 5e-3).sum()}/{diff.size} beyond 5e-3, "
        f"max {diff.max():.4g}")

    _check_qparams(variables, c, skip_bits32_acts=True)
    with torch.no_grad():
        _check_logits(runner.model(_eval_x(c), mode="quant").numpy(), c, "quant")


def test_qat_trajectory_replays_through_the_port(tmp_path):
    c = _CASES["qat_traj_w8a8"]
    calib = _batches(c, c["calib_seeds"])
    traj = _batches(c, c["traj_seeds"])
    runner = _runner(QAT, tmp_path, c, "qat", calib,
                     extra_train={"calibrated_epoch": 1, "max_epoch": 1, "eval_freq": 0,
                                  "save_freq": 0})
    for i, batch in enumerate(calib):
        runner.train_step(_t(batch), 0, i, len(calib))
    runner.update(0)
    assert runner.initialized

    losses = []
    for i, batch in enumerate(traj):
        losses.append(runner.train_step(_t(batch), 1, i, len(traj))[0])
        if i == 0:
            # scale/zero after exactly one SGD step through the STE graph
            mine = _flat_qparams(convert.to_numpy(runner.model)["qparams"])
            for ref_path, rec in c["qparams_step1"].items():
                q = "/" + ref_path.replace(".", "/")
                for field in ("scale", "zero"):
                    np.testing.assert_allclose(mine[f"{q}/{field}"],
                                               np.asarray(rec[field], np.float64),
                                               rtol=2e-3, atol=1e-4,
                                               err_msg=f"{ref_path}.{field} after one QAT step")
    np.testing.assert_allclose(losses, c["losses"], rtol=2e-3, atol=2e-3,
                               err_msg="per-step QAT loss trajectory")

    want = _trajnet_params(_state_dict(c, source=c["final_state"]))
    got = convert.to_numpy(runner.model)["params"]
    diff = np.concatenate([np.abs(np.asarray(got[layer][leaf], np.float64)
                                  - np.asarray(want[layer][leaf], np.float64)).reshape(-1)
                           for layer in ("conv1", "conv2", "fc") for leaf in ("kernel", "bias")])
    assert (diff <= 5e-4).mean() >= 0.995 and diff.max() <= 5e-3, (
        f"final QAT params: {(diff > 5e-4).sum()}/{diff.size} beyond 5e-4, max {diff.max():.4g}")
    with torch.no_grad():
        _check_logits(runner.model(_eval_x(c), mode="fp32").numpy(), c, "fp32")
