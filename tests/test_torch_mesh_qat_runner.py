"""The QAT runner on a ``(data, model)`` mesh of gloo ranks on the CPU
(``tests/_torch_mesh.py``), held against the port's one device and the JAX
package's runner on the global batches (what its jitted step computes on
any mesh).

TestCNN (16 x 16, 10 classes) and ResNet-18 (32 x 32, 16 classes), BN
folded, W8 per-channel MinMax weights and the QAT configs' 8-bit activations
(``tests/_torch_train_parity.py``), 3 global batches of 4 with one padded
label, a calibration epoch (``calibrated_epoch`` 1), then an epoch of 3 SGD
steps at 1e-2, from JAX's initial variables; TestCNN at ``(2, 1)``,
``(1, 2)`` and ``(2, 2)``, ResNet-18 at ``(1, 2)``:

* against the port's one device: every step's loss within rtol 1e-5; the
  weights' training movement (the final ``params`` less the initial: the
  calibration epoch leaves them) and the final ``qparams`` by
  ``check_grad`` (99% of the elements within rtol 1e-4 plus atol 1e-6, the
  L2 difference within 1e-3 of the reference's, a qparams floor of 1e-3 of
  its largest entry); the observer state within rtol 1e-5 (the counts
  exact), as ``tests/test_torch_mesh_calibrate.py``;
* against JAX's runner (TestCNN): the same, beyond the port's own
  one-device gap where that already misses JAX (``tests/
  test_torch_mesh_qat.py``'s rule: the mesh's L2 difference within the
  one device's plus the criterion's bound; the losses within the one
  device's gap plus rtol 1e-5);
* the ranks of a ``data`` group hold bit-equal variables; every rank's
  gathered variables are the same; rank 0's last checkpoint, gathered
  whole, reloads on one device bit-equal to them;
* the collectives of each step: a calibration step one all-gather a
  quantizer reading rows split over ``data`` and one a split layer; a
  training step the valid count's and the gradients' all-reduces over
  ``data``, one all-gather and one input-gradient all-reduce a split layer.

Through ``execute_runner`` (the CLI's path: the synthetic config with
``configs/runners/qat/base.yaml``) at ``(2, 1)``: the one device's test
top-1 and count; and again with ``train.elastic`` (every rank under a
``ResumableRun``), which runs to its end with the same result, its state
file written once by rank 0 (``finished``) and one heartbeat a rank.
"""
import argparse
import json

import jax
import numpy as np
import pytest
import torch

from _torch_mesh import ArrayLoader, flat_tensors, run_jobs
from _torch_train_parity import A8, W8, check_grad, quant_cfg
from quantize_tpu.runners.qat import QAT as JaxQAT
from quantize_tpu.utils import Config as JaxConfig
from quantize_tpu_torch import convert
from quantize_tpu_torch.cli import setup_cfg
from quantize_tpu_torch.runners import build_runner, execute_runner
from quantize_tpu_torch.utils import Config, set_random_seed

torch.set_num_threads(2)

LR = 1e-3
PERTURBATIONS = 3
QUANT = quant_cfg("testcnn-bnfold", W8, A8)
# name: (registry name, classes, image size, split layers, JAX reference)
MODELS = {"testcnn": ("testcnn", 10, 16, 4, True), "resnet18": ("resnet18", 16, 32, 21, False)}
RUNS = [("testcnn", (2, 1)), ("testcnn", (1, 2)), ("testcnn", (2, 2)), ("resnet18", (1, 2))]
IDS = [f"{m}-{d}x{t}" for m, (d, t) in RUNS]
CLI_CFG = ["configs/runners/ptq/minmax/ptq_rn18_w8a8_synthetic.yaml",
           "configs/runners/qat/base.yaml"]
CLI_OPTS = ["model.name=testcnn", "train_loader.batch_size=16", "train.max_epoch=1",
            "train.print_freq=100", "train.eval_freq=0"]
ELASTIC_OPTS = CLI_OPTS + ["train.elastic.max_restarts=1", "train.elastic.monitor=true"]


def _name(model, mesh):
    return f"{model}{mesh[0]}x{mesh[1]}"


def _cfg(out, model):
    registry, classes, _, _, _ = MODELS[model]
    return {"seed": 0, "output_dir": str(out),
            "model": {"name": registry, "num_classes": classes},
            "runner": {"name": "qat"}, "quant": QUANT,
            "train": {"max_epoch": 1, "calibrated_epoch": 1, "print_freq": 1000,
                      "eval_freq": 0, "save_freq": 0},
            "optimizer": {"name": "sgd", "lr": LR}, "lr_scheduler": {"name": "constant"}}


def _batches(model):
    _, classes, size, _, _ = MODELS[model]
    rng = np.random.default_rng(11)
    out = []
    for i in range(3):
        label = rng.integers(0, classes, 4).astype(np.int32)
        if i == 1:
            label[2] = -1  # a padded row: the masked mean
        out.append({"img": rng.normal(size=(4, size, size, 3)).astype(np.float32),
                    "label": label})
    return out


def _flat(tree):
    return {f"{c}/{k}": np.asarray(a) for c in tree for k, a in convert.flatten(tree[c]).items()}


def _reference(tmp, model):
    """JAX's initial variables (written for the ranks, with the batches),
    and the runs from them: the port's one device and, for TestCNN, JAX's
    runner (flat variables and per-step losses)."""
    batches = _batches(model)
    np.savez(tmp / f"{model}.npz", img=np.stack([b["img"] for b in batches]),
             label=np.stack([b["label"] for b in batches]))
    jr = JaxQAT(JaxConfig(_cfg(tmp / f"jax_{model}", model)), ArrayLoader(batches))
    jr.init_variables(batches[0], seed=0)
    v0 = jax.device_get(dict(jr.variables))
    torch.save(flat_tensors(v0), tmp / f"{model}_v0.pt")
    out = {"v0": _flat(v0)}
    if MODELS[model][4]:
        losses, step = [], jr.train_step
        jr.train_step = lambda *a: losses.append(step(*a)[0]) or (losses[-1], 0.0, 0)
        jr.run()
        out["jax"] = (_flat(jax.device_get(jr.variables)), losses)
    out["one"] = _port_run(tmp / f"one_{model}", model, batches, v0)
    rng = np.random.default_rng(12)

    def moved(a):
        return (np.asarray(a) * (1 + 1e-6 * rng.normal(size=np.shape(a)))).astype(np.float32)

    out["noise"] = [_port_run(tmp / f"noise_{model}{i}", model,
                              [{**b, "img": moved(b["img"])} for b in batches],
                              {**v0, "params": jax.tree.map(moved, v0["params"])})
                    for i in range(PERTURBATIONS)]
    return out


def _port_run(out, model, batches, v0):
    """The port's one-device runner from ``v0``: its flat variables and
    per-step losses."""
    pr = build_runner(Config(_cfg(out, model)), ArrayLoader(batches), device="cpu")
    pr.variables = v0
    losses, step = [], pr.train_step
    pr.train_step = lambda *a: losses.append(step(*a)[0]) or (losses[-1], 0.0, 0)
    pr.run()
    return {k: t.numpy() for k, t in _port_flat(pr.model).items()}, losses


def _port_flat(model):
    from quantize_tpu_torch.nn.variables import collections

    return {f"{c}/{k}": t.detach() for c, f in collections(model).items() for k, t in f.items()}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_qat_runner")
    refs = {model: _reference(tmp, model) for model in MODELS}
    jobs = {2: [], 4: []}
    for model, mesh in RUNS:
        jobs[mesh[0] * mesh[1]].append({
            "name": _name(model, mesh), "mesh": list(mesh), "out": str(tmp / _name(model, mesh)),
            "train_runner": {"cfg": _cfg(tmp / f"out_{_name(model, mesh)}", model),
                             "batches": str(tmp / f"{model}.npz"),
                             "variables": str(tmp / f"{model}_v0.pt")}})
    for name, opts in (("cli", CLI_OPTS), ("elastic", ELASTIC_OPTS)):
        jobs[2].append({"name": name, "mesh": [2, 1], "out": str(tmp / name),
                        "runner": {"cfg": CLI_CFG, "output_dir": str(tmp / f"{name}_mesh"),
                                   "opts": opts}})
    return refs, {world: run_jobs(world, j, tmp) for world, j in jobs.items()}, tmp


def _ranks(cases, name, world):
    reports, saved = cases[1][world]
    return [r[name] for r in reports], [s[name] for s in saved]


def _l2(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64).ravel()
                                - np.asarray(b, np.float64).ravel()))


def _hold(rep, got, ref, tag):
    """A rank's run against ``ref``'s reference run (JAX's, or the port's
    one device): the calibration epoch's losses within rtol 1e-5 plus the
    one device's own gap to the reference; each training step's loss, each
    weight's training movement and each qparams leaf no further from the
    reference than the one device is, plus twice the largest of the one
    device's own movements under the perturbations, plus ``check_grad``'s L2
    bound (1e-3 of the reference's norm plus 1e-6 * sqrt(n)), each
    collection as one vector."""
    case = ref
    want, losses = case["ref"]
    one, one_losses = case["one"]
    v0 = case["v0"]
    n_cal = len(losses) // 2
    gap = np.abs(np.subtract(one_losses, losses))
    noise = np.max([np.abs(np.subtract(p, one_losses)) for _, p in case["noise"]], axis=0)
    bound = 1e-5 * np.abs(losses) + gap + np.where(np.arange(len(losses)) < n_cal, 0.0,
                                                   2 * noise)
    np.testing.assert_array_less(np.abs(np.subtract(rep["losses"], losses)), bound + 1e-30,
                                 err_msg=tag)
    mine = {k: t.numpy() for k, t in got["variables"].items()}
    for col in ("params", "qparams"):
        keys = sorted(k for k in want if k.startswith(col + "/"))
        # a weight's training movement; a quantizer's value

        def vec(flat):
            return np.concatenate([(np.asarray(flat[k], np.float64) - (
                v0[k] if col == "params" else 0.0)).ravel() for k in keys])

        w = vec(want)
        moves = [_l2(vec(p), vec(one)) for p, _ in case["noise"]]
        limit = (_l2(vec(one), w) + 2 * max(moves) + 1e-3 * np.linalg.norm(w)
                 + 1e-6 * np.sqrt(w.size))
        assert _l2(vec(mine), w) <= limit, (
            f"{tag}: {col} |mesh - ref| {_l2(vec(mine), w):.3e} beyond {limit:.3e} (one device "
            f"{_l2(vec(one), w):.3e}, its own movement {max(moves):.3e})")


@pytest.mark.parametrize("model,mesh", RUNS, ids=IDS)
def test_runner_matches_one_device(cases, model, mesh):
    reports, saved = _ranks(cases, _name(model, mesh), mesh[0] * mesh[1])
    ref = cases[0][model]
    for rank, (rep, got) in enumerate(zip(reports, saved)):
        assert set(got["variables"]) == set(ref["one"][0]), rank
        _hold(rep, got, {**ref, "ref": ref["one"]}, f"rank {rank} vs one device")
        for key, want in ref["one"][0].items():
            if key.startswith("qobs/"):
                np.testing.assert_allclose(got["variables"][key].numpy(), want, rtol=1e-5,
                                           atol=1e-7, err_msg=key)
        assert rep["top1"]["n"] == 12 - 1 and 0.0 <= rep["top1"]["top1"] <= 100.0


@pytest.mark.parametrize("model,mesh", [r for r in RUNS if MODELS[r[0]][4]],
                         ids=[i for i, r in zip(IDS, RUNS) if MODELS[r[0]][4]])
def test_runner_matches_jax(cases, model, mesh):
    reports, saved = _ranks(cases, _name(model, mesh), mesh[0] * mesh[1])
    ref = cases[0][model]
    for rank, (rep, got) in enumerate(zip(reports, saved)):
        _hold(rep, got, {**ref, "ref": ref["jax"]}, f"rank {rank} vs JAX")


@pytest.mark.parametrize("model,mesh", RUNS, ids=IDS)
def test_ranks_agree_and_the_checkpoint_reloads(cases, model, mesh):
    _, saved = _ranks(cases, _name(model, mesh), mesh[0] * mesh[1])
    tp = mesh[1]
    for rank, got in enumerate(saved):
        peer = saved[rank % tp]["own"]  # data row 0, this model index
        assert got["own"].keys() == peer.keys()
        for key, t in got["own"].items():
            assert torch.equal(t, peer[key]), (rank, key)
        for key, t in got["variables"].items():
            assert torch.equal(t, saved[0]["variables"][key]), (rank, key)
    fresh = build_runner(Config(_cfg(cases[2] / "reload", model)), device="cpu")
    fresh.load_checkpoint(str(cases[2] / f"out_{_name(model, mesh)}" / "ckpt_last.pkl"))
    back = _port_flat(fresh.model)
    assert set(back) == set(saved[0]["variables"])
    for key, t in saved[0]["variables"].items():
        assert torch.equal(back[key], t), key


@pytest.mark.parametrize("model,mesh", RUNS, ids=IDS)
def test_step_collectives(cases, model, mesh):
    reports, _ = _ranks(cases, _name(model, mesh), mesh[0] * mesh[1])
    dp, tp = mesh
    split = MODELS[model][3] if tp > 1 else 0
    # a calibration step: each activation quantizer reads rows split over
    # data (TestCNN's four; ResNet-18 quantizes 21 layer inputs), each split
    # layer gathers its output
    quantizers = {"testcnn": 4, "resnet18": 21}[model]
    calib = {"all-gather": quantizers * (dp > 1) + split} if dp > 1 or split else {}
    if dp > 1:  # the masked loss's sum and count over data
        calib["all-reduce"] = 1
    # a training step: the valid count and the gradients over data; a split
    # layer's gather and its input gradient's reduce over model
    train = {"all-gather": split, "all-reduce": split} if split else {}
    if dp > 1:
        train["all-reduce"] = train.get("all-reduce", 0) + 2
    for rep in reports:
        assert rep["steps"] == [calib] * 3 + [train] * 3


def _one_device_cli(tmp, opts):
    cfg = setup_cfg(argparse.Namespace(cfg=CLI_CFG, output_dir=str(tmp), opts=opts))
    set_random_seed(cfg.seed)
    return execute_runner(cfg, device="cpu")


def test_execute_runner_on_a_data_parallel_mesh(cases, tmp_path):
    want = _one_device_cli(tmp_path, CLI_OPTS)
    reports, _ = _ranks(cases, "cli", 2)
    for rep in reports:
        assert rep["runner"] == want
        assert "ckpt_last.pkl" in rep["files"]


def test_elastic_run_on_a_data_parallel_mesh(cases):
    """``train.elastic`` gives every rank a ``ResumableRun``: the run ends
    with the plain run's result, rank 0 alone writes the state file (its
    last write marks the run finished), and each rank beats its own
    heartbeat."""
    reports, _ = _ranks(cases, "elastic", 2)
    plain, _ = _ranks(cases, "cli", 2)
    for rep, want in zip(reports, plain):
        assert rep["runner"] == want["runner"]
        assert {"resume_state.json", "ckpt_resume.pkl", "p0.heartbeat", "p1.heartbeat"} <= set(
            rep["files"])
        assert not any(f.endswith(".tmp") for f in rep["files"])
    state = json.loads((cases[2] / "elastic_mesh" / "resume_state.json").read_text())
    assert state["finished"] and state["epoch"] == 1
