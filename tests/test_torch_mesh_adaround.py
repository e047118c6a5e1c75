"""AdaRound on a ``(data, model)`` mesh of gloo ranks on the CPU
(``tests/_torch_mesh.py``), held against the port's one device and the JAX
package on the global batch (what JAX's jitted steps compute on any mesh).

The primitives and the joint step: TestCNN (16 x 16, BN folded, 10 classes)
W4 per-channel MinMax weights with ``adaround.apply`` and the QAT configs'
8-bit activations (``tests/_torch_train_parity.py``, as
``tests/test_torch_adaround_step.py``), a global batch of 4, JAX's
calibrated variables with JAX's initial V moved by seeded noise, β from the
schedule's decay; at ``(2, 1)``, ``(1, 2)`` and ``(2, 2)``:

* ``init_adaround`` on each rank's rows: each rank's own V bit-equal to its
  slice of the port's one-device V from the same variables (the V gathered
  whole equal to it), and within rtol 1e-6 plus 2^-24 of eager JAX's V (V =
  -log(1.2 / (frac + 0.1) - 1) crosses 0; the log is XLA's own);
* each V's regularization on a slice, divided by the whole V's element
  count: its value summed over ``model`` within rtol 1e-5 of the port's
  one-device ``regularization`` of the whole V and of JAX's (a float32 sum
  of 4,608 terms in another order: up to 1.3e-6 apart; a V held whole gives
  the one device's value exactly); its gradient
  gathered whole bit-equal to the port's one device (elementwise), and
  within rtol 1e-5 (atol 1e-12, the gradient's float32 floor) of JAX's
  ``jax.grad``: the port's one device already sits up to 2.7e-6 relative
  from it on a few elements (float32 ``pow`` and ``sigmoid`` in another
  library);
* one joint step (the calibrate pass, then the reconstruction loss): the
  loss within rtol 1e-5 of the port's one device and of eager JAX (JAX's
  loss function without ``jit``: under ``jit`` XLA moves AdaRound's knife
  edges, ROADMAP §3, PR 17), every V gradient gathered whole by
  ``check_grad`` against both; the ranks of a ``data`` group bit-equal; the
  step's collectives exactly the tap counts' and the recon gradients'
  all-reduces over ``data``, and on a model-sharded mesh one gather a split
  layer, one input-gradient reduce a split layer after the first and the
  regularization value's reduce over ``model``.

The runner: TestCNN with the AdaRound base config's quant section (W4
per-channel MinMax weights, 32-bit activations; ``tests/
test_torch_adaround_runner.py``), Adam 1e-3, β dynamic, 3 global batches of
4, ``max_epoch`` 2, from JAX's initial variables: blockwise at ``(2, 1)``,
``(1, 2)`` and ``(2, 2)``, sequential at ``(1, 2)`` and ``(2, 2)``, joint at
``(2, 1)`` and ``(1, 2)``. Against the port's one device on the same global
batches: the layer order, ``layer_losses`` within rtol 1e-4 plus 1e-6 (6
Adam steps a layer from gradients that differ by float32 reassociation),
the rounding
decisions (``floor(w / s - z) + [h(V) >= 0.5]``) exact wherever the one
device's |V| > 2e-2 (``tests/test_torch_adaround_runner.py``'s criterion),
qparams within rtol 1e-5 (against JAX's runner run eagerly: ``tests/
test_torch_mesh_adaround_jax.py``). The ranks of a ``data``
group hold bit-equal variables, every rank the same order and
``layer_losses``; a sequential input pass runs, on every rank, exactly the
collectives of the split layers before the layer it stops at. The
``(1, 2)`` blockwise run also goes through ``execute_runner`` (the CLI's
path) to a test top-1; the reconstructed model's deploy variables on
``(1, 2)`` run every layer whole (weight-only convs pack for a float conv)
and serve bit-equal to one device.

``test_split_step_gradient_is_the_slice_of_one_device`` fails on the
parent: ``reconstruction_loss`` took no mesh, ``init_adaround`` raised on a
slice, and a slice's regularization divided by the slice's count.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh import ArrayLoader, flat_tensors, run_jobs
from _torch_train_parity import A8, ADA, W4, check_grad, quant_cfg, setup
from quantize_tpu.quant.adaround import regularization as jax_regularization
from quantize_tpu.runners.adaround import AdaRound as JaxAdaRound
from quantize_tpu.utils import Config as JaxConfig
import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert
from quantize_tpu_torch.quant.adaround import beta_schedule, rect_sigmoid, regularization
from quantize_tpu_torch.runners import build_runner
from quantize_tpu_torch.runners.adaround import calibrate_taps, reconstruction_loss
from quantize_tpu_torch.utils import Config

torch.set_num_threads(2)

MESHES = [(2, 1), (1, 2), (2, 2)]
LAYERS = ["conv1", "conv2", "fc1", "fc2"]
# the layers that run on a slice: W4 dense layers pack as split-half int4
# (K4's ``w_p4``) and stay whole on the mesh
SPLIT = ["conv1", "conv2"]
BETA = beta_schedule(5, 10)
STEP_CFG = quant_cfg("testcnn-bnfold", {**W4, **ADA}, A8)
RUNNER_QUANT = {"default": {
    "weight": {"n_bits": 4, "symmetric": True, "signed": True, "granularity": "channel",
               "range": {"name": "minmax", "percentile": 0.0}, "adaround": {"apply": True}},
    "activation": {"n_bits": 32, "range": {"name": "minmax"}},
    "bn_folding": True}}
RUNS = [("blockwise", (2, 1)), ("blockwise", (1, 2)), ("blockwise", (2, 2)),
        ("sequential", (1, 2)), ("sequential", (2, 2)), ("joint", (2, 1)), ("joint", (1, 2))]
CLI_CFG = ["configs/runners/ptq/minmax/ptq_rn18_w8a8_synthetic.yaml",
           "configs/runners/adaround/base.yaml"]
CLI_OPTS = ["model.name=testcnn", "train_loader.batch_size=16", "train.max_epoch=1",
            "train.print_freq=100"]


def _name(*parts):
    return "_".join(f"{p[0]}x{p[1]}" if isinstance(p, tuple) else str(p) for p in parts)


def _flat(tree):
    return {f"{c}/{k}": np.asarray(a) for c in tree for k, a in convert.flatten(tree[c]).items()}


def _eager_joint_step(jm, variables, x, beta):
    """``quantize_tpu/runners/adaround.py``'s joint step, eagerly: the loss
    and the V gradients."""
    img = jnp.asarray(x)
    _, upd = jm.apply(variables, img, mode="calibrate", mutable=["qobs", "qparams", "taps"])
    fp_taps = jax.lax.stop_gradient(upd.pop("taps"))
    variables = {**variables, "qobs": upd["qobs"], "qparams": upd["qparams"]}

    def loss_fn(ada):
        _, upd2 = jm.apply({**variables, "adaround": ada}, img, mode="quant", mutable=["taps"])
        terms = jax.tree.map(lambda q, o: jnp.mean((q - o) ** 2), upd2["taps"], fp_taps)
        return sum(jax.tree.leaves(terms)) + sum(jax_regularization(v, beta)
                                                 for v in jax.tree.leaves(ada))

    loss, grads = jax.value_and_grad(loss_fn)(variables["adaround"])
    return float(loss), {f"adaround/{k}": np.asarray(a)
                         for k, a in convert.flatten(jax.device_get(grads)).items()}


def _step_refs(tmp):
    """JAX's and the port's one-device side of the primitives and the joint
    step; writes the moved variables and the batch for the ranks."""
    jm, tm, v, x, _ = setup("testcnn-bnfold", STEP_CFG)
    _, upd = jm.apply(v, jnp.asarray(x), mode="init_adaround", mutable=["adaround"])
    rng = np.random.default_rng(7)
    moved = {**v, "adaround": jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.5, a.shape)).astype(np.float32),
        jax.device_get(upd["adaround"]))}
    torch.save(flat_tensors(moved), tmp / "moved.pt")
    np.save(tmp / "x.npy", x)
    # JAX: V from the moved variables' kernel and qparams, each V's
    # regularization and its gradient, the eager joint step
    _, upd = jm.apply(moved, jnp.asarray(x), mode="init_adaround", mutable=["adaround"])
    jax_v = {f"adaround/{k}": np.asarray(a)
             for k, a in convert.flatten(jax.device_get(upd["adaround"])).items()}
    reg = {}
    for key, a in _flat({"adaround": moved["adaround"]}).items():
        value, grad = jax.value_and_grad(lambda t: jax_regularization(t, BETA))(jnp.asarray(a))
        reg[key] = (float(value), np.asarray(grad))
    jax_step = _eager_joint_step(jm, moved, x, BETA)
    # the port's one device on the global batch
    convert.from_jax_variables(tm, moved)
    with torch.no_grad():
        tm(torch.from_numpy(x), mode="init_adaround")
    one_v = {k: t.detach().clone() for k, t in _trainable_v(tm).items()}
    convert.from_jax_variables(tm, moved)
    one_reg = {}
    for key, t in _trainable_v(tm).items():
        t.requires_grad_(True)
        value = regularization(t, BETA)
        one_reg[key] = (float(value.detach()), torch.autograd.grad(value, [t])[0].numpy())
    xt = torch.from_numpy(x)
    loss, _, grads = reconstruction_loss(tm, xt, calibrate_taps(tm, xt), BETA)
    return {"jax_v": jax_v, "reg": reg, "one_reg": one_reg, "jax_step": jax_step, "one_v": one_v,
            "one_step": (float(loss), {k: g.numpy() for k, g in grads.items()})}


def _trainable_v(model):
    from quantize_tpu_torch.nn.variables import trainable

    return trainable(model, ("adaround",))


def _batches():
    rng = np.random.default_rng(3)
    return [{"img": rng.normal(size=(4, 16, 16, 3)).astype(np.float32),
             "label": rng.integers(0, 10, 4).astype(np.int32)} for _ in range(3)]


def _runner_cfg(out, mode):
    return {"seed": 0, "output_dir": str(out), "model": {"name": "testcnn", "num_classes": 10},
            "runner": {"name": "adaround", "reconstruction": mode, "beta": "dynamic"},
            "quant": RUNNER_QUANT, "train": {"max_epoch": 2, "print_freq": 1000},
            "optimizer": {"name": "adam", "lr": 1e-3}, "lr_scheduler": {"name": "constant"}}


def initial_variables(tmp):
    """JAX's AdaRound runner's initial variables (its init pass on the first
    batch), written with the batches for the ranks."""
    batches = _batches()
    np.savez(tmp / "batches.npz", img=np.stack([b["img"] for b in batches]),
             label=np.stack([b["label"] for b in batches]))
    jr = JaxAdaRound(JaxConfig(_runner_cfg(tmp / "jax_init", "blockwise")), ArrayLoader(batches))
    jr.init_variables(batches[0], seed=0)
    v0 = jax.device_get(dict(jr.variables))
    torch.save(flat_tensors(v0), tmp / "v0.pt")
    return batches, v0


def runner_job(tmp, mode, mesh):
    return {"name": _name(mode, mesh), "mesh": list(mesh), "out": str(tmp / _name(mode, mesh)),
            "train_runner": {"cfg": _runner_cfg(tmp / _name("out", mode, mesh), mode),
                             "batches": str(tmp / "batches.npz"),
                             "variables": str(tmp / "v0.pt")}}


def _runner_refs(tmp):
    """By mode: the port's one-device runner from JAX's initial variables."""
    batches, v0 = initial_variables(tmp)
    refs = {}
    for mode in sorted({m for m, _ in RUNS}):
        pr = build_runner(Config(_runner_cfg(tmp / f"one_{mode}", mode)), ArrayLoader(batches),
                          device="cpu")
        pr.variables = v0
        pr.run()
        refs[mode] = {"one": {k: t.numpy() for k, t in _flat_port(pr.model).items()},
                      "one_losses": dict(pr.layer_losses)}
        if mode == "blockwise":
            # the reconstructed model packed, for the ranks to serve
            x = torch.from_numpy(batches[0]["img"])
            torch.save(qtt.pack_model(pr.model, x, device="cpu"), tmp / "deploy.pt")
            with torch.no_grad():
                refs["packed"] = pr.model(x, mode="packed")
    return refs


def _flat_port(model):
    from quantize_tpu_torch.nn.variables import collections

    return {f"{c}/{k}": t.detach() for c, f in collections(model).items() for k, t in f.items()}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_adaround")
    step, runs = _step_refs(tmp), _runner_refs(tmp)
    base = {"build": {"name": "testcnn", "kw": {"num_classes": 10}}}
    jobs = {2: [], 4: []}
    for mesh in MESHES:
        jobs[mesh[0] * mesh[1]].append({
            **base, "name": _name("ada", mesh), "mesh": list(mesh), "cfg": STEP_CFG,
            "variables": str(tmp / "moved.pt"), "x": str(tmp / "x.npy"), "ada": BETA,
            "out": str(tmp / _name("ada", mesh))})
    for mode, mesh in RUNS:
        jobs[mesh[0] * mesh[1]].append(runner_job(tmp, mode, mesh))
    np.save(tmp / "x0.npy", _batches()[0]["img"])
    jobs[2].append({**base, "name": "packed1x2", "mesh": [1, 2], "cfg": RUNNER_QUANT,
                    "variables": str(tmp / "deploy.pt"), "x": str(tmp / "x0.npy"),
                    "forward": ["packed"], "out": str(tmp / "packed1x2")})
    jobs[2].append({"name": "cli1x2", "mesh": [1, 2], "out": str(tmp / "cli1x2"),
                    "runner": {"cfg": CLI_CFG, "output_dir": str(tmp / "cli_mesh"),
                               "opts": CLI_OPTS}})
    ranks = {world: run_jobs(world, j, tmp) for world, j in jobs.items()}
    return step, runs, ranks, tmp


def _ranks(cases, name, mesh):
    reports, saved = cases[2][mesh[0] * mesh[1]]
    return [r[name] for r in reports], [s[name] for s in saved]


def _slice(a, mesh, rank, key):
    """This rank's part of a whole V ``a`` (of the layer named in ``key``):
    its slice of the out channels on a split layer, else all of it."""
    tp = mesh[1]
    if tp == 1 or key.split("/")[1] not in SPLIT:
        return a
    n = a.shape[-1] // tp
    j = rank % tp
    return a[..., j * n:(j + 1) * n]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_init_adaround_writes_the_slice_of_one_device(cases, mesh):
    reports, saved = _ranks(cases, _name("ada", mesh), mesh)
    one, jax_v = cases[0]["one_v"], cases[0]["jax_v"]
    assert set(one) == set(jax_v) == {f"adaround/{layer}/w_quantizer/V" for layer in LAYERS}
    for rank, got in enumerate(saved):
        assert reports[rank]["split"] == (SPLIT if mesh[1] > 1 else [])
        for key, want in one.items():
            np.testing.assert_array_equal(got["init_v"][key].numpy(), want.numpy(), err_msg=key)
            np.testing.assert_array_equal(got["init_own"][key].numpy(),
                                          _slice(want.numpy(), mesh, rank, key), err_msg=key)
            np.testing.assert_allclose(got["init_v"][key].numpy(), jax_v[key], rtol=1e-6,
                                       atol=2.0 ** -24, err_msg=key)
        # the pass gathers each split layer's output, and reduces nothing
        assert reports[rank]["init"] == ({"all-gather": len(SPLIT)} if mesh[1] > 1 else {})


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_regularization_of_a_slice_is_the_whole_vs(cases, mesh):
    reports, saved = _ranks(cases, _name("ada", mesh), mesh)
    for rank, got in enumerate(saved):
        for key, (value, grad) in cases[0]["reg"].items():
            one_value, one_grad = cases[0]["one_reg"][key]
            mine = reports[rank]["reg"][key]
            if mesh[1] == 1 or key.split("/")[1] not in SPLIT:
                assert mine == one_value, key
            np.testing.assert_allclose(mine, one_value, rtol=1e-5, err_msg=key)
            np.testing.assert_allclose(mine, value, rtol=1e-5, err_msg=key)
            np.testing.assert_array_equal(got["reg_grads"][key].numpy(), one_grad, err_msg=key)
            np.testing.assert_allclose(got["reg_grads"][key].numpy(), grad, rtol=1e-5,
                                       atol=1e-12, err_msg=key)


def _hold_step(got, loss, grads, tag):
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-5, err_msg=tag)
    assert set(got["grads"]) == set(grads), tag
    for key, want in grads.items():
        try:
            check_grad(got["grads"][key].numpy(), want, key)
        except AssertionError as exc:
            raise AssertionError(f"{tag}: {exc}") from None


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_joint_step_matches_one_device_and_jax(cases, mesh):
    _, saved = _ranks(cases, _name("ada", mesh), mesh)
    for rank, got in enumerate(saved):
        _hold_step(got, *cases[0]["one_step"], f"rank {rank} vs one device")
        _hold_step(got, *cases[0]["jax_step"], f"rank {rank} vs eager JAX")
        first = rank % mesh[1]  # the rank of this model index in data row 0
        for key, g in got["own_grads"].items():
            assert torch.equal(g, saved[first]["own_grads"][key]), (rank, key)
        assert float(got["loss"]) == float(saved[0]["loss"])


def test_split_step_gradient_is_the_slice_of_one_device(cases):
    """At ``(1, 2)`` each rank's V gradient is its slice of one device's
    (``check_grad``; a slice's float conv sums in another order), and no
    collective sums it: the regularization of the slice divides by the
    whole V's count. Fails on the parent (``reconstruction_loss`` took no
    mesh, ``init_adaround`` raised on the slice)."""
    mesh = (1, 2)
    _, saved = _ranks(cases, _name("ada", mesh), mesh)
    _, one = cases[0]["one_step"]
    for rank, got in enumerate(saved):
        for key, want in one.items():
            own = got["own_grads"][key].numpy()
            part = _slice(want, mesh, rank, key)
            assert own.shape == part.shape, key
            check_grad(own, part, key)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_joint_step_collectives(cases, mesh):
    reports, _ = _ranks(cases, _name("ada", mesh), mesh)
    dp, tp = mesh
    want = {}
    if tp > 1:
        # a gather a split layer forward; the input-gradient reduce of every
        # split layer but the first (its input is the image); the
        # regularization value of the slices summed over model
        want = {"all-gather": len(SPLIT), "all-reduce": len(SPLIT) - 1 + 1}
    if dp > 1:  # the taps' element counts, then the recon gradients and value
        want["all-reduce"] = want.get("all-reduce", 0) + 2
    for rep in reports:
        assert rep["ada_step"] == want


def split_before(tp):
    """``{layer: the split layers called before it}`` on a mesh of ``tp``
    model ranks."""
    return {layer: sum(s in SPLIT for s in LAYERS[:i]) if tp > 1 else 0
            for i, layer in enumerate(LAYERS)}


def _decisions(flat, layer):
    v = flat[f"adaround/{layer}/w_quantizer/V"]
    w_over = (flat[f"params/{layer}/kernel"] / flat[f"qparams/{layer}/w_quantizer/scale"]
              - flat[f"qparams/{layer}/w_quantizer/zero"])
    h = rect_sigmoid(torch.tensor(v)).numpy()
    return v.reshape(-1), (np.floor(w_over) + (h >= 0.5)).reshape(-1)


def _hold_decisions(got, want, tag):
    n = 0
    for layer in LAYERS:
        _, q_t = _decisions(got, layer)
        v_w, q_w = _decisions(want, layer)
        decided = np.abs(v_w) > 2e-2
        assert np.array_equal(q_t[decided], q_w[decided]), (
            f"{tag} {layer}: {(q_t[decided] != q_w[decided]).sum()} rounding decisions diverge")
        n += decided.sum()
    assert n > 1000, tag


RUN_IDS = [f"{mode}-{m[0]}x{m[1]}" for mode, m in RUNS]


def hold_run(reports, saved, flat_ref, losses_ref, tag):
    """Each rank's gathered variables and layer losses against a reference
    run's: the decisions, the layer order, and the losses within rtol 1e-4
    (plus 1e-6 for a reference logged to six decimals); every rank's layer
    losses the same floats."""
    for rank, got in enumerate(saved):
        flat = {k: t.numpy() for k, t in got["variables"].items()}
        _hold_decisions(flat, flat_ref, f"rank {rank} vs {tag}")
        if losses_ref is None:
            continue
        losses = reports[rank]["layer_losses"]
        assert list(losses) == list(losses_ref) == LAYERS, (rank, tag)
        for layer, loss in losses.items():
            np.testing.assert_allclose(loss, losses_ref[layer], rtol=1e-4, atol=1e-6,
                                       err_msg=f"rank {rank} vs {tag}: {layer}")
        assert losses == reports[0]["layer_losses"], rank


@pytest.mark.parametrize("mode,mesh", RUNS, ids=RUN_IDS)
def test_runner_matches_one_device(cases, mode, mesh):
    reports, saved = _ranks(cases, _name(mode, mesh), mesh)
    ref = cases[1][mode]
    hold_run(reports, saved, ref["one"], None if mode == "joint" else ref["one_losses"],
             "one device")
    for rank, got in enumerate(saved):
        flat = {k: t.numpy() for k, t in got["variables"].items()}
        assert set(flat) == set(ref["one"]), rank
        for key, want in ref["one"].items():
            if key.startswith("qparams/"):
                np.testing.assert_allclose(flat[key], want, rtol=1e-5, atol=1e-7, err_msg=key)
        assert 0.0 <= reports[rank]["top1"]["top1"] <= 100.0
        assert reports[rank]["top1"]["n"] == 12


@pytest.mark.parametrize("mode,mesh", RUNS, ids=RUN_IDS)
def test_runner_ranks_agree(cases, mode, mesh):
    """The ranks of a ``data`` group hold bit-equal variables; the ranks of
    a ``model`` group the same replicated leaves."""
    _, saved = _ranks(cases, _name(mode, mesh), mesh)
    tp = mesh[1]
    for rank, got in enumerate(saved):
        peer = saved[rank % tp]["own"]  # data row 0, this model index
        assert got["own"].keys() == peer.keys()
        for key, t in got["own"].items():
            assert torch.equal(t, peer[key]), (rank, key)
        for key, t in got["variables"].items():
            assert torch.equal(t, saved[0]["variables"][key]), (rank, key)


@pytest.mark.parametrize("mode,mesh", [r for r in RUNS if r[0] != "joint"],
                         ids=[i for i in RUN_IDS if not i.startswith("joint")])
def test_runner_collectives(cases, mode, mesh):
    """A sequential input pass stops before the layer it records, on every
    rank: it runs the gathers of the split layers before that one and
    nothing else, so no rank waits in a gather the others never reach."""
    reports, _ = _ranks(cases, _name(mode, mesh), mesh)
    dp, tp = mesh
    for rep in reports:
        assert rep["stops"] == reports[0]["stops"]
        if mode == "sequential":
            # three batches an input pass, each through the layers before
            want = [[layer, {"all-gather": n} if n else {}]
                    for layer, n in split_before(tp).items() for _ in range(3)]
            assert rep["stops"] == want
        else:
            assert rep["stops"] == []


def test_weight_only_deploy_runs_whole_on_a_model_sharded_mesh(cases):
    """The reconstructed W4 weight-only model's deploy variables on ``(1,
    2)``: its convs pack for the float weight-only conv (and its dense
    layers as split-half int4), so every layer runs whole, its leaves
    gathered at load, and the packed logits equal one device's bit for bit
    (on the card a float conv over half the out channels sums in another
    order)."""
    reports, saved = _ranks(cases, "packed1x2", (1, 2))
    for rank, got in enumerate(saved):
        assert reports[rank]["split"] == []
        assert reports[rank]["load"]["all-gather"] > 0
        assert torch.equal(got["packed"], cases[1]["packed"].float()), rank


def test_execute_runner_on_a_model_sharded_mesh(cases, tmp_path):
    """The CLI's path (``execute_runner`` over the AdaRound base config on
    synthetic data) at ``(1, 2)``: the one device's test top-1 and count,
    and rank 0's checkpoint holds V whole."""
    import argparse

    from quantize_tpu_torch.cli import setup_cfg
    from quantize_tpu_torch.runners import execute_runner
    from quantize_tpu_torch.utils import set_random_seed

    reports, _ = _ranks(cases, "cli1x2", (1, 2))
    cfg = setup_cfg(argparse.Namespace(cfg=CLI_CFG, output_dir=str(tmp_path), opts=CLI_OPTS))
    set_random_seed(cfg.seed)
    want = execute_runner(cfg, device="cpu")
    for rep in reports:
        assert rep["runner"] == want
        assert "ckpt_last.pkl" in rep["files"]
    payload = torch.load(cases[3] / "cli_mesh" / "ckpt_last.pkl", weights_only=True)
    ada = convert.flatten(payload["variables"]["adaround"])
    kernel = convert.flatten(payload["variables"]["params"])
    for key, v in ada.items():
        assert v.shape == kernel[key.replace("w_quantizer/V", "kernel")].shape, key
