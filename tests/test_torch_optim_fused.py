"""The optimizer's fused Adam route (kernel KA: ``quantize_tpu_torch/ops/
adam.py``, ``csrc/adam_update.cu``) against the chain leaf by leaf that it
replaces, as ``Optimizer.step`` ran it before the route existed
(:func:`per_leaf`).

On the CPU the route runs the kernel's plain version: p, mu and nu equal
bit for bit (``torch.equal``) over 20 steps for ``adam``, ``adamw`` and the
QAT runner's ``Partition`` with ``qparams_lr_scale`` 0.1, under every
schedule, on a tree shaped like the QAT cell's (0-d and 1-element leaves,
leaves past one block's 4,096 elements, leaves without a gradient), and on
more leaves than one launch takes. ``route_leaves`` counts each leaf on its
route: SGD and RMSprop leaf by leaf, a float64 or non-contiguous leaf leaf
by leaf beside the fused rest. The tests marked ``cuda`` hold the kernel to
the same on the card, with its launches, a leaf not 16-byte aligned, and
one QAT step of ViT-B/16 (run there with ``--noconftest``: this file
imports no JAX).
"""
import copy
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_optim_cases import SCHEDULES
from quantize_tpu_torch import optim as topt
from quantize_tpu_torch.ops import adam as kadam

torch.set_num_threads(2)

STEPS, PER_EPOCH = 20, 3
OPTIMIZERS = {
    "adam": {"name": "adam", "lr": 1e-2},
    "adamw": {"name": "adamw", "lr": 1e-2, "weight_decay": 1e-2},
    "adam-qparams-0.1": {"name": "adam", "lr": 1e-2},
}
CSRC = Path(__file__).resolve().parent.parent / "quantize_tpu_torch" / "csrc"


def _cfg(opt, sched):
    return SimpleNamespace(optimizer=SimpleNamespace(**opt),
                           lr_scheduler=SimpleNamespace(name=sched, **SCHEDULES[sched]),
                           train=SimpleNamespace(max_epoch=6))


def _tx(name, sched):
    """The transform as the registry (and, for the split, the QAT runner)
    builds it."""
    cfg = _cfg(OPTIMIZERS[name], sched)
    if name != "adam-qparams-0.1":
        return topt.build_optimizer(cfg, PER_EPOCH)
    return topt.Partition({"main": topt.build_optimizer(cfg, PER_EPOCH),
                           "qparams": topt.Chain(topt.build_optimizer(cfg, PER_EPOCH),
                                                 topt.Scale(0.1))},
                          lambda key: "qparams" if key.startswith("qparams/") else "main")


# key: (shape, gradient scale; 0 = no gradient on every third step, None = never)
CELL_TREE = {
    "params/class_token": ((), 1.0),
    "params/head/bias": ((1,), 1.0),
    "params/encoder_layer_0/mlp_0/kernel": ((96, 97), 1.0),  # past one block's span, ragged
    "params/encoder_layer_0/ln/scale": ((4096 * 2 + 3,), 0.5),
    "params/encoder_layer_0/unused": ((300,), None),
    "qparams/encoder_layer_0/a_quantizer/scale": ((), 0.01),
    "qparams/encoder_layer_0/w_quantizer/scale": ((64,), 0.1),
    "qparams/encoder_layer_0/w_quantizer/zero": ((64,), 0),
}


def _tree(spec, device="cpu", seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(np.asarray(rng.normal(0, 1, shape), np.float32)).to(device)
            for k, (shape, _) in spec.items()}


def _grads(spec, params, step):
    rng = np.random.default_rng(1000 + step)
    out = {}
    for k, (shape, scale) in spec.items():
        if scale is None or (scale == 0 and step % 3 == 0):
            out[k] = None
            continue
        g = np.asarray(rng.normal(0, 1, shape) * (scale or 1.0), np.float32)
        out[k] = torch.from_numpy(g).to(params[k].device) + 0.5 * params[k]
    return out


def per_leaf(tx, state, params, grads):
    """``Optimizer.step`` before the fused route: the chain over every leaf
    (a missing gradient as zeros), then ``p += u``."""
    grads = {k: torch.zeros_like(p) if grads.get(k) is None else grads[k]
             for k, p in params.items()}
    updates, state = tx.update(grads, state, params)
    for k, p in params.items():
        p.add_(updates[k])
    return state


def _walk(state):
    """A state's moments, as ``(mu, nu)`` dict pairs, and its counts, in
    order."""
    if isinstance(state, dict) and "mu" in state:
        return [(state["mu"], state["nu"]), state["count"]]
    if isinstance(state, (dict, list, tuple)):
        return [x for s in (state.values() if isinstance(state, dict) else state)
                for x in _walk(s)]
    return [state]


def _run(name, sched, spec, device="cpu", steps=STEPS, tree=None):
    """``steps`` steps through ``Optimizer`` and through :func:`per_leaf`
    from the same leaves and gradients; returns both sides."""
    tree = tree or (lambda: _tree(spec, device))
    got, want = tree(), tree()
    opt = topt.Optimizer(_tx(name, sched), got)
    ref_tx = _tx(name, sched)
    ref_state = ref_tx.init(want)
    for step in range(steps):
        grads = _grads(spec, got, step)
        opt.step(got, grads)
        ref_state = per_leaf(ref_tx, ref_state, want, grads)
    return opt, got, want, ref_state


def _assert_same(opt, got, want, ref_state):
    for k in want:
        assert torch.equal(got[k], want[k]), k
    walk_got, walk_want = _walk(opt.state), _walk(ref_state)
    assert len(walk_got) == len(walk_want)
    assert any(isinstance(x, tuple) for x in walk_want)
    for x, y in zip(walk_got, walk_want):
        if not isinstance(y, tuple):
            assert x == y  # a count, as the chain moves it
            continue
        assert set(x[0]) == set(y[0])
        for k in y[0]:
            assert torch.equal(x[0][k], y[0][k]) and torch.equal(x[1][k], y[1][k]), k


@pytest.mark.parametrize("sched", list(SCHEDULES))
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_fused_route_is_bit_equal_to_the_chain_leaf_by_leaf(name, sched):
    opt, got, want, ref_state = _run(name, sched, CELL_TREE)
    _assert_same(opt, got, want, ref_state)
    assert opt.route_leaves == {"fused": STEPS * len(CELL_TREE), "per_leaf": 0}
    start = _tree(CELL_TREE)
    assert all(not torch.equal(got[k], start[k])
               for k, (_, scale) in CELL_TREE.items() if scale is not None)


def test_more_leaves_than_one_launch_takes():
    spec = {f"params/l{i}/w": ((i % 7 + 1,), 1.0) for i in range(kadam.ADAM_CHUNK + 60)}
    opt, got, want, ref_state = _run("adamw", "cosine", spec, steps=4)
    _assert_same(opt, got, want, ref_state)
    assert opt.route_leaves == {"fused": 4 * len(spec), "per_leaf": 0}


def test_chunk_mirrors_the_kernel_source():
    src = (CSRC / "adam_update.cu").read_text()
    assert int(re.search(r"MAX_LEAVES = (\d+);", src).group(1)) == kadam.ADAM_CHUNK
    assert "extern \"C\" int qtt_adam_update(" in src


@pytest.mark.parametrize("cfg", [
    {"name": "sgd", "lr": 0.05, "momentum": 0.9, "weight_decay": 1e-3},
    {"name": "rmsprop", "lr": 1e-2, "momentum": 0.9},
])
def test_sgd_and_rmsprop_stay_leaf_by_leaf(cfg):
    params = _tree(CELL_TREE)
    tx = topt.build_optimizer(_cfg(cfg, "constant"), PER_EPOCH)
    opt = topt.Optimizer(tx, params)
    for step in range(3):
        opt.step(params, _grads(CELL_TREE, params, step))
    assert opt.route_leaves == {"fused": 0, "per_leaf": 3 * len(CELL_TREE)}


def _odd_tree(kind, device="cpu"):
    """The cell's tree with one more leaf the fused update does not take:
    float64, or a transposed (non-contiguous) view."""
    def tree():
        t = _tree(CELL_TREE, device)
        g = torch.Generator().manual_seed(5)
        if kind == "float64":
            t["params/odd"] = torch.randn(33, generator=g, dtype=torch.float64).to(device)
        else:
            t["params/odd"] = torch.randn(24, 40, generator=g).to(device).t()
        return t
    return tree


@pytest.mark.parametrize("kind", ["float64", "non_contiguous"])
def test_a_leaf_the_kernel_does_not_take_goes_leaf_by_leaf(kind):
    tree = _odd_tree(kind)

    def grads_like(params, step):
        out = _grads(CELL_TREE, params, step)
        out["params/odd"] = torch.full_like(params["params/odd"], 0.25 * (step + 1))
        return out

    got, want = tree(), tree()
    opt = topt.Optimizer(_tx("adamw", "cosine"), got)
    ref_tx = _tx("adamw", "cosine")
    ref_state = ref_tx.init(want)
    for step in range(5):
        grads = grads_like(got, step)
        opt.step(got, grads)
        ref_state = per_leaf(ref_tx, ref_state, want, grads)
    _assert_same(opt, got, want, ref_state)
    assert opt.route_leaves == {"fused": 5 * len(CELL_TREE), "per_leaf": 5}


def test_a_training_kernel_builds_and_loads_its_library_alone(monkeypatch):
    """KA's first use builds and loads ``adam_update`` only (``ALONE``); an
    inference kernel's first use then builds and loads every library."""
    from quantize_tpu_torch.ops import _build

    built, loaded = [], []

    class Lib:
        def __getattr__(self, sym):
            return SimpleNamespace()

    def cdll(path):
        loaded.append(Path(path).name)
        return Lib()

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "build_all", lambda names=None: built.append(list(names)))
    monkeypatch.setattr(_build, "_lib_path", lambda lib: Path(f"{lib}.so"))
    monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
    assert _build.ALONE == {"adam_update"}
    _build.kernel_fn("adam_update")
    assert built == [["adam_update"]] and loaded == ["adam_update.so"]
    assert set(_build._fns) == {"adam_update"}
    _build.kernel_fn("adam_update")
    _build.kernel_fn("w8a8_gemm")
    assert built == [["adam_update"], _build.LIBRARIES]
    assert loaded == ["adam_update.so"] + [f"{lib}.so" for lib in _build.LIBRARIES]
    assert set(_build._fns) == set(_build.KERNELS)


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the GPU machine)")


@pytest.mark.cuda
@pytest.mark.parametrize("sched", list(SCHEDULES))
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_cuda_kernel_is_bit_equal_to_the_chain_leaf_by_leaf(cuda_card, name, sched):
    before = kadam.adam_update.launches
    opt, got, want, ref_state = _run(name, sched, CELL_TREE, device="cuda")
    torch.cuda.synchronize()
    _assert_same(opt, got, want, ref_state)
    assert opt.route_leaves == {"fused": STEPS * len(CELL_TREE), "per_leaf": 0}
    # one launch a step for each fused chain: the split's two labels are two
    labels = 2 if name == "adam-qparams-0.1" else 1
    assert kadam.adam_update.launches - before == STEPS * labels


@pytest.mark.cuda
@pytest.mark.parametrize("wd,qs", [(None, None), (1e-2, 0.1)])
def test_cuda_kernel_is_bit_equal_to_its_plain_version(cuda_card, wd, qs):
    """KA against :func:`adam_update_plain` on the same card tensors (the
    plain version divides by 0-d tensors there, as the chain does), a leaf
    without a gradient included."""
    spec = CELL_TREE
    params = _tree(spec, "cuda")
    grads = _grads(spec, params, 3)
    mu = {k: 0.1 * torch.sin(p) for k, p in params.items()}
    nu = {k: 0.01 * torch.cos(p) ** 2 for k, p in params.items()}
    s = kadam.AdamScalars(0.9, 0.999, 0.1, 0.001, 1e-8, 0.271, 0.00399, wd, -1e-2, qs)
    sides = [[(params[k].clone(), grads[k], mu[k].clone(), nu[k].clone()) for k in spec]
             for _ in range(2)]
    before = kadam.adam_update.launches
    assert kadam.adam_update(sides[0], s) == []
    kadam.adam_update_plain(sides[1], s)
    torch.cuda.synchronize()
    assert kadam.adam_update.launches - before == 1
    for k, got, want in zip(spec, *sides):
        assert all(torch.equal(got[i], want[i]) for i in (0, 2, 3)), k  # p, mu, nu
        assert not torch.equal(got[0], params[k]), k


@pytest.mark.cuda
def test_cuda_more_leaves_than_one_launch_takes(cuda_card):
    spec = {f"params/l{i}/w": ((i % 7 + 1,), 1.0) for i in range(kadam.ADAM_CHUNK + 60)}
    before = kadam.adam_update.launches
    opt, got, want, ref_state = _run("adamw", "cosine", spec, device="cuda", steps=4)
    torch.cuda.synchronize()
    _assert_same(opt, got, want, ref_state)
    assert kadam.adam_update.launches - before == 4 * 2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float64", "non_contiguous"])
def test_cuda_a_leaf_the_kernel_does_not_take_falls_back(cuda_card, kind):
    tree = _odd_tree(kind, "cuda")
    got, want = tree(), tree()
    opt = topt.Optimizer(_tx("adam", "constant"), got)
    ref_tx = _tx("adam", "constant")
    ref_state = ref_tx.init(want)
    for step in range(5):
        grads = _grads(CELL_TREE, got, step)
        grads["params/odd"] = torch.full_like(got["params/odd"], 0.25 * (step + 1))
        opt.step(got, grads)
        ref_state = per_leaf(ref_tx, ref_state, want, grads)
    torch.cuda.synchronize()
    _assert_same(opt, got, want, ref_state)
    assert opt.route_leaves == {"fused": 5 * len(CELL_TREE), "per_leaf": 5}


@pytest.mark.cuda
def test_cuda_unaligned_leaves_take_the_scalar_loop(cuda_card):
    """Leaves 4 bytes past a 16-byte boundary (views at offset 1 of a
    buffer): the kernel's one-element loop, bit-equal all the same; the
    version counters move as an in-place op moves them."""
    def tree():
        t = _tree(CELL_TREE, "cuda")
        buf = torch.randn(4096 + 9, generator=torch.Generator().manual_seed(3)).cuda()
        t["params/unaligned"] = buf[1:]
        return t

    got, want = tree(), tree()
    assert got["params/unaligned"].data_ptr() % 16 == 4
    opt = topt.Optimizer(_tx("adam", "constant"), got)
    ref_tx = _tx("adam", "constant")
    ref_state = ref_tx.init(want)
    versions = {k: v._version for k, v in got.items()}
    for step in range(5):
        grads = _grads(CELL_TREE, got, step)
        grads["params/unaligned"] = torch.sin(got["params/unaligned"] * (step + 1))
        opt.step(got, grads)
        ref_state = per_leaf(ref_tx, ref_state, want, grads)
    torch.cuda.synchronize()
    _assert_same(opt, got, want, ref_state)
    assert opt.route_leaves == {"fused": 5 * (len(CELL_TREE) + 1), "per_leaf": 0}
    assert all(got[k]._version > versions[k] for k in got)


@pytest.mark.cuda
def test_cuda_qat_train_step_matches_the_chain_leaf_by_leaf(cuda_card, tmp_path, monkeypatch):
    """One ``QAT.train_step`` of ViT-B/16 W4A8 at 32 x 32 (the QAT cell's
    472 leaves; ``qparams_lr_scale`` 0.1, so both labels of the split): the
    leaves and moments after the step equal those of the chain leaf by leaf
    from the same leaves, state and gradients."""
    from quantize_tpu_torch import runners
    from quantize_tpu_torch.nn.variables import trainable
    from quantize_tpu_torch.runners import qat
    from quantize_tpu_torch.utils import Config, Logger

    w4 = {"n_bits": 4, "symmetric": True, "signed": True, "granularity": "channel",
          "range": {"name": "minmax"}}
    a8 = {"n_bits": 8, "symmetric": False, "granularity": "layer",
          "range": {"name": "maminmax", "momentum": 0.1}}
    Logger(str(tmp_path))
    cfg = Config({"seed": 0, "output_dir": str(tmp_path),
                  "model": {"name": "vit_b_16", "num_classes": 10, "image_size": 32},
                  "runner": {"name": "qat", "verbose": False},
                  "quant": {"default": {"weight": w4, "activation": a8}},
                  "optimizer": {"name": "adam", "lr": 1e-3, "qparams_lr_scale": 0.1},
                  "lr_scheduler": {"name": "constant"},
                  "train": {"calibrated_epoch": 1, "max_epoch": 1, "print_freq": 1000}})
    runner = runners.build_runner(cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)

    def batch():
        return {"img": torch.randn((4, 32, 32, 3), generator=g, device="cuda"),
                "label": torch.randint(0, 10, (4,), generator=g, device="cuda")}

    runner.init_variables(batch())
    for i in range(2):
        runner.train_step(batch(), 0, i, 2)
    runner.build_optim()
    runner.initialized = True
    runner.train_step(batch(), 1, 0, 2)  # the moments away from zero
    leaves = trainable(runner.model, qat.TRAINABLE)
    want = {k: v.detach().clone() for k, v in leaves.items()}
    ref_state = copy.deepcopy(runner.optimizer.state)
    seen, step_grads = {}, qat.loss_and_grads

    def recorded(*args, **kw):
        out = step_grads(*args, **kw)
        seen["grads"] = out[2]
        return out

    monkeypatch.setattr(qat, "loss_and_grads", recorded)
    routes = dict(runner.optimizer.route_leaves)
    runner.train_step(batch(), 1, 1, 2)
    ref_state = per_leaf(runner.optimizer.tx, ref_state, want, seen["grads"])
    torch.cuda.synchronize()
    got = trainable(runner.model, qat.TRAINABLE)
    assert len(got) == 472
    _assert_same(runner.optimizer, {k: v.detach() for k, v in got.items()}, want, ref_state)
    assert runner.optimizer.route_leaves["fused"] - routes["fused"] == 472
    assert runner.optimizer.route_leaves["per_leaf"] == routes["per_leaf"] == 0
