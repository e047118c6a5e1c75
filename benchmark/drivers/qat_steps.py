"""Traffic kind ``qat_steps``: quantization-aware training steps.

Set-up builds the framework's QAT runner (``runners.build_runner`` over the
configuration's model and quant sections and the job's ``optimizer`` and
``lr_scheduler``), imports the seeded weights, runs ``calibration_steps``
calibration steps of ``batch`` seeded images with labels, switches to
training (the runner's optimizer built over every ``params`` and
``qparams`` leaf), then drives ``QAT.train_step`` (quant-mode forward,
gradients, the optimizer's update) through its first ``checked_steps``
steps, on batches whose rows all differ, and hands the same runner to the
window. The window steps through ``distinct_batches`` batches in turn; each
step returns its loss to the host. ``train_img_per_s`` is every image of the
window's steps over the window's time, which ends in a synchronize.

The reference follows the first steps, which are taken in set-up, before
the window, through the same runner and ``train_step`` that the window then
drives: each step's loss, each leaf's first gradient as the optimizer holds
it (Adam's first moment after one step, divided by ``1 - b1``), and each
leaf's change over the checked steps. The window's own steps are not
compared.

The configuration trains in float32 with TF32 off. Set-up switches TF32
off; once the window has closed, a float32 product and conv on the device
read whether the program left it so (:func:`check.float32_errors`), and a
traced run counts the stretch's TF32 kernels (``tf32_launches``).
"""
from __future__ import annotations

import tempfile
import time

import torch

from ..core import check, inputs
from ..core.spec import family
from ..core.trace import Stretch, span

TRAINABLE = ("params", "qparams")


def data(cfg: dict, t: dict, seed: int, device) -> tuple:
    """``(calibration, batches)``: lists of ``{"img", "label"}``."""
    gen = inputs.generator(seed, "train", device)
    classes, shape = int(cfg["architecture"]["num_classes"]), inputs.image_shape(cfg)

    def batch():
        return {"img": torch.randn((int(t["batch"]), *shape), generator=gen, device=device),
                "label": torch.randint(0, classes, (int(t["batch"]),), generator=gen,
                                       device=device)}

    calib = [batch() for _ in range(int(t["calibration_steps"]))]
    return calib, [batch() for _ in range(int(t["distinct_batches"]))]


def build_runner(qtt, cfg: dict, t: dict, out_dir: str, device):
    """The framework's QAT runner over ``cfg``; no data loaders."""
    from quantize_tpu_torch import runners
    from quantize_tpu_torch.utils import Config, Logger

    Logger(out_dir)
    arch = cfg["architecture"]
    model = {"name": cfg["model"], "num_classes": int(arch["num_classes"]),
             **family(cfg).build_kwargs(arch)}
    conf = Config({"seed": 0, "output_dir": out_dir, "model": model,
                   "runner": {"name": "qat", "verbose": False}, "quant": cfg["quant"],
                   "optimizer": dict(t["optimizer"]), "lr_scheduler": dict(t["lr_scheduler"]),
                   "train": {"calibrated_epoch": 1, "max_epoch": 1, "print_freq": 1000}})
    return runners.build_runner(conf, device=device)


def first_steps(qtt, r, runner, cfg, t, calib, batches) -> dict:
    """Import, calibrate, switch, and the checked steps; what the reference
    is held to."""
    from quantize_tpu_torch.models.import_auto import import_into_model
    from quantize_tpu_torch.nn.variables import trainable

    with torch.no_grad():
        sd = inputs.state_dict(cfg, r.seed, r.device)
    runner.init_variables(calib[0])
    import_into_model(runner.model, cfg["model"], sd)
    qtt.reset_observers(runner.model)
    del sd
    for i, b in enumerate(calib):
        runner.train_step(b, 0, i, len(calib))
    runner.build_optim()
    runner.initialized = True
    before = {k: v.detach().clone() for k, v in trainable(runner.model, TRAINABLE).items()}
    losses, grads = [], None
    for i in range(int(t["checked_steps"])):
        losses.append(runner.train_step(batches[i], 1, i, int(t["checked_steps"]))[0])
        if i == 0:
            b1 = float(t["optimizer"].get("beta1", 0.9))
            mu = runner.optimizer.state[0]["mu"]
            grads = {k: float((mu[k].double() / (1 - b1)).norm()) for k in before}
    after = trainable(runner.model, TRAINABLE)
    change = {k: float((after[k].detach().double() - before[k].double()).norm()) for k in before}
    return {"losses": losses, "grads": grads, "change": change}


def _train_reference(cfg: dict):
    ref = family(cfg).TrainReference
    if ref is None:
        raise ValueError(f"family {cfg['family']!r} has no training reference "
                         f"(benchmark/families/{cfg['family']}.py: TrainReference)")
    return ref


def reference_steps(cfg, t, seed: int, device, tf32: bool = False, rows: int = 0) -> dict:
    """The reference through the checked steps; ``tf32`` and ``rows`` (the
    first rows of each batch only) make the control and a planted fault."""
    train_reference = _train_reference(cfg)
    calib, batches = data(cfg, t, seed, device)
    rows = rows or int(t["batch"])
    opt = t["optimizer"]
    ref = train_reference(inputs.state_dict(cfg, seed, device), cfg["architecture"],
                            cfg["quant"], [b["img"] for b in calib], float(opt["lr"]),
                            float(opt.get("beta1", 0.9)), float(opt.get("beta2", 0.999)),
                            float(opt.get("eps", 1e-8)))
    before = {k: v.detach().clone().double() for k, v in ref.leaves.items()}
    losses, grads = [], None
    for i in range(int(t["checked_steps"])):
        loss, g = ref.step(batches[i]["img"][:rows], batches[i]["label"][:rows], tf32)
        losses.append(loss)
        if i == 0:
            grads = {k: float(v.double().norm()) for k, v in g.items()}
    change = {k: float((ref.leaves[k].detach().double() - before[k]).norm()) for k in before}
    return {"losses": losses, "grads": grads, "change": change}


def compare(program: dict, ref: dict) -> dict:
    """A leaf's gap is the gap of the two norms, over the larger of the
    reference leaf's norm and the median leaf's; leaves whose reference
    gradient is under a thousandth of the median leaf's (moved by round-off
    alone) are left out.

    ``loss_gap``: the worst checked step's relative loss gap.
    ``grad_gap``: the worst ``params`` leaf's first gradient.
    ``qparams_grad_gap``: the median ``qparams`` leaf's first gradient (an
    activation scale's gradient sums the rounding residuals of its whole
    tensor, so one activation that rounds the other way moves it by about
    its own size: its worst leaf reads the rounding, not the program).
    ``change_gap``: the worst leaf's change over the checked steps."""
    loss = max(abs(p - q) / abs(q) for p, q in zip(program["losses"], ref["losses"]))
    inf = float("inf")
    if set(program["grads"]) != set(ref["grads"]):
        return {"loss_gap": loss, "grad_gap": inf, "qparams_grad_gap": inf, "change_gap": inf}
    g_med = _median(ref["grads"].values())
    keep = [k for k, v in ref["grads"].items() if v >= 1e-3 * g_med]
    c_med = _median(ref["change"][k] for k in keep)

    def grad(k):
        return abs(program["grads"][k] - ref["grads"][k]) / max(ref["grads"][k], g_med)

    change = max(abs(program["change"][k] - ref["change"][k]) / max(ref["change"][k], c_med)
                 for k in keep)
    return {"loss_gap": loss,
            "grad_gap": max(grad(k) for k in keep if k.startswith("params/")),
            "qparams_grad_gap": _median(grad(k) for k in keep if k.startswith("qparams/")),
            "change_gap": change}


def _median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0


def run(r) -> dict:
    cfg, t, dev, qtt = r.cell.config, r.cell.traffic, r.device, r.qtt
    _train_reference(cfg)
    prec = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    # the configuration's training precision: float32, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            got, window, steps, stretch = _window(r, qtt, cfg, t, dev, out_dir)
        # float32 as the program left it, before anything is restored
        precision = check.float32_errors(dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prec
    r.free()
    ref = reference_steps(cfg, t, r.seed, dev)
    compared = {**compare(got, ref), **precision}
    if stretch is not None:
        compared["tf32_launches"] = check.tf32_launches(stretch.summary)
    batch = int(t["batch"])
    return {"e2e": {"train_img_per_s": steps * batch / window, "setup_s": r.setup_s},
            "attempted": steps * batch, "failed": 0, "compared": compared,
            "stretch": None if stretch is None else stretch.summary,
            "info": {"steps": steps, "window_s": window, "losses": got["losses"],
                     "reference_losses": ref["losses"], "batch": batch}}


def _window(r, qtt, cfg, t, dev, out_dir) -> tuple:
    calib, batches = data(cfg, t, r.seed, dev)
    runner = build_runner(qtt, cfg, t, out_dir, dev)
    got = first_steps(qtt, r, runner, cfg, t, calib, batches)
    n = len(batches)
    stretch = Stretch(dev) if r.trace else None
    if stretch is not None:
        stretch.warm(lambda: runner.train_step(batches[0], 1, 0, 1))
    r.reset_peak()
    r.sync()
    r.begin_window()
    t0 = time.perf_counter()
    i, traced_from, last = 0, None, t0
    while (now := time.perf_counter()) - t0 < r.seconds:
        # from trace_from of the window, and at the latest on what looks like
        # its last step
        if (stretch is not None and traced_from is None
                and (now - t0 >= r.seconds * float(t["trace_from"])
                     or 2 * now - last - t0 >= r.seconds)):
            stretch.start()
            traced_from = i
        last = now
        with span("step", r.trace):
            runner.train_step(batches[i % n], 1, i, n)
        i += 1
    r.sync()
    window = time.perf_counter() - t0
    if traced_from is not None:
        stretch.stop(i - traced_from)
    r.read_peak()
    return got, window, i, stretch
