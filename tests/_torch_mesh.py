"""Ranks of the port on a ``(data, model)`` mesh for the mesh-training tests
(``tests/test_torch_mesh_*.py``): fresh interpreters joined over gloo on
the CPU (``quantize_tpu_torch.parallel.scaling.spawn_ranks``), each running
a list of jobs and saving what it computed for the test process, which
holds it against JAX's sharded computation and the port's one device.

A job names a model (``build``: a registry name and keywords, or CLIP's
zero-shot model), its quant config, a file of variables (``{collection:
{"path/leaf": tensor}}``) that every rank shards onto its mesh, a batch
that each rank takes its ``data`` rows of, the device (``"cpu"``, or
``"cuda"``: rank ``r`` on card ``r % device_count()``), and what to run:

* ``forward``: the logits in each of ``modes`` (no gradient);
* ``step``: :func:`~quantize_tpu_torch.runners.qat.loss_and_grads` on the
  mesh, then one SGD step of ``lr``: the loss, the gradients gathered whole
  (``gather_variables`` over ``rank_variables``' spec), the trainable leaves
  this rank holds whole (for the ranks to be compared with each other),
  the updated variables gathered whole, and the collectives of the step;
* ``modes``: calibrate, pack and ``init_adaround`` on the loaded model
  (each used to raise on a split layer): whether calibrate and pack ran
  and changed the variables, and the V that
  ``init_adaround`` wrote (this rank's own, and gathered whole) beside the
  variables it was written from (gathered whole);
* ``ada``: AdaRound at β ``ada`` on variables that hold V: the
  ``init_adaround`` pass on this rank's rows (its V, own and gathered
  whole, and its collectives), then, from the loaded V again, each V's
  regularization (its value summed over ``model`` where it is a slice, its
  gradient gathered whole), then one joint step
  (:func:`~quantize_tpu_torch.runners.adaround.calibrate_taps` and
  ``reconstruction_loss`` on the mesh): the loss, the V gradients (own, and
  gathered whole) and the step's collectives;
* ``train_runner``: a QAT or AdaRound runner built from the config dict
  ``train_runner["cfg"]`` over a loader of the global batches in
  ``train_runner["batches"]`` (an ``.npz`` of ``img``/``label`` stacks),
  from the whole variables ``train_runner["variables"]``, run on the mesh:
  its variables gathered whole and this rank's own, its ``layer_losses``
  (in layer order), the loss and the collectives of each train step, the
  collectives of each sequential input pass, and its top-1 over the same
  batches;
* ``roundtrip``: ``gather_variables(mesh, shard_variables(mesh, v))``
  against ``v``, bit for bit;
* ``calibrate``: a list of global batches (``.npy``), each rank calibrating
  on its rows of each (``qtt.calibrate_model``): the variables gathered
  whole, and the collectives of the first step;
* ``pack``: a global batch whose rows each rank packs with
  (``qtt.pack_model``): the deploy variables gathered whole, and the packed
  logits of this rank's rows of ``x``;
* ``engine``: an ``InferenceEngine`` over the variables on the mesh, batch
  ``batch``: the leader of each ``model`` group serves the images of ``x``
  in its ``data`` rows; a follower's ``submit`` must raise, and its
  ``stop()`` returns once the leader stops; ``follower_carry`` sets the
  follower's packed carry dtype to another than the leader's before it
  starts (it must serve under the leader's, and have its own back after);
  ``silent`` instead leaves the leader idle without an engine, and the
  follower's ``stop()`` must raise within ``follow_timeout_s`` (set as the
  engine's ``_FOLLOW_TIMEOUT_S``);
* ``runner``: a runner through ``execute_runner`` over config files and
  ``--opts`` (the CLI's path), on the mesh: its test result (rank 0 writes
  the checkpoints, gathered whole, into the job's ``output_dir``) and the
  files in that directory.
"""
import json

import numpy as np
import torch

from quantize_tpu_torch.parallel.scaling import spawn_ranks

TIMEOUT = 240.0

WORKER = r"""
import json, sys, time
import numpy as np, torch
torch.set_num_threads(1)
import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert, optim
from quantize_tpu_torch.nn.variables import collections, trainable
from quantize_tpu_torch.parallel import (CollectiveCounter, InferenceEngine, ShardedVariables,
                                         gather_variables,
                                         init_distributed, make_mesh, rank_variables,
                                         shard_variables)
from quantize_tpu_torch.runners.qat import TRAINABLE, loss_and_grads

rank, world, port = (int(a) for a in sys.argv[1:4])
jobs = json.load(open(sys.argv[4]))
init_distributed(rank, world, port)


def build(job, device):
    ctx = qtt.QuantCtx(job["cfg"])
    b = job["build"]
    if b["name"] == "clip":
        from quantize_tpu_torch.models.clip import CLIPZeroShot
        return CLIPZeroShot(ctx=ctx, device=device, **b["kw"])
    return qtt.MODELS.build(b["name"], ctx=ctx, device=device, **b["kw"])


def snapshot(model):
    return {f"{c}/{k}": t.detach().clone() for c, f in collections(model).items()
            for k, t in f.items()}


def nest(flat):
    out = {}
    for key, t in flat.items():
        col, rest = key.split("/", 1)
        out.setdefault(col, {})[rest] = t
    return out


def host(obj):
    if isinstance(obj, dict):
        return {k: host(v) for k, v in obj.items()}
    return obj.detach().cpu() if isinstance(obj, torch.Tensor) else obj


def gathered(model, mesh, flat):
    # flat ({"collection/path/leaf": tensor} of this rank's leaves, or their
    # gradients) with every slice gathered whole
    spec = getattr(rank_variables(model), "spec", None)
    if spec is None:
        return dict(flat)
    tree = nest(flat)
    tree = ShardedVariables(tree, mesh, {c: {k: spec[c][k] for k in t} for c, t in tree.items()})
    return {f"{c}/{k}": g for c, t in gather_variables(mesh, tree).items() for k, g in t.items()}


class Loader:
    def __init__(self, batches):
        self.batches, self.batch_size = batches, len(batches[0]["label"])

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


report = {}
for job in jobs:
    dp, tp = job["mesh"]
    cuda = job.get("device") == "cuda"
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    mesh = make_mesh(dp, tp, devices=[f"cuda:{r % torch.cuda.device_count()}" if cuda
                                      else "cpu" for r in range(world)])
    rep, saved = {}, {}
    if "variables" in job:
        model = build(job, mesh.device)
        v = torch.load(job["variables"], weights_only=True)
        with CollectiveCounter() as load:
            convert.from_jax_variables(model, shard_variables(mesh, v))
        rep = {"load": load.counts, "split": sorted(
            p for p, m in model.named_modules() if getattr(m, "tp_shard", None) is not None)}
        x = torch.from_numpy(np.load(job["x"])).to(mesh.device)
        n = x.shape[0] // dp
        rows = slice(mesh.coords[0] * n, (mesh.coords[0] + 1) * n)
    if "forward" in job:
        for mode in job["forward"]:
            with torch.no_grad(), CollectiveCounter() as c:
                saved[mode] = model(x[rows], mode=mode).float()
            rep[mode] = c.counts
    if "step" in job:
        label = torch.from_numpy(np.load(job["label"]))[rows].to(mesh.device)
        with CollectiveCounter() as c:
            loss, _, grads = loss_and_grads(model, x[rows], label, mesh)
        rep["step"] = c.counts
        spec = getattr(rank_variables(model), "spec", None)
        saved["loss"] = loss
        saved["grads"] = gathered(model, mesh, {k: g for k, g in grads.items() if g is not None})
        sliced = {f"{c}/{k}" for c, t in (spec or {}).items() for k, s in t.items() if s}
        saved["whole_grads"] = {k: g for k, g in grads.items()
                                if g is not None and k not in sliced}
        lr = job["step"]
        opt = optim.Optimizer(optim.sgd(lambda i: lr), trainable(model, TRAINABLE))
        opt.step(trainable(model, TRAINABLE), grads)
        saved["updated"] = {f"{c}/{k}": t.detach() for c, t in
                            gather_variables(mesh, rank_variables(model)).items()
                            for k, t in t.items() if c in TRAINABLE}
    if "modes" in job:
        before = snapshot(model)
        ran = []
        for what, call in (("calibrate", lambda: model(x[rows], mode="calibrate")),
                           ("pack", lambda: qtt.pack_model(model, x[rows],
                                                           device=mesh.device))):
            call()
            ran.append(what)
        calibrated = snapshot(model)
        rep["ran"] = ran
        rep["changed"] = before.keys() != calibrated.keys() or any(
            not torch.equal(before[k], calibrated[k]) for k in before)
        saved["from"] = {k: t for k, t in gathered(model, mesh, calibrated).items()
                         if k.startswith(("params/", "qparams/"))}
        with torch.no_grad():
            model(x[rows], mode="init_adaround")
        saved["v_own"] = trainable(model, ("adaround",))
        saved["v"] = gathered(model, mesh, saved["v_own"])
    if "ada" in job:
        import math
        from quantize_tpu_torch.parallel.tensor_parallel import all_reduce
        from quantize_tpu_torch.quant.adaround import regularization
        from quantize_tpu_torch.runners.adaround import (calibrate_taps, reconstruction_loss,
                                                          v_layers)

        beta = job["ada"]
        with torch.no_grad(), CollectiveCounter() as c:
            model(x[rows], mode="init_adaround")
        rep["init"] = c.counts
        saved["init_own"] = {k: t.detach().clone()
                             for k, t in trainable(model, ("adaround",)).items()}
        saved["init_v"] = gathered(model, mesh, saved["init_own"])
        convert.from_jax_variables(model, shard_variables(mesh, v))
        layers = v_layers(model)
        values, reg_grads = {}, {}
        for key, t in trainable(model, ("adaround",)).items():
            t.requires_grad_(True)
            reg = regularization(t, beta, numel=math.prod(layers[key].kernel_shape))
            reg_grads[key], = torch.autograd.grad(reg, [t])
            value = reg.detach().reshape(1)
            if layers[key].tp_shard is not None:
                value = all_reduce(value, mesh.groups["model"])
            values[key] = float(value)
        rep["reg"] = values
        saved["reg_grads"] = gathered(model, mesh, reg_grads)
        with CollectiveCounter() as c:
            fp = calibrate_taps(model, x[rows])
            rep["calibrate"] = dict(c.counts)
            loss, _, grads = reconstruction_loss(model, x[rows], fp, beta, mesh)
        rep["ada_step"] = {k: n - rep["calibrate"].get(k, 0) for k, n in c.counts.items()
                           if n - rep["calibrate"].get(k, 0)}
        saved["loss"] = loss
        saved["own_grads"] = grads
        saved["grads"] = gathered(model, mesh, grads)
    if "roundtrip" in job:
        back = gather_variables(mesh, shard_variables(mesh, v))
        rep["roundtrip"] = all(
            back[c][k].dtype == t.dtype and torch.equal(back[c][k].cpu(), t)
            for c, f in v.items() for k, t in f.items()) and back.keys() == v.keys()
        rep["roundtrip_leaves"] = sum(len(f) for f in v.values())
    if "calibrate" in job:
        for i, path in enumerate(job["calibrate"]):
            xb = torch.from_numpy(np.load(path)).to(mesh.device)
            nb = xb.shape[0] // dp
            with CollectiveCounter() as c:
                qtt.calibrate_model(model, [xb[mesh.coords[0] * nb:(mesh.coords[0] + 1) * nb]],
                                    device=mesh.device)
            if i == 0:
                rep["calibrate"] = c.counts
        saved["calibrated"] = {f"{c}/{k}": t for c, f in
                               gather_variables(mesh, rank_variables(model)).items()
                               for k, t in f.items()}
    if "pack" in job:
        xp = torch.from_numpy(np.load(job["pack"])).to(mesh.device)
        npk = xp.shape[0] // dp
        with CollectiveCounter() as c:
            deploy = qtt.pack_model(model, xp[mesh.coords[0] * npk:(mesh.coords[0] + 1) * npk],
                                    device=mesh.device)
        rep["pack"] = c.counts
        rep["pack_sharded"] = isinstance(deploy, ShardedVariables)
        saved["deploy"] = {f"{c}/{k}": t for c, f in gather_variables(mesh, deploy).items()
                           for k, t in f.items()}
        with torch.no_grad():
            saved["packed"] = model(x[rows], mode="packed")
    if "engine" in job:
        from quantize_tpu_torch.nn import precision
        from quantize_tpu_torch.parallel import serving

        if "follow_timeout_s" in job["engine"]:
            serving._FOLLOW_TIMEOUT_S = job["engine"]["follow_timeout_s"]
        eng = InferenceEngine(model, batch_size=job["engine"]["batch"], mesh=mesh,
                              max_wait_ms=job["engine"].get("wait_ms", 20.0),
                              device=mesh.device)
        rep["leader"] = eng.is_leader
        images = x[rows].numpy()
        if job["engine"].get("silent"):
            if not eng.is_leader:
                eng.start()
                t0 = time.perf_counter()
                try:
                    eng.stop()
                except RuntimeError as exc:
                    rep["follower_error"] = str(exc)
                rep["follower_s"] = time.perf_counter() - t0
            torch.distributed.barrier()
        elif eng.is_leader:
            with CollectiveCounter() as c:
                with eng:
                    futs = eng.submit_many(list(images))
                    saved["served"] = torch.from_numpy(np.stack([f.result(timeout=120)
                                                                 for f in futs]))
            rep["engine"] = {**eng.stats(), "counts": c.counts}
        else:
            try:
                eng.submit(images[0])
            except RuntimeError as exc:
                rep["submit_error"] = str(exc)
            carry = job["engine"].get("follower_carry")
            if carry:
                precision.set_packed_carry_dtype(carry)
            eng.start()
            eng.stop()
            rep["engine"] = eng.stats()
            rep["follower_carry"] = str(precision.packed_carry_dtype())
            precision.set_packed_carry_dtype(None)
    if "train_runner" in job:
        from quantize_tpu_torch.runners import build_runner
        from quantize_tpu_torch.utils import Config

        r = job["train_runner"]
        stacks = np.load(r["batches"])
        batches = [{"img": i, "label": l} for i, l in zip(stacks["img"], stacks["label"])]
        runner = build_runner(Config(r["cfg"]), Loader(batches), device=mesh.device, mesh=mesh)
        quant_input = getattr(runner, "_quant_input", None)
        if r.get("variables"):
            runner.variables = torch.load(r["variables"], weights_only=True)
        steps, losses, stops = [], [], []
        train_step = runner.train_step

        def counted_step(*a, **kw):
            with CollectiveCounter() as c:
                out = train_step(*a, **kw)
            steps.append(c.counts)
            losses.append(out[0])
            return out

        def counted_input(path, *a, **kw):
            with CollectiveCounter() as c:
                out = quant_input(path, *a, **kw)
            stops.append([path, c.counts])
            return out

        runner.train_step = counted_step
        if quant_input is not None:
            runner._quant_input = counted_input
        runner.run()
        rep["steps"], rep["losses"], rep["stops"] = steps, losses, stops
        rep["layer_losses"] = getattr(runner, "layer_losses", {})
        rep["top1"] = runner.evaluate(Loader(batches), quantized=True)
        saved["own"] = snapshot(runner.model)
        saved["variables"] = gathered(runner.model, mesh, saved["own"])
    if "runner" in job:
        import argparse
        import os
        from quantize_tpu_torch.cli import setup_cfg
        from quantize_tpu_torch.runners import execute_runner
        from quantize_tpu_torch.utils import set_random_seed

        r = job["runner"]
        cfg = setup_cfg(argparse.Namespace(cfg=r["cfg"], output_dir=r["output_dir"],
                                           opts=r["opts"]))
        set_random_seed(cfg.seed)
        result = execute_runner(cfg, device="cpu", mesh=mesh)
        rep["runner"] = result
        rep["files"] = sorted(os.listdir(r["output_dir"]))
    torch.save(host(saved), job["out"] + f".rank{rank}.pt")
    report[job["name"]] = rep
torch.distributed.destroy_process_group()
print("REPORT " + json.dumps(report), flush=True)
"""


class ArrayLoader:
    """Global batches of numpy arrays: what a runner reads of a loader
    (iteration, ``len`` and ``batch_size``)."""

    def __init__(self, batches):
        self.batches, self.batch_size = batches, len(batches[0]["label"])

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def flat_tensors(variables) -> dict:
    """``{collection: {"path/leaf": tensor}}`` of nested numpy (or tensor)
    variables."""
    from quantize_tpu_torch import convert

    return {col: {k: torch.tensor(np.asarray(a)) for k, a in convert.flatten(tree).items()}
            for col, tree in variables.items()}


def run_jobs(world: int, jobs: list, tmp) -> tuple:
    """Run ``jobs`` on ``world`` ranks; returns each rank's report and its
    saved results by job name."""
    path = tmp / f"jobs{world}.json"
    path.write_text(json.dumps(jobs))
    outs = spawn_ranks(world, WORKER, [str(path)], timeout=TIMEOUT, threads=1)
    reports = [json.loads(next(ln for ln in out.splitlines() if ln.startswith("REPORT "))[7:])
               for out in outs]
    saved = [{job["name"]: torch.load(job["out"] + f".rank{r}.pt", weights_only=True)
              for job in jobs} for r in range(world)]
    return reports, saved
