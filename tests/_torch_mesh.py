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
* ``refuse``: calibrate and pack on the loaded model, each of which must
  raise ValueError and leave every variable as it was;
* ``roundtrip``: ``gather_variables(mesh, shard_variables(mesh, v))``
  against ``v``, bit for bit.
"""
import json

import numpy as np
import torch

from quantize_tpu_torch.parallel.scaling import spawn_ranks

TIMEOUT = 240.0

WORKER = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert, optim
from quantize_tpu_torch.nn.variables import collections, trainable
from quantize_tpu_torch.parallel import (CollectiveCounter, ShardedVariables, gather_variables,
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


report = {}
for job in jobs:
    dp, tp = job["mesh"]
    cuda = job.get("device") == "cuda"
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    mesh = make_mesh(dp, tp, devices=[f"cuda:{r % torch.cuda.device_count()}" if cuda
                                      else "cpu" for r in range(world)])
    model = build(job, mesh.device)
    v = torch.load(job["variables"], weights_only=True)
    with CollectiveCounter() as load:
        convert.from_jax_variables(model, shard_variables(mesh, v))
    rep = {"load": load.counts, "split": sorted(
        p for p, m in model.named_modules() if getattr(m, "tp_shard", None) is not None)}
    x = torch.from_numpy(np.load(job["x"])).to(mesh.device)
    n = x.shape[0] // dp
    rows = slice(mesh.coords[0] * n, (mesh.coords[0] + 1) * n)
    saved = {}
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
        flat_grads = {k: g for k, g in grads.items() if g is not None}
        if spec is not None:
            tree = nest(flat_grads)
            tree = ShardedVariables(tree, mesh, {c: {k: spec[c][k] for k in t}
                                                 for c, t in tree.items()})
            flat_grads = {f"{c}/{k}": g for c, t in gather_variables(mesh, tree).items()
                          for k, g in t.items()}
        saved["loss"] = loss
        saved["grads"] = flat_grads
        sliced = {f"{c}/{k}" for c, t in (spec or {}).items() for k, s in t.items() if s}
        saved["whole_grads"] = {k: g for k, g in grads.items()
                                if g is not None and k not in sliced}
        lr = job["step"]
        opt = optim.Optimizer(optim.sgd(lambda i: lr), trainable(model, TRAINABLE))
        opt.step(trainable(model, TRAINABLE), grads)
        saved["updated"] = {f"{c}/{k}": t.detach() for c, t in
                            gather_variables(mesh, rank_variables(model)).items()
                            for k, t in t.items() if c in TRAINABLE}
    if "refuse" in job:
        before = snapshot(model)
        refused = []
        for what, call in (("calibrate", lambda: model(x[rows], mode="calibrate")),
                           ("pack", lambda: qtt.pack_model(model, x[rows],
                                                           device=mesh.device))):
            try:
                call()
            except ValueError as exc:
                refused.append([what, str(exc)])
        after = snapshot(model)
        rep["refused"] = refused
        rep["unchanged"] = before.keys() == after.keys() and all(
            torch.equal(before[k], after[k]) for k in before)
    if "roundtrip" in job:
        back = gather_variables(mesh, shard_variables(mesh, v))
        rep["roundtrip"] = all(
            back[c][k].dtype == t.dtype and torch.equal(back[c][k].cpu(), t)
            for c, f in v.items() for k, t in f.items()) and back.keys() == v.keys()
        rep["roundtrip_leaves"] = sum(len(f) for f in v.values())
    torch.save(host(saved), job["out"] + f".rank{rank}.pt")
    report[job["name"]] = rep
torch.distributed.destroy_process_group()
print("REPORT " + json.dumps(report), flush=True)
"""


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
