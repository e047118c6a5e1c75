#!/usr/bin/env python3
"""The noise floor of one quant-mode QAT step on one GPU: how far the loss
and the gradients of ``chip_smoke.py`` phase 12a move when the batch is run
as two halves on the same card (what phase 12b's two data-parallel ranks
compute, without a mesh), and when its input moves by independent 1e-6
relative perturbations.

    python3 scripts/qat_noise_floor.py [--perturbations 4]

ResNet-50 W8A8 at 224 (phase 12's configuration: seed 0, calibrated on the
batch, a global batch of 32 from seed 12 with one padded label). For each
of ``torch.backends.cudnn.deterministic`` off and on: the step run twice
(the same bits, or not), the halves' masked shares summed, then each
perturbation; each line gives the loss's relative gap and each collection's
gradient gap ``|g - g_whole| / |g_whole|``. The card's name and power limit
first. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import quantize_tpu_torch as qtt  # noqa: E402
from quantize_tpu_torch.runners.qat import loss_and_grads  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--perturbations", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("qat_noise_floor: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(12)
    n = cs.MESH_TRAIN_BATCH
    img = torch.randn((n, 224, 224, 3), generator=gen, device=dev)
    label = torch.randint(0, 1000, (n,), generator=gen, device=dev)
    label[5] = -1
    model = qtt.MODELS.build("resnet50", num_classes=1000, ctx=qtt.QuantCtx(cs.CFG))
    qtt.init_model(model, img[:8], seed=0)
    qtt.calibrate_model(model, [img[:16], img[16:]])

    def step(x, y):
        loss, _, grads = loss_and_grads(model, x, y)
        return float(loss), {k: g.detach() for k, g in grads.items() if g is not None}

    def report(what, loss, grads, ref):
        loss_a, grads_a = ref
        gaps = {col: cs.grad_gap(grads, grads_a, sorted(k for k in grads_a
                                                         if k.startswith(col + "/")))
                for col in ("params", "qparams")}
        print(f"  {what}: loss {abs(loss - loss_a) / abs(loss_a):.3e}, params "
              f"{gaps['params']:.3e}, qparams {gaps['qparams']:.3e}", flush=True)

    count = float((label >= 0).sum())
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        ref = step(img, label)
        print(f"cudnn.deterministic={det}: whole batch of {n}, loss {ref[0]:.6f}", flush=True)
        report("the same step again", *step(img, label), ref)
        halves = []
        for rows in (slice(0, n // 2), slice(n // 2, n)):
            loss, grads = step(img[rows], label[rows])
            w = float((label[rows] >= 0).sum()) / count  # its share of the masked mean
            halves.append((loss * w, {k: g * w for k, g in grads.items()}))
        report(f"two halves of {n // 2} summed", halves[0][0] + halves[1][0],
               {k: halves[0][1][k] + halves[1][1][k] for k in ref[1]}, ref)
        pert = torch.Generator(device=dev).manual_seed(13)
        for i in range(args.perturbations):
            x = img * (1 + 1e-6 * torch.randn(img.shape, generator=pert, device=dev))
            report(f"1e-6 perturbation {i}", *step(x, label), ref)
    torch.backends.cudnn.deterministic = False


if __name__ == "__main__":
    main()
