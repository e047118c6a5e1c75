"""Runner registry + end-to-end execution.

PyTorch counterpart of ``quantize_tpu/runners/__init__.py`` (the
reference's ``RUNNERS`` / ``build_runner`` / ``execute_runner``,
``runner/__init__.py:13-77``): builds the dataloaders, injects
``num_classes`` from the dataset into the model config, runs calibration,
then re-evaluates the best checkpoint on the test split, all on ``device``
(CUDA unless the caller asks for the CPU). The three runners are ported:
``ptq``, ``qat`` and ``adaround``; with ``train.elastic`` the run goes
through :func:`~.resume.supervised_run` (resumable epochs, restarts).
"""
from __future__ import annotations

from typing import Optional

from ..data import build_dataloader, build_transform
from ..utils import get_logger
from ..utils.registry import Registry
from .adaround import AdaRound
from .base import BasicRunner
from .ptq import PTQ
from .qat import QAT

RUNNERS = Registry("runners")
RUNNERS.register_dict({"ptq": PTQ, "qat": QAT, "adaround": AdaRound})


def build_runner(cfg, train_loader=None, val_loader=None, test_loader=None,
                 device="cuda", mesh=None) -> BasicRunner:
    """The runner ``cfg.runner.name`` names; with ``mesh`` (every rank of it
    builds the same runner) it runs on the ranks (PTQ, QAT and AdaRound)."""
    name = cfg.runner.name if cfg.runner else "ptq"
    cls = RUNNERS.lookup(name)
    return cls(cfg, train_loader, val_loader, test_loader, device=device, mesh=mesh)


def _loader(cfg, which: str):
    split_cfg = getattr(cfg, f"{which}_dataset", None)
    transform = build_transform(split_cfg.transform) if split_cfg and split_cfg.transform else None
    return build_dataloader(cfg, which, transform=transform)


def execute_runner(cfg, device="cuda", mesh=None) -> Optional[dict]:
    """Build loaders + runner, run it, then test from the best checkpoint
    (reference ``runner/__init__.py:41-77``); with ``mesh``, on its ranks
    (every rank calls this with the same config)."""
    logger = get_logger()
    train_loader = _loader(cfg, "train")
    val_loader = _loader(cfg, "val")
    test_loader = _loader(cfg, "test")

    # dataset metadata -> model config (reference runner/__init__.py:51-52)
    ds = (train_loader or val_loader or test_loader)
    if ds is not None and cfg.model:
        cfg.model.num_classes = ds.dataset.num_classes
        cfg.model.classnames = list(ds.dataset.classnames)

    runner = build_runner(cfg, train_loader, val_loader, test_loader, device=device, mesh=mesh)
    if train_loader is not None:
        elastic = cfg.train.elastic if cfg.train else None
        if elastic:
            # fault-tolerant path: resumable epochs + supervised restarts
            # (config: train.elastic.{max_restarts, backoff_s,
            # ckpt_every_epochs, monitor})
            import os

            from ..parallel.fault import HealthMonitor, Heartbeat
            from .resume import supervised_run

            # one heartbeat a rank (p<rank>.heartbeat), so that a wedged rank shows
            rank = mesh.rank if mesh is not None else 0
            hb_path = os.path.join(cfg.output_dir or "results", f"p{rank}.heartbeat")
            result_sup = supervised_run(
                lambda attempt: runner if attempt == 0 else build_runner(
                    cfg, _loader(cfg, "train"), val_loader, test_loader, device=device,
                    mesh=mesh),
                max_restarts=int(elastic.max_restarts or 3),
                backoff_s=float(elastic.backoff_s or 0.5),
                ckpt_every_epochs=int(elastic.ckpt_every_epochs or 1),
                monitor_factory=(HealthMonitor if elastic.monitor else None),
                heartbeat=Heartbeat(hb_path, process_index=rank),
            )
            runner = result_sup.runner
            if result_sup.restarts:
                logger.info(f"completed after {len(result_sup.restarts)} restart(s)")
        else:
            runner.run()

    result = None
    if test_loader is not None:
        best = cfg.runner.best if cfg.runner else None
        if best:
            runner.load_checkpoint(best)
        result = runner.evaluate(test_loader, quantized=bool(cfg.quant))
        logger.info(f"test result: {result}")
    return result


__all__ = ["RUNNERS", "AdaRound", "BasicRunner", "PTQ", "QAT", "build_runner", "execute_runner"]
