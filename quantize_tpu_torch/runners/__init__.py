"""Runner registry + end-to-end execution.

PyTorch counterpart of ``quantize_tpu/runners/__init__.py`` (the
reference's ``RUNNERS`` / ``build_runner`` / ``execute_runner``,
``runner/__init__.py:13-77``): builds the dataloaders, injects
``num_classes`` from the dataset into the model config, runs calibration,
then re-evaluates the best checkpoint on the test split, all on ``device``
(CUDA unless the caller asks for the CPU). PTQ is ported; ``qat`` and
``adaround``, and ``train.elastic``, raise NotImplementedError.
"""
from __future__ import annotations

from typing import Optional

from ..data import build_dataloader, build_transform
from ..utils import get_logger
from ..utils.registry import Registry, not_ported, not_ported_error
from .base import BasicRunner
from .ptq import PTQ

RUNNERS = Registry("runners")
RUNNERS.register_dict({"ptq": PTQ, "qat": not_ported("the QAT runner", 2),
                       "adaround": not_ported("the AdaRound runner", 2)})


def build_runner(cfg, train_loader=None, val_loader=None, test_loader=None,
                 device="cuda") -> BasicRunner:
    name = cfg.runner.name if cfg.runner else "ptq"
    cls = RUNNERS.lookup(name)
    return cls(cfg, train_loader, val_loader, test_loader, device=device)


def _loader(cfg, which: str):
    split_cfg = getattr(cfg, f"{which}_dataset", None)
    transform = build_transform(split_cfg.transform) if split_cfg and split_cfg.transform else None
    return build_dataloader(cfg, which, transform=transform)


def execute_runner(cfg, device="cuda") -> Optional[dict]:
    """Build loaders + runner, calibrate, then test from the best checkpoint
    (reference ``runner/__init__.py:41-77``)."""
    if cfg.train and cfg.train.elastic:
        raise not_ported_error("the fault-tolerant run (train.elastic)", 6)
    logger = get_logger()
    train_loader = _loader(cfg, "train")
    val_loader = _loader(cfg, "val")
    test_loader = _loader(cfg, "test")

    # dataset metadata -> model config (reference runner/__init__.py:51-52)
    ds = (train_loader or val_loader or test_loader)
    if ds is not None and cfg.model:
        cfg.model.num_classes = ds.dataset.num_classes
        cfg.model.classnames = list(ds.dataset.classnames)

    runner = build_runner(cfg, train_loader, val_loader, test_loader, device=device)
    if train_loader is not None:
        runner.run()

    result = None
    if test_loader is not None:
        best = cfg.runner.best if cfg.runner else None
        if best:
            runner.load_checkpoint(best)
        result = runner.evaluate(test_loader, quantized=bool(cfg.quant))
        logger.info(f"test result: {result}")
    return result


__all__ = ["RUNNERS", "BasicRunner", "PTQ", "build_runner", "execute_runner"]
