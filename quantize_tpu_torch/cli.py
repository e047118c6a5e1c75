"""CLI entry point (installable as ``quantize-tpu-torch``).

Usage (the JAX package's ``quantize-tpu``, on the card)::

    python -m quantize_tpu_torch.cli --cfg configs/runners/ptq/minmax/xxx.yaml --opts seed=3
    python -m quantize_tpu_torch.cli --cfg ... --device cpu     # on the CPU

Builds the config (defaults -> YAML chain -> CLI --opts), sets up logging and
seeding, and executes the configured runner on ``--device`` (``cuda`` unless
given).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence


def setup_cfg(args: argparse.Namespace):
    from .utils import Config

    cfg = Config({
        "seed": -1,
        "output_dir": "results/default",
        "train": {"max_epoch": 1, "print_freq": 10},
    })
    for cfg_file in args.cfg or []:
        cfg.merge_from_yaml(cfg_file)
    if args.output_dir:
        cfg.merge_from_dict({"output_dir": args.output_dir})
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    return cfg


def main(argv: Optional[Sequence[str]] = None) -> None:
    from .runners import execute_runner
    from .utils import Logger, set_random_seed

    parser = argparse.ArgumentParser(description="quantize_tpu_torch")
    parser.add_argument("--cfg", nargs="+", help="config yaml file(s)")
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--opts", nargs="*", default=None, help="k.x=v overrides")
    parser.add_argument("--device", default="cuda", help="torch device to run on (cuda, cpu)")
    args = parser.parse_args(argv)

    cfg = setup_cfg(args)
    logger = Logger(cfg.output_dir)
    logger.dump_config(cfg)
    logger.info("config:\n" + str(cfg))

    if cfg.seed is not None and cfg.seed >= 0:
        set_random_seed(cfg.seed)

    execute_runner(cfg, device=args.device)


if __name__ == "__main__":
    main()
