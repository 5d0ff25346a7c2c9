"""CLI argument parsing + run setup (counterpart of
``monoflex_tpu/engine/defaults.py``; reference: engine/defaults.py:15-88):
the same flags and the same ``opts`` remainder."""

from __future__ import annotations

import argparse
import os

from ..utils.envs import collect_env_info, seed_all_rng
from ..utils.logger import setup_logger


def default_argument_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="monoflex_tpu_torch training")
    parser.add_argument("--config-file", "--config", default="runs/monoflex.yaml",
                        metavar="FILE", dest="config_file")
    parser.add_argument("--eval", action="store_true", help="evaluate only")
    parser.add_argument("--eval_all_depths", action="store_true",
                        help="sweep all depth-ensemble methods at eval")
    parser.add_argument("--test", action="store_true", help="run on the test split")
    parser.add_argument("--ckpt", default=None, help="checkpoint to load")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--num_work", type=int, default=None)
    parser.add_argument("--output", default=None)
    parser.add_argument("--vis", action="store_true", help="visualize predictions")
    parser.add_argument("--num_chips", type=int, default=None,
                        help="spawn N local ranks, one per card")
    parser.add_argument("--profile", type=int, default=0, metavar="N",
                        help="capture a torch.profiler trace of the N steps after the "
                             "first (OUTPUT_DIR/profile) with the host spans of every "
                             "thread, and log the device's idle share by span")
    # multi-host flags (engine/launch.py): each host runs this CLI once and
    # the processes meet at the coordinator (tcp://)
    parser.add_argument("--num_processes", type=int, default=None,
                        help="total number of host processes")
    parser.add_argument("--process_id", type=int, default=None,
                        help="this host's process index [0, num_processes)")
    parser.add_argument("--coordinator_address", default=None,
                        help="host:port of process 0 for torch.distributed")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="config overrides: KEY VALUE [KEY VALUE ...]")
    return parser


def setup(args):
    from ..config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.merge_from_file(args.config_file)
    if getattr(args, "test", False):
        # submission mode: label-less test split (reference:
        # tools/plain_train_net.py:104-106). Applied BEFORE the opts merge
        # so explicit KEY VALUE overrides still win.
        cfg.DATASETS.TEST_SPLIT = "test"
        cfg.DATASETS.TEST = ("kitti_test",)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if args.batch_size is not None:
        cfg.SOLVER.IMS_PER_BATCH = args.batch_size
    if args.num_work is not None:
        cfg.DATALOADER.NUM_WORKERS = args.num_work
    if args.output is not None:
        cfg.OUTPUT_DIR = args.output
    if args.ckpt is not None:
        cfg.MODEL.WEIGHT = args.ckpt
    return cfg


def default_setup(cfg, args, rank: int = 0):
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    logger = setup_logger("monoflex", cfg.OUTPUT_DIR, rank=rank)
    logger.info("environment:\n" + collect_env_info())
    logger.info(f"command line args: {args}")
    logger.info("running with config:\n" + cfg.dump())
    seed = seed_all_rng(None if cfg.SEED < 0 else cfg.SEED + rank)
    logger.info(f"seed: {seed}")
    return logger, seed
