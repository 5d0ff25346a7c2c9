"""Train / evaluate MonoFlex with the PyTorch port (counterpart of
``monoflex_tpu/cli.py``)::

    python -m monoflex_tpu_torch.cli --config runs/monoflex.yaml [KEY VALUE ...]

or the installed ``monoflex-torch-train`` console script.  The flags are the
JAX CLI's (``engine/defaults.py``).  It runs on a CUDA card and exits
non-zero without one; ``MONOFLEX_PLATFORM=cpu`` runs it on the CPU instead
(gloo between processes).  There is no fallback from the card to the CPU.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .config import DatasetCatalog
from .data.dataset import CachedFlipDataset, KITTIDataset
from .data.loader import collate, make_train_loader
from .decode.postprocessor import PostProcessor
from .engine.defaults import default_argument_parser, default_setup, setup
from .engine.inference import inference, inference_all_depths, to_device
from .engine.launch import launch, on_cpu
from .engine.trainer import do_train
from .losses.loss_computation import LossComputer
from .models.detector import build_model, require_trainable
from .parallel.mesh import wrap_model
from .train.checkpoint import Checkpointer
from .train.solver import build_optimizer
from .train.train_step import make_eval_step, make_train_step
from .utils.dcn_guard import dcn_offset_guard, reroute

# the kernel sources ride along with the Python in the run's source snapshot
BACKUP_EXTS = (".py", ".yaml", ".yml", ".cu", ".cuh")


def build_datasets(cfg, need_train: bool = True):
    test_name = cfg.DATASETS.TEST[0]
    test_root = DatasetCatalog.get(test_name)["args"]["root"]
    eval_ds = KITTIDataset(cfg, test_root, is_train=False)
    if not need_train:
        return eval_ds, eval_ds
    train_name = cfg.DATASETS.TRAIN[0]
    train_root = DatasetCatalog.get(train_name)["args"]["root"]
    if cfg.DATALOADER.CACHE_DATASET:
        train_ds = CachedFlipDataset(cfg, train_root, is_train=True)
    else:
        train_ds = KITTIDataset(cfg, train_root, is_train=True)
    return train_ds, eval_ds


def require_device(num_chips=None) -> None:
    """Exit non-zero unless the run's device is there: the CPU under
    ``MONOFLEX_PLATFORM=cpu``, else as many CUDA cards as local ranks."""
    if on_cpu():
        return
    want = max(1, num_chips or 1)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < want:
        raise SystemExit(f"monoflex_tpu_torch: needs {want} CUDA card(s), found {have} "
                         f"(MONOFLEX_PLATFORM=cpu runs on the CPU)")


def run_device() -> torch.device:
    if on_cpu():
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def main():
    """Parse args and launch the training or evaluation run on every rank."""
    from .cli import _run   # by its module path, so spawned ranks can import it

    args = default_argument_parser().parse_args()
    require_device(args.num_chips)
    launch(_run, args.coordinator_address, args.num_processes, args.process_id,
           args.num_chips, args)


def _run(args):
    """One rank's run; with ``MONOFLEX_TORCH_LAUNCH_LOG`` set, rank 0 writes
    the kernels' launch counts there at its end."""
    from .tools import write_launch_log
    from .utils import comm

    try:
        _train_or_evaluate(args)
    finally:
        if comm.is_main_process():
            write_launch_log()


def _train_or_evaluate(args):
    from .utils import comm

    cfg = setup(args)
    require_trainable(cfg.MODEL.META_ARCHITECTURE)   # the CLI trains and evaluates on KITTI
    logger, seed = default_setup(cfg, args, rank=comm.get_rank())
    if comm.is_initialized():
        logger.info(f"process group {dist.get_backend()}: rank {comm.get_rank()} "
                    f"of {comm.get_world_size()}")

    # every process builds the same initial weights (DDP's broadcast at wrap
    # time makes sure of it again), and the samplers agree on the epoch
    # permutation they rank-stride: one seed for all
    shared_seed = comm.broadcast_object(seed) % (2 ** 31)

    device = run_device()
    model = build_model(cfg, device=device, seed=shared_seed)
    post = PostProcessor(cfg)
    loss_computer = LossComputer(cfg)

    train_ds, eval_ds = build_datasets(cfg, need_train=not args.test)
    steps_per_epoch = max(1, len(train_ds) // cfg.SOLVER.IMS_PER_BATCH)
    # on the unwrapped model: the EMA and the moments keyed by plain names
    optimizer, schedule, _ = build_optimizer(cfg, model, steps_per_epoch)

    checkpointer = Checkpointer(os.path.join(cfg.OUTPUT_DIR, "ckpt"),
                                cfg.SOLVER.LOAD_OPTIMIZER_SCHEDULER)
    ckpt_path = cfg.MODEL.WEIGHT or None
    restored = bool(ckpt_path) or checkpointer.has_checkpoint()
    state, start_iter = checkpointer.load(model, optimizer, ckpt_path)
    if start_iter:
        logger.info(f"resumed from iteration {start_iter}")
    if restored:
        logger.info(f"optimizer count {optimizer.count} after the restore")

    if restored and cfg.TPU.DCN_OFFSET_GUARD != "off":
        # restored weights on bounded-window DCN impls are a measured AP-0
        # trap: scan the learned offsets, warn, and under "auto" reroute
        sample = to_device(collate([train_ds[0]]), device)
        fired, suggestion, _ = dcn_offset_guard(cfg, model, sample, logger=logger)
        if fired and suggestion is not None:
            logger.warning("DCN offset guard (auto): rebuilding model with "
                           f"TPU.DCN_IMPL_PER_STAGE={list(suggestion)}")
            reroute(cfg, model, suggestion)

    eval_step = make_eval_step(model, post)

    if args.test:
        # label-less submission run on DATASETS.TEST_SPLIT (reference:
        # engine/test_net.py:9-35): writes txts, skips AP
        from .engine.test_net import run_test

        if not restored:
            logger.warning(
                "--test with RANDOMLY INITIALIZED weights: no --ckpt given "
                "and no checkpoint found in OUTPUT_DIR; the submission "
                "txts will be garbage")
        run_test(cfg, eval_step, eval_ds, eval_all_depths=args.eval_all_depths, logger=logger,
                 device=device)
        return

    if args.eval:
        out = os.path.join(cfg.OUTPUT_DIR, "inference")
        if args.eval_all_depths:
            inference_all_depths(cfg, eval_step, eval_ds, out, logger=logger, device=device)
        else:
            inference(cfg, eval_step, eval_ds, out, metrics=cfg.TEST.METRIC, logger=logger,
                      model=model, visualize=args.vis, device=device)
        return

    # snapshot the port's source and configs into the run directory
    # (reference: utils/backup_files.py:57-70), on rank 0 only
    if comm.is_main_process():
        from .utils.backup_files import sync_root

        n_backed = sync_root(os.path.dirname(os.path.abspath(__file__)), cfg.OUTPUT_DIR,
                             exts=BACKUP_EXTS)
        logger.info(f"backed up {n_backed} source files to {cfg.OUTPUT_DIR}/backup")

    train_loader = make_train_loader(cfg, train_ds, rank=comm.get_rank(),
                                     world_size=comm.get_world_size(), seed=shared_seed)
    train_model = wrap_model(model, device)
    if train_model is not model:
        logger.info(f"training through {type(train_model).__name__}")
    train_step = make_train_step(train_model, loss_computer, optimizer)
    do_train(cfg, model, train_step, eval_step, state, train_loader, optimizer,
             eval_dataset=eval_ds, schedule=schedule, logger=logger, start_iter=start_iter,
             profile_steps=args.profile, device=device)


if __name__ == "__main__":
    main()
