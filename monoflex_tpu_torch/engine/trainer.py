"""Training orchestration loop (counterpart of
``monoflex_tpu/engine/trainer.py``; reference: engine/trainer.py:61-225).

Iteration-based loop over the infinite loader, metric logging with ETA (the
time and data meters are means over each log window), periodic
checkpointing, periodic evaluation (of the EMA weights when the EMA is on)
with best-model gating on ``Car_3d_0.70/moderate`` (AP R40), and scalar
logging to TensorBoard when it imports (JSONL always), on rank 0.

The parameters, BN stats and moments live in the model and the optimizer,
which the port's ``train_step`` updates in place; the loop moves each
host batch to the device, logs and checkpoints (spans ``trainer.log``,
``trainer.save``, ``trainer.eval`` of ``utils/trace.py``).
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..train.checkpoint import Checkpointer
from ..train.solver import Optimizer, ema_params
from ..train.train_step import TrainState
from ..utils import comm, trace
from ..utils.metric_logger import MetricLogger
from .inference import inference, to_device

DEFAULT_KEY_METRIC = "Car_3d_0.70/moderate"


class ScalarWriter:
    """TensorBoard if ``torch.utils.tensorboard`` imports, JSONL always.

    Writes only on the main process (reference: tools/plain_train_net.py:62);
    other ranks get a no-op writer."""

    def __init__(self, log_dir: str):
        self.enabled = comm.is_main_process()
        self.jsonl = None
        self.tb = None
        if not self.enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(log_dir=log_dir)
        except ImportError:
            pass

    def write(self, step: int, scalars: Dict[str, float], prefix: str = "") -> None:
        if not self.enabled:
            return
        record = {"step": step}
        for k, v in scalars.items():
            key = f"{prefix}{k}"
            record[key] = float(v)
            if self.tb is not None:
                self.tb.add_scalar(key, float(v), step)
        self.jsonl.write(json.dumps(record) + "\n")
        self.jsonl.flush()

    def close(self) -> None:
        if self.jsonl is not None:
            self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


MAX_CONSECUTIVE_SKIPS = 20  # abort if this many steps in a row are non-finite


def _host_metrics(metrics: Dict[str, object]) -> Dict[str, float]:
    """Every metric as a float, with one device-to-host copy."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    values = torch.stack([metrics[k].float() for k in keys]).tolist() if keys else []
    out = {k: float(v) for k, v in metrics.items() if not isinstance(v, torch.Tensor)}
    out.update(zip(keys, values))
    return {k: out[k] for k in metrics}


class _Profile:
    """A torch.profiler trace of ``steps`` steps, written under
    ``output_dir/profile``, with the device's busy time and idle share over
    the traced wall time logged when it stops.  On the card it traces the
    device only: tracing every host op too slows the host-bound step, and
    with it the idle share it measures.  The program's spans
    (``utils/trace.py``) are on for the same steps: every thread's join the
    exported trace as a ``host spans`` process, one row a thread (the
    loader's producer among them), placed by the tracer's anchor on the
    device's timebase; a log line gives the counters, and on the card
    another sums the idle share by the main thread's span open.  A save or
    an evaluation inside the profiled steps shows as ``trainer.save`` or
    ``trainer.eval``."""

    def __init__(self, output_dir: str, steps: int, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        self.dir = os.path.join(output_dir, "profile")
        self.steps = steps
        self.cuda = device.type == "cuda"
        self.prof = profile(activities=[ProfilerActivity.CUDA if self.cuda
                                        else ProfilerActivity.CPU])
        self.prof.start()
        self.t0 = time.perf_counter()
        trace.on()

    def stop(self, logger: logging.Logger) -> None:
        from torch.autograd import DeviceType

        from ..tools.profile_split import busy_ms

        if self.cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        wall_ms = (t1 - self.t0) * 1e3
        self.prof.stop()
        trace.off()
        drained = trace.drain()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"trace_rank{comm.get_rank()}.json")
        self.prof.export_chrome_trace(path)
        add_host_spans(path, drained.spans, drained.anchor, self.t0)
        if drained.counters:
            logger.info(counters_line(drained.counters))
        main = [s for s in drained.spans if s.thread == threading.main_thread().name]
        busy = None
        if self.cuda:
            # device ops in us from the profiler's start
            ops = [(e.name, e.time_range.start, e.time_range.end)
                   for e in self.prof.events() if e.device_type == DeviceType.CUDA]
            busy = busy_ms([(s, e) for _, s, e in ops])
            anchor = drained.anchor
            marker = trace.marker_start(ops, None if anchor is None else (anchor - self.t0) * 1e6)
            if marker is not None and busy:
                def at(t):      # host time t on the ops' clock
                    return marker + (t - anchor) * 1e6

                idle = trace.idle_by_span([(s, e) for _, s, e in ops],
                                          [(s.name, at(s.start), at(s.end)) for s in main],
                                          at(self.t0), at(t1))
                logger.info(idle_line(idle, wall_ms * 1e3))
        logger.info(profile_line(self.steps, path, wall_ms, busy))


def add_host_spans(path: str, spans, anchor: Optional[float], t0: float) -> None:
    """Append ``spans`` (``utils/trace.Span``) to the chrome trace at
    ``path`` as a process named ``host spans``, one row a thread: a span at host
    time t lands at the marker kernel's timestamp + (t - anchor); without a
    marker, at the trace's first timestamp + (t - t0), the profiler's
    start."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    stamped = [e for e in events if isinstance(e.get("ts"), (int, float))]
    if not stamped:
        return
    base, origin = min(e["ts"] for e in stamped), t0
    markers = [e["ts"] for e in stamped if e.get("cat") == "kernel"
               and trace.MARKER in str(e.get("name", ""))]
    if anchor is not None and markers:
        base, origin = min(markers), anchor
    pid = 1 + max((e["pid"] for e in events if isinstance(e.get("pid"), int)), default=0)
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": "host spans"}})
    tids: Dict[str, int] = {}
    for s in spans:
        if s.thread not in tids:
            tids[s.thread] = len(tids)
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tids[s.thread],
                           "args": {"name": s.thread}})
        events.append({"ph": "X", "cat": "host_span", "name": s.name, "pid": pid,
                       "tid": tids[s.thread], "ts": base + (s.start - origin) * 1e6,
                       "dur": (s.end - s.start) * 1e6, "args": {"parent": s.parent}})
    with open(path, "w") as f:
        json.dump(doc, f)


def idle_line(idle: Dict[str, float], wall: float) -> str:
    """The profiled window's idle share by the span open, largest first
    (``idle`` and ``wall`` in one unit)."""
    parts = ", ".join(f"{name} {t / wall:.4f}"
                      for name, t in sorted(idle.items(), key=lambda kv: -kv[1]))
    return f"device idle share by host span: {parts}"


def counters_line(counters: Dict[str, int]) -> str:
    """The profiled steps' counters (``loader.batches``, ``to_device.bytes``)."""
    return "profiled counters: " + ", ".join(f"{k} {v}" for k, v in sorted(counters.items()))


def profile_line(steps: int, trace: str, wall_ms: float, busy_ms: Optional[float]) -> str:
    """The log line of a profiled window (``chip_smoke.py`` reads it).  The
    profiler can drop every device record of a trace on the card: a busy
    time of 0 is reported as lost, not as an idle device."""
    line = f"profiler trace of {steps} steps written to {trace}; wall {wall_ms:.2f} ms"
    if busy_ms == 0.0:
        line += ", the trace holds no device records"
    elif busy_ms is not None:
        line += f", device busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.4f}"
    return line


def do_train(cfg, model: nn.Module, train_step: Callable, eval_step: Optional[Callable],
             state: TrainState, train_loader, optimizer: Optimizer, eval_dataset=None,
             schedule=None, logger: Optional[logging.Logger] = None,
             max_iter: Optional[int] = None, start_iter: int = 0, profile_steps: int = 0,
             device="cuda") -> TrainState:
    """Train from ``start_iter`` to the configured iteration count.
    ``model`` is the unwrapped module that ``train_step`` updates (through
    its DistributedDataParallel wrapper, if any) and ``eval_step`` reads;
    checkpoints hold it, ``optimizer`` (with its EMA) and ``state``."""
    logger = logger or logging.getLogger("monoflex.trainer")
    device = torch.device(device)
    output_dir = cfg.OUTPUT_DIR
    writer = ScalarWriter(os.path.join(output_dir, "tensorboard"))
    checkpointer = Checkpointer(os.path.join(output_dir, "ckpt"),
                                cfg.SOLVER.LOAD_OPTIMIZER_SCHEDULER)
    ema = optimizer.ema

    steps_per_epoch = max(1, len(train_loader.dataset) // cfg.SOLVER.IMS_PER_BATCH)
    if max_iter is None:
        if cfg.SOLVER.EVAL_AND_SAVE_EPOCH:
            max_iter = cfg.SOLVER.MAX_EPOCHS * steps_per_epoch
            eval_interval = cfg.SOLVER.EVAL_EPOCH_INTERVAL * steps_per_epoch
            save_interval = cfg.SOLVER.SAVE_CHECKPOINT_EPOCH_INTERVAL * steps_per_epoch
        else:
            max_iter = cfg.SOLVER.MAX_ITERATION
            eval_interval = cfg.SOLVER.EVAL_INTERVAL
            save_interval = cfg.SOLVER.SAVE_CHECKPOINT_INTERVAL
    else:
        eval_interval = cfg.SOLVER.EVAL_INTERVAL
        save_interval = cfg.SOLVER.SAVE_CHECKPOINT_INTERVAL

    meters = MetricLogger()
    best_ap = -1.0
    iteration = start_iter
    last_log_iter = start_iter
    data_iter = iter(train_loader)
    logger.info(f"start training: {max_iter} iterations "
                f"({steps_per_epoch} steps/epoch)")
    profile = None
    end = time.time()
    end_window = end
    data_window = 0.0      # data seconds of the iterations since the last log point

    while iteration < max_iter:
        batch = to_device(next(data_iter), device)
        data_window += time.time() - end
        state, metrics = train_step(state, batch)
        iteration += 1

        # the trace covers the first steady steps: the ones after this
        # process's first, which autotunes cuDNN and warms the allocator
        if profile_steps > 0 and iteration - start_iter == 1:
            profile = _Profile(output_dir, profile_steps, device)
        elif profile is not None and iteration - start_iter == 1 + profile_steps:
            profile.stop(logger)
            profile = None

        if iteration % 10 == 0 or iteration == max_iter:
            with trace.span("trainer.log"):
                metrics = _host_metrics(metrics)
                # the step's own counter: exact however rarely the host reads it
                consecutive_skips = int(metrics.get("consecutive_skips", 0.0))
                if consecutive_skips >= MAX_CONSECUTIVE_SKIPS:
                    logger.error(
                        f"aborting: {consecutive_skips} consecutive non-finite "
                        f"steps (bad data or diverged optimizer)")
                    checkpointer.save("model_aborted", model, optimizer, state)
                    writer.close()
                    return state
                # time and data: means over the iterations since the last log point
                window = max(1, iteration - last_log_iter)
                batch_time = (time.time() - end_window) / window
                last_log_iter = iteration
                end_window = time.time()
                meters.update(time=batch_time, data=data_window / window, **metrics)
                data_window = 0.0
                eta = datetime.timedelta(
                    seconds=int(meters.meters["time"].global_avg * (max_iter - iteration)))
                lr = float(schedule(iteration)) if schedule is not None else float("nan")
                logger.info(f"iter {iteration}/{max_iter}  eta: {eta}  {meters}  lr: {lr:.6f}")
                writer.write(iteration, metrics, prefix="train/")
                if schedule is not None:
                    writer.write(iteration, {"lr": lr})

        if iteration % save_interval == 0 and iteration != max_iter:
            t_save = time.time()
            with trace.span("trainer.save"):
                checkpointer.save(f"model_checkpoint_{iteration}", model, optimizer, state)
            logger.info(f"saved model_checkpoint_{iteration} in {time.time() - t_save:.3f} s")

        if eval_dataset is not None and iteration % eval_interval == 0:
            logger.info(f"evaluating at iteration {iteration}")
            # with the EMA on, evaluate (and best-checkpoint) the averaged
            # weights; the raw ones come back for training after
            with trace.span("trainer.eval"), ema_params(model, ema):
                results = inference(cfg, eval_step, eval_dataset,
                                    os.path.join(output_dir, f"eval_{iteration}"),
                                    metrics=cfg.TEST.METRIC, logger=logger, device=device)
                # ranks other than 0 have no AP; every rank enters the save
                results = comm.broadcast_object(results)
                writer.write(iteration, {k: v for k, v in results.items()
                                         if isinstance(v, (int, float))}, prefix="eval/")
                key_ap = results.get(DEFAULT_KEY_METRIC, None)
                if key_ap is not None and key_ap >= best_ap:
                    best_ap = key_ap
                    # the weights that were evaluated, so --eval --ckpt <best>
                    # reproduces the gated metric
                    checkpointer.save(f"model_moderate_best_{cfg.MODEL.HEAD.OUTPUT_DEPTH}",
                                      model, optimizer, state, tag_last=False)
                    logger.info(f"new best {DEFAULT_KEY_METRIC}: {best_ap:.4f}")
        # the next iteration's data time starts here: the log, the save and
        # the evaluation are no wait for data
        end = time.time()

    if profile is not None:
        profile.stop(logger)
    checkpointer.save("model_final", model, optimizer, state)
    # with the EMA on, the logged eval metrics come from the averaged
    # weights; they ship as their own artifact (model_final stays the raw
    # resume point)
    if ema is not None:
        with ema_params(model, ema):
            checkpointer.save("model_final_ema", model, optimizer, state, tag_last=False)
    writer.close()
    logger.info(f"training done; best {DEFAULT_KEY_METRIC}: {best_ap:.4f}")
    return state
