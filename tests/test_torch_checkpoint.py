"""The port's checkpoints (``train/checkpoint.py``) and the optimizer's and
EMA's state (``train/solver.py``), on the CPU.

``runs/monoflex_ema.yaml`` (AdamW with the parameter EMA) at 96x320,
batch 2, on the narrow model of ``test_torch_slice.py`` from a seed, fed
seeded batches.  A checkpoint must restore the run exactly: a save/load
round trip gives back every weight, BN buffer, moment, the optimizer's
count and the EMA, bit for bit, and 2 iterations, a save, a load into a
fresh model and 2 more iterations give the run of 4 iterations bit for bit
(CPU kernels are deterministic).
"""

import os

import numpy as np
import pytest
import torch

from monoflex_tpu_torch.data.synthetic import make_train_batch
from monoflex_tpu_torch.engine.trainer import do_train
from monoflex_tpu_torch.losses.loss_computation import LossComputer
from monoflex_tpu_torch.models.detector import init_parameters
from monoflex_tpu_torch.train.checkpoint import LAST_CHECKPOINT_FILE, Checkpointer
from monoflex_tpu_torch.train.solver import build_optimizer, ema_params
from monoflex_tpu_torch.train.train_step import TrainState, make_train_step
from test_torch_slice import narrow_cfg, port_narrow_model

ROOT = os.path.join(os.path.dirname(__file__), "..")
H, W, B = 96, 320, 2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the test workers share the machine's cores, and
    more threads than cores makes each parallel region wait for spinning
    threads of other processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def ema_cfg(out_dir, **solver):
    cfg = narrow_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "runs", "monoflex_ema.yaml"))
    cfg.SOLVER.EVAL_AND_SAVE_EPOCH = False
    cfg.SOLVER.SAVE_CHECKPOINT_INTERVAL = 1000
    cfg.OUTPUT_DIR = str(out_dir)
    for key, value in solver.items():
        setattr(cfg.SOLVER, key, value)
    return cfg


def narrow_model(cfg, seed=0):
    model = port_narrow_model(cfg)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model


def batches(n):
    return [{k: torch.from_numpy(v) for k, v in make_train_batch(B, H, W, seed=s).items()}
            for s in range(n)]


class ListLoader:
    """Numpy batches in order, forever; ``dataset`` sizes an epoch."""

    def __init__(self, batches):
        self.batches = [{k: v.numpy() for k, v in b.items()} for b in batches]
        self.dataset = list(range(64))

    def __iter__(self):
        while True:
            yield from self.batches


def run(cfg, n_steps, seed=0):
    """A model of ``cfg`` after ``n_steps`` train steps, its optimizer and state."""
    model = narrow_model(cfg, seed=seed)
    optimizer, _, _ = build_optimizer(cfg, model)
    step = make_train_step(model, LossComputer(cfg), optimizer)
    state = TrainState()
    for batch in batches(n_steps):
        state, _ = step(state, batch)
    return model, optimizer, state


def assert_same_run(model_a, opt_a, model_b, opt_b):
    for key, value in model_a.state_dict().items():
        assert torch.equal(model_b.state_dict()[key], value), key
    assert opt_a.count == opt_b.count
    inner_a, inner_b = opt_a.inner.state_dict(), opt_b.inner.state_dict()
    assert inner_a["param_groups"] == inner_b["param_groups"]
    assert inner_a["state"].keys() == inner_b["state"].keys()
    for pid, moments in inner_a["state"].items():
        for key, value in moments.items():
            assert torch.equal(inner_b["state"][pid][key], value), (pid, key)
    assert opt_a.ema.count == opt_b.ema.count
    for name, value in opt_a.ema.shadow.items():
        assert torch.equal(opt_b.ema.shadow[name], value), name


def test_round_trip_is_exact(tmp_path):
    cfg = ema_cfg(tmp_path)
    model, optimizer, state = run(cfg, 2)
    state = TrainState(step=state.step + 3, skips=1)
    ckpt = Checkpointer(os.path.join(tmp_path, "ckpt"))
    ckpt.save("model_checkpoint_5", model, optimizer, state)
    assert ckpt.has_checkpoint()
    assert ckpt.get_checkpoint_file().endswith("model_checkpoint_5")

    fresh = narrow_model(cfg, seed=7)
    fresh_opt, _, _ = build_optimizer(cfg, fresh)
    loaded, start = ckpt.load(fresh, fresh_opt)
    assert loaded == state and start == 5
    assert_same_run(model, optimizer, fresh, fresh_opt)
    assert optimizer.count == 2 and fresh_opt.ema.count == 2
    # BN buffers moved in training, and came back with the weights
    assert any(k.endswith("num_batches_tracked") and int(v) == 2
               for k, v in fresh.state_dict().items())


def test_checkpoint_holds_only_tensors_and_plain_values(tmp_path):
    cfg = ema_cfg(tmp_path)
    model, optimizer, state = run(cfg, 1)
    path = Checkpointer(tmp_path).save("model_final", model, optimizer, state)
    ckpt = torch.load(path, weights_only=True)   # raises on anything else
    assert sorted(ckpt) == ["model", "optimizer", "state"]
    assert ckpt["state"] == {"step": 1, "skips": 0}
    assert sorted(ckpt["optimizer"]) == ["count", "ema", "inner"]
    assert not any(k.startswith("module.") for k in ckpt["model"])
    assert not any(k.startswith("module.") for k in ckpt["optimizer"]["ema"]["shadow"])


def test_weights_only_without_optimizer_scheduler(tmp_path):
    cfg = ema_cfg(tmp_path)
    model, optimizer, state = run(cfg, 2)
    Checkpointer(tmp_path).save("model_final", model, optimizer, state)

    fresh = narrow_model(cfg, seed=7)
    fresh_opt, _, _ = build_optimizer(cfg, fresh)
    shadow = {k: v.clone() for k, v in fresh_opt.ema.shadow.items()}
    loaded, start = Checkpointer(tmp_path, load_optimizer_scheduler=False).load(fresh, fresh_opt)
    assert loaded == TrainState() and start == 0
    for key, value in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key
    assert fresh_opt.count == 0 and fresh_opt.inner.state_dict()["state"] == {}
    assert fresh_opt.ema.count == 0
    for name, value in shadow.items():
        assert torch.equal(fresh_opt.ema.shadow[name], value), name


@pytest.mark.parametrize("saved_ema, loaded_ema", [(0.999, 0.0), (0.0, 0.999)])
def test_ema_mismatch_falls_back_to_weights(tmp_path, saved_ema, loaded_ema):
    """A run saved with another SOLVER.EMA_DECAY (EMA on one side only):
    weights and BN stats, iteration 0, the optimizer untouched."""
    model, optimizer, state = run(ema_cfg(tmp_path, EMA_DECAY=saved_ema), 1)
    Checkpointer(tmp_path).save("model_final", model, optimizer, state)

    cfg = ema_cfg(tmp_path, EMA_DECAY=loaded_ema)
    fresh = narrow_model(cfg, seed=7)
    fresh_opt, _, ema = build_optimizer(cfg, fresh)
    assert (ema is None) == (loaded_ema == 0.0)
    loaded, start = Checkpointer(tmp_path).load(fresh, fresh_opt)
    assert loaded == TrainState() and start == 0
    for key, value in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key
    assert fresh_opt.count == 0 and fresh_opt.inner.state_dict()["state"] == {}


def test_no_checkpoint_starts_fresh(tmp_path):
    cfg = ema_cfg(tmp_path)
    model = narrow_model(cfg, seed=0)
    optimizer, _, _ = build_optimizer(cfg, model)
    ckpt = Checkpointer(os.path.join(tmp_path, "ckpt"))
    assert not ckpt.has_checkpoint() and ckpt.get_checkpoint_file() is None
    assert ckpt.load(model, optimizer) == (TrainState(), 0)


def test_ema_params_swap_and_restore_exactly(tmp_path):
    cfg = ema_cfg(tmp_path)
    model, optimizer, _ = run(cfg, 2)
    raw = {n: p.detach().clone() for n, p in model.named_parameters()}
    with ema_params(model, optimizer.ema) as swapped:
        assert swapped is model
        for name, p in model.named_parameters():
            assert torch.equal(p, optimizer.ema.shadow[name]), name
    for name, p in model.named_parameters():
        assert torch.equal(p, raw[name]), name
    assert any(not torch.equal(raw[n], s) for n, s in optimizer.ema.shadow.items())
    with ema_params(model, None):
        pass
    for name, p in model.named_parameters():
        assert torch.equal(p, raw[name]), name


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """do_train for 2 iterations, model_final, a fresh model resumed from
    last_checkpoint for 2 more: bit-equal to do_train for 4."""
    feed = batches(4)
    runs = {}
    for label, max_iter in (("whole", 4), ("first", 2)):
        cfg = ema_cfg(os.path.join(tmp_path, label))
        model = narrow_model(cfg, seed=0)
        optimizer, schedule, _ = build_optimizer(cfg, model)
        step = make_train_step(model, LossComputer(cfg), optimizer)
        state = do_train(cfg, model, step, None, TrainState(), ListLoader(feed), optimizer,
                         schedule=schedule, max_iter=max_iter, device="cpu")
        runs[label] = (model, optimizer, state)

    cfg = ema_cfg(os.path.join(tmp_path, "first"))
    ckpt = Checkpointer(os.path.join(cfg.OUTPUT_DIR, "ckpt"))
    with open(os.path.join(ckpt.save_dir, LAST_CHECKPOINT_FILE)) as f:
        assert f.read() == "model_final"
    model = narrow_model(cfg, seed=3)
    optimizer, schedule, _ = build_optimizer(cfg, model)
    state, start = ckpt.load(model, optimizer)
    assert start == 2 and optimizer.count == 2
    step = make_train_step(model, LossComputer(cfg), optimizer)
    state = do_train(cfg, model, step, None, state, ListLoader(feed[2:]), optimizer,
                     schedule=schedule, max_iter=4, start_iter=start, device="cpu")
    whole_model, whole_opt, whole_state = runs["whole"]
    assert state == whole_state == TrainState(step=4, skips=0)
    assert_same_run(whole_model, whole_opt, model, optimizer)
    assert not np.array_equal(whole_model.state_dict()["backbone.base.base_layer.0.weight"],
                              runs["first"][0].state_dict()["backbone.base.base_layer.0.weight"])
