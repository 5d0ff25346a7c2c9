"""The port's training loop (``engine/trainer.py::do_train``) against the
JAX package's ``do_train``, and its guards.

Both loops train the narrow model of ``test_torch_slice.py`` (the train-step
test's conditioned weights, made on the port, sent to flax by the JAX
package's importer and back into the port by ``utils/param_bridge.py``)
under ``runs/monoflex.yaml`` with the parameter EMA of
``runs/monoflex_ema.yaml``, for 3 iterations at 96x320, batch 2, on a
1/4-scale synthetic KITTI tree read by each package's own dataset and
loader with the same sampler seed (flip augmentation off: its RNG is not
seeded).  A checkpoint every 2 iterations.  The JAX step runs the clamped
DCN as the XLA shift op, the port its autograd Function (the plain op on
the CPU).

Both loops run at SOLVER.BASE_LR 1e-6, not the recipe's 3e-4.  The first
AdamW steps move each element by about lr * factor * sign(g), and the two
sides' float32 gradients of the trunk differ by 1-3% (the step test), so
wherever an element's gradient is small its sign, and its step, differ;
train-mode BN over 2 images then carries the difference through the net.
Measured at 3e-4: the terms of iteration 2 differ by up to 1.3%, of
iteration 3 by up to 6% (dims_loss), though the two loops read the same
batches, bit for bit, and iteration 1 agrees to 6e-5.  At 1e-6: 2.7e-4.

Tolerances.  The batches of every iteration: equal.  The logged terms of
iteration 3: rtol 2e-3, atol 1e-6 (measured 2.7e-4 at most; the step
test's 1e-4 is not met after 3 iterations, nor by every log entry of one
step on these batches: center_MAE read 1.6e-4 at one thread count, a ratio
of keypoint heights near 0 at random weights).  Parameters after 3 steps,
in units of one step (lr * factor): 99% of the elements within 0.1 of each
other (measured 99.4%; 82% within 0.01), every element within 3 steps of
2.5 (AdamW moves an element by at most about 2.3 steps a step with these
betas; measured 5.7 at most), and 90% of the elements moved by more than
half a step (measured 93%; the rest have gradients near 0).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoflex_tpu.data.dataset import KITTIDataset as JaxKITTIDataset
from monoflex_tpu.data.loader import make_train_loader as jax_make_train_loader
from monoflex_tpu.engine.trainer import do_train as jax_do_train
from monoflex_tpu.losses.loss_computation import LossComputer as JaxLossComputer
from monoflex_tpu.train.solver import build_optimizer as jax_build_optimizer
from monoflex_tpu.train.train_step import TrainState as JaxTrainState
from monoflex_tpu.train.train_step import make_train_step as jax_make_train_step
from monoflex_tpu.utils.weight_import import flatten_params
from monoflex_tpu_torch.data.dataset import KITTIDataset
from monoflex_tpu_torch.data.loader import make_train_loader
from monoflex_tpu_torch.data.synthetic import make_synthetic_kitti, make_train_batch
from monoflex_tpu_torch.decode.postprocessor import PostProcessor
from monoflex_tpu_torch.engine import trainer as trainer_mod
from monoflex_tpu_torch.engine.trainer import ScalarWriter, do_train
from monoflex_tpu_torch.losses.loss_computation import LossComputer
from monoflex_tpu_torch.train.checkpoint import Checkpointer
from monoflex_tpu_torch.train.solver import build_optimizer
from monoflex_tpu_torch.train.train_step import TrainState, make_eval_step, make_train_step
from monoflex_tpu_torch.utils import comm
from monoflex_tpu_torch.utils.param_bridge import load_flax_variables
from test_torch_slice import jax_narrow_model, narrow_cfg, port_narrow_model, to_flax
from test_torch_train_step import conditioned_model, flax_layout

ROOT = os.path.join(os.path.dirname(__file__), "..")
H, W, B = 96, 320, 2
ITERS = 3
SEED = 5
LR = 1e-6
TERMS_RTOL, TERMS_ATOL = 2e-3, 1e-6
AGREE_SHARE = 0.99
AGREE_OF_STEP = 0.1
MOVED_SHARE = 0.9
MAX_STEP_FACTOR = 2.5


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the test workers share the machine's cores, and
    more threads than cores makes each parallel region wait for spinning
    threads of other processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def trainer_cfg(out_dir):
    cfg = narrow_cfg("pallas3")
    cfg.SOLVER.EMA_DECAY = 0.999           # runs/monoflex_ema.yaml's
    cfg.SOLVER.BASE_LR = LR
    cfg.INPUT.HEIGHT_TRAIN, cfg.INPUT.WIDTH_TRAIN = H, W
    cfg.INPUT.HEIGHT_TEST, cfg.INPUT.WIDTH_TEST = H, W
    cfg.SOLVER.IMS_PER_BATCH = B
    cfg.SOLVER.EVAL_AND_SAVE_EPOCH = False
    cfg.SOLVER.SAVE_CHECKPOINT_INTERVAL = 2
    cfg.SOLVER.EVAL_INTERVAL = 1000
    cfg.DATALOADER.NUM_WORKERS = 2
    cfg.OUTPUT_DIR = str(out_dir)
    return cfg


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_synthetic_kitti(str(tmp_path_factory.mktemp("kitti") / "training"), scale=4)


def last_record(out_dir):
    with open(os.path.join(out_dir, "tensorboard", "scalars.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return [r for r in records if any(k.startswith("train/") for k in r)][-1]


@pytest.fixture(scope="module")
def both_loops(tree, tmp_path_factory):
    out = tmp_path_factory.mktemp("loops")
    cfg = trainer_cfg(out / "port")
    params, stats = to_flax(conditioned_model(cfg), cfg)

    model = port_narrow_model(cfg)
    load_flax_variables(model, params, stats, cfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    dataset = KITTIDataset(cfg, tree, is_train=True, augment=False)
    optimizer, schedule, _ = build_optimizer(cfg, model, len(dataset) // B)
    step = make_train_step(model, LossComputer(cfg), optimizer)
    batches = {"port": [], "jax": []}

    def port_step(state, batch):
        batches["port"].append({k: v.numpy().copy() for k, v in batch.items()})
        return step(state, batch)

    state = do_train(cfg, model, port_step, None, TrainState(),
                     make_train_loader(cfg, dataset, seed=SEED), optimizer, schedule=schedule,
                     max_iter=ITERS, device="cpu")

    jcfg = trainer_cfg(out / "jax")
    jdataset = JaxKITTIDataset(jcfg, tree, is_train=True, augment=False)
    tx, jschedule = jax_build_optimizer(jcfg, params, len(jdataset) // B)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                           opt_state=tx.init(params), skips=jnp.zeros((), jnp.int32))
    jitted = jax.jit(jax_make_train_step(jax_narrow_model(jcfg), JaxLossComputer(jcfg), tx))

    def jstep(state, batch):
        batches["jax"].append({k: np.asarray(v) for k, v in batch.items()})
        return jitted(state, batch)

    jstate = jax_do_train(jcfg, None, jstep, None, jstate,
                          jax_make_train_loader(jcfg, jdataset, seed=SEED),
                          schedule=jschedule, max_iter=ITERS)
    return dict(cfg=cfg, out=out, model=model, optimizer=optimizer, state=state, before=before,
                jax_state=jstate, batches=batches)


def test_loops_read_the_same_batches(both_loops):
    port, jax_batches = both_loops["batches"]["port"], both_loops["batches"]["jax"]
    assert len(port) == len(jax_batches) == ITERS
    for i, (got, want) in enumerate(zip(port, jax_batches)):
        assert set(got) == set(want)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=f"iteration {i + 1} {key}")
    assert not np.array_equal(port[0]["image"], port[1]["image"])


def test_logged_terms_match_jax(both_loops):
    got = last_record(both_loops["out"] / "port")
    want = last_record(both_loops["out"] / "jax")
    assert got["step"] == want["step"] == ITERS
    assert set(got) == set(want)
    names = both_loops["cfg"].MODEL.HEAD.LOSS_NAMES
    assert len(names) == 11 and all(f"train/{k}" in got for k in names)
    assert got["train/skipped"] == 0.0
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=TERMS_RTOL, atol=TERMS_ATOL, err_msg=key)


def test_parameters_match_jax(both_loops):
    cfg = both_loops["cfg"]
    model = both_loops["model"]
    got = flax_layout({n: p.detach().numpy() for n, p in model.named_parameters()}, cfg)
    want = flatten_params(both_loops["jax_state"].params)
    before = flax_layout({n: v.numpy() for n, v in both_loops["before"].items()}, cfg)
    assert set(got) == set(want)
    agree = moved = total = 0
    for path, p in want.items():
        p = np.asarray(p)
        lr = cfg.SOLVER.BASE_LR * (cfg.SOLVER.BIAS_LR_FACTOR if path.endswith("bias") else 1.0)
        err = np.abs(got[path] - p)
        assert err.max() <= ITERS * MAX_STEP_FACTOR * lr, (path, err.max())
        agree += int((err <= AGREE_OF_STEP * lr).sum())
        moved += int((np.abs(p - before[path]) > 0.5 * lr).sum())
        total += p.size
    assert agree >= AGREE_SHARE * total, (agree, total)
    assert moved >= MOVED_SHARE * total, (moved, total)


def test_same_checkpoint_names_as_jax(both_loops):
    out = both_loops["out"]
    names = sorted(os.listdir(out / "port" / "ckpt"))
    assert names == sorted(os.listdir(out / "jax" / "ckpt"))
    assert names == ["last_checkpoint", "model_checkpoint_2", "model_final", "model_final_ema"]
    for pointer in ("port", "jax"):
        assert (out / pointer / "ckpt" / "last_checkpoint").read_text() == "model_final"
    assert both_loops["state"] == TrainState(step=ITERS, skips=0)
    assert both_loops["optimizer"].count == ITERS == int(both_loops["jax_state"].step)


class ListLoader:
    def __init__(self, batches, dataset_len=64):
        self.batches = batches
        self.dataset = list(range(dataset_len))

    def __iter__(self):
        while True:
            yield from self.batches


def narrow_model_and_step(cfg):
    model = conditioned_model(cfg)
    optimizer, schedule, _ = build_optimizer(cfg, model, steps_per_epoch=10)
    return model, optimizer, schedule, make_train_step(model, LossComputer(cfg), optimizer)


def test_nan_storm_aborts_at_the_true_threshold(tmp_path):
    """Every step non-finite: the step's own skip counter ends the run at
    MAX_CONSECUTIVE_SKIPS (a multiple of the 10-step log cadence), with
    model_aborted saved and no parameter moved."""
    cfg = trainer_cfg(tmp_path)
    cfg.SOLVER.SAVE_CHECKPOINT_INTERVAL = 10_000
    model, optimizer, schedule, step = narrow_model_and_step(cfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    bad = make_train_batch(B, H, W)
    bad["dimensions"] = np.full_like(bad["dimensions"], np.nan)
    state = do_train(cfg, model, step, None, TrainState(), ListLoader([bad]), optimizer,
                     schedule=schedule, max_iter=500, device="cpu")
    assert state == TrainState(step=trainer_mod.MAX_CONSECUTIVE_SKIPS,
                               skips=trainer_mod.MAX_CONSECUTIVE_SKIPS)
    assert os.path.isfile(os.path.join(cfg.OUTPUT_DIR, "ckpt", "model_aborted"))
    assert optimizer.count == 0
    for name, p in model.named_parameters():
        assert torch.equal(p, before[name]), name


def test_skip_counter_resets_on_a_finite_step(tmp_path):
    cfg = trainer_cfg(tmp_path)
    _, _, _, step = narrow_model_and_step(cfg)
    good = {k: torch.from_numpy(v) for k, v in make_train_batch(B, H, W).items()}
    bad = dict(good, dimensions=torch.full_like(good["dimensions"], float("nan")))
    state = TrainState()
    for _ in range(2):
        state, metrics = step(state, bad)
    assert state.skips == 2 and metrics["consecutive_skips"] == 2.0
    state, metrics = step(state, good)
    assert state == TrainState(step=3, skips=0) and metrics["skipped"] == 0.0


def test_writer_and_checkpointer_rank_gated(tmp_path, monkeypatch):
    monkeypatch.setattr(comm, "is_main_process", lambda: False)
    log_dir = os.path.join(tmp_path, "tb")
    writer = ScalarWriter(log_dir)
    writer.write(1, {"loss": 1.0})
    writer.close()
    assert not os.path.exists(os.path.join(log_dir, "scalars.jsonl"))

    cfg = trainer_cfg(tmp_path)
    model, optimizer, _, _ = narrow_model_and_step(cfg)
    ckpt_dir = os.path.join(tmp_path, "ckpt")
    Checkpointer(ckpt_dir).save("model_x", model, optimizer, TrainState())
    assert os.listdir(ckpt_dir) == []


def test_ema_eval_and_saves(tree, tmp_path):
    """Under runs/monoflex_ema.yaml the periodic eval runs on the EMA
    weights, the best-gated save holds the weights evaluated, model_final
    the raw ones and model_final_ema the EMA; the raw weights come back bit
    for bit after the eval."""
    cfg = trainer_cfg(tmp_path)
    cfg.merge_from_file(os.path.join(ROOT, "runs", "monoflex_ema.yaml"))
    cfg.SOLVER.EVAL_INTERVAL = 2
    cfg.SOLVER.SAVE_CHECKPOINT_INTERVAL = 10_000
    cfg.TEST.IMS_PER_BATCH = B
    assert cfg.SOLVER.EMA_DECAY == 0.999
    model, optimizer, schedule, step = narrow_model_and_step(cfg)
    ema = optimizer.ema
    raw_after_step, seen = {}, []

    def train_step(state, batch):
        out = step(state, batch)
        raw_after_step.update({n: p.detach().clone() for n, p in model.named_parameters()})
        return out

    real_eval = make_eval_step(model, PostProcessor(cfg))

    def eval_step(batch, output_depth=None):
        seen.append(all(torch.equal(p, ema.shadow[n]) for n, p in model.named_parameters()))
        return real_eval(batch, output_depth=output_depth)

    feed = [make_train_batch(B, H, W, seed=s) for s in range(2)]
    eval_ds = KITTIDataset(cfg, tree, is_train=False)
    do_train(cfg, model, train_step, eval_step, TrainState(), ListLoader(feed), optimizer,
             eval_dataset=eval_ds, schedule=schedule, max_iter=2, device="cpu")
    assert seen and all(seen)
    for name, p in model.named_parameters():
        assert torch.equal(p, raw_after_step[name]), name
    assert any(not torch.equal(raw_after_step[n], s) for n, s in ema.shadow.items())

    ckpt = os.path.join(cfg.OUTPUT_DIR, "ckpt")
    assert sorted(os.listdir(ckpt)) == ["last_checkpoint", "model_final", "model_final_ema",
                                        "model_moderate_best_soft"]
    want = {"model_final": raw_after_step, "model_final_ema": ema.shadow,
            "model_moderate_best_soft": ema.shadow}
    for name, params in want.items():
        saved = torch.load(os.path.join(ckpt, name), weights_only=True)["model"]
        for key, value in params.items():
            assert torch.equal(saved[key], value), (name, key)
    assert len(os.listdir(os.path.join(cfg.OUTPUT_DIR, "eval_2", "data"))) == 3
    record = [json.loads(line) for line in
              open(os.path.join(cfg.OUTPUT_DIR, "tensorboard", "scalars.jsonl"))]
    assert any("eval/Car_3d_0.70/moderate" in r for r in record)
