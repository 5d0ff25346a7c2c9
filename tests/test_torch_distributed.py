"""The port's data parallelism on torch.distributed, on the CPU (gloo).

Two processes, spawned by the port's own launcher (``engine/launch.py``, as
``--num_chips 2`` does under ``MONOFLEX_PLATFORM=cpu``), each take one train
step at batch 2 on their half of a batch of 4 whose objects are split
unevenly (11 against 3, with truncated objects, invisible keypoints and
invalid keypoint depths in both halves), through DistributedDataParallel.
One process takes the same step at batch 4.  The JAX mesh step is one
function of the global batch; so must this be: the global BN statistics
(``models/batchnorm.py``) and the global loss normalisers (``losses/``).

The full-width ``runs/monoflex_ema.yaml`` model at 96x320 from seed 0,
with f32 x in the DCN (pallas3): under bf16 transfer a last-bit change of x
flips its rounding, which the step then amplifies (the chaos the train-step
tests avoid the same way).

Tolerances (float32; the two sides sum in another order, measured against
each other):
- the total, the 11 terms and the log entries: rtol 1e-4, atol 1e-6
  (measured 2e-6 relative at most);
- BN running stats: atol 1e-5 (measured 1.4e-6);
- gradients: relative L2 per parameter 5e-2, the train-step test's bound
  (measured 1.9e-2 at most, in the trunk's BN and conv parameters, which
  train-mode BN couples across the batch); a bias feeding a train-mode BN
  has a zero gradient in exact arithmetic and is held to 1e-4 abs;
- parameters after the AdamW step: as in ``test_torch_train_step.py``, to
  1e-3 of the step where both gradients have the same sign and |g| > 1e-4,
  which must hold for 90% of the elements.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.data.synthetic import make_train_batch
from monoflex_tpu_torch.engine.launch import launch
from monoflex_tpu_torch.engine.trainer import ScalarWriter
from monoflex_tpu_torch.losses.loss_computation import LossComputer
from monoflex_tpu_torch.models.detector import build_model
from monoflex_tpu_torch.parallel.mesh import wrap_model
from monoflex_tpu_torch.train.checkpoint import Checkpointer
from monoflex_tpu_torch.train.solver import build_optimizer
from monoflex_tpu_torch.train.train_step import TrainState, make_train_step
from monoflex_tpu_torch.utils import comm

RUN_YAML = os.path.join(os.path.dirname(__file__), "..", "runs", "monoflex_ema.yaml")
H, W = 96, 320
OBJECTS = (6, 5, 1, 2)          # per image: rank 0 gets 11 objects, rank 1 gets 3
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-6
STATS_ATOL = 1e-5
GRAD_REL_L2 = 5e-2
ZERO_GRAD_ATOL = 1e-4
PARAM_ATOL = 1e-7


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the test workers share the machine's cores, and
    more threads than cores makes each parallel region wait for spinning
    threads of other processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def cfg_f32x():
    cfg = get_cfg_defaults()
    cfg.merge_from_file(RUN_YAML)
    cfg.TPU.DCN_FORCE_IMPL = "pallas3"
    return cfg


def uneven_batch():
    parts = []
    for i, n in enumerate(OBJECTS):
        b = make_train_batch(1, H, W, n_valid=n, seed=10 + i)
        b["trunc_mask"][0, :n:2] = 1.0
        b["keypoints_depth_mask"][0, 1:n, 1] = 0.0
        b["keypoints"][0, :n, 3:5, 2] = 0.0
        parts.append(b)
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def train_once(batch):
    """One train step of the seeded model on ``batch`` (wrapped in DDP when
    a process group is up); its metrics, state dict, gradients and model."""
    cfg = cfg_f32x()
    model = build_model(cfg, device="cpu", seed=0)
    optimizer, _, _ = build_optimizer(cfg, model)
    step = make_train_step(wrap_model(model, "cpu"), LossComputer(cfg), optimizer)
    state, metrics = step(TrainState(), {k: torch.from_numpy(v) for k, v in batch.items()})
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "train_state": (state.step, state.skips)}, model, optimizer


def rank_worker(out_dir):
    """Runs in each spawned rank."""
    rank, world = comm.get_rank(), comm.get_world_size()
    result, model, optimizer = train_once(
        {k: v[2 * rank:2 * rank + 2] for k, v in uneven_batch().items()})
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))

    writer = ScalarWriter(os.path.join(out_dir, "tb"))
    writer.write(1, {"loss": float(rank)})
    writer.close()
    Checkpointer(os.path.join(out_dir, "ckpt")).save(
        f"model_rank{rank}", model, optimizer, TrainState(step=1))

    # the collectives: objects, host reductions, a seed for all, the
    # barrier with its own timeout, device sums and the max's gradient
    comm.coordination_barrier("probe", timeout_s=120)
    x = torch.tensor(float(rank + 1), requires_grad=True)
    top = comm.global_max(x * 3.0)
    top.backward()
    probe = {"world": world,
             "broadcast": comm.broadcast_object({"from": rank}),
             "gathered": comm.all_gather_objects(rank * 10),
             "reduced": comm.reduce_dict({"a": float(rank), "b": 2.0 * rank}, average=False),
             "averaged": comm.reduce_dict({"a": float(rank)}),
             "seed": comm.shared_random_seed(),
             "sum": float(comm.global_sum(torch.tensor([rank + 1.0]))[0]),
             "max": float(top), "max_grad": float(x.grad)}
    with open(os.path.join(out_dir, f"probe{rank}.json"), "w") as f:
        json.dump(probe, f)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("two_ranks")
    saved = {k: os.environ.get(k) for k in ("MONOFLEX_PLATFORM", "OMP_NUM_THREADS")}
    os.environ.update(MONOFLEX_PLATFORM="cpu", OMP_NUM_THREADS="2")   # 1 thread a rank
    try:
        launch(rank_worker, None, None, None, 2, str(out))
    finally:
        for key, value in saved.items():
            if value is None:
                del os.environ[key]
            else:
                os.environ[key] = value
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(2)]
    probes = [json.loads((out / f"probe{r}.json").read_text()) for r in range(2)]
    yield {"dir": out, "ranks": ranks, "probes": probes}
    shutil.rmtree(out, ignore_errors=True)       # full-width checkpoints and states


@pytest.fixture(scope="module")
def one_process():
    return train_once(uneven_batch())[0]


def feeds_train_bn(name):
    """A bias whose output goes straight into a train-mode BN: every DCN
    conv's and the first conv of each edge-fusion stack."""
    return name.endswith(".conv.bias") or (name.startswith("heads.predictor.trunc_")
                                           and name.endswith(".0.bias"))


def test_ranks_agree(two_ranks):
    a, b = two_ranks["ranks"]
    assert a["metrics"] == b["metrics"]
    assert a["train_state"] == b["train_state"] == (1, 0)
    for key, value in a["state"].items():
        assert torch.equal(value, b["state"][key]), key


def test_two_ranks_give_the_global_batch_losses(two_ranks, one_process):
    got, want = two_ranks["ranks"][0]["metrics"], one_process["metrics"]
    assert set(got) == set(want)
    assert len(cfg_f32x().MODEL.HEAD.LOSS_NAMES) == 11
    assert want["skipped"] == 0.0 and want["trunc_offset_loss"] > 0.0
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=key)


def test_two_ranks_give_the_global_batch_statistics(two_ranks, one_process):
    got, want = two_ranks["ranks"][0]["state"], one_process["state"]
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 100
    for key in stats:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=STATS_ATOL,
                                   err_msg=key)


def test_two_ranks_give_the_global_batch_gradients(two_ranks, one_process):
    got, want = two_ranks["ranks"][0]["grads"], one_process["grads"]
    assert set(got) == set(want)
    for name, g in want.items():
        h = got[name]
        if feeds_train_bn(name):
            assert max(g.abs().max(), h.abs().max()) <= ZERO_GRAD_ATOL, name
        elif not g.any():
            assert not h.any(), name
        else:
            err = float((h - g).norm() / g.norm())
            assert err <= GRAD_REL_L2, (name, err)


def test_two_ranks_give_the_global_batch_update(two_ranks, one_process):
    cfg = cfg_f32x()
    before = build_model(cfg, device="cpu", seed=0).state_dict()
    got, want = two_ranks["ranks"][0], one_process
    compared = total = 0
    for name, g in want["grads"].items():
        h = got["grads"][name]
        lr = cfg.SOLVER.BASE_LR * (cfg.SOLVER.BIAS_LR_FACTOR if name.endswith("bias") else 1.0)
        same = (torch.sign(g) == torch.sign(h)) & (torch.minimum(g.abs(), h.abs()) > 1e-4)
        p, q = want["state"][name], got["state"][name]
        assert ((q - p).abs()[same] <= 1e-3 * lr + PARAM_ATOL).all(), name
        assert ((p - before[name]).abs()[same] > 0.9 * lr).all(), name
        compared += int(same.sum())
        total += p.numel()
    assert compared >= 0.9 * total, (compared, total)


def test_writes_are_rank_gated(two_ranks):
    out = two_ranks["dir"]
    lines = (out / "tb" / "scalars.jsonl").read_text().splitlines()
    assert [json.loads(line) for line in lines] == [{"step": 1, "loss": 0.0}]
    ckpt = out / "ckpt"
    # every rank called save; rank 0 wrote its file and the pointer
    assert sorted(os.listdir(ckpt)) == ["last_checkpoint", "model_rank0"]
    assert (ckpt / "last_checkpoint").read_text() == "model_rank0"


def test_collectives(two_ranks):
    p0, p1 = two_ranks["probes"]
    assert p0["world"] == p1["world"] == 2
    assert p0["broadcast"] == p1["broadcast"] == {"from": 0}
    assert p0["gathered"] == p1["gathered"] == [0, 10]
    assert p0["reduced"] == p1["reduced"] == {"a": 1.0, "b": 2.0}
    assert p0["averaged"] == p1["averaged"] == {"a": 0.5}
    assert p0["seed"] == p1["seed"]
    assert p0["sum"] == p1["sum"] == 3.0
    # max(3 * (rank + 1)) = 6 on rank 1, which takes both ranks' gradient
    assert p0["max"] == p1["max"] == 6.0
    assert (p0["max_grad"], p1["max_grad"]) == (0.0, 6.0)


def test_one_process_has_no_group():
    assert not comm.is_initialized()
    assert (comm.get_rank(), comm.get_world_size(), comm.is_main_process()) == (0, 1, True)
    t = torch.tensor([2.0])
    assert comm.global_sum(t) is t and comm.global_max(t) is t
    assert comm.broadcast_object({"x": 1}) == {"x": 1}
    assert comm.all_gather_objects(3) == [3]
    assert comm.reduce_dict({"a": 1.0}) == {"a": 1.0}
    comm.synchronize()
    comm.coordination_barrier("solo")
    model = torch.nn.Linear(2, 2)
    assert wrap_model(model, "cpu") is model
