"""Data parallelism under the bf16 model: two gloo ranks, spawned by the
port's launcher as ``--num_chips 2`` spawns them under
``MONOFLEX_PLATFORM=cpu``, each take one train step of ``runs/monoflex_bf16.yaml``
(32-wide heads, 64x128) through DistributedDataParallel on their half of a
batch of 4.  The global batch statistics reduce f32 sums of bf16 activations
(``models/batchnorm.py``), DDP reduces the f32 gradients, and the metrics are
all-reduced: so both ranks must report the same 11 finite terms and end
with the same parameters and BN buffers, bit for bit, and the step must not
be skipped.  (A comparison with one process at batch 4 does not hold under
bf16: the ranks sum in another order, and a train-mode bf16 step is chaotic,
``test_torch_bf16_step.py``.)"""

import os
import shutil

import numpy as np
import pytest
import torch

from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.data.synthetic import make_train_batch
from monoflex_tpu_torch.engine.launch import launch
from monoflex_tpu_torch.losses.loss_computation import LossComputer
from monoflex_tpu_torch.models.detector import build_model
from monoflex_tpu_torch.parallel.mesh import wrap_model
from monoflex_tpu_torch.train.solver import build_optimizer
from monoflex_tpu_torch.train.train_step import TrainState, make_train_step
from monoflex_tpu_torch.utils import comm

BF16_YAML = os.path.join(os.path.dirname(__file__), "..", "runs", "monoflex_bf16.yaml")


def rank_worker(out_dir):
    rank = comm.get_rank()
    cfg = get_cfg_defaults()
    cfg.merge_from_file(BF16_YAML)
    cfg.MODEL.HEAD.NUM_CHANNEL = 32
    model = build_model(cfg, device="cpu", seed=0)
    optimizer, _, _ = build_optimizer(cfg, model)
    wrapped = wrap_model(model, "cpu")
    step = make_train_step(wrapped, LossComputer(cfg), optimizer)
    batch = {k: torch.from_numpy(v[2 * rank:2 * rank + 2])
             for k, v in make_train_batch(4, 64, 128).items()}
    state, metrics = step(TrainState(), batch)
    torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
                "state": model.state_dict(), "train_state": (state.step, state.skips),
                "ddp": isinstance(wrapped, torch.nn.parallel.DistributedDataParallel),
                "terms": list(cfg.MODEL.HEAD.LOSS_NAMES)},
               os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("bf16_ranks")
    saved = {k: os.environ.get(k) for k in ("MONOFLEX_PLATFORM", "OMP_NUM_THREADS")}
    os.environ.update(MONOFLEX_PLATFORM="cpu", OMP_NUM_THREADS="2")
    try:
        launch(rank_worker, None, None, None, 2, str(out))
    finally:
        for key, value in saved.items():
            if value is None:
                del os.environ[key]
            else:
                os.environ[key] = value
    yield [torch.load(out / f"rank{r}.pt") for r in range(2)]
    shutil.rmtree(out, ignore_errors=True)


def test_ranks_report_the_same_finite_terms(ranks):
    a, b = (r["metrics"] for r in ranks)
    assert ranks[0]["ddp"] and ranks[1]["ddp"]
    assert a == b
    terms = ranks[0]["terms"]
    assert len(terms) == 11 and set(terms) <= set(a)
    assert all(np.isfinite(v) for v in a.values())
    assert a["skipped"] == 0.0
    assert ranks[0]["train_state"] == ranks[1]["train_state"] == (1, 0)


def test_ranks_end_with_the_same_model(ranks):
    a, b = (r["state"] for r in ranks)
    assert a.keys() == b.keys()
    for key, value in a.items():
        assert value.dtype != torch.bfloat16, key
        assert torch.equal(value, b[key]), key
    running = [k for k in a if k.endswith("running_var")]
    assert len(running) > 60
    assert all(not torch.equal(a[k], torch.ones_like(a[k])) for k in running)
