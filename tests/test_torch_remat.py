"""``TPU.REMAT_BACKBONE``: the port recomputes the trunk in the backward
(``torch.utils.checkpoint``), as the JAX trunk runs under ``nn.remat``.

One train step of the full-width ``runs/monoflex.yaml`` model from seed 0
at 64x128, batch 2, with the key on and off: the trunk's forward must run
twice with it on (so the recomputation happens) and the step must be the
same, bit for bit on the CPU: the total, every loss term, every gradient
and every BN buffer.  The running stats are the trap: the recomputation
runs train-mode BN again and must not fold the batch statistics twice.
"""

import os

import pytest
import torch

from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.data.synthetic import make_train_batch
from monoflex_tpu_torch.losses.loss_computation import LossComputer
from monoflex_tpu_torch.models.detector import build_model
from monoflex_tpu_torch.train.solver import build_optimizer
from monoflex_tpu_torch.train.train_step import TrainState, make_train_step

RUN_YAML = os.path.join(os.path.dirname(__file__), "..", "runs", "monoflex.yaml")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the test workers share the machine's cores, and
    more threads than cores makes each parallel region wait for spinning
    threads of other processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def one_step(remat):
    cfg = get_cfg_defaults()
    cfg.merge_from_file(RUN_YAML)
    cfg.TPU.REMAT_BACKBONE = remat
    model = build_model(cfg, device="cpu", seed=0)
    assert model.backbone.remat == remat
    calls = []
    model.backbone.base.base_layer.register_forward_hook(lambda *_: calls.append(1))
    optimizer, _, _ = build_optimizer(cfg, model)
    batch = {k: torch.from_numpy(v) for k, v in make_train_batch(2, 64, 128).items()}
    _, metrics = make_train_step(model, LossComputer(cfg), optimizer)(TrainState(), batch)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return metrics, grads, model.state_dict(), len(calls)


def test_remat_step_equals_the_plain_step():
    plain, plain_grads, plain_state, plain_calls = one_step(False)
    remat, remat_grads, remat_state, remat_calls = one_step(True)
    assert (plain_calls, remat_calls) == (1, 2)
    assert plain.keys() == remat.keys()
    for key, value in plain.items():
        assert torch.equal(torch.as_tensor(remat[key]), torch.as_tensor(value)), key
    for name, g in plain_grads.items():
        assert torch.equal(remat_grads[name], g), name
    stats = [k for k in plain_state if "running" in k or "num_batches" in k]
    assert len(stats) > 100
    for key in plain_state:
        assert torch.equal(remat_state[key], plain_state[key]), key
    assert all(int(plain_state[k]) == 1 for k in stats if "num_batches" in k)


def test_remat_is_off_in_eval():
    """No gradient, nothing to recompute: the trunk runs once."""
    cfg = get_cfg_defaults()
    cfg.merge_from_file(RUN_YAML)
    cfg.TPU.REMAT_BACKBONE = True
    model = build_model(cfg, device="cpu", seed=0)
    calls = []
    model.backbone.base.base_layer.register_forward_hook(lambda *_: calls.append(1))
    batch = make_train_batch(1, 64, 128)
    with torch.no_grad():
        model(torch.from_numpy(batch["image"]), torch.from_numpy(batch["edge_indices"]),
              torch.from_numpy(batch["edge_len"]))
    assert calls == [1]
