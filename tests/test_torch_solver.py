"""The port's solver against the JAX package's optax chain: the LR and momentum
schedules step by step, and 3 updates of each optimizer mode on a small
parameter tree fed the same gradients, with and without the bias and
backbone LR factors, the trunk freeze, global-norm clipping and the
parameter EMA.

The tree is a module whose parameter names mirror the detector's
(``backbone.base.*`` is the trunk, ``backbone.*`` the backbone, ``*.bias`` the
biases); the optax side gets the same arrays in a tree keyed by those names,
which is all its masks read.

Tolerances.  float32 on both sides with the same formulas in another order:
parameters and EMA 1e-6 relative plus 1e-7 abs (values O(1), three updates
of at most 6e-3 each); learning rates and momenta 1e-6 of the schedule's
peak (the JAX schedules evaluate in float32, the port's in float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from monoflex_tpu.train import solver as JS
from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.train import solver as S

RTOL, ATOL = 1e-6, 1e-7
STEPS = 3


@pytest.mark.parametrize("args", [
    dict(base_lr=3e-4, decay_steps=[4, 9], decay=0.1, lr_clip=1e-6),
    dict(base_lr=3e-4, decay_steps=[4, 9], decay=0.01, lr_clip=1e-7, warmup_steps=6,
         warmup_div=10.0),
])
def test_multi_step_schedule(args):
    ours, theirs = S.multi_step_schedule(**args), JS.multi_step_schedule(**args)
    for step in range(14):
        np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=0,
                                   atol=RTOL * args["base_lr"], err_msg=str(step))


def test_one_cycle_schedules():
    pairs = [(S.one_cycle_schedule(1e-3, 20, 10.0, 0.4), JS.one_cycle_schedule(1e-3, 20, 10.0, 0.4),
              1e-3),
             (S.one_cycle_momentum(20, (0.95, 0.85), 0.4),
              JS.one_cycle_momentum(20, (0.95, 0.85), 0.4), 0.95)]
    for ours, theirs, peak in pairs:
        for step in range(24):
            np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=0, atol=RTOL * peak,
                                       err_msg=str(step))


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = nn.ModuleDict({"base": nn.Linear(5, 4), "dla_up": nn.Linear(4, 3)})
        self.heads = nn.ModuleDict({"predictor": nn.Linear(3, 2)})


def tree_of(named):
    """{a: {b: {c: x}}} from {'a.b.c': x}."""
    tree = {}
    for name, value in named.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flat(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = np.asarray(value)
    return out


def solver_cfg(optimizer, extras):
    cfg = get_cfg_defaults()
    s = cfg.SOLVER
    s.OPTIMIZER = optimizer
    s.BASE_LR = 3e-3
    s.WEIGHT_DECAY = 1e-2
    s.EVAL_AND_SAVE_EPOCH = False
    s.STEPS = (1, 2)              # the LR changes between the 3 updates
    s.LR_DECAY = 0.5
    s.MAX_ITERATION = 6
    s.BIAS_LR_FACTOR = 2.0
    if extras:
        s.BACKBONE_LR_FACTOR = 0.5
        s.GRAD_NORM_CLIP = 1.0    # the drawn gradients have norm about 5
        s.EMA_DECAY = 0.9
        cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT = 2
    return cfg


@pytest.mark.parametrize("extras", [False, True], ids=["plain", "factors-freeze-clip-ema"])
@pytest.mark.parametrize("optimizer", ["adamw", "adam", "sgd", "adam_onecycle"])
def test_three_updates_match_optax(optimizer, extras):
    cfg = solver_cfg(optimizer, extras)
    torch.manual_seed(0)
    model = Tiny()
    start = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    params = jax.tree.map(jnp.asarray, tree_of(start))
    tx, _ = JS.build_optimizer(cfg, params)
    opt_state = tx.init(params)
    optimizer_, schedule, ema = S.build_optimizer(cfg, model)
    assert (ema is not None) == extras

    rng = np.random.RandomState(1)
    for step in range(STEPS):
        grads = {n: (rng.randn(*p.shape) * 1.5).astype(np.float32) for n, p in start.items()}
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, tree_of(grads)), opt_state,
                                       params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[name].copy())
        optimizer_.step()

        want = flat(params)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {step} {name}")
    assert optimizer_.count == STEPS

    for name, p in model.named_parameters():
        moved = not np.array_equal(p.detach().numpy(), start[name])
        assert moved == (not (extras and name.startswith("backbone.base."))), name
    if extras:
        shadow = flat(JS.get_ema_params(opt_state))
        assert ema.count == STEPS
        for name, value in ema.shadow.items():
            np.testing.assert_allclose(value.numpy(), shadow[name], rtol=RTOL, atol=ATOL,
                                       err_msg=name)


def test_lr_factors_follow_the_optax_masks():
    cfg = solver_cfg("adamw", extras=True)
    assert S.lr_factors("backbone.base.level0.0.weight", cfg) == (False, 0.0)
    assert S.lr_factors("backbone.dla_up.ida_0.proj_1.actf.0.bias", cfg) == (True, 1.0)
    assert S.lr_factors("backbone.dla_up.ida_0.proj_1.conv.weight", cfg) == (True, 0.5)
    assert S.lr_factors("heads.predictor.class_head.1.bias", cfg) == (True, 2.0)
    assert S.lr_factors("heads.predictor.class_head.1.weight", cfg) == (True, 1.0)
