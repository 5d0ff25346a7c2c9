"""The port's training step against the JAX package's ``make_train_step`` on the
same weights and the same batch.

The narrow model of ``test_torch_slice.py`` (64x128, batch 2), with its
perturbed weights sent to flax through the JAX package's importer (not
``model.init``, which costs minutes un-jitted).  The JAX side runs the
clamped DCN as the XLA shift op; the port runs its autograd Function, whose
CPU forward and backward are the plain op and ``modulated_deform_conv_backward``.
The JAX step is compiled once, in a module fixture; its optimizer is the
package's own ``build_optimizer`` (AdamW, lr 3e-4, weight decay 1e-5, bias
factor 2) behind one transform that only records the raw gradients.

Tolerances.  float32 on both sides.  Train-mode BN couples every sample, so
rounding travels further than in eval mode; both figures below were measured
against a float64 run of the port, which the port's float32 step matches to
1e-5 (relative L2 of each gradient):
- loss terms and log entries: 1e-4 relative (plus 1e-6 abs for terms near
  0); measured up to 2.4e-5;
- gradients: relative L2 error per parameter 5e-2.  The JAX step's own
  float32 gradients of the trunk's BN and conv parameters sit 1-3% from the
  float64 values (measured 3.4% at most), the neck's and heads' 1e-4.
  The gradient of a bias that feeds a train-mode BN (every DCN bias, the
  first conv of each edge-fusion stack) is 0 in exact arithmetic; both sides
  give rounding noise, held to 1e-4 abs;
- BN running stats: 1e-5 abs (O(1) values, a mean and a variance over the
  batch); measured 9e-6;
- parameters after the update: the first AdamW step moves an element by
  lr * factor * g / (|g| + 1e-8), about lr * factor * sign(g), so the two
  sides agree to 1e-3 of the step (plus 1e-7) wherever their gradients have
  the same sign and |g| > 1e-4, which must hold for 90% of the elements.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monoflex_tpu.data.synthetic import make_dummy_batch
from monoflex_tpu.losses.loss_computation import LossComputer as JaxLossComputer
from monoflex_tpu.train.solver import build_optimizer as jax_build_optimizer
from monoflex_tpu.train.train_step import TrainState as JaxTrainState
from monoflex_tpu.train.train_step import make_train_step as jax_make_train_step
from monoflex_tpu.utils.monoflex_import import monoflex_name_map
from monoflex_tpu.utils.weight_import import convert_torch_entry, flatten_params
from monoflex_tpu_torch.data.synthetic import make_train_batch
from monoflex_tpu_torch.losses.loss_computation import LossComputer
from monoflex_tpu_torch.models.backbone.dla import DCN
from monoflex_tpu_torch.train.solver import build_optimizer
from monoflex_tpu_torch.train.train_step import TrainState, make_train_step
from test_torch_slice import B, H, W, jax_narrow_model, narrow_cfg, perturbed_port_model, to_flax

LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-6
GRAD_REL_L2 = 5e-2
ZERO_GRAD_ATOL = 1e-4
STATS_ATOL = 1e-5
PARAM_ATOL = 1e-7


def feeds_train_bn(path):
    """A bias whose conv output goes straight into a train-mode BN."""
    return path.endswith("DCN_0/bias") or (path.startswith("predictor/trunc_")
                                           and path.endswith("Conv_0/bias"))


def record_grads():
    """An optax transform that passes the gradients on and keeps them as its
    state, so the compiled step hands them back."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def flax_layout(named, cfg):
    """{flax path: array} for the port's named tensors (``stats:`` for BN
    running stats), through the JAX package's own layout converters."""
    out = {}
    for torch_name, flax_path in monoflex_name_map(cfg).items():
        if torch_name in named:
            out[flax_path] = convert_torch_entry(torch_name, named[torch_name])[1]
    return out


def conditioned_model(cfg):
    """The slice test's perturbed model with its offset/mask conv weights
    scaled by 0.1: offsets still come out fractional and partly clamped (the
    conv biases are unscaled), but the gradient no longer blows up through
    16 deformable layers in train mode, where f32 rounding alone moved it by
    2% (port in f32 against the port in f64); scaled, 3e-5."""
    model = perturbed_port_model(cfg)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DCN):
                m.conv_offset_mask.weight.mul_(0.1)
    return model


@pytest.fixture(scope="module")
def one_step():
    cfg = narrow_cfg("pallas3")
    model = conditioned_model(cfg)
    params, stats = to_flax(model, cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}

    jbatch = {k: jnp.asarray(v) for k, v in make_dummy_batch(B, H, W).items()}
    tx = optax.chain(record_grads(), jax_build_optimizer(cfg, params)[0])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                          opt_state=tx.init(params), skips=jnp.zeros((), jnp.int32))
    step = jax.jit(jax_make_train_step(jax_narrow_model(cfg), JaxLossComputer(cfg), tx))
    new_state, jmetrics = step(state, jbatch)
    jax_grads = new_state.opt_state[0]

    batch = {k: torch.from_numpy(v) for k, v in make_train_batch(B, H, W).items()}
    optimizer, _, _ = build_optimizer(cfg, model)
    port_state, metrics = make_train_step(model, LossComputer(cfg), optimizer)(TrainState(), batch)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    return dict(cfg=cfg, before=before, model=model, state=port_state, metrics=metrics,
                grads=grads, jax_state=new_state, jax_metrics=jmetrics, jax_grads=jax_grads)


def test_every_loss_term_and_log_entry_matches(one_step):
    metrics, jmetrics = one_step["metrics"], one_step["jax_metrics"]
    assert set(metrics) == set(jmetrics)
    assert len(one_step["cfg"].MODEL.HEAD.LOSS_NAMES) == 11
    for key, want in jmetrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(want), rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=key)
    assert metrics["skipped"] == 0.0 and one_step["state"] == TrainState(step=1, skips=0)


def test_every_gradient_matches(one_step):
    """P1 on the CPU side: the DCN weights, the offset/mask convs and the
    trunk all get their gradients through the DCN Function."""
    got = flax_layout(one_step["grads"], one_step["cfg"])
    want = flatten_params(one_step["jax_grads"])
    assert set(got) == set(want)
    for path, g in want.items():
        g = np.asarray(g)
        if feeds_train_bn(path):
            assert max(np.abs(g).max(), np.abs(got[path]).max()) <= ZERO_GRAD_ATOL, path
        elif not g.any():   # a deeper tree's projection, which feeds nothing
            assert not got[path].any(), path
        else:
            err = np.linalg.norm(got[path] - g) / np.linalg.norm(g)
            assert err <= GRAD_REL_L2, (path, err)


def test_bn_running_stats_follow_flax(one_step):
    """P3: train-mode BN folds the biased batch variance into running_var
    (stock torch folds the unbiased one, n/(n-1) larger: 6% on the 16-pixel
    deepest level)."""
    state = {k: v.numpy() for k, v in one_step["model"].state_dict().items()}
    got = {k: v for k, v in flax_layout(state, one_step["cfg"]).items() if k.startswith("stats:")}
    want = flatten_params(one_step["jax_state"].batch_stats)
    assert len(got) == len(want) > 0
    for path, value in got.items():
        np.testing.assert_allclose(value, np.asarray(want[path[len("stats:"):]]),
                                   atol=STATS_ATOL, err_msg=path)
    before = {k: v.numpy() for k, v in one_step["before"].items() if k.endswith("running_var")}
    assert any(np.abs(state[k] - v).max() > 1e-3 for k, v in before.items())


def test_parameters_after_the_update_match(one_step):
    cfg = one_step["cfg"]
    state = {n: p.detach().numpy() for n, p in one_step["model"].named_parameters()}
    got = flax_layout(state, cfg)
    want = flatten_params(one_step["jax_state"].params)
    before = flax_layout({n: v.numpy() for n, v in one_step["before"].items()}, cfg)
    jax_grads = flatten_params(one_step["jax_grads"])
    port_grads = flax_layout(one_step["grads"], cfg)
    compared = total = 0
    for path, p in want.items():
        p = np.asarray(p)
        step = cfg.SOLVER.BASE_LR * (cfg.SOLVER.BIAS_LR_FACTOR if path.endswith("bias") else 1.0)
        g, h = np.asarray(jax_grads[path]), port_grads[path]
        same = (np.sign(g) == np.sign(h)) & (np.minimum(np.abs(g), np.abs(h)) > 1e-4)
        err = np.abs(got[path] - p)[same]
        assert (err <= 1e-3 * step + PARAM_ATOL).all(), (path, err.max())
        # each of those elements took a full step
        assert (np.abs(p - before[path])[same] > 0.9 * step).all(), path
        compared += int(same.sum())
        total += p.size
    assert compared >= 0.9 * total, (compared, total)


def test_nonfinite_loss_skips_the_update():
    """A NaN in the targets: the step is counted and skipped; parameters,
    moments, the optimizer's count (the LR schedule's clock), the EMA and the
    BN running stats stay as they were."""
    cfg = narrow_cfg("pallas3")
    cfg.SOLVER.EMA_DECAY = 0.99
    model = conditioned_model(cfg)
    optimizer, schedule, ema = build_optimizer(cfg, model)
    train_step = make_train_step(model, LossComputer(cfg), optimizer)
    good = {k: torch.from_numpy(v) for k, v in make_train_batch(B, H, W).items()}
    state, _ = train_step(TrainState(), good)
    snapshot = copy.deepcopy((model.state_dict(), optimizer.inner.state_dict(), ema.shadow))
    count = optimizer.count

    bad = dict(good, locations=good["locations"].clone())
    bad["locations"][0, 0, 2] = float("nan")
    for k in (1, 2):
        state, metrics = train_step(state, bad)
        assert metrics["skipped"] == 1.0 and metrics["consecutive_skips"] == float(k)
        assert not np.isfinite(float(metrics["total_loss"]))
    assert state == TrainState(step=3, skips=2)
    assert optimizer.count == count == 1 and ema.count == 1
    assert schedule(optimizer.count) == schedule(1)
    state_now = model.state_dict()
    for key, value in snapshot[0].items():
        assert torch.equal(state_now[key], value), key
    inner = optimizer.inner.state_dict()
    for pid, moments in snapshot[1]["state"].items():
        for key, value in moments.items():
            assert torch.equal(inner["state"][pid][key], value), (pid, key)
    for name, value in snapshot[2].items():
        assert torch.equal(ema.shadow[name], value), name

    state, metrics = train_step(state, good)
    assert metrics["skipped"] == 0.0 and state.skips == 0 and optimizer.count == 2


def test_train_batch_matches_jax_batch_maker():
    """make_train_batch gives every field of make_dummy_batch, bit for bit."""
    ours = make_train_batch(3, 64, 128, seed=7)
    theirs = make_dummy_batch(3, 64, 128, seed=7)
    assert set(ours) == set(theirs)
    for key, value in ours.items():
        np.testing.assert_array_equal(value, theirs[key], err_msg=key)
        assert value.dtype == theirs[key].dtype, key
