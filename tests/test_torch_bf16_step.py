"""One training step of the bf16 model (``runs/monoflex_bf16.yaml``): the
port's ``make_train_step`` against the JAX package's on the same weights and
batch, and the step under ``TPU.REMAT_BACKBONE``.

The model, weights and JAX DCN of ``test_torch_bf16.py``.  In train mode each
BN normalises with its batch statistics, and a random DLA with BN is chaotic
in its input: a relative change e of the stem's output grows to about 100 e
at the trunk's last level (the f32 steps here: 6e-7 to 6e-5).  bf16 rounds
every activation to 2^-9, so two correct bf16 steps that round one element
in 1e4 the other way end far apart: the JAX bf16 step's own trunk output
lies 25-37% (relative L2) from its f32 step's at the last level, its
gradients at a median of 100% from the f32 gradients, and the port's at the
same distance from either.  So the step is held where that chaos has not
grown, and by what it must keep wherever it has:
- the 11 terms and every log entry: finite, no skip, the same keys as JAX,
  and each term within 30% of JAX's (measured 10%; JAX bf16 against JAX
  f32: 19%);
- the stem's BN running statistics (the first BN, before any chaos): 1e-3
  relative (the conv's bf16 output differs in about 1e-4 of its elements);
- every gradient: f32, finite, zero exactly where the JAX gradient is zero
  (a deeper tree's projection, which feeds nothing);
- the update: every parameter that has a gradient moves, and none without;
- the same step with the trunk recomputed (``TPU.REMAT_BACKBONE``): bit for
  bit on the CPU, the total, terms, gradients and BN buffers.
The gradients themselves are held to JAX's with the statistics fixed, in
``test_torch_bf16.py``.
"""

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
from monoflex_tpu.utils.weight_import import flatten_params
from monoflex_tpu_torch.data.synthetic import make_train_batch
from monoflex_tpu_torch.losses.loss_computation import LossComputer
from monoflex_tpu_torch.models.detector import build_model
from monoflex_tpu_torch.train.solver import build_optimizer
from monoflex_tpu_torch.train.train_step import TrainState, make_train_step
from test_torch_bf16 import bf16_cfg, bf16_port_model, jax_bf16_model, v3_as_xla  # noqa: F401
from test_torch_slice import B, H, W, to_flax
from test_torch_train_step import flax_layout, record_grads

TERM_RTOL = 0.3
STEM_STATS_RTOL = 1e-3
STEM_BNS = ("backbone.base.base_layer.1", "backbone.base.level0.1")


@pytest.fixture(scope="module")
def one_step(v3_as_xla):  # noqa: F811
    cfg = bf16_cfg()
    model = bf16_port_model(cfg)
    params, stats = to_flax(model, cfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    jbatch = {k: jnp.asarray(v) for k, v in make_dummy_batch(B, H, W).items()}
    tx = optax.chain(record_grads(), jax_build_optimizer(cfg, params)[0])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                          opt_state=tx.init(params), skips=jnp.zeros((), jnp.int32))
    step = jax.jit(jax_make_train_step(jax_bf16_model(cfg), JaxLossComputer(cfg), tx))
    new_state, jmetrics = step(state, jbatch)

    batch = {k: torch.from_numpy(v) for k, v in make_train_batch(B, H, W).items()}
    optimizer, _, _ = build_optimizer(cfg, model)
    port_state, metrics = make_train_step(model, LossComputer(cfg), optimizer)(TrainState(), batch)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    return dict(cfg=cfg, model=model, before=before, state=port_state, metrics=metrics,
                grads=grads, jax_state=new_state, jax_metrics=jmetrics,
                jax_grads={k: np.asarray(v) for k, v in
                           flatten_params(new_state.opt_state[0]).items()})


def test_terms_are_finite_and_near_jax(one_step):
    metrics, jmetrics = one_step["metrics"], one_step["jax_metrics"]
    assert set(metrics) == set(jmetrics)
    terms = one_step["cfg"].MODEL.HEAD.LOSS_NAMES
    assert len(terms) == 11
    for key, value in metrics.items():
        assert np.isfinite(float(value)), key
    for key in terms:
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=TERM_RTOL,
                                   err_msg=key)
    assert metrics["skipped"] == 0.0 and one_step["state"] == TrainState(step=1, skips=0)


def test_stem_statistics_match_jax(one_step):
    cfg = one_step["cfg"]
    state = {k: v.numpy() for k, v in one_step["model"].state_dict().items()}
    got = flax_layout(state, cfg)
    want = flatten_params(one_step["jax_state"].batch_stats)
    names = [f"{bn}.{s}" for bn in STEM_BNS for s in ("running_mean", "running_var")]
    paths = flax_layout({n: state[n] for n in names}, cfg)
    assert len(paths) == 4
    for path in paths:
        np.testing.assert_allclose(got[path], np.asarray(want[path[len("stats:"):]]),
                                   rtol=STEM_STATS_RTOL, atol=1e-6, err_msg=path)


def test_gradients_reach_what_jax_reaches(one_step):
    got = flax_layout(one_step["grads"], one_step["cfg"])
    want = one_step["jax_grads"]
    assert set(got) == set(want)
    for path, g in want.items():
        assert got[path].dtype == np.float32 and np.isfinite(got[path]).all(), path
        assert got[path].any() == g.any(), path


def test_the_update_moves_every_parameter_with_a_gradient(one_step):
    model, before = one_step["model"], one_step["before"]
    for name, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[name])
        assert p.dtype == torch.float32
        assert moved == bool(one_step["grads"][name].any()), name


def remat_step(remat):
    cfg = bf16_cfg()
    cfg.MODEL.HEAD.NUM_CHANNEL = 32
    cfg.TPU.REMAT_BACKBONE = remat
    model = build_model(cfg, device="cpu", seed=0)
    optimizer, _, _ = build_optimizer(cfg, model)
    batch = {k: torch.from_numpy(v) for k, v in make_train_batch(2, 64, 128).items()}
    _, metrics = make_train_step(model, LossComputer(cfg), optimizer)(TrainState(), batch)
    return metrics, {n: p.grad.clone() for n, p in model.named_parameters()}, model.state_dict()


def test_remat_step_equals_the_plain_step_under_bf16():
    plain, plain_grads, plain_state = remat_step(False)
    remat, remat_grads, remat_state = remat_step(True)
    assert plain.keys() == remat.keys()
    for key, value in plain.items():
        assert torch.equal(torch.as_tensor(remat[key]), torch.as_tensor(value)), key
    for name, g in plain_grads.items():
        assert torch.equal(remat_grads[name], g), name
    for key in plain_state:
        assert torch.equal(remat_state[key], plain_state[key]), key
