"""A JAX (orbax) training checkpoint into the port: ``convert_jax_checkpoint.py``
at the repo root writes the ``.npz`` that the port's ``train/checkpoint.py``
restores, and the CLI resumes from it.

The JAX state is built, not trained (a JAX train step's CPU compile alone
takes about 80 s): the narrow model of ``test_torch_slice.py`` with
perturbed weights, the optax chain of ``runs/monoflex_ema.yaml`` (AdamW with
the parameter EMA) with seeded moments, EMA shadow and counts, saved with the
JAX package's ``Checkpointer``.  Restored in the port: the forward equals
JAX's on the saved weights to 1e-4 abs (as ``test_torch_slice.py``); the
moments and the EMA equal optax's trees after the layout transpose, bit for
bit; the step and the counts are equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convert_jax_checkpoint as converter
from monoflex_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from monoflex_tpu.train.solver import ParamEmaState
from monoflex_tpu.train.solver import build_optimizer as jax_build_optimizer
from monoflex_tpu.train.train_step import TrainState as JaxTrainState
from monoflex_tpu.utils.monoflex_import import monoflex_name_map
from monoflex_tpu_torch.data.synthetic import make_inference_batch
from monoflex_tpu_torch.train.checkpoint import Checkpointer, read_converted
from monoflex_tpu_torch.train.solver import build_optimizer
from test_torch_cli import OPTS, data_dir, run_cli  # noqa: F401 (fixture)
from test_torch_slice import (ATOL, STAGE_R, B, H, W, jax_narrow_model,
                              perturbed_port_model, port_narrow_model, to_flax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMA_YAML = os.path.join(REPO, "runs", "monoflex_ema.yaml")
NARROW_OPTS = ["MODEL.HEAD.NUM_CHANNEL", 16, "TPU.DCN_FORCE_IMPL", "pallas3",
               "TPU.DCN_MAX_OFFSET_PER_STAGE", STAGE_R]
STEP = 5


def seeded(tree, rng, positive=False):
    """A tree of the same shapes with seeded values."""
    def draw(x):
        v = rng.randn(*np.shape(x)).astype(np.float32) * 1e-3
        return jnp.asarray(np.abs(v) if positive else v)
    return jax.tree.map(draw, tree)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    jcfg, pcfg = converter.configs(EMA_YAML, NARROW_OPTS)
    params, stats = to_flax(perturbed_port_model(pcfg, seed=21), pcfg)
    tx, _ = jax_build_optimizer(jcfg, params)
    template = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                             opt_state=tx.init(params), skips=jnp.zeros((), jnp.int32))
    rng = np.random.RandomState(22)

    def seed_states(s):
        if hasattr(s, "mu") and hasattr(s, "nu"):
            return s._replace(mu=seeded(s.mu, rng), nu=seeded(s.nu, rng, positive=True),
                              count=jnp.asarray(STEP, s.count.dtype))
        return s

    opt_state = jax.tree.map(seed_states, template.opt_state,
                             is_leaf=lambda s: hasattr(s, "mu") and hasattr(s, "nu"))
    assert isinstance(opt_state, ParamEmaState)
    opt_state = opt_state._replace(ema=jax.tree.map(lambda p, d: p + d, params,
                                                    seeded(params, rng)),
                                   count=jnp.asarray(STEP, jnp.int32))
    state = template._replace(step=jnp.asarray(STEP, jnp.int32), opt_state=opt_state,
                              skips=jnp.asarray(1, jnp.int32))
    root = tmp_path_factory.mktemp("orbax")
    path = JaxCheckpointer(str(root / "ckpt")).save(f"model_checkpoint_{STEP}", state)
    out = root / "model.npz"
    converter.convert(EMA_YAML, path, str(out), NARROW_OPTS, template=template)
    return jcfg, pcfg, state, out


def test_restored_forward_equals_jax(converted):
    _, pcfg, state, out = converted
    model = port_narrow_model(pcfg)
    optimizer, _, _ = build_optimizer(pcfg, model)
    train_state, start = Checkpointer(str(out.parent / "port")).load(model, optimizer, str(out))
    assert start == train_state.step == STEP and train_state.skips == 1
    batch = make_inference_batch(B, H, W)
    inputs = [batch[k] for k in ("image", "edge_indices", "edge_len")]
    jmodel = jax_narrow_model(pcfg)
    ref = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        {"params": state.params, "batch_stats": state.batch_stats}, *map(jnp.asarray, inputs))
    with torch.no_grad():
        got = model.eval()(*map(torch.from_numpy, inputs))
    np.testing.assert_allclose(got["cls"].permute(0, 2, 3, 1).numpy(), np.asarray(ref["cls"]),
                               atol=ATOL)
    for g, want in zip(got["reg"], ref["reg"]):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=ATOL)


def flat(tree, prefix=""):
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


def torch_layout(a):
    return {4: lambda w: w.transpose(3, 2, 0, 1), 3: lambda w: w.transpose(2, 1, 0)}.get(
        a.ndim, lambda w: w)(a)


def test_moments_and_ema_equal_optax(converted):
    jcfg, pcfg, state, out = converted
    model = port_narrow_model(pcfg)
    optimizer, _, ema = build_optimizer(pcfg, model)
    Checkpointer(str(out.parent / "port2")).load(model, optimizer, str(out))
    adam = adam_state(state)
    mu, nu, shadow = flat(adam.mu), flat(adam.nu), flat(state.opt_state.ema)
    params = dict(model.named_parameters())
    names = {n: path for n, path in monoflex_name_map(pcfg).items() if n in params}
    assert len(names) == len(params)
    for name, path in names.items():
        moments = optimizer.inner.state[params[name]]
        np.testing.assert_array_equal(moments["exp_avg"].numpy(), torch_layout(mu[path]))
        np.testing.assert_array_equal(moments["exp_avg_sq"].numpy(), torch_layout(nu[path]))
        assert moments["step"].item() == STEP
        np.testing.assert_array_equal(ema.shadow[name].numpy(), torch_layout(shadow[path]))
    assert optimizer.count == ema.count == STEP


def adam_state(state):
    """The optax Adam state of the saved chain."""
    found = [s for s in jax.tree_util.tree_leaves(
        state.opt_state.inner, is_leaf=lambda s: hasattr(s, "mu") and hasattr(s, "nu"))
        if hasattr(s, "mu") and hasattr(s, "nu")]
    assert len(found) == 1
    return found[0]


def test_the_file_holds_the_port_names(converted):
    _, pcfg, _, out = converted
    arrays = read_converted(str(out))
    model = port_narrow_model(pcfg)
    state = model.state_dict()
    assert set(arrays["model"]) == {n for n in state if not n.endswith("num_batches_tracked")}
    params = {n for n, _ in model.named_parameters()}
    assert set(arrays["moments"]) == {"exp_avg", "exp_avg_sq"}
    assert all(set(m) == params for m in arrays["moments"].values())
    assert set(arrays["ema"]) == params
    assert (arrays["step"], arrays["count"], arrays["ema_count"], arrays["skips"]) == (
        STEP, STEP, STEP, 1)


def test_the_cli_resumes_from_a_converted_file(data_dir, tmp_path):  # noqa: F811
    """``--ckpt <file>.npz``: the CLI restores weights, moments and step and
    trains on from there."""
    from monoflex_tpu_torch.config import get_cfg_defaults
    from monoflex_tpu_torch.models.detector import build_model

    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(REPO, "runs", "monoflex.yaml"))
    cfg.merge_from_list(OPTS)
    model = build_model(cfg, device="cpu", seed=2)
    arrays = {f"model/{n}": v.numpy() for n, v in model.state_dict().items()
              if not n.endswith("num_batches_tracked")}
    for n, p in model.named_parameters():
        arrays[f"exp_avg/{n}"] = np.zeros(p.shape, np.float32)
        arrays[f"exp_avg_sq/{n}"] = np.zeros(p.shape, np.float32)
    arrays.update(count=np.asarray(3), ema_count=np.asarray(0), step=np.asarray(3),
                  skips=np.asarray(0))
    np.savez(tmp_path / "converted.npz", **arrays)
    r = run_cli("--config", "runs/monoflex.yaml", "--output", str(tmp_path / "run"), "--ckpt",
                str(tmp_path / "converted.npz"), *OPTS, "SOLVER.IMS_PER_BATCH", "2",
                "SOLVER.MAX_ITERATION", "4", "SOLVER.EVAL_INTERVAL", "100",
                MONOFLEX_DATA_DIR=str(data_dir))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    log = r.stdout + r.stderr
    assert "resumed from iteration 3" in log and "optimizer count 3 after the restore" in log
    assert "iter 4/4" in r.stdout
