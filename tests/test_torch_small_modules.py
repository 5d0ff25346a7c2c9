"""The port's counterparts of the JAX package's small modules against them:
``ops/psroi.py`` (value and gradients), ``losses/uncertainty.py``,
``train/grad_clip.py`` (the optax transform over several steps),
``structures/`` and ``utils/registry.py``, and the ``plain_train_net``
shim onto the port's CLI.

Tolerances: 1e-5 abs on the PSROI pool and its gradients (float32 bilinear
sums of at most 4 x 16 terms on both sides); 1e-6 relative on the weighted
losses and the clipped gradients (the same float32 arithmetic); the numpy
containers exactly.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monoflex_tpu.losses import uncertainty as jax_uncertainty
from monoflex_tpu.ops.psroi import deform_psroi_pooling as jax_psroi
from monoflex_tpu.structures import ParamsList as JaxParamsList
from monoflex_tpu.structures import to_image_list as jax_to_image_list
from monoflex_tpu.train.grad_clip import adaptive_grad_clip
from monoflex_tpu.utils.registry import Registry as JaxRegistry
from monoflex_tpu_torch.losses.uncertainty import apply_uncertainty_weights, init_log_variances
from monoflex_tpu_torch.ops.psroi import deform_psroi_pooling
from monoflex_tpu_torch.structures import ParamsList, to_image_list
from monoflex_tpu_torch.train.grad_clip import AdaptiveGradClip
from monoflex_tpu_torch.utils.registry import BACKBONES, HEADS, PREDICTORS, Registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def psroi_inputs(seed=0, B=2, H=12, W=16, od=3, group=2, P=3, N=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, od * group * group).astype(np.float32)
    x1, y1 = rng.uniform(0, 8, N), rng.uniform(0, 6, N)
    rois = np.stack([rng.randint(0, B, N), x1, y1, x1 + rng.uniform(2, 8, N),
                     y1 + rng.uniform(2, 6, N)], 1).astype(np.float32)
    trans = (rng.randn(N, P, P, 2) * 0.5).astype(np.float32)
    return x, rois, trans, dict(output_dim=od, group_size=group, pooled_size=P,
                                sample_per_part=4, spatial_scale=0.5, trans_std=0.1)


@pytest.mark.parametrize("with_trans", [False, True])
def test_psroi_value_and_gradients_equal_jax(with_trans):
    x, rois, trans, kw = psroi_inputs()
    tr = trans if with_trans else None

    def jax_loss(x, trans):
        return jnp.sum(jax_psroi(x, jnp.asarray(rois), trans, **kw) ** 2)

    jout = np.asarray(jax_psroi(jnp.asarray(x), jnp.asarray(rois),
                                None if tr is None else jnp.asarray(tr), **kw))
    xt = torch.tensor(x, requires_grad=True)
    tt = None if tr is None else torch.tensor(tr, requires_grad=True)
    out = deform_psroi_pooling(xt, torch.from_numpy(rois), tt, **kw)
    assert out.shape == (5, 3, 3, 3)
    np.testing.assert_allclose(out.detach().numpy(), jout, atol=1e-5)
    (out ** 2).sum().backward()
    if tr is None:
        gx = jax.grad(lambda x: jax_loss(x, None))(jnp.asarray(x))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5)
    else:
        gx, gt = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(tr))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5)
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt), atol=1e-5)


def test_psroi_rejects_a_channel_count():
    x, rois, _, kw = psroi_inputs()
    with pytest.raises(ValueError, match="output_dim"):
        deform_psroi_pooling(torch.from_numpy(x[..., :5]), torch.from_numpy(rois), **kw)


def test_uncertainty_weights_equal_jax():
    names = ["hm_loss", "bbox_loss", "depth_loss"]
    losses = {n: v for n, v in zip(names, (1.5, 0.25, 3.0))}
    log_var = init_log_variances(names)
    assert all(p.item() == 0 for p in log_var.values())
    with torch.no_grad():
        for n, s in zip(names, (0.3, -0.2, 1.1)):
            log_var[n].fill_(s)
    enabled = {"hm_loss": True, "bbox_loss": False, "depth_loss": True}
    for en in (None, enabled):
        out, reg = apply_uncertainty_weights({n: torch.tensor(v) for n, v in losses.items()},
                                             log_var, en)
        jout, jreg = jax_uncertainty.apply_uncertainty_weights(
            {n: jnp.asarray(v) for n, v in losses.items()},
            {n: jnp.asarray(log_var[n].item()) for n in names}, en)
        for n in names:
            assert out[n].item() == pytest.approx(float(jout[n]), rel=1e-6)
        assert reg.item() == pytest.approx(float(jreg), rel=1e-6)
    reg.backward()
    assert log_var["hm_loss"].grad is not None and log_var["bbox_loss"].grad is None
    assert sorted(jax_uncertainty.init_log_variances(names)) == sorted(log_var)


def test_adaptive_grad_clip_follows_optax():
    """Five steps of gradients of growing norm: the same scale each step and
    the same clipped gradients as the optax transform."""
    rng = np.random.RandomState(3)
    shapes = [(4, 3), (5,)]
    params = [torch.nn.Parameter(torch.zeros(s)) for s in shapes]
    ours = AdaptiveGradClip(factor=1.5, alpha=0.9)
    tx = adaptive_grad_clip(1.5, 0.9)
    state = tx.init(None)
    for step in range(5):
        grads = [rng.randn(*s).astype(np.float32) * (1 + 2 * step) for s in shapes]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        ours(params)
        updates, state = tx.update([jnp.asarray(g) for g in grads], state)
        for p, u in zip(params, updates):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(u), rtol=1e-6)
        assert float(ours.ema_norm) == pytest.approx(float(state.ema_norm), rel=1e-6)
    assert ours.initialized and bool(state.initialized)
    again = AdaptiveGradClip()
    again.load_state_dict(ours.state_dict())
    assert float(again.ema_norm) == float(ours.ema_norm)


def test_structures_equal_jax():
    rng = np.random.RandomState(4)
    images = [rng.rand(30, 41, 3).astype(np.float32), rng.rand(33, 37, 3).astype(np.float32)]
    for div in (0, 32):
        ours, theirs = to_image_list(images, div), jax_to_image_list(images, div)
        np.testing.assert_array_equal(ours.tensors, theirs.tensors)
        assert ours.image_sizes == theirs.image_sizes and len(ours) == len(theirs) == 2
    p, q = ParamsList((375, 1242)), JaxParamsList((375, 1242))
    for obj in (p, q):
        obj.add_field("cls_ids", np.arange(3))
        obj.add_field("reg_mask", np.ones(3))
    assert p.fields() == q.fields() and len(p) == len(q) == 2 and repr(p) == repr(q)
    assert p.has_field("cls_ids") and not p.has_field("depth")
    np.testing.assert_array_equal(p.get_field("cls_ids"), q.get_field("cls_ids"))


def test_registry_behaves_as_jax():
    for cls in (Registry, JaxRegistry):
        reg = cls()

        @reg.register("a")
        def a():
            return 1

        reg.register("b", 2)
        assert reg["a"] is a and reg["b"] == 2
        with pytest.raises(KeyError, match="already registered"):
            reg.register("a", 3)
    assert all(isinstance(r, Registry) for r in (BACKBONES, PREDICTORS, HEADS))


def test_plain_train_net_is_the_cli():
    r = subprocess.run([sys.executable, "-m", "monoflex_tpu_torch.tools.plain_train_net",
                        "--help"], cwd=REPO, capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0
    for flag in ("--config", "--eval", "--ckpt", "--vis", "--num_chips"):
        assert flag in r.stdout
