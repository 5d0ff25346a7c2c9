"""The DCN offset guard (``utils/dcn_guard.py``) against the JAX package's
(``monoflex_tpu/utils/dcn_guard.py``) on the same weights and batch: the
same per-stage rows and the same "auto" suggestion; and the reroute it
drives.

``runs/monoflex.yaml`` with 32-wide heads on the clamped "shift" impl (the
JAX guard test's choice) at 32x64, batch 1.  Weights: seeded values in the JAX
model's shapes (``test_torch_configs.py``) with every offset/mask conv
kernel scaled by 0.1, then ida_0's offset biases set to 7 pixels, past its
clamp (unbounded-trained weights there), the other stages' offsets within
theirs.  Both guards scan under the unbounded gather.  Rows: the stage, impl,
boundedness and R equal; the |offset| percentiles and maximum within 1e-4
relative (f32 both sides, the offsets of 16 convs through the trunk and the
gather neck); the share beyond R within 1e-3.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoflex_tpu.models.detector import build_model as jax_build_model
from monoflex_tpu.utils.dcn_guard import dcn_offset_guard as jax_guard
from monoflex_tpu_torch.data.synthetic import make_inference_batch
from monoflex_tpu_torch.models.backbone.dla import DCN
from monoflex_tpu_torch.models.detector import build_model
from monoflex_tpu_torch.utils.dcn_guard import dcn_offset_guard, reroute, stage_of
from monoflex_tpu_torch.utils.param_bridge import load_flax_variables
from test_torch_configs import FIELDS, cfgs, seeded

STAT_RTOL = 1e-4
FRAC_ATOL = 1e-3


def guard_cfgs(mode):
    port, jax_cfg = cfgs(("TPU.DCN_FORCE_IMPL", "shift"))
    for cfg in (port, jax_cfg):
        cfg.TPU.DCN_OFFSET_GUARD = mode
    return port, jax_cfg


def saturate_ida0(params):
    """Offset/mask kernels x 0.1; ida_0's offset biases at 7 pixels."""
    def walk(tree, path=""):
        for k, v in tree.items():
            p = f"{path}/{k}"
            if hasattr(v, "items"):
                walk(v, p)
            elif p.endswith("DCN_0/Conv_0/kernel"):
                tree[k] = v * np.float32(0.1)
            elif p.endswith("DCN_0/Conv_0/bias") and "/ida_0/" in p:
                tree[k] = v.copy()
                tree[k][:18] = 7.0
    walk(params)
    return params


@pytest.fixture(scope="module")
def sides():
    cfg, jcfg = guard_cfgs("auto")
    batch = make_inference_batch(1, 32, 64)
    jbatch = {k: jnp.asarray(batch[k]) for k in FIELDS}
    # the variables do not depend on the impl: trace the cheap gather model
    jmodel = jax_build_model(cfgs(())[1])
    shapes = jax.eval_shape(lambda *a: jmodel.init(jax.random.PRNGKey(0), *a, train=False),
                            *jbatch.values())
    rs = np.random.RandomState(0)
    params = saturate_ida0(seeded(shapes["params"], rs))
    stats = seeded(shapes["batch_stats"], rs)
    model = build_model(cfg, device="cpu")
    load_flax_variables(model, params, stats, cfg)
    return dict(cfg=cfg, jcfg=jcfg, model=model, variables={"params": params,
                                                             "batch_stats": stats},
                batch={k: torch.from_numpy(batch[k]) for k in FIELDS}, jbatch=jbatch)


def test_auto_gives_the_jax_rows_and_suggestion(sides):
    fired, suggestion, rows = dcn_offset_guard(sides["cfg"], sides["model"], sides["batch"])
    jfired, jsuggestion, jrows = jax_guard(sides["jcfg"], sides["variables"], sides["jbatch"])
    assert fired and jfired
    assert suggestion == jsuggestion == ("gather", "shift", "shift", "shift")
    assert len(rows) == len(jrows) == 4
    for row, jrow in zip(rows, jrows):
        for key in ("stage", "impl", "bounded", "R"):
            assert row[key] == jrow[key], key
        for key in ("p50", "p99", "max"):
            np.testing.assert_allclose(row[key], jrow[key], rtol=STAT_RTOL, err_msg=key)
        assert abs(row["frac_clipped"] - jrow["frac_clipped"]) <= FRAC_ATOL
    assert rows[0]["frac_clipped"] > 0.5 and all(r["frac_clipped"] < 0.05 for r in rows[1:])


def test_the_scan_leaves_the_model_as_it_was(sides):
    model = sides["model"]
    specs = [m.spec for m in model.modules() if isinstance(m, DCN)]
    model.train()
    dcn_offset_guard(sides["cfg"], model, sides["batch"])
    assert model.training
    model.eval()
    assert [m.spec for m in model.modules() if isinstance(m, DCN)] == specs
    assert all(s.impl == "shift" for s in specs)


def test_warn_reports_and_off_skips(sides, caplog):
    cfg, _ = guard_cfgs("warn")
    with caplog.at_level(logging.WARNING, logger="monoflex"):
        fired, suggestion, rows = dcn_offset_guard(cfg, sides["model"], sides["batch"])
    assert fired and suggestion is None and len(rows) == 4
    assert any("DCN OFFSET GUARD" in r.message and "SATURATES" in r.message
               for r in caplog.records)
    cfg, _ = guard_cfgs("off")
    assert dcn_offset_guard(cfg, sides["model"], sides["batch"]) == (False, None, [])


def test_reroute_gives_the_rebuilt_model(sides):
    """The rerouted model computes what a model built with the suggestion
    computes, on the same parameters."""
    cfg, _ = guard_cfgs("auto")
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sides["model"].state_dict())
    params = list(model.parameters())
    reroute(cfg, model, ("gather", "shift", "shift", "shift"))
    assert list(model.parameters()) == params
    assert tuple(cfg.TPU.DCN_IMPL_PER_STAGE) == ("gather", "shift", "shift", "shift")
    stages = {stage_of(n): m.spec.impl for n, m in model.named_modules() if isinstance(m, DCN)}
    assert stages == {0: "gather", 1: "shift", 2: "shift", 3: "shift"}
    rebuilt = build_model(cfg, device="cpu")
    rebuilt.load_state_dict(model.state_dict())
    with torch.no_grad():
        a, b = model(*sides["batch"].values()), rebuilt(*sides["batch"].values())
    assert torch.equal(a["cls"], b["cls"])
    assert all(torch.equal(x, y) for x, y in zip(a["reg"], b["reg"]))


def test_reroute_keeps_the_plain_op_of_a_plain_model(sides):
    """A model built on the plain op stays on it when rerouted onto kernel
    impls."""
    cfg, _ = guard_cfgs("auto")
    model = build_model(cfg, device="cpu", use_dcn_kernel=False)
    reroute(cfg, model, ("gather", "pallas3b", "pallas3b", "pallas3b"))
    specs = {stage_of(n): m.spec for n, m in model.named_modules() if isinstance(m, DCN)}
    assert [specs[k].impl for k in range(4)] == ["gather", "pallas3b", "pallas3b", "pallas3b"]
    assert not any(spec.use_kernel for spec in specs.values())
    kernel_model = build_model(cfg, device="cpu")
    assert all(m.spec.use_kernel for n, m in kernel_model.named_modules()
               if isinstance(m, DCN) and stage_of(n) > 0)


@pytest.mark.parametrize("body", ["dlav0", "dla34_nodcn"])
@pytest.mark.parametrize("mode", ["warn", "auto"])
def test_a_model_without_dcns_gives_no_rows(body, mode):
    """A neck of plain convs has no offsets: no rows, nothing fired, no
    suggestion, the model left as it was.  The JAX guard has no answer to
    compare with here: on the dlav0 family its scan sows nothing and it
    raises KeyError 'intermediates', and on dla34_nodcn it builds a gather
    neck whose DCN parameters a nodcn checkpoint does not have."""
    cfg, _ = cfgs(("MODEL.BACKBONE.CONV_BODY", body))
    cfg.TPU.DCN_OFFSET_GUARD = mode
    batch = make_inference_batch(1, 32, 64)
    model = build_model(cfg, device="cpu").train()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    got = dcn_offset_guard(cfg, model, {k: torch.from_numpy(batch[k]) for k in FIELDS})
    assert got == (False, None, [])
    assert model.training
    assert all(torch.equal(v, state[k]) for k, v in model.state_dict().items())
