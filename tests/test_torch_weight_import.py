"""Reference PyTorch checkpoints into the port (``utils/weight_import.py``)
against the JAX package's importers on the same file.

One seeded reference-format state dict (the narrow model of
``test_torch_slice.py`` with perturbed offsets, upsampling kernels and
BatchNorms; saved as the reference saves it, under ``model`` with DDP's
``module.`` prefix) goes into the port through ``load_reference_checkpoint``
and into flax through ``import_monoflex_checkpoint``; the two forwards then
agree to 1e-4 abs on the head maps (float32 on both sides, summation order
only, as ``test_torch_slice.py``).  The ImageNet DLA-34 map names the JAX
``dla34_name_map``'s torch names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoflex_tpu.utils.dla34_import import dla34_name_map as jax_dla34_name_map
from monoflex_tpu.utils.monoflex_import import import_monoflex_checkpoint
from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.data.synthetic import make_inference_batch
from monoflex_tpu_torch.models.detector import build_model
from monoflex_tpu_torch.utils.weight_import import (dla34_name_map, load_dla34_backbone,
                                                    load_reference_checkpoint,
                                                    load_torch_state_dict)
from test_torch_slice import (ATOL, RUN_YAML, B, H, W, jax_narrow_model, narrow_cfg,
                              perturbed_port_model, port_narrow_model)


@pytest.fixture(scope="module")
def reference_file(tmp_path_factory):
    """A reference-format checkpoint of the perturbed narrow model."""
    cfg = narrow_cfg()
    source = perturbed_port_model(cfg, seed=11)
    state = {f"module.{k}": v.clone() for k, v in source.state_dict().items()}
    path = tmp_path_factory.mktemp("ref") / "model_moderate_best_soft.pth"
    torch.save({"model": state, "iteration": 7}, path)
    return cfg, source, path


def test_the_loader_reads_the_reference_layout(reference_file):
    _, source, path = reference_file
    state = load_torch_state_dict(str(path))
    assert state.keys() == source.state_dict().keys()
    nested = {"state_dict": {f"module.{k}": v for k, v in source.state_dict().items()}}
    assert load_torch_state_dict(nested).keys() == state.keys()


def test_reference_checkpoint_forward_equals_jax(reference_file):
    cfg, source, path = reference_file
    model = port_narrow_model(cfg)
    report = load_reference_checkpoint(model, str(path))
    assert not report.missing and not report.unexpected
    assert len(report.loaded) == len(source.state_dict())
    for key, value in source.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key

    batch = make_inference_batch(B, H, W)
    inputs = [batch[k] for k in ("image", "edge_indices", "edge_len")]
    jmodel = jax_narrow_model(cfg)
    variables = jax.jit(lambda key, *a: jmodel.init(key, *a, train=False))(
        jax.random.PRNGKey(0), *map(jnp.asarray, inputs))
    torch_sd = {k: v.numpy() for k, v in torch.load(path, weights_only=True)["model"].items()}
    params, stats, missed = import_monoflex_checkpoint(
        variables["params"], variables["batch_stats"], torch_sd, cfg, strict=True)
    assert missed == []
    ref = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        {"params": params, "batch_stats": stats}, *map(jnp.asarray, inputs))
    with torch.no_grad():
        out = model.eval()(*map(torch.from_numpy, inputs))
    np.testing.assert_allclose(out["cls"].permute(0, 2, 3, 1).numpy(), np.asarray(ref["cls"]),
                               atol=ATOL)
    for got, want in zip(out["reg"], ref["reg"]):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=ATOL)


def test_strict_load_reports_what_differs(reference_file):
    cfg, source, _ = reference_file
    state = {k: v for k, v in source.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    # num_batches_tracked is optional
    assert not load_reference_checkpoint(port_narrow_model(cfg), state).missing
    state.pop("heads.predictor.class_head.2.bias")
    state["heads.predictor.extra.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="1 missing .*class_head.2.bias.*1 unexpected"):
        load_reference_checkpoint(port_narrow_model(cfg), state)
    report = load_reference_checkpoint(port_narrow_model(cfg), state, strict=False)
    assert report.missing == ["heads.predictor.class_head.2.bias"]
    assert report.unexpected == ["heads.predictor.extra.weight"]


def test_dla34_map_names_the_jax_maps_torch_names():
    ours = dla34_name_map()
    assert set(ours) == set(jax_dla34_name_map())
    assert all(v == "backbone.base." + k for k, v in ours.items())


def test_dla34_trunk_loads_into_the_full_model(tmp_path):
    """An ImageNet-format trunk file (with its classifier) loads into
    ``backbone.base`` of the full-width model; the rest keeps its weights."""
    cfg = get_cfg_defaults()
    cfg.merge_from_file(RUN_YAML)
    donor = build_model(cfg, device="cpu", seed=3).state_dict()
    trunk = {k[len("backbone.base."):]: v.clone() for k, v in donor.items()
             if k.startswith("backbone.base.")}
    trunk.update({"fc.weight": torch.zeros(1000, 512, 1, 1), "fc.bias": torch.zeros(1000)})
    torch.save(trunk, tmp_path / "dla34-ba72cf86.pth")
    model = build_model(cfg, device="cpu", seed=4)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    report = load_dla34_backbone(model, str(tmp_path / "dla34-ba72cf86.pth"))
    assert report.ignored == ["fc.bias", "fc.weight"]
    assert not report.missing and not report.unexpected
    for key, value in model.state_dict().items():
        want = donor[key] if key.startswith("backbone.base.") else before[key]
        assert torch.equal(value, want), key
    trunk.pop("level5.root.conv.weight")
    with pytest.raises(ValueError, match="1 missing"):
        load_dla34_backbone(model, trunk)
