"""Flax ``params`` + ``batch_stats`` (as numpy) -> the port's state dict.

The port's modules carry the reference torch model's names.  ``name_map``
gives, for each of them, the JAX model's flax path (the same map as the JAX
package's checkpoint importer, kept here as the port's own copy); the bridge
runs it in reverse and inverts the JAX package's layout converters.  It is
strict: every flax leaf and every state-dict entry is used exactly once, or
it raises.  BatchNorm's ``num_batches_tracked`` counters have no flax
counterpart and are set to 0.

Flax naming facts the map relies on (linen auto-names, in creation order in
each scope): a Tree creates its projection conv first (Conv_0/BatchNorm_0
when present), then BasicBlock_0/1 (levels == 1) or Tree_0/Tree_1, then
Root_0; a BasicBlock has Conv_0/BatchNorm_0 then Conv_1/BatchNorm_1; the
DLA stem is Conv_0/BatchNorm_0, then ConvBnRelu_0 (level0), ConvBnRelu_1
(level1), Tree_0..Tree_3 (levels 2-5).  A DeformConvBlock is DCN_0 (with
its offset/mask conv Conv_0, kernel and bias) + BatchNorm_0.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_STATS = "stats:"
# DLA-34: levels per stage and widths
_LEVELS = (1, 1, 1, 2, 2, 1)
_CHANNELS = (16, 32, 64, 128, 256, 512)


def _conv_bn(torch_conv: str, torch_bn: str, flax_scope: str,
             conv_name: str = "Conv_0", bn_name: str = "BatchNorm_0") -> Dict[str, str]:
    return {
        f"{torch_conv}.weight": f"{flax_scope}/{conv_name}/kernel",
        f"{torch_bn}.weight": f"{flax_scope}/{bn_name}/scale",
        f"{torch_bn}.bias": f"{flax_scope}/{bn_name}/bias",
        f"{torch_bn}.running_mean": f"{_STATS}{flax_scope}/{bn_name}/mean",
        f"{torch_bn}.running_var": f"{_STATS}{flax_scope}/{bn_name}/var",
    }


def _tree(torch_prefix: str, flax_scope: str, levels: int, in_ch: int,
          out_ch: int) -> Dict[str, str]:
    m: Dict[str, str] = {}
    if in_ch != out_ch:
        m.update(_conv_bn(f"{torch_prefix}.project.0", f"{torch_prefix}.project.1", flax_scope))
    if levels == 1:
        for i in (1, 2):
            block, scope = f"{torch_prefix}.tree{i}", f"{flax_scope}/BasicBlock_{i - 1}"
            m.update(_conv_bn(f"{block}.conv1", f"{block}.bn1", scope, "Conv_0", "BatchNorm_0"))
            m.update(_conv_bn(f"{block}.conv2", f"{block}.bn2", scope, "Conv_1", "BatchNorm_1"))
        m.update(_conv_bn(f"{torch_prefix}.root.conv", f"{torch_prefix}.root.bn",
                          f"{flax_scope}/Root_0"))
    else:
        m.update(_tree(f"{torch_prefix}.tree1", f"{flax_scope}/Tree_0", levels - 1, in_ch, out_ch))
        m.update(_tree(f"{torch_prefix}.tree2", f"{flax_scope}/Tree_1", levels - 1, out_ch,
                       out_ch))
    return m


def _dla34(scope: str) -> Dict[str, str]:
    m = _conv_bn("base_layer.0", "base_layer.1", scope)
    m.update(_conv_bn("level0.0", "level0.1", f"{scope}/ConvBnRelu_0"))
    m.update(_conv_bn("level1.0", "level1.1", f"{scope}/ConvBnRelu_1"))
    for i in range(4):
        m.update(_tree(f"level{i + 2}", f"{scope}/Tree_{i}", _LEVELS[i + 2], _CHANNELS[i + 1],
                       _CHANNELS[i + 2]))
    return m


def _deform_conv(torch_prefix: str, flax_scope: str) -> Dict[str, str]:
    dcn = f"{flax_scope}/DCN_0"
    bn = f"{flax_scope}/BatchNorm_0"
    return {
        f"{torch_prefix}.conv.weight": f"{dcn}/kernel",
        f"{torch_prefix}.conv.bias": f"{dcn}/bias",
        f"{torch_prefix}.conv.conv_offset_mask.weight": f"{dcn}/Conv_0/kernel",
        f"{torch_prefix}.conv.conv_offset_mask.bias": f"{dcn}/Conv_0/bias",
        f"{torch_prefix}.actf.0.weight": f"{bn}/scale",
        f"{torch_prefix}.actf.0.bias": f"{bn}/bias",
        f"{torch_prefix}.actf.0.running_mean": f"{_STATS}{bn}/mean",
        f"{torch_prefix}.actf.0.running_var": f"{_STATS}{bn}/var",
    }


def _ida_up(torch_prefix: str, flax_scope: str, n_layers: int) -> Dict[str, str]:
    m: Dict[str, str] = {}
    for j in range(1, n_layers):
        m.update(_deform_conv(f"{torch_prefix}.proj_{j}", f"{flax_scope}/proj_{j}"))
        m.update(_deform_conv(f"{torch_prefix}.node_{j}", f"{flax_scope}/node_{j}"))
        m[f"{torch_prefix}.up_{j}.weight"] = f"{flax_scope}/up_{j}/kernel"
    return m


def _conv1d_stack(torch_prefix: str, flax_scope: str, use_bn: bool) -> Dict[str, str]:
    """Sequential[conv1d, norm, act, conv1d] -> flax Conv1DStack."""
    m = {
        f"{torch_prefix}.0.weight": f"{flax_scope}/Conv_0/kernel",
        f"{torch_prefix}.0.bias": f"{flax_scope}/Conv_0/bias",
        f"{torch_prefix}.3.weight": f"{flax_scope}/Conv_1/kernel",
        f"{torch_prefix}.3.bias": f"{flax_scope}/Conv_1/bias",
    }
    if use_bn:
        bn = f"{flax_scope}/BatchNorm_0"
        m.update({
            f"{torch_prefix}.1.weight": f"{bn}/scale",
            f"{torch_prefix}.1.bias": f"{bn}/bias",
            f"{torch_prefix}.1.running_mean": f"{_STATS}{bn}/mean",
            f"{torch_prefix}.1.running_var": f"{_STATS}{bn}/var",
        })
    return m


def name_map(cfg) -> Dict[str, str]:
    """{torch name: flax path} of the whole model (trunk, DCN neck, heads);
    a path starting with ``stats:`` lies in ``batch_stats``."""
    m = {f"backbone.base.{k}": v for k, v in _dla34("backbone/base").items()}
    # DLAUp: ida_0 over 2 layers, ida_1 over 3, ida_2 over 4; final IDAUp over 3
    for i, n_layers in enumerate((2, 3, 4)):
        m.update(_ida_up(f"backbone.dla_up.ida_{i}", f"backbone/dla_up/ida_{i}", n_layers))
    m.update(_ida_up("backbone.ida_up", "backbone/ida_up", 3))

    p = "heads.predictor"
    m.update(_conv_bn(f"{p}.class_head.0", f"{p}.class_head.1", "predictor/class_tower"))
    m[f"{p}.class_head.2.weight"] = "predictor/class_out/kernel"
    m[f"{p}.class_head.2.bias"] = "predictor/class_out/bias"
    for gi, group in enumerate(cfg.MODEL.HEAD.REGRESSION_HEADS):
        m.update(_conv_bn(f"{p}.reg_features.{gi}.0", f"{p}.reg_features.{gi}.1",
                          f"predictor/reg_tower_{gi}"))
        for ki, key in enumerate(group):
            m[f"{p}.reg_heads.{gi}.{ki}.weight"] = f"predictor/reg_out_{key}/kernel"
            m[f"{p}.reg_heads.{gi}.{ki}.bias"] = f"predictor/reg_out_{key}/bias"
    if cfg.MODEL.HEAD.ENABLE_EDGE_FUSION:
        use_bn = cfg.MODEL.HEAD.EDGE_FUSION_NORM == "BN"
        for name in ("trunc_heatmap_conv", "trunc_offset_conv"):
            m.update(_conv1d_stack(f"{p}.{name}", f"predictor/{name}", use_bn))
    return m


def flatten_params(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested mapping -> {"a/b/c": leaf as numpy}."""
    out = {}
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            out.update(flatten_params(v, f"{prefix}/{k}" if prefix else str(k)))
    else:
        out[prefix] = np.asarray(tree)
    return out


def hwio_to_oihw(w: np.ndarray) -> np.ndarray:
    """flax conv (kh, kw, I, O) -> torch (O, I, kh, kw); also depthwise
    (kh, kw, 1, C) -> (C, 1, kh, kw), the transposed-conv weight."""
    return np.transpose(w, (3, 2, 0, 1))


def conv1d_to_torch(w: np.ndarray) -> np.ndarray:
    """flax conv1d (k, I, O) -> torch (O, I, k)."""
    return np.transpose(w, (2, 1, 0))


def _to_torch_layout(w: np.ndarray) -> np.ndarray:
    if w.ndim == 4:
        return hwio_to_oihw(w)
    if w.ndim == 3:
        return conv1d_to_torch(w)
    return w


def flax_to_state_dict(params: Any, batch_stats: Any, cfg) -> Dict[str, torch.Tensor]:
    """Every flax leaf, renamed and re-laid-out to the port's torch names."""
    trees = {False: flatten_params(params), True: flatten_params(batch_stats)}
    used = set()
    state: Dict[str, torch.Tensor] = {}
    for torch_name, flax_path in name_map(cfg).items():
        is_stat = flax_path.startswith(_STATS)
        path = flax_path[len(_STATS):] if is_stat else flax_path
        if path not in trees[is_stat]:
            raise KeyError(f"{torch_name}: no flax leaf {flax_path}")
        if (is_stat, path) in used:
            raise KeyError(f"{torch_name}: flax leaf {flax_path} mapped twice")
        used.add((is_stat, path))
        state[torch_name] = torch.from_numpy(
            np.array(_to_torch_layout(np.asarray(trees[is_stat][path], np.float32))))
    unused = sorted((_STATS if s else "") + p for s in (False, True) for p in trees[s]
                    if (s, p) not in used)
    if unused:
        raise KeyError(f"flax leaves with no torch name: {unused}")
    return state


def load_flax_variables(model: torch.nn.Module, params: Any, batch_stats: Any, cfg) -> None:
    """Load a flax model's variables into ``model``, strictly."""
    state = flax_to_state_dict(params, batch_stats, cfg)
    expected = model.state_dict()
    for name, value in expected.items():
        if name.endswith("num_batches_tracked"):
            state[name] = torch.zeros_like(value)
    missing = sorted(set(expected) - set(state))
    unexpected = sorted(set(state) - set(expected))
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing}, unexpected {unexpected}")
    for name, value in state.items():
        if value.shape != expected[name].shape:
            raise ValueError(f"{name}: flax gives {tuple(value.shape)}, "
                             f"model has {tuple(expected[name].shape)}")
    model.load_state_dict(state, strict=True)
