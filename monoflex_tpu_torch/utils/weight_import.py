"""Loading reference PyTorch checkpoints into the port (counterpart of the
JAX package's ``utils/weight_import.py``, ``monoflex_import.py`` and
``dla34_import.py``).

The port's ``state_dict`` names and layouts are the reference MonoFlex's
(under ``runs/monoflex.yaml`` the JAX package's ``monoflex_name_map`` lists
the same 412 names), so a reference checkpoint loads by name:

- ``load_torch_state_dict(path)``: the tensors of a ``.pth``, from under
  ``model`` or ``state_dict`` where the file nests them, with a DDP
  ``module.`` prefix stripped;
- ``load_reference_checkpoint(model, path)``: a reference MonoFlex
  checkpoint (reference: utils/check_point.py), loaded strictly;
- ``load_dla34_backbone(model, path)``: the ImageNet DLA-34 trunk
  (``dla34-ba72cf86.pth``; reference: model/backbone/dla_dcn.py:333-344),
  its names mapped onto ``backbone.base.*`` (``dla34_name_map``); its
  classifier (``fc.*``) has no place in the model and is left out.

A file is read with ``torch.load(weights_only=True)``: both reference files
hold only tensors, numbers and dicts of them.  ``num_batches_tracked`` is
optional (flax has no such counter; a file without it keeps the model's).
Each load returns a ``LoadReport`` and logs it; ``strict`` raises on any
name missing from the file or unknown to the model.  A library API, as in
the JAX package, whose CLI restores only its own checkpoints.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Union

import torch

logger = logging.getLogger("monoflex")

_LEVELS = (1, 1, 1, 2, 2, 1)
_CHANNELS = (16, 32, 64, 128, 256, 512)
OPTIONAL_SUFFIX = "num_batches_tracked"

StateDict = Dict[str, torch.Tensor]


@dataclass
class LoadReport:
    """What a load did: names loaded, the model's names the file lacks, the
    file's names the model does not know (and those left out on purpose)."""
    loaded: List[str] = field(default_factory=list)
    missing: List[str] = field(default_factory=list)
    unexpected: List[str] = field(default_factory=list)
    ignored: List[str] = field(default_factory=list)

    def __str__(self) -> str:
        return (f"{len(self.loaded)} loaded, {len(self.missing)} missing, "
                f"{len(self.unexpected)} unexpected, {len(self.ignored)} ignored")


def strip_module_prefix(state: StateDict) -> StateDict:
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in state.items()}


def load_torch_state_dict(path_or_state: Union[str, StateDict]) -> StateDict:
    """The tensors of a checkpoint file (or a state dict already loaded),
    from under ``model`` or ``state_dict`` where nested, ``module.``
    stripped."""
    if isinstance(path_or_state, (str, bytes)) or hasattr(path_or_state, "__fspath__"):
        ckpt = torch.load(path_or_state, map_location="cpu", weights_only=True)
    else:
        ckpt = path_or_state
    for key in ("model", "state_dict"):
        if isinstance(ckpt, dict) and key in ckpt and isinstance(ckpt[key], dict):
            ckpt = ckpt[key]
    return strip_module_prefix({k: v for k, v in ckpt.items() if isinstance(v, torch.Tensor)})


def _conv_bn(conv: str, bn: str) -> List[str]:
    return [f"{conv}.weight", f"{bn}.weight", f"{bn}.bias", f"{bn}.running_mean",
            f"{bn}.running_var"]


def _tree(prefix: str, levels: int, in_ch: int, out_ch: int) -> List[str]:
    names = []
    if in_ch != out_ch:
        names += _conv_bn(f"{prefix}.project.0", f"{prefix}.project.1")
    if levels == 1:
        for block in ("tree1", "tree2"):
            names += _conv_bn(f"{prefix}.{block}.conv1", f"{prefix}.{block}.bn1")
            names += _conv_bn(f"{prefix}.{block}.conv2", f"{prefix}.{block}.bn2")
        names += _conv_bn(f"{prefix}.root.conv", f"{prefix}.root.bn")
    else:
        names += _tree(f"{prefix}.tree1", levels - 1, in_ch, out_ch)
        names += _tree(f"{prefix}.tree2", levels - 1, out_ch, out_ch)
    return names


def dla34_name_map(prefix: str = "backbone.base.") -> Dict[str, str]:
    """{ImageNet DLA-34 name: the port's name} for the trunk, walked as the
    JAX package's ``dla34_name_map`` walks it (levels (1, 1, 1, 2, 2, 1))."""
    names = (_conv_bn("base_layer.0", "base_layer.1") + _conv_bn("level0.0", "level0.1")
             + _conv_bn("level1.0", "level1.1"))
    for i in range(4):
        names += _tree(f"level{i + 2}", _LEVELS[i + 2], _CHANNELS[i + 1], _CHANNELS[i + 2])
    return {name: prefix + name for name in names}


def _load(model: torch.nn.Module, state: StateDict, required, strict: bool, what: str,
          unexpected=(), ignored=()) -> LoadReport:
    """Copy the file's tensors into the model's by name; ``required`` are
    the model's names the file must hold."""
    own = model.state_dict()
    report = LoadReport(loaded=sorted(n for n in state if n in own),
                        missing=sorted(n for n in required if n not in state),
                        unexpected=sorted(set(unexpected) | (set(state) - set(own))),
                        ignored=sorted(ignored))
    bad_shape = [f"{n}: {tuple(state[n].shape)} vs {tuple(own[n].shape)}" for n in report.loaded
                 if state[n].shape != own[n].shape]
    if bad_shape:
        raise ValueError(f"{what}: shapes differ: {bad_shape[:5]}")
    if strict and (report.missing or report.unexpected):
        raise ValueError(f"{what}: {len(report.missing)} missing "
                         f"{report.missing[:5]}, {len(report.unexpected)} unexpected "
                         f"{report.unexpected[:5]}")
    with torch.no_grad():
        for name in report.loaded:
            own[name].copy_(state[name])
    logger.info(f"{what}: {report}")
    return report


def load_reference_checkpoint(model: torch.nn.Module, path_or_state: Union[str, StateDict],
                              strict: bool = True) -> LoadReport:
    """A reference MonoFlex checkpoint into ``model`` by name (every name
    but ``num_batches_tracked`` required under ``strict``)."""
    required = [n for n in model.state_dict() if not n.endswith(OPTIONAL_SUFFIX)]
    return _load(model, load_torch_state_dict(path_or_state), required, strict,
                 "reference checkpoint")


def load_dla34_backbone(model: torch.nn.Module, path_or_state: Union[str, StateDict],
                        strict: bool = True) -> LoadReport:
    """The ImageNet DLA-34 trunk into ``model.backbone.base``; every trunk
    name is required under ``strict``, the classifier is ignored, the rest
    of the model keeps its weights."""
    state = load_torch_state_dict(path_or_state)
    name_map = dla34_name_map()
    own = model.state_dict()
    mapped = {}
    unknown, ignored = [], []
    for name, value in state.items():
        if name in name_map:
            mapped[name_map[name]] = value
        elif name.startswith("fc."):
            ignored.append(name)
        elif name.endswith(OPTIONAL_SUFFIX) and "backbone.base." + name in own:
            mapped["backbone.base." + name] = value
        else:
            unknown.append(name)
    return _load(model, mapped, list(name_map.values()), strict, "DLA-34 trunk",
                 unexpected=unknown, ignored=ignored)
