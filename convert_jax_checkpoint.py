"""Convert a JAX package (orbax) training checkpoint into the ``.npz`` that
the PyTorch port restores (``monoflex_tpu_torch/train/checkpoint.py``).

Run where JAX is installed (the port itself imports no JAX)::

    python convert_jax_checkpoint.py --config runs/monoflex.yaml \\
        --ckpt output/monoflex/ckpt/model_final --out model_final.npz [KEY VALUE ...]

then, on the card, resume the port from it::

    python -m monoflex_tpu_torch.cli --config runs/monoflex.yaml --ckpt model_final.npz

The orbax directory is restored through the JAX package's ``Checkpointer``
into the ``TrainState`` that the JAX CLI builds for the same config.  The
file holds, under the port's torch names and layouts
(``monoflex_tpu_torch/utils/param_bridge.py``): the parameters and BN
statistics (``model/``), the EMA shadow and its count (``ema/``,
``ema_count``) where the run has one, the Adam moments (``exp_avg/``,
``exp_avg_sq/``) and their update ``count`` (SOLVER.OPTIMIZER adamw, adam or
adam_onecycle), and ``step`` and ``skips``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def find_states(tree, kind):
    """Every optax state of type ``kind`` in an optimizer-state tree."""
    import jax

    return [s for s in jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, kind))
            if isinstance(s, kind)]


def template_state(cfg):
    """The JAX CLI's initial TrainState for ``cfg`` (the restore's shapes and
    structure; parameter shapes do not depend on the input size)."""
    import jax
    import jax.numpy as jnp

    from monoflex_tpu.data.synthetic import make_dummy_batch
    from monoflex_tpu.models.detector import build_model
    from monoflex_tpu.train.solver import build_optimizer
    from monoflex_tpu.train.train_step import TrainState

    model = build_model(cfg)
    batch = make_dummy_batch(1, 64, 128)
    variables = jax.jit(lambda key, *a: model.init(key, *a, train=False))(
        jax.random.PRNGKey(0), *(jnp.asarray(batch[k])
                                 for k in ("image", "edge_indices", "edge_len")))
    tx, _ = build_optimizer(cfg, variables["params"])
    return TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                      batch_stats=variables["batch_stats"],
                      opt_state=tx.init(variables["params"]), skips=jnp.zeros((), jnp.int32))


def configs(config: str, opts=()):
    """The run's config in each package: the same YAML and overrides."""
    from monoflex_tpu.config import get_cfg_defaults as jax_defaults
    from monoflex_tpu_torch.config import get_cfg_defaults

    out = []
    for defaults in (jax_defaults, get_cfg_defaults):
        cfg = defaults()
        cfg.merge_from_file(config)
        cfg.merge_from_list(list(opts))
        out.append(cfg)
    return out


def convert(config: str, ckpt: str, out: str, opts=(), template=None) -> Dict[str, np.ndarray]:
    """Restore ``ckpt`` (into ``template``, by default the JAX CLI's state
    for the config) and write the port's ``.npz`` to ``out``; returns its
    arrays."""
    import jax
    import optax

    from monoflex_tpu.train.checkpoint import Checkpointer
    from monoflex_tpu.train.solver import ParamEmaState
    from monoflex_tpu_torch.utils.param_bridge import flax_to_state_dict

    cfg, pcfg = configs(config, opts)
    template = template_state(cfg) if template is None else template
    ckpt = os.path.abspath(ckpt)
    state, _ = Checkpointer(os.path.dirname(ckpt)).load(template, ckpt)
    state = jax.device_get(state)

    def torch_tree(params, prefix, with_stats=False) -> Dict[str, np.ndarray]:
        """A params-shaped tree under the port's names and layouts; the BN
        statistics only with the weights themselves."""
        named = flax_to_state_dict(params, state.batch_stats, pcfg)
        return {prefix + n: v.numpy() for n, v in named.items() if with_stats or not _is_stat(n)}

    arrays: Dict[str, np.ndarray] = {}
    arrays.update(torch_tree(state.params, "model/", with_stats=True))
    opt_state = state.opt_state
    ema: Optional[ParamEmaState] = None
    if isinstance(opt_state, ParamEmaState):
        ema, opt_state = opt_state, opt_state.inner
        arrays.update(torch_tree(ema.ema, "ema/"))
        arrays["ema_count"] = np.asarray(int(ema.count))
    else:
        arrays["ema_count"] = np.asarray(0)
    adam = find_states(opt_state, optax.ScaleByAdamState)
    if len(adam) != 1:
        raise ValueError(f"{ckpt}: expected one Adam state in the optimizer's, found "
                         f"{len(adam)} (the converter takes the Adam family)")
    arrays.update(torch_tree(adam[0].mu, "exp_avg/"))
    arrays.update(torch_tree(adam[0].nu, "exp_avg_sq/"))
    arrays["count"] = np.asarray(int(adam[0].count))
    arrays["step"] = np.asarray(int(state.step))
    arrays["skips"] = np.asarray(int(state.skips))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, **arrays)
    return arrays


def _is_stat(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True, help="the run's YAML")
    parser.add_argument("--ckpt", required=True, help="the orbax checkpoint directory")
    parser.add_argument("--out", required=True, help="the .npz to write")
    parser.add_argument("opts", nargs="*", help="the run's KEY VALUE overrides")
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)
    arrays = convert(args.config, args.ckpt, args.out, args.opts)
    print(f"wrote {args.out}: step {int(arrays['step'])}, "
          f"{sum(k.startswith('model/') for k in arrays)} tensors, moments "
          f"{sorted({k.split('/')[0] for k in arrays if '/' in k} - {'model', 'ema'})}, "
          f"EMA {'yes' if any(k.startswith('ema/') for k in arrays) else 'no'}")


if __name__ == "__main__":
    main()
