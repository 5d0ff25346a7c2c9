"""The frozen reference against the program, at the narrow test size on the
CPU (where the program's DCN runs its plain op too): the same weights, head
maps, losses, gradients and decoded rows, for both configurations."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT
from mfbench import program as prog
from mfbench import synth
from mfbench.harness import tree_with
from mfbench.reference import model as ref
from mfbench.spec import data_file

OBJECTS = {"min": 1, "max": 15, "mean": 4.7}


def setup(config: str, seed: int = 5):
    conf = json.load(open(data_file("configs", config)))
    tree = tree_with(conf["cfg"], {"batch": 2, "height": 96, "width": 320})
    cfg = prog.config(tree)
    model = prog.model(cfg, conf["weights"], seed, "cpu")
    reference, _ = ref.build(tree, conf["weights"], seed, "cpu")
    return conf, tree, cfg, model, reference


@pytest.mark.parametrize("config", ["monoflex-f32", "monoflex-bf16"])
def test_weights_and_forward(config):
    conf, tree, cfg, model, reference = setup(config)
    theirs = dict(reference.state_dict())
    for name, value in model.state_dict().items():
        torch.testing.assert_close(value, theirs[name], rtol=0, atol=0, msg=name)
    batch = prog.to_device(synth.inference_batches(5, 1, batch=2, height=96, width=320,
                                                   objects=OBJECTS)[0], "cpu")
    model.eval()
    reference.eval()
    with torch.no_grad():
        a = model(batch["image"], batch["edge_indices"], batch["edge_len"])
        b = reference(batch["image"], batch["edge_indices"], batch["edge_len"])
    torch.testing.assert_close(a["cls"], b["cls"], rtol=1e-6, atol=1e-7)
    for x, y in zip(a["reg"], b["reg"]):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("config", ["monoflex-f32", "monoflex-bf16"])
def test_losses_gradients_and_steps(config):
    conf, tree, cfg, model, reference = setup(config)
    batches = synth.train_batches(7, 2, batch=2, height=96, width=320, objects=OBJECTS)
    step, optimizer = prog.train_step(cfg, model, 1)
    state = prog.TrainState()
    losses = []
    for i, host in enumerate(batches):
        state, metrics = step(state, prog.to_device(host, "cpu"))
        losses.append(float(metrics["total_loss"]))
        if i == 0:
            grads = ref.norms({n: m / 0.1 for n, m in prog.first_moments(optimizer, model).items()})
    record = ref.train_record(tree, conf["weights"], 5, "cpu", batches, 1)
    assert losses == pytest.approx(record["losses"], rel=1e-6)
    for name, value in record["grad_norms"].items():
        assert grads[name] == pytest.approx(value, rel=1e-5, abs=1e-9), name


@pytest.mark.parametrize("config", ["monoflex-f32", "monoflex-bf16"])
def test_decoded_rows(config):
    conf, tree, cfg, model, reference = setup(config)
    batch = prog.to_device(synth.inference_batches(9, 1, batch=2, height=96, width=320,
                                                   objects=OBJECTS)[0], "cpu")
    rows, valid, extras = prog.eval_step(cfg, model)(batch)
    reference.eval()
    with torch.no_grad():
        pred = reference(batch["image"], batch["edge_indices"], batch["edge_len"])
        ref_rows, ref_valid, ref_extras = ref.decoder(tree)(pred, batch)
    torch.testing.assert_close(rows, ref_rows, rtol=1e-5, atol=1e-5)
    assert torch.equal(extras["points"], ref_extras["points"])


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import mfbench.reference.model, mfbench.reference.dcn; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"monoflex_tpu_torch", "monoflex_tpu", "jax", "jaxlib", "flax"}
