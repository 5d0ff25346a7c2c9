"""The port's matmul/convolution precision follows the config (ROADMAP C8):
``build_model`` and the entry points that build or receive a model set
torch's TF32 and cuDNN-autotune flags from it, whatever they were before."""

import os

import pytest
import torch

from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.decode.postprocessor import PostProcessor
from monoflex_tpu_torch.losses.loss_computation import LossComputer
from monoflex_tpu_torch.models.detector import build_model
from monoflex_tpu_torch.train.solver import build_optimizer
from monoflex_tpu_torch.train.train_step import make_eval_step, make_train_step
from monoflex_tpu_torch.utils.precision import (apply_precision, current_precision,
                                                resolve_precision)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_flags():
    saved = current_precision()
    yield
    apply_precision(saved)


def tiny_cfg(benchmark: bool):
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, "runs", "monoflex.yaml"))
    cfg.CUDNN_BENCHMARK = benchmark
    return cfg


def scramble():
    """Set every flag to the opposite of what a float32 config resolves to."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = not torch.backends.cudnn.benchmark


@pytest.mark.parametrize("benchmark", [True, False])
def test_build_model_sets_the_flags_of_its_config(restore_flags, benchmark):
    cfg = tiny_cfg(benchmark)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = not benchmark
    model = build_model(cfg, device="cpu")
    want = {"cuda.matmul.allow_tf32": False, "cudnn.allow_tf32": False,
            "cudnn.benchmark": benchmark}
    assert resolve_precision(cfg) == want
    assert current_precision() == want
    assert model.precision == want


@pytest.mark.parametrize("benchmark", [True, False])
def test_steps_apply_the_model_precision(restore_flags, benchmark):
    """make_train_step and make_eval_step take the flags from the model's
    config again, after something else changed them."""
    cfg = tiny_cfg(benchmark)
    model = build_model(cfg, device="cpu")
    scramble()
    make_eval_step(model, PostProcessor(cfg))
    assert current_precision() == model.precision
    scramble()
    optimizer, _, _ = build_optimizer(cfg, model)
    make_train_step(model, LossComputer(cfg), optimizer)
    assert current_precision() == model.precision


def test_inference_applies_the_config(restore_flags, tmp_path, monkeypatch):
    """inference() sets the flags of its cfg before the first eval step."""
    from monoflex_tpu_torch.engine import inference as inf

    cfg = tiny_cfg(False)
    seen = []

    def fake_sweep(*args, **kwargs):
        seen.append(current_precision())
        return {}

    monkeypatch.setattr(inf, "compute_on_dataset", fake_sweep)
    monkeypatch.setattr(inf, "make_test_loader", lambda *a, **k: None)
    scramble()

    class NoLabels:
        root = str(tmp_path)
        split = "test"

    assert inf.inference(cfg, None, NoLabels(), str(tmp_path / "out"), device="cpu") == {}
    assert seen == [resolve_precision(cfg)]


def test_other_compute_dtypes_raise():
    cfg = tiny_cfg(True)
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    with pytest.raises(NotImplementedError, match="only float32"):
        resolve_precision(cfg)
