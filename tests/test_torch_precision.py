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
from monoflex_tpu_torch.utils.precision import (apply_precision, compute_dtype,
                                                current_precision, resolve_precision)

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
    cfg.TPU.COMPUTE_DTYPE = "float16"
    with pytest.raises(NotImplementedError, match="one of"):
        resolve_precision(cfg)


@pytest.mark.parametrize("name,dtype", [("float32", torch.float32), ("bfloat16", torch.bfloat16)])
def test_bfloat16_keeps_tf32_off(restore_flags, name, dtype):
    """bf16 is a dtype of modules, not a torch flag: TF32 stays off for the
    ops that stay f32, and the flags are those of a float32 config."""
    cfg = tiny_cfg(True)
    cfg.TPU.COMPUTE_DTYPE = name
    assert compute_dtype(cfg) == dtype
    scramble()
    model = build_model(cfg, device="cpu")
    assert current_precision() == resolve_precision(tiny_cfg(True)) == model.precision
    assert not torch.is_autocast_enabled()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    convs = [m for m in model.modules() if hasattr(m, "compute_dtype")]
    assert convs and all(m.compute_dtype == dtype for m in model.backbone.modules()
                         if hasattr(m, "compute_dtype"))
    head = model.heads["predictor"]
    assert head.class_head[0].compute_dtype == head.class_head[1].compute_dtype == dtype
    assert not hasattr(head.class_head[2], "compute_dtype")   # class_out stays f32
