"""The port stands alone: importing its inference, training and evaluation
paths (and chip_smoke.py, which drives them on the GPU) loads no jax, flax
or triton module, no module of the JAX package ``monoflex_tpu``, and builds
or loads no kernel library."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import sys
banned = ("jax", "jaxlib", "flax", "triton", "monoflex_tpu")
def loaded():
    return {m for m in sys.modules if m.split(".")[0] in banned}
before = loaded()
import chip_smoke
import monoflex_tpu_torch.config
import monoflex_tpu_torch.core.geometry_np
import monoflex_tpu_torch.core.heatmap
import monoflex_tpu_torch.data.augmentations
import monoflex_tpu_torch.data.dataset
import monoflex_tpu_torch.data.kitti_objects
import monoflex_tpu_torch.data.loader
import monoflex_tpu_torch.data.synthetic
import monoflex_tpu_torch.data.target_encoder
import monoflex_tpu_torch.decode.diagnostics
import monoflex_tpu_torch.decode.kitti_writer
import monoflex_tpu_torch.decode.nms
import monoflex_tpu_torch.decode.postprocessor
import monoflex_tpu_torch.engine.inference
import monoflex_tpu_torch.engine.test_net
import monoflex_tpu_torch.eval
import monoflex_tpu_torch.losses.loss_computation
import monoflex_tpu_torch.models.detector
import monoflex_tpu_torch.models.heads.key2channel
import monoflex_tpu_torch.ops.rotated_iou
import monoflex_tpu_torch.train.solver
import monoflex_tpu_torch.train.train_step
import monoflex_tpu_torch.utils.param_bridge
from monoflex_tpu_torch.ops import dcn_cuda
new = sorted(loaded() - before)
assert not new, new
assert dcn_cuda._libs is None, "a kernel library was built or loaded at import"
print("clean")
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"
