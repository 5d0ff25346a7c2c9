"""The port runs where jax is not installed: importing its inference and
training paths (and chip_smoke.py, which drives them on the GPU) loads no
jax, flax or triton module and builds or loads no kernel library."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import sys
banned = ("jax", "jaxlib", "flax", "triton")
def loaded():
    return {m for m in sys.modules if m.split(".")[0] in banned}
before = loaded()
import chip_smoke
import monoflex_tpu_torch.config
import monoflex_tpu_torch.data.synthetic
import monoflex_tpu_torch.decode.postprocessor
import monoflex_tpu_torch.losses.loss_computation
import monoflex_tpu_torch.models.detector
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
