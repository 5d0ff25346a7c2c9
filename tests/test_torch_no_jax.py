"""The port stands alone: importing its inference, training (the CLI, the
loop, checkpoints, launch and data parallelism), evaluation and
kernel-diagnostics paths, every model configuration (the dlav0 family, the
compute-dtype layers, FCOS3D) and the DCN offset guard, the C++ evaluator's loader,
the visualizer, the reference-checkpoint loader, the multi-process dry run,
the small modules (PSROI pooling, uncertainty weights, adaptive clipping,
structures, registry), the tools (convergence gate, offset statistics,
FLOPs, the plain_train_net shim, the kernel and upsampling sweeps) and the
benchmark entry points (bench, benchmark_train, entry) (and chip_smoke.py,
which drives them on the GPU) loads no jax, flax or triton module, no module of the JAX package
``monoflex_tpu``, and builds or loads no kernel library."""

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
import monoflex_tpu_torch.bench
import monoflex_tpu_torch.cli
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
import monoflex_tpu_torch.decode.fcos3d
import monoflex_tpu_torch.models.backbone.resnet
import monoflex_tpu_torch.models.fpn
import monoflex_tpu_torch.models.heads.fcos3d
import monoflex_tpu_torch.engine.defaults
import monoflex_tpu_torch.engine.inference
import monoflex_tpu_torch.engine.launch
import monoflex_tpu_torch.engine.test_net
import monoflex_tpu_torch.engine.trainer
import monoflex_tpu_torch.entry
import monoflex_tpu_torch.eval
import monoflex_tpu_torch.losses.loss_computation
import monoflex_tpu_torch.losses.uncertainty
import monoflex_tpu_torch.models.backbone.dlav0
import monoflex_tpu_torch.models.detector
import monoflex_tpu_torch.models.heads.key2channel
import monoflex_tpu_torch.models.layers
import monoflex_tpu_torch.native
import monoflex_tpu_torch.ops.dcn_ablate
import monoflex_tpu_torch.ops.psroi
import monoflex_tpu_torch.ops.relayout
import monoflex_tpu_torch.ops.rotated_iou
import monoflex_tpu_torch.parallel.dryrun
import monoflex_tpu_torch.parallel.mesh
import monoflex_tpu_torch.structures
import monoflex_tpu_torch.train.checkpoint
import monoflex_tpu_torch.train.grad_clip
import monoflex_tpu_torch.train.solver
import monoflex_tpu_torch.tools.benchmark_train
import monoflex_tpu_torch.tools.bf16_step_spread
import monoflex_tpu_torch.tools.bilinear_ablate
import monoflex_tpu_torch.tools.convergence_run
import monoflex_tpu_torch.tools.flops
import monoflex_tpu_torch.tools.fwd_ablate
import monoflex_tpu_torch.tools.kernel_bench
import monoflex_tpu_torch.tools.kernel_diag
import monoflex_tpu_torch.tools.kernel_sweep
import monoflex_tpu_torch.tools.offset_stats
import monoflex_tpu_torch.tools.plain_train_net
import monoflex_tpu_torch.tools.trace_time
import monoflex_tpu_torch.tools.transpose_ablate
import monoflex_tpu_torch.train.train_step
import monoflex_tpu_torch.utils.backup_files
import monoflex_tpu_torch.utils.comm
import monoflex_tpu_torch.utils.dcn_guard
import monoflex_tpu_torch.utils.envs
import monoflex_tpu_torch.utils.logger
import monoflex_tpu_torch.utils.metric_logger
import monoflex_tpu_torch.utils.param_bridge
import monoflex_tpu_torch.utils.precision
import monoflex_tpu_torch.utils.registry
import monoflex_tpu_torch.utils.trace
import monoflex_tpu_torch.utils.visualizer
import monoflex_tpu_torch.utils.weight_import
from monoflex_tpu_torch.ops import dcn_cuda
new = sorted(loaded() - before)
assert not new, new
assert dcn_cuda._libs is None, "a kernel library was built or loaded at import"
assert monoflex_tpu_torch.native._lib is None, "the evaluator's library was loaded at import"
print("clean")
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"
