"""monoflex_tpu_torch: MonoFlex in PyTorch for NVIDIA Hopper.

A port of ``monoflex_tpu`` (JAX/Pallas on TPU), which stays beside it as the
reference.  Modules keep the JAX package's layout so each counterpart is easy
to find: ``models/backbone/dla.py``, ``models/heads/predictor.py``,
``ops/dcn.py``, ``decode/postprocessor.py``, ``train/train_step.py``,
``engine/inference.py``.  It serves inference, the training step and the
evaluation path.  The Pallas kernels of the neck's modulated DCNv2 are
hand-written CUDA kernels in ``csrc/``, built with nvcc at first use.

Nothing here imports jax or the JAX package: the framework-neutral pieces
it needs (the config tree, the head key map, the weight-name maps, the
numpy geometry, the KITTI reader, loader, writer and evaluator) are copies.
"""

__version__ = "0.1.0"
