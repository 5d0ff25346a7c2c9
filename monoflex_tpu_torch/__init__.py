"""monoflex_tpu_torch: the MonoFlex inference path in PyTorch for NVIDIA Hopper.

A port of ``monoflex_tpu`` (JAX/Pallas on TPU), which stays beside it as the
reference.  Modules keep the JAX package's layout so each counterpart is easy
to find: ``models/backbone/dla.py``, ``models/heads/predictor.py``,
``ops/dcn.py``, ``decode/postprocessor.py``.  The one Pallas kernel on the
inference path (the modulated DCNv2 forward of the neck) is a hand-written
CUDA kernel, ``csrc/dcn_fwd.cu``, built with nvcc at first use.

Nothing here imports jax.  Framework-neutral pieces of the JAX package (the
config tree, the head key map, the numpy weight-name maps, the KITTI writer)
are imported from it directly.
"""

__version__ = "0.1.0"
