"""Henjou-Torch: the Henjou path tracer on PyTorch and CUDA.

A port of the JAX package ``henjou_tpu`` (which stays the reference) to
PyTorch tensors and hand-written CUDA kernels for NVIDIA Hopper (sm_90a).
Every module keeps the subpackage path and module name of the JAX file it
ports, so ``henjou_torch/accel/pallas_binned.py`` is the counterpart of
``henjou_tpu/accel/pallas_binned.py``.

This package imports ``torch`` and ``numpy`` and never ``jax``. Its CUDA
kernels live in ``csrc/`` and are compiled with ``nvcc`` on first use
(``henjou_torch.csrc.load_library``):

- ``csrc/binned.cu``: the binned closest-hit / any-hit intersector (the
  renderer's, and the two-sample MIS light query above
  ``runtime/scene_accel.py``'s BINNED_LIGHT_THRESHOLD lights);
- ``csrc/bitonic.cu``: the payload-carrying ray sort and its inverse;
- ``csrc/cluster.cu``, ``csrc/cluster_hbm.cu``, ``csrc/mxu.cu``: the flat,
  two-level and matrix-form cluster intersectors, which the scale probe
  ``python -m henjou_torch.tools.scale_test`` and the tests drive.

Each kernel's wrapper runs the kernel for CUDA tensors and the plain
PyTorch version of the same contract for CPU tensors.
"""

__version__ = "0.1.0"
