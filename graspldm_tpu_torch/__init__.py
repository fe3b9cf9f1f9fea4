"""PyTorch/CUDA port of graspldm_tpu's LDM generation path for NVIDIA Hopper.

The package mirrors the layout of :mod:`graspldm_tpu` module for module, so
the counterpart of each file is easy to find. It imports ``torch`` and never
``jax``: the JAX package stays the numerical reference the port is held
against (``tests/test_torch_port_*.py``).

Plain tensor code is PyTorch; the three TPU kernels on the generation path
are hand-written CUDA C++ for ``sm_90a`` (``csrc/``), built with ``nvcc`` at
first use (:mod:`graspldm_tpu_torch.cuda_build`). Each kernel wrapper runs
its plain PyTorch version for CPU tensors and launches the kernel (or raises)
for CUDA tensors.
"""

__version__ = "0.1.0"
