"""sceneverse_tpu_torch — PyTorch + CUDA port of sceneverse_tpu for NVIDIA
Hopper (H100).

The JAX package (``sceneverse_tpu``) is the reference this package is held
against. The framework-free parts the port needs (config, registry, the
synthetic dataset, the metrics logger) are copies kept in this package;
nothing here imports ``jax``, ``flax`` or the JAX package.

Every Pallas kernel on the GPS pretrain path has a hand-written CUDA C++
counterpart under ``csrc/`` (built with nvcc at first use, bound with
ctypes, see ``ops/_build.py``) and a plain PyTorch twin beside its wrapper.
CPU tensors take the plain twin; CUDA tensors launch the kernel.
"""

__version__ = "0.1.0"
