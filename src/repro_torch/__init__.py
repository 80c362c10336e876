"""PyTorch/CUDA port of the Magnus serving system.

The JAX package ``repro`` is the reference; this package keeps its own
copies of the modules it needs and imports nothing from it.  Kernels are
hand-written CUDA C++ for Hopper (``csrc/``); their plain PyTorch
versions run where the tensors lie on the CPU."""
