"""Hand-written Hopper kernels of the port.

Each kernel lives in ``<name>/`` with three modules, as in the JAX package:
``<name>.py`` launches the CUDA C++ kernel of ``csrc/<name>.cu`` on CUDA
tensors, ``ref.py`` is the plain PyTorch version of the same function, and
``ops.py`` is the wrapper the model calls: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel (or raises).  Each wrapper carries a
plain-integer launch count, ``ops.<fn>.launches``.
"""
