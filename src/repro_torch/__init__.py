"""PyTorch / CUDA port of the ``repro`` serving system, for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package imports
nothing of it (nor ``jax``).  Host-side modules (configs, the contention
clock, the cost model, the scheduler) are the reference's own code, copied;
the model path runs in PyTorch and, on the card, through the hand-written
CUDA kernels under ``repro_torch.kernels``.  Every entry point takes an
explicit ``device`` (default ``"cuda"``) and never falls back to the CPU.
"""
