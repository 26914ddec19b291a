"""curriculum_learning_for_vln_torch — the PyTorch/CUDA port of
``curriculum_learning_for_vln_tpu``.

It keeps the JAX package's module names, so each module's counterpart is
found by its path; the JAX package stays the reference.  The port
imports ``torch`` and never ``jax`` nor anything of the JAX package.  Its
kernels are hand-written CUDA for Hopper (``csrc/``), each beside a plain
PyTorch twin that the CPU runs (``ops/cuda/``).
"""
