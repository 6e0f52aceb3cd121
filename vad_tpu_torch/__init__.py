"""PyTorch / CUDA port of the video anomaly-detection system.

A second package beside the JAX one: the same models, weights and scoring
semantics, run eagerly in PyTorch with hand-written CUDA kernels (sm_90a)
in place of the Pallas TPU kernels.  Importing it has no side effects: no
device is touched and no kernel is built until an entry point runs.

Entry points take ``device=None``, which means ``"cuda"``; with no CUDA
device they raise instead of running on the CPU.  Pass ``device="cpu"``
explicitly to run the plain PyTorch versions of the kernels.
"""
