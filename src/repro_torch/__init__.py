"""PyTorch / CUDA port of the serving and training substrate (NVIDIA Hopper, sm_90a).

Mirrors the sub-package layout of the JAX package so a counterpart is found
by path; imports ``torch`` only and keeps its own copy of the framework-neutral
modules it needs (``configs``, the simulator, the data pipeline).
"""
