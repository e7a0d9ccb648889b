"""PyTorch/CUDA port of `repro`: the sRSP protocol simulator and the
serving path of the dense/MoE transformer family.

Modules mirror `repro`'s paths and names.  Plain tensor code is PyTorch;
the Pallas kernels of the ported paths are hand-written CUDA C++ kernels
for Hopper (`csrc/`), launched when their inputs lie on a CUDA device
and replaced by their plain PyTorch versions for CPU tensors
(`kernels/common.py`).  Entry points run on `cuda` unless the caller
passes `device="cpu"`; the model runs where its parameters lie.
"""
