"""PyTorch/CUDA port of the sRSP protocol simulator (`repro`'s counterpart).

Modules mirror `repro`'s paths and names.  Plain tensor code is PyTorch;
the Pallas kernels of the simulator's main path are hand-written CUDA C++
kernels for Hopper (`csrc/`), launched when their inputs lie on a CUDA
device and replaced by their plain PyTorch versions for CPU tensors
(`kernels/common.py`).  Entry points run on `cuda` unless the caller
passes `device="cpu"`.
"""
