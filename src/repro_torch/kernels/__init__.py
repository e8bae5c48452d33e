"""Hand-written CUDA kernels for Hopper (sm_90a), one per Pallas kernel of
``repro.kernels``.

Each kernel ships as ``<name>/{csrc/<name>.cu, build.py, ops.py, ref.py}``:
the CUDA source; its ``nvcc`` build into ``build/repro_torch/`` at the
repository root, loaded with ``ctypes``; the wrapper that checks inputs,
launches on the current stream and counts launches; and the plain
PyTorch version the wrapper runs for CPU tensors.
"""
