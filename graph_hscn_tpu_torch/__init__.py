"""graph-hscn-tpu, ported to PyTorch and CUDA for the NVIDIA H100.

The counterpart of ``graph_hscn_tpu`` module for module.  Each TPU kernel
of the JAX package becomes a kernel written by hand for Hopper (``csrc/``,
bound in ``ops/cuda/``), beside a plain PyTorch version of the same
function that the CPU runs and the kernel is held against.
"""
