"""PyTorch/CUDA port of the P2M sensor + sparse-BNN serving stack.

Mirrors ``src/repro``'s layout module for module. The port runs on an NVIDIA
GPU through hand-written CUDA kernels (``csrc/``); every kernel wrapper also
carries a plain PyTorch version that is used for tensors on the CPU.
"""
