"""The segment-reduce kernel (CUDA C++ under csrc/), its wrapper, its plain
PyTorch version, and the dispatching `ops` front."""
