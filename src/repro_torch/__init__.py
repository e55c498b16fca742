"""PyTorch port of `repro`, for one NVIDIA H100.

A package of its own beside the JAX reference (`src/repro/`); it imports
torch and NumPy and nothing of JAX or of `repro`. The host layer (graphs,
partitioners, partition books, the tiled-edge layout, the sampler and the
micro-batcher) is kept as NumPy copies of the reference's modules; the
device layer is PyTorch, and every aggregate runs the hand-written CUDA
segment-reduce kernel (`kernels/csrc/segment_reduce.cu`) on CUDA tensors.

Entry points: `python -m repro_torch.launch.gnn_serve` (GNN serving),
`python -m repro_torch.launch.gnn_train` (full-batch and mini-batch
training) and `python -m repro_torch.launch.serve` (LM serving, the dense
family: prefill on the flash kernel, decode on the decode kernel).
"""
