"""Online GNN serving: the micro-batcher (NumPy copy) and the engine."""
