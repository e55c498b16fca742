"""GNN layers, the loss, halo sync, full-batch training, layer-wise
inference, the MFG forward, and the NumPy sampler / row store."""
