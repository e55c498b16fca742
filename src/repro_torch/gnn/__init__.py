"""GNN layers, halo sync, layer-wise inference, the MFG forward, and the
NumPy sampler / row store."""
