"""GNN layers, the loss, halo sync, full-batch training, layer-wise
inference, mini-batch training (the MFG forward, the batch pipeline), and
the NumPy sampler / row store."""
