"""Host layer: graphs, partitioners, partition books, metrics, cost model
(NumPy copies of the reference's modules), and the device helper."""
