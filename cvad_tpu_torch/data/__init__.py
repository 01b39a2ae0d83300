"""Data of the port: the synthetic dataset and the batching host feed."""
