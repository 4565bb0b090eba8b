"""Data parallelism of the PyTorch port: one rank per device (``mesh``,
``multihost``)."""
