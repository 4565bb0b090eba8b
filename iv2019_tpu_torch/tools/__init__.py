"""Dataset tools of the PyTorch port."""
