"""Internal implementation packages of the PyTorch port."""
