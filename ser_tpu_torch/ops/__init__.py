"""Numerical ops of the PyTorch port: filterbanks, activations, the log-mel kernel."""
