"""Plain PyTorch and NumPy references that decide a run's ``correct``; they import nothing of the port."""
