"""The benchmark of the PyTorch/CUDA port (``ser_tpu_torch``): see ``run.py``."""
