"""Internal package of the PyTorch port (mirrors the ser_tpu path of the same name)."""
