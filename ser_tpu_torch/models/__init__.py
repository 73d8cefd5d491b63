"""Model families of the PyTorch port: Whisper encoder, attention kernel, MLP head."""
