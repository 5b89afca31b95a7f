"""Runnable examples of the PyTorch port (``python -m repro_torch.examples.<name>``)."""
