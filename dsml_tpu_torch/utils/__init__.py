"""Config, logging and device selection for the PyTorch port."""
