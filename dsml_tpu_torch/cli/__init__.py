"""Entry points of the port (``python -m dsml_tpu_torch.cli.<name>``)."""
