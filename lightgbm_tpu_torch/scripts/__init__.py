"""Experiment entry points of the port (``python -m
lightgbm_tpu_torch.scripts.<name>``)."""
