"""mapping of the PyTorch port (see mcslam_tpu_torch/__init__.py)."""
