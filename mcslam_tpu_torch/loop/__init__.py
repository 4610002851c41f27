"""loop of the PyTorch port (see mcslam_tpu_torch/__init__.py): the BoW
vocabulary, loop detection, relocalization and fast tracking."""
