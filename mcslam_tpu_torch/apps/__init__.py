"""apps of the PyTorch port (see mcslam_tpu_torch/__init__.py): the SLAM
app (`python -m mcslam_tpu_torch.apps.mc_slam_app`), the EuRoC runner
(`python -m mcslam_tpu_torch.apps.run_euroc`) and the trajectory
evaluation (`python -m mcslam_tpu_torch.apps.evaluate_trajectory`)."""
