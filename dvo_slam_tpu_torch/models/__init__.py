"""Dense tracker and frame-to-frame odometry (PyTorch)."""
