"""Numpy-only host utilities, copied from ``dvo_slam_tpu/utils``."""
