"""The benchmark of dvo_slam_tpu_torch, the PyTorch and CUDA port: one cell
a run (``run.py``), cells found by name from the files of ``configs/``,
``workloads/``, ``traffic/`` and ``metrics/``, each run checked against the
plain reference of ``reference/``."""
