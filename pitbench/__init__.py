"""The benchmark of the private path's PyTorch and CUDA port
(``repro_torch``): harness, traffic, configurations, metric readers, the
frozen yardstick and the plain reference. Run ``pitbench/run.py``."""
