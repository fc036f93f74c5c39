"""Training on one device: losses, AdamW, checkpoints, fault handling and
the trainer (the port of ``src/repro/train/``)."""
