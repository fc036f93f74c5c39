"""One module per assigned architecture (plus the paper's own BERT-base-PiT).

Import side effect: registers the config. ``repro_torch.config.get_config`` loads
all of these lazily.
"""
