from repro_torch.models.transformer import init_params, forward, init_caches

__all__ = ["init_params", "forward", "init_caches"]
