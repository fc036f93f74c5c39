from repro_torch.roofline.analysis import (
    HW,
    active_params,
    model_flops,
    roofline_terms,
)

__all__ = ["roofline_terms", "model_flops", "active_params", "HW"]
