from repro_torch.roofline.analysis import (RooflineResult, collective_bytes,
                                           model_flops, roofline_terms)

__all__ = ["collective_bytes", "roofline_terms", "model_flops",
           "RooflineResult"]
