from .model import (DecoderModel, fuse_projections, init_params,
                    init_params_quantized, params_from_jax, quantize_params,
                    quantize_params_int4, unstack_layers)

__all__ = ["DecoderModel", "fuse_projections", "init_params",
           "init_params_quantized", "params_from_jax", "quantize_params",
           "quantize_params_int4", "unstack_layers"]
