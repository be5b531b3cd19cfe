from .model import (DecoderModel, fuse_projections, init_params,
                    params_from_jax, unstack_layers)

__all__ = ["DecoderModel", "fuse_projections", "init_params",
           "params_from_jax", "unstack_layers"]
