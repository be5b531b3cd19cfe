from .hf_import import (params_from_hf_gemma2, params_from_hf_gemma3,
                        params_from_hf_gpt2, params_from_hf_llama,
                        params_from_hf_phi3)
from .hf_stream import (ShardReader, config_from_hf, import_hf_streaming,
                        load_flat_params)
from .model import (DecoderModel, fuse_projections, init_params,
                    init_params_quantized, params_from_jax, quantize_params,
                    quantize_params_int4, unstack_layers)

__all__ = ["DecoderModel", "ShardReader", "config_from_hf",
           "fuse_projections", "import_hf_streaming", "init_params",
           "init_params_quantized", "load_flat_params", "params_from_hf_gemma2",
           "params_from_hf_gemma3", "params_from_hf_gpt2",
           "params_from_hf_llama", "params_from_hf_phi3", "params_from_jax",
           "quantize_params", "quantize_params_int4", "unstack_layers"]
