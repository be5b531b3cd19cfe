from .tensor import (Q4Tensor, QTensor, dequantize, dequantize_int4,
                     int4_block_width, pack_int4, quantize_int4_groupwise,
                     quantize_per_channel, quantize_per_row, unpack_int4)

__all__ = ["QTensor", "Q4Tensor", "quantize_per_channel",
           "quantize_per_row", "quantize_int4_groupwise", "dequantize",
           "dequantize_int4", "int4_block_width", "pack_int4",
           "unpack_int4"]
