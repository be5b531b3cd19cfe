from .allocator import OutOfPagesError, PageAllocator
from .pool import (PAGES_AXIS, PagePool, append_to_pages_at_layer,
                   gather_kv_dense, quantize_kv, resize_pool, stack_new_kv)

__all__ = ["OutOfPagesError", "PageAllocator", "PAGES_AXIS", "PagePool",
           "append_to_pages_at_layer", "gather_kv_dense", "quantize_kv",
           "resize_pool", "stack_new_kv"]
