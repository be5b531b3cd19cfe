"""The port's KV-cache modules against the JAX package's: the host swap
(``kvcache/swap.py``: ``gather_pages`` bit-exact with the JAX one on the
same numpy pool, bf16, f32 and INT8 with its flat scales, at page 8 and
64, and the scatter's round trip and pool equal to the JAX scatter's),
``kvcache/pool.py::resize_pool`` equal to the JAX one (grow and shrink,
the scales' rows included), the Python and the native page allocator
through the seven cases of the JAX package's ``tests/test_allocator.py``,
and the session snapshot (``kvcache/snapshot.py``) resuming a
generation exactly, as ``tests/test_checkpoint.py::
test_kv_snapshot_resume`` does, with f32 and INT8 KV."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pagedattention_based_transformer_decoder_inference_framework_tpu.kvcache import pool as jpool
from pagedattention_based_transformer_decoder_inference_framework_tpu.kvcache import swap as jswap
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.config import (
    CacheConfig, FrameworkConfig, RuntimeConfig, preset)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import Engine, SamplingParams
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.kvcache import pool as tpool
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.kvcache import swap as tswap
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.kvcache.allocator import (
    OutOfPagesError, PageAllocator as PyPageAllocator)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.kvcache.native import (
    NativePageAllocator, make_allocator, native_available)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.kvcache.snapshot import (
    load_kv_state, save_kv_state)

L, KH, P, D = 2, 2, 12, 16
PAGES = [3, 7, 1, 11]


def numpy_pool(dtype, page, seed=0):
    """A pool as numpy leaves: values ``[L, 2, KH, P, page, D]`` (bf16 as
    its 16-bit patterns) and for INT8 the flat scales ``[L, 2, KH, R,
    128]``."""
    rng = np.random.default_rng(seed)
    shape = (L, 2, KH, P, page, D)
    if dtype == "int8":
        R = -(-P * page // 128)
        return (rng.integers(-127, 128, shape, dtype=np.int8),
                rng.random((L, 2, KH, R, 128), dtype=np.float32))
    vals = rng.normal(size=shape).astype(np.float32)
    if dtype == "bfloat16":
        return (torch.from_numpy(vals).bfloat16().view(torch.int16).numpy(),)
    return (vals,)


def to_torch(leaves, dtype):
    t = tuple(torch.from_numpy(x.copy()) for x in leaves)
    if dtype == "bfloat16":
        t = (t[0].view(torch.bfloat16),)
    return t


def to_jax(leaves, dtype):
    if dtype == "bfloat16":
        return (jnp.asarray(torch.from_numpy(leaves[0]).view(
            torch.bfloat16).float().numpy()).astype(jnp.bfloat16),)
    return tuple(jnp.asarray(x) for x in leaves)


def bits(x):
    """Bit patterns of a torch tensor or a JAX/numpy array."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if str(x.dtype) == "bfloat16" else x


CASES = [(d, p) for d in ("bfloat16", "float32", "int8") for p in (8, 64)]


@pytest.mark.parametrize("dtype,page", CASES,
                         ids=[f"{d}-page{p}" for d, p in CASES])
def test_gather_pages_bit_exact_with_jax(dtype, page):
    leaves = numpy_pool(dtype, page)
    got = tswap.gather_pages(to_torch(leaves, dtype), PAGES)
    want = jswap.gather_pages(to_jax(leaves, dtype), PAGES)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(bits(g), bits(w))


@pytest.mark.parametrize("dtype,page", CASES,
                         ids=[f"{d}-page{p}" for d, p in CASES])
def test_scatter_round_trip_and_jax_scatter(dtype, page):
    """Pages gathered, then scattered into other pages of another pool:
    those pages read back the same slabs, every other page (and scale
    slot) keeps its value, and the pool equals the JAX scatter's."""
    src = to_torch(numpy_pool(dtype, page, seed=1), dtype)
    dst_np = numpy_pool(dtype, page, seed=2)
    blobs = tswap.gather_pages(src, PAGES)
    fresh = [2, 9, 4, 10]
    dst = tswap.scatter_pages(to_torch(dst_np, dtype), blobs, fresh)
    for g, w in zip(tswap.gather_pages(dst, fresh), blobs):
        np.testing.assert_array_equal(bits(g), bits(w))
    want = jswap.scatter_pages(to_jax(dst_np, dtype),
                               tuple(np.asarray(b.float() if
                                                b.dtype == torch.bfloat16
                                                else b) for b in blobs),
                               fresh)
    for g, w in zip(dst, want):
        np.testing.assert_array_equal(bits(g), bits(w))


@pytest.mark.parametrize("dtype,page", [("int8", 8), ("int8", 64),
                                        ("bfloat16", 64)])
@pytest.mark.parametrize("new", [5, 12, 20, 33])
def test_resize_pool_equals_jax(dtype, page, new):
    leaves = numpy_pool(dtype, page, seed=3)
    got = tpool.resize_pool(to_torch(leaves, dtype), new)
    want = jpool.resize_pool(to_jax(leaves, dtype), new)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(bits(g), bits(w))


def test_resize_pool_returns_new_tensors():
    kv = to_torch(numpy_pool("int8", 64), "int8")
    grown = tpool.resize_pool(kv, 20)
    assert all(g.data_ptr() != k.data_ptr() for g, k in zip(grown, kv))
    shrunk = tpool.resize_pool(kv, 6)
    assert all(s.is_contiguous() for s in shrunk)
    assert all(s.untyped_storage().data_ptr() != k.untyped_storage(
    ).data_ptr() for s, k in zip(shrunk, kv))


# -- the allocators ----------------------------------------------------------

@pytest.fixture(name="PageAllocator", params=["python", "native"])
def _allocator_cls(request):
    if request.param == "native":
        assert native_available()
        return NativePageAllocator
    return PyPageAllocator


def test_make_allocator_modes():
    assert type(make_allocator(4, "never")) is PyPageAllocator
    assert type(make_allocator(4, "always")) is NativePageAllocator
    assert type(make_allocator(4, "auto")) is NativePageAllocator


def test_alloc_free_cycle(PageAllocator):
    a = PageAllocator(5)
    pages = a.alloc_many(4)
    assert sorted(pages) == [1, 2, 3, 4]       # page 0 reserved
    with pytest.raises(OutOfPagesError):
        a.alloc()
    a.free(pages[0])
    assert a.alloc() == pages[0]


def test_dump_page_never_allocated(PageAllocator):
    a = PageAllocator(3)
    assert PageAllocator.DUMP_PAGE not in a.alloc_many(2)
    with pytest.raises(OutOfPagesError):
        a.alloc()


def test_refcount_fork_and_cow(PageAllocator):
    a = PageAllocator(5)
    pages = a.alloc_many(2)
    shared = a.fork(pages)
    assert shared == pages
    assert a.refcount(pages[0]) == 2

    # COW: shared page must be copied before write
    page, copied = a.ensure_exclusive(pages[0])
    assert copied and page not in pages
    assert a.refcount(pages[0]) == 1
    # pages[1] still has refcount 2, so it must copy too
    page2, copied2 = a.ensure_exclusive(pages[1])
    assert copied2
    # free both views fully
    a.free(pages[0])
    a.free(pages[1])
    a.free(page)
    a.free(page2)
    assert a.num_free == 4


def test_double_free_raises(PageAllocator):
    a = PageAllocator(3)
    p = a.alloc()
    a.free(p)
    with pytest.raises(ValueError):
        a.free(p)


def test_lru_prefix_reuse(PageAllocator):
    a = PageAllocator(3)
    p = a.alloc()
    a.free(p, tag=("prefix", 123))
    # freed page is reclaimable by tag
    assert a.lookup_freed(("prefix", 123)) == p
    a.free(p)
    # once evicted for a fresh alloc, tag lookup misses
    a.free(a.alloc(), tag=("prefix", 9))
    a.alloc_many(2)  # forces LRU eviction of the tagged page
    assert a.lookup_freed(("prefix", 9)) is None


def test_live_pages_never_evicted(PageAllocator):
    """Unlike the reference's LRU (kv_tile_cache.cpp:90-98), live pages
    are never dropped — allocation fails instead."""
    a = PageAllocator(3)
    a.alloc_many(2)
    with pytest.raises(OutOfPagesError):
        a.alloc()


def test_resize_grow_and_shrink(PageAllocator):
    a = PageAllocator(4)
    pages = a.alloc_many(2)
    a.resize(8)                                # grow: new pages usable
    assert a.num_free == 8 - 1 - 2             # page 0 reserved, 2 live
    more = a.alloc_many(5)
    for p in more:
        a.free(p)
    with pytest.raises(ValueError):
        a.resize(2)                            # would drop live pages
    for p in pages:
        a.free(p)
    a.resize(2)                                # all free: shrink ok
    assert a.num_free == 1


# -- the session snapshot ----------------------------------------------------

GREEDY = SamplingParams(temperature=0.0, eos_token_id=-1)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_kv_snapshot_resume(tmp_path, kv_dtype):
    cfg = FrameworkConfig(
        model=preset("llama-tiny"),
        cache=CacheConfig(page_size=8, num_pages=64, max_pages_per_seq=8,
                          kv_dtype=kv_dtype),
        runtime=RuntimeConfig(max_new_tokens=8))
    cfg.model.dtype = "float32"
    eng = Engine(cfg, device="cpu")
    prompts = [[2, 4, 6], [9, 8, 7, 6]]
    ref = eng.generate_batch(prompts, 8, GREEDY)

    # run 3 tokens, snapshot, resume in a fresh engine, run 5 more
    state = eng.prefill(prompts, sampling=GREEDY)
    outs = [[int(t)] for t in state.last_tokens]
    for _ in range(2):
        for b, t in enumerate(eng.decode(state, GREEDY)):
            outs[b].append(int(t))
    path = str(tmp_path / "kv.npz")
    save_kv_state(state, path)

    eng2 = Engine(cfg, params=eng.params, device="cpu")
    state2 = load_kv_state(eng2, path)
    assert eng2.allocator.num_live == sum(len(p) for p in state2.pages)
    for _ in range(5):
        for b, t in enumerate(eng2.decode(state2, GREEDY)):
            outs[b].append(int(t))
    eng2.free(state2)
    assert outs == ref
    assert eng2.allocator.num_live == 0
