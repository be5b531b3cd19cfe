"""ctypes bindings for the native (C++) page allocator.

Builds the package's ``csrc/page_allocator.cpp`` with ``g++`` at first
use into the git-ignored ``_build/`` beside the package (the library is
named by a digest of the source and the flags, so an edited source
rebuilds; never beside the source) and wraps it in a class with the
exact :class:`~.allocator.PageAllocator` API, so the scheduler can use
either. This is the host's allocator: no device code.

Allocator calls sit on the scheduler's admission path (one
``alloc_many`` / ``free`` / ``lookup_freed`` burst a request); at high
request rates the Python dict / OrderedDict bookkeeping is measurable
host cost.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import List, Optional, Tuple

from .allocator import OutOfPagesError, tag64

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "page_allocator.cpp"
BUILD_DIR = _PKG / "_build"
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_build_error: Optional[str] = None


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"page_allocator-{digest}.so"


def _load() -> Optional[ctypes.CDLL]:
    """Build (once) and load the shared library; None if unavailable."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            lib_path = library_path()
            if not lib_path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                # build to a temp path and os.replace: concurrent
                # processes never dlopen a half-written library
                tmp = f"{lib_path}.{os.getpid()}.tmp"
                subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp],
                               check=True, capture_output=True, text=True)
                os.replace(tmp, lib_path)
            lib = ctypes.CDLL(str(lib_path))
        except (OSError, subprocess.CalledProcessError) as e:
            _build_error = getattr(e, "stderr", None) or str(e)
            return None
        lib.pa_create.restype = ctypes.c_void_p
        lib.pa_create.argtypes = [ctypes.c_int]
        lib.pa_destroy.argtypes = [ctypes.c_void_p]
        for name, args in (
            ("pa_num_free", [ctypes.c_void_p]),
            ("pa_num_live", [ctypes.c_void_p]),
            ("pa_alloc", [ctypes.c_void_p]),
            ("pa_alloc_many", [ctypes.c_void_p, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_int)]),
            ("pa_free", [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_int]),
            ("pa_fork", [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                         ctypes.c_int]),
            ("pa_refcount", [ctypes.c_void_p, ctypes.c_int]),
            ("pa_ensure_exclusive", [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int)]),
            ("pa_lookup_freed", [ctypes.c_void_p, ctypes.c_int64]),
            ("pa_drop_cached", [ctypes.c_void_p]),
            ("pa_num_cached", [ctypes.c_void_p]),
            ("pa_claim", [ctypes.c_void_p, ctypes.c_int]),
            ("pa_resize", [ctypes.c_void_p, ctypes.c_int]),
        ):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class NativePageAllocator:
    """Drop-in replacement for :class:`~.allocator.PageAllocator`."""

    DUMP_PAGE = 0

    def __init__(self, num_pages: int):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                f"native allocator unavailable: {_build_error}")
        self._lib = lib
        self.num_pages = num_pages
        self._h = lib.pa_create(num_pages)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.pa_destroy(h)
            self._h = None

    @property
    def num_free(self) -> int:
        return self._lib.pa_num_free(self._h)

    @property
    def num_live(self) -> int:
        return self._lib.pa_num_live(self._h)

    @property
    def num_cached(self) -> int:
        return self._lib.pa_num_cached(self._h)

    def claim(self, page: int) -> None:
        if self._lib.pa_claim(self._h, page) != 0:
            raise ValueError(f"cannot claim page {page}")

    def resize(self, new_num_pages: int) -> None:
        if self._lib.pa_resize(self._h, new_num_pages) != 0:
            raise ValueError("cannot shrink below a live page")
        self.num_pages = new_num_pages

    def alloc(self) -> int:
        page = self._lib.pa_alloc(self._h)
        if page < 0:
            raise OutOfPagesError(
                f"page pool exhausted ({self.num_pages} pages live)")
        return page

    def alloc_many(self, n: int) -> List[int]:
        out = (ctypes.c_int * max(n, 1))()
        if self._lib.pa_alloc_many(self._h, n, out) != 0:
            raise OutOfPagesError(
                f"need {n} pages, only {self.num_free} free")
        return list(out[:n])

    def free(self, page: int, tag: Optional[object] = None) -> None:
        has_tag = tag is not None
        rc = self._lib.pa_free(self._h, page, tag64(tag) if has_tag else 0,
                               1 if has_tag else 0)
        if rc != 0:
            raise ValueError(f"double free of page {page}")

    def fork(self, pages: List[int]) -> List[int]:
        arr = (ctypes.c_int * max(len(pages), 1))(*pages)
        if self._lib.pa_fork(self._h, arr, len(pages)) != 0:
            raise KeyError("fork of non-live page")
        return list(pages)

    def refcount(self, page: int) -> int:
        return self._lib.pa_refcount(self._h, page)

    def ensure_exclusive(self, page: int) -> Tuple[int, bool]:
        out = ctypes.c_int()
        rc = self._lib.pa_ensure_exclusive(self._h, page, ctypes.byref(out))
        if rc < 0:
            if self.refcount(page) == 0:
                raise KeyError(f"page {page} not live")
            raise OutOfPagesError("no page free for COW copy")
        return out.value, bool(rc)

    def lookup_freed(self, tag: object) -> Optional[int]:
        page = self._lib.pa_lookup_freed(self._h, tag64(tag))
        return None if page < 0 else page

    def drop_cached(self) -> int:
        return self._lib.pa_drop_cached(self._h)


def make_allocator(num_pages: int, native: str = "auto"):
    """Allocator factory: ``native`` in {"auto", "always", "never"};
    "auto" takes the native one where the library builds, "always"
    raises where it does not."""
    from .allocator import PageAllocator

    if native == "never":
        return PageAllocator(num_pages)
    if native == "always" or native_available():
        return NativePageAllocator(num_pages)
    return PageAllocator(num_pages)
