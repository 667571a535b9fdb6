"""The port's native IO runtime (``loader.cpp``) through ctypes
(``causalvae_tpu/native``).

``loader.cpp`` decodes image files (minimal TIFF: 8/16-bit unsigned or
32-bit float grayscale, uncompressed, LZW, Deflate or PackBits, predictor 2;
and NPY) in a C++ thread pool, applies the vessel transform (antialiased
bilinear resize, flips by aug code, per-image min-max, mean binarize) and
delivers batches in submission order. ``decode_raw`` returns a file's
stored pixels at their own size, for ``data/vessel.py load_raw``.
``decode_pages`` walks a TIFF file's chain of pages (IFDs) and returns the
stack, ``decode_mip`` its maximum-intensity projection, computed page by
page without the stack (``data/translator.py load_stack``,
``data/cascade.py load_mip_paged``).

The library is compiled by ``g++`` at first use into
``<checkout>/build/native/``, never beside its source. Its name hashes the
source, the flags and the host's CPU (for ``-march=native``), and it is
written under a temporary name and renamed, so concurrent processes may
build at once. ``available()`` says False (and ``build_error()`` why) when
the build fails, for callers that choose a path; every other entry point
raises with the compiler's output instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = SOURCE.parents[2] / "build" / "native"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")
LIBS = ("-lz",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None

_F32 = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)


def _host_cpu() -> bytes:
    """What ``-march=native`` compiles for: the machine and its CPU's flags."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            flags = next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        flags = b""
    return platform.machine().encode() + flags


def library_path() -> Path:
    """The built library's path; its name hashes the source, the flags and
    the host's CPU (a checkout copied to another machine builds anew)."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(FLAGS + LIBS).encode())
    digest.update(_host_cpu())
    return BUILD_DIR / f"libcvae_loader-{digest.hexdigest()[:12]}.so"


def build_command(out: Path) -> list:
    """The ``g++`` command that compiles ``loader.cpp`` into ``out``."""
    return ["g++", *FLAGS, str(SOURCE), "-o", str(out), *LIBS]


def build() -> float:
    """Compile the library unless it is built; returns the seconds spent
    (0.0 when it was there). Raises RuntimeError with the compiler's output
    when the build fails."""
    out = library_path()
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    try:
        r = subprocess.run(build_command(tmp), capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native loader build failed: {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native loader build failed (g++ exit {r.returncode}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.cvae_loader_create.restype = ctypes.c_void_p
    lib.cvae_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _I32, _I32,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.cvae_loader_next.restype = ctypes.c_int
    lib.cvae_loader_next.argtypes = [ctypes.c_void_p, _F32, _I32]
    lib.cvae_loader_destroy.restype = None
    lib.cvae_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.cvae_decode_image.restype = ctypes.c_int
    lib.cvae_decode_image.argtypes = [
        ctypes.c_char_p, _F32, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.cvae_raw_decode.restype = ctypes.c_void_p
    lib.cvae_raw_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int,
    ]
    lib.cvae_pages_decode.restype = ctypes.c_void_p
    lib.cvae_pages_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.cvae_raw_take.restype = None
    lib.cvae_raw_take.argtypes = [ctypes.c_void_p, _F32]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                build()
                _lib = _bind(ctypes.CDLL(str(library_path())))
            except (RuntimeError, OSError) as e:
                _error = str(e)
        return _lib


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(_error)
    return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why ``available()`` is False (the compiler's output), else None."""
    _load()
    return _error


def _f32_ptr(a):
    """A float32 pointer into ``a``: a C-contiguous numpy array or CPU tensor."""
    if isinstance(a, np.ndarray):
        if a.dtype != np.float32 or not a.flags.c_contiguous or not a.flags.writeable:
            raise ValueError("expected a writeable C-contiguous float32 array")
        return a.ctypes.data_as(_F32)
    import torch

    if a.dtype != torch.float32 or a.device.type != "cpu" or not a.is_contiguous():
        raise ValueError("expected a contiguous float32 tensor in host memory")
    return ctypes.cast(a.data_ptr(), _F32)


def decode_image(path: str, hw: Tuple[int, int], *, binarize: bool = False,
                 flip_mode: int = 0) -> Optional[np.ndarray]:
    """One file decoded, resized to ``hw``, flipped by ``flip_mode`` (1
    horizontal, 2 vertical, 3 both), min-max normalized (and binarized at
    its mean): (H, W) float32, or None when the file cannot be decoded."""
    lib = _require()
    H, W = hw
    out = np.empty((H, W), np.float32)
    ok = lib.cvae_decode_image(os.fsencode(path), _f32_ptr(out), H, W, int(binarize),
                               int(flip_mode))
    return out if ok else None


def _take(lib, path: str, raw, why, shape) -> np.ndarray:
    """The pixels of a decode handle as a float32 array of ``shape`` (the
    handle freed either way); ValueError naming the file when it is NULL."""
    if not raw:
        raise ValueError(f"{path}: {why.value.decode(errors='replace')}")
    out = None
    try:
        out = np.empty(shape, np.float32)
    finally:
        lib.cvae_raw_take(raw, None if out is None else _f32_ptr(out))
    return out


def decode_raw(path: str) -> np.ndarray:
    """A file's stored pixels at their own size, (h, w) float32 (a TIFF's
    first page). Raises OSError when the file cannot be read and ValueError,
    naming the file and what the decoder could not read (a TIFF tag and its
    value), when it cannot be decoded."""
    lib = _require()
    with open(path, "rb") as f:
        data = f.read()
    h, w = ctypes.c_int(), ctypes.c_int()
    why = ctypes.create_string_buffer(1024)
    raw = lib.cvae_raw_decode(data, len(data), ctypes.byref(h), ctypes.byref(w), why,
                              len(why))
    return _take(lib, path, raw, why, (h.value, w.value))


def _pages(path: str, mip: bool) -> np.ndarray:
    lib = _require()
    with open(path, "rb") as f:
        data = f.read()
    p, h, w = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    why = ctypes.create_string_buffer(1024)
    raw = lib.cvae_pages_decode(data, len(data), int(mip), ctypes.byref(p), ctypes.byref(h),
                                ctypes.byref(w), why, len(why))
    shape = (h.value, w.value) if mip else (p.value, h.value, w.value)
    return _take(lib, path, raw, why, shape)


def decode_pages(path: str) -> np.ndarray:
    """Every page of a TIFF file, (P, h, w) float32 (P = 1 for a one-page
    file). Each page is read as ``decode_raw`` reads the first and must have
    the first page's size, bit depth and sample format; a loop in the chain
    of pages is refused. Raises as ``decode_raw`` does, the page's index in
    the message."""
    return _pages(path, mip=False)


def decode_mip(path: str) -> np.ndarray:
    """The maximum over a TIFF file's pages, (h, w) float32: ``decode_pages(path)
    .max(axis=0)`` (a NaN sample propagates, as in ``numpy.maximum``),
    computed page by page, so that two pages are held at a time and never
    the stack."""
    return _pages(path, mip=True)


class NativeBatchLoader:
    """Threaded prefetching batch loader over image files.

    ``order`` holds the sample (index into ``paths``) of each position and
    ``augs`` its flip code; batches of ``batch_size`` positions come back in
    that order, a remainder under ``batch_size`` dropped. Iterating yields
    (images (B, H, W, 1) float32, sample indices (B,) int32); ``next_into``
    fills buffers the caller owns. A file that cannot be decoded comes back
    as zeros. ``close()`` (also on garbage collection) stops and joins the
    threads."""

    def __init__(
        self,
        paths: Sequence[str],
        order: np.ndarray,
        hw: Tuple[int, int],
        batch_size: int,
        *,
        augs: Optional[np.ndarray] = None,
        binarize: bool = True,
        n_threads: int = 4,
        max_queue: int = 4,
    ):
        self._handle = None
        lib = _require()
        order = np.ascontiguousarray(order, np.int32)
        if order.ndim != 1 or (order.size and (order.min() < 0 or order.max() >= len(paths))):
            raise ValueError(f"order must index the {len(paths)} paths")
        if augs is not None:
            augs = np.ascontiguousarray(augs, np.int32)
            if augs.shape != order.shape or (augs.size and (augs.min() < 0 or augs.max() > 3)):
                raise ValueError("augs must hold one flip code in 0-3 per order entry")
        if batch_size < 1:
            raise ValueError(f"batch_size {batch_size}")
        self._lib = lib
        self.hw = tuple(hw)
        self.batch_size = batch_size
        self.n_batches = len(order) // batch_size
        # the C side reads these until destroy: keep them referenced
        self._paths_buf = [os.fsencode(p) for p in paths]
        self._argv = (ctypes.c_char_p * len(paths))(*self._paths_buf)
        self._order, self._augs = order, augs
        self._handle = lib.cvae_loader_create(
            self._argv, len(paths), order.ctypes.data_as(_I32),
            augs.ctypes.data_as(_I32) if augs is not None else None,
            len(order), self.hw[0], self.hw[1], batch_size, int(binarize),
            n_threads, max_queue,
        )

    def next_into(self, data, idx: np.ndarray) -> bool:
        """Fill ``data`` (B*H*W float32, C-contiguous, in host memory: a numpy
        array or a CPU tensor, pinned or not) and ``idx`` ((B,) int32) with
        the next batch; False when the epoch is done."""
        if not self._handle:
            raise RuntimeError("the loader is closed")
        H, W = self.hw
        n = data.size if isinstance(data, np.ndarray) else data.numel()
        if n != self.batch_size * H * W:
            raise ValueError(f"data holds {n} values, a batch {self.batch_size * H * W}")
        if idx.dtype != np.int32 or idx.shape != (self.batch_size,) or not idx.flags.c_contiguous:
            raise ValueError(f"idx must be a contiguous ({self.batch_size},) int32 array")
        return bool(self._lib.cvae_loader_next(self._handle, _f32_ptr(data),
                                               idx.ctypes.data_as(_I32)))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        H, W = self.hw
        while True:
            data = np.empty((self.batch_size, H, W, 1), np.float32)
            idx = np.empty((self.batch_size,), np.int32)
            if not self.next_into(data, idx):
                return
            yield data, idx

    def close(self):
        if self._handle:
            self._lib.cvae_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
