"""Asynchronous host file I/O: the port of ``deepspeed_tpu/ops/aio``.

Reference ``op_builder/async_io.py`` over ``csrc/aio/py_lib`` (DeepNVMe).
``AsyncIOBuilder`` builds the port's own copy of the JAX package's C++
thread pool, ``ops/csrc/host/aio.cpp``, with ``g++`` at first use
(``ops/_build.load_host``; a failed build raises) and binds it with
``ctypes``. ``AsyncIOHandle`` mirrors ``deepspeed_py_io_handle.cpp``:
``async_pread`` / ``async_pwrite`` return request ids, ``wait`` returns the
bytes moved and raises ``OSError`` on a failure. Buffers are contiguous CPU
tensors or numpy arrays; a strided buffer, or a read into a read-only
array, is refused. The handle keeps each buffer alive until its request is
waited for. ``plain_pwrite`` / ``plain_pread`` are the plain versions
(one thread, ``os.pwrite`` / ``os.preadv``); ``launch_counts`` counts the
requests submitted to the library.
"""

import ctypes
import os
from typing import Dict, Union

import numpy as np
import torch

#: requests submitted to the library (reset by callers that want a
#: window's count)
launch_counts: Dict[str, int] = {"aio": 0}

_SOURCE = "aio.cpp"
MIN_BLOCK = 4096           # the library clamps smaller blocks to this

Buffer = Union[torch.Tensor, np.ndarray]


class AsyncIOBuilder:
    """Build (``g++``, at first use) and load the aio library (the JAX
    package's ``AsyncIOBuilder``)."""

    NAME = "async_io"

    def load(self) -> ctypes.CDLL:
        from .._build import load_host

        lib = load_host(_SOURCE)
        if lib.dstpu_aio_create.argtypes is None:
            lib.dstpu_aio_create.restype = ctypes.c_void_p
            lib.dstpu_aio_create.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int]
            lib.dstpu_aio_destroy.restype = None
            lib.dstpu_aio_destroy.argtypes = [ctypes.c_void_p]
            lib.dstpu_aio_submit.restype = ctypes.c_int64
            lib.dstpu_aio_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                             ctypes.c_void_p, ctypes.c_int64,
                                             ctypes.c_int64, ctypes.c_int]
            lib.dstpu_aio_wait.restype = ctypes.c_int64
            lib.dstpu_aio_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.dstpu_aio_wait_all.restype = ctypes.c_int64
            lib.dstpu_aio_wait_all.argtypes = [ctypes.c_void_p]
            lib.dstpu_aio_pending.restype = ctypes.c_int
            lib.dstpu_aio_pending.argtypes = [ctypes.c_void_p]
            lib.dstpu_aio_version.restype = ctypes.c_int
            lib.dstpu_aio_version.argtypes = []
        return lib

    def is_compatible(self) -> bool:
        try:
            self.load()
            return True
        except (OSError, RuntimeError):
            return False


def reset_launch_counts() -> None:
    launch_counts["aio"] = 0


def _bytes(buffer: Buffer) -> memoryview:
    if isinstance(buffer, torch.Tensor):
        buffer = buffer.reshape(-1).view(torch.uint8).numpy()
    return memoryview(buffer).cast("B")


def plain_pwrite(buffer: Buffer, path: str, offset: int = 0) -> int:
    """The plain version of a write: one ``os.pwrite`` loop in this thread."""
    view = _bytes(buffer)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        done = 0
        while done < len(view):
            done += os.pwrite(fd, view[done:], offset + done)
    finally:
        os.close(fd)
    return done


def plain_pread(buffer: Buffer, path: str, offset: int = 0) -> int:
    """The plain version of a read: one ``os.preadv`` loop in this thread;
    returns the bytes read (fewer at the end of the file)."""
    view = _bytes(buffer)
    fd = os.open(path, os.O_RDONLY)
    try:
        done = 0
        while done < len(view):
            n = os.preadv(fd, [view[done:]], offset + done)
            if n == 0:
                break
            done += n
    finally:
        os.close(fd)
    return done


def _pointer(buf: Buffer, writable: bool):
    """``(address, nbytes)`` of a contiguous host buffer."""
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu":
            raise ValueError(f"aio buffers live in host memory, got a {buf.device} tensor")
        if not buf.is_contiguous():
            raise ValueError("aio buffers must be contiguous")
        return buf.data_ptr(), buf.numel() * buf.element_size()
    if not isinstance(buf, np.ndarray):
        raise TypeError(f"aio buffers are CPU tensors or numpy arrays, got {type(buf)}")
    if not buf.flags["C_CONTIGUOUS"]:
        raise ValueError("aio buffers must be C-contiguous")
    if writable and not buf.flags["WRITEABLE"]:
        raise ValueError("read target buffer is not writable")
    return buf.ctypes.data, buf.nbytes


class AsyncIOHandle:
    """An asynchronous file I/O handle over a pool of ``num_threads``
    workers; requests are striped in ``block_size`` chunks."""

    def __init__(self, num_threads: int = 8, block_size: int = 1 << 20,
                 use_o_direct: bool = False):
        self._lib = AsyncIOBuilder().load()
        block_size = max(int(block_size), MIN_BLOCK)
        self._h = self._lib.dstpu_aio_create(int(num_threads), block_size,
                                             1 if use_o_direct else 0)
        self.num_threads = num_threads
        self.block_size = block_size
        self._live = {}            # request id -> its buffer, kept alive

    def _submit(self, buf: Buffer, path: str, offset: int, is_read: bool) -> int:
        ptr, nbytes = _pointer(buf, writable=is_read)
        rid = self._lib.dstpu_aio_submit(self._h, os.fsencode(path), ptr, nbytes,
                                         int(offset), int(is_read))
        launch_counts["aio"] += 1
        self._live[rid] = buf
        return rid

    def async_pread(self, buffer: Buffer, path: str, offset: int = 0) -> int:
        return self._submit(buffer, path, offset, True)

    def async_pwrite(self, buffer: Buffer, path: str, offset: int = 0) -> int:
        return self._submit(buffer, path, offset, False)

    def wait(self, req_id: int) -> int:
        r = self._lib.dstpu_aio_wait(self._h, req_id)
        self._live.pop(req_id, None)
        if r < 0:
            raise OSError(-r, os.strerror(-r))
        return r

    def wait_all(self) -> None:
        r = self._lib.dstpu_aio_wait_all(self._h)
        self._live.clear()
        if r < 0:
            raise OSError(-r, os.strerror(-r))

    def pending(self) -> int:
        return self._lib.dstpu_aio_pending(self._h)

    # synchronous conveniences -----------------------------------------
    def pread(self, buffer: Buffer, path: str, offset: int = 0) -> int:
        return self.wait(self.async_pread(buffer, path, offset))

    def pwrite(self, buffer: Buffer, path: str, offset: int = 0) -> int:
        return self.wait(self.async_pwrite(buffer, path, offset))

    def close(self) -> None:
        """Wait for every request and free the worker pool."""
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.dstpu_aio_wait_all(h)
            self._lib.dstpu_aio_destroy(h)
            self._live.clear()

    def __del__(self):
        self.close()


__all__ = ["AsyncIOBuilder", "AsyncIOHandle", "launch_counts", "plain_pread", "plain_pwrite",
           "reset_launch_counts"]
