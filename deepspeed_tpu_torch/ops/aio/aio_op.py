"""Python surface of the native async-IO engine.

Port of ``deepspeed_tpu/ops/aio/aio_op.py`` with the loader of
``deepspeed_tpu/ops/op_builder/async_io.py``: ``csrc/aio/dstpu_aio.cpp`` (a
std::thread pool over positional pread/pwrite, shared with the JAX package
and unchanged) is built with the host C++ compiler into
``deepspeed_tpu_torch/_build/`` by ``ops/builder.py`` (hash-named, built on
first use) and bound through ``ctypes``. The consumers are numpy buffers
(numpy views of the pinned torch tensors of the KV disk tier); requests are
submitted to the C++ thread pool and completed with ``wait``/``wait_all``.

This is host file I/O, not a device kernel: when the build fails the handle
falls back to a Python thread pool, as the reference does, and
:func:`aio_available` reports which engine runs (True: the native library).
"""

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from deepspeed_tpu_torch.ops import builder
from deepspeed_tpu_torch.utils.logging import logger

SOURCE = builder.REPO_CSRC_DIR / "aio" / "dstpu_aio.cpp"

_LIB = None
_LIB_TRIED = False


def _native_lib():
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB_TRIED = True
        try:
            _LIB = _bind(builder.load_host("dstpu_aio", SOURCE))
        except Exception as e:  # no compiler / build failure
            logger.warning(f"native async_io unavailable ({e}); using Python thread pool")
            _LIB = None
    return _LIB


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C ABI's signatures (``async_io.py``'s ``AsyncIOBuilder.load``)."""
    lib.dstpu_aio_new.restype = ctypes.c_void_p
    lib.dstpu_aio_new.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.dstpu_aio_free.argtypes = [ctypes.c_void_p]
    for fn in (lib.dstpu_aio_submit_read, lib.dstpu_aio_submit_write):
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_long]
    lib.dstpu_aio_wait.restype = ctypes.c_long
    lib.dstpu_aio_wait.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.dstpu_aio_wait_all.restype = ctypes.c_long
    lib.dstpu_aio_wait_all.argtypes = [ctypes.c_void_p]
    for fn in (lib.dstpu_aio_pread, lib.dstpu_aio_pwrite):
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_long]
    return lib


def aio_available() -> bool:
    """True when the native engine loaded; False when handles run on the
    Python thread pool."""
    return _native_lib() is not None


def _check_buffer(buf: np.ndarray):
    if not isinstance(buf, np.ndarray):
        raise TypeError(f"aio buffers must be numpy arrays, got {type(buf)}")
    if not buf.flags["C_CONTIGUOUS"]:
        raise ValueError("aio buffers must be C-contiguous")


class AsyncIOHandle:
    """Handle over the native thread pool (reference ``aio_handle``).

    ``async_pread/async_pwrite`` return request ids; ``wait(id)`` returns bytes
    transferred (raises on I/O error); ``wait_all`` drains every outstanding
    request.
    """

    def __init__(self, block_size: int = 1 << 20, queue_depth: int = 32,
                 thread_count: int = 4, single_submit: bool = False,
                 overlap_events: bool = True):
        self.block_size = block_size
        self.queue_depth = queue_depth
        self.thread_count = thread_count
        self._lib = _native_lib()
        self._handle = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._futures = {}
        self._next_id = 1
        if self._lib is not None:
            self._handle = self._lib.dstpu_aio_new(thread_count, queue_depth)
        else:
            self._pool = ThreadPoolExecutor(max_workers=max(1, thread_count))

    # -- fallback engine ---------------------------------------------------------
    def _py_submit(self, is_write: bool, path: str, buf: np.ndarray, offset: int) -> int:
        def run():
            # O_CREAT without O_TRUNC (mirroring the C++ engine's open flags):
            # concurrent first writes to a new file must not truncate each
            # other's shards. pwrite/pread keep each request's offset private.
            flags = (os.O_CREAT | os.O_WRONLY) if is_write else os.O_RDONLY
            fd = os.open(path, flags, 0o644)
            try:
                if is_write:
                    view = memoryview(buf).cast("B")
                    done = 0
                    while done < buf.nbytes:
                        done += os.pwrite(fd, view[done:], offset + done)
                    os.fsync(fd)
                    return buf.nbytes
                flat = memoryview(buf).cast("B")
                done = 0
                while done < buf.nbytes:
                    chunk = os.pread(fd, buf.nbytes - done, offset + done)
                    if not chunk:
                        break  # EOF
                    flat[done:done + len(chunk)] = chunk
                    done += len(chunk)
                return done
            finally:
                os.close(fd)

        rid = self._next_id
        self._next_id += 1
        self._futures[rid] = self._pool.submit(run)
        return rid

    # -- API ---------------------------------------------------------------------
    def async_pread(self, buffer: np.ndarray, path: str, offset: int = 0) -> int:
        _check_buffer(buffer)
        if self._handle is not None:
            rid = self._lib.dstpu_aio_submit_read(
                self._handle, os.fsencode(path), buffer.ctypes.data, buffer.nbytes, offset)
            if rid < 0:
                raise OSError(-rid, f"aio submit_read {path}")
            return rid
        return self._py_submit(False, path, buffer, offset)

    def async_pwrite(self, buffer: np.ndarray, path: str, offset: int = 0) -> int:
        _check_buffer(buffer)
        if self._handle is not None:
            rid = self._lib.dstpu_aio_submit_write(
                self._handle, os.fsencode(path), buffer.ctypes.data, buffer.nbytes, offset)
            if rid < 0:
                raise OSError(-rid, f"aio submit_write {path}")
            return rid
        return self._py_submit(True, path, buffer, offset)

    def wait(self, request_id: int) -> int:
        if self._handle is not None:
            rc = self._lib.dstpu_aio_wait(self._handle, request_id)
            if rc < 0:
                raise OSError(-rc, f"aio request {request_id} failed")
            return rc
        fut = self._futures.pop(request_id)
        return fut.result()

    def wait_all(self):
        if self._handle is not None:
            rc = self._lib.dstpu_aio_wait_all(self._handle)
            if rc < 0:
                raise OSError(-rc, "aio wait_all: a request failed")
            return
        futs, self._futures = self._futures, {}
        for f in futs.values():
            f.result()

    # synchronous one-shots (reference deepspeed_py_aio.cpp)
    def sync_pread(self, buffer: np.ndarray, path: str, offset: int = 0) -> int:
        rid = self.async_pread(buffer, path, offset)
        return self.wait(rid)

    def sync_pwrite(self, buffer: np.ndarray, path: str, offset: int = 0) -> int:
        rid = self.async_pwrite(buffer, path, offset)
        return self.wait(rid)

    def close(self):
        if self._handle is not None:
            self._lib.dstpu_aio_free(self._handle)
            self._handle = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
