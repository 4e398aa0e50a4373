"""ctypes bindings over the repository's C++ runtime (``csrc/``): the
recordio container and the bounded blocking queue (counterpart of
``paddle_tpu/runtime/native.py``'s recordio and queue parts).

The library is built from ``csrc/`` at first use, into
``build/runtime/libpaddle_tpu_rt.so`` under the repository root, with
``make -C csrc OUT=<that path>`` (``g++`` and ``zlib.h``), and built again
when a source is newer than it.  Without a compiler the pure-Python paths
below keep everything working: the same on-disk recordio format, and a
``queue.Queue`` with the native queue's close semantics.
"""

import ctypes
import os
import queue as _queue
import struct
import subprocess
import tempfile
import threading
import zlib

_REPO = os.path.normpath(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), '..', '..'))
_CSRC = os.path.join(_REPO, 'csrc')
_SO_PATH = os.path.join(_REPO, 'build', 'runtime', 'libpaddle_tpu_rt.so')
_SOURCES = ('recordio.cc', 'blocking_queue.cc', 'host_pool.cc',
            'channel.cc', 'master.cc', 'Makefile')

_lib = None
_lib_tried = False
_lib_lock = threading.Lock()


def _stale():
    """True when the library is missing or older than a source."""
    if not os.path.exists(_SO_PATH):
        return True
    built = os.path.getmtime(_SO_PATH)
    return any(os.path.getmtime(os.path.join(_CSRC, s)) > built
               for s in _SOURCES if os.path.exists(os.path.join(_CSRC, s)))


def _build():
    """Build the library into a temporary file beside its path and move it
    there in one rename, so that processes building at once never load a
    half-written image.  False when the build fails."""
    if not os.path.isdir(_CSRC):
        return False
    os.makedirs(os.path.dirname(_SO_PATH), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(_SO_PATH), suffix='.so')
    os.close(fd)
    try:
        subprocess.run(['make', '-B', '-C', _CSRC, 'OUT=%s' % tmp],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, _SO_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib):
    c_void_p, c_char_p, c_uint64 = (ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_uint64)
    lib.recordio_writer_create.restype = c_void_p
    lib.recordio_writer_create.argtypes = [c_char_p, ctypes.c_int, c_uint64]
    lib.recordio_writer_write.restype = ctypes.c_int
    lib.recordio_writer_write.argtypes = [c_void_p, c_char_p, c_uint64]
    lib.recordio_writer_close.restype = ctypes.c_int
    lib.recordio_writer_close.argtypes = [c_void_p]
    lib.recordio_scanner_create.restype = c_void_p
    lib.recordio_scanner_create.argtypes = [c_char_p]
    lib.recordio_scanner_next.restype = ctypes.c_int
    lib.recordio_scanner_next.argtypes = [
        c_void_p, ctypes.POINTER(c_char_p), ctypes.POINTER(c_uint64)]
    lib.recordio_scanner_destroy.restype = None
    lib.recordio_scanner_destroy.argtypes = [c_void_p]
    lib.bq_create.restype = c_void_p
    lib.bq_create.argtypes = [c_uint64]
    lib.bq_push.restype = ctypes.c_int
    lib.bq_push.argtypes = [c_void_p, c_char_p, c_uint64]
    lib.bq_pop.restype = ctypes.c_int64
    lib.bq_pop.argtypes = [c_void_p, c_char_p, c_uint64]
    lib.bq_size.restype = c_uint64
    lib.bq_size.argtypes = [c_void_p]
    for name in ('bq_close', 'bq_reopen', 'bq_destroy'):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [c_void_p]
    return lib


def _load():
    """The bound library, built first where needed; None when it cannot be
    built (the pure-Python paths run then)."""
    global _lib, _lib_tried
    with _lib_lock:
        if not _lib_tried:
            _lib_tried = True
            if not _stale() or _build():
                try:
                    _lib = _bind(ctypes.CDLL(_SO_PATH))
                except OSError:
                    _lib = None
        return _lib


def lib_available():
    """True when the native library is built and loaded."""
    return _load() is not None


class RecordIOWriter(object):
    """Writes records into the chunked recordio container
    (``csrc/recordio.cc``; reference recordio/writer.h)."""

    def __init__(self, path, compressor='zlib', max_chunk_bytes=1 << 20):
        self._lib = _load()
        self._path = path
        self._compressor = compressor
        self._py_records = None
        if self._lib is None:
            self._py_records = []
            return
        self._h = self._lib.recordio_writer_create(
            path.encode(), 1 if compressor == 'zlib' else 0,
            max_chunk_bytes)
        if not self._h:
            raise IOError('cannot open %s for writing' % path)

    def write(self, data):
        if isinstance(data, str):
            data = data.encode()
        if self._py_records is not None:
            self._py_records.append(bytes(data))
            return
        if self._lib.recordio_writer_write(self._h, data, len(data)) != 0:
            raise IOError('recordio write failed')

    def close(self):
        if self._py_records is not None:
            _py_write_recordio(self._path, self._py_records,
                               self._compressor)
            self._py_records = []
            return
        if self._h is not None:
            if self._lib.recordio_writer_close(self._h) != 0:
                raise IOError('recordio close/flush failed')
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordIOScanner(object):
    """Iterates the records of a recordio file (reference
    recordio/scanner.h); a chunk whose CRC or format is wrong raises
    IOError."""

    def __init__(self, path):
        self._lib = _load()
        self._h = None
        if self._lib is None:
            self._records = iter(_py_read_recordio(path))
            return
        self._h = self._lib.recordio_scanner_create(path.encode())
        if not self._h:
            raise IOError('cannot open %s' % path)

    def __iter__(self):
        return self

    def __next__(self):
        if self._h is None:
            if self._lib is not None:
                raise StopIteration  # closed
            return next(self._records)
        buf = ctypes.c_char_p()
        length = ctypes.c_uint64()
        status = self._lib.recordio_scanner_next(
            self._h, ctypes.byref(buf), ctypes.byref(length))
        if status == 0:
            raise StopIteration
        if status < 0:
            raise IOError('corrupt recordio chunk (crc/format)')
        return ctypes.string_at(buf, length.value)

    def close(self):
        if self._h is not None:
            self._lib.recordio_scanner_destroy(self._h)
            self._h = None


# ---- the pure-Python recordio path: the same on-disk format -------------
_MAGIC = 0x0c010cec


def _py_write_recordio(path, records, compressor='zlib'):
    """One chunk: a 24-byte header (magic, compressor, record count, raw
    bytes, stored bytes, CRC32 of the stored bytes), then the records, each
    behind its u32 length, zlib-compressed or stored."""
    raw = b''.join(struct.pack('<I', len(r)) + r for r in records)
    comp = 1 if compressor == 'zlib' else 0
    stored = zlib.compress(raw, 1) if comp else raw
    with open(path, 'wb') as f:
        f.write(struct.pack('<6I', _MAGIC, comp, len(records), len(raw),
                            len(stored), zlib.crc32(stored) & 0xffffffff))
        f.write(stored)


def _py_read_recordio(path):
    out = []
    with open(path, 'rb') as f:
        while True:
            hdr = f.read(24)
            if len(hdr) < 24:
                break
            magic, comp, n, _, stored_len, crc = struct.unpack('<6I', hdr)
            if magic != _MAGIC:
                raise IOError('bad recordio magic')
            stored = f.read(stored_len)
            if zlib.crc32(stored) & 0xffffffff != crc:
                raise IOError('recordio crc mismatch')
            raw = zlib.decompress(stored) if comp else stored
            off = 0
            for _ in range(n):
                (length, ) = struct.unpack_from('<I', raw, off)
                off += 4
                out.append(raw[off:off + length])
                off += length
    return out


class NativeBlockingQueue(object):
    """Bounded producer/consumer queue of byte strings (``csrc/
    blocking_queue.cc``; reference operators/reader/
    lod_tensor_blocking_queue.h).  ``push`` blocks while the queue is full
    and returns False once it is closed; ``pop`` blocks while it is empty
    and returns None once it is closed and drained; ``reopen`` empties it
    for the next pass."""

    _POLL_S = 0.05

    def __init__(self, capacity):
        self._lib = _load()
        self.capacity = max(int(capacity), 1)
        self._h = None
        if self._lib is None:
            self._q = _queue.Queue(maxsize=self.capacity)
            self._closed = False
            return
        self._q = None
        self._h = self._lib.bq_create(self.capacity)
        self._pop_cap = 1 << 16  # a size hint: each pop owns its buffer

    def push(self, data):
        data = bytes(data)
        if self._q is not None:
            # a bounded wait, so that close() ends a blocked producer as
            # bq_push's does
            while not self._closed:
                try:
                    self._q.put(data, timeout=self._POLL_S)
                    return True
                except _queue.Full:
                    continue
            return False
        return self._lib.bq_push(self._h, data, len(data)) == 0

    def pop(self):
        """The next byte string, or None when closed and drained."""
        if self._q is not None:
            while True:
                try:
                    return self._q.get(timeout=self._POLL_S)
                except _queue.Empty:
                    if self._closed:
                        return None
        cap = self._pop_cap
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.bq_pop(self._h, buf, cap)
            if n == -1:
                return None
            if n <= -2:  # the front item needs -(n + 2) bytes: grow
                cap = -(n + 2)
                self._pop_cap = max(self._pop_cap, cap)
                continue
            return buf.raw[:n]

    def size(self):
        if self._q is not None:
            return self._q.qsize()
        return int(self._lib.bq_size(self._h))

    def close(self):
        if self._q is not None:
            self._closed = True
            return
        self._lib.bq_close(self._h)

    def reopen(self):
        if self._q is not None:
            self._q = _queue.Queue(maxsize=self.capacity)
            self._closed = False
            return
        self._lib.bq_reopen(self._h)

    def __del__(self):
        if getattr(self, '_h', None) is not None:
            self._lib.bq_destroy(self._h)
            self._h = None
