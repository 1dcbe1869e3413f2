"""Lock-free shared-memory transport between processes: an atomic counter,
a single-producer ring buffer and a single-producer single-consumer
queue. The port of adaptigraph_tpu/planning/real_world/shared_memory.py.

The hot path (the counters' atomic loads, stores and adds, and the slot
copies) runs in native/shm_ring.cpp, built by kernels.build's host route
at first use and called through ctypes. `native=False` takes the numpy
form, the plain version the tests hold the native one to; the port never
falls back to it on its own.

Layout (native/shm_ring.cpp:10-16, shared with the JAX package's ring, so
either package can read what the other writes): an int64 write count, an
int64 read count, then `capacity` slots of `slot_size` bytes. A slot holds
every field of a put, packed in the order of `field_specs`. The producer
writes the slot, then publishes it by incrementing the write count with
release ordering; a consumer acquire-loads the write count before it
reads.

Imports numpy and the standard library only (no torch): camera processes
run it.
"""

from __future__ import annotations

import ctypes
from multiprocessing import shared_memory

import numpy as np

_HEADER = 16  # two int64 counters
_I64, _P = ctypes.c_int64, ctypes.c_void_p
_SIGNATURES = {
    "shm_counter_load": ([_P], _I64),
    "shm_counter_store": ([_P, _I64], None),
    "shm_counter_add": ([_P, _I64], _I64),
    "shm_ring_put": ([_P, _I64, _I64, _P], _I64),
    "shm_ring_get_latest": ([_P, _I64, _I64, _P], _I64),
    "shm_ring_get_last_k": ([_P, _I64, _I64, _I64, _P], _I64),
    "shm_ring_count": ([_P], _I64),
}


def native_lib():
    """native/shm_ring.cpp's library, built first if needed."""
    from adaptigraph_torch.kernels import build

    lib = build.load_host("shm_ring")
    for name, (args, res) in _SIGNATURES.items():
        f = getattr(lib, name)
        f.argtypes, f.restype = args, res
    return lib


def _address(shm, offset, size):
    return ctypes.addressof((ctypes.c_char * size).from_buffer(shm.buf,
                                                              offset))


class SharedAtomicCounter:
    """A cross-process int64 at `offset` of a shared-memory block."""

    def __init__(self, shm: shared_memory.SharedMemory, offset: int = 0,
                 native: bool = True):
        self.shm = shm
        self.offset = offset
        self._lib = native_lib() if native else None
        self._addr = _address(shm, offset, 8)

    def _view(self):
        return np.frombuffer(self.shm.buf, np.int64, 1, self.offset)

    def load(self) -> int:
        if self._lib:
            return self._lib.shm_counter_load(self._addr)
        return int(self._view()[0])

    def store(self, value: int):
        if self._lib:
            self._lib.shm_counter_store(self._addr, value)
        else:
            self._view()[0] = value

    def add(self, inc: int = 1) -> int:
        """Add `inc` and return the new value (the numpy form is not
        atomic across processes)."""
        if self._lib:
            return self._lib.shm_counter_add(self._addr, inc)
        v = self._view()
        v[0] += inc
        return int(v[0])


def _slot_size(field_specs) -> int:
    return sum(int(np.prod(shape)) * dt.itemsize
               for shape, dt in field_specs.values())


class SharedMemoryRingBuffer:
    """A single-producer ring of `capacity` slots over a named
    shared-memory block. field_specs: {name: (shape, dtype)}; every put
    and get carries all fields (a camera's frame: colour, depth,
    timestamp, sequence number). `create` makes the block (replacing a
    stale one of that name); otherwise the block is attached."""

    def __init__(self, name: str, field_specs, capacity: int = 32,
                 create: bool = True, native: bool = True):
        self.field_specs = {k: (tuple(s), np.dtype(d))
                            for k, (s, d) in field_specs.items()}
        self.capacity = capacity
        self.slot_size = _slot_size(self.field_specs)
        total = _HEADER + capacity * self.slot_size
        if create:
            try:
                self.shm = shared_memory.SharedMemory(name=name, create=True,
                                                      size=total)
            except FileExistsError:
                old = shared_memory.SharedMemory(name=name)
                old.close()
                old.unlink()
                self.shm = shared_memory.SharedMemory(name=name, create=True,
                                                      size=total)
            np.frombuffer(self.shm.buf, np.int64, 2, 0)[:] = 0
        else:
            self.shm = shared_memory.SharedMemory(name=name)
        self._lib = native_lib() if native else None
        self._base = _address(self.shm, 0, total)
        self.owner = create

    def _header(self):
        return np.frombuffer(self.shm.buf, np.int64, 2, 0)

    def _slot(self, seq):
        start = _HEADER + (seq % self.capacity) * self.slot_size
        return np.frombuffer(self.shm.buf, np.uint8, self.slot_size, start)

    def _pack(self, fields: dict) -> np.ndarray:
        out = np.empty(self.slot_size, np.uint8)
        off = 0
        for k, (shape, dt) in self.field_specs.items():
            a = np.ascontiguousarray(fields[k], dtype=dt).reshape(shape)
            out[off: off + a.nbytes] = a.view(np.uint8).reshape(-1)
            off += a.nbytes
        return out

    def _unpack(self, raw: np.ndarray) -> dict:
        out, off = {}, 0
        for k, (shape, dt) in self.field_specs.items():
            nb = int(np.prod(shape)) * dt.itemsize
            out[k] = raw[off: off + nb].view(dt).reshape(shape).copy()
            off += nb
        return out

    def put(self, fields: dict) -> int:
        """Write the next slot and publish it; returns the write count."""
        raw = self._pack(fields)
        if self._lib:
            return self._lib.shm_ring_put(self._base, self.capacity,
                                          self.slot_size, raw.ctypes.data)
        hdr = self._header()
        w = int(hdr[0])
        self._slot(w)[:] = raw
        hdr[0] = w + 1
        return w + 1

    def get_latest(self):
        """(fields, sequence number) of the newest slot, or (None, -1)."""
        raw = np.empty(self.slot_size, np.uint8)
        if self._lib:
            seq = self._lib.shm_ring_get_latest(
                self._base, self.capacity, self.slot_size, raw.ctypes.data)
        else:
            seq = int(self._header()[0]) - 1
            if seq >= 0:
                raw[:] = self._slot(seq)
        if seq < 0:
            return None, -1
        return self._unpack(raw), int(seq)

    def get_last_k(self, k: int):
        """The k newest slots' fields, oldest first (fewer when fewer were
        published)."""
        k = min(k, self.capacity)
        raw = np.empty(k * self.slot_size, np.uint8)
        if self._lib:
            n = self._lib.shm_ring_get_last_k(
                self._base, self.capacity, self.slot_size, k, raw.ctypes.data)
        else:
            w = int(self._header()[0])
            n = min(w, k)
            for i in range(n):
                raw[i * self.slot_size:(i + 1) * self.slot_size] = \
                    self._slot(w - n + i)
        return [self._unpack(raw[i * self.slot_size:(i + 1) * self.slot_size])
                for i in range(int(n))]

    @property
    def count(self) -> int:
        if self._lib:
            return self._lib.shm_ring_count(self._base)
        return int(self._header()[0])

    def close(self, unlink: bool | None = None):
        """Detach; the creator (or `unlink=True`) also removes the block."""
        self._base = None
        try:
            self.shm.close()
            if unlink if unlink is not None else self.owner:
                self.shm.unlink()
        except FileNotFoundError:
            pass


class SharedMemoryQueue(SharedMemoryRingBuffer):
    """A single-producer single-consumer FIFO on the ring: the consumer
    advances the read count; a put into a full queue fails."""

    def _counts(self):
        if self._lib:
            return (self._lib.shm_counter_load(self._base),
                    self._lib.shm_counter_load(self._base + 8))
        w, r = self._header()
        return int(w), int(r)

    def put(self, fields: dict) -> bool:
        w, r = self._counts()
        if w - r >= self.capacity:
            return False
        super().put(fields)
        return True

    def get(self):
        """The oldest unread slot's fields, or None when the queue is
        empty."""
        w, r = self._counts()
        if r >= w:
            return None
        raw = self._slot(r).copy()
        if self._lib:
            self._lib.shm_counter_store(self._base + 8, r + 1)
        else:
            self._header()[1] = r + 1
        return self._unpack(raw)

    def qsize(self) -> int:
        w, r = self._counts()
        return w - r
