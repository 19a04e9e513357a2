"""Page-locked host memory that the card reads and writes directly.

The cached tier's capacity level (the full-height mega table and its
row-wise AdaGrad accumulator) is the paper's "system memory" tier: it
lives in host DRAM, and the row movers of `kernels.cache_ops` reach its
rows across PCIe through unified virtual addressing (UVA). Such memory must
be page-locked and mapped into the card's address space.

`pinned_zeros` maps exactly the tensor's bytes (rounded up to one page)
with an anonymous `mmap` and registers them with
`cudaHostRegister(..., cudaHostRegisterMapped | cudaHostRegisterPortable)`.
PyTorch's caching host allocator (`pin_memory=True`) would round a block up
to a power of two: 64 GB for dlrm-m1's 44.3 GB. The device address comes
from `cudaHostGetDevicePointer`; under UVA it equals the host address,
which is checked, never assumed, so a kernel may take `data_ptr()`. The
range is unregistered, after the device has finished its queued work, when
the last tensor over it is freed.

`upload` stages a step's small host arrays (worklists, dense features)
in one page-locked block from PyTorch's caching host allocator and copies
them to the card in one transfer that does not block the host.

`is_page_locked` is the kernels' guard: a lookup in the ranges registered
here, and only for other memory PyTorch's `is_pinned` (a driver call).
The runtime is reached through ctypes on libcudart, as
`kernels._build` binds the kernels; nothing is loaded at import.
"""
from __future__ import annotations

import ctypes
import mmap
import os

import numpy as np
import torch

_REGISTER_PORTABLE = 0x01
_REGISTER_MAPPED = 0x02

#: start -> end of every host range registered by this module. Page-locked
#: ranges are process-wide driver state, so their registry is too.
_LIVE: dict[int, int] = {}
_LIB: list = []


def _cudart():
    """libcudart through ctypes: the copy PyTorch already loaded (matched
    by its soname), else the toolkit's."""
    if _LIB:
        return _LIB[0]
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    errors = []
    for name in ("libcudart.so.12", "libcudart.so.13",
                 os.path.join(home, "lib64", "libcudart.so")):
        try:
            lib = ctypes.CDLL(name)
        except OSError as e:
            errors.append(f"{name}: {e}")
            continue
        lib.cudaHostRegister.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                         ctypes.c_uint]
        lib.cudaHostGetDevicePointer.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_uint]
        lib.cudaHostUnregister.argtypes = [ctypes.c_void_p]
        lib.cudaGetErrorString.argtypes = [ctypes.c_int]
        lib.cudaGetErrorString.restype = ctypes.c_char_p
        for fn in (lib.cudaHostRegister, lib.cudaHostGetDevicePointer,
                   lib.cudaHostUnregister):
            fn.restype = ctypes.c_int
        _LIB.append(lib)
        return lib
    raise RuntimeError("libcudart not found: " + "; ".join(errors))


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.cudaGetErrorString(code).decode()} "
                           f"(cudaError {code})")


class _RegisteredMap(mmap.mmap):
    """An anonymous mapping registered with the CUDA runtime. Tensors made
    by `torch.frombuffer` hold it; when the last goes, the device finishes
    its queued work (a kernel may still read or write the range), the range
    is unregistered, then unmapped."""

    def __del__(self):
        addr = getattr(self, "_addr", None)
        if addr is None:
            return
        self._addr = None
        _LIVE.pop(addr, None)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        _cudart().cudaHostUnregister(addr)


def pinned_zeros(shape, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A zero-filled, page-locked, device-mapped host tensor of `shape`,
    holding exactly its own bytes (rounded up to one page). Needs the CUDA
    runtime; raises RuntimeError when a runtime call fails or the device
    address differs from the host address."""
    shape = tuple(int(s) for s in shape)
    itemsize = torch.empty((), dtype=dtype).element_size()
    n = itemsize
    for s in shape:
        n *= s
    size = max(mmap.PAGESIZE, -(-n // mmap.PAGESIZE) * mmap.PAGESIZE)
    lib = _cudart()
    torch.cuda.init()
    mm = _RegisteredMap(-1, size)
    raw = torch.frombuffer(mm, dtype=torch.uint8)
    addr = raw.data_ptr()
    _check(lib, lib.cudaHostRegister(addr, size,
                                     _REGISTER_MAPPED | _REGISTER_PORTABLE),
           f"cudaHostRegister of {size} bytes")
    mm._addr = addr
    _LIVE[addr] = addr + size
    dptr = ctypes.c_void_p()
    _check(lib, lib.cudaHostGetDevicePointer(ctypes.byref(dptr), addr, 0),
           "cudaHostGetDevicePointer")
    if dptr.value != addr:
        raise RuntimeError(
            f"the card maps page-locked host address {addr:#x} at "
            f"{dptr.value:#x}; the kernels need unified addressing")
    return raw[:n].view(dtype).view(shape)


def is_page_locked(t: torch.Tensor) -> bool:
    """True iff `t` is host memory the card can address: inside a range
    `pinned_zeros` registered, or pinned by PyTorch."""
    if t.device.type != "cpu":
        return False
    p = t.data_ptr()
    for start, end in _LIVE.items():
        if start <= p < end:
            return True
    return bool(t.is_pinned())


def page_locked_bytes() -> int:
    """Bytes of host memory registered by `pinned_zeros` and still live."""
    return sum(end - start for start, end in _LIVE.items())


_UPLOAD_DTYPES = {np.dtype(np.int32): torch.int32,
                  np.dtype(np.float32): torch.float32}


def upload(arrays, device) -> list[torch.Tensor]:
    """Copy host arrays (int32 or float32, any shapes) to `device` in ONE
    transfer and return them as tensors of their shapes and dtypes, views
    of one buffer. They are packed into one staging buffer, page-locked
    (`pin_memory=True`) when `device` is a CUDA device, and copied with
    `non_blocking=True`: the copy is queued on the current stream behind
    the work queued before it, and the host goes on. PyTorch's caching
    host allocator keeps the block until the copy has run, so it may be
    dropped at once. On the CPU the views share the packed buffer."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    bad = {str(a.dtype) for a in arrays if a.dtype not in _UPLOAD_DTYPES}
    if bad:
        raise TypeError(f"upload takes int32 and float32 arrays, got {bad}")
    dev = torch.device(device)
    buf = torch.empty((sum(a.size for a in arrays),), dtype=torch.int32,
                      pin_memory=dev.type == "cuda")
    flat, off = buf.numpy(), 0
    for a in arrays:
        flat[off:off + a.size] = a.reshape(-1).view(np.int32)
        off += a.size
    moved, out, off = buf.to(dev, non_blocking=True), [], 0
    for a in arrays:
        out.append(moved[off:off + a.size].view(_UPLOAD_DTYPES[a.dtype])
                   .view(a.shape))
        off += a.size
    return out
