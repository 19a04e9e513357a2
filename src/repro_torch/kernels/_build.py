"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each kernel has a plain C entry point in a `csrc/<source>.cu` that takes
raw pointers, sizes and a stream, launches, and returns `cudaGetLastError()`
(one source may hold several entry points). Each source is compiled for
Hopper (`sm_90a`) into its own shared library under `build/kernels/` at the
root of the checkout, at first use; the file name carries a hash of the
source and flags, so an edited source rebuilds and an unchanged one loads
as it is. `build_all` starts one nvcc per missing library, all at once.
Nothing is compiled or loaded when a module imports this one: the CPU
tests import every module on a machine without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
#: <checkout>/build/kernels (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


class KernelError(RuntimeError):
    """A kernel could not be built, loaded or launched. A RuntimeError, as
    these failures were before it existed; the chaos loop
    (`train.fault_tolerance.run_chaos_loop`) tells it apart from the faults
    it restores from and never replays it."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
            "kernels are built on the machine with the card")
    return found


class Kernel:
    """One hand-written CUDA kernel: its source, its built library, its C
    entry point, and the count of launches made through it. `source` names
    the `csrc/` file when it is not `<name>.cu`.

    `launches` is a plain integer that only `launch` increments; callers
    reset it to 0 to count the launches of one run."""

    def __init__(self, name: str, symbol: str, argtypes: list,
                 source: str | None = None):
        self.name = name
        self.source = CSRC / f"{source or name}.cu"
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._fn = None

    @property
    def library(self) -> Path:
        """Path of the shared library for the current source and flags."""
        h = hashlib.sha256(self.source.read_bytes()
                           + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}-{h}.so"

    def _command(self, out: Path) -> list[str]:
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def _load(self):
        lib = ctypes.CDLL(str(self.library))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.kernel_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err

    def launch(self, *args) -> None:
        """Call the C entry point (builds and loads on first use); raises
        if the launch reported a CUDA error."""
        if self._fn is None:
            build_all([self])
            self._load()
        self.launches += 1
        code = self._fn(*args)
        if code != 0:
            raise KernelError(
                f"CUDA kernel {self.name} failed to launch: "
                f"{self._err(code).decode()} (cudaError {code})")


def build_all(kernels: list[Kernel]) -> list[str]:
    """Compile every source whose library is missing, one nvcc per source,
    all started together. Raises with nvcc's output if any build fails.
    Stores each compiler log (ptxas register/spill report) on every kernel
    of the source. Returns the names of the sources it compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    by_lib: dict[Path, list[Kernel]] = {}
    for k in kernels:
        by_lib.setdefault(k.library, []).append(k)
    procs = []
    for lib, ks in by_lib.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs.append((lib, ks, tmp, subprocess.Popen(
            ks[0]._command(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for lib, ks, tmp, p in procs:
        log, _ = p.communicate()
        for k in ks:
            k.build_log = log
        if p.returncode != 0:
            failed.append(f"--- {ks[0].source.name} (exit {p.returncode}) "
                          f"---\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise KernelError("nvcc failed:\n" + "\n".join(failed))
    return [ks[0].source.stem for _, ks, _, _ in procs]


def stream_handle(device) -> int:
    """Raw cudaStream_t of PyTorch's current stream on `device` (a
    torch.device, or a device index). Asks PyTorch's C++ side for the
    handle, as PyTorch's own generated Triton launchers do, without
    building a `torch.cuda.Stream` object on every launch; the CPU build of
    torch lacks that call, and only CUDA tensors reach this function."""
    import torch
    index = device if isinstance(device, int) else device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
