"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under ``build/repro_torch/`` (git-ignored), named
by the source's content hash so an edited source is rebuilt, and loaded
with ``ctypes``.  Nothing is built when a module is imported: the CPU tests
import every module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + \
        [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


class CudaLibrary:
    """One ``csrc/<name>.cu`` source: its library path, build and load.

    ``functions`` maps each exported C function to its ctypes argument
    types; every function returns an ``int`` CUDA error code.
    """

    def __init__(self, name: str, functions: Dict[str, List]):
        self.name = name
        self.source = CSRC_DIR / f"{name}.cu"
        self.functions = functions
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        """Where the shared library for the current source lives (keyed by
        the source's content hash)."""
        digest = hashlib.sha1(self.source.read_bytes()).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def build(self) -> Tuple[Path, str]:
        """(library path, ptxas's register / shared-memory report) --
        compiles only when the library for this source does not exist yet,
        else the report is ""."""
        out = self.library_path()
        if out.exists():
            return out, ""
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, out)   # atomic: a concurrent build never sees half
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return out, proc.stderr

    def load(self) -> ctypes.CDLL:
        """The loaded library (built first if needed), with argtypes set."""
        if self._lib is not None:    # the per-call path takes no lock
            return self._lib
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()[0]))
                for fn_name, argtypes in self.functions.items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib


def build_all(libraries: Sequence[CudaLibrary]) -> List[Path]:
    """Build several sources at once, one nvcc process each, then print each
    fresh build's ptxas report, one source at a time."""
    with ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
        results = list(pool.map(lambda lib: lib.build(), libraries))
    for path, report in results:
        if report:
            print(f"--- {path.name}\n{report}", end="")
    return [path for path, _ in results]


_sm_counts: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device`` (cached)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]

