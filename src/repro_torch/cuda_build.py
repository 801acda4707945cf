"""Building the port's CUDA kernels: ``nvcc`` at first use, bound with ctypes.

Each kernel source under a ``csrc/`` directory has a plain C interface and
is compiled by hand (no PyTorch headers, so a build takes seconds) into a
shared library named after the hash of its source and flags, in a build
directory that ``.gitignore`` lists. :class:`CudaLibrary` owns one such
library: it builds it once per source version, writes the compiler's
output beside it as ``.log`` (``-Xptxas -v``: registers, shared memory and
spills of each kernel), loads it and declares its functions' signatures.
Builds of different libraries may run at the same time (``nvcc`` runs in a
subprocess, outside the interpreter lock).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """The nvcc binary: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the port's CUDA "
                           "kernels cannot be built")
    return found


class CudaLibrary:
    """One CUDA source built into one shared library.

    ``bind(lib)`` sets ``argtypes``/``restype`` of the library's C
    functions after it is loaded."""

    def __init__(self, name: str, source: Path, build_dir: Path,
                 bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = Path(source)
        self.build_dir = Path(build_dir)
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        """The shared library built from the current source and flags."""
        tag = hashlib.sha256(self.source.read_bytes()
                             + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return self.build_dir / f"{self.name}-{tag}.so"

    def build(self) -> ctypes.CDLL:
        """Compile the source with nvcc (once per source version) and load
        it. Raises if nvcc is missing or fails."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            so = self.library_path()
            if not so.exists():
                self.build_dir.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
                res = subprocess.run(
                    [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                    capture_output=True, text=True, check=False)
                so.with_suffix(".log").write_text(res.stdout + res.stderr)
                if res.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {self.source}:\n"
                                       f"{res.stdout}{res.stderr}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            self._bind(lib)
            self._lib = lib
            return lib
