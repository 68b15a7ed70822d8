"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface,
compiled by ``nvcc`` into a shared library and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Libraries land in
``build/torch_kernels/`` beside the package, named by a hash of the source
and the flags, so an edited source is rebuilt on its next use.  Nothing is
built or loaded at import time: the first launch builds, or a caller such
as ``chip_smoke.py`` builds every kernel up front with ``build_all``.

Each ``Kernel`` keeps a plain launch count that its wrapper increments
where it launches, so a run can show that its main path went through the
kernel.  It counts launches from the host: a launch recorded into a CUDA
graph counts once, and the graph's replays do not count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


class Kernel:
    """One CUDA source, its built library, and its launch count."""

    def __init__(
        self, name: str, signatures: Dict[str, tuple], source: Optional[Path] = None
    ):
        self.name = name
        self.source = CSRC / f"{name}.cu" if source is None else source
        # C function name -> (restype, argtypes) for ctypes.
        self.signatures = signatures
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None
        self._functions: Optional[Dict[str, ctypes._CFuncPtr]] = None

    @property
    def library_path(self) -> Path:
        digest = hashlib.sha256(
            self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def library(self) -> ctypes.CDLL:
        """The loaded library, built first if this source has no build yet."""
        if self._lib is None:
            build_all([self])
            lib = ctypes.CDLL(str(self.library_path))
            functions = {}
            for fn, (restype, argtypes) in self.signatures.items():
                functions[fn] = getattr(lib, fn)
                functions[fn].restype = restype
                functions[fn].argtypes = list(argtypes)
            self._lib, self._functions = lib, functions
        return self._lib

    def function(self, name: str) -> ctypes._CFuncPtr:
        """The bound C function ``name``, bound once when the library loads."""
        if self._functions is None:
            self.library()
        return self._functions[name]


def build_all(kernels: Sequence[Kernel]) -> List[Path]:
    """Compile every kernel without a current build, all nvcc runs at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for k in kernels:
        out = k.library_path
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(k.source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((k, proc, tmp, out))
    for k, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {k.source}:\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent build process sees all or nothing
    return [k.library_path for k in kernels]


PRIORITY_SCATTER = Kernel(
    "priority_scatter",
    {
        # Each takes one packed launch record (ops/scatter.py::_LAUNCH_RECORD).
        "priority_scatter_f32": (ctypes.c_int, (ctypes.c_char_p,)),
        "launch_floor": (ctypes.c_int, (ctypes.c_char_p,)),
    },
)

ALL_KERNELS = (PRIORITY_SCATTER,)
