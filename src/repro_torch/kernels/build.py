"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library of its own with a plain C interface, at first use, into
``build/kernels/`` at the root of the checkout.  A library's file name
carries a hash of the sources and flags, so an edited kernel builds
anew and an unchanged one loads at once.  ``build_all`` starts one
``nvcc`` per source, all together.  Nothing here runs at import time:
the CPU tests import every module on a machine without ``nvcc``.

The libraries link the CUDA runtime only: ``flash_attention``'s TMA
tensor maps are encoded by ``cuTensorMapEncodeTiled``, looked up at run
time with ``cudaGetDriverEntryPoint`` (by version where the runtime has
it), so no library needs ``-lcuda``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of repro_torch are built from source at "
                       "first use")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def sources() -> List[str]:
    """Kernel names: one per ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names: Optional[List[str]] = None) -> Dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source, all
    started together; raise with the compiler's output if one fails."""
    names = sources() if names is None else names
    out = {n: _library_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
               str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"--- nvcc {n}.cu (exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, todo[n])      # atomic: readers see whole files
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def refuse_autograd(kernel: str, **tensors) -> None:
    """Raise where autograd would need a backward the kernel lacks: the
    wrappers fill their outputs through ctypes, so a result would carry
    no ``grad_fn`` and its inputs would silently get no gradient."""
    if not torch.is_grad_enabled():
        return
    for name, t in tensors.items():
        if t is not None and t.requires_grad:
            raise ValueError(
                f"{kernel} kernel: {name} requires grad, and the kernel "
                "has no backward yet; call it under torch.no_grad() or "
                "pass detached tensors")


class CudaKernel:
    """A kernel's C entry point plus the count of its launches.

    ``launches`` grows by one where the wrapper launches the kernel and
    nowhere else, so a run can show that its path went through the
    kernel (set it to 0 before the run, read it after)."""

    def __init__(self, library: str, symbol: str, argtypes,
                 smem_symbol: Optional[str] = None, smem_argtypes=()):
        self.library = library
        self.symbol = symbol
        self.argtypes = argtypes
        self.smem_symbol = smem_symbol
        self.smem_argtypes = smem_argtypes
        self.launches = 0
        self._bound = None

    def _bind(self):
        """(launch, smem_bytes) C functions; builds and loads the
        library on first use.  A kernel with static shared memory only
        has no smem_bytes function (None)."""
        if self._bound is None:
            lib = ctypes.CDLL(str(build_all([self.library])[self.library]))
            fns = []
            for sym, argtypes, restype in (
                    (self.symbol, self.argtypes, ctypes.c_int),
                    (self.smem_symbol, self.smem_argtypes, ctypes.c_size_t)):
                if sym is None:
                    fns.append(None)
                    continue
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = restype
                fns.append(fn)
            self._bound = tuple(fns)
        return self._bound

    def smem_bytes(self, *args) -> int:
        return int(self._bind()[1](*args))

    def launch(self, *args) -> None:
        err = self._bind()[0](*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol} failed to launch: "
                               f"cudaError_t {err}")
        self.launches += 1
