"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own
into `build/cuda/lib<name>-<hash>.so` at the root of the checkout (a
directory `.gitignore` lists). The hash covers the source, every header in
`csrc/` (`*.cuh`, `*.h`: a source may include any of them) and the flags, so
an edited source or header is rebuilt and a stale library is never loaded. Nothing is
built when a module is imported: the first wrapper call on a CUDA tensor
builds, or `build()` builds several sources at once, one nvcc each, all
started together.

`Launcher` is what the kernel wrappers share: the counts, the library
loaded at the first launch, and the check of a C call's error code; with
it `cdiv`, `device_args` and `sm_count`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted([*CSRC.glob("*.cuh"), *CSRC.glob("*.h")]):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every missing library of `names` in parallel.

    Returns {name: nvcc's output (ptxas register / spill report)} for the
    sources compiled in this call; raises if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    with _lock:
        build([name])
        return ctypes.CDLL(str(library_path(name)))


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def device_args(dev: torch.device) -> Tuple[int, int]:
    """(card index, current stream), the last two arguments of every C
    entry point."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(dev).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of card `index`, asked once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


class Launcher:
    """The base of every kernel wrapper: `name` (its registered op is
    `audiodepth::<name>`), `launches` and `variant_launches` (counted by
    `_check`), and its library, loaded at the first launch. A wrapper
    defined in `ops/cuda/<module>.py` loads `csrc/<module>.cu` with the
    entry points that module's `bind` declares; `library`, a callable
    giving a loaded library, replaces it (a variant build)."""

    name = ""

    def __init__(self, library: Optional[Callable[[], ctypes.CDLL]] = None):
        self.launches = 0
        self.variant_launches = Counter()
        self._load = library or self._own_library
        self._lib = None

    def _own_library(self) -> ctypes.CDLL:
        module = sys.modules[type(self).__module__]
        return module.bind(load(module.__name__.rpartition(".")[2]))

    def library(self) -> ctypes.CDLL:
        if self._lib is None:
            self._lib = self._load()
        return self._lib

    def _check(self, err: int, variant: str, launches: int = 1) -> None:
        """Raise on a C call's error code; else count the call: `launches`
        kernel launches, one call of `variant`."""
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: "
                               + self.library().adepth_cuda_error_string(err).decode())
        self.launches += launches
        self.variant_launches[variant] += 1
