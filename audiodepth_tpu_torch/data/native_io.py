"""ctypes binding of the port's native decoder, `native/adepth_io.cpp`
(port of `data/native_io.py`).

The library is built with g++ at first use, never when this module is
imported, into `build/native/libadepth_io-<hash>.so` at the root of the
checkout (a directory `.gitignore` lists); the hash covers the source and
the flags, so an edited source is rebuilt and a stale library is never
loaded. A build writes a temporary name and renames it, so another
process building at the same time never loads half a file. A failed build
raises with the compiler's output: nothing falls back to the Python
decoder, which runs only where a caller asks for it
(`batches(native=False)`).

Entry points, each releasing the GIL for the whole native call:
  * decode_wav_i16(path, fixed_len) → int16 [C, fixed_len] (transport form)
  * load_depth_u16(path, out_hw, max_depth, depth_norm) → uint16 [H, W]
  * assemble_batch(wav_paths, depth_paths, ...) → (int16 [B, C, L],
    uint16 [B, H, W, 1]) decoded by a thread pool
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "native" / "adepth_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()


def library_path(src: Path = SRC, build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(Path(src).read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return Path(build_dir) / f"libadepth_io-{digest.hexdigest()[:16]}.so"


def build(src: Path = SRC, build_dir: Path = BUILD_DIR) -> Path:
    """Compile `src` unless its library exists; the library's path. Raises
    RuntimeError with g++'s output when the compile fails."""
    out = library_path(src, build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(src), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: it builds the native decoder "
                           "(batches(native=False) runs the Python decoder)") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.adepth_decode_wav_i16.restype = ctypes.c_int
    lib.adepth_decode_wav_i16.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.adepth_load_depth_u16.restype = ctypes.c_int
    lib.adepth_load_depth_u16.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_int32,
    ]
    lib.adepth_assemble_batch.restype = ctypes.c_int
    lib.adepth_assemble_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_int32,
    ]
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The loaded library, built first if needed. ctypes releases the GIL
    for the duration of each foreign call."""
    with _lock:
        return _bind(ctypes.CDLL(str(build())))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def decode_wav_i16(path: str, fixed_len: int, channels: int = 2) -> np.ndarray:
    out = np.zeros((channels, fixed_len), np.int16)
    ch, sr = ctypes.c_int32(0), ctypes.c_int32(0)
    rc = load().adepth_decode_wav_i16(os.fsencode(path), _ptr(out, ctypes.c_int16),
                                      fixed_len, ctypes.byref(ch), ctypes.byref(sr))
    if rc != 0:
        raise IOError(f"native wav decode failed ({rc}): {path}")
    if ch.value != channels:
        raise IOError(f"expected {channels}ch, got {ch.value}: {path}")
    return out


def load_depth_u16(path: str, out_hw: Tuple[int, int], max_depth: float,
                   depth_norm: bool) -> np.ndarray:
    out = np.zeros(out_hw, np.uint16)
    rc = load().adepth_load_depth_u16(os.fsencode(path), _ptr(out, ctypes.c_uint16),
                                      out_hw[0], out_hw[1], max_depth, int(bool(depth_norm)))
    if rc != 0:
        raise IOError(f"native depth load failed ({rc}): {path}")
    return out


def assemble_batch(
    wav_paths: Optional[Sequence[str]],
    depth_paths: Sequence[str],
    fixed_len: int,
    out_hw: Tuple[int, int],
    max_depth: float,
    depth_norm: bool,
    channels: int = 2,
    n_threads: int = 8,
):
    """Decode a whole batch in native threads.

    Returns (wav int16 [B, C, L] or None, depth uint16 [B, H, W, 1]), already
    in the compact transport dtypes of data/codec.py.
    """
    if wav_paths and len(wav_paths) != len(depth_paths):
        raise ValueError(f"{len(wav_paths)} wav paths for {len(depth_paths)} depth paths")
    if any("\n" in p for p in (*(wav_paths or ()), *depth_paths)):
        raise ValueError("a path holds a newline, the native call's separator")
    b = len(depth_paths)
    wav_out = np.zeros((b, channels, fixed_len), np.int16)
    depth_out = np.zeros((b, out_hw[0], out_hw[1]), np.uint16)
    wav_blob = b"\n".join(map(os.fsencode, wav_paths)) if wav_paths else b""
    rc = load().adepth_assemble_batch(
        wav_blob, b"\n".join(map(os.fsencode, depth_paths)), b, fixed_len, channels,
        out_hw[0], out_hw[1], max_depth, int(bool(depth_norm)),
        _ptr(wav_out, ctypes.c_int16), _ptr(depth_out, ctypes.c_uint16), n_threads)
    if rc != 0:
        raise IOError(f"native batch assembly failed ({rc})")
    return (wav_out if wav_paths else None), depth_out[..., None]
