"""Build and load the port's CUDA kernels: ``nvcc`` at first use, ``ctypes``.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` into one shared library,
``build/kernels/libnk_kernels.so`` at the root of the checkout. The sources
export a plain C interface, so nothing includes PyTorch's headers and a
build takes seconds: one ``nvcc`` per source, all started together, then
one link. The library is rebuilt when any source or header is newer than
it. Nothing here runs at import time: the CPU tests import every module of
the port on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "kernels"
LIB_NAME = "libnk_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
NVCC_TIMEOUT_S = 600

# dtype codes of the C interface (csrc/nk_common.cuh)
DT_F32 = 0
DT_BF16 = 1
DT_F64 = 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_long
# argtypes of every exported entry point: c_void_p for each pointer and the
# stream, or ctypes would pass them as 32-bit ints and cut them
SIGNATURES = {
    "nk_flash_attention": [_P, _P, _P, _P] + [_I] * 10 + [_F, _I, _P],
    "nk_decode_attention": [_P] * 9 + [_I] * 11 + [_F, _I, _P],
    "nk_water_fill": [_P] * 6 + [_L, _I, _L, _I, _I, _P],
    "nk_ssd_chunk_scan": [_P] * 8 + [_I] * 8 + [_P],
    "nk_quantize_int8": [_P] * 3 + [_L] + [_I] * 4 + [_P],
    "nk_dequantize_int8": [_P] * 3 + [_L] + [_I] * 4 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build in this process did: seconds, nvcc's output
build_info: Dict[str, object] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME); the CUDA toolkit "
                       "is needed to build the port's kernels")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _stale(lib: Path) -> bool:
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime
                 for p in _sources() + sorted(CSRC.glob("*.cuh")))
    return lib.stat().st_mtime < newest


def build(force: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into ``BUILD_DIR/LIB_NAME`` if it is missing or
    stale (or ``force``). Raises with nvcc's output when a build fails."""
    lib = BUILD_DIR / LIB_NAME
    if not force and not _stale(lib):
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="nk_build_", dir=BUILD_DIR))
    procs = []
    try:
        for src in _sources():
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _obj, proc in procs:
            out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            logs.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
        tmp_lib = work / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _src, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=NVCC_TIMEOUT_S)
        log += f"\n== link (rc {link.returncode})\n{link.stdout}"
        if link.returncode != 0:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{log}")
        os.replace(tmp_lib, lib)          # atomic: concurrent loaders see
        (BUILD_DIR / "build.log").write_text(log)   # old or new, never half
        build_info.update(seconds=time.perf_counter() - t0, log=log,
                          sources=[p.name for p in _sources()])
    finally:
        for _src, _obj, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.nk_error_string.argtypes = [ctypes.c_int]
            lib.nk_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, kernel: str) -> None:
    """Raise if a C entry point reported an error (its launch was refused,
    or its arguments are outside what the kernel supports)."""
    if rc != 0:
        msg = library().nk_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel failed (code {rc}): {msg}")
