"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every source under ``csrc/`` is a ``.cu`` file with a plain C interface (no
PyTorch headers; it may include the ``.cuh`` headers beside it), compiled
for Hopper into its own shared library under ``build/repro_torch_kernels/``
at the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source, the headers and the flags,
so an edited source or header is rebuilt and a built one is reused.
Nothing is compiled when a module is imported: :func:`library` builds on
first use, and :func:`build_all` starts one ``nvcc`` per source at once and
waits for all.
A failed build raises with the compiler's output.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises on a nonzero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("streaming_mm", "fused_region", "ssd_scan", "flash_attention",
           "flash_attention_wgmma", "ntx_matmul", "conv2d_ntx", "conv2d_ntx_wgmma",
           "ntx_gemm_wgmma", "ssd_scan_wgmma", "flash_attention_tf32", "conv2d_ntx_tf32")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> None:
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names=SOURCES) -> dict[str, Path]:
    """Build every listed source that is not built yet, in parallel."""
    with _LOCK:
        todo = [n for n in names if not _target(n).exists()]
        running = [(n, *_start(n)) for n in todo]
        errors = []
        for n, proc, tmp, out in running:
            try:
                _finish(n, proc, tmp, out)
            except RuntimeError as e:  # collect, then raise once all ended
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return {n: _target(n) for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all((name,))[name]
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(path))
                _LIBS[name] = lib
    return lib


def check(name: str, code: int, what: str) -> None:
    """Raise if an entry point of library ``name`` reported a CUDA error.

    Each source exports ``<name>_error_string`` for the message.
    """
    if code != 0:
        fn = getattr(library(name), f"{name}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {code} ({fn(code).decode()})")
