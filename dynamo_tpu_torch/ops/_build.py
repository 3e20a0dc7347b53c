"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` compiles with ``nvcc`` into its own shared library with
a plain C interface under ``dynamo_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of its sources and flags, at first use.
The libraries load with ``ctypes``: pointers and the stream pass as
``c_void_p``, and each C entry returns ``cudaGetLastError()`` of its
launches, which ``check`` turns into an exception.  Building with nvcc by
hand takes seconds per source where ``torch.utils.cpp_extension.load``
(which compiles PyTorch's headers) takes minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
)

# dtype codes of csrc/common.cuh (enum DType).
DTYPE_CODES = {
    torch.float32: 0,
    torch.bfloat16: 1,
    torch.int8: 2,
    torch.float8_e4m3fn: 3,
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(src: Path) -> Path:
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Dict[str, object]]:
    """Compile every kernel source whose library is missing: one nvcc
    process per source, all started together.  Returns, per source stem,
    the build seconds and nvcc's output (ptxas register/spill report);
    raises on the first failed build."""
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for src in sorted(CSRC.glob("*.cu")):
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs[src.stem] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    report: Dict[str, Dict[str, object]] = {}
    failed = []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[stem] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{stem}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(stem: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<stem>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            path = _target(CSRC / f"{stem}.cu")
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[stem] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """A tensor's device pointer; None passes a null pointer."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
