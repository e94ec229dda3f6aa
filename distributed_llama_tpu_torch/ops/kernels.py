"""Build and load the port's CUDA kernels.

Every kernel lives in one source under `csrc/`, with a plain C interface.
`build` compiles each source into its own shared library with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

one nvcc process per source, all started together, into `build/kernels/` at
the root of the checkout (listed in `.gitignore`). A library's file name
carries a hash of its source, the headers under `csrc/` and the flags, so
an edited source or header is rebuilt and an unchanged one is reused. `load` opens a library with ctypes on first use
and declares its functions' argument types: every pointer and the stream as
`c_void_p`, so that ctypes never cuts a 64-bit pointer to a C int.

Nothing here runs at import time: the CPU tests import every module of the
port, on machines that have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = (
    "q40_gemv", "q40_gemm", "q40_grouped_gemm", "flash_attention", "paged_attention",
    "q40_i8_mma", "stream_probe", "attention_probe", "i8_tile_probe", "i4_codec_probe",
    "i8_gemv_probe", "i4_gemv_probe",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

P = ctypes.c_void_p  # pointers and the CUDA stream
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: put the CUDA toolkit's bin/ on PATH or set CUDA_HOME"
    )


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build(names=SOURCES, ptxas_verbose: bool = False) -> dict[str, str]:
    """Compile every source in `names` that has no library yet, all nvcc
    processes at once. Returns {name: compiler output} for the sources it
    compiled; raises with the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS]
        if ptxas_verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs[name] = (proc, tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed.
    `signatures` maps each C function to its argument types; every function
    returns an int (a cudaError_t)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            lib.dlt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.dlt_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.dlt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def launch(lib: ctypes.CDLL, fn: str, t, *args) -> None:
    """Call the C entry `fn` of `lib` with `args` and the current stream of
    the card that holds the tensor `t`, that card made current for the
    call; raise if it reports a CUDA error. A launch goes to the current
    device (stream handle 0 is that device's default stream), and a
    kernel's shared-memory opt-in is set per device, so a kernel on
    another card than the current one would otherwise run on the wrong
    card, unordered with the work queued on its own."""
    import torch

    with torch.cuda.device(t.device):
        rc = getattr(lib, fn)(*args, torch.cuda.current_stream(t.device).cuda_stream)
    check(lib, rc, fn)
