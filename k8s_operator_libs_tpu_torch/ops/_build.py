"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <name>-<digest>.so csrc/<name>.cu

The libraries are built at first use into the directory that
``K8S_OPERATOR_LIBS_TORCH_KERNEL_DIR`` names, read at each call, and without
it into ``build/torch_kernels/`` at the root of the checkout. The probe pod
points the variable at a host directory, so the pods of one node build
each library once. A library's file name carries a digest of its source
and the flags, so an edited source builds anew and an unchanged one loads
at once. A lock file serialises concurrent builds, so several processes that
start together build each library once. ``nvcc``'s ``-Xptxas -v`` report
(registers, shared memory, spills) is kept beside each library.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers pass that code to :func:`check`, which raises on anything but 0.
Without ``nvcc`` or without a card, building raises: there is no fallback
to a plain version for a tensor that lies on the card.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
#: The build directory when ``KERNEL_DIR_ENV`` is unset.
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
#: Environment variable naming the build directory.
KERNEL_DIR_ENV = "K8S_OPERATOR_LIBS_TORCH_KERNEL_DIR"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: Seconds one ``nvcc`` run may take before the build is abandoned.
NVCC_TIMEOUT_S = 600.0

_P, _I = ctypes.c_void_p, ctypes.c_int
_OUT_I, _OUT_LL = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)

#: Library name -> {C entry point -> argument types}. Every pointer and the
#: stream are ``c_void_p``: without ``argtypes`` ctypes passes a Python int
#: as a 32-bit C int and cuts the pointer. Every entry returns a CUDA error
#: code; an entry with a result writes it through its last argument.
SIGNATURES: dict[str, dict[str, list]] = {
    "matmul": {
        # (a, b, c, M, N, K, stream, *path launched)
        "k1_matmul_bf16_f32": [_P, _P, _P, _I, _I, _I, _P, _OUT_I],
        # (a, b, M, N, K) -> the kernel the call above takes
        "k1_matmul_path": [_P, _P, _I, _I, _I],
    },
    "flash_attention": {
        # (q, k, v, out, scratch, batch_heads, seq, head_dim, causal, split, stream)
        "k2_flash_attention_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        # (batch_heads, seq, head_dim, split, *f32 elements of scratch)
        "k2_scratch_elems": [_I, _I, _I, _I, _OUT_LL],
        # the same two for the wgmma family
        "k2_flash_attention_wgmma_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "k2_wgmma_scratch_elems": [_I, _I, _I, _I, _OUT_LL],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}

#: Seconds :func:`load` spent building each library in this process (0.0
#: where it found the library built).
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from ops/csrc at "
            "first use and need the CUDA toolkit"
        )
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """Where the libraries are built: ``$K8S_OPERATOR_LIBS_TORCH_KERNEL_DIR``,
    else ``build/torch_kernels/`` in the checkout."""
    return Path(os.environ.get(KERNEL_DIR_ENV) or BUILD_DIR)


def library_path(name: str) -> Path:
    return build_dir() / f"{name}-{_digest(name)}.so"


def ptxas_report(name: str) -> str:
    """What ``-Xptxas -v`` said when ``name`` was built."""
    path = library_path(name).with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""


def build(names: Iterable[str] = tuple(SIGNATURES)) -> dict[str, float]:
    """Build every library in ``names`` that is not built yet, one ``nvcc``
    per source, all started together. Returns the seconds each build took
    (0.0 for a library that was already there)."""
    names = list(names)
    for name in names:
        if name not in SIGNATURES:
            raise KeyError(f"unknown kernel library {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: the kernels run only on the card")
    nvcc = _nvcc()
    directory = build_dir()
    directory.mkdir(parents=True, exist_ok=True)
    seconds = {name: 0.0 for name in names}
    with open(directory / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        running = []
        try:
            for name in names:
                out = library_path(name)
                if out.exists():
                    continue
                tmp = out.with_suffix(".so.tmp")
                log = open(out.with_suffix(".ptxas.txt"), "w")
                proc = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                    stdout=log, stderr=subprocess.STDOUT,
                )
                running.append((name, proc, log, tmp, out, time.perf_counter()))
            errors = []
            for name, proc, log, tmp, out, start in running:
                rc = proc.wait(timeout=NVCC_TIMEOUT_S)
                log.close()
                seconds[name] = time.perf_counter() - start
                if rc != 0:
                    tail = ptxas_report(name).strip().splitlines()[-20:]
                    errors.append(f"{name}: nvcc exited {rc}\n" + "\n".join(tail))
                else:
                    os.replace(tmp, out)
            if errors:
                raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
        finally:
            for _, proc, log, *_ in running:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if need be."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    BUILD_SECONDS.update(build([name]))
    lib = ctypes.CDLL(str(library_path(name)))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        message = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({message})")


def stream_handle(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
