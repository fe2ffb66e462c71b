"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source compiles in its own ``nvcc`` process, all started together,
and one more ``nvcc`` links the objects into one shared library with a
plain C interface, which is loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC --fmad=false -c -o X.o csrc/X.cu     (per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o lib...so *.o

``--fmad=false`` keeps the intersectors' t, u and v equal to their plain
PyTorch versions to the ulp (the sort is integer-only, so the flag does
not touch it). The library lands in ``build/henjou_torch/`` at the
repository root, named by a hash of the sources, the shared headers and
the flags, so an edit to any of them rebuilds it and an unchanged tree
reuses it.

Each C entry point takes device pointers and a ``cudaStream_t`` (all as
``c_void_p``), launches on that stream without synchronising, and returns
``cudaGetLastError()``; ``check`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = CSRC_DIR.parent.parent / "build" / "henjou_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "--fmad=false")

# seconds the last build took in this process (0.0 when the library was
# already built); set by load_library
BUILD_SECONDS = {"seconds": 0.0, "built": False}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC_DIR.glob("*.cu*")):  # the sources and the headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(COMPILE_FLAGS).encode())
    return BUILD_DIR / f"libhenjou_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands at once; raise with the compiler's output of the
    first that fails, after every one has ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}\n{err}"
            )


@functools.cache
def load_library() -> ctypes.CDLL:
    """Compile ``csrc/*.cu`` if this source hash has no library yet, then
    load it. Raises ``RuntimeError`` with the compiler's output when
    ``nvcc`` fails."""
    lib_path = library_path()
    t0 = time.monotonic()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
        try:
            objs = [work / f"{src.stem}.o" for src in _sources()]
            _run_all([[_nvcc(), *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
                      for src, obj in zip(_sources(), objs)])
            tmp = work / "lib.so"
            _run_all([[_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
                       *map(str, objs)]])
            os.replace(tmp, lib_path)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        BUILD_SECONDS.update(seconds=time.monotonic() - t0, built=True)
    return ctypes.CDLL(str(lib_path))


# argument kinds for `bind`: a device pointer or the stream, and an int
# (the C side declares it `long long`)
PTR = ctypes.c_void_p
INT = ctypes.c_int64


def bind(name: str, argtypes):
    """The library's C function `name` with its ``argtypes`` declared
    (``PTR``/``INT`` per argument). It returns a cudaError_t as int."""
    fn = getattr(load_library(), name)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
