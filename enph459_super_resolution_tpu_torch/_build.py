"""Build the package's CUDA kernels with ``nvcc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and compiles on its
own into ``_build_out/lib<name>_<hash>.so`` (``_build_out`` is git-ignored),
where the hash covers the source, every shared header ``csrc/*.cuh`` and
the flags, so an edited source or header never loads a stale library.  The
build happens at first use, or for every source at once, in parallel,
through :func:`build_all`.  ``-Xptxas -v``
puts each kernel's registers, shared memory and spills into
``lib<name>_<hash>.log`` beside the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

from .utils.trace import span

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build_out"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_FUNCS: Dict[str, ctypes._CFuncPtr] = {}


def kernel_names():
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, the default toolkit
    location, or ``nvcc`` on PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    parts = [(CSRC_DIR / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh"))]
    key = hashlib.sha256(b"".join(parts)
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def _tmp_path(target: Path) -> Path:
    return target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")


def _start(name: str) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(_tmp_path(library_path(name))),
         str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode})"
                           f":\n{log}")
    target = library_path(name)
    target.with_suffix(".log").write_text(log)
    os.replace(_tmp_path(target), target)  # atomic against concurrent builds
    return log


def build(name: str) -> str:
    """Compile kernel ``name`` unless it is built already.  Returns the
    compiler's output ("" when there was nothing to build); raises if
    ``nvcc`` fails."""
    return build_all([name])[name]


def build_all(names=None) -> Dict[str, str]:
    """Compile the kernels ``names`` (default: every source under
    ``csrc/``) that are not built yet, one ``nvcc`` per source, all started
    together.  Returns each name's compiler output ("" when it was built
    already); raises if any ``nvcc`` fails, and leaves none running."""
    names = kernel_names() if names is None else list(names)
    procs = {n: _start(n) for n in names if not library_path(n).exists()}
    try:
        logs = {n: _finish(n, p) for n, p in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {n: logs.get(n, "") for n in names}


def load_function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of kernel ``name``, building the kernel
    on first use; it returns an ``int`` (a ``cudaError_t``).  The first
    load of each entry point is a ``kernels.load`` span noting the kernel,
    the symbol and whether ``nvcc`` ran for it."""
    with _LOCK:
        fn = _FUNCS.get(symbol)
        if fn is None:
            with span("kernels.load") as s:
                compiled = not library_path(name).exists()
                build(name)
                fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
                s.note(kernel=name, symbol=symbol, compiled=compiled)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _FUNCS[symbol] = fn
    return fn
