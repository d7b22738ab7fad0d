"""Build the native PNG library:
``python -m enph459_super_resolution_tpu_torch.native.build``.

``png_loader.cpp`` compiles with ``g++`` against the system's libpng into
the package's git-ignored ``_build_out/libsrpng_<hash>.so``, where the hash
covers the source and the flags, so an edited source never loads a stale
library.  The compiler writes a temporary file that is then renamed into
place, so processes building at once never load a half-written library;
nothing is written beside the sources.  A failed build leaves the
compiler's message in ``libsrpng_<hash>.err`` beside it, and later builds
raise that message without running ``g++`` again, so a machine without
libpng's headers pays for the attempt once; running this module retries.
:mod:`.png_loader` builds at first use, so running this is optional.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "png_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build_out"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-lpng", "-lpthread")


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS + LIBS).encode()
                         ).hexdigest()[:16]
    return BUILD_DIR / f"libsrpng_{key}.so"


def _failed(target: Path, msg: str) -> RuntimeError:
    """Record a failed build's message beside the library's path (written
    whole, then renamed) and return the error to raise."""
    err = target.with_suffix(".err")
    tmp = err.with_name(f"{err.stem}.{os.getpid()}.tmp.err")
    tmp.write_text(msg)
    os.replace(tmp, err)
    return RuntimeError(msg)


def build(verbose: bool = False, retry: bool = False) -> Path:
    """Compile the library unless it is built already; returns its path.
    Raises ``RuntimeError`` with the compiler's message when ``g++`` fails
    or is missing, now or, unless ``retry``, at an earlier build of the same
    source and flags."""
    target = library_path()
    if target.exists():
        return target
    err = target.with_suffix(".err")
    if err.exists() and not retry:
        raise RuntimeError(err.read_text())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), *LIBS, "-o", str(tmp)]
    if verbose:
        print(" ".join(cmd))
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise _failed(target, f"g++ did not run: {exc}") from exc
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise _failed(target, f"g++ failed (exit {res.returncode}):\n"
                      f"{res.stdout}{res.stderr}")
    os.replace(tmp, target)  # atomic against concurrent builds
    err.unlink(missing_ok=True)
    return target


def main(argv=None) -> int:
    path = build(verbose=True, retry=True)
    from . import png_loader

    png_loader.reset()  # probe the library just built
    print("built:", path, "loadable:", png_loader.available())
    return 0


if __name__ == "__main__":
    sys.exit(main())
