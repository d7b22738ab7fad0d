"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, and it never runs on the CPU unless asked."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from enph459_super_resolution_tpu_torch.device import resolve_device

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "enph459_super_resolution_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes",
           "enph459_super_resolution_tpu")
# optional, imported only where used: the vendor SDKs
# of hw/real.py, PyQt5 of hw/gui.py, the plots' matplotlib
ABSENT = ("gxipy", "vmbpy", "optoICC", "optoKummenberg",
          "optoControllerToolbox", "zaber_motion", "serial", "cv2", "PyQt5",
          "matplotlib")


def _blocked(name: str) -> bool:
    # exact name or a dotted child: 'enph459_super_resolution_tpu_torch'
    # shares the JAX package's prefix and must stay importable
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


def test_blocklist_minds_the_prefix():
    assert _blocked("enph459_super_resolution_tpu")
    assert _blocked("enph459_super_resolution_tpu.sr.classical")
    assert _blocked("jax.numpy")
    assert _blocked("orbax.checkpoint")
    assert not _blocked("enph459_super_resolution_tpu_torch")
    assert not _blocked("enph459_super_resolution_tpu_torch.sr.run")
    assert not _blocked("jaxtyping")


def test_every_port_module_imports_with_jax_blocked():
    """Every module of the port imports with JAX, flax, optax and the JAX
    package refused, and with no vendor SDK, no PyQt5 and no matplotlib
    (refused too): the rig's backends and GUI import them lazily."""
    script = textwrap.dedent(f"""
        import importlib, importlib.abc, pkgutil, sys
        BLOCKED = {BLOCKED + ABSENT!r}

        def blocked(name):
            return any(name == b or name.startswith(b + ".") for b in BLOCKED)

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if blocked(name):
                    raise ImportError("refused import of " + name)
                return None

        for mod in [m for m in sys.modules if blocked(m)]:
            del sys.modules[mod]
        sys.meta_path.insert(0, Refuse())
        import enph459_super_resolution_tpu_torch as pkg
        names = [pkg.__name__]
        for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(info.name)
            names.append(info.name)
        leaked = sorted(m for m in sys.modules if blocked(m))
        assert not leaked, leaked
        gui = sys.modules["enph459_super_resolution_tpu_torch.hw.gui"]
        assert gui.HAVE_QT is False
        print(" ".join(names))
    """)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 70  # every module was walked
    for mod in ("ops.conv", "ops.resample", "sr.prewarm", "sr.hybrid_bound",
                "ops.resize", "sr.fusion", "eval.metrics", "train.burst",
                "train.data", "train.losses", "train.state", "train.vgg",
                "train.loop", "train.evaluate", "parallel", "parallel.mesh",
                "parallel.tiled", "parallel.spmd", "parallel.pipeline",
                "parallel.moe", "parallel.dryrun", "eval", "eval.decode",
                "eval.code128", "eval.ean13", "eval.barcode_analysis",
                "eval.slanted_edge", "eval.cal_target_analysis", "psf",
                "psf.toolkit", "psf.analyze", "psf.cli", "hw", "hw.protocols",
                "hw.sim", "hw.autofocus", "hw.calibrate", "hw.collect",
                "hw.stability", "hw.real", "hw.gui", "utils", "utils.config",
                "utils.trace", "utils.plots", "utils.timing", "native",
                "native.build", "native.png_loader"):
        assert f"enph459_super_resolution_tpu_torch.{mod}" in names, mod


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py", "bench_fused_f32.py", "bench_k1.py",
       "bench_spans.py"]))
def test_no_jax_import_anywhere_in_source(path):
    """Lazy imports inside functions too: scan the source, not just the
    modules' import-time behavior."""
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_blocked(n) for n in names), (path, names)


def test_resolve_device_never_falls_back():
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("tpu")
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_sr_run_without_device_fails_on_a_box_without_cuda(tmp_path):
    import torch

    from enph459_super_resolution_tpu_torch.sr import run

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    data = tmp_path / "data" / "s0"
    os.makedirs(data)
    out = tmp_path / "out"
    with pytest.raises(SystemExit) as exc:
        run.main(["--workload", "mono_cal_target", "--data-dir",
                  str(data.parent), "--output-dir", str(out),
                  "--no-figures"])
    assert exc.value.code != 0
    assert not out.exists()


def test_every_kernel_entry_point_is_in_its_source():
    """Each symbol a wrapper binds with ctypes is an ``extern "C"`` function
    of the CUDA source it names, and every source under ``csrc/`` is bound:
    the card is the first place a missing one would show otherwise."""
    import re

    from enph459_super_resolution_tpu_torch import _build
    from enph459_super_resolution_tpu_torch.ops import (banded_rows,
                                                        fused_ibp, trunk)

    assert "banded_rows_x3_launch" in [spec.symbol for spec in
                                       banded_rows.KINDS.values()]
    bound = {"banded_rows": [spec.symbol
                             for spec in banded_rows.KINDS.values()],
             "fused_ibp": ["fused_fwd_launch", "fused_bwd_launch"],
             "trunk": [s for s, _ in trunk._ENTRY.values()]}
    assert sorted(bound) == _build.kernel_names()
    for name, symbols in bound.items():
        src = (_build.CSRC_DIR / f"{name}.cu").read_text()
        exported = set(re.findall(r'extern "C" int (\w+)\(', src))
        assert set(symbols) == exported, name
        for symbol in symbols:
            assert re.search(rf"\b{symbol}\b", (
                PORT / "ops" / f"{name}.py").read_text()), symbol

    def const(name, var):
        src = (_build.CSRC_DIR / f"{name}.cu").read_text()
        return int(re.search(rf"constexpr int {var} = (\d+);", src).group(1))

    # the wrappers' tile constants are the kernels'
    assert banded_rows.ROWS == const("banded_rows", "BM")
    assert banded_rows.K_CHUNK == const("banded_rows", "BK")
    assert fused_ibp.ROWS == const("fused_ibp", "BM")
    assert fused_ibp.COLS == const("fused_ibp", "TN")
    assert fused_ibp.MAX_FRAMES == const("fused_ibp", "MAX_OUT")
    assert fused_ibp.SMEM_LIMIT == const("fused_ibp", "MAX_SMEM")
    assert trunk.FEATURES == const("trunk", "C")
    assert trunk.TILE_H == const("trunk", "TH")
    assert trunk.TILE_W == const("trunk", "TW")


def test_a_shared_header_edit_rebuilds_every_kernel(tmp_path, monkeypatch):
    """The build key of each kernel covers the headers under ``csrc/``
    (``mma_bf16.cuh`` is included by trunk.cu, banded_rows.cu and
    fused_ibp.cu): an edited
    header never loads a library built from the old one."""
    import shutil

    from enph459_super_resolution_tpu_torch import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    names = _build.kernel_names()
    before = {n: _build.library_path(n) for n in names}
    assert (csrc / "mma_bf16.cuh").exists()
    for user in ("trunk", "banded_rows", "fused_ibp"):
        assert '#include "mma_bf16.cuh"' in (csrc / f"{user}.cu").read_text()
    header = csrc / "mma_bf16.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert all(_build.library_path(n) != before[n] for n in names)
