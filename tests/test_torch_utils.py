"""The port's ``utils/`` (config, trace, plots) and ``models.common.
ConvBlock`` against the JAX package's, on the CPU.

Configs round-trip, override and overlay the environment exactly as JAX's
do; ``device_trace`` writes a ``torch.profiler`` Chrome trace where JAX's
writes a ``jax.profiler`` one; the plotting CLIs draw headless (Agg) from
the same inputs and return JAX's numbers; ``ConvBlock`` with flax-
initialised weights carried over by ``convert.load_flax_params`` is within
``CONV_ATOL`` of the flax module.
"""

import dataclasses
import json
import os
import textwrap

import numpy as np
import pytest

from enph459_super_resolution_tpu import utils as JU
from enph459_super_resolution_tpu_torch import utils as TU

CONV_ATOL = 1e-5


@dataclasses.dataclass(frozen=True)
class Inner:
    gain: float = 3.2
    steps: int = 15


@dataclasses.dataclass(frozen=True)
class Outer:
    name: str = "run"
    fast: bool = False
    inner: Inner = dataclasses.field(default_factory=Inner)
    sizes: tuple = (96, 128)


def test_exports_are_jax_s():
    assert TU.__all__ == JU.__all__
    for name in TU.__all__:
        assert hasattr(TU, name)


@pytest.mark.parametrize("cfg", [
    Outer(),
    Outer(name="x", inner=Inner(gain=4.5)),
    Outer(fast=True, inner=Inner(steps=3), sizes=(3, 4, 5)),
], ids=["default", "nested", "tuple"])
def test_round_trip(cfg, tmp_path):
    d = TU.to_dict(cfg)
    assert d == JU.to_dict(cfg)
    back = TU.from_dict(Outer, json.loads(json.dumps(d)))
    assert back == cfg == JU.from_dict(Outer, json.loads(json.dumps(d)))
    TU.save(cfg, str(tmp_path / "port.json"))
    JU.save(cfg, str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    assert TU.load(Outer, str(tmp_path / "jax.json")) == cfg


def test_unknown_key_rejected():
    with pytest.raises(KeyError, match="typo_field"):
        TU.from_dict(Outer, {"typo_field": 1})


@pytest.mark.parametrize("overrides", [
    ["inner.gain=9.5", "fast=true", "inner.steps=3"],
    ["name=other", "fast=0"],
    [],
], ids=["nested", "top", "none"])
def test_dotted_overrides_coerce_types(overrides):
    got = TU.apply_overrides(Outer(), overrides)
    assert got == JU.apply_overrides(Outer(), overrides)
    if overrides and overrides[0] == "inner.gain=9.5":
        assert got.inner.gain == 9.5 and got.fast is True
        assert got.inner.steps == 3 and isinstance(got.inner.steps, int)


def test_env_overlay(monkeypatch):
    monkeypatch.setenv("SRTPU_NAME", "from_env")
    monkeypatch.setenv("SRTPU_FAST", "1")
    cfg = TU.apply_env(Outer())
    assert cfg.name == "from_env" and cfg.fast is True
    assert cfg == JU.apply_env(Outer())
    monkeypatch.setenv("MYAPP_NAME", "other")
    assert TU.apply_env(Outer(), prefix="MYAPP_") == \
        JU.apply_env(Outer(), prefix="MYAPP_")


def test_from_dict_with_future_annotations(tmp_path):
    """String annotations (``from __future__ import annotations``) still
    recurse into nested dataclasses."""
    import importlib.util
    import sys

    src = textwrap.dedent("""
        from __future__ import annotations
        import dataclasses

        @dataclasses.dataclass(frozen=True)
        class In2:
            gain: float = 1.0

        @dataclasses.dataclass(frozen=True)
        class Out2:
            name: str = "x"
            inner: In2 = dataclasses.field(default_factory=In2)
    """)
    path = tmp_path / "cfgmod_future_port.py"
    path.write_text(src)
    spec = importlib.util.spec_from_file_location("cfgmod_future_port", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["cfgmod_future_port"] = mod
    try:
        spec.loader.exec_module(mod)
        back = TU.from_dict(mod.Out2, TU.to_dict(mod.Out2(
            inner=mod.In2(gain=7.5))))
    finally:
        del sys.modules["cfgmod_future_port"]
    assert isinstance(back.inner, mod.In2)
    assert back.inner.gain == 7.5


def test_stage_timer_accumulates():
    t = TU.StageTimer()
    for name in ("a", "a", "b"):
        with t.stage(name):
            pass
    d = t.as_dict()
    assert set(d) == {"a", "b"} and d["a"] >= 0


def test_metrics_logger_lines_equal_jax_s(tmp_path):
    logs = {}
    for name, mod in (("port", TU), ("jax", JU)):
        path = str(tmp_path / name / "metrics.jsonl")
        log = mod.MetricsLogger(path)
        log.log({"step": 1, "loss": 0.5})
        log.log({"step": 2}, loss=0.25, wall_s=7.0)
        logs[name] = [json.loads(line) for line in open(path)]
    for got, want in zip(*logs.values()):
        assert got.pop("wall_s") >= 0 and want.pop("wall_s") >= 0
        assert got == want
    assert logs["port"][1] == {"step": 2, "loss": 0.25}


@pytest.mark.parametrize("enabled", [True, False])
def test_device_trace_writes_a_trace_on_the_cpu(tmp_path, enabled):
    """``device_trace`` profiles the block with ``torch.profiler`` and
    writes a Chrome trace naming the block's ops into ``log_dir``, with
    spans on and the block's spans on a ``spans`` track on the trace's
    clock; disabled, it writes nothing and records no span."""
    import torch

    from enph459_super_resolution_tpu_torch.utils import trace as TT

    TT.drain_spans()
    log_dir = tmp_path / "trace"
    with TU.device_trace(str(log_dir), enabled=enabled) as prof:
        with TT.span("block"):
            torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    assert TT.set_spans(False) is False
    kept, _ = TT.drain_spans()
    if not enabled:
        assert prof is None and not log_dir.exists() and kept == []
        return
    assert [s.name for s in kept] == ["block"]
    files = list(log_dir.iterdir())
    assert files == [__import__("pathlib").Path(prof.trace_path)]
    events = json.loads(files[0].read_text())["traceEvents"]
    mm = [e for e in events
          if "matmul" in e.get("name", "") or "mm" == e.get("name", "")]
    assert mm
    block, = [e for e in events if e.get("cat") == "span"]
    assert block["name"] == "block" and block["tid"] == "spans"
    for e in mm:
        assert block["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= block["ts"] + block["dur"]


# ---------------------------------------------------------------------------
# plots (matplotlib's Agg backend; the port imports matplotlib only here)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shifts_csv(tmp_path_factory):
    """A shifts.csv of the calibration's schema: 3 tilts x 2 axes x the 8
    off-centre positions, shifts at 3.2 px/deg with a seeded spread."""
    from enph459_super_resolution_tpu_torch.hw.calibrate import (
        CENTER_IDX, GRID_LABELS, GRID_SIGNS, save_shifts_csv)

    rng = np.random.default_rng(0)
    by_axis = {}
    for axis in ("x", "y"):
        results = {}
        for tilt in (0.1, 0.2, 0.3):
            shifts = {}
            for p, (sx, sy) in enumerate(GRID_SIGNS):
                if p == CENTER_IDX:
                    continue
                dx = 3.2 * tilt * sx * (axis == "x") + rng.normal(0, 0.01)
                dy = 3.2 * tilt * sy * (axis == "y") + rng.normal(0, 0.01)
                shifts[p] = {"pos": p, "label": GRID_LABELS[p],
                             "dx_mean": dx, "dx_std": abs(rng.normal(0, .01)),
                             "dy_mean": dy, "dy_std": abs(rng.normal(0, .01))}
            results[tilt] = {"mean_shifts": shifts}
        by_axis[axis] = results
    path = tmp_path_factory.mktemp("cal") / "shifts.csv"
    save_shifts_csv(by_axis, str(path))
    return str(path)


def test_load_shifts_equals_jax_s(shifts_csv):
    from enph459_super_resolution_tpu.utils.plots import \
        load_shifts as jax_load
    from enph459_super_resolution_tpu_torch.utils.plots import load_shifts

    got, want = load_shifts(shifts_csv), jax_load(shifts_csv)
    assert {a: dict(v) for a, v in got.items()} == \
        {a: dict(v) for a, v in want.items()}
    assert sorted(got["x"]) == [0, 1, 2, 3, 5, 6, 7, 8]


def _png_size(path):
    from enph459_super_resolution_tpu_torch.data.io import load_image

    return load_image(str(path), np.uint8).shape[:2]


def test_plot_beam_shifts_headless(shifts_csv, tmp_path):
    from enph459_super_resolution_tpu.utils.plots import \
        plot_beam_shifts as jax_plot
    from enph459_super_resolution_tpu_torch.utils.plots import \
        plot_beam_shifts

    plot_beam_shifts(shifts_csv, str(tmp_path / "port.png"))
    jax_plot(shifts_csv, str(tmp_path / "jax.png"))
    assert _png_size(tmp_path / "port.png") == _png_size(tmp_path / "jax.png")


@pytest.fixture(scope="module")
def focus_json(tmp_path_factory):
    from enph459_super_resolution_tpu_torch.hw.autofocus import \
        save_autofocus_result

    pos = np.linspace(350.0, 390.0, 21)
    vals = 100.0 * np.exp(-((pos - 369.23) / 6.0) ** 2) + 3.0
    res = {"best_pos_mm": float(pos[np.argmax(vals)]),
           "best_metric": float(vals.max()), "positions": pos.tolist(),
           "values": vals.tolist(), "metric": "Laplacian Variance"}
    return save_autofocus_result(res, str(tmp_path_factory.mktemp("af")))


@pytest.mark.parametrize("threshold", [0.5, 0.8])
def test_plot_depth_of_field_headless(focus_json, tmp_path, threshold):
    from enph459_super_resolution_tpu.utils.plots import \
        plot_depth_of_field as jax_plot
    from enph459_super_resolution_tpu_torch.utils.plots import \
        plot_depth_of_field

    got = plot_depth_of_field(focus_json, str(tmp_path / "port.png"),
                              threshold)
    want = jax_plot(focus_json, str(tmp_path / "jax.png"), threshold)
    assert got == want
    assert got["span"][0] <= 369.23 <= got["span"][1]
    assert _png_size(tmp_path / "port.png") == _png_size(tmp_path / "jax.png")


def test_plot_confidence_vs_pitch_headless(tmp_path):
    from enph459_super_resolution_tpu.utils.plots import \
        plot_confidence_vs_pitch as jax_plot
    from enph459_super_resolution_tpu_torch.eval import barcode_analysis
    from enph459_super_resolution_tpu_torch.utils.plots import \
        plot_confidence_vs_pitch

    assert not hasattr(barcode_analysis, "plot_confidence_vs_pitch")
    records = [{"method": m, "pitch_mil": p, "confidence": c,
                "decoded_text": "004" if c > 0.5 else None}
               for m, base in (("Native-2x", 0.0), ("SAA", 0.3),
                               ("SAA+IBP", 0.6))
               for p in (2, 4, 6) for c in (base, min(1.0, base + 0.1 * p))]
    plot_confidence_vs_pitch(records, str(tmp_path / "port.png"))
    jax_plot(records, str(tmp_path / "jax.png"))
    assert _png_size(tmp_path / "port.png") == _png_size(tmp_path / "jax.png")


@pytest.mark.parametrize("cmd", ["beam-shifts", "dof"])
def test_plots_cli(cmd, shifts_csv, focus_json, tmp_path, capsys):
    from enph459_super_resolution_tpu.utils.plots import main as jax_main
    from enph459_super_resolution_tpu_torch.utils.plots import main

    src = shifts_csv if cmd == "beam-shifts" else focus_json
    assert main([cmd, src, str(tmp_path / "port.png")]) == 0
    got = capsys.readouterr().out
    assert jax_main([cmd, src, str(tmp_path / "jax.png")]) == 0
    want = capsys.readouterr().out
    assert got.replace("port.png", "x") == want.replace("jax.png", "x")
    assert os.path.exists(tmp_path / "port.png")


# ---------------------------------------------------------------------------
# models.common.ConvBlock
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,act,c_in,c_out", [
    (3, None, 3, 8), (3, "relu", 4, 16), (1, "relu", 8, 8), (5, None, 1, 4),
])
def test_conv_block_matches_flax(kernel, act, c_in, c_out):
    """``ConvBlock`` with the flax module's initialised weights, carried
    over by ``convert.load_flax_params``, within ``CONV_ATOL`` of flax."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import torch

    from enph459_super_resolution_tpu.models.common import \
        ConvBlock as FlaxConvBlock
    from enph459_super_resolution_tpu_torch import convert
    from enph459_super_resolution_tpu_torch.models.common import ConvBlock

    x = np.random.default_rng(kernel + c_in).normal(
        size=(2, 12, 10, c_in)).astype(np.float32)
    fm = FlaxConvBlock(features=c_out, kernel=kernel,
                       act=nn.relu if act else None)
    params = fm.init(jax.random.PRNGKey(c_out), jnp.asarray(x))
    want = np.asarray(fm.apply(params, jnp.asarray(x)))
    tree = jax.tree.map(np.asarray, params)
    block = ConvBlock(c_in, c_out, kernel, act=torch.relu if act else None)
    convert.load_flax_params(block, tree)
    assert sorted(block.state_dict()) == ["conv.bias", "conv.weight"]
    got = block(torch.as_tensor(x)).detach().numpy()
    assert got.shape == want.shape == (2, 12, 10, c_out)
    np.testing.assert_allclose(got, want, rtol=0, atol=CONV_ATOL)
    if act:
        assert (got >= 0).all()
