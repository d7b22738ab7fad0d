"""The port's ``sr.hybrid_bound`` against the JAX module (rtol 1e-9), the
checks of ``tests/test_hybrid_bound.py`` on the port's operators, and the
flagship numbers in ``artifacts/hybrid_bound_flagship.json``."""

import json
from pathlib import Path

import numpy as np
import pytest

from enph459_super_resolution_tpu.sr import hybrid_bound as JH
from enph459_super_resolution_tpu_torch.sr import hybrid_bound as TH

LR = (64, 96)  # reduced geometry; same kernel/shift/stride structure
FLAGSHIP = Path(__file__).resolve().parents[1] / "artifacts" / \
    "hybrid_bound_flagship.json"


def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    else:
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)


def test_bf16_rounding_equals_ml_dtypes():
    rng = np.random.default_rng(0)
    a = rng.normal(size=20000) * np.exp(rng.uniform(-30, 30, 20000))
    np.testing.assert_array_equal(TH._bf16_round(a), JH._bf16_round(a))


def test_quantities_equal_jax():
    _close(TH.operator_norms(lr_shape=LR), JH.operator_norms(lr_shape=LR))
    _close(TH.injection_bound(lr_shape=LR), JH.injection_bound(lr_shape=LR))
    _close(TH.mode_spectrum(lr_shape=LR), JH.mode_spectrum(lr_shape=LR))
    for rho0, target in ((0.98, 0.5), (0.9, 0.25), (0.5, 10.0)):
        eps = TH.injection_bound(lr_shape=LR)
        assert TH.derived_tail(eps, rho0, target) == \
            JH.derived_tail(eps, rho0, target)
    got = TH.report(LR, 64, 16)
    want = JH.report(LR, 64, 16)
    _close({k: v for k, v in got.items() if k != "lr_shape"},
           {k: v for k, v in want.items() if k != "lr_shape"})


def test_refuses_non_grid_patterns():
    with pytest.raises(ValueError, match="product grid"):
        TH.mode_spectrum(shifts_yx=((0.0, 0.0), (0.5, 0.5)))
    with pytest.raises(ValueError, match="rank-1"):
        y, x = np.mgrid[-3:4, -3:4]
        TH.injection_bound(psf=np.exp(-(x - 0.5 * y) ** 2 - y ** 2 / 4.0),
                           lr_shape=(16, 24))


def test_flagship_numbers():
    """The checked flagship record: the injection bound and every norm are
    interior properties of the band entries, so the reduced geometry gives
    them; the spectrum's structure holds as tests/test_hybrid_bound.py
    checks it."""
    flag = json.loads(FLAGSHIP.read_text())
    eps = TH.injection_bound(lr_shape=LR)
    np.testing.assert_allclose(eps, flag["eps_inf_per_iter"], rtol=1e-9)
    np.testing.assert_allclose(eps * 64, flag["unconditional_bound_counts"],
                               rtol=1e-9)
    assert TH.derived_tail(eps, 0.98, 0.5) == \
        flag["derived_tail_rho0_0.98_target_0.5"] >= 16
    norms = TH.report(LR, spectrum=False)["norms"]
    assert norms.keys() == flag["norms"].keys()
    _close({k: {q: v for q, v in n.items()} for k, n in norms.items()},
           flag["norms"])
    spec = TH.mode_spectrum(lr_shape=LR)
    assert abs(spec["frac_ge_0.999"] - flag["spectrum"]["frac_ge_0.999"]) \
        < 0.02
    assert abs(spec["null_frac_y"] - 0.5) < 0.02
    assert abs(spec["null_frac_x"] - 0.5) < 0.02
    assert spec["frac_ge_0.98"] > spec["frac_ge_0.999"]
    assert spec["asym_y"] < 0.2 and spec["abs_lambda_max"] < 1.01
    assert 0.0 < eps < 0.5 and eps * 64 > 2.0 and eps * 80 < 40.0


def test_cli_prints_the_report(capsys):
    assert TH.main(["--lr-shape", "16,24", "--no-spectrum"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["lr_shape"] == [16, 24] and "spectrum" not in out
