"""Declarative workload configs (counterpart of
``enph459_super_resolution_tpu/sr/config.py``) — the matrix the reference
spreads across four copy-pasted scripts.

| workload        | layout       | shifts               | channel | IBP |
|-----------------|--------------|----------------------|---------|-----|
| mono_cal_target | center+4     | nominal table        | mono    | 80  |
| rgb_cal_target  | corner (avg) | metadata.json / 2    | red     | 50  |
| mono_barcodes   | corner (rep) | nominal ±0.5         | mono    | 80  |
| rgb_barcodes    | corner (rep) | nominal ±0.5 red-LR  | red     | 80  |
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..data import sessions as S
from .classical import IBP_STEP_SIZE, PSF_SIGMA, PSF_SIZE, UPSAMPLE_FACTOR


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    name: str
    layout: str  # 'center_shift' | 'corner_rep'
    bayer_red: bool = False
    average_reps: bool = False
    use_metadata_shifts: bool = False
    nominal_shifts: Optional[Tuple[Tuple[float, float], ...]] = S.CORNER_SHIFTS_LR
    upsample_factor: int = UPSAMPLE_FACTOR
    psf_size: int = PSF_SIZE
    psf_sigma: float = PSF_SIGMA
    ibp_iterations: int = 80
    ibp_step: float = IBP_STEP_SIZE
    # Bayer workloads name the LR mean 'LR_red_mean.png'
    # (``rgb_cal_target/run_sr.py:323``).
    lr_mean_name: str = "LR_mean.png"

    def load(self, session_dir: str) -> List[S.SessionData]:
        if self.layout == "center_shift":
            return [S.load_center_shift_session(session_dir, self.bayer_red)]
        shifts = None if self.use_metadata_shifts else self.nominal_shifts
        return S.load_corner_rep_sessions(
            session_dir, bayer_red=self.bayer_red,
            average_reps=self.average_reps, shifts=shifts)


WORKLOADS = {
    # mono_cal_target/run_sr.py:56-66
    "mono_cal_target": WorkloadConfig(
        name="mono_cal_target", layout="center_shift", ibp_iterations=80),
    # rgb_cal_target/run_sr.py:56-60,88-113
    "rgb_cal_target": WorkloadConfig(
        name="rgb_cal_target", layout="corner_rep", bayer_red=True,
        average_reps=True, use_metadata_shifts=True, ibp_iterations=50,
        lr_mean_name="LR_red_mean.png"),
    # mono_barcodes/run_sr.py:60-77
    "mono_barcodes": WorkloadConfig(
        name="mono_barcodes", layout="corner_rep", ibp_iterations=80),
    # rgb_barcodes/run_sr.py:68-84
    "rgb_barcodes": WorkloadConfig(
        name="rgb_barcodes", layout="corner_rep", bayer_red=True,
        ibp_iterations=80, lr_mean_name="LR_red_mean.png"),
}
