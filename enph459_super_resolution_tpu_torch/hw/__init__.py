"""Hardware layer: protocols, simulator, real backends, orchestrators (the
port's counterpart of ``enph459_super_resolution_tpu/hw``)."""

from .protocols import (
    TRIGGER_LINE0,
    TRIGGER_LINE2,
    TRIGGER_LINE3,
    TRIGGER_SOFTWARE,
    BeamSteering,
    BurstCamera,
    Camera,
    Stage,
    get_xpr_angles,
)
from .sim import (
    SimBeamSteering,
    SimCamera,
    SimConfig,
    SimStage,
    SimStage3Axis,
    SimulatedRig,
    knife_edge_scene,
    pinhole_scene,
)

__all__ = [
    "TRIGGER_LINE0", "TRIGGER_LINE2", "TRIGGER_LINE3", "TRIGGER_SOFTWARE",
    "BeamSteering", "BurstCamera", "Camera", "Stage", "get_xpr_angles",
    "SimBeamSteering", "SimCamera", "SimConfig", "SimStage",
    "SimStage3Axis", "SimulatedRig",
    "knife_edge_scene", "pinhole_scene",
]
