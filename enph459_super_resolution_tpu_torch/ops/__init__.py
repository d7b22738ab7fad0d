"""Banded operators (host construction, BandedOp) and the banded-row kernel."""
