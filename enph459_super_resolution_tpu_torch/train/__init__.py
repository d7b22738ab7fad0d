"""Training of the burst engine: losses, train state with EMA and
checkpoints, procedural scene pools and the burst trainer."""
