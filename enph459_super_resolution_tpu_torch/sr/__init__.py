"""Classical multi-frame SR: the banded solve, workload configs, the session
pipeline and its CLI (``python -m enph459_super_resolution_tpu_torch.sr.run``)."""
