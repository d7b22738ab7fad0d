"""Work counters: the operations and bytes a call's kernels need, counted
from the shapes and from the nonzeros of the benchmark's own operators
(:mod:`srbench.reference`), never from the program's packs or windows, so
a count reads the same whatever implements it.  The peaks they are held
against are in :mod:`.peaks`."""
