"""The lock every forward-mode derivative of the port's plain versions
holds (``torch.func.jacfwd`` and ``torch.func.jvp``).

PyTorch keeps its forward-AD levels in one table for the whole process, not
per thread: two threads inside a forward-mode transform at once find each
other's level created or deleted under them ("Trying to create a dual
Tensor for forward AD but no level exists", "... a forward AD level with
an invalid index").  On the CPU the async backend runs the plain versions
on its worker thread beside the tracker (the KB8 camera's projection
Jacobian, the inertial factors, the essential graphs), so those sections
take turns.  The lock is re-entrant: a transform may call another.  The
kernels take no derivative on the host, so a run on the card never waits
on it."""
from __future__ import annotations

import threading

LOCK = threading.RLock()
