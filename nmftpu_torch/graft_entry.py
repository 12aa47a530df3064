"""The single-device entry point (port of ``__graft_entry__.entry``): one
full MU iteration under the Frobenius objective plus the error on the
device, on a dense 256 x 256 V at rank 32. The multi-rank dry run, the
other half of that file, is `parallel.dryrun.dryrun_multichip`.

    step, (V, W, H) = entry()                 # on the card
    W1, H1, err = step(V, W, H)
    step, args = entry(device="cpu")          # the plain torch path

The products are plain ``torch.matmul``: ``nmftpu`` leaves this step to
XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from nmftpu_torch.driver import _resolve_device
from nmftpu_torch.linalg import dense as D


def step(V, W, H):
    """One MU-Frobenius iteration (W first, eps 1e-9), then ||V - WH||_F
    of the new factors: (W, H, error), the error a 0-d tensor."""
    W, H = D.mu_update_frobenius(V, W, H, eps=1e-9)
    return W, H, D.frobenius_error(V, W, H)


def entry(device=None):
    """(step, (V, W, H)): V (256, 256), W (256, 32) and H (32, 256),
    uniform in [0.1, 1) from numpy's default_rng(0), drawn in that order
    and rounded to float32, as ``__graft_entry__.entry`` draws them; on
    `device`, by default the card."""
    dev = _resolve_device(None, device)
    rng = np.random.default_rng(0)
    n, m, r = 256, 256, 32
    args = tuple(
        torch.as_tensor(rng.uniform(0.1, 1.0, shape), dtype=torch.float32,
                        device=dev)
        for shape in ((n, m), (n, r), (r, m)))
    return step, args
