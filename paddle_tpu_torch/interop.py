"""Weights across packages: fill the port's Scope from numpy arrays.

Both packages name variables through `unique_name`, so after a reset of
each package's counters the same model script yields the same names for
every persistable: parameters, batch-norm statistics, and the optimizer's
learning rate and accumulators (`<param>_velocity_0`, `<param>_moment1_0`,
...), which both startups create. A caller reads the JAX package's values
out of its scope as numpy arrays, by name, and hands them here; the port
then computes on exactly the same weights and optimizer state (the two
packages' random initializers draw different numbers from the same seed).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def load_numpy_params(scope, arrays: Dict[str, np.ndarray],
                      device) -> None:
    """Set each `arrays[name]` in `scope` as a torch tensor on `device`,
    keeping its dtype (bfloat16 arrays, which numpy spells through
    ml_dtypes, arrive as float32 and are cast back)."""
    device = torch.device(device)
    for name, arr in arrays.items():
        a = np.asarray(arr)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            # a copy: the port updates sparse tables in place, never in
            # the caller's (or the other package's) memory
            t = torch.from_numpy(np.array(a, copy=True, order="C"))
        scope.set_var(name, t.to(device))
