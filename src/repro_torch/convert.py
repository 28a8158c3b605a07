"""Reference params, decode caches and optimizer states (nested numpy
arrays) -> the port's.

The reference initialises with ``jax.random``, which torch cannot
reproduce, so parity tests hand the same params to both packages through
numpy: ``params_from_reference(jax.tree.map(np.asarray, ref_params))``.
A decode cache (``LM.init_cache``'s tree, mid-sequence) crosses the same
way through ``cache_from_reference``, and an optimizer state (``m``,
``v``, ``master``, ``step``, int8 ``{"q", "scale"}`` moments) through
``opt_state_from_reference``, so the port's trainer can continue a
reference run. The nested dict/list structure (stacked groups included)
is kept 1:1.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a).reshape(np.shape(a))   # 0-d stays 0-d
    if a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16: cross as the 16-bit pattern, bit-exactly
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_reference(tree, *, device="cuda"):
    """Map a nested dict/list/tuple of numpy arrays onto torch tensors on
    ``device``. fp32 and int32 cross as is; bfloat16 through an int16
    view. A decode cache crosses the same way."""
    dev = resolve(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return _tensor(np.asarray(x), dev)

    return conv(tree)


# an alias: a decode cache (``k``/``v`` in the compute dtype, ``pos`` int32,
# grouped as ``LM.init_cache``) crosses as params do
cache_from_reference = params_from_reference


def opt_state_from_reference(state, *, device="cuda"):
    """A reference optimizer state (``repro.train.optimizer.
    init_opt_state``'s tree, numpy leaves) on ``device``: ``step`` a 0-d
    int32 tensor, the moments fp32 or int8 ``{"q", "scale"}`` blocks, the
    fp32 master copy if the state has one; every value bit for bit."""
    missing = {"step", "m", "v"} - set(state)
    extra = set(state) - {"step", "m", "v", "master"}
    if missing or extra:
        raise ValueError(f"not an optimizer state: missing {sorted(missing)}"
                         f", unknown {sorted(extra)}")
    return params_from_reference(dict(state), device=device)
