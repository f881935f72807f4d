"""Move forecaster state between the JAX package and the port.

Both sides meet as numpy arrays: the port imports neither JAX nor
optax. Params keep the same names and ``[in, out]`` layout on both
sides. optax's ``adam`` state is ``(ScaleByAdamState(count, mu, nu),
EmptyState())``; :func:`opt_state_from_optax` reads the Adam entry by
its attributes, so any object of that shape converts.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .forecast import PARAM_NAMES, AdamState, Params


def params_from_jax(
    params: Mapping[str, Any], device: DeviceLike = None
) -> Params:
    """JAX params (arrays or numpy) -> port params on ``device``."""
    dev = resolve_device(device)
    return {
        name: torch.as_tensor(np.array(params[name], dtype=np.float32), device=dev)
        for name in PARAM_NAMES
    }


def params_to_numpy(params: Params) -> dict[str, np.ndarray]:
    """Port params -> numpy arrays a JAX function accepts as params."""
    return {name: params[name].detach().cpu().numpy() for name in PARAM_NAMES}


def _adam_entry(opt_state: Any) -> Any:
    """The element of an optax state tree that carries ``count``, ``mu``
    and ``nu``."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for item in opt_state:
            found = _adam_entry(item)
            if found is not None:
                return found
    return None


def opt_state_from_optax(opt_state: Any, device: DeviceLike = None) -> AdamState:
    """optax ``adam`` state (or its ``ScaleByAdamState``) -> AdamState."""
    entry = _adam_entry(opt_state)
    if entry is None:
        raise ValueError("no Adam state (count, mu, nu) in the given optax state")
    dev = resolve_device(device)
    return AdamState(
        torch.as_tensor(np.array(entry.count, dtype=np.int32), device=dev),
        params_from_jax(entry.mu, dev),
        params_from_jax(entry.nu, dev),
    )


def opt_state_to_numpy(state: AdamState) -> tuple[np.ndarray, dict, dict]:
    """AdamState -> ``(count, mu, nu)`` as numpy, the fields of optax's
    ``ScaleByAdamState`` in order."""
    return (
        state.count.detach().cpu().numpy().astype(np.int32),
        params_to_numpy(state.mu),
        params_to_numpy(state.nu),
    )
