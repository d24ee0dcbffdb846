"""Variable trees of facl_tpu (flax) -> the port's ``state_dict``.

flax names map one to one onto the port's modules (models/layers.py keeps
flax's names): ``params`` leaves become parameters, ``batch_stats`` leaves
buffers, with path segments joined by dots. A Dense ``kernel`` (in, out)
becomes an ``nn.Linear`` ``weight`` (out, in); the SA stage keeps its raw
``kernel_i`` (Cin, Cout) as in the JAX module. ``probe_from_jax`` does the
same for the linear probe's variables, ``swav_queue_from_jax`` carries
the SwAV queue and ``moco_state_from_jax`` the MoCo state. The slow/fast
encoder's variables need nothing more: its submodules keep JAX's names.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _walk(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_jax(params: Mapping, batch_stats: Mapping
             ) -> Dict[str, torch.Tensor]:
    """params / batch_stats: nested dicts of arrays (numpy or anything
    ``np.asarray`` takes). Returns a state_dict for
    ``facl_tpu_torch.models.PointNetPlus``."""
    out: Dict[str, torch.Tensor] = OrderedDict()
    for path, leaf in _walk(params):
        arr = np.array(leaf, dtype=np.float32)
        if path[-1] == "kernel":        # nn.Dense -> nn.Linear
            out[".".join(path[:-1] + ("weight",))] = torch.from_numpy(
                np.ascontiguousarray(arr.T))
        else:
            out[".".join(path)] = torch.from_numpy(arr)
    for path, leaf in _walk(batch_stats):
        out[".".join(path)] = torch.from_numpy(
            np.array(leaf, dtype=np.float32))
    return out


def probe_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The variables of facl_tpu's ``LinearProbe`` (``{"params": ...}``,
    as ``LinearProbeTrainer.params`` holds them, or the inner tree) -> a
    state_dict for ``facl_tpu_torch.models.LinearProbe``: the Dense
    kernel transposed."""
    return from_jax(params.get("params", params), {})


def swav_queue_from_jax(queue, device="cpu") -> Optional[torch.Tensor]:
    """facl_tpu's ``TrainState.swav_queue`` ((G-1, Q, D), numpy or
    anything ``np.asarray`` takes; None when SwAV is off) -> the port's
    ``TrainState.swav_queue``: the same f32 values on ``device``."""
    if queue is None:
        return None
    return torch.from_numpy(np.array(queue, dtype=np.float32)).to(device)


def moco_state_from_jax(moco_state: Any, batch_stats: Mapping
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                                   int]:
    """facl_tpu's ``MoCoState`` (``key_params``, ``queue``, ``queue_ptr``)
    and the query encoder's ``batch_stats``, which the key encoder reads
    -> (the key encoder's state_dict, the queue as the same f32 values on
    the CPU, the pointer as an int): the parts of the port's
    ``models.moco.MoCoState``."""
    return (from_jax(moco_state.key_params, batch_stats),
            torch.from_numpy(np.array(moco_state.queue, dtype=np.float32)),
            int(np.asarray(moco_state.queue_ptr)))
