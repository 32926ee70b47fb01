"""Checkpoint persistence of flat {name: tensor} dicts: parameters and training
state.

Port of `stgcma_tpu/checkpoint/io.py` (orbax or an `.npz` of the flattened
tree there; `torch.save` of the flat dict here). Replaces the reference's
per-epoch torch.save(state_dict) flow (AVE/traintest_adapt_ave29.py:225-229)
and carries the mid-training resume the reference lacks. A round trip is bit
for bit: tensors are saved as they are (dtype, shape, values), on the CPU.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping

import torch


def save_checkpoint(path: str, state: Mapping[str, torch.Tensor]):
    """Write the flat {name: tensor} dict `state` to the file `path` (its
    directory made if missing), each tensor detached and on the CPU."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({k: v.detach().cpu() for k, v in state.items()}, tmp)
    os.replace(tmp, path)      # a reader never sees half a file


def load_checkpoint(path: str, device=None) -> Dict[str, torch.Tensor]:
    """The flat dict `save_checkpoint` wrote at `path`, on `device` (the CPU
    when None). Loads tensors only (`weights_only`)."""
    state = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    return state if device is None else {k: v.to(device) for k, v in state.items()}
