"""Shared CLI plumbing: model construction by the reference model-type names,
seeding, argument archiving, pretrained loading.

Port of `stgcma_tpu/cli/common.py`. The reference's public model
identifiers (BASELINE.json): MM-Swin-AVE-{Base,Large}, MM-CLIP-AVE-{Base,Large}.
"""
from __future__ import annotations

import ast
import contextlib
import json
import os
import pickle
import random

import numpy as np
import torch

from ..configs import clip_b16, clip_l14, swin_base, swin_large


DETERMINISTIC = "STGCMA_DETERMINISTIC"


@contextlib.contextmanager
def deterministic_algorithms():
    """With STGCMA_DETERMINISTIC=1 in the environment, torch's deterministic
    algorithms inside the block (or the decorated call): an op that has
    none raises, cuDNN picks deterministic convolutions, and cuBLAS gets a
    fixed workspace. A run resumed after an epoch then reaches the straight
    run's masters bit for bit on the card. Unset (the default), the card's
    backwards sum in a varying order (cuDNN's algorithms, atomics), and Adam
    turns the sign of a gradient that is rounding noise into a whole update,
    so a resumed AVS run drifts from the straight one. An environment
    switch, so that the CLIs keep the JAX CLIs' flags."""
    if os.environ.get(DETERMINISTIC) != "1":
        yield
        return
    old = torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic
    workspace = "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    if workspace:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old[0])
        torch.backends.cudnn.deterministic = old[1]
        if workspace:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]


def str2bool(v):
    return ast.literal_eval(str(v).capitalize()) if isinstance(v, str) else bool(v)


def seed_everything(seed: int = 0) -> torch.Generator:
    """Fixed seed like the reference (AVE/run_adapt_ave29.py:86-89): Python's,
    numpy's and torch's global generators, and a torch.Generator of `seed`
    for the caller's own draws (the JAX key's place)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def archive_args(args, exp_dir: str):
    """args.pkl + args.json experiment archive (AVE/run_adapt_ave29.py:193-196)."""
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "args.pkl"), "wb") as f:
        pickle.dump(args, f)
    with open(os.path.join(exp_dir, "args.json"), "w") as f:
        json.dump(vars(args), f, indent=1, default=str)


def build_ave_model(model_type: str, ftmode: str, label_dim: int, adapter_ratios=None,
                    num_frames: int = 10):
    """-> (flavor, cfg). flavor in {'swin', 'clip'}."""
    ratios = {"adapter_ratios": tuple(adapter_ratios)} if adapter_ratios else {}
    if model_type == "MM-Swin-AVE-Base":
        return "swin", swin_base(ftmode=ftmode, label_dim=label_dim, num_frames=num_frames,
                                 **ratios)
    if model_type == "MM-Swin-AVE-Large":
        return "swin", swin_large(ftmode=ftmode, label_dim=label_dim, num_frames=num_frames,
                                  **ratios)
    if model_type == "MM-CLIP-AVE-Base":
        return "clip", clip_b16(ftmode=ftmode, label_dim=label_dim, num_frames=num_frames)
    if model_type == "MM-CLIP-AVE-Large":
        return "clip", clip_l14(ftmode=ftmode, label_dim=label_dim, num_frames=num_frames)
    raise ValueError(f"unknown model type {model_type}")


def maybe_load_pretrained(model, pretrained: str, flavor: str, cfg, device="cuda"):
    """The model with a torch pretrained checkpoint loaded if one is given
    (`load_pretrained_swin2d` / `load_pretrained_clip`), on `device`."""
    if not pretrained:
        return model
    from ..checkpoint import torch_convert as TC
    ckpt = torch.load(pretrained, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    load = TC.load_pretrained_swin2d if flavor == "swin" else TC.load_pretrained_clip
    model, unexpected = load(model, sd, cfg, device=device)
    print(f"loaded {pretrained}; unexpected keys: {len(unexpected)}")
    return model
