"""Shared CLI plumbing: model construction by the reference model-type names,
seeding, argument archiving, pretrained loading.

Port of `stgcma_tpu/cli/common.py`. The reference's public model
identifiers (BASELINE.json): MM-Swin-AVE-{Base,Large}, MM-CLIP-AVE-{Base,Large}.
"""
from __future__ import annotations

import ast
import json
import os
import pickle
import random

import numpy as np
import torch

from ..configs import clip_b16, clip_l14, swin_base, swin_large


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
