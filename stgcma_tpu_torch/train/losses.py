"""Task losses.

Port of `stgcma_tpu/train/losses.py` (:1-138), on tensors; every loss takes
its logits in float32, as the JAX functions do.
- AVE: CE with soft (one-hot) targets on per-second logits, labels rearranged
  'b t c -> (b t) c' (AVE/traintest_adapt_ave29.py:110-114,161-163); BCE option.
- AVQA: CE(out_qa, answer) + 0.5 * CE(out_match, match_labels) with interleaved
  posi/nega rows (AVQA/traintest_adapt_avqa.py:16-30,172-179).
- AVS: F1_IoU_BCELoss on frame 0 of each clip + optional audio-masked-visual
  similarity loss; mask_iou eval metric (AVS/loss.py:7-138).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def softmax_cross_entropy(logits, soft_targets):
    """torch nn.CrossEntropyLoss with class-probability targets, mean reduction."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(soft_targets.float() * logp).sum(-1).mean()


def cross_entropy_int(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None]).mean()


def bce_with_logits(logits, targets):
    logits, targets = logits.float(), targets.float()
    return torch.mean(torch.clamp_min(logits, 0) - logits * targets
                      + torch.log1p(torch.exp(-logits.abs())))


def ave_loss(logits, labels, kind: str = "CE"):
    """logits (B*T, C); labels (B, T, C) one-hot -> scalar."""
    flat = labels.reshape(-1, labels.shape[-1])
    if kind == "CE":
        return softmax_cross_entropy(logits, flat)
    return bce_with_logits(logits, flat)


def avqa_match_organize(out_posi, out_nega):
    """Interleave posi/nega rows and build 1/0 labels
    (AVQA/traintest_adapt_avqa.py:16-30)."""
    n = out_posi.shape[0]
    out = torch.stack([out_posi, out_nega], dim=1).reshape(2 * n, -1)
    labels = torch.tensor([1, 0], dtype=torch.int32, device=out.device).repeat(n)
    return out, labels


def avqa_loss(out_qa, out_match_posi, out_match_nega, answer_ids, kind: str = "CE"):
    """kind applies to BOTH the qa and match terms
    (AVQA/traintest_adapt_avqa.py:129-134,172-179); BCE one-hots the integer
    targets first."""
    out_match, match_labels = avqa_match_organize(out_match_posi, out_match_nega)
    if kind == "BCE":
        loss_qa = bce_with_logits(out_qa, F.one_hot(answer_ids.long(), out_qa.shape[-1]))
        loss_match = bce_with_logits(out_match,
                                     F.one_hot(match_labels.long(), out_match.shape[-1]))
    else:
        loss_qa = cross_entropy_int(out_qa, answer_ids)
        loss_match = cross_entropy_int(out_match, match_labels)
    return loss_qa + 0.5 * loss_match, {"loss_qa": loss_qa, "loss_match": loss_match}


def f1_iou_bce_loss(pred_masks, first_gt_mask, frames_per_clip: int = 5):
    """BCE(sigmoid(pred of frame 0 of each clip), gt) (AVS/loss.py:7-31).

    pred_masks: (B*T, H, W, 1) logits; first_gt_mask: (B, H, W, 1) in {0,1}.
    """
    BT = pred_masks.shape[0]
    first = pred_masks.reshape(BT // frames_per_clip, frames_per_clip,
                               *pred_masks.shape[1:])[:, 0]
    p = torch.sigmoid(first.float())
    g = first_gt_mask.float()
    eps = 1e-7
    p = torch.clamp(p, eps, 1 - eps)
    return -(g * torch.log(p) + (1 - g) * torch.log(1 - p)).mean()


def a_masked_v_simm_loss(pred_masks, a_fea_list, v_map_list, count_stages,
                         frames_per_clip: int = 5):
    """Audio / masked-visual cosine log loss, Loss_AVM_AV (AVS/loss.py:30-77).
    Off by default in the reference (sa_loss_flag=False)."""
    p = torch.sigmoid(pred_masks.float())               # (B*T, 224, 224, 1)
    total = 0.0
    for stage in count_stages:
        a_fea = a_fea_list[stage].reshape(-1, a_fea_list[stage].shape[-1])
        v_map = v_map_list[stage].float()               # (B*T, H, W, C)
        H, W = v_map.shape[1], v_map.shape[2]
        kh, kw = p.shape[1] // H, p.shape[2] // W
        down = p.reshape(p.shape[0], H, kh, W, kw, 1).mean(dim=(2, 4))
        down = (down > 0.5).float()
        obj_pix = down.sum(dim=(1, 2))                  # (B*T, 1)
        masked = (v_map * down).sum(dim=(1, 2)) / (obj_pix + 1e-6)
        a_n = a_fea / torch.clamp_min(torch.linalg.norm(a_fea, dim=-1, keepdim=True), 1e-12)
        v_n = masked / torch.clamp_min(torch.linalg.norm(masked, dim=-1, keepdim=True), 1e-12)
        cos = torch.relu((a_n * v_n).sum(-1)) + 1e-6
        total = total + (-torch.log(cos)).mean()
    return total / max(len(count_stages), 1)


def iou_semantic_aware_loss(pred_masks, first_gt_mask, a_fea_list=None, v_map_list=None,
                            lambda_1: float = 0.0, count_stages=(),
                            sa_loss_flag: bool = False, frames_per_clip: int = 5):
    """AVS total loss (AVS/loss.py:86-111)."""
    f1 = f1_iou_bce_loss(pred_masks, first_gt_mask, frames_per_clip)
    total = f1
    sa = torch.zeros((), device=f1.device)
    if sa_loss_flag:
        sa = a_masked_v_simm_loss(pred_masks, a_fea_list, v_map_list, count_stages,
                                  frames_per_clip)
        total = total + lambda_1 * sa
    return total, {"iou_loss": f1, "sa_loss": sa}


def mask_iou(pred_logits, target, eps: float = 1e-7):
    """MIoU eval with empty-mask handling (AVS/loss.py:113-138).
    pred_logits/target: (N, H, W)."""
    pred_logits, target = pred_logits.float(), target.float()
    N = pred_logits.shape[0]
    num_pixels = pred_logits.shape[-1] * pred_logits.shape[-2]
    pred = (torch.sigmoid(pred_logits) > 0.5).int()
    t = target.int()
    no_obj = t.sum(dim=(1, 2)) == 0
    inter = (pred * t).sum(dim=(1, 2))
    union = torch.maximum(pred, t).sum(dim=(1, 2))
    inter_no_obj = ((1 - t) * (1 - pred)).sum(dim=(1, 2))
    inter = torch.where(no_obj, inter_no_obj, inter)
    union = torch.where(no_obj, torch.full_like(union, num_pixels), union)
    return (inter / (union + eps)).sum() / N
