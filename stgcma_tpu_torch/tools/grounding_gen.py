"""AVQA grounding / matching pretraining, the offline stage before AVQA
training (reference: AVQA/grounding_gen/{main_grd_gen.py, nets_grd_gen.py,
dataloader_grd_gen.py}).

Port of `stgcma_tpu/tools/grounding_gen.py`: VGGish audio features (B, T,
128) through fc_a1 / fc_a2; the frozen ResNet-18's layer4 features (stride-1
layer4: 14 x 14 at 224^2, `nn/resnet.py`); the normalized dot-product
grounding; the 4-layer match MLP; 2-way cross entropy on interleaved
positive / negative frame pairs. The trained head exports in the reference
checkpoint layout (`module.<fc>.weight` (out, in) / `.bias`), which
`cli/run_adapt_avqa.py --grounding_pretrained` splices into the AVQA head
(Swin_AVQAModel_V1.py:1520-1540); `splice_into_avqa` does the same between
models. `apply_grounding(..., return_attention=True)` and `--dump_heatmaps`
are the *_vis heat-map variant (main_grd_gen_vis.py). `main` trains with
torch's Adam and StepLR(8, 0.1), the optax Adam and per-epoch table of the
JAX trainer; it takes the JAX trainer's flags plus `--device` (default
"cuda"; "cpu" runs on the CPU).

Usage (synthetic smoke on the CPU):
    python -m stgcma_tpu_torch.tools.grounding_gen --synthetic True --device cpu \\
        --epochs 1 --batch-size 2 --synthetic_n 4 --model_save_dir /tmp/grd
"""
from __future__ import annotations

import math
import os
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..nn.resnet import ResNet18, resnet18_features, resnet18_init
from ..ops.common import Linear, linear, resolve_device
from ..train.losses import cross_entropy_int

HEAD_KEYS = ("fc_a1", "fc_a2", "fc_gl", "fc1", "fc2", "fc3", "fc4")
HEAD_SHAPES = {"fc_a1": (128, 512), "fc_a2": (512, 512), "fc_gl": (1024, 512),
               "fc1": (1024, 512), "fc2": (512, 256), "fc3": (256, 128), "fc4": (128, 2)}

# r(2+1)d-18 video-model normalization statistics (dataloader_grd_gen.py:21-22)
R2P1D_MEAN = np.array([0.43216, 0.394666, 0.37645], np.float32)
R2P1D_STD = np.array([0.22803, 0.22145, 0.216989], np.float32)


class GroundingModel(nn.Module):
    """The head's linears (`HEAD_KEYS`, (in, out) in `HEAD_SHAPES`) and the
    frozen `visual_net`, under the JAX tree's keys."""

    def __init__(self):
        super().__init__()
        for k in HEAD_KEYS:
            setattr(self, k, Linear(*HEAD_SHAPES[k]))
        self.visual_net = ResNet18()


def init_grounding(generator: torch.Generator = None, device="cuda") -> GroundingModel:
    """A GroundingModel with the JAX `init_grounding`'s distributions, drawn
    on the CPU from `generator` (seed 0 if none), then moved to `device`:
    each linear's weight and bias uniform(+-1/sqrt(in)) (torch's default),
    the ResNet as `resnet18_init`'s."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    model = GroundingModel()
    with torch.no_grad():
        for k in HEAD_KEYS:
            lin = getattr(model, k)
            bound = 1.0 / math.sqrt(lin.weight.shape[1])
            lin.weight.uniform_(-bound, bound, generator=g)
            lin.bias.uniform_(-bound, bound, generator=g)
    model.visual_net = resnet18_init(g, device="cpu")
    return model.to(device)


def _l2norm(x, dim):
    n = torch.linalg.vector_norm(x.float(), dim=dim, keepdim=True)
    return x / n.clamp_min(1e-12).to(x.dtype)


def apply_grounding(p: GroundingModel, audio, frames, return_attention: bool = False):
    """audio: (B, T, 128) VGGish; frames: (B, T, H, W, 3) normalized.
    Returns the match logits (B*T, 2) [, the grounding attention (B*T, HW)]."""
    B, T = audio.shape[0], audio.shape[1]
    af = linear(p.fc_a2, torch.relu(linear(p.fc_a1, audio))).reshape(B * T, -1)
    feat = resnet18_features(p.visual_net, frames.reshape(B * T, *frames.shape[2:]))
    v_before = feat.mean(dim=(1, 2))                                     # (BT, 512)
    v = _l2norm(feat.reshape(B * T, -1, feat.shape[-1]), 2)
    a_n = _l2norm(af[:, :, None], 1)
    x2_va = torch.matmul(v, a_n)[..., 0]
    x2_p = torch.softmax(x2_va.float(), dim=-1).to(v.dtype)
    grd = torch.matmul(x2_p[:, None], v)[:, 0]
    grd = linear(p.fc_gl, torch.tanh(torch.cat([v_before, grd], dim=-1)))
    out = torch.cat([af, grd], dim=-1)
    for fc in (p.fc1, p.fc2, p.fc3):
        out = torch.relu(linear(fc, out))
    out = linear(p.fc4, out)
    return (out, x2_p) if return_attention else out


def _pairs(p, audio, frames_pos, frames_neg):
    """The positive and negative logits interleaved: (2n, 2)."""
    out_pos = apply_grounding(p, audio, frames_pos)
    out_neg = apply_grounding(p, audio, frames_neg)
    return torch.stack([out_pos, out_neg], dim=1).reshape(2 * out_pos.shape[0], -1)


def grounding_loss(p: GroundingModel, audio, frames_pos, frames_neg):
    """Cross entropy on interleaved positive / negative pairs, labels 1, 0
    (main_grd_gen.py:27-50)."""
    out = _pairs(p, audio, frames_pos, frames_neg)
    labels = torch.tensor([1, 0], device=out.device).repeat(out.shape[0] // 2)
    return cross_entropy_int(out, labels)


def _jet_rgb(x: np.ndarray) -> np.ndarray:
    """The jet colormap (cv2.COLORMAP_JET's shape), RGB in [0, 1], of x in
    [0, 1]."""
    v = np.clip(x, 0.0, 1.0) * 4.0
    r = np.clip(np.minimum(v - 1.5, -v + 4.5), 0.0, 1.0)
    g = np.clip(np.minimum(v - 0.5, -v + 3.5), 0.0, 1.0)
    b = np.clip(np.minimum(v + 0.5, -v + 2.5), 0.0, 1.0)
    return np.stack([r, g, b], axis=-1)


def splice_into_avqa(avqa_model: nn.Module, grd: GroundingModel) -> nn.Module:
    """Copy the pretrained grounding head into the AVQA head in place (the
    reference's avqatask_* key remap, Swin_AVQAModel_V1.py:1520-1540): each
    of `HEAD_KEYS` that the AVQA head holds at the same shape (fc2, fc3, fc4
    at feat_dim 1536; fc_a2, fc_gl, fc1 are wider there). Returns the
    model."""
    hp = avqa_model.avqatask
    with torch.no_grad():
        for k in HEAD_KEYS:
            dst, src = getattr(hp, k, None), getattr(grd, k)
            if dst is not None and dst.weight.shape == src.weight.shape:
                dst.weight.copy_(src.weight)
                dst.bias.copy_(src.bias)
    return avqa_model


def export_torch_state_dict(model: GroundingModel, path: str):
    """The head in the reference checkpoint layout: `module.<fc>.weight`
    (out, in) and `.bias`, fp32 on the CPU, as main_grd_gen.py:224-227
    saves a DataParallel model; the frozen visual net is not exported."""
    sd = {}
    for k in HEAD_KEYS:
        lin = getattr(model, k)
        sd[f"module.{k}.weight"] = lin.weight.detach().float().cpu().clone()
        sd[f"module.{k}.bias"] = lin.bias.detach().float().cpu().clone()
    torch.save(sd, path)


def load_head(model: GroundingModel, path: str) -> GroundingModel:
    """An exported head (`export_torch_state_dict`) back into `model`."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    with torch.no_grad():
        for k in HEAD_KEYS:
            lin = getattr(model, k)
            lin.weight.copy_(sd[f"module.{k}.weight"])
            lin.bias.copy_(sd[f"module.{k}.bias"])
    return model


# ---------------------------------------------------------------------------
# datasets (dataloader_grd_gen.py:64-127)
# ---------------------------------------------------------------------------

class GroundingGenDataset:
    """Positive / negative frame pairs with each second's VGGish row.
    video_list: the unique video ids of the train json; 10 items a video
    (item idx: video idx // 10, frame idx % 10); the negative frame is drawn
    from another video by the dataset's RandomState(seed); audio: row flag of
    `audio_dir/<video>.npy` (10, 128); frames from `video_dir/<video>/`
    (sorted), resized to 224^2 (PIL bilinear), normalized with the
    r(2+1)d statistics."""

    def __init__(self, label_json: str, train_json: str, audio_dir: str, video_dir: str,
                 seed: int = 1):
        import json
        with open(train_json) as f:
            samples = json.load(f)
        self.video_list = list(dict.fromkeys(s["video_id"] for s in samples))
        self.audio_dir = audio_dir
        self.video_dir = video_dir
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return 10 * len(self.video_list)

    def _frame(self, video: str, flag: int) -> np.ndarray:
        from PIL import Image
        d = os.path.join(self.video_dir, video)
        files = sorted(os.listdir(d))
        with Image.open(os.path.join(d, files[flag])) as im:
            x = np.asarray(im.convert("RGB").resize((224, 224), Image.BILINEAR),
                           np.float32) / 255.0
        return (x - R2P1D_MEAN) / R2P1D_STD

    def __getitem__(self, idx: int):
        pos_video = self.video_list[idx // 10]
        flag = idx % 10
        while True:
            neg_idx = self.rng.randint(10 * len(self.video_list))
            if neg_idx // 10 != idx // 10:
                break
        audio = np.load(os.path.join(self.audio_dir, pos_video + ".npy")).astype(np.float32)
        return {"audio": audio[flag], "frame_pos": self._frame(pos_video, flag),
                "frame_neg": self._frame(self.video_list[neg_idx // 10], neg_idx % 10)}


class SyntheticGrounding:
    """Seeded random items (no data on disk) with the nine question types
    for the per-type test breakdown."""

    _TYPES = [["Audio", "Counting"], ["Audio", "Comparative"],
              ["Visual", "Counting"], ["Visual", "Location"],
              ["Audio-Visual", "Existential"], ["Audio-Visual", "Counting"],
              ["Audio-Visual", "Location"], ["Audio-Visual", "Comparative"],
              ["Audio-Visual", "Temporal"]]

    def __init__(self, n: int = 8, seed: int = 0, img: int = 224):
        self.n, self.seed, self.img = n, seed, img

    def __len__(self):
        return self.n

    def __getitem__(self, i: int):
        rng = np.random.RandomState(self.seed * 1000 + i)
        return {"audio": rng.randn(128).astype(np.float32),
                "frame_pos": rng.randn(self.img, self.img, 3).astype(np.float32),
                "frame_neg": rng.randn(self.img, self.img, 3).astype(np.float32),
                "qtype": self._TYPES[i % len(self._TYPES)]}


def _collate(items):
    return {k: [it[k] for it in items] if k == "qtype" else np.stack([it[k] for it in items])
            for k in items[0]}


def _batches(ds, batch_size, shuffle, rng):
    idx = np.arange(len(ds))
    if shuffle:
        rng.shuffle(idx)
    for i in range(0, len(idx), batch_size):
        yield _collate([ds[j] for j in idx[i:i + batch_size]])


# ---------------------------------------------------------------------------
# the trainer (main_grd_gen.py:27-237)
# ---------------------------------------------------------------------------

def parse_args(argv=None):
    import argparse

    def s2b(v):
        return str(v).lower() in ("1", "true", "yes")

    p = argparse.ArgumentParser(description="AVQA grounding-module pretraining "
                                            "(main_grd_gen.py flag surface)")
    p.add_argument("--audio_dir", type=str, default="./data/feats/vggish")
    p.add_argument("--video_dir", type=str, default="./data/frames")
    p.add_argument("--label_train", type=str, default="./data/json/avqa-train_real.json")
    p.add_argument("--label_val", type=str, default="./data/json/avqa-val_real.json")
    p.add_argument("--label_test", type=str, default="./data/json/avqa-test_real.json")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--mode", type=str, default="train", choices=["train", "val", "test"])
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--model_save_dir", type=str, default="./models_grounding_gen/")
    p.add_argument("--checkpoint", type=str, default="main_grounding_gen")
    p.add_argument("--synthetic", type=s2b, default=False,
                   help="train on deterministic random tensors (no data dirs)")
    p.add_argument("--synthetic_n", type=int, default=8)
    p.add_argument("--dump_heatmaps", type=str, default="",
                   help="in test mode, dump JET-overlay grounding heatmaps here "
                        "(main_grd_gen_vis.py equivalent)")
    p.add_argument("--resnet_pretrained", type=str, default="",
                   help="torchvision resnet18 .pth for the frozen visual net")
    # the port's one flag of its own: where the model runs
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Train (per-epoch and best exports of the head), or evaluate the best
    export (`--mode val`: pair accuracy; `test`: the per-type breakdown, and
    with `--dump_heatmaps` the heat-map overlays). Returns the model."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    np.random.seed(args.seed)
    model = init_grounding(torch.Generator().manual_seed(args.seed), device="cpu")
    if args.resnet_pretrained:
        from ..checkpoint.torch_convert import load_resnet18
        sd = torch.load(args.resnet_pretrained, map_location="cpu", weights_only=False)
        model.visual_net, _ = load_resnet18(model.visual_net, sd, device="cpu")
        print(f"loaded resnet18 weights from {args.resnet_pretrained}")
    model = model.to(device)
    # the visual net is frozen (main_grd_gen.py:205-209)
    model.visual_net.requires_grad_(False)

    if args.synthetic:
        tr_ds = SyntheticGrounding(args.synthetic_n, seed=0)
        va_ds = SyntheticGrounding(max(2, args.synthetic_n // 2), seed=7)
        te_ds = va_ds
    else:
        tr_ds, va_ds, te_ds = (GroundingGenDataset(label, args.label_train, args.audio_dir,
                                                   args.video_dir, args.seed)
                               for label in (args.label_train, args.label_val, args.label_test))

    def tensors(batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(device) for k, v in batch.items() if k != "qtype"}

    @torch.no_grad()
    def infer(batch):
        b = tensors(batch)
        return _pairs(model, b["audio"][:, None], b["frame_pos"][:, None],
                      b["frame_neg"][:, None]).argmax(dim=-1).cpu().numpy()

    def evaluate(ds):
        correct = total = 0
        for batch in _batches(ds, args.batch_size, False, np.random.RandomState(0)):
            pred = infer(batch)
            correct += int((pred == np.tile([1, 0], pred.shape[0] // 2)).sum())
            total += pred.shape[0]
        acc = 100.0 * correct / max(total, 1)
        print(f"Accuracy: {acc:.2f} %")
        return acc

    def test_types(ds):
        """The per-question-type breakdown (main_grd_gen.py:72-148), one item
        a batch, each item's type from the dataset."""
        from ..metrics.stats import avqa_type_accuracy
        preds, answers, qtypes = [], [], []
        for batch in _batches(ds, 1, False, np.random.RandomState(0)):
            preds.extend(infer(batch).tolist())
            answers.extend([1, 0])
            t = batch.get("qtype", [["", ""]])[0]
            qtypes.extend([t, t])
        res = avqa_type_accuracy(preds, answers, qtypes)
        for k, v in sorted(res.items()):
            print(f"{k} Accuracy: {v:.2f} %")
        return res.get("Overall", 0.0)

    os.makedirs(args.model_save_dir, exist_ok=True)

    def ckpt_path(tag):
        return os.path.join(args.model_save_dir, f"{args.checkpoint}{tag}.pt")

    if args.mode == "train":
        # Adam at torch's defaults and StepLR(step_size=8, gamma=0.1) over the
        # head (main_grd_gen.py:211-212)
        opt = torch.optim.Adam([getattr(model, k).weight for k in HEAD_KEYS]
                               + [getattr(model, k).bias for k in HEAD_KEYS], lr=args.lr)
        sched = torch.optim.lr_scheduler.StepLR(opt, step_size=8, gamma=0.1)
        best, rng = -1.0, np.random.RandomState(args.seed)
        model.step_losses = []
        for epoch in range(1, args.epochs + 1):
            for bi, batch in enumerate(_batches(tr_ds, args.batch_size, True, rng)):
                b = tensors(batch)
                opt.zero_grad()
                loss = grounding_loss(model, b["audio"][:, None], b["frame_pos"][:, None],
                                      b["frame_neg"][:, None])
                loss.backward()
                opt.step()
                model.step_losses.append(loss.item())
                if bi % args.log_interval == 0:
                    print(f"Train Epoch: {epoch} [{bi}]\tLoss: {model.step_losses[-1]:.6f}")
            sched.step()
            acc = evaluate(va_ds)
            export_torch_state_dict(model, ckpt_path(str(epoch)))
            if acc >= best:
                best = acc
                export_torch_state_dict(model, ckpt_path("_best"))
        print(f"done. best val acc {best:.2f} %")
        return model
    load_head(model, ckpt_path("_best"))
    if args.mode == "val":
        evaluate(va_ds)
    else:
        test_types(te_ds)
        if args.dump_heatmaps:
            dump_heatmaps(model, te_ds, args.dump_heatmaps, args.batch_size, tensors)
    return model


@torch.no_grad()
def dump_heatmaps(model: GroundingModel, ds, out_dir: str, batch_size: int, tensors):
    """main_grd_gen_vis.py:82-104: each positive frame's 14 x 14 grounding
    attention, scaled to its maximum, resized bilinearly to 224^2 (PIL),
    jet-coloured and laid over the denormalized frame (0.4 heat + 0.6
    frame), one PNG each."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    n_out = 0
    for batch in _batches(ds, batch_size, False, np.random.RandomState(0)):
        b = tensors(batch)
        _, att = apply_grounding(model, b["audio"][:, None], b["frame_pos"][:, None],
                                 return_attention=True)
        att = att.float().cpu().numpy()
        frames = np.asarray(batch["frame_pos"], np.float32)
        for i in range(att.shape[0]):
            amap = att[i].reshape(14, 14)
            amap = amap / max(float(amap.max()), 1e-12)
            img = Image.fromarray((amap * 255).astype(np.uint8))
            amap = np.asarray(img.resize((224, 224), Image.BILINEAR), np.float32) / 255.0
            fr = np.clip(frames[i] * R2P1D_STD + R2P1D_MEAN, 0.0, 1.0)
            if fr.shape[:2] != (224, 224):
                fr = np.asarray(Image.fromarray((fr * 255).astype(np.uint8)).resize(
                    (224, 224), Image.BILINEAR), np.float32) / 255.0
            over = np.clip(_jet_rgb(amap) * 0.4 + fr * 0.6, 0.0, 1.0)
            name = batch.get("name", [f"sample_{n_out}"] * att.shape[0])
            fname = f"{name[i] if i < len(name) else n_out}_{i}.png"
            Image.fromarray((over * 255).astype(np.uint8)).save(os.path.join(out_dir, fname))
            n_out += 1
    print(f"wrote {n_out} heatmap overlays to {out_dir}")


if __name__ == "__main__":
    main()
