"""Batched AV serving on one device, and the streaming path from raw media.

Port of `stgcma_tpu/serving.py`. `MultiTaskServer` (:49-121) with the AVE
tasks, Swin (`add_ave`) and CLIP (`add_clip_ave`), any ftmode, AVSBench
segmentation (`add_avs`) and MUSIC-AVQA (`add_avqa`): float parameters,
buffers and inputs are cast to the serving dtype (bf16 by default, the int8
tower's scales, the Swin bias tables and the BatchNorms' running statistics
included, as the JAX `cast_tree` does), integer inputs (AVQA's question) go
as they are, and the logits or mask logits come back as float32 numpy. Only
the inputs a task reads go to the card; inputs already there are used as
they are.

The streaming half (:125-347): `StreamRequest`, `HostDecoder` (native WAV
and jpg/png decode through `data/native_io.py`, scipy and PIL where the
native library is not built), `video_requests` (OpenCV) and `serve_stream`,
which overlaps host decode with the card's work and moves each micro-batch
to the card through pinned memory, uint8 frames and float32 waves, for the
device pipelines of `data/loader.py`. `share_frozen_tower` (:23) makes the
served models of several tasks share one frozen tower.

With a `mesh` (`runtime/mesh.py`, JAX :62-74 and :109-122) every rank is
given the whole batch, runs its rows over 'data' and all-gathers the
outputs over 'data', so every rank returns the whole batch; a batch whose
leading dim does not divide the 'data' extent raises (`serve_stream` pads
its tail batch to `batch_size`, which makes a streamed batch divide it).
The served models are replicated from the mesh's first rank, or with
`shard_tower` stored split over 'model' (`shard_params`: each split leaf
all-gathered right before the module that reads it).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .configs import AVQAHeadConfig, AVSHeadConfig, ClipConfig, SwinConfig
from .models.ave import ClipAVE, SwinAVE, apply_clip_ave, apply_swin_ave
from .models.avqa import AVQAModel, answer_avqa
from .models.avs import AVSModel, apply_avs
from .ops.common import cast_tree, resolve_device
from .runtime import mesh as M
from .runtime.profiling import annotate
from .train.optim import label


def share_frozen_tower(canonical: nn.Module, others: Dict[str, nn.Module]
                       ) -> Dict[str, nn.Module]:
    """In place: every 'frozen' tower parameter or buffer (`train/optim.py::
    label`) of each model in `others` whose name, shape, dtype and device
    match the canonical model's becomes the canonical's tensor, so one tower
    is resident for all of them. Adapters, gates, temporal tables, heads and
    BatchNorm statistics stay each model's own, as do the leaves of an int8
    tower that a float one does not hold (and the other way round). Apply it
    to the models a server serves (`MultiTaskServer.models`): `add_*` keeps
    a cast copy, so sharing done before is lost. Returns `others`."""
    canon = dict(canonical.backbone.named_parameters())
    canon.update(canonical.backbone.named_buffers())
    for model in others.values():
        for mod_name, mod in model.backbone.named_modules():
            for slots in (mod._parameters, mod._buffers):
                for leaf, t in slots.items():
                    name = f"{mod_name}.{leaf}" if mod_name else leaf
                    c = canon.get(name)
                    if (t is not None and c is not None and label(f"backbone.{name}") == "frozen"
                            and (c.shape, c.dtype, c.device) == (t.shape, t.dtype, t.device)):
                        slots[leaf] = c
    return others


class MultiTaskServer:
    """Dispatches batched inference by task name."""

    def __init__(self, dtype=torch.bfloat16, device="cuda", mesh=None, shard_tower=False):
        self.dtype = dtype
        self.device = resolve_device(device)
        self.mesh = mesh
        self.shard_tower = shard_tower
        self._fns: Dict[str, Callable] = {}
        self._reads: Dict[str, Tuple[str, ...]] = {}    # the inputs each task copies
        self.models: Dict[str, torch.nn.Module] = {}    # the cast copy each task serves

    def add_ave(self, name: str, cfg: SwinConfig, model: SwinAVE):
        """Serve a Swin AVE `model` of any ftmode, float or with an int8 tower
        (left as it is: the server keeps a cast copy). A `videoonly` task's
        batches need no "a", an `audioonly` task's no "v"."""
        m = self.models[name] = self._place(model)
        self._fns[name] = lambda batch: apply_swin_ave(m, cfg, batch.get("a"), batch.get("v"))
        self._reads[name] = ("a", "v")

    def add_avs(self, name: str, cfg: SwinConfig, hcfg: AVSHeadConfig, model: AVSModel):
        """Serve an AVS `model` (left as it is: the server keeps a cast copy):
        a request {"a", "v"} -> the mask logits `pred` (B*T, H, W, 1)."""
        m = self.models[name] = self._place(model)
        self._fns[name] = lambda batch: apply_avs(m, cfg, hcfg, batch["a"], batch["v"])[0]
        self._reads[name] = ("a", "v")

    def add_clip_ave(self, name: str, cfg: ClipConfig, model: ClipAVE):
        """Serve a CLIP AVE `model` of any ftmode, float or with an int8 tower
        (left as it is: the server keeps a cast copy). A `videoonly` task's
        batches need no "a", an `audioonly` task's no "v"."""
        m = self.models[name] = self._place(model)
        self._fns[name] = lambda batch: apply_clip_ave(m, cfg, batch.get("a"), batch.get("v"))
        self._reads[name] = ("a", "v")

    def add_avqa(self, name: str, cfg: SwinConfig, hcfg: AVQAHeadConfig, model: AVQAModel):
        """Serve an AVQA `model` (left as it is: the server keeps a cast
        copy): a request {"a", "v", "v_nega", "question"} -> out_qa (B,
        answer_dim), through `answer_avqa`, as the JAX server's compiled
        `apply_avqa(...)[0]`. out_qa does not read v_nega, so v_nega stays
        on the host."""
        m = self.models[name] = self._place(model)
        self._fns[name] = lambda batch: answer_avqa(m, cfg, hcfg, batch["a"], batch["v"],
                                                    batch["question"])
        self._reads[name] = ("a", "v", "question")

    def _place(self, model: nn.Module) -> nn.Module:
        """The served copy: cast to the serving dtype, on the server's
        device, and under a mesh replicated or split (`shard_tower`)."""
        m = cast_tree(model, self.dtype).to(self.device).eval()
        if self.mesh is None:
            return m
        M.replicate(m, self.mesh)
        return M.shard_params(m, self.mesh) if self.shard_tower else m

    def tasks(self):
        return sorted(self._fns)

    @torch.inference_mode()
    def predict(self, task: str, batch: Dict[str, object]) -> np.ndarray:
        """batch: numpy arrays or tensors (on any device: those on the
        server's are used as they are); float inputs are cast to the serving
        dtype on the server's device. Under a mesh each rank gives the whole
        batch and gets the whole output. Spans: `serve.request` ⊃
        {`serve.copy_in`, `serve.forward`, `serve.copy_out`}."""
        with annotate("serve.request"):
            rows = None
            if self.mesh is not None:
                rows = M.batch_sharding(self.mesh)
                for k, v in batch.items():
                    if v.shape[0] % rows.count:
                        raise ValueError(
                            f"batch['{k}'] leading dim {v.shape[0]} does not divide the mesh's "
                            f"data extent {rows.count}; pad the request micro-batch to a "
                            "multiple (serve_stream does)")
            dev = {}
            with annotate("serve.copy_in"):
                for k, v in batch.items():
                    if k not in self._reads[task]:
                        continue
                    if rows is not None:
                        v = v[rows.rows(v.shape[0] // rows.count)]
                    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
                    t = t.to(self.device)
                    dev[k] = t.to(self.dtype) if t.is_floating_point() else t
            with annotate("serve.forward"):
                out = self._fns[task](dev)
            with annotate("serve.copy_out"):
                out = out.float()
                if rows is not None:
                    parts = [torch.empty_like(out) for _ in range(rows.count)]
                    torch.distributed.all_gather(parts, out.contiguous(), group=rows.group)
                    out = torch.cat(parts)
                return out.cpu().numpy()


# ---------------------------------------------------------------------------
# streaming decode serving (BASELINE.json configs[4]): WAV files and frames
# -> host decode -> the device pipelines (fbank + transforms on the card) ->
# MultiTaskServer.predict, with host decode overlapping the card's work
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StreamRequest:
    """One request: a clip's audio file and its frames, in ONE of two forms:
    `frames` (T, H, W, 3) uint8, already decoded; or `frame_paths`, T
    jpg/png files that HostDecoder decodes at its staging geometry (bit for
    bit as PIL where a file has that size; the device pipeline still makes
    the protocol's resize and crop). extras: per-task arrays merged into the
    batch (AVQA's 'question' ids)."""
    task: str
    wav_path: str
    frames: Optional[np.ndarray] = None
    extras: Optional[Dict[str, np.ndarray]] = None
    rid: int = 0
    frame_paths: Optional[Sequence[str]] = None


class HostDecoder:
    """The host stage: WAV files -> (B, num_segments, seg_samples) float32
    segments (native, multithreaded; scipy where the native library is not
    built) and the requests' frames stacked (B, T, H, W, 3) uint8. `native`
    says which WAV decoder runs."""

    def __init__(self, num_segments: int = 10, seg_samples: int = 16000,
                 num_threads: int = 8, frame_hw: Tuple[int, int] = (256, 256)):
        from .data import native_io
        self.num_segments = num_segments
        self.seg_samples = seg_samples
        self.num_threads = num_threads
        self.frame_hw = frame_hw        # staging geometry of frame_paths
        self.native = native_io.available()

    def _decode_python(self, paths: Sequence[str]) -> np.ndarray:
        from .data.datasets import load_wav
        from .ops.fbank import segment_starts
        out = np.zeros((len(paths), self.num_segments, self.seg_samples), np.float32)
        for i, p in enumerate(paths):
            try:
                wav, sr = load_wav(p)       # (C, L)
            except Exception:
                continue                    # an unreadable file decodes to silence
            wav = wav.mean(axis=0)          # mono downmix
            starts = segment_starts(len(wav), self.seg_samples, self.num_segments,
                                    sample_rate=sr)
            for s, st in enumerate(starts):
                seg = wav[st:st + self.seg_samples]
                out[i, s, :len(seg)] = seg
        return out

    def _decode_frames(self, reqs: Sequence[StreamRequest]) -> np.ndarray:
        """Pre-decoded frames pass through; frame_paths decode natively (PIL
        where the native image decoder is not built) at frame_hw."""
        from .data import native_io
        H, W = self.frame_hw
        path_reqs = [r for r in reqs if r.frame_paths is not None]
        decoded: Dict[int, np.ndarray] = {}
        if path_reqs:
            flat = [p for r in path_reqs for p in r.frame_paths]
            if native_io.image_available():
                imgs, _ok = native_io.decode_image_batch(flat, H, W,
                                                         num_threads=self.num_threads)
            else:
                from PIL import Image
                imgs = np.zeros((len(flat), H, W, 3), np.uint8)
                for i, p in enumerate(flat):
                    with Image.open(p) as im:
                        imgs[i] = np.asarray(im.convert("RGB").resize((W, H), Image.BILINEAR),
                                             np.uint8)
            ofs = 0
            for r in path_reqs:
                decoded[id(r)] = imgs[ofs:ofs + len(r.frame_paths)]
                ofs += len(r.frame_paths)
        out = []
        for r in reqs:
            if r.frame_paths is not None:
                out.append(decoded[id(r)])
            elif r.frames is not None:
                out.append(r.frames)
            else:
                raise ValueError(f"request rid={r.rid}: neither frames nor frame_paths set")
        return np.stack(out)

    def __call__(self, reqs: Sequence[StreamRequest]) -> Dict[str, np.ndarray]:
        paths = [r.wav_path for r in reqs]
        if self.native:
            from .data import native_io
            wave, _ok = native_io.decode_wav_batch(paths, self.num_segments, self.seg_samples,
                                                   num_threads=self.num_threads)
        else:
            wave = self._decode_python(paths)
        batch = {"wave": wave, "frames": self._decode_frames(reqs)}
        extras = [r.extras for r in reqs if r.extras]
        if extras:
            if len(extras) != len(reqs) or any(set(e) != set(extras[0]) for e in extras[1:]):
                raise ValueError(
                    "heterogeneous extras within a micro-batch: every request must carry "
                    "the same extra tensors (e.g. AVQA question ids) or none")
            for k in extras[0]:
                batch[k] = np.stack([r.extras[k] for r in reqs])
        return batch


def video_requests(task: str, items, num_frames: int = 10,
                   frame_hw: Tuple[int, int] = (256, 256), start_rid: int = 0):
    """StreamRequests from video containers (mp4 / avi / mkv, OpenCV's
    FFMPEG backend), decoded on the host. items: (video_path, wav_path) or
    (video_path, wav_path, extras). One frame a second at the half-second
    mark, clamped to the last frame, staged at frame_hw in RGB, as the
    offline frame extraction samples them."""
    import cv2

    for i, item in enumerate(items):
        video_path, wav_path = item[0], item[1]
        extras = item[2] if len(item) > 2 else None
        cap = cv2.VideoCapture(video_path)
        if not cap.isOpened():
            raise ValueError(f"cannot open video container: {video_path}")
        fps = cap.get(cv2.CAP_PROP_FPS) or 16.0
        raw = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            raw.append(f)
        cap.release()
        if not raw:
            raise ValueError(f"no frames decoded from {video_path}")
        H, W = frame_hw
        frames = np.empty((num_frames, H, W, 3), np.uint8)
        for s in range(num_frames):
            idx = min(int(round((s + 0.5) * fps)), len(raw) - 1)
            frames[s] = cv2.resize(raw[idx], (W, H), interpolation=cv2.INTER_LINEAR)[:, :, ::-1]
        yield StreamRequest(task=task, wav_path=wav_path, frames=frames, extras=extras,
                            rid=start_rid + i)


def serve_stream(server: MultiTaskServer, pipelines: Dict[str, Callable],
                 requests: Iterable[StreamRequest], batch_size: int = 8,
                 decoder: Optional[HostDecoder] = None, decode_depth: int = 2,
                 device="cuda", stats: Optional[list] = None
                 ) -> Iterable[Tuple[List[int], np.ndarray]]:
    """Stream requests through host decode -> the device pipeline -> the
    model. Yields (request ids, outputs) a micro-batch.

    Requests are grouped per task in arrival order, `batch_size` a
    micro-batch; each task's last, partial batch is padded by repeating its
    last row, and the padding rows are dropped from its output (whose
    leading axis holds `rows_per_req` rows a request: B*T for AVE).
    `decode_depth` batches decode on a thread pool while the card works on
    an earlier one. A decoded batch is padded and pinned in the decode
    thread, a fresh pinned buffer a batch, and copied to `device` (the
    server's; the card unless the caller asks for the CPU) with
    non_blocking=True. pipelines: task -> fn(batch of tensors on the device)
    -> the model's batch ({'a', 'v', ...}), e.g. around
    `data/loader.py::make_ave_device_pipeline`. stats: a list to which one
    {"task", "n", "decode_ms", "stage_ms", "h2d_bytes"} is appended a
    micro-batch: the host ms of the decoder, then of padding and pinning."""
    device = resolve_device(device)
    if server.device != device:
        raise ValueError(f"the server runs on {server.device}, not on {device}")
    decoder = decoder or HostDecoder()
    pin = device.type == "cuda"
    ex = ThreadPoolExecutor(max_workers=decode_depth)

    def micro_batches():
        groups: Dict[str, List[StreamRequest]] = {}
        for r in requests:
            groups.setdefault(r.task, []).append(r)
            if len(groups[r.task]) == batch_size:
                yield groups.pop(r.task)
        for task in sorted(groups):
            yield groups[task]

    def decode(mb):
        t0 = time.perf_counter()
        host = decoder(mb)
        t1 = time.perf_counter()
        pad = batch_size - len(mb)
        if pad > 0:                     # the tail batch at the served shape
            host = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                    for k, v in host.items()}
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host.items()}
        if pin:
            host = {k: v.pin_memory() for k, v in host.items()}
        return host, ((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3)

    def run(mb, fut):
        host, (decode_ms, stage_ms) = fut.result()
        n = len(mb)
        batch = {k: v.to(device, non_blocking=True) for k, v in host.items()}
        if stats is not None:
            stats.append({"task": mb[0].task, "n": n, "decode_ms": decode_ms, "stage_ms": stage_ms,
                          "h2d_bytes": sum(v.numel() * v.element_size() for v in host.values())})
        out = server.predict(mb[0].task, pipelines[mb[0].task](batch))
        rows = len(host["frames"])
        if out.shape[0] % rows != 0:
            raise ValueError(f"model output leading dim {out.shape[0]} is not a multiple of "
                             f"the padded batch {rows}; cannot slice per-request results")
        rows_per_req = out.shape[0] // rows
        return [r.rid for r in mb], out[:n * rows_per_req]

    pending: deque = deque()
    try:
        for mb in micro_batches():
            pending.append((mb, ex.submit(decode, mb)))
            if len(pending) > decode_depth:
                yield run(*pending.popleft())
        while pending:
            yield run(*pending.popleft())
    finally:
        ex.shutdown(wait=False)
