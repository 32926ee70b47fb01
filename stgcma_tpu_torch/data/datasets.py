"""Host-side datasets and decode helpers: datasets yield raw numpy items
(uint8 frames, float32 waveforms, labels); `data/loader.py` batches them and
finishes them on the device.

Port of `stgcma_tpu/data/datasets.py`: `load_wav` (:33, the scipy decoder
behind `serving.HostDecoder`'s Python path), `load_image` (:51),
`load_mask` (:68), `_select_frames` (:79), `_segment_waveform` (:91),
`AVEDataset` (:107), `build_avqa_vocab` (:170), `encode_question` (:196),
`AVQADataset` (:213), `AVSDataset` (:263) and `SyntheticAVE` (:338).
`load_image` decodes with PIL, which the JAX package's native decoder
matches bit for bit. `h5py` is imported by `AVEDataset` alone. A question's
`templ_values` string is read by `ast.literal_eval` where the JAX package
calls `eval`: the same list for the reference's "['dog', 'piano']" strings,
and no code runs.

AVE layout (AVE/dataloader.py:73-525): train/test_order.h5 'order',
labels.h5 'avadataset' one-hot [N, 10, 29], Annotations.txt '&'-separated
rows, frame directories of jpgs, 10 x 1 s wav segments. AVQA layout
(AVQA/dataloader.py:36-263): avqa-{train,test}.json, the 93-word question
vocabulary and 42 answers built from the train json, 10 frames and 10
negative frames of another video, 10 x 1.95 s wav segments, questions
padded to 14 words. AVS layout
(AVS/dataloader.py:40-193): s4_meta_data.csv splits (MS3's csv has no
category column), 5 png frames, 1 (train) / 5 (test) gt masks, 5 x 1.95 s
wav segments, optional VGGish log-mel pkls.
"""
from __future__ import annotations

import ast
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.fbank import segment_starts


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """A wav as float32 in [-1, 1], (channels, samples) as torchaudio.load
    returns it, and its sample rate."""
    from scipy.io import wavfile
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    data = data.T if data.ndim == 2 else data[None]
    return data, sr


def load_image(path: str) -> np.ndarray:
    """jpg/png -> (H, W, 3) uint8."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def load_mask(path: str, size: int = 224) -> np.ndarray:
    """An AVS ground-truth mask png (PIL mode '1') -> (size, size) float32 in
    {0, 1}, resized by nearest neighbour."""
    from PIL import Image
    with Image.open(path) as im:
        im = im.convert("1").resize((size, size), Image.NEAREST)
        return np.asarray(im, np.float32)


def _select_frames(frame_dir: str, num: int) -> List[str]:
    """linspace over all jpg/png frames (AVE/dataloader.py:292-302)."""
    files = sorted(f for f in os.listdir(frame_dir)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))
    if not files:
        raise FileNotFoundError(f"no frames in {frame_dir}")
    idx = np.linspace(0, len(files) - 1, num=num).astype(int)
    return [os.path.join(frame_dir, files[i]) for i in idx]


def _segment_waveform(wav: np.ndarray, sr: int, num_segments: int,
                      seg_seconds: float) -> np.ndarray:
    """(L,) -> (num_segments, seg_samples), zero-padded; linspace starts when the
    clip is long enough (AVE/dataloader.py:229-236)."""
    seg = int(sr * seg_seconds)
    L = wav.shape[-1]
    if L > sr * (seg_seconds + 0.1):
        starts = segment_starts(L, seg, num_segments, sample_rate=sr)
    else:
        starts = np.zeros(num_segments, np.int64)
    out = np.zeros((num_segments, seg), np.float32)
    for i, s in enumerate(starts):
        chunk = wav[s: s + seg]
        out[i, : len(chunk)] = chunk
    return out


class AVEDataset:
    """Items: frames (10, H, W, 3) uint8, wave (10, 16000) f32, labels (10,
    29) one-hot f32."""

    def __init__(self, order_h5: str, labels_h5: str, frames_root: str,
                 audio_root: str, num_frames: int = 10, mode: str = "eval",
                 annotations_txt: str = ""):
        import h5py
        with h5py.File(order_h5, "r") as f:
            self.order = np.asarray(f["order"])
        with h5py.File(labels_h5, "r") as f:
            self.labels = np.asarray(f["avadataset"], np.float32)
        # Annotations.txt: '&'-separated rows, column 1 = video file name;
        # order entries index into it (AVE/dataloader.py:129 raw_gt +
        # :489 file_name = raw_gt.iloc[real_idx][1], read with header=None so
        # any header line counts as row 0, exactly like the reference).
        self.file_names: Optional[List[str]] = None
        if annotations_txt:
            with open(annotations_txt) as f:
                self.file_names = [ln.rstrip("\n").split("&")[1] for ln in f if ln.strip()]
        self.frames_root = frames_root
        self.audio_root = audio_root
        self.num_frames = num_frames
        self.mode = mode

    def __len__(self):
        return len(self.order)

    def video_ids(self) -> List[str]:
        return [str(i) for i in self.order]

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        vid = self.order[i]
        if self.file_names is not None:
            vid_s = self.file_names[int(vid)]
        else:
            vid_s = vid.decode() if isinstance(vid, bytes) else str(vid)
        # corrupted-sample fallbacks mirror the reference's 0.01-filled
        # substitutes + warning (AVE/dataloader.py:246-248,311-316,501-505)
        try:
            paths = _select_frames(os.path.join(self.frames_root, vid_s), self.num_frames)
            frames = np.stack([load_image(p) for p in paths])
        except (OSError, ValueError) as e:
            print(f"there is a frame loading error for {vid_s}: {e}")
            frames = np.zeros((self.num_frames, 224, 224, 3), np.uint8)
        try:
            wav, sr = load_wav(os.path.join(self.audio_root, vid_s + ".wav"))
            wav = wav.mean(axis=0)
            wav = wav - wav.mean()
            segs = _segment_waveform(wav, sr, self.num_frames, 1.0)
        except (OSError, ValueError) as e:
            print(f"there is an audio loading error for {vid_s}: {e}")
            segs = np.full((self.num_frames, 16000), 0.01, np.float32)
        return {"frames": frames, "wave": segs,
                "labels": self.labels[vid] if np.issubdtype(type(vid), np.integer)
                else self.labels[i]}


def _templ_list(templ_values):
    """A question's template values: the json's string literal, or a list."""
    return list(ast.literal_eval(templ_values)) if isinstance(templ_values, str) \
        else templ_values


def _question_words(question_content: str, templ_values) -> List[str]:
    """The question's words, the trailing '?' stripped, each '<...>'
    placeholder replaced by the next template value (AVQA/dataloader.py:51-76)."""
    question = question_content.rstrip().split(" ")
    question[-1] = question[-1][:-1]
    templ = _templ_list(templ_values)
    p = 0
    for pos in range(len(question)):
        if "<" in question[pos]:
            question[pos] = templ[p]
            p += 1
    return question


def build_avqa_vocab(train_json: str) -> Tuple[Dict[str, int], Dict[str, int]]:
    """Question-word and answer vocabularies scanned from the train json, in
    first-seen order, "<pad>" at 0 (AVQA/dataloader.py:51-76)."""
    with open(train_json) as f:
        samples = json.load(f)
    ques_vocab, ans_vocab = ["<pad>"], []
    for s in samples:
        for w in _question_words(s["question_content"], s["templ_values"]):
            if w not in ques_vocab:
                ques_vocab.append(w)
        if s["anser"] not in ans_vocab:
            ans_vocab.append(s["anser"])
    return ({w: i for i, w in enumerate(ques_vocab)},
            {a: i for i, a in enumerate(ans_vocab)})


def encode_question(question_content: str, templ_values, word2idx: Dict[str, int],
                    max_len: int = 14) -> np.ndarray:
    """The question's word ids (unknown words 0), padded with "<pad>" or cut
    to `max_len`: (max_len,) int32."""
    question = _question_words(question_content, templ_values)
    if len(question) < max_len:
        question += ["<pad>"] * (max_len - len(question))
    return np.asarray([word2idx.get(w, 0) for w in question[:max_len]], np.int32)


class AVQADataset:
    """Items: frames / frames_nega (T, H, W, 3) uint8, wave (T, 1.95 s of
    samples) f32, question (14,) int32, answer () int32, qtype (the json's
    'type' as it is). The negative frames are another video's, drawn from
    the dataset's own RandomState(seed) (AVQA/dataloader.py:214-231), so a
    loader's worker threads draw them in the order they ask for items. A
    json of one video has no negative to draw: an item raises, where the
    JAX package's draw loops forever."""

    def __init__(self, samples_json: str, train_json: str, frames_root: str,
                 audio_root: str, num_frames: int = 10, mode: str = "train",
                 seed: int = 0):
        with open(samples_json) as f:
            self.samples = json.load(f)
        self.word2idx, self.ans2idx = build_avqa_vocab(train_json)
        self.frames_root = frames_root
        self.audio_root = audio_root
        self.num_frames = num_frames
        self.mode = mode
        self.rng = np.random.RandomState(seed)
        self.n_videos = len({s["video_id"] for s in self.samples})

    def __len__(self):
        return len(self.samples)

    def _frames(self, vid: str) -> np.ndarray:
        return np.stack([load_image(p) for p in
                         _select_frames(os.path.join(self.frames_root, vid), self.num_frames)])

    def __getitem__(self, i: int):
        s = self.samples[i]
        vid = s["video_id"]
        frames = self._frames(vid)
        if self.n_videos < 2:
            raise ValueError(f"{self.n_videos} video in the json: no other video to draw the "
                             "negative frames from")
        while True:
            j = self.rng.randint(len(self.samples))
            if self.samples[j]["video_id"] != vid:
                break
        frames_nega = self._frames(self.samples[j]["video_id"])
        wav, sr = load_wav(os.path.join(self.audio_root, vid + ".wav"))
        wav = wav.mean(axis=0)
        wav = wav - wav.mean()
        return {"frames": frames, "frames_nega": frames_nega,
                "wave": _segment_waveform(wav, sr, self.num_frames, 1.95),
                "question": encode_question(s["question_content"], s["templ_values"],
                                            self.word2idx),
                "answer": np.int32(self.ans2idx.get(s["anser"], 0)),
                "qtype": s.get("type", ["", ""])}


class AVSDataset:
    """Items: frames (T, H, W, 3) uint8, wave (T, 1.95 s of samples) f32,
    masks (k, 224, 224) f32 with k = 1 (train) or T (test); with the VGGish
    log-mel pkls, `audio_log_mel` too (the reference S4Dataset returns them
    with every item; the Swin trainer does not read them). `dir_image`,
    `dir_mask` and `dir_audio_wav` override data_root's visual_frames /
    gt_masks / audio_wav (AVS/run_adapt_avs.py:89-92). Whether the pkls are
    loaded is decided once here (None: the directory exists), so that a
    partly filled tree raises on its missing item rather than making
    batches of two schemas."""

    def __init__(self, meta_csv: str, data_root: str, split: str = "train",
                 num_frames: int = 5, dir_image: str = "", dir_mask: str = "",
                 dir_audio_wav: str = "", dir_audio_log_mel: str = "",
                 load_audio_log_mel: Optional[bool] = None):
        import csv
        with open(meta_csv) as f:
            self.rows = [row for row in csv.DictReader(f) if row.get("split") == split]
        self.dir_image = dir_image or os.path.join(data_root, "visual_frames")
        self.dir_mask = dir_mask or os.path.join(data_root, "gt_masks")
        self.dir_audio_wav = dir_audio_wav or os.path.join(data_root, "audio_wav")
        self.dir_audio_log_mel = dir_audio_log_mel or os.path.join(data_root, "audio_log_mel")
        if load_audio_log_mel is None:
            load_audio_log_mel = os.path.isdir(self.dir_audio_log_mel)
        self.load_audio_log_mel = load_audio_log_mel
        self.split = split
        self.num_frames = num_frames

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        row = self.rows[i]
        name, category = row["name"], row.get("category", "")
        base = os.path.join(self.dir_image, self.split, category, name)
        frames = np.stack([load_image(os.path.join(base, f"{name}_{k + 1}.png"))
                           for k in range(self.num_frames)])
        mask_base = os.path.join(self.dir_mask, self.split, category, name)
        n_masks = 1 if self.split == "train" else self.num_frames
        masks = np.stack([load_mask(os.path.join(mask_base, f"{name}_{k + 1}.png"))
                          for k in range(n_masks)])
        wav, sr = load_wav(os.path.join(self.dir_audio_wav, self.split, category,
                                        name + ".wav"))
        wav = wav.mean(axis=0)
        wav = wav - wav.mean()
        item = {"frames": frames, "wave": _segment_waveform(wav, sr, self.num_frames, 1.95),
                "masks": masks}
        if self.load_audio_log_mel:
            import pickle
            path = os.path.join(self.dir_audio_log_mel, self.split, category, name + ".pkl")
            with open(path, "rb") as f:      # a missing pkl raises, as the reference's
                lm = pickle.load(f)
            if hasattr(lm, "detach"):        # a torch tensor pkl (the reference's layout)
                lm = lm.detach().cpu().numpy()
            item["audio_log_mel"] = np.asarray(lm, np.float32)
        return item


class SyntheticAVE:
    """Seeded random AVE items (tests and runs without the corpus): uint8
    frames (T, size, size, 3), wave (T, 16000) ~ N(0, 0.1), one-hot labels."""

    def __init__(self, n=32, num_frames=10, size=256, label_dim=29, seed=0):
        self.n, self.T, self.size, self.C = n, num_frames, size, label_dim
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed + i)
        frames = rng.randint(0, 256, (self.T, self.size, self.size, 3), np.uint8)
        wave = (rng.randn(self.T, 16000) * 0.1).astype(np.float32)
        labels = np.zeros((self.T, self.C), np.float32)
        labels[np.arange(self.T), rng.randint(0, self.C, self.T)] = 1.0
        return {"frames": frames, "wave": wave, "labels": labels}
