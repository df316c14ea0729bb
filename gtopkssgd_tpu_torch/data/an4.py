"""AN4 speech pipeline, the port's copy of ``gtopkssgd_tpu/data/an4.py``:
bit for bit the JAX pipeline's batches, without importing the JAX package.

Real path: a manifest CSV of ``wav_path,transcript_path`` lines (paths
relative to the manifest's folder, or absolute), ``an4_train_manifest.csv``
or ``an4_val_manifest.csv`` under ``data_dir``; each wav becomes a
log-STFT spectrogram (20 ms window, 10 ms hop, 161 bins at 16 kHz, scipy)
and each transcript ids over the 29 characters of ``LABELS``. Without a
manifest: synthetic utterances whose spectrogram carries a per-character
signature, shared by train and test (``signal_rng``), so CTC has signal.

Every batch is padded to one fixed ``(max_frames, max_label_len)`` shape;
longer utterances or transcripts are cut, counted in ``truncated_count``,
with one warning on the first.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from gtopkssgd_tpu_torch.data.partition import (
    DataPartitioner,
    signal_rng,
    split_id,
)

# Blank at 0, then apostrophe, A-Z, space: the deepspeech English labels.
LABELS = "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ "
CHAR_TO_ID = {c: i for i, c in enumerate(LABELS)}
SPACE_ID = CHAR_TO_ID[" "]
N_BINS = 161
SYNTH_TRAIN, SYNTH_TEST = 256, 64


def text_to_ids(text: str) -> np.ndarray:
    return np.asarray(
        [CHAR_TO_ID[c] for c in text.upper() if c in CHAR_TO_ID], np.int32)


def wav_to_logspec(path: str) -> np.ndarray:
    """log(1 + |STFT|) of a wav file, f32[frames, 161]."""
    import scipy.io.wavfile as wavfile
    import scipy.signal as sig

    sr, audio = wavfile.read(path)
    audio = audio.astype(np.float32) / 32768.0
    nperseg = int(0.02 * sr)
    noverlap = nperseg - int(0.01 * sr)
    _, _, spec = sig.stft(audio, sr, nperseg=nperseg, noverlap=noverlap,
                          nfft=320)
    return np.log1p(np.abs(spec.T)).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _synth_utterances(split: str, seed: int, num_chars: int) -> List[Dict]:
    """Synthetic utterances of a split, made from (seed, split); cached."""
    rng = np.random.default_rng(np.random.SeedSequence([seed,
                                                        split_id(split)]))
    n = SYNTH_TRAIN if split == "train" else SYNTH_TEST
    signatures = signal_rng(seed).standard_normal(
        (num_chars, N_BINS)).astype(np.float32)
    utts: List[Dict] = []
    for _ in range(n):
        length = int(rng.integers(4, 12))
        labels = rng.integers(1, num_chars, length).astype(np.int32)
        frames_per = int(rng.integers(6, 12))
        spec = 0.1 * rng.standard_normal(
            (length * frames_per, N_BINS)).astype(np.float32)
        for j, ch in enumerate(labels):
            spec[j * frames_per:(j + 1) * frames_per] += 0.5 * signatures[ch]
        utts.append({"spec": spec, "labels": labels})
    return utts


class AN4Dataset:
    num_chars = len(LABELS)

    def __init__(self, *, split="train", batch_size=8, rank=0, nworkers=1,
                 data_dir=None, seed=0, max_frames=400, max_label_len=64):
        self.split = split
        self.batch_size = batch_size
        self.max_frames = max_frames
        self.max_label_len = max_label_len
        manifest = os.path.join(
            data_dir or "",
            f"an4_{'train' if split == 'train' else 'val'}_manifest.csv")
        self.synthetic = not os.path.isfile(manifest)
        if self.synthetic:
            self._utts = _synth_utterances(split, seed, self.num_chars)
            count = len(self._utts)
        else:
            mdir = os.path.dirname(os.path.abspath(manifest))
            with open(manifest) as f:
                self._manifest = [
                    [p if os.path.isabs(p) else os.path.join(mdir, p)
                     for p in line.strip().split(",")]
                    for line in f if line.strip()]
            self._utts = None
            count = len(self._manifest)
        self.partitioner = DataPartitioner(count, rank, nworkers, seed)
        if len(self.partitioner) < batch_size:
            raise ValueError(
                f"rank shard has {len(self.partitioner)} utterances < "
                f"batch_size {batch_size} — lower batch_size or nworkers")
        self.truncated_count = 0
        self._warned_truncation = False

    def steps_per_epoch(self) -> int:
        return len(self.partitioner) // self.batch_size

    def _load(self, i: int) -> Dict:
        if self.synthetic:
            return self._utts[i]
        wav, txt = self._manifest[i][:2]
        with open(txt) as f:
            return {"spec": wav_to_logspec(wav),
                    "labels": text_to_ids(f.read().strip())}

    def epoch(self, epoch: int = 0, batches: Optional[range] = None
              ) -> Iterator[Dict[str, np.ndarray]]:
        """One pass over this rank's shard: the batches numbered in
        `batches` (all when None), each padded to (max_frames,
        max_label_len)."""
        idx = self.partitioner.indices(epoch)
        b = self.batch_size
        t_max, l_max = self.max_frames, self.max_label_len
        for n in range(len(idx) // b) if batches is None else batches:
            utts = [self._load(i) for i in idx[n * b:(n + 1) * b]]
            spec = np.zeros((b, t_max, N_BINS), np.float32)
            labels = np.zeros((b, l_max), np.int32)
            in_len = np.zeros((b,), np.int32)
            lab_len = np.zeros((b,), np.int32)
            for j, u in enumerate(utts):
                t = min(u["spec"].shape[0], t_max)
                length = min(len(u["labels"]), l_max)
                if u["spec"].shape[0] > t_max or len(u["labels"]) > l_max:
                    self.truncated_count += 1
                    if not self._warned_truncation:
                        self._warned_truncation = True
                        logging.getLogger(__name__).warning(
                            "utterance exceeds max_frames=%d/max_label_len="
                            "%d and was truncated (counting further cases "
                            "in AN4Dataset.truncated_count)", t_max, l_max)
                spec[j, :t] = u["spec"][:t]
                labels[j, :length] = u["labels"][:length]
                in_len[j], lab_len[j] = t, length
            yield {"spectrogram": spec, "labels": labels,
                   "input_lengths": in_len, "label_lengths": lab_len}

    def __iter__(self):
        e = 0
        while True:
            yield from self.epoch(e)
            e += 1
