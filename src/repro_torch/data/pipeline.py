"""Data pipeline (counterpart of `repro/data/pipeline.py`): deterministic
synthetic and byte-level LM streams, in numpy.

  * `SyntheticLM`  — structured pseudo-language (Zipfian unigrams + local
    n-gram structure) so models actually reduce loss during training
    runs (pure noise would floor at ln(V));
  * `ByteCorpus`   — byte-level LM over any text file / string;
  * `SyntheticImages` — class-conditional blob images;
  * host-side background prefetch (`Prefetcher`) and per-host sharding
    (`shard_for_host`).

All streams are stateless functions of (seed, step), so a resumed run
replays the exact batch sequence, and they are the JAX package's numpy
code: the batches are bit-identical to its.  Tensors are made at the
step's call site.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class SyntheticLM:
    """Deterministic pseudo-language stream: batch(step) is pure."""

    def __init__(self, vocab: int, seq_len: int, batch: int,
                 seed: int = 0, n_image_tokens: int = 0,
                 d_model: int = 0, input_mode: str = "tokens"):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.n_image_tokens = n_image_tokens
        self.d_model = d_model
        self.input_mode = input_mode
        rng = np.random.default_rng(seed)
        # Zipfian unigram distribution + a random bigram transition kernel
        ranks = np.arange(1, vocab + 1)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        self.shift = rng.integers(1, vocab, size=16)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        toks = rng.choice(self.vocab, p=self.unigram,
                          size=(self.batch, self.seq_len + 1))
        # inject deterministic local structure: every 4th token repeats a
        # shifted copy of its predecessor (learnable signal)
        src = toks[:, :-1]
        sh = self.shift[step % len(self.shift)]
        toks[:, 1::4] = (toks[:, 0:-1:4] + sh) % self.vocab
        out = {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        if self.input_mode == "tokens+image":
            out["patch_embeds"] = rng.standard_normal(
                (self.batch, self.n_image_tokens, self.d_model),
                dtype=np.float32)
        elif self.input_mode == "embeds":
            out = {"embeds": rng.standard_normal(
                (self.batch, self.seq_len, self.d_model),
                dtype=np.float32),
                "labels": out["labels"]}
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class ByteCorpus:
    """Byte-level LM batches over a text corpus (vocab 256)."""

    def __init__(self, text: str, seq_len: int, batch: int, seed: int = 0):
        self.data = np.frombuffer(text.encode("utf-8"), dtype=np.uint8)
        assert len(self.data) > seq_len + 1, "corpus too small"
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        starts = rng.integers(0, len(self.data) - self.seq_len - 1,
                              size=self.batch)
        idx = starts[:, None] + np.arange(self.seq_len + 1)[None]
        seqs = self.data[idx].astype(np.int32)
        return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}


class SyntheticImages:
    """Class-conditional blob images: class k -> gaussian blob at grid
    cell k with class-dependent color (linearly separable-ish)."""

    def __init__(self, image: int, n_classes: int, batch: int,
                 seed: int = 0):
        self.image = image
        self.n_classes = n_classes
        self.batch = batch
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        labels = rng.integers(0, self.n_classes, size=self.batch)
        grid = int(np.ceil(np.sqrt(self.n_classes)))
        yy, xx = np.mgrid[0:self.image, 0:self.image]
        imgs = rng.standard_normal(
            (self.batch, self.image, self.image, 3)).astype(np.float32) * .1
        for i, lbl in enumerate(labels):
            cy = (lbl // grid + 0.5) * self.image / grid
            cx = (lbl % grid + 0.5) * self.image / grid
            blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) /
                          (2 * (self.image / grid / 2) ** 2))
            color = np.array([np.sin(lbl), np.cos(lbl),
                              np.sin(2 * lbl)], np.float32)
            imgs[i] += blob[..., None] * color
        return {"images": imgs, "labels": labels.astype(np.int32)}


def shard_for_host(batch: Dict[str, np.ndarray], host_id: int,
                   n_hosts: int) -> Dict[str, np.ndarray]:
    """Slice the per-step global batch for this host (data axis)."""
    def slc(x):
        per = x.shape[0] // n_hosts
        return x[host_id * per:(host_id + 1) * per]
    return {k: slc(v) for k, v in batch.items()}


class Prefetcher:
    """Background-thread prefetch of host batches (straggler mitigation:
    data is always ready when the step finishes)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.it = it
        self._stop = False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        for item in self.it:
            if self._stop:
                return
            self.q.put(item)
        self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def stop(self):
        self._stop = True
        try:
            self.q.get_nowait()
        except queue.Empty:
            pass
