"""Deterministic synthetic data pipeline (counterpart of
:mod:`repro.data.pipeline`).

Produces token (or stub-embedding) batches that are:
- *deterministic in (seed, step)*: restart-safe, the iterator's checkpoint
  is just the integer step;
- *host-shardable*: each host materialises only its slice of the global
  batch;
- *structured*: a Zipf-ish unigram mix plus shifted-copy structure so a
  model can actually reduce loss.

:class:`Prefetcher` is the bounded background prefetch the spectral
server's staging stage (:mod:`repro_torch.serve.spectral.executor`) and the
batch iterator sit on.  The reference's ``make_batch_specs`` (shape stand-ins
for the sharded dry run) waits for the training launcher, ROADMAP 'Modules
to port' item 14.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

import repro_torch
from repro_torch.models.config import ModelConfig


class Prefetcher:
    """Bounded background prefetch over any iterator.

    A daemon thread pulls items from ``src`` into a bounded queue of
    ``depth`` slots (2 = double buffering), so consumers overlap their own
    work with the producer's assembly cost.  Order is preserved; a producer
    exception is re-raised at the consumer's ``next()`` (not swallowed on
    the thread); ``close()`` stops the producer promptly even when the
    queue is full.

    ``threaded=False`` is the injectable test mode: a plain synchronous
    passthrough with the identical interface.
    """

    _DONE = object()

    def __init__(self, src: Iterable, *, depth: int = 2,
                 threaded: bool = True):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._src = iter(src)
        self._threaded = threaded
        self._closed = False
        if not threaded:
            return
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="repro-torch-prefetch")
        self._thread.start()

    def _produce(self) -> None:
        try:
            for item in self._src:
                while not self._closed:
                    try:
                        self._q.put(("item", item), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._closed:
                    return
            self._q.put((None, self._DONE))
        except BaseException as e:  # noqa: BLE001 — re-raised at next()
            self._q.put(("error", e))

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if not self._threaded:
            if self._closed:
                raise StopIteration
            return next(self._src)
        kind, item = self._q.get()
        if item is self._DONE:
            raise StopIteration
        if kind == "error":
            raise item
        return item

    def close(self) -> None:
        """Stop prefetching; the producer thread exits at its next put."""
        self._closed = True
        if self._threaded:
            while True:             # unblock a full-queue producer
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    copy_offset: int = 3             # learnable structure: x[t] ~ x[t-offset]
    copy_prob: float = 0.7


class SyntheticLM:
    """Deterministic (seed, step) -> batch generator; batches are made on
    the host from numpy and land on ``device``."""

    def __init__(self, dcfg: DataConfig, mcfg: ModelConfig, *,
                 device="cuda"):
        self.dcfg = dcfg
        self.mcfg = mcfg
        self.device = repro_torch.device(device)

    def batch_at(self, step: int, host_id: int = 0, num_hosts: int = 1):
        d, m = self.dcfg, self.mcfg
        per_host = d.global_batch // num_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([d.seed, step, host_id]))
        v = m.vocab_size
        # Zipf-ish unigram draw
        ranks = np.arange(1, v + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(v, size=(per_host, d.seq_len + 1), p=probs)
        # inject copy structure
        copy_mask = rng.random((per_host, d.seq_len + 1)) < d.copy_prob
        idx = np.arange(d.seq_len + 1)
        src = np.clip(idx - d.copy_offset, 0, None)
        toks = np.where(copy_mask, toks[:, src], toks)
        tokens = torch.from_numpy(toks[:, :-1]).to(self.device, torch.int32)
        labels = torch.from_numpy(toks[:, 1:]).to(self.device, torch.int32)
        if m.input_mode == "embeddings":
            # stub modality frontend: deterministic random projections of
            # the token stream stand in for patch/frame embeddings
            emb_rng = np.random.default_rng(
                np.random.SeedSequence([d.seed, step, host_id, 7]))
            embeds = emb_rng.standard_normal(
                (per_host, d.seq_len, m.d_model)).astype(np.float32)
            return {"embeds": torch.from_numpy(embeds).to(
                        self.device, getattr(torch, m.dtype)),
                    "labels": labels}
        return {"tokens": tokens, "labels": labels}

    def iter_batches(self, start_step: int = 0, *, num_steps: int = None,
                     host_id: int = 0, num_hosts: int = 1,
                     prefetch_depth: int = 2,
                     threaded: bool = True) -> Prefetcher:
        """Streaming batch iterator with bounded background prefetch.

        Yields ``(step, batch)`` pairs from ``start_step`` (restart-safe:
        resume by passing the checkpointed step).  Batch assembly runs on
        the prefetch thread, overlapped with the consumer's device step.
        ``threaded=False`` degrades to a synchronous passthrough
        (deterministic tests)."""
        def gen():
            step = start_step
            while num_steps is None or step < start_step + num_steps:
                yield step, self.batch_at(step, host_id=host_id,
                                          num_hosts=num_hosts)
                step += 1
        return Prefetcher(gen(), depth=prefetch_depth, threaded=threaded)

    def checkpoint_state(self, step: int) -> dict:
        return {"step": step, "seed": self.dcfg.seed}

    @staticmethod
    def restore_step(state: dict) -> int:
        return int(state["step"])
