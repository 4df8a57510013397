"""Serving engine: decode steps and a slot-based batched request scheduler
(continuous-batching-lite); counterpart of :mod:`repro.serve.engine`.

The engine keeps a fixed batch of B slots.  Requests prefill into a free
slot's cache region; every engine tick decodes one token for all active
slots; finished slots (EOS or max tokens) are recycled.  Sampling is greedy
or temperature-based from a seeded :class:`torch.Generator`.  Every decode
step runs :func:`repro_torch.models.model.decode_step` under
``torch.inference_mode()`` on ``ServeConfig.device`` (the card unless the
caller asks for the CPU), so each attention layer of a step launches the
decode-attention kernel once.

``decode_fn`` is what the `decode_32k` / `long_500k` cells run: one new
token against a seq_len-deep cache.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

import repro_torch
from repro_torch.core import plan as fftplan
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import EMPTY_POS
from repro_torch.resilience import faults as _faults


@dataclasses.dataclass
class ServeConfig:
    batch_size: int = 8
    max_len: int = 1024
    temperature: float = 0.0         # 0 => greedy
    eos_id: Optional[int] = None
    seed: int = 0
    device: str = "cuda"             # raises where CUDA is absent

    def __post_init__(self):
        repro_torch.device(self.device)


@dataclasses.dataclass
class _Slot:
    active: bool = False
    request_id: int = -1
    position: int = 0
    generated: Optional[list] = None
    deadline: Optional[float] = None  # absolute clock time, None = no limit


class Engine:
    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params,
                 clock: Optional[Callable[[], float]] = None):
        self.cfg = cfg
        self.scfg = scfg
        self.params = params
        self.device = repro_torch.device(scfg.device)
        with torch.inference_mode():
            self.cache = M.init_cache(cfg, scfg.batch_size, scfg.max_len,
                                      M.torch_dtype(cfg.dtype),
                                      device=self.device)
            # one empty row, copied over a slot's cache on admission
            self._empty = M.init_cache(cfg, 1, scfg.max_len,
                                       M.torch_dtype(cfg.dtype),
                                       device=self.device)
        self.slots: List[_Slot] = [_Slot() for _ in range(scfg.batch_size)]
        self._decode = decode_fn(cfg)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(scfg.seed)
        self.finished: dict = {}
        self.timed_out: set = set()   # request ids cut off by their deadline
        self.degraded = False         # pre-warm fell back to torch plans
        self.degrade_reason: Optional[str] = None
        self._clock = clock if clock is not None else time.monotonic
        self._warm_fft_plans()

    def _warm_fft_plans(self) -> None:
        """Resolve the (d_model,) FFT plan fourier mixers request on every
        call, on the model's ``cfg.fft_backend``, once at engine
        construction; the plan lives in the process-wide registry.  The
        seq-axis key depends on the runtime sequence length, so it
        resolves lazily on first use.

        :func:`repro_torch.core.plan.warm` holds the compile-or-degrade
        semantics: a raising plan resolution (an injected
        ``serve.prewarm`` fault) degrades the engine to the torch schedule,
        ``self.degraded`` flips and ``self.degrade_reason`` says why, and
        serving proceeds instead of crashing."""
        cfg = self.cfg
        uses_fourier = (cfg.token_mixing == "fourier"
                        or any("fourier" in b for b in cfg.block_pattern))
        if not uses_fourier:
            return
        res = fftplan.warm([{"shape": (cfg.d_model,),
                             "dtype": M.torch_dtype(cfg.dtype)}],
                           backend=cfg.fft_backend,
                           device=self.device)[0]
        if res.degraded:
            self.degraded = True
            self.degrade_reason = res.reason

    def _step_inputs(self, toks: np.ndarray, pos: np.ndarray):
        return (torch.from_numpy(toks).to(self.device),
                torch.from_numpy(pos).to(self.device))

    # -- request lifecycle ---------------------------------------------------

    def add_request(self, request_id: int, prompt: np.ndarray,
                    deadline_s: Optional[float] = None) -> bool:
        """Prefill `prompt` into a free slot; False if engine is full.

        ``deadline_s`` is a per-request latency budget in seconds (measured
        on the engine clock from admission): a request past its deadline is
        finished with whatever it generated so far and its id recorded in
        ``self.timed_out``."""
        try:
            slot_idx = next(i for i, s in enumerate(self.slots)
                            if not s.active)
        except StopIteration:
            return False
        # token-by-token prefill into this slot, from an empty cache row;
        # the other rows decode at an empty position, which leaves their
        # caches as they were
        with torch.inference_mode():
            for dst, src in zip(M.tree_leaves(self.cache),
                                M.tree_leaves(self._empty)):
                dst[:, slot_idx].copy_(src[:, 0])
            for t, tok in enumerate(prompt[:-1]):
                toks = np.zeros((self.scfg.batch_size,), np.int64)
                toks[slot_idx] = tok
                pos = np.full((self.scfg.batch_size,), EMPTY_POS, np.int32)
                pos[slot_idx] = t
                t_toks, t_pos = self._step_inputs(toks, pos)
                _, self.cache = self._decode(self.params, t_toks, self.cache,
                                             t_pos)
        s = self.slots[slot_idx]
        s.active = True
        s.request_id = request_id
        s.position = len(prompt) - 1
        s.generated = [int(prompt[-1])]
        s.deadline = (None if deadline_s is None
                      else self._clock() + deadline_s)
        return True

    # -- engine tick -----------------------------------------------------

    def step(self, max_new: int):
        _faults.check("serve.step", tag="tick")
        toks = np.zeros((self.scfg.batch_size,), np.int64)
        pos = np.full((self.scfg.batch_size,), EMPTY_POS, np.int32)
        for i, s in enumerate(self.slots):
            if s.active:
                toks[i] = s.generated[-1]
                pos[i] = s.position
        t_toks, t_pos = self._step_inputs(toks, pos)
        with torch.inference_mode():
            logits, self.cache = self._decode(self.params, t_toks,
                                              self.cache, t_pos)
            if self.scfg.temperature > 0:
                probs = torch.softmax(logits.float() / self.scfg.temperature,
                                      dim=-1)
                nxt = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
            else:
                nxt = torch.argmax(logits, dim=-1)
        nxt = nxt.cpu().numpy()
        now = self._clock()
        for i, s in enumerate(self.slots):
            if not s.active:
                continue
            s.generated.append(int(nxt[i]))
            s.position += 1
            expired = s.deadline is not None and now >= s.deadline
            done = (expired
                    or len(s.generated) - 1 >= max_new
                    or (self.scfg.eos_id is not None
                        and nxt[i] == self.scfg.eos_id)
                    or s.position >= self.scfg.max_len - 1)
            if done:
                if expired:
                    self.timed_out.add(s.request_id)
                self.finished[s.request_id] = list(s.generated)
                s.active = False
                s.generated = None
                s.deadline = None

    def run(self, requests, max_new: int = 32):
        """Serve a list of (id, prompt ndarray[, deadline_s]); returns
        {id: tokens}.  Ids in ``self.timed_out`` were cut short by their
        deadline (their entry holds the partial generation)."""
        pending = list(requests)
        while pending or any(s.active for s in self.slots):
            while pending and self.add_request(*pending[0]):
                pending.pop(0)
            if any(s.active for s in self.slots):
                self.step(max_new)
        return self.finished


def decode_fn(cfg: ModelConfig):
    """(params, tokens, cache, position) -> (logits, cache): the function
    the decode cells run."""
    def fn(params, tokens, cache, position):
        return M.decode_step(params, cfg, tokens, cache, position)
    return fn


def prefill_fn(cfg: ModelConfig):
    def fn(params, batch, cache):
        return M.prefill(params, cfg, tokens=batch.get("tokens"),
                         embeds=batch.get("embeds"), cache=cache)
    return fn
