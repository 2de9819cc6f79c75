"""Batched serving engine: request queue -> length-bucketed waves ->
prefill + greedy decode loop with per-slot completion masking.

Requests are bucketed by prompt length (equal-length waves keep the
decode step's one position exact for every slot); each wave is padded to
the fixed slot count by repeating its last request.  Slots whose request
has finished (EOS or max_new) keep decoding, masked out of the results,
so the batch shape never changes mid-wave.

One difference from the reference: a request whose prompt and new tokens
need more cache positions than ``max_len`` is refused at ``submit`` (a
``ValueError``), where the reference's clamped cache writes would run it.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import api
from repro_torch.models.layers import cdtype
from repro_torch.train.step import make_decode_step


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16


@dataclass
class Completion:
    rid: int
    tokens: List[int]
    latency_s: float = 0.0


class BatchServer:
    """Serves ``Request``s with ``params`` (on ``device``, the card when
    None).  ``stats``: tokens emitted, waves run, each wave's occupancy,
    and per wave (``wave_log``) its prompt length, prefill seconds (to the
    first token on the host), decode steps and decode seconds."""

    def __init__(self, cfg: ModelConfig, params, max_batch: int = 8,
                 eos_id: Optional[int] = None, max_len: int = 512,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.eos_id = eos_id
        self.max_len = max_len
        self.device = resolve(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params on {params['embed'].device}, the "
                             f"server on {self.device}")
        self.queue: List[Request] = []
        self._decode = make_decode_step(cfg)
        self.stats = {"tokens": 0, "waves": 0, "occupancy": [],
                      "wave_log": []}

    def _positions_needed(self, req: Request) -> int:
        """Cache positions ``req`` writes: its prompt, then one a decode
        step (the last new token is never fed back)."""
        return len(req.prompt) + max(req.max_new, 1) - 1

    def submit(self, req: Request):
        if self.cfg.family != "ssm" and \
                self._positions_needed(req) > self.max_len:
            raise ValueError(
                f"request {req.rid}: a prompt of {len(req.prompt)} and "
                f"{req.max_new} new tokens need "
                f"{self._positions_needed(req)} cache positions, over "
                f"max_len {self.max_len}")
        self.queue.append(req)

    def _waves(self) -> List[List[Request]]:
        buckets: Dict[int, List[Request]] = defaultdict(list)
        for r in self.queue:
            buckets[len(r.prompt)].append(r)
        waves = []
        for _, rs in sorted(buckets.items()):
            for i in range(0, len(rs), self.max_batch):
                waves.append(rs[i:i + self.max_batch])
        return waves

    def run(self) -> Dict[int, Completion]:
        out: Dict[int, Completion] = {}
        for wave in self._waves():
            out.update(self._run_wave(wave))
        self.queue.clear()
        return out

    def _run_wave(self, wave: List[Request]) -> Dict[int, Completion]:
        t0 = time.perf_counter()
        cfg, dev = self.cfg, self.device
        b = self.max_batch
        plen = len(wave[0].prompt)
        gen = max(r.max_new for r in wave)
        max_len = min(self.max_len, plen + gen)
        slots = wave + [wave[-1]] * (b - len(wave))
        toks = torch.tensor([r.prompt for r in slots], dtype=torch.int32,
                            device=dev)
        batch = {"tokens": toks}
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.zeros(
                (b, cfg.n_frontend_tokens, cfg.d_model), dtype=cdtype(cfg),
                device=dev)
        if cfg.family == "audio":
            batch["frames"] = torch.zeros(
                (b, cfg.encoder_len, cfg.d_model), dtype=cdtype(cfg),
                device=dev)

        logits, cache = api.prefill(self.params, cfg, batch, max_len)
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
        emitted = [[t] for t in tok[:, 0].tolist()]
        t_prefill = time.perf_counter()
        done = [False] * b
        steps = 0
        for step in range(gen - 1):
            tok, _, cache = self._decode(self.params, cache, tok,
                                         plen + step)
            steps += 1
            t_host = tok[:, 0].tolist()
            for i in range(b):
                if done[i]:
                    continue
                emitted[i].append(t_host[i])
                if self.eos_id is not None and t_host[i] == self.eos_id:
                    done[i] = True
                if len(emitted[i]) >= slots[i].max_new:
                    done[i] = True
            if all(done):
                break
        t_end = time.perf_counter()
        dt = t_end - t0
        self.stats["waves"] += 1
        self.stats["occupancy"].append(len(wave) / b)
        self.stats["wave_log"].append({
            "prompt_len": plen, "requests": len(wave),
            "prefill_s": t_prefill - t0, "decode_steps": steps,
            "decode_s": t_end - t_prefill})
        res = {}
        for i, r in enumerate(wave):
            res[r.rid] = Completion(r.rid, emitted[i][:r.max_new], dt)
            self.stats["tokens"] += len(res[r.rid].tokens)
        return res
