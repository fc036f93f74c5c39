"""Batched plaintext serving: prefill + greedy decode with KV caches.

The port of ``src/repro/serve/engine.py``. The reference jits one prefill
and one decode function; here both are plain eager calls of
``models.transformer.forward`` under ``torch.inference_mode`` on the
engine's ``device``. Prompts of one batch share a length (bucket by
length); the prefill caches are grown to ``capacity`` in the time dim and
every decode step reads and appends to them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.transformer import forward, tree_map


@dataclass
class Request:
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    out_tokens: Optional[List[int]] = None


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, capacity: int = 256,
                 batch: int = 4, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = tree_map(lambda a: a.to(self.device), params)
        self.capacity = capacity
        self.batch = batch

    def _prefill(self, params, batch_in):
        with torch.inference_mode():
            return forward(self.cfg, params, batch_in, mode="prefill")

    def _decode(self, params, batch_in, caches):
        with torch.inference_mode():
            return forward(self.cfg, params, batch_in, mode="decode",
                           caches=caches)

    def _grow_caches(self, caches, target: int):
        """Copy prefill caches into ``target``-sized buffers (time dim 2
        of the stacked attention caches; recurrent states keep their
        size)."""
        layers = caches["layers"]
        if self.cfg.uses_attention:
            layers = dict(layers)
            layers["attn"] = {
                k: F.pad(v, (0, 0, 0, 0, 0, target - v.shape[2]))
                for k, v in layers["attn"].items()
            }
        return {"layers": layers, "len": caches["len"]}

    def generate(self, requests: List[Request], greedy: bool = True
                 ) -> List[Request]:
        """Serve a batch of same-length-prompt requests."""
        assert len(requests) <= self.batch
        reqs = list(requests)
        S = len(reqs[0].prompt)
        assert all(len(r.prompt) == S for r in reqs), "bucket by length"
        B = len(reqs)
        toks = np.stack([r.prompt for r in reqs]).astype(np.int64)
        V = self.cfg.vocab_size
        logits, caches = self._prefill(
            self.params, {"tokens": torch.from_numpy(toks).to(self.device)})
        caches = self._grow_caches(caches, self.capacity)
        out = [[] for _ in reqs]
        cur = logits[:, :V].argmax(-1)
        cur_host = cur.cpu().numpy()
        for i in range(B):
            out[i].append(int(cur_host[i]))
        steps = max(r.max_new_tokens for r in reqs) - 1
        for _ in range(max(steps, 0)):
            logits, caches = self._decode(self.params,
                                          {"tokens": cur[:, None]}, caches)
            cur = logits[:, :V].argmax(-1)
            cur_host = cur.cpu().numpy()
            for i in range(B):
                if len(out[i]) < reqs[i].max_new_tokens:
                    out[i].append(int(cur_host[i]))
        for r, o in zip(reqs, out):
            r.out_tokens = o
        return reqs
