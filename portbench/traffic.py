"""The one traffic generator: batches made on the device from the seed, one
batch a step, their ids drawn uniformly over the configuration's
vocabulary, from the parameters of a workload file's ``traffic`` block:

  ``batch``     sequences a step
  ``seq_len``   tokens a sequence
  ``inputs``    ``"tokens"`` (the ids, shifted by one from the labels) or
                ``"embeddings"``: what a later stage of a pipeline gets
                from the stage before it, hidden states [batch, seq_len,
                d_model] drawn N(0, 1) in the model's dtype

A step's batch depends on (seed, step) alone, so the reference gets the
very batches the program's first steps got, and every step's rows differ.
"""

from __future__ import annotations

from typing import Dict

import torch

from .weights import derive_seed

__all__ = ["batch", "tokens_per_step"]

#: the stream of ``derive_seed`` that batches come from (weights use 0, 1)
_STREAM = 7


def tokens_per_step(traffic: Dict) -> int:
    return int(traffic["batch"]) * int(traffic["seq_len"])


def batch(traffic: Dict, model: Dict, seed: int, step: int, device) -> Dict[str, torch.Tensor]:
    """{"labels": int32 [batch, seq_len]} with "tokens" (int32, the labels
    shifted by one) or "embeddings", as ``inputs`` says."""
    b, s = int(traffic["batch"]), int(traffic["seq_len"])
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, _STREAM, step))
    ids = torch.randint(0, model["vocab"], (b, s + 1), generator=gen, device=device,
                        dtype=torch.int64).to(torch.int32)
    out = {"labels": ids[:, 1:].contiguous()}
    inputs = traffic.get("inputs", "tokens")
    if inputs == "tokens":
        out["tokens"] = ids[:, :-1].contiguous()
    elif inputs == "embeddings":
        dtype = getattr(torch, model.get("dtype", "bfloat16"))
        out["embeddings"] = torch.randn((b, s, model["d_model"]), generator=gen, device=device,
                                        dtype=dtype)
    else:
        raise ValueError(f"inputs {inputs!r}: the generator makes 'tokens' or 'embeddings'")
    return out
