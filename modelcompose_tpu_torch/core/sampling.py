"""Device-side token sampling: temperature + top-p (nucleus) (counterpart
of modelcompose_tpu/core/sampling.py).

Semantics match HF's processor stack exactly, as the JAX package's do:
- temperature scaling first, then the TopP warper (ascending stable sort,
  softmax-cumsum, drop tokens with cumulative mass <= 1 - top_p, always
  keeping the top-1 token), then a categorical draw;
- rows with temperature <= GREEDY_TEMP decode greedily (argmax of the raw
  logits), matching the reference's ``do_sample = temperature > 0.001``.

The draw is Gumbel-max with uniforms from an explicit ``torch.Generator``
on the logits' device: it stays on the device, with no host sync.  RNG
streams cannot match across frameworks; the masks do, exactly.
"""

from __future__ import annotations

import torch

# the reference worker's gate is do_sample = temperature > 0.001
# (model_worker.py) — rows at or below this sample greedily
GREEDY_TEMP = 1e-3


def entropy_seed() -> int:
    """OS-entropy seed for a generator when the caller supplies none — a
    fixed default seed would make every worker replay identical "random"
    streams across restarts/replicas."""
    import os

    return int.from_bytes(os.urandom(4), "little")


def top_p_filter(scaled_logits: torch.Tensor, top_p) -> torch.Tensor:
    """Fill logits outside the top-p nucleus with the dtype's lowest value.

    scaled_logits: [..., V] (already temperature-scaled); top_p: [...] or a
    scalar in (0, 1].  HF-exact: ascending stable sort (ties land as
    ``jnp.argsort`` puts them), cumulative softmax mass, remove tokens with
    ``cumsum <= 1 - top_p``, keep at least the top-1 token.  top_p >= 1
    removes nothing.
    """
    dtype = scaled_logits.dtype
    top_p = torch.as_tensor(top_p, dtype=dtype,
                            device=scaled_logits.device)[..., None]
    sorted_logits, sorted_idx = torch.sort(scaled_logits, dim=-1,
                                           stable=True)  # ascending
    cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
    remove_sorted = cum <= (1.0 - top_p)
    # min_tokens_to_keep=1: the last ascending slot (the argmax) survives
    remove_sorted[..., -1] = False
    remove = torch.zeros_like(remove_sorted).scatter(-1, sorted_idx,
                                                     remove_sorted)
    return scaled_logits.masked_fill(remove, torch.finfo(dtype).min)


def gumbel(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise, fp32, from uniforms drawn by ``generator``
    (which lives on ``device``)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def categorical(generator: torch.Generator, logits: torch.Tensor
                ) -> torch.Tensor:
    """One draw per row of softmax(logits) [..., V] -> [...] int64, by
    Gumbel-max with uniforms from ``generator`` (on the logits' device)."""
    noise = gumbel(generator, logits.shape, logits.device)
    return (logits.float() + noise).argmax(dim=-1)


def sample_logits(generator: torch.Generator, logits: torch.Tensor,
                  temperature, top_p) -> torch.Tensor:
    """[B, V] logits -> [B] int32 tokens, on the logits' device.

    temperature/top_p: [B] tensors (or scalars); rows with
    temperature <= GREEDY_TEMP take argmax of the raw logits (bit-identical
    to greedy decode), other rows sample
    softmax(top_p_filter(logits / temperature)).
    """
    logits = logits.float()
    shape, device = logits.shape[:-1], logits.device
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=device).expand(shape)
    top_p = torch.as_tensor(top_p, dtype=torch.float32,
                            device=device).expand(shape)
    greedy = temperature <= GREEDY_TEMP
    safe_temp = torch.where(greedy, 1.0, temperature)[..., None]
    filtered = top_p_filter(logits / safe_temp, top_p)
    sampled = categorical(generator, filtered)
    return torch.where(greedy, logits.argmax(dim=-1),
                       sampled).to(torch.int32)


def sample_step(generator: torch.Generator, logits, temperature, top_p):
    """Entry for the streaming engines: one [B] token draw."""
    return sample_logits(generator, logits, temperature, top_p)
