"""Merging attention partials across the ranks of a mesh axis.

Counterpart of quantizedattention_tpu/parallel/collective.py. For now it
holds only `lse_weighted_merge` (JAX collective.py:42-54), which
context-sharded decode (kv_cache.py:context_sharded_decode) merges its
ranks' partials with; the all-gather and KV-sharded attentions of that file
come with the training slice's sequence parallelism.
"""

from __future__ import annotations

import torch

from quantizedattention_tpu_torch.parallel.mesh import pmax, psum


def lse_weighted_merge(o: torch.Tensor, lse: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Merge normalized attention partials O [..., d] with their exp2-domain
    lse [...] across `axis`: m = pmax(lse); w = exp2(lse - m);
    O = psum(w O) / psum(w). A row with no live key anywhere (lse -inf on
    every rank) gives O = 0. Three all_reduces over the axis."""
    m = pmax(lse.clone(), mesh, axis)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    w = torch.where(torch.isfinite(lse), torch.exp2(lse - m_safe), 0.0)
    num = psum((o * w[..., None]).contiguous(), mesh, axis)
    den = psum(w.contiguous(), mesh, axis)
    den = torch.where(den == 0.0, 1.0, den)
    return num / den[..., None]
