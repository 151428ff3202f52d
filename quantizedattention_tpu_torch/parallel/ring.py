"""Merging partial attentions by their log-sum-exp.

Counterpart of quantizedattention_tpu/parallel/ring.py. For now it holds
only `_merge_partials` (JAX ring.py:52-62), which the chunked prefill uses
to join a chunk's causal attention over itself with its attention over the
cached prefix. It is plain tensor code, as it is plain XLA in the JAX
package; the rings themselves (sequence parallelism across cards) are not
ported yet.
"""

from __future__ import annotations

import torch


def _merge_partials(o1, lse1, o2, lse2):
    """Combine two normalized partial attentions (O [..., t, d], lse
    [..., t]) through their exp2-domain lse: O = (w1 O1 + w2 O2) / (w1 + w2)
    with w = exp2(lse - max). A row whose two lse are both -inf gives O = 0
    and lse -inf."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    w1 = torch.where(torch.isfinite(lse1), torch.exp2(lse1 - m_safe), 0.0)
    w2 = torch.where(torch.isfinite(lse2), torch.exp2(lse2 - m_safe), 0.0)
    l = w1 + w2
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / l_safe[..., None]
    lse = torch.where(l == 0.0, -torch.inf, m + torch.log2(l_safe))
    return o, lse
