"""bf16 softmax correction rules.

Counterpart of quantizedattention_tpu/quantize/bf16_correction.py. In bf16
flash attention the un-normalized probability of a row's max logit is
exp2(m - m) = 1.0 exactly, and when several logits tie for the max each of
them rounds to 1.0 in bf16, which destabilizes training (arXiv:2510.04212).
Two rules keep every P entry strictly below 1.0:

- "eps" (the default): in exact arithmetic any per-row bias of the running
  max cancels in the softmax normalization, so biasing it by one bf16 ulp
  pushes every un-normalized P entry to at most exp2(-EPS_BIAS) = 0.9973,
  which rounds to bf16 0.99609.
- "beta" (the reference's rule, `amplify_tied_max`): where more than one
  logit of a tile lies within `tol` of the running max, the max becomes
  BETA * m where m > 0 and 0 elsewhere. BETA = 2.0 (the reference notes
  that 8.0 overflows to NaN).

"none" applies neither. The logits are compared scaled to scaled (the JAX
package's documented divergence from the reference).
"""

import torch

BETA = 2.0
APPROX_MAX_TOL = 1e-3
EPS_BIAS = 2.0 ** -8


def amplify_tied_max(s_scaled: torch.Tensor, next_m: torch.Tensor, beta: float = BETA,
                     tol: float = APPROX_MAX_TOL) -> torch.Tensor:
    """The running max `next_m` [..., q, 1], amplified where a row of the
    scaled logits `s_scaled` [..., q, k] has more than one entry >= next_m -
    tol: beta * next_m where next_m > 0, else 0. Same shape and dtype as
    next_m."""
    tied = (s_scaled >= next_m - tol).sum(-1, keepdim=True) > 1
    amplified = torch.where(next_m > 0, beta * next_m, torch.zeros_like(next_m))
    return torch.where(tied, amplified, next_m)
