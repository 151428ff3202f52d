"""bf16 softmax correction constants.

The "eps" rule: in exact arithmetic any per-row bias of the running max
cancels in the softmax normalization, so biasing it by one bf16 ulp pushes
every un-normalized P entry to at most exp2(-EPS_BIAS) = 0.9973, which rounds
to bf16 0.99609, strictly below 1.0. That keeps tied row maxima resolvable
after P is rounded to bf16 for the PV product (arXiv:2510.04212).
"""

EPS_BIAS = 2.0 ** -8
