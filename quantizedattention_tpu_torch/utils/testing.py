"""Structured accuracy reports: mismatch counts, MSE and max abs error.

Counterpart of quantizedattention_tpu/utils/testing.py. The envelope below is
the JAX package's (tests/test_bf16_attention.py:18-23): the original
reference's published rates, atol 1e-2 with rtol 0, forward mismatch rate
5e-5, and a gradient rate of 3.5e-4 (its 1.1e-4 with slack for small
tensors).
"""

from __future__ import annotations

import dataclasses

import torch

ATOL = 1e-2
FWD_MISMATCH_RATE = 5e-5
GRAD_MISMATCH_RATE = 3.5e-4


@dataclasses.dataclass
class MismatchReport:
    name: str
    mismatches: int
    total: int
    mse: float
    max_abs_err: float
    atol: float

    @property
    def mismatch_rate(self) -> float:
        return self.mismatches / max(self.total, 1)

    def __str__(self) -> str:
        return (
            f"{self.name}: {self.mismatches}/{self.total} mismatches "
            f"(atol={self.atol}, rate={self.mismatch_rate:.2e}), "
            f"mse={self.mse:.4e}, max_abs_err={self.max_abs_err:.4e}"
        )


def mismatch_report(name: str, got, want, atol: float = ATOL) -> MismatchReport:
    """Element-wise |got - want| <= atol (rtol 0) count, MSE and max abs error."""
    err = (torch.as_tensor(got).float() - torch.as_tensor(want).float()).abs()
    return MismatchReport(
        name=name,
        mismatches=int((err > atol).sum()),
        total=err.numel(),
        mse=float((err * err).mean()),
        max_abs_err=float(err.max()),
        atol=atol,
    )
