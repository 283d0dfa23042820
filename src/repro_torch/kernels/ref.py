"""Sequential references for the port's kernels (from ``repro/kernels/ref.py``).

Slow and literal: the tests and ``chip_smoke.py`` hold the kernels and
their chunked plain versions against these.
"""

from __future__ import annotations

import torch


def ssd_ref(
    x: torch.Tensor,  # (B, H, S, P)
    la: torch.Tensor,  # (B, H, S)
    b: torch.Tensor,  # (B, G, S, N)
    c: torch.Tensor,  # (B, G, S, N)
    h0: torch.Tensor | None = None,  # (B, H, P, N)
) -> torch.Tensor:
    """Sequential SSD recurrence (the literal state-space model), fp32.

    h_t = exp(la_t) h_{t-1} + x_t b_t^T,  y_t = h_t c_t; y in x's dtype.
    """
    bb, h, s, p = x.shape
    n = b.shape[-1]
    grp = h // b.shape[1]
    bf = b.float().repeat_interleave(grp, dim=1)  # (B, H, S, N)
    cf = c.float().repeat_interleave(grp, dim=1)
    xf, laf = x.float(), la.float()
    state = h0.float() if h0 is not None else x.new_zeros((bb, h, p, n), dtype=torch.float32)
    ys = []
    for t in range(s):
        a = torch.exp(laf[:, :, t])[..., None, None]
        state = a * state + xf[:, :, t, :, None] * bf[:, :, t, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cf[:, :, t]))
    return torch.stack(ys, dim=2).to(x.dtype)
