"""Mamba-2 (SSD) block — attention-free sequence mixing (``repro/models/ssm.py``).

Follows the Mamba-2 architecture (arXiv:2405.21060): input projections for
(z, x, B, C, dt); a short depthwise causal conv over x, B and C; the SSD
scan with scalar-per-head decay A; a D skip; gated RMSNorm; out projection.
The scan runs through :func:`repro_torch.kernels.ops.ssd`: the
hand-written kernel on the card, its plain version on the CPU, or with
``backend="xla"`` the chunked route that autograd goes through.

bf16 rounds where the JAX block rounds: after every projection, after the
conv's silu, the dt scale cast before the product, the D-skip term,
``silu(z)`` in fp32 cast before the gate, and the norm's output.

The decode step (:func:`ssm_block_step`) carries the last three conv
inputs (in the model dtype) and the SSM state (fp32, (B, H, P, N)) in its
cache (:func:`init_ssm_cache`) and costs O(1) a token; it rounds where the
block does. No kernel is on this step, as none is on JAX's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ops import widen
from repro_torch.models.blocks import ParamTree, _dot, init_rmsnorm, normal, rms_norm

_CONV_W = 4


def _dims(cfg):
    d_inner = cfg.ssm_headdim * cfg.n_heads  # == 2 * d_model for mamba2
    g, n = cfg.ssm_groups, cfg.ssm_state
    return d_inner, g, n


def init_ssm_block(cfg, gen: torch.Generator | None, device, dtype=torch.bfloat16) -> ParamTree:
    """The JAX block's parameters, same names, shapes and distributions.

    As in JAX, where both come from one key, ``conv_wc`` equals ``conv_wb``.
    """
    d = cfg.d_model
    d_inner, g, n = _dims(cfg)
    h = cfg.n_heads
    std = d**-0.5

    def rnd(shape, s, dt=dtype):
        return normal(shape, s, gen, device, dt)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    # dt bias: softplus^-1 of dt log-uniform in [1e-3, 1e-1] (mamba init)
    if torch.device(device).type == "meta":
        dt = torch.empty((h,), device=device)
    else:
        u = torch.rand((h,), generator=gen, device=device)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return ParamTree({
        "w_z": rnd((d, d_inner), std),
        "w_x": rnd((d, d_inner), std),
        "w_b": rnd((d, g * n), std),
        "w_c": rnd((d, g * n), std),
        "w_dt": rnd((d, h), std),
        "conv_wx": rnd((_CONV_W, d_inner), 0.1),
        "conv_bx": zeros((d_inner,)),
        "conv_wb": (conv_wb := rnd((_CONV_W, g * n), 0.1)),
        "conv_bb": zeros((g * n,)),
        "conv_wc": conv_wb.clone(),
        "conv_bc": zeros((g * n,)),
        "a_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32, device=device)),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),  # softplus^-1(dt)
        "d_skip": torch.ones((h,), dtype=torch.float32, device=device),
        "norm": init_rmsnorm(d_inner, device),
        "w_out": rnd((d_inner, d), d_inner**-0.5),
    })


def _project(x, params):
    z = _dot(x, params["w_z"])
    xs = _dot(x, params["w_x"])
    b = _dot(x, params["w_b"])
    c = _dot(x, params["w_c"])
    dt = _dot(x, params["w_dt"])
    return z, xs, b, c, dt


def _causal_conv1d(x, w, b):
    """Depthwise causal conv along S of (B, S, C), fp32 sum, silu, x's dtype."""
    s = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.promote_types(x.dtype, torch.float32),
                      device=x.device)
    for k in range(w.shape[0]):
        shifted = F.pad(x, (0, 0, k, 0))[:, :s]
        out = out + widen(shifted) * widen(w[k])
    return F.silu(out + widen(b)).to(x.dtype)


def ssm_block(x: torch.Tensor, params, cfg, *, backend: str = "auto",
              chunk: int = 128) -> torch.Tensor:
    """Full-sequence Mamba-2 block. x: (B, S, D) -> (B, S, D)."""
    bsz, s, _ = x.shape
    d_inner, g, n = _dims(cfg)
    h, p = cfg.n_heads, cfg.ssm_headdim

    z, xs, b, c, dt = _project(x, params)
    xs = _causal_conv1d(xs, params["conv_wx"], params["conv_bx"])
    b = _causal_conv1d(b, params["conv_wb"], params["conv_bb"])
    c = _causal_conv1d(c, params["conv_wc"], params["conv_bc"])

    dt = F.softplus(widen(dt) + params["dt_bias"])  # (B, S, H)
    a = -torch.exp(params["a_log"])  # (H,)
    la = (dt * a).transpose(1, 2)  # (B, H, S) log-decay <= 0

    xh = xs.reshape(bsz, s, h, p).transpose(1, 2)  # (B, H, S, P)
    xh = xh * dt.transpose(1, 2)[..., None].to(xh.dtype)  # dt-scaled input
    bg = b.reshape(bsz, s, g, n).transpose(1, 2)  # (B, G, S, N)
    cg = c.reshape(bsz, s, g, n).transpose(1, 2)

    y = ops.ssd(xh, la, bg, cg, chunk=min(chunk, s), backend=backend)  # (B, H, S, P)
    y = y + params["d_skip"][None, :, None, None].to(xh.dtype) * xh
    y = y.transpose(1, 2).reshape(bsz, s, d_inner)

    y = y * F.silu(widen(z)).to(y.dtype)  # gated
    y = rms_norm(y, params["norm"], cfg.norm_eps)
    return _dot(y, params["w_out"])


def init_ssm_cache(cfg, batch: int, dtype=torch.bfloat16, device=None) -> dict:
    """The conv window's last ``_CONV_W - 1`` inputs in ``dtype`` and the
    SSM state in fp32."""
    d_inner, g, n = _dims(cfg)
    conv_dim = d_inner + 2 * g * n
    return {
        "conv": torch.zeros((batch, _CONV_W - 1, conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.ssm_headdim, n), dtype=torch.float32,
                           device=device),
    }


def _conv_step(win, w, bias, dtype):
    """The causal conv at the window's last position: taps flipped to line
    up with the window (oldest first), fp32 sum, silu, ``dtype``."""
    out = (widen(win) * widen(torch.flip(w, dims=(0,)))[None]).sum(1)
    return F.silu(out + widen(bias)).to(dtype)


def ssm_block_step(x1: torch.Tensor, params, cfg, cache: dict):
    """One decode step (O(1)). x1: (B, 1, D). Returns (y (B, 1, D), new cache)."""
    bsz = x1.shape[0]
    d_inner, g, n = _dims(cfg)
    h, p = cfg.n_heads, cfg.ssm_headdim

    z, xs, b, c, dt = _project(x1, params)
    xbc = torch.cat([xs, b, c], dim=-1)  # (B, 1, conv_dim)
    window = torch.cat([cache["conv"], xbc], dim=1)  # (B, W, conv_dim)
    wx, wb, wc = torch.split(window, [d_inner, g * n, g * n], dim=-1)
    xs = _conv_step(wx, params["conv_wx"], params["conv_bx"], x1.dtype)  # (B, d_inner)
    b = _conv_step(wb, params["conv_wb"], params["conv_bb"], x1.dtype)
    c = _conv_step(wc, params["conv_wc"], params["conv_bc"], x1.dtype)

    dt = F.softplus(widen(dt[:, 0]) + params["dt_bias"])  # (B, H)
    a = torch.exp(dt * -torch.exp(params["a_log"]))  # (B, H) decay
    xh = xs.reshape(bsz, h, p) * dt[..., None].to(xs.dtype)  # (B, H, P) dt-scaled input
    grp = h // g
    # jnp.repeat along the group axis: each group's b and c serve its heads in turn
    bh = b.reshape(bsz, g, n).repeat_interleave(grp, dim=1)  # (B, H, N)
    ch = c.reshape(bsz, g, n).repeat_interleave(grp, dim=1)

    state = cache["ssm"] * a[..., None, None] + (
        widen(xh)[..., :, None] * widen(bh)[..., None, :]
    )  # (B, H, P, N)
    y = torch.einsum("bhpn,bhn->bhp", state, widen(ch)).to(x1.dtype)
    y = y + params["d_skip"][None, :, None].to(x1.dtype) * xh
    y = y.reshape(bsz, 1, d_inner)
    y = y * F.silu(widen(z)).to(y.dtype)  # gated
    y = rms_norm(y, params["norm"], cfg.norm_eps)
    return _dot(y, params["w_out"]), {"conv": window[:, 1:], "ssm": state}
