"""Backend policy shared by every kernel wrapper of the port.

Counterpart of the backend policy at the top of ``repro/kernels/ops.py``:

  * entry points take ``device=``; ``None`` and ``"cuda"`` mean the CUDA
    device, ``"cpu"`` must be asked for explicitly. Without a CUDA device
    and without ``device="cpu"`` they raise — they never fall back.
  * a kernel wrapper looks at the tensors it is given: CPU tensors go to
    the kernel's plain PyTorch version (the role Pallas ``interpret=True``
    plays for the JAX package), CUDA tensors go to the hand-written kernel,
    anything else raises. There is no ``try`` that gives way to the plain
    version on the device.
"""

from __future__ import annotations

import torch


def strict_fp32() -> None:
    """Turn TF32 off for matmuls and cuDNN convolutions, and keep bf16
    matmuls from reducing in bf16.

    The reference numerics are fp32 storage with an fp32 accumulator; TF32
    keeps a 10-bit mantissa. cuDNN's flag defaults to True. A bf16 product
    must sum in fp32 and round once, as ``preferred_element_type=float32``
    followed by a cast does in the JAX package.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``"cpu"`` is asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        strict_fp32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors.

    Mixed devices and other device types raise.
    """
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel operands lie on different CUDA devices")
        return True
    raise ValueError(
        f"kernel operands must all lie on the CPU or all on one CUDA "
        f"device, got {sorted(types)}"
    )


class LaunchCounter:
    """Per-kernel counts: kernel launches and plain-version calls; a wrapper
    with more than one C entry also counts launches per entry."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.plain_calls = 0
        self.entries: dict[str, int] = {}

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0
        self.entries = {}


def matmul_block_k(k: int) -> int:
    """K tile of :func:`matmul`: the JAX wrapper's power of two, at most 128."""
    return min(128, 1 << (k - 1).bit_length()) if k < 128 else 128


def matmul(a: torch.Tensor, b: torch.Tensor, *, compensated: bool = False,
           out_dtype=torch.float32) -> torch.Tensor:
    """NTX wide-accumulation matmul (``repro/kernels/ops.py::matmul`` on its
    kernel route): the kernel for CUDA tensors, its plain version for CPU tensors.

    K tiles are the JAX wrapper's power-of-two block of at most 128
    (:func:`matmul_block_k`). The JAX wrapper pads M, N and K to whole
    blocks and slices the result; here the kernel and its plain version mask
    the ragged edges instead, which gives the same sums (zeros change neither
    ``acc`` nor 2Sum) without the copies. The output tiles set no result, so
    only K's block is chosen.
    """
    from repro_torch.kernels import ntx_matmul  # looked up at call time

    return ntx_matmul.tiled_matmul(a, b, block_k=matmul_block_k(a.shape[-1]),
                                   out_dtype=out_dtype, compensated=compensated)


BACKENDS = ("auto", "xla")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32 — or left in fp64: the dtype the element-wise steps,
    the reductions and the fp32 sums compute in. Only an fp64 model (the
    reference of the training step's first-step gate) computes in fp64."""
    return x if x.dtype == torch.float64 else x.float()


def _mm32(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(spec, a, b, preferred_element_type=float32)``: the
    operands widened to fp32 (a product of two bf16 values is exact there),
    summed in fp32. TF32 stays off (:func:`strict_fp32`)."""
    return torch.einsum(spec, widen(a), widen(b))


def _blockwise_attention_xla(q, k, v, *, causal: bool, window: int | None,
                             sm_scale: float, q_offset, kv_valid_len,
                             block_kv: int) -> torch.Tensor:
    """Online-softmax attention scanning KV blocks; GQA grouped (no KV repeat).

    ``repro/kernels/ops.py::_blockwise_attention_xla``: q, k, v and p stay
    in the input dtype, the products sum in fp32 and only the score and
    normalizer statistics are fp32. The last KV block is padded with zeros;
    masked scores are ``-1e30``. Differentiable by autograd; JAX's
    ``jax.checkpoint`` around each block only saves memory and has no
    counterpart here.
    """
    bsz, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    grp = hq // hkv
    qf = q.reshape(bsz, hkv, grp, sq, d)

    block_kv = min(block_kv, skv)
    pad = (-skv) % block_kv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    nblk = k.shape[2] // block_kv
    dev = q.device
    q_ids = q_offset + torch.arange(sq, device=dev)
    valid = skv if kv_valid_len is None else kv_valid_len

    f32 = torch.promote_types(q.dtype, torch.float32)
    m_p = torch.full((bsz, hkv, grp, sq), -torch.inf, dtype=f32, device=dev)
    l_p = torch.zeros((bsz, hkv, grp, sq), dtype=f32, device=dev)
    acc = torch.zeros((bsz, hkv, grp, sq, d), dtype=f32, device=dev)
    for i in range(nblk):
        kv0 = i * block_kv
        kblk = k[:, :, kv0:kv0 + block_kv]
        vblk = v[:, :, kv0:kv0 + block_kv]
        s = _mm32("bkgqd,bkjd->bkgqj", qf, kblk) * sm_scale
        kv_ids = kv0 + torch.arange(block_kv, device=dev)
        mask = (kv_ids[None, :] < valid) | torch.zeros((sq, 1), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (kv_ids[None, :] <= q_ids[:, None])
        if window is not None:
            mask = mask & (kv_ids[None, :] > q_ids[:, None] - window)
        s = torch.where(mask, s, -1e30)
        m_c = s.amax(dim=-1)
        m_n = torch.maximum(m_p, m_c)
        # avoid NaN from (-inf) - (-inf) on fully-masked prefixes
        safe_m = torch.where(m_n <= -1e29, 0.0, m_n)
        p = torch.exp(s - safe_m[..., None])
        p = torch.where(mask, p, 0.0)
        alpha = torch.exp(torch.where(m_p <= -1e29, -torch.inf, m_p - safe_m))
        l_p = l_p * alpha + p.sum(-1)
        # p rounded to the value dtype before the product; the sum stays fp32
        acc = acc * alpha[..., None] + _mm32("bkgqj,bkjd->bkgqd", p.to(vblk.dtype), vblk)
        m_p = m_n
    l_f = torch.where(l_p == 0.0, 1.0, l_p)
    out = (acc / l_f[..., None]).reshape(bsz, hq, sq, d)
    return out.to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: int | None = None, sm_scale: float | None = None, q_offset: int = 0,
              kv_valid_len: int | None = None, block_kv: int = 128,
              backend: str = "auto") -> torch.Tensor:
    """Flash attention with GQA and causal / sliding-window masks
    (``repro/kernels/ops.py::attention``).

    q (B, Hq, Sq, D), k / v (B, Hkv, Skv, D) -> o (B, Hq, Sq, D) in q's
    dtype. ``sm_scale`` defaults to ``1/sqrt(D)``. ``backend="auto"`` takes
    the kernel route: the kernel for CUDA tensors, its plain version for CPU
    tensors; as on the JAX kernel route it serves only the full prompt
    (``q_offset == 0``, ``kv_valid_len is None``). ``backend="xla"`` takes
    the blockwise route (:func:`_blockwise_attention_xla`, KV blocks of
    ``block_kv``) on either device: the route the training step and
    autograd go through, with ``q_offset`` / ``kv_valid_len``.
    """
    _check_backend(backend)
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if backend == "xla":
        return _blockwise_attention_xla(q, k, v, causal=causal, window=window,
                                        sm_scale=sm_scale, q_offset=q_offset,
                                        kv_valid_len=kv_valid_len, block_kv=block_kv)
    if q_offset != 0 or kv_valid_len is not None:
        raise NotImplementedError(
            "the flash-attention kernel serves the q_offset=0 full-cache case, as the "
            "JAX kernel route does; take backend='xla' (the blockwise route) for "
            "q_offset / kv_valid_len. The decode step attends to its KV cache densely "
            "(models.attention.decode_attention_block)"
        )
    from repro_torch.kernels import flash_attention  # looked up at call time

    return flash_attention.flash_attention(q, k, v, causal=causal, window=window,
                                           sm_scale=sm_scale)


def _ssd_chunked_xla(x, la, b, c, *, chunk: int, h0=None):
    """Chunked dual-form SSD, a loop over chunks
    (``repro/kernels/ops.py::_ssd_chunked_xla``). Everything is fp32 (fp64
    for fp64 inputs) but the cums, summed and differenced in fp64; returns
    (y in x's dtype, the final state (B, H, P, N) in fp32).

    Unlike the reference, each decay is masked before its exponential, so
    the backward stays finite where a chunk's decay passes fp32's exp range
    (the reference's is NaN there)."""
    bb, h, s, p = x.shape
    _, g, _, n = b.shape
    grp = h // g
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"chunk {chunk} does not divide the sequence length {s}")
    nc = s // chunk

    xf = widen(x).reshape(bb, h, nc, chunk, p)
    laf = widen(la).reshape(bb, h, nc, chunk)
    bf = widen(b).reshape(bb, g, nc, chunk, n)
    cf = widen(c).reshape(bb, g, nc, chunk, n)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))

    hstate = h0 if h0 is not None else torch.zeros((bb, h, p, n), dtype=xf.dtype,
                                                   device=x.device)
    ys = []
    for i in range(nc):
        xc, lac, bc, cc = xf[:, :, i], laf[:, :, i], bf[:, :, i], cf[:, :, i]
        # cums summed and differenced in fp64, each exponent rounded once, as
        # the fp32 SSD kernel takes them: differences of fp32 cums cancel
        # where la is large (and their backward, a reverse cumsum, too)
        cum64 = torch.cumsum(lac.double(), dim=-1)  # (B,H,Q) inclusive
        cumg64 = cum64.reshape(bb, g, grp, chunk)
        total64 = cum64[..., -1].reshape(bb, g, grp)
        cumg = cumg64.to(lac.dtype)
        total = total64.to(lac.dtype)  # (B,G,grp)
        # intra (grouped to avoid repeating b/c across the head group)
        scores = torch.einsum("bgin,bgjn->bgij", cc, bc)  # (B,G,Q,Q)
        # masked before the exponential: for j > i the difference is
        # -(la_{i+1} + ... + la_j) >= 0, whose exp overflows past ~88 and
        # whose masked backward would then multiply 0 by inf
        diff = (cumg64[..., :, None] - cumg64[..., None, :]).to(lac.dtype)  # (B,G,grp,Q,Q)
        decay = torch.exp(torch.where(causal, diff, -torch.inf))
        xg = xc.reshape(bb, g, grp, chunk, p)
        y = torch.einsum("bgij,bgkij,bgkjp->bgkip", scores, decay, xg)
        # inter
        hg = hstate.reshape(bb, g, grp, p, n)
        y = y + torch.exp(cumg)[..., None] * torch.einsum("bgin,bgkpn->bgkip", cc, hg)
        # state update
        w = torch.exp((total64[..., None] - cumg64).to(lac.dtype))[..., None] * bc[:, :, None]
        hstate = torch.exp(total).reshape(bb, h)[..., None, None] * hstate + torch.einsum(
            "bgkip,bgkin->bgkpn", xg, w
        ).reshape(bb, h, p, n)
        ys.append(y.reshape(bb, h, chunk, p))
    y = torch.stack(ys, dim=2).reshape(bb, h, s, p)
    return y.to(x.dtype), hstate


def ssd(x: torch.Tensor, la: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
        chunk: int = 128, backend: str = "auto", return_state: bool = False):
    """Mamba-2 SSD scan (``repro/kernels/ops.py::ssd``).

    x (B, H, S, P), la (B, H, S), b / c (B, G, S, N) -> y (B, H, S, P), and
    the final state (B, H, P, N) fp32 with ``return_state=True``.
    ``backend="auto"`` without ``return_state`` takes the kernel route: the
    kernel for CUDA tensors, its plain version for CPU tensors.
    ``backend="xla"`` or ``return_state`` take the chunked route
    (:func:`_ssd_chunked_xla`) on either device, as the JAX wrapper does for
    ``return_state``; it is the route autograd goes through.
    """
    _check_backend(backend)
    if backend == "auto" and not return_state:
        from repro_torch.kernels import ssd_scan  # looked up at call time

        return ssd_scan.ssd_scan(x, la, b, c, chunk=chunk)
    y, h = _ssd_chunked_xla(x, la, b, c, chunk=chunk)
    return (y, h) if return_state else y
