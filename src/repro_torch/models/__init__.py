"""The model zoo of the port (counterpart of ``repro/models``).

So far the Mamba-2 and attention decoders, forward and decode step:
:mod:`~repro_torch.models.config`, :mod:`~repro_torch.models.blocks`
(norms, RoPE, MLPs), :mod:`~repro_torch.models.attention`,
:mod:`~repro_torch.models.ssm`, :mod:`~repro_torch.models.transformer` and
:mod:`~repro_torch.models.lm` (``init_lm``, ``forward``, ``prefill``,
``lm_loss``, ``init_cache``, ``serve_step``).
"""
