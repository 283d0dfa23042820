"""The model zoo of the port (counterpart of ``repro/models``).

So far the LM forward of the Mamba-2 and attention decoders:
:mod:`~repro_torch.models.config`, :mod:`~repro_torch.models.blocks`
(norms, RoPE, MLPs), :mod:`~repro_torch.models.attention`,
:mod:`~repro_torch.models.ssm`, :mod:`~repro_torch.models.transformer` and
:mod:`~repro_torch.models.lm` (``init_lm``, ``forward``, ``prefill``).
"""
