"""The model zoo of the port (counterpart of ``repro/models``).

So far the Mamba-2 forward: :mod:`~repro_torch.models.config`,
:mod:`~repro_torch.models.blocks`, :mod:`~repro_torch.models.ssm`,
:mod:`~repro_torch.models.transformer` and :mod:`~repro_torch.models.lm`
(``init_lm``, ``forward``, ``prefill``).
"""
