"""Double-buffered cluster DMA model: TCDM banking + HMC vault bandwidth.

Counterpart of ``repro/runtime/dma.py``, line for line: the port's timing
model computes no tensors, so it is plain Python on the host.

The cluster DMA engine streams tiles between the HMC vaults (through the
vault controllers) and the TCDM scratchpad while the NTX engines compute
(paper §2.1/§3.1). This module models the three effects that decide whether
the transfer hides behind compute:

  * **sustained bandwidth** — ``R_D_BYTES_PER_CYCLE`` bytes per NTX cycle per
    cluster at efficiency ``ETA_DMA`` (the paper's eta_d), the same
    calibration constants as the analytic model in ``benchmarks/ntx_model.py``.
  * **TCDM bank conflicts** — the scratchpad is word-interleaved over
    ``TCDM_BANKS`` banks; a strided burst that hits only a subset of banks
    serializes by ``gcd(stride, banks)``.
  * **HMC internal bandwidth cap** — all clusters share the 320 GB/s vault
    crossbar; past ~16 clusters the per-cluster share, not the DMA engine,
    is the limit (the Fig. 8 "dent").

``DmaEngine.pipeline`` plays a tile stream through ``n_buffers`` TCDM tile
buffers and reports where the cycles went — compute stall (compute waited on
a transfer) vs buffer stall (transfer waited on a free buffer).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Sequence

# Calibration constants — numerically identical to benchmarks/ntx_model.py
# and to the JAX package's runtime (tests/test_torch_runtime.py pins them).
R_D_BYTES_PER_CYCLE = 4.8  # DMA bytes per NTX cycle per cluster (Table 4)
ETA_DMA = 0.87  # eta_d: achievable fraction of the DMA wire rate
HMC_INTERNAL_BW = 320e9  # B/s through the vault crossbar (§4.9)
TCDM_BANKS = 32  # word-interleaved SRAM banks per cluster


def bank_conflict_factor(word_stride: int, banks: int = TCDM_BANKS) -> int:
    """Serialization factor of a constant-stride burst over ``banks`` banks.

    A stride-s burst touches ``banks / gcd(s, banks)`` distinct banks, so the
    per-cycle parallelism drops by ``gcd(s, banks)``. Stride 0 (broadcast
    reads of one address) pins a single bank.
    """
    if word_stride == 0:
        return banks
    return math.gcd(abs(word_stride), banks)


def vault_bytes_per_cycle(n_clusters: int, f_ntx: float,
                          wire_rate: float = R_D_BYTES_PER_CYCLE) -> float:
    """Per-cluster DMA bytes/cycle after the shared HMC crossbar cap."""
    cap = HMC_INTERNAL_BW / (n_clusters * f_ntx)
    return min(wire_rate, cap)


@dataclass(frozen=True)
class Transfer:
    """One DMA job: ``num_bytes`` moved with TCDM word stride ``word_stride``."""

    num_bytes: float
    word_stride: int = 1


@functools.lru_cache(maxsize=4096)
def _transfer_cycles(num_bytes: float, word_stride: int,
                     bytes_per_cycle: float, eta: float, banks: int) -> int:
    eff = bytes_per_cycle * eta / bank_conflict_factor(word_stride, banks)
    return int(math.ceil(num_bytes / eff))


@dataclass(frozen=True)
class DmaConfig:
    bytes_per_cycle: float = R_D_BYTES_PER_CYCLE
    eta: float = ETA_DMA
    n_buffers: int = 2  # double buffering by default
    banks: int = TCDM_BANKS

    def transfer_cycles(self, t: Transfer) -> int:
        # memoized: the event-driven scheduler evaluates this once per
        # command, and block-replicated programs repeat a handful of
        # (bytes, stride) pairs across hundreds of thousands of commands
        return _transfer_cycles(t.num_bytes, t.word_stride,
                                self.bytes_per_cycle, self.eta, self.banks)

    def capped(self, n_clusters: int, f_ntx: float) -> "DmaConfig":
        """This config with the per-cluster share of the vault crossbar."""
        return DmaConfig(
            bytes_per_cycle=vault_bytes_per_cycle(
                n_clusters, f_ntx, self.bytes_per_cycle
            ),
            eta=self.eta, n_buffers=self.n_buffers, banks=self.banks,
        )


@dataclass(frozen=True)
class PipelineStats:
    total_cycles: int
    compute_cycles: int  # sum of tile compute
    dma_cycles: int  # sum of transfer times
    compute_stall_cycles: int  # compute unit idle, waiting on a transfer
    buffer_stall_cycles: int  # DMA idle, waiting on a free tile buffer

    @property
    def overlap_efficiency(self) -> float:
        """1.0 == transfers fully hidden behind compute."""
        ideal = max(self.compute_cycles, self.dma_cycles)
        return ideal / max(self.total_cycles, 1)


class DmaEngine:
    """Plays a tile stream through ``cfg.n_buffers`` TCDM tile buffers."""

    def __init__(self, cfg: DmaConfig | None = None):
        self.cfg = cfg or DmaConfig()

    def pipeline(
        self,
        tiles: Sequence[tuple[Transfer, float]],
        *,
        overlap: bool = True,
    ) -> PipelineStats:
        """``tiles`` = [(input transfer, compute cycles)] per tile, in order.

        With ``overlap`` the engine prefetches tile i+1 while tile i computes
        (classic double buffering); without it every transfer serializes with
        compute — the §2.5 strawman used to measure what overlap buys.
        """
        nbuf = self.cfg.n_buffers
        d_end: list[int] = []
        c_end: list[int] = []
        compute_stall = 0
        buffer_stall = 0
        dma_sum = 0
        comp_sum = 0
        for i, (tr, cc) in enumerate(tiles):
            dc = self.cfg.transfer_cycles(tr)
            cc = int(math.ceil(cc))
            prev_d = d_end[i - 1] if i else 0
            prev_c = c_end[i - 1] if i else 0
            if overlap:
                slot_free = c_end[i - nbuf] if i >= nbuf else 0
                d_start = max(prev_d, slot_free)
                buffer_stall += d_start - prev_d
                d_i = d_start + dc
                c_start = max(prev_c, d_i)
                compute_stall += c_start - prev_c
            else:
                d_start = max(prev_d, prev_c)
                d_i = d_start + dc
                c_start = d_i
                compute_stall += c_start - prev_c
            d_end.append(d_i)
            c_end.append(c_start + cc)
            dma_sum += dc
            comp_sum += cc
        total = max(c_end[-1] if c_end else 0, d_end[-1] if d_end else 0)
        return PipelineStats(
            total_cycles=total,
            compute_cycles=comp_sum,
            dma_cycles=dma_sum,
            compute_stall_cycles=compute_stall,
            buffer_stall_cycles=buffer_stall,
        )
