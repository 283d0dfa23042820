"""Metrics reporting: per-step JSONL and hotspot tables.

Counterpart of ``repro/obs/report.py`` without its benchmark-artefact
writers (``write_bench_json``, ``write_offload_bench``), which come with
the port's benchmark.

  * ``launch/train.py --metrics out.jsonl`` streams one JSON object per
    training step through :class:`MetricsWriter` — schema:
    ``{"schema_version": 1, "step": int, "wall_s": float, "loss": float?,
    "counters": {leaf: total}}`` where ``counters`` are the step's
    :class:`~repro_torch.obs.counters.CounterRegistry` leaf totals
    (offloads, commands, dma_bytes, busy_cycles, macs, ...).
  * :func:`format_hotspots` renders the registry's top-k scopes by cycles,
    DMA bytes and link bytes — the CLI prints it after a run.
"""

from __future__ import annotations

import json
import os

#: Version stamp of every metrics JSONL record (the JAX package's too).
SCHEMA_VERSION = 1


# ---------------------------------------------------------------------------
# Per-step JSONL metrics
# ---------------------------------------------------------------------------


def _jsonable(v):
    """Best-effort scalar coercion: one-element tensors and numpy arrays or
    scalars -> float (a CUDA tensor is copied to the host); anything else
    that is not a JSON scalar -> its ``str``."""
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class MetricsWriter:
    """Append-only JSONL emitter; one flushed line per record."""

    def __init__(self, path, append: bool = False):
        self.path = str(path)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "a" if append else "w")

    def write(self, record: dict) -> None:
        rec = {"schema_version": SCHEMA_VERSION}
        for k, v in record.items():
            if isinstance(v, dict):
                rec[k] = {kk: _jsonable(vv) for kk, vv in v.items()}
            else:
                rec[k] = _jsonable(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_jsonl(path) -> list[dict]:
    """Load a metrics JSONL back into a list of records."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# ---------------------------------------------------------------------------
# Hotspot tables
# ---------------------------------------------------------------------------


def hotspots(reg, leaf: str, k: int = 5, prefix: str = "") -> list[tuple[str, float]]:
    """Top-``k`` (scope, value) pairs for one counter leaf, descending."""
    want = f"/{leaf}"
    rows = []
    for key, v in reg.counters().items():
        if prefix and not key.startswith(prefix):
            continue
        if key == leaf:
            rows.append(("<root>", v))
        elif key.endswith(want):
            rows.append((key[: -len(want)], v))
    rows.sort(key=lambda r: -r[1])
    return rows[:k]


def _fmt(v: float) -> str:
    for unit, div in (("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(v) >= div:
            return f"{v / div:.2f}{unit}"
    return f"{v:.0f}" if v == int(v) else f"{v:.3f}"


def format_hotspots(reg, k: int = 5) -> str:
    """Human-readable top-k table by cycles, DMA bytes and link bytes."""
    sections = (
        ("busy_cycles", "by cycles"),
        ("dma_bytes", "by DMA bytes"),
        ("link_bytes", "by link bytes"),
    )
    lines = [f"top-{k} hotspots"]
    for leaf, title in sections:
        rows = hotspots(reg, leaf, k)
        if not rows:
            continue
        lines.append(f"  {title}:")
        width = max(len(s) for s, _ in rows)
        for scope, v in rows:
            lines.append(f"    {scope:<{width}}  {_fmt(v):>10}")
    return "\n".join(lines)
