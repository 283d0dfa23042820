"""Training driver of the port: ``python -m repro_torch.launch.train --backend ntx``.

Counterpart of ``repro/launch/train.py``'s ``run_ntx_cnn`` and the ntx
branch of its CLI: lower the paper's small CNN to one NTX program per step
(printed as blocks, commands, peak TCDM against the budget and spills),
then train it with every step one pass of the torch executor — fused
region kernels by default (the fusion plan's coverage of the program's
commands is printed), per-node streaming matmuls with ``--no-fuse``. Runs
on the CUDA device unless ``--device cpu`` is given.

``--metrics OUT.jsonl`` writes one JSON record per step (loss, wall
seconds, the step's counters: the program's closed-form offload, cycle and
DMA counts, the plan cache's and the fuser's); ``--trace OUT.json`` writes
one chrome trace (Perfetto or ``chrome://tracing``) with the host's
lowering and dispatch spans and the NTX cycle model's cluster lanes of the
step program. Either also prints the top-k hotspot table.
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np

from repro_torch import obs
from repro_torch.kernels.ops import resolve_device
from repro_torch.lower import (
    PlanCache,
    frequency_band_batches,
    lower_training_step,
    paper_cnn_graph,
    run_timing,
    train_graph,
)


def run_ntx_cnn(steps: int, batch: int, img: int, *, n_clusters: int = 16,
                lr: float = 0.05, momentum: float = 0.9, fuse: bool = True,
                device=None, metrics: str | None = None,
                trace: str | None = None) -> dict:
    """Train the paper CNN for ``steps`` steps; print the per-step losses.

    ``n_clusters`` sizes the program's TCDM budget and the timing model.
    ``metrics`` streams one JSONL record per step; ``trace`` writes the
    merged chrome trace (host lowering / dispatch spans, the step program's
    modeled cluster exec / DMA lanes, flow events). Returns the
    :func:`~repro_torch.lower.graph.train_graph` result dict plus the plan
    cache (``"cache"``).
    """
    dev = resolve_device(device)
    registry = obs.CounterRegistry() if (metrics or trace) else None
    collector = obs.TraceCollector() if trace else None
    reg_ctx = obs.use_registry(registry) if registry is not None else contextlib.nullcontext()
    col_ctx = obs.use_collector(collector) if collector is not None else contextlib.nullcontext()
    with reg_ctx, col_ctx:
        graph = paper_cnn_graph(batch=batch, img=img, lr=lr, momentum=momentum)
        n_params = sum(int(np.prod(s)) for s in graph.param_shapes().values())
        print(f"ntx train-step graph: {graph.name}, {len(graph.nodes)} nodes, "
              f"{n_params} parameters, batch {batch}, img {img}, device {dev}")
        program = lower_training_step(graph, n_clusters=n_clusters)
        print(f"ntx train-step program: {len(program.blocks)} blocks, "
              f"{program.n_commands} commands, "
              f"peak TCDM {program.meta['peak_tcdm_bytes']} / "
              f"{program.meta['tcdm_budget_bytes']} B "
              f"({len(program.meta['spilled'])} spilled)")
        batch_fn = frequency_band_batches(np.random.RandomState(0), batch, img,
                                          graph.loss.classes)
        cache = PlanCache()
        res = train_graph(graph, steps, batch_fn, program=program,
                          params=graph.init_params(seed=0), fuse=fuse, device=dev,
                          cache=cache, metrics_path=metrics)
        if collector is not None:
            # the lane-rendering timing run must not book into the run's counters
            with obs.use_registry(None):
                result = run_timing(program, n_clusters=n_clusters)
            collector.add_cluster_lanes(program, result, n_clusters, pid="hmc0")
            exec_evs = [e for e in collector.events if e.get("cat") == "exec"]
            collector.link_flows(exec_evs, [])
            print(f"merged trace: {collector.save(trace)} ({len(collector.events)} events; "
                  f"modeled step {result.total_cycles} NTX cycles) — open in "
                  "https://ui.perfetto.dev or chrome://tracing")
    losses = res["losses"]
    for i, (loss, w) in enumerate(zip(losses, res["walls"])):
        print(f"step {i:5d} loss={loss:.4f} ({w*1e3:.0f} ms)", flush=True)
    print(f"plan cache: {len(cache)} plans "
          f"({cache.hits} hits / {cache.misses} misses over {cache.calls} calls)")
    fusion = res["fusion"]
    if fusion is not None:
        print(f"fusion: {fusion.n_regions} regions + "
              f"{len(fusion.fallback_steps)} fallback steps per step, covering "
              f"{fusion.fused_commands} of {fusion.total_commands} program commands "
              f"({100 * fusion.coverage:.2f} %)")
    else:
        print("fusion: disabled (--no-fuse) — per-node plan dispatch")
    if metrics:
        print(f"per-step metrics JSONL: {metrics}")
    if registry is not None:
        print(obs.format_hotspots(registry))
    print(f"done: {steps} ntx steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    res["cache"] = cache
    return res


def _cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="ntx", choices=["ntx"],
                    help="ntx: train the paper's small CNN through the torch "
                         "executor (the only backend of the port so far)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--img", type=int, default=16, help="CNN input image size")
    ap.add_argument("--n-clusters", type=int, default=16,
                    help="HMC clusters: the program's TCDM budget and the timing model")
    ap.add_argument("--no-fuse", action="store_true",
                    help="disable the region fuser and run per-node plans")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the default) needs a GPU; cpu runs the plain "
                         "PyTorch versions of the kernels")
    ap.add_argument("--metrics", default=None, metavar="OUT.jsonl",
                    help="write one JSON record per step (loss, wall, counters)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write the merged chrome trace (host spans, modeled "
                         "cluster lanes)")
    args = ap.parse_args(argv)
    res = run_ntx_cnn(args.steps, args.batch, args.img, n_clusters=args.n_clusters,
                      fuse=not args.no_fuse, device=args.device,
                      metrics=args.metrics, trace=args.trace)
    if len(res["losses"]) >= 3 and not res["losses"][-1] < res["losses"][0]:
        raise SystemExit("ntx CNN training did not decrease the loss")


if __name__ == "__main__":
    _cli()
