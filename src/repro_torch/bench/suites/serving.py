"""Serving hot-path benchmark — the paper's sustained-load methodology
applied to the engine itself.

Port of ``repro.bench.suites.serving``, with its record names, grids and
contrasts.  One engine definition is driven over slot-count × prompt-length ×
output-length × KV-layout sweeps, registered once per kernel backend
(``serving[cuda]`` / ``serving[torch]``, the reference's ``[pallas]`` /
``[xla]``), emitting TTFT, per-token latency percentiles, throughput, and
slot/page occupancy as schema-v1 records.  Three KV-layout contrasts ride on
the common sweep:

- **paged vs dense** at the same slot count (``serving_*_ps{k}`` vs the
  unsuffixed rows): same tokens, paged overhead isolated,
- **equal-memory** (``serving_eqmem_*``): a dense engine and a paged engine
  holding the *same KV pool bytes*, the paged one oversubscribing slots
  against it — its ``concurrency`` row (mean active lanes) is the headline
  paging win,
- **shared prefix** (``serving_prefix_*``): every prompt shares a registered
  system-prompt prefix; the ``page_occupancy`` row's ``prefix_tokens_reused``
  metric counts prompt tokens served from shared pages instead of prefill.

The engine's decode and chunked-prefill steps are plain torch ops (the
reference's are plain jnp) and launch no hand kernel, so on this port the
two variants run the same computation: ``backend`` changes only the policy
around the steps, and their rows can differ only by host noise.  Both stay
registered for the reference's record names, and start to differ once a
step launches a hand kernel (ROADMAP.md §1 item 8).  On a CPU device
``serving[cuda]`` gives one ``serving_skipped`` row, as every ``[cuda]``
variant does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.registry import register
from repro_torch.core.timing import resolve_device

from ._skip import skipped_on_cpu


def _build_model(device):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("gemma-2b").reduced()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    return cfg, model, params


def _drive(cfg, model, params, *, backend, n_slots, prompt_len, out_len,
           requests, prefill_chunk, scheduler, seed=0, max_len=None,
           page_size=None, n_pages=None, prefix_len=0):
    """One measured engine run.  Warm-up requests go through the SAME engine
    and their telemetry is discarded before the measured batch.
    ``page_size`` switches the engine to paged KV; ``prefix_len`` registers a
    shared prefix that every prompt then starts with (paged only)."""
    from repro_torch.serve import EngineConfig, ServeEngine

    engine = ServeEngine(
        model,
        params,
        EngineConfig(
            n_slots=n_slots,
            max_len=max_len if max_len is not None else prompt_len + out_len + 1,
            prefill_chunk=prefill_chunk,
            page_size=page_size,
            n_pages=n_pages,
            backend=backend,
            scheduler=scheduler,
        ),
    )
    rng = np.random.default_rng(seed)
    prefix = []
    if prefix_len:
        prefix = [int(t) for t in rng.integers(1, cfg.vocab_size, prefix_len)]
        engine.register_prefix(prefix)

    def batch(n):
        for _ in range(n):
            tail = [int(t) for t in rng.integers(1, cfg.vocab_size, prompt_len)]
            engine.submit(prefix + tail, max_new_tokens=out_len)
        finished = engine.run(max_ticks=50 * max(n, 1) * out_len)
        if len(finished) != n:
            raise RuntimeError(f"served {len(finished)}/{n} requests")

    batch(min(2, requests))  # warm-up: first calls of the prefill and decode steps
    engine.reset_metrics()
    batch(requests)
    return engine


def _points(slots, prompt_lens, out_lens, page_sizes, prefix_len) -> int:
    """Engine runs of one sweep (the rows a skipped variant stands for)."""
    n = len(slots) * len(prompt_lens) * len(out_lens) * (1 + len(page_sizes))
    return n + (2 + bool(prefix_len) if page_sizes else 0)


@register(
    "serving",
    backends=("cuda", "torch"),
    paper_ref="Ch.1 + Fig 4.3 (inference board under sustained load)",
    description="serving-engine TTFT/latency/throughput sweep (dense + paged KV)",
    quick={"slots": (2,), "prompt_lens": (8,), "out_lens": (8,), "requests": 4,
           "prefill_chunk": 4, "page_sizes": (4,), "oversub": 3,
           "prefix_len": 6},
    full={"slots": (2, 4), "prompt_lens": (8, 32), "out_lens": (16,), "requests": 12,
          "prefill_chunk": 8, "page_sizes": (4, 16), "oversub": 3,
          "prefix_len": 16},
)
def bench_serving(slots=(2,), prompt_lens=(8,), out_lens=(8,), requests=4,
                  prefill_chunk=4, scheduler="fcfs", backend="torch",
                  page_sizes=(), oversub=3, prefix_len=0, device="cuda") -> list:
    """Each sweep point drives a fresh engine over seeded prompts and reports
    its :class:`~repro_torch.serve.metrics.EngineMetrics` rows.  A warm-up
    pass per point keeps one-time costs out of TTFT.

    ``page_sizes`` adds a paged twin per sweep point (same workload, paged
    KV) plus, for the first page size, the equal-memory and shared-prefix
    contrasts described in the module docstring.  ``oversub`` is the slot
    multiplier the equal-memory paged engine runs at.
    """
    skipped = skipped_on_cpu(
        "serving", _points(slots, prompt_lens, out_lens, page_sizes, prefix_len), backend,
        device)
    if skipped:
        return skipped
    cfg, model, params = _build_model(resolve_device(device))
    recs = []
    for ns in slots:
        for pl in prompt_lens:
            for ol in out_lens:
                common = dict(backend=backend, n_slots=ns, prompt_len=pl,
                              out_len=ol, prefill_chunk=prefill_chunk,
                              scheduler=scheduler, requests=requests)
                engine = _drive(cfg, model, params, **common)
                recs.extend(
                    engine.metrics.to_records(
                        benchmark="serving",
                        prefix=f"serving_s{ns}_p{pl}_o{ol}",
                        x=f"s{ns}:p{pl}:o{ol}",
                    )
                )
                for ps in page_sizes:
                    engine = _drive(cfg, model, params, page_size=ps, **common)
                    recs.extend(
                        engine.metrics.to_records(
                            benchmark="serving",
                            prefix=f"serving_s{ns}_p{pl}_o{ol}_ps{ps}",
                            x=f"s{ns}:p{pl}:o{ol}:ps{ps}",
                        )
                    )
    if page_sizes:
        ps = page_sizes[0]
        ns, pl, ol = slots[0], prompt_lens[0], out_lens[0]
        recs.extend(
            _eqmem_contrast(cfg, model, params, backend=backend, n_slots=ns,
                            prompt_len=pl, out_len=ol, page_size=ps,
                            oversub=oversub, prefill_chunk=prefill_chunk,
                            scheduler=scheduler, requests=max(requests, 2 * ns))
        )
        if prefix_len:
            engine = _drive(cfg, model, params, backend=backend, n_slots=ns,
                            prompt_len=pl, out_len=ol, page_size=ps,
                            prefix_len=prefix_len, prefill_chunk=prefill_chunk,
                            scheduler=scheduler, requests=requests,
                            max_len=prefix_len + pl + ol + 1)
            recs.extend(
                engine.metrics.to_records(
                    benchmark="serving",
                    prefix=f"serving_prefix_s{ns}_ps{ps}",
                    x=f"prefix{prefix_len}:s{ns}:ps{ps}",
                )
            )
    return recs


def _eqmem_contrast(cfg, model, params, *, backend, n_slots, prompt_len,
                    out_len, page_size, oversub, prefill_chunk, scheduler,
                    requests):
    """Dense vs paged at EQUAL KV memory.

    Both engines hold KV for ``n_slots * max_len`` positions, with
    ``max_len`` sized well above the actual request length.  Dense commits a
    full ``max_len`` region per lane, so it runs ``n_slots`` lanes; the paged
    engine spends the same pool on ``oversub * n_slots`` slots whose lanes
    only consume pages they actually touch.  The ``concurrency`` rows (mean
    active lanes, ``better="higher"``) are the comparison.
    """
    seq = prompt_len + out_len + 1
    max_len = max(oversub * seq, 2 * seq)  # headroom: requests << max_len
    pages_per_lane = -(-max_len // page_size)
    n_pages = n_slots * pages_per_lane  # exactly dense's KV footprint
    common = dict(backend=backend, prompt_len=prompt_len, out_len=out_len,
                  prefill_chunk=prefill_chunk, scheduler=scheduler,
                  requests=requests, max_len=max_len)
    recs = []
    dense = _drive(cfg, model, params, n_slots=n_slots, **common)
    recs.extend(
        dense.metrics.to_records(
            benchmark="serving",
            prefix=f"serving_eqmem_dense_s{n_slots}",
            x=f"eqmem:dense:s{n_slots}",
        )
    )
    paged = _drive(cfg, model, params, n_slots=oversub * n_slots,
                   page_size=page_size, n_pages=n_pages, **common)
    recs.extend(
        paged.metrics.to_records(
            benchmark="serving",
            prefix=f"serving_eqmem_paged_s{oversub * n_slots}_ps{page_size}",
            x=f"eqmem:paged:s{oversub * n_slots}:ps{page_size}",
        )
    )
    return recs
