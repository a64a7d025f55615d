"""gloo collectives and the tp 2 prefill on one card, for comparing trees.

Ranks share the card over gloo, every collective staged through host
memory, as ``chip_smoke.py`` phases 13-16 run them.  One JSON line a run.

    python tools/gloo_ab.py dist                 # torch.distributed on host fp32
    python tools/gloo_ab.py collectives [SRC]    # the port's dist.collectives
    python tools/gloo_ab.py prefill [SRC]        # gemma-2b's 4 x 1000 prefill at tp 2

``dist`` times gloo's own ops on a (2000, 4, 2048) fp32 host tensor on 2
ranks: all-reduce (in place, and of a copy), ``reduce_scatter_tensor``,
the list ``reduce_scatter`` and ``all_gather_into_tensor``, 10 calls each.
``collectives`` times ``all_reduce``, ``reduce_scatter`` on dim 1,
``all_reduce`` then a slice, and ``all_gather`` of half on dim 1, of a
(4, 1000, 2048) bf16 CUDA tensor, from the package under ``SRC`` (default
``src``; another checkout's ``src`` measures that tree).  ``prefill`` times
4 prefills of gemma-2b at full width and depth (flash kernel) on a
2-rank ``model`` mesh after a warm-up.  Set ``GLOO_AB_DEVICE=cpu`` to
rehearse ``dist`` and ``collectives`` without a card.
"""
import json
import os
import sys
import tempfile
import time

MODE = sys.argv[1]
SRC = os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else "src")
sys.path.insert(0, SRC)

import torch  # noqa: E402

DEV = os.environ.get("GLOO_AB_DEVICE", "cuda")
REPS = 10


def sync():
    if DEV == "cuda":
        torch.cuda.synchronize()


def timed(fn, reps, barrier=sync) -> float:
    fn()
    barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    barrier()
    return (time.perf_counter() - t0) / reps


def dist_rank(r, n, path, q):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{path}", rank=r, world_size=n)
    x = torch.randn((1000 * n, 4, 2048))
    out = torch.empty((1000, 4, 2048))
    ops = {"all_reduce_inplace": lambda: dist.all_reduce(x),
           "all_reduce_of_a_copy": lambda: dist.all_reduce(x.clone()),
           "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(out, x),
           "reduce_scatter_list": lambda: dist.reduce_scatter(out, list(x.chunk(n))),
           "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(x, out),
           "copy_alone": lambda: x.clone()}
    q.put((r, {k: timed(fn, REPS, dist.barrier) for k, fn in ops.items()}))
    dist.destroy_process_group()


def collectives_rank(rank):
    from repro_torch.dist import collectives, rank_device
    from repro_torch.launch.mesh import Mesh

    mesh = Mesh((2,), ("model",)).bind(rank_device(DEV, rank))
    x = torch.randn((4, 1000, 2048), device=mesh.device).bfloat16()
    half = x[:, :500].contiguous()
    ops = {"all_reduce": lambda: collectives.all_reduce(x, mesh, "model"),
           "reduce_scatter_dim1": lambda: collectives.reduce_scatter(x, mesh, "model", 1),
           "all_reduce_then_slice": lambda: collectives.all_reduce(x, mesh, "model")[:, :500]
           .contiguous(),
           "all_gather_half_dim1": lambda: collectives.all_gather(half, mesh, "model", 1)}
    return {k: timed(fn, REPS) for k, fn in ops.items()}


def prefill_rank(rank, reps):
    from repro_torch.configs import get_config
    from repro_torch.dist import activation_sharding, param_specs, rank_device, shard_tree
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model

    mesh = Mesh((2,), ("model",)).bind(rank_device(DEV, rank))
    dev = mesh.device
    cfg = get_config("gemma-2b").replace(attn_impl="pallas")
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    local = shard_tree(params, param_specs(params, cfg, mesh))
    del params
    tokens = torch.randint(0, cfg.vocab_size, (4, 1000),
                           generator=torch.Generator(device=dev).manual_seed(13), device=dev)
    times = []
    with torch.inference_mode(), activation_sharding(mesh):
        model.prefill(local, {"tokens": tokens[:1, :64]})
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            model.prefill(local, {"tokens": tokens})
            sync()
            times.append(time.perf_counter() - t0)
    return times


def main() -> int:
    out = {"mode": MODE, "torch": torch.__version__}
    if MODE == "dist":
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        with tempfile.TemporaryDirectory() as tmp:
            ps = [ctx.Process(target=dist_rank, args=(r, 2, os.path.join(tmp, "store"), q))
                  for r in range(2)]
            for p in ps:
                p.start()
            out["ranks_s"] = [v for _, v in sorted(q.get(timeout=600) for _ in ps)]
            for p in ps:
                p.join(60)
    else:
        from repro_torch.dist import run_ranks

        out["src"] = SRC
        fn, args = ((collectives_rank, ()) if MODE == "collectives"
                    else (prefill_rank, (4,)))
        out["ranks_s"] = run_ranks(fn, 2, *args, backend="gloo", device=DEV, timeout=900)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
