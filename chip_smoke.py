#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the final line:

1. the card's name and power limit (nvidia-smi);
2. build the hand kernels from ``src/repro_torch/kernels/csrc`` (timed);
3. each kernel at the shapes the main path gives it: run, compare with its
   plain PyTorch version on the same inputs (tolerance stated per kernel),
   and time kernel, plain version and, where one exists, one PyTorch library
   call of the same function, beside the least time the card could take;
4. the main path: ``python -m repro_torch.bench run dissect --full`` through
   the CLI function, with the launch counts zeroed before and read after; the
   pointer-chase, stream, matmul and op-latency probes must have gone through
   the kernels; the fitted model is checked and compared with the H100
   datasheet, and the op-latency table (ns per op) printed;
4b. the precision ladder: ``bench run gemm_lp[cuda] gemm_lp[torch] gemm[cuda]
   --full`` through the CLI function, counted the same way: every matmul
   instance (fp32, bf16, fp16, int8, fp8 and the 8-bit B transpose) must
   launch, no record may error or be skipped, and the measured ladder at the
   top size is printed beside the datasheet's;
4c. the paper's other tables: ``bench run instr bandwidth axpy memhier
   scheduler atomics throttle --full`` (every variant) through the CLI
   function, counted the same way and per registered benchmark: op_latency,
   stream_reduce, axpy and pchase must launch from the plain suites and the
   ``[cuda]`` variants, the ``[torch]`` ones launch nothing, and no record
   may error or be skipped; Tab 4.1, the memhier levels, stream GB/s, the
   atomics rates and the scheduler ratios are printed; the pointer chase is
   walked at 128 and 256 MiB, 2^21 steps, past the 50 MB L2; then a
   ``--quick`` run of every ported suite must PASS ``compare`` against
   ``benchmarks/baselines_torch/``, and FAIL with one latency record doubled;
5. ``probe_block_shape_bandwidth`` (the Ch. 1 axpy experiment), counted the
   same way, and the access-width sweep of Fig 1.1 at an HBM-sized array,
   each width counted on its own (phase 3 times the same sweep beside
   ``torch.add``; the kernels line carries both as axpy's ``sweep_256mib``);
6. the kernel layer's bandwidth entry points ``api.stream_copy`` and
   ``api.strided_reduce`` on 8 MiB of ones (exact sums), counted the same way;
7. the dense LM at gemma-2b's full width and depth, ``attn_impl="pallas"``,
   through ``build_model(cfg).loss_fn`` / ``prefill`` / ``decode_step`` on 4
   sequences of 1000 tokens, 32 greedy steps, held against the plain
   ``attn_impl="blockwise"`` path by the harness of phases 8b-8e (each call
   with 18 flash_attention launches; last logits and every shared-input
   decode step within 0.1 of their max, the loss within 1e-3; a greedy flip
   printed with its margin); beside it one prompt of 2048 (18 launches,
   held the same way), and the plain 4 x 1000 prefill counted once
   (``perfmodel.extract_costs``) and rooflined against the H100 at bf16,
   the bound's share of the kernel path's prefill printed;
8. the Zamba2 hybrid LM at zamba2-7b's full width and depth (81 Mamba2
   layers, 14 shared-attention calls at hd 112), ``ssm_impl="pallas"`` and
   ``attn_impl="pallas"``, through ``build_model(cfg).loss_fn`` (81 ssm_scan
   launches, all on the wgmma route, and 14 flash_attention launches),
   ``prefill`` (14 flash_attention) and
   16 ``decode_step``s on 4 sequences of 1000 tokens; the same requests
   through the plain path (``ssm_impl="xla"``, ``attn_impl="blockwise"``)
   are the reference; then one forward under ``kernel_policy(autotune=True)``
   at the chunk the autotuner picks for the H100 (512), which must reach the
   ssm_scan kernel at that chunk and agree with the chunk-256 forward; the
   plain forward is rooflined as in phase 7;
8b. the MoE family at olmoe-1b-7b's full width and depth (16 layers, 64
   experts top-8, 6.9e9 fp32 params), ``attn_impl="pallas"``: ``loss_fn``,
   ``prefill`` and 32 greedy ``decode_step``s on 4 sequences of 1000
   tokens through build_model's entry points, each call with 16
   flash_attention launches, against the plain ``attn_impl="blockwise"``
   path (last logits and every shared-input decode step within 0.1 of
   their max, the loss within 1e-3; a greedy flip is printed with its
   margin); then ``moe_block`` against ``moe_block_dense`` on 1 x 256 bf16
   tokens at layer 0 with ``capacity_factor`` 16 (nothing drops) within
   ``tolerance(bfloat16, "nvidia-h100-sxm")``, with the drops at 1.25
   printed; then phase 10's 8 requests served by a dense and a paged engine
   and a direct ``decode_chunk``/``decode_step`` loop, token for token
   equal: a MoE routing group is one lane of one call, and every leg cuts
   each prompt into the same 128-token chunks (the paged leg's 128-token
   prefix is one chunk); tokens/s, TTFT, per-token p50/p99 and peak memory
   per engine, and the assignments each engine drops, counted in an
   untimed rerun of its requests (as are the drops of one 4 x 1000
   prefill), which must repeat its tokens;
8c. the VLM family at internvl2-76b's full width with ``n_layers`` cut from
   80 to 4 (the whole model's 282 GB of fp32 params do not fit one card):
   a seeded bf16 frontend of (2, 256, 8192) patch embeddings before 256
   text tokens, ``loss_fn``, ``prefill`` (4 flash launches each) and 8
   greedy decode steps against the plain path, held as in 8b;
8d. the encoder-decoder family at whisper-base, whole: seeded bf16 frames
   (4, 1500, 512) and 32-token prompts, ``loss_fn`` and ``prefill`` with 18
   flash launches each (6 non-causal encoder layers over 1500 frames, 6
   causal decoder self attentions, 6 cross attentions of Sq 32 over Skv
   1500), 16 greedy ``decode_step``s, held as in 8b;
8e. the xLSTM family at xlstm-1.3b, whole (48 layers: 6 macro blocks of 7
   mLSTM + 1 sLSTM, 2.07e9 fp32 params, bf16 compute): ``loss_fn``,
   ``prefill`` of 4 x 1000 tokens and 16 greedy ``decode_step``s, then the
   forward over the prompt and the tokens the steps were fed; no hand kernel
   may launch (the family is plain torch, as the reference's is plain jnp);
   the prefill's last logits must agree with the forward's at the same
   position within 0.1 of their max, in bf16 and in a float32 twin; each
   decode step's (the step recurrence against the chunkwise form) distance
   from the forward is printed at full depth beside the model's own floor
   (the float32 forward with its embeddings nudged by one ulp: the random
   weights amplify a rounding at every layer), and held within 0.1 over one
   macro block (8 layers) at full width in float32; times printed;
9. the numerics guard (``kernels/guard.py``) at gemma-2b's full width and
   depth: the 4 x 1000 prefill with ``attn_impl="pallas"`` under
   ``kernel_policy(guard="shadow")`` at the H100's tolerances, every flash
   launch shadowed by the torch oracle, plus the guard's verify sweep (the
   matmul, flash and axpy kernels against their oracles): no drift, fault,
   saturation or degraded call, nothing quarantined; then ``python -m
   repro_torch.bench run --guard shadow --only gemm_lp --quick`` in a
   subprocess, which must exit 0; then drift injected into flash_attention
   must be caught, quarantine that op only and serve degraded calls, and
   ``probe``/``revive`` must close the breaker once the drift is cleared;
   then an int8 matmul whose |a|@|b| passes int32's max must raise
   ``SaturationError``;
10. the serving engine (``repro_torch.serve``) at gemma-2b's full width and
   depth: 8 requests (prompts of 200-1000 tokens from numpy seed 0, each
   starting with one shared 128-token prefix) over 4 slots, 32 greedy tokens
   each, chunked prefill of 128 tokens (the chunk's logits are 4 x 128 x
   256,000 bf16, 262 MB), max_len 1056, ``guard="sample"`` and
   ``degrade=False``; one dense engine and one paged engine (page 16, a
   66-page table, so T*page == max_len, with the prefix registered); every
   request must finish, and the tokens of both engines must equal a direct
   loop over ``decode_chunk``/``decode_step``; no degradation, drift or
   quarantine (the engine's steps launch no hand kernel, so its guard checks
   compare torch with torch on this slice); ``decode_chunk``'s logits at
   each prompt's last position must agree with ``model.prefill``'s (the
   flash kernel's path) in float32 within ``tolerance(float32,
   "nvidia-h100-sxm")``, and the served bf16 rows' distance from the bf16
   flash prefill is printed beside the blockwise prefill's; TTFT,
   per-token latency, tokens/s, concurrency and
   reused prefix tokens are printed (smoke readings: 8 requests, so a p99 is
   their maximum); then one ``torch.profiler`` trace of a single
   dense decode step with 4 active lanes: its five longest device operations,
   the device's busy and idle share of the step, and the step's wall time;
11. the serving cluster (``repro_torch.serve.ClusterRouter``) over phase 10's
   model, params and requests, 2 replicas on the card sharing one copy of
   the params: (1) dense under ``least_loaded``, every token equal to phase
   10's dense engine, requests per replica and the peak memory beside phase
   10's printed; (2) paged with the prefix registered once through the
   router under ``prefix_affinity``: the same tokens, every request on the
   prefix's replica, reused prefix tokens > 0; (3) ``fail_replica(1)`` after
   4 ticks of leg 1's workload: nothing lost, one manual failover; (4)
   ``HealthConfig()`` at the reference's defaults, clean and then driven by
   ``FaultInjector`` with ``serving_chaos._fault_plan()`` (paged): the crash
   failed over by the heartbeat, the breaker half-open and closed again, the
   NaN lane quarantined and retried, the kernel fault degrading once, the
   straggler flags and EWMA inflations printed; (5) ``_guard_fault_plan()``
   under ``guard="shadow"`` at the H100's tolerances: drift on ``matmul`` and
   a fault on ``flash_attention`` each quarantined and revived by a clean
   half-open probe, whose launches of the hand ``matmul`` and
   ``flash_attention`` kernels are counted (> 0 each); (6)
   ``repro_torch.launch.serve.main`` at full width (``LAUNCH_ARGV``, its own
   params): 8 of 8 served.  Legs 3–5 resume requests through
   ``decode_chunk``: a bf16 stream may differ from the reference only where
   the reference's top-2 margin lies within that position's
   ``decode_step``-vs-``decode_chunk`` distance and the leg's float32 twin is
   identical (each flip printed); anything else fails.  Each leg prints its
   wall time, tokens/s, TTFT and per-token p50/p99;
12. training, with the earlier phases' params freed: (a) gemma-2b at full
   width and depth as the reference trains it (``attn_impl="blockwise"``,
   remat "full", bf16 compute, fp32 params and AdamW state), 4 steps of
   ``make_train_step`` on ``SyntheticLM`` batches of 2 x 1024 (lr warmed up
   from 0 at step 0): every parameter leaf gets a nonzero gradient on the
   first batch, the losses and grad norms are finite, the first batch's loss
   falls, no hand kernel launches; per-step loss, grad norm, step time and
   tokens/s, and the peak memory printed; (b) the same step at ``reduced()``
   float32 on the card against the CPU, 3 steps: the losses within 1e-4
   relative, the params under the rule of ``tests/test_torch_train.py``
   (each leaf within ``tolerance(float32, "nvidia-h100-sxm")`` but for 1 %
   of its elements, every element within a quarter of the summed lr);
   (c) ``examples/train_tiny_lm_torch.py`` at its defaults, with its
   injected failure and resume, and the same run uninterrupted: the resumed
   losses' largest difference printed and held within 0.05 (the card's
   embedding backward adds with atomics); (d) ``python -m
   repro_torch.launch.train --arch gemma-2b --steps 2 --batch 2 --seq 512``
   in a subprocess, which must exit 0; (e) the flash kernel under autograd,
   alone and in a gemma-2b reduced ``value_and_grad`` with
   ``attn_impl="pallas"``, must raise before it launches;
13. the distribution layer (``repro_torch.dist``), with phase 12's params
   freed, two ranks sharing the card over gloo (every collective staged
   through host memory: these times are not NVLink figures and say nothing
   of multi-GPU scaling), started by ``dist.run_ranks``; a failed or hung
   rank fails the run: (a) gemma-2b at full width and depth tensor-parallel
   on a 2-rank ``model`` mesh: the 4 x 1000 prefill under the guard's shadow
   mode, each rank's 18 flash launches on its 4 query heads and the 1 KV
   head, the gathered last logits within 0.1 of their max of the one-rank
   flash prefill's; phase 10's requests through a dense and a paged engine
   on the mesh, both ranks' tokens equal, and equal to phase 10's dense
   engine but where the one-rank model's top-2 margin lies within the
   distance between its logits row and the ranks' at that position (each
   flip printed); tokens/s and each rank's peak memory; (b) ZeRO stages 2
   and 3 on (data=2, model=1), gemma-2b at full width in float32 compute,
   its depth odd, at most ``ZERO_MAX_LAYERS`` and cut further by a printed
   reckoning of the bytes two ranks hold (``data`` on an inner dim of every
   stacked leaf, the layout printed), one
   step of 2 x 512 tokens each against the one-process step on the same
   batch: the loss and grad norm within 1e-3, the params within
   ``tolerance(float32, "nvidia-h100-sxm")`` but for 1 % of a leaf's
   elements, every element within 2 lr; stage 3 gathers a layer at a time,
   and its peak a rank must be below stage 2's; (c) ``gpipe_apply`` over 2 stages
   against the sequential stages and ``psum_compressed`` against the exact
   sum, on CUDA tensors; (d) a checkpoint saved under data 2 from its
   shards, restored by ``ElasticController`` on one rank, its tree equal;
   (e) a world of one rank over NCCL runs the collectives;
14. training on a (data 2, model 2) mesh, four ranks sharing the card over
   gloo (every collective staged through host memory), with Megatron's
   conjugate collectives in the backward and ZeRO-3 gathering a layer at a
   time: (a) gemma-2b, (b) olmoe-1b-7b (its 64 experts 32 a rank), each at
   full width in float32 compute with the config's ZeRO stage (3) and
   microbatches, its depth at most ``TP_TRAIN_MAX_LAYERS`` (gemma-2b 10 of
   18) and cut further by a printed reckoning of the bytes four ranks
   hold, one step of 4 x 512 random tokens (numpy seed 13) against
   the one-process step on the card at the same depth over the whole batch,
   taken before the ranks start: the loss and grad norm within 1e-3, the
   params under (b)'s rule of phase 13; each rank's local state bytes, peak
   and collectives (calls and bytes through the host) printed, with where
   ZeRO-3 put ``data`` on the stacked leaves, a rank's CUDA context as
   measured beside the reckoning's, and the MoE's dropped assignments; the
   training path launches no kernel;
15. tensor parallelism for the other families and tensor-parallel replicas,
   ranks sharing the card over gloo (every collective through host memory),
   started by ``dist.RankGroup``; each leg's one-rank reference is taken on
   the card first from the params its ranks then place (shared by CUDA IPC,
   the parent's copy freed before the ranks run), after a printed
   reckoning of the bytes the ranks hold: (a) zamba2-7b at full width and
   ``FAMILY_LAYERS`` (39 of 81 layers) at tp 2 (``ssm_impl``/``attn_impl``
   "pallas"): phase 7's 4 x 1000 forward, its logits every 50th position
   within 0.1 of their max of the one-rank forward's, each rank's 39
   ssm_scan (56 of the 112 heads) and 7 flash launches counted, then the prefill and 8 greedy ``decode_step``s; (b)
   internvl2-76b at phase 8c's 4 of 80 layers, tp 2: ``loss_fn`` (within
   1e-3) and the prefill with the 256-patch frontend (4 flash launches
   each), 8 greedy steps, and phase 10's text requests through a dense
   engine on the mesh; (c) whisper-base whole, tp 2, phase 8d's workload
   (18 flash launches a call); (d) xlstm-1.3b whole, tp 2, the forward, the
   prefill and 8 greedy steps, no kernel; (e) gemma-2b at full width served
   by 2 replicas x tp 2 (``ClusterRouter(tp=2)``, four ranks) with
   ``fail_replica(0)`` after 4 ticks, each replica rank's launch counts
   read around the router's run (none: the engine's steps launch no hand
   kernel), then ``python -m repro_torch.launch.serve --replicas 2 --tp 2
   --requests 8``, which must exit 0.  Every prefill's last logits within 0.1 of their max of one
   rank's; the token rule: the ranks' tokens equal one rank's (each leg's
   static batch, phase 10's engine for (b) and (e)), but where the one-rank
   row's top-2 margin at the first differing position lies within its
   distance from the ranks' row there, the ranks' token one of its top two
   (each flip printed); both ranks' tokens equal; a requeued stream keeps
   the output it had.  Times, the bytes each call handed the collectives a
   rank, each rank's peak, tok/s and TTFT printed;
16. a ``kernels`` line, one JSON line of per-kernel numbers (the flash and
   ssm_scan launches count phases 13 and 15's ranks', and list phase 15's
   a leg and a rank at a time, ``launches_tp_ranks``), and the final
   ``{"ok": true, "device": ...}`` line.

Rates used for the bounds (NVIDIA H100 SXM data sheet): 3.35 TB/s HBM,
67 TFLOP/s fp32 outside the tensor cores, 989 TFLOP/s bf16 and fp16 dense on
them, 1,979 TFLOP/s (TOP/s) fp8 and int8.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BPS = 3.35e12
# a dependent fma.f32's latency in cycles: the paper's Tab 4.1 on Turing, assumed
# for Hopper (phase 4c's measured ns per fma checks it against the SM clock)
FMA_CYCLES = 4
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
FP8_FLOPS = 1979e12  # fp8 and int8 (TOP/s)
MATMUL_LP = {  # tensor-core instance: input dtype name, datasheet peak
    "matmul_bf16": ("bfloat16", BF16_FLOPS), "matmul_fp16": ("float16", BF16_FLOPS),
    "matmul_int8": ("int8", FP8_FLOPS), "matmul_fp8": ("float8_e4m3fn", FP8_FLOPS),
}
KERNELS = ("pchase", "stream_copy", "stream_reduce", "strided_reduce", "axpy", "matmul",
           *MATMUL_LP, "matmul_transpose", "flash_attention", "ssm_scan", "op_latency")
SOURCES = {
    "pchase": ("src/repro_torch/kernels/csrc/pchase.cu", "src/repro/kernels/pchase.py:22"),
    "stream_copy": ("src/repro_torch/kernels/csrc/membw.cu", "src/repro/kernels/membw.py:19"),
    "stream_reduce": ("src/repro_torch/kernels/csrc/membw.cu", "src/repro/kernels/membw.py:39"),
    "strided_reduce": ("src/repro_torch/kernels/csrc/membw.cu", "src/repro/kernels/membw.py:67"),
    "axpy": ("src/repro_torch/kernels/csrc/axpy.cu", "src/repro/kernels/axpy.py:16"),
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu", "src/repro/kernels/matmul.py:58"),
    **{k: ("src/repro_torch/kernels/csrc/matmul.cu", "src/repro/kernels/matmul.py:58")
       for k in (*MATMUL_LP, "matmul_transpose")},
    "op_latency": ("src/repro_torch/kernels/csrc/op_latency.cu",
                   "src/repro/core/probes.py:149"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:49"),
    "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu", "src/repro/kernels/ssm_scan.py:17"),
}
LM_BATCH, LM_PROMPT, LM_STEPS, LM_LONG = 4, 1000, 32, 2048
ZAMBA_STEPS = 16
LOSS_RTOL = 1e-3  # zamba2 loss against the plain path, relative; measured ~2e-5
# flash_attention's bf16 rows against the plain version's fp32 output:
# max over rows of ||got - want|| / ||want||; p's and the output's bf16
# roundings come to a few 1e-3
FLASH_ROW_RTOL = {"bfloat16": 1e-2, "float32": 1e-4}
# ssm_scan's bf16 rows against the plain version's fp32 output on the same
# bf16 inputs: y's own bf16 rounding measured 2.5e-3 (the kernel's error
# equal to it), so twice that
SSM_ROW_RTOL = 5e-3
# the same at a slow decay (-softplus(N(-5, 1))), where y's own bf16 rounding
# (row_rel_err_rounding_slow_decay) measured 2.571e-3 at chunk 256 and
# 2.621e-3 at chunk 512 on an H100, above the 2.5e-3 the rule above was set
# from: twice the larger
SSM_SLOW_ROW_RTOL = 2 * 2.621e-3
# fp16 inputs on the SIMT route (an fp32 state, as the reference's): one
# rounding of y to fp16, relative to max |y|, the card tests' fp16 limit
SSM_FP16_RTOL = 2e-3
# matmul's fp32 outputs, each row against the plain version's fp32 output:
# 16-bit inputs differ by the sum order (a few 1e-6 at K 4096); fp8 by the
# tensor cores' ~14-bit accumulation within each 128 of K (~1e-4, with the
# promotion to fp32 in between; the matmul_fp8 row of the run prints it).
# 16-bit outputs: twice the plain output's own rounding to that type,
# measured in the run.
MATMUL_F32_ROW_RTOL = {"bfloat16": 1e-5, "float16": 1e-5, "float8_e4m3fn": 5e-4}
MATMUL_SHAPES = ((2048, 2048, 2048), (4096, 4096, 4096), (300, 200, 100))
# each LM's causal prefill in the model layout, as its phase hands it to flash:
# B, S, H, Hkv, hd (internvl2-76b's S is its 256 frontend rows and 256 of text)
FLASH_MODEL_SHAPES = {"gemma-2b": (4, 1000, 8, 1, 256), "gemma-2b tp 2": (4, 1000, 4, 1, 256),
                      "zamba2-7b": (4, 1000, 32, 32, 112),
                      "zamba2-7b tp 2": (4, 1000, 16, 16, 112),
                      "olmoe-1b-7b": (4, 1000, 16, 16, 128),
                      "internvl2-76b": (2, 512, 64, 8, 128),
                      "internvl2-76b tp 2": (2, 512, 32, 4, 128),
                      # whisper-base's decoder self attention over its 32-token prompt
                      "whisper-base decoder": (4, 32, 8, 8, 64),
                      "whisper-base decoder tp 2": (4, 32, 4, 4, 64)}
# the flash row's keys of its other shapes, beside gemma-2b's (a "_tp2" key is
# one tp 2 rank's call, phases 13 and 15)
FLASH_SHAPE_SUFFIXES = ("_hd112", "_hd512", "_olmoe", "_internvl2", "_whisper_enc",
                        "_whisper_cross", "_whisper_dec", "_tp2")
MEMBW_SHAPE = (65536, 512)  # 128 MiB of fp32: the probes' largest footprint
# phase 4c: the paper's other suites, the kernels each registered variant must
# launch (exactly these; the [torch] variants and the rest launch none)
PAPER_SUITES = ("instr", "bandwidth", "axpy", "memhier", "scheduler", "atomics", "throttle")
SUITE_KERNELS = {
    "instr": {"op_latency"}, "bandwidth": {"stream_reduce", "axpy"},
    "bandwidth[cuda]": {"stream_reduce"}, "axpy": {"axpy"}, "axpy[cuda]": {"axpy"},
    "memhier": {"pchase"}, "memhier[cuda]": {"pchase"}, "scheduler": {"stream_reduce"},
    "scheduler[cuda]": {"stream_reduce"},
}
PORTED_SUITES = ("dissect", "gemm", *PAPER_SUITES)  # "gemm" takes gemm_lp and the variants
BASELINES = os.path.join(ROOT, "benchmarks", "baselines_torch")
GATE_PROBE = "oplat_fma.f32"  # the measured latency record doubled to show the gate fails
# the pointer chase past the 50 MB L2: footprints and steps (2^21 steps touch
# most of the 128 MiB array's 1 M 128-byte lines)
HBM_WALK_BYTES, HBM_WALK_STEPS = (128 << 20, 256 << 20), 1 << 21
AXPY_SWEEP_SHAPE = (32768, 2048)  # Fig 1.1's sweep: 256 MiB of fp32 an array
# phase 10: the serving engine at gemma-2b's full width
SERVE_REQUESTS, SERVE_SLOTS, SERVE_NEW, SERVE_CHUNK = 8, 4, 32, 128
SERVE_PROMPT_LENS, SERVE_PREFIX, SERVE_MAX_LEN, SERVE_PAGE = (200, 1000), 128, 1056, 16
# phase 11: the serving cluster at full width
CLUSTER_REPLICAS, CLUSTER_FAIL_AFTER = 2, 4  # replicas; ticks before leg 3 fails replica 1
CARD_HW = "nvidia-h100-sxm"
# phases 8b-8d: the MoE, VLM and encoder-decoder families
MOE_DENSE_TOKENS = 256  # moe_block against moe_block_dense, 1 x 256 tokens at layer 0
VLM_LAYERS, VLM_BATCH, VLM_TEXT, VLM_STEPS = 4, 2, 256, 8  # internvl2-76b cut from 80 layers
WHISPER_BATCH, WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_STEPS = 4, 1500, 32, 16
XLSTM_STEPS = 16  # phase 8e: greedy decode steps after the 4 x 1000 prefill
# phase 12: training
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 1024, 4, 1e-3  # (a): gemma-2b, whole
TRAIN_CPU_STEPS = 3  # (b): reduced float32, the card against the CPU
# (c): the example's resumed losses against its uninterrupted run; the card's
# embedding backward adds with atomics, so the two runs part by rounding only:
# 0.05 (1 % of the loss) catches a resume from the wrong step or a lost state
EXAMPLE_RESUME_ATOL = 0.05
TRAIN_LAUNCH_ARGV = ["--arch", "gemma-2b", "--steps", "2", "--batch", "2", "--seq", "512"]
# phase 13: the distribution layer, two ranks sharing the card over gloo
DIST_TIMEOUT = 900  # seconds a run of ranks may take before it fails the phase
ZERO_BATCH, ZERO_SEQ = 2, 512  # (b)'s global batch: one 512-token sequence a rank
ZERO_FREE_SHARE = 0.85  # of the card's free memory (b)'s two ranks may plan to fill
# (b)'s depth at most, leaving phase 14 its time; odd, so that ZeRO's ``data``
# falls on an inner dim of each stacked leaf (phase 14 (a)'s 18 put it on the
# layer dim): the all-gather and reduce-scatter of a layer's slices under remat
ZERO_MAX_LAYERS = 9
CARD_BYTES = 80e9  # the H100's memory, for (b)'s reckoning where no card is visible
# phase 14: training on (data 2, model 2), four ranks sharing the card over gloo
TP_TRAIN_MESH = (2, 2)  # (data, model)
TP_TRAIN_ARCHS = ("gemma-2b", "olmoe-1b-7b")  # (a), (b)
TP_TRAIN_BATCH, TP_TRAIN_SEQ = 4, 512  # the global batch of the one step
# the most layers (a) runs, cut for the script's time: 18 layers' step took
# 53.8-92.2 s over gloo on an H100; an even depth keeps ZeRO-3's `data` on
# the stacked leaves' layer dim (phase 13(b)'s odd depth puts it inside)
TP_TRAIN_MAX_LAYERS = {"gemma-2b": 10}
# a rank's CUDA context, outside the allocator's count: phase 14 measures it
# (``rank_context_gb``) and prints it beside this; 0.786 GB a rank on an
# H100 80GB HBM3 at 700 W, torch 2.11.0+cu128
RANK_CONTEXT_BYTES = 0.8e9
LAUNCH_ARGV = ["--arch", "gemma-2b", "--requests", "8", "--prompt-len", "64", "--max-new", "16",
               "--slots", "4", "--max-len", "256", "--prefill-chunk", "64", "--replicas", "2",
               "--health", "--chaos", "--chaos-seed", "7", "--page-size", "16",
               "--shared-prefix", "32"]


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one ``fn()`` over ``iters`` back-to-back calls,
    bracketed by CUDA events after ``warmup`` calls.  A spin kernel of 2^18
    cycles per call (about 130 us) runs first, so the host enqueues the calls while the
    device is busy and the bracket holds device work, not Python dispatch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(iters << 18)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def check_close(name, got, want, rtol, atol) -> float:
    err = max_abs_err(got, want)
    limit = atol + rtol * float(want.double().abs().max())
    if not (err <= limit and got.shape == want.shape):
        raise AssertionError(f"{name}: max |err| {err} > {limit} (rtol {rtol}, atol {atol})")
    return err


def row_rel_err(got, want) -> float:
    """The largest ||got - want|| / ||want|| over the rows of the last axis."""
    g, w = got.double(), want.double()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())


def check_rows(name, got, want, limit) -> float:
    """A limit on each row's relative error, where check_close's scales with
    the largest value of the whole output: a fault confined to rows whose
    values are small cannot hide under it."""
    err = row_rel_err(got, want)
    if not (err <= limit and got.shape == want.shape):
        raise AssertionError(f"{name}: max row ||err|| / ||want|| {err} > {limit}")
    return err


def kernel_checks(torch, dev) -> dict:
    """Phase 3: each kernel against its plain version at main-path shapes."""
    from repro_torch import hw
    from repro_torch.core.pchase import single_cycle_successors
    from repro_torch.kernels import ref
    from repro_torch.kernels.matmul import matmul_cuda
    from repro_torch.kernels.membw import stream_reduce
    from repro_torch.kernels.pchase import pchase_cuda, pchase_torch

    rows = {}
    gen = torch.Generator(device=dev).manual_seed(0)

    # pchase: the largest full-mode footprint (128 MiB, HBM-resident), full-mode steps
    n, steps = 1 << 25, 1 << 17
    t0 = time.perf_counter()
    perm = single_cycle_successors(n, 0, dev)
    torch.cuda.synchronize()
    print(f"Sattolo permutation of {n} entries on the card in {time.perf_counter() - t0:.1f} s")
    got = pchase_cuda(perm, steps)
    torch.cuda.synchronize()
    plain = pchase_torch(perm, steps)
    host = ref.pchase_ref(perm, steps)
    if int(got[0, 0]) != int(plain[0, 0]) or int(got[0, 0]) != host:
        raise AssertionError(f"pchase: kernel {int(got[0, 0])}, plain {int(plain[0, 0])}, host {host}")
    # spec-sheet latency of the level that holds what the walk touches: one
    # 32-byte sector per step, a single cycle, so min(steps, n) sectors
    touched = min(steps, n) * 32
    level = next(l for l in hw.get("h100").levels if l.size_bytes == 0 or touched <= l.size_bytes)
    rows["pchase"] = {
        "shape": f"perm ({n},) int32, steps {steps}", "tolerance": "exact",
        "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: pchase_cuda(perm, steps), 3, warmup=1),
        "plain_ms": time_ms(torch, lambda: pchase_torch(perm, steps), 1, warmup=1),
        "library_ms": None,
        "bound_ms": (min(steps, n) * 4 + 4) / HBM_BPS * 1e3, "bound_by": "bytes",
        "latency_bound_ms": steps * level.latency_ns * 1e-6, "latency_level": level.name,
    }
    del perm

    # stream_reduce: the largest full-mode footprint, (65536, 512) f32 = 128 MiB
    x = torch.rand((65536, 512), generator=gen, device=dev)
    err = check_close("stream_reduce", stream_reduce(x), ref.reduce_ref(x), 1e-4, 0.0)
    ones = torch.ones((4096, 512), device=dev)  # 8 MiB: every partial sum stays below 2^24
    if float(stream_reduce(ones)[0, 0]) != float(ones.numel()):
        raise AssertionError("stream_reduce: all-ones checksum is not exact")
    rows["stream_reduce"] = {
        "shape": "(65536, 512) float32", "tolerance": "rtol 1e-4; 8 MiB of ones exact",
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: stream_reduce(x), 20),
        "plain_ms": time_ms(torch, lambda: ref.reduce_ref(x), 20),
        "library_ms": time_ms(torch, lambda: torch.sum(x), 20),
        "bound_ms": (x.numel() * 4 + 4) / HBM_BPS * 1e3, "bound_by": "bytes",
    }
    del x, ones

    rows["axpy"] = axpy_checks(torch, dev, gen)

    # matmul: the largest full-mode size, fp32 with no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    nn = 2048
    a = torch.randn((nn, nn), generator=gen, device=dev) * 0.3
    b = torch.randn((nn, nn), generator=gen, device=dev) * 0.3
    err = check_close("matmul", matmul_cuda(a, b), ref.matmul_ref(a, b), 1e-4, 1e-4)
    rows["matmul"] = {
        "shape": "(2048, 2048) @ (2048, 2048) float32", "tolerance": "rtol 1e-4, atol 1e-4",
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: matmul_cuda(a, b), 10),
        "plain_ms": time_ms(torch, lambda: ref.matmul_ref(a, b), 10),
        "library_ms": time_ms(torch, lambda: torch.matmul(a, b), 10),
        "bound_ms": max(2 * nn**3 / FP32_FLOPS, 3 * nn * nn * 4 / HBM_BPS) * 1e3,
        "bound_by": "operations",
    }
    del a, b
    rows.update(matmul_lp_checks(torch, dev, gen))
    rows["stream_copy"] = copy_checks(torch, dev, gen)
    rows["strided_reduce"] = strided_checks(torch, dev, gen)
    rows["flash_attention"] = flash_checks(torch, dev, gen)
    rows["ssm_scan"] = ssm_checks(torch, dev, gen)
    rows["op_latency"] = op_latency_checks(torch, dev)
    for name, r in rows.items():
        print(f"check {name}: {r['shape']}; max_abs_err {r['max_abs_err']} ({r['tolerance']}); "
              f"kernel {r['ms']} ms, plain {r['plain_ms']} ms, library {r['library_ms']} ms, "
              f"bound {r['bound_ms']} ms ({r['bound_by']})", flush=True)
    print(f"check pchase latency chain at the datasheet's {rows['pchase']['latency_level']} "
          f"latency: {rows['pchase']['latency_bound_ms']} ms (spec-sheet figure)", flush=True)
    return rows


def matmul_operands(torch, dev, gen, dtype, m, k, n):
    """Seeded operands: int8 uniform over its range, the floats N(0, 1) (fp8
    N(0, 2), so an fp8 output holds NaNs past 448 beside numbers)."""
    if dtype == torch.int8:
        return [torch.randint(-128, 128, shape, generator=gen, device=dev, dtype=torch.int32)
                .to(dtype) for shape in ((m, k), (k, n))]
    scale = 2.0 if dtype == torch.float8_e4m3fn else 1.0
    return [(torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)
            for shape in ((m, k), (k, n))]


def matmul_agreement(torch, name, got, a, b, out) -> dict:
    """``got`` (a @ b into ``out``) against the plain version: int outputs
    exact, saturation included; fp8 NaN at the same places away from the
    line of 464 (where the two fp32 sums may round either way) and within
    fp8's rounding elsewhere; the floats row by row against the plain fp32
    output (check_rows; limits at MATMUL_F32_ROW_RTOL)."""
    from repro_torch.kernels import ref

    want = ref.matmul_ref(a, b, out)
    if out in (torch.int32, torch.int8) or a.dtype == torch.int8:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: {int((got != want).sum())} entries differ from the "
                                 f"plain version's (exact expected)")
        return {"max_abs_err": 0.0}
    want32 = ref.matmul_ref(a, b, torch.float32)
    if out == torch.float8_e4m3fn:
        sure = (want32.abs() - ref.FP8_E4M3_NAN_PAST).abs() > 1e-3 * ref.FP8_E4M3_NAN_PAST
        gf, wf = got.float(), want.float()
        if not torch.equal(torch.isnan(gf)[sure], torch.isnan(wf)[sure]):
            raise AssertionError(f"{name}: NaN at other places than the plain version's")
        fin = ~torch.isnan(gf) & ~torch.isnan(wf)
        err = check_close(name, gf[fin], wf[fin], 0.125, 0.125)
        return {"max_abs_err": err, "nan_share": float(torch.isnan(gf).float().mean())}
    dt = str(a.dtype).removeprefix("torch.")
    limit = (MATMUL_F32_ROW_RTOL[dt] if out == torch.float32
             else 2 * row_rel_err(want32.to(out), want32))
    return {"max_abs_err": max_abs_err(got, want), "row_rel_err": check_rows(name, got, want32,
                                                                              limit),
            "row_rel_limit": limit}


def matmul_lp_checks(torch, dev, gen) -> dict:
    """The tensor-core matmul instances: each (input, output) pair the gemm
    suites run (into fp32, int32 for int8) and the default outputs (the input
    type: int8 saturating, fp8 NaN past 448) at 2048^3, 4096^3 and 300 x 200
    x 100, against the plain version; then each instance timed at 2048^3 and
    4096^3 beside the plain version, the library call (torch.matmul for
    bf16/fp16, torch._int_mm, torch._scaled_mm with unit scales and B handed
    over column-major, made untimed) and the bound, and the 8-bit B
    transpose on its own."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.matmul import matmul_cuda, transpose8

    rows, transpose = {}, {}
    for kernel, (dt_name, peak) in MATMUL_LP.items():
        dtype = getattr(torch, dt_name)
        acc = torch.int32 if dtype == torch.int8 else torch.float32
        outs = (acc, dtype) + ((torch.bfloat16,) if dtype == torch.float8_e4m3fn else ())
        errs = {}
        for m, k, n in MATMUL_SHAPES:
            a, b = matmul_operands(torch, dev, gen, dtype, m, k, n)
            for out in outs:
                key = f"{str(out).removeprefix('torch.')}_{m}x{k}x{n}"
                errs[key] = matmul_agreement(
                    torch, f"{kernel} -> {out} at {m}x{k}x{n}",
                    matmul_cuda(a, b, out_dtype=out), a, b, out)
            if m not in (2048, 4096):
                continue
            es, oes = dtype.itemsize, acc.itemsize
            flops, nbytes = 2 * m * n * k, (m * k + k * n) * es + m * n * oes
            bound_ms, bound_by = bound(flops, nbytes, peak)
            if dtype == torch.int8:
                def library(a=a, b=b):
                    return torch._int_mm(a, b)
            elif dtype == torch.float8_e4m3fn:
                one, b_cols = torch.ones((), device=dev), b.t().contiguous().t()

                def library(a=a, b_cols=b_cols, one=one):
                    return torch._scaled_mm(a, b_cols, scale_a=one, scale_b=one,
                                            out_dtype=torch.float32)
            else:
                def library(a=a, b=b):
                    return torch.matmul(a, b)
            ms = time_ms(torch, lambda a=a, b=b: matmul_cuda(a, b, out_dtype=acc), 10)
            times = {"ms": ms, "tflops": flops / ms * 1e-9,
                     "library_ms": time_ms(torch, library, 10),
                     "bound_ms": bound_ms, "bound_by": bound_by}
            if m == 2048:
                times["plain_ms"] = time_ms(torch, lambda a=a, b=b: ref.matmul_ref(a, b, acc), 5)
            if dtype.itemsize == 1:  # the B^T pass, inside the timed call above
                times["transpose_ms"] = time_ms(torch, lambda b=b: transpose8(b), 10)
                if dtype == torch.int8:
                    tbytes = 2 * k * n
                    transpose[m] = {
                        "ms": times["transpose_ms"],
                        "plain_ms": time_ms(torch, lambda b=b: ref.transpose8_ref(b, k), 10),
                        "library_ms": time_ms(torch, lambda b=b: b.t().contiguous(), 10),
                        "bound_ms": tbytes / HBM_BPS * 1e3}
            if m == 4096:
                rows[kernel].update({f"{key}_4096": v for key, v in times.items()})
            else:
                rows[kernel] = {
                    "shape": f"(2048, 2048) @ (2048, 2048) {dt_name} -> {acc}".replace(
                        "torch.", ""), **times}
            del a, b
        rows[kernel].update({
            "tolerance": "int8: exact (int32 and saturating int8 outputs); floats: each row's "
                         "||err|| / ||want|| against the plain fp32 output within "
                         "MATMUL_F32_ROW_RTOL (fp32 out) or twice the plain output's own "
                         "rounding (16-bit out); fp8 out: NaN where the plain version's is, "
                         "away from 464, else rtol/atol 0.125; at 2048^3, 4096^3, 300x200x100",
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "row_rel_err": max((e.get("row_rel_err", 0.0) for e in errs.values()), default=0.0),
            "agreement": errs,
        })
        print(f"check {kernel}: {rows[kernel]}", flush=True)
    rows["matmul_transpose"] = {
        "shape": "int8 B (2048, 2048) -> B^T (2048, 2048)", "tolerance": "exact",
        "max_abs_err": 0.0, **transpose[2048], "bound_by": "bytes",
        **{f"{k}_4096": v for k, v in transpose[4096].items()},
    }
    for k, n in ((2048, 2048), (100, 200), (7, 33)):
        b = matmul_operands(torch, dev, gen, torch.int8, 1, k, n)[1]
        if not torch.equal(transpose8(b), ref.transpose8_ref(b, -(-k // 16) * 16)):
            raise AssertionError(f"matmul_transpose: B^T of ({k}, {n}) differs from the plain "
                                 f"version's")
    return rows


def axpy_checks(torch, dev, gen) -> dict:
    """axpy: one unroll at every access width (axpy_geometry, at the probe's
    and the sweep's shapes, and the built kernel's); the probe's 1 MiB footprint at its middle tile
    width with 16-byte accesses, timed; tiles of an odd number of vectors
    (never a multiple of the unroll; 4503 take a second, partial round) at
    every width in f32 and bf16; and Fig 1.1's sweep shape, (32768, 2048)
    f32 = 256 MiB an array in (8, 2048) tiles, at 4, 8 and 16 bytes, each
    timed beside ``torch.add`` at the same shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.axpy import VEC_BYTES, axpy_cuda, axpy_geometry, kernel_unroll

    unrolls = {(shape, vb): axpy_geometry(shape, 8, cols, vb, 4).unroll
               for shape, cols in (((512, 512), 512), (AXPY_SWEEP_SHAPE, AXPY_SWEEP_SHAPE[1]))
               for vb in VEC_BYTES}
    unrolls.update({("kernel", vb): kernel_unroll(vb) for vb in VEC_BYTES})
    if len(set(unrolls.values())) != 1:
        raise AssertionError(f"axpy: the unroll differs across widths (axpy_geometry at the "
                             f"probe's and the sweep's shapes, and the kernel's own): {unrolls}")
    x = torch.randn((512, 512), generator=gen, device=dev)
    y = torch.randn((512, 512), generator=gen, device=dev)
    err = check_close("axpy", axpy_cuda(x, y, 2.0), ref.axpy_ref(x, y, 2.0), 1e-5, 1e-5)
    xb, yb = x.bfloat16(), y.bfloat16()
    check_close("axpy bf16", axpy_cuda(xb, yb, 2.0), ref.axpy_ref(xb, yb, 2.0), 2e-2, 2e-2)
    row = {
        "shape": "(512, 512) float32, tile (8, 512), 16-byte accesses",
        "tolerance": "rtol 1e-5, atol 1e-5 (bf16: 2e-2)", "max_abs_err": err,
        "ms": time_ms(torch, lambda: axpy_cuda(x, y, 2.0), 200),
        "plain_ms": time_ms(torch, lambda: ref.axpy_ref(x, y, 2.0), 200),
        "library_ms": time_ms(torch, lambda: torch.add(y, x, alpha=2.0), 200),
        "bound_ms": 3 * x.numel() * 4 / HBM_BPS * 1e3, "bound_by": "bytes",
    }
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        item = torch.tensor([], dtype=dtype).element_size()
        for vb in VEC_BYTES:
            for row_vecs, block_rows in ((13, 3), (1501, 3)):
                cols = row_vecs * vb // item
                xe, ye = (torch.randn((2 * block_rows, 2 * cols), generator=gen, device=dev)
                          .to(dtype) for _ in range(2))
                check_close(f"axpy {dtype} tile ({block_rows}, {cols}), {vb}-byte accesses",
                            axpy_cuda(xe, ye, 2.0, block_rows=block_rows, block_cols=cols,
                                      vec_bytes=vb), ref.axpy_ref(xe, ye, 2.0), tol, tol)
    del x, y, xb, yb
    x = torch.randn(AXPY_SWEEP_SHAPE, generator=gen, device=dev)
    y = torch.randn(AXPY_SWEEP_SHAPE, generator=gen, device=dev)
    nbytes = 3 * x.numel() * 4
    library_ms = time_ms(torch, lambda: torch.add(y, x, alpha=2.0), 20)
    sweep = []
    for vb in VEC_BYTES:
        def run(vb=vb):
            return axpy_cuda(x, y, 2.0, block_cols=AXPY_SWEEP_SHAPE[1], vec_bytes=vb)

        e = check_close(f"axpy sweep {vb}-byte accesses", run(), ref.axpy_ref(x, y, 2.0),
                        1e-5, 1e-5)
        ms = time_ms(torch, run, 20)
        sweep.append({"vec_bytes": vb, "max_abs_err": e, "ms": ms, "gbps": nbytes / ms * 1e-6,
                      "bound_ms": nbytes / HBM_BPS * 1e3, "library_ms": library_ms})
    row["sweep_256mib"] = sweep
    print(f"check axpy Fig 1.1 sweep, {AXPY_SWEEP_SHAPE} f32, tile (8, 2048): {sweep}", flush=True)
    return row


def copy_checks(torch, dev, gen) -> dict:
    """stream_copy bit for bit in f32, bf16 and int32 at the probes' largest
    footprint, and at the edges of its rounds (below one, whole ones, 16
    bytes more, a tail of fewer than 16 bytes), timed at 128 MiB."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.membw import COPY_ROUND_BYTES, stream_copy

    x = torch.rand(MEMBW_SHAPE, generator=gen, device=dev)
    for xd in (x, (x * 1000).bfloat16(), (x * 1000).int()):
        if not torch.equal(stream_copy(xd), xd):
            raise AssertionError(f"stream_copy {xd.dtype}: the copy is not bit for bit")
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        item = torch.tensor([], dtype=dtype).element_size()
        for nbytes in (COPY_ROUND_BYTES - 48, 300 * COPY_ROUND_BYTES,
                       300 * COPY_ROUND_BYTES + 16, 300 * COPY_ROUND_BYTES + 16 - item):
            xe = (torch.rand((1, nbytes // item), generator=gen, device=dev) * 1000).to(dtype)
            if not torch.equal(stream_copy(xe, block_rows=1, block_cols=xe.shape[1]), xe):
                raise AssertionError(f"stream_copy {dtype} of {nbytes} bytes: not bit for bit")
    nbytes = x.numel() * 4
    return {
        "shape": "(65536, 512) float32, 128 MiB",
        "tolerance": "exact (f32, bf16, int32; also below one round, at 300 rounds and 16 bytes "
                     "and a short tail past them)", "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: stream_copy(x), 20),
        "plain_ms": time_ms(torch, lambda: ref.copy_ref(x), 20),
        "library_ms": time_ms(torch, lambda: x.clone(), 20),
        "bound_ms": 2 * nbytes / HBM_BPS * 1e3, "bound_by": "bytes",
    }


def strided_checks(torch, dev, gen) -> dict:
    """strided_reduce at the probes' largest footprint."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.membw import strided_reduce

    x = torch.rand(MEMBW_SHAPE, generator=gen, device=dev)
    errs, per_stride = [], {}
    for stride in (2, 3, 128):
        want = ref.strided_reduce_blocked_ref(x, stride, 64)
        errs.append(check_close(f"strided_reduce stride {stride}",
                                strided_reduce(x, stride=stride), want, 1e-4, 0.0))
        sel_rows = MEMBW_SHAPE[0] // 64 * -(-64 // stride)
        per_stride[stride] = {
            "ms": time_ms(torch, lambda s=stride: strided_reduce(x, stride=s), 20),
            "plain_ms": time_ms(torch, lambda s=stride: ref.strided_reduce_blocked_ref(x, s, 64), 20),
            "library_ms": (time_ms(torch, lambda s=stride: x[::s].sum(), 20)
                           if 64 % stride == 0 else None),
            "bound_ms": (sel_rows * MEMBW_SHAPE[1] * 4 + 4) / HBM_BPS * 1e3,
        }
        print(f"check strided_reduce stride {stride}: {per_stride[stride]}", flush=True)
    return {
        "shape": "(65536, 512) float32, block_rows 64, stride 2 (also 3, 128)",
        "tolerance": "rtol 1e-4 against the blocked plain version", "max_abs_err": max(errs),
        **per_stride[2], "bound_by": "bytes",
    }


def bound(flops: float, nbytes: float, peak: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over HBM and operations over ``peak``."""
    by_ops, by_bytes = flops / peak * 1e3, nbytes / HBM_BPS * 1e3
    return max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes"


def flash_model_case(torch, dev, gen, heads, kv_heads, hd, b=LM_BATCH, s=LM_PROMPT) -> tuple:
    """One bf16 causal case in the model layout, by default at the LMs'
    batch and prompt, q (b, s, heads, hd) and k/v (b, s, kv_heads, hd): the
    operands, their head-expanded (BH, S, hd) copies that the plain version
    takes, the kernel's output in that layout, and the plain version's fp32
    output."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_model

    q = torch.randn((b, s, heads, hd), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, s, kv_heads, hd), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    flat = [t.repeat_interleave(heads // t.shape[2], 2).permute(0, 2, 1, 3)
            .reshape(-1, s, hd).contiguous() for t in (q, k, v)]
    got = flash_attention_model(q, k, v, causal=True).permute(0, 2, 1, 3).reshape(-1, s, hd)
    want32 = ref.flash_attention_ref(*(t.float() for t in flat), causal=True)
    return (q, k, v), flat, got, want32


def flash_agreement(name, got, want32, tol) -> dict:
    """``got`` against the plain version: within ``tol`` of its output in
    ``got``'s dtype (check_close), and row by row within FLASH_ROW_RTOL of
    its fp32 output; ``row_rel_err_rounding`` is what rounding that fp32
    output to ``got``'s dtype alone gives."""
    want = want32.to(got.dtype)
    rtol = FLASH_ROW_RTOL[str(got.dtype).removeprefix("torch.")]
    return {"max_abs_err": check_close(name, got.float(), want.float(), tol, tol),
            "row_rel_err": check_rows(name, got, want32, rtol),
            "row_rel_err_rounding": row_rel_err(want, want32)}


def flash_checks(torch, dev, gen) -> dict:
    """flash_attention at the LMs' shapes (FLASH_MODEL_SHAPES), bf16,
    causal, in the model layout the LMs hand it: gemma-2b's q (4, 1000, 8,
    256) over one KV head (native GQA) and one tp 2 rank's half of its heads,
    zamba2-7b's q (4, 1000, 32, 112) at
    its native head width, and the hd-128 instance at olmoe-1b-7b's q (4,
    1000, 16, 128) and internvl2-76b's q (2, 512, 64, 128) over 8 KV heads;
    each against its plain version and timed beside it and SDPA.
    Whisper's non-causal shapes at hd 64: the encoder's 1500 frames and
    the cross attention's 32 queries over them; and its decoder's causal
    self attention over the 32-token prompt (one 128-key tile, masked), at
    8 heads and a tp 2 rank's 4.  Also the head-flattened
    entry point: bf16 at gemma's prompt of 2048
    (bq 128, bk 1024) and fp32 at S 256 on the FP32-pipe kernel."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_model

    def check_flat(dtype, s, bq, bk, tol, bh=32, hd=256):
        sq_pad = -(-s // bq) * bq
        q, k, v = [torch.randn((bh, n, hd), generator=gen, device=dev).to(dtype)
                   for n in (sq_pad, s, s)]
        got = flash_attention_cuda(q, k, v, causal=True, bq=bq, bk=bk, kv_len=s)
        want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=True, kv_len=s)
        return flash_agreement(f"flash_attention {dtype} S {s} hd {hd}", got[:, :s],
                               want32[:, :s], tol)

    def model_layout(arch):
        """The kernel on (B, S, H, hd) q and (B, S, Hkv, hd) k/v; the plain
        version and SDPA get the expanded heads, made untimed."""
        b, s, heads, kv_heads, hd = FLASH_MODEL_SHAPES[arch]
        (q, k, v), flat, got, want32 = flash_model_case(torch, dev, gen, heads, kv_heads, hd,
                                                        b, s)
        errs = flash_agreement(f"flash_attention bf16 at {arch}'s q {tuple(q.shape)} "
                               f"k/v {tuple(k.shape)}", got, want32, 2e-2)
        del got, want32
        q4, k4, v4 = (t.view(b, heads, s, hd) for t in flat)  # SDPA's (B, H, S, hd)
        flops = 2 * b * heads * s * s * hd  # causal: half of the two full products
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())  # KV heads read once
        bound_ms, bound_by = bound(flops, nbytes, BF16_FLOPS)
        ms = time_ms(torch, lambda: flash_attention_model(q, k, v, causal=True), 20)
        return {
            **errs, "shape": f"q {tuple(q.shape)}, k/v {tuple(k.shape)} bf16 causal",
            "ms": ms, "tflops": flops / ms * 1e-9,
            "plain_ms": time_ms(torch, lambda: ref.flash_attention_ref(*flat, causal=True), 5),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True), 20),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }

    def wide(s=2048, heads=8, hd=512):
        """Past hd 256 (the SIMT wide kernel): q, k, v (1, s, heads, hd) bf16
        causal in the model layout, against the plain version and timed beside
        it and SDPA, with the SDPA backend the dispatcher picks."""
        q, k, v = (torch.randn((1, s, heads, hd), generator=gen, device=dev).bfloat16()
                   for _ in range(3))
        flat = [t.permute(0, 2, 1, 3).reshape(heads, s, hd).contiguous() for t in (q, k, v)]
        got = flash_attention_model(q, k, v, causal=True).permute(0, 2, 1, 3).reshape(heads, s, hd)
        want32 = ref.flash_attention_ref(*(t.float() for t in flat), causal=True)
        errs = flash_agreement(f"flash_attention bf16 hd {hd}", got, want32, 2e-2)
        del got, want32
        q4, k4, v4 = (t.view(1, heads, s, hd) for t in flat)
        try:
            from torch.nn.attention import SDPBackend

            backend = SDPBackend(torch._fused_sdp_choice(q4, k4, v4, None, 0.0, True)).name
        except (AttributeError, TypeError, ValueError, RuntimeError) as e:
            backend = f"not known ({type(e).__name__})"
        bound_ms, bound_by = bound(2 * heads * s * s * hd, 2 * 4 * q.numel(), BF16_FLOPS)
        return {**errs, "shape": f"q, k, v (1, {s}, {heads}, {hd}) bf16 causal",
                "ms": time_ms(torch, lambda: flash_attention_model(q, k, v, causal=True), 5),
                "plain_ms": time_ms(torch, lambda: ref.flash_attention_ref(*flat, causal=True), 3),
                "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True), 5),
                "sdpa_backend": backend, "bound_ms": bound_ms, "bound_by": bound_by}

    def whisper(sq, h=8):
        """whisper-base's non-causal shapes at hd 64 over ``h`` heads (8, or
        a tp 2 rank's 4): q (4, sq, h, 64) against k/v (4, 1500, h, 64), the
        encoder's self attention (sq 1500) or the decoder's cross attention
        (sq 32, under one 128-row q tile); 1500 is not a multiple of the
        128-key tile.  Against the plain version, timed beside it and SDPA."""
        b, hd = WHISPER_BATCH, 64
        skv = WHISPER_FRAMES
        q = torch.randn((b, sq, h, hd), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((b, skv, h, hd), generator=gen, device=dev).bfloat16()
                for _ in range(2))
        qf, kf, vf = (t.permute(0, 2, 1, 3).reshape(-1, t.shape[1], hd).contiguous()
                      for t in (q, k, v))
        got = flash_attention_model(q, k, v, causal=False).permute(0, 2, 1, 3).reshape(-1, sq, hd)
        want32 = ref.flash_attention_ref(qf.float(), kf.float(), vf.float(), causal=False)
        errs = flash_agreement(f"flash_attention bf16 non-causal q {tuple(q.shape)} "
                               f"k/v {tuple(k.shape)}", got, want32, 2e-2)
        del got, want32
        q4, k4, v4 = (t.view(b, h, -1, hd) for t in (qf, kf, vf))
        flops = 4 * b * h * sq * skv * hd  # non-causal: the two full products
        bound_ms, bound_by = bound(flops, 2 * (2 * q.numel() + k.numel() + v.numel()), BF16_FLOPS)
        return {**errs, "shape": f"q {tuple(q.shape)}, k/v {tuple(k.shape)} bf16 non-causal",
                "ms": time_ms(torch, lambda: flash_attention_model(q, k, v, causal=False), 20),
                "plain_ms": time_ms(torch, lambda: ref.flash_attention_ref(qf, kf, vf,
                                                                           causal=False), 5),
                "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q4, k4, v4), 20),
                "bound_ms": bound_ms, "bound_by": bound_by, "tflops": flops / 1e9}

    enc = whisper(WHISPER_FRAMES)
    print(f"check flash_attention at whisper-base's encoder: {enc}", flush=True)
    cross = whisper(WHISPER_PROMPT)
    print(f"check flash_attention at whisper-base's cross attention: {cross}", flush=True)
    for r in (enc, cross):
        r["tflops"] /= r["ms"]
    dec = model_layout("whisper-base decoder")
    print(f"check flash_attention at whisper-base's decoder self attention: {dec}", flush=True)
    hd512 = wide()
    print(f"check flash_attention past hd 256: {hd512}", flush=True)
    flat32 = check_flat(torch.float32, 256, 128, 256, 1e-4)
    flat2k = check_flat(torch.bfloat16, 2048, 128, 1024, 2e-2)
    print(f"check flash_attention head-flattened: fp32 S 256 {flat32}, bf16 S 2048 {flat2k}",
          flush=True)
    hd112 = model_layout("zamba2-7b")
    print(f"check flash_attention at zamba2-7b's q (4, 1000, 32, 112) bf16: {hd112}", flush=True)
    olmoe = model_layout("olmoe-1b-7b")
    print(f"check flash_attention at olmoe-1b-7b's q (4, 1000, 16, 128) bf16: {olmoe}", flush=True)
    internvl2 = model_layout("internvl2-76b")
    print(f"check flash_attention at internvl2-76b's q (2, 512, 64, 128) over 8 KV heads bf16: "
          f"{internvl2}", flush=True)
    tp2 = model_layout("gemma-2b tp 2")
    print(f"check flash_attention at a gemma-2b tp 2 rank's q (4, 1000, 4, 256) bf16: {tp2}",
          flush=True)
    # phase 15's per-rank shapes: each tp 2 rank holds half the heads
    rank = {"hd112_tp2": model_layout("zamba2-7b tp 2"),
            "internvl2_tp2": model_layout("internvl2-76b tp 2"),
            "whisper_enc_tp2": whisper(WHISPER_FRAMES, 4),
            "whisper_cross_tp2": whisper(WHISPER_PROMPT, 4),
            "whisper_dec_tp2": model_layout("whisper-base decoder tp 2")}
    for r in rank["whisper_enc_tp2"], rank["whisper_cross_tp2"]:
        r["tflops"] /= r["ms"]
    print(f"check flash_attention at a tp 2 rank's shapes (zamba2-7b q (4, 1000, 16, 112), "
          f"internvl2-76b q (2, 512, 32, 128) over 4 KV heads, whisper-base's at 4 heads, "
          f"its decoder's causal q, k, v (4, 32, 4, 64)): "
          f"{rank}", flush=True)
    row = {
        "shape": "q (4, 1000, 8, 256) bf16 causal, k/v (4, 1000, 1, 256): model layout, "
                 "native GQA",
        "tolerance": "bf16 rtol 2e-2, atol 2e-2 and each row's ||err|| / ||want|| within 1e-2 "
                     "of the fp32 plain output, at S 1000 (hd 256 over one KV head, hd 112, hd "
                     "128), at S 512 (hd 128, 64 heads over 8) and 2048, at hd 512 (S 2048, "
                     "the wide kernel), non-causal at hd 64 (Sq 1500 and 32 over 1500 "
                     "keys) and causal at hd 64, S 32; fp32 1e-4 (rows 1e-4) at S 256",
        "max_abs_err_bf16_s2048": flat2k["max_abs_err"],
        "row_rel_err_bf16_s2048": flat2k["row_rel_err"],
        "max_abs_err_fp32_s256": flat32["max_abs_err"],
        **model_layout("gemma-2b"),
        **{f"{k}_hd112": v for k, v in hd112.items()},
        **{f"{k}_hd512": v for k, v in hd512.items()},
        **{f"{k}_olmoe": v for k, v in olmoe.items()},
        **{f"{k}_internvl2": v for k, v in internvl2.items()},
        **{f"{k}_whisper_enc": v for k, v in enc.items()},
        **{f"{k}_whisper_cross": v for k, v in cross.items()},
        **{f"{k}_whisper_dec": v for k, v in dec.items()},
        **{f"{k}_tp2": v for k, v in tp2.items()},
        **{f"{k}_{shape}": v for shape, r in rank.items() for k, v in r.items()},
    }
    print(f"check flash_attention at gemma-2b's q (4, 1000, 8, 256) bf16: "
          f"{ {k: v for k, v in row.items() if not k.endswith(FLASH_SHAPE_SUFFIXES)} }",
          flush=True)
    return row


SSM_SHAPE = (LM_BATCH, 1024, 112, 64, 64)  # zamba2-7b's (B, S padded to the chunk, H, P, N)


def ssm_inputs(torch, dev, gen, dtype, steps=SSM_SHAPE[1], shift=0.0):
    """u (B, steps, H, P) and head-shared b/c (B, steps, N) ~ N(0, 0.25) in
    ``dtype``; a_log (B, steps, H) fp32 = -softplus(N(shift, 1))."""
    import torch.nn.functional as F

    bsz, _, h, p, n = SSM_SHAPE
    a = -F.softplus(torch.randn((bsz, steps, h), generator=gen, device=dev) + shift)
    u = (torch.randn((bsz, steps, h, p), generator=gen, device=dev) * 0.5).to(dtype)
    b, c = ((torch.randn((bsz, steps, n), generator=gen, device=dev) * 0.5).to(dtype)
            for _ in range(2))
    return u, a, b, c


def ssm_fp16_state_inputs(torch, dev, gen):
    """fp16 inputs at SSM_SHAPE whose state passes fp16's 65,504 while y stays
    inside it: u ~ 100, B ~ 30, C ~ 1e-3 (each within 10 %) at a slow,
    constant decay of 0.01 a step (the state settles near 3e5, y near 2e4)."""
    bsz, s, h, p, n = SSM_SHAPE

    def around(v, shape):
        return (v * (1 + 0.1 * torch.randn(shape, generator=gen, device=dev))).half()

    u, b, c = around(100.0, (bsz, s, h, p)), around(30.0, (bsz, s, n)), around(1e-3, (bsz, s, n))
    return u, torch.full((bsz, s, h), -0.01, device=dev), b, c


def ssm_plain(scan, *args):
    """A plain scan of kernels.ref on the model layout's (u, a_log, b, c)."""
    from repro_torch.kernels import _util

    return _util.unflatten_heads(scan(*_util.flatten_ssm(*args[:4]), *args[4:]), args[0].shape[0])


def ssm_bf16_case(torch, dev, gen, chunk=256, shift=0.0) -> tuple:
    """The bf16 scan at zamba2-7b's shape, at the init's decay (``shift`` 0)
    or a slow one (-5): the inputs, the kernel's y, and the plain version's y
    in bf16 and in fp32 (on the same bf16 inputs)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda

    u, a, b, c = ssm_inputs(torch, dev, gen, torch.bfloat16, shift=shift)
    got = ssm_scan_cuda(u, a, b, c, chunk=chunk)
    want = ssm_plain(ref.ssm_scan_chunked_ref, u, a, b, c, chunk)
    want32 = ssm_plain(ref.ssm_scan_chunked_ref, u.float(), a, b.float(), c.float(), chunk)
    return (u, a, b, c), got, want, want32


def ssm_flops(chunk: int) -> int:
    """The causal work of the scan at SSM_SHAPE: the (t, s <= t) pairs of the
    score and W u products, and the state's two products, per chunk."""
    bsz, s, h, p, n = SSM_SHAPE
    causal = chunk * (chunk + 1) // 2
    return bsz * h * (s // chunk) * (2 * causal * (n + p) + 4 * chunk * p * n)


def ssm_pass_checks(torch, u, a, b, c, chunk) -> dict:
    """The wgmma route's three passes at zamba2-7b's shape, each on its plain
    version's inputs: the chunk states within 1e-4 of their max (sdecay B
    enters as a hi + lo pair of bf16 values) and acum within 1e-5, the
    passed states within 1e-5 (the same fp32 recurrence), the outputs'
    rows within SSM_ROW_RTOL of the plain fp32 output; and each pass timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ssd

    states, acum = ssd.ssd_chunk_states_cuda(u, a, b, chunk=chunk)
    want_states, want_acum = ref.ssd_chunk_states(u, a, b, chunk)
    errs = {"acum": check_close(f"ssm pass 1 acum, chunk {chunk}", acum, want_acum, 1e-5, 0.0),
            "states": check_close(f"ssm pass 1 states, chunk {chunk}", states, want_states,
                                  1e-4, 0.0)}
    entering = ssd.ssd_pass_states_cuda(want_states.clone(), want_acum, chunk=chunk)
    want_entering, _ = ref.ssd_pass_states(want_states, want_acum, chunk)
    errs["entering"] = check_close(f"ssm pass 2, chunk {chunk}", entering, want_entering,
                                   1e-5, 0.0)
    got = ssd.ssd_chunk_outputs_cuda(u, b, c, want_entering, want_acum, chunk=chunk)
    want = ref.ssd_chunk_outputs(u, b, c, want_entering, want_acum, chunk)
    errs["outputs_row_rel_err"] = check_rows(f"ssm pass 3, chunk {chunk}", got, want,
                                             SSM_ROW_RTOL)
    del want_states, want_entering, got, want
    spare = states.clone()  # pass 2 rewrites its input: time it on a copy
    return {"max_abs_err": errs, "ms": {
        "chunk_states": time_ms(torch, lambda: ssd.ssd_chunk_states_cuda(u, a, b, chunk=chunk),
                                10),
        "pass_states": time_ms(torch, lambda: ssd.ssd_pass_states_cuda(spare, acum, chunk=chunk),
                               10),
        "chunk_outputs": time_ms(torch, lambda: ssd.ssd_chunk_outputs_cuda(
            u, b, c, entering, acum, chunk=chunk), 10)}}


def ssm_checks(torch, dev, gen) -> dict:
    """ssm_scan at zamba2-7b's main-path shape: u (4, 1024, 112, 64) (S 1000
    padded to the chunk), a_log (4, 1024, 112) f32 at the init's decay
    (-softplus of a unit normal, ~0.8 a step), head-shared B/C (4, 1024, 64),
    chunk 256.  bf16 on the wgmma route: rtol/atol 2e-2 (one rounding of y)
    and each row's ||err|| / ||want|| within SSM_ROW_RTOL of the fp32 plain
    output, then the rows again at a slow decay (-softplus(N(-5, 1)), ~0.007
    a step, where the state passed between the 4 chunks and the key tiles far
    below the diagonal decide y; at the init's decay they add ~0) at chunks
    256 and 512 (the autotuner's pick) within SSM_SLOW_ROW_RTOL, and each
    pass against its plain version.  fp32 on the SIMT route (1e-4: sum
    order) against the chunked plain version at both decays, at chunk 512
    too, and at S 256 against the sequential recurrence.  fp16 on the SIMT
    route with a state past fp16's range and y inside it, against the fp32
    plain version (SSM_FP16_RTOL), and timed.  Tolerances but the row
    checks' are relative to max |y|."""
    from repro_torch.kernels import _util, ref
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda

    bsz, s, h, p, n = SSM_SHAPE
    chunk = 256
    _util.reset_launch_counts()
    ins = ssm_inputs(torch, dev, gen, torch.float32)
    err32 = check_close("ssm_scan fp32", ssm_scan_cuda(*ins, chunk=chunk),
                        ssm_plain(ref.ssm_scan_chunked_ref, *ins, chunk), 1e-4, 1e-4)
    ins = ssm_inputs(torch, dev, gen, torch.float32, shift=-5.0)
    err32_slow = check_close("ssm_scan fp32 at a slow decay", ssm_scan_cuda(*ins, chunk=chunk),
                             ssm_plain(ref.ssm_scan_chunked_ref, *ins, chunk), 1e-4, 1e-4)
    err32_512 = check_close("ssm_scan fp32 at a slow decay, chunk 512",
                            ssm_scan_cuda(*ins, chunk=512),
                            ssm_plain(ref.ssm_scan_chunked_ref, *ins, 512), 1e-4, 1e-4)
    ins = ssm_inputs(torch, dev, gen, torch.float32, 256)
    err_seq = check_close("ssm_scan fp32 S 256 vs the sequential recurrence",
                          ssm_scan_cuda(*ins, chunk=chunk), ssm_plain(ref.ssm_scan_ref, *ins),
                          1e-4, 1e-4)
    del ins
    slow = {}
    for ch in (256, 512):
        _, got, _, want32 = ssm_bf16_case(torch, dev, gen, ch, shift=-5.0)
        slow[ch] = {"row_rel_err": check_rows(f"ssm_scan bf16 at a slow decay, chunk {ch}",
                                              got, want32, SSM_SLOW_ROW_RTOL),
                    "row_rel_err_rounding": row_rel_err(want32.bfloat16(), want32)}
        del got, want32
    (u, a, b, c), got, want, want32 = ssm_bf16_case(torch, dev, gen, chunk)
    err = check_close("ssm_scan bf16", got.float(), want.float(), 2e-2, 2e-2)
    row_err = check_rows("ssm_scan bf16", got, want32, SSM_ROW_RTOL)
    row_rounding = row_rel_err(want32.bfloat16(), want32)
    del got, want, want32
    # fp16 keeps an fp32 state, as the reference does: the SIMT route
    ins16 = ssm_fp16_state_inputs(torch, dev, gen)
    want16 = ssm_plain(ref.ssm_scan_chunked_ref, *(t.float() for t in ins16), chunk)
    err16 = check_close("ssm_scan fp16 with its state past 65,504",
                        ssm_scan_cuda(*ins16, chunk=chunk).float(), want16, SSM_FP16_RTOL, 0.0)
    y16_max = float(want16.abs().max())
    del want16
    routes = _util.route_counts()["ssm_scan"]
    if routes != {"simt": 5, "wgmma": 3}:
        raise AssertionError(f"ssm_scan: routes {routes}; fp32 and fp16 on simt (5), bf16 on "
                             "wgmma (3)")
    passes = {ch: ssm_pass_checks(torch, u, a, b, c, ch) for ch in (chunk, 512)}
    print(f"check ssm_scan bf16 at a slow decay: {slow}; the wgmma route's passes (errors, "
          f"ms): {passes}", flush=True)
    flat = _util.flatten_ssm(u, a, b, c)  # the plain version's own layout, made untimed
    nbytes = 2 * u.numel() * u.element_size() + a.numel() * 4 + 2 * b.numel() * b.element_size()
    bound_ms, bound_by = bound(ssm_flops(chunk), nbytes, BF16_FLOPS)
    bound_512, bound_by_512 = bound(ssm_flops(512), nbytes, BF16_FLOPS)
    # phase 15's per-rank call: a tp 2 rank's 56 of zamba2-7b's 112 heads
    half = h // 2
    ur, ar = u[:, :, :half].contiguous(), a[:, :, :half].contiguous()
    want_r = ssm_plain(ref.ssm_scan_chunked_ref, ur.float(), ar, b.float(), c.float(), chunk)
    rank = {"row_rel_err_tp2": check_rows(f"ssm_scan bf16 at a tp 2 rank's u {tuple(ur.shape)}",
                                          ssm_scan_cuda(ur, ar, b, c, chunk=chunk), want_r,
                                          SSM_ROW_RTOL)}
    del want_r
    flat_r = _util.flatten_ssm(ur, ar, b, c)
    rank.update(
        ms_tp2=time_ms(torch, lambda: ssm_scan_cuda(ur, ar, b, c, chunk=chunk), 10),
        plain_ms_tp2=time_ms(torch, lambda: ref.ssm_scan_chunked_ref(*flat_r, chunk), 3),
        shape_tp2=f"u {tuple(ur.shape)} bf16, a_log {tuple(ar.shape)}, b/c {tuple(b.shape)}, "
                  "chunk 256 (a tp 2 rank's heads of zamba2-7b)")
    rank["bound_ms_tp2"], rank["bound_by_tp2"] = bound(
        ssm_flops(chunk) // 2, nbytes // 2 + b.numel() * b.element_size(), BF16_FLOPS)
    print(f"check ssm_scan at a tp 2 rank's shape: {rank}", flush=True)
    return {
        **rank,
        "shape": "u (4, 1024, 112, 64) bf16, a_log (4, 1024, 112) f32, b/c (4, 1024, 64) bf16, "
                 "chunk 256",
        "tolerance": f"bf16 rtol 2e-2, atol 2e-2 and each row's ||err|| / ||want|| within "
                     f"{SSM_ROW_RTOL} of the fp32 plain output; at a slow decay rows within "
                     f"{SSM_SLOW_ROW_RTOL} at chunks 256 and 512; fp32 1e-4 (also at a slow "
                     "decay, there at chunk 512 too, and at S 256 against the sequential "
                     f"recurrence); fp16 with its state past 65,504 (SIMT) {SSM_FP16_RTOL}; "
                     "but the row checks, relative to max |y|",
        "ssm_routes": {"bfloat16": "wgmma", "float32": "simt", "float16": "simt"},
        "max_abs_err": err, "row_rel_err": row_err, "row_rel_err_rounding": row_rounding,
        "row_rel_err_slow_decay": slow[256]["row_rel_err"],
        "row_rel_err_slow_decay_chunk512": slow[512]["row_rel_err"],
        "row_rel_err_rounding_slow_decay": slow[256]["row_rel_err_rounding"],
        "row_rel_err_rounding_slow_decay_chunk512": slow[512]["row_rel_err_rounding"],
        "max_abs_err_fp32": err32, "max_abs_err_fp32_slow_decay": err32_slow,
        "max_abs_err_fp32_chunk512": err32_512, "max_abs_err_fp32_sequential": err_seq,
        "ms": time_ms(torch, lambda: ssm_scan_cuda(u, a, b, c, chunk=chunk), 10),
        "ms_chunk512": time_ms(torch, lambda: ssm_scan_cuda(u, a, b, c, chunk=512), 10),
        "ms_passes": passes[chunk]["ms"], "ms_passes_chunk512": passes[512]["ms"],
        "max_abs_err_state_past_65504_fp16": err16, "max_abs_y_fp16": y16_max,
        "ms_fp16": time_ms(torch, lambda: ssm_scan_cuda(*ins16, chunk=chunk), 10),
        "plain_ms": time_ms(torch, lambda: ref.ssm_scan_chunked_ref(*flat, chunk), 3),
        "library_ms": None,  # no single PyTorch call computes this scan
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_ms_chunk512": bound_512, "bound_by_chunk512": bound_by_512,
        "bound_ms_fp32_pipes": ssm_flops(chunk) / FP32_FLOPS * 1e3,
    }


def sm_clock_under(torch, fn, seconds: float = 0.5) -> float:
    """The highest SM clock (Hz) ``nvidia-smi`` reads every 50 ms while
    ``fn`` runs back to back for about ``seconds``."""
    mon = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                            "-lms", "50"], stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        mon.terminate()
        out, _ = mon.communicate(timeout=10)
    readings = [float(x) for x in out.split() if x.strip().replace(".", "", 1).isdigit()]
    if not readings:
        raise AssertionError(f"nvidia-smi read no SM clock: {out!r}")
    return max(readings) * 1e6


def op_latency_checks(torch, dev) -> dict:
    """op_latency: each op's chain of 8192 steps on 128 lanes against the same
    chain as PyTorch ops on the card (equal for the arithmetic ops, fma as one
    rounding; rtol = atol = 1e-6 for rsqrt, exp, tanh and log); the fma chain
    timed as one launch beside its eager chain (8192 launches)."""
    from repro_torch.kernels import op_latency as ops

    chain, width = 8192, 128
    errs = {}
    for name, (kind, *_consts) in ops.OPS.items():
        x0 = ops.chain_input(kind, width, dev)
        got, want = ops.op_chain(name, x0, chain), ops.op_chain_ref(name, x0, chain)
        if name.split(".")[0] in ("rsqrt", "exp", "tanh", "log"):
            errs[name] = check_close(f"op_latency {name}", got, want, 1e-6, 1e-6)
        elif not torch.equal(got, want):
            raise AssertionError(f"op_latency {name}: the chain differs from the PyTorch ops'")
        else:
            errs[name] = 0.0
    x0 = ops.chain_input("f32", width, dev)
    clock_hz = sm_clock_under(torch, lambda: ops.op_chain("fma.f32", x0, chain))
    return {
        "shape": f"fma.f32 chain of {chain} on {width} lanes", "max_abs_err": max(errs.values()),
        # the chain's own floor: each of its dependent FMAs waits out the FMA
        # latency (FMA_CYCLES) at the SM clock read while the chain ran
        "latency_bound_ms": chain * FMA_CYCLES / clock_hz * 1e3, "sm_clock_mhz": clock_hz / 1e6,
        "tolerance": "equal for move/add/mul/fma/max and the s32 ops; rsqrt, exp, tanh, log "
                     "rtol = atol = 1e-6",
        "ms": time_ms(torch, lambda: ops.op_chain("fma.f32", x0, chain), 20),
        "plain_ms": time_ms(torch, lambda: ops.op_chain_ref("fma.f32", x0, chain), 1, warmup=1),
        "library_ms": None,  # no PyTorch call runs a dependent chain
        # the contract's floor: chain x width FMAs at the FP32 pipes' rate and
        # the lanes in and out; the chain's latency is what the probe measures
        "bound_ms": max(2 * chain * width / FP32_FLOPS, 2 * width * 4 / HBM_BPS) * 1e3,
        "bound_by": "operations",
    }


def main_path(torch, dev) -> tuple:
    """Phase 4: ``bench run dissect --full`` through the CLI function.  Returns
    the launch counts, the seconds and the op-latency table (ns per op)."""
    from repro_torch import hw
    from repro_torch.bench import cli
    from repro_torch.bench.suites import dissect as dissect_suite
    from repro_torch.kernels import _util

    reports = []
    measure = dissect_suite.dissect_measure

    def keep_report(*args, **kw):  # the suite reports fitted numbers; keep the probes too
        rep = measure(*args, **kw)
        reports.append(rep)
        return rep

    dissect_suite.dissect_measure = keep_report
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "dissect.json")
        t0 = time.perf_counter()
        _util.reset_launch_counts()
        rc = cli.main(["run", "dissect", "--full", "--out", out])
        counts = _util.launch_counts()
        seconds = time.perf_counter() - t0
        dissect_suite.dissect_measure = measure
        if rc != 0:
            raise RuntimeError(f"bench run dissect --full exited {rc}")
        with open(out) as f:
            result = json.load(f)
    print(f"dissect --full: {seconds:.1f} s; launches {counts}", flush=True)
    (rep,) = reports
    for probe in ("pointer_chase", "stream_bandwidth", "matmul_throughput", "op_latency"):
        backend = rep.probe_results[probe]["meta"]["backend"]
        if backend != "cuda":
            raise AssertionError(f"{probe} ran on backend {backend!r}, not the cuda kernels")
    for k in ("pchase", "stream_reduce", "matmul", "op_latency"):
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"{k} kernel was not launched on the main path")
    if result["env"]["device_kind"] != torch.cuda.get_device_name(dev):
        raise AssertionError(f"result env names {result['env']['device_kind']!r}")
    recs = {r["name"]: r["value"] for r in result["records"]}
    want = {"dissect_host_stream_bw", "dissect_host_matmul_peak", "dissect_host_n_levels",
            "dissect_tpu_model_hbm_bw", "dissect_tpu_model_bf16_peak"}
    if not want <= set(recs) or not all(math.isfinite(v) and v > 0 for v in recs.values()):
        raise AssertionError(f"dissect records missing or not finite and positive: {recs}")
    fitted = rep.hardware
    if not 0 < fitted.peak("float32") <= 1.05 * FP32_FLOPS:
        raise AssertionError(f"fitted fp32 peak {fitted.peak('float32')} is outside (0, 67T]")
    pc = rep.probe_results["pointer_chase"]
    print("pointer chase ns/load by footprint: "
          + ", ".join(f"{x}:{y:.1f}" for x, y in zip(pc["x"], pc["y"])), flush=True)
    sb = rep.probe_results["stream_bandwidth"]
    print("stream GB/s by footprint: "
          + ", ".join(f"{x}:{y:.1f}" for x, y in zip(sb["x"], sb["y"])), flush=True)
    mm = rep.probe_results["matmul_throughput"]
    print("matmul GFLOP/s: " + ", ".join(f"{x}:{y:.1f}" for x, y in zip(mm["x"], mm["y"])))
    ops = rep.probe_results["op_latency"]
    print(f"op_latency ns/op (one launch of the op_latency kernel a chain of "
          f"{ops['meta']['chain']}, less the move-only chain's {ops['meta']['base_ns']} ns a "
          f"step): " + ", ".join(f"{x}:{y}" for x, y in zip(ops["x"], ops["y"])), flush=True)
    slow = {x: y for x, y in zip(ops["x"], ops["y"])
            if x in ("add.f32", "mul.f32", "fma.f32") and not 0 <= y < 10}
    if slow:
        raise AssertionError(f"op_latency: fp32 add/mul/fma take 10 ns or more a step: {slow}")
    print(f"fitted levels (latency ns, capacity bytes): {rep.detected_levels}")
    print(f"fitted stream {fitted.main_memory_Bps / 1e9} GB/s, "
          f"fp32 {fitted.peak('float32') / 1e9} GFLOP/s", flush=True)
    cmp = hw.compare("measured-host", "h100")
    print("compare(measured-host, h100): " + json.dumps(
        {k: cmp[k] for k in ("peak_ratio", "main_memory_Bps_ratio", "levels")}), flush=True)
    return counts, seconds, dict(zip(ops["x"], ops["y"])), rep.detected_levels


def gemm_path(torch, dev) -> dict:
    """Phase 4b: the Tab 4.3 ladder, ``bench run gemm_lp[cuda] gemm_lp[torch]
    gemm[cuda] --full`` through the CLI function, with the launch counts
    zeroed before and read after.  Every record of the reference's full grid
    must be there (no error, no skipped point), every matmul instance must
    have launched, and the measured ladder at the top size is printed beside
    the H100 datasheet's."""
    from repro_torch.bench import cli
    from repro_torch.kernels import _util

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "gemm.json")
        t0 = time.perf_counter()
        _util.reset_launch_counts()
        rc = cli.main(["run", "gemm_lp[cuda]", "gemm_lp[torch]", "gemm[cuda]", "--full",
                       "--out", out])
        counts = _util.launch_counts()
        seconds = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"bench run gemm_lp / gemm --full exited {rc}")
        with open(out) as f:
            result = json.load(f)
    print(f"gemm_lp[cuda], gemm_lp[torch], gemm[cuda] --full: {seconds:.1f} s; launches {counts}",
          flush=True)
    if result["errors"] or result["env"]["device_kind"] != torch.cuda.get_device_name(dev):
        raise AssertionError(f"gemm suites: errors {result['errors']}, env {result['env']}")
    recs = {r["name"]: r["value"] for r in result["records"]}
    dtypes = ("float32", "bfloat16", "float16", "int8", "float8_e4m3fn")
    sizes = (256, 512, 1024)
    want = {f"gemm_lp_{dt}:{n}[{be}]" for dt in dtypes for n in sizes for be in ("cuda", "torch")}
    want |= {f"gemm_dispatch_float32:{n}[cuda]" for n in sizes}
    missing = want - set(recs)
    skipped = [k for k in recs if "skipped" in k]
    if missing or skipped or not all(math.isfinite(v) and v > 0 for v in recs.values()):
        raise AssertionError(f"gemm suites: missing {sorted(missing)}, skipped {skipped}")
    for k in ("matmul", *MATMUL_LP, "matmul_transpose"):
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"{k} kernel was not launched by the gemm suites")
    top = max(sizes)
    ladder = {}
    for hi, lo, sheet in (("float16", "float32", BF16_FLOPS / FP32_FLOPS),
                          ("int8", "float16", FP8_FLOPS / BF16_FLOPS),
                          ("float8_e4m3fn", "bfloat16", FP8_FLOPS / BF16_FLOPS)):
        for be in ("cuda", "torch"):
            ladder[f"{hi}/{lo}[{be}]"] = (recs[f"gemm_lp_{hi}:{top}[{be}]"]
                                          / recs[f"gemm_lp_{lo}:{top}[{be}]"])
        ladder[f"{hi}/{lo}[datasheet]"] = sheet
    print(f"gemm_lp measured ladder at n={top}: {json.dumps(ladder)}", flush=True)
    print("gemm_lp GFLOP/s: " + json.dumps(
        {k: v for k, v in recs.items() if k.startswith(("gemm_lp_", "gemm_dispatch_"))
         and ":" in k}), flush=True)
    return counts


def suites_path(torch, dev, tab41: dict, levels) -> dict:
    """Phase 4c: the paper's other tables, ``bench run instr bandwidth axpy
    memhier scheduler atomics throttle --full`` through the CLI function with
    every variant, the launch counts zeroed before and read after, and each
    registered benchmark's own launches read around its run: each must
    launch exactly its kernels of SUITE_KERNELS (the [torch] variants none),
    and no record may error or be skipped.  Prints Tab 4.1 beside phase 4's,
    the memhier levels, stream GB/s per footprint, the atomics rates and the
    scheduler ratios; walks the pointer chase past the L2 (HBM_WALK_*) beside
    phase 4's L2 plateau; then gates a ``--quick`` run of every ported suite
    against benchmarks/baselines_torch (must PASS) and the same result with
    GATE_PROBE doubled (must FAIL)."""
    from repro_torch.bench import cli
    from repro_torch.core import probes, registry
    from repro_torch.kernels import _util

    per_suite, run = {}, registry.BenchSpec.run

    def counted(spec, *args, **kw):
        before = _util.launch_counts()
        try:
            return run(spec, *args, **kw)
        finally:
            after = _util.launch_counts()
            per_suite[spec.name] = {k for k in after if after[k] != before.get(k, 0)}

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "suites.json")
        t0 = time.perf_counter()
        registry.BenchSpec.run = counted
        try:
            _util.reset_launch_counts()
            rc = cli.main(["run", *PAPER_SUITES, "--full", "--out", out])
            counts = _util.launch_counts()
        finally:
            registry.BenchSpec.run = run
        seconds = time.perf_counter() - t0
        with open(out) as f:
            result = json.load(f)
        print(f"{' '.join(PAPER_SUITES)} --full: {seconds:.1f} s; launches {counts}; per "
              f"benchmark {json.dumps({k: sorted(v) for k, v in per_suite.items()})}", flush=True)
        if rc != 0 or result["errors"]:
            raise RuntimeError(f"bench run {' '.join(PAPER_SUITES)} --full exited {rc}: "
                               f"{result['errors']}")
        wrong = {k: sorted(v) for k, v in per_suite.items() if v != SUITE_KERNELS.get(k, set())}
        if wrong or set(per_suite) < set(SUITE_KERNELS):
            raise AssertionError(f"suites launched other kernels than {SUITE_KERNELS}: {wrong}")
        recs = {r["name"]: r for r in result["records"]}
        bad = [k for k, r in recs.items() if "skipped" in k or not math.isfinite(r["value"])]
        if bad or result["env"]["device_kind"] != torch.cuda.get_device_name(dev):
            raise AssertionError(f"suites: skipped or not finite {bad}, env {result['env']}")

        def table(prefix, key=lambda r: r["value"]):
            """The measured records under ``prefix`` (the reference's modeled
            TPU rows are not the card's), keyed by the rest of the name."""
            return {k[len(prefix):]: key(r) for k, r in recs.items()
                    if k.startswith(prefix) and r["measured"] and "_tpu_" not in k}

        tab = table("oplat_")
        print("Tab 4.1, ns per dependent op (instr --full, phase 4 in brackets): " + ", ".join(
            f"{k}: {v:.4g} [{tab41[k]:.4g}]" if k in tab41 else f"{k}: {v:.4g}"
            for k, v in tab.items()), flush=True)
        print("memhier levels (latency ns, capacity bytes): " + json.dumps(
            table("pchase_host_level", lambda r: (r["value"], r["metrics"]["capacity_bytes"]))))
        print("pchase ns/load by footprint: " + json.dumps(
            {k: v for k, v in table("pchase_host_").items() if k.endswith("KiB")}
            | {"dispatch": table("pchase_dispatch_")}))
        print("stream GB/s by footprint: " + json.dumps(table("streambw_host_")))
        print("stream GB/s through the dispatch API: " + json.dumps(table("streambw_dispatch_")))
        print("axpy GB/s: " + json.dumps(table("axpy_")))
        print("atomics Mupdates/s by collisions: " + json.dumps(table("scatter_contention_")))
        print("scheduler ratio to one unit: " + json.dumps(
            table("grid_occupancy_", lambda r: r["metrics"]["ratio_vs_1program"])), flush=True)

        _util.reset_launch_counts()
        walk = probes.probe_pointer_chase(HBM_WALK_BYTES, steps=HBM_WALK_STEPS, device=dev)
        add_counts(counts, _util.launch_counts())
        l2 = max(lat for lat, _ in levels) if levels else float("nan")
        print(f"pointer chase past the L2, {HBM_WALK_STEPS} steps, ns/load: " + json.dumps(
            dict(zip(walk.x, walk.y))) + f"; phase 4's slowest plateau {l2:.4g} ns", flush=True)
        if walk.meta["backend"] != "cuda" or not all(math.isfinite(y) and y > 0 for y in walk.y):
            raise AssertionError(f"HBM walk: {walk}")

        quick = os.path.join(tmp, "quick.json")
        t0 = time.perf_counter()
        if cli.main(["run", *PORTED_SUITES, "--quick", "--out", quick]) != 0:
            raise RuntimeError("bench run --quick of the ported suites failed")
        gate = cli.main(["compare", quick, BASELINES])
        with open(quick) as f:
            doubled = json.load(f)
        (probe,) = [r for r in doubled["records"] if r["name"] == GATE_PROBE]
        probe["value"] *= 2
        with open(quick, "w") as f:
            json.dump(doubled, f)
        gate_doubled = cli.main(["compare", quick, BASELINES])
        print(f"gate: --quick run and compare in {time.perf_counter() - t0:.1f} s; against "
              f"{os.path.relpath(BASELINES, ROOT)} exit {gate} (0 = PASS), with {GATE_PROBE} "
              f"doubled exit {gate_doubled} (1 = FAIL)", flush=True)
        if gate != 0 or gate_doubled != 1:
            raise AssertionError(f"gate: compare exited {gate}, doubled {gate_doubled}")
    return counts


def axpy_path(torch, dev) -> tuple:
    """Phase 5: the Ch. 1 experiment as the probe runs it, then Fig 1.1's
    access-width sweep at an array far past the 50 MB L2, each width counted
    the same way.  Returns the probe's launch counts and, by width, the
    sweep's GB/s and launches."""
    from repro_torch.core import probes
    from repro_torch.kernels import _util

    _util.reset_launch_counts()
    res = probes.probe_block_shape_bandwidth(device=dev)
    counts = _util.launch_counts()
    if res.meta["backend"] != "cuda" or counts.get("axpy", 0) <= 0:
        raise AssertionError(f"block-shape probe bypassed the axpy kernel: {res.meta} {counts}")
    print("block_shape_bandwidth GB/s by tile width (1 MiB arrays): "
          + ", ".join(f"{x}:{y:.1f}" for x, y in zip(res.x, res.y)) + f"; launches {counts}")
    sweep = {}
    for vb in (4, 8, 16):
        _util.reset_launch_counts()
        big = probes.probe_block_shape_bandwidth(
            footprint=256 << 20, col_widths=(2048,), device=dev, vec_bytes=vb)
        launches = _util.launch_counts().get("axpy", 0)
        if launches <= 0:
            raise AssertionError(f"the {vb}-byte sweep bypassed the axpy kernel")
        sweep[vb] = {"probe_gbps": big.y[0], "launches": launches}
        print(f"access width {vb * 8}-bit, 256 MiB arrays: {big.y[0]:.1f} GB/s; "
              f"launches {launches}", flush=True)
    return counts, sweep


def entry_point_path(torch, dev) -> dict:
    """Phase 6: the kernel layer's bandwidth entry points, as a user calls them."""
    from repro_torch.kernels import _util
    from repro_torch.kernels import api

    rows, cols = 4096, 512  # 8 MiB of ones: every partial sum stays below 2^24, so exact
    x = torch.ones((rows, cols), device=dev)
    _util.reset_launch_counts()
    out = api.stream_copy(x)
    sums = {s: float(api.strided_reduce(x, stride=s)[0, 0]) for s in (1, 2, 3, 128)}
    torch.cuda.synchronize()
    counts = _util.launch_counts()
    want = {s: float(rows // 64 * -(-64 // s) * cols) for s in sums}  # ones: a count of elements
    if not torch.equal(out, x) or sums != want:
        raise AssertionError(f"entry points: strided sums {sums}, expected {want}")
    for k in ("stream_copy", "strided_reduce"):
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"{k} kernel was not launched through kernels.api")
    print(f"entry points api.stream_copy / api.strided_reduce: launches {counts}", flush=True)
    return counts


def lm_path(torch, dev) -> dict:
    """Phase 7: gemma-2b, full width and depth, through build_model's entry
    points with the flash kernel, held against the plain blockwise path by
    ``lm_against_plain`` (the harness of phases 8b-8e); beside it the long
    2048-token prefill, and the roofline of the 4 x 1000 prefill."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params

    cfg = get_config("gemma-2b").replace(attn_impl="pallas")
    model = build_model(cfg, device=dev)
    plain_model = build_model(cfg.replace(attn_impl="blockwise"), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    n_params = count_params(params)
    print(f"lm: {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params} params "
          f"({params['embed'].dtype}), init {time.perf_counter() - t0:.1f} s", flush=True)
    seq = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT + 1), generator=gen, device=dev)
    batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
    long_prompt = torch.randint(0, cfg.vocab_size, (1, LM_LONG), generator=gen, device=dev)
    with torch.inference_mode():
        model.prefill(params, {"tokens": seq[:1, :64]})  # warm-up: cuBLAS, kernel attributes
        counts, res = lm_against_plain(torch, "lm", model, plain_model, params, batch, LM_STEPS,
                                       cfg.n_layers, dev)
        (long_last, _), long_s, long_counts = counted(
            torch, lambda: model.prefill(params, {"tokens": long_prompt}))
        (plain_long, _), plain_long_s, _ = counted(
            torch, lambda: plain_model.prefill(params, {"tokens": long_prompt}))
        roof = roofline_share(f"{cfg.name} prefill {LM_BATCH} x {LM_PROMPT} (plain path counted)",
                              plain_model.prefill,
                              (params, {"tokens": batch["tokens"]}, LM_PROMPT + LM_STEPS),
                              n_params, LM_BATCH * LM_PROMPT, res["prefill_s"])
    if long_counts != {"flash_attention": cfg.n_layers}:
        raise AssertionError(f"lm: the {LM_LONG}-token prefill launched {long_counts}, expected "
                             f"flash_attention {cfg.n_layers}")
    long_last, plain_long = long_last[:, :cfg.vocab_size].float(), plain_long[:, :cfg.vocab_size]
    if long_last.shape != (1, cfg.vocab_size) or not torch.isfinite(long_last).all():
        raise AssertionError(f"lm: the long prefill's last logits {tuple(long_last.shape)} are "
                             f"malformed or not finite")
    long_res = {"long_prefill_s": long_s, "plain_long_prefill_s": plain_long_s,
                "long_prefill_tok_s": LM_LONG / long_s,
                "rel_err_long_last_logits": rel_max(long_last, plain_long),
                "prefill_bound_share": roof["bound_share_of_kernel_path"]}
    print("lm long prefill: " + json.dumps(long_res), flush=True)
    if long_res["rel_err_long_last_logits"] > 0.1:
        raise AssertionError(f"lm: the long prefill differs from the plain path: {long_res}")
    add_counts(counts, long_counts)
    return counts


def zamba_path(torch, dev) -> dict:
    """Phase 8: zamba2-7b, full width and depth, through build_model's entry
    points with the ssm_scan and flash kernels; the plain path (ssm_impl
    "xla", attn_impl "blockwise") is the reference.  Per path: loss_fn on 4
    sequences of 1000 tokens, the forward's logits, prefill of all but the
    last token (cache 1016), then 16 decode steps, the first fed the last
    prompt token (so its logits continue the forward), the rest greedy.
    Launches are zeroed before and read after each call."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _util
    from repro_torch.models import build_model, mamba
    from repro_torch.models.common import count_params

    phase_start = time.perf_counter()
    cfg = get_config("zamba2-7b").replace(ssm_impl="pallas", attn_impl="pallas")
    plain_cfg = cfg.replace(ssm_impl="xla", attn_impl="blockwise")
    n_super, per, tail = mamba._zamba_counts(cfg)
    n_attn = n_super + (1 if tail else 0)
    model, plain_model = build_model(cfg, device=dev), build_model(plain_cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    print(f"zamba: {cfg.name}, {cfg.n_layers} Mamba2 layers, {n_attn} shared-attention calls, "
          f"d_model {cfg.d_model}, {count_params(params)} params ({params['embed'].dtype}), "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)
    seq = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT + 1), generator=gen, device=dev)
    batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
    prompts = batch["tokens"]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    routes = {}

    def run(m, c):
        out, counts = {}, {}

        def call(key, fn):
            _util.reset_launch_counts()
            res, out[f"{key}_s"] = timed(fn)
            counts[key] = _util.launch_counts()
            routes[key] = _util.route_counts()
            return res

        out["loss"] = float(call("loss_fn", lambda: m.loss_fn(params, batch)))
        logits = call("forward", lambda: mamba.zamba_forward(params, prompts, c))
        out["last"], out["second_last"] = logits[:, -1].float(), logits[:, -2].float()
        del logits
        last, cache = call("prefill", lambda: m.prefill(params, {"tokens": prompts[:, :-1]},
                                                        LM_PROMPT + ZAMBA_STEPS))
        out["prefill_last"] = last.float()

        def decode():
            nonlocal cache
            tok, toks = prompts[:, -1], []
            for i in range(ZAMBA_STEPS):
                pos = torch.full((LM_BATCH,), LM_PROMPT - 1 + i, dtype=torch.int32, device=dev)
                logits, cache = m.decode_step(params, cache, tok, pos)
                if i == 0:
                    out["first_step"] = logits.float()
                tok = logits.argmax(-1)
                toks.append(tok)
            return torch.stack(toks, 1)

        out["tokens"] = call("decode", decode)
        return out, counts

    def autotuned():
        """The forward and the loss under kernel_policy(autotune=True), at the
        chunk the autotuner picks for the kernel's operands on the H100.  The
        model hands the op cfg.ssm_chunk explicitly, and an explicit kwarg wins
        over autotune in both packages, so the config carries the pick; a spy
        on the kernel's wrapper records the chunk each launch ran at."""
        from repro_torch.core.autotune import choose_ssm_chunk, dtype_name
        from repro_torch.kernels import ssm_scan as ssd
        from repro_torch.kernels.api import kernel_policy

        seen, kernel = [], ssd.ssm_scan_cuda

        def spy(u, a_log, b, c, *, chunk):
            seen.append((u.dtype, chunk))
            return kernel(u, a_log, b, c, chunk=chunk)

        ssd.ssm_scan_cuda = spy
        try:
            mamba.zamba_forward(params, prompts[:1, :8], cfg)  # the kernel's operand dtype
            chunk = choose_ssm_chunk(LM_PROMPT, cfg.ssm_head_dim, cfg.ssm_state,
                                     dtype_name(seen[0][0]), hw="nvidia-h100-sxm")
            seen.clear()
            acfg = cfg.replace(ssm_chunk=chunk)
            with kernel_policy(autotune=True):
                _util.reset_launch_counts()
                logits, seconds = timed(lambda: mamba.zamba_forward(params, prompts, acfg))
                launches = _util.launch_counts()
                routes["autotuned_forward"] = _util.route_counts()
                loss = float(build_model(acfg, device=dev).loss_fn(params, batch))
        finally:
            ssd.ssm_scan_cuda = kernel
        chunks = sorted({c for _, c in seen})
        return {"chunk": chunk, "kernel_chunks": chunks, "forward_s": seconds,
                "launches": launches, "loss": loss, "last": logits[:, -1].float()}

    with torch.inference_mode():
        # warm-up: cuBLAS handles and the kernels' shared-memory attributes
        model.loss_fn(params, {"tokens": seq[:1, :32], "targets": seq[:1, 1:33]})
        run_out, counts = run(model, cfg)
        kernel_routes = dict(routes)
        plain, plain_counts = run(plain_model, plain_cfg)
        roof = roofline_share(f"{cfg.name} forward {LM_BATCH} x {LM_PROMPT} (plain path counted)",
                              mamba.zamba_forward, (params, prompts, plain_cfg),
                              count_params(params), LM_BATCH * LM_PROMPT, run_out["forward_s"])
        auto = autotuned()
    want_routes = {"ssm_scan": {"wgmma": cfg.n_layers}}
    for key in ("loss_fn", "forward"):
        if kernel_routes[key] != want_routes:
            raise AssertionError(f"zamba {key}: ssm_scan routes {kernel_routes[key]}, "
                                 f"expected {want_routes}")
    if routes["autotuned_forward"] != want_routes:
        raise AssertionError(f"zamba autotuned: ssm_scan routes {routes['autotuned_forward']}")
    want = {"loss_fn": {"ssm_scan": cfg.n_layers, "flash_attention": n_attn},
            "forward": {"ssm_scan": cfg.n_layers, "flash_attention": n_attn},
            "prefill": {"flash_attention": n_attn}, "decode": {}}
    if counts != want:
        raise AssertionError(f"zamba: launches {counts}, expected {want}")
    if any(plain_counts.values()):
        raise AssertionError(f"zamba: the plain path launched kernels: {plain_counts}")
    for key in ("last", "second_last", "prefill_last", "first_step"):
        got = run_out[key]
        if got.shape != (LM_BATCH, cfg.padded_vocab) or not torch.isfinite(got).all():
            raise AssertionError(f"zamba: {key} is not finite of shape (4, {cfg.padded_vocab})")
    if run_out["tokens"].shape != (LM_BATCH, ZAMBA_STEPS) or not math.isfinite(run_out["loss"]):
        raise AssertionError("zamba: tokens or loss malformed")

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    agree = {
        "loss_vs_plain": abs(run_out["loss"] - plain["loss"]) / abs(plain["loss"]),
        "last_logits_vs_plain": rel(run_out["last"], plain["last"]),
        "prefill_vs_forward_pos_-2": rel(run_out["prefill_last"], run_out["second_last"]),
        "first_step_vs_forward_pos_-1": rel(run_out["first_step"], run_out["last"]),
        "plain_prefill_vs_plain_forward_pos_-2": rel(plain["prefill_last"], plain["second_last"]),
    }
    res = {
        **{k: run_out[k] for k in ("loss_fn_s", "forward_s", "prefill_s", "decode_s", "loss")},
        **{f"plain_{k}": plain[k] for k in ("loss_fn_s", "forward_s", "prefill_s", "decode_s",
                                             "loss")},
        "forward_tok_s": LM_BATCH * LM_PROMPT / run_out["forward_s"],
        "decode_ms_per_step": run_out["decode_s"] / ZAMBA_STEPS * 1e3,
        "decode_tok_s": LM_BATCH * ZAMBA_STEPS / run_out["decode_s"],
        "greedy_equal_share": float((run_out["tokens"] == plain["tokens"]).float().mean()),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        **agree, "launches": counts, "ssm_routes": kernel_routes["forward"],
        "forward_bound_share": roof["bound_share_of_kernel_path"],
        "phase_s": time.perf_counter() - phase_start,
    }
    print("zamba: " + json.dumps(res), flush=True)
    if max(agree.values()) > 0.1:
        raise AssertionError(f"zamba: outputs disagree by more than 0.1 of their max: {agree}")
    # with random weights the loss sits near ln(vocab) whatever the layers compute,
    # so 0.1 cannot catch a wrong layer; the kernels' own rounding is ~2e-5
    if agree["loss_vs_plain"] > LOSS_RTOL:
        raise AssertionError(f"zamba: loss differs from the plain path's by "
                             f"{agree['loss_vs_plain']} relative, over {LOSS_RTOL}")
    auto_agree = {"loss_vs_chunk256": abs(auto["loss"] - run_out["loss"]) / abs(run_out["loss"]),
                  "last_logits_vs_chunk256": rel(auto["last"], run_out["last"])}
    print("zamba autotuned: " + json.dumps(
        {k: v for k, v in auto.items() if k != "last"} | auto_agree), flush=True)
    if auto["chunk"] != 512 or auto["kernel_chunks"] != [512]:
        raise AssertionError(f"zamba autotuned: chunk {auto['chunk']}, the kernel ran at "
                             f"{auto['kernel_chunks']}; 512 expected")
    if auto["launches"] != want["forward"]:
        raise AssertionError(f"zamba autotuned: launches {auto['launches']}")
    if auto_agree["last_logits_vs_chunk256"] > 0.1 or auto_agree["loss_vs_chunk256"] > LOSS_RTOL:
        raise AssertionError(f"zamba autotuned: disagrees with the chunk-256 run: {auto_agree}")
    counts["autotuned_forward"] = auto["launches"]
    total = {}
    for c in counts.values():
        add_counts(total, c)
    return total


# phases 8b-8d: the MoE, VLM and encoder-decoder families


def counted(torch, fn) -> tuple:
    """``fn()`` with the launch counts zeroed before and read after, timed
    on the host clock between two synchronizes: (result, seconds, counts)."""
    from repro_torch.kernels import _util

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    _util.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0, _util.launch_counts()


def rel_max(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def greedy(torch, model, params, cache, tok, start, steps, dev) -> tuple:
    """``steps`` greedy ``decode_step``s from ``tok`` at position ``start``:
    the tokens (B, steps) and each step's logits (steps, B, V) in fp32."""
    toks, rows = [], []
    for i in range(steps):
        pos = torch.full((tok.shape[0],), start + i, dtype=torch.int32, device=dev)
        logits, cache = model.decode_step(params, cache, tok, pos)
        tok = logits.argmax(-1)
        toks.append(tok)
        rows.append(logits.float())
    return torch.stack(toks, 1), torch.stack(rows)


def greedy_flips(torch, got, want, got_rows, want_rows) -> tuple:
    """The kernel path's greedy decode against the plain path's: (flips,
    rel), where ``flips`` lists, per lane whose stream leaves the plain
    one, the first step that differs, both tokens, the plain path's top-2
    logit margin there and the two paths' largest logit distance at that
    step (a flip needs the margin within twice the distance: a near-tie);
    ``rel`` is the largest max |got - want| / max |want| of a logits row
    over every step whose inputs the two paths share (each lane up to and
    including its first flip)."""
    flips, rel = [], 0.0
    for lane in range(want.shape[0]):
        diff = (got[lane] != want[lane]).nonzero()
        last = int(diff[0]) if len(diff) else want.shape[1] - 1
        for j in range(last + 1):
            rel = max(rel, rel_max(got_rows[j, lane], want_rows[j, lane]))
        if len(diff):
            top = torch.topk(want_rows[last, lane], 2).values
            flips.append({"lane": lane, "step": last, "want": int(want[lane, last]),
                          "got": int(got[lane, last]), "margin": float(top[0] - top[1]),
                          "distance": float((got_rows[last, lane]
                                             - want_rows[last, lane]).abs().max())})
    return flips, rel


@contextlib.contextmanager
def moe_drops():
    """Count, on the device, the real tokens' assignments every ``moe_block``
    call drops past its capacity (``mlp.moe_drop_count``, each lane of a call
    one routing group); yields a dict whose ``"drops"`` is the running total
    (a tensor).  It adds a router pass to every call, so it wraps untimed
    runs only.  A prefill chunk's pad entries (positions the step itself
    treats as padding: past the lane cache, or past the block table's
    pages) route too, after a lane's real tokens: the two chunk steps are
    wrapped to hand their real-token mask, read from their named arguments
    ``cache``, ``positions`` and ``block_table``, to the count.  A decode
    step routes each lane as a group of one token, which never drops."""
    import inspect

    from repro_torch.models import mlp, transformer

    block, seen, mask = mlp.moe_block, {"drops": 0}, {"real": None}
    steps = {name: getattr(transformer, name)
             for name in ("lm_decode_chunk", "lm_decode_chunk_paged")}

    def spy(params, x, cfg):
        seen["drops"] = seen["drops"] + mlp.moe_drop_count(params, x, cfg, mask["real"])
        return block(params, x, cfg)

    def masked(step):
        sig = inspect.signature(step)

        def run(*args, **kwargs):
            a = sig.bind(*args, **kwargs).arguments
            # the dense cache (L, B, Smax, K, hd); the page pool (L, N, page, K, hd)
            limit = a["cache"]["k"].shape[2]
            if "block_table" in a:
                limit *= a["block_table"].shape[1]
            mask["real"] = a["positions"] < limit
            try:
                return step(*args, **kwargs)
            finally:
                mask["real"] = None
        return run

    mlp.moe_block = spy
    for name, step in steps.items():
        setattr(transformer, name, masked(step))
    try:
        yield seen
    finally:
        mlp.moe_block = block
        for name, step in steps.items():
            setattr(transformer, name, step)


def lm_against_plain(torch, name, model, plain_model, params, batch, steps, want_flash, dev):
    """``loss_fn``, ``prefill`` and ``steps`` greedy decode steps through
    ``model`` (the flash kernel) and ``plain_model`` (blockwise): each call's
    flash launches must be ``want_flash``; the outputs are finite, of the
    expected shapes, and agree with the plain path (last logits within 0.1 of
    their max, the loss within LOSS_RTOL, and every decode step's logits
    whose inputs the two paths share within 0.1 too: a greedy token that
    flips is a bf16 near-tie, printed with its margin, and the step's logits
    are held to that same limit).  ``batch`` holds tokens, targets and any
    frontend; the prefill gets all but the targets."""
    prompt = {k: v for k, v in batch.items() if k != "targets"}
    start = batch["tokens"].shape[1] + (
        batch["frontend"].shape[1] if model.cfg.family == "vlm" else 0)
    runs = {}
    for path, m in (("kernel", model), ("plain", plain_model)):
        loss, loss_s, loss_counts = counted(torch, lambda: float(m.loss_fn(params, batch)))
        (last, cache), prefill_s, prefill_counts = counted(
            torch, lambda: m.prefill(params, prompt, start + steps))
        # both paths decode from the same token, the sequence's next one
        (toks, rows), decode_s, _ = counted(torch, lambda: greedy(
            torch, m, params, cache, batch["targets"][:, -1], start, steps, dev))
        vocab = m.cfg.vocab_size  # the pad columns hold -1e30 in both paths
        runs[path] = {"loss": loss, "last": last[:, :vocab].float(), "tokens": toks,
                      "rows": rows[..., :vocab],
                      "loss_s": loss_s, "prefill_s": prefill_s, "decode_s": decode_s,
                      "counts": {"loss_fn": loss_counts, "prefill": prefill_counts}}
        del cache
    run, plain = runs["kernel"], runs["plain"]
    want = {"flash_attention": want_flash}
    if run["counts"] != {"loss_fn": want, "prefill": want} or any(plain["counts"].values()):
        raise AssertionError(f"{name}: launches {run['counts']} (plain {plain['counts']}), "
                             f"expected flash_attention {want_flash} per call")
    b = batch["tokens"].shape[0]
    if run["last"].shape != (b, model.cfg.vocab_size) or run["tokens"].shape != (b, steps):
        raise AssertionError(f"{name}: shapes {tuple(run['last'].shape)}, "
                             f"{tuple(run['tokens'].shape)}")
    if not (torch.isfinite(run["last"]).all() and torch.isfinite(run["rows"]).all()
            and math.isfinite(run["loss"])):
        raise AssertionError(f"{name}: non-finite outputs")
    flips, decode_rel = greedy_flips(torch, run["tokens"], plain["tokens"], run["rows"],
                                     plain["rows"])
    res = {
        "loss": run["loss"], "plain_loss": plain["loss"],
        "loss_vs_plain": abs(run["loss"] - plain["loss"]) / abs(plain["loss"]),
        "rel_err_last_logits": rel_max(run["last"], plain["last"]),
        "rel_err_decode_logits": decode_rel,
        "greedy_equal_share": float((run["tokens"] == plain["tokens"]).float().mean()),
        "prefill_argmax_equal_share": float((run["last"].argmax(-1) == plain["last"].argmax(-1))
                                            .float().mean()),
        "flips": flips, **{f"{k}_s": run[f"{k}_s"] for k in ("loss", "prefill", "decode")},
        **{f"plain_{k}_s": plain[f"{k}_s"] for k in ("loss", "prefill", "decode")},
        "prefill_tok_s": b * start / run["prefill_s"], "decode_tok_s": b * steps / run["decode_s"],
        "launches": run["counts"],
    }
    print(f"{name}: " + json.dumps(res), flush=True)
    if max(res["rel_err_last_logits"], decode_rel) > 0.1 or res["loss_vs_plain"] > LOSS_RTOL:
        raise AssertionError(f"{name}: differs from the plain path: {res}")
    total = {}
    for c in run["counts"].values():
        add_counts(total, c)
    return total, res


def moe_path(torch, dev) -> dict:
    """Phase 8b: olmoe-1b-7b at full width and depth (see the module
    docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.core.timing import percentile
    from repro_torch.kernels import guard
    from repro_torch.models import build_model, mlp
    from repro_torch.models.common import count_params, tree_map
    from repro_torch.serve import EngineConfig, ServeEngine

    phase_start = time.perf_counter()
    cfg = get_config("olmoe-1b-7b").replace(attn_impl="pallas")
    model = build_model(cfg, device=dev)
    plain_model = build_model(cfg.replace(attn_impl="blockwise"), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    print(f"moe: {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_experts} "
          f"experts top-{cfg.experts_per_token}, {count_params(params)} params "
          f"({params['embed'].dtype}), init {time.perf_counter() - t0:.1f} s", flush=True)
    seq = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT + 1), generator=gen, device=dev)
    batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
    with torch.inference_mode():
        model.prefill(params, {"tokens": seq[:1, :64]})  # warm-up: cuBLAS, kernel attributes
        counts, _ = lm_against_plain(torch, "moe", model, plain_model, params, batch, LM_STEPS,
                                     cfg.n_layers, dev)
        with moe_drops() as prefill_drops:  # untimed: the prefill once more, counted
            model.prefill(params, {"tokens": batch["tokens"]})

        # the capacity dispatch against every token through every expert
        lp = tree_map(lambda a: a[0], params["layers"]["moe"])
        x = torch.randn((1, MOE_DENSE_TOKENS, cfg.d_model), generator=gen, device=dev).bfloat16()
        ample = cfg.replace(capacity_factor=16.0)
        (y, aux), dispatch_s, _ = counted(torch, lambda: mlp.moe_block(lp, x, ample))
        (yd, auxd), dense_s, _ = counted(torch, lambda: mlp.moe_block_dense(lp, x, ample))
        tol = guard.tolerance(torch.bfloat16, CARD_HW)
        r = guard.compare(y, yd, tol, op="moe_block", backend="torch")
        dispatch = {"tokens": MOE_DENSE_TOKENS, "ok": r.ok, "max_ulp": r.max_ulp,
                    "max_abs": r.max_abs, "aux": float(aux), "aux_dense": float(auxd),
                    "drops_at_16": int(mlp.moe_drop_count(lp, x, ample)),
                    "drops_at_1.25": int(mlp.moe_drop_count(lp, x, cfg)),
                    "dispatch_s": dispatch_s, "dense_s": dense_s}
        print("moe: moe_block against moe_block_dense, bf16, capacity_factor 16: "
              + json.dumps(dispatch), flush=True)
        if not r.ok or dispatch["drops_at_16"] or abs(dispatch["aux"] - dispatch["aux_dense"]) > (
                1e-5 * abs(dispatch["aux_dense"])):
            raise AssertionError(f"moe: the dispatch disagrees with the dense oracle: {dispatch}")

        # serving: a routing group is one lane of one call, so the engines and
        # the direct loop must prefill each prompt in the same SERVE_CHUNK chunks
        if SERVE_PREFIX % SERVE_CHUNK:
            raise AssertionError("moe: the paged leg's prefix does not end on a chunk boundary")
        prompts, prefix = serve_prompts(cfg)
        base = dict(n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, prefill_chunk=SERVE_CHUNK,
                    guard="off")
        results = {}
        for name, extra in (("dense", {}), ("paged", {"page_size": SERVE_PAGE})):
            eng = ServeEngine(model, params, EngineConfig(**base, **extra))
            if name == "paged":
                eng.register_prefix(prefix)
            eng.submit(prompts[0][:SERVE_PREFIX + 8], 4)  # warm-up: first calls of both steps
            eng.run()
            eng.reset_metrics()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            sessions = [eng.submit(p, SERVE_NEW) for p in prompts]
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            m, sm = eng.metrics, eng.summary()
            results[name] = {
                "tokens": [x.out for x in sessions],
                "finished": [x.finish_reason for x in sessions], "wall_s": wall,
                "throughput_tok_s": sm["throughput_tok_s"], "ttft_ms_p50": sm["ttft_ms_p50"],
                "ttft_ms_max": max(m.ttft_s) * 1e3,
                "tok_latency_ms_p50": sm["tok_latency_ms_p50"],
                "tok_latency_ms_p99": percentile(m.token_latency_s, 99) * 1e3,
                "prefix_tokens_reused": sm["prefix_tokens_reused"],
                "max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            }
            # untimed: the same requests again with their drops counted; the
            # streams must repeat
            with moe_drops() as drops:
                again = [eng.submit(p, SERVE_NEW) for p in prompts]
                eng.run()
            if [x.out for x in again] != results[name]["tokens"]:
                raise AssertionError(f"moe serving {name}: the counted rerun's tokens differ")
            results[name]["assignments_dropped"] = int(drops["drops"])
            print(f"moe serving {name} (smoke reading, {SERVE_REQUESTS} requests): "
                  + json.dumps({k: v for k, v in results[name].items() if k != "tokens"}),
                  flush=True)
        direct, _ = direct_tokens(torch, model, params, prompts, dev)
    print(f"moe: assignments dropped at capacity_factor {cfg.capacity_factor} over one "
          f"prefill of {LM_BATCH} x {LM_PROMPT}: {int(prefill_drops['drops'])}", flush=True)
    if any(r != "max_new_tokens" for res in results.values() for r in res["finished"]):
        raise AssertionError("moe serving: not every request finished")
    same = {"dense_paged": results["dense"]["tokens"] == results["paged"]["tokens"],
            "dense_direct": results["dense"]["tokens"] == direct}
    print(f"moe serving: tokens equal {same}; the paged leg's {SERVE_PREFIX}-token prefix "
          f"ends on a {SERVE_CHUNK}-token chunk boundary, so every leg routes the same groups",
          flush=True)
    if not all(same.values()):
        raise AssertionError(f"moe serving: token streams differ: {same}")
    if results["paged"]["prefix_tokens_reused"] != SERVE_REQUESTS * SERVE_PREFIX:
        raise AssertionError(f"moe serving: prefix reuse "
                             f"{results['paged']['prefix_tokens_reused']}")
    print(f"moe: phase {time.perf_counter() - phase_start:.1f} s", flush=True)
    return counts


def vlm_path(torch, dev) -> dict:
    """Phase 8c: internvl2-76b at full width, its depth cut (see the module
    docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params

    phase_start = time.perf_counter()
    full = get_config("internvl2-76b")
    cfg = full.replace(attn_impl="pallas", n_layers=VLM_LAYERS)
    print(f"vlm: {cfg.name} at full width (d_model {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}); n_layers cut from {full.n_layers} to "
          f"{cfg.n_layers}: {full.param_count()} params, {full.param_count() * 4 / 1e9:.0f} GB "
          f"of fp32, do not fit one 80 GB card", flush=True)
    model = build_model(cfg, device=dev)
    plain_model = build_model(cfg.replace(attn_impl="blockwise"), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    print(f"vlm: {count_params(params)} params, init {time.perf_counter() - t0:.1f} s",
          flush=True)
    seq = torch.randint(0, cfg.vocab_size, (VLM_BATCH, VLM_TEXT + 1), generator=gen, device=dev)
    frontend = torch.randn((VLM_BATCH, cfg.frontend_len, cfg.d_model), generator=gen,
                           device=dev).bfloat16()
    batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:], "frontend": frontend}
    with torch.inference_mode():
        model.prefill(params, {"tokens": seq[:1, :8], "frontend": frontend[:1]})  # warm-up
        counts, _ = lm_against_plain(torch, "vlm", model, plain_model, params, batch, VLM_STEPS,
                                     cfg.n_layers, dev)
    print(f"vlm: phase {time.perf_counter() - phase_start:.1f} s", flush=True)
    return counts


def encdec_path(torch, dev) -> dict:
    """Phase 8d: whisper-base, whole (see the module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params

    phase_start = time.perf_counter()
    cfg = get_config("whisper-base").replace(attn_impl="pallas")
    model = build_model(cfg, device=dev)
    plain_model = build_model(cfg.replace(attn_impl="blockwise"), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    print(f"encdec: {cfg.name}, {cfg.n_enc_layers} + {cfg.n_dec_layers} layers, d_model "
          f"{cfg.d_model}, {count_params(params)} params, frames ({WHISPER_BATCH}, "
          f"{WHISPER_FRAMES}, {cfg.d_model}) bf16", flush=True)
    seq = torch.randint(0, cfg.vocab_size, (WHISPER_BATCH, WHISPER_PROMPT + 1), generator=gen,
                        device=dev)
    frames = torch.randn((WHISPER_BATCH, WHISPER_FRAMES, cfg.d_model), generator=gen,
                         device=dev).bfloat16()
    batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:], "frontend": frames}
    with torch.inference_mode():
        model.prefill(params, {"tokens": seq[:1, :8], "frontend": frames[:1]})  # warm-up
        counts, _ = lm_against_plain(torch, "encdec", model, plain_model, params, batch,
                                     WHISPER_STEPS, cfg.n_enc_layers + 2 * cfg.n_dec_layers, dev)
    print(f"encdec: phase {time.perf_counter() - phase_start:.1f} s", flush=True)
    return counts


def xlstm_path(torch, dev) -> dict:
    """Phase 8e: xlstm-1.3b, whole (see the module docstring).  The family
    reaches no kernel.  Its prefill and decode steps are held against its
    own forward over the prompt and the tokens the steps were fed (the step
    recurrence against the chunkwise form).  With random weights the model
    amplifies a rounding at every layer (a 1e-6 nudge of the embeddings
    grows to 3e-4 of the residual stream in the first mLSTM layer and to
    0.57 after 24 layers, in float32 on the CPU), so at full depth the two
    forms part by rounding alone, in either precision and in the reference
    too: there the distances are printed beside the model's own floor (the
    float32 forward against itself with the embeddings nudged by one
    ulp), and the identity is held within 0.1 over one macro block (8
    layers) at full width in float32."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, xlstm
    from repro_torch.models.common import count_params, tree_map

    phase_start = time.perf_counter()
    cfg = get_config("xlstm-1.3b")
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    print(f"xlstm: {cfg.name}, {cfg.n_layers} layers ({xlstm.n_macros(cfg)} x "
          f"({cfg.xlstm_mlstm_per_macro} mLSTM + {cfg.xlstm_slstm_per_macro} sLSTM)), d_model "
          f"{cfg.d_model}, {count_params(params)} params ({params['embed'].dtype}, {cfg.dtype} "
          f"compute), init {time.perf_counter() - t0:.1f} s", flush=True)
    seq = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT + 1), generator=gen, device=dev)
    batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}

    def against_forward(c, p, fed=None):
        """prefill of the prompt, XLSTM_STEPS decode steps (greedy, or fed the
        tokens ``fed``), then the forward over the prompt and the fed tokens:
        (readings, fed, launches, the forward's logits)."""
        m = build_model(c, device=dev)
        (last, cache), prefill_s, prefill_counts = counted(
            torch, lambda: m.prefill(p, {"tokens": batch["tokens"]}))
        if fed is None:
            first = last.argmax(-1)
            (toks, rows), decode_s, decode_counts = counted(torch, lambda: greedy(
                torch, m, p, cache, first, LM_PROMPT, XLSTM_STEPS, dev))
            fed = torch.cat([first[:, None], toks[:, :-1]], dim=1)
        else:
            def forced():
                nonlocal cache
                out = []
                for i in range(XLSTM_STEPS):
                    pos = torch.full((LM_BATCH,), LM_PROMPT + i, dtype=torch.int32, device=dev)
                    logits, cache = m.decode_step(p, cache, fed[:, i], pos)
                    out.append(logits.float())
                return torch.stack(out)
            rows, decode_s, decode_counts = counted(torch, forced)
        full = torch.cat([batch["tokens"], fed], dim=1)
        logits, forward_s, forward_counts = counted(
            torch, lambda: xlstm.xlstm_forward(p, full, c))
        # the forward's logits at LM_PROMPT - 1 .. LM_PROMPT + XLSTM_STEPS - 1 are the
        # prefill's last and each decode step's
        want = logits[:, LM_PROMPT - 1:].float()
        if (last.shape != (LM_BATCH, c.padded_vocab) or rows.shape[0] != XLSTM_STEPS
                or not (torch.isfinite(want).all() and torch.isfinite(rows).all())):
            raise AssertionError(f"xlstm {c.dtype}: outputs malformed or not finite")
        res = {"prefill_vs_forward": rel_max(last, want[:, 0]),
               "decode_vs_forward_max": max(rel_max(rows[i], want[:, i + 1])
                                            for i in range(XLSTM_STEPS)),
               "forward_s": forward_s, "prefill_s": prefill_s, "decode_s": decode_s,
               "decode_ms_per_step": decode_s / XLSTM_STEPS * 1e3,
               "prefill_tok_s": LM_BATCH * LM_PROMPT / prefill_s,
               "forward_tok_s": full.numel() / forward_s,
               "decode_tok_s": LM_BATCH * XLSTM_STEPS / decode_s}
        counts = {"prefill": prefill_counts, "decode": decode_counts, "forward": forward_counts}
        return res, fed, counts, (full, want)

    torch.cuda.reset_peak_memory_stats()
    f32 = cfg.replace(dtype="float32")
    macro = f32.replace(n_layers=cfg.xlstm_mlstm_per_macro + cfg.xlstm_slstm_per_macro)
    with torch.inference_mode():
        model.loss_fn(params, {k: v[:1, :32] for k, v in batch.items()})  # warm-up
        loss, loss_s, loss_counts = counted(torch, lambda: float(model.loss_fn(params, batch)))
        res, fed, launches, _ = against_forward(cfg, params)
        twin, _, twin_launches, (full, want) = against_forward(f32, params, fed)
        nudged = {**params, "embed": params["embed"] * (1 + 2.0 ** -23)}
        floor = rel_max(xlstm.xlstm_forward(nudged, full, f32)[:, LM_PROMPT:].float(),
                        want[:, 1:])
        del nudged, full, want
        one, _, one_launches, _ = against_forward(
            macro, {**params, "macros": tree_map(lambda a: a[:1], params["macros"])}, fed)
    launches.update(loss_fn=loss_counts, **{f"float32_{k}": v for k, v in twin_launches.items()},
                    **{f"macro_{k}": v for k, v in one_launches.items()})
    if any(launches.values()):
        raise AssertionError(f"xlstm: hand kernels launched: {launches}")
    if not math.isfinite(loss):
        raise AssertionError(f"xlstm: loss {loss}")
    res = {"loss": loss, "loss_s": loss_s, **res, "float32": twin,
           "float32_nudged_forward_vs_forward": floor,
           f"float32_{macro.n_layers}_layers": one,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "phase_s": time.perf_counter() - phase_start}
    print("xlstm: " + json.dumps(res), flush=True)
    held = {"prefill_vs_forward": res["prefill_vs_forward"],
            "float32_prefill_vs_forward": twin["prefill_vs_forward"],
            "one_macro_prefill_vs_forward": one["prefill_vs_forward"],
            "one_macro_decode_vs_forward": one["decode_vs_forward_max"]}
    if max(held.values()) > 0.1:
        raise AssertionError(f"xlstm: a prefill, or a decode step over one macro block, "
                             f"disagrees with the forward by more than 0.1 of the logits' "
                             f"max: {held}")
    return {}


def gemma_full(torch, dev) -> tuple:
    """gemma-2b at full width and depth with the flash kernel, its params
    made on the card from a seeded generator."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("gemma-2b").replace(attn_impl="pallas")
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    return cfg, model, params


def guard_path(torch, dev, cfg, model, params) -> dict:
    """Phase 9: the numerics guard on the card (see the module docstring)."""
    from repro_torch.kernels import _util, api, guard

    phase_start = time.perf_counter()
    h100 = guard.GuardConfig(hw="nvidia-h100-sxm")
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), generator=gen, device=dev)
    with guard.isolated(h100):
        _util.reset_launch_counts()
        with torch.inference_mode(), api.kernel_policy(guard="shadow"):
            last, _ = model.prefill(params, {"tokens": prompts})
            sweep = guard.verify_ops()
        torch.cuda.synchronize()
        counts = _util.launch_counts()
        m = guard.metrics()
        shadowed = dict(guard.state()._calls)
        clean = m.summary()
        quarantined = guard.quarantined_ops()
    checks = {op: shadowed.get(op, 0) + int(sweep[op].checked > 0) for op in sweep}
    print(f"guard: clean shadow run: checks by op {checks}, {json.dumps(clean)}, sweep "
          + json.dumps({op: {"ok": r.ok, "max_ulp": r.max_ulp, "backend": r.backend}
                        for op, r in sweep.items()}), flush=True)
    if not torch.isfinite(last.float()).all():
        raise AssertionError("guard: the guarded prefill's logits are not finite")
    if (min(checks["flash_attention"], checks["matmul"]) <= 0 or shadowed.get("flash_attention")
            != cfg.n_layers or not all(r.ok and r.backend == "cuda" for r in sweep.values())):
        raise AssertionError(f"guard: checks {checks}, sweep {sweep}")
    if (clean["drift_events"] or clean["faults"] or clean["degraded_calls"]
            or clean["saturation_events"] or clean["max_saturation_fraction"] or quarantined):
        raise AssertionError(f"guard: the clean run saw {clean}, quarantined {quarantined}")
    if counts.get("flash_attention", 0) < cfg.n_layers + 1 or not counts.get("axpy"):
        raise AssertionError(f"guard: launches {counts}")

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.bench", "run", "--guard", "shadow", "--only",
             "gemm_lp", "--quick", "--out", os.path.join(tmp, "r.json")],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
            capture_output=True, text=True, timeout=600)
    line = [ln for ln in proc.stderr.splitlines() if ln.startswith("guard[")]
    print(f"guard: bench run --guard shadow --only gemm_lp --quick: rc {proc.returncode}, "
          f"{line}", flush=True)
    if proc.returncode != 0 or not line or " 0 drift, 0 saturation, 0 faults" not in line[0]:
        raise AssertionError(f"guard: bench run --guard failed:\n{proc.stdout}\n{proc.stderr}")

    with guard.isolated(guard.GuardConfig(hw="nvidia-h100-sxm", on_drift="oracle")):
        guard.inject_drift("flash_attention", scale=0.05, seed=0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            with torch.inference_mode(), api.kernel_policy(guard="shadow"):
                drifted, _ = model.prefill(params, {"tokens": prompts})
        caught = guard.metrics().summary()
        quarantined = guard.quarantined_ops()
        guard.clear_drift("flash_attention")
        probed = guard.probe("flash_attention")
        guard.revive("flash_attention")
        after = guard.quarantined_ops()
    print(f"guard: injected drift into flash_attention: {json.dumps(caught)}, quarantined "
          f"{quarantined}, probe after clearing {probed}, quarantined after revive {after}",
          flush=True)
    if (caught["drift_events"] < 1 or quarantined != ("flash_attention",)
            or caught["quarantined_ops"] != ["flash_attention"] or caught["degraded_calls"] < 1
            or not probed or after):
        raise AssertionError(f"guard: injected drift was not handled: {caught}")
    rel = float((drifted.float() - last.float()).abs().max() / last.float().abs().max())
    print(f"guard: logits served through the quarantine against the clean run: max rel {rel:.3e}",
          flush=True)

    with guard.isolated(h100):
        k = 140_000  # 127 * 127 * 140,000 > 2^31 - 1
        a = torch.full((16, k), 127, dtype=torch.int8, device=dev)
        b = torch.full((k, 16), 127, dtype=torch.int8, device=dev)
        try:
            with api.kernel_policy(guard="shadow"):
                api.matmul(a, b, out_dtype=torch.int32)
        except guard.SaturationError as err:
            print(f"guard: int8 matmul past int32's max: SaturationError ({err})", flush=True)
        else:
            raise AssertionError("guard: an int8 matmul past int32's max did not raise")
        if guard.quarantined_ops():
            raise AssertionError("guard: saturation quarantined an op")
    print(f"guard: phase {time.perf_counter() - phase_start:.1f} s", flush=True)
    return counts


def direct_tokens(torch, model, params, prompts, dev) -> tuple:
    """The serving phase's reference: the prompts in lanes of SERVE_SLOTS,
    each group prefilled through ``decode_chunk`` (SERVE_CHUNK tokens a call,
    ragged lanes padded with the cache length) and decoded greedily through
    ``decode_step``.  Returns the tokens and each prompt's last logits row."""
    out, rows = [], []
    for g in range(0, len(prompts), SERVE_SLOTS):
        group = prompts[g:g + SERVE_SLOTS]
        cache = model.init_cache(SERVE_SLOTS, SERVE_MAX_LEN)
        width = -(-max(map(len, group)) // SERVE_CHUNK) * SERVE_CHUNK
        toks = torch.zeros((SERVE_SLOTS, width), dtype=torch.int32)
        poss = torch.full((SERVE_SLOTS, width), SERVE_MAX_LEN, dtype=torch.int32)
        for i, p in enumerate(group):
            toks[i, :len(p)] = torch.tensor(p, dtype=torch.int32)
            poss[i, :len(p)] = torch.arange(len(p), dtype=torch.int32)
        last = [None] * SERVE_SLOTS
        for c in range(0, width, SERVE_CHUNK):
            logits, cache = model.decode_chunk(params, cache, toks[:, c:c + SERVE_CHUNK].to(dev),
                                               poss[:, c:c + SERVE_CHUNK].to(dev))
            for i, p in enumerate(group):
                if c < len(p) <= c + SERVE_CHUNK:
                    last[i] = logits[i, len(p) - 1 - c]
        rows.extend(last[:len(group)])
        last = [int(r.argmax()) if r is not None else None for r in last]
        tok = torch.tensor([t if t is not None else 0 for t in last], dtype=torch.int32,
                           device=dev)
        pos = torch.tensor([len(p) for p in group] + [SERVE_MAX_LEN] * (SERVE_SLOTS - len(group)),
                           dtype=torch.int32, device=dev)
        gen = [[last[i]] for i in range(len(group))]
        for _ in range(SERVE_NEW - 1):
            logits, cache = model.decode_step(params, cache, tok, pos)
            tok = logits.argmax(-1).to(torch.int32)
            pos = pos + 1
            for i, t in enumerate(tok[:len(group)].tolist()):
                gen[i].append(t)
        out.extend(gen)
    return out, rows


def chunk_flash_check(torch, cfg, model, params, prompts, served_rows, dev) -> list:
    """``decode_chunk``'s logits at each prompt's last position against
    ``model.prefill``'s last logits, the flash kernel's path: an independent
    route to the same numbers (its launches compare, they are not counted).
    Gated in float32 compute on the same params, at ``tolerance(float32,
    "nvidia-h100-sxm")``.  In bf16, 18 layers of rounding put any two
    attention paths ~10 ulps of bf16 apart near zero, past the guard's
    per-kernel 4, so the served bf16 rows are reported against the bf16
    flash prefill beside the plain (blockwise) prefill's own distance from
    it, the noise floor."""
    from repro_torch.kernels import guard
    from repro_torch.models import build_model

    h100 = "nvidia-h100-sxm"
    tol32, tol16 = guard.tolerance(torch.float32, h100), guard.tolerance(torch.bfloat16, h100)
    m32 = build_model(cfg.replace(dtype="float32"), device=dev)
    plain = build_model(cfg.replace(attn_impl="blockwise"), device=dev)

    def report(got, want, tol):
        r = guard.compare(got, want, tol, op="decode_chunk", backend="torch")
        return {"ok": r.ok, "max_ulp": r.max_ulp, "max_abs": r.max_abs}

    out = []
    for p, served in zip(prompts, served_rows):
        toks = torch.tensor([p], dtype=torch.int32, device=dev)
        cache = m32.init_cache(1, SERVE_MAX_LEN)
        for c in range(0, len(p), SERVE_CHUNK):
            n = min(SERVE_CHUNK, len(p) - c)
            pos = torch.arange(c, c + n, dtype=torch.int32, device=dev)[None]
            logits, cache = m32.decode_chunk(params, cache, toks[:, c:c + n], pos)
        flash32, _ = m32.prefill(params, {"tokens": toks})
        flash, _ = model.prefill(params, {"tokens": toks})
        blockwise, _ = plain.prefill(params, {"tokens": toks})
        out.append({"len": len(p), "row_max": float(flash32.abs().max()),
                    "float32": report(logits[:, n - 1], flash32, tol32),
                    "bf16_served": report(served[None], flash, tol16),
                    "bf16_blockwise": report(blockwise, flash, tol16)})
    return out


def device_busy_us(events) -> float:
    """Length of the union of the events' time ranges (us)."""
    busy, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def serve_prompts(cfg) -> tuple:
    """Phases 10 and 11's requests: SERVE_REQUESTS prompts of SERVE_PROMPT_LENS
    tokens from numpy seed 0, each opening with one shared SERVE_PREFIX-token
    prefix; returns (prompts, prefix)."""
    import numpy as np

    rng = np.random.default_rng(0)
    lens = rng.integers(SERVE_PROMPT_LENS[0], SERVE_PROMPT_LENS[1] + 1, SERVE_REQUESTS)
    prefix = [int(t) for t in rng.integers(1, cfg.vocab_size, SERVE_PREFIX)]
    prompts = [prefix + [int(t) for t in rng.integers(1, cfg.vocab_size, n - SERVE_PREFIX)]
               for n in lens]
    return prompts, prefix


def serving_path(torch, dev, cfg, model, params) -> tuple:
    """Phase 10: the serving engine at full width (see the module docstring).
    Returns the launch counts and the dense engine's results (its tokens are
    phase 11's reference)."""
    from torch.autograd import DeviceType

    from repro_torch.core.timing import percentile
    from repro_torch.kernels import _util, guard
    from repro_torch.serve import EngineConfig, ServeEngine

    phase_start = time.perf_counter()
    prompts, prefix = serve_prompts(cfg)
    base = dict(n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, prefill_chunk=SERVE_CHUNK,
                guard="sample", degrade=False)
    results, engines = {}, {}
    with guard.isolated(guard.GuardConfig(hw="nvidia-h100-sxm")), torch.inference_mode():
        _util.reset_launch_counts()
        for name, extra in (("dense", {}), ("paged", {"page_size": SERVE_PAGE})):
            eng = ServeEngine(model, params, EngineConfig(**base, **extra))
            if name == "paged":
                eng.register_prefix(prefix)
                if eng._table_width * SERVE_PAGE != SERVE_MAX_LEN:
                    raise AssertionError("serving: the block table does not span max_len")
            eng.submit(prompts[0][:SERVE_PREFIX + 8], 4)  # warm-up: first calls of both steps
            eng.run()
            eng.reset_metrics()
            t0 = time.perf_counter()
            sessions = [eng.submit(p, SERVE_NEW) for p in prompts]
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            m = eng.metrics
            s = eng.summary()
            results[name] = {
                "tokens": [x.out for x in sessions],
                "finished": [x.finish_reason for x in sessions],
                "wall_s": wall, "ttft_ms_p50": s["ttft_ms_p50"],
                "ttft_ms_max": max(m.ttft_s) * 1e3,  # 8 requests: a p99 is their max
                "tok_latency_ms_p50": s["tok_latency_ms_p50"],
                "tok_latency_ms_p99": percentile(m.token_latency_s, 99) * 1e3,
                "throughput_tok_s": s["throughput_tok_s"], "prefill_tok_s": s["prefill_tok_s"],
                "concurrency": s["concurrency"], "ticks": s["ticks"],
                "prefix_tokens_reused": s["prefix_tokens_reused"], "pages_peak": s["pages_peak"],
                "guard_checks": s["guard_checks"], "drift_events": s["drift_events"],
                "degradations": s["degradations"], "op_degradations": s["op_degradations"],
                "degraded": eng._degraded,
            }
            engines[name] = eng
            print(f"serving {name} (smoke reading, {SERVE_REQUESTS} requests): "
                  + json.dumps({k: v for k, v in results[name].items() if k != "tokens"}),
                  flush=True)
        counts = _util.launch_counts()
        gm = guard.metrics().summary()
        quarantined = guard.quarantined_ops()
        direct, last_rows = direct_tokens(torch, model, params, prompts, dev)
        chunk_vs_flash = chunk_flash_check(torch, cfg, model, params, prompts, last_rows, dev)

        # one traced dense decode step with every lane active
        eng = engines["dense"]
        eng.reset_metrics()
        for p in prompts[:SERVE_SLOTS]:
            eng.submit(p[:SERVE_PREFIX], 8)
        eng.step()  # admission, prefill and the first decode
        eng.step()  # a decode step, untraced
        t0 = time.perf_counter()
        eng.step()
        untraced_s = time.perf_counter() - t0
        if sum(x is not None for x in eng.slots) != SERVE_SLOTS:
            raise AssertionError("serving: the traced step does not have every lane active")
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        checks_before = eng.metrics.guard_checks
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            eng.step()
            traced_s = time.perf_counter() - t0
        shadow_checked = eng.metrics.guard_checks > checks_before
        eng.run()
    if any(r != "max_new_tokens" for res in results.values() for r in res["finished"]):
        raise AssertionError(f"serving: not every request finished: "
                             f"{[res['finished'] for res in results.values()]}")
    same_dp = results["dense"]["tokens"] == results["paged"]["tokens"]
    same_direct = results["dense"]["tokens"] == direct
    print(f"serving: tokens dense == paged {same_dp}, dense == direct decode_chunk/decode_step "
          f"{same_direct}; guard {json.dumps(gm)} (the steps launch no hand kernel: each "
          f"check compares torch with torch); launches {counts}", flush=True)
    print("serving: decode_chunk's last logits against the flash prefill's (float32 gated "
          "at 256 ulp; bf16 reported beside the blockwise prefill's spread from flash): "
          + json.dumps(chunk_vs_flash), flush=True)
    bad = [r for r in chunk_vs_flash if not r["float32"]["ok"]]
    if bad:
        raise AssertionError(f"serving: decode_chunk disagrees with the flash prefill: {bad}")
    if not (same_dp and same_direct):
        diff = [(i, a[:8], b[:8], c[:8]) for i, (a, b, c) in
                enumerate(zip(results["dense"]["tokens"], results["paged"]["tokens"], direct))
                if not a == b == c]
        raise AssertionError(f"serving: token streams differ: {diff}")
    if (any(res["degraded"] or res["degradations"] or res["drift_events"]
            or res["op_degradations"] for res in results.values())
            or gm["drift_events"] or quarantined or not results["dense"]["guard_checks"]):
        raise AssertionError(f"serving: guard or degradation activity: {gm}, {results}")
    if results["paged"]["prefix_tokens_reused"] != SERVE_REQUESTS * SERVE_PREFIX:
        raise AssertionError(f"serving: prefix reuse {results['paged']['prefix_tokens_reused']}")
    if counts:
        raise AssertionError(f"serving: the engine's steps launched hand kernels: {counts}")

    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in dev_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    busy_us = device_busy_us(dev_events)
    trace = {
        "step_wall_ms": traced_s * 1e3, "untraced_step_wall_ms": untraced_s * 1e3,
        "shadow_checked": shadow_checked,
        "device_ops": len(dev_events), "device_busy_ms": busy_us / 1e3,
        "busy_share": busy_us / 1e3 / (traced_s * 1e3),
        "idle_share": 1.0 - busy_us / 1e3 / (traced_s * 1e3),
        "top5_device_ms": [(n[:90], us / 1e3) for n, us in top],
    }
    print("serving: decode-step trace (4 active lanes): " + json.dumps(trace), flush=True)
    if not dev_events:
        raise AssertionError("serving: the profiler saw no device operation in the decode step")
    print(f"serving: phase {time.perf_counter() - phase_start:.1f} s", flush=True)
    return counts, results["dense"]


# phase 11: the serving cluster at full width


def leg_timing(torch, cluster, sessions, wall) -> dict:
    """A cluster leg's wall time, tokens/s and pooled TTFT / per-token
    percentiles (p99 over 8 requests is their maximum: smoke readings)."""
    from repro_torch.core.timing import percentile

    ttft = [t for r in cluster.replicas for t in r.engine.metrics.ttft_s]
    gaps = [g for r in cluster.replicas for g in r.engine.metrics.token_latency_s]
    generated = sum(len(s.out) for s in sessions)
    return {"wall_s": wall, "tok_s": generated / wall,
            "ttft_ms_p50": percentile(ttft, 50) * 1e3, "ttft_ms_p99": percentile(ttft, 99) * 1e3,
            "tok_latency_ms_p50": percentile(gaps, 50) * 1e3,
            "tok_latency_ms_p99": percentile(gaps, 99) * 1e3}


def lane_logits(torch, model, params, feed, steps, dev, mesh=None):
    """The logits row after ``feed`` (prefilled through ``decode_chunk``,
    SERVE_CHUNK tokens a call) and then ``steps`` fed one at a time through
    ``decode_step``, with the request in lane 0 of SERVE_SLOTS lanes (the
    others padded), as an engine tick computes it; on a tensor-parallel
    ``mesh`` the cache is this rank's part, as the engine places it."""
    cache = model.init_cache(SERVE_SLOTS, SERVE_MAX_LEN)
    if mesh is not None:
        from repro_torch.dist import cache_shardings, shard_tree

        cache = shard_tree(cache, cache_shardings(cache, model.cfg, mesh))
    width = -(-len(feed) // SERVE_CHUNK) * SERVE_CHUNK
    toks = torch.zeros((SERVE_SLOTS, width), dtype=torch.int32)
    poss = torch.full((SERVE_SLOTS, width), SERVE_MAX_LEN, dtype=torch.int32)
    toks[0, :len(feed)] = torch.tensor(feed, dtype=torch.int32)
    poss[0, :len(feed)] = torch.arange(len(feed), dtype=torch.int32)
    for c in range(0, width, SERVE_CHUNK):
        logits, cache = model.decode_chunk(params, cache, toks[:, c:c + SERVE_CHUNK].to(dev),
                                           poss[:, c:c + SERVE_CHUNK].to(dev))
        if c < len(feed) <= c + SERVE_CHUNK:
            row = logits[0, len(feed) - 1 - c]
    pad = torch.full((SERVE_SLOTS,), SERVE_MAX_LEN, dtype=torch.int32)
    for i, t in enumerate(steps):
        tok = torch.zeros((SERVE_SLOTS,), dtype=torch.int32)
        tok[0] = t
        pos = pad.clone()
        pos[0] = len(feed) + i
        logits, cache = model.decode_step(params, cache, tok.to(dev), pos.to(dev))
        row = logits[0]
    return row.float()


def flip_report(torch, model, params, prompt, want, got, dev) -> dict:
    """Where a served stream first differs from the reference: the position,
    both tokens, the top-2 logit margin there on the ``decode_step`` route
    (the uninterrupted run's) and on the ``decode_chunk`` route (a resumed
    run re-prefills prompt + output through it), and the two routes'
    largest logit distance at that position."""
    j = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    step = (lane_logits(torch, model, params, prompt, want[:j], dev) if j
            else lane_logits(torch, model, params, prompt, [], dev))
    chunk = lane_logits(torch, model, params, prompt + want[:j], [], dev)

    def margin(row):
        top = torch.topk(row, 2).values
        return float(top[0] - top[1])

    return {"position": j, "want": want[j], "got": got[j], "margin_step": margin(step),
            "margin_chunk": margin(chunk),
            "step_vs_chunk_max_abs": float((step - chunk).abs().max())}


def identity(torch, leg, got, want, model, params, prompts, dev, twin=None) -> str:
    """The identity rule of phase 11: every stream equals the reference.  A
    leg that resumed requests through ``decode_chunk`` (``twin`` given) may
    differ in bf16 only where the reference's top-2 margin lies within the
    step-vs-chunk distance at that position, and only if its float32 twin
    (``twin()`` -> (got, want) in float32 compute) is identical; each flip is
    printed.  Anything else fails the run."""
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if not bad and len(got) == len(want):
        return "identical"
    reports = {i: flip_report(torch, model, params, prompts[i], want[i], got[i], dev)
               for i in bad}
    print(f"cluster {leg}: bf16 streams differ from the reference: " + json.dumps(reports),
          flush=True)
    if twin is None:
        raise AssertionError(f"cluster {leg}: token streams differ: {reports}")
    got32, want32 = twin()
    if got32 != want32:
        raise AssertionError(f"cluster {leg}: the float32 twin differs too")
    loose = {i: r for i, r in reports.items() if r["margin_step"] > r["step_vs_chunk_max_abs"]}
    if loose:
        raise AssertionError(f"cluster {leg}: flips past the step-vs-chunk distance: {loose}")
    print(f"cluster {leg}: float32 twin identical; every bf16 flip within the "
          f"step-vs-chunk distance (kept deviation)", flush=True)
    return "bf16 flips within the step-vs-chunk distance; float32 twin identical"


@contextlib.contextmanager
def straggler_watch():
    """Record, while open, every straggler flag any ``StragglerDetector``
    raises and each worker's largest EWMA inflation over the fleet median
    (the ratio the cluster's threshold is held against)."""
    from repro_torch.ft import StragglerDetector

    log = {"flags": [], "max_inflation": {}}
    real = StragglerDetector.stragglers

    def stragglers(det):
        med = det.fleet_median()
        for w, v in det._ewma.items():
            if med:
                log["max_inflation"][w] = max(log["max_inflation"].get(w, 0.0), v / med)
        out = real(det)
        if out:
            log["flags"].append(out)
        return out

    StragglerDetector.stragglers = stragglers
    try:
        yield log
    finally:
        StragglerDetector.stragglers = real


def cluster_path(torch, dev, cfg, model, params, single) -> dict:
    """Phase 11: the serving cluster at full width (see the module docstring).
    ``single`` is phase 10's dense engine: its tokens are the reference."""
    import io

    from repro_torch.bench.suites.serving_chaos import _fault_plan, _guard_fault_plan
    from repro_torch.kernels import _util, guard
    from repro_torch.launch import serve as launcher
    from repro_torch.models import build_model
    from repro_torch.serve import (ClusterConfig, ClusterRouter, EngineConfig, FaultInjector,
                                   HealthConfig, ServeEngine)
    from repro_torch.serve.cluster import BREAKER_CLOSED

    phase_start = time.perf_counter()
    prompts, prefix = serve_prompts(cfg)
    want = single["tokens"]
    # the cuda backend (the card's default) named, so injected step faults fire
    base = dict(n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, prefill_chunk=SERVE_CHUNK,
                backend="cuda")
    counts: dict = {}

    def serve(leg, ccfg, *, m=model, plan=None, before=None, register=False):
        """Submit every prompt, run (through ``plan``'s injector when given)
        and check that every request finished."""
        cluster = ClusterRouter(m, params, ccfg)
        if register:
            cluster.register_prefix(prefix)
        t0 = time.perf_counter()
        sessions = [cluster.submit(p, SERVE_NEW) for p in prompts]
        if before is not None:
            before(cluster)
        injector = FaultInjector(plan, cluster) if plan is not None else None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # the chaos legs' degrade notes
            if injector is not None:
                injector.run()
            else:
                cluster.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        reasons = [s.finish_reason for s in sessions]
        if reasons != ["max_new_tokens"] * len(prompts):
            raise AssertionError(f"cluster {leg}: not every request finished: {reasons}")
        return cluster, sessions, injector, wall

    def report(leg, cluster, sessions, wall, keys=(), **extra):
        """Print a leg's timings, placement, failovers and the summary's
        ``keys``; returns the summary."""
        s = cluster.summary()
        row = {**leg_timing(torch, cluster, sessions, wall),
               "requests_per_replica": [r["requests"] for r in s["per_replica"]],
               "failovers": s["failovers"], "requeues": s["requeues"],
               **{k: s[k] for k in keys}, **extra}
        print(f"cluster {leg}: " + json.dumps(row), flush=True)
        return s

    def twin(leg_fn):
        """Float32 compute over the same params: the leg and one engine."""
        m32 = build_model(cfg.replace(dtype="float32"), device=dev)
        eng = ServeEngine(m32, params, EngineConfig(**base))
        ref = [eng.submit(p, SERVE_NEW) for p in prompts]
        eng.run()
        return [s.out for s in leg_fn(m32)], [s.out for s in ref]

    identities = {}  # leg -> what the identity rule found
    with torch.inference_mode():
        # leg 1: two dense replicas under least_loaded equal one engine
        torch.cuda.reset_peak_memory_stats()
        dense = ClusterConfig(engine=EngineConfig(**base), n_replicas=CLUSTER_REPLICAS)
        cluster, sessions, _, wall = serve("leg 1 (dense, least_loaded)", dense)
        peak = torch.cuda.max_memory_allocated()
        shared = all(r.engine.params is params and r.engine.model is model
                     for r in cluster.replicas)
        s1 = report("leg 1 (dense, least_loaded)", cluster, sessions, wall,
                    max_memory_allocated_gb=peak / 1e9,
                    phase10_max_memory_allocated_gb=single["max_memory_allocated"] / 1e9,
                    phase10_tok_s=single["throughput_tok_s"], params_shared=shared)
        identities["leg 1"] = identity(torch, "leg 1", [x.out for x in sessions], want, model,
                                       params, prompts, dev)
        per = [r["requests"] for r in s1["per_replica"]]
        if not shared or sum(per) != SERVE_REQUESTS or min(per) == 0:
            raise AssertionError(f"cluster leg 1: requests per replica {per}, "
                                 f"params shared {shared}")

        # leg 2: paged, the prefix registered once, prefix affinity
        paged = ClusterConfig(engine=EngineConfig(**base, page_size=SERVE_PAGE),
                              n_replicas=CLUSTER_REPLICAS, router="prefix_affinity")
        cluster, sessions, _, wall = serve("leg 2", paged, register=True)
        placed = {cluster._placement[x.rid] for x in sessions}
        s2 = report("leg 2 (paged, prefix_affinity)", cluster, sessions, wall,
                    ("prefix_tokens_reused", "prefix_hits"), replicas_used=sorted(placed))
        identities["leg 2"] = identity(torch, "leg 2", [x.out for x in sessions], want, model,
                                       params, prompts, dev)
        if s2["prefix_tokens_reused"] <= 0 or s2["prefix_hits"] <= 0 or placed != {0}:
            raise AssertionError(f"cluster leg 2: prefix reuse {s2['prefix_tokens_reused']}, "
                                 f"hits {s2['prefix_hits']}, replicas {placed}")

        # leg 3: replica 1 fails after CLUSTER_FAIL_AFTER ticks
        def fail_one(cluster):
            for _ in range(CLUSTER_FAIL_AFTER):
                cluster.step()
            cluster.fail_replica(1)

        def leg3(m):
            return serve("leg 3", dense, m=m, before=fail_one)[1]

        cluster, sessions, _, wall = serve("leg 3", dense, before=fail_one)
        s3 = report("leg 3 (fail_replica(1) after 4 ticks)", cluster, sessions, wall,
                    ("requeued_sessions",))
        identities["leg 3"] = identity(torch, "leg 3", [x.out for x in sessions], want, model,
                                       params, prompts, dev, twin=lambda: twin(leg3))
        if s3["failovers"] != {"manual": 1} or not s3["requeued_sessions"]:
            raise AssertionError(f"cluster leg 3: {s3['failovers']}, {s3['requeued_sessions']}")

        # leg 4: health at the reference's defaults, clean and under _fault_plan()
        health = ClusterConfig(engine=EngineConfig(**base, page_size=SERVE_PAGE, degrade=True),
                               n_replicas=CLUSTER_REPLICAS, router="round_robin",
                               health=HealthConfig())
        flags = {}
        for run, plan in (("clean", None), ("faulted", _fault_plan())):
            def leg4(m, plan=plan):
                return serve(f"leg 4 {run}", health, m=m, plan=plan)[1]

            with straggler_watch() as log:
                cluster, sessions, injector, wall = serve(f"leg 4 {run}", health, plan=plan)
            s4 = report(f"leg 4 {run} (HealthConfig())", cluster, sessions, wall,
                        ("availability", "quarantines", "nan_events", "degradations",
                         "half_opens", "revivals"),
                        straggler_flags=log["flags"], max_inflation=log["max_inflation"],
                        injector=injector.summary() if injector else None)
            flags[run] = log
            identities[f"leg 4 {run}"] = identity(
                torch, f"leg 4 {run}", [x.out for x in sessions], want, model, params,
                prompts, dev, twin=lambda leg4=leg4: twin(leg4))
            if run == "faulted":
                inj = injector.summary()
                if (s4["failovers"].get("heartbeat") != 1 or s4["half_opens"] < 1
                        or s4["revivals"] < 1
                        or cluster.replicas[0].breaker != BREAKER_CLOSED
                        or s4["quarantines"] != 1 or s4["nan_events"] != 1
                        or s4["degradations"] != 1
                        or inj["applied"] != {"crash": 1, "straggler": 1, "kernel_fault": 1,
                                              "kernel_drift": 0, "nan_logits": 1,
                                              "page_pressure": 1}):
                    raise AssertionError(f"cluster leg 4 faulted: {s4}, injector {inj}")

        # leg 5: the guarded legs' plan on the card; revival probes run the kernels
        guarded = ClusterConfig(
            engine=EngineConfig(**base, degrade=True, guard="shadow", guard_cooldown=2),
            n_replicas=CLUSTER_REPLICAS, router="round_robin",
            health=HealthConfig(heartbeat_timeout=2, min_samples=3, margin=0.25, cooldown=6,
                                warmup_ticks=6, straggler=False))
        revival_launches: dict = {}
        real_probe = guard.probe

        def probe(op):
            before = _util.launch_counts()
            ok = real_probe(op)
            torch.cuda.synchronize()
            after = _util.launch_counts()
            for k, v in after.items():
                if v > before.get(k, 0):
                    revival_launches.setdefault(op, {})
                    revival_launches[op][k] = revival_launches[op].get(k, 0) + v - before.get(k, 0)
            return ok

        with guard.isolated(guard.GuardConfig(hw=CARD_HW)):
            _util.reset_launch_counts()
            guard.probe = probe
            try:
                cluster, sessions, injector, wall = serve("leg 5", guarded,
                                                          plan=_guard_fault_plan())
            finally:
                guard.probe = real_probe
            torch.cuda.synchronize()
            add_counts(counts, _util.launch_counts())
            gm = guard.metrics().summary()
            quarantined = guard.quarantined_ops()
        drift_calls = sum(r.engine._injected_drift_calls for r in cluster.replicas)
        summ = report("leg 5 (guarded, _guard_fault_plan())", cluster, sessions, wall,
                      ("drift_events", "op_degradations", "op_revivals", "degradations"),
                      injected_drift=drift_calls, guard=gm,
                      revival_probe_launches=revival_launches, launches=dict(counts))
        identities["leg 5"] = identity(torch, "leg 5", [x.out for x in sessions], want, model,
                                   params, prompts, dev)
        if (drift_calls < 1 or summ["drift_events"] != drift_calls
                or set(gm["quarantined_ops"]) != {"matmul", "flash_attention"}
                or summ["op_degradations"] != 2 or summ["op_revivals"] != 2
                or summ["degradations"] or quarantined
                or revival_launches.get("matmul", {}).get("matmul", 0) <= 0
                or revival_launches.get("flash_attention", {}).get("flash_attention", 0) <= 0):
            raise AssertionError(f"cluster leg 5: {summ}, launches {revival_launches}")
        del cluster, sessions, injector

    # leg 6: the launcher at full width, in-process, with its own params
    torch.cuda.empty_cache()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), torch.inference_mode(), straggler_watch() as log:
        finished = launcher.main(LAUNCH_ARGV)
    flags["launcher"] = log
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    for ln in lines:
        print(f"cluster leg 6 (launcher): {ln}", flush=True)
    heads = {ln.split(":")[0] for ln in lines}
    print(f"cluster leg 6 (launcher): python -m repro_torch.launch.serve {' '.join(LAUNCH_ARGV)}: "
          f"{len(finished)} finished in {wall:.1f} s (params made on the card included)",
          flush=True)
    if (len(finished) != 8 or any(x.finish_reason != "max_new_tokens" for x in finished)
            or not {"cluster", "chaos", "robustness"} <= heads):
        raise AssertionError(f"cluster leg 6: {len(finished)} finished, lines {lines}")
    del finished
    torch.cuda.empty_cache()
    print(f"cluster: tokens against phase 10's dense engine: {json.dumps(identities)}",
          flush=True)
    print(f"cluster: straggler flags and largest EWMA inflations (leg 4 clean, leg 4 "
          f"faulted, the launcher; threshold 1.1215): {json.dumps(flags)}", flush=True)
    print(f"cluster: phase {time.perf_counter() - phase_start:.1f} s", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 12: training
# ---------------------------------------------------------------------------
def leaf_paths(tree, prefix: str = "") -> list:
    """[(path, tensor)] of a nested dict, depth first."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in leaf_paths(v, f"{prefix}/{k}")]
    return [(prefix[1:], tree)]


def params_rule(torch, got, want, sum_lr) -> dict:
    """tests/test_torch_train.py's rule for params after AdamW steps: each
    leaf within tolerance(float32, "nvidia-h100-sxm") but for at most 1 % of
    its elements (at least one), every element within a quarter of the
    summed lr (AdamW's update g / (|g| + eps) is steepest, 1/eps, at a zero
    grad).  Returns the readings; raises past the rule."""
    from repro_torch.kernels import guard

    tol = guard.tolerance(torch.float32, CARD_HW)
    outside, worst = 0, 0.0
    for (name, a), (_, b) in zip(leaf_paths(got), leaf_paths(want)):
        err = (a.float().cpu() - b.float().cpu()).abs()
        n = int((err > tol.atol + tol.rtol * b.float().cpu().abs()).sum())
        outside, worst = outside + n, max(worst, float(err.max()))
        if n > max(1, b.numel() // 100) or float(err.max()) > 0.25 * sum_lr:
            raise AssertionError(f"train: leaf {name} has {n} of {b.numel()} elements outside "
                                 f"256 ulps, the worst {float(err.max())} (sum of lr {sum_lr})")
    return {"elements_outside_256_ulps": outside, "max_abs_err": worst,
            "max_abs_err_over_sum_lr": worst / sum_lr}


def train_path(torch, dev) -> dict:
    """Phase 12: training (see the module docstring).  Returns the launch
    counts of (a)'s steps, which must be none."""
    import importlib.util

    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline, SyntheticLM
    from repro_torch.kernels import _util, api
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params, tree_map
    from repro_torch.optim import AdamW, cosine_with_warmup, global_norm
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.step import TrainState, make_train_step, value_and_grad

    phase_start = time.perf_counter()
    # (a) gemma-2b at full width and depth, as the reference trains it
    cfg = get_config("gemma-2b")
    if (cfg.attn_impl, cfg.remat, cfg.remat_policy, cfg.dtype, cfg.param_dtype) != (
            "blockwise", True, "full", "bfloat16", "float32"):
        raise AssertionError(f"train: gemma-2b's config trains on {cfg}")
    model = build_model(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    print(f"train: {cfg.name}, {count_params(params)} fp32 params, attn_impl {cfg.attn_impl}, "
          f"remat {cfg.remat_policy}, {cfg.dtype} compute; batches {TRAIN_BATCH} x {TRAIN_SEQ}",
          flush=True)
    src = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    pipe = DataPipeline(src.batch_at, device=dev, prefetch=0)
    first = next(pipe)[1]
    _util.reset_launch_counts()
    loss0, grads = value_and_grad(model.loss_fn, params, first)
    zero = [name for name, g in leaf_paths(grads) if not bool(g.ne(0).any())]
    finite = all(bool(torch.isfinite(g).all()) for _, g in leaf_paths(grads))
    gnorm0 = float(global_norm(grads))
    del grads
    if zero or not finite:
        raise AssertionError(f"train: leaves without a nonzero gradient {zero}; finite {finite}")
    opt = AdamW()
    state = TrainState(params, opt.init(params))
    lr_fn = cosine_with_warmup(TRAIN_LR, 1, TRAIN_STEPS)
    step = make_train_step(model.loss_fn, opt, lr_fn)
    pipe.seek(0)
    steps = []
    for i in range(TRAIN_STEPS):
        batch = next(pipe)[1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])  # waits for the step
        dt = time.perf_counter() - t0
        steps.append({"step": i, "loss": loss, "grad_norm": float(m["grad_norm"]),
                      "lr": float(m["lr"]), "step_s": dt, "tok_s": TRAIN_BATCH * TRAIN_SEQ / dt})
        print(f"train step {i}: " + json.dumps(steps[-1]), flush=True)
    launches = _util.launch_counts()
    with torch.no_grad():
        loss_after = float(model.loss_fn(params, first))
    res = {"loss_first_batch_before": float(loss0), "loss_first_batch_after": loss_after,
           "grad_norm_first_batch": gnorm0, "leaves_with_grad": len(leaf_paths(params)),
           "step_s_median": sorted(r["step_s"] for r in steps[1:])[(TRAIN_STEPS - 1) // 2],
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "launches": launches}
    res["tok_s_median"] = TRAIN_BATCH * TRAIN_SEQ / res["step_s_median"]
    print("train gemma-2b: " + json.dumps(res), flush=True)
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in steps):
        raise AssertionError(f"train: non-finite loss or grad norm: {steps}")
    if not loss_after < float(loss0):
        raise AssertionError(f"train: the first batch's loss did not fall: {res}")
    if launches:
        raise AssertionError(f"train: the training path launched hand kernels: {launches}")
    del state, params, m, step, pipe, first, batch, model
    torch.cuda.empty_cache()

    # (b) the same step at reduced() float32 on the card against the CPU
    rcfg = get_config("gemma-2b").reduced()
    host = build_model(rcfg, device="cpu").init(torch.Generator().manual_seed(0))
    rsrc = SyntheticLM(rcfg.vocab_size, 32, 4, seed=0)
    runs = {}
    for where in ("cpu", dev):
        m_ = build_model(rcfg, device=where)
        o = AdamW()
        p = tree_map(lambda t: t.to(where, copy=True), host)
        st = TrainState(p, o.init(p))
        fn = make_train_step(m_.loss_fn, o, cosine_with_warmup(TRAIN_LR, 0, TRAIN_CPU_STEPS))
        losses = []
        for i in range(TRAIN_CPU_STEPS):
            st, mm = fn(st, {k: torch.from_numpy(v).to(where) for k, v in rsrc.batch_at(i).items()})
            losses.append(float(mm["loss"]))
        runs["cpu" if where == "cpu" else "card"] = (losses, st.params)
    sum_lr = sum(float(cosine_with_warmup(TRAIN_LR, 0, TRAIN_CPU_STEPS)(i))
                 for i in range(TRAIN_CPU_STEPS))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(runs["card"][0], runs["cpu"][0]))
    rule = params_rule(torch, runs["card"][1], runs["cpu"][1], sum_lr)
    reduced = {"losses_card": runs["card"][0], "losses_cpu": runs["cpu"][0],
               "loss_rel_max": loss_rel, **rule}
    print("train reduced float32, card against the CPU: " + json.dumps(reduced), flush=True)
    if loss_rel > 1e-4:
        raise AssertionError(f"train: the card's losses differ from the CPU's: {reduced}")
    del runs

    # (c) examples/train_tiny_lm_torch.py at its defaults, its failure and resume,
    # against the same run uninterrupted (the embedding's backward adds with
    # atomics on the card, so the two agree only within a tolerance)
    spec = importlib.util.spec_from_file_location(
        "train_tiny_lm_torch", os.path.join(ROOT, "examples", "train_tiny_lm_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    argv = ["--device", dev.type]  # the default on the card
    t0 = time.perf_counter()
    resumed = example.main(argv)
    example_s = time.perf_counter() - t0
    args = example.parse_args(argv)
    step_fn, fresh_state, tsrc = example.make_run(args, dev)
    upipe = DataPipeline(tsrc.batch_at, device=dev, prefetch=2)
    try:
        _, whole = train_loop(step_fn, fresh_state(), upipe, cfg=LoopConfig(total_steps=args.steps))
    finally:
        upipe.close()
    diffs = [abs(r["loss"] - whole[r["step"]]["loss"]) for r in resumed]
    example_res = {"example_s": example_s, "resumed_from": resumed[0]["step"],
                   "resumed_steps": len(resumed), "loss_first": whole[0]["loss"],
                   "loss_last_resumed": resumed[-1]["loss"],
                   "loss_last_uninterrupted": whole[-1]["loss"],
                   "resumed_vs_uninterrupted_max_abs": max(diffs)}
    print("train example (train_tiny_lm_torch.py defaults): " + json.dumps(example_res),
          flush=True)
    if example_res["resumed_from"] != args.steps // 2 or max(diffs) > EXAMPLE_RESUME_ATOL:
        raise AssertionError(f"train: the example's resume is off: {example_res}")
    torch.cuda.empty_cache()

    # (d) the launcher at gemma-2b's full width, in a subprocess
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *TRAIN_LAUNCH_ARGV],
                          cwd=ROOT, env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
                          capture_output=True, text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-3:]
    print(f"train launcher {' '.join(TRAIN_LAUNCH_ARGV)}: rc {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s; {tail}", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"train: the launcher exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")

    # (e) a hand kernel under autograd raises on the card, before it launches
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn((1, 128, 2, 64), generator=g, device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    _util.reset_launch_counts()
    try:
        api.flash_attention(q.requires_grad_(True), k, v)
    except NotImplementedError as e:
        refusal = str(e)
    else:
        raise AssertionError("train: flash_attention under autograd did not raise")
    pcfg = rcfg.replace(attn_impl="pallas")
    pm = build_model(pcfg, device=dev)
    pparams = pm.init(torch.Generator(device=dev).manual_seed(0))
    pbatch = {k: torch.from_numpy(v).to(dev) for k, v in rsrc.batch_at(0).items()}
    try:
        value_and_grad(pm.loss_fn, pparams, pbatch)
    except NotImplementedError:
        pass
    else:
        raise AssertionError("train: value_and_grad through the flash kernel did not raise")
    if _util.launch_counts():
        raise AssertionError(f"train: a refused call launched {_util.launch_counts()}")
    print(f"train: a hand kernel under autograd raises on the card: {refusal!r}", flush=True)
    print(f"train: phase {time.perf_counter() - phase_start:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 13: the distribution layer, two ranks sharing the card over gloo
# ---------------------------------------------------------------------------
def dist_conf(dev) -> dict:
    """What phase 13's ranks need from this script's constants, passed to
    them as arguments (a spawned rank imports the script afresh)."""
    return {"device": dev.type, "arch": "gemma-2b", "reduced": False, "hw": CARD_HW,
            "slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN, "chunk": SERVE_CHUNK,
            "page": SERVE_PAGE, "new": SERVE_NEW, "prefix_len": SERVE_PREFIX,
            "lr": TRAIN_LR}


def use_conf(conf) -> None:
    """Set this process's serving constants to the parent's (a spawned rank
    imports the script afresh; the CPU rehearsal shrinks them)."""
    global SERVE_SLOTS, SERVE_MAX_LEN, SERVE_CHUNK
    SERVE_SLOTS, SERVE_MAX_LEN, SERVE_CHUNK = conf["slots"], conf["max_len"], conf["chunk"]


def dist_cfg(conf, **kw):
    from repro_torch.configs import get_config

    cfg = get_config(conf["arch"])
    return (cfg.reduced() if conf["reduced"] else cfg).replace(**kw)


def rank_mesh(shape, axes, conf):
    """This rank's bound mesh on its device (rank r on GPU r mod the count)."""
    import torch.distributed as tdist

    from repro_torch.dist import rank_device
    from repro_torch.launch.mesh import Mesh

    return Mesh(shape, axes).bind(rank_device(conf["device"], tdist.get_rank()))


def tree_bytes(tree) -> int:
    from repro_torch.models.common import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def tp_rank(rank, conf, tokens, prompts, prefix, want_tokens) -> dict:
    """Phase 13 (a) on one rank of a 2-rank ``model`` mesh: gemma-2b's params
    made from the seed and sharded by ``param_specs``; the 4 x 1000 prefill
    under the guard's shadow mode (each flash call on this rank's 4 query
    heads and 1 KV head); then phase 10's requests through a dense and a
    paged engine on the mesh.  Where a stream differs from ``want_tokens``
    (the one-rank engine's), this rank's logits row at the first differing
    position, fed as the engine fed it, comes back for the near-tie rule."""
    import torch

    from repro_torch.core.timing import percentile
    from repro_torch.dist import activation_sharding, param_specs, shard_tree
    from repro_torch.kernels import _util, guard
    from repro_torch.kernels.api import kernel_policy
    from repro_torch.models import build_model
    from repro_torch.serve import EngineConfig, ServeEngine

    use_conf(conf)
    mesh = rank_mesh((2,), ("model",), conf)
    dev = mesh.device
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = dist_cfg(conf, attn_impl="pallas")
    model = build_model(cfg, device=dev)

    def global_params():
        return model.init(torch.Generator(device=dev).manual_seed(0))

    out = {}
    params = global_params()
    specs = param_specs(params, cfg, mesh)
    local = shard_tree(params, specs)
    out["param_bytes_tp1"], out["param_bytes_local"] = tree_bytes(params), tree_bytes(local)
    out["local_shapes"] = {"wq": list(local["layers"]["attn"]["wq"].shape),
                           "wk": list(local["layers"]["attn"]["wk"].shape),
                           "embed": list(local["embed"].shape)}
    del params
    if on_card:
        torch.cuda.empty_cache()
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    with torch.inference_mode(), activation_sharding(mesh):
        model.prefill(local, {"tokens": batch["tokens"][:1, :64]})  # warm-up, unguarded
    with guard.isolated(guard.GuardConfig(hw=conf["hw"])), torch.inference_mode(), \
            kernel_policy(guard="shadow"), activation_sharding(mesh):
        _util.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        last, cache = model.prefill(local, batch)
        sync()
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_launches"] = _util.launch_counts()
        out["guard"] = guard.metrics().summary()
        out["shadowed"] = dict(guard.state()._calls)
        out["quarantined"] = list(guard.quarantined_ops())
    out["prefill_last"] = last.float().cpu()
    out["cache_kv_heads"] = int(cache["k"].shape[3])
    del local, cache

    base = dict(n_slots=conf["slots"], max_len=conf["max_len"], prefill_chunk=conf["chunk"],
                guard="sample", degrade=False, mesh=mesh)
    engines = {}
    for name, extra in (("dense", {}), ("paged", {"page_size": conf["page"]})):
        params = global_params()
        eng = ServeEngine(model, params, EngineConfig(**base, **extra))
        del params
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        with torch.inference_mode():
            if name == "paged":
                eng.register_prefix(prefix)
            eng.submit(prompts[0][:conf["prefix_len"] + 8], 4)  # warm-up
            eng.run()
            eng.reset_metrics()
            sync()
            t0 = time.perf_counter()
            sessions = [eng.submit(p, conf["new"]) for p in prompts]
            eng.run()
            sync()
            wall = time.perf_counter() - t0
        m, s = eng.metrics, eng.summary()
        res = {"tokens": [x.out for x in sessions], "finished": [x.finish_reason for x in sessions],
               "wall_s": wall, "throughput_tok_s": s["throughput_tok_s"],
               "ttft_ms_p50": s["ttft_ms_p50"], "tok_latency_ms_p50": s["tok_latency_ms_p50"],
               "tok_latency_ms_p99": percentile(m.token_latency_s, 99) * 1e3,
               "guard_checks": s["guard_checks"], "drift_events": s["drift_events"],
               "degradations": s["degradations"], "op_degradations": s["op_degradations"],
               "prefix_tokens_reused": s["prefix_tokens_reused"],
               "engine_param_bytes": tree_bytes(eng.params),
               "max_memory_allocated": (torch.cuda.max_memory_allocated(dev) if on_card
                                        else None)}
        res["rows"] = {}
        for i, (got, want) in enumerate(zip(res["tokens"], want_tokens)):
            if got != want:  # this rank's row where the stream first differs
                j = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
                         min(len(got), len(want)))
                with torch.inference_mode(), activation_sharding(mesh):
                    row = lane_logits(torch, model, eng.params, prompts[i], want[:j], dev)
                res["rows"][i] = (j, row.cpu())
        engines[name] = res
        del eng
        if on_card:
            torch.cuda.empty_cache()
    out["engines"] = engines
    return out


def tp_flip_rule(torch, dev, conf, prompts, want, got, rows) -> dict:
    """The near-tie rule of phases 10-11 for the tensor-parallel streams:
    where a stream first differs from the one-rank engine's, the one-rank
    model's top-2 margin at that position must lie within the distance
    between its logits row and the tp ranks' (fed the same tokens the same
    way), and the tp token must be one of the one-rank row's top two.
    Anything else fails; each flip is returned."""
    from repro_torch.models import build_model

    if not rows:
        return {}
    cfg = dist_cfg(conf, attn_impl="pallas")
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    flips = {}
    with torch.inference_mode():
        for i, (j, tp_row) in rows.items():
            one = lane_logits(torch, model, params, prompts[i], want[i][:j], dev).cpu()
            top = torch.topk(one, 2)
            flips[i] = {"position": j, "want": want[i][j] if j < len(want[i]) else None,
                        "got": got[i][j] if j < len(got[i]) else None,
                        "margin_tp1": float(top.values[0] - top.values[1]),
                        "top2_tp1": top.indices.tolist(),
                        "tp_vs_tp1_max_abs": float((one - tp_row.float()).abs().max())}
    del params, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    bad = {i: f for i, f in flips.items()
           if f["got"] not in f["top2_tp1"] or f["margin_tp1"] > f["tp_vs_tp1_max_abs"]}
    if bad:
        raise AssertionError(f"dist tp: streams differ past the near-tie rule: {bad}")
    return flips


def zero_layers(torch, conf, free_bytes) -> tuple:
    """The depth (a)'s ZeRO run can hold, and its reckoning: the fp32 params
    P(L) of L layers; each rank's peak about 3.5 P (params or their gathered
    copy, full grads before the reduce-scatter, their half, half of each
    moment, and at stage 3 the stored half too), two ranks on one card, plus
    per rank the float32 logits of one 512-token sequence and its grads
    (3 x 512 x 256,000 x 4 bytes) and twice the largest leaf in flight.  The
    depth stays odd (see ``ZERO_MAX_LAYERS``)."""
    from repro_torch.optim import AdamW
    from repro_torch.train.step import state_shapes
    from repro_torch.models import build_model

    def param_bytes(layers):
        cfg = dist_cfg(conf, n_layers=layers)
        shapes = state_shapes(build_model(cfg, device="cpu").init, AdamW()).params
        return tree_bytes(shapes), max(t.numel() * t.element_size()
                                       for t in (shapes["embed"],
                                                 shapes["layers"]["mlp"]["wi_gate"]))

    full = min(dist_cfg(conf).n_layers, ZERO_MAX_LAYERS)
    p1, _ = param_bytes(1)
    p2, _ = param_bytes(2)
    per_layer, embed_and_norms = p2 - p1, 2 * p1 - p2
    act = 3 * ZERO_SEQ * dist_cfg(conf).padded_vocab * 4
    budget = ZERO_FREE_SHARE * free_bytes
    layers = full - (1 - full % 2)
    while layers > 1:
        total, leaf = param_bytes(layers)
        if 2 * (3.5 * total + act + 2 * leaf) <= budget:
            break
        layers -= 2
    total, leaf = param_bytes(layers)
    reckoning = {"free_gb": free_bytes / 1e9, "budget_gb": budget / 1e9,
                 "per_layer_gb": per_layer / 1e9, "embed_and_norms_gb": embed_and_norms / 1e9,
                 "params_gb": total / 1e9,
                 "per_rank_peak_gb_est": (3.5 * total + act + 2 * leaf) / 1e9,
                 "layers": layers, "of": dist_cfg(conf).n_layers, "at_most": full}
    return layers, reckoning


def zero3_layout(conf, arch, layers, mesh_shape) -> dict:
    """Where ZeRO-3 puts ``data`` on ``arch``'s stacked layer leaves at
    ``layers`` layers on a (data, model) mesh of ``mesh_shape``: how many
    leaves it splits on the layer dim (a layer's gather a broadcast from its
    owner), on an inner dim (an all-gather of the layer's slices), or keeps
    whole."""
    from repro_torch.dist import zero_layouts
    from repro_torch.dist.zero import data_dim
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import AdamW
    from repro_torch.train.step import state_shapes

    cfg = dist_cfg({**conf, "arch": arch}, n_layers=layers, zero_stage=3)
    shapes = state_shapes(build_model(cfg, device="cpu").init, AdamW()).params
    lay = zero_layouts(shapes, cfg, Mesh(mesh_shape, ("data", "model"))).params
    out = {"layer_dim": 0, "inner_dim": 0, "whole": 0}
    for t, sh in zip(tree_leaves(shapes["layers"]), tree_leaves(lay["layers"])):
        d = data_dim(sh, t.ndim)
        out["whole" if d is None else "layer_dim" if d == 0 else "inner_dim"] += 1
    return out


def zero_rank(rank, conf, layers, batch, stages) -> dict:
    """Phase 13 (b) on one rank of (data=2, model=1): gemma-2b at full width
    and ``layers`` layers, float32 compute, one step of each ZeRO stage from
    the seeded params over the global batch; rank 0 then runs the one-process
    step on the same batch and holds each stage's gathered params against it."""
    import torch

    from repro_torch.dist import gather_tree, shard_tree, zero_layouts
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import AdamW, AdamWState
    from repro_torch.optim.schedule import constant
    from repro_torch.train.step import TrainState, make_train_step

    mesh = rank_mesh((2, 1), ("data", "model"), conf)
    dev = mesh.device
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = dist_cfg(conf, n_layers=layers, dtype="float32")
    model = build_model(cfg, device=dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    lr = conf["lr"]
    out, kept = {}, {}
    for stage in stages:
        c = cfg.replace(zero_stage=stage)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        lay = zero_layouts(params, c, mesh)
        opt = AdamW()
        state = TrainState(shard_tree(params, lay.params),
                           opt.init(shard_tree(params, lay.moments)))
        del params
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        step = make_train_step(model.loss_fn, opt, constant(lr), grad_shardings=lay.grads,
                               state_shardings=TrainState(lay.params, AdamWState(
                                   None, lay.moments, lay.moments)))
        sync()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        step_s = time.perf_counter() - t0
        out[stage] = {"loss": loss, "grad_norm": float(m["grad_norm"]), "step_s": step_s,
                      "state_bytes_local": tree_bytes(state),
                      "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                               if on_card else None)}
        full = gather_tree(state.params, lay.params)
        if rank == 0:
            kept[stage] = [t.cpu() for t in tree_leaves(full)]
        del state, full, step
        if on_card:
            torch.cuda.empty_cache()
    if rank != 0:
        return out
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt = AdamW()
    step = make_train_step(model.loss_fn, opt, constant(lr))
    sync()
    t0 = time.perf_counter()
    state, m = step(TrainState(params, opt.init(params)), batch)
    out["one_process"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                          "step_s": time.perf_counter() - t0}
    want = tree_leaves(state.params)
    for stage in stages:
        out[stage]["params"] = zero_param_rule(torch, kept[stage], want, lr, conf["hw"])
    return out


def zero_param_rule(torch, got, want, lr, hw) -> dict:
    """Each leaf within ``tolerance(float32, hw)`` but for at most 1 % of
    its elements (at least one), and every element within 2 lr: one step of
    AdamW moves an element by lr times g / (|g| + eps), about lr times g's
    sign, so an element whose grad sits at the sums' rounding from zero may
    take the other sign in one run (at full width some do).  Returns the
    counts; raises past the rule."""
    from repro_torch.kernels import guard

    tol = guard.tolerance(torch.float32, hw)
    outside, worst, n = 0, 0.0, 0
    for a, b in zip(got, want):
        err = (a.to(b.device).float() - b.float()).abs()
        k = int((err > tol.atol + tol.rtol * b.float().abs()).sum())
        outside, worst, n = outside + k, max(worst, float(err.max())), n + b.numel()
        if k > max(1, b.numel() // 100) or float(err.max()) > 2 * lr + tol.atol:
            raise AssertionError(f"dist zero: a leaf of {b.numel()} has {k} elements outside "
                                 f"256 ulps, the worst {float(err.max())} (lr {lr})")
    return {"elements": n, "elements_outside_256_ulps": outside, "max_abs_err": worst}


def collectives_rank(rank, conf) -> dict:
    """Phase 13 (c) on one rank of a 2-rank ``pod`` axis: ``gpipe_apply``
    over 2 stages against the sequential stages (output and gradients), and
    ``psum_compressed`` against the exact sum, on the rank's device."""
    import torch

    from repro_torch.dist import NamedSharding, P, gather_tree, gpipe_apply, psum_compressed
    from repro_torch.dist import shard_tree

    mesh = rank_mesh((2,), ("pod",), conf)
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(5)
    d, n_micro, mb = 1024, 8, 64
    w = torch.randn((2, d, d), generator=gen, device=dev) * d ** -0.5
    x = torch.randn((n_micro, mb, d), generator=gen, device=dev)
    spec = {"w": NamedSharding(mesh, P("pod"))}
    local = shard_tree({"w": w}, spec)
    local["w"].requires_grad_(True)
    y = gpipe_apply(lambda p, h: torch.tanh(h @ p["w"]), local, x, mesh, "pod")
    (y ** 2).sum().backward()
    grad = gather_tree({"w": local["w"].grad}, spec)["w"]
    ws = w.clone().requires_grad_(True)
    seq = x
    for s in range(2):
        seq = torch.tanh(seq @ ws[s])
    (seq ** 2).sum().backward()
    v = torch.randn((1 << 20,), generator=torch.Generator(device=dev).manual_seed(6 + rank),
                    device=dev)
    exact = psum_compressed(v, "pod", "none", mesh=mesh)
    q = psum_compressed(v, "pod", "int8", mesh=mesh)
    return {"gpipe_y_max_abs": float((y.detach() - seq.detach()).abs().max()),
            "gpipe_grad_rel": float((grad - ws.grad).abs().max() / ws.grad.abs().max()),
            "psum_int8_rel": float((q - exact).abs().max() / exact.abs().max()),
            "psum_exact_is_sum": bool(torch.equal(exact, gather_tree(
                {"v": v[None]}, {"v": NamedSharding(mesh, P("pod"))})["v"].sum(0)))}


def ckpt_rank(rank, conf, directory) -> dict:
    """Phase 13 (d), the save: gemma-2b reduced's params sharded at ZeRO
    stage 3 on (data=2, model=1), saved from the shards."""
    import torch

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.dist import shard_tree, zero_layouts
    from repro_torch.models import build_model

    mesh = rank_mesh((2, 1), ("data", "model"), conf)
    cfg = dist_cfg({**conf, "reduced": True})
    params = build_model(cfg, device=mesh.device).init(
        torch.Generator(device=mesh.device).manual_seed(0))
    lay = zero_layouts(params, cfg.replace(zero_stage=3), mesh)
    CheckpointManager(directory).save(7, shard_tree(params, lay.params), shardings=lay.params)
    return {"saved": 7}


def elastic_rank(rank, conf, directory) -> dict:
    """Phase 13 (d), the resume: ``ElasticController`` on one rank restores
    (d)'s checkpoint onto the mesh it plans; its tree must equal the params
    it was saved from."""
    import torch

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.dist import NamedSharding, P
    from repro_torch.ft import ElasticController
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_map

    ctl = ElasticController(model_parallel=1, ckpt=CheckpointManager(directory), devices_total=2)
    planned = ctl.plan_mesh(1)
    mesh = rank_mesh(tuple(planned.shape.values()), planned.axis_names, conf)
    cfg = dist_cfg({**conf, "reduced": True})
    want = build_model(cfg, device=mesh.device).init(
        torch.Generator(device=mesh.device).manual_seed(0))
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), want)
    step, got = ctl.resume(like, tree_map(lambda _: NamedSharding(mesh, P()), want))
    return {"mesh": dict(mesh.shape), "step": step,
            "equal": all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))}


def nccl_rank(rank, conf) -> dict:
    """Phase 13 (e): a world of one rank over NCCL runs the layer's
    collectives on the card."""
    import torch
    import torch.distributed as tdist

    from repro_torch.dist import collectives, psum_compressed

    mesh = rank_mesh((1,), ("data",), conf)
    x = torch.arange(12, dtype=torch.float32, device=mesh.device).reshape(3, 4)
    ok = {"all_reduce": torch.equal(collectives.all_reduce(x, mesh, "data"), x),
          "all_gather": torch.equal(collectives.all_gather(x.bfloat16(), mesh, "data", 1),
                                    x.bfloat16()),
          "reduce_scatter": torch.equal(collectives.reduce_scatter(x, mesh, "data", 0), x),
          "psum_none": torch.equal(psum_compressed(x, "data", "none", mesh=mesh), x),
          "psum_int8_rel": float((psum_compressed(x, "data", "int8", mesh=mesh) - x).abs().max()
                                 / x.abs().max())}
    torch.cuda.synchronize()
    return {"backend": tdist.get_backend(), **ok}


def zero_path(torch, dev, conf, cfg) -> None:
    """Phase 13 (b): ZeRO stages 2 and 3 on (data=2, model=1), gemma-2b at
    full width and the reckoning's depth, two ranks on the card; stage 3,
    which gathers a layer at a time, must peak below stage 2 on each rank."""
    import numpy as np

    from repro_torch.dist import run_ranks

    free = torch.cuda.mem_get_info(dev)[0] if dev.type == "cuda" else CARD_BYTES
    layers, reckoning = zero_layers(torch, conf, free)
    print("dist zero: depth cut by the reckoning " + json.dumps(reckoning), flush=True)
    rng = np.random.default_rng(13)
    seq = rng.integers(0, cfg.vocab_size, (ZERO_BATCH, ZERO_SEQ + 1))
    batch = {"tokens": seq[:, :-1].astype(np.int32), "targets": seq[:, 1:].astype(np.int32)}
    layout = zero3_layout(conf, conf["arch"], layers, (2, 1))
    if layout["layer_dim"] or not layout["inner_dim"]:
        raise AssertionError(f"dist zero: {layers} layers do not put data on an inner dim of "
                             f"every stacked leaf: {layout}")
    z0, z1 = run_ranks(zero_rank, 2, conf, layers, batch, (2, 3), backend="gloo",
                       device=dev.type, timeout=DIST_TIMEOUT)
    one = z0["one_process"]
    zero = {"layers": layers, "stage3_layout": layout, "one_process": one}
    for stage in (2, 3):
        zero[f"stage{stage}"] = {**z0[stage], "rank1": {k: v for k, v in z1[stage].items()}}
        for k in ("loss", "grad_norm"):
            rel = abs(z0[stage][k] - one[k]) / abs(one[k])
            zero[f"stage{stage}"][f"{k}_rel"] = rel
            if rel > 1e-3:
                raise AssertionError(f"dist zero stage {stage}: {k} {z0[stage][k]} against "
                                     f"the one-process step's {one[k]}")
    print("dist zero data 2 (float32 compute; gloo through host memory): " + json.dumps(zero),
          flush=True)
    for z in (z0, z1):  # stage 3 gathers a layer at a time: below stage 2's bound
        if dev.type == "cuda" and not z[3]["max_memory_allocated"] < z[2]["max_memory_allocated"]:
            raise AssertionError(f"dist zero: stage 3 peaked at {z[3]['max_memory_allocated']} "
                                 f"bytes a rank, stage 2 at {z[2]['max_memory_allocated']}")


def dist_path(torch, dev, tp1) -> dict:
    """Phase 13: the distribution layer (see the module docstring), two ranks
    on the one card over gloo (its collectives staged through host memory)
    and one rank over NCCL.  ``tp1``: the one-rank prefill's last logits and
    the one-rank engine's tokens.  Returns the ranks' launch counts."""
    from repro_torch.dist import run_ranks

    phase_start = time.perf_counter()
    conf = dist_conf(dev)
    cfg = dist_cfg(conf)
    prompts, prefix = serve_prompts(cfg)
    counts = {}

    # (a) tensor-parallel gemma-2b, tp 2
    ranks = run_ranks(tp_rank, 2, conf, tp1["prefill_tokens"], prompts, prefix, tp1["tokens"],
                      backend="gloo", device=dev.type, timeout=DIST_TIMEOUT)
    for r in ranks:
        add_counts(counts, r["prefill_launches"])
    tp = {"prefill_s": [r["prefill_s"] for r in ranks],
          "launches": [r["prefill_launches"] for r in ranks],
          "shadowed": [r["shadowed"] for r in ranks],
          "guard": [r["guard"] for r in ranks],
          "local_shapes": ranks[0]["local_shapes"], "cache_kv_heads": ranks[0]["cache_kv_heads"],
          "param_gb_tp1": ranks[0]["param_bytes_tp1"] / 1e9,
          "param_gb_local": [r["param_bytes_local"] / 1e9 for r in ranks],
          "rel_err_last_logits": [rel_max(r["prefill_last"][:, :cfg.vocab_size],
                                          tp1["prefill_last"][:, :cfg.vocab_size])
                                  for r in ranks]}
    print(f"dist tp 2 prefill {LM_BATCH} x {LM_PROMPT} (two ranks on one card, gloo through "
          "host memory): "
          + json.dumps(tp), flush=True)
    for r in ranks:
        if r["prefill_launches"].get("flash_attention") != cfg.n_layers:
            raise AssertionError(f"dist tp: a rank's prefill launched {r['prefill_launches']}")
        g = r["guard"]
        if (r["shadowed"].get("flash_attention") != cfg.n_layers or g["drift_events"]
                or g["faults"] or g["degraded_calls"] or r["quarantined"]):
            raise AssertionError(f"dist tp: the guard saw {g}, quarantined {r['quarantined']}")
    if max(tp["rel_err_last_logits"]) > 0.1:
        raise AssertionError(f"dist tp: the tp 2 prefill differs from tp 1: {tp}")
    for name in ("dense", "paged"):
        legs = [r["engines"][name] for r in ranks]
        got = legs[0]["tokens"]
        if any(leg["tokens"] != got for leg in legs):
            raise AssertionError(f"dist tp {name}: the ranks sampled different tokens")
        if any(f != "max_new_tokens" for leg in legs for f in leg["finished"]):
            raise AssertionError(f"dist tp {name}: not every request finished")
        if any(leg["drift_events"] or leg["degradations"] or leg["op_degradations"]
               for leg in legs) or not legs[0]["guard_checks"]:
            raise AssertionError(f"dist tp {name}: guard or degradation activity")
        flips = tp_flip_rule(torch, dev, conf, prompts, tp1["tokens"], got, legs[0]["rows"])
        summary = {k: v for k, v in legs[0].items() if k not in ("tokens", "finished", "rows")}
        summary["max_memory_allocated_gb"] = [
            None if leg["max_memory_allocated"] is None else leg["max_memory_allocated"] / 1e9
            for leg in legs]
        summary["identity"] = "identical" if not flips else "near-tie flips"
        summary["flips"] = flips
        print(f"dist tp 2 {name} engine (smoke reading, {len(prompts)} requests; gloo through "
              f"host memory, not NVLink): " + json.dumps(summary), flush=True)

    # (b) ZeRO data parallelism, data 2
    zero_path(torch, dev, conf, cfg)

    # (c) GPipe and the compressed all-reduce on the card
    coll = run_ranks(collectives_rank, 2, conf, backend="gloo", device=dev.type,
                     timeout=DIST_TIMEOUT)
    print("dist gpipe and psum_compressed: " + json.dumps(coll), flush=True)
    for r in coll:
        if (r["gpipe_y_max_abs"] > 1e-5 or r["gpipe_grad_rel"] > 1e-4
                or r["psum_int8_rel"] > 0.02 or not r["psum_exact_is_sum"]):
            raise AssertionError(f"dist: gpipe or psum_compressed is off: {r}")

    # (d) a checkpoint saved under data 2, resumed on one rank
    with tempfile.TemporaryDirectory() as tmp:
        run_ranks(ckpt_rank, 2, conf, tmp, backend="gloo", device=dev.type, timeout=DIST_TIMEOUT)
        (el,) = run_ranks(elastic_rank, 1, conf, tmp, backend="gloo", device=dev.type,
                          timeout=DIST_TIMEOUT)
    print("dist elastic resume on one rank: " + json.dumps(el), flush=True)
    if el["step"] != 7 or not el["equal"]:
        raise AssertionError(f"dist: the resharded restore is off: {el}")

    # (e) one rank over NCCL, the backend for a GPU per rank
    if dev.type == "cuda":
        (nc,) = run_ranks(nccl_rank, 1, conf, backend="nccl", device="cuda",
                          timeout=DIST_TIMEOUT)
        print("dist nccl world of one: " + json.dumps(nc), flush=True)
        if nc["backend"] != "nccl" or not all(nc[k] for k in (
                "all_reduce", "all_gather", "reduce_scatter", "psum_none")) \
                or nc["psum_int8_rel"] > 0.01:
            raise AssertionError(f"dist: the NCCL collectives are off: {nc}")
    print(f"dist: phase {time.perf_counter() - phase_start:.1f} s", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 14: training on a (data, model) mesh, four ranks sharing the card
# ---------------------------------------------------------------------------
COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "broadcast", "reduce", "shift")


def tp_train_layers(torch, conf, arch, free_bytes) -> tuple:
    """The depth phase 14's four ranks can hold at ZeRO-3 on (data 2, model
    2), and its reckoning, phase 13(b)'s extended: each rank holds its
    stored shard S of the fp32 params (``param_specs`` over ``model``, then
    ZeRO over ``data``) and as much again for each moment, the grads and,
    over microbatches, their accumulator and one microbatch's grads; one
    layer's gathered ``model``-local slices and their grads; the gathered
    head (the tied embedding or ``lm_head``) and its grad; three float32
    logits-sized tensors of a microbatch's tokens (the logits, their exp,
    their grads); its CUDA context.  Four ranks within
    ``ZERO_FREE_SHARE`` of the card's free memory, and the one-process step
    (the whole params, as many copies, the head and logits of the whole
    microbatch, and twice its largest leaf for AdamW's temporaries) alone
    within it too."""
    from math import prod

    from repro_torch.dist import param_specs, zero_layouts
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import AdamW
    from repro_torch.train.step import state_shapes

    mesh = Mesh(TP_TRAIN_MESH, ("data", "model"))

    def nbytes(t, sh=None):
        split = 1 if sh is None else prod(mesh.shape[a] for ax in sh.dim_axes(t.ndim) for a in ax)
        return t.numel() * t.element_size() // split

    def reckon(layers):
        cfg = dist_cfg({**conf, "arch": arch}, n_layers=layers)
        shapes = state_shapes(build_model(cfg, device="cpu").init, AdamW()).params
        pspecs = param_specs(shapes, cfg, mesh)
        stored = sum(map(nbytes, tree_leaves(shapes),
                         tree_leaves(zero_layouts(shapes, cfg.replace(zero_stage=3), mesh).params)))
        layer = sum(map(nbytes, tree_leaves(shapes["layers"]),
                        tree_leaves(pspecs["layers"]))) // layers
        head = "embed" if cfg.tie_embeddings else "lm_head"
        tokens = TP_TRAIN_BATCH * TP_TRAIN_SEQ // cfg.train_microbatches
        copies = 5 if cfg.train_microbatches > 1 else 4
        logits = 3 * tokens * cfg.padded_vocab * 4
        rank = (copies * stored + 2 * layer + 2 * nbytes(shapes[head], pspecs[head])
                + logits // mesh.shape["data"] + RANK_CONTEXT_BYTES)
        whole = sum(map(nbytes, tree_leaves(shapes)))
        one = (copies * whole + 2 * nbytes(shapes[head]) + logits
               + 2 * max(map(nbytes, tree_leaves(shapes))))
        return {"params_gb": whole / 1e9, "stored_gb_a_rank": stored / 1e9,
                "layer_gb_a_rank": layer / 1e9, "per_rank_peak_gb_est": rank / 1e9,
                "ranks_gb_est": mesh.size * rank / 1e9, "one_process_gb_est": one / 1e9}

    budget = ZERO_FREE_SHARE * free_bytes
    full = dist_cfg({**conf, "arch": arch}).n_layers
    layers = min(full, TP_TRAIN_MAX_LAYERS.get(arch, full))
    while layers > 1:
        r = reckon(layers)
        if max(r["ranks_gb_est"], r["one_process_gb_est"]) * 1e9 <= budget:
            break
        layers -= 1
    held = ({"parent_allocated_gb": torch.cuda.memory_allocated() / 1e9,
             "parent_reserved_gb": torch.cuda.memory_reserved() / 1e9}
            if torch.cuda.is_available() else {})
    return layers, {"free_gb": free_bytes / 1e9, **held, "budget_gb": budget / 1e9,
                    **reckon(layers), "layers": layers, "of": full,
                    "at_most": TP_TRAIN_MAX_LAYERS.get(arch, full)}


def tp_train_batch(cfg) -> dict:
    """Phase 14's global batch: TP_TRAIN_BATCH x TP_TRAIN_SEQ random tokens
    (numpy seed 13)."""
    import numpy as np

    seq = np.random.default_rng(13).integers(0, cfg.vocab_size, (TP_TRAIN_BATCH, TP_TRAIN_SEQ + 1))
    return {"tokens": seq[:, :-1].astype(np.int32), "targets": seq[:, 1:].astype(np.int32)}


def tp_train_reference(torch, dev, conf, arch, layers, batch, path) -> dict:
    """Phase 14's one-process step on the card at the rank run's depth, from
    the same seeded params over the whole batch; its params are written to
    ``path`` (a dict by leaf path, on the host) and freed.  A MoE's dropped
    assignments are counted on the initial params in an untimed forward."""
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import constant
    from repro_torch.train.step import TrainState, make_train_step

    cfg = dist_cfg({**conf, "arch": arch}, n_layers=layers, dtype="float32")
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    out = {"microbatches": cfg.train_microbatches, "zero_stage": cfg.zero_stage}
    if cfg.family == "moe":
        with torch.no_grad(), moe_drops() as seen:
            model.loss_fn(params, tb)
        out["drops"] = int(seen["drops"])
        out["assignments"] = layers * TP_TRAIN_BATCH * TP_TRAIN_SEQ * cfg.experts_per_token
    opt = AdamW()
    step = make_train_step(model.loss_fn, opt, constant(conf["lr"]),
                           microbatches=cfg.train_microbatches)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    (state, m), step_s, launches = counted(torch, lambda: step(TrainState(params, opt.init(params)),
                                                              tb))
    out.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), step_s=step_s,
               launches=launches, max_memory_allocated=(torch.cuda.max_memory_allocated(dev)
                                                        if dev.type == "cuda" else None))
    torch.save({name: t.cpu() for name, t in leaf_paths(state.params)}, path)
    del state, params, model, opt, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def tp_train_rank(rank, conf, arch, layers, batch, ref_path) -> dict:
    """Phase 14 (a)/(b) on one rank of (data=2, model=2): ``arch`` at full
    width and ``layers`` layers, float32 compute, the config's ZeRO stage and
    microbatches; the params made from the seed one rank at a time and
    sharded; one step over the global batch, with the collectives counted
    (calls and the bytes of their inputs, each staged through the host over
    gloo) and the kernel launches; then this rank's stored params against
    their slices of the one-process step's in ``ref_path``: per leaf slice
    the elements past 256 ulps and the largest error."""
    import torch
    import torch.distributed as tdist

    from repro_torch.dist import collectives, shard_tree, zero_layouts
    from repro_torch.dist.sharding import local_index
    from repro_torch.kernels import _util, guard
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import AdamW, AdamWState
    from repro_torch.optim.schedule import constant
    from repro_torch.train.step import TrainState, make_train_step, state_shapes

    mesh = rank_mesh(TP_TRAIN_MESH, ("data", "model"), conf)
    dev = mesh.device
    on_card = dev.type == "cuda"
    cfg = dist_cfg({**conf, "arch": arch}, n_layers=layers, dtype="float32")
    model = build_model(cfg, device=dev)
    opt = AdamW()
    lay = zero_layouts(state_shapes(build_model(cfg, device="cpu").init, opt).params, cfg, mesh)
    state = None
    for turn in range(mesh.size):  # one rank at a time holds the whole tree
        if turn == rank:
            params = model.init(torch.Generator(device=dev).manual_seed(0))
            state = TrainState(shard_tree(params, lay.params),
                               opt.init(shard_tree(params, lay.moments)))
            del params
            if on_card:
                torch.cuda.empty_cache()
        tdist.barrier()
    step = make_train_step(model.loss_fn, opt, constant(conf["lr"]),
                           microbatches=cfg.train_microbatches, grad_shardings=lay.grads,
                           state_shardings=TrainState(lay.params, AdamWState(
                               None, lay.moments, lay.moments)))
    tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    stats = {}
    real = {name: getattr(collectives, name) for name in COLLECTIVES}

    def count(name, fn):
        def run(x, *args, **kw):
            s = stats.setdefault(name, {"calls": 0, "bytes": 0})
            s["calls"] += 1
            s["bytes"] += x.numel() * x.element_size()
            return fn(x, *args, **kw)
        return run

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    for name, fn in real.items():
        setattr(collectives, name, count(name, fn))
    try:
        _util.reset_launch_counts()
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        sync()
        t0 = time.perf_counter()
        state, m = step(state, tb)
        sync()
        step_s = time.perf_counter() - t0
    finally:
        for name, fn in real.items():
            setattr(collectives, name, fn)
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "step_s": step_s,
           "launches": _util.launch_counts(), "collectives": stats,
           "state_bytes_local": tree_bytes(state),
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev) if on_card else None}
    if on_card:  # the card's use while every rank holds its memory, and each allocator's part
        tdist.barrier()
        reserved = [None] * mesh.size
        tdist.all_gather_object(reserved, torch.cuda.memory_reserved(dev))
        free, total = torch.cuda.mem_get_info(dev)
        tdist.barrier()
        out.update(card_used=total - free, memory_reserved=reserved)
    tol = guard.tolerance(torch.float32, conf["hw"])
    ref = torch.load(ref_path, mmap=True)
    slices = {}
    for (name, got), sh in zip(leaf_paths(state.params), tree_leaves(lay.params)):
        idx = local_index(sh, ref[name].shape)
        want = ref[name][idx].to(dev)
        err = (got.float() - want.float()).abs()
        slices[name] = {str([(i.start, i.stop) for i in idx]): (
            int((err > tol.atol + tol.rtol * want.float().abs()).sum()), float(err.max()),
            got.numel())}
    out["slices"] = slices
    return out


def slices_rule(ranks, ref_numel, lr) -> dict:
    """Phase 13(b)'s param rule over the ranks' slices of each leaf (a slice
    that several ranks hold counted once): at most 1 % of a leaf's elements
    past 256 ulps (at least one), every element within 2 lr.  Returns the
    counts; raises past the rule."""
    from repro_torch.kernels import guard

    tol = guard.tolerance("float32", CARD_HW)
    outside, worst, n = 0, 0.0, 0
    for name, numel in ref_numel.items():
        parts = {k: v for r in ranks for k, v in r["slices"][name].items()}
        k = sum(p[0] for p in parts.values())
        w = max(p[1] for p in parts.values())
        if sum(p[2] for p in parts.values()) != numel:
            raise AssertionError(f"dist tp train: the ranks' slices of {name} do not tile it")
        outside, worst, n = outside + k, max(worst, w), n + numel
        if k > max(1, numel // 100) or w > 2 * lr + tol.atol:
            raise AssertionError(f"dist tp train: {name} of {numel} has {k} elements outside "
                                 f"256 ulps, the worst {w} (lr {lr})")
    return {"elements": n, "elements_outside_256_ulps": outside, "max_abs_err": worst}


def tp_train_path(torch, dev) -> dict:
    """Phase 14: training on (data 2, model 2) (see the module docstring),
    four ranks on the one card over gloo.  Returns the ranks' launch counts,
    which must be none."""
    from repro_torch.dist import run_ranks

    phase_start = time.perf_counter()
    conf = dist_conf(dev)
    counts = {}
    for arch in TP_TRAIN_ARCHS:
        free = torch.cuda.mem_get_info(dev)[0] if dev.type == "cuda" else CARD_BYTES
        layers, reckoning = tp_train_layers(torch, conf, arch, free)
        print(f"dist tp train {arch}: depth cut by the reckoning " + json.dumps(reckoning),
              flush=True)
        batch = tp_train_batch(dist_cfg({**conf, "arch": arch}))
        with tempfile.TemporaryDirectory() as tmp:
            ref_path = os.path.join(tmp, "one_process_params.pt")
            one = tp_train_reference(torch, dev, conf, arch, layers, batch, ref_path)
            numel = {k: v.numel() for k, v in torch.load(ref_path, mmap=True).items()}
            if dev.type == "cuda":
                free, total = torch.cuda.mem_get_info(dev)
            ranks = run_ranks(tp_train_rank, 4, conf, arch, layers, batch, ref_path,
                              backend="gloo", device=dev.type, timeout=DIST_TIMEOUT)
        for r in ranks:
            add_counts(counts, r["launches"])
        res = {"layers": layers, "one_process": {k: v for k, v in one.items() if k != "launches"},
               "loss": [r["loss"] for r in ranks], "grad_norm": [r["grad_norm"] for r in ranks],
               "step_s": [r["step_s"] for r in ranks],
               "state_gb_local": [r["state_bytes_local"] / 1e9 for r in ranks],
               "max_memory_allocated_gb": [None if r["max_memory_allocated"] is None
                                           else r["max_memory_allocated"] / 1e9 for r in ranks],
               "collectives_rank0": ranks[0]["collectives"],
               "host_gb_a_rank": [sum(c["bytes"] for c in r["collectives"].values()) / 1e9
                                  for r in ranks],
               "stage3_layout": zero3_layout(conf, arch, layers, TP_TRAIN_MESH)}
        if dev.type == "cuda":  # what the ranks added to the card past their allocators
            r0 = ranks[0]
            res["rank_context_gb"] = ((r0["card_used"] - (total - free)
                                       - sum(r0["memory_reserved"])) / len(ranks) / 1e9)
            res["rank_context_gb_reckoned"] = RANK_CONTEXT_BYTES / 1e9
        for k in ("loss", "grad_norm"):
            res[f"{k}_rel"] = max(abs(r[k] - one[k]) / abs(one[k]) for r in ranks)
            if res[f"{k}_rel"] > 1e-3:
                raise AssertionError(f"dist tp train {arch}: {k} {[r[k] for r in ranks]} against "
                                     f"the one-process step's {one[k]}")
        res["params"] = slices_rule(ranks, numel, conf["lr"])
        print(f"dist tp train {arch} on (data 2, model 2), {TP_TRAIN_BATCH} x {TP_TRAIN_SEQ} "
              "tokens (float32 compute; gloo through host memory, not NVLink): " + json.dumps(res),
              flush=True)
        if any(any(r["launches"].values()) or any(one["launches"].values()) for r in ranks):
            raise AssertionError(f"dist tp train {arch}: the training path launched a kernel: "
                                 f"{[r['launches'] for r in ranks]}, {one['launches']}")
    print(f"dist tp train: phase {time.perf_counter() - phase_start:.1f} s", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 15: tensor parallelism for the other families, tensor-parallel replicas
# ---------------------------------------------------------------------------
FAMILY_TP = 2  # (a)-(d): ranks on the family's `model` mesh
# (a)'s depth, cut for the script's time: zamba2-7b's 6-layer super-blocks
# and its 3-layer tail, 6 super-blocks of its 13 (81 layers took 43-46 s
# a leg on an H100 over gloo)
FAMILY_LAYERS = {"zamba": 39}
FAMILY_STEPS = {"zamba": 8, "vlm": VLM_STEPS, "whisper": WHISPER_STEPS, "xlstm": 8}
FORWARD_STRIDE = 50  # (a), (d): the forward's logits compared every 50th position
FAMILY_FREE_SHARE = 0.9  # of the card's free memory a leg's reckoning may plan to fill


def family_cfg(conf, leg):
    """Phase 15's config of ``leg``: zamba2-7b at ``FAMILY_LAYERS``,
    internvl2-76b at phase 8c's depth, whisper-base and xlstm-1.3b, the
    kernels on."""
    from repro_torch.configs import get_config

    name, kw = {"zamba": ("zamba2-7b", {"ssm_impl": "pallas", "attn_impl": "pallas"}),
                "vlm": ("internvl2-76b", {"attn_impl": "pallas", "n_layers": VLM_LAYERS}),
                "whisper": ("whisper-base", {"attn_impl": "pallas"}),
                "xlstm": ("xlstm-1.3b", {})}[leg]
    cfg = get_config(name)
    if conf["reduced"]:
        cfg = cfg.reduced()
        kw.pop("n_layers", None)
    elif leg in FAMILY_LAYERS:
        kw["n_layers"] = FAMILY_LAYERS[leg]
    return cfg.replace(**kw)


def family_batch(torch, cfg, leg, gen, dev) -> dict:
    """The leg's workload: phase 7's 4 x 1000 tokens (zamba, xlstm), phase
    8c's frontend and 256 text tokens (vlm), phase 8d's frames and 32-token
    prompts (whisper); tokens, targets and any frontend, in bf16."""
    b, s = {"zamba": (LM_BATCH, LM_PROMPT), "xlstm": (LM_BATCH, LM_PROMPT),
            "vlm": (VLM_BATCH, VLM_TEXT), "whisper": (WHISPER_BATCH, WHISPER_PROMPT)}[leg]
    seq = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen, device=dev)
    batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
    if leg in ("vlm", "whisper"):
        n = cfg.frontend_len if leg == "vlm" else min(WHISPER_FRAMES, cfg.frontend_len)
        batch["frontend"] = torch.randn((b, n, cfg.d_model), generator=gen,
                                        device=dev).to(torch.bfloat16)
    return batch


def family_forms(torch, model, params, batch, leg, steps, dev, moved=None) -> dict:
    """One leg's forms, the same on one rank and on the mesh: the forward's
    logits every FORWARD_STRIDE positions (zamba, xlstm) or ``loss_fn``
    (vlm, whisper), the prefill's last logits, and ``steps`` greedy
    ``decode_step``s (tokens, rows); each call's launches and seconds, and,
    given ``moved`` (a running count of the bytes handed to the
    collectives), each call's bytes."""
    from repro_torch.models import mamba, xlstm

    out, cfg = {}, model.cfg
    vocab = cfg.vocab_size  # past it the pad columns hold -1e30 (whisper-base)

    def call(key, fn):
        before = 0 if moved is None else moved["bytes"]
        res, out[f"{key}_s"], out[f"{key}_launches"] = counted(torch, fn)
        if moved is not None:
            out[f"{key}_bytes"] = moved["bytes"] - before
        return res

    prompt = {k: v for k, v in batch.items() if k != "targets"}
    start = batch["tokens"].shape[1] + (batch["frontend"].shape[1] if leg == "vlm" else 0)
    if leg in ("zamba", "xlstm"):
        fwd = mamba.zamba_forward if leg == "zamba" else xlstm.xlstm_forward
        logits = call("forward", lambda: fwd(params, batch["tokens"], cfg))
        out["forward_rows"] = logits[:, FORWARD_STRIDE - 1::FORWARD_STRIDE, :vocab].float().cpu()
        del logits
    else:
        out["loss"] = call("loss", lambda: float(model.loss_fn(params, batch)))
    last, cache = call("prefill", lambda: model.prefill(params, prompt, start + steps))
    out["prefill_last"] = last[:, :vocab].float().cpu()
    toks, rows = call("decode", lambda: greedy(torch, model, params, cache, last.argmax(-1),
                                               start, steps, dev))
    out["tokens"], out["rows"] = toks.cpu(), rows[..., :vocab].cpu()
    return out


def family_place(rank, conf, leg, params) -> dict:
    """Phase 15, on each rank: this rank's shards of the parent's params (its
    CUDA tensors, shared by CUDA IPC) placed by ``param_specs`` on a 2-rank
    ``model`` mesh, kept for the leg's next command."""
    import torch

    from repro_torch.dist import param_specs, rank_state, shard_tree

    mesh = rank_mesh((FAMILY_TP,), ("model",), conf)
    cfg = family_cfg(conf, leg)
    local = shard_tree(params, param_specs(params, cfg, mesh))
    del params
    rank_state().update(mesh=mesh, params=local)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    return {"param_bytes_local": tree_bytes(local)}


def family_run(rank, conf, leg, batch, prompts) -> dict:
    """Phase 15, on each rank: the leg's forms (``family_forms``) under the
    mesh; for the VLM, phase 10's requests through a dense engine on it too;
    this rank's peak memory and the bytes its collectives moved."""
    import torch

    from repro_torch.dist import activation_sharding, collectives, rank_state
    from repro_torch.models import build_model
    from repro_torch.serve import EngineConfig, ServeEngine

    use_conf(conf)
    st = rank_state()
    mesh, params = st["mesh"], st["params"]
    dev = mesh.device
    on_card = dev.type == "cuda"
    cfg = family_cfg(conf, leg)
    model = build_model(cfg, device=dev)
    batch = {k: v.to(dev) for k, v in batch.items()}
    moved = {"bytes": 0}
    real = {k: getattr(collectives, k) for k in ("all_reduce", "all_gather")}

    def logged(fn):
        def run(x, *a, **kw):  # each rank hands the collective x, through the host
            moved["bytes"] += x.numel() * x.element_size()
            return fn(x, *a, **kw)
        return run

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    out = {}
    with torch.inference_mode(), activation_sharding(mesh):
        family_forms(torch, model, params, {k: v[:1] for k, v in batch.items()}, leg, 1,
                     dev)  # warm-up
        for k, fn in real.items():
            setattr(collectives, k, logged(fn))
        try:
            out.update(family_forms(torch, model, params, batch, leg, FAMILY_STEPS[leg], dev,
                                    moved))
        finally:
            for k, fn in real.items():
                setattr(collectives, k, fn)
        if leg == "vlm":
            eng = ServeEngine(model, None, EngineConfig(
                n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, prefill_chunk=SERVE_CHUNK,
                mesh=mesh))
            eng.params = params  # placed already
            sessions = [eng.submit(p, conf["new"]) for p in prompts]
            t0 = time.perf_counter()
            eng.run()
            if on_card:
                torch.cuda.synchronize(dev)
            out["engine"] = {"tokens": [x.out for x in sessions],
                             "finished": [x.finish_reason for x in sessions],
                             "wall_s": time.perf_counter() - t0, **{
                                 k: eng.summary()[k] for k in ("throughput_tok_s",
                                                                "ttft_ms_p50",
                                                                "tok_latency_ms_p50")}}
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev) if on_card else None
    out["param_bytes_local"] = tree_bytes(params)
    return out


def token_rule(torch, name, got, want, got_rows, want_rows) -> list:
    """Phase 15's token rule on a greedy batch: the ranks' tokens (B, steps)
    equal one rank's, but where the one-rank logits row's top-2 margin at a
    lane's first differing step lies within the distance between its row and
    the ranks' there, the ranks' token one of its top two.  Each flip is
    returned; anything else fails."""
    flips = []
    for lane in range(want.shape[0]):
        diff = (got[lane] != want[lane]).nonzero()
        if not len(diff):
            continue
        j = int(diff[0])
        top = torch.topk(want_rows[j, lane], 2)
        flip = {"lane": lane, "step": j, "want": int(want[lane, j]), "got": int(got[lane, j]),
                "margin_tp1": float(top.values[0] - top.values[1]),
                "top2_tp1": top.indices.tolist(),
                "tp_vs_tp1_max_abs": float((got_rows[j, lane] - want_rows[j, lane]).abs().max())}
        flips.append(flip)
        if flip["got"] not in flip["top2_tp1"] or flip["margin_tp1"] > flip["tp_vs_tp1_max_abs"]:
            raise AssertionError(f"{name}: tokens differ from one rank's past the token rule: "
                                 f"{flip}")
    return flips


def family_reckoning(torch, cfg, params, dev) -> dict:
    """The bytes the leg holds on the card while its ranks place their
    shards: the parent's global params and each rank's shards (by
    ``param_specs`` on an abstract 2-rank mesh) and CUDA context, against
    the card's free memory."""
    from repro_torch.dist import param_specs
    from repro_torch.dist.sharding import tree_leaves
    from repro_torch.launch.mesh import Mesh

    mesh = Mesh((FAMILY_TP,), ("model",))
    leaves = tree_leaves(params)
    local = sum(t.numel() * t.element_size() // math.prod(
        mesh.shape[a] for axes in sh.dim_axes(t.ndim) for a in axes)
        for t, sh in zip(leaves, tree_leaves(param_specs(params, cfg, mesh))))
    whole = sum(t.numel() * t.element_size() for t in leaves)
    free = torch.cuda.mem_get_info(dev)[0] if dev.type == "cuda" else CARD_BYTES
    ranks = FAMILY_TP * (local + RANK_CONTEXT_BYTES)  # the parent's params are in use already
    return {"params_gb": whole / 1e9, "local_gb_a_rank": local / 1e9,
            "placing_gb": (whole + ranks) / 1e9, "free_gb": free / 1e9,
            "fits": ranks < FAMILY_FREE_SHARE * free}


def family_lane_rows(rank, conf, cases) -> list:
    """Phase 15 (b), on each rank: the VLM's logits rows ``lane_logits``
    gives on the mesh for each (prompt, fed tokens) of ``cases``."""
    import torch

    from repro_torch.dist import activation_sharding, rank_state
    from repro_torch.models import build_model

    use_conf(conf)
    st = rank_state()
    mesh = st["mesh"]
    model = build_model(family_cfg(conf, "vlm"), device=mesh.device)
    with torch.inference_mode(), activation_sharding(mesh):
        return [lane_logits(torch, model, st["params"], feed, fed, mesh.device, mesh).cpu()
                for feed, fed in cases]


def engine_rule(torch, name, model, params, prompts, want, got, tp_rows) -> dict:
    """The token rule for served streams: where a stream first differs from
    the one-rank engine's, the one-rank row there (``lane_logits``, fed as
    the engine fed it) must have the ranks' token in its top two and a top-2
    margin within its distance from the ranks' row (``tp_rows(cases)``);
    each flip is returned; anything else fails."""
    cases, where = [], {}
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            j = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
            where[i] = j
            cases.append((prompts[i], w[:j]))
    if not cases:
        return {}
    rows = tp_rows(cases)
    flips = {}
    with torch.inference_mode():
        for (i, j), row in zip(where.items(), rows):
            one = lane_logits(torch, model, params, prompts[i], want[i][:j], model.device).cpu()
            top = torch.topk(one, 2)
            flips[i] = {"position": j, "want": want[i][j] if j < len(want[i]) else None,
                        "got": got[i][j] if j < len(got[i]) else None,
                        "margin_tp1": float(top.values[0] - top.values[1]),
                        "top2_tp1": top.indices.tolist(),
                        "tp_vs_tp1_max_abs": float((one - row.cpu().float()).abs().max())}
    bad = {i: f for i, f in flips.items()
           if f["got"] not in f["top2_tp1"] or f["margin_tp1"] > f["tp_vs_tp1_max_abs"]}
    if bad:
        raise AssertionError(f"{name}: streams differ from one rank's past the token rule: {bad}")
    return flips


def family_leg(torch, dev, conf, leg) -> list:
    """Phase 15 (a)-(d): one family on a 2-rank ``model`` mesh sharing the
    card over gloo, against one rank (see the module docstring).  The
    one-rank forms are taken on the card first, from the params the ranks
    then place (shared by CUDA IPC); the parent's copy is freed before the
    ranks run (kept for the VLM's flip rows).  Returns each rank's launch
    counts."""
    from repro_torch.dist import RankGroup
    from repro_torch.models import build_model, mamba
    from repro_torch.serve import EngineConfig, ServeEngine

    leg_start = time.perf_counter()
    on_card = dev.type == "cuda"
    cfg = family_cfg(conf, leg)
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    batch = family_batch(torch, cfg, leg, gen, dev)
    reckoning = family_reckoning(torch, cfg, params, dev)
    print(f"tp families {leg}: {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, on 2 "
          f"ranks; the reckoning: {json.dumps(reckoning)}", flush=True)
    if not reckoning["fits"]:
        raise AssertionError(f"tp families {leg}: the ranks' shards do not fit the card")
    steps = FAMILY_STEPS[leg]
    prompts = serve_prompts(cfg)[0] if leg == "vlm" else None
    one_engine = None
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        family_forms(torch, model, params, {k: v[:1] for k, v in batch.items()}, leg, 1, dev)
        one = family_forms(torch, model, params, batch, leg, steps, dev)
        if leg == "vlm":
            eng = ServeEngine(model, params, EngineConfig(
                n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, prefill_chunk=SERVE_CHUNK))
            sessions = [eng.submit(p, SERVE_NEW) for p in prompts]
            t0 = time.perf_counter()
            eng.run()
            if on_card:
                torch.cuda.synchronize(dev)
            one_engine = {"tokens": [x.out for x in sessions], "wall_s": time.perf_counter() - t0,
                          **{k: eng.summary()[k] for k in ("throughput_tok_s", "ttft_ms_p50",
                                                          "tok_latency_ms_p50")}}
            del eng, sessions
    one_peak = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None
    host_batch = {k: v.cpu() for k, v in batch.items()}
    with RankGroup(FAMILY_TP, device=dev.type, backend="gloo", timeout=DIST_TIMEOUT) as group:
        t0 = time.perf_counter()
        placed = group.call(family_place, conf, leg, params)
        place_s = time.perf_counter() - t0
        if leg != "vlm":
            del params
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.ipc_collect()
        ranks = group.call(family_run, conf, leg, host_batch, prompts)
        flips = token_rule(torch, f"tp families {leg}", ranks[0]["tokens"], one["tokens"],
                           ranks[0]["rows"], one["rows"])
        engine = None
        if leg == "vlm":
            legs = [r["engine"] for r in ranks]
            if any(x["tokens"] != legs[0]["tokens"] for x in legs):
                raise AssertionError("tp families vlm: the ranks served different tokens")
            if any(f != "max_new_tokens" for x in legs for f in x["finished"]):
                raise AssertionError("tp families vlm: not every request finished")
            engine = {k: v for k, v in legs[0].items() if k not in ("tokens", "finished")}
            engine["one_rank"] = {k: v for k, v in one_engine.items() if k != "tokens"}
            engine["flips"] = engine_rule(
                torch, "tp families vlm engine", model, params, prompts, one_engine["tokens"],
                legs[0]["tokens"], lambda cases: group.call(family_lane_rows, conf, cases)[0])
            del params
    n_attn = 0
    if leg == "zamba":
        n_super, _, tail = mamba._zamba_counts(cfg)
        n_attn = n_super + (1 if tail else 0)
    want = {
        "zamba": {"forward": {"ssm_scan": cfg.n_layers, "flash_attention": n_attn},
                  "prefill": {"flash_attention": n_attn}, "decode": {}},
        "vlm": {"loss": {"flash_attention": cfg.n_layers},
                "prefill": {"flash_attention": cfg.n_layers}, "decode": {}},
        "whisper": {"loss": {"flash_attention": cfg.n_enc_layers + 2 * cfg.n_dec_layers},
                    "prefill": {"flash_attention": cfg.n_enc_layers + 2 * cfg.n_dec_layers},
                    "decode": {}},
        "xlstm": {"forward": {}, "prefill": {}, "decode": {}}}[leg]
    per_rank = []
    res = {"place_s": place_s, "one_rank_peak_gb": one_peak,
           "param_gb_local": [p["param_bytes_local"] / 1e9 for p in placed]}
    for i, r in enumerate(ranks):
        got = {k: r[f"{k}_launches"] for k in want}
        if got != want or {k: one[f"{k}_launches"] for k in want} != want:
            raise AssertionError(f"tp families {leg}: rank {i} launched {got} (one rank "
                                 f"{ {k: one[f'{k}_launches'] for k in want} }), expected {want}")
        per_rank.append({})
        for c in got.values():
            add_counts(per_rank[-1], c)
        if any(not torch.equal(r["tokens"], ranks[0]["tokens"]) for r in ranks):
            raise AssertionError(f"tp families {leg}: the ranks sampled different tokens")
    agree = {"prefill_last_rel": [rel_max(r["prefill_last"], one["prefill_last"])
                                  for r in ranks]}
    if "forward_rows" in one:
        agree["forward_rel"] = [rel_max(r["forward_rows"], one["forward_rows"]) for r in ranks]
    else:
        agree["loss_rel"] = [abs(r["loss"] - one["loss"]) / abs(one["loss"]) for r in ranks]
    for k in ("forward", "loss", "prefill", "decode"):
        if f"{k}_s" in one:
            res[f"{k}_s"] = {"one_rank": one[f"{k}_s"], "ranks": [r[f"{k}_s"] for r in ranks]}
            res[f"{k}_host_mb_a_rank"] = ranks[0][f"{k}_bytes"] / 1e6
    res.update(agree, flips=flips, launches_a_rank=want,
               decode_step_host_mb_a_rank=ranks[0]["decode_bytes"] / steps / 1e6,
               max_memory_allocated_gb=[None if r["max_memory_allocated"] is None
                                        else r["max_memory_allocated"] / 1e9 for r in ranks],
               engine=engine, leg_s=time.perf_counter() - leg_start)
    print(f"tp families {leg} at tp {FAMILY_TP} (two ranks on one card, gloo through host "
          f"memory): " + json.dumps(res), flush=True)
    if not all(torch.isfinite(r["prefill_last"]).all() and torch.isfinite(r["rows"]).all()
               for r in ranks):
        raise AssertionError(f"tp families {leg}: non-finite outputs")
    if max(max(v) for k, v in agree.items() if k != "loss_rel") > 0.1 or max(
            agree.get("loss_rel", [0])) > LOSS_RTOL:
        raise AssertionError(f"tp families {leg}: differs from one rank: {agree}")
    return per_rank


def rank_reset_counts(rank) -> None:
    """Set a replica rank's kernel launch counts to 0."""
    from repro_torch.kernels import _util

    _util.reset_launch_counts()


def rank_counts(rank) -> dict:
    """A replica rank's kernel launch counts."""
    from repro_torch.kernels import _util

    return _util.launch_counts()


def rank_peak(rank) -> float:
    """A replica rank's peak memory (GB) on its device."""
    import torch

    from repro_torch.dist.launcher import this_device

    dev = this_device()
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0


def replica_lane_rows(rank, conf, cases) -> list:
    """Phase 15 (e), on each rank of a replica: ``lane_logits`` on the
    replica's engine (its model, placed params and mesh) for each (prompt,
    fed tokens) of ``cases``."""
    import torch

    from repro_torch.dist import activation_sharding, rank_state

    use_conf(conf)
    eng = rank_state()["engine"]
    with torch.inference_mode(), activation_sharding(eng.mesh):
        return [lane_logits(torch, eng.model, eng.params, feed, fed, eng.device, eng.mesh).cpu()
                for feed, fed in cases]


def tp_cluster_leg(torch, dev, conf, want_tokens) -> list:
    """Phase 15 (e): gemma-2b at full width served by 2 replicas x tp 2,
    four ranks on the card, then the launcher's ``--replicas 2 --tp 2``
    (see the module docstring).  ``want_tokens``: phase 10's dense
    engine's.  Returns each replica rank's launch counts over the router's
    run: none, as the engine's steps (``decode_chunk``) launch no hand
    kernel (phase 10)."""
    from repro_torch.serve import ClusterConfig, ClusterRouter, EngineConfig

    leg_start = time.perf_counter()
    cfg, model, params = gemma_full(torch, dev) if not conf["reduced"] else reduced_gemma(
        torch, dev, conf)
    prompts, _ = serve_prompts(cfg)
    cluster = ClusterRouter(model, params, ClusterConfig(
        engine=EngineConfig(n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                            prefill_chunk=SERVE_CHUNK),
        n_replicas=2, tp=2, devices=(dev,) * 4))
    try:
        t0 = time.perf_counter()
        sessions = [cluster.submit(p, SERVE_NEW) for p in prompts]
        start_s = time.perf_counter() - t0  # the ranks start at the first submit
        groups = [r.engine.group for r in cluster.replicas]
        for g in groups:
            g.call(rank_reset_counts)
        t0 = time.perf_counter()
        for _ in range(CLUSTER_FAIL_AFTER):
            cluster.step()
        before = {x.rid: list(x.out) for x in sessions}
        drained = cluster.fail_replica(0)
        cluster.run()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = [x.out for x in sessions]
        launches = [c for g in groups for c in g.call(rank_counts)]
        if any(launches):
            raise AssertionError(f"tp cluster: the replicas' ranks launched {launches}; the "
                                 f"engine's steps launch no hand kernel")
        if any(x.finish_reason != "max_new_tokens" for x in sessions) or not drained:
            raise AssertionError(f"tp cluster: {[x.finish_reason for x in sessions]}, "
                                 f"{len(drained)} drained")
        resumed = [x for x in drained if before[x.rid]]
        if any(x.out[:len(before[x.rid])] != before[x.rid] for x in drained):
            raise AssertionError("tp cluster: a requeued stream lost its output")
        flips = engine_rule(torch, "tp cluster", model, params, prompts, want_tokens, got,
                            lambda cases: cluster.replicas[1].engine.group.call(
                                replica_lane_rows, conf, cases)[0])
        res = {"ranks_start_s": start_s, **leg_timing(torch, cluster, sessions, wall),
               "requests_per_replica": [r["requests"] for r in cluster.summary()["per_replica"]],
               "drained": len(drained), "drained_mid_stream": len(resumed),
               "requeued_tokens": cluster.metrics.requeued_tokens,
               "identity": "identical" if not flips else "near-tie flips", "flips": flips,
               "launches_a_rank": launches,
               "peak_gb_a_rank": [p for r in cluster.replicas
                                  for p in r.engine.group.call(rank_peak)]}
    finally:
        cluster.close()
    print("tp cluster: gemma-2b, 2 replicas x tp 2 (four ranks on one card, gloo through host "
          "memory), fail_replica(0) after 4 ticks: " + json.dumps(res), flush=True)
    del cluster, params, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    argv = ["--arch", conf["arch"], "--replicas", "2", "--tp", "2", "--requests", "8",
            "--prompt-len", "64", "--max-new", "16", "--slots", "4", "--max-len", "256",
            "--prefill-chunk", "64"] + (["--reduced", "--device", "cpu"] if conf["reduced"]
                                        else [])
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *argv],
                          cwd=ROOT, capture_output=True, text=True, timeout=DIST_TIMEOUT,
                          env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    for ln in proc.stdout.splitlines():
        print(f"tp cluster launcher: {ln}", flush=True)
    print(f"tp cluster launcher: python -m repro_torch.launch.serve {' '.join(argv)}: exit "
          f"{proc.returncode} in {time.perf_counter() - t0:.1f} s", flush=True)
    if proc.returncode != 0 or "served 8/8" not in proc.stdout:
        raise AssertionError(f"tp cluster launcher: exit {proc.returncode}: {proc.stderr[-4000:]}")
    print(f"tp cluster: leg {time.perf_counter() - leg_start:.1f} s", flush=True)
    return launches


def reduced_gemma(torch, dev, conf) -> tuple:
    """gemma-2b ``reduced()`` with the flash kernel (the CPU rehearsal)."""
    from repro_torch.models import build_model

    cfg = dist_cfg(conf, attn_impl="pallas")
    model = build_model(cfg, device=dev)
    return cfg, model, model.init(torch.Generator(device=dev).manual_seed(0))


def tp_families_path(torch, dev, want_tokens) -> tuple:
    """Phase 15 (see the module docstring).  Returns the ranks' launch
    counts, summed, and each leg's, a rank at a time."""
    phase_start = time.perf_counter()
    conf = dist_conf(dev)
    by_leg = {}
    for leg in ("zamba", "vlm", "whisper", "xlstm"):
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        by_leg[leg] = family_leg(torch, dev, conf, leg)
    by_leg["cluster"] = tp_cluster_leg(torch, dev, conf, want_tokens)
    counts = {}
    for ranks in by_leg.values():
        for c in ranks:
            add_counts(counts, c)
    print(f"tp families: launches a rank {json.dumps(by_leg)}; phase "
          f"{time.perf_counter() - phase_start:.1f} s", flush=True)
    return counts, by_leg


def tp1_reference(torch, dev, cfg, model, params, tokens) -> dict:
    """Phase 13's one-rank reference, taken while phase 10's params are
    alive: the 4 x 1000 flash prefill's last logits, on the host."""
    gen = torch.Generator(device=dev).manual_seed(13)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), generator=gen, device=dev)
    with torch.inference_mode():
        last, _ = model.prefill(params, {"tokens": prompt})
    return {"prefill_tokens": prompt.cpu(), "prefill_last": last.float().cpu(),
            "tokens": tokens}


def roofline_share(name, fn, args, n_params, tokens, measured_s) -> dict:
    """Count ``fn(*args)`` once, untimed (``perfmodel.extract_costs``: ATen
    FLOPs and bytes, so on the plain path, whose ops it sees), roofline it
    against the H100 SXM at bf16 on one card, and divide the bound into the
    kernel path's measured time."""
    from repro_torch.perfmodel import CollectiveStats, extract_costs, roofline

    costs = extract_costs(fn, *args)
    terms = roofline(costs, CollectiveStats(), chips=1, kind="infer", n_params_active=n_params,
                     tokens=tokens, hw="nvidia-h100-sxm", dtype="bfloat16")
    bound_s = max(terms.compute_s, terms.memory_s, terms.collective_s)
    res = {"flops": costs.flops_per_device, "bytes": costs.bytes_per_device,
           "compute_s": terms.compute_s, "memory_s": terms.memory_s,
           "collective_s": terms.collective_s, "dominant": terms.dominant,
           "model_flops": terms.model_flops, "roofline_fraction": terms.roofline_fraction,
           "kernel_path_s": measured_s, "bound_share_of_kernel_path": bound_s / measured_s}
    print(f"roofline {name}: {json.dumps(res)}", flush=True)
    if not (bound_s > 0 and math.isfinite(res["bound_share_of_kernel_path"])):
        raise AssertionError(f"roofline {name}: {res}")
    return res


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def main() -> int:
    import torch

    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    from repro_torch.kernels import _util

    t0 = time.perf_counter()
    lib = _util.build_library()
    _util.library()
    print(f"built {os.path.relpath(lib, ROOT)} in {time.perf_counter() - t0:.1f} s", flush=True)

    rows = kernel_checks(torch, dev)
    torch.cuda.empty_cache()
    counts, _, rows["op_latency"]["ns_per_op"], levels = main_path(torch, dev)
    add_counts(counts, gemm_path(torch, dev))
    add_counts(counts, suites_path(torch, dev, rows["op_latency"]["ns_per_op"], levels))
    probe_counts, sweep = axpy_path(torch, dev)
    add_counts(counts, probe_counts)
    for r in rows["axpy"]["sweep_256mib"]:
        r.update(sweep[r["vec_bytes"]])
    add_counts(counts, entry_point_path(torch, dev))
    torch.cuda.empty_cache()
    add_counts(counts, lm_path(torch, dev))
    torch.cuda.empty_cache()  # gemma's params are gone; zamba2's 27 GB come next
    add_counts(counts, zamba_path(torch, dev))
    for path in (moe_path, vlm_path, encdec_path, xlstm_path):
        torch.cuda.empty_cache()  # the last model's params are gone; the next one's come
        add_counts(counts, path(torch, dev))
    torch.cuda.empty_cache()  # whisper's params are gone; gemma-2b's come back
    cfg, model, params = gemma_full(torch, dev)
    add_counts(counts, guard_path(torch, dev, cfg, model, params))
    torch.cuda.reset_peak_memory_stats()
    serving_counts, single = serving_path(torch, dev, cfg, model, params)
    single["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    add_counts(counts, serving_counts)
    add_counts(counts, cluster_path(torch, dev, cfg, model, params, single))
    tp1 = tp1_reference(torch, dev, cfg, model, params, single["tokens"])
    del params, model, single
    torch.cuda.empty_cache()  # the training phase needs the card's memory
    add_counts(counts, train_path(torch, dev))
    gc.collect()  # earlier phases' engines hold device memory in reference cycles
    torch.cuda.empty_cache()  # the ranks of phase 13 share the card
    add_counts(counts, dist_path(torch, dev, tp1))
    gc.collect()
    torch.cuda.empty_cache()  # the four ranks of phase 14 share the card
    add_counts(counts, tp_train_path(torch, dev))
    gc.collect()
    torch.cuda.empty_cache()  # phase 15's ranks share the card
    tp_counts, tp_by_leg = tp_families_path(torch, dev, tp1["tokens"])
    add_counts(counts, tp_counts)
    for name in ("flash_attention", "ssm_scan"):  # phase 15's, a rank at a time
        rows[name]["launches_tp_ranks"] = {leg: [c.get(name, 0) for c in ranks]
                                           for leg, ranks in tp_by_leg.items()}

    print(f"chip_smoke: all phases passed in {time.perf_counter() - start:.1f} s", flush=True)
    print("kernels: " + " ".join(KERNELS))
    line = []
    for name in KERNELS:
        r = rows[name]
        src, replaces = SOURCES[name]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts.get(name, 0), "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        }
        entry.update({k: v for k, v in r.items()
                      if k in ("latency_bound_ms", "sm_clock_mhz", "tflops", "row_rel_err", "sweep_256mib",
                               "transpose_ms", "ns_per_op", "ssm_routes", "ms_passes",
                               "launches_tp_ranks")
                      or k.endswith((*FLASH_SHAPE_SUFFIXES, "_4096", "_chunk512", "_fp16"))})
        line.append(entry)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
