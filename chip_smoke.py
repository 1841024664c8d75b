#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (`src/repro_torch/`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
last line:

  1. the card: `nvidia-smi` name and power limit, torch and CUDA versions;
  2. build: every kernel of `src/repro_torch/kernels/csrc/` compiled with
     nvcc for sm_90a, one nvcc a source, all at once;
  3. kernels: the full-width MobileNetV2 fixture (alpha 1.0, 224x224, act8,
     `tests/golden_torch/`) and the full-size compact EfficientNet fixture
     (H=128, act8) are walked on their 8 images with the plain PyTorch
     route, and every kernel call each served path makes (MobileNetV2:
     irb0/dw, irb0/project, irb1..irb16, tail/pw, classifier/fc; the
     EfficientNet: its 10 DW ops, 3x3 and 5x5, stride 1 and 2, and its 31
     PW/DENSE ops, the SE squeezes on the pooled tensor included) is run
     on exactly that input, through the kernel and through its plain
     version: they
     must be equal (tolerance: exact), and a second call must give the same
     bits; K2's lines name the tile and K slices its `plan` chose, K4's the
     tile and E slices (`splits`, `eslice`), and the phase fails unless
     every K4 launch at 14x14 and 7x7 took the split-E variant. Each
     prints its time `ms` (CUDA events around the call, median of 25, the
     host's wrapper and launch included: see `time_ms`), the plain
     version's, one PyTorch library call's where one computes the same
     accumulation, the least time the card could take (bytes at 3.35 TB/s
     or int8 operations at 1979 TOP/s; activations counted at 1 byte a
     value, since every one lies in [0, 255]), and `device_ms` and
     `library_device_ms`, the kernel's and the library call's work on the
     device alone; a summary a net, and the JSON rows sum both nets'
     micro-batches;
  4. serve: `VisionEngine.from_artifact` on `cuda` serves the 8 images as
     8 requests, with the launch counters set to 0 just before and read
     just after (K4's by variant too: the 11 launches at 14x14 and 7x7
     split E, the 5 at 56x56 and 28x28 do not); the logits must equal the JAX package's `run_qnet` logits
     stored in the fixture bit for bit, every CU stage's output its stored
     digest, and the port's `cu.run_qnet` on the card the same logits;
  5. throughput: a closed loop over buckets 1/2/4/8 and a one-request-at-a-
     time loop, with FPS and p50/p95 latency, per-stage times (CUDA events
     around each stage's call, its host side included), and a
     short torch.profiler window (device busy share: the union of the
     device-side kernel and copy intervals over the wall time; top kernels);
  6. lm: the LM operator entry points at Llama-3.2-1B widths (read from
     `repro_torch.configs.llama32_1b`), inputs made with numpy from the
     seeds of `tests/torch_lm_cases.py`. `ops.quantized_linear` runs the 7
     linears of one decoder layer and the tied lm_head at W8 per channel,
     W4 per channel and W4 in groups of 128, for 8 rows in f32 and bf16 and
     512 rows in bf16; `ops.decode_attend` runs batch 8 over a 4096-position
     cache, int8 (from `kv_quant`) at kv_len 4096 and 3001, bf16 at 3001.
     The launch counters are set to 0 just before and read just after;
     every 8-row linear must have taken K5's `decode` variant and every
     512-row one its `mma` variant, and every decode case K6's `split_s`
     (its line names the splits, positions a split, blocks and kv heads a
     warp reads together). Each case is called a second time and
     must give the same bits. Each output is then held against the kernel's
     plain version on the same
     inputs (the JAX tests' tolerances: quantized matmul rtol 1e-5 / atol
     1e-3 in f32 and 2e-2 / 2e-1 in bf16, decode attention 1e-5 / 1e-5) and,
     where the JAX entry points wrote one, against the golden
     `tests/golden_torch/llama32_1b_lm_ops.npz` at the same tolerances. Each
     case prints its time, the plain version's, one library call's
     (`torch.matmul` on the dequantized weight; `scaled_dot_product_attention`
     on the dequantized cache), its bound (bytes at 3.35 TB/s or flops at
     the 989 TFLOP/s dense bf16 peak), and the kernel's and the library
     call's device time alone, as in phase 3; K6 also `cold_device_ms`,
     its device time with the L2 cache flushed before each call (the int8
     caches fit in the 50 MB L2, so a warm call can beat the HBM bound);
  6a. lm_serve: LM serving through the port's `Engine` (`serve/engine.py`)
     and model (`models/lm/`), which launch none of K2-K6 (the JAX LM
     dequantizes and multiplies, and attends over the dequantized cache):
     the launch counters are set to 0 at the phase's start and must read 0
     at its end. The serving CLI (`launch/serve.py`) at its defaults on
     full-width Llama-3.2-1B (16 layers, d_model 2048, 32 / 8 heads, d_ff
     8192, vocab 128256 padded to 128512, tied, bf16, seeded weights): 8
     requests of 16 tokens, all in range, its tok/s. The Engine's three
     properties (`tests/test_serve_engine.py`) at full width in bf16, W8,
     W4 and with the int8 KV cache: equal to a manual prefill-and-decode
     loop at 1 slot and at 4 slots with 6 requests, and one prompt's tokens
     equal across two batches; each prints prefill ms (4 x 12 tokens) and
     decode ms a step at 4 slots (median of 25, CUDA events, host
     included) beside the bound of reading every weight once at 3.35
     TB/s, and the bf16 decode step its device busy share under
     torch.profiler. The cache path against `forward_train` on the
     16-layer model in f32 (TF32 off; max abs err LM_CACHE_ATOL). The
     published widths cut to 2 layers, f32, numpy-seeded weights
     (`tests/torch_lm_cases.py`): the card's prefill and 8 greedy steps
     against the port's on the CPU and both against the JAX golden
     `tests/golden_torch/llama32_1b_serve.npz` (LM_SERVE_TOL, tokens
     exact). The nine other archs at `reduced_config` in f32, prefill and
     8 decode steps on the card against the CPU (LM_SERVE_TOL); mamba2-1.3b
     and recurrentgemma-2b also at their published widths and depths in
     f32: prefill and 4 greedy steps on the card, finite, the prefill and
     first step against the CPU (LM_SERVE_TOL), and a decode step's ms.
     Peak memory and the phase's seconds;
  6b. lm_train: LM training (`models/lm/model.loss_fn`,
     `train/train_loop.make_train_step`, `launch/train.py`), which
     launches none of K2-K6 either (the JAX LM trains through no Pallas
     kernel; the counters must read 0 at the phase's end). One f32
     `make_train_step` step on the card against the CPU from the same
     seeded weights and numpy batch (2 x 32 tokens): Llama-3.2-1B at its
     published widths cut to 2 layers, then the nine other archs at
     `reduced_config`; loss, grad norm, lr, every gradient leaf, the
     updated params and AdamW's m and v held to `train/parity.py`'s LM_*
     bounds (`lm_step_errors`, the CPU tests' own). Then the driver
     `launch/train.main` at its defaults on full-depth bf16 Llama-3.2-1B
     (batch 8 x seq 128) for 6 steps with a checkpoint directory; again,
     stopped by a SIGTERM (sent as the data stream hands out step 3's
     batch: the drain checkpoints after step 3) and `--resume`d to step
     6: the losses and the final checkpoint's params must equal the
     straight run's bit for bit, its AdamW moments by size and CRC-32;
     losses finite. Then the step timed at the driver's defaults (median
     of 6, tokens/s), its forward-and-backward and its AdamW alone, one
     step under torch.profiler (busy share, device intervals, by kernel
     family), the `--grad-compress` step, beside the matmul and AdamW
     bounds. Peak memory of the driver's run and the phase's seconds;
  7. stream: `StreamEngine` on `cuda` serves the full-width keyword-spotting
     DS-CNN (`build_kws()` defaults: 49 frames x 10 MFCC, 64 channels, 4
     DS blocks, act8; `tests/torch_stream_cases.py`) at hop 4: 64 sessions
     of 16 windows, staged with `push(defer=True)` and advanced by
     `drain()` through buckets 2..64, in float-multiplier and in
     fixed-point mode; all 12,288 logits of each mode must equal the JAX
     package's `run_qnet` over each full window, stored in
     `tests/golden_torch/dscnn_kws_t49_c64_act8.npz` (fixed point computed
     under x64). Then the frozen `stream_logits` of
     `tests/golden/dscnn_kws_act8.npz`, and the full-width HAR DS-CNN
     (128 x 3, stride-2 DW k5) at hop 16, 8 sessions of 8 windows, float.
     Prints the prime ms at each bucket, ms per `drain()` round at 64
     sessions, the fleet's windows/s, the device busy share of 10 rounds
     under torch.profiler with the host ops and device intervals a round,
     and one session's step p50. The path
     runs torch ops only (the reference has no kernel there): its launch
     counts are printed and must be 0;
  8. fixed point: the full-width MobileNetV2 fixture served by
     `VisionEngine(fixed_point=True)` and by `cu.run_qnet(fixed_point=True)`
     on `cuda`: all 8000 logits must equal the JAX package's x64
     fixed-point logits (`..._act8_fixed.npz`). The kernels' epilogue is
     float-multiplier only, so fixed point runs the reference torch ops:
     launch counts printed, and they must be 0; ms per micro-batch of 8;
  9. fleet: both fixtures served together on `cuda` by one
     `MultiModelEngine` (bucket 8, interleaved requests with mixed
     deadlines, none of which expires), with the launch counters set to 0
     just before and read just after: every logit of each net must equal
     the JAX package's (0 of 8000 each), with a shared `Tracer` and
     `MetricsRegistry` as without them, and each net's micro-batch must
     launch what `ops.served_launches` works out from its NetSpec
     (MobileNetV2: K2 3, K3 1, K4 16 as 5 `single` + 11 `split_e`; the
     EfficientNet: K2 31, K3 10). The trace is saved to
     `smoke_out/fleet_trace.json` (metrics beside it), must pass
     `validate_chrome_trace` with every request span closed, and
     `python -m repro_torch.obs summarize` prints its top spans. Then
     each net alone in a closed loop (rounds of 256 queued requests for
     LOOP_S seconds, buckets 1/2/4/8), obs off and on in turns, 3 pairs:
     FPS, p50, the modeled watts and FPS/W of `EngineStats`, and the
     measured watts and FPS/W from `nvidia-smi --query-gpu=power.draw`
     sampled every 100 ms by a subprocess during the loop (the paper's
     ZCU102 FPS/W beside them); obs-on's FPS cost by pair. Then a
     power-capped fleet: slo 0 and 1 requests under a budget halfway
     between the idle draw and idle plus the unconstrained run's modeled
     dispatched watts (window: a quarter of that run's wall time),
     `shed_slo=0`; the rolling watts must stay under the budget at every
     dispatch, no slo=1 request may be shed, the first `run()` must
     account for every request (ok + shed + deferred + expired) and later
     ones serve the deferred. The phase measures first, and prints last,
     the card's draw at rest and under a dense int8 matmul loop (the
     median of 100 ms samples over 6 s each) beside
     `BACKEND_WATTS["cuda"]`;
  9a. replicas: data-parallel replicas (`dist/sharding.py`'s `data_mesh`)
     on the one card. `VisionEngine(mesh=data_mesh(1))` serves the
     MobileNetV2 fixture's 8 images at buckets 1/2/4/8: 0 of 8000 logits
     may differ from the JAX package's, and the launches must be
     `[serve]`'s. Two replicas of the card (`data_mesh(2, devices=[cuda:0,
     cuda:0])`) serve both `[fleet]` fixtures' images twice over (16
     requests each; buckets asked (1, 3, 4), rounded up to (2, 4)): 0
     logits may differ, `EngineStats.replicas` must be 2, each replica's
     constants must be its own storage, and a micro-batch must launch 2 x
     one replica's kernels at half the rows (K4 by variant from
     `fused_irb.plan` at those rows). Closed loops (REPLICA_LOOP_S, 2 in
     turns) without a mesh, on a one-replica mesh and on two replicas:
     FPS and p50, reported, not gated. The serving CLI with `--vision
     --replicas 1` (both nets) must serve every request, and with
     `--replicas 2` must be refused with JAX's `replicas=2 with 1 visible
     devices` where one card is visible. Full-depth bf16 Llama-3.2-1B
     (seeded weights, the data stream's first two 8 x 128 batches):
     `dist/pp.make_pp_loss` with 2 stages of 8 layers on [cuda:0, cuda:0]
     at n_micro 2 and 4, its loss and every gradient leaf against the
     plain `loss_fn` (`train/parity.py`'s bf16 bounds), the wq gradient
     reaching both stages, ms beside the plain call's and the matmul
     bound; `compressed_psum` over two replicas of the card, each with
     its own batch's gradients and the residual a first all-reduce left:
     every summed and residual value bit for bit its plain version's on
     the CPU, ms beside the bytes bound. Prints the phase's seconds;
  9b. dryrun: the distributed LM on the one card (`dist/sharding.py`
     collectives, `models/lm/model.py`'s partitioned program,
     `launch/{dryrun,roofline}.py`). [lm_train]'s step (full-depth bf16
     Llama-3.2-1B, batch 8 x 128, `make_train_step`) traced on the (1, 1)
     mesh of the card: its roofline terms and bound (its memory term the
     bytes of the eager program, op by op) beside its measured ms and the
     step's function bound (`lm_train_bounds`), the reckoned peak beside
     `max_memory_allocated`. The same step on
     TP (1, 2), DP (2, 1) and FSDP (2, 2) meshes that name `cuda:0`
     repeatedly: the loss within LM_BF16_LOSS_RTOL of the mesh-less
     step's; every mesh's bf16 gradients' worst leaf within
     DRYRUN_FLOOR_X times the bf16 noise floor (the mesh-less bf16
     gradients' worst distance from the float32 gradients of the same
     weights, measured in the run) of those float32 gradients, and DP's
     within LM_BF16_GRAD_L2 of the mesh-less step's; and the loss and
     every gradient leaf of the float32 model at full width and depth
     within LM_LOSS_RTOL / LM_GRAD_L2 of the mesh-less float32 ones. Each
     mesh's step ms (median of DRYRUN_REPS), device busy and intervals
     under torch.profiler, and collective operand bytes by kind: host
     cost of one card standing for several devices, not scaling. A
     decode step at 4 slots under TP (1, 2): logits within
     LM_BF16_GRAD_L2 (relative L2) of the mesh-less step's, ms of both.
     (e) The vlm, audio, ssm, hybrid and moe families
     (`DRYRUN_FAMILIES`: phi-3-vision 2 layers with 576 image embeds,
     seamless 2 + 2 layers with 1024 frames, mamba2 2 layers,
     recurrentgemma 5 layers, qwen2-moe 2 layers, each at its published
     widths, bf16, 8 x 128) gated on the same three meshes as Llama, each
     against its own bf16 floor measured in the run, and a TP prefill and
     4 decode steps (logits within LM_BF16_GRAD_L2); qwen2-moe's float32
     routing on every mesh identical to the mesh-less step's (the same
     top-k experts and the same kept (token, choice) pairs in every
     layer), and the mesh-less step must drop pairs at its published
     capacity_factor 1.25 (the count printed: capacity over the global
     batch at work). bf16 routing is discontinuous (a last-bit change of
     a router input moves a top-k choice; the moved choices are printed),
     so qwen2-moe's bf16 loss is held within max(LM_BF16_LOSS_RTOL,
     DRYRUN_FLOOR_X x 2 x the mesh-less bf16 loss's distance from the
     float32 loss) of the mesh-less one, and its DP gradients to the
     float32 ones as TP's and FSDP's; its DP step is not run (two
     replicas' weights and AdamW state, old and new, exceed the card).
     ms, device intervals and collective bytes a mesh; each arch's
     seconds and the part's. The dry-run's llama3.2-1b decode_32k
     2x16x16 and train_4k 16x16 cells, mamba2's long_500k 2x16x16 (a replicated row) and
     recurrentgemma's train_4k 16x16 (heads split mid-head) on meta
     devices must report `ok` (terms, bottleneck, memory, seconds
     printed). K2-K6 launch counts must be 0;
 10. train: the training front end (`repro_torch.train.vision`) on the
     card. MobileNetV2 at the paper's full width (alpha 1.0, 224x224x3,
     1000 classes, w8/a8, BN, batch 32, 2 float + 2 QAT steps, an
     online-quantization round after each QAT step over 2 calibration
     batches) from seeded random weights: trained straight, then again
     killed after step 3 into a temporary checkpoint directory and resumed,
     and its params, optimizer state, observers and losses must equal the
     straight run's bit for bit. Exported on the card: `verify_export`
     must prove every route (reference, prepared, stage executors, engine)
     on 8 held-out images, the proof must launch K2-K4 as two
     micro-batches, the exported logits must equal the port's
     `cu.run_qnet` on the CPU for the same artifact bit for bit, and a
     `VisionEngine` serving the artifact must launch what `[serve]` does
     (K2 3, K3 1, K4 16 as 5 `single` + 11 `split_e`) with the same
     logits. The compact EfficientNet at its published size (H=128, 1000
     classes, w8/a8) the same after 1 float and 1 QAT step (K2 31, K3 10).
     Prints the float-step and QAT-step ms (median of 6, CUDA events, host
     included) with images/s, each step's device busy share and heaviest
     kernels under torch.profiler (one step), peak `max_memory_allocated`,
     the export ms,
     beside the card's name and power limit; then the tiny config's
     (alpha 0.35, 16x16, 4 classes, batch 8) float phase on the CPU, each
     step's loss computed on the card too from the same params and batch
     (rtol 1e-4, the CPU tests');
 11. tune: the route autotuner (`repro_torch.tune.tune_qnet`, batch 8, the
     real timer, the latency objective) on both `[fleet]` fixtures on the
     card; every unique key's winner with its `us`, `us_ref` and the
     disqualified candidates is printed (and each cache saved under
     `smoke_out/`), and the phase fails if a K2, K3 or K4 candidate was
     disqualified, if the cache does not cover the net (coverage 1.0), or
     if the tuner's end-to-end check raises. A `VisionEngine(tuned=)`
     serves each fixture's 8 images with the launch counters set to 0 just
     before and read just after: 0 of 8000 logits may differ from the JAX
     package's, every MobileNetV2 stage output must equal its stored
     digest, and the K2, K3 and K4 launches (K4 by variant, from
     `fused_irb.plan`) must be what the resolved routes call for
     (`ops.served_launches(plan, routes=, fused=)`). Then closed loops of
     each net untuned and tuned in turns (3 pairs, TUNE_LOOP_S each,
     buckets 1/2/4/8): FPS and p50, reported beside the card's name and
     power limit, no gate; each variant's device busy share under
     torch.profiler. `verify_export(tuned=)` must prove
     `engine[tuned]` on the MobileNetV2 fixture. Last, the serving CLI
     (`python -m repro_torch.launch.serve --vision`) as two subprocesses
     on the card, both nets at hw 128: `--tune --tuned-cache` (writes the
     cache), then `--tuned-cache` alone (loads it); both must exit 0 with
     every request ok and 100% coverage, and the saved trace must pass
     `validate_chrome_trace`. Prints the phase's seconds;
 12. precision: the mixed-precision search (`repro_torch.tune.precision`)
     at full width: MobileNetV2 alpha 1.0, 224x224, 1000 classes, 4-bit
     weights, act widths (4, 6, 8), ladder budget 5. `ensure_coverage`
     tunes the three uniform nets on the card (real timer, batch 8, every
     kernel candidate; seconds a width printed); `QATFinetuneAccuracy`
     scores each candidate on a small budget printed with it (2 float + 2
     QAT base steps, 2 fine-tune steps a candidate, batch 8, one eval
     batch). The front is written to
     `smoke_out/precision/mobilenet_v2_cuda_pareto.json` and must pass
     `check_pareto_artifact`; every point must be fully tuned and no
     candidate disqualified. The headline mixed point (the CLI's pick) is
     exported on the card through `export_point`, whose route proof must
     pass, and served by `VisionEngine` on 8 images: 0 logits may differ
     from the port's `cu.run_qnet` on the CPU over the same artifact, and
     the launches (K4 by variant) must be what the resolved routes call
     for. The mixed fixture `tests/golden_torch/mobilenet_v2_alpha1_224_mix468.*`
     (Body blocks cycling act 8, 4, 6) served the same way: 0 of 8000
     logits may differ from the JAX package's, and every stage its
     digest. K4 on the fixture's act4 and act6 blocks and K2, K3 on
     uniform act4 and act6 nets calibrated on the card, each call against
     its plain version (exact), with `ms`, `device_ms` and `bound_ms`.
     Then closed loops (2 rounds, 1.5 s, buckets 1/2/4/8) of the exported
     net, the mixed fixture and the act8 fixture, in turns: FPS and p50,
     no gate. Prints every point's `us_per_image` and the phase's seconds;
 13. the kernels' JSON line (with `device_ms`, `library_device_ms` and
     K6's `cold_device_ms` beside the keys the contract names; K2-K4's
     `launches` are the fleet run's, one micro-batch of each net), the card
     line, and
     {"ok": true, "device": {"platform": "gpu", ...}} as the last line.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "golden_torch",
                       "mobilenet_v2_alpha1_224_act8")
EFFNET = os.path.join(ROOT, "tests", "golden_torch",
                      "efficientnet_compact_h128_act8")
# the [fleet] phase's nets: fixture path without extension, input size
FLEET = {"mobilenet_v2": (FIXTURE, 224), "efficientnet_compact": (EFFNET, 128)}
# the paper's FPS/W on the ZCU102 (its Table 6), printed for comparison only
PAPER_FPS_PER_W = {"mobilenet_v2": 47.4, "efficientnet_compact": 233.3}
OUT_DIR = os.path.join(ROOT, "smoke_out")  # the trace and metrics of [fleet]
LOOP_S = 3.0  # a closed-loop run of [fleet]
TUNE_LOOP_S = 1.5  # a closed-loop run of [tune]
POWER_WINDOW_S = 6.0  # nvidia-smi sampling of the idle and busy draw
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, same source
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak, same source
CSRC = "src/repro_torch/kernels/csrc/"
# kernel: (its source, the TPU kernel it replaces)
KERNELS = {
    "pointwise_conv_q": (CSRC + "pointwise_conv.cu",
                         "src/repro/kernels/pointwise_conv.py:109"),
    "depthwise_conv_q": (CSRC + "depthwise_conv.cu",
                         "src/repro/kernels/depthwise_conv.py:126"),
    "fused_irb_q": (CSRC + "fused_irb.cu",
                    "src/repro/kernels/fused_irb.py:163"),
    "quant_matmul": (CSRC + "quant_matmul.cu",
                     "src/repro/kernels/quant_matmul.py:74"),
    "decode_attention": (CSRC + "decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:104"),
}
EXPECTED_LAUNCHES = {"pointwise_conv_q": 3, "depthwise_conv_q": 1,
                     "fused_irb_q": 16, "quant_matmul": 0,
                     "decode_attention": 0}
# K4's launches a micro-batch by variant: E split at 14x14 and 7x7
EXPECTED_IRB_VARIANTS = {"single": 5, "split_e": 11}
SPLIT_E_HW = (14, 7)  # output sizes whose K4 launches must split E
LM_GOLDEN = os.path.join(ROOT, "tests", "golden_torch",
                         "llama32_1b_lm_ops.npz")
# (rtol, atol) of the JAX tests (test_kernels_quant_matmul.py:33, :48;
# test_kernels_decode_attention.py:38): the sums run in another order
QMM_TOL = {"float32": (1e-5, 1e-3), "bfloat16": (2e-2, 2e-1)}
ATTN_TOL = (1e-5, 1e-5)
REPS = 25
SPIN_CYCLES = 2_000_000  # about 1 ms at the H100's clock
FLUSH_BYTES = 256 << 20  # written before each cold call: 5x the 50 MB L2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def images(hw: int = 224):
    """A fixture's 8 inputs, regenerated from their seed."""
    import numpy as np
    return np.random.default_rng(0).uniform(
        -1, 1, (8, hw, hw, 3)).astype(np.float32)


def digests(act) -> list:
    import numpy as np
    u8 = np.ascontiguousarray(act.cpu().numpy().astype(np.uint8))
    return [hashlib.sha256(row.tobytes()).hexdigest() for row in u8]


def time_ms(fn, reps: int = REPS, device_only: bool = False,
            flush=None, samples=None, warmup: int = 3) -> float:
    """Median time of one call, CUDA events around each call: the call as
    the host sees it, its Python wrapper and launch cost included (the
    `ms` of every kernel line and of the JSON line). With `device_only`, a
    spin kernel (`torch.cuda._sleep`, about 1 ms) holds the stream while
    the host enqueues the first event, the call and the second event, so
    the interval is the device's work alone (`device_ms`); a call whose
    host side outlasts the spin still shows its gaps. With `flush`, a
    tensor of FLUSH_BYTES is zeroed before each call, outside the events,
    so that the call finds the L2 cache holding none of its inputs
    (`cold_device_ms`). With `samples`, a list, every time is appended to
    it. `warmup` calls run first, untimed."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.zero_()
        if device_only:
            torch.cuda._sleep(SPIN_CYCLES)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    if samples is not None:
        samples.extend(times)
    return statistics.median(times)


def nbytes(*ts) -> int:
    """Bytes of tensors as stored (weights and per-channel constants)."""
    return sum(t.numel() * t.element_size() for t in ts)


def bytes_moved(acts_in: int, acts_out: int, consts: int):
    """(least, as stored): the bytes a call must move with its activations
    at 1 byte a value (all lie in [0, 255]), and with them as the int32 the
    kernels read and write."""
    return acts_in + acts_out + consts, 4 * (acts_in + acts_out) + consts


def main_path_calls(pq, x):
    """Walk the net on `x` with the plain route; return every kernel call
    the served path makes, as (kernel, label, kernel_fn, plain_fn,
    library_fn or None, (least bytes, bytes as stored), ops, plan text)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import cu, graph as G
    from repro_torch.kernels import ops as K
    from repro_torch.kernels.depthwise_conv import (
        depthwise_conv_q, depthwise_conv_q_plain)
    from repro_torch.kernels.fused_irb import (
        fused_irb_q, fused_irb_q_plain, plan as irb_plan)

    calls = []
    s, z = cu.input_qparams(pq)
    y = cu.quantize_input(x, pq.input_scale, z)
    for block in pq.spec.blocks:
        if K.fusable_irb(block):
            tensors, kw, _, _ = K.irb_args(block, pq, s, z)
            xin = y
            b, h, w, c = xin.shape
            e_ch, c_out = tensors[0].shape[1], tensors[8].shape[1]
            kk = kw["kernel"] ** 2
            ho, wo = -(-h // kw["stride"]), -(-w // kw["stride"])
            ops = 2 * b * (h * w * c * e_ch + ho * wo * e_ch * kk
                           + ho * wo * e_ch * c_out)
            irb = irb_plan(b, h, w, c, e_ch, c_out, kw["kernel"],
                           kw["stride"])
            calls.append((
                "fused_irb_q", block.name,
                lambda a=xin, t=tensors, k=kw: fused_irb_q(a, *t, **k),
                lambda a=xin, t=tensors, k=kw: fused_irb_q_plain(a, *t, **k),
                None,
                bytes_moved(xin.numel(), b * ho * wo * c_out,
                            nbytes(*tensors)), ops,
                f" tile={irb.tile} splits={irb.splits} "
                f"eslice={irb.eslice}"))
        else:
            h_in = y
            for op in block.ops:
                pop = pq.ops[op.name]
                if op.kind == G.DW:
                    kw = dict(kernel=op.kernel, stride=op.stride,
                              qmax=pop.qmax)
                    args = (h_in, pop.w_kern, pop.mult, pop.zpc, pop.bias_q)
                    xf = h_in.to(torch.float32).permute(0, 3, 1, 2)
                    wf = pop.w_kern.to(torch.float32).permute(2, 0, 1)[:, None]
                    pad = (op.kernel - 1) // 2
                    b, hh, ww, c = h_in.shape
                    ho, wo = -(-hh // op.stride), -(-ww // op.stride)
                    calls.append((
                        "depthwise_conv_q", op.name,
                        lambda a=args, k=kw: depthwise_conv_q(*a, **k),
                        lambda a=args, k=kw: depthwise_conv_q_plain(*a, **k),
                        lambda xf=xf, wf=wf, st=op.stride, p=pad, g=c:
                            F.conv2d(xf, wf, stride=st, padding=p, groups=g),
                        bytes_moved(h_in.numel(), b * ho * wo * c,
                                    nbytes(*args[1:])),
                        2 * b * ho * wo * c * op.kernel ** 2, ""))
                elif op.kind in (G.PW, G.DENSE) and op.act != G.HSIGMOID:
                    calls.append(pw_call(h_in, pop, op.name))
                h_in = cu.run_qop(h_in, pop)
                if block.se is not None and block.se_after == op.name:
                    # the SE squeeze takes K2 on the pooled tensor; the
                    # hsigmoid excite and the gate are torch ops
                    calls.append(pw_call(
                        cu.mean_round(h_in), pq.ops[block.se.squeeze.name],
                        block.se.squeeze.name))
                    h_in = cu.se_gate(h_in, block, pq)
        y, s, z = cu.run_block(y, block, pq, s, z)
    return calls


def pw_call(h_in, pop, label):
    """One K2 call of the main path as `main_path_calls` lists it."""
    import torch

    from repro_torch.kernels.pointwise_conv import (
        plan as pw_plan, pointwise_conv_q, pointwise_conv_q_plain)

    kw = dict(qmax=pop.qmax)
    args = (h_in, pop.w_kern, pop.mult, pop.zpc, pop.bias_q)
    k_dim, n_dim = pop.w_kern.shape
    m = h_in.numel() // k_dim
    xf = h_in.reshape(m, k_dim).to(torch.float32)
    wf = pop.w_kern.to(torch.float32)
    pw = pw_plan(m, k_dim, n_dim)
    return ("pointwise_conv_q", label,
            lambda a=args, k=kw: pointwise_conv_q(*a, **k),
            lambda a=args, k=kw: pointwise_conv_q_plain(*a, **k),
            lambda xf=xf, wf=wf: torch.matmul(xf, wf),
            bytes_moved(h_in.numel(), m * n_dim, nbytes(*args[1:])),
            2 * m * k_dim * n_dim, f" tile={pw.tile} splits={pw.splits}")


def phase_kernels(nets):
    """Each kernel call of each net's main path (`nets`: (label, prepared
    net, images on the card)) against its plain version, then timed. Returns
    the rows summed over every net's micro-batch."""
    import torch

    from repro_torch.kernels.fused_irb import fused_irb_q

    print("[kernels] each kernel against its plain version on the main "
          "path's inputs, batch 8 (tolerance: exact), called twice (the "
          "same bits)")
    rows = {}
    for net, pq, x in nets:
        per_net = {}
        for name, label, kern, plain, lib, (nb, nb32), ops, note in \
                main_path_calls(pq, x):
            before = dict(fused_irb_q.variants)
            got = kern()
            took = [v for v, n in fused_irb_q.variants.items()
                    if n != before[v]]
            again, want = kern(), plain()
            torch.cuda.synchronize()
            if name == "fused_irb_q" and got.shape[1] in SPLIT_E_HW and \
                    took != ["split_e"]:
                raise SystemExit(f"[kernels] {name}[{label}] at "
                                 f"{got.shape[1]}x{got.shape[2]} took "
                                 f"{took}, not the split-E variant")
            err = int((got.to(torch.int64) - want.to(torch.int64)
                       ).abs().max())
            if got.shape != want.shape or err != 0:
                raise SystemExit(f"[kernels] {net} {name}[{label}] differs "
                                 f"from its plain version: max |err| {err}")
            if not torch.equal(got, again):
                raise SystemExit(f"[kernels] {net} {name}[{label}]: two "
                                 f"calls gave different bits")
            ms, plain_ms = time_ms(kern), time_ms(plain)
            lib_ms = time_ms(lib) if lib is not None else None
            dev_ms = time_ms(kern, device_only=True)
            lib_dev_ms = (time_ms(lib, device_only=True) if lib is not None
                          else None)
            bytes_ms = nb / HBM_BYTES_PER_S * 1e3
            bytes32_ms = nb32 / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / INT8_OPS_PER_S * 1e3
            print(f"  {net} {name}[{label}] {tuple(got.shape)}{note} "
                  f"max_abs_err={err} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms="
                  f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} "
                  f"bound_ms={max(bytes_ms, ops_ms):.5f} "
                  f"({'bytes' if bytes_ms >= ops_ms else 'operations'}; "
                  f"int32 activations: {max(bytes32_ms, ops_ms):.5f}) "
                  f"device_ms={dev_ms:.4f} library_device_ms="
                  f"{'null' if lib_dev_ms is None else f'{lib_dev_ms:.4f}'}")
            for table in (rows, per_net):
                r = _row(table, name, err, ms, plain_ms, lib_ms, bytes_ms,
                         ops_ms, dev_ms, lib_dev_ms)
                r["bound32"] += max(bytes32_ms, ops_ms)
                r["calls"] = r.get("calls", 0) + 1
        for name, r in per_net.items():
            print(f"[kernels] {net} {name}: {r['calls']} calls, ms "
                  f"{r['ms']:.4f} over the micro-batch, bound_ms "
                  f"{r['bound']:.5f} (1-byte activations), "
                  f"{r['bound32']:.5f} (int32 activations)")
        for name, r in per_net.items():
            print(f"[kernels] {net} {name}: over the micro-batch, "
                  f"plain_ms {r['plain_ms']:.4f}, library_ms "
                  f"{_opt(r, 'lib_ms')}; device work alone: device_ms "
                  f"{r['dev_ms']:.4f}, library_device_ms "
                  f"{_opt(r, 'lib_dev_ms')}")
    return rows


def phase_serve(imgs, fix):
    import numpy as np
    import torch

    from repro_torch.core import cu
    from repro_torch.kernels import ops as K
    from repro_torch.kernels.fused_irb import fused_irb_q
    from repro_torch.serve.vision import VisionEngine

    if (EXPECTED_LAUNCHES["depthwise_conv_q"],
            EXPECTED_LAUNCHES["fused_irb_q"]) != (1, 16):
        raise SystemExit(f"[serve] EXPECTED_LAUNCHES {EXPECTED_LAUNCHES} "
                         f"no longer reads depthwise 1, fused IRB 16")
    eng = VisionEngine.from_artifact(FIXTURE + ".qnet", device="cuda",
                                     buckets=(8,))
    eng.warmup()
    K.reset_launch_counts()
    rids = [eng.submit(img) for img in imgs]
    res = eng.run()
    counts = K.launch_counts()
    irb_variants = dict(fused_irb_q.variants)
    stats = eng.stats()
    print(f"[serve] launch counts {counts}; fused_irb_q by variant "
          f"{irb_variants}; micro-batches {stats.micro_batches}; stage "
          f"invocations {stats.stage_invocations}")
    want = {k: v * stats.micro_batches for k, v in EXPECTED_LAUNCHES.items()}
    if counts != want:
        raise SystemExit(f"[serve] launches {counts} != expected {want}")
    want = {k: v * stats.micro_batches
            for k, v in EXPECTED_IRB_VARIANTS.items()}
    if irb_variants != want:
        raise SystemExit(f"[serve] fused_irb_q variants {irb_variants} != "
                         f"expected {want}")
    logits = np.stack([res[r].logits for r in rids])
    n_diff = int(np.sum(logits != fix["logits"]))
    print(f"[serve] {len(rids)} images: {n_diff} of {logits.size} logits "
          f"differ from the JAX package's run_qnet")
    if n_diff:
        raise SystemExit("[serve] logits are not bit-identical")
    y = torch.from_numpy(imgs).to(eng.device)
    for i, st in enumerate(eng.stages):
        y = st.run(y)
        if i + 1 < len(eng.stages) and \
                digests(y) != list(fix["stage_sha256"][i]):
            raise SystemExit(f"[serve] stage {i} ({st.spec.cu}) output "
                             f"differs from the reference's")
    print(f"[serve] every stage output equals the reference's digests")
    ref = cu.run_qnet(eng.pq, imgs).cpu().numpy()
    n_diff = int(np.sum(ref != fix["logits"]))
    print(f"[run_qnet] the port's cu.run_qnet on the card: {n_diff} of "
          f"{ref.size} logits differ from the JAX package's")
    if n_diff:
        raise SystemExit("[run_qnet] logits are not bit-identical")
    return counts


def phase_throughput(imgs, card):
    import torch

    from repro_torch.serve.vision import VisionEngine

    eng = VisionEngine.from_artifact(FIXTURE + ".qnet", device="cuda",
                                     buckets=(1, 2, 4, 8))
    eng.warmup()
    n, t_end = 0, time.perf_counter() + 4.0
    while time.perf_counter() < t_end:
        for i in range(64):
            eng.submit(imgs[i % len(imgs)])
        n += sum(r.status == "ok" for r in eng.run().values())
    st = eng.stats()
    print(f"[throughput] {card}: closed loop of 64 queued requests, buckets "
          f"1/2/4/8: {n} images in {st.wall_s:.3f} s, FPS {st.fps:.1f}, "
          f"p50 {st.latency_p50_s * 1e3:.3f} ms, p95 "
          f"{st.latency_p95_s * 1e3:.3f} ms, micro-batches "
          f"{st.micro_batches}, pad fraction {st.pad_fraction:.3f}")
    one = VisionEngine.from_artifact(FIXTURE + ".qnet", device="cuda",
                                     buckets=(1,))
    one.warmup()
    for i in range(200):
        one.submit(imgs[i % len(imgs)])
        one.run()
    st = one.stats()
    print(f"[throughput] {card}: one request at a time, 200 requests: FPS "
          f"{st.fps:.1f}, p50 {st.latency_p50_s * 1e3:.3f} ms, p95 "
          f"{st.latency_p95_s * 1e3:.3f} ms")
    x = torch.from_numpy(imgs).to(eng.device)
    parts = []
    for stage in eng.stages:
        ms = time_ms(lambda s=stage, a=x: s.run(a))
        parts.append(f"{stage.spec.cu} {ms:.4f}")
        x = stage.run(x)
    print(f"[throughput] device ms per stage at batch 8, CUDA events: "
          f"{'; '.join(parts)}")
    profile(eng, imgs)


def lm_cases():
    """`tests/torch_lm_cases.py`, loaded by its path: a `tests` package
    installed elsewhere may shadow the repo's."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_lm_cases", os.path.join(ROOT, "tests", "torch_lm_cases.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stream_cases():
    """`tests/torch_stream_cases.py`, loaded by its path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_stream_cases",
        os.path.join(ROOT, "tests", "torch_stream_cases.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def serve_fleet(eng, frames):
    """Open one session a stream, stage every frame with `push(defer=True)`
    and `drain()`; returns (logits [sessions * windows, classes] in
    session-major order, the drain's seconds)."""
    import numpy as np

    sids = [eng.open_session() for _ in range(len(frames))]
    for sid, fr in zip(sids, frames):
        eng.push(sid, fr, defer=True)
    t0 = time.perf_counter()
    res = eng.drain()
    secs = time.perf_counter() - t0
    by = {(r.sid, r.window): r.logits for r in res}
    n_win = len(res) // len(sids)
    return np.stack([by[(sid, w)] for sid in sids
                     for w in range(n_win)]), secs


def phase_stream(card):
    """The streaming 1-D path on the card, both requant modes, against the
    JAX package's full-window logits; then its times."""
    import numpy as np
    import torch

    from repro_torch.core.qnet import load_qnet
    from repro_torch.kernels import ops as K
    from repro_torch.serve.stream import StreamEngine

    SC = stream_cases()
    c = SC.CASES["kws"]
    qnet_path, npz_path = SC.paths("kws")
    fix = np.load(npz_path)
    qnet = load_qnet(qnet_path)
    frames = SC.frames("kws")
    for fixed in (False, True):
        mode = "fixed point" if fixed else "float"
        eng = StreamEngine(qnet, c["hop"], fixed_point=fixed, device="cuda",
                           max_sessions=c["sessions"],
                           batch_buckets=SC.BUCKETS)
        eng.warm(SC.BUCKETS)
        K.reset_launch_counts()
        got, secs = serve_fleet(eng, frames)
        counts = K.launch_counts()
        want = fix["logits_fixed" if fixed else "logits_float"]
        n_diff = int(np.sum(got != want)) if got.shape == want.shape else -1
        st = eng.stats()
        print(f"[stream] KWS {mode}, {c['sessions']} sessions x "
              f"{c['windows']} windows at hop {c['hop']} through drain() "
              f"({secs * 1e3:.3f} ms): {n_diff} of {want.size} logits differ "
              f"from the JAX package's run_qnet over each full window; "
              f"{st['frames_per_window_step']:.0f} of "
              f"{st['frames_per_window_full']:.0f} conv frames a step, "
              f"{st['session_buffer_bytes']:.0f} B of ring buffers a "
              f"session; batched programs {st['batched_traces']:.0f} "
              f"(bound {2 * len(eng.batch_buckets)})")
        print(f"[stream] launch counts {counts}: 0 by design, the streaming "
              f"path runs torch ops only (the reference runs it through no "
              f"kernel either)")
        if n_diff:
            raise SystemExit(f"[stream] KWS {mode}: logits are not "
                             f"bit-identical")
        if any(counts.values()):
            raise SystemExit(f"[stream] a kernel was launched: {counts}")
        if st["batched_traces"] > 2 * len(eng.batch_buckets):
            raise SystemExit("[stream] more batched programs than buckets")
        stream_times(eng, card, mode, c)

    # the conformance golden's frozen per-window logits (window 32, hop 4)
    gold = np.load(os.path.join(ROOT, "tests", "golden", "dscnn_kws_act8.npz"))
    eng = StreamEngine(load_qnet(os.path.join(
        ROOT, "tests", "golden", "dscnn_kws_act8.qnet")), 4, device="cuda")
    res = eng.push(eng.open_session(), gold["stream_frames"])
    got = np.stack([r.logits for r in res])
    n_diff = (int(np.sum(got != gold["stream_logits"]))
              if got.shape == gold["stream_logits"].shape else -1)
    print(f"[stream] tests/golden/dscnn_kws_act8 stream_logits: {n_diff} of "
          f"{gold['stream_logits'].size} differ")
    if n_diff:
        raise SystemExit("[stream] frozen stream_logits differ")

    # HAR: stride-2 depthwise halos, float
    c = SC.CASES["har"]
    qnet_path, npz_path = SC.paths("har")
    eng = StreamEngine(load_qnet(qnet_path), c["hop"], device="cuda",
                       max_sessions=c["sessions"], batch_buckets=SC.BUCKETS)
    K.reset_launch_counts()
    got, secs = serve_fleet(eng, SC.frames("har"))
    want = np.load(npz_path)["logits_float"]
    n_diff = int(np.sum(got != want)) if got.shape == want.shape else -1
    print(f"[stream] HAR float, {c['sessions']} sessions x {c['windows']} "
          f"windows at hop {c['hop']} ({secs * 1e3:.3f} ms, first run): "
          f"{n_diff} of {want.size} logits differ; launch counts "
          f"{K.launch_counts()}")
    if n_diff or any(K.launch_counts().values()):
        raise SystemExit("[stream] HAR logits are not bit-identical or a "
                         "kernel was launched")
    torch.cuda.synchronize()


def stream_times(eng, card, mode, c):
    """Prime ms at each bucket (CUDA events around the call, its host side
    included), ms per drain() round with every session one hop behind, the
    fleet's windows/s, and one session's step p50 (push of one hop, wall
    clock, logits back on the host)."""
    import numpy as np
    import torch

    from repro_torch.serve.stream import StreamEngine

    rng = np.random.default_rng(3)
    parts = []
    for b in (1,) + tuple(eng.batch_buckets):
        x = torch.from_numpy(rng.uniform(-1, 1, (
            b, eng.window, eng.input_ch)).astype(np.float32)).to(eng.device)
        parts.append(f"{b}: {time_ms(lambda x=x: eng._prime(x), reps=10):.3f}")
    print(f"[stream] {card}: KWS {mode} prime ms by bucket "
          f"{'; '.join(parts)}")
    sids = list(eng._sessions)
    rounds = []
    for _ in range(40):
        for sid in sids:
            eng.push(sid, rng.uniform(-1, 1, (eng.hop, eng.input_ch)).astype(
                np.float32), defer=True)
        t0 = time.perf_counter()
        n = len(eng.drain())
        rounds.append(time.perf_counter() - t0)
        if n != len(sids):
            raise SystemExit(f"[stream] a drain round gave {n} windows")
    med = statistics.median(rounds)
    print(f"[stream] {card}: KWS {mode}, {len(sids)} sessions one hop "
          f"behind: drain() round p50 {med * 1e3:.3f} ms (min "
          f"{min(rounds) * 1e3:.3f}, max {max(rounds) * 1e3:.3f}, 40 "
          f"rounds), fleet {len(sids) / med:.1f} windows/s "
          f"({len(sids) * len(rounds) / sum(rounds):.1f} over all rounds)")
    profile_stream(eng, rng, mode)
    one = StreamEngine(eng.pq, eng.hop, fixed_point=eng.fixed_point,
                       device=eng.device)
    sid = one.open_session()
    one.push(sid, rng.uniform(-1, 1, (eng.window, eng.input_ch)).astype(
        np.float32))
    steps = []
    for _ in range(200):
        hop = rng.uniform(-1, 1, (eng.hop, eng.input_ch)).astype(np.float32)
        t0 = time.perf_counter()
        one.push(sid, hop)
        steps.append(time.perf_counter() - t0)
    steps.sort()
    print(f"[stream] {card}: KWS {mode}, one session, 200 single steps "
          f"(push of one hop): p50 {statistics.median(steps) * 1e3:.3f} ms, "
          f"p95 {steps[189] * 1e3:.3f} ms")


def profile_stream(eng, rng, mode, rounds: int = 10):
    """Device busy share of `drain()` rounds with every session one hop
    behind, under torch.profiler, and the host ops and device intervals a
    round."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    sids = list(eng._sessions)
    hops = rng.uniform(-1, 1, (rounds, len(sids), eng.hop, eng.input_ch)
                       ).astype(np.float32)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in range(rounds):
            for sid, fr in zip(sids, hops[r]):
                eng.push(sid, fr, defer=True)
            eng.drain()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    n_dev = sum(e.device_type == DeviceType.CUDA for e in events)
    n_aten = sum(e.device_type == DeviceType.CPU and
                 e.name.startswith("aten::") and e.cpu_parent is None
                 for e in events)
    busy = busy_ms(events)
    if busy <= 0:
        print("[stream] torch.profiler reported no device time: busy share "
              "not measured")
        return
    print(f"[stream] KWS {mode}, {rounds} drain() rounds of {len(sids)} "
          f"sessions under torch.profiler: wall {wall_ms:.3f} ms, device "
          f"busy {busy:.3f} ms, busy share {busy / wall_ms:.4f}; a round: "
          f"{n_dev / rounds:.0f} device intervals, {n_aten / rounds:.0f} "
          f"top-level aten ops on the host")


# [train]: the paper's full-width MobileNetV2 (w8/a8, BN) and the compact
# EfficientNet at its published size, trained from seeded random weights
TRAIN_CFGS = {
    "mobilenet_v2": dict(model="mobilenet_v2", alpha=1.0, input_hw=224,
                         num_classes=1000, bits=8, act_bits=8, bn=True,
                         batch=32, float_steps=2, qat_steps=2,
                         calibrate_every=1, calib_batches=2),
    "efficientnet_compact": dict(model="efficientnet_compact", input_hw=128,
                                 num_classes=1000, bits=8, act_bits=8,
                                 bn=True, batch=32, float_steps=1,
                                 qat_steps=1, calibrate_every=1,
                                 calib_batches=2),
}
TRAIN_STOP_AT = 3  # the MobileNetV2 run is killed here, then resumed
TRAIN_REPS = 6  # timed steps a phase (median)
# the JAX trainer test's config, held step by step on the card against the
# CPU (repro_torch.train.parity)
TINY_CFG = dict(model="mobilenet_v2", alpha=0.35, input_hw=16, num_classes=4,
                float_steps=4, qat_steps=4, batch=8, anneal_from=8,
                calibrate_every=2)


def tiny_step_parity(dev):
    """The tiny config's schedule walked on the CPU; every step, QAT
    fake-quant forward and calibration round also run on the card from
    the CPU's state and held against it (`parity.verify_train_steps`,
    the CPU tests' tolerances against the reference). Fails the phase on
    any miss."""
    from repro_torch.train import parity as P
    from repro_torch.train import vision as V

    t0 = time.perf_counter()
    rep = P.verify_train_steps(V.VisionTrainConfig(**TINY_CFG), device=dev)
    for e in rep["steps"]:
        fq = (f"; fake-quant outputs {e['fq_flipped']} of "
              f"{e['fq_elements']} a step apart (worst "
              f"{e['fq_steps']:.3g} steps)" if "fq_elements" in e else "")
        print(f"[train] tiny step {e['step']} ({e['phase']}) card against "
              f"CPU from the CPU's state: loss {e['loss_dev']!r} against "
              f"{e['loss_cpu']!r} (rel {e['loss_rel']:.3g}); gradients "
              f"{e['grad_l2']:.3g} apart in rel L2, worst element "
              f"{e['grad_elem']:.3g} of the largest; updated params worst "
              f"{e['param_max']:.3g} apart (lr {e['lr']:.3g}), "
              f"{e['param_sure']:.3g} where the gradient is sure; BN stats "
              f"at {e['bn']:.3g} of their tolerance; the card's AdamW on "
              f"the CPU's gradients: params at {e['opt_param']:.3g} of "
              f"their tolerance, moments {e['opt_moment']:.3g} apart "
              f"relative to their magnitude{fq}")
    for r in rep["rounds"]:
        print(f"[train] tiny online-quant round after step {r['step']}: "
              f"observers {r['obs']:.3g} apart relative to their range")
    print(f"[train] tiny config: {len(rep['steps'])} steps and "
          f"{len(rep['rounds'])} rounds held against the CPU in "
          f"{time.perf_counter() - t0:.1f} s; failures {rep['failures']}")
    if rep["failures"]:
        raise SystemExit("[train] tiny config: the card's steps differ from "
                         "the CPU's")


def _state_leaves(result):
    from repro_torch.train import tree as T
    from repro_torch.train import vision as V
    return T.leaves((result.params, result.opt_state,
                     V._obs_tree(result.observers)))


def train_step_ms(cfg, dev):
    """Median ms (CUDA events, the host included) of a float step (BN on
    batch statistics) and of a QAT step at the config's size, from the
    seeded init, each over TRAIN_REPS calls after 3 warm-ups."""
    from repro_torch.models import layers
    from repro_torch.train import optimizer as O
    from repro_torch.train import vision as V

    net = V.build_net(cfg)
    opt = O.AdamWConfig(lr=cfg.lr, warmup_steps=1, total_steps=4,
                        weight_decay=cfg.weight_decay)
    batch = V.train_batch(cfg, 0, dev)
    params = layers.init_params(cfg.seed, net, bn=True, device=dev)
    fused = layers.fuse_bn_params(params)
    out = {}
    for name, p, qat in (("float", params, False), ("qat", fused, True)):
        step = V.make_vision_train_step(net, opt, qat=qat, bn_batch=not qat)
        state = O.init_state(p)
        out[name] = time_ms(lambda: step(p, state, batch), reps=TRAIN_REPS)
        out[name + "_profile"] = profile_steps(
            lambda: step(p, state, batch))
    return out


def profile_steps(fn, n: int = 1):
    """`n` calls of a train step under torch.profiler (one: the profile's
    thousands of events take seconds to read back): wall ms a step,
    device busy ms a step (the union of device intervals), device
    intervals a step, those intervals by kernel family (ms and launches a
    step), and the five heaviest kernels; None where the profiler saw no
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [(evt.self_device_time_total / 1e3, evt.count, evt.key)
           for evt in prof.key_averages()
           if evt.device_type == DeviceType.CUDA]
    busy = busy_ms(prof.events())
    if not dev or busy <= 0:
        return None
    families = {}
    for d, c, k in dev:
        fam = next((f for f in ("elementwise", "reduce", "conv", "gemm")
                    if f in k.lower()), "other")
        ms, cnt = families.get(fam, (0.0, 0))
        families[fam] = (ms + d / n, cnt + c // n)
    return {"wall_ms": wall_ms / n, "busy_ms": busy / n,
            "intervals": sum(c for _, c, _ in dev) / n,
            "families": {f: (round(ms, 3), cnt)
                         for f, (ms, cnt) in sorted(families.items())},
            "top": [(round(d / n, 3), c // n, k[:60]) for d, c, k in
                    sorted(dev, reverse=True)[:5]]}


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def export_and_serve(tag, result, dev, card):
    """Export on the card (every route proven on 8 held-out images), then
    serve the artifact through `VisionEngine` on the card with the launch
    counters set to 0 just before and read just after, and hold its logits
    and the export's against the port's `cu.run_qnet` on the CPU."""
    import tempfile

    import numpy as np

    from repro_torch.core import compiler as CC
    from repro_torch.core import cu
    from repro_torch.core.qnet import load_qnet
    from repro_torch.kernels import ops as K
    from repro_torch.kernels.fused_irb import fused_irb_q
    from repro_torch.serve.vision import VisionEngine
    from repro_torch.train import vision as V

    cfg = result.cfg
    x = V.calibration_batches(cfg, "cpu")[0][:8].numpy()
    with tempfile.TemporaryDirectory(prefix="train_export_") as tmp:
        path = os.path.join(tmp, f"{tag}.qnet")
        K.reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        qnet, report = V.export(result.params, result.net, cfg, path=path,
                                observers=result.observers, verify_batch=x,
                                device=dev)
        _sync(dev)
        export_ms = (time.perf_counter() - t0) * 1e3
        counts = K.launch_counts()
        per = K.served_launches(CC.compile_net(qnet.spec))
        print(f"[train] {tag}: export on {report['device']} in "
              f"{export_ms:.1f} ms ({card}); routes proven bit-exact "
              f"{report['routes']}; {report['artifact_bytes']} bytes; "
              f"launches during the proof {counts} (a micro-batch: "
              f"{ {k: v for k, v in per.items() if v} }, two micro-batches: "
              f"the stage executors and the engine)")
        if counts != {k: 2 * v for k, v in per.items()}:
            raise SystemExit(f"[train] {tag}: the proof launched {counts}")
        cpu = cu.run_qnet(load_qnet(path), x, device="cpu").numpy()
        n_diff = int(np.sum(report["logits"] != cpu))
        print(f"[train] {tag}: exported logits on the card against the "
              f"port's cu.run_qnet on the CPU: {n_diff} of {cpu.size} "
              f"differ")
        if n_diff:
            raise SystemExit(f"[train] {tag}: exported logits differ")
        eng = VisionEngine.from_artifact(path, device=dev, buckets=(8,))
        eng.warmup()
        K.reset_launch_counts()
        rids = [eng.submit(img) for img in x]
        res = eng.run()
        counts, variants = K.launch_counts(), dict(fused_irb_q.variants)
        served = np.stack([res[r].logits for r in rids])
        n_diff = int(np.sum(served != cpu))
        print(f"[train] {tag}: VisionEngine on the card, 8 requests: launch "
              f"counts {counts}; fused_irb_q by variant {variants}; {n_diff} "
              f"of {cpu.size} logits differ from the CPU's")
        if counts != per or n_diff:
            raise SystemExit(f"[train] {tag}: served launches {counts} != "
                             f"{per}, or logits differ")
        if per["fused_irb_q"] and variants != EXPECTED_IRB_VARIANTS:
            raise SystemExit(f"[train] {tag}: fused_irb_q variants "
                             f"{variants}")
        return export_ms


def phase_train(card, dev):
    """The training front end on the card: full-width MobileNetV2 trained
    straight, and again killed at step TRAIN_STOP_AT and resumed (bitwise
    equal); both nets exported and proven bit-exact through K2-K4; step
    times, images/s, peak memory, the profiled device busy share; every
    step of the tiny config held on the card against the CPU's."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.train import vision as V

    t_phase = time.perf_counter()
    for tag, kw in TRAIN_CFGS.items():
        cfg = V.VisionTrainConfig(**kw)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        straight = V.train(cfg, device=dev)
        _sync(dev)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        print(f"[train] {tag}: {cfg.total_steps} steps of batch "
              f"{cfg.batch} at {cfg.input_hw}x{cfg.input_hw}, "
              f"{cfg.num_classes} classes, w{cfg.bits}/a{cfg.act_bits}: "
              f"losses {[round(v, 4) for v in straight.history['loss']]}; "
              f"{len(straight.history['calibration'])} online-quant rounds;"
              f" {wall:.2f} s with the calibration rounds; peak "
              f"max_memory_allocated {peak / 2**30:.3f} GiB ({card})")
        if not (straight.done and V.observers_ready(straight.observers)
                and np.isfinite(straight.history["loss"]).all()):
            raise SystemExit(f"[train] {tag}: run incomplete or not finite")
        if tag == "mobilenet_v2":
            with tempfile.TemporaryDirectory(prefix="train_ckpt_") as ckpt:
                part = V.train(cfg, ckpt_dir=ckpt, stop_after=TRAIN_STOP_AT,
                               device=dev)
                resumed = V.train(cfg, ckpt_dir=ckpt, resume=True,
                                  device=dev)
            a, b = _state_leaves(straight), _state_leaves(resumed)
            same = part.step == TRAIN_STOP_AT and len(a) == len(b) and all(
                x.dtype == y.dtype and torch.equal(x, y)
                for x, y in zip(a, b))
            print(f"[train] {tag}: killed at step {part.step}, resumed to "
                  f"{resumed.step}: {len(a)} leaves (params, optimizer "
                  f"state, observers) bitwise equal to the straight run: "
                  f"{same}; losses equal: "
                  f"{resumed.history['loss'] == straight.history['loss']}")
            if not same or resumed.history["loss"] != straight.history["loss"]:
                raise SystemExit(f"[train] {tag}: restart is not bitwise")
        ms = train_step_ms(cfg, dev)
        print(f"[train] {tag}: {card}: float step {ms['float']:.3f} ms "
              f"({cfg.batch / ms['float'] * 1e3:.1f} images/s), QAT step "
              f"{ms['qat']:.3f} ms ({cfg.batch / ms['qat'] * 1e3:.1f} "
              f"images/s) (median of {TRAIN_REPS}, CUDA events, host "
              f"included); peak max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        for kind in ("float", "qat"):
            prof = ms[kind + "_profile"]
            if prof is None:
                print(f"[train] {tag}: {kind} step: torch.profiler saw no "
                      f"device time: busy share not measured")
                continue
            print(f"[train] {tag}: {kind} step under torch.profiler, a step:"
                  f" wall {prof['wall_ms']:.3f} ms, device busy "
                  f"{prof['busy_ms']:.3f} ms (share "
                  f"{prof['busy_ms'] / prof['wall_ms']:.4f}), "
                  f"{prof['intervals']:.0f} device intervals; by kernel "
                  f"family (ms, launches a step) {prof['families']}; heaviest "
                  f"(ms a step, launches a step, kernel) {prof['top']}")
        export_and_serve(tag, straight, dev, card)
    tiny_step_parity(dev)
    print(f"[train] phase: {time.perf_counter() - t_phase:.1f} s")


def phase_fixed_point(imgs, card):
    """The full-width MobileNetV2 in fixed point, served and through
    `run_qnet`, against the JAX package's x64 fixed-point logits."""
    import functools

    import numpy as np
    import torch

    from repro_torch.core import cu
    from repro_torch.kernels import ops as K
    from repro_torch.serve.vision import VisionEngine

    want = np.load(FIXTURE + "_fixed.npz")["logits"]
    eng = VisionEngine.from_artifact(FIXTURE + ".qnet", device="cuda",
                                     buckets=(8,), fixed_point=True)
    eng.warmup()
    K.reset_launch_counts()
    rids = [eng.submit(img) for img in imgs]
    res = eng.run()
    counts = K.launch_counts()
    logits = np.stack([res[r].logits for r in rids])
    n_diff = int(np.sum(logits != want))
    print(f"[fixed_point] VisionEngine(fixed_point=True), 8 images: {n_diff} "
          f"of {want.size} logits differ from the JAX package's x64 "
          f"fixed-point run_qnet")
    print(f"[fixed_point] launch counts {counts}: 0 by design, the kernels' "
          f"requant epilogue is float-multiplier only (the reference's "
          f"Pallas kernels too), so fixed point serves through the "
          f"reference torch ops")
    if n_diff:
        raise SystemExit("[fixed_point] served logits are not bit-identical")
    if any(counts.values()):
        raise SystemExit(f"[fixed_point] a kernel was launched: {counts}")
    x = torch.from_numpy(imgs).to(eng.device)
    ref = cu.run_qnet(eng.pq, x, fixed_point=True).cpu().numpy()
    n_diff = int(np.sum(ref != want))
    print(f"[fixed_point] cu.run_qnet(fixed_point=True) on the card: "
          f"{n_diff} of {want.size} logits differ")
    if n_diff:
        raise SystemExit("[fixed_point] run_qnet logits are not "
                         "bit-identical")
    chain = (lambda: functools.reduce(lambda y, st: st.run(y), eng.stages, x))
    ms = time_ms(chain, reps=10)
    print(f"[fixed_point] {card}: one micro-batch of 8 through the 4 CU "
          f"stages, fixed point: {ms:.3f} ms (CUDA events, host included)")


class PowerSampler:
    """`nvidia-smi --query-gpu=power.draw` every 100 ms in a subprocess, for
    as long as the `with` block runs; a reader thread stamps each sample
    with the host clock, so `median(t0, t1)` takes the draw over a window
    of the host's `time.perf_counter()`."""

    def __enter__(self):
        import threading

        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()
        return self

    def _read(self):
        for line in self.proc.stdout:
            try:
                watts = float(line.strip())
            except ValueError:  # "[N/A]" or a partial line
                continue
            self.samples.append((time.perf_counter(), watts))

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.thread.join(timeout=10)

    def median(self, t0: float, t1: float, least: int = 5):
        """(median watts, number of samples) of the samples in [t0, t1]."""
        got = [w for t, w in self.samples if t0 <= t <= t1]
        if len(got) < least:
            raise SystemExit(f"[fleet] nvidia-smi gave {len(got)} power "
                             f"samples in {t1 - t0:.2f} s")
        return statistics.median(got), len(got)


def power_constants(sampler, dev):
    """The card's draw at rest and held busy by a dense int8 matmul loop
    (the counterpart of the CPU calibration's integer matmul spin): the
    median of 100 ms samples over 6 s each."""
    import torch

    torch.cuda.synchronize()
    time.sleep(2.0)  # let the earlier phases' draw fall off
    t0 = time.perf_counter()
    time.sleep(POWER_WINDOW_S)
    idle, n_idle = sampler.median(t0, time.perf_counter())
    gen = torch.Generator(device=dev).manual_seed(0)
    a, b = (torch.randint(-128, 128, (8192, 8192), generator=gen,
                          device=dev, dtype=torch.int8) for _ in range(2))
    for _ in range(3):
        torch._int_mm(a, b)
    torch.cuda.synchronize()
    t_ramp = time.perf_counter()
    t0 = t_ramp + 1.0  # the first second ramps the clocks up
    while time.perf_counter() < t0 + POWER_WINDOW_S:
        for _ in range(8):
            torch._int_mm(a, b)
        torch.cuda.synchronize()
    busy, n_busy = sampler.median(t0, time.perf_counter())
    del a, b
    torch.cuda.empty_cache()
    return idle, n_idle, busy, n_busy


def fleet_engines(qnets, buckets, **kw):
    from repro_torch.serve.vision import VisionEngine

    return {m: VisionEngine(q, device="cuda", buckets=buckets, name=m, **kw)
            for m, q in qnets.items()}


def fleet_serve(qnets, imgs, obs: bool):
    """Both nets' 8 images through one `MultiModelEngine`, interleaved, with
    mixed deadlines (none, or 60 to 80 s away: none expires), with the
    launch counters set to 0 just before the run and read just after."""
    from repro_torch.kernels import ops as K
    from repro_torch.kernels.fused_irb import fused_irb_q
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.serve.vision import MultiModelEngine

    tracer, reg = (Tracer(), MetricsRegistry()) if obs else (None, None)
    mm = MultiModelEngine(fleet_engines(qnets, (8,), tracer=tracer,
                                        metrics=reg))
    mm.warmup()
    now = time.perf_counter()
    handles = {m: [] for m in qnets}
    for i in range(8):
        for j, m in enumerate(qnets):
            k = (i + j) % 3
            handles[m].append(mm.submit(
                m, imgs[m][i], deadline_s=None if k == 0
                else now + 50.0 + 10.0 * k))
    K.reset_launch_counts()
    res = mm.run()
    counts, variants = K.launch_counts(), dict(fused_irb_q.variants)
    logits = {m: [res[h].logits for h in hs] for m, hs in handles.items()}
    return mm, tracer, reg, logits, counts, variants


def fleet_exact(qnets, imgs, want, card):
    """Part 1: exactness, launches a micro-batch, the trace and its
    summary. Returns the launch counts of the obs-off run."""
    import numpy as np

    from repro_torch.core import compiler as CC
    from repro_torch.kernels import ops as K
    from repro_torch.obs import validate_chrome_trace

    runs = {obs: fleet_serve(qnets, imgs, obs) for obs in (False, True)}
    mm, _, _, logits, counts, variants = runs[False]
    expect = dict.fromkeys(counts, 0)
    for m, eng in mm.engines.items():
        per = K.served_launches(CC.compile_net(eng.pq.spec))
        batches = eng.stats().micro_batches
        print(f"[fleet] {m}: {batches} micro-batch of 8; launches a "
              f"micro-batch worked out from its NetSpec: "
              f"{ {k: v for k, v in per.items() if v} }")
        for k, v in per.items():
            expect[k] += v * batches
    print(f"[fleet] launch counts of the MultiModelEngine run: {counts}; "
          f"fused_irb_q by variant {variants}; dispatch_log "
          f"{mm.dispatch_log}")
    if counts != expect:
        raise SystemExit(f"[fleet] launches {counts} != expected {expect}")
    n_mnv2 = mm.engines["mobilenet_v2"].stats().micro_batches
    if variants != {k: v * n_mnv2 for k, v in EXPECTED_IRB_VARIANTS.items()}:
        raise SystemExit(f"[fleet] fused_irb_q variants {variants}")
    for m in qnets:
        got = np.stack(logits[m])
        on = np.stack(runs[True][3][m])
        n_diff = int(np.sum(got != want[m]))
        n_obs = int(np.sum(on != got))
        print(f"[fleet] {m}: {n_diff} of {want[m].size} logits differ from "
              f"the JAX package's run_qnet; obs on against obs off: "
              f"{n_obs} differ")
        if n_diff or n_obs:
            raise SystemExit(f"[fleet] {m}: logits are not bit-identical")
    mm_on, tracer, reg = runs[True][:3]
    os.makedirs(OUT_DIR, exist_ok=True)
    trace_path = tracer.save(os.path.join(OUT_DIR, "fleet_trace.json"))
    metrics_path = reg.save(os.path.join(OUT_DIR, "fleet_metrics.json"))
    with open(trace_path) as f:
        doc = json.load(f)
    errors = validate_chrome_trace(doc)
    spans = {}
    for ev in doc["traceEvents"]:
        if ev.get("name") == "request" and ev["ph"] in ("b", "e"):
            spans.setdefault((ev["cat"], ev["id"]), []).append(ev["ph"])
    closed = sum(v == ["b", "e"] for v in spans.values())
    print(f"[fleet] trace: {len(doc['traceEvents'])} events, "
          f"validate_chrome_trace: {len(errors)} violations; {closed} of "
          f"{len(spans)} request spans closed ({2 * 8} submitted)")
    if errors or closed != len(spans) or len(spans) != 16:
        raise SystemExit(f"[fleet] trace invalid or a request span open: "
                         f"{errors[:5]}")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "summarize", "--trace",
         trace_path, "--metrics", metrics_path, "--top", "10"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    if out.returncode:
        raise SystemExit(f"[fleet] summarize failed: {out.stderr}")
    for line in out.stdout.splitlines():
        if not line.startswith(("  gauge", "  counter", "  histogram")):
            print(f"[fleet] summarize| {line}")
    return counts


def fleet_closed_loop(qnets, imgs, sampler, card):
    """Part 2: each net alone, closed loop, buckets 1/2/4/8, obs off and on
    in turns (3 pairs). A run submits rounds of 256 requests and drains
    them for LOOP_S seconds while nvidia-smi samples the draw."""
    from repro_torch.obs import MetricsRegistry, Tracer

    summary = {}
    for m, q in qnets.items():
        runs = {False: [], True: []}
        for pair in range(3):
            for obs in (False, True):
                tracer, reg = ((Tracer(), MetricsRegistry()) if obs
                               else (None, None))
                eng = fleet_engines({m: q}, (1, 2, 4, 8), tracer=tracer,
                                    metrics=reg)[m]
                eng.warmup()
                n, t0 = 0, time.perf_counter()
                while n == 0 or time.perf_counter() - t0 < LOOP_S:
                    for i in range(256):
                        eng.submit(imgs[m][i % len(imgs[m])])
                    n += sum(r.status == "ok" for r in eng.run().values())
                t1 = time.perf_counter()
                st = eng.stats()
                watts, n_w = sampler.median(t0 + 0.3, t1)
                fps = n / (t1 - t0)
                runs[obs].append((fps, st.latency_p50_s, st.fps_per_watt,
                                  st.watts, watts, fps / watts))
                print(f"[fleet] {card}: {m} closed loop, obs "
                      f"{'on ' if obs else 'off'} (pair {pair}): {n} "
                      f"requests in {t1 - t0:.3f} s, FPS {fps:.1f} (engine "
                      f"{st.fps:.1f}), p50 {st.latency_p50_s * 1e3:.3f} ms; "
                      f"modeled: watts {st.watts:.3f}, FPS/W "
                      f"{st.fps_per_watt:.2f}; measured (nvidia-smi, "
                      f"median of {n_w} samples): {watts:.2f} W, FPS/W "
                      f"{fps / watts:.3f}")
        off, on = runs[False], runs[True]
        cost = [1 - b[0] / a[0] for a, b in zip(off, on)]
        med = {k: statistics.median(r[i] for r in off)
               for i, k in enumerate(("fps", "p50", "fpw_model", "w_model",
                                      "w_meas", "fpw_meas"))}
        summary[m] = med
        print(f"[fleet] {card}: {m} obs off, median of 3: FPS "
              f"{med['fps']:.1f}, p50 {med['p50'] * 1e3:.3f} ms, modeled "
              f"FPS/W {med['fpw_model']:.2f} at {med['w_model']:.3f} W, "
              f"measured FPS/W {med['fpw_meas']:.3f} at {med['w_meas']:.2f} "
              f"W (the paper's ZCU102: {PAPER_FPS_PER_W[m]} FPS/W); obs on "
              f"costs {', '.join(f'{c:.4f}' for c in cost)} of FPS by pair "
              f"(median {statistics.median(cost):.4f})")
    return summary


def fleet_power_cap(qnets, imgs, want, card):
    """Part 3: slo 0 and 1 requests of both nets under a fleet budget
    between the idle draw and idle plus the unconstrained run's modeled
    dispatched watts, with shed_slo=0."""
    import numpy as np

    from repro_torch.serve.vision import MultiModelEngine

    n = 64
    mm = MultiModelEngine(fleet_engines(qnets, (1, 2, 4, 8)))
    mm.warmup()
    for i in range(n):
        for m in qnets:
            mm.submit(m, imgs[m][i % 8])
    t0 = time.perf_counter()
    mm.run()
    wall = time.perf_counter() - t0
    stats = mm.stats()
    idle = max(e.energy.power.idle_w for e in mm.engines.values())
    dispatched = sum(s.watts - idle for s in stats.values())
    budget, window = idle + 0.5 * dispatched, wall / 4
    print(f"[fleet] unconstrained: {2 * n} requests in {wall * 1e3:.3f} ms, "
          f"modeled draw idle {idle:.3f} W + dispatched {dispatched:.6f} W; "
          f"capped run: budget {budget:.6f} W over a {window * 1e3:.3f} ms "
          f"window, shed_slo=0")
    mm = MultiModelEngine(fleet_engines(qnets, (1, 2, 4, 8), shed_slo=0),
                          power_budget_w=budget, power_window_s=window)
    mm.warmup()
    gov, record, peak = mm.governor, mm.governor.record, [0.0]

    def checked(joules, now):
        record(joules, now)
        peak[0] = max(peak[0], gov.watts(now))
        if gov.watts(now) > gov.budget_w * (1 + 1e-12):
            raise SystemExit(f"[fleet] rolling watts {gov.watts(now)} over "
                             f"the budget {gov.budget_w} at a dispatch")

    gov.record = checked
    slos = {}
    for i in range(n):
        for m in qnets:
            slos[mm.submit(m, imgs[m][i % 8], slo=i % 2)] = (i % 8, i % 2)
    results, rounds = {}, 0
    while True:
        res = mm.run()
        results.update(res)
        rounds += 1
        if rounds == 1:
            st = mm.stats()
            by = {s: sum(r.status == s for r in res.values())
                  for s in ("ok", "shed", "expired")}
            deferred = sum(mm.pending().values())
            print(f"[fleet] capped, first run(): ok {by['ok']} + shed "
                  f"{by['shed']} + deferred {deferred} + expired "
                  f"{by['expired']} = {sum(by.values()) + deferred} of "
                  f"{len(slos)} submitted")
            if sum(by.values()) + deferred != len(slos) or not deferred:
                raise SystemExit("[fleet] the first capped run does not "
                                 "account for every request, or deferred "
                                 "none")
        if not any(mm.pending().values()) or rounds == 200:
            break
        time.sleep(window)
    st = mm.stats()
    shed = [h for h, r in results.items() if r.status == "shed"]
    bad = [h for h, r in results.items()
           if r.status == "ok" and not np.array_equal(
               r.logits, want[h[0]][slos[h][0]])]
    print(f"[fleet] capped: {rounds} run() calls; ok "
          f"{sum(r.status == 'ok' for r in results.values())}, shed "
          f"{len(shed)} (slo {sorted({slos[h][1] for h in shed})}), "
          f"deferrals {sum(s.n_deferred for s in st.values())}, pending "
          f"{sum(mm.pending().values())}; peak rolling watts at a dispatch "
          f"{peak[0]:.6f} of {budget:.6f}; {len(bad)} served logits differ")
    if any(slos[h][1] == 1 for h in shed) or bad or len(results) != len(
            slos):
        raise SystemExit("[fleet] a slo=1 request was shed, a request was "
                         "never served, or served logits differ")


def phase_fleet(card):
    """Both paper networks at full size through one `MultiModelEngine` on
    the card: exactness, launches, the trace; closed loops with modeled and
    measured FPS/W; a power-capped run; the card's power constants."""
    import numpy as np
    import torch

    from repro_torch.core.qnet import load_qnet
    from repro_torch.energy import BACKEND_WATTS

    dev = torch.device("cuda", torch.cuda.current_device())
    qnets = {m: load_qnet(base + ".qnet") for m, (base, _) in FLEET.items()}
    imgs = {m: images(hw) for m, (_, hw) in FLEET.items()}
    want = {m: np.load(base + ".npz")["logits"]
            for m, (base, _) in FLEET.items()}
    with PowerSampler() as sampler:
        idle, n_idle, busy, n_busy = power_constants(sampler, dev)
        counts = fleet_exact(qnets, imgs, want, card)
        fleet_closed_loop(qnets, imgs, sampler, card)
    fleet_power_cap(qnets, imgs, want, card)
    print(f"[fleet] {card}: power.draw at rest {idle:.2f} W (median of "
          f"{n_idle} samples), busy under a dense int8 matmul loop "
          f"{busy:.2f} W (median of {n_busy}); BACKEND_WATTS['cuda'] "
          f"(busy, idle) = {BACKEND_WATTS['cuda']}")
    return counts


REPLICA_LOOP_S = 1.5  # a closed-loop run of [replicas]
PP_STAGES, PP_MICRO = 2, (2, 4)  # [replicas]' pipeline on the one card
PP_BATCH, PP_SEQ = 8, 128


def replicated_serve(tag, q, imgs, want, mesh, buckets, want_buckets):
    """A `VisionEngine(mesh=)` serves `imgs` with the launch counters set to
    0 just before the run and read just after: the logits must equal
    `want`, the buckets `want_buckets`, and the K2-K4 launches (K4 by
    variant, from `fused_irb.plan` at a replica's rows) the replicas times
    one replica's at its rows. Returns (engine, launch counts, K4 by
    variant)."""
    import numpy as np

    from repro_torch.kernels import ops as K
    from repro_torch.kernels.fused_irb import fused_irb_q
    from repro_torch.serve.vision import VisionEngine

    eng = VisionEngine(q, mesh=mesh, buckets=buckets)
    eng.warmup()
    rids = [eng.submit(img) for img in imgs]
    K.reset_launch_counts()
    res = eng.run()
    counts, variants = K.launch_counts(), dict(fused_irb_q.variants)
    st = eng.stats()
    rows = eng.buckets[-1] // eng.replicas
    per, per_var = tuned_launches(eng, rows)
    n = st.micro_batches * eng.replicas
    expect = {k: v * n for k, v in per.items()}
    expect_var = {k: v * n for k, v in per_var.items()}
    logits = np.stack([res[r].logits for r in rids])
    n_diff = int(np.sum(logits != want))
    print(f"{tag}: {len(rids)} images over {eng.replicas} replica(s) "
          f"{mesh}, buckets {eng.buckets} (asked {tuple(buckets)}), "
          f"{st.micro_batches} micro-batches of {eng.buckets[-1]} rows: "
          f"{n_diff} of {logits.size} logits differ from the JAX package's; "
          f"launch counts {counts}, fused_irb_q by variant {variants}; "
          f"expected {st.micro_batches} x {eng.replicas} replicas x "
          f"{ {k: v for k, v in per.items() if v} } at {rows} rows a "
          f"replica, by variant {per_var}; EngineStats.replicas "
          f"{st.replicas}")
    if (n_diff or counts != expect or variants != expect_var
            or eng.buckets != tuple(want_buckets)
            or st.replicas != eng.replicas):
        raise SystemExit(f"{tag}: logits, launches, buckets or replicas "
                         f"are not as expected")
    return eng, counts, variants


def replicas_vision(card, dev):
    """Vision serving over a mesh: one replica (the [serve] path), two
    replicas of the one card (both nets), each replica's constants its own
    storage, and closed loops without a mesh, on a one-replica mesh and on
    two replicas, in turns."""
    import numpy as np

    from repro_torch.core import cu
    from repro_torch.core.qnet import load_qnet
    from repro_torch.dist.sharding import data_mesh
    from repro_torch.serve.vision import VisionEngine

    qnets = {m: load_qnet(base + ".qnet") for m, (base, _) in FLEET.items()}
    imgs = {m: images(hw) for m, (_, hw) in FLEET.items()}
    want = {m: np.load(base + ".npz")["logits"]
            for m, (base, _) in FLEET.items()}
    one = data_mesh(1)
    two = data_mesh(2, devices=[dev, dev])
    eng, counts, variants = replicated_serve(
        "[replicas] mobilenet_v2 on a 1-replica mesh",
        qnets["mobilenet_v2"], imgs["mobilenet_v2"], want["mobilenet_v2"],
        one, (1, 2, 4, 8), (1, 2, 4, 8))
    mb = eng.stats().micro_batches
    if (counts != {k: v * mb for k, v in EXPECTED_LAUNCHES.items()}
            or variants != {k: v * mb
                            for k, v in EXPECTED_IRB_VARIANTS.items()}):
        raise SystemExit(f"[replicas] one replica's launches {counts}, "
                         f"{variants} are not [serve]'s")
    for m in FLEET:
        eng = replicated_serve(
            f"[replicas] {m} on 2 replicas of the card", qnets[m],
            np.concatenate([imgs[m]] * 2), np.concatenate([want[m]] * 2),
            two, (1, 3, 4), (2, 4))[0]
        pq = eng.stages[0].pq
        shared = [n for n in pq.ops if pq.replicas[0].ops[n].w_acc.data_ptr()
                  == pq.replicas[1].ops[n].w_acc.data_ptr()]
        print(f"[replicas] {m}: {len(pq.ops)} ops' constants, each "
              f"replica its own storage (data_ptr): {not shared}")
        if not isinstance(pq, cu.ReplicatedQNet) or shared:
            raise SystemExit(f"[replicas] {m}: replicas share constants "
                             f"{shared[:3]}")
    q, x = qnets["mobilenet_v2"], imgs["mobilenet_v2"]
    engines = {"no mesh": VisionEngine(q, device=dev, buckets=(1, 2, 4, 8)),
               "1-replica mesh": VisionEngine(q, mesh=one,
                                              buckets=(1, 2, 4, 8)),
               "2 replicas, one card": VisionEngine(q, mesh=two,
                                                    buckets=(1, 2, 4, 8))}
    runs = {k: [] for k in engines}
    for eng in engines.values():
        eng.warmup()
    for _ in range(2):
        for k, eng in engines.items():
            runs[k].append(closed_loop(eng, x, REPLICA_LOOP_S))
    for k, rs in runs.items():
        print(f"[replicas] {card}: mobilenet_v2 closed loop, {k} (buckets "
              f"{engines[k].buckets}): FPS "
              f"{' '.join(f'{r[0]:.1f}' for r in rs)}, p50 ms "
              f"{' '.join(f'{r[1] * 1e3:.3f}' for r in rs)} ({len(rs)} "
              f"runs of {REPLICA_LOOP_S} s in turns; reported, not gated: "
              f"two replicas of one card measure the host cost of a "
              f"replica, not scaling)")


def replicas_cli():
    """`launch/serve.py --vision --replicas 1` serves both nets;
    `--replicas 2` is refused where one card is visible."""
    from repro_torch.launch import serve as serve_cli

    argv = ["--vision", "--models", "mobilenet_v2,efficientnet_compact",
            "--requests", "8"]
    out = serve_cli.main(argv + ["--replicas", "1"])
    ok = all(r.status == "ok" for r in out["results"].values())
    print(f"[replicas] serve CLI --replicas 1: {len(out['results'])} "
          f"requests, all ok {ok}, replicas "
          f"{ {m: st.replicas for m, st in out['stats'].items()} }")
    if not ok or len(out["results"]) != 8:
        raise SystemExit("[replicas] the CLI with --replicas 1 failed")
    import torch
    try:
        out = serve_cli.main(argv + ["--replicas", "2"])
    except ValueError as e:
        print(f"[replicas] serve CLI --replicas 2 on "
              f"{torch.cuda.device_count()} visible card(s): refused: {e}")
        if torch.cuda.device_count() != 1 or \
                str(e) != "replicas=2 with 1 visible devices":
            raise SystemExit("[replicas] the wrong refusal") from e
        return
    if torch.cuda.device_count() < 2 or not all(
            st.replicas == 2 for st in out["stats"].values()):
        raise SystemExit("[replicas] --replicas 2 served on one card")


def replicas_pipeline(card, dev, cfg, params, tokens):
    """`dist/pp.make_pp_loss` on full-depth bf16 Llama-3.2-1B, 2 stages of 8
    layers on [card, card], n_micro 2 and 4: the loss and every gradient
    leaf against the plain `loss_fn` (the bf16 bounds of
    `train/parity.py`), the gradient reaching both stages, and the times of
    a loss-and-gradient call beside the matmul bound. Returns the plain
    gradients."""
    from repro_torch.dist import pp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import exact_f32
    from repro_torch.models.lm import model as M
    from repro_torch.train import tree as T
    from repro_torch.train.parity import (
        LM_BF16_GRAD_L2,
        LM_BF16_LOSS_RTOL,
        _as_tensor,
        _leaf_names,
        _rel_l2,
    )
    from repro_torch.train.train_loop import value_and_grad

    def plain():
        with exact_f32():
            return value_and_grad(
                lambda q, b: M.loss_fn(q, cfg, {"tokens": b}), params, tokens)

    ploss, _, pgrads = plain()
    split = dict(pgrads, layers=pp.split_stage_params(pgrads["layers"],
                                                      PP_STAGES))
    sp = dict(params, layers=pp.split_stage_params(params["layers"],
                                                   PP_STAGES))
    mesh = make_mesh((PP_STAGES,), ("pod",), devices=[dev] * PP_STAGES)
    names = _leaf_names(split)
    b, s = tokens.shape
    tflop, flop_ms = lm_train_bounds(cfg, b, s)[:2]
    plain_ms = time_ms(plain, 3)
    bad = []
    for n_micro in PP_MICRO:
        loss_fn = pp.make_pp_loss(cfg, PP_STAGES, n_micro)

        def piped():
            with exact_f32():
                return value_and_grad(lambda q, t: loss_fn(q, t, mesh), sp,
                                      tokens)

        loss, _, grads = piped()
        loss_err = abs(float(loss) - float(ploss)) / abs(float(ploss))
        worst, where = 0.0, ""
        for name, a, g in zip(names, T.leaves(split), T.leaves(grads)):
            e = _rel_l2(_as_tensor(a, dev), _as_tensor(g, dev))
            if e > worst:
                worst, where = e, name
        wq = grads["layers"]["mix"]["wq"]["w"].float()
        energy = wq.abs().sum(dim=tuple(range(1, wq.dim()))).tolist()
        del grads
        ms = time_ms(piped, 3)
        print(f"[replicas] {card}: pipeline, Llama-3.2-1B full depth bf16, "
              f"{PP_STAGES} stages x {cfg.n_layers // PP_STAGES} layers on "
              f"{mesh}, tokens {b} x {s}, n_micro {n_micro}: loss "
              f"{float(loss):.6f} against the plain loss_fn's "
              f"{float(ploss):.6f} (rel err {loss_err:.3e}, bound "
              f"{LM_BF16_LOSS_RTOL}); worst gradient leaf {where} rel L2 "
              f"{worst:.3e} (bound {LM_BF16_GRAD_L2}); wq gradient energy "
              f"by stage {[f'{v:.4e}' for v in energy]}; loss and gradients "
              f"{ms:.4f} ms against the plain {plain_ms:.4f} ms (median of "
              f"3, CUDA events, host included; bound {tflop:.3f} TFLOP of "
              f"matmul = {flop_ms:.4f} ms at 989 TFLOP/s)")
        if (loss_err > LM_BF16_LOSS_RTOL or worst > LM_BF16_GRAD_L2
                or not all(v > 0 for v in energy)):
            bad.append(f"pipeline n_micro {n_micro}: loss err {loss_err}, "
                       f"{where} {worst}, energy {energy}")
    return pgrads, bad


def replicas_psum(card, dev, grads):
    """`compressed_psum` over two replicas of the card (each replica's
    full-width gradients from its own batch, and the residuals that a
    first all-reduce from zeros leaves): every summed and residual leaf
    bit for bit its plain version's on the CPU (leaf by leaf there), its
    ms beside the bytes bound."""
    import torch

    from repro_torch.dist.sharding import data_mesh
    from repro_torch.train import grad_compress as GC
    from repro_torch.train import tree as T

    mesh = data_mesh(2, devices=[dev, dev])
    zeros = [GC.init_error(g) for g in grads]
    _, errs = GC.compressed_psum(grads, zeros, mesh)
    del zeros
    ms = time_ms(lambda: GC.compressed_psum(grads, errs, mesh), 3)
    torch.cuda.reset_peak_memory_stats()
    sums, res = GC.compressed_psum(grads, errs, mesh)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    cpu_mesh = data_mesh(2, devices=["cpu", "cpu"])
    flat = [T.leaves(t) for t in (*grads, *errs)]
    outs = [T.leaves(t) for t in (*sums, *res)]
    n = sum(x.numel() for x in flat[0])
    n_diff = 0
    t0 = time.perf_counter()
    for i in range(len(flat[0])):
        g = [{"x": flat[r][i].cpu()} for r in range(2)]
        e = [{"x": flat[2 + r][i].cpu()} for r in range(2)]
        ws, wr = GC.compressed_psum(g, e, cpu_mesh)
        for got, want in zip(outs, [w["x"] for w in (*ws, *wr)]):
            got = got[i].cpu()
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                n_diff += int((got != want).sum())
    cpu_s = time.perf_counter() - t0
    # inputs read once (bf16 gradients, f32 residuals), outputs written
    # once (f32 sums, f32 residuals), for each replica
    gb = 2 * n * (2 + 4 + 4 + 4) / 1e9
    print(f"[replicas] {card}: compressed_psum, 2 replicas on {mesh}, "
          f"Llama-3.2-1B full-width bf16 gradients ({n} values a replica, "
          f"two token batches): {n_diff} of {4 * n} summed and residual "
          f"values differ from its plain version on the CPU ({cpu_s:.1f} s "
          f"there); {ms:.4f} ms (median of 3, CUDA events, host included) "
          f"against a bound of {gb:.3f} GB = "
          f"{gb * 1e9 / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s; peak "
          f"{peak:.3f} GiB")
    return [] if n_diff == 0 else [f"compressed_psum: {n_diff} differ"]


def phase_replicas(card):
    """Data-parallel replicas on the one card: vision serving over a
    one-replica mesh and over two replicas of the card, the serving CLI's
    `--replicas`, the pipeline-parallel loss and the compressed
    all-reduce at full width."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, lm_batch
    from repro_torch.models.layers import exact_f32
    from repro_torch.models.lm import model as M
    from repro_torch.train.train_loop import value_and_grad

    t_phase = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    replicas_vision(card, dev)
    replicas_cli()
    torch.cuda.empty_cache()
    cfg = get_config("llama3.2-1b")
    params, _ = M.init_params(cfg, 0, device=dev)
    data = DataConfig(seed=0, vocab=cfg.vocab, seq_len=PP_SEQ,
                      global_batch=PP_BATCH)
    tokens = [torch.from_numpy(lm_batch(data, step)["tokens"]).to(dev).long()
              for step in (0, 1)]
    grads_a, bad = replicas_pipeline(card, dev, cfg, params, tokens[0])
    with exact_f32():
        grads_b = value_and_grad(
            lambda q, b: M.loss_fn(q, cfg, {"tokens": b}), params,
            tokens[1])[2]
    del params
    torch.cuda.empty_cache()
    bad += replicas_psum(card, dev, [grads_a, grads_b])
    del grads_a, grads_b
    torch.cuda.empty_cache()
    print(f"[replicas] phase {time.perf_counter() - t_phase:.1f} s; "
          f"scaling across several cards: not verified (one card)")
    if bad:
        raise SystemExit(f"[replicas] failed: {'; '.join(bad)}")


DRYRUN_MESHES = {"tp": ((1, 2), False), "dp": ((2, 1), False),
                 "fsdp": ((2, 2), True)}  # (data, model) over cuda:0, fsdp
DRYRUN_REPS = 3  # timed steps a mesh (median), after 1 warm-up
DRYRUN_DECODE_REPS = 10  # timed decode steps each side (median)
DRYRUN_BATCH = (8, 128)  # launch/train.py's defaults, as in [lm_train]
DRYRUN_DECODE = (4, 16)  # decode slots, prompt length
DRYRUN_CELLS = (("llama3.2-1b", "decode_32k", True),
                ("llama3.2-1b", "train_4k", False),
                ("mamba2-1.3b", "long_500k", True),  # a row replicated
                ("recurrentgemma-2b", "train_4k", False))  # heads mid-head
# (e): the other partitioned families at their published widths, depth cut
# (recurrentgemma: one (rec, rec, attn) super-block and the (rec, rec)
# tail, as reduced_config keeps the pattern)
DRYRUN_FAMILIES = (("phi-3-vision-4.2b", dict(n_layers=2)),
                   ("seamless-m4t-large-v2",
                    dict(n_layers=4, n_enc_layers=2, n_dec_layers=2)),
                   ("mamba2-1.3b", dict(n_layers=2)),
                   ("recurrentgemma-2b", dict(n_layers=5)),
                   ("qwen2-moe-a2.7b", dict(n_layers=2)))
# A mesh's bf16 gradients from the float32 gradients of the same weights,
# at most this many times the mesh-less bf16 gradients' own distance (the
# bf16 noise floor, measured in the same run): two bf16 steps part by the
# floor itself at full depth, above LM_BF16_GRAD_L2, so TP and FSDP are
# held to the float32 truth rather than to the mesh-less bf16 step
DRYRUN_FLOOR_X = 1.1


def _gathered(x):
    from repro_torch.dist.sharding import Sharded
    return x.gather(x.parts[0].device) if isinstance(x, Sharded) else x


def _placed_model(cfg, params, logical, mesh, fsdp, tokens):
    """`params` and a batch of `tokens` placed on `mesh` as the dry-run
    places them (tree_shardings; rows over the data axes)."""
    from repro_torch.dist import sharding as S
    from repro_torch.train import tree as T

    with S.use_mesh(mesh, fsdp=fsdp):
        sh = S.tree_shardings(logical, mesh, fsdp=fsdp, shapes=params)
        placed = T.tree_map(S.place, params, sh)
        rows = S.NamedSharding(mesh, S.logical_to_spec(("batch", None),
                                                       mesh))
        return placed, S.place(tokens, rows)


def _leaf_errors(names, want, got, dev):
    """(worst relative L2 distance, its leaf) of `got`'s gradient leaves
    (placed ones gathered) from `want`'s, each leaf moved to `dev` in
    turn."""
    import torch

    from repro_torch.train import parity as PP
    from repro_torch.train import tree as T

    worst, where = 0.0, ""
    with torch.no_grad():
        for name, a, g in zip(names, T.leaves(want), T.leaves(got)):
            e = PP._rel_l2(PP._as_tensor(a, dev),
                           PP._as_tensor(_gathered(g), dev))
            if e > worst:
                worst, where = e, name
    return worst, where


def dryrun_train(card, dev):
    """(a) and (d): the train step [lm_train] runs through
    `launch/train.py` (full-depth bf16 Llama-3.2-1B, batch 8 x 128,
    make_train_step) without a mesh, then on
    TP (1, 2), DP (2, 1) and FSDP (2, 2) meshes that name the card
    repeatedly: the loss against the mesh-less one (LM_BF16_LOSS_RTOL),
    ms, device intervals and collective bytes; the bf16 gradients' worst
    leaf from the float32 gradients of the same weights within
    DRYRUN_FLOOR_X times the mesh-less bf16 gradients' own (the bf16
    noise floor), and DP's from the mesh-less step's within
    LM_BF16_GRAD_L2. The partitioned loss and gradients also in float32
    at full width and depth against the mesh-less float32 ones
    (LM_LOSS_RTOL, LM_GRAD_L2). The mesh-less step also traced on the
    (1, 1) mesh of the card (`launch/roofline.trace_step`): the bound of
    its eager program beside its ms and its function bound
    (`lm_train_bounds`), the reckoned peak beside the allocator's.
    Returns the failures."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, lm_batch
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import exact_f32
    from repro_torch.models.lm import model as M
    from repro_torch.train import optimizer as O
    from repro_torch.train import parity as PP
    from repro_torch.train.train_loop import (
        _psum_data,
        make_train_step,
        value_and_grad,
    )

    cfg = get_config("llama3.2-1b")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    b, s = DRYRUN_BATCH
    params, logical = M.init_params(cfg, 0, device=dev)
    tokens = torch.from_numpy(lm_batch(DataConfig(
        seed=0, vocab=cfg.vocab, seq_len=s, global_batch=b), 0)["tokens"]
    ).long()
    opt_cfg = O.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    step = make_train_step(cfg, opt_cfg)
    names = PP._leaf_names(params)

    def grads_of(c, p, bb):
        with exact_f32():
            out = value_and_grad(lambda q, x: M.loss_fn(q, c, x), p, bb)
        return out[0], _psum_data(out[2])

    def to32(p):
        return M.tree_map(lambda t: t.to(torch.float32), p)

    # the float32 gradients of the same (bf16-valued) weights, kept on the
    # host: the yardstick of the bf16 noise floor
    loss32, g32 = grads_of(cfg32, to32(params), {"tokens": tokens.to(dev)})
    g32 = M.tree_map(lambda t: t.cpu(), g32)
    torch.cuda.empty_cache()

    # (d) the (1, 1) mesh of the card: the device path, traced
    one = make_mesh((1, 1), ("data", "model"), devices=[dev])
    state = O.init_state(params)
    batch = {"tokens": tokens.to(dev)}
    args_bytes = RL.tensor_bytes((params, state, batch))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trace = RL.trace_step(lambda: step(params, state, batch), one)
    torch.cuda.synchronize()
    measured_peak = torch.cuda.max_memory_allocated()
    del trace.output
    roof = RL.from_trace(trace, 1)
    ms = {}
    ms["none"] = time_ms(lambda: step(params, state, batch), DRYRUN_REPS,
                         warmup=1)
    prof = {"none": profile_steps(lambda: step(params, state, batch))}
    coll = {"none": {}}
    del state
    torch.cuda.empty_cache()
    loss0, g0 = grads_of(cfg, params, batch)
    floor = _leaf_errors(names, g32, g0, dev)
    r = roof.summary()
    flop_ms, opt_ms = (lm_train_bounds(cfg, b, s)[i] for i in (1, 3))
    print(f"[dryrun] (d) {card}: [lm_train]'s step (Llama-3.2-1B full depth "
          f"bf16, batch {b} x {s}) on the (1, 1) mesh of the card, traced: "
          f"{roof.flops / 1e12:.4f} TFLOP (matmuls), "
          f"{roof.hbm_bytes / 1e9:.3f} GB the eager program reads and "
          f"writes op by op (not the bytes the step needs), "
          f"{roof.coll_bytes:.0f} collective bytes; terms compute "
          f"{r['t_compute_s'] * 1e3:.4f} ms, memory (eager program) "
          f"{r['t_memory_s'] * 1e3:.4f} ms, collective "
          f"{r['t_collective_s'] * 1e3:.4f} ms; the eager program's t_bound "
          f"{roof.t_bound * 1e3:.4f} ms ({roof.bottleneck}) and the step's "
          f"function bound {flop_ms + opt_ms:.4f} ms (lm_train_bounds: "
          f"matmuls at the bf16 peak plus AdamW's bytes once) beside the "
          f"measured step {ms['none']:.4f} ms; reckoned peak "
          f"{(args_bytes + trace.peak_live_bytes) / 2**30:.3f} GiB "
          f"(arguments {args_bytes / 2**30:.3f} + the step's live "
          f"{trace.peak_live_bytes / 2**30:.3f}) beside "
          f"max_memory_allocated {measured_peak / 2**30:.3f} GiB; "
          f"trace {trace.seconds:.1f} s")
    print(f"[dryrun] (a) the bf16 noise floor: the mesh-less bf16 "
          f"gradients' worst leaf is {floor[0]:.3g} ({floor[1]}) from the "
          f"float32 gradients of the same weights")

    bad = []
    for tag, (shape, fsdp) in DRYRUN_MESHES.items():
        t0 = time.perf_counter()
        mesh = make_mesh(shape, ("data", "model"),
                         devices=[dev] * (shape[0] * shape[1]))
        pp, tok = _placed_model(cfg, params, logical, mesh, fsdp, tokens)
        pbatch = {"tokens": tok}
        state = O.init_state(pp)
        mesh.collectives.reset()
        out = step(pp, state, pbatch)
        torch.cuda.synchronize()
        coll[tag] = mesh.collectives.snapshot()
        del out
        ms[tag] = time_ms(lambda: step(pp, state, pbatch), DRYRUN_REPS,
                          warmup=1)
        prof[tag] = profile_steps(lambda: step(pp, state, pbatch))
        del state
        torch.cuda.empty_cache()
        loss1, g1 = grads_of(cfg, pp, pbatch)
        loss_err = abs(float(loss1) - float(loss0)) / abs(float(loss0))
        apart = _leaf_errors(names, g0, g1, dev)
        truth = _leaf_errors(names, g32, g1, dev)
        del pp, tok, pbatch, g1
        torch.cuda.empty_cache()
        # float32: the partitioning itself, at full width and depth
        pp, tok = _placed_model(cfg32, to32(params), logical, mesh, fsdp,
                                tokens)
        l32, g = grads_of(cfg32, pp, {"tokens": tok})
        err32 = abs(float(l32) - float(loss32)) / abs(float(loss32))
        worst32 = _leaf_errors(names, g32, g, dev)
        del pp, tok, g
        torch.cuda.empty_cache()
        limit = DRYRUN_FLOOR_X * floor[0]
        apart_bound = PP.LM_BF16_GRAD_L2 if tag == "dp" else None
        ok = (loss_err <= PP.LM_BF16_LOSS_RTOL and err32 <= PP.LM_LOSS_RTOL
              and worst32[0] <= PP.LM_GRAD_L2 and truth[0] <= limit
              and (apart_bound is None or apart[0] <= apart_bound))
        print(f"[dryrun] (a) {tag} {dict(mesh.shape)} fsdp={fsdp} on "
              f"[{dev}] x {mesh.size}: bf16 loss {float(loss1):.6f} "
              f"against {float(loss0):.6f} without a mesh (rel "
              f"{loss_err:.3g}, bound {PP.LM_BF16_LOSS_RTOL}); bf16 "
              f"gradients' worst leaf {truth[0]:.3g} ({truth[1]}) from the "
              f"float32 gradients (bound {DRYRUN_FLOOR_X} x the floor "
              f"{floor[0]:.3g} = {limit:.3g}) and {apart[0]:.3g} "
              f"({apart[1]}) from the mesh-less bf16 step's (bound "
              f"{apart_bound or 'none: two bf16 steps part by the floor'}); "
              f"float32 loss rel {err32:.3g} (bound {PP.LM_LOSS_RTOL}), "
              f"worst float32 gradient leaf {worst32[0]:.3g} ({worst32[1]}; "
              f"bound {PP.LM_GRAD_L2}); {'ok' if ok else 'FAILED'} "
              f"({time.perf_counter() - t0:.1f} s)")
        if not ok:
            bad.append(f"{tag}: bf16 loss {loss_err:.3g}, bf16 grads "
                       f"{truth[0]:.3g} from float32 (limit {limit:.3g}), "
                       f"{apart[0]:.3g} from the mesh-less step, float32 "
                       f"loss {err32:.3g}, float32 grads {worst32[0]:.3g} "
                       f"({worst32[1]})")
    for tag in ("none", *DRYRUN_MESHES):
        p = prof[tag]
        busy = ("not measured" if p is None else
                f"device busy {p['busy_ms']:.3f} ms, "
                f"{p['intervals']:.0f} device intervals")
        c = coll[tag]
        moved = ", ".join(f"{k} {v}" for k, v in c.items()
                          if k != "n_ops" and v) or "none"
        print(f"[dryrun] (a) {card}: step on {tag}: {ms[tag]:.4f} ms "
              f"(median of {DRYRUN_REPS}, {ms[tag] / ms['none']:.3f} x "
              f"without a mesh); {busy}; collective operand bytes a "
              f"device: {moved} ({c.get('n_ops', 0)} collectives): host "
              f"cost of one card standing for {tag}'s devices, not "
              f"scaling")
    del params, g0, g32
    torch.cuda.empty_cache()
    return bad


def dryrun_decode(card, dev):
    """(b) a decode step at DRYRUN_DECODE[0] slots under TP (1, 2) on the
    card against the mesh-less step: logits within LM_BF16_GRAD_L2 in
    relative L2 over the real vocab, greedy tokens compared; ms of
    both."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import model as M
    from repro_torch.train import parity as PP

    cfg = get_config("llama3.2-1b")
    slots, plen = DRYRUN_DECODE
    params, logical = M.init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(30)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (slots, plen)))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (slots, 1)))
    max_len = plen + 8
    mesh = make_mesh((1, 2), ("data", "model"), devices=[dev, dev])
    pp, tok = _placed_model(cfg, params, logical, mesh, False, prompt)
    rows = tok.sharding
    with torch.no_grad():
        _, cache = M.prefill(params, cfg, prompt.to(dev), max_len)
        _, pcache = M.prefill(pp, cfg, tok, max_len)
        want, _ = M.decode_step(params, cfg, nxt.to(dev), cache, plen)
        ptok = S.place(nxt, rows)
        got, _ = M.decode_step(pp, cfg, ptok, pcache, plen)
        got = got.gather(dev)
        ms_plain = time_ms(lambda: M.decode_step(params, cfg, nxt.to(dev),
                                                 cache, plen),
                           DRYRUN_DECODE_REPS, warmup=1)
        ms_tp = time_ms(lambda: M.decode_step(pp, cfg, ptok, pcache, plen),
                        DRYRUN_DECODE_REPS, warmup=1)
    v = cfg.vocab
    err = PP._rel_l2(PP._as_tensor(want[..., :v], dev),
                     PP._as_tensor(got[..., :v], dev))
    same = int((want[..., :v].argmax(-1) == got[..., :v].argmax(-1)).sum())
    ok = err <= PP.LM_BF16_GRAD_L2 and bool(torch.isfinite(got[..., :v])
                                            .all())
    print(f"[dryrun] (b) {card}: decode step at {slots} slots after a "
          f"{plen}-token prefill, Llama-3.2-1B full depth bf16, TP (1, 2) "
          f"on [{dev}] x 2: logits {err:.3g} from the mesh-less step's in "
          f"relative L2 (bound {PP.LM_BF16_GRAD_L2}), greedy tokens equal "
          f"{same} of {slots}; {'ok' if ok else 'FAILED'}; decode ms "
          f"{ms_tp:.4f} on TP against {ms_plain:.4f} without a mesh "
          f"(median of {DRYRUN_DECODE_REPS})")
    del params, pp, cache, pcache
    torch.cuda.empty_cache()
    return [] if ok else [f"decode logits {err:.3g}"]


def _family_batch(cfg, rows: int, seq: int, seed: int):
    """Seeded tokens (the data stream's first batch) and the modality
    stub's inputs, bf16-valued so the bf16 and float32 models read the
    same numbers."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import DataConfig, lm_batch

    batch = {"tokens": torch.from_numpy(lm_batch(DataConfig(
        seed=seed, vocab=cfg.vocab, seq_len=seq, global_batch=rows),
        0)["tokens"]).long()}
    name = {"vlm": "embeds", "audio": "enc_inputs"}.get(cfg.family)
    if name:
        x = np.random.default_rng(seed).standard_normal(
            (rows, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        batch[name] = torch.from_numpy(x).to(torch.bfloat16).float()
    return batch


def _placed_family(params, logical, mesh, fsdp, batch):
    """`params` and `batch` placed on `mesh` as the dry-run places them
    (tree_shardings; batch_shardings)."""
    from repro_torch.dist import sharding as S
    from repro_torch.launch import dryrun as D
    from repro_torch.train import tree as T

    with S.use_mesh(mesh, fsdp=fsdp):
        sh = S.tree_shardings(logical, mesh, fsdp=fsdp, shapes=params)
        rows = D.batch_shardings(batch, mesh)
        return (T.tree_map(S.place, params, sh),
                {k: S.place(v, rows[k]) for k, v in batch.items()})


def dryrun_family(card, dev, arch, over):
    """(e) one arch of the vlm, audio, ssm and hybrid families at its
    published widths, depth cut (`over`), bf16, batch DRYRUN_BATCH: the
    train step without a mesh, then on TP (1, 2), DP (2, 1) and FSDP
    (2, 2) meshes that name the card, gated as (a) gates Llama (the bf16
    floor measured here for this arch at this depth); a TP decode (a
    prefill and 4 steps) against the mesh-less one. A moe arch's float32
    routing (`moe.record_routes`) must be the mesh-less step's on every
    mesh, and the mesh-less step must drop (token, choice) pairs.
    Returns the failures."""
    import contextlib
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import exact_f32
    from repro_torch.models.lm import model as M
    from repro_torch.models.lm import moe as MOE
    from repro_torch.train import optimizer as O
    from repro_torch.train import parity as PP
    from repro_torch.train.train_loop import (
        _psum_data,
        make_train_step,
        row_axes,
        value_and_grad,
    )

    t_arch = time.perf_counter()
    moe = get_config(arch).family == "moe"

    def routes():
        return MOE.record_routes() if moe else contextlib.nullcontext([])

    def same_routes(a, b):
        return len(a) == len(b) and all(
            torch.equal(x["idx"], y["idx"]) and torch.equal(x["keep"],
                                                           y["keep"])
            for x, y in zip(a, b))

    cfg = dataclasses.replace(get_config(arch), **over)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    b, s = DRYRUN_BATCH
    params, logical = M.init_params(cfg, 0, device=dev)
    batch = _family_batch(cfg, b, s, 0)
    names = PP._leaf_names(params)
    step = make_train_step(cfg, O.AdamWConfig(lr=1e-3, warmup_steps=1,
                                              total_steps=100))

    def on(bb):
        return {k: v.to(dev) for k, v in bb.items()}

    def grads_of(c, p, bb):
        with exact_f32():
            out = value_and_grad(lambda q, x: M.loss_fn(q, c, x), p, bb)
        if isinstance(bb["tokens"], torch.Tensor):
            return out[0], out[2]
        return out[0], _psum_data(out[2], row_axes(bb))

    def to32(p):
        return M.tree_map(lambda t: t.to(torch.float32), p)

    with routes() as routes32:
        loss32, g32 = grads_of(cfg32, to32(params), on(batch))
    g32 = M.tree_map(lambda t: t.cpu(), g32)
    bad = []
    if moe:
        pairs = sum(r["keep"].numel() for r in routes32)
        dropped = sum(int((~r["keep"]).sum()) for r in routes32)
        print(f"[dryrun] (e) {arch}: the mesh-less float32 step drops "
              f"{dropped} of {pairs} (token, choice) pairs over its "
              f"{len(routes32)} MoE layers at capacity_factor "
              f"{cfg.capacity_factor} ({MOE.capacity(cfg, b * s)} slots "
              f"an expert for {b * s} tokens); must be > 0")
        if dropped == 0:
            bad.append(f"{arch}: no (token, choice) pair dropped")
    torch.cuda.empty_cache()
    state = O.init_state(params)
    ms, prof, coll = {}, {}, {"none": {}}
    ms["none"] = time_ms(lambda: step(params, state, on(batch)),
                         DRYRUN_REPS, warmup=1)
    prof["none"] = profile_steps(lambda: step(params, state, on(batch)))
    del state
    with routes() as routes0:
        loss0, g0 = grads_of(cfg, params, on(batch))
    floor = _leaf_errors(names, g32, g0, dev)
    print(f"[dryrun] (e) {arch} ({cfg.family}, published widths, "
          f"{over}, bf16, batch {b} x {s}): the bf16 noise floor, the "
          f"mesh-less bf16 gradients' worst leaf from the float32 "
          f"gradients of the same weights, {floor[0]:.3g} ({floor[1]}); "
          f"the bf16 loss {float(loss0):.6f} from the float32 loss "
          f"{float(loss32):.6f}: rel "
          f"{abs(float(loss0) - float(loss32)) / abs(float(loss32)):.3g}")
    # bf16 routing is discontinuous: a last-bit change of the router's
    # input moves a top-k choice, so two bf16 runs of a moe arch part by
    # up to twice the bf16 loss's own distance from the float32 loss
    loss_floor = abs(float(loss0) - float(loss32)) / abs(float(loss32))
    loss_bound = (max(PP.LM_BF16_LOSS_RTOL, DRYRUN_FLOOR_X * 2 * loss_floor)
                  if moe else PP.LM_BF16_LOSS_RTOL)
    for tag, (shape, fsdp) in DRYRUN_MESHES.items():
        t0 = time.perf_counter()
        mesh = make_mesh(shape, ("data", "model"),
                         devices=[dev] * (shape[0] * shape[1]))
        pp, pb = _placed_family(params, logical, mesh, fsdp, batch)
        mesh.collectives.reset()
        # a moe arch's DP step is not run: two replicas of qwen2-moe's
        # 1.76e9 weights and float32 AdamW moments, old and new, fill the
        # card's 80 GB (its gates below need no optimizer)
        if moe and tag == "dp":
            ms[tag] = prof[tag] = None
        else:
            state = O.init_state(pp)
            out = step(pp, state, pb)
            torch.cuda.synchronize()
            coll[tag] = mesh.collectives.snapshot()
            del out
            ms[tag] = time_ms(lambda: step(pp, state, pb), DRYRUN_REPS,
                              warmup=1)
            prof[tag] = profile_steps(lambda: step(pp, state, pb))
            del state
        with routes() as routes1:
            loss1, g1 = grads_of(cfg, pp, pb)
        coll.setdefault(tag, mesh.collectives.snapshot())
        if moe:
            moved = sum(int((x["idx"] != y["idx"]).sum())
                        for x, y in zip(routes0, routes1))
            kept = sum(int((x["keep"] != y["keep"]).sum())
                       for x, y in zip(routes0, routes1))
            rel = abs(float(loss1) - float(loss32)) / abs(float(loss32))
            print(f"[dryrun] (e) {arch} {tag}: bf16 routing against the "
                  f"mesh-less bf16 step's: {moved} of {pairs} top-k "
                  f"choices and {kept} kept flags differ; the bf16 loss "
                  f"from the float32 loss: rel {rel:.3g}")
        loss_err = abs(float(loss1) - float(loss0)) / abs(float(loss0))
        apart = _leaf_errors(names, g0, g1, dev)
        truth = _leaf_errors(names, g32, g1, dev)
        del pp, pb, g1
        torch.cuda.empty_cache()
        pp, pb = _placed_family(to32(params), logical, mesh, fsdp, batch)
        with routes() as routes_mesh:
            l32, g = grads_of(cfg32, pp, pb)
        routed = same_routes(routes32, routes_mesh)
        err32 = abs(float(l32) - float(loss32)) / abs(float(loss32))
        worst32 = _leaf_errors(names, g32, g, dev)
        del pp, pb, g
        torch.cuda.empty_cache()
        limit = DRYRUN_FLOOR_X * floor[0]
        # a moe arch's DP step parts from the mesh-less one by the floor
        # (its bf16 routing moves too), so DP is held as TP and FSDP are
        apart_bound = (PP.LM_BF16_GRAD_L2 if tag == "dp" and not moe
                       else None)
        ok = (loss_err <= loss_bound and err32 <= PP.LM_LOSS_RTOL
              and worst32[0] <= PP.LM_GRAD_L2 and truth[0] <= limit
              and (apart_bound is None or apart[0] <= apart_bound)
              and routed)
        if moe:
            print(f"[dryrun] (e) {arch} {tag}: float32 routing "
                  f"{'identical to' if routed else 'DIFFERS from'} the "
                  f"mesh-less step's (top-k experts and kept pairs of "
                  f"{len(routes_mesh)} MoE layers)")
        print(f"[dryrun] (e) {arch} {tag} {dict(mesh.shape)} fsdp={fsdp} "
              f"on [{dev}] x {mesh.size}: bf16 loss {float(loss1):.6f} "
              f"against {float(loss0):.6f} without a mesh (rel "
              f"{loss_err:.3g}, bound {loss_bound:.3g}); bf16 "
              f"gradients' worst leaf {truth[0]:.3g} ({truth[1]}) from the "
              f"float32 gradients (bound {DRYRUN_FLOOR_X} x the floor "
              f"{floor[0]:.3g} = {limit:.3g}) and {apart[0]:.3g} "
              f"({apart[1]}) from the mesh-less bf16 step's (bound "
              f"{apart_bound or 'none: two bf16 steps part by the floor'}); "
              f"float32 loss rel {err32:.3g} (bound {PP.LM_LOSS_RTOL}), "
              f"worst float32 gradient leaf {worst32[0]:.3g} ({worst32[1]}; "
              f"bound {PP.LM_GRAD_L2}); {'ok' if ok else 'FAILED'} "
              f"({time.perf_counter() - t0:.1f} s)")
        if not routed:
            bad.append(f"{arch} {tag}: float32 routing differs")
        if not ok:
            bad.append(f"{arch} {tag}: bf16 loss {loss_err:.3g}, bf16 grads "
                       f"{truth[0]:.3g} from float32 (limit {limit:.3g}), "
                       f"{apart[0]:.3g} from the mesh-less step, float32 "
                       f"loss {err32:.3g}, float32 grads {worst32[0]:.3g} "
                       f"({worst32[1]})")
    for tag in ("none", *DRYRUN_MESHES):
        p = prof[tag]
        busy = ("not measured" if p is None else
                f"device busy {p['busy_ms']:.3f} ms, "
                f"{p['intervals']:.0f} device intervals")
        c = coll[tag]
        moved = ", ".join(f"{k} {v}" for k, v in c.items()
                          if k != "n_ops" and v) or "none"
        timed = ("not run (the weights and AdamW state of two replicas, "
                 "old and new, exceed the card; collective bytes those "
                 "of the gradients alone)" if ms[tag] is None else
                 f"{ms[tag]:.4f} ms (median of {DRYRUN_REPS}, "
                 f"{ms[tag] / ms['none']:.3f} x without a mesh)")
        print(f"[dryrun] (e) {card}: {arch} step on {tag}: {timed}; "
              f"{busy}; collective operand bytes a device: {moved} "
              f"({c.get('n_ops', 0)} collectives): host cost of one card "
              f"standing for {tag}'s devices, not scaling")
    del g0, g32
    bad += _family_decode(card, dev, arch, cfg, params, logical)
    del params
    torch.cuda.empty_cache()
    print(f"[dryrun] (e) {arch}: {time.perf_counter() - t_arch:.1f} s")
    return bad


def _family_decode(card, dev, arch, cfg, params, logical):
    """A prefill and 4 decode steps at DRYRUN_DECODE[0] slots under TP
    (1, 2) against the mesh-less ones: logits within LM_BF16_GRAD_L2 in
    relative L2 over the real vocab at every step."""
    import numpy as np
    import torch

    from repro_torch.dist import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import model as M
    from repro_torch.train import parity as PP

    slots, plen = DRYRUN_DECODE
    batch = _family_batch(cfg, slots, plen, 31)
    extra = {k: v.to(dev) for k, v in batch.items() if k != "tokens"}
    rng = np.random.default_rng(31)
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (4, slots, 1)))
    pos = plen + (cfg.frontend_len if cfg.family == "vlm" else 0)
    mesh = make_mesh((1, 2), ("data", "model"), devices=[dev, dev])
    pp, pb = _placed_family(params, logical, mesh, False, batch)
    v = cfg.vocab
    errs = []
    with torch.no_grad():
        want, cache = M.prefill(params, cfg, batch["tokens"].to(dev),
                                pos + 4, **extra)
        got, pcache = M.prefill(pp, cfg, pb["tokens"], pos + 4,
                                **{k: pb[k] for k in extra})
        pairs = [(want, got)]
        for i, tok in enumerate(nxt):
            want, cache = M.decode_step(params, cfg, tok.to(dev), cache,
                                        pos + i)
            got, pcache = M.decode_step(
                pp, cfg, S.place(tok, pb["tokens"].sharding), pcache,
                pos + i)
            pairs.append((want, got))
        for want, got in pairs:
            got = got.gather(dev)
            errs.append(PP._rel_l2(PP._as_tensor(want[..., :v], dev),
                                   PP._as_tensor(got[..., :v], dev)))
            if not bool(torch.isfinite(got[..., :v]).all()):
                errs[-1] = float("inf")
    ok = max(errs) <= PP.LM_BF16_GRAD_L2
    print(f"[dryrun] (e) {card}: {arch} prefill of {plen} tokens at "
          f"{slots} slots and 4 decode steps under TP (1, 2) on [{dev}] x "
          f"2: logits from the mesh-less ones in relative L2 "
          f"{', '.join(f'{e:.3g}' for e in errs)} (bound "
          f"{PP.LM_BF16_GRAD_L2}); {'ok' if ok else 'FAILED'}")
    del pp, pb, cache, pcache
    return [] if ok else [f"{arch} decode logits {max(errs):.3g}"]


def dryrun_families(card, dev):
    """(e) the vlm, audio, ssm, hybrid and moe families on the card's
    meshes (`dryrun_family` each). Returns the failures."""
    t0 = time.perf_counter()
    bad = []
    for arch, over in DRYRUN_FAMILIES:
        bad += dryrun_family(card, dev, arch, over)
    print(f"[dryrun] (e) the {len(DRYRUN_FAMILIES)} archs: "
          f"{time.perf_counter() - t0:.1f} s")
    return bad


def dryrun_cells(card):
    """(c) JAX's own dry-run test cell, a train cell, a replicated-row
    mamba2 cell and a mid-head recurrentgemma cell on meta devices."""
    import tempfile

    from repro_torch.launch import dryrun as D

    bad = []
    with tempfile.TemporaryDirectory() as out:
        for arch, shape, multi_pod in DRYRUN_CELLS:
            t0 = time.perf_counter()
            rep = D.run_cell(arch, D.shape_by_name(shape),
                             multi_pod=multi_pod, out_dir=out)
            secs = time.perf_counter() - t0
            if rep["status"] != "ok":
                bad.append(f"{rep['cell']}: {rep['status']} "
                           f"{rep.get('error', '')}")
                continue
            r, m = rep["roofline"], rep["memory"]
            print(f"[dryrun] (c) {rep['cell']}: ok on "
                  f"{'512' if multi_pod else '256'} meta devices; per "
                  f"device {r['flops_per_device']:.6g} FLOP, "
                  f"{r['hbm_bytes_per_device']:.6g} bytes, collectives "
                  f"{r['collective_bytes_per_device']:.6g} bytes "
                  f"{ {k: v for k, v in r['collectives'].items() if v} }; "
                  f"terms at {card}'s data-sheet rates: compute "
                  f"{r['t_compute_s']:.4g} s, memory {r['t_memory_s']:.4g} "
                  f"s, collective {r['t_collective_s']:.4g} s, bottleneck "
                  f"{r['bottleneck']}; memory argument "
                  f"{m['argument_bytes'] / 2**30:.3f} GiB, peak (reckoned) "
                  f"{m['peak_bytes'] / 2**30:.3f} GiB; useful FLOPs "
                  f"{rep['useful_flops_ratio']:.4f}; traced in "
                  f"{rep['t_compile_s']} s, cell {secs:.1f} s")
    return bad


def phase_dryrun(card):
    """The distributed LM on the card: TP, DP and FSDP train steps and a
    TP decode against the mesh-less ones, the dry-run's production cells
    on meta devices, and the card's own roofline cell; K2-K6 launch
    none."""
    import torch

    from repro_torch.kernels import ops as K

    t_phase = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    K.reset_launch_counts()
    bad = dryrun_train(card, dev)
    bad += dryrun_decode(card, dev)
    bad += dryrun_families(card, dev)
    bad += dryrun_cells(card)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    if any(counts.values()):
        bad.append(f"kernel launches {counts}")
    print(f"[dryrun] K2-K6 launches {counts} (must be 0); phase "
          f"{time.perf_counter() - t_phase:.1f} s; scaling across several "
          f"cards: not verified (one card)")
    if bad:
        raise SystemExit(f"[dryrun] failed: {'; '.join(bad)}")


def tune_net(m, q, card):
    """Tune one fixture on the card; print each unique key's winner; fail
    on a disqualified kernel candidate or on coverage below 1.0 (the
    tuner's own end-to-end check raises on drift). Returns the plan."""
    from repro_torch.tune import save_tuned, tune_qnet

    t0 = time.perf_counter()
    plan = tune_qnet(q, batch=8, device="cuda", verbose=True)
    secs = time.perf_counter() - t0
    save_tuned(plan, os.path.join(OUT_DIR, f"tune_{m}_cuda.json"))
    by_route = {}
    for key, ch in sorted(plan.entries.items()):
        by_route[ch.route] = by_route.get(ch.route, 0) + 1
        us_ref = "n/a" if ch.us_ref is None else f"{ch.us_ref:.3f}"
        print(f"[tune] {m} {key}: {ch.route}{dict(ch.params) or ''} us "
              f"{ch.us:.3f} us_ref {us_ref} of {ch.n_candidates} "
              f"candidates; disqualified {list(ch.disqualified)}")
    bad = {k: ch.disqualified for k, ch in plan.entries.items()
           if any(d.startswith(("pallas_pw", "pallas_dw", "fused_irb"))
                  for d in ch.disqualified)}
    coverage = plan.coverage(q, backend="cuda")
    print(f"[tune] {card}: {m} tuned in {secs:.3f} s (batch 8, the "
          f"verification end to end included): {len(plan)} keys, winners by "
          f"route {dict(sorted(by_route.items()))}, coverage {coverage}")
    if bad or coverage != 1.0:
        raise SystemExit(f"[tune] {m}: kernel candidates disqualified {bad}, "
                         f"or coverage {coverage} != 1.0")
    return plan


def tuned_launches(eng, rows: int = 8):
    """(K2-K4 launches, K4 by variant) one micro-batch of `rows` rows of a
    (tuned) engine's replica makes: its resolved routes and fused blocks,
    each fused block's variant from `fused_irb.plan` at its input shape."""
    from repro_torch.core import compiler as CC
    from repro_torch.kernels import fused_irb as FI
    from repro_torch.kernels import ops as K

    plan = CC.compile_net(eng.pq.spec)
    fused = eng.stages[0].fused_blocks
    per = K.served_launches(plan, routes=eng.stages[0].pq.routes,
                            fused=fused)
    variants = {"single": 0, "split_e": 0}
    hw_in = {}
    for _, block, _, in_hw in plan.op_descriptors():
        hw_in.setdefault(block.name, in_hw)
    for block in eng.pq.spec.blocks:
        if block.name in fused:
            e, d, p = block.ops
            h = hw_in[block.name]
            fp = FI.plan(rows, h, h, e.in_ch, e.out_ch, p.out_ch, d.kernel,
                         d.stride)
            variants["split_e" if fp.splits > 1 else "single"] += 1
    return per, variants


def serve_exact(tag, q, imgs, want, stage_sha256=None, tuned=None):
    """A `VisionEngine` (with `tuned=`, if given) serves `imgs` on the
    card, bucket 8, with the launch counters set to 0 just before and
    read just after: the logits must equal `want` and the K2-K4 launches
    (K4 by variant) what the resolved routes call for; given
    `stage_sha256`, every stage output must equal its stored digest."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops as K
    from repro_torch.kernels.fused_irb import fused_irb_q
    from repro_torch.serve.vision import VisionEngine

    eng = VisionEngine(q, device="cuda", buckets=(8,), tuned=tuned)
    eng.warmup()
    rids = [eng.submit(img) for img in imgs]
    K.reset_launch_counts()
    res = eng.run()
    counts, variants = K.launch_counts(), dict(fused_irb_q.variants)
    per, per_var = tuned_launches(eng)
    logits = np.stack([res[r].logits for r in rids])
    n_diff = int(np.sum(logits != want))
    widths = sorted({op.act_bits for _, op in eng.pq.spec.all_ops()})
    print(f"{tag}: VisionEngine({'tuned=' if tuned else ''}) on the card "
          f"(act widths {widths}), {len(rids)} requests: {n_diff} of "
          f"{logits.size} logits differ; launch counts {counts}, "
          f"fused_irb_q by variant {variants}; the resolved routes call for "
          f"{ {k: v for k, v in per.items() if v} }, by variant {per_var}")
    if n_diff or counts != per or variants != per_var:
        raise SystemExit(f"{tag}: logits differ, or launches are not the "
                         f"resolved routes'")
    if stage_sha256 is not None:
        y = torch.from_numpy(imgs).to(eng.device)
        for i, st in enumerate(eng.stages[:-1]):
            y = st.run(y)
            if digests(y) != list(stage_sha256[i]):
                raise SystemExit(f"{tag}: stage {i} ({st.spec.cu}) differs "
                                 f"from the reference's digests")
        print(f"{tag}: every stage output equals the reference's digests")
    return counts


def closed_loop(eng, imgs, secs: float):
    """(FPS, p50 s) of rounds of 256 queued requests for `secs`."""
    n, lat, t0 = 0, [], time.perf_counter()
    while n == 0 or time.perf_counter() - t0 < secs:
        for i in range(256):
            eng.submit(imgs[i % len(imgs)])
        done = [r for r in eng.run().values() if r.status == "ok"]
        n += len(done)
        lat += [r.latency_s for r in done]
    return n / (time.perf_counter() - t0), statistics.median(lat), n


def tune_loops(qnets, plans, imgs, card):
    """Closed loops of each net untuned and tuned in turns, 3 pairs (the
    middle pair tuned first): rounds of 256 queued requests for
    TUNE_LOOP_S, buckets 1/2/4/8. Then each variant under torch.profiler
    (`profile`: wall, device busy, device intervals, top kernels)."""
    from repro_torch.serve.vision import VisionEngine

    for m, q in qnets.items():
        engs = {t: VisionEngine(q, device="cuda", buckets=(1, 2, 4, 8),
                                tuned=plans[m] if t else None)
                for t in (False, True)}
        for eng in engs.values():
            eng.warmup()
        runs = {False: [], True: []}
        for pair in range(3):
            for tuned in ((True, False) if pair == 1 else (False, True)):
                fps, p50, n = closed_loop(engs[tuned], imgs[m], TUNE_LOOP_S)
                runs[tuned].append((fps, p50))
                print(f"[tune] {card}: {m} closed loop, "
                      f"{'tuned  ' if tuned else 'untuned'} (pair {pair}): "
                      f"{n} requests, FPS {fps:.1f}, p50 "
                      f"{p50 * 1e3:.3f} ms")
        med = {t: (statistics.median(r[0] for r in runs[t]),
                   statistics.median(r[1] for r in runs[t]))
               for t in runs}
        print(f"[tune] {card}: {m} median of 3, untuned FPS "
              f"{med[False][0]:.1f} p50 {med[False][1] * 1e3:.3f} ms; tuned "
              f"FPS {med[True][0]:.1f} p50 {med[True][1] * 1e3:.3f} ms "
              f"(reported, no gate)")
        for tuned in (False, True):
            print(f"[tune] {m} {'tuned' if tuned else 'untuned'}:")
            profile(engs[tuned], imgs[m])


def tune_cli(card):
    """The serving CLI on the card as two subprocesses: tune and write the
    cache, then load it. Both must exit 0 with every request ok and full
    coverage; the first run's trace must validate."""
    from repro_torch.obs import validate_chrome_trace

    cache = os.path.join(OUT_DIR, "serve_tuned_cuda.json")
    trace = os.path.join(OUT_DIR, "serve_trace.json")
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--vision",
            "--models", "mobilenet_v2,efficientnet_compact", "--hw", "128",
            "--requests", "32"]
    runs = (base + ["--tune", "--tuned-cache", cache, "--trace-out", trace,
                    "--metrics-out",
                    os.path.join(OUT_DIR, "serve_metrics.json")],
            base + ["--tuned-cache", cache])
    for i, cmd in enumerate(runs):
        t0 = time.perf_counter()
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300, cwd=ROOT,
                             env=dict(os.environ,
                                      PYTHONPATH=os.path.join(ROOT, "src")))
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("[serve-vision]")]
        for ln in lines:
            print(f"[tune] cli {i}| {ln}")
        ok = "[serve-vision] 32/32 ok" in out.stdout
        full = sum("tuned route coverage 100%" in ln for ln in lines) == 2
        print(f"[tune] {card}: CLI run {i} exit {out.returncode} in "
              f"{time.perf_counter() - t0:.1f} s; 32/32 ok: {ok}; coverage "
              f"100% for both nets: {full}")
        if out.returncode or not ok or not full:
            raise SystemExit(f"[tune] CLI run {i} failed: "
                             f"{out.stderr[-3000:]}")
    with open(trace) as f:
        errors = validate_chrome_trace(json.load(f))
    print(f"[tune] CLI trace: validate_chrome_trace {len(errors)} "
          f"violations")
    if errors:
        raise SystemExit(f"[tune] CLI trace invalid: {errors[:5]}")


def phase_tune(card):
    """The route autotuner and tuned serving of both full-width nets."""
    import numpy as np

    from repro_torch.core.qnet import load_qnet
    from repro_torch.train.vision import verify_export

    t_phase = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    qnets = {m: load_qnet(base + ".qnet") for m, (base, _) in FLEET.items()}
    imgs = {m: images(hw) for m, (_, hw) in FLEET.items()}
    fixes = {m: dict(np.load(base + ".npz")) for m, (base, _) in FLEET.items()}
    plans = {m: tune_net(m, q, card) for m, q in qnets.items()}
    for m, q in qnets.items():
        serve_exact(f"[tune] {m}", q, imgs[m], fixes[m]["logits"],
                    fixes[m]["stage_sha256"] if m == "mobilenet_v2" else None,
                    tuned=plans[m])
    tune_loops(qnets, plans, imgs, card)
    m = "mobilenet_v2"
    t0 = time.perf_counter()
    report = verify_export(qnets[m], imgs[m], device="cuda", tuned=plans[m])
    print(f"[tune] {m}: verify_export(tuned=) in "
          f"{time.perf_counter() - t0:.1f} s proved {report['routes']}")
    if "engine[tuned]" not in report["routes"]:
        raise SystemExit("[tune] the export proof did not prove "
                         "engine[tuned]")
    tune_cli(card)
    print(f"[tune] {card}: phase {time.perf_counter() - t_phase:.1f} s")


# [precision]: the search's full-width config and its small, printed budget
PRECISION_CFG = dict(model="mobilenet_v2", alpha=1.0, input_hw=224,
                     num_classes=1000, bits=4, float_steps=2, qat_steps=2,
                     batch=8, calibrate_every=0, ckpt_every=0)
PRECISION_CHOICES = (4, 6, 8)
PRECISION_LADDER = 5
PRECISION_FINETUNE = 2  # QAT fine-tune steps a candidate
PRECISION_EVAL_BATCHES = 1
PRECISION_LOOP_S = 1.5  # a closed-loop run of [precision]
MIX = os.path.join(ROOT, "tests", "golden_torch",
                   "mobilenet_v2_alpha1_224_mix468")


def precision_search(card):
    """`search_precision` at full width on the card: `ensure_coverage`
    tunes each uniform net there (timed a width), then the search scores
    every candidate with `QATFinetuneAccuracy`. Fails unless the artifact
    passes `check_pareto_artifact`, every point is fully tuned and no
    kernel candidate was disqualified. Returns (cfg, scorer, result)."""
    from repro_torch.core import graph as G
    from repro_torch.energy.power import default_power_model
    from repro_torch.train.vision import VisionTrainConfig, build_net
    from repro_torch.tune import TunedPlan
    from repro_torch.tune import precision as P

    cfg = VisionTrainConfig(act_bits=min(PRECISION_CHOICES), **PRECISION_CFG)
    power = default_power_model("cuda")
    table = P.LatencyTable(TunedPlan(backend="cuda", nets=(), tuned_batch=8,
                                     entries={}), power, "cuda")
    base = build_net(cfg)
    for w in PRECISION_CHOICES:
        t0 = time.perf_counter()
        table = P.ensure_coverage(table, [G.with_act_bits(base, w)],
                                  batch=8, repeats=3)
        print(f"[precision] {card}: uniform act{w} net calibrated and tuned "
              f"on the card in {time.perf_counter() - t0:.3f} s (batch 8, "
              f"3 repeats, every kernel candidate); the table holds "
              f"{len(table.tuned)} keys")
    bad = {k: ch.disqualified for k, ch in table.tuned.entries.items()
           if ch.disqualified}
    if bad:
        raise SystemExit(f"[precision] candidates disqualified: {bad}")
    scorer = P.QATFinetuneAccuracy(
        cfg, steps=PRECISION_FINETUNE, eval_batches=PRECISION_EVAL_BATCHES,
        device="cuda")
    print(f"[precision] accuracy budget: base run {cfg.float_steps} float + "
          f"{cfg.qat_steps} QAT steps at act8, {PRECISION_FINETUNE} QAT "
          f"fine-tune steps a candidate, batch {cfg.batch}, "
          f"{PRECISION_EVAL_BATCHES} eval batch")
    t0 = time.perf_counter()
    result = P.search_precision(
        cfg, choices=PRECISION_CHOICES, tuned=table.tuned, power=power,
        accuracy_fn=scorer, ladder_budget=PRECISION_LADDER, tune_batch=8,
        device="cuda")
    secs = time.perf_counter() - t0
    path = P.write_pareto(result, P.pareto_path(
        cfg.model, "cuda", os.path.join(OUT_DIR, "precision")))
    for pt in result.points:
        print(f"[precision] {card}: {pt.name} us_per_image "
              f"{pt.us_per_image:.3f} (fps {pt.fps:.1f}) j_per_image "
              f"{pt.j_per_image:.6g} accuracy {pt.accuracy} tuned_fraction "
              f"{pt.tuned_fraction}{' (front)' if pt.name in result.front else ''}")
    # the schema, the widths and the recorded front against the recomputed
    # non-dominated set; not the three-point minimum of the JAX package's
    # committed front: at 1000 classes this budget scores every candidate
    # about 0 of 8, so one point can dominate every other on the remaining
    # axes (fps, J/image; model bytes are equal)
    P.check_pareto_artifact(path, min_points=1)
    print(f"[precision] {card}: search {secs:.3f} s, {len(result.points)} "
          f"points, front {list(result.front)} ({len(result.front)} "
          f"points), savings order {result.meta['savings_order']}; "
          f"check_pareto_artifact passed on {os.path.relpath(path, ROOT)}")
    if any(pt.tuned_fraction != 1.0 for pt in result.points):
        raise SystemExit("[precision] a point is not fully tuned")
    return cfg, scorer, result


def precision_export(card, cfg, scorer, result):
    """The headline mixed point (the CLI's pick: the dominating mixed
    point, else the first mixed point on the front; else the first mixed
    point) exported on the card through its route proof. Returns the
    artifact's path."""
    from repro_torch.tune import precision as P

    dom = P.find_domination(list(result.points))
    name = dom[0] if dom else next(
        (n for n in result.front if n.startswith("mix")), None)
    if name is None:
        name = next(p.name for p in result.points if p.uniform is None)
        print(f"[precision] the front holds no mixed point; exporting "
              f"{name}, the first mixed point searched")
    point = result.point(name)
    path = os.path.join(OUT_DIR, "precision", f"{cfg.model}_cuda_{name}.qnet")
    t0 = time.perf_counter()
    report = P.export_point(cfg, point, path, accuracy_impl=scorer)
    print(f"[precision] {card}: exported {name} (widths "
          f"{sorted(set(point.alloc.values()))}, dominates "
          f"{dom[1] if dom else 'no uniform point'}) in "
          f"{time.perf_counter() - t0:.3f} s, fine-tune included; route "
          f"proof {report['routes']}; {report['artifact_bytes']} bytes")
    if "engine" not in report["routes"]:
        raise SystemExit("[precision] the export proof did not reach the "
                         "engine")
    return path


def precision_kernels(card, mix_pq, x):
    """K2, K3 and K4 at act4 and act6 at full-width MobileNetV2 shapes,
    each call against its plain version (exact) and timed: K4 on the
    mixed fixture's act4 and act6 blocks (whose inputs come quantized at
    the neighbour block's width), K2 and K3 on the unfused ops of uniform
    act4 and act6 nets calibrated on the card from the fixture's spec."""
    import torch

    from repro_torch.core import cu, graph as G
    from repro_torch.models.layers import make_calibrated_qnet

    spec = mix_pq.spec
    width = {b.name: b.ops[0].act_bits for b in spec.blocks}
    width.update({op.name: op.act_bits for _, op in spec.all_ops()})
    calls = [(w, c) for c in main_path_calls(mix_pq, x)
             if c[0] == "fused_irb_q" and (w := width[c[1]]) in (4, 6)]
    for w in (4, 6):
        q = make_calibrated_qnet(G.with_act_bits(spec, w), bits=4,
                                 device="cuda")
        pq = cu.prepare_qnet(q, device="cuda")
        calls += [(w, c) for c in main_path_calls(pq, x)
                  if c[0] != "fused_irb_q"]
    print(f"[precision] kernels at act4 and act6 against their plain "
          f"versions, batch 8 (tolerance: exact)")
    sums = {}
    for w, (name, label, kern, plain, _, (nb, _), ops, note) in calls:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if got.shape != want.shape or err != 0 or \
                int(got.max()) > 2 ** w - 1:
            raise SystemExit(f"[precision] {name}[{label}] at act{w} "
                             f"differs from its plain version (max |err| "
                             f"{err}) or leaves [0, {2 ** w - 1}]")
        ms, dev_ms = time_ms(kern), time_ms(kern, device_only=True)
        bytes_ms, ops_ms = nb / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
        print(f"  act{w} {name}[{label}] {tuple(got.shape)}{note} "
              f"max_abs_err={err} max={int(got.max())} ms={ms:.4f} "
              f"device_ms={dev_ms:.4f} bound_ms={max(bytes_ms, ops_ms):.5f}")
        r = sums.setdefault((name, w), [0, 0.0, 0.0, 0.0])
        r[0] += 1
        r[1] += ms
        r[2] += dev_ms
        r[3] += max(bytes_ms, ops_ms)
    for (name, w), (n, ms, dev_ms, bound) in sorted(sums.items()):
        print(f"[precision] {card}: {name} at act{w}: {n} calls, ms "
              f"{ms:.4f}, device_ms {dev_ms:.4f}, bound_ms {bound:.5f}")
    if {k[0] for k in sums} != {"pointwise_conv_q", "depthwise_conv_q",
                                "fused_irb_q"} or len(sums) != 6:
        raise SystemExit(f"[precision] not every kernel ran at act4 and "
                         f"act6: {sorted(sums)}")


def precision_loops(card, paths, imgs):
    """Closed loops of each net in turns (2 rounds, PRECISION_LOOP_S each,
    buckets 1/2/4/8): FPS and p50, reported, no gate."""
    from repro_torch.serve.vision import VisionEngine

    engs = {tag: VisionEngine.from_artifact(p, device="cuda",
                                            buckets=(1, 2, 4, 8))
            for tag, p in paths.items()}
    for eng in engs.values():
        eng.warmup()
    runs = {tag: [] for tag in engs}
    for rnd in range(2):
        for tag in (list(engs) if rnd == 0 else list(reversed(engs))):
            runs[tag].append(closed_loop(engs[tag], imgs,
                                         PRECISION_LOOP_S)[:2])
    for tag, r in runs.items():
        print(f"[precision] {card}: {tag} closed loop, buckets 1/2/4/8: "
              f"FPS {', '.join(f'{f:.1f}' for f, _ in r)}; p50 "
              f"{', '.join(f'{p * 1e3:.3f}' for _, p in r)} ms (reported, "
              f"no gate)")


def phase_precision(card):
    """The mixed-precision search at full width on the card, its headline
    export served there, the mixed 4/6/8 fixture held against JAX, and
    K2-K4 at act4 and act6 against their plain versions."""
    import numpy as np
    import torch

    from repro_torch.core import cu
    from repro_torch.core.qnet import load_qnet

    t_phase = time.perf_counter()
    imgs = images()
    cfg, scorer, result = precision_search(card)
    path = precision_export(card, cfg, scorer, result)
    t0 = time.perf_counter()
    want = cu.run_qnet(cu.prepare_qnet(load_qnet(path), device="cpu"),
                       imgs).numpy()
    print(f"[precision] the port's cu.run_qnet on the CPU over the exported "
          f"artifact: {time.perf_counter() - t0:.1f} s")
    serve_exact(f"[precision] exported {os.path.basename(path)}",
                load_qnet(path), imgs, want)
    fix = dict(np.load(MIX + ".npz"))
    serve_exact("[precision] fixture mix468", load_qnet(MIX + ".qnet"), imgs,
                fix["logits"], fix["stage_sha256"])
    mix_pq = cu.prepare_qnet(load_qnet(MIX + ".qnet"), device="cuda")
    precision_kernels(card, mix_pq, torch.from_numpy(imgs).to(mix_pq.device))
    precision_loops(card, {"exported " + os.path.basename(path): path,
                           "fixture mix468": MIX + ".qnet",
                           "uniform8 (act8 fixture)": FIXTURE + ".qnet"},
                    imgs)
    print(f"[precision] {card}: phase {time.perf_counter() - t_phase:.1f} s")


def lm_inputs(cfg, dev):
    """The [lm] phase's cases on the card: (linears, decodes). A linear is
    (label, x [M, K], w_q, scale, bits, golden key or None); a decode is
    (label, q [B, 1, H, dh], cache dict, kv_len as a 0-dim int32 tensor,
    golden key). Weights are quantized on the card by the port's
    `quantize_weight_for_matmul`, the int8 cache by its `kv_quant`."""
    import torch

    from repro_torch.kernels import ops as K
    from repro_torch.models.lm.common import kv_quant

    C = lm_cases()
    linears = []
    for name, k, n in C.layer_linears(cfg):
        w = torch.from_numpy(C.weight(name, k, n)).to(dev)
        x8 = torch.from_numpy(C.activations(name, 8, k)).to(dev)
        xs = {"8xf32": x8, "8xbf16": x8.to(torch.bfloat16),
              "512xbf16": torch.from_numpy(
                  C.activations(name, 512, k)).to(dev, torch.bfloat16)}
        for scheme, (bits, group) in C.SCHEMES.items():
            wq, sc = K.quantize_weight_for_matmul(w, bits=bits,
                                                  group_size=group)
            for xname, x in xs.items():
                key = f"linear/{scheme}/{name}"
                gold = key if (xname == "8xf32" and name != "lm_head"
                               and scheme in C.GOLDEN_SCHEMES) else None
                linears.append((f"{name}/{scheme}/{xname}", x, wq, sc, bits,
                                gold))
        del w
    q, k, v = (torch.from_numpy(a).to(dev) for a in C.decode_inputs(cfg))
    (k8, ks), (v8, vs) = kv_quant(k), kv_quant(v)
    caches = {True: {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs},
              False: {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}}
    decodes = [(case, q, caches[quant],
                torch.tensor(kv_len, dtype=torch.int32, device=dev),
                f"decode/{case}") for case, quant, kv_len in C.DECODE_CASES]
    return linears, decodes


def _row(rows, name, err, ms, plain_ms, lib_ms, bytes_ms, ops_ms, dev_ms,
         lib_dev_ms):
    r = rows.setdefault(name, dict(err=0, ms=0.0, plain_ms=0.0, lib_ms=0.0,
                                   has_lib=True, bytes_ms=0.0, ops_ms=0.0,
                                   bound=0.0, bound32=0.0, dev_ms=0.0,
                                   lib_dev_ms=0.0))
    r["err"] = max(r["err"], err)
    r["ms"] += ms
    r["plain_ms"] += plain_ms
    r["has_lib"] &= lib_ms is not None
    r["lib_ms"] += lib_ms or 0.0
    r["bytes_ms"] += bytes_ms
    r["ops_ms"] += ops_ms
    r["bound"] += max(bytes_ms, ops_ms)
    r["dev_ms"] += dev_ms
    r["lib_dev_ms"] += lib_dev_ms or 0.0
    return r


def _opt(r, key: str) -> str:
    """A library time of a row, or null where a case had no library call."""
    return f"{r[key]:.4f}" if r["has_lib"] else "null"


def _close(got, want, rtol, atol):
    """(max |got - want| in f32, within rtol/atol)."""
    import torch
    g, w = got.float(), want.float()
    return (float((g - w).abs().max()),
            g.shape == w.shape and bool(torch.allclose(g, w, rtol=rtol,
                                                       atol=atol)))


def phase_lm(card):
    """Drive the LM entry points once at Llama-3.2-1B widths, then hold
    every output against the plain version and the golden, and time it."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import llama32_1b
    from repro_torch.kernels import ops as K
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain, launch_plan as da_plan)
    from repro_torch.kernels.quant_matmul import (
        dequantize, plan, quant_matmul, quant_matmul_plain)

    cfg = llama32_1b.get_config()
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    linears, decodes = lm_inputs(cfg, dev)
    torch.cuda.synchronize()
    print(f"[lm] {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads} heads, "
          f"{cfg.n_kv_heads} kv heads, head_dim {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}; {len(linears)} linears and "
          f"{len(decodes)} decode-attention cases built in "
          f"{time.perf_counter() - t0:.1f} s")

    K.reset_launch_counts()
    outs, took = [], []  # took: the variant each case's launch counted
    for _, x, wq, sc, bits, _ in linears:
        before = dict(quant_matmul.variants)
        outs.append(K.quantized_linear(x, wq, sc, bits=bits))
        took.append([v for v, c in quant_matmul.variants.items()
                     if c != before[v]])
    douts, dtook = [], []  # dtook: the variant each K6 case counted
    for _, q, cache, n, _ in decodes:
        before = dict(decode_attention.variants)
        douts.append(K.decode_attend(q, cache, n))
        dtook.append([v for v, c in decode_attention.variants.items()
                      if c != before[v]])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    want = {name: 0 for name in counts}
    want.update(quant_matmul=len(linears), decode_attention=len(decodes))
    print(f"[lm] launch counts of the entry points' run: {counts}; "
          f"quant_matmul by variant: {quant_matmul.variants}")
    if counts != want:
        raise SystemExit(f"[lm] launches {counts} != expected {want}")
    expect = {8: "decode", 512: "mma"}
    wrong = [f"{case[0]} took {v}" for case, v in zip(linears, took)
             if v != [expect[case[1].shape[0]]]]
    wrong += [f"decode_attention[{case[0]}] took {v}"
              for case, v in zip(decodes, dtook) if v != ["split_s"]]
    if wrong:
        raise SystemExit(f"[lm] wrong variant: {', '.join(wrong)}")

    golden = dict(np.load(LM_GOLDEN))
    rows, bad, layer = {}, [], {}
    print(f"[lm] {card}: each case against the plain version and the "
          f"golden; ms = median of {REPS} (CUDA events, the host's launch "
          f"cost included; device_ms the device's work alone); bound: "
          f"bytes at 3.35 TB/s, flops at the 989 TFLOP/s dense bf16 peak")
    for (label, x, wq, sc, bits, gold), y, (variant,) in zip(linears, outs,
                                                              took):
        dtype = str(x.dtype).split(".")[1]
        rtol, atol = QMM_TOL[dtype]
        err, ok = _close(y, quant_matmul_plain(x, wq, sc, bits=bits).to(
            x.dtype), rtol, atol)
        if not torch.equal(y, K.quantized_linear(x, wq, sc, bits=bits)):
            bad.append(f"quant_matmul[{label}] (two calls, different bits)")
        gtxt = "-"
        if gold is not None:
            gerr, gok = _close(y, torch.from_numpy(golden[gold]).to(dev),
                               rtol, atol)
            gtxt = f"{gerr:.3g}"
            ok &= gok
        if not ok:
            bad.append(f"quant_matmul[{label}]")
        wdq, xf = dequantize(wq, sc, bits=bits), x.float()
        ms = time_ms(lambda: quant_matmul(x, wq, sc, bits=bits))
        plain_ms = time_ms(lambda: quant_matmul_plain(x, wq, sc, bits=bits))
        lib_ms = time_ms(lambda: torch.matmul(xf, wdq))
        dev_ms = time_ms(lambda: quant_matmul(x, wq, sc, bits=bits),
                         device_only=True)
        lib_dev_ms = time_ms(lambda: torch.matmul(xf, wdq), device_only=True)
        del wdq, xf
        (m, k), n = x.shape, y.shape[1]
        bytes_ms = (nbytes(x, wq, sc) + 4 * m * n) / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * m * k * n / BF16_FLOPS_PER_S * 1e3
        times = (ms, plain_ms, lib_ms, bytes_ms, ops_ms, dev_ms, lib_dev_ms)
        _row(rows, "quant_matmul", err, *times)
        if not label.startswith("lm_head/"):
            _row(layer, label.split("/", 1)[1], err, *times)
        splits = plan(m, k, n, k // sc.shape[0], bits, x.dtype).splits
        print(f"  quant_matmul[{label}] ({m},{k})x({k},{n}) variant={variant}"
              f" splits={splits} max_abs_err={err:.3g} golden_err={gtxt} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"bound_ms={max(bytes_ms, ops_ms):.5f} "
              f"({'bytes' if bytes_ms >= ops_ms else 'operations'}) "
              f"device_ms={dev_ms:.4f} library_device_ms={lib_dev_ms:.4f}")
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    cold_total = 0.0
    for (label, q, cache, kv_len, gold), y, (variant,) in zip(decodes, douts,
                                                              dtook):
        b, _, h, dh = q.shape
        kv = cache["k"].shape[2]
        qg = q.reshape(b, kv, h // kv, dh)
        args = (qg, cache["k"], cache["v"], kv_len, cache.get("k_scale"),
                cache.get("v_scale"))
        err, ok = _close(y.reshape(qg.shape), decode_attention_plain(*args),
                         *ATTN_TOL)
        if not torch.equal(y, K.decode_attend(q, cache, kv_len)):
            bad.append(f"decode_attention[{label}] (two calls, different "
                       f"bits)")
        gerr, gok = _close(y, torch.from_numpy(golden[gold]).to(dev),
                           *ATTN_TOL)
        if not (ok and gok):
            bad.append(f"decode_attention[{label}]")
        n = min(int(kv_len), cache["k"].shape[1])  # positions attended
        kd, vd = (c.float() for c in (cache["k"], cache["v"]))
        if "k_scale" in cache:
            kd = kd * cache["k_scale"].float()[..., None]
            vd = vd * cache["v_scale"].float()[..., None]
        kd, vd = (t.permute(0, 2, 1, 3).contiguous() for t in (kd, vd))
        qs = q.reshape(b, h, 1, dh)
        mask = (torch.arange(kd.shape[2], device=dev) < n)[None, None, None]
        ms = time_ms(lambda: decode_attention(*args))
        plain_ms = time_ms(lambda: decode_attention_plain(*args))
        sdpa = (lambda: F.scaled_dot_product_attention(
            qs, kd, vd, attn_mask=mask, enable_gqa=True))
        lib_ms = time_ms(sdpa)
        dev_ms = time_ms(lambda: decode_attention(*args), device_only=True)
        cold_ms = time_ms(lambda: decode_attention(*args), device_only=True,
                          flush=flush)
        cold_total += cold_ms
        lib_dev_ms = time_ms(sdpa, device_only=True)
        del kd, vd, sdpa
        # the plan the wrapper launched with for these tensors
        p, lay = da_plan(qg, cache["k"], cache["v"])
        blocks = p.splits * lay.grid(b, kv, h // kv)
        per_pos = b * kv * dh * cache["k"].element_size() * 2 + (
            b * kv * 2 * cache["k_scale"].element_size()
            if "k_scale" in cache else 0)
        bytes_ms = (2 * nbytes(q) + n * per_pos) / HBM_BYTES_PER_S * 1e3
        ops_ms = 4 * b * h * n * dh / BF16_FLOPS_PER_S * 1e3
        _row(rows, "decode_attention", err, ms, plain_ms, lib_ms, bytes_ms,
             ops_ms, dev_ms, lib_dev_ms)
        print(f"  decode_attention[{label}] q {tuple(q.shape)} cache "
              f"{tuple(cache['k'].shape)} {cache['k'].dtype} kv_len {n} "
              f"variant={variant} plan: splits={p.splits} "
              f"per_split={p.per_split} blocks={blocks} heads={lay.heads}; "
              f"max_abs_err={err:.3g} golden_err={gerr:.3g} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"bound_ms={max(bytes_ms, ops_ms):.5f} "
              f"({'bytes' if bytes_ms >= ops_ms else 'operations'}) "
              f"device_ms={dev_ms:.4f} cold_device_ms={cold_ms:.4f} "
              f"library_device_ms={lib_dev_ms:.4f}")
    del flush
    rows["decode_attention"]["cold_dev_ms"] = cold_total
    for how, r in layer.items():
        print(f"[lm] one decoder layer's 7 linears, {how}: ms {r['ms']:.4f}, "
              f"bound_ms {r['bound']:.5f}, plain_ms {r['plain_ms']:.4f}, "
              f"library_ms {r['lib_ms']:.4f}")
    for name, r in rows.items():
        print(f"[lm] {name}: ms {r['ms']:.4f} over its "
              f"{counts[name]} cases, bound_ms {r['bound']:.5f}, plain_ms "
              f"{r['plain_ms']:.4f}, library_ms {r['lib_ms']:.4f}")
    for how, r in [(f"one decoder layer's 7 linears, {how}", r)
                   for how, r in layer.items()] + [
            (f"{name}, its {counts[name]} cases", r)
            for name, r in rows.items()]:
        print(f"[lm] {how}, the device's work alone: device_ms "
              f"{r['dev_ms']:.4f}, library_device_ms {r['lib_dev_ms']:.4f}")
    print(f"[lm] decode_attention, its {counts['decode_attention']} cases "
          f"with the L2 cache flushed before each call: cold_device_ms "
          f"{cold_total:.4f}")
    if bad:
        raise SystemExit(f"[lm] out of tolerance: {', '.join(bad)}")
    return rows, counts


LM_SERVE_GOLDEN = os.path.join(ROOT, "tests", "golden_torch",
                               "llama32_1b_serve.npz")
# (rtol, atol) of the [lm_serve] checks between two f32 runs: the card
# against the CPU (cuBLAS and the CPU's BLAS sum in other orders) and both
# against the JAX golden (tests/test_torch_lm_engine.py's GOLDEN_TOL)
LM_SERVE_TOL = (1e-4, 1e-4)
LM_CACHE_ATOL = 1e-4  # prefill + decode against forward_train, f32, 16 layers
LM_ARCH_STEPS = 8  # decode steps of each reduced arch, card against CPU
LM_FULL_ARCHS = ("mamba2-1.3b", "recurrentgemma-2b")  # also at full width
LM_FULL_STEPS = 4  # greedy decode steps of each on the card


def lm_manual(params, cfg, prompts, max_new, max_len):
    """A batch's greedy tokens by a plain prefill-and-decode loop (prompts
    of one length, so no padding)."""
    import numpy as np
    import torch

    from repro_torch.models.lm import model as M

    dev = params["embed"].device
    with torch.inference_mode():
        tokens = torch.from_numpy(np.stack(prompts)).long().to(dev)
        logits, cache = M.prefill(params, cfg, tokens, max_len=max_len)
        cur = torch.argmax(logits[:, 0], -1)
        out = [cur]
        for t in range(max_new - 1):
            logits, cache = M.decode_step(params, cfg, cur[:, None], cache,
                                          tokens.shape[1] + t)
            cur = torch.argmax(logits[:, 0], -1)
            out.append(cur)
    return torch.stack(out, 1).cpu().tolist()


def lm_engine_checks(tag, cfg, params, rng):
    """test_serve_engine.py's three properties at full width on the card:
    the Engine against a manual loop at 1 slot and at 4 slots with 6
    requests (two batches), and one prompt's tokens across two batches."""
    from repro_torch.serve.engine import Engine, Request

    def serve(slots, prompts, max_new):
        eng = Engine(cfg, params, batch_slots=slots, max_len=128,
                     device=params["embed"].device)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new=max_new))
        done = eng.run()
        return [done[i] for i in range(len(prompts))]

    def prompt():
        return rng.integers(0, cfg.vocab, 12).astype("int32")

    bad = []
    one = [prompt()]
    if serve(1, one, 8) != lm_manual(params, cfg, one, 8, 128):
        bad.append("1 slot")
    six = [prompt() for _ in range(6)]
    want = (lm_manual(params, cfg, six[:4], 6, 128)
            + lm_manual(params, cfg, six[4:], 6, 128))
    if serve(4, six, 6) != want:
        bad.append("4 slots, 6 requests")
    p, other = prompt(), prompt()
    a = serve(2, [p, other], 6)
    b = serve(2, [p, other[::-1].copy()], 6)
    if a[0] != b[0]:
        bad.append("same prompt across batches")
    print(f"[lm_serve] {tag}: Engine vs manual loop at 1 slot and at 4 slots "
          f"(6 requests), same prompt across batches: "
          f"{'equal' if not bad else 'DIFFERENT: ' + ', '.join(bad)}")
    return [f"{tag} {b}" for b in bad]


def lm_times(tag, cfg, params, card):
    """Prefill ms (4 x 12 tokens) and decode ms a step at 4 slots (CUDA
    events, median of REPS, host included), against the bound of reading
    every weight once at 3.35 TB/s."""
    import torch

    from repro_torch.models.lm import model as M

    dev = params["embed"].device
    tokens = torch.randint(0, cfg.vocab, (4, 12), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               0))
    with torch.inference_mode():
        _, cache = M.prefill(params, cfg, tokens, max_len=128)
        tok = tokens[:, -1:]
        pre_ms = time_ms(lambda: M.prefill(params, cfg, tokens, max_len=128))
        dec_ms = time_ms(lambda: M.decode_step(params, cfg, tok, cache, 12))
    wbytes = sum(t.numel() * t.element_size()
                 for t in _leaves(params))
    bound = wbytes / HBM_BYTES_PER_S * 1e3
    print(f"[lm_serve] {tag}: prefill (4 x 12 tokens) {pre_ms:.4f} ms, "
          f"decode step (4 slots, position 12) {dec_ms:.4f} ms; weights "
          f"{wbytes / 1e9:.4f} GB, read once at 3.35 TB/s: {bound:.4f} ms "
          f"(decode at {bound / dec_ms:.4f} of that bound); {card}")
    return dec_ms, tok, cache


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def lm_decode_profile(cfg, params, tok, cache, steps: int = 10):
    """Device busy share of `steps` decode steps under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from repro_torch.models.lm import model as M

    torch.cuda.synchronize()
    with torch.inference_mode(), tprofile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            M.decode_step(params, cfg, tok, cache, 12)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [(evt.self_device_time_total / 1e3, evt.count, evt.key)
           for evt in prof.key_averages()
           if evt.device_type == DeviceType.CUDA]
    busy = busy_ms(prof.events())
    if not dev or busy <= 0:
        print("[lm_serve] torch.profiler reported no device time: busy "
              "share not measured")
        return
    n = sum(c for _, c, _ in dev)
    print(f"[lm_serve] bf16 decode step at 4 slots, {steps} steps under "
          f"torch.profiler: wall {wall_ms / steps:.4f} ms a step, device "
          f"busy {busy / steps:.4f} ms a step ({n / steps:.1f} device "
          f"intervals a step), busy share {busy / wall_ms:.4f}")
    for d, c, key in sorted(dev, reverse=True)[:6]:
        print(f"[lm_serve]   {d / steps:9.4f} ms {c // steps:5d}x  "
              f"{key[:80]}")


def lm_cache_vs_forward(cfg, dev, rng):
    """`cfg` (full-width Llama-3.2-1B, 16 layers) in f32, TF32 off: prefill
    of 8 tokens plus 8 teacher-forced decode steps against forward_train."""
    import dataclasses

    import torch

    from repro_torch.models.lm import model as M

    cfg = dataclasses.replace(cfg, dtype="float32")
    params, _ = M.init_params(cfg, 1, device=dev)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))).to(
        params["embed"].device)
    with torch.inference_mode():
        full, _ = M.forward_train(params, cfg, tokens)
        logits, cache = M.prefill(params, cfg, tokens[:, :8], max_len=16)
        errs = [float((logits[:, 0] - full[:, 7]).abs().max())]
        for t in range(8, 16):
            logits, cache = M.decode_step(params, cfg, tokens[:, t:t + 1],
                                          cache, t)
            errs.append(float((logits[:, 0] - full[:, t]).abs().max()))
    del params, full, cache
    print(f"[lm_serve] cache path vs forward_train, {cfg.name} "
          f"{cfg.n_layers} layers f32 (TF32 off), prefill 8 + 8 decode "
          f"steps: max abs err "
          f"{max(errs):.3g} at each position "
          f"{' '.join(f'{e:.3g}' for e in errs)} (bound {LM_CACHE_ATOL})")
    return [] if max(errs) <= LM_CACHE_ATOL else [
        f"cache path vs forward: {max(errs):.3g} > {LM_CACHE_ATOL}"]


def lm_golden_checks(dev):
    """Llama-3.2-1B widths, 2 layers, f32, numpy-seeded weights
    (tests/torch_lm_cases.py): the card's prefill and greedy decode against
    the port's on the CPU, and both against the JAX golden."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import llama32_1b
    from repro_torch.models.lm import model as M

    C = lm_cases()
    cfg = dataclasses.replace(llama32_1b.get_config(),
                              n_layers=C.SERVE_LAYERS, dtype="float32")
    cpu_params = M.tree_map(torch.from_numpy, C.serve_params(cfg))
    prompts = C.serve_prompts(cfg)
    ids = C.serve_vocab_ids(cfg)
    runs = {}
    for where in (dev.type, "cpu"):
        params = M.tree_map(lambda t: t.to(where), cpu_params)
        with torch.inference_mode():
            tok = torch.from_numpy(prompts).long().to(where)
            logits, cache = M.prefill(params, cfg, tok,
                                      max_len=C.SERVE_MAX_LEN)
            steps = [logits[:, 0].cpu()]
            toks = [torch.argmax(logits[:, 0], -1)]
            for t in range(C.SERVE_NEW):
                logits, cache = M.decode_step(params, cfg, toks[-1][:, None],
                                              cache, C.SERVE_PROMPT + t)
                steps.append(logits[:, 0].cpu())
                toks.append(torch.argmax(logits[:, 0], -1))
        runs[where] = (torch.stack([t.cpu() for t in toks], 1).numpy(),
                       torch.stack(steps).numpy())
        del params, cache
    gold = dict(np.load(LM_SERVE_GOLDEN))
    rtol, atol = LM_SERVE_TOL
    bad = []
    (ct, cl), (pt, pl) = runs[dev.type], runs["cpu"]
    err = float(np.abs(cl - pl).max())
    if not np.array_equal(ct, pt) or not np.allclose(cl, pl, rtol, atol):
        bad.append(f"card vs CPU (tokens equal {np.array_equal(ct, pt)}, "
                   f"max abs err {err:.3g})")
    gerr = 0.0
    for where, (toks, lg) in runs.items():
        top = np.take_along_axis(lg, toks.T[:, :, None], axis=2)[..., 0]
        sub = lg[:, :, ids]
        gerr = max(gerr, float(np.abs(sub - gold["logits_at_ids"]).max()),
                   float(np.abs(top - gold["top_logit"]).max()))
        if not (np.array_equal(toks, gold["tokens"])
                and np.allclose(sub, gold["logits_at_ids"], rtol, atol)
                and np.allclose(top, gold["top_logit"], rtol, atol)):
            bad.append(f"{where} vs the JAX golden")
    print(f"[lm_serve] Llama-3.2-1B widths, {C.SERVE_LAYERS} layers, f32: "
          f"card vs CPU max abs err {err:.3g} over {cl.size} logits, greedy "
          f"tokens {'equal' if np.array_equal(ct, pt) else 'DIFFERENT'}; "
          f"both vs the JAX golden max abs err {gerr:.3g} (rtol {rtol}, "
          f"atol {atol}), tokens {ct.tolist()}")
    return bad


def lm_archs_card_vs_cpu(dev, rng):
    """The nine other archs at reduced_config, f32: the card's prefill and
    LM_ARCH_STEPS teacher-forced decode steps against the port's on the
    CPU, on the same weights and inputs."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.models.lm import model as M

    rtol, atol = LM_SERVE_TOL
    bad = []
    for arch in sorted(ARCHS):
        if arch == "llama3.2-1b":
            continue
        cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
        params, _ = M.init_params(cfg, 0, device="cpu")
        s = 8 + LM_ARCH_STEPS
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, s)))
        extra, off = {}, 0
        if cfg.family == "vlm":
            extra["embeds"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.frontend_len, cfg.d_model)).astype("float32"))
            off = cfg.frontend_len
        if cfg.family in ("encdec", "audio"):
            extra["enc_inputs"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.frontend_len, cfg.d_model)).astype("float32"))
        outs = {}
        for where in (dev.type, "cpu"):
            p = M.tree_map(lambda t: t.to(where), params)
            kw = {k: v.to(where) for k, v in extra.items()}
            tok = tokens.to(where)
            with torch.inference_mode():
                logits, cache = M.prefill(p, cfg, tok[:, :8],
                                          max_len=off + s, **kw)
                steps = [logits[:, 0].cpu()]
                for t in range(8, s):
                    logits, cache = M.decode_step(p, cfg, tok[:, t:t + 1],
                                                  cache, off + t)
                    steps.append(logits[:, 0].cpu())
            outs[where] = torch.stack(steps).numpy()
        err = float(np.abs(outs[dev.type] - outs["cpu"]).max())
        ok = np.allclose(outs[dev.type], outs["cpu"], rtol, atol)
        print(f"[lm_serve] {arch} reduced f32: prefill + {LM_ARCH_STEPS} "
              f"decode steps, card vs CPU max abs err {err:.3g} "
              f"({'ok' if ok else 'OUT OF TOLERANCE'})")
        if not ok:
            bad.append(f"{arch} card vs CPU {err:.3g}")
    return bad


def lm_fullwidth_recurrent(dev, rng, card):
    """LM_FULL_ARCHS at their published widths and depths in f32 (TF32
    off): prefill of 2 x 8 tokens and LM_FULL_STEPS greedy decode steps on
    the card, every logit finite; the prefill and the first decode step
    (fed the card's token) held against the port on the CPU, on the same
    weights. Also the card's decode ms a step at 2 slots."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.lm import model as M

    rtol, atol = LM_SERVE_TOL
    bad = []
    for arch in LM_FULL_ARCHS:
        cfg = dataclasses.replace(get_config(arch), dtype="float32")
        params, _ = M.init_params(cfg, 0, device=dev)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)))
        max_len = 8 + LM_FULL_STEPS
        with torch.inference_mode():
            logits, cache = M.prefill(params, cfg, tokens.to(dev),
                                      max_len=max_len)
            card_steps = [logits[:, 0].cpu()]
            toks = [torch.argmax(logits[:, 0], -1)]
            for t in range(LM_FULL_STEPS):
                logits, cache = M.decode_step(params, cfg, toks[-1][:, None],
                                              cache, 8 + t)
                card_steps.append(logits[:, 0].cpu())
                toks.append(torch.argmax(logits[:, 0], -1))
            tok = toks[-1][:, None]
            dec_ms = time_ms(lambda: M.decode_step(params, cfg, tok, cache,
                                                   max_len - 1), reps=5)
            n_params = sum(t.numel() for t in _leaves(params))
            cpu = M.tree_map(lambda t: t.cpu(), params)
            del params, cache
            logits, cache = M.prefill(cpu, cfg, tokens, max_len=max_len)
            cpu_steps = [logits[:, 0]]
            logits, _ = M.decode_step(cpu, cfg, toks[0][:, None].cpu(),
                                      cache, 8)
            cpu_steps.append(logits[:, 0])
            del cpu, cache
        card_lg = torch.stack(card_steps).numpy()
        got, want = card_lg[:2], torch.stack(cpu_steps).numpy()
        err = float(np.abs(got - want).max())
        finite = bool(np.isfinite(card_lg[..., :cfg.vocab]).all())
        ok = finite and np.allclose(got, want, rtol, atol)
        print(f"[lm_serve] {arch} full width ({cfg.n_layers} layers, "
              f"d_model {cfg.d_model}, {n_params / 1e9:.4f} B parameters) "
              f"f32: prefill 2 x 8 + {LM_FULL_STEPS} decode steps on the "
              f"card, logits finite {finite}; prefill and first step card "
              f"vs CPU max abs err {err:.3g} (rtol {rtol}, atol {atol}, "
              f"{'ok' if ok else 'OUT OF TOLERANCE'}); decode step (2 "
              f"slots, f32) {dec_ms:.4f} ms; {card}")
        if not ok:
            bad.append(f"{arch} full width: finite {finite}, card vs CPU "
                       f"{err:.3g}")
        torch.cuda.empty_cache()
    return bad


def phase_lm_serve(card):
    """LM serving on the card: the CLI at its defaults on full-width
    Llama-3.2-1B, the Engine's properties in bf16, W8, W4 and with the
    int8 KV cache, the cache path against forward_train, the card against
    the CPU and the JAX golden, the nine other archs, and no K2-K6 launch."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels import ops as K
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.lm import model as M

    t_phase = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(27)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    out = serve_cli.main(["--arch", "llama3.2-1b"])
    cfg, done = out["cfg"], out["done"]
    bad = []
    if sorted(done) != list(range(8)) or any(
            len(t) != 16 or not all(0 <= x < cfg.vocab for x in t)
            for t in done.values()):
        bad.append("CLI: not 8 requests of 16 in-range tokens")
    print(f"[lm_serve] CLI at its defaults ({cfg.name}: {cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} kv, d_ff {cfg.d_ff}, vocab {cfg.vocab} padded "
          f"to {M.padded_vocab(cfg)}, {cfg.dtype}): {len(done)} requests, "
          f"{sum(map(len, done.values()))} tokens in {out['seconds']:.3f} s, "
          f"{out['tok_per_s']:.1f} tok/s (the first batch pays the first "
          f"calls); {card}")
    bf16 = out["params"]
    variants = [("bf16", cfg, bf16),
                ("int8 KV", dataclasses.replace(cfg, kv_bits=8), bf16)]
    for bits in (8, 4):
        qcfg = dataclasses.replace(cfg, quant_bits=bits)
        variants.append((f"W{bits}", qcfg,
                         M.init_params(qcfg, 0, device=dev)[0]))
    for tag, vcfg, params in variants:
        bad += lm_engine_checks(tag, vcfg, params, rng)
        dec_ms, tok, cache = lm_times(tag, vcfg, params, card)
        if tag == "bf16":
            lm_decode_profile(vcfg, params, tok, cache)
        del cache
    del variants, bf16, params, out
    bad += lm_cache_vs_forward(cfg, dev, rng)
    bad += lm_golden_checks(dev)
    bad += lm_archs_card_vs_cpu(dev, rng)
    bad += lm_fullwidth_recurrent(dev, rng, card)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    print(f"[lm_serve] K2-K6 launches on the LM serving path: {counts} "
          f"(must all be 0: the JAX LM dequantizes and multiplies, and "
          f"attends over the dequantized cache)")
    if any(counts.values()):
        bad.append(f"kernel launches {counts}")
    print(f"[lm_serve] peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
          f"GiB; phase {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    if bad:
        raise SystemExit(f"[lm_serve] failed: {'; '.join(bad)}")


LM_TRAIN_LAYERS = 2  # the card-vs-CPU step at Llama-3.2-1B's widths, f32
LM_TRAIN_BATCH = (2, 32)  # its batch x seq, and the nine archs'
LM_TRAIN_STEPS = 6  # the driver's full-depth bf16 run ...
LM_TRAIN_STOP = 3  # ... stopped by SIGTERM after this step, then resumed
LM_TRAIN_REPS = 6  # timed steps (median), after 3 warm-ups (`time_ms`)
LM_TRAIN_CKPT = os.path.join(OUT_DIR, "lm_train_ckpt")


def lm_train_sides(cfg, params, batch, dev, opt_cfg):
    """One `make_train_step` step and the loss's gradients on the CPU and
    on `dev` from the same params (CPU tensors) and numpy batch: the two
    sides as `train/parity.lm_step_errors` reads them."""
    import torch

    from repro_torch.models.layers import exact_f32
    from repro_torch.models.lm import model as M
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import make_train_step, value_and_grad

    sides = {}
    for where in ("cpu", dev):
        p = M.tree_map(lambda t: t.to(where), params)
        b = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
        b["tokens"] = b["tokens"].long()
        new_p, state, metrics = make_train_step(cfg, opt_cfg)(
            p, O.init_state(p), b)
        with exact_f32():
            _, _, grads = value_and_grad(
                lambda q, bb: M.loss_fn(q, cfg, bb), p, b)
        sides[str(where)] = dict(
            loss=metrics["loss"], grad_norm=metrics["grad_norm"],
            lr=metrics["lr"], grads=grads, params=new_p, m=state.m,
            v=state.v)
        del p, b
    return sides["cpu"], sides[str(dev)]


def lm_train_batch(cfg, rng):
    """A numpy batch of LM_TRAIN_BATCH tokens (and the modality stub's
    inputs) for `cfg`."""
    b, s = LM_TRAIN_BATCH
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype("int32")}
    if cfg.family == "vlm":
        batch["embeds"] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.d_model)).astype("float32")
    if cfg.family in ("encdec", "audio"):
        batch["enc_inputs"] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.d_model)).astype("float32")
    return batch


def lm_train_card_vs_cpu(dev, rng, card):
    """One f32 train step on the card against the CPU, under the CPU
    tests' bounds (`train/parity.py`'s LM_*): Llama-3.2-1B at its published
    widths cut to LM_TRAIN_LAYERS layers, then the nine other archs at
    `reduced_config`."""
    import dataclasses

    from repro_torch.configs import ARCHS, get_config, reduced_config
    from repro_torch.models.lm import model as M
    from repro_torch.train import optimizer as O
    from repro_torch.train import parity as PP

    opt_cfg = O.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    full = dataclasses.replace(get_config("llama3.2-1b"), dtype="float32",
                               n_layers=LM_TRAIN_LAYERS)
    cases = [("llama3.2-1b full width", full)] + [
        (f"{a} reduced", dataclasses.replace(reduced_config(a),
                                             dtype="float32"))
        for a in sorted(ARCHS) if a != "llama3.2-1b"]
    bad = []
    for tag, cfg in cases:
        t0 = time.perf_counter()
        params, _ = M.init_params(cfg, 0, device="cpu")
        want, got = lm_train_sides(cfg, params, lm_train_batch(cfg, rng),
                                   dev, opt_cfg)
        err = PP.lm_step_errors(params, want, got, opt_cfg, device=dev)
        fails = PP.lm_step_failures(
            err, params_sure=PP.LM_PARAM_SURE_CARD)
        print(f"[lm_train] {tag} f32 ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, vocab {cfg.vocab}), one step card vs CPU: "
              f"loss rel {err['loss']:.3g}, grad_norm rel "
              f"{err['grad_norm']:.3g}, lr abs {err['lr']:.3g}, gradients "
              f"{err['grads']:.3g} ({err['worst_grad']}), moments "
              f"{err['moments']:.3g} ({err['worst_moment']}), params "
              f"{err['params_sure']:.3g} lr where sure (share "
              f"{err['sure_share']:.4f}), {err['params']:.3g} lr at most; "
              f"{'ok' if not fails else 'FAILED ' + '; '.join(fails)} "
              f"({time.perf_counter() - t0:.1f} s)")
        if fails:
            bad.append(f"{tag}: {'; '.join(fails)}")
        del params, want, got
    return bad


def _ckpt_compare(a_dir, b_dir, n_exact: int):
    """(same step, the first `n_exact` stored leaves equal bit for bit, the
    rest equal in size and CRC-32, bytes compared) of the newest
    checkpoints in two directories. The leaves are stored in the tree's
    order, so a (params, opt_state) checkpoint's parameters come first;
    reading back the 10 GB of AdamW moments twice more would double the
    phase, so their stored CRC-32s stand in for them."""
    import zipfile

    import numpy as np

    from repro_torch.train import checkpoint as CKPT

    steps = [CKPT.latest_step(d) for d in (a_dir, b_dir)]
    paths = [os.path.join(d, f"step_{s:08d}", "arrays.npz")
             for d, s in zip((a_dir, b_dir), steps)]
    infos = []
    for path in paths:
        with zipfile.ZipFile(path) as z:
            infos.append({i.filename: (i.file_size, i.CRC)
                          for i in z.infolist()})
    crc_same = infos[0] == infos[1]
    nbytes = 0
    with np.load(paths[0]) as za, np.load(paths[1]) as zb:
        exact = True
        for i in range(n_exact):
            x, y = za[f"a{i}"], zb[f"a{i}"]
            exact &= x.dtype == y.dtype and np.array_equal(x, y)
            nbytes += x.nbytes
    return steps, exact, crc_same, nbytes, len(infos[0])


def lm_train_driver(card):
    """`launch/train.main` on full-depth bf16 Llama-3.2-1B at its defaults
    (batch 8 x seq 128) for LM_TRAIN_STEPS steps; then again, stopped by a
    SIGTERM as it draws the batch of step LM_TRAIN_STOP (the drain
    checkpoints after that step), and `--resume`d to the end: losses and
    the final checkpoint's params bitwise the straight run's, its AdamW
    moments by size and CRC-32 (`_ckpt_compare`). Returns (failures, peak
    GiB)."""
    import shutil
    import signal

    import numpy as np
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.launch import train as train_cli
    from repro_torch.models.lm import model as M
    from repro_torch.train import tree as T

    shutil.rmtree(LM_TRAIN_CKPT, ignore_errors=True)
    base = ["--steps", str(LM_TRAIN_STEPS), "--log-every", "1",
            "--device", "cuda"]
    a_dir, b_dir = (os.path.join(LM_TRAIN_CKPT, d) for d in "ab")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    straight = train_cli.main(base + ["--ckpt-dir", a_dir])
    t_straight = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    real = train_cli.lm_stream

    def preempted(cfg, start_step=0):
        for i, b in enumerate(real(cfg, start_step), start_step):
            if i == LM_TRAIN_STOP - 1:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    train_cli.lm_stream = preempted
    try:
        first = train_cli.main(base + ["--ckpt-dir", b_dir])
    finally:
        train_cli.lm_stream = real
    rest = train_cli.main(base + ["--ckpt-dir", b_dir, "--resume"])
    t_all = time.perf_counter() - t0
    n_params = len(T.leaves(M.init_params(reduced_config("llama3.2-1b"), 0,
                                          device="cpu")[0]))
    steps, exact, crc_same, nbytes, n_leaves = _ckpt_compare(
        a_dir, b_dir, n_params + 1)
    shutil.rmtree(LM_TRAIN_CKPT, ignore_errors=True)
    finite = bool(np.isfinite(straight).all())
    same = steps == [LM_TRAIN_STEPS] * 2 and exact and crc_same
    print(f"[lm_train] launch/train.py, Llama-3.2-1B full depth bf16, batch "
          f"8 x seq 128: losses {' '.join(f'{x:.4f}' for x in straight)} "
          f"(finite {finite}); stopped by SIGTERM after "
          f"{len(first)} steps and resumed for {len(rest)}: losses equal "
          f"{first + rest == straight}; final checkpoints ({n_leaves} "
          f"leaves): the params and step bitwise equal {exact} "
          f"({nbytes / 1e9:.3f} GB compared), every leaf's size and "
          f"CRC-32 equal {crc_same}; straight run {t_straight:.1f} s, all "
          f"three {t_all:.1f} s; peak {peak:.3f} GiB; {card}")
    bad = []
    if not finite:
        bad.append("driver losses not finite")
    if first + rest != straight or not same:
        bad.append("restart not bitwise")
    return bad, peak


def lm_train_bounds(cfg, b: int, s: int):
    """(matmul TFLOP a step, its ms at the bf16 peak, optimizer GB a step,
    its ms at the HBM rate) of a train step of `cfg` on b x s tokens: 6
    flops a token per linear weight (forward, two backward products) and
    the tied head, plus attention's two S x S products three times over
    (the port computes the whole square, then masks it); AdamW reads
    params, grads, m and v and writes params, m and v once (bf16 params
    and grads, f32 moments). The optimizer waits for every gradient, so
    the step takes at least the two times' sum."""
    from repro_torch.models.lm import model as M

    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    lin = L * (d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
               + 3 * d * cfg.d_ff)
    head = M.padded_vocab(cfg) * d
    tokens = b * s
    attn = 3 * L * b * cfg.n_heads * s * s * hd * 2 * 2
    flops = 6 * tokens * (lin + head) + attn
    n_params = lin + head + L * 2 * d + d
    opt_bytes = n_params * (2 + 2 + 2 + 4 * 4)
    return (flops / 1e12, flops / BF16_FLOPS_PER_S * 1e3, opt_bytes / 1e9,
            opt_bytes / HBM_BYTES_PER_S * 1e3)


def lm_train_times(card):
    """The driver's step at its defaults, timed outside it: median ms of
    LM_TRAIN_REPS steps, tokens/s, and the step's two halves alone (the
    loss's forward and backward, AdamW); the device busy share and
    intervals of one step under torch.profiler; the `--grad-compress`
    step's ms; beside the bounds."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, lm_batch
    from repro_torch.models.layers import exact_f32
    from repro_torch.models.lm import model as M
    from repro_torch.train import grad_compress as GC
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import make_train_step, value_and_grad

    cfg = get_config("llama3.2-1b")
    b, s = 8, 128
    dev = torch.device("cuda", torch.cuda.current_device())
    params, _ = M.init_params(cfg, 0, device=dev)
    opt_cfg = O.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    batch = {"tokens": torch.from_numpy(lm_batch(DataConfig(
        seed=0, vocab=cfg.vocab, seq_len=s, global_batch=b), 0)["tokens"]
    ).to(dev).long()}
    state = O.init_state(params)
    step = make_train_step(cfg, opt_cfg)
    all_ms = []
    ms = time_ms(lambda: step(params, state, batch), LM_TRAIN_REPS,
                 samples=all_ms)
    prof = profile_steps(lambda: step(params, state, batch))

    def grads_of():
        with exact_f32():
            return value_and_grad(lambda q, bb: M.loss_fn(q, cfg, bb),
                                  params, batch)[2]

    half = LM_TRAIN_REPS // 2
    grads_ms = time_ms(grads_of, half)
    grads = grads_of()
    with torch.no_grad():
        adamw_ms = time_ms(
            lambda: O.apply_updates(params, grads, state, opt_cfg), half)
    del grads
    step = make_train_step(cfg, opt_cfg, compress=True)
    err = GC.init_error(params)
    compress_ms = time_ms(lambda: step(params, state, batch, err),
                          LM_TRAIN_REPS)
    del step, err, params, state, batch
    torch.cuda.empty_cache()
    tflop, flop_ms, opt_gb, opt_ms = lm_train_bounds(cfg, b, s)
    print(f"[lm_train] {card}: Llama-3.2-1B full depth bf16 train step, "
          f"batch {b} x seq {s} ({b * s} tokens): {ms:.4f} ms (median of "
          f"{LM_TRAIN_REPS} after 3 warm-ups, CUDA events around each step "
          f"as the host calls it; all "
          f"{' '.join(f'{t:.3f}' for t in all_ms)}), "
          f"{b * s / ms * 1e3:.1f} tokens/s; alone, the loss's forward and "
          f"backward {grads_ms:.4f} ms and AdamW {adamw_ms:.4f} ms (median "
          f"of {half}); --grad-compress step {compress_ms:.4f} ms; bounds: "
          f"{tflop:.3f} TFLOP of matmul = {flop_ms:.4f} ms at 989 TFLOP/s, "
          f"AdamW {opt_gb:.3f} GB = {opt_ms:.4f} ms at 3.35 TB/s; the step "
          f"at least {flop_ms + opt_ms:.4f} ms")
    if prof is None:
        print("[lm_train] torch.profiler reported no device time: busy "
              "share not measured")
    else:
        print(f"[lm_train] one step under torch.profiler: wall "
              f"{prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} "
              f"ms (share {prof['busy_ms'] / prof['wall_ms']:.4f}; of the "
              f"unprofiled step {prof['busy_ms'] / ms:.4f}), "
              f"{prof['intervals']:.0f} device intervals; by family "
              f"{prof['families']} (cuBLAS's Hopper GEMMs, `nvjet_*`, "
              f"count as other); top {prof['top']}")


def phase_lm_train(card):
    """LM training on the card: one f32 step card against CPU at
    Llama-3.2-1B's widths (2 layers) and on the nine other archs, the
    training driver on full-depth bf16 Llama-3.2-1B with a SIGTERM-stopped
    run resumed bitwise, the step's times and profile, and no K2-K6
    launch."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops as K

    t_phase = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    K.reset_launch_counts()
    bad = lm_train_card_vs_cpu(dev, np.random.default_rng(28), card)
    torch.cuda.empty_cache()
    more, peak = lm_train_driver(card)
    bad += more
    torch.cuda.empty_cache()
    lm_train_times(card)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    print(f"[lm_train] K2-K6 launches on the LM training path: {counts} "
          f"(must all be 0: the JAX LM trains through no Pallas kernel)")
    if any(counts.values()):
        bad.append(f"kernel launches {counts}")
    print(f"[lm_train] peak memory of the driver's run {peak:.3f} GiB; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    if bad:
        raise SystemExit(f"[lm_train] failed: {'; '.join(bad)}")


def busy_ms(events) -> float:
    """Length of the union of the device-side intervals (kernels, copies,
    memsets) among a profile's events, in ms. The CPU ops' rows also carry
    the device time of what they launched, so adding up every row would
    count it twice."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    total, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total / 1e3


def profile(eng, imgs):
    """Device busy share and the heaviest kernels over 32 micro-batches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    for i in range(256):
        eng.submit(imgs[i % len(imgs)])
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [(evt.self_device_time_total / 1e3, evt.count, evt.key)
           for evt in prof.key_averages()
           if evt.device_type == DeviceType.CUDA]
    busy = busy_ms(prof.events())
    if not dev or busy <= 0:
        print("[profile] torch.profiler reported no device time: busy share "
              "not measured")
        return
    print(f"[profile] 256 requests, buckets 1/2/4/8, under torch.profiler: "
          f"wall {wall_ms:.3f} ms, device busy {busy:.3f} ms (union of "
          f"{sum(n for _, n, _ in dev)} device intervals, which add up to "
          f"{sum(d for d, _, _ in dev):.3f} ms), busy share "
          f"{busy / wall_ms:.4f}")
    for d, n, key in sorted(dev, reverse=True)[:10]:
        print(f"[profile]   {d:9.3f} ms {n:5d}x  {key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.core import cu
    from repro_torch.core.qnet import load_qnet
    from repro_torch.kernels import _build

    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("TF32 matmuls are on: f32 accumulation not exact")
    torch.backends.cudnn.allow_tf32 = False  # the library_ms yardstick

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] {len(built)} of {len(_build.sources())} sources "
          f"compiled, one nvcc each in parallel: "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in sorted(built.items()):
        for line in log.splitlines():
            if "Used" in line or ("spill" in line and " 0 bytes spill" not in
                                  line):
                print(f"  {name}: {line.strip()}")

    fix = dict(np.load(FIXTURE + ".npz"))
    imgs = images()
    nets = []
    for net, (base, hw) in FLEET.items():
        pq = cu.prepare_qnet(load_qnet(base + ".qnet"), device="cuda")
        nets.append((net, pq, torch.from_numpy(images(hw)).to(pq.device)))
    rows = phase_kernels(nets)
    del nets
    phase_serve(imgs, fix)
    phase_throughput(imgs, card)
    lm_rows, lm_launches = phase_lm(card)  # the LM entry points' counts
    phase_lm_serve(card)
    phase_lm_train(card)
    phase_stream(card)
    phase_fixed_point(imgs, card)
    launches = phase_fleet(card)  # the serving path: both nets
    phase_replicas(card)
    phase_dryrun(card)
    phase_tune(card)
    phase_precision(card)
    phase_train(card, torch.device("cuda", torch.cuda.current_device()))
    rows.update(lm_rows)
    launches.update({name: lm_launches[name] for name in lm_rows})

    kernels = []
    for name, r in rows.items():
        source, replaces = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"],
            "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"]
            else "operations",
            "library_ms": r["lib_ms"] if r["has_lib"] else None,
            "device_ms": r["dev_ms"],
            "library_device_ms": r["lib_dev_ms"] if r["has_lib"] else None,
            **({"cold_device_ms": r["cold_dev_ms"]} if "cold_dev_ms" in r
               else {})})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
