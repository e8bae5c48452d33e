#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare OTHER/src   # digests and times of another tree

Phases, each of which exits non-zero on failure:

1. device  - require CUDA; print the card's name and power limit as
             ``nvidia-smi`` gives them.
2. build   - compile every kernel of the port from ``src/`` with ``nvcc``,
             all at once, and print the build seconds and ptxas' report.
3. kernels - hold each kernel against its plain PyTorch version on the
             card, at full width and the shapes its path gives it (within
             1e-4 abs + 1e-4 rel); check that two launches are
             bit-identical, that a row's Q ignores the other rows, and that
             a prefix of the rows run alone (another tile) gives the same
             bits; for
             ``packed_qnet_stacked`` also that dead workers' zero planes
             evaluate like zero input without touching live workers, that
             its packed and dense loaders agree bit for bit, and that each
             worker's Q equals ``fused_qnet``'s on its densified rows; for
             ``stacked_adam`` (the learner's fused Adam) that it equals its
             plain version bit for bit at odd leaf sizes, a gradient of row
             stride 0, no clip, and 512 workers x 2,693,825 parameters with
             the clip biting on half the rows; for ``leaf_adam`` (the LM
             step's in-place Adam) that it equals its plain version (with
             the kernel's f64 norm) bit for bit over mixed bf16 / f32 leaves
             of odd sizes, the clip biting and idle, zero gradients, weight
             decay, unaligned leaves and 150 leaves, ``optim/adam.py``'s
             step where the clip is idle, and at moonlight.train8k's 2.78 B
             leaves (a rerun bit-identical; the norm's gap to
             ``global_norm``); time the kernel, the plain version and a
             library yardstick (for ``leaf_adam``, ``optim/adam.py``'s
             update + apply_updates) with CUDA events beside the card's
             bound for the same work.
4. serve   - the serving path: ``repro_torch.launch.serve_molopt`` on the
             GPU at full width (8 slots, 32 requests, deadlines, poisoned
             requests, a seeded FaultPlan).  Every request must end
             terminal, every Q dispatch must be one ``fused_qnet`` launch,
             a rerun must be bit-identical, and the same stream at
             epsilon = 1 must give the CPU run's results bit for bit.
5. train   - the training path: ``DistributedTrainer`` on the GPU at the
             launcher's defaults (4 workers x 4 molecules of the
             antioxidant train split, rollout fleet, packed acting and
             learner, 4 updates of 32 per episode) for 3 episodes.  Every
             fleet Q dispatch must be one ``packed_qnet_stacked`` launch,
             losses and rewards finite, a rerun bit-identical, an
             epsilon = 1 run's transitions and rewards equal to the CPU
             run's (losses within 1e-4 rel), the acting, rollout and
             learner modes bit-identical to one another, and a run under
             a seeded FaultPlan bit-identical to its fault-free twin.
5a. mesh   - the sharded trainer (``launch/mesh.py``) on a pool of ``cuda``
             repeated: the driver's machine has one card, so every shard
             shares it.  First ``packed_qnet_stacked`` launched per shard on
             contiguous ``[W_local, ...]`` slices of a W = 8 fleet (W_local
             1, 2 and 4, an all-dead shard of zero planes included) must
             give the unsharded launch's bits.  Then the launcher-default
             fleet (4 workers x 4 molecules, full-width Q net, fleet
             rollout, packed acting and learner, ``OracleService``,
             epsilon 0.05) for 3 episodes at nd = 1, 2 and 4: transitions,
             reward and loss logs and every parameter bit identical across
             nd, ``packed_qnet_stacked`` launches == nd x fleet Q
             dispatches, 0 shape events after the warmup episode, env
             steps/s and updates/s per nd (the sharding's overhead, not a
             speedup).  A ragged W = 6 at nd = 4 (W_pad 8, two dead slots)
             in both sync modes equal to its unpadded nd = 1 run on the
             live rows, and the episode-mode run's ``state_dict`` after
             episode 1 restored into a fresh nd = 4 trainer ends
             bit-identical on every key.  Last, the learner's stacked step
             at the paper's widths and B 32 x C 64, where nd changes how
             many rows share one batched product: every run length from
             ``_MIN_RUN`` to ``_chunk_rows`` gives each row the bits it has
             in a run of ``_chunk_rows``, and fleets of W = 6, 64 and 300
             (runs of 6, 64 and 100 at nd = 1; 2 (padded), 16 and 75 at
             nd = 4) take two updates bit-identical across nd.
6. train_rl - the paper's launcher path (``repro_torch.launch.train --mode
             rl``) on the GPU: ``ensure_trained`` trains Alfabet-S and
             AIMNet-S at 1500 steps each into a fresh cache under
             ``build/`` (held-out relative error < 0.05 for both), the
             trained models on the card and on the CPU agree within 1e-5
             relative on the held-out molecules, one predictor batch of 16
             and of 64 rows is timed; ``DistributedTrainer`` at the
             launcher's defaults runs 4 episodes on the trained
             ``PropertyService``, checkpointing every episode, and a fresh
             trainer restored at episode 2 ends bit-identical to it on
             every ``state_dict`` key; ``greedy_optimize`` scores the
             general model on the 16 training molecules (OFR);
             ``serve_molopt --trained`` serves the serve phase's stream.
             Every fleet Q dispatch is one ``packed_qnet_stacked`` launch
             and every greedy or serving Q dispatch one ``fused_qnet``
             launch.
9. pipeline - run right after train_rl, on its general model, its trained
             ``PropertyService`` and its predictor cache: the paper's §3.5
             pipeline and the truth run.  ``fine_tune`` of the worst of 8
             unseen test molecules after greedy scoring, at full Q width
             (15 episodes, batches of 16 x 32): one ``fused_qnet`` launch
             per Q dispatch, a bit-identical rerun, the general agent
             unchanged bit for bit, and an epsilon = 1 run on the card
             within 1e-4 abs + 1e-4 rel of the CPU run's parameters; the
             greedy reward before and after.  ``filter_molecules`` over
             the greedy records, with the oracle ("DFT") BDE and IP of
             each survivor.  ``repro_torch.launch.verify`` at the
             launcher's width (4 x 4 workers, hidden 1024,512,128,32,
             256 candidates): straight in process (one
             ``packed_qnet_stacked`` launch per fleet dispatch, 0 shape
             events after warmup), ``--kill-at 2`` in a fresh process that
             must die by SIGKILL then ``--resume`` in another, and
             ``--faults predict,chem``: both reports bit-identical to the
             straight run's.  The Q kernels at the truth run's default and
             the examples' shallower widths (padded to five layers) against
             their plain versions (1e-4).  The quickstart twin on the
             trained cache: Q dispatches == fleet steps == launches.
7. lm_kernels - ``flash_attention`` and ``ssd_scan`` against their plain
             versions (``attention_ref``; ``ssd_ref``, the naive recurrence,
             and the model's ``ssd_chunked``) at the prefill shapes of
             zamba2-1.2b (both kernels) and mamba2-2.7b (the scan at
             N = 128) in bf16 and f32, at small mask, GQA/MQA and group
             shapes, at shapes that cut the bf16 attention's 128 x 64 tiles
             (ragged Sq != Sk, window and prefix edges) and the scan's
             64-row tiles (N = 128, long runs of chunks, chunks of 96 and
             512, widths without 16-byte rows), within
             ``tests/test_kernels.py``'s tolerances; two launches
             bit-identical; strided views run (the scan's x, B and C as
             views of one conv-output buffer) and a misaligned bf16
             attention view raises; kernel, plain, library
             (``scaled_dot_product_attention`` for causal attention; none
             for the scan) and bound times.  Attention also at head dim 256
             (paligemma-3b; small MQA, window and prefix shapes, and ragged
             edges) and at the new families' path shapes, bf16 and f32:
             paligemma-3b (B 2, S 2304, 8 heads over 1 kv head of 256,
             causal, prefix 256), whisper-large-v3's encoder (B 2, S 1500,
             20 heads of 64, bidirectional) and mixtral-8x22b (B 1, S 8192,
             48 heads over 8 of 128, causal, window 4096), each timed beside
             one SDPA call with its boolean mask; and granite-20b's MQA (B 1,
             S 4096, 48 heads over 1 kv head of 128, causal: the largest GQA
             ratio of any config, and granite-34b's shape) with a small MQA
             case at D 128.  ``packed_qnet`` (the W = 1
             launch of the packed kernel) against its plain version and bit
             for bit against ``fused_qnet`` on the densified rows.
8. lm      - zamba2-1.2b, then mamba2-2.7b, at full width with seeded
             random weights made on the card: the kernel route against the
             plain route in f32 (B = 1, S = 512, within 1e-3 of max
             |logits|, beside the plain route's own rounding floor); for
             zamba2-1.2b 256 decode steps through ``serve_step`` against
             the kernel-route forward in f32 (within 2e-2); the timed bf16
             prefill (B = 2, S = 4096) through ``make_prefill_step``:
             exactly 6 ``flash_attention`` and 38 ``ssd_scan`` calls per
             zamba2-1.2b forward, 64 ``ssd_scan`` calls per mamba2-2.7b
             forward, finite logits, a bit-identical rerun, tokens/s and
             each kernel's share; then ``python -m repro_torch.launch.serve``
             at its defaults must exit 0.
8a. lm_families - the moe, encdec and vlm families (and yi-34b's GQA of
             ratio 7 and granite-20b's MQA of 48 heads), each at its
             published width with seeded random
             weights made on the card, depth cut only where one card cannot
             hold the model: paligemma-3b (18 layers, B 2, 256 patches +
             2048 tokens), whisper-large-v3 (32 + 32 layers, B 2, 1500
             frames + 448 tokens), and 2 layers of mixtral-8x22b (B 1,
             S 8192: the window bites), qwen3-moe-235b-a22b, yi-34b and
             granite-20b (B 1, S 4096).  Per config: the f32 kernel route against the plain
             route at 2 layers (within 1e-3 of max |logits|, the aux loss
             alike); the bf16 prefill through ``make_prefill_step`` with
             exactly 18 / 64 / 2 / 2 / 2 / 2 ``flash_attention`` launches, finite
             logits, a bit-identical rerun, positions/s from CUDA events and
             a ``torch.profiler`` table; 8 ``serve_step`` decode steps of the
             reduced f32 config on the card against the CPU (1e-4), and for
             the moe and dense configs against the card's forward at the
             positions its capacity did not drop.

10. lm_train - the LM training step, after lm has freed its memory.  On
             the card a ``use_pallas`` loss on parameters that require grad
             raises in both kernels (reduced stablelm-1.6b: attention;
             reduced mamba2-2.7b: the scan) with no launch, and the same
             forward under ``torch.no_grad()`` launches.  The reduced
             stablelm-1.6b, zamba2-1.2b and mamba2-2.7b in f32 on the card
             and on the CPU from the same parameters and SMILES batch:
             ``loss_fn`` within 1e-5 relative and every gradient leaf within
             1e-4 of that leaf's max |g|; one ``microbatches = 2`` train
             step the same way (its loss, and its first moments, which hold
             the clipped gradient).  zamba2-1.2b at full width, bf16, remat
             on, B = 2, S = 4096 through ``make_train_step``, with
             ``torch.use_deterministic_algorithms`` on for the phase: a warm
             step and its rerun from the same state bit-identical, then 3
             timed steps (CUDA events; tokens/s, peak memory, a
             ``torch.profiler`` table of one step); the losses finite, every
             leaf's first moment finite and nonzero, every leaf changed but
             the bf16 norm scales of 1.0 (an update of lr = 1e-4 is below
             half their ulp), 0 launches of every other kernel and one
             ``leaf_adam`` launch a step (the step's Adam, in place; the
             rerun and the check clone what the step consumes).  Then
             ``python -m repro_torch.launch.train --mode lm`` at its defaults
             (stablelm-1.6b at full width, bf16, B 8, S 64, 50 steps) must
             exit 0 with a finite final loss below its first, and ``python
             -m repro_torch.examples.backbone_lm`` must exit 0.
11. dryrun - the dry-run half.  damoldqn's serve step (``make_serve_step``
             over the parameter tree) at ``qnet_batch_specs``' shape, B 256 x
             160 candidates = 40,960 rows of 2049, in one ``fused_qnet``
             launch per call: within 1e-4 abs + 1e-4 rel of ``qnet_ref``,
             a rerun bit-identical.  Its double-DQN train step
             (``make_train_step``, Adam with clip 1.0) from the same seeded
             parameters and batch (a random legal-action mask, every 16th row
             empty) on the card and on the CPU: the loss within 1e-5
             relative, the parameters after one step within 1e-4 abs + 1e-4
             rel and the step's update (p1 - p0) within 1e-3 x lr of the
             CPU's where the gradient is not near zero (a step that moved
             nothing fails), 0 kernel launches, a rerun bit-identical; the FLOPs
             ``roofline.op_walk`` counts over the step on the card equal to
             its count of the same step on ``meta``; 5 timed steps (steps/s,
             achieved FLOP/s against the f32 peak); ``fused_qnet`` at the
             40,960 rows timed beside its plain version, the addmm chain and
             the bound.  Then ``python -m repro_torch.launch.dryrun`` in
             parallel host processes that see no card, into ``build/dryrun``:
             damoldqn at every shape (``train_4k`` ok, the other three
             skipped with the reference's reasons), yi-34b at ``long_500k``
             (the window policy, under FSDP) and zamba2-1.2b at
             ``decode_32k``, each on 16 x 16 and 2 x 16 x 16: every report
             ``ok`` or ``skipped``, one line each.  The whole matrix
             (``--all --both-meshes``) needs no card and is a host run.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package ``repro``.

``--compare SRC`` runs none of the phases: it builds the kernels of the
port at SRC and prints one JSON line of sha256 digests of every Q kernel's
output on the kernels phases' seeded inputs, and the times of the Q kernels,
of bf16 ``flash_attention`` and of bf16 and f32 ``ssd_scan`` at zamba2-1.2b's
path shapes, with the scan's error against ``ssd_ref``.  Run it on two trees in
one call (parent, change, change, parent) to hold them to the same bits on
one card.
"""

from __future__ import annotations

import json
import math
import struct
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
TOL = 1e-4                      # abs and rel, as tests/test_kernels.py holds fused_qnet
SERVE_ARGS = ["--slots", "8", "--requests", "32", "--deadline-frac", "0.3",
              "--invalid-every", "8", "--faults"]
KERNEL_ROWS = (1, 5, 128, 300, 2048, 4096)
STACKED_SHAPES = ((1, 5), (3, 300), (4, 1024), (128, 32))   # workers x rows
CROSS_ROWS = (5, 128)           # a prefix of N = 2048 run on its own tile
CROSS_STACKED = 32              # a prefix of each worker's rows, likewise
TRAIN_EPISODES = 3
TRAIN_LOSS_RTOL = 1e-4          # GPU vs CPU losses: cuBLAS vs CPU BLAS sums
MESH_ND = (1, 2, 4)             # shards of the one card
MESH_EPISODES = 3               # a warmup episode, then 2 measured
MESH_RAGGED = 6                 # W = 6 pads to 8 on 4 shards
MESH_KERNEL_ROWS = 512

# the RL launcher's path (train_rl): predictors trained at the launcher's
# 1500 steps, held to the paper's envelope (tests/test_system.py:24-25);
# the trainer at the launcher's defaults for RL_EPISODES (it runs 40: cut
# for time), resumed from RL_RESUME_FROM
RL_EPISODES = 4
RL_RESUME_FROM = 2
PREDICTOR_ENVELOPE = 0.05       # rel_err_mean, BDE and IP
PREDICTOR_RTOL = 1e-5           # card vs CPU on the held-out molecules
PREDICTOR_ROWS = (16, 64)       # the fleet's batch, and DEFAULT_MAX_BATCH

# the paper's §3.5 pipeline (pipeline): examples/optimize_antioxidants.py's
# fine-tune and evaluation sizes on train_rl's general model, and the truth
# run at the launcher's Q width
FT_EPISODES = 15
FT_BATCH, FT_CANDIDATES = 16, 32
FT_TOL = 1e-4                   # card vs CPU fine-tune parameters, abs + rel
N_TEST = 8                      # unseen molecules scored for Fig. 4
VERIFY_ARGS = ["--hidden", "1024,512,128,32", "--workers", "4",
               "--mols-per-worker", "4", "--max-candidates", "256",
               "--episodes", "2", "--device", "cuda"]
VERIFY_TIMEOUT_S = 300
SHALLOW_HIDDEN = ((32,), (256, 64), (512, 128, 32))   # verify's default, the examples'
FAULT_KEYS = ("n_faults_injected", "n_retries", "n_timeouts", "n_quarantined",
              "n_chem_retries", "n_pipeline_restarts", "n_incidents")

# LM slice: zamba2-1.2b's prefill shapes, and tests/test_kernels.py's
# tolerances for the Pallas kernels (flash :20-21, :57; ssd :89-90, :102-103)
LM_ARCH = "zamba2-1.2b"
FLASH_PATH = (2, 4096, 32, 32, 64)              # B, S, H, K, D; causal
FLASH_SMALL = (                                  # B, S, H, K, D, causal, window, prefix
    (2, 256, 4, 2, 64, True, None, 0), (1, 128, 4, 4, 128, True, None, 0),
    (2, 256, 8, 1, 64, True, None, 0), (1, 512, 2, 2, 32, True, None, 0),
    (1, 256, 4, 2, 64, True, 64, 0), (1, 256, 4, 2, 64, True, None, 32),
    (1, 256, 4, 2, 64, True, 32, 16), (1, 256, 4, 2, 64, False, None, 0),
    (1, 200, 4, 2, 64, True, None, 0),
    # GQA ratios 7 (yi-34b) and 16 (qwen3-moe-235b-a22b), the second windowed
    (1, 256, 14, 2, 128, True, None, 0), (1, 256, 32, 2, 128, True, 64, 0),
    # D = 256 (paligemma-3b): MQA with a window and a prefix, MQA with a prefix
    (1, 256, 4, 1, 256, True, 64, 16), (2, 200, 8, 1, 256, True, None, 16),
    # MQA at D = 128 (granite-20b / granite-34b: 48 heads over 1 kv head)
    (1, 256, 8, 1, 128, True, None, 0))
# bf16 tiles are 128 queries x 64 keys: ragged edges, a window and a prefix
# that cut tiles, GQA with Sq != Sk
FLASH_EDGES = (                                  # B, Sq, Sk, H, K, D, causal, window, prefix
    (1, 320, 320, 4, 2, 64, True, 96, 0), (1, 384, 384, 4, 2, 64, True, None, 130),
    (2, 200, 264, 8, 2, 64, True, None, 0), (1, 320, 320, 4, 4, 128, True, 96, 0),
    (1, 264, 200, 2, 1, 32, False, None, 0),
    (1, 300, 300, 2, 1, 256, True, None, 37), (1, 130, 260, 4, 2, 256, False, None, 0))
# the attention path shapes of the LM prefills: arch, site (whisper's
# encoder and decoder self-attentions differ), B, S, H, K, D, causal,
# window, prefix, whether SDPA takes k and v as they are (enable_gqa) or
# expanded to H heads outside the timed call (at mixtral's S a GQA call
# with a mask would fall back to scores of 6.4-12.9 GB)
FLASH_PATHS = (
    (LM_ARCH, "", *FLASH_PATH, True, None, 0, True),
    ("paligemma-3b", "", 2, 2304, 8, 1, 256, True, None, 256, True),
    ("whisper-large-v3", "encoder", 2, 1500, 20, 20, 64, False, None, 0, True),
    ("whisper-large-v3", "decoder", 2, 448, 20, 20, 64, True, None, 0, True),
    ("mixtral-8x22b", "", 1, 8192, 48, 8, 128, True, 4096, 0, False),
    ("qwen3-moe-235b-a22b", "", 1, 4096, 64, 4, 128, True, None, 0, True),
    ("yi-34b", "", 1, 4096, 56, 8, 128, True, None, 0, True),
    ("granite-20b", "", 1, 4096, 48, 1, 128, True, None, 0, True))
# the path shape before the bf16 kernel moved to tensor cores (PERF.md §6)
FFMA_FLASH_MS = {"bfloat16": 5.7809, "float32": 5.8006}
# the scan at the zamba2 path shape before the chunk-parallel kernel (PERF.md §6)
PR14_SSD_MS = {("bfloat16", "zamba2-1.2b"): 3.8881, ("float32", "zamba2-1.2b"): 3.5682}
# B, L, H, P, G, N, chunk of each model's prefill scan
SSD_PATHS = {"zamba2-1.2b": (2, 4096, 64, 64, 1, 64, 256),
             "mamba2-2.7b": (2, 4096, 80, 64, 1, 128, 256)}
SSD_SMALL = ((2, 256, 4, 32, 1, 16, 64), (1, 128, 2, 64, 2, 32, 128),
             (2, 512, 8, 16, 1, 8, 128), (1, 64, 4, 16, 4, 64, 32),
             (1, 512, 8, 64, 4, 64, 256), (2, 64, 4, 16, 2, 16, 16),
             # N = 128, one and two groups; a long run of chunks; chunks cut
             # into a ragged last 64-row tile, or into 8 tiles; widths that
             # take the element loads (no 16-byte rows)
             (1, 512, 4, 64, 1, 128, 256), (2, 256, 4, 64, 2, 128, 64),
             (1, 2048, 2, 32, 1, 64, 64), (1, 192, 4, 16, 1, 16, 96),
             (1, 512, 2, 16, 1, 16, 512), (1, 40, 2, 12, 1, 20, 40))
SSD_VIEWS = (2, 512, 8, 64, 1, 128, 256)        # strided views of one xBC buffer
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOL = {"float32": 2e-4, "bfloat16": 5e-2}
# the kernel against ssd_stages, its three launches in plain PyTorch with
# the same bf16 rounding points: only summation orders differ, and in bf16
# the roundings of G and of y they flip
SSD_STAGES_TOL = {"float32": 1e-5, "bfloat16": 2e-3}
# f32 kernel route vs plain route, x max |logits|: the same f32 math in
# other summation orders (64-key tiles, a warp scan of cum), amplified over
# 38 random-weight SSM layers (2.9e-4 of max |logits| measured on an H100);
# the phase prints beside it the plain route against itself with half the
# chunk, the model's own f32 rounding floor
LM_ROUTE_TOL = 1e-3
DECODE_TOL = 2e-2               # tests/test_models.py:210
LM_DECODE = 256
PACKED_ROWS = (2048, 4096)
LM_TRAIN_ARCHS = ("stablelm-1.6b", "zamba2-1.2b", "mamba2-2.7b")  # reduced, card vs CPU
LM_TRAIN = (2, 4096)            # B, S of the full-width steps: train_4k's length
LM_TRAIN_STEPS = 3
LM_LOSS_RTOL = 1e-5             # card vs CPU, f32
LM_GRAD_TOL = 1e-4              # of each gradient leaf's max |g|
LM_TRAIN_TIMEOUT_S = 600
# the LM cells of the lm and lm_families phases, each config at its
# published width, depth cut only where one card cannot hold it: arch;
# decoder (and encoder) layers of the bf16 prefill (None: all), its B and
# text tokens (B 2 x 4096: the train_4k length; whisper's 448: its target
# length); layers of the f32 route parity (None: all), its B and text
# tokens (mixtral's window bites at 8192)
LM_CELLS = {
    "lm": (("zamba2-1.2b", None, 2, 4096, None, 1, 512),
           ("mamba2-2.7b", None, 2, 4096, None, 1, 512)),
    "lm_families": (("paligemma-3b", None, 2, 2048, 2, 1, 256),
                    ("whisper-large-v3", None, 2, 448, 2, 1, 448),
                    ("mixtral-8x22b", 2, 1, 8192, 2, 1, 8192),
                    ("qwen3-moe-235b-a22b", 2, 1, 4096, 2, 1, 512),
                    ("yi-34b", 2, 1, 4096, 2, 1, 512),
                    ("granite-20b", 2, 1, 4096, 2, 1, 512))}
REDUCED_DECODE = 8              # steps of each reduced config, card vs CPU
REDUCED_DECODE_TOL = 1e-4       # abs + rel, f32

# the dry-run half (dryrun): damoldqn's steps at launch/specs.qnet_batch_specs'
# shape (train_4k's global batch of 256 x its 160 candidates), card vs CPU,
# and the dry-run launcher on the host (no card), each run one process
QNET_BATCH, QNET_CANDIDATES = 256, 160
QNET_STEP_TOL = 1e-4            # parameters after one step, card vs CPU, abs + rel
QNET_LR = 1e-4                  # launch/steps.make_optimizer's Adam
QNET_UPDATE_TOL = 1e-3          # x lr: the step's update (p1 - p0), card vs CPU, where
QNET_UPDATE_MASK = 1e-3         # the CPU's first moment exceeds this x its leaf's max
QNET_STEPS = 5
# the launcher's policies: damoldqn's SKIP rows, yi-34b's long_500k window
# under FSDP, zamba2's decode; the whole matrix is the host run's
DRYRUN_RUNS = (["--arch", "damoldqn", "--both-meshes"],
               ["--arch", "yi-34b", "--shape", "long_500k", "--both-meshes"],
               ["--arch", "zamba2-1.2b", "--shape", "decode_32k", "--both-meshes"])
DRYRUN_TIMEOUT_S = 600

# leaf_adam at moonlight.train8k's share (PERF.md §4): the vocabulary's first
# eighth and 8 of the router's 64 experts; gradients of 1e-4 a element put the
# norm near 5.3, so the clip (1.0) bites; the kernel within 1.3 x its bound
LEAF_ADAM_VOCAB, LEAF_ADAM_EXPERTS = 20480, 8
LEAF_ADAM_G_SCALE = 1e-4
LEAF_ADAM_BOUND_X = 1.3

# dense peaks by card (NVIDIA data sheets): f32 FMA FLOP/s, HBM bytes/s,
# bf16 tensor-core FLOP/s
PEAKS = (("H100 PCIe", 51.2e12, 2.0e12, 756e12),
         ("H100 NVL", 60.0e12, 3.9e12, 835e12),
         ("H100", 66.9e12, 3.35e12, 989e12), ("H200", 66.9e12, 4.8e12, 989e12))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase_device(src: Path = SRC):
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    if not (src / "repro_torch").is_dir():
        fail(f"{src / 'repro_torch'} is missing: run from a checkout of the repo")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    peak = next(((f, b, t) for key, f, b, t in PEAKS if key in name), None)
    if peak is None:
        fail(f"no f32/HBM peak on record for {name!r}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | {name} | "
          f"{torch.cuda.device_count()} device(s) | peaks f32 "
          f"{peak[0] / 1e12} TFLOP/s, bf16 tensor {peak[2] / 1e12} TFLOP/s, "
          f"HBM {peak[1] / 1e12} TB/s", flush=True)
    return card, name, peak


def phase_build(report: bool = True) -> None:
    """Build every kernel source the tree on the path has (``--compare``
    may point at an older tree, without the newer kernels)."""
    import importlib
    import importlib.util
    names = ("fused_qnet", "packed_qnet", "flash_attention", "ssd_scan",
             "stacked_adam", "leaf_adam")
    modules = [importlib.import_module(f"repro_torch.kernels.{n}.build") for n in names
               if importlib.util.find_spec(f"repro_torch.kernels.{n}") is not None]
    builds = [m.nvcc_build() for m in modules]           # one per source
    t0 = time.perf_counter()
    for b in builds:
        b.start()
    for b in builds:
        b.wait()
    print(f"build: {len(builds)} kernel source(s) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for b in builds:
        if report and b.log.is_file():
            print(f"ptxas {b.source.name}:\n" + "\n".join(
                "  " + l for l in b.log.read_text().splitlines() if l.strip()))
    for m in modules:
        m.load()


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _fused_inputs():
    """phase_kernels' seeded inputs: full-width weights and x [n, 2049] for
    every n of KERNEL_ROWS, drawn in one numpy stream."""
    import numpy as np
    import torch
    from repro_torch.core.agent import STATE_DIM, QNetwork

    rng = np.random.default_rng(0)
    sizes = (STATE_DIM, 1024, 512, 128, 32, 1)
    layers = [(torch.from_numpy((rng.standard_normal((i, o)) * (2.0 / i) ** 0.5)
                                .astype(np.float32)),
               torch.from_numpy((0.1 * rng.standard_normal(o)).astype(np.float32)))
              for i, o in zip(sizes[:-1], sizes[1:])]
    weights = QNetwork(device="cuda", layers=layers).layers()
    xs = {}
    for n in KERNEL_ROWS:
        bits = (rng.random((n, STATE_DIM - 1)) < 0.2).astype(np.float32)
        frac = rng.integers(0, 11, (n, 1)).astype(np.float32) / 10.0
        xs[n] = torch.from_numpy(np.concatenate([bits, frac], 1)).cuda()
    return weights, xs


def phase_kernels(peak) -> list[dict]:
    import torch
    from repro_torch.kernels.fused_qnet.ops import fused_qnet
    from repro_torch.kernels.fused_qnet.ref import qnet_ref

    weights, xs = _fused_inputs()
    n_params = sum(w.numel() + b.numel() for w, b in weights)
    mac_per_row = sum(w.numel() for w, _ in weights)

    def library(x):                          # yardstick only: addmm chain
        h = x
        for li, (w, b) in enumerate(weights):
            h = torch.addmm(b, h, w)
            if li < len(weights) - 1:
                h = torch.relu_(h)
        return h[:, 0]

    rows, qs = [], {}
    for n in KERNEL_ROWS:
        x = xs[n]
        qk = qs[n] = fused_qnet(weights, x)
        qp = qnet_ref(x, weights)
        torch.cuda.synchronize()
        if qk.shape != (n,) or not bool(torch.isfinite(qk).all()):
            fail(f"fused_qnet N={n}: shape {tuple(qk.shape)} or non-finite values")
        err = (qk - qp).abs()
        max_abs = float(err.max())
        if not bool((err <= TOL + TOL * qp.abs()).all()):
            fail(f"fused_qnet N={n}: max |kernel - plain| {max_abs:.3e} "
                 f"exceeds {TOL} + {TOL}*|plain|")
        if not torch.equal(fused_qnet(weights, x), qk):
            fail(f"fused_qnet N={n}: two launches on one input differ")
        if n > 1:
            x2 = x.clone()
            x2[1::2] = 1.0 - x2[1::2]        # change every odd row
            q2 = fused_qnet(weights, x2)
            if not torch.equal(q2[0::2], qk[0::2]):
                fail(f"fused_qnet N={n}: a row's Q moved with other rows")
        reps = 20 if n >= 2048 else 50
        flops = 2.0 * n * mac_per_row
        nbytes = 4.0 * (x.numel() + n_params + n)
        t_ops, t_bytes = flops / peak[0], nbytes / peak[1]
        rows.append({
            "name": "fused_qnet", "route": "cuda",
            "source": "src/repro_torch/kernels/fused_qnet/csrc/fused_qnet.cu",
            "replaces": "src/repro/kernels/fused_qnet/fused_qnet.py:63",
            "rows": n, "launches": None, "max_abs_err": max_abs,
            "ms": cuda_ms(lambda: fused_qnet(weights, x), reps),
            "plain_ms": cuda_ms(lambda: qnet_ref(x, weights), reps),
            "library_ms": cuda_ms(lambda: library(x), reps),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
        })
        rows[-1]["kernel_ms"] = rows[-1]["ms"]
        print(f"fused_qnet N={n}: max_abs_err {max_abs:.3e} | kernel "
              f"{rows[-1]['ms']:.4f} ms, plain {rows[-1]['plain_ms']:.4f} ms, "
              f"library {rows[-1]['library_ms']:.4f} ms, bound "
              f"{rows[-1]['bound_ms']:.4f} ms", flush=True)
    # the tile depends on N (32 x 32 at N = 5 and 128, 128 x 128 for layer 1
    # at N = 2048); the sums must not
    full = xs[2048]
    for n in CROSS_ROWS:
        if not torch.equal(fused_qnet(weights, full[:n].contiguous()), qs[2048][:n]):
            fail(f"fused_qnet: the first {n} rows' Q at N={n} differs from the "
                 f"same rows at N=2048")
    print(f"fused_qnet: the first {CROSS_ROWS} rows' Q at N = {CROSS_ROWS} "
          f"bit-identical to the same rows at N = 2048", flush=True)
    return rows


def _stacked_weights(n_workers: int):
    """Full-width per-worker weights, distinct for every worker, made on
    the card from a seed."""
    import torch
    from repro_torch.core.agent import STATE_DIM
    g = torch.Generator(device="cuda").manual_seed(n_workers)
    sizes = (STATE_DIM, 1024, 512, 128, 32, 1)
    return [((torch.randn(n_workers, i, o, generator=g, device="cuda")
              * (2.0 / i) ** 0.5).contiguous(),
             (0.1 * torch.randn(n_workers, o, generator=g, device="cuda")).contiguous())
            for i, o in zip(sizes[:-1], sizes[1:])]


def _stacked_inputs(W: int, C: int):
    """phase_stacked_kernel's seeded inputs: weights, bits u8 [W, C, 256]
    with ~25% of bits set, frac [W, C]."""
    import torch
    weights = _stacked_weights(W)
    g = torch.Generator(device="cuda").manual_seed(1000 + W)
    rand_u8 = lambda: torch.randint(0, 256, (W, C, 256), generator=g,
                                    device="cuda").to(torch.uint8)
    bits = rand_u8() & rand_u8()
    frac = torch.randint(0, 11, (W, C), generator=g, device="cuda").float() / 10.0
    return weights, bits, frac


def phase_stacked_kernel(peak) -> list[dict]:
    import torch
    from repro_torch.core.packed_batch import unpack_bits
    from repro_torch.kernels.fused_qnet.ops import fused_qnet
    from repro_torch.kernels.packed_qnet.ops import (dense_qnet_stacked,
                                                     packed_qnet_stacked)
    from repro_torch.kernels.packed_qnet.ref import packed_qnet_stacked_ref

    rows = []
    for W, C in STACKED_SHAPES:
        tag = f"packed_qnet_stacked W={W} C={C}"
        weights, bits, frac = _stacked_inputs(W, C)
        qk = packed_qnet_stacked(weights, bits, frac)
        qp = packed_qnet_stacked_ref(bits, frac, weights)
        torch.cuda.synchronize()
        if qk.shape != (W, C) or not bool(torch.isfinite(qk).all()):
            fail(f"{tag}: shape {tuple(qk.shape)} or non-finite values")
        err = (qk - qp).abs()
        max_abs = float(err.max())
        if not bool((err <= TOL + TOL * qp.abs()).all()):
            fail(f"{tag}: max |kernel - plain| {max_abs:.3e} exceeds "
                 f"{TOL} + {TOL}*|plain|")
        if not torch.equal(packed_qnet_stacked(weights, bits, frac), qk):
            fail(f"{tag}: two launches on one input differ")
        if C > 1:
            b2, f2 = bits.clone(), frac.clone()
            b2[:, 1::2] ^= 0xFF                  # change every odd row
            f2[:, 1::2] = 1.0 - f2[:, 1::2]
            if not torch.equal(packed_qnet_stacked(weights, b2, f2)[:, 0::2],
                               qk[:, 0::2]):
                fail(f"{tag}: a row's Q moved with other rows")
        if C > CROSS_STACKED:                    # a 32-row tile, not 128
            c = CROSS_STACKED
            if not torch.equal(packed_qnet_stacked(
                    weights, bits[:, :c].contiguous(), frac[:, :c].contiguous()),
                    qk[:, :c]):
                fail(f"{tag}: the first {c} rows of each worker at C={c} differ "
                     f"from the same rows at C={C}")
        x = torch.cat([unpack_bits(bits), frac.unsqueeze(-1)], -1).contiguous()
        if not torch.equal(dense_qnet_stacked(weights, x), qk):
            fail(f"{tag}: the dense loader differs from the packed one")
        fused_equal = all(
            torch.equal(fused_qnet([(w[i], b[i]) for w, b in weights], x[i]), qk[i])
            for i in range(W))
        if not fused_equal:
            fail(f"{tag}: a worker's Q differs from fused_qnet on its rows")
        if W > 1:                                # worker 1 dead: zero planes
            bd, fd = bits.clone(), frac.clone()
            bd[1], fd[1] = 0, 0.0
            qd = packed_qnet_stacked(weights, bd, fd)
            live = [i for i in range(W) if i != 1]
            zero = dense_qnet_stacked(weights, torch.zeros_like(x))
            if not torch.equal(qd[live], qk[live]) or not torch.equal(qd[1], zero[1]):
                fail(f"{tag}: dead-worker rows are not zero input, or moved "
                     f"live workers")
        print(f"{tag}: max_abs_err {max_abs:.3e} | rerun, row independence, "
              f"dead workers, dense loader bit-identical | equal to fused_qnet "
              f"per worker bit for bit: {fused_equal}", flush=True)

        def library():                           # yardstick only
            h = x
            for li, (w, b) in enumerate(weights):
                h = torch.baddbmm(b.unsqueeze(1), h, w)
                if li < len(weights) - 1:
                    h = torch.relu_(h)
            return h[..., 0]

        if not bool(((library() - qp).abs() <= TOL + TOL * qp.abs()).all()):
            fail(f"{tag}: the library yardstick computes something else")
        n_params = sum(w[0].numel() + b[0].numel() for w, b in weights)
        mac_per_row = sum(w[0].numel() for w, _ in weights)
        flops = 2.0 * W * C * mac_per_row
        nbytes = bits.numel() + 4.0 * (frac.numel() + W * n_params + W * C)
        t_ops, t_bytes = flops / peak[0], nbytes / peak[1]
        reps = 20 if W * C >= 2048 else 50
        rows.append({
            "name": "packed_qnet_stacked", "route": "cuda",
            "source": "src/repro_torch/kernels/packed_qnet/csrc/packed_qnet.cu",
            "replaces": "src/repro/kernels/packed_qnet/packed_qnet.py:158",
            "workers": W, "rows": C, "launches": None, "max_abs_err": max_abs,
            "ms": cuda_ms(lambda: packed_qnet_stacked(weights, bits, frac), reps),
            "plain_ms": cuda_ms(lambda: packed_qnet_stacked_ref(bits, frac, weights),
                                reps),
            "library_ms": cuda_ms(library, reps),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            "fused_qnet_bitwise": fused_equal,
        })
        print(f"{tag}: kernel {rows[-1]['ms']:.4f} ms, plain "
              f"{rows[-1]['plain_ms']:.4f} ms, library "
              f"{rows[-1]['library_ms']:.4f} ms, bound {rows[-1]['bound_ms']:.4f} "
              f"ms ({rows[-1]['bound_by']})", flush=True)
        del weights
    return rows


def _adam_state(widths, W: int, gen):
    """Seeded stacked Adam inputs on the card: leaves ``[W, in, out]`` and
    ``[W, out]`` for each pair of ``widths``; gradients of norm ~1.6 (clip
    10 idle) on rows 0, 2, 4, ..., ~160 on odd rows (the clip bites) and 0
    on row 2 (a dead worker's); moments as after a few steps; each row's
    own step."""
    import torch
    shapes = [s for i, o in zip(widths[:-1], widths[1:]) for s in ((i, o), (o,))]
    rnd = lambda shape, scale: scale * torch.randn((W,) + shape, generator=gen,
                                                   device="cuda")
    row = torch.where(torch.arange(W, device="cuda") % 2 == 0, 1.0, 100.0)
    row[2:3] = 0.0
    n = sum(math.prod(s) for s in shapes)
    g = [rnd(s, 1.6 / n ** 0.5) * row.view((W,) + (1,) * len(s)) for s in shapes]
    p = [rnd(s, 0.05) for s in shapes]
    m = [rnd(s, 1e-3) for s in shapes]
    v = [rnd(s, 1e-3).square() for s in shapes]
    step = (torch.arange(W, device="cuda", dtype=torch.int32) % 5) + 3
    return p, g, m, v, step


def _adam_copy(p, m, v, step, rows=slice(None)):
    """Fresh copies of ``rows`` of the state a step writes."""
    return ([x[rows].clone() for x in p], [x[rows].clone() for x in m],
            [x[rows].clone() for x in v], step[rows].clone())


def _adam_equal(a, b) -> bool:
    import torch
    flat = lambda s: [*s[0], *s[1], *s[2], s[3]]
    return all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))


def phase_stacked_adam(peak) -> list[dict]:
    """``stacked_adam`` against its plain version on the card: bit for bit
    at small and odd leaf sizes (element and float4 loads), a gradient of
    row stride 0, and the paper's 512 workers x 2,693,825 parameters (the
    plain version in row slices of 64, each row being its own); a rerun
    bit-identical; kernel, plain, library and bound times at the full
    stack."""
    import torch
    from repro_torch.core.agent import STATE_DIM
    from repro_torch.kernels.stacked_adam.ops import stacked_adam
    from repro_torch.kernels.stacked_adam.ref import stacked_adam_ref

    hp = dict(lr=1e-4, b1=0.9, b2=0.999, eps=1e-8, clip=10.0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = (((STATE_DIM, 32, 16, 8, 4, 1), 3, False),
             ((9, 7, 5, 3, 1), 8, False),
             ((STATE_DIM, 32, 16, 8, 4, 1), 5, True))
    for widths, W, shared in cases:
        p, g, m, v, step = _adam_state(widths, W, gen)
        if shared:                         # one gradient for every row
            g = [x[1:2].expand_as(x) for x in g]
        a, b = _adam_copy(p, m, v, step), _adam_copy(p, m, v, step)
        stacked_adam(a[0], g, a[1], a[2], a[3], **hp)
        stacked_adam_ref(b[0], g, b[1], b[2], b[3], **hp)
        torch.cuda.synchronize()
        if not _adam_equal(a, b):
            fail(f"stacked_adam widths {widths} W={W} shared={shared}: "
                 f"kernel differs from the plain version")
    print(f"stacked_adam: {len(cases)} small cases (odd leaf sizes, row stride "
          f"0, a zero gradient, the clip biting on odd rows) bit-equal to the "
          f"plain version", flush=True)

    widths = (STATE_DIM, 1024, 512, 128, 32, 1)
    W = 512
    p, g, m, v, step = _adam_state(widths, W, gen)
    a, twice = _adam_copy(p, m, v, step), _adam_copy(p, m, v, step)
    stacked_adam(a[0], g, a[1], a[2], a[3], **hp)
    stacked_adam(twice[0], g, twice[1], twice[2], twice[3], **hp)
    torch.cuda.synchronize()
    if not _adam_equal(a, twice):
        fail("stacked_adam: two launches on one input differ")
    del twice
    for lo in range(0, W, 64):
        rows = slice(lo, lo + 64)
        b = _adam_copy(p, m, v, step, rows)
        stacked_adam_ref(b[0], [x[rows] for x in g], b[1], b[2], b[3], **hp)
        if not _adam_equal(([x[rows] for x in a[0]], [x[rows] for x in a[1]],
                            [x[rows] for x in a[2]], a[3][rows]), b):
            fail(f"stacked_adam: {W} x full width, rows {lo}-{lo + 63} differ "
                 f"from the plain version")
        del b
    print(f"stacked_adam: {W} workers x full width bit-equal to the plain "
          f"version (the clip biting on odd rows), rerun bit-identical",
          flush=True)

    def library():                         # yardstick only: no per-row clip
        torch._foreach_mul_(a[1], hp["b1"])
        torch._foreach_add_(a[1], g, alpha=1 - hp["b1"])
        torch._foreach_mul_(a[2], hp["b2"])
        torch._foreach_addcmul_(a[2], g, g, value=1 - hp["b2"])
        denom = torch._foreach_sqrt(a[2])
        torch._foreach_div_(denom, (1 - hp["b2"] ** 4) ** 0.5)
        torch._foreach_add_(denom, hp["eps"])
        torch._foreach_addcdiv_(a[0], a[1], denom,
                                value=-hp["lr"] / (1 - hp["b1"] ** 4))

    n = W * sum(x[0].numel() for x in p)
    nbytes = 4.0 * n * 8          # g for the norms, then p, g, m, v in, p, m, v out
    row = {"name": "stacked_adam", "route": "cuda",
           "source": "src/repro_torch/kernels/stacked_adam/csrc/stacked_adam.cu",
           "replaces": None, "workers": W, "params_per_worker": n // W,
           "launches": None,
           "ms": cuda_ms(lambda: stacked_adam(a[0], g, a[1], a[2], a[3], **hp),
                         10),
           "library_ms": cuda_ms(library, 5, warmup=1),
           "bound_ms": nbytes / peak[1] * 1e3, "bound_by": "bytes",
           "gbytes": nbytes / 1e9}
    del p, m, v                  # room for the plain version's temporaries
    row["plain_ms"] = cuda_ms(lambda: stacked_adam_ref(
        a[0], g, a[1], a[2], a[3], **hp), 3, warmup=1)
    print(f"stacked_adam: {W} x {n // W:,} f32: kernel {row['ms']:.4f} ms "
          f"({nbytes / row['ms'] / 1e6:.1f} GB/s), bound {row['bound_ms']:.4f} "
          f"ms (bytes), plain {row['plain_ms']:.4f} ms (all {W} rows in one "
          f"call), library "
          f"(torch._foreach_* in place, no clip) {row['library_ms']:.4f} ms",
          flush=True)
    return [row]


def _share_tree(device: str = "cuda"):
    """The leaves' shapes and types of moonlight.train8k's share of
    Moonlight-16B-A3B: 8 of its 64 routed experts, an eighth of the
    vocabulary, bf16 beside the f32 norms, router and bias."""
    import dataclasses

    from repro_torch.checkpoint.checkpoint import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.models import abstract_params

    base = get_config("moonlight-16b-a3b")
    cfg = dataclasses.replace(base, vocab=LEAF_ADAM_VOCAB, dtype="bfloat16",
                              moe=dataclasses.replace(
                                  base.moe, expert_share=(0, LEAF_ADAM_EXPERTS)))
    return [(tuple(t.shape), t.dtype) for t in tree_leaves(abstract_params(cfg))]


def _leaf_state(leaves, gen, g_scale, *, zero=(), offset=0):
    """Seeded leaf-Adam inputs on the card for ``leaves`` [(shape, dtype)]:
    parameters, gradients (``g_scale`` x N(0, 1), zero on the leaves in
    ``zero``), moments as after a few steps.  ``offset`` > 0 lays every
    tensor out at that many elements into a buffer of its own: contiguous,
    but not 16-byte aligned."""
    import torch

    def make(shape, dtype, scale, square=False):
        x = scale * torch.randn(shape, generator=gen, device="cuda")
        x = (x.square() if square else x).to(dtype)
        if offset:
            buf = torch.empty(x.numel() + offset, dtype=dtype, device="cuda")
            buf[offset:].copy_(x.reshape(-1))
            x = buf[offset:].view(shape)
        return x
    p = [make(s, d, 0.02) for s, d in leaves]
    g = [make(s, d, 0.0 if k in zero else g_scale) for k, (s, d) in enumerate(leaves)]
    m = [make(s, torch.float32, 1e-4) for s, _ in leaves]
    v = [make(s, torch.float32, 1e-4, square=True) for s, _ in leaves]
    return p, g, m, v


def phase_leaf_adam(peak) -> list[dict]:
    """``leaf_adam`` (the LM step's in-place Adam) against its plain version
    on the card, bit for bit, the plain version taking the kernel's norm
    (``norm_f64``): mixed bf16 / f32 leaves of odd sizes, the clip biting
    (one gradient zero) and idle, every gradient zero, no clip with weight
    decay, leaves that are not 16-byte aligned, 150 leaves (three tables);
    with the clip idle also ``optim/adam.py``'s ``update`` + ``apply_updates``
    bit for bit.  At the share's 2.78 B leaves: a rerun bit-identical, the
    plain version bit-equal, the norm's gap to ``global_norm``, and the
    kernel's, the bound's and the plain steps' times."""
    import numpy as np
    import torch
    from repro_torch.kernels.leaf_adam.ops import leaf_adam
    from repro_torch.kernels.leaf_adam.ref import leaf_adam_ref, norm_f64
    from repro_torch.optim.adam import (OptState, adam, apply_updates, global_norm,
                                        step_scalars)

    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cuda").manual_seed(11)
    lr = 1e-4
    _, lr_t, bc1, bc2 = step_scalars(
        torch.tensor(3, dtype=torch.int32, device="cuda"),
        lambda s: torch.tensor(lr, dtype=f32, device="cuda"), 0.9, 0.999)
    hp = dict(lr_t=lr_t, bc1=bc1, bc2=bc2, b1=0.9, b2=0.999, eps=1e-8)
    copy = lambda st: [[t.clone() for t in ts] for ts in (st[0], st[2], st[3])]
    same = lambda a, b: all(torch.equal(x, y) for xs, ys in zip(a, b)
                            for x, y in zip(xs, ys))
    odd = [((7, 3), bf), ((1,), f32), ((1000,), bf), ((5, 13, 3), f32),
           ((4099,), bf), ((2, 2, 2, 2, 3), bf), ((333, 17), f32), ((65536 + 5,), bf)]
    sizes = torch.randint(1, 3000, (150,), generator=torch.Generator().manual_seed(3))
    many = [((int(n),), bf if k % 3 else f32) for k, n in enumerate(sizes)]
    cases = (("odd sizes, clip biting, one gradient zero", odd, 1.0,
              dict(clip=1.0), (2,), 0),
             ("odd sizes, clip idle", odd, 1e-4, dict(clip=1.0), (), 0),
             ("every gradient zero", odd, 1.0, dict(clip=1.0), range(len(odd)), 0),
             ("no clip, weight decay 0.01", odd, 1.0,
              dict(clip=None, weight_decay=0.01), (), 0),
             ("not 16-byte aligned, clip biting", odd, 1.0, dict(clip=1.0), (), 1),
             ("150 leaves (3 tables), clip biting", many, 1.0, dict(clip=1.0), (5,), 0))
    for name, leaves, g_scale, kw, zero, offset in cases:
        st = _leaf_state(leaves, gen, g_scale, zero=set(zero), offset=offset)
        a, b = copy(st), copy(st)
        leaf_adam(a[0], st[1], a[1], a[2], **hp, **kw)
        leaf_adam_ref(b[0], st[1], b[1], b[2], **hp, **kw, norm=norm_f64)
        torch.cuda.synchronize()
        if not same(a, b):
            bad = [k for k, (x, y) in enumerate(zip(a[0], b[0])) if not torch.equal(x, y)]
            fail(f"leaf_adam ({name}): the kernel differs from its plain version "
                 f"(parameter leaves {bad[:10]})")
        if g_scale < 1.0:                       # the clip idle: optim/adam.py's step
            state = OptState(step=torch.tensor(3, dtype=torch.int32, device="cuda"),
                             mu=[t.clone() for t in st[2]], nu=[t.clone() for t in st[3]])
            updates, state = adam(lr, clip_norm=1.0).update(st[1], state, st[0])
            if not same(a, (apply_updates(st[0], updates), state.mu, state.nu)):
                fail(f"leaf_adam ({name}): the kernel differs from optim/adam.py's "
                     f"update + apply_updates")
    print(f"leaf_adam: {len(cases)} cases bit-equal to the plain version (the "
          f"kernel's f64 norm), the clip-idle case to optim/adam.py's update + "
          f"apply_updates", flush=True)

    # the share's leaves: state made twice from one seed (two copies fit)
    leaves = _share_tree()
    n = sum(math.prod(s) for s, _ in leaves)
    grads = _leaf_state(leaves, torch.Generator(device="cuda").manual_seed(12),
                        LEAF_ADAM_G_SCALE)[1]

    def made():
        p, _, m, v = _leaf_state(leaves, torch.Generator(device="cuda").manual_seed(13),
                                 0.0)
        return [p, m, v]
    a = made()
    leaf_adam(a[0], grads, a[1], a[2], **hp, clip=1.0)
    b = made()
    leaf_adam(b[0], grads, b[1], b[2], **hp, clip=1.0)
    torch.cuda.synchronize()
    if not same(a, b):
        fail("leaf_adam: two launches on the share's leaves differ")
    del b
    b = made()
    leaf_adam_ref(b[0], grads, b[1], b[2], **hp, clip=1.0, norm=norm_f64)
    if not same(a, b):
        fail("leaf_adam: the share's leaves differ from the plain version")
    del b
    torch_norm, own = float(global_norm(grads)), float(norm_f64(grads))
    ulps = abs(torch_norm - own) / float(np.spacing(np.float32(own)))
    print(f"leaf_adam: the share's {len(leaves)} leaves ({n:,} elements): rerun "
          f"bit-identical, bit-equal to the plain version; clip 1.0 biting (norm "
          f"{own:.9g}); optim/adam.py's global_norm {torch_norm:.9g}, "
          f"{abs(torch_norm - own) / own:.3e} relative, {ulps:.1f} f32 ulps",
          flush=True)

    nbytes = sum(math.prod(s) * (24 if d == bf else 32) for s, d in leaves)
    row = {"name": "leaf_adam", "route": "cuda",
           "source": "src/repro_torch/kernels/leaf_adam/csrc/leaf_adam.cu",
           "replaces": None, "leaves": len(leaves), "elements": n,
           "launches": None,
           "ms": cuda_ms(lambda: leaf_adam(a[0], grads, a[1], a[2], **hp, clip=1.0), 10),
           "bound_ms": nbytes / peak[1] * 1e3, "bound_by": "bytes",
           "gbytes": nbytes / 1e9}
    row["plain_ms"] = cuda_ms(lambda: leaf_adam_ref(a[0], grads, a[1], a[2], **hp,
                                                    clip=1.0), 3, warmup=1)
    opt = adam(lr, clip_norm=1.0)
    state = OptState(step=torch.tensor(3, dtype=torch.int32, device="cuda"),
                     mu=a[1], nu=a[2])

    def functional():                  # the parent's step: new moments and leaves
        updates, _ = opt.update(grads, state, a[0])
        apply_updates(a[0], updates)
    row["adam_py_ms"] = cuda_ms(functional, 3, warmup=1)
    print(f"leaf_adam: the share's leaves: kernel {row['ms']:.4f} ms "
          f"({nbytes / row['ms'] / 1e6:.1f} GB/s, {row['ms'] / row['bound_ms']:.3f} x "
          f"the bound), bound {row['bound_ms']:.4f} ms (bytes: {nbytes / 1e9:.2f} GB), "
          f"plain in place {row['plain_ms']:.4f} ms, optim/adam.py's update + "
          f"apply_updates {row['adam_py_ms']:.4f} ms", flush=True)
    if row["ms"] > LEAF_ADAM_BOUND_X * row["bound_ms"]:
        fail(f"leaf_adam: {row['ms']:.4f} ms is more than {LEAF_ADAM_BOUND_X} x its "
             f"bound {row['bound_ms']:.4f} ms")
    del a, grads, state
    torch.cuda.empty_cache()
    return [row]


def _signature(svc):
    return [(r.request_id, r.status, r.steps_used, r.degraded_steps, r.latency,
             r.best_smiles, None if r.best_reward is None
             else struct.pack("<d", r.best_reward).hex())
            for r in sorted(svc.results, key=lambda r: r.request_id)]


def phase_serve() -> int:
    from repro_torch.kernels.fused_qnet.ops import fused_qnet
    from repro_torch.launch import serve_molopt
    from repro_torch.serving import STATUSES, latency_stats

    args = serve_molopt.parser().parse_args(SERVE_ARGS + ["--device", "cuda"])
    runs = []
    for run in ("first", "rerun"):
        fused_qnet.launches = 0
        svc, wall = serve_molopt.serve(args)
        launches = fused_qnet.launches
        runs.append((svc, wall, launches))
        st = svc.stats()
        ids = {r.request_id for r in svc.results}
        if len(svc.results) != args.requests or len(ids) != args.requests \
                or any(r.status not in STATUSES for r in svc.results):
            fail(f"serve: {len(svc.results)} results over {len(ids)} ids for "
                 f"{args.requests} requests")
        if not svc.idle:
            fail("serve: service not idle after the stream drained")
        if launches != st["n_q_dispatches"] or launches == 0:
            fail(f"serve: fused_qnet launches {launches} != Q dispatches "
                 f"{st['n_q_dispatches']}")
        bad = [r.request_id for r in svc.results if r.best_reward is not None
               and not math.isfinite(r.best_reward)]
        if bad:
            fail(f"serve: non-finite best reward for {bad}")
        lat = latency_stats(svc.results)
        steps = st["n_service_steps"]
        timing = svc.dispatch_timing()
        chem = svc.engine.chem_stats()
        print(f"serve ({run}): {args.requests} requests in {wall:.3f} s = "
              f"{args.requests / wall:.2f} req/s | p50/p99 wall "
              f"{lat['p50_wall_ms']:.2f}/{lat['p99_wall_ms']:.2f} ms | statuses "
              f"{st['status_counts']} | service steps {steps} | Q dispatches "
              f"{st['n_q_dispatches']} ({svc._policy.n_workers} x "
              f"{svc._policy._cap} rows) | fused_qnet launches {launches}",
              flush=True)
        print(f"serve ({run}): per Q dispatch H2D copy {timing['h2d_ms']:.4f} ms,"
              f" fused_qnet {timing['kernel_ms']:.4f} ms (CUDA events) | per "
              f"service step {wall * 1e3 / steps:.2f} ms wall, host enumeration "
              f"{chem['enum_s'] * 1e3 / steps:.2f} ms, host fingerprints "
              f"{chem['fp_s'] * 1e3 / steps:.2f} ms", flush=True)

    (a, _, _), (b, _, _) = runs
    if _signature(a) != _signature(b):
        fail("serve: rerun on the same seed gave different results")
    if json.dumps(a.stats(), sort_keys=True, default=str) != \
            json.dumps(b.stats(), sort_keys=True, default=str):
        fail("serve: rerun on the same seed gave different counters")

    # epsilon = 1: actions do not read Q, so the GPU run must reproduce the
    # CPU run's results and counters bit for bit
    twins = []
    for dev in ("cuda", "cpu"):
        twin_args = serve_molopt.parser().parse_args(
            SERVE_ARGS + ["--device", dev, "--epsilon", "1.0"])
        twins.append(serve_molopt.serve(twin_args)[0])
    if _signature(twins[0]) != _signature(twins[1]) or \
            json.dumps(twins[0].stats(), sort_keys=True, default=str) != \
            json.dumps(twins[1].stats(), sort_keys=True, default=str):
        fail("serve: epsilon=1 results on the GPU differ from the CPU run's")
    print("serve: rerun bit-identical; epsilon=1 GPU run bit-identical to "
          "the CPU run", flush=True)
    return runs[0][2]


def _learner_trees(W: int, seed: int):
    """Seeded full-width stacked parameters and targets on the card, one
    row a worker (``[W, ...]`` leaves, He-normal weights)."""
    import torch
    from repro_torch.core.agent import HIDDEN_SIZES, STATE_DIM
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    sizes = (STATE_DIM,) + HIDDEN_SIZES + (1,)
    return [[t for i, o in zip(sizes[:-1], sizes[1:])
             for t in (rnd(W, i, o) * (2.0 / i) ** 0.5, 0.1 * rnd(W, o))]
            for _ in range(2)]


def _learner_batch(W: int, seed: int, W_pad: int | None = None):
    """A seeded dense ``[W_pad, B, ...]`` learner batch on the card at the
    paper's B 32 x C 64 (a fifth of the next-state slots empty, a fifth of
    the rows terminal), all-zero on rows ``W`` on (dead workers')."""
    import torch
    from repro_torch.core.agent import STATE_DIM
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    uni = lambda *shape: torch.rand(shape, generator=gen, device="cuda")
    B, C = 32, 64
    batch = {"states": (uni(W, B, STATE_DIM) < 0.3).float(),
             "next_fps": (uni(W, B, C, STATE_DIM) < 0.3).float(),
             "next_mask": (uni(W, B, C) < 0.8).float(),
             "rewards": rnd(W, B), "dones": (uni(W, B) < 0.2).float()}
    batch["next_fps"] *= batch["next_mask"].unsqueeze(-1)
    pad = (W_pad or W) - W
    return {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
            for k, v in batch.items()}


def _mesh_run_lengths(setup) -> None:
    """The learner's stacked step at the paper's widths where nd changes
    the rows a batched product holds: every run length bit-equal to the
    longest run, then whole fleets bit-identical at nd = 1 and 4."""
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.core.agent import DQNConfig, QNetwork, flat
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.predictors.service import OracleService

    discount = DQNConfig().discount
    leaves, target = _learner_trees(128, 11)
    batch = _learner_batch(128, 11)
    full = D._loss_grad(leaves, target, batch, discount)
    for n in range(D._MIN_RUN, 128):
        rows = slice(128 - n, 128)         # a run at an offset in its stack
        grads, loss, td = D._loss_grad(
            [t[rows] for t in leaves], [t[rows] for t in target],
            {k: v[rows] for k, v in batch.items()}, discount)
        if not (all(torch.equal(g, f[rows]) for g, f in zip(grads, full[0]))
                and torch.equal(loss, full[1][rows])
                and torch.equal(td, full[2][rows])):
            fail(f"mesh: a stacked run of {n} rows gives other gradient, loss "
                 f"or |TD| bits than the same rows in a run of 128")
    del leaves, target, batch, full, grads
    print(f"mesh: the stacked gradient at full width, B 32 x C 64: runs of "
          f"{D._MIN_RUN} to 127 rows bit-equal, row by row, to a run of 128",
          flush=True)

    train, rcfg = setup
    for W in (MESH_RAGGED, 64, 300):
        sig, runs = {}, {}
        for nd in (1, 4):
            cfg = D.TrainerConfig(n_workers=W, mols_per_worker=1,
                                  learner="dense", seed=0)
            tr = D.DistributedTrainer(
                cfg, (list(train) * 2)[:W], OracleService(), rcfg,
                network=QNetwork(generator=torch.Generator().manual_seed(0),
                                 device="cpu"),
                mesh=make_host_mesh(nd, pool=["cuda"] * nd))
            W_pad = tr.n_padded_workers
            trees = _learner_trees(W, 12)
            for sh in tr._shards:                # the live rows differ
                lo, hi = sh.rows.start, min(sh.rows.stop, W)
                for dst, src in zip((sh.params, sh.target), trees):
                    for d, x in zip(flat(dst), src):
                        d[:max(0, hi - lo)].copy_(x[lo:hi])
            del trees
            out = []
            chunks = tr.trace_stats()["counts"].get("trainer.stacked_chunks", 0)
            for seed in (13, 14):
                batch = _learner_batch(W, seed, W_pad)
                loss, td = tr._update_once(shard_batch(batch, tr.mesh),
                                           packed=False)
                out += [loss[:W].cpu(), td[:W].cpu()]
                del batch
            runs[nd] = (tr.trace_stats()["counts"]["trainer.stacked_chunks"]
                        - chunks) // 2
            sig[nd] = out + [t[:W].cpu() for t in flat(tr.params)]
            del tr
            torch.cuda.empty_cache()
        if not all(map(torch.equal, sig[1], sig[4])):
            fail(f"mesh: W={W} stacked updates differ between nd=1 and nd=4")
        print(f"mesh: W={W} at full width, two stacked updates (B 32 x C 64): "
              f"losses, |TD| and every parameter bit identical at nd 1 "
              f"({runs[1]} run(s) of live rows an update) and nd 4 "
              f"({runs[4]})", flush=True)


def _train_setup():
    """The launcher's data and reward: the antioxidant train split, its
    first W x mols_per_worker molecules, Eq. 1 bounds from the split."""
    from repro_torch.core.reward import RewardConfig
    from repro_torch.data.datasets import (antioxidant_dataset,
                                           dataset_property_table,
                                           train_test_split)
    train, _ = train_test_split(antioxidant_dataset(600))
    props = dataset_property_table(train)
    return train, RewardConfig.from_dataset(props["bde"], props["ip"])


def _trainer(setup, device="cuda", faults=False, episodes=TRAIN_EPISODES,
             dqn=None, **over):
    from repro_torch.core.agent import DQNConfig
    from repro_torch.core.distributed import DistributedTrainer, TrainerConfig
    from repro_torch.core.faults import FaultPlan, FaultRule
    from repro_torch.predictors.service import (OracleService,
                                                ResilientService, RetryPolicy)
    train, rcfg = setup
    cfg = TrainerConfig(episodes=episodes,
                        dqn=dqn or DQNConfig(epsilon_decay=0.97), **over)
    svc, plan = OracleService(), None
    if faults:                 # the fault smoke's plan, inside the budgets
        plan = FaultPlan([
            FaultRule(site="predict", kind="timeout", every=3, fail_attempts=1),
            FaultRule(site="chem", kind="transient", rate=0.3, fail_attempts=1),
        ], seed=8)
        svc = ResilientService(svc, RetryPolicy(seed=8), fault_plan=plan,
                               sleep=None)
    n = cfg.n_workers * cfg.mols_per_worker
    tr = DistributedTrainer(cfg, list(train[:n]), svc, rcfg, fault_plan=plan,
                            device=device)
    tr.train(episodes)
    tr.close()
    return tr


def _host_s(tr) -> tuple[float, float]:
    """The trainer's host seconds in ``rollout_episode`` and in
    ``run_updates`` (its spans ``trainer.rollout`` and ``trainer.updates``)."""
    s = tr.trace_stats()["seconds"]
    return s.get("trainer.rollout", 0.0), s.get("trainer.updates", 0.0)


def _train_signature(tr):
    bufs = [[getattr(b, k).tobytes() for k in
             ("_state_bits", "_state_frac", "_rewards", "_dones", "_next_bits",
              "_next_frac", "_next_counts")] for b in tr.buffers]
    return (bufs, [struct.pack("<d", x).hex() for x in tr.reward_log],
            [struct.pack("<d", x).hex() for x in tr.loss_log],
            [t.cpu().numpy().tobytes() for wb in tr.params for t in wb])


def phase_train() -> int:
    from repro_torch.core.agent import DQNConfig
    from repro_torch.kernels.packed_qnet.ops import packed_qnet_stacked

    setup = _train_setup()
    runs = []
    for run in ("first", "rerun"):
        packed_qnet_stacked.launches = 0
        t0 = time.perf_counter()
        tr = _trainer(setup)
        wall = time.perf_counter() - t0
        launches = packed_qnet_stacked.launches
        runs.append((tr, launches))
        if launches != tr.n_q_dispatches or launches == 0:
            fail(f"train: packed_qnet_stacked launches {launches} != fleet Q "
                 f"dispatches {tr.n_q_dispatches}")
        if not all(math.isfinite(x) for x in tr.reward_log) or \
                not any(math.isfinite(x) for x in tr.loss_log) or \
                any(math.isnan(x) for x in tr.loss_log[1:]):
            fail(f"train: rewards {tr.reward_log} or losses {tr.loss_log} "
                 f"not finite")
        steps = tr.engine.n_env_steps
        timing = tr.dispatch_timing()
        chem = tr.engine.chem_stats()
        rollout_s, learner_s = _host_s(tr)
        step_ms = rollout_s * 1e3 / steps
        busy = (timing["h2d_ms"] + timing["kernel_ms"]) / step_ms
        print(f"train ({run}): {TRAIN_EPISODES} episodes in {wall:.3f} s | "
              f"{steps} env steps, {steps / rollout_s:.2f} env steps/s | "
              f"{tr.n_updates} updates, {tr.n_updates / learner_s:.2f} "
              f"updates/s, {learner_s * 1e3 / tr.n_updates:.2f} ms per "
              f"update (host clock, ends synced) | rewards {tr.reward_log} | "
              f"losses {tr.loss_log}", flush=True)
        print(f"train ({run}): per Q dispatch ({tr.cfg.n_workers} x "
              f"{tr.candidate_capacity} rows) H2D {timing['h2d_ms']:.4f} ms "
              f"({tr.acting_h2d_bytes / tr.n_q_dispatches / 1e6:.3f} MB), "
              f"packed_qnet_stacked {timing['kernel_ms']:.4f} ms (CUDA "
              f"events) | per env step {step_ms:.2f} ms wall, host enumeration "
              f"{chem['enum_s'] * 1e3 / steps:.2f} ms, host fingerprints "
              f"{chem['fp_s'] * 1e3 / steps:.2f} ms | card busy on acting "
              f"{100 * busy:.1f}% of a step | launches {launches} = Q "
              f"dispatches {tr.n_q_dispatches}", flush=True)
    (a, launches), (b, _) = runs
    if _train_signature(a) != _train_signature(b):
        fail("train: rerun on the same seed gave different transitions, "
             "losses, rewards or parameters")

    # epsilon = 1 throughout: actions do not read Q, so the card's
    # transitions and rewards must be the CPU run's bit for bit
    explore = DQNConfig(epsilon_decay=1.0)
    gpu = _trainer(setup, dqn=explore)
    cpu = _trainer(setup, device="cpu", dqn=explore)
    sg, sc = _train_signature(gpu), _train_signature(cpu)
    if sg[:2] != sc[:2]:
        fail("train: epsilon=1 transitions or rewards on the GPU differ from "
             "the CPU run's")
    rel = max((abs(x - y) / max(abs(y), 1e-30) for x, y in
               zip(gpu.loss_log, cpu.loss_log) if math.isfinite(y)), default=0.0)
    if rel > TRAIN_LOSS_RTOL or len(gpu.loss_log) != len(cpu.loss_log):
        fail(f"train: epsilon=1 GPU losses {gpu.loss_log} vs CPU "
             f"{cpu.loss_log}: rel {rel:.3e} > {TRAIN_LOSS_RTOL}")
    print(f"train: rerun bit-identical; epsilon=1 transitions and rewards on "
          f"the GPU bit-identical to the CPU run, losses within {rel:.3e} rel",
          flush=True)

    # acting x rollout at epsilon 0.05: Q decides most actions
    greedy = DQNConfig(epsilon_initial=0.05, epsilon_decay=0.97)
    ref = _train_signature(_trainer(setup, episodes=2, dqn=greedy))
    for acting, rollout in (("dense", "fleet"), ("packed_async", "fleet"),
                            ("packed", "fleet_pipelined"),
                            ("packed_async", "fleet_pipelined"),
                            ("packed", "per_worker")):
        got = _train_signature(_trainer(setup, episodes=2, dqn=greedy,
                                        acting=acting, rollout=rollout))
        if got[:3] != ref[:3]:
            fail(f"train: acting={acting} rollout={rollout} transitions differ "
                 f"from packed fleet at epsilon 0.05")
    print("train: acting {dense, packed, packed_async} x rollout {fleet, "
          "fleet_pipelined, per_worker}: identical transitions at epsilon "
          "0.05", flush=True)

    want = _train_signature(a)
    for learner in ("dense", "packed_pipelined"):
        if _train_signature(_trainer(setup, learner=learner)) != want:
            fail(f"train: learner={learner} losses or parameters differ from "
                 f"learner=packed")
    print("train: learner {dense, packed, packed_pipelined}: bit-identical "
          "loss trajectories and parameters", flush=True)

    clean = _trainer(setup, episodes=2)
    faulted = _trainer(setup, episodes=2, faults=True)
    retries = faulted.service.n_retries
    if retries == 0 or _train_signature(faulted) != _train_signature(clean):
        fail(f"train: faulted run ({retries} retries) differs from its "
             f"fault-free twin")
    print(f"train: FaultPlan run ({retries} predict retries, "
          f"{faulted.engine.fault_stats()['n_chem_retries']} chem retries) "
          f"bit-identical to its fault-free twin", flush=True)
    return launches


def _mesh_kernel_check() -> None:
    """Per-shard launches on contiguous ``[W_local, ...]`` slices give the
    unsharded launch's bits: W = 8 at W_local 1, 2 and 4, workers 6 and 7
    dead (zero planes), so the last shard at W_local 2 is all dead."""
    import torch
    from repro_torch.kernels.packed_qnet.ops import packed_qnet_stacked
    W, C = 8, MESH_KERNEL_ROWS
    weights, bits, frac = _stacked_inputs(W, C)
    bits[6:], frac[6:] = 0, 0.0
    full = packed_qnet_stacked(weights, bits, frac)
    for per in (1, 2, 4):
        cut = lambda t, s: t[s:s + per].contiguous()
        parts = [packed_qnet_stacked([(cut(w, s), cut(b, s)) for w, b in weights],
                                     cut(bits, s), cut(frac, s))
                 for s in range(0, W, per)]
        if not torch.equal(torch.cat(parts), full):
            fail(f"mesh: per-shard packed_qnet_stacked at W_local {per} of "
                 f"{W} x {C} differs from the unsharded launch")
    print(f"mesh: per-shard packed_qnet_stacked at W_local 1, 2, 4 of {W} x {C} "
          f"(an all-dead shard included) bit-identical to the unsharded launch",
          flush=True)


def _mesh_run(setup, nd: int, workers: int = 4, sync: str = "episode",
              snapshot: bool = False):
    """The launcher-default fleet (or a ragged one) on ``nd`` shards of one
    card: a warmup episode with the 1.3x candidate reserve, then the
    measured episodes.  Returns the trainer, its ``packed_qnet_stacked``
    launches, with ``snapshot`` its state after the warmup episode (else
    None), and its env steps/s and updates/s over the measured episodes
    (the warmup episode pays first-use costs)."""
    from repro_torch.core.agent import DQNConfig
    from repro_torch.core.distributed import DistributedTrainer, TrainerConfig
    from repro_torch.core.jit_stats import RecompileCounter
    from repro_torch.kernels.packed_qnet.ops import packed_qnet_stacked
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.predictors.service import OracleService
    train, rcfg = setup
    # epsilon 0.05: Q decides most actions, so the shards' Q bits matter
    cfg = TrainerConfig(n_workers=workers, episodes=MESH_EPISODES,
                        sync_mode=sync, dqn=DQNConfig(epsilon_initial=0.05,
                                                      epsilon_decay=0.97))
    tr = DistributedTrainer(cfg, list(train[:workers * cfg.mols_per_worker]),
                            OracleService(), rcfg,
                            mesh=make_host_mesh(nd, pool=["cuda"] * nd))
    counter = RecompileCounter.install()
    packed_qnet_stacked.launches = 0
    with counter.window():
        tr.train_episode()
        tr.reserve_candidates(int(tr.candidate_capacity * 1.3))
    snap = tr.state_dict() if snapshot else None
    marks = (tr.engine.n_env_steps, tr.n_updates, *_host_s(tr))
    with counter.window() as measured:
        while tr.episode < MESH_EPISODES:
            tr.train_episode()
    tr.close()
    rollout_s, learner_s = _host_s(tr)
    rates = ((tr.engine.n_env_steps - marks[0]) / (rollout_s - marks[2]),
             (tr.n_updates - marks[1]) / (learner_s - marks[3]))
    launches = packed_qnet_stacked.launches
    tag = f"mesh: W={workers} nd={nd} sync={sync}"
    if launches != nd * tr.n_q_dispatches or launches == 0:
        fail(f"{tag}: packed_qnet_stacked launches {launches} != {nd} x fleet "
             f"Q dispatches {tr.n_q_dispatches}")
    if measured.count != 0:
        fail(f"{tag}: {measured.count} shape events after warmup")
    if not all(math.isfinite(x) for x in tr.reward_log) or \
            not all(math.isfinite(x) for x in tr.loss_log):
        fail(f"{tag}: rewards {tr.reward_log} or losses {tr.loss_log} not finite")
    return tr, launches, snap, rates


def _mesh_signature(tr):
    """``_train_signature`` over the live workers' parameter rows."""
    bufs, rewards, losses, _ = _train_signature(tr)
    return (bufs, rewards, losses,
            [t[:tr.n_live_workers].cpu().numpy().tobytes()
             for wb in tr.params for t in wb])


def phase_mesh(card: str) -> dict:
    """The sharded trainer on a pool of ``cuda`` repeated: nd shards share
    the one card, so the rates show the sharding's overhead."""
    _mesh_kernel_check()
    setup = _train_setup()
    launches, sig = {}, {}
    for nd in MESH_ND:
        tr, launches[f"W4_nd{nd}"], _, rates = _mesh_run(setup, nd)
        sig[nd] = _mesh_signature(tr)
        timing = tr.dispatch_timing()
        print(f"mesh: W=4 x 4 nd={nd} ({tr.n_padded_workers} workers, "
              f"{tr.n_padded_workers // nd} a shard; {card}; the {nd} shards "
              f"share one card, so these rates show the sharding's overhead, "
              f"not a speedup) | over the {MESH_EPISODES - 1} measured "
              f"episodes: {rates[0]:.2f} env steps/s, "
              f"{rates[1]:.2f} updates/s (host clock, ends synced) | "
              f"per Q dispatch H2D {timing['h2d_ms']:.4f} "
              f"ms + packed_qnet_stacked {timing['kernel_ms']:.4f} ms over "
              f"{nd} launch(es) (CUDA events) | launches "
              f"{launches[f'W4_nd{nd}']} = {nd} x {tr.n_q_dispatches} Q "
              f"dispatches | 0 shape events after warmup", flush=True)
        if sig[nd] != sig[MESH_ND[0]]:
            fail(f"mesh: nd={nd} transitions, rewards, losses or parameters "
                 f"differ from nd={MESH_ND[0]}")
    print(f"mesh: nd {', '.join(map(str, MESH_ND))}: transitions, reward and "
          f"loss logs and every parameter bit identical", flush=True)

    for sync in ("episode", "step"):
        flat_tr = _mesh_run(setup, 1, MESH_RAGGED, sync)[0]
        padded, n, snap, _ = _mesh_run(setup, 4, MESH_RAGGED, sync,
                                       snapshot=sync == "episode")
        launches[f"W{MESH_RAGGED}_nd4_{sync}"] = n
        if padded.n_padded_workers != 8:
            fail(f"mesh: W={MESH_RAGGED} on 4 shards padded to "
                 f"{padded.n_padded_workers}, not 8")
        if _mesh_signature(padded) != _mesh_signature(flat_tr):
            fail(f"mesh: ragged W={MESH_RAGGED} nd=4 sync={sync} differs from "
                 f"its unpadded nd=1 run on the live rows")
        print(f"mesh: ragged W={MESH_RAGGED} nd=4 (W_pad 8) sync={sync} "
              f"bit-identical to nd=1 on the live rows | launches {n} = 4 x "
              f"{padded.n_q_dispatches}", flush=True)
        if snap is None:
            continue
        from repro_torch.core.distributed import DistributedTrainer
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.predictors.service import OracleService
        train, rcfg = setup
        fresh = DistributedTrainer(
            padded.cfg, list(train[:MESH_RAGGED * padded.cfg.mols_per_worker]),
            OracleService(), rcfg, mesh=make_host_mesh(4, pool=["cuda"] * 4))
        fresh.load_state_dict(snap)
        while fresh.episode < MESH_EPISODES:
            fresh.train_episode()
        fresh.close()
        if _state_bytes(fresh) != _state_bytes(padded):
            fail("mesh: the padded nd=4 checkpoint restored into a fresh nd=4 "
                 "trainer did not resume bit-identical")
        print(f"mesh: padded nd=4 state_dict ({len(snap)} keys, [8, ...] "
              f"leaves) restored into a fresh nd=4 trainer at episode 1 ends "
              f"bit-identical on every key", flush=True)
    _mesh_run_lengths(setup)
    return launches


def _state_bytes(tr) -> dict[str, bytes]:
    import numpy as np
    return {k: np.asarray(v).dtype.str.encode() + np.asarray(v).tobytes()
            for k, v in tr.state_dict().items()}


def phase_train_rl():
    """The RL launcher's path; returns the Q kernels' launches on it, and
    the trained trainer, its ``PropertyService`` and the predictor cache
    for the pipeline phase."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.agent import DQNConfig
    from repro_torch.core.distributed import (DistributedTrainer, TrainerConfig,
                                              greedy_optimize,
                                              optimization_failure_rate)
    from repro_torch.kernels.fused_qnet.ops import fused_qnet
    from repro_torch.kernels.packed_qnet.ops import packed_qnet_stacked
    from repro_torch.launch import serve_molopt
    from repro_torch.predictors import gnn, ip_net, training
    from repro_torch.predictors.service import PropertyService
    from repro_torch.serving import STATUSES

    work = ROOT / "build" / "chip_smoke_rl"
    shutil.rmtree(work, ignore_errors=True)

    # 1. predictors, trained on the card at the launcher's steps
    t0 = time.perf_counter()
    corpus = training.featurized_corpus(training.build_corpus())
    print(f"train_rl: corpus of {len(corpus[1])} molecules built and "
          f"featurized in {time.perf_counter() - t0:.2f} s (host)", flush=True)
    t0 = time.perf_counter()
    bm, bp, im, ip_, metrics = training.ensure_trained(
        str(work / "predictors"), device="cuda", corpus=corpus)
    print(f"train_rl: ensure_trained {time.perf_counter() - t0:.2f} s | "
          f"metrics {json.dumps(metrics, sort_keys=True)}", flush=True)
    for kind in ("bde", "ip"):
        if not metrics[kind]["rel_err_mean"] < PREDICTOR_ENVELOPE:
            fail(f"train_rl: {kind} held-out rel_err_mean "
                 f"{metrics[kind]['rel_err_mean']} >= {PREDICTOR_ENVELOPE}")

    # 2. the card against the CPU on the held-out molecules; batch times
    feats, _, _, has_bde = corpus
    dev = {d: training.corpus_to_device(feats, torch.device(d))
           for d in ("cuda", "cpu")}
    for kind, model, to_cpu, valid in (
            ("bde", bm, gnn.params_from_numpy(bp, device="cpu"), has_bde),
            ("ip", im, ip_net.params_from_numpy(ip_, device="cpu"),
             feats["conf_valid"] > 0.5)):
        hold, _ = training.holdout_split(valid)
        got = training.predict_corpus(model, dev["cuda"], hold, kind)
        want = training.predict_corpus(to_cpu, dev["cpu"], hold, kind)
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        if not np.isfinite(got).all() or rel > PREDICTOR_RTOL:
            fail(f"train_rl: {kind} on the card vs the CPU rel {rel:.3e} > "
                 f"{PREDICTOR_RTOL}")
        print(f"train_rl: {kind} on the card vs the CPU, {len(hold)} held-out "
              f"molecules: max rel {rel:.3e} (<= {PREDICTOR_RTOL})", flush=True)
    del dev
    svc = PropertyService(bm, bp, im, ip_, device="cuda")
    for rows in PREDICTOR_ROWS:
        batch = {k: v[:rows] for k, v in feats.items()}
        ms = cuda_ms(lambda: svc._run_models(batch), 20)
        print(f"train_rl: one predictor batch of {rows} rows (pack, one H2D "
              f"copy, both forwards, one copy back): {ms:.4f} ms (CUDA events)",
              flush=True)
    svc = PropertyService(bm, bp, im, ip_, device="cuda")   # fresh counters

    # 3. the trainer on the trained predictors, checkpointed every episode
    train, rcfg = _train_setup()
    cfg = TrainerConfig(episodes=RL_EPISODES, dqn=DQNConfig(epsilon_decay=0.97))
    n = cfg.n_workers * cfg.mols_per_worker
    mgr = CheckpointManager(str(work / "ckpt"), max_to_keep=RL_EPISODES)
    packed_qnet_stacked.launches = 0
    t0 = time.perf_counter()
    tr = DistributedTrainer(cfg, list(train[:n]), svc, rcfg, device="cuda")
    while tr.episode < RL_EPISODES:
        tr.train_episode()
        tr.save_checkpoint(mgr)
    tr.close()
    wall = time.perf_counter() - t0
    stacked = packed_qnet_stacked.launches
    if stacked != tr.n_q_dispatches or stacked == 0:
        fail(f"train_rl: packed_qnet_stacked launches {stacked} != fleet Q "
             f"dispatches {tr.n_q_dispatches}")
    if not all(math.isfinite(x) for x in tr.reward_log) or \
            any(math.isnan(x) for x in tr.loss_log[1:]):
        fail(f"train_rl: rewards {tr.reward_log} or losses {tr.loss_log}")
    steps = tr.engine.n_env_steps
    chem = tr.engine.chem_stats()
    timing = tr.dispatch_timing()
    rollout_s, learner_s = _host_s(tr)
    step_ms = rollout_s * 1e3 / steps
    print(f"train_rl: {RL_EPISODES} episodes in {wall:.3f} s (checkpoints "
          f"included) | {steps} env steps, {steps / rollout_s:.2f} env "
          f"steps/s | {tr.n_updates} updates, {tr.n_updates / learner_s:.2f} "
          f"updates/s | rewards {tr.reward_log} | losses {tr.loss_log}",
          flush=True)
    print(f"train_rl: per env step {step_ms:.2f} ms wall: predictor "
          f"{svc.predict_s * 1e3 / steps:.2f} ms ({100 * svc.predict_s / rollout_s:.1f}%; "
          f"model batches {svc.model_s * 1e3 / steps:.2f} ms, "
          f"{svc.n_predictor_batches} batches of {svc.n_predictor_mols} "
          f"molecules, cache hit rate {svc.cache.hit_rate:.3f}), host "
          f"enumeration {chem['enum_s'] * 1e3 / steps:.2f} ms, host "
          f"fingerprints {chem['fp_s'] * 1e3 / steps:.2f} ms, "
          f"packed_qnet_stacked {timing['kernel_ms']:.4f} ms (CUDA events) | "
          f"launches {stacked} = fleet Q dispatches {tr.n_q_dispatches}",
          flush=True)
    want = _state_bytes(tr)

    # a fresh trainer restored at episode RL_RESUME_FROM runs to the end:
    # bit-identical on every key.  It shares the service, whose cache holds
    # each molecule's first predicted value (the cache is not state).
    for fresh_svc in (False, True):
        rsvc = PropertyService(bm, bp, im, ip_, device="cuda") if fresh_svc else svc
        packed_qnet_stacked.launches = 0
        rt = DistributedTrainer(cfg, list(train[:n]), rsvc, rcfg, device="cuda")
        if rt.restore_checkpoint(mgr, step=RL_RESUME_FROM) != RL_RESUME_FROM:
            fail("train_rl: restore did not land on the asked episode")
        while rt.episode < RL_EPISODES:
            rt.train_episode()
        rt.close()
        got = _state_bytes(rt)
        diff = sorted(k for k in want if got.get(k) != want[k])
        if not fresh_svc:
            if sorted(got) != sorted(want) or diff:
                fail(f"train_rl: resumed trainer differs from the unbroken run "
                     f"on {diff[:8]} ({len(diff)} of {len(want)} keys)")
            if packed_qnet_stacked.launches != rt.n_q_dispatches:
                fail("train_rl: resumed run's launches != its Q dispatches")
            print(f"train_rl: restored at episode {RL_RESUME_FROM}, ran to "
                  f"{RL_EPISODES}: all {len(want)} state_dict keys "
                  f"bit-identical to the unbroken run", flush=True)
        else:    # a new process's cache: reported, not gated
            print(f"train_rl: the same with a fresh PropertyService (empty "
                  f"cache): {len(want) - len(diff)} of {len(want)} keys "
                  f"bit-identical{'' if not diff else ', differing: ' + str(diff[:6])}",
                  flush=True)

    # 4. greedy evaluation of the general model
    agent = tr.as_agent(epsilon=0.0)
    fused_qnet.launches = 0
    recs = greedy_optimize(agent, list(train[:n]), svc, rcfg, cfg.env)
    greedy = fused_qnet.launches
    if greedy != agent.n_q_dispatches or greedy == 0 or len(recs) != n:
        fail(f"train_rl: greedy evaluation: fused_qnet launches {greedy}, Q "
             f"dispatches {agent.n_q_dispatches}, {len(recs)} records")
    print(f"train_rl: greedy_optimize on {n} training molecules: OFR "
          f"{optimization_failure_rate(recs):.3f} | cache hit rate "
          f"{svc.cache.hit_rate:.3f} | fused_qnet launches {greedy} = Q "
          f"dispatches {agent.n_q_dispatches}", flush=True)

    # 5. serving through the trained predictors
    training.DEFAULT_CACHE_DIR = str(work / "predictors")
    args = serve_molopt.parser().parse_args(SERVE_ARGS + ["--device", "cuda",
                                                          "--trained"])
    fused_qnet.launches = 0
    ssvc, wall = serve_molopt.serve(args)
    served = fused_qnet.launches
    st = ssvc.stats()
    if len(ssvc.results) != args.requests or not ssvc.idle or \
            any(r.status not in STATUSES for r in ssvc.results):
        fail(f"train_rl: serve --trained left {len(ssvc.results)} of "
             f"{args.requests} requests terminal")
    if served != st["n_q_dispatches"] or served == 0:
        fail(f"train_rl: serve --trained fused_qnet launches {served} != Q "
             f"dispatches {st['n_q_dispatches']}")
    print(f"train_rl: serve --trained: {args.requests} requests in {wall:.3f} s"
          f" = {args.requests / wall:.2f} req/s | statuses "
          f"{st['status_counts']} | fused_qnet launches {served} = Q "
          f"dispatches {st['n_q_dispatches']}", flush=True)
    return ({"packed_qnet_stacked": stacked, "greedy": greedy, "serve": served},
            (tr, svc, work / "predictors"))


def _agent_bytes(agent) -> list[bytes]:
    return [t.cpu().numpy().tobytes()
            for wb in agent.params + agent.target_params for t in wb]


def _timed_fused_qnet(calls: list):
    """A stand-in for ``core.agent``'s ``fused_qnet`` that records CUDA
    events around each call (the launch itself is the real wrapper's)."""
    import torch
    from repro_torch.core import agent as agent_mod
    real = agent_mod.fused_qnet

    def timed(weights, x):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        q = real(weights, x)
        ev[1].record()
        calls.append((x.shape[0], ev))
        return q
    return agent_mod, real, timed


def _verify_child(args: list[str]) -> subprocess.CompletedProcess:
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.verify",
                           *args], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=VERIFY_TIMEOUT_S)


def _report_diff(a: dict, b: dict, skip) -> list[str]:
    import numpy as np
    keys = sorted((set(a) | set(b)) - set(skip))
    return [k for k in keys if k not in a or k not in b
            or np.asarray(a[k]).dtype != np.asarray(b[k]).dtype
            or np.asarray(a[k]).tobytes() != np.asarray(b[k]).tobytes()]


def phase_pipeline(tr, svc, cache_dir: Path) -> dict[str, int]:
    """The paper's §3.5 pipeline and the truth run on train_rl's general
    model; returns the Q kernels' launches on each path."""
    import io
    import re
    import shutil
    from contextlib import redirect_stdout
    import numpy as np
    import torch
    from repro_torch.chem.oracle import oracle_bde, oracle_ip
    from repro_torch.chem.smiles import canonical_smiles
    from repro_torch.core import FilterCriteria, filter_molecules, fine_tune
    from repro_torch.core.distributed import greedy_optimize
    from repro_torch.data.datasets import antioxidant_dataset, train_test_split
    from repro_torch.examples import quickstart
    from repro_torch.kernels.fused_qnet.ops import fused_qnet
    from repro_torch.kernels.packed_qnet.ops import packed_qnet_stacked
    from repro_torch.launch import verify

    t_phase = time.perf_counter()
    _, rcfg = _train_setup()
    train, test = train_test_split(antioxidant_dataset(600))
    env_cfg = tr.cfg.env
    n = tr.cfg.n_workers * tr.cfg.mols_per_worker

    # (a) fine-tune the worst unseen molecule, as optimize_antioxidants does
    agent = tr.as_agent(epsilon=0.0)
    recs = greedy_optimize(agent, list(train[:n]), svc, rcfg, env_cfg, seed=1)
    trecs = greedy_optimize(agent, list(test[:N_TEST]), svc, rcfg, env_cfg,
                            seed=2)
    worst = int(np.argmin([r.reward for r in trecs]))
    mol = test[worst]
    general = tr.as_agent(epsilon=0.5)
    width = "->".join(str(w.shape[0]) for w, _ in general.params) + "->1"
    general_bytes = _agent_bytes(general)

    def tune(device="cuda", **kw):
        return fine_tune(general, mol, svc, rcfg, episodes=FT_EPISODES,
                         env_cfg=env_cfg, train_batch_size=FT_BATCH,
                         max_candidates=FT_CANDIDATES, device=device, **kw)

    calls: list = []
    agent_mod, real, timed = _timed_fused_qnet(calls)
    fused_qnet.launches = 0
    agent_mod.fused_qnet = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ft = tune()
        torch.cuda.synchronize()
        ft_s = time.perf_counter() - t0
    finally:
        agent_mod.fused_qnet = real
    launches_ft = fused_qnet.launches
    if launches_ft != ft.n_q_dispatches or launches_ft == 0:
        fail(f"pipeline: fine_tune fused_qnet launches {launches_ft} != Q "
             f"dispatches {ft.n_q_dispatches}")
    kernel_ms = sum(ev[0].elapsed_time(ev[1]) for _, ev in calls)
    rows = [r for r, _ in calls]
    steps = ft.n_q_dispatches
    print(f"pipeline: fine_tune at {width} on {canonical_smiles(mol)} (the "
          f"worst of {N_TEST} unseen molecules): {FT_EPISODES} episodes in "
          f"{ft_s:.3f} s | {steps} env steps, {steps / ft_s:.2f} env steps/s "
          f"| fused_qnet {kernel_ms:.3f} ms in all, {kernel_ms / steps:.4f} ms "
          f"a dispatch of {min(rows)}..{max(rows)} rows (CUDA events), "
          f"{100 * kernel_ms / (1e3 * ft_s):.2f}% of the fine-tune | launches "
          f"{launches_ft} = Q dispatches {ft.n_q_dispatches}", flush=True)
    if _agent_bytes(tune()) != _agent_bytes(ft):
        fail("pipeline: fine_tune rerun on the same seed gave other parameters")
    if _agent_bytes(general) != general_bytes:
        fail("pipeline: fine_tune changed the general agent's parameters")
    explore = dict(epsilon_initial=1.0, epsilon_decay=1.0)
    gpu, cpu = tune(**explore), tune(device="cpu", **explore)
    err = 0.0
    for (gw, gb), (cw, cb) in zip(gpu.params, cpu.params):
        for g, c in ((gw, cw), (gb, cb)):
            g, c = g.cpu(), c.cpu()
            over = torch.abs(g - c) - (FT_TOL + FT_TOL * torch.abs(c))
            if float(over.max()) > 0 or not bool(torch.isfinite(g).all()):
                fail(f"pipeline: epsilon=1 fine_tune on the card vs the CPU: "
                     f"max abs {float(torch.abs(g - c).max()):.3e} beyond "
                     f"{FT_TOL} abs + {FT_TOL} rel")
            err = max(err, float(torch.abs(g - c).max()))
    print(f"pipeline: fine_tune rerun bit-identical; general agent unchanged "
          f"bit for bit; epsilon=1 on the card vs the CPU: max abs {err:.3e} "
          f"(<= {FT_TOL} abs + {FT_TOL} rel)", flush=True)
    after = greedy_optimize(ft, [mol], svc, rcfg, env_cfg, seed=3)[0]
    print(f"pipeline: greedy reward before {trecs[worst].reward:.3f} -> after "
          f"fine-tune {after.reward:.3f}", flush=True)

    # (b) the filter script over the greedy records, with oracle validation
    results = filter_molecules(
        [(r.molecule, r.bde, r.ip) for r in recs + trecs + [after]],
        known=list(train[:n]) + list(test[:N_TEST]), criteria=FilterCriteria())
    survivors = [r for r in results if r.passed]
    print(f"pipeline: filter: {len(survivors)}/{len(results)} pass BDE<76 & "
          f"IP>145 & SA<=3.5", flush=True)
    for r in survivors:
        dft_bde, dft_ip = oracle_bde(r.molecule), oracle_ip(r.molecule)
        if dft_bde is None or not (math.isfinite(dft_bde) and math.isfinite(dft_ip)):
            fail(f"pipeline: survivor {canonical_smiles(r.molecule)} has oracle "
                 f"BDE {dft_bde}, IP {dft_ip}")
        print(f"pipeline:   {canonical_smiles(r.molecule):44s} ML bde/ip "
              f"{r.bde:5.1f}/{r.ip:5.1f}  DFT {dft_bde:5.1f}/{dft_ip:5.1f}  "
              f"SA {r.sa:.2f}", flush=True)

    # (c) the truth run at the launcher's Q width: straight, killed and
    # resumed in fresh processes, and under a FaultPlan
    work = ROOT / "build" / "chip_smoke_verify"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    packed_qnet_stacked.launches = 0
    t0 = time.perf_counter()
    straight, vtr = verify.run(verify.parser().parse_args(
        VERIFY_ARGS + ["--out", str(work / "straight.npz")]))
    straight_s = time.perf_counter() - t0
    launches_verify = packed_qnet_stacked.launches
    if launches_verify != vtr.n_q_dispatches or launches_verify == 0:
        fail(f"pipeline: verify packed_qnet_stacked launches {launches_verify} "
             f"!= fleet Q dispatches {vtr.n_q_dispatches}")
    if int(straight["recompiles_after_warmup"]) != 0:
        fail(f"pipeline: verify: {int(straight['recompiles_after_warmup'])} "
             f"shape events after warmup")
    print(f"pipeline: verify straight run in {straight_s:.3f} s | "
          f"{int(straight['n_transitions'].sum())} transitions | "
          f"{int(straight['warmup_compiles'])} warmup shape events, 0 after | "
          f"losses {straight['losses'].tolist()} | launches {launches_verify} "
          f"= fleet Q dispatches {vtr.n_q_dispatches}", flush=True)

    ck = ["--ckpt-dir", str(work / "ckpt")]
    t0 = time.perf_counter()
    killed = _verify_child(VERIFY_ARGS + ck + ["--kill-at", "2", "--out",
                                               str(work / "killed.npz")])
    killed_s = time.perf_counter() - t0
    if killed.returncode != -9:
        fail(f"pipeline: verify --kill-at 2 exited {killed.returncode}, not by "
             f"SIGKILL:\n{killed.stdout}{killed.stderr}")
    t0 = time.perf_counter()
    resumed = _verify_child(VERIFY_ARGS + ck + ["--resume", "--out",
                                                str(work / "resumed.npz")])
    resumed_s = time.perf_counter() - t0
    if resumed.returncode != 0:
        fail(f"pipeline: verify --resume exited {resumed.returncode}:\n"
             f"{resumed.stdout}{resumed.stderr}")
    with np.load(work / "resumed.npz") as z:
        got = {k: z[k] for k in z.files}
    diff = _report_diff(got, straight, ("meta", "warmup_compiles",
                                        "recompiles_after_warmup"))
    if diff or int(got["recompiles_after_warmup"]) != 0:
        fail(f"pipeline: resumed report differs from the straight run on "
             f"{diff}, or has shape events after warmup")
    print(f"pipeline: verify --kill-at 2 died by SIGKILL in {killed_s:.3f} s; "
          f"--resume in {resumed_s:.3f} s (fresh processes): report "
          f"bit-identical to the straight run on all {len(straight) - 3} "
          f"compared keys, 0 shape events after warmup", flush=True)

    packed_qnet_stacked.launches = 0
    t0 = time.perf_counter()
    faulted, ftr = verify.run(verify.parser().parse_args(
        VERIFY_ARGS + ["--faults", "predict,chem",
                       "--out", str(work / "faulted.npz")]))
    faulted_s = time.perf_counter() - t0
    diff = _report_diff(faulted, straight, ("meta", "warmup_compiles",
                                            "recompiles_after_warmup")
                        + FAULT_KEYS)
    counters = {k: int(faulted[k]) for k in FAULT_KEYS}
    if diff or counters["n_faults_injected"] == 0 or counters["n_retries"] == 0:
        fail(f"pipeline: faulted verify differs from the fault-free run on "
             f"{diff} ({counters})")
    if packed_qnet_stacked.launches != ftr.n_q_dispatches:
        fail("pipeline: faulted verify launches != its fleet Q dispatches")
    print(f"pipeline: verify --faults predict,chem in {faulted_s:.3f} s: "
          f"bit-identical to the fault-free run | {counters}", flush=True)

    # (d) shallower Q networks (the truth run's default width, the
    # examples') through the five-layer Q kernels, padded with identity
    # layers, against their plain versions; then the quickstart twin on
    # train_rl's predictor cache
    from repro_torch.core.agent import QNetwork
    from repro_torch.kernels.fused_qnet.ref import qnet_ref
    from repro_torch.kernels.packed_qnet.ref import packed_qnet_stacked_ref
    g = torch.Generator().manual_seed(7)
    x = torch.rand((300, 2049), generator=g)
    bits = (torch.randint(0, 256, (4, 256, 256), generator=g)
            & torch.randint(0, 256, (4, 256, 256), generator=g)).to(torch.uint8)
    frac = torch.randint(0, 11, (4, 256), generator=g).float() / 10.0
    errs = []
    for hidden in SHALLOW_HIDDEN:
        layers = [(w, 0.1 * torch.randn(b.shape, generator=g)) for w, b in
                  QNetwork(hidden=hidden, generator=g, device="cpu").layers()]
        stacked = [(torch.stack([w * (1 + 0.1 * i) for i in range(4)]),
                    torch.stack([b] * 4)) for w, b in layers]
        cuda = lambda ls: [(w.cuda(), b.cuda()) for w, b in ls]
        errs.append(_check_close(
            f"pipeline: fused_qnet at hidden {hidden}",
            fused_qnet(cuda(layers), x.cuda()).cpu(), qnet_ref(x, layers), TOL))
        errs.append(_check_close(
            f"pipeline: packed_qnet_stacked at hidden {hidden}",
            packed_qnet_stacked(cuda(stacked), bits.cuda(), frac.cuda()).cpu(),
            packed_qnet_stacked_ref(bits, frac, stacked), TOL))
    print(f"pipeline: fused_qnet (300 rows) and packed_qnet_stacked (4 x 256) "
          f"at hidden {list(SHALLOW_HIDDEN)}, padded to five layers: max "
          f"|kernel - plain| {max(errs):.3e} (<= {TOL} abs + {TOL} rel)",
          flush=True)

    packed_qnet_stacked.launches = 0
    fused_qnet.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(out):
        quickstart.main(["--device", "cuda"], cache_dir=str(cache_dir))
    qs_s = time.perf_counter() - t0
    text = out.getvalue()
    print("\n".join("pipeline: quickstart | " + l for l in text.splitlines()),
          flush=True)
    m = re.search(r"acting: (\d+) Q dispatches for (\d+) fleet steps", text)
    if m is None or m.group(1) != m.group(2) or \
            packed_qnet_stacked.launches != int(m.group(1)) or \
            fused_qnet.launches == 0 or "pass BDE<76" not in text:
        fail(f"pipeline: quickstart acting line {m and m.group(0)}, "
             f"packed_qnet_stacked launches {packed_qnet_stacked.launches}, "
             f"fused_qnet launches {fused_qnet.launches}")
    print(f"pipeline: quickstart in {qs_s:.3f} s | packed_qnet_stacked "
          f"launches {packed_qnet_stacked.launches} = Q dispatches = fleet "
          f"steps; fused_qnet launches {fused_qnet.launches} (greedy)",
          flush=True)
    print(f"pipeline: phase total {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"fused_qnet": launches_ft,
            "packed_qnet_stacked": launches_verify,
            "quickstart_packed": int(m.group(1)),
            "quickstart_fused": fused_qnet.launches}


def _row(name, source, replaces, shape, launches, max_abs, ms, plain_ms,
         library_ms, flops, nbytes, peak_ops, peak, **extra):
    """One kernel record: bound = max(bytes / HBM rate, ops / the peak for
    the inputs' type)."""
    t_ops, t_bytes = flops / peak_ops, nbytes / peak[1]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "shape": shape, "launches": launches, "max_abs_err": max_abs,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6, **extra}


def _packed_weights():
    return [(w[0].contiguous(), b[0].contiguous()) for w, b in _stacked_weights(1)]


def _packed_rows(n: int):
    """phase_packed_kernel's seeded rows: bits u8 [n, 256], frac [n]."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(n)
    rand_u8 = lambda: torch.randint(0, 256, (n, 256), generator=g,
                                    device="cuda").to(torch.uint8)
    bits = rand_u8() & rand_u8()
    frac = torch.randint(0, 11, (n,), generator=g, device="cuda").float() / 10.0
    return bits, frac


def phase_packed_kernel(peak) -> list[dict]:
    """``packed_qnet``: the W = 1 launch of the packed kernel."""
    import torch
    from repro_torch.core.packed_batch import unpack_bits
    from repro_torch.kernels.fused_qnet.ops import fused_qnet
    from repro_torch.kernels.packed_qnet.ops import packed_qnet
    from repro_torch.kernels.packed_qnet.ref import packed_qnet_ref

    weights = _packed_weights()
    n_params = sum(w.numel() + b.numel() for w, b in weights)
    mac_per_row = sum(w.numel() for w, _ in weights)
    rows = []
    for n in PACKED_ROWS:
        bits, frac = _packed_rows(n)
        qk = packed_qnet(weights, bits, frac)
        qp = packed_qnet_ref(bits, frac, weights)
        torch.cuda.synchronize()
        err = (qk - qp).abs()
        max_abs = float(err.max())
        if qk.shape != (n,) or not bool((err <= TOL + TOL * qp.abs()).all()):
            fail(f"packed_qnet N={n}: shape {tuple(qk.shape)}, max |kernel - "
                 f"plain| {max_abs:.3e} exceeds {TOL} + {TOL}*|plain|")
        if not torch.equal(packed_qnet(weights, bits, frac), qk):
            fail(f"packed_qnet N={n}: two launches on one input differ")
        x = torch.cat([unpack_bits(bits), frac[:, None]], -1).contiguous()
        if not torch.equal(fused_qnet(weights, x), qk):
            fail(f"packed_qnet N={n}: differs from fused_qnet on the densified rows")

        def library():                           # yardstick only
            h = x
            for li, (w, b) in enumerate(weights):
                h = torch.addmm(b, h, w)
                if li < len(weights) - 1:
                    h = torch.relu_(h)
            return h[:, 0]

        rows.append(_row(
            "packed_qnet", "src/repro_torch/kernels/packed_qnet/csrc/packed_qnet.cu",
            "src/repro/kernels/packed_qnet/packed_qnet.py:91", [n, 256], 0,
            max_abs, cuda_ms(lambda: packed_qnet(weights, bits, frac), 20),
            cuda_ms(lambda: packed_qnet_ref(bits, frac, weights), 20),
            cuda_ms(library, 20), 2.0 * n * mac_per_row,
            bits.numel() + 4.0 * (n + n_params + n), peak[0], peak,
            path="none: no path of the reference runs packed_qnet_rows",
            fused_qnet_bitwise=True))
        r = rows[-1]
        print(f"packed_qnet N={n}: max_abs_err {max_abs:.3e} | rerun and "
              f"fused_qnet on densified rows bit-identical | kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
    return rows


def _attn_pairs(Sq, Sk, causal, window, prefix) -> int:
    from repro_torch.models.layers import make_attn_mask
    return int(make_attn_mask(Sq, Sk, causal=causal, window=window,
                              prefix_len=prefix).sum())


def _ssd_flop(B, L, H, P, N, Q) -> float:
    """Q x Q products over the causal half, the carry-in and the state
    update, per (b, h, chunk); elementwise work not counted."""
    return B * H * (L // Q) * (Q * (Q + 1) * (N + P) + 4.0 * Q * P * N)


def _check_close(tag, got, want, tol) -> float:
    import torch
    if got.shape != want.shape or got.dtype != want.dtype \
            or not bool(torch.isfinite(got).all()):
        fail(f"{tag}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} "
             f"{want.dtype}, or non-finite values")
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if not bool((err <= tol + tol * w.abs()).all()):
        fail(f"{tag}: max |kernel - plain| {float(err.max()):.3e} exceeds "
             f"{tol} + {tol}*|plain|")
    return float(err.max())


def _flash_case(B, Sq, Sk, H, K, D, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, S, n, D, generator=g, device="cuda").to(dtype)
               for S, n in ((Sq, H), (Sk, K), (Sk, K)))
    return q, k, v


def _ssd_case(B, L, H, P, G, N, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(B, L, H, P, generator=g, device="cuda") * 0.5).to(dtype)
    dt = torch.randn(B, L, H, generator=g, device="cuda").abs() * 0.1 + 0.01
    A = torch.randn(H, generator=g, device="cuda").abs() + 0.5
    Bm = (torch.randn(B, L, G, N, generator=g, device="cuda") * 0.3).to(dtype)
    Cm = (torch.randn(B, L, G, N, generator=g, device="cuda") * 0.3).to(dtype)
    return x, dt, A, Bm, Cm


def phase_lm_kernels(peak) -> tuple[list[dict], dict]:
    """``flash_attention`` and ``ssd_scan`` against their plain versions.
    Returns the records and, per arch, each bf16 path-shape kernel's
    ``(name, launches a forward at that shape, ms)``."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_ref, ssd_stages
    from repro_torch.models.ssm import ssd_chunked

    def plain_attn(q, k, v, **mk):
        return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), **mk).transpose(1, 2)

    rows, path_ms = [], {}
    cases = [(B, S, S, H, K, D, c, w, p) for B, S, H, K, D, c, w, p in FLASH_SMALL]
    for i, (B, Sq, Sk, H, K, D, causal, window, prefix) in enumerate(
            cases + list(FLASH_EDGES)):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            mk = dict(causal=causal, window=window, prefix_len=prefix)
            q, k, v = _flash_case(B, Sq, Sk, H, K, D, dtype, i)
            tag = f"flash_attention B={B} Sq={Sq} Sk={Sk} H={H} K={K} D={D} {mk} {name}"
            o = flash_attention(q, k, v, **mk)
            err = _check_close(tag, o, plain_attn(q, k, v, **mk), FLASH_TOL[name])
            if not torch.equal(flash_attention(q, k, v, **mk), o):
                fail(f"{tag}: two launches differ")
            print(f"{tag}: max_abs_err {err:.3e}, rerun bit-identical", flush=True)

    # strided bf16 views: 16-byte aligned ones run, misaligned ones raise
    g = torch.Generator(device="cuda").manual_seed(400)
    wide = torch.randn(2, 192, 3, 4, 72, generator=g, device="cuda").bfloat16()
    q, k, v = (wide[:, :, j, :, :64] for j in range(3))    # S stride 864, H 72
    err = _check_close("flash_attention strided bf16 views", flash_attention(q, k, v),
                       plain_attn(q, k, v, causal=True), FLASH_TOL["bfloat16"])
    odd = torch.randn(1, 64, 2, 65, generator=g, device="cuda").bfloat16()[..., 1:]
    try:
        flash_attention(odd, odd, odd)
        fail("flash_attention: a bf16 view 2 bytes off alignment did not raise")
    except ValueError:
        pass
    print(f"flash_attention strided bf16 views: max_abs_err {err:.3e}; a "
          f"misaligned bf16 view raises ValueError", flush=True)

    rows += _flash_path_rows(peak, plain_attn, path_ms)

    def check_ssd(tag, x, dt, A, Bm, Cm, Q, stages=False):
        """The kernel against ssd_ref within SSD_TOL (and, with ``stages``,
        against ssd_stages within SSD_STAGES_TOL), and a bit-identical rerun;
        returns the max abs errors against ssd_ref and ssd_stages."""
        name = str(x.dtype).split(".")[1]
        y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=Q)
        yr, sr = ssd_ref(x, dt, A, Bm, Cm)
        err = max(_check_close(tag + " y", y, yr, SSD_TOL[name]),
                  _check_close(tag + " state", st, sr, SSD_TOL[name]))
        err_s = None
        if stages:
            ys, ss = ssd_stages(x, dt, A, Bm, Cm, Q)
            err_s = max(
                _check_close(tag + " y vs ssd_stages", y, ys, SSD_STAGES_TOL[name]),
                _check_close(tag + " state vs ssd_stages", st, ss, SSD_STAGES_TOL[name]))
        y2, st2 = ssd_scan(x, dt, A, Bm, Cm, chunk=Q)
        if not (torch.equal(y2, y) and torch.equal(st2, st)):
            fail(f"{tag}: two launches differ")
        return err, err_s

    for i, (B, L, H, P, G, N, Q) in enumerate(SSD_SMALL):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            tag = f"ssd_scan B={B} L={L} H={H} P={P} G={G} N={N} chunk={Q} {name}"
            err, err_s = check_ssd(tag, *_ssd_case(B, L, H, P, G, N, dtype, 200 + i), Q,
                                   stages=True)
            print(f"{tag}: max_abs_err {err:.3e} vs ssd_ref, {err_s:.3e} vs "
                  f"ssd_stages, rerun bit-identical", flush=True)

    # x, B and C as the model passes them: strided views of one conv output
    B, L, H, P, G, N, Q = SSD_VIEWS
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(500)
        xbc = (torch.randn(B, L, H * P + 2 * G * N, generator=g, device="cuda")
               * 0.4).to(dtype)
        x, Bm, Cm = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
        x, Bm, Cm = x.unflatten(-1, (H, P)), Bm.unflatten(-1, (G, N)), Cm.unflatten(-1, (G, N))
        dt = torch.rand(B, L, H, generator=g, device="cuda") * 0.1 + 0.01
        A = torch.rand(H, generator=g, device="cuda") + 0.5
        tag = (f"ssd_scan strided views of one [{B}, {L}, {H * P + 2 * G * N}] "
               f"buffer, N={N} chunk={Q} {str(dtype).split('.')[1]}")
        err, err_s = check_ssd(tag, x, dt, A, Bm, Cm, Q, stages=True)
        print(f"{tag}: max_abs_err {err:.3e} vs ssd_ref, {err_s:.3e} vs "
              f"ssd_stages, rerun bit-identical", flush=True)

    for arch, (B, L, H, P, G, N, Q) in SSD_PATHS.items():
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            x, dt, A, Bm, Cm = _ssd_case(B, L, H, P, G, N, dtype, 300)
            tag = f"ssd_scan {arch} path {name}"
            err, _ = check_ssd(tag, x, dt, A, Bm, Cm, Q)
            y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=Q)
            yc, sc = ssd_chunked(x, dt, A, Bm, Cm, chunk=Q)
            err_c = max(_check_close(tag + " y vs ssd_chunked", y, yc, SSD_TOL[name]),
                        _check_close(tag + " state vs ssd_chunked", st, sc,
                                     SSD_TOL[name]))
            del y, st, yc, sc
            ms = cuda_ms(lambda: ssd_scan(x, dt, A, Bm, Cm, chunk=Q), 20)
            if dtype == torch.bfloat16:
                path_ms.setdefault(arch, []).append(
                    ("ssd_scan", _lm_launches(_cell_cfg(arch))["ssd_scan"], ms))
            es = x.element_size()
            nbytes = es * (2 * x.numel() + Bm.numel() + Cm.numel() + B * H * P * N) \
                + 4 * (dt.numel() + A.numel())
            flops = _ssd_flop(B, L, H, P, N, Q)
            rows.append(_row(
                "ssd_scan", "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                "src/repro/kernels/ssd_scan/ssd_scan.py:86", [B, L, H, P, G, N, Q],
                None, err, ms, cuda_ms(lambda: ssd_ref(x, dt, A, Bm, Cm), 1, warmup=1),
                None, flops, nbytes, peak[2] if dtype == torch.bfloat16 else peak[0],
                peak, dtype=name, arch=arch, bound_f32_ffma_ms=flops / peak[0] * 1e3,
                ssd_chunked_max_abs=err_c,
                ssd_chunked_ms=cuda_ms(lambda: ssd_chunked(x, dt, A, Bm, Cm, chunk=Q), 3,
                                       warmup=1)))
            r, pr14 = rows[-1], PR14_SSD_MS.get((name, arch))
            print(f"ssd_scan {arch} path B={B} L={L} H={H} P={P} G={G} N={N} "
                  f"chunk={Q} {name}: max_abs_err {err:.3e} vs ssd_ref, {err_c:.3e} "
                  f"vs ssd_chunked, rerun bit-identical | kernel {ms:.4f} ms"
                  + (f" (PR 14's kernel: {pr14} ms)" if pr14 else "")
                  + f", plain (ssd_ref) {r['plain_ms']:.4f} ms, ssd_chunked "
                  f"{r['ssd_chunked_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}), f32 FFMA bound {r['bound_f32_ffma_ms']:.4f} ms",
                  flush=True)
            del x, dt, A, Bm, Cm
            torch.cuda.empty_cache()
    return rows, path_ms


def _flash_path_rows(peak, plain_attn, path_ms) -> list[dict]:
    """``flash_attention`` at every LM prefill's attention shape
    (FLASH_PATHS), bf16 and f32: held to its plain version, a rerun
    bit-identical, timed beside SDPA (one call on the same inputs) and the
    bound; the bf16 times go into ``path_ms``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.layers import make_attn_mask

    rows = []
    for i, (arch, site, B, S, H, K, D, causal, window, prefix, gqa) in enumerate(
            FLASH_PATHS):
        mk = dict(causal=causal, window=window, prefix_len=prefix)
        pairs = B * H * _attn_pairs(S, S, causal, window, prefix)
        mask = make_attn_mask(S, S, device="cuda", **mk) if (window or prefix) else None
        cfg = _cell_cfg(arch)
        enc = cfg.encdec.n_enc_layers if cfg.encdec else 0
        at_shape = enc if site == "encoder" else _lm_launches(cfg)["flash_attention"] - enc
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            tag = (f"flash_attention {arch} {site + ' ' if site else ''}path B={B} "
                   f"S={S} H={H} K={K} D={D} {mk} {name}")
            q, k, v = _flash_case(B, S, S, H, K, D, dtype, 600 + i)
            o = flash_attention(q, k, v, **mk)
            err = _check_close(tag, o, plain_attn(q, k, v, **mk), FLASH_TOL[name])
            if not torch.equal(flash_attention(q, k, v, **mk), o):
                fail(f"{tag}: two launches differ")
            qt = q.transpose(1, 2).contiguous()
            kt, vt = (t.transpose(1, 2).contiguous() if gqa else
                      t.repeat_interleave(H // K, dim=2).transpose(1, 2).contiguous()
                      for t in (k, v))

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                    enable_gqa=gqa and K != H)
            lib_err = float((sdpa().transpose(1, 2).float() - o.float()).abs().max())
            ms = cuda_ms(lambda: flash_attention(q, k, v, **mk), 10)
            if dtype == torch.bfloat16:
                path_ms.setdefault(arch, []).append(("flash_attention", at_shape, ms))
            rows.append(_row(
                "flash_attention",
                "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention/flash_attention.py:99",
                [B, S, H, K, D], None, err, ms,
                cuda_ms(lambda: plain_attn(q, k, v, **mk), 2, warmup=1),
                cuda_ms(sdpa, 5, warmup=2), 4.0 * D * pairs,
                q.element_size() * (2 * B * S * H * D + 2 * B * S * K * D),
                peak[2] if dtype == torch.bfloat16 else peak[0], peak, dtype=name,
                arch=arch, **({"site": site} if site else {}), mask=mk, pairs=pairs,
                launches_at_shape=at_shape,
                bound_f32_ffma_ms=4.0 * D * pairs / peak[0] * 1e3,
                library_vs_kernel_max_abs=lib_err,
                library_call="scaled_dot_product_attention(" + ", ".join(
                    ["enable_gqa"] * (gqa and K != H)
                    + ["k, v expanded to H heads"] * (not gqa and K != H)
                    + ["boolean attn_mask"] * (mask is not None)
                    + ["is_causal"] * (causal and mask is None)) + ")"))
            r = rows[-1]
            print(f"{tag}: max_abs_err {err:.3e} (SDPA vs kernel {lib_err:.3e}), "
                  f"rerun bit-identical | kernel {ms:.4f} ms"
                  + (f" (all-FFMA kernel: {FFMA_FLASH_MS[name]} ms)" if arch == LM_ARCH
                     else "")
                  + f", plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), f32 FFMA bound "
                  f"{r['bound_f32_ffma_ms']:.4f} ms, {pairs / 1e6:.1f} M pairs, "
                  f"{at_shape} launches a forward at this shape", flush=True)
            del q, k, v, qt, kt, vt, o
            torch.cuda.empty_cache()
    return rows


def _profile_top(fn, top: int = 12, what: str = "lm: torch.profiler over one prefill") -> None:
    """Device time by kernel over one call of ``fn``, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    total_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    gemm_us = sum(e.self_device_time_total for e in events
                  if "gemm" in e.key.lower() or e.key.startswith("nvjet"))
    print(f"{what}: {total_us / 1e3:.2f} ms of "
          f"device kernel time in {len(events)} kernel names, of which cuBLAS "
          f"GEMMs ('gemm' or 'nvjet' names) {gemm_us / 1e3:.2f} ms", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d}x  "
              f"{e.key[:100]}", flush=True)


def _lm_cfg(arch: str, layers):
    """The published config, its decoder (and encoder) depth cut to
    ``layers`` where given."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is None:
        return cfg
    enc = replace(cfg.encdec, n_enc_layers=layers) if cfg.encdec else None
    return replace(cfg, n_layers=layers, encdec=enc)


def _cell_cfg(arch: str):
    """The config of ``arch``'s LM cell at the depth of its bf16 prefill."""
    return _lm_cfg(arch, next(c[1] for cells in LM_CELLS.values()
                              for c in cells if c[0] == arch))


def _lm_launches(cfg) -> dict:
    """Each LM kernel's launches in one ``use_pallas`` forward on the card:
    one ``flash_attention`` per self-attention application (the encoder's
    too; cross-attention is plain, as in the reference), one ``ssd_scan``
    call per SSM layer."""
    from repro_torch.models.model import hybrid_n_apps
    attn = {"hybrid": hybrid_n_apps(cfg) if cfg.family == "hybrid" else 0,
            "ssm": 0}.get(cfg.family, cfg.n_layers)
    return {"flash_attention": attn + (cfg.encdec.n_enc_layers if cfg.encdec else 0),
            "ssd_scan": cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0}


def _prefill_batch(cfg, B: int, S: int, seed: int, device) -> dict:
    """Tokens [B, S] in [1, vocab) from ``default_rng(seed)``, with the stub
    frames or patches the LM launcher feeds (``with_stub_inputs``)."""
    import numpy as np
    import torch
    from repro_torch.launch.train import with_stub_inputs
    tokens = np.random.default_rng(seed).integers(1, cfg.vocab, (B, S))
    batch = next(with_stub_inputs(cfg, [{"tokens": tokens}]))
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _positions_run(cfg, B: int, S: int) -> int:
    """Positions one forward runs: text, plus the image prefix or the
    encoder frames."""
    extra = cfg.vlm.n_patches if cfg.family == "vlm" else \
        cfg.encdec.n_frames if cfg.family == "encdec" else 0
    return B * (S + extra)


def _lm_route_parity(tag: str, arch: str, layers, B: int, S: int):
    """The f32 kernel route against the plain route at full width and
    ``layers`` (None: all), within LM_ROUTE_TOL of max |logits|, the aux
    loss alike, with exactly ``_lm_launches`` launches; where the config
    has an SSM, printed beside the plain route against itself with half the
    SSD chunk (the model's own f32 rounding floor).  Returns the f32 config
    and its parameters."""
    from dataclasses import replace

    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.models import count_params, forward_train, init_params

    cfg = replace(_lm_cfg(arch, layers), dtype="float32")
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = _prefill_batch(cfg, B, S, 1, "cuda")
    flash_attention.launches = ssd_scan.launches = 0
    lk, aux_k = forward_train(params, replace(cfg, use_pallas=True), batch)
    torch.cuda.synchronize()
    launches = {"flash_attention": flash_attention.launches,
                "ssd_scan": ssd_scan.launches}
    if launches != _lm_launches(cfg):
        fail(f"{tag}: {arch} f32 kernel route made {launches} launches, want "
             f"{_lm_launches(cfg)}")
    lp, aux_p = forward_train(params, cfg, batch)
    scale = float(lp.abs().max())
    err = float((lk - lp).abs().max())
    msg = (f"{tag}: {arch} f32, {cfg.n_layers} layers at full width "
           f"({count_params(cfg):,} parameters, init on the card {init_s:.2f} s), "
           f"B={B} S={S}: kernel route vs plain route max abs {err:.3e} on logits "
           f"of max |.| {scale:.3f} ({err / scale:.3e} of it), aux "
           f"{float(aux_k):.6f} vs {float(aux_p):.6f}, launches {launches}")
    if cfg.ssm is not None:
        half = replace(cfg, ssm=replace(cfg.ssm, chunk=cfg.ssm.chunk // 2))
        lc, _ = forward_train(params, half, batch)
        floor = float((lc - lp).abs().max())
        msg += (f"; plain route with {half.ssm.chunk}-chunks vs {cfg.ssm.chunk}-"
                f"chunks: {floor:.3e} ({floor / scale:.3e})")
        del lc
    print(msg, flush=True)
    if not bool(torch.isfinite(lk).all()) or err > LM_ROUTE_TOL * scale:
        fail(f"{tag}: {arch} kernel route differs from the plain route by "
             f"{err:.3e} > {LM_ROUTE_TOL} x {scale:.3f}")
    if abs(float(aux_k) - float(aux_p)) > LM_ROUTE_TOL * max(abs(float(aux_p)), 1e-6):
        fail(f"{tag}: {arch} aux loss differs between the routes")
    del lk, lp
    return cfg, params


def _lm_prefill(tag: str, arch: str, B: int, S: int, path_ms, card: str) -> dict:
    """The cell's bf16 prefill at full width through ``make_prefill_step``
    with ``use_pallas``: exactly ``_lm_launches`` launches, [B, S, V] finite
    logits, a bit-identical rerun; timed with CUDA events and the host
    clock, each path kernel's share, the profiler table.  Returns the
    launches."""
    from dataclasses import replace

    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import count_params, init_params

    cfg = replace(_cell_cfg(arch), use_pallas=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = _prefill_batch(cfg, B, S, 0, "cuda")
    prefill = make_prefill_step(cfg)
    flash_attention.launches = ssd_scan.launches = 0
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    launches = {"flash_attention": flash_attention.launches,
                "ssd_scan": ssd_scan.launches}
    if launches != _lm_launches(cfg):
        fail(f"{tag}: one {arch} forward made {launches} launches, want "
             f"{_lm_launches(cfg)}")
    if tuple(logits.shape) != (B, S, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        fail(f"{tag}: {arch} bf16 prefill logits {tuple(logits.shape)} are not "
             f"[B, S, V] or not finite")
    if not torch.equal(prefill(params, batch), logits):
        fail(f"{tag}: {arch} bf16 prefill rerun is not bit-identical")
    del logits
    ms = cuda_ms(lambda: prefill(params, batch), 3, warmup=1)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    pos = _positions_run(cfg, B, S)
    shares = [(k, n, t, n * t / ms) for k, n, t in path_ms.get(arch, ())]
    print(f"{tag}: {arch} bf16 prefill, {cfg.n_layers} layers"
          + (f" + {cfg.encdec.n_enc_layers} encoder" if cfg.encdec else "")
          + f" at full width ({count_params(cfg):,} parameters, init {init_s:.2f} s), "
          f"B={B} S={S}: {ms:.2f} ms per forward (CUDA events) = "
          f"{pos / ms * 1e3:.0f} positions/s ({B * S / ms * 1e3:.0f} text "
          f"tokens/s); host clock {wall * 1e3:.2f} ms on {card} | per forward "
          + ", ".join(f"{n} {k} x {t:.3f} ms = {100 * f:.1f}%" for k, n, t, f in shares)
          + f", the rest {100 * (1 - sum(f for *_, f in shares)):.1f}% | launches "
          f"{launches}, rerun bit-identical, logits finite, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    _profile_top(lambda: prefill(params, batch), top=12 if tag == "lm" else 8,
                 what=f"{tag}: torch.profiler over one {arch} prefill")
    del params
    torch.cuda.empty_cache()
    return launches


def _lm_decode_vs_forward(cfg, params) -> None:
    """LM_DECODE f32 decode steps at full width against the kernel-route
    forward on the same tokens, within DECODE_TOL (the hybrid)."""
    from dataclasses import replace

    import numpy as np
    import torch
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import forward_train, init_cache

    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (1, LM_DECODE))).cuda()
    full, _ = forward_train(params, replace(cfg, use_pallas=True), {"tokens": tokens})
    step = make_serve_step(cfg)
    cache = init_cache(cfg, 1, LM_DECODE, device="cuda")
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(LM_DECODE):
        lg, cache = step(params, cache, tokens[:, t:t + 1])
        outs.append(lg[:, 0])
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    dec = torch.stack(outs, dim=1)
    dec_err = float((dec - full).abs().max())
    if not bool(((dec - full).abs() <= DECODE_TOL + DECODE_TOL * full.abs()).all()):
        fail(f"lm: decode differs from forward by {dec_err:.3e} (> "
             f"{DECODE_TOL} abs + rel)")
    print(f"lm: {LM_DECODE} f32 decode steps vs the kernel-route forward: "
          f"max abs {dec_err:.3e} (within {DECODE_TOL}); "
          f"{LM_DECODE / dec_s:.1f} tok/s at B=1 (host clock)", flush=True)


def _reduced_decode(tag: str, arch: str) -> None:
    """REDUCED_DECODE decode steps of the reduced f32 config on the card and
    on the CPU from the same parameters: logits within REDUCED_DECODE_TOL.
    For the dense and moe families also against the kernel-route forward
    on the card at the positions its capacity did not drop (all, dense),
    as tests/test_models.py::test_decode_matches_forward_moe holds them."""
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_cache, init_params, serve_step

    cfg = get_config(arch).reduced()
    cpu = init_params(cfg, 2, device="cpu")
    gpu = _to_cuda(cpu)
    tokens = _prefill_batch(cfg, 1, REDUCED_DECODE, 2, "cpu")["tokens"]
    caches = {d: init_cache(cfg, 1, REDUCED_DECODE, device=d) for d in ("cpu", "cuda")}
    outs = {"cpu": [], "cuda": []}
    for t in range(REDUCED_DECODE):
        for d, params in (("cpu", cpu), ("cuda", gpu)):
            lg, caches[d] = serve_step(params, cfg, caches[d], tokens[:, t:t + 1].to(d))
            outs[d].append(lg[:, 0].cpu())
    dec, ref = torch.stack(outs["cuda"], 1), torch.stack(outs["cpu"], 1)
    err = float((dec - ref).abs().max())
    if not bool(((dec - ref).abs() <= REDUCED_DECODE_TOL * (1 + ref.abs())).all()):
        fail(f"{tag}: {arch} reduced decode on the card differs from the CPU's "
             f"by {err:.3e}")
    msg = (f"{tag}: {arch} reduced f32, {REDUCED_DECODE} decode steps on the "
           f"card vs the CPU: max abs {err:.3e}")
    if cfg.family in ("dense", "moe"):
        full = make_prefill_step(replace(cfg, use_pallas=True))(
            gpu, {"tokens": tokens.cuda()}).cpu()
        per_pos = (dec - full).abs().amax(dim=-1)[0]
        matched = per_pos < 1e-3
        need = REDUCED_DECODE if cfg.family == "dense" else REDUCED_DECODE // 2
        if not bool(matched[0]) or int(matched.sum()) < need:
            fail(f"{tag}: {arch} decode vs forward per position {per_pos.tolist()}")
        msg += (f"; vs the kernel-route forward {int(matched.sum())} of "
                f"{REDUCED_DECODE} positions within 1e-3 (the rest dropped at "
                f"capacity by the grouped forward)" if cfg.family == "moe" else
                f"; vs the kernel-route forward max abs {float(per_pos.max()):.3e}")
    print(msg, flush=True)


def _to_cuda(tree):
    return {k: _to_cuda(v) if isinstance(v, dict) else v.cuda() for k, v in tree.items()}


def _lm_cells(tag: str, path_ms, card: str) -> dict:
    """Each cell of ``LM_CELLS[tag]``: the f32 route parity (and the
    hybrid's full-width decode vs forward on its parameters), the timed
    bf16 prefill, the reduced decode card vs CPU.  Returns each kernel's
    launches a forward, ``{(kernel, arch): n}``."""
    import torch
    out = {}
    for arch, _, B, S, route_layers, rB, rS in LM_CELLS[tag]:
        cfg, params = _lm_route_parity(tag, arch, route_layers, rB, rS)
        if arch == LM_ARCH:
            _lm_decode_vs_forward(cfg, params)
        del params
        torch.cuda.empty_cache()
        for name, n in _lm_prefill(tag, arch, B, S, path_ms, card).items():
            out[(name, arch)] = n
        _reduced_decode(tag, arch)
        torch.cuda.empty_cache()
    return out


def phase_lm(path_ms, card: str) -> dict:
    """zamba2-1.2b and mamba2-2.7b at full width (``_lm_cells``), then the
    LM serve launcher at its defaults."""
    import os
    out = _lm_cells("lm", path_ms, card)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    if res.returncode != 0:
        fail(f"lm: python -m repro_torch.launch.serve exited {res.returncode}:\n"
             f"{res.stderr[-2000:]}")
    print("lm: launcher: " + " | ".join(res.stdout.strip().splitlines()), flush=True)
    return out


def phase_lm_families(path_ms, card: str) -> dict:
    """The moe, encdec and vlm families (and yi-34b's GQA 7) through
    ``_lm_cells``."""
    t0 = time.perf_counter()
    out = _lm_cells("lm_families", path_ms, card)
    print(f"lm_families: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def _lm_batch(vocab: int, B: int, S: int, device: str, seed: int = 0) -> dict:
    """Random tokens [1, vocab), next-token labels, the last position masked."""
    import numpy as np
    import torch
    tokens = np.random.default_rng(seed).integers(1, vocab, (B, S))
    labels = np.concatenate([tokens[:, 1:], np.zeros((B, 1), tokens.dtype)], 1)
    mask = (labels != 0).astype(np.float32)
    return {k: torch.from_numpy(v).to(device)
            for k, v in (("tokens", tokens), ("labels", labels), ("mask", mask))}


def _lm_train_guard() -> None:
    """On the card a use_pallas loss on parameters that require grad raises
    in the kernel's wrapper with no launch; under no_grad it launches."""
    from dataclasses import replace

    import torch
    from repro_torch.checkpoint.checkpoint import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.launch.steps import loss_and_grads, with_leaves
    from repro_torch.models import forward_train, init_params

    for arch, kernel in (("stablelm-1.6b", flash_attention), ("mamba2-2.7b", ssd_scan)):
        cfg = replace(get_config(arch).reduced(), use_pallas=True)
        params = init_params(cfg, 0, device="cuda")
        batch = _lm_batch(cfg.vocab, 2, 64, "cuda")
        counts, before = (flash_attention.launches, ssd_scan.launches), kernel.launches
        try:
            loss_and_grads(params, cfg, batch)
        except RuntimeError as e:
            if f"{kernel.__name__} is forward only" not in str(e):
                raise
        else:
            fail(f"lm_train: a use_pallas loss of {arch} backpropagated through "
                 f"{kernel.__name__}")
        if (flash_attention.launches, ssd_scan.launches) != counts:
            fail(f"lm_train: the refused {arch} loss launched a kernel")
        trainable = with_leaves(params, [t.detach().requires_grad_()
                                         for t in tree_leaves(params)])
        with torch.no_grad():
            forward_train(trainable, cfg, batch)
        torch.cuda.synchronize()
        if kernel.launches == before:
            fail(f"lm_train: the no_grad {arch} forward did not launch "
                 f"{kernel.__name__}")
        print(f"lm_train: guard: {arch} use_pallas loss with grad raised in "
              f"{kernel.__name__} before any launch; under no_grad it launched "
              f"{kernel.launches - before} time(s)", flush=True)


def _lm_train_card_vs_cpu() -> None:
    """The reduced configs in f32 on the card and on the CPU, from the same
    parameters and SMILES batch: loss_fn, every gradient leaf, and one
    microbatches = 2 train step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.checkpoint.checkpoint import tree_leaves
    from repro_torch.launch.steps import loss_and_grads, make_train_step, with_leaves
    from repro_torch.launch.train import lm_batches
    from repro_torch.models import init_params

    batch = next(lm_batches(8, 64))
    for arch in LM_TRAIN_ARCHS:
        cfg = get_config(arch).reduced()
        cpu = init_params(cfg, 0, device="cpu")
        gpu = with_leaves(cpu, [t.cuda() for t in tree_leaves(cpu)])
        worst_loss, worst_leaf = 0.0, 0.0
        lc, gc = loss_and_grads(cpu, cfg, batch)
        lg, gg = loss_and_grads(gpu, cfg, batch)
        step, opt = make_train_step(cfg, microbatches=2)
        _, sc, mc = step(cpu, opt.init(cpu), batch)
        _, sg, mg = step(gpu, opt.init(gpu), batch)
        for tag, (l_cpu, l_gpu, leaves_cpu, leaves_gpu) in (
                ("loss_fn", (lc, lg, gc, gg)),
                ("microbatches=2 step", (mc, mg, sc.mu, sg.mu))):
            rel = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
            if not rel <= LM_LOSS_RTOL:
                fail(f"lm_train: {arch} {tag} loss on the card {float(l_gpu)!r} vs "
                     f"the CPU {float(l_cpu)!r}: {rel:.3e} > {LM_LOSS_RTOL}")
            for i, (a, b) in enumerate(zip(leaves_cpu, leaves_gpu)):
                scale = float(a.abs().max())
                err = float((b.cpu() - a).abs().max())
                if not err <= LM_GRAD_TOL * scale:
                    fail(f"lm_train: {arch} {tag} gradient leaf {i} {tuple(a.shape)}: "
                         f"card vs CPU {err:.3e} > {LM_GRAD_TOL} x {scale:.3e}")
                worst_leaf = max(worst_leaf, err / max(scale, 1e-30))
            worst_loss = max(worst_loss, rel)
        print(f"lm_train: {arch} reduced, f32, B 8 S 64 (SMILES): card vs CPU "
              f"loss {float(lg):.6f} vs {float(lc):.6f}, worst loss rel "
              f"{worst_loss:.3e} (<= {LM_LOSS_RTOL}), worst gradient leaf "
              f"{worst_leaf:.3e} of its max (<= {LM_GRAD_TOL}), over loss_fn "
              f"and a microbatches=2 step", flush=True)


def _clone_tree(tree):
    """``tree`` with every leaf cloned (a train step consumes its trees)."""
    from repro_torch.checkpoint.checkpoint import tree_leaves
    from repro_torch.launch.steps import with_leaves
    return with_leaves(tree, [t.clone() for t in tree_leaves(tree)])


def _lm_train_full_width() -> dict:
    """zamba2-1.2b at full width, bf16, remat, through make_train_step.
    Returns each kernel's launches over the timed steps."""
    import warnings

    import torch
    from repro_torch.checkpoint.checkpoint import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.fused_qnet.ops import fused_qnet
    from repro_torch.kernels.packed_qnet.ops import packed_qnet, packed_qnet_stacked
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.kernels.leaf_adam.ops import leaf_adam
    from repro_torch.kernels.stacked_adam.ops import stacked_adam
    from repro_torch.models import count_params, init_params

    kernels = (fused_qnet, packed_qnet_stacked, packed_qnet, flash_attention,
               ssd_scan, stacked_adam)
    cfg = get_config(LM_ARCH)
    if not cfg.remat or cfg.use_pallas:
        fail(f"lm_train: {LM_ARCH} should train with remat on and use_pallas off")
    B, S = LM_TRAIN
    params = init_params(cfg, 0, device="cuda")
    step, opt = make_train_step(cfg)
    state = opt.init(params)
    batch = _lm_batch(cfg.vocab, B, S, "cuda")
    # the step consumes its trees: clones for the rerun and the final check
    init_tree = _clone_tree(params)
    twin = (_clone_tree(params), state._replace(
        step=state.step.clone(), mu=[t.clone() for t in state.mu],
        nu=[t.clone() for t in state.nu]))
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p1, s1, l1 = step(params, state, batch)          # warm
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            p1b, s1b, l1b = step(*twin, batch)               # its rerun
            torch.cuda.synchronize()
            same = torch.equal(l1, l1b) and all(
                torch.equal(a, b) for a, b in zip(
                    tree_leaves(p1) + s1.mu + s1.nu,
                    tree_leaves(p1b) + s1b.mu + s1b.nu))
            if not same:
                diffs = [(i, float((a.float() - b.float()).abs().max()))
                         for i, (a, b) in enumerate(zip(tree_leaves(p1), tree_leaves(p1b)))
                         if not torch.equal(a, b)]
                fail(f"lm_train: the rerun of a {LM_ARCH} train step is not "
                     f"bit-identical: loss {float(l1)!r} vs {float(l1b)!r}, "
                     f"parameter leaves (index, max abs) {diffs[:8]}")
            del state, twin, p1b, s1b, l1b
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()     # from here: one training loop
            firsts = [float(m.abs().max()) for m in s1.mu]
            if not all(math.isfinite(m) and m > 0 for m in firsts):
                fail(f"lm_train: a {LM_ARCH} leaf got no finite nonzero gradient: "
                     f"{firsts}")
            for k in kernels + (leaf_adam,):
                k.launches = 0
            cur, st, losses, ms = p1, s1, [float(l1)], []
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            for _ in range(LM_TRAIN_STEPS):
                start.record()
                cur, st, loss = step(cur, st, batch)
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
                losses.append(float(loss))
            launches = {k.__name__: k.launches for k in kernels}
            fused = leaf_adam.launches
            peak = torch.cuda.max_memory_allocated() / 2**30
            messages = sorted({str(w.message).split("\n")[0][:160] for w in caught})
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
    if any(launches.values()) or fused != LM_TRAIN_STEPS:
        fail(f"lm_train: {LM_ARCH} train steps launched kernels {launches} and "
             f"leaf_adam {fused} times (want 0 and {LM_TRAIN_STEPS}: its Adam)")
    launches["leaf_adam"] = fused
    if not all(math.isfinite(l) for l in losses):
        fail(f"lm_train: {LM_ARCH} train losses are not finite: {losses}")
    unchanged = [i for i, (a, b) in enumerate(zip(tree_leaves(init_tree), tree_leaves(cur)))
                 if torch.equal(a, b)]
    norms = [i for i in unchanged if tree_leaves(init_tree)[i].dtype == torch.bfloat16
             and bool((tree_leaves(init_tree)[i].abs() == 1).all())]
    if unchanged != norms:
        fail(f"lm_train: {LM_ARCH} leaves {sorted(set(unchanged) - set(norms))} did "
             f"not change in {1 + LM_TRAIN_STEPS} steps")
    print(f"lm_train: {LM_ARCH} {count_params(cfg):,} parameters, bf16, remat, "
          f"B={B} S={S} through make_train_step: warm step {warm_s:.2f} s "
          f"(host clock), rerun bit-identical (deterministic algorithms on); "
          f"{LM_TRAIN_STEPS} steps {', '.join(f'{m:.2f}' for m in ms)} ms "
          f"(CUDA events) = {B * S / (min(ms) / 1e3):.0f} tokens/s at the best, "
          f"{B * S * LM_TRAIN_STEPS / (sum(ms) / 1e3):.0f} over the {LM_TRAIN_STEPS}; "
          f"losses {', '.join(f'{l:.4f}' for l in losses)}; peak memory "
          f"{peak:.2f} GiB over the timed steps (the initial parameters kept for "
          f"the check included); launches {launches}; {len(norms)} leaves unchanged, "
          f"all bf16 norm scales of 1.0", flush=True)
    for m in messages:
        print(f"lm_train: warning under deterministic algorithms: {m}", flush=True)
    # the step's two halves apart: loss and gradients, then Adam in place
    torch.cuda.reset_peak_memory_stats()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    marks[0].record()
    _, grads = loss_and_grads(cur, cfg, batch)
    marks[1].record()
    leaves = tree_leaves(cur)
    st = opt.update_in_place(grads, st, leaves)
    marks[2].record()
    torch.cuda.synchronize()
    print(f"lm_train: one {LM_ARCH} step split: loss and gradients "
          f"{marks[0].elapsed_time(marks[1]):.2f} ms, Adam in place (leaf_adam: "
          f"clip, moments, update) {marks[1].elapsed_time(marks[2]):.2f} ms (CUDA "
          f"events); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB with the "
          f"parameters, moments and initial parameters resident", flush=True)
    del grads, leaves
    _profile_top(lambda: step(cur, st, batch), top=15,
                 what=f"lm_train: torch.profiler over one {LM_ARCH} train step")
    del params, init_tree, p1, s1, cur, st
    torch.cuda.empty_cache()
    return launches


def _run_module(tag: str, args: list[str]) -> tuple[list[str], float]:
    """``python -m <args>`` from the checkout; its stdout lines and wall s."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", *args], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=LM_TRAIN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"{tag}: python -m {' '.join(args)} exited {res.returncode}:\n"
             f"{res.stderr[-2000:]}")
    return res.stdout.strip().splitlines(), wall


def phase_lm_train() -> dict:
    """The LM training step: the gradient guard, card vs CPU, zamba2-1.2b
    at full width, the launcher at its defaults and the example twin.
    Returns each kernel's launches over the full-width steps."""
    _lm_train_guard()
    _lm_train_card_vs_cpu()
    launches = _lm_train_full_width()

    lines, wall = _run_module("lm_train", ["repro_torch.launch.train", "--mode", "lm"])
    steps = [float(l.split("loss ")[1].split()[0]) for l in lines if l.startswith("[step")]
    final = json.loads(lines[-1])
    if not (steps and math.isfinite(final["final_loss"]) and final["final_loss"] < steps[0]
            and final["steps"] == 50):
        fail(f"lm_train: the launcher's loss did not fall: {lines}")
    print(f"lm_train: python -m repro_torch.launch.train --mode lm (stablelm-1.6b, "
          f"full width, bf16, B 8, S 64, 50 steps): {wall:.1f} s wall with start-up; "
          f"loss {steps[0]:.4f} at step 1 -> {final['final_loss']:.4f} | "
          + " | ".join(lines), flush=True)
    lines, wall = _run_module("lm_train", ["repro_torch.examples.backbone_lm"])
    print(f"lm_train: python -m repro_torch.examples.backbone_lm: {wall:.1f} s wall; "
          f"{lines[-1]}", flush=True)
    return launches


def _qnet_step_inputs():
    """damoldqn's seeded parameters (online, and a perturbed target) and a
    replay batch at ``qnet_batch_specs``' shape, on the CPU: fingerprint
    bits with a steps-left feature, a random legal-action mask with every
    16th row empty."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config("damoldqn")
    params = init_params(cfg, 0, device="cpu")
    target = {"layers": [{k: v * 0.9 + 0.01 for k, v in l.items()}
                         for l in init_params(cfg, 1, device="cpu")["layers"]]}
    rng = np.random.default_rng(0)
    B, C = QNET_BATCH, QNET_CANDIDATES

    def fps(*shape):
        x = np.empty((*shape, 2049), np.float32)
        x[..., :2048] = rng.random((*shape, 2048), np.float32) < 0.1
        x[..., 2048] = rng.integers(0, 11, shape) / 10.0
        return x
    mask = (rng.random((B, C)) < 0.6).astype(np.float32)
    mask[::16] = 0.0
    batch = {"states": fps(B), "rewards": rng.standard_normal(B).astype(np.float32),
             "dones": (rng.random(B) < 0.3).astype(np.float32),
             "next_fps": fps(B, C), "next_mask": mask}
    return cfg, params, target, {k: torch.from_numpy(v) for k, v in batch.items()}


def _qnet_update_err(p0, p1, p1_cpu, mu_cpu) -> float:
    """Max |update on the card - update on the CPU| of one Adam step, where
    the CPU's first moment is above QNET_UPDATE_MASK of its leaf's max (a
    near-zero gradient's update is g / (|g| + eps), ill-conditioned).  A
    step that moved nothing, or part of Adam's lr-sized update, fails."""
    import torch
    from repro_torch.checkpoint.checkpoint import tree_leaves
    worst = 0.0
    for i, (a, card, want, m) in enumerate(zip(tree_leaves(p0), tree_leaves(p1),
                                               tree_leaves(p1_cpu), mu_cpu)):
        sel = m.abs() > QNET_UPDATE_MASK * m.abs().max()
        diff = ((card.cpu() - a) - (want - a)).abs()[sel]
        if not bool(sel.any()) or not bool(torch.isfinite(diff).all()):
            fail(f"dryrun: qnet leaf {i}: no gradient above the mask, or a "
                 f"non-finite update")
        worst = max(worst, float(diff.max()))
        if worst > QNET_UPDATE_TOL * QNET_LR:
            fail(f"dryrun: qnet leaf {i}: the update on the card differs from the "
                 f"CPU's by {worst:.3e} > {QNET_UPDATE_TOL} x lr {QNET_LR}")
    return worst


def _to(tree, device):
    from repro_torch.checkpoint.checkpoint import tree_leaves
    from repro_torch.launch.steps import with_leaves
    return with_leaves(tree, [t.to(device) for t in tree_leaves(tree)])


def _dryrun_launcher() -> dict:
    """``python -m repro_torch.launch.dryrun`` on the host, DRYRUN_RUNS in
    parallel processes that see no card, into a fresh ``build/dryrun``:
    every report ``ok`` or ``skipped`` (damoldqn's other shapes with the
    reference's reasons).  Returns the reports by file name."""
    import os
    import shutil
    from repro_torch.launch.dryrun import SKIP

    out = ROOT / "build" / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *a,
                               "--out", str(out)], env=env, cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for a in DRYRUN_RUNS]
    try:
        for a, p in zip(DRYRUN_RUNS, procs):
            stdout, stderr = p.communicate(timeout=DRYRUN_TIMEOUT_S)
            if p.returncode != 0:
                fail(f"dryrun: python -m repro_torch.launch.dryrun {' '.join(a)} exited "
                     f"{p.returncode}:\n{stdout[-2000:]}\n{stderr[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    reports = {f.name: json.loads(f.read_text()) for f in sorted(out.glob("*.json"))}
    want = {f"damoldqn_{s}_{m}.json" for s in
            ("train_4k", "prefill_32k", "decode_32k", "long_500k")
            for m in ("16x16", "2x16x16")} | {
        f"{a}_{s}_{m}.json" for a, s in (("yi-34b", "long_500k"),
                                         ("zamba2-1.2b", "decode_32k"))
        for m in ("16x16", "2x16x16")}
    if set(reports) != want:
        fail(f"dryrun: reports {sorted(reports)}, want {sorted(want)}")
    for name, r in reports.items():
        skip = SKIP.get((r["arch"], r["shape"]))
        if (r["status"], r.get("reason")) != (("skipped", skip) if skip else ("ok", None)):
            fail(f"dryrun: {name}: status {r['status']} {r.get('reason') or r.get('error')}")
        if skip:
            print(f"dryrun: {name[:-5]}: skipped ({skip})", flush=True)
            continue
        if not (r["flops_per_chip"] > 0 and r["fits_80gb"] and r["hw"]["name"] == "h100-sxm"):
            fail(f"dryrun: {name}: {r}")
        print(f"dryrun: {name[:-5]}: ok, {r['flops_per_chip']:.4e} FLOP/chip, "
              f"{r['bytes_per_chip']:.4e} B/chip, {r['collective_bytes_per_chip']:.4e} "
              f"collective B/chip, HBM {r['hbm_gb_per_chip']} GiB/chip, dominant "
              f"{r['dominant']}, fits_80gb {r['fits_80gb']}, microbatches "
              f"{r['microbatches']}, fsdp {r['fsdp']}, window {r['window']}, "
              f"{r['compile_s']} s", flush=True)
    print(f"dryrun: {len(DRYRUN_RUNS)} launcher processes on the host (no card): "
          f"{len(reports)} reports in {wall:.1f} s wall", flush=True)
    return reports


def phase_dryrun(peak, card: str) -> tuple[dict, int]:
    """damoldqn's serve and train steps on the card, the op walk's count on
    the card against ``meta``, and the dry-run launcher on the host.
    Returns the ``fused_qnet`` record at the serve step's rows and the
    launches of the phase's main-path run."""
    import warnings

    import torch
    from repro_torch.checkpoint.checkpoint import tree_leaves
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.fused_qnet.ops import fused_qnet
    from repro_torch.kernels.fused_qnet.ref import qnet_ref
    from repro_torch.kernels.packed_qnet.ops import packed_qnet, packed_qnet_stacked
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import make_serve_step, make_train_step
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.models import abstract_params
    from repro_torch.roofline.op_walk import aggregate

    t_phase = time.perf_counter()
    kernels = (fused_qnet, packed_qnet_stacked, packed_qnet, flash_attention, ssd_scan)
    cfg, cpu, target_cpu, batch_cpu = _qnet_step_inputs()
    spec, _ = S.qnet_batch_specs(INPUT_SHAPES["train_4k"], make_production_mesh())
    if {k: tuple(v.shape) for k, v in batch_cpu.items()} != \
            {k: tuple(v.shape) for k, v in spec.items()}:
        fail(f"dryrun: the qnet batch is not qnet_batch_specs' shape {spec}")
    params, target = _to(cpu, "cuda"), _to(target_cpu, "cuda")
    batch = {k: v.cuda() for k, v in batch_cpu.items()}
    layers = [(l["w"], l["b"]) for l in params["layers"]]
    rows = QNET_BATCH * QNET_CANDIDATES

    # the main path: the serve step twice, the train step twice
    serve = make_serve_step(cfg)
    step, opt = make_train_step(cfg)
    for k in kernels:
        k.launches = 0
    q = serve(params, batch["next_fps"])
    q2 = serve(params, batch["next_fps"])
    torch.cuda.synchronize()
    serve_launches = fused_qnet.launches
    before = [k.launches for k in kernels]
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            p1, s1, l1 = step(params, target, opt.init(params), batch)
            p1b, s1b, l1b = step(params, target, opt.init(params), batch)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
    step_launches = {k.__name__: k.launches - n for k, n in zip(kernels, before)}
    if serve_launches != 2:
        fail(f"dryrun: 2 qnet serve steps of {rows} rows made {serve_launches} "
             f"fused_qnet launches, want 1 each")
    if any(step_launches.values()):
        fail(f"dryrun: the qnet train step launched kernels: {step_launches}")
    if tuple(q.shape) != (QNET_BATCH, QNET_CANDIDATES) or not torch.equal(q, q2):
        fail(f"dryrun: qnet serve step {tuple(q.shape)}, or its rerun differs")
    x2d = batch["next_fps"].reshape(rows, -1)
    err = _check_close("dryrun: qnet serve step vs qnet_ref", q.reshape(-1),
                       qnet_ref(x2d, layers), TOL)
    if not (torch.equal(l1, l1b) and all(torch.equal(a, b) for a, b in
                                         zip(tree_leaves(p1), tree_leaves(p1b)))):
        fail("dryrun: the qnet train step's rerun is not bit-identical")
    pc, sc, lc = step(cpu, target_cpu, opt.init(cpu), batch_cpu)
    rel = abs(float(l1) - float(lc)) / abs(float(lc))
    if not rel <= LM_LOSS_RTOL:
        fail(f"dryrun: qnet train loss on the card {float(l1)!r} vs the CPU "
             f"{float(lc)!r}: {rel:.3e} > {LM_LOSS_RTOL}")
    perr = max(_check_close(f"dryrun: qnet parameter leaf {i} after one step, card vs CPU",
                            a.cpu(), b, QNET_STEP_TOL)
               for i, (a, b) in enumerate(zip(tree_leaves(p1), tree_leaves(pc))))
    uerr = _qnet_update_err(cpu, p1, pc, sc.mu)
    print(f"dryrun: damoldqn serve step, B {QNET_BATCH} x {QNET_CANDIDATES} candidates "
          f"= {rows} rows of 2049: {serve_launches} fused_qnet launches for 2 calls, "
          f"max_abs_err {err:.3e} vs qnet_ref (<= {TOL} abs + rel), rerun "
          f"bit-identical | train step (double DQN, Adam clip 1.0) card vs CPU: loss "
          f"{float(l1):.6f} vs {float(lc):.6f} ({rel:.3e} rel, <= {LM_LOSS_RTOL}), "
          f"parameters after one step max abs {perr:.3e} (<= {QNET_STEP_TOL} abs + "
          f"rel), update max abs {uerr / QNET_LR:.3e} x lr (<= {QNET_UPDATE_TOL} x lr "
          f"where |mu| > {QNET_UPDATE_MASK} x its leaf's max), launches "
          f"{step_launches}, rerun bit-identical", flush=True)
    for m in sorted({str(w.message).split("\n")[0][:160] for w in caught}):
        print(f"dryrun: warning under deterministic algorithms: {m}", flush=True)
    del pc, p1b, s1b

    # the op walk: the real step on the card against the same step on meta
    counted = aggregate(step, params, target, opt.init(params), batch)
    meta = abstract_params(cfg)
    counted_meta = aggregate(step, meta, abstract_params(cfg), opt.init(meta), spec)
    if counted["flops"] != counted_meta["flops"]:
        fail(f"dryrun: op_walk counts {counted['flops']} FLOP on the card, "
             f"{counted_meta['flops']} on meta")
    cur, st = p1, s1
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(QNET_STEPS + 1)]
    marks[0].record()
    for i in range(QNET_STEPS):
        cur, st, _ = step(cur, target, st, batch)
        marks[i + 1].record()
    torch.cuda.synchronize()
    ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(QNET_STEPS)]
    best = min(ms)
    print(f"dryrun: op_walk over the train step: {counted['flops']:.6e} FLOP on the "
          f"card == {counted_meta['flops']:.6e} on meta ({counted['ops']} aten ops, "
          f"{counted['bytes'] / 1e9:.3f} GB unfused); {QNET_STEPS} steps "
          f"{', '.join(f'{m:.3f}' for m in ms)} ms (CUDA events) = "
          f"{1e3 / best:.1f} steps/s at the best, {counted['flops'] / best / 1e9:.2f} "
          f"TFLOP/s achieved against the f32 peak {peak[0] / 1e12} TFLOP/s "
          f"({100 * counted['flops'] / best * 1e3 / peak[0]:.1f}%) on {card}", flush=True)
    del cur, st, p1, s1

    # the kernel at the serve step's rows, held and timed like phase_kernels
    n_params = sum(w.numel() + b.numel() for w, b in layers)
    mac_per_row = sum(w.numel() for w, _ in layers)

    def library(x):                          # yardstick only: addmm chain
        h = x
        for li, (w, b) in enumerate(layers):
            h = torch.addmm(b, h, w)
            if li < len(layers) - 1:
                h = torch.relu_(h)
        return h[:, 0]
    record = _row("fused_qnet", "src/repro_torch/kernels/fused_qnet/csrc/fused_qnet.cu",
                  "src/repro/kernels/fused_qnet/fused_qnet.py:63", [rows, 2049],
                  serve_launches, err, cuda_ms(lambda: fused_qnet(layers, x2d), 10),
                  cuda_ms(lambda: qnet_ref(x2d, layers), 5),
                  cuda_ms(lambda: library(x2d), 5), 2.0 * rows * mac_per_row,
                  4.0 * (x2d.numel() + n_params + rows), peak[0], peak,
                  rows=rows, path="dryrun: the damoldqn serve step")
    print(f"dryrun: fused_qnet N={rows}: kernel {record['ms']:.4f} ms, plain "
          f"{record['plain_ms']:.4f} ms, library (addmm chain) "
          f"{record['library_ms']:.4f} ms, bound {record['bound_ms']:.4f} ms "
          f"({record['bound_by']})", flush=True)
    del params, target, batch, x2d, q, q2, layers
    torch.cuda.empty_cache()

    _dryrun_launcher()
    print(f"dryrun: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return record, serve_launches


def compare(src: Path) -> None:
    """``--compare SRC``: the port at SRC (the ``src`` of another checkout)
    on the seeded inputs of the kernels phases.  Prints one JSON line with
    sha256 digests of every Q kernel's output and the times of the
    redesigned kernels (the Q kernels, bf16 ``flash_attention``, and bf16
    and f32 ``ssd_scan`` at zamba2-1.2b's path shape, with the scan's max
    abs error against ``ssd_ref``), so two trees run in one call can be
    held to the same bits and timed on the same card."""
    import hashlib
    sys.path.insert(0, str(src))
    card, _, _ = phase_device(src)
    import torch
    from repro_torch.core.packed_batch import unpack_bits
    from repro_torch.device import resolve_device
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.fused_qnet.ops import fused_qnet
    from repro_torch.kernels.packed_qnet.ops import (dense_qnet_stacked,
                                                     packed_qnet,
                                                     packed_qnet_stacked)
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    resolve_device("cuda")
    phase_build(report=False)

    def digest(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    bits_of, ms = {}, {}
    weights, xs = _fused_inputs()
    for n, x in xs.items():
        bits_of[f"fused_qnet N={n}"] = digest(fused_qnet(weights, x))
    ms["fused_qnet N=2048"] = cuda_ms(lambda: fused_qnet(weights, xs[2048]), 20)
    del weights, xs
    for W, C in STACKED_SHAPES:
        weights, bits, frac = _stacked_inputs(W, C)
        bits_of[f"packed_qnet_stacked {W}x{C}"] = digest(
            packed_qnet_stacked(weights, bits, frac))
        x = torch.cat([unpack_bits(bits), frac.unsqueeze(-1)], -1).contiguous()
        bits_of[f"dense_qnet_stacked {W}x{C}"] = digest(dense_qnet_stacked(weights, x))
        if W * C >= 2048:
            ms[f"packed_qnet_stacked {W}x{C}"] = cuda_ms(
                lambda: packed_qnet_stacked(weights, bits, frac), 20)
        del weights, bits, frac, x
    weights = _packed_weights()
    for n in PACKED_ROWS:
        bits, frac = _packed_rows(n)
        bits_of[f"packed_qnet N={n}"] = digest(packed_qnet(weights, bits, frac))
    B, S, H, K, D = FLASH_PATH
    q, k, v = _flash_case(B, S, S, H, K, D, torch.bfloat16, 100)
    ms["flash_attention bf16 path"] = cuda_ms(lambda: flash_attention(q, k, v), 10)
    del q, k, v
    B, L, H, P, G, N, Q = SSD_PATHS[LM_ARCH]     # the shape every tree takes
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        key = f"ssd_scan {str(dtype).split('.')[1]} {LM_ARCH} path"
        x, dt, A, Bm, Cm = _ssd_case(B, L, H, P, G, N, dtype, 300)
        y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=Q)
        yr, sr = ssd_ref(x, dt, A, Bm, Cm)
        errs[key] = max(float((y.float() - yr.float()).abs().max()),
                        float((st.float() - sr.float()).abs().max()))
        ms[key] = cuda_ms(lambda: ssd_scan(x, dt, A, Bm, Cm, chunk=Q), 20)
        del x, dt, A, Bm, Cm, y, st, yr, sr
    print(json.dumps({"src": str(src), "card": card, "digests": bits_of, "ms": ms,
                      "max_abs_err_vs_ssd_ref": errs}), flush=True)


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--compare"] and len(args) == 2:
        compare(Path(args[1]).resolve())
        return
    if args:
        fail(f"usage: {sys.argv[0]} [--compare SRC]")
    sys.path.insert(0, str(SRC))
    t0 = time.perf_counter()
    card, name, peak = phase_device()
    import torch
    from repro_torch.device import resolve_device
    resolve_device("cuda")                   # TF32 off for the plain versions
    phase_build()
    rows = phase_kernels(peak)
    stacked_rows = phase_stacked_kernel(peak)
    adam_rows = phase_stacked_adam(peak)
    leaf_rows = phase_leaf_adam(peak)
    launches = phase_serve()
    for r in rows:
        r["launches"] = launches
    from repro_torch.kernels.stacked_adam.ops import stacked_adam
    stacked_adam.launches = 0
    launches = phase_train()
    for r in stacked_rows:
        r["launches"] = launches
    for r in adam_rows:
        r["launches"] = stacked_adam.launches
    stacked_adam.launches = 0
    launches = phase_mesh(card)
    for r in stacked_rows:
        r["launches_mesh"] = launches
    for r in adam_rows:
        r["launches_mesh"] = stacked_adam.launches
    rl, (tr, svc, cache_dir) = phase_train_rl()
    for r in rows:
        r["launches_greedy_eval"] = rl["greedy"]
        r["launches_serve_trained"] = rl["serve"]
    for r in stacked_rows:
        r["launches_train_rl"] = rl["packed_qnet_stacked"]
    pipe = phase_pipeline(tr, svc, cache_dir)
    del tr, svc
    for r in rows:
        r["launches_fine_tune"] = pipe["fused_qnet"]
        r["launches_quickstart"] = pipe["quickstart_fused"]
    for r in stacked_rows:
        r["launches_verify"] = pipe["packed_qnet_stacked"]
        r["launches_quickstart"] = pipe["quickstart_packed"]
    rows += stacked_rows + adam_rows + leaf_rows
    rows += phase_packed_kernel(peak)
    lm_rows, path_ms = phase_lm_kernels(peak)
    launches = phase_lm(path_ms, card)
    launches.update(phase_lm_families(path_ms, card))
    for r in lm_rows:
        r["launches"] = launches[(r["name"], r["arch"])]
    rows += lm_rows
    lm_launches = phase_lm_train()
    for r in rows:
        r["launches_lm_train"] = lm_launches[r["name"]]
    record, launches = phase_dryrun(peak, card)
    for r in rows:
        if r["name"] == "fused_qnet":
            r["launches_dryrun"] = launches
    rows.append({**record, "launches_lm_train": lm_launches["fused_qnet"],
                 "launches_dryrun": launches})
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s on {card}", flush=True)
    print(json.dumps({"card": card, "kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
