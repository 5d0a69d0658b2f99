"""Chip smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``src/repro_torch/csrc``,
drives the main path of the GBDT train and serve entry points, then holds
each kernel against its plain PyTorch version on the card at the main
path's shapes. The main path: 16 boosting rounds of the paper's ``efficiency-realsim``
configuration (depth 9, 64 bins, feature fraction 0.8, R = 0.8, v = 0.01,
histogram subtraction, 400-slot forest; dataset realsim-like, N = 4000,
F = 1500) under four round-robin PS workers, three ways: staged (twice),
with the fused level (``backend="fused"``: levels 0-4 as one fused level
each, 5-8 staged; its forest must be the staged one bit for bit) and on
the sparse layout (``bin_dataset(..., sparse=True)``, twice); then a
``ForestServer`` answering raw float requests with the staged forest and
with a seeded full 400-slot forest. The configuration comes from
``configs.gbdt.get("efficiency-realsim")``.

The handoff phase follows, with its own launch counts: the second staged
run checkpoints its ``TrainState`` at rounds 8 and 16; both restore on the
card bitwise (CRCs checked; the manifest in the JAX package's layout),
and ``load_forest_checkpoint`` gives the trained forest bitwise. A
``ForestServer`` on the round-8 forest answers 8 requests (each labelled
8), reloads round 16 from the checkpoint root and answers them again,
every answer bitwise a fresh round-16 server's; the reload (``latest_step``
to install) is timed f32, int8 and fp16; an idle server's reload poller
must pick up a newly written step within 2 s. ``ForestEngine`` then serves
64 requests from its background thread with two versions, "half" (round
8, f32) and "full" (round 16, int8, weight 3): each request by the version
``route_hash`` picks, labelled with its step, int8 answers within
``quantization_atol`` + 1e-6 of the f32 forest's; p50/p99 of queue,
compute and end-to-end latency are printed. Last the train CLI (staged,
fused, multiclass:5, sparse) and the serve CLI (wave, continuous, int8)
run as a user runs them, each exiting clean with its own asserts.

The e2006 and step-rules phase follows the handoff phase, with its own
launch counts: the paper's ``efficiency-e2006`` configuration (squared
error, depth 9, 64 bins, feature fraction 0.8, R = 0.8, v = 0.01,
histogram subtraction, 400-slot forest; dataset e2006-like, N = 3000, F =
2000) trained 16 rounds at W = 4 staged (twice, bitwise equal), fused
(bitwise the staged forest) and on the sparse layout (twice, bitwise
equal, the loss within 1e-3 of the dense run's), the loss falling, and
served f32, int8 and fp16 with the identity link; then, on realsim's
data, Newton leaves staged and fused (bitwise equal; round 0's tree
bitwise the build on the hessian weights m' h) and the staleness-adaptive
step at rho = 0.1, under W = 1 bitwise the fixed step and under W = 4 with
the scales applied bitwise ``staleness_scales`` and rounds 0-3 the fixed
run's trees times their scale; then the train CLI with mse, quantile:0.9,
huber and lambdarank and the serve CLI with mse and lambdarank. Every
GBDT kernel is held against its plain version at e2006's shapes and with
the Newton run's hessians (``check_e2006_kernels``); its ``*_e2006``
entries in the kernels line carry the launches of the e2006 part.

The second main path follows, the multiclass path and quantized
serving: the driver's K-output configuration (``launch.train.gbdt_config``,
``multiclass:5``,
depth 6, v = 0.15, 64 bins, 2000-slot forest;
``make_multiclass_classification(4000, 60, 5, seed=0)``) trained 16 rounds
at W = 4 staged (twice, bitwise equal) and fused (bitwise the staged
forest), its loss falling and its accuracy above the largest class prior;
then the realsim forest just trained and the multiclass forest each served
f32, ``quantize="int8"`` and ``quantize="fp16"`` (8 requests of 1-600 rows
each): every answer is link(forest_predict) on the installed forest, every
multiclass row a softmax row, every quantized margin within
``quantization_atol`` of the f32 forest's.

The kernel checks come after both main paths: the profiler that reads
their device times would slow the host side of the rounds and requests.
The traversal kernel's int8, fp16 and K = 5 forms are held bit for bit
against the plain version at those forests' full shapes and at a ragged
shape; the histogram, split gain and fused level against theirs on the
multiclass data at each of a tree's six levels; every kernel against its
plain version at realsim's shapes. Both histogram kernels and the split
gain are also timed at each level of one realsim tree. The split gain runs
in its decision form on the main path (``split_gain_decide``: the surface
and each node's masked first maximum in one launch); at every level
checked its decision must be bitwise the plain chain's (``masked_fill``,
``argmax``, ``gather``) on the kernel's own surface, and a profiled round
must hold no argmax or masked_fill launch.

Then the LM zoo's serving path: the flash-attention kernel against its
plain version at the serving prefill's shape and at ragged shapes (each
shape's route: the wgmma kernel for bf16 at d 64 and 128, the mma.sync
kernel for bf16 at d 32 and 80, the scalar kernel for f32), timed beside
SDPA (whose backend is named by its kernels), and granite-3-2b at full
width (40 layers, d_model 2048, bf16, seeded random weights,
``attn_impl="flash"``) served through ``ServingEngine`` in two waves of
four requests (2048- and 1024-token prompts, 32 new tokens each), twice,
every forward launch on the wgmma route; the flash prefill's logits are
held against the chunked path's.

Then the LM zoo's training path: the flash-attention backward kernels
(delta, dq and dk/dv) against their plain version at the training shape
and the ragged shapes (each shape's route, as the forward's), each kernel
timed alone beside its own bound and the whole beside SDPA's backward, and
granite-3-2b at full width trained on batches of
4 x 2048 tokens from ``synthetic_batches`` through ``make_train_step``
(flash attention, per-layer remat): the reference recipe (AdamW, cosine
schedule, clipping, decay) at accum 2 for 6 steps, twice (bitwise equal),
then the delayed-gradient wrapper (tau = 2, Proposition 1's step scale)
with Bernoulli sampling (R = 0.8) for 6 steps, every forward and backward
launch on the wgmma route; one more step is profiled, and one microbatch's loss and
gradients are held against the chunked attention path's. Run A is then
trained once more under ``remat_policy="dots"`` (selective checkpointing
that keeps the layers' batch-free matmul outputs): its losses and every
parameter must be bitwise run A's, with the same 80 forward and 40
backward flash launches a microbatch; its step time and peak memory are
printed beside "full"'s and one more step is profiled. Then packed
documents (``data.pipeline``: seeded Markov documents of 64-3072 tokens
packed into rows of 2049 by ``pack_documents``, batched by
``TokenPipeline``, the last row with a pad tail) train granite-3-2b for 4
steps twice under ``attn_impl="flash"``: bitwise across the two runs, the
loss falling, a microbatch with a pad tail giving finite loss and
gradients, and no flash launch at all (packed rows take the chunked
attention, by the reference's rule); one row of two packed documents
gives each document's logits within twice the bf16 error of the document
in a row of its own, both against the f32 forward of the separate rows.

Then the hybrid family: the flash forward and backward against their
plain versions at zamba2's shared-block shape (B 4, S 2048, 32 q heads on
32 kv heads, d 64, bf16, causal; the wgmma routes), beside SDPA and its
backward, and zamba2-1.2b at full width (38 Mamba2 layers in 6 groups of
6 + 2 tail, one shared attention block called after each group, bf16,
seeded random weights, flash) served through ``ServingEngine`` on the
dense path's waves, twice (6 flash launches a wave's prefill; the flash
prefill's logits against the chunked path's and f32; each decode step's
logits against the f32 teacher-forced forward, which catches a drift of
the SSM and conv caches), then trained through ``make_train_step`` on run
A's batches and recipe, twice (bitwise equal; 12 forward and 6 backward
flash launches a microbatch under per-group remat; ``a_log`` and
``dt_bias`` f32 after the steps; the shared block's and the first and
last Mamba2 layer's projection gradients, flash against chunked). Its
profiles split device time into GEMMs, flash, the SSD scan (its ops and
their backward) and the rest (``device_groups``).

Then the MoE family: the flash forward and backward at phi3.5-moe's shape
(B 4, S 2048, 32 q heads on 8 kv heads, d 128, bf16, causal; the wgmma
routes) beside SDPA, and phi3.5-moe-42b at full width (d_model 4096, 16
experts top-2 of d_ff 6400, bf16, seeded random weights, flash) served at
16 of its 32 layers (all 32 do not fit the card) on the dense path's
waves, twice (16 flash launches a wave's prefill; the KV ring's bytes),
then trained at 2 layers on run A's batches and recipe, twice (bitwise;
the loss falling; the router aux in (0, 2]; 4 forward and 2 backward
flash launches a microbatch), under "dots" (bitwise "full") and on packed
rows (bitwise, no flash launch). At 2 layers: every layer's router
gradient, the flash prefill's logits against the chunked path's and f32,
each decode step against the f32 teacher-forced forward (every token kept
by the capacity in both; both gates over the rows the compared paths
route alike), and every expert's dispatch on the card against the CPU's
from the same ids and weights; last the serve CLI (``--arch
phi3.5-moe-42b``, reduced). Its profiles split device time into GEMMs,
flash, the router with dispatch and combine, and the rest.

Then the media families. llama-3.2-vision-90b at full width (d_model
8192, 64 q heads on 8 kv heads of 128, bf16, seeded random weights,
flash, every cross layer's gates set to 0.5 and -0.3: at their init of 0
a cross layer is the identity): the flash forward and backward at its self
layers' shape (B 4, S 2048, group 8, d 128) beside SDPA; served at 20 of
its 100 layers (4 groups of 4 self + 1 cross; all 100 do not fit the card)
on the dense path's waves, each request with its own seeded (1601, 8192)
media, twice (16 flash launches a wave's prefill; the ring's and the
media caches' bytes; one prompt with two media gives other logits); at
one group (5 layers) the flash prefill's logits against the chunked
path's and f32 and each decode step against the f32 teacher-forced
forward, then 4 plain-SGD steps (2 x 2048 tokens, accum 2, two batches
each seen twice) twice (bitwise; each batch's loss lower the second time;
8 forward and 4 backward flash launches a microbatch under the group's
remat) and every cross projection's and gate's gradient finite and
non-zero. whisper-small whole (12 encoder and 12 decoder layers, 12 heads
of 64, (1500, 768) media): the flash kernels at its training shape (B 8,
S 448) and serving prompts (64 and 320); served in waves of 8 requests
with 64- and 320-token prompts and 64 new tokens, twice (12 flash
launches a wave's prefill; the same gates, and the accuracy gates on the
320-token wave); trained with run A's recipe on 16 x 448 tokens a step,
6 steps twice (bitwise, the loss falling, 24 forward and 12 backward
flash launches a microbatch); the encoder's first and last wq and every
decoder layer's cross projections with finite, non-zero gradients; last
the train and serve CLIs for both arches, reduced. Its profiles split
device time into GEMMs, flash, the chunked attention of the encoder and
the cross layers (``CHUNKED_RANGE``), and the rest; each kernel is
counted once, under the innermost host op that launched it
(``device_kernels``), and the groups must sum to the device total.

Then the xLSTM family (``drive_xlstm``), and last the sharded LM step
(``drive_lm_mesh``): phi3.5-moe-42b at full width, its single-device
results first on the card, then four rank processes on a (data 2, model
2) mesh sharing the card over gloo (``lm_mesh_rank``). One layer is
trained, run A of the reference's distributed test (AdamW 1e-3 clipped
at 1.0, 3 steps of 4 x 512 tokens) twice: losses and every parameter
shard bitwise across the runs, every holder of a block the same bits,
loss and parameters within 5e-2 of the single device, no expert weight
and no gradient on 'model', 2 forward and 1 backward flash launches a
microbatch on every rank (wgmma). Two layers are served through
``ServingEngine(mesh=)`` under ``serving_rules`` placement: the prefill
logits and the decode logits of the engine's own steps, teacher-forced
on the single device's tokens, within twice the single device's bf16
error against f32, greedy tokens equal where the top-2 gap exceeds it. Each phase's seconds are printed (``phase``).

It prints the card's name and power limit, a ``kernels`` JSON line (per
kernel, and per form of the traversal kernel: launches on its path, error
against the plain version, time as a CUDA-event mean and as device time
alone, the plain version's time, the bound, a library call's time), a sweep of both histogram
kernels and the split gain over one realsim tree's nine levels and, last,
``{"ok": true, "device": {...}}``. Every failure raises: the exit code is
then non-zero and the last line is not printed. Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import dataclasses  # noqa: E402

import repro_torch.configs as lm_configs  # noqa: E402
from repro_torch import checkpoint, collectives  # noqa: E402
from repro_torch.configs import gbdt as gbdt_configs  # noqa: E402
from repro_torch.convert import forest_from_numpy  # noqa: E402
from repro_torch.core.sgbdt import init_state, train_loss, train_metrics  # noqa: E402
from repro_torch.data.sampling import bernoulli_weights  # noqa: E402
from repro_torch.data import TokenPipeline, pack_documents, synthetic  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build,
    flash_attention,
    flash_plan,
    forest_traversal,
    histogram,
    histogram_sparse,
    level_build,
    ref,
    split_scan,
    traversal_plan,
)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.train import gbdt_config, synthetic_batches  # noqa: E402
from repro_torch.models import forward_train, init_cache, init_params  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import ssm as lm_ssm  # noqa: E402
from repro_torch.models import xlstm as lm_xlstm  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.objectives import get_objective  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    adamw,
    cosine_schedule,
    delayed_gradient,
    sgd,
    staleness_step_scale,
)
from repro_torch.optim.optimizers import tree_leaves, tree_map  # noqa: E402
from repro_torch.ps import engine as ps_engine  # noqa: E402
from repro_torch.ps.engine import Trainer  # noqa: E402
from repro_torch.ps.runtime import AsyncRuntime, FaultPlan, RunTrace, replay_trace  # noqa: E402
from repro_torch.ps.schedules import resolve_schedule, staleness_scales  # noqa: E402
from repro_torch.ps.worker import train_worker_parallel  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ForestEngine,
    Request,
    ServingEngine,
    load_forest_checkpoint,
    percentile_latencies,
    route_hash,
)
from repro_torch.serving.forest_server import ForestServer, PredictRequest  # noqa: E402
from repro_torch.trees.binning import (  # noqa: E402
    BinnedData, apply_bins, bin_dataset, gather_feature_bins)
from repro_torch.trees.forest import (  # noqa: E402
    QuantizedForest,
    empty_forest,
    forest_predict,
    quantization_atol,
)
from repro_torch.trees.learner import (  # noqa: E402
    _smaller_children,
    _staged_level,
    build_tree,
)

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 ops/s
# outside the tensor cores; the kernels' integer and float work is scalar.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
PEAK_BF16_S = 989e12  # dense bf16 tensor-core rate
# exp2 in the special-function units: 132 SMs x 16 a clock x 1.83 GHz.
PEAK_EX2_S = 132 * 16 * 1.83e9
SEED = 0
ROUNDS = 16
WORKERS = 4
# configs.gbdt "efficiency-realsim" (paper VI.C): depth 9, 64 bins, feature
# fraction 0.8, R = 0.8, v = 0.01, 400 slots; realsim-like data.
REALSIM = "efficiency-realsim"
CFG = gbdt_configs.EXPERIMENTS[REALSIM].config
CFG_FUSED = CFG._replace(learner=CFG.learner._replace(backend="fused"))
KERNELS = {
    "histogram": (histogram, "src/repro_torch/csrc/histogram.cu",
                  "src/repro/kernels/histogram.py:80"),
    "split_gain": (split_scan, "src/repro_torch/csrc/split_scan.cu",
                   "src/repro/kernels/split_scan.py:50"),
    "forest_traverse": (forest_traversal, "src/repro_torch/csrc/forest_traversal.cu",
                        "src/repro/kernels/forest_traversal.py:107"),
    "level_build": (level_build, "src/repro_torch/csrc/level_build.cu",
                    "src/repro/kernels/level_build.py:199"),
    "histogram_sparse": (histogram_sparse, "src/repro_torch/csrc/histogram_sparse.cu",
                         "src/repro/kernels/histogram_sparse.py:87"),
}

# The multiclass path: the driver's K-output configuration
# (launch/train.py --arch gbdt --objective multiclass:5 on
# gbdt_dataset_for("multiclass:5")): make_multiclass_classification(4000,
# 60, 5, seed=0) at 64 bins, a 2000-slot forest (400 rounds x 5), 16 rounds
# at W = 4 as the logistic phase runs.
MC_SHAPE = (4000, 60, 5)  # rows, features, classes
MC_CFG = gbdt_config("multiclass:5", 400)
MC_CFG_FUSED = MC_CFG._replace(learner=MC_CFG.learner._replace(backend="fused"))
QUANT_MODES = (None, "int8", "fp16")  # each forest is served f32 and packed both ways
# ForestServer's max_rows: every serving wave runs the traversal on this
# many rows, padded.
WAVE_ROWS = 256
# The handoff phase: the realsim run's TrainState checkpointed at rounds 8
# and 16 (under build/, beside the kernels), restored, served and
# hot-swapped; the reload timed RELOAD_REPS times a form; an idle server's
# poller (every POLL_S) must pick up a new step within POLL_BOUND_S; the
# continuous engine takes ENGINE_REQUESTS requests ENGINE_GAP_S apart.
HANDOFF_DIR = ROOT / "build" / "handoff"
HANDOFF_HALF = ROUNDS // 2
RELOAD_REPS = 5
POLL_S, POLL_BOUND_S = 0.05, 2.0
ENGINE_REQUESTS, ENGINE_GAP_S, ENGINE_SLO_S = 64, 0.002, 0.05
# The reference's TrainState layout (tests/golden/ckpt of the JAX package):
# leaf paths and dtypes in manifest order.
REF_LAYOUT = [(".forest/.feature", "int32"), (".forest/.threshold", "int32"),
              (".forest/.leaf_value", "float32"), (".forest/.n_trees", "int32"),
              (".forest/.base_score", "float32"), (".f", "float32"), (".step", "int32")]
# The CLIs the handoff phase runs, as a user would (on the card).
TRAIN_CLIS = {
    "staged": ["--arch", "gbdt", "--steps", "16", "--workers", "4"],
    "fused": ["--arch", "gbdt", "--steps", "16", "--workers", "4", "--backend", "fused"],
    "multiclass:5": ["--arch", "gbdt", "--steps", "16", "--workers", "4",
                     "--objective", "multiclass:5"],
    "sparse": ["--arch", "gbdt", "--steps", "16", "--workers", "4", "--sparse"],
}
SERVE_CLIS = {
    "wave": ["--arch", "gbdt"],
    "continuous": ["--arch", "gbdt", "--engine", "continuous"],
    "wave int8": ["--arch", "gbdt", "--quantize", "int8"],
}
# The e2006 and step-rules phase (ROADMAP A4): configs.gbdt
# "efficiency-e2006" (paper VI.C, Fig. 10): squared error, depth 9, 64
# bins, feature fraction 0.8, R = 0.8, v = 0.01, 400 slots; e2006-like
# data (N 3000, F 2000, 40 nonzeros a row); 16 rounds at W = 4, as the
# realsim path runs. Then the step rules on the realsim configuration:
# Newton leaves (staged and fused) and the staleness-adaptive step at rho =
# STEP_RHO, under W = 1 and W = 4.
E2006 = "efficiency-e2006"
E2006_CFG = gbdt_configs.EXPERIMENTS[E2006].config
E2006_CFG_FUSED = E2006_CFG._replace(learner=E2006_CFG.learner._replace(backend="fused"))
STEP_RHO = 0.1
NEWTON_CFG = CFG._replace(step_kind="newton")
NEWTON_CFG_FUSED = CFG_FUSED._replace(step_kind="newton")
ADAPTIVE_CFG = CFG._replace(adaptive_step=STEP_RHO)
# The CLIs of the regression and ranking objectives, run in that phase.
OBJECTIVE_TRAIN_CLIS = {obj: ["--arch", "gbdt", "--steps", "16", "--workers", "4", "--objective", obj]
                 for obj in ("mse", "quantile:0.9", "huber", "lambdarank")}
OBJECTIVE_SERVE_CLIS = {obj: ["--arch", "gbdt", "--objective", obj] for obj in ("mse", "lambdarank")}
# That phase's entries in the kernels line: name -> (KERNELS key, launch
# count key).
E2006_LINE = {
    "histogram_e2006": ("histogram", "histogram"),
    "split_gain_e2006": ("split_gain", "split_gain"),
    "level_build_e2006": ("level_build", "level_build"),
    "histogram_sparse_e2006": ("histogram_sparse", "histogram_sparse"),
    "forest_traverse_e2006": ("forest_traverse", "f32"),
    "forest_traverse_int8_e2006": ("forest_traverse", "int8"),
    "forest_traverse_fp16_e2006": ("forest_traverse", "fp16"),
}
# The threads phase (ROADMAP A5): the host-async runtime on realsim at full
# width, W = 4 worker threads (a CUDA stream each), all 400 trees; then
# THREADS_SHORT-tree runs: faults (crash ticket 3, leave ticket 7, worker 4
# joining at fold 10), a halt at fold THREADS_HALT with a checkpoint every
# THREADS_CKPT_EVERY folds resumed on THREADS_RESUME_WORKERS workers,
# THREADS_SHARDS sharded pulls, the adaptive step at STEP_RHO, the fused
# backend (in a child process, under a time limit) and the train CLI. The
# kernels then run on THREADS_STREAMS streams at once.
THREADS_SHORT = 32
THREADS_CFG = CFG._replace(n_trees=THREADS_SHORT)
THREADS_FAULTS = {"crash_tickets": {3}, "leave_tickets": {7}, "join_at": {4: 10}}
THREADS_HALT, THREADS_CKPT_EVERY, THREADS_RESUME_WORKERS = 16, 8, 3
THREADS_SHARDS = 16
THREADS_FUSED_TIMEOUT_S = 300
THREADS_STREAMS, THREADS_SPLIT_REPS, THREADS_REPS = 4, 200, 20
THREADS_DIR = ROOT / "build" / "threads"
THREADS_CLI = ["--arch", "gbdt", "--runtime", "threads", "--steps", str(THREADS_SHORT),
               "--workers", "4", "--verify-replay", "--checkpoint-dir",
               str(THREADS_DIR / "cli"), "--checkpoint-every", "8", "--verify-resume"]
# That phase's entries in the kernels line: name -> KERNELS key.
THREADS_LINE = {"histogram_threads": "histogram", "split_gain_threads": "split_gain",
                "level_build_threads": "level_build",
                "forest_traverse_threads": "forest_traverse"}
# The mesh phase (ROADMAP A8): efficiency-realsim at full width through
# Trainer(mesh=), ROUNDS rounds at W = WORKERS: the (1, 1) mesh as one rank
# over NCCL in this process; then MESH_RANKS rank processes sharing the
# card over MESH_BACKEND (NCCL refuses two ranks on one card) train each
# form of MESH_FORMS (tag -> (mesh, feature axis, sparse layout)); then the
# mesh train CLIs, each starting its own MESH_RANKS ranks.
MESH_RANKS = 4
MESH_BACKEND = "gloo"
MESH_DIR = ROOT / "build" / "mesh"
# tag -> (mesh, feature axis, data): "dense" and "sparse" are realsim's
# layouts, "decisive" the DECISIVE_CFG set (``decisive_data``).
MESH_FORMS = {
    "1d_x4": ("x4", None, "dense"),
    "1d_x4_again": ("x4", None, "dense"),
    "1d_x4_decisive": ("x4", None, "decisive"),
    "2d_1x4": ("1x4", "feature", "dense"),
    "2d_1x4_sparse": ("1x4", "feature", "sparse"),
    "2d_2x2": ("2x2", "feature", "dense"),
    "1d_x2_on_2x2": ("2x2", None, "dense"),  # the (2, 2) mesh's data axis alone
}
# The 1-D x4 forest held to an independent build: realsim's configuration
# under squared error on a set of realsim's shape (N, F, 64 bins) whose
# every split is decisive (``decisive_data``), where the data-parallel
# forest must split as the unmeshed one, leaves within DECISIVE_LEAF_ATOL
# (the reference's own tolerance for its sharded builder).
DECISIVE_CFG = CFG._replace(loss="mse")
DECISIVE_BITS, DECISIVE_DECAY = 12, 0.9
DECISIVE_LEAF_ATOL = 1e-5
MESH_CLIS = {
    "1d x4": ["--arch", "gbdt", "--steps", "8", "--workers", "4", "--mesh", "1d",
              "--mesh-shape", "4", "--mesh-backend", MESH_BACKEND],
    "2d 1x4 sparse": ["--arch", "gbdt", "--steps", "8", "--workers", "4", "--mesh", "2d",
                      "--mesh-shape", "1x4", "--sparse", "--mesh-backend", MESH_BACKEND],
}
# That phase's entries in the kernels line: name -> KERNELS key.
MESH_LINE = {"histogram_mesh": "histogram", "split_gain_mesh": "split_gain",
             "histogram_sparse_mesh": "histogram_sparse"}
# The traversal forms' ragged case: rows (not a multiple of the kernel's
# 16-sample block) and live slots of each forest (not a multiple of the
# 16-tree pass, nor of K).
RAGGED_ROWS, RAGGED_LIVE = 1001, {"realsim": 237, "multiclass": 1233}
# The traversal's instances in ``csrc/forest_traversal.cu``: the narrowing
# pre-pass, the walk per layout with staged rows (one or two chunks in
# flight) and with device-memory rows, the sum.
TRAV_INSTANCES = 1 + 3 * 3 + 1
# The split gain's instances in ``csrc/split_scan.cu``: bins a lane 1-8,
# each with and without the decision.
SPLIT_INSTANCES = 8 * 2
# The traversal kernel's forms beside the f32 one-output entry, by their key
# in ``forest_traversal.form_launches``.
TRAV_FORMS = {
    "forest_traverse_int8": "int8",
    "forest_traverse_fp16": "fp16",
    "forest_traverse_k5": "k_f32",
    "forest_traverse_k5_int8": "k_int8",
    "forest_traverse_k5_fp16": "k_fp16",
}

# The LM zoo's serving path: granite-3-2b at full width through the flash
# kernel; its prompts are the prefill shape the kernel is checked at.
LM_ARCH = "granite-3-2b"
LM_SLOTS, LM_MAX_LEN, LM_NEW = 4, 2112, 32
LM_PROMPTS = (2048, 1024)  # one wave of LM_SLOTS requests each
LM_KERNELS = {
    "flash_attention": (flash_attention, "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:105"),
}
# The LM zoo's training path: granite-3-2b at full width on LM_SLOTS x
# LM_PROMPTS[0] tokens a step (the prefill's shape), the reference recipe.
TRAIN_STEPS, TRAIN_ACCUM, TRAIN_LR = 6, 2, 1e-3
TRAIN_DELAY, TRAIN_RHO, TRAIN_SAMPLE = 2, 0.3, 0.8
TRAIN_KERNELS = {
    "flash_attention_bwd_dq": ("dq", "src/repro_torch/csrc/flash_attention_bwd.cu",
                               "src/repro/kernels/flash_attention.py:305"),
    "flash_attention_bwd_dkv": ("dkv", "src/repro_torch/csrc/flash_attention_bwd.cu",
                                "src/repro/kernels/flash_attention.py:329"),
}
# Packed documents (``drive_lm_packed``): rows of LM_PROMPTS[0] + 1 tokens
# packed from seeded documents of PACKED_DOC_LEN tokens (as fractions of
# the row: 64-3072 at 2048), trained PACKED_STEPS steps at TRAIN_ACCUM;
# the last row keeps a pad tail of PACKED_PAD of the row.
PACKED_STEPS = 4
PACKED_DOC_LEN = (1 / 32, 3 / 2)
PACKED_PAD = 0.15
# The hybrid family: zamba2-1.2b at full width (38 Mamba2 layers in 6
# groups of 6 + 2 tail layers, one shared attention block of 32 q heads on
# 32 kv heads), served on LM_PROMPTS' waves and trained on the dense
# path's batches and recipe (run A). Its flash entries in the kernels
# line are the kernels at the shared block's shape (group 1). Its step
# profile takes one group's step (its Mamba2 layers and the shared block)
# on a step's rows cut to HYBRID_PROFILE_SEQ tokens (one SSM chunk): the
# profiler took 77 s over a whole step, 49 s over 4 x 512 and 44 s over 4 x
# 256 of the 38 layers (PERF.md §6).
HYBRID_ARCH = "zamba2-1.2b"
HYBRID_PROFILE_SEQ = 256
HYBRID_KERNELS = {
    "flash_attention_zamba2": LM_KERNELS["flash_attention"][1:],
    "flash_attention_bwd_dq_zamba2": TRAIN_KERNELS["flash_attention_bwd_dq"][1:],
    "flash_attention_bwd_dkv_zamba2": TRAIN_KERNELS["flash_attention_bwd_dkv"][1:],
}
# The MoE family: phi3.5-moe-42b at full width (d_model 4096, 32 q heads on
# 8 kv heads of 128, 16 experts of d_ff 6400, top-2, vocab 32,064, bf16).
# All 32 layers hold 83.7 GB of bf16 weights, more than the card's 80: it
# is served at MOE_SERVE_LAYERS layers on LM_PROMPTS' waves and trained at
# MOE_TRAIN_LAYERS on run A's batches and recipe (bf16 weights, f32
# accumulated gradients and moments: 16 bytes a parameter), its "dots" and
# packed runs MOE_EXTRA_STEPS steps each. Its flash entries in the kernels
# line are the kernels at its attention's shape (d 128).
MOE_ARCH = "phi3.5-moe-42b"
MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS, MOE_EXTRA_STEPS = 16, 2, 2
MOE_KERNELS = {
    "flash_attention_phi35": LM_KERNELS["flash_attention"][1:],
    "flash_attention_bwd_dq_phi35": TRAIN_KERNELS["flash_attention_bwd_dq"][1:],
    "flash_attention_bwd_dkv_phi35": TRAIN_KERNELS["flash_attention_bwd_dkv"][1:],
}
# The media families. llama-3.2-vision-90b at full width (d_model 8192, 64
# q heads on 8 kv heads of 128, d_ff 28,672, vocab 128,256; every 5th layer
# a gated cross-attention layer over 1601 media tokens): all 100 layers hold
# 175 GB of bf16 weights, so it is served at VLM_SERVE_LAYERS (4 groups of 4
# self + 1 cross) on LM_PROMPTS' waves, and trained at one group with plain
# SGD (a group's AdamW moments do not fit beside its f32 gradient
# accumulator) for VLM_TRAIN_STEPS steps of VLM_TRAIN_BATCH rows a step,
# cycling two batches (each seen twice); its cross layers' gates are set to
# VLM_GATES (at their init of 0 a cross layer is the identity). Its accuracy
# gates run at one group, where an f32 copy fits. Its flash entries in the
# kernels line are the kernels at its self layers' shape (group 8, d 128).
VLM_ARCH = "llama-3.2-vision-90b"
VLM_SERVE_LAYERS, VLM_TRAIN_LAYERS, VLM_TRAIN_STEPS, VLM_TRAIN_BATCH = 20, 5, 4, 2
VLM_GATES = {"gate_attn": 0.5, "gate_mlp": -0.3}
VLM_SGD_LR = 0.01
VLM_KERNELS = {
    "flash_attention_vlm": LM_KERNELS["flash_attention"][1:],
    "flash_attention_bwd_dq_vlm": TRAIN_KERNELS["flash_attention_bwd_dq"][1:],
    "flash_attention_bwd_dkv_vlm": TRAIN_KERNELS["flash_attention_bwd_dkv"][1:],
}
# whisper-small whole (12 encoder and 12 decoder layers, d_model 768, 12
# heads on 12 of 64, 1500 media frames): served in waves of AUDIO_SLOTS
# requests with AUDIO_PROMPTS' prompts and AUDIO_NEW new tokens within its
# 448-token decoding horizon (AUDIO_MAX_LEN), and trained on AUDIO_TRAIN
# (rows, tokens) a step with run A's recipe. Its flash entries are the
# kernels at the training shape (B 8 a microbatch, S 448: 3.5 key tiles);
# the serving prompts (one partial tile, 2.5 tiles) are checked beside it.
AUDIO_ARCH = "whisper-small"
AUDIO_SLOTS, AUDIO_PROMPTS, AUDIO_NEW, AUDIO_MAX_LEN = 8, (64, 320), 64, 448
AUDIO_TRAIN = (16, 448)
AUDIO_FLASH_SERVE = [(AUDIO_SLOTS, p, p, 12, 12, 64, True, torch.bfloat16, None)
                     for p in AUDIO_PROMPTS]
AUDIO_KERNELS = {
    "flash_attention_whisper": LM_KERNELS["flash_attention"][1:],
    "flash_attention_bwd_dq_whisper": TRAIN_KERNELS["flash_attention_bwd_dq"][1:],
    "flash_attention_bwd_dkv_whisper": TRAIN_KERNELS["flash_attention_bwd_dkv"][1:],
}
# The xLSTM family: xlstm-1.3b whole (48 layers: 6 groups of 7 mLSTM layers
# and one sLSTM layer, d_model 2048, 4 heads of 512, vocab 50,304, bf16;
# XLSTM_PARAMS parameters), served on LM_PROMPTS' waves and trained with
# run A's recipe (AdamW, accum TRAIN_ACCUM) on XLSTM_TRAIN (rows, tokens) a
# step for XLSTM_TRAIN_STEPS steps: the sLSTM's loop over positions is
# host-bound (tools/xlstm_probe.py, PERF.md section 4: a 4 x 512
# microbatch takes 8.3 s), so a microbatch is 4 x 128 (at 4 x 64 the loss
# moves less than the batches differ). No kernel of the
# port is on its path (the reference's xLSTM is plain jnp). Its accuracy
# gates hold the served model against the same weights at ssm_chunk
# XLSTM_OTHER["ssm_chunk"] (the same sums grouped otherwise) and both
# against f32 on the XLSTM_CHECK_PROMPT wave's prompts cut to
# XLSTM_CHECK_LEN tokens (two chunks), its decode on that wave, and its
# gradients on a run's microbatch (the two paths' chunks must differ at
# both lengths, or the comparison would hold a path to itself). The
# profiler's cost grows with the host ops it records (65.5 s for a 4 x
# 1024 prefill's and two decode steps', PERF.md §6), and a position of
# the sLSTM is about 27 host ops (94 with its backward), so the prefill
# profile takes the wave's first XLSTM_PROFILE["prefill"] tokens and the
# step profile one group (8 layers, the model's repeating unit) on
# XLSTM_PROFILE["train"] (rows, tokens); the share of a run's step that
# grows with the positions is read from an unprofiled step on
# XLSTM_PROFILE["positions"] (rows, tokens) beside the run's median.
XLSTM_ARCH = "xlstm-1.3b"
XLSTM_PARAMS = 1_239_206_224
XLSTM_TRAIN, XLSTM_TRAIN_STEPS = (8, 128), 4
# One microbatch a step: the sLSTM's loop a position runs once a step (at
# accum 2 it ran twice, 70-73% of a step's wall time); the gradient gate
# takes the first batch's first XLSTM_GRAD_ROWS rows.
XLSTM_ACCUM, XLSTM_GRAD_ROWS = 1, 4
XLSTM_OTHER = {"ssm_chunk": 64}
XLSTM_CHECK_PROMPT, XLSTM_CHECK_LEN = 1024, 512
XLSTM_PROFILE = {"prefill": 32, "train": (8, 32), "positions": (8, 8)}
# (b, sq, sk, h, kv, d, causal, dtype, seq_k): the ragged edges of each
# route (the wgmma kernel off its 128-row q tiles and 128-key tiles last;
# the 1000-row shapes give its persistent grid of 132 blocks 256 work
# tiles, so blocks run a second tile, with keys past seq_k masked; the
# 600-row shape gives the backward's dk/dv grid 576 key tiles, those past
# Sq without a q tile).
FLASH_RAGGED = [
    (1, 100, 100, 4, 2, 32, True, torch.bfloat16, None),
    (1, 96, 96, 2, 2, 128, False, torch.bfloat16, None),
    (2, 64, 192, 4, 4, 64, False, torch.bfloat16, None),
    (1, 100, 100, 4, 2, 80, True, torch.float32, None),
    (1, 200, 200, 8, 2, 64, True, torch.bfloat16, None),
    (1, 130, 300, 4, 4, 128, False, torch.bfloat16, None),
    (2, 1000, 1100, 16, 4, 128, True, torch.bfloat16, 950),
    (2, 1000, 1100, 16, 4, 128, False, torch.bfloat16, 1050),
    (2, 1000, 1100, 16, 4, 64, False, torch.bfloat16, 1050),
    (4, 600, 1100, 16, 16, 64, True, torch.bfloat16, 1000),
]
# A bf16 flash out's relative L2 error limit, over the whole tensor and
# over its later half of rows: above every sound reading and below every
# planted fault (``flash_planted_faults``; PERF.md, PR 17).
FLASH_OUT_REL_L2 = 1e-2
# The kernel names of SDPA's backends, matched in this order.
SDPA_BACKENDS = (("cudnn", "cuDNN"), ("flash", "flash"), ("fmha_cutlass", "memory-efficient"),
                 ("efficient", "memory-efficient"))


def reset_counts() -> None:
    """Set every kernel's launch count to 0 (each traversal form's)."""
    for mod, _, _ in list(KERNELS.values()) + list(LM_KERNELS.values()):
        if mod is not forest_traversal:
            mod.launches = 0
    forest_traversal.form_launches.update(dict.fromkeys(forest_traversal.form_launches, 0))
    flash_attention.route_launches.update(dict.fromkeys(flash_attention.route_launches, 0))
    flash_attention.bwd_launches = 0
    flash_attention.bwd_route_launches.update(
        dict.fromkeys(flash_attention.bwd_route_launches, 0))


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timed_once(fn, dev: torch.device) -> tuple:
    """``fn()`` and the ms of that one call: CUDA events on the card, the
    host clock elsewhere. The plain versions' times: one call of the
    check's own, which costs no more calls of a function that takes up to
    a second at the traversal's shapes."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        return fn(), 1e3 * (time.perf_counter() - t0)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


# Device times waiting to be taken: (fn, reps, into, key). torch.profiler
# leaves the tracer hooked into every later launch, which slows the host
# side of each op for the rest of the process, so the device times are taken
# after every event timing and every timed round that they could disturb.
_PENDING: list = []


def event_times(fn, into: dict | None = None, key: str = "", reps: int = 20,
                warmup: int = 2) -> dict:
    """``{key}ms``: the CUDA-event mean of ``reps`` back-to-back calls of
    ``fn`` (it includes the wrapper's host time where that is longer than
    the kernels), now; ``{key}device_ms``: the device time alone of the
    kernels another ``reps`` calls launch, by ``torch.profiler`` (CUDA
    activity), when ``fill_device_times`` runs (and, without a key,
    ``device_kernels``: the same by kernel name, and ``device_launches``:
    each kernel's launches a call). Returns ``into``."""
    d = {} if into is None else into
    d[key + "ms"] = cuda_ms(fn, reps, warmup)
    d[key + "device_ms"] = None
    _PENDING.append((fn, reps, d, key))
    return d


def device_rows(prof) -> list:
    """(kernel name, device ms, launches) of each kernel in a finished
    ``torch.profiler`` trace that took device time (a ``record_function``
    range's span on the device, a user annotation, is no kernel)."""
    return [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and not getattr(e, "is_user_annotation", False)
            and e.key not in RANGES]


def device_trace(fn, reps: int) -> list:
    """``device_rows`` of ``reps`` calls of ``fn``: a trace that caught no
    kernel, or whose launches of some kernel are no multiple of ``reps``
    (it lost some calls' kernels, or caught a first call's one-off), is
    taken again, three times in all; empty if none was whole. Traces
    taken again are counted in ``_PROFILER["traces_taken_again"]``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        if rows and all(c % reps == 0 for _, _, c in rows):
            return rows
        _PROFILER["traces_taken_again"] = _PROFILER.get("traces_taken_again", 0) + 1
    return []


# Whether torch.profiler records device time in this process: a trace of
# one known kernel, taken once (``profiler_sees_device``). Where it does not
# (CUPTI's activity tracing unavailable), every device time is a CUDA-event
# time instead and says so (``device_ms_by``).
_PROFILER: dict = {}


def profiler_sees_device() -> bool:
    if "sees_device" not in _PROFILER:
        x = torch.ones(1 << 20, device="cuda")
        _PROFILER["sees_device"] = bool(device_trace(lambda: x.add_(1), 4))
        if not _PROFILER["sees_device"]:
            env = sorted(k for k in os.environ
                         if re.search("CUPTI|KINETO|INJECTION|NSYS|DCGM", k))
            print("torch.profiler records no device time here (environment: "
                  f"{env or 'none of CUPTI/KINETO/INJECTION/NSYS/DCGM'}): every device "
                  "time below is a CUDA-event time", flush=True)
    return _PROFILER["sees_device"]


def busy(prof: dict, device_ms: float, wall_ms: float) -> float | None:
    """The device's busy share: a profiled device time over a wall time;
    None where the device time is a CUDA-event span (``device_ms_by``
    "events"), which holds the device's idle gaps."""
    return device_ms / wall_ms if prof["device_ms_by"] == "profiler" else None


def pct(share: float | None) -> str:
    return "not measured" if share is None else f"{100 * share:.0f}%"


def fill_device_times() -> None:
    """Take the device time of every pending function: by ``torch.profiler``
    where its traces hold the function's kernels, else by CUDA events over
    as many calls (``{key}device_ms_by`` "events"; no per-kernel split)."""
    for fn, reps, d, key in _PENDING:
        rows = device_trace(fn, reps) if profiler_sees_device() else []
        d[key + "device_ms_by"] = "profiler" if rows else "events"
        d[key + "device_ms"] = (sum(ms for _, ms, _ in rows) / reps if rows
                                else cuda_ms(fn, reps, warmup=0))
        if not key:
            d["device_kernels"] = {k[:80]: ms / reps for k, ms, _ in rows}
            d["device_launches"] = {k[:80]: c / reps for k, _, c in rows}
    _PENDING.clear()


def kernel_times(fn, reps: int = 20, warmup: int = 2) -> dict:
    """``event_times`` with the device time taken at once: ``ms``,
    ``device_ms`` and ``device_ms_by``."""
    d = event_times(fn, reps=reps, warmup=warmup)
    fill_device_times()
    return {"ms": d["ms"], "device_ms": d["device_ms"], "device_ms_by": d["device_ms_by"]}


def line_stats(shapes: dict, tag: str, drop: tuple = ()) -> dict:
    """A kernel's ``kernels``-line entry: the stats of shape ``tag`` (no
    per-name split, nor the keys in ``drop``), with the largest error over
    every shape checked."""
    out = {k: v for k, v in shapes[tag].items() if k not in ("device_kernels", *drop)}
    out["max_abs_err"] = max(v["max_abs_err"] for v in shapes.values())
    return out


def bound(nbytes: float, ops: float, peak_ops: float = PEAK_OPS_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def close(name: str, got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    """Require |got - want| <= atol + rtol |want| on finite cells and the same
    -inf cells exactly; returns the max abs error of the finite cells."""
    inf_got, inf_want = torch.isneginf(got), torch.isneginf(want)
    if not torch.equal(inf_got, inf_want):
        raise AssertionError(f"{name}: -inf masks differ in {int((inf_got ^ inf_want).sum())} cells")
    g, w = got[~inf_got], want[~inf_want]
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (g - w).abs()
    if bool((err > atol + rtol * w.abs()).any()):
        raise AssertionError(f"{name}: max abs error {float(err.max())} over tolerance")
    return float(err.max()) if err.numel() else 0.0


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def seeded_forest(rng: np.random.Generator, n_feat: int, base: float, dev) -> object:
    """A full 400-slot depth-9 forest of valid random trees."""
    depth = CFG.learner.depth
    slots, n_int = CFG.n_trees, (1 << depth) - 1
    return forest_from_numpy(
        rng.integers(0, n_feat, (slots, n_int)),
        rng.integers(0, CFG.learner.n_bins, (slots, n_int)),
        0.01 * rng.standard_normal((slots, 1 << depth)),
        slots, base, device=dev,
    )


def touched_bins(bins: torch.Tensor, forest, live: int) -> int:
    """Distinct (sample, feature) bin cells read by the walks of the first
    ``live`` trees of ``forest``."""
    n, f = bins.shape
    seen = torch.zeros(n * f, dtype=torch.bool, device=bins.device)
    row = torch.arange(n, device=bins.device)[:, None] * f
    tree = torch.arange(live, device=bins.device)[None, :]
    feature, threshold = forest.feature[:live].long(), forest.threshold[:live]
    node = torch.zeros((n, live), dtype=torch.long, device=bins.device)
    for _ in range(forest.depth):
        fid = feature[tree, node]
        seen[(row + fid).reshape(-1)] = True
        node = 2 * node + 1 + (bins.gather(1, fid) > threshold[tree, node]).long()
    return int(seen.sum())


def fused_levels(n: int, n_feat: int) -> list:
    """The levels of an efficiency-realsim tree that run as a fused level."""
    lc = CFG.learner
    return [lv for lv in range(lc.depth) if level_build.fused_level_fits(
        n, 1 << lv, max(1, (1 << lv) // 2), n_feat, lc.n_bins)]


def level_build_case(lc, bins, node, g, h, mask, level: int, parent, tag: str,
                     report: dict, key: str = "level_build") -> dict:
    """The fused level at ``level`` (``parent``, the level above's histogram,
    from level 1 on; the active rows are the smaller children of ``node``)
    under learner ``lc``: against its plain version summed in f64 (see
    ``histogram_case``; integer outputs exact up to ties; histogram and
    best gain within 1e-5 x max|cell|), bitwise against the learner's
    staged level on the same inputs, two launches bitwise. Ties go to
    ``report[key + "_tied_nodes"]``. Returns the stats (device time
    pending)."""
    n, f = bins.shape
    b = lc.n_bins
    mask_i = mask.to(torch.int32)
    n_nodes = 1 << level
    derive = level > 0
    active = (_smaller_children(node, h, n_nodes) if derive
              else torch.zeros(1, dtype=torch.int32, device=bins.device))
    args = (bins, node, g, h, active, parent, mask_i, lc.lam, lc.min_child_hess,
            n_nodes, b, derive)

    def run():
        return level_build.level_build(*args)
    k1, k2 = run(), run()
    torch.cuda.synchronize()
    for a, c in zip(k1, k2):
        if not torch.equal(a, c):
            raise AssertionError(f"{key} {tag}: two launches differ")
    staged = _staged_level(lc, bins, node, g, h, mask, level, parent)
    for name, a, c in zip(("hist", "feat", "thr", "new_node"),
                          (k1[0], k1[1], k1[2], k1[4]), staged):
        if not torch.equal(a, c):
            raise AssertionError(f"{key} {tag}: {name} differs from the staged level")
    plain = level_build.level_build_plain(
        bins, node, g.double(), h.double(), active, None if parent is None else parent.double(),
        *args[6:])
    scale = float(plain[0].abs().max())
    err = max(close(f"{key} {tag} hist", k1[0].double(), plain[0], 1e-5, 1e-5 * scale),
              close(f"{key} {tag} best_gain", k1[3].double(), plain[3], 1e-5, 1e-5 * scale))
    # Integer outputs exact, up to ties: at realsim the first tree's
    # gradients take two values (one per label) and most features hold a
    # few stored entries, so many (feature, threshold) pairs tie in exact
    # arithmetic (splits that part a node's samples alike), and the kernel's
    # f32 sums may pick another of them. Where the two pick different
    # splits, the kernel's must tie the f64 best within the gain tolerance
    # under the f64 gains: 1e-5 x the best gain. The samples of every node
    # where they agree must be routed alike.
    differ = (k1[1] != plain[1]) | (k1[2] != plain[2])
    if bool(differ.any()):
        gain = split_scan.split_gain_plain(plain[0], lc.lam, lc.min_child_hess)
        flat = gain.masked_fill(~mask[None, :, None], float("-inf")).reshape(n_nodes, -1)
        picked = flat.gather(1, (k1[1].long() * b + k1[2].long())[:, None])[:, 0]
        tie = (picked - plain[3]).abs() <= 1e-5 * plain[3].abs()
        if not bool(tie[differ].all()):
            bad = (differ & ~tie).nonzero()[:, 0][:4].tolist()
            raise AssertionError(
                f"{key} {tag}: feat/thr differ from the plain version at a node without a "
                f"tie: nodes {bad}, picked f64 gains {picked[bad].tolist()}, best "
                f"{plain[3][bad].tolist()}, kernel best {k1[3][bad].tolist()}")
    agree = ~differ[node.long()]
    if not torch.equal(k1[4][agree], plain[4][agree]):
        raise AssertionError(f"{key} {tag}: new_node differs from the plain version")
    report.setdefault(f"{key}_tied_nodes", {})[tag] = int(differ.sum())
    n_sub = active.shape[0]
    hit = int(torch.isin(node, active).sum())
    routed = int((node >= 0).sum())
    cells = n_nodes * f * b
    # Bytes the level needs: node ids, the bin rows and grad/hess of the
    # samples on built nodes, the active list, the parent cache, the
    # level histogram written, the split vectors, one bin per routed
    # sample and the new node ids. Operations: two adds a built cell,
    # about a dozen a scanned cell (unmasked features).
    nbytes = 4 * (n + hit * (f + 2) + n_sub + (2 * n_sub * f * b if derive else 0)
                  + 2 * cells + 3 * n_nodes + routed + n)
    ops = 2.0 * f * hit + 12.0 * n_nodes * int(mask.sum()) * b
    bms, by = bound(nbytes, ops)
    stats = event_times(run)
    stats.update({
        "max_abs_err": err,
        "plain_ms": cuda_ms(lambda: level_build.level_build_plain(*args), reps=5),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "staged_ms": cuda_ms(lambda: _staged_level(lc, bins, node, g, h, mask, level,
                                                   parent)),
        "samples_hit": hit,
    })
    return stats


def check_level_build(data, g, h, gen, report: dict, key: str = "level_build") -> dict:
    """The fused level at every realsim level that fuses (every level of
    ``data``'s shape that fuses): level 0 (full) and the subtract levels
    below it, on seeded node ids (``level_build_case``). Returns the stats
    by shape (device times pending), also ``report[key + "_shapes"]``."""
    dev = data.bins.device
    n, f = data.bins.shape
    b, lc = CFG.learner.n_bins, CFG.learner
    mask = torch.rand(f, generator=gen, device=dev) < lc.feature_fraction
    shapes = {}
    for level in fused_levels(n, f):
        n_nodes = 1 << level
        node = torch.randint(0, n_nodes, (n,), generator=gen, device=dev, dtype=torch.int32)
        parent = (histogram.histogram(data.bins, node >> 1, g, h, n_nodes // 2, b)
                  if level else None)
        tag = f"level{level}"
        shapes[tag] = level_build_case(lc, data.bins, node, g, h, mask, level, parent, tag,
                                       report, key=key)
    report[f"{key}_shapes"] = shapes
    report[f"{key}_bitwise_vs_staged"] = True
    return shapes


def check_histogram_sparse(sp, node8, active, g, h, report: dict,
                           key: str = "histogram_sparse") -> dict:
    """The stored-entry sparse histogram at level 0 and at the level-8
    smaller-child subset: within 1e-5 x max|cell| of its plain version, two
    launches bitwise. Returns the stats by shape (device times pending),
    also ``report[key + "_shapes"]``."""
    dev = sp.feat_rows.device
    f, c = sp.feat_rows.shape
    b = CFG.learner.n_bins
    node0 = torch.zeros(sp.n_samples, dtype=torch.int32, device=dev)
    valid = sp.feat_rows >= 0
    safe = torch.where(valid, sp.feat_rows, 0).long()
    shapes = {}
    for tag, node, n_nodes, act in (("level0", node0, 1, None),
                                    ("level8_subset", node8, 256, active)):
        args = (sp.feat_rows, sp.feat_codes, node, g, h, n_nodes, b, act)

        def run(args=args):
            return histogram_sparse.histogram_sparse(*args)
        k1, k2 = run(), run()
        torch.cuda.synchronize()
        if not torch.equal(k1, k2):
            raise AssertionError(f"{key} {tag}: two launches differ")
        plain = histogram_sparse.histogram_sparse_plain(*args)
        scale = float(plain.abs().max())
        err = close(f"{key} {tag}", k1, plain, 1e-5, 1e-5 * scale)
        rows = k1.shape[1]
        # The library yardstick (``library_times``) over the cells of the
        # stored entries that land on a built row.
        e_row = ref.node_rows(torch.where(valid, node[safe], -1), act, n_nodes)
        keep = e_row >= 0
        cell = ((e_row * f + torch.arange(f, device=dev)[:, None]) * b
                + sp.feat_codes.long())[keep]
        seg = torch.cat([cell, cell + rows * f * b])
        vals = torch.cat([g[safe][keep], h[safe][keep]])
        nnz = int(valid.sum())
        # Bytes the function needs: the (F, C) store, the node/grad/hess of
        # the stored entries, the row list and the (2, R, F, B) output.
        bms, by = bound(4 * (2 * f * c + 3 * nnz + rows + 2 * rows * f * b),
                        2.0 * int(keep.sum()))
        shapes[tag] = event_times(run)
        shapes[tag].update({
            "max_abs_err": err,
            "plain_ms": cuda_ms(
                lambda args=args: histogram_sparse.histogram_sparse_plain(*args), reps=5),
            "bound_ms": bms, "bound_by": by, "entries_hit": int(keep.sum()),
        })
        library_times(seg, vals, 2 * rows * f * b, shapes[tag])
    report[f"{key}_shapes"] = shapes
    report[f"{key}_store"] = {"F": f, "C": c, "E": sp.indices.shape[1], "nnz": nnz}
    return shapes


def library_times(seg: torch.Tensor, vals: torch.Tensor, cells: int, into: dict) -> dict:
    """The library yardstick, into ``into``: one ``index_add_`` into a fresh
    zeroed buffer of the whole (2, R, F, B) output, as the function writes
    it (allocation, zero fill and scatter on every repetition); ``seg``, the
    cells the values land in, is computed before the timer starts. Also the
    figure PR 14 recorded, an ``index_add_`` into one buffer zeroed once,
    whose sums pile up across repetitions and which writes no zeros: below
    the output-write bound at a deep level, so it is kept only to show what
    changed."""
    flat = torch.zeros(cells, device=seg.device)
    event_times(lambda: torch.zeros(cells, device=seg.device).index_add_(0, seg, vals),
                into, key="library_")
    into["library_accumulating_ms"] = cuda_ms(lambda: flat.index_add_(0, seg, vals))
    return into


def kernel_inputs(data) -> tuple:
    """Round 0's gradients under R = 0.8 sampling, a seeded level-8 node
    assignment (samples with h = 0 on node -1), its smaller children, and
    the generator that drew them."""
    dev = data.bins.device
    n = data.n_samples
    state = init_state(CFG, data)
    g0, h0 = CFG.obj.grad_hess(data.labels, state.f)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    m = torch.binomial(torch.ones(n, device=dev), torch.full((n,), 0.8, device=dev),
                       generator=gen) / 0.8
    g, h = (m * g0).contiguous(), m.contiguous()
    node8 = torch.randint(0, 256, (n,), generator=gen, device=dev, dtype=torch.int32)
    node8 = torch.where(h > 0, node8, torch.full_like(node8, -1))
    return g, h, node8, _smaller_children(node8, h, 256), gen


def histogram_case(bins, g, h, node, n_nodes: int, act, n_bins: int, tag: str,
                   report: dict, key: str = "histogram",
                   plan_features: int | None = None) -> dict:
    """The histogram of the rows ``act`` (every node's row where None) of a
    level of ``n_nodes``: within 1e-5 x max|cell| of its plain version
    summed in f64 (on the card the f32 plain version adds with atomics, one
    long chain a cell: at level 0 under Newton hessians it strays 0.106
    from the f64 sums where the kernel strays 0.0013, the tolerance being
    0.039), two launches bitwise; times, bound and the library yardstick.
    The samples on built rows go to ``report[key + "_samples_hit"]``.
    ``plan_features``: the launch plan's F, as a feature shard takes it.
    Returns the stats (device times pending)."""
    dev = bins.device
    n, f = bins.shape
    b = n_bins

    def run():
        return histogram.histogram(bins, node, g, h, n_nodes, b, act, plan_features)
    k1, k2 = run(), run()
    torch.cuda.synchronize()
    if not torch.equal(k1, k2):
        raise AssertionError(f"{key} {tag}: two launches differ")
    plain = histogram.histogram_plain(bins, node, g.double(), h.double(), n_nodes, b, act)
    scale = float(plain.abs().max())
    err = close(f"{key} {tag}", k1.double(), plain, 1e-5, 1e-5 * scale)
    rows = n_nodes if act is None else act.shape[0]
    hit = int((node >= 0).sum()) if act is None else int(torch.isin(node, act).sum())
    # Bytes the function needs: every node id, the bin rows and grad/hess
    # of the samples on built nodes only, the row map and the output.
    nbytes = 4 * (n + hit * (f + 2) + rows + 2 * rows * f * b)
    bms, by = bound(nbytes, 2.0 * f * hit)
    report.setdefault(f"{key}_samples_hit", {})[tag] = hit
    row_of = torch.full((n_nodes,), -1, dtype=torch.int64, device=dev)
    row_of[(torch.arange(n_nodes, device=dev) if act is None else act.long())] = \
        torch.arange(rows, device=dev)
    r = torch.where(node >= 0, row_of[node.long().clamp(min=0)], -1)
    keep = r >= 0
    cell = ((r[:, None] * f + torch.arange(f, device=dev)) * b + bins.long())[keep]
    seg = torch.cat([cell.reshape(-1), (cell + rows * f * b).reshape(-1)])
    vals = torch.cat([g[keep][:, None].expand(-1, f).reshape(-1),
                      h[keep][:, None].expand(-1, f).reshape(-1)])
    stats = event_times(run)
    stats.update({
        "max_abs_err": err,
        "plain_ms": cuda_ms(lambda: histogram.histogram_plain(bins, node, g, h, n_nodes, b,
                                                              act), reps=5),
        "bound_ms": bms, "bound_by": by,
    })
    return library_times(seg, vals, 2 * rows * f * b, stats)


def check_histogram(data, g, h, node8, active, report: dict, key: str = "histogram") -> dict:
    """The histogram at the full level 0 and at the level-8 smaller-child
    subset (``histogram_case``). Returns the stats by shape (device times
    pending), also ``report[key + "_shapes"]``."""
    node0 = torch.zeros(data.n_samples, dtype=torch.int32, device=data.bins.device)
    shapes = {tag: histogram_case(data.bins, g, h, node, n_nodes, act, CFG.learner.n_bins,
                                  tag, report, key=key)
              for tag, node, n_nodes, act in (("level0", node0, 1, None),
                                              ("level8_subset", node8, 256, active))}
    report[f"{key}_shapes"] = shapes
    return shapes


def sweep_levels(data, sp, g, h, gen, report: dict) -> list:
    """Both histogram kernels and the split gain's decision form at each of
    one realsim tree's nine levels (the staged learner's nodes, subtract
    mode: the full level 0, then each level's smaller children; the split
    gain on the level's whole histogram, its decision checked as
    ``split_gain_case`` checks it): device time, rows, output bytes and the
    time the output write alone takes at 3.35 TB/s, so the per-launch floor
    and the output-write share can be read off; the split gain's bytes
    bound. Takes every pending device time (``fill_device_times``) once its
    own event timings are done."""
    lc = CFG.learner
    n, f = data.bins.shape
    b = lc.n_bins
    mask = torch.rand(f, generator=gen, device=data.bins.device) < lc.feature_fraction
    node = torch.zeros(n, dtype=torch.int32, device=data.bins.device)
    parent, rows_out = None, []
    for level in range(lc.depth):
        n_nodes = 1 << level
        act = None if level == 0 else _smaller_children(node, h, n_nodes)
        rows = 1 if act is None else act.shape[0]
        times = (event_times(lambda node=node, n_nodes=n_nodes, act=act: histogram.histogram(
                     data.bins, node, g, h, n_nodes, b, act)),
                 event_times(lambda node=node, n_nodes=n_nodes, act=act:
                             histogram_sparse.histogram_sparse(
                                 sp.feat_rows, sp.feat_codes, node, g, h, n_nodes, b, act)))
        out_bytes = 4 * 2 * rows * f * b
        row = {
            "level": level, "rows": rows, "output_bytes": out_bytes,
            "output_write_us": 1e6 * out_bytes / PEAK_BYTES_S,
            "samples_hit": int((node >= 0).sum()) if act is None
            else int(torch.isin(node, act).sum()),
        }
        parent, _, _, node = _staged_level(lc, data.bins, node, g, h, mask, level, parent)
        split = split_gain_case(parent, lc.lam, lc.min_child_hess, scale_by="terms", mask=mask)
        rows_out.append((row, times, split))
    fill_device_times()
    sweep = [{**row, "histogram_device_us": 1e3 * dense["device_ms"],
              "histogram_us": 1e3 * dense["ms"],
              "histogram_sparse_device_us": 1e3 * sparse["device_ms"],
              "histogram_sparse_us": 1e3 * sparse["ms"],
              "split_gain_device_us": 1e3 * split["device_ms"], "split_gain_us": 1e3 * split["ms"],
              "split_gain_surface_us": 1e3 * split["surface_ms"],
              "split_gain_plain_us": 1e3 * split["plain_ms"],
              "split_gain_bound_us": 1e3 * split["bound_ms"]}
             for row, (dense, sparse), split in rows_out]
    report["histogram_level_sweep"] = sweep
    return sweep


def split_gain_case(hist: torch.Tensor, lam: float, min_h: float,
                    scale_by: str = "gain", mask: torch.Tensor | None = None) -> dict:
    """The split gain of ``hist`` within rtol 1e-5 and atol 1e-5 x scale of
    its plain version, -inf cells exact; its decision form under ``mask``
    ((F,) bool or int32; every feature where None): the surface within the
    same tolerance, each node's (best, idx) bitwise the plain chain's
    (``masked_fill``, ``argmax``, ``gather``) on the kernel's own surface.
    Times (the decision form, the main path's launch: event and device,
    pending; the surface alone and the plain chain: event) and bound. The
    scale is the largest finite gain, or with ``scale_by="terms"`` the
    largest sum of a finite cell's three terms' magnitudes,
    |G_L^2 / (H_L + lam)| + |G_R^2 / (H_R + lam)| + |G^2 / (H + lam)|: the
    size the f32 prefix sums round at. Below a tree's root, where a node's
    best gain is a small difference of large terms (the multiclass data),
    the two versions' scans differ by ulps of the terms, not of the gain."""
    l, f = hist.shape[1], hist.shape[2]
    mask = (torch.ones(f, dtype=torch.int32, device=hist.device) if mask is None
            else mask.to(torch.int32))
    gain = split_scan.split_gain(hist, lam, min_h)
    plain = split_scan.split_gain_plain(hist, lam, min_h)
    fin = torch.isfinite(plain)
    if scale_by == "terms":
        gl, hl = torch.cumsum(hist[0].double(), -1), torch.cumsum(hist[1].double(), -1)
        gt, ht = gl[..., -1:], hl[..., -1:]
        terms = gl ** 2 / (hl + lam) + (gt - gl) ** 2 / (ht - hl + lam) + gt ** 2 / (ht + lam)
        finite = terms[fin]
    else:
        finite = plain[fin]
    scale = float(finite.abs().max()) if finite.numel() else 1.0
    err = close(f"split_gain L={l}", gain, plain, 1e-5, 1e-5 * scale)
    dgain, best, idx = split_scan.split_gain_decide(hist, lam, min_h, mask)
    err = max(err, close(f"split_gain_decide L={l}", dgain, plain, 1e-5, 1e-5 * scale))
    flat = dgain.masked_fill((mask == 0)[None, :, None], float("-inf")).reshape(l, -1)
    want = torch.argmax(flat, dim=-1)
    if not (torch.equal(idx, want) and torch.equal(best, flat.gather(1, want[:, None])[:, 0])):
        raise AssertionError(f"split_gain_decide L={l}: the decision differs from the plain "
                             "chain on the kernel's surface")
    cells = hist[0].numel()
    # Bytes: the histogram read, the surface written, the mask, (best, idx).
    bms, by = bound(4 * 3 * cells + 4 * f + 12 * l, 12 * cells)
    stats = event_times(lambda: split_scan.split_gain_decide(hist, lam, min_h, mask))
    stats.update({
        "max_abs_err": err,
        "surface_ms": cuda_ms(lambda: split_scan.split_gain(hist, lam, min_h)),
        "plain_ms": cuda_ms(lambda: split_scan.split_gain_decide_plain(hist, lam, min_h, mask),
                            reps=5),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
    })
    return stats


def split_decide_ties(f: int, b: int, dev) -> None:
    """The decision form's tie-break is the first maximum: four nodes of F
    features with bitwise-equal maxima (identical rows) at features 7, F/2
    and F-2 (node 1 also at 5; rows in different blocks), every other row
    without hessian mass (all -inf); then feature 7 masked."""
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    row = torch.randn(b, generator=gen)
    hist = torch.zeros((2, 4, f, b))
    for node, feats in ((0, (7, f // 2, f - 2)), (1, (5, 7, f // 2, f - 2)),
                        (2, (7, f // 2, f - 2)), (3, (7, f // 2, f - 2))):
        for feat in feats:
            hist[0, node, feat], hist[1, node, feat] = row, 1.25
    hist = hist.to(dev)
    lc = CFG.learner
    top = int(split_scan.split_gain_plain(hist, lc.lam, lc.min_child_hess)[0, 7].argmax())
    mask = torch.ones(f, dtype=torch.int32, device=dev)
    for want in ([7, 5, 7, 7], [f // 2, 5, f // 2, f // 2]):
        _, _, idx = split_scan.split_gain_decide(hist, lc.lam, lc.min_child_hess, mask)
        if idx.tolist() != [w * b + top for w in want]:
            raise AssertionError("split_gain_decide on the card does not pick the first "
                                 f"maximum: {idx.tolist()}, want features {want}")
        mask[7] = 0


def check_kernels(data, sp, rng, report: dict) -> dict:
    """Phase 4: each kernel against its plain version at the main path's
    shapes, with its time (event mean and device alone), its plain
    version's time, its bound and a library call's time."""
    dev = data.bins.device
    n, f = data.bins.shape
    b = CFG.learner.n_bins
    g, h, node8, active, gen = kernel_inputs(data)
    hist_shapes = check_histogram(data, g, h, node8, active, report)

    # Split gain at L = 256, on a real level-8 histogram.
    hist = histogram.histogram(data.bins, node8, g, h, 256, b)
    mgen = torch.Generator(device=dev)
    mgen.manual_seed(SEED + 1)
    mask = torch.rand(f, generator=mgen, device=dev) < CFG.learner.feature_fraction
    gain_shapes = {"L=256": split_gain_case(hist, CFG.learner.lam, CFG.learner.min_child_hess,
                                            mask=mask)}
    split_decide_ties(f, b, dev)

    # Traversal: 4000 rows x 400 slots, n_trees = 400 and 16, and the
    # serving wave (``WAVE_ROWS`` rows, every slot live); bitwise.
    forest = seeded_forest(rng, f, 0.0, dev)
    depth = forest.depth
    trav_shapes = {}
    for tag, rows, live in (("n_trees=400", n, 400), ("n_trees=16", n, 16),
                            (f"wave{WAVE_ROWS}", WAVE_ROWS, 400)):
        b = data.bins[:rows].contiguous()
        nt = torch.tensor(live, dtype=torch.int32, device=dev)
        args = (forest.feature, forest.threshold, forest.leaf_value, nt, depth)

        def run(b=b, args=args):
            return forest_traversal.forest_traverse(b, *args)
        got = run()
        want, plain_ms = timed_once(lambda: forest_traversal.forest_traverse_plain(b, *args),
                                    dev)
        if not torch.equal(got, want):
            raise AssertionError(f"forest_traverse {tag}: differs from the plain version")
        # Bytes the function needs: the bin cells the walks read, the live
        # trees' arrays, n_trees and the output.
        bms, by, cells = traversal_bound(b, forest, live)
        trav_shapes[tag] = event_times(run)
        trav_shapes[tag].update({
            "max_abs_err": 0.0,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None,
            "plan": traversal_plan_of(b, forest),
        })
        report.setdefault("forest_traverse_bin_cells_read", {})[tag] = cells
    report["forest_traverse_shapes"] = trav_shapes

    lb_shapes = check_level_build(data, g, h, gen, report)
    sp_shapes = check_histogram_sparse(sp, node8, active, g, h, report)
    sweep_levels(data, sp, g, h, gen, report)  # takes every pending device time
    deep = max(report["level_build_shapes"], key=lambda t: int(t[len("level"):]))
    return {
        "histogram": line_stats(hist_shapes, "level8_subset"),
        "split_gain": line_stats(gain_shapes, "L=256", drop=("surface_ms",)),
        "forest_traverse": line_stats(trav_shapes, "n_trees=400", drop=("plan",)),
        "level_build": line_stats(lb_shapes, deep, drop=("staged_ms", "samples_hit")),
        "histogram_sparse": line_stats(sp_shapes, "level8_subset", drop=("entries_hit",)),
    }


def train(data, cfg=CFG, round_s: list | None = None, fused_per_round: list | None = None,
          ckpt=None, workers: int = WORKERS):
    """Phase 2: 16 rounds of efficiency-realsim (``cfg``: staged or fused)
    under round-robin W = ``workers`` (4). ``round_s`` collects a host time stamp after
    each round (and one before the first); ``fused_per_round`` the fused
    levels each round's tree ran; ``ckpt`` (a ``CheckpointManager``) saves
    the ``TrainState`` through the trainer's eval hook at each round its
    ``save_every`` divides."""
    marks = [level_build.launches]

    def tick(state, j):
        if ckpt is not None:
            ckpt.maybe_save(j, state)
        if round_s is not None:
            torch.cuda.synchronize()
            round_s.append(time.perf_counter())
            marks.append(level_build.launches)

    if round_s is not None:
        torch.cuda.synchronize()
        round_s.append(time.perf_counter())
    state = Trainer(cfg, device=data.bins.device).train(
        data, ("round_robin", workers), seed=SEED, rounds=ROUNDS,
        eval_every=1 if round_s is not None or ckpt is not None else 0, eval_fn=tick,
    )
    if fused_per_round is not None:
        fused_per_round.extend(b - a for a, b in zip(marks, marks[1:]))
    return state


def draw_requests(x: np.ndarray, rng, n: int) -> list:
    """``n`` raw-float requests of 1-600 rows (the first one 600, oversized
    for a 256-row wave), each a random slice of ``x``."""
    sizes = [600] + [int(s) for s in rng.integers(1, 257, n - 1)]
    reqs = []
    for uid, size in enumerate(sizes):
        lo = int(rng.integers(0, x.shape[0] - size + 1))
        reqs.append(PredictRequest(uid, x[lo:lo + size]))
    return reqs


def serve(forest, x: np.ndarray, edges, rng, objective="logistic", quantize=None) -> tuple:
    """Phase 3: 8 raw-float requests of 1..600 rows, one of them oversized,
    through ``ForestServer`` (``quantize`` packs the forest); returns
    (server, requests, results)."""
    server = ForestServer(forest, edges, max_rows=WAVE_ROWS, objective=objective,
                          quantize=quantize, device=edges.device)
    reqs = draw_requests(x, rng, 8)
    return server, reqs, server.run(reqs)


def check_served(tag: str, server, reqs, results) -> dict:
    """Every request answered, each answer equal to link(forest_predict) on
    the installed forest (f32 or quantized, one output or K), with the
    forest sum taken by the traversal's plain version over all requests'
    rows at once."""
    if [r.uid for r in results] != list(range(len(reqs))):
        raise AssertionError(f"{tag}: not every request was answered")
    fo = server.forest
    x = torch.from_numpy(np.concatenate([r.x for r in reqs])).to(server.device)
    raw = fo.base_score + forest_traversal.forest_traverse_plain(
        apply_bins(x, server.bin_edges), fo.feature, fo.threshold, fo.leaf_value,
        fo.n_trees, fo.depth, fo.n_outputs, getattr(fo, "leaf_scale", None))
    want_all = server.objective.link(raw).cpu().numpy()
    err, lo = 0.0, 0
    for req, res in zip(reqs, results):
        want = want_all[lo:lo + len(req.x)]
        lo += len(req.x)
        if res.scores.shape != want.shape or not np.isfinite(res.scores).all():
            raise AssertionError(f"{tag}: request {req.uid} came back malformed")
        np.testing.assert_allclose(res.scores, want, rtol=1e-6, atol=1e-7)
        err = max(err, float(np.abs(res.scores - want).max()))
    lat = np.array([r.latency_s for r in results]) * 1e3
    return {"requests": len(results), "rows": [len(r.x) for r in reqs],
            "waves": server.waves_served,
            "latency_p50_ms": float(np.percentile(lat, 50)),
            "latency_p99_ms": float(np.percentile(lat, 99)), "max_abs_err": err}


def profile_rounds(data, cfg, rounds: int = 2) -> dict:
    """Where a training round's device time goes: ``torch.profiler`` over a
    short run (after a warm-up round), device time by kernel name; the
    run's span by CUDA events a round, idle gaps included, where the
    profiler records no device time (``device_ms_by``); the argmax and
    masked_fill calls a profiled round (``chain_calls``) and in the warm-up
    round (``ChainCalls``); the split kernel's launches a round, by its
    wrapper's count."""
    from torch.profiler import ProfilerActivity, profile

    trainer = Trainer(cfg, device=data.bins.device)
    with ChainCalls() as warm_up:
        trainer.train(data, ("round_robin", WORKERS), seed=SEED, rounds=1)
    torch.cuda.synchronize()
    split0 = split_scan.launches
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        trainer.train(data, ("round_robin", WORKERS), seed=SEED, rounds=rounds)
        stop.record()
        torch.cuda.synchronize()
    rows = device_rows(prof) if profiler_sees_device() else []
    rows.sort(key=lambda r: -r[1])
    return {"rounds": rounds, "device_ms_by": "profiler" if rows else "events",
            "device_ms_per_round": (sum(r[1] for r in rows) if rows
                                    else start.elapsed_time(stop)) / rounds,
            "top": [{"name": k[:80], "device_ms_per_round": ms / rounds, "calls": c}
                    for k, ms, c in rows[:12]],
            # The split-gain kernel's launches a round, and those of the
            # torch chain its decision form replaced (mask, argmax).
            "split_kernel_calls": (split_scan.launches - split0) / rounds,
            "argmax_or_masked_fill_calls": chain_calls(prof, rows) / rounds,
            "argmax_or_masked_fill_calls_warm_up": warm_up.calls}


class ChainCalls(torch.overrides.TorchFunctionMode):
    """Counts the argmax and masked_fill calls made under it (``torch`` and
    tensor-method forms, in place too), with no profiler."""

    NAMES = ("argmax", "masked_fill", "masked_fill_")

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls += getattr(func, "__name__", "") in self.NAMES
        return func(*args, **(kwargs or {}))


def chain_calls(prof, rows: list) -> int:
    """The argmax and masked_fill calls in a finished trace: its host-side
    ops (``aten::argmax``, ``aten::masked_fill``, ``aten::masked_fill_``),
    recorded with or without device tracing, and its kernels of those names
    among ``rows`` (``device_rows``)."""
    host = sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CPU
               and re.fullmatch(r"aten::(argmax|masked_fill_?)", e.key))
    return host + sum(c for k, _, c in rows if re.search("ArgMax|masked_fill", k))


def check_no_chain(tag: str, prof: dict) -> None:
    """A profiled round's staged levels run the decision in the split-gain
    kernel: no argmax or masked_fill over the surface."""
    if prof["argmax_or_masked_fill_calls"] or prof["argmax_or_masked_fill_calls_warm_up"]:
        raise AssertionError(f"profile ({tag}): {prof['argmax_or_masked_fill_calls']} argmax "
                             "or masked_fill ops and launches a profiled round, "
                             f"{prof['argmax_or_masked_fill_calls_warm_up']} calls in the "
                             "warm-up round")


def first_tree_ties(data, dense, sparse) -> int:
    """The heap nodes of the first tree's levels 0-2 where the sparse run's
    split differs from the dense run's, below agreeing ancestors. Each must
    be a tie: under the dense histogram of the node's samples the two splits'
    gains agree within 1e-5 (relative). At realsim the first tree's
    gradients take two values, so distinct splits that move the same counts
    of each label tie in exact arithmetic, and the two layouts' sums round
    them differently."""
    dev, b, lc = data.bins.device, CFG.learner.n_bins, CFG.learner
    m, _, mask = ps_engine.round_draws(CFG, data, SEED, 0)  # round 0's draws
    g0, _ = CFG.obj.grad_hess(data.labels, init_state(CFG, data).f)
    tree = build_tree(lc, data.bins, m * g0, m, mask)
    fd, td = dense.forest.feature[0], dense.forest.threshold[0]
    if not (torch.equal(tree.feature, fd) and torch.equal(tree.threshold, td)):
        raise AssertionError("round 0's draws do not rebuild the first tree")
    fs, ts = sparse.forest.feature[0], sparse.forest.threshold[0]
    heap = torch.zeros(data.n_samples, dtype=torch.int64, device=dev)
    ties, agree = 0, {0}
    for i in range(7):
        if i in (1, 3):  # the next level: route every sample one step down
            right = gather_feature_bins(data.bins, fd.long()[heap]) > td[heap]
            heap = 2 * heap + 1 + right.long()
        if i not in agree:
            continue
        if (fd[i], td[i]) == (fs[i], ts[i]):
            agree |= {2 * i + 1, 2 * i + 2}
            continue
        on = torch.where(heap == i, 0, -1).to(torch.int32)
        hist = histogram.histogram_plain(data.bins, on, m * g0, m, 1, b)
        gain = split_scan.split_gain_plain(hist, lc.lam, lc.min_child_hess)
        gain = gain.masked_fill(~mask[None, :, None], float("-inf")).reshape(-1)
        gd, gs = gain[fd[i] * b + td[i]], gain[fs[i] * b + ts[i]]
        if not bool((gd - gs).abs() <= 1e-5 * gd.abs()):
            raise AssertionError(f"sparse run: first tree's node {i} splits differently "
                                 f"without a tie (gains {float(gd)} vs {float(gs)})")
        ties += 1
    return ties


def same_forest(tag: str, a, b) -> None:
    """Require two training states to be bitwise equal."""
    for name in ("feature", "threshold", "leaf_value", "n_trees"):
        if not torch.equal(getattr(a.forest, name), getattr(b.forest, name)):
            raise AssertionError(f"{tag}: forest.{name} differs")
    if not torch.equal(a.f, b.f):
        raise AssertionError(f"{tag}: f differs")


def gbdt_counts() -> dict:
    """Each GBDT kernel's launches since ``reset_counts``, with the
    traversal's under its f32 one-output form's key (the kernel's name) and
    every form's key."""
    counts = {name: mod.launches for name, (mod, _, _) in KERNELS.items()
              if mod is not forest_traversal}
    counts.update(forest_traversal.form_launches)
    counts["forest_traverse"] = counts["f32"]
    return counts


def drive(dev: torch.device) -> dict:
    """Phases 2 and 3 on ``dev``, the main path: only their launches are
    counted. They run before any kernel check: the profiler that reads the
    checks' device times would slow the host side of every later op (see
    ``_PENDING``), and the rounds are host-bound. Returns what the checks
    need."""
    cfg, data = gbdt_configs.get(REALSIM, device=dev)
    if cfg != CFG:
        raise AssertionError(f"configs.gbdt.get({REALSIM!r}) returned another config")
    x, y, mult = synthetic.raw(gbdt_configs.EXPERIMENTS[REALSIM].dataset)
    sparse = bin_dataset(x, y, n_bins=64, multiplicity=mult, device=dev, sparse=True)
    rng = np.random.default_rng(SEED)
    ckpt_root = HANDOFF_DIR / "realsim"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    ckpt = checkpoint.CheckpointManager(ckpt_root, save_every=HANDOFF_HALF, keep=4)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    stamps: dict = {"staged": [], "fused": [], "sparse": []}
    fused_per_round: list = []
    # The second staged run (untimed) checkpoints at rounds 8 and 16 for the
    # handoff phase.
    runs = {"staged": train(data, CFG, stamps["staged"]), "again": train(data, CFG, ckpt=ckpt),
            "fused": train(data, CFG_FUSED, stamps["fused"], fused_per_round),
            "sparse": train(sparse, CFG, stamps["sparse"]), "sparse_again": train(sparse, CFG)}
    served = serve(runs["staged"].forest, x, data.bin_edges, rng)
    seeded = seeded_forest(rng, data.n_features, float(runs["staged"].forest.base_score), dev)
    full = serve(seeded, x, data.bin_edges, rng)
    torch.cuda.synchronize()
    return {"data": data, "sparse": sparse, "x": x, "rng": rng, "runs": runs,
            "stamps": stamps, "fused_per_round": fused_per_round, "served": (served, full),
            "counts": gbdt_counts(), "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
            "forest": runs["staged"].forest, "ckpt_root": ckpt_root}


def check_drive(run: dict, report: dict) -> list:
    """Phase 4 (every kernel against its plain version; it takes every
    pending device time) and the checks of phases 2 and 3 on ``drive``'s
    run; then a profiled round of each run. Returns the ``kernels`` line's
    entries."""
    data, sparse, x, rng = run["data"], run["sparse"], run["x"], run["rng"]
    runs, counts, peak_gb = run["runs"], run["counts"], run["peak_gb"]
    state, sp1 = runs["staged"], runs["sparse"]
    kstats = check_kernels(data, sparse.bins, rng, report)
    print("kernel checks: " + json.dumps(
        {k: {"max_abs_err": v["max_abs_err"], "ms": v["ms"], "device_ms": v["device_ms"]}
         for k, v in kstats.items()}), flush=True)
    print("level_build bitwise equal to the staged level at levels "
          + ", ".join(report["level_build_shapes"]), flush=True)
    card = report.get("nvidia_smi", "card not queried")
    phases = report.setdefault("level_build_phases", {})
    for tag, st in report["level_build_shapes"].items():
        phases[f"realsim {tag}"] = level_phases(st.get("device_kernels") or {})
    print("forest_traverse f32 bitwise equal to the plain version (event / device / bound ms): "
          + traversal_times(report["forest_traverse_shapes"]) + f" [{card}]", flush=True)
    sweep = "; ".join(
        f"L{r['level']} R{r['rows']} {r['histogram_device_us']:.1f} / "
        f"{r['histogram_sparse_device_us']:.1f} ({r['output_write_us']:.1f})"
        for r in report["histogram_level_sweep"])
    print("histogram sweep, device us per level (dense / sparse; output-write us): "
          f"{sweep} [{report.get('nvidia_smi', '')}]", flush=True)
    split = "; ".join(
        f"L{r['level']} {r['split_gain_device_us']:.1f} ({r['split_gain_bound_us']:.1f})"
        for r in report["histogram_level_sweep"])
    print("split_gain_decide sweep, device us per level (bytes bound us), the decision bitwise "
          f"the plain chain's on the kernel's surface at every level: {split} [{card}]",
          flush=True)

    # The checks of phases 2 and 3.
    round_ms = {k: [1e3 * (b - a) for a, b in zip(v, v[1:])] for k, v in run["stamps"].items()}
    median_ms = {k: float(np.median(v[1:])) for k, v in round_ms.items()}
    for k, v in round_ms.items():
        print(f"round ms ({k}): " + " ".join(f"{t:.1f}" for t in v), flush=True)
    print("median round ms (rounds 2-16): "
          + ", ".join(f"{k} {v:.2f}" for k, v in median_ms.items())
          + f"; peak device memory {peak_gb:.2f} GB", flush=True)
    loss0 = float(CFG.obj.loss(data.labels, init_state(CFG, data).f, data.multiplicity))
    loss = float(CFG.obj.loss(data.labels, state.f, data.multiplicity))
    loss_sp = float(CFG.obj.loss(data.labels, sp1.f, data.multiplicity))
    print(f"train loss {loss0:.6f} -> {loss:.6f} after {ROUNDS} rounds (sparse layout "
          f"{loss_sp:.6f})", flush=True)
    if not (np.isfinite(loss) and loss < loss0):
        raise AssertionError("training loss did not fall")
    same_forest("second staged run", state, runs["again"])
    torch.testing.assert_close(forest_predict(state.forest, data.bins), state.f,
                               rtol=1e-5, atol=1e-6)

    # (i) The fused run: the staged forest bit for bit.
    want = fused_levels(data.n_samples, data.n_features)
    if run["fused_per_round"] != [len(want)] * ROUNDS:
        raise AssertionError(f"fused levels per tree {run['fused_per_round']}, "
                             f"expected {len(want)}")
    same_forest("fused run vs staged run", runs["fused"], state)
    print(f"fused run: levels {want} fused in each of the {ROUNDS} trees, levels "
          f"{[lv for lv in range(CFG.learner.depth) if lv not in want]} staged; forest and f "
          "bitwise equal to the staged run", flush=True)

    # (ii) The sparse layout: deterministic, the loss falls to within 1e-3 of
    # the dense run's, the first tree's levels 0-2 are the dense run's.
    same_forest("second sparse run", sp1, runs["sparse_again"])
    if not (np.isfinite(loss_sp) and loss_sp < loss0 and abs(loss_sp - loss) <= 1e-3):
        raise AssertionError(f"sparse loss {loss_sp} vs dense {loss} (start {loss0})")
    ties = first_tree_ties(data, state, sp1)
    torch.testing.assert_close(forest_predict(sp1.forest, data.bins), sp1.f,
                               rtol=1e-5, atol=1e-6)
    print(f"sparse run: two runs bitwise equal; loss {loss_sp:.6f} vs dense {loss:.6f} "
          f"(|diff| {abs(loss_sp - loss):.2e}); first tree's levels 0-2 equal to the dense "
          f"run's up to {ties} tied node(s)", flush=True)

    served = check_served("trained forest", *run["served"][0])
    full = check_served("seeded 400-slot forest", *run["served"][1])
    for label, st in (("trained", served), ("seeded 400-slot", full)):
        print(f"serve {label}: {st['requests']} requests over {st['waves']} waves, latency "
              f"p50 {st['latency_p50_ms']:.3f} ms p99 {st['latency_p99_ms']:.3f} ms", flush=True)
    report.update(round_ms=round_ms, median_round_ms=median_ms, fused_levels=want,
                  sparse_first_tree_ties=ties,
                  loss={"start": loss0, "staged": loss, "sparse": loss_sp},
                  serve_trained=served, serve_seeded=full, launches=counts,
                  peak_mem_gb=peak_gb, kernels=kstats)
    if data.bins.device.type == "cuda":
        report["profile"] = {}
        for tag, d, cfg in (("staged", data, CFG), ("fused", data, CFG_FUSED),
                            ("sparse", sparse, CFG)):
            prof = report["profile"][tag] = profile_rounds(d, cfg)
            # Busy share: profiled device time per round over the median wall
            # time of an unprofiled round (the first round is warm-up).
            prof["device_busy_share"] = busy(prof, prof["device_ms_per_round"], median_ms[tag])
            check_no_chain(tag, prof)
            print(f"profile ({tag}): device {prof['device_ms_per_round']:.4f} ms per round "
                  f"({prof['device_ms_by']}), "
                  f"busy {pct(prof['device_busy_share'])} of a round's wall time; "
                  f"split kernel {prof['split_kernel_calls']:g} launches a round, argmax or "
                  f"masked_fill {prof['argmax_or_masked_fill_calls']:g} [{card}]", flush=True)

    # The kernels line; every kernel of the path must have run.
    line = []
    for name, (_, source, replaces) in KERNELS.items():
        if counts[name] <= 0:
            raise AssertionError(f"{name}: no launch on the main path")
        line.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": counts[name], **kstats[name]})
    return line


def same_tensors(tag: str, a, b) -> None:
    """Require two NamedTuples of tensors (forests, states) to be bitwise
    equal and on one device."""
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, torch.Tensor):
            if x.device != y.device or x.dtype != y.dtype or not torch.equal(x, y):
                raise AssertionError(f"{tag}: {name} differs")
        elif isinstance(x, tuple):
            same_tensors(f"{tag}.{name}", x, y)
        elif x != y:
            raise AssertionError(f"{tag}: {name} {x} != {y}")


def check_restore(run: dict) -> dict:
    """The checkpoints of ``drive``'s second staged run: restored on the card
    with the CRC checked, bitwise the trained state (round 16) and its
    first 8 slots (round 8); the manifest in the reference's layout;
    ``load_forest_checkpoint`` bitwise the trained forest."""
    root, state = run["ckpt_root"], run["runs"]["again"]
    if checkpoint.steps(root) != [HANDOFF_HALF, ROUNDS]:
        raise AssertionError(f"checkpoints {checkpoint.steps(root)}, expected "
                             f"{[HANDOFF_HALF, ROUNDS]}")
    restore_ms = []
    for _ in range(RELOAD_REPS):
        t0 = time.perf_counter()
        back = checkpoint.restore_pytree(root, ROUNDS, state, check_crc=True)
        restore_ms.append(1e3 * (time.perf_counter() - t0))
        same_tensors("restored round-16 state", back, state)
    if type(back.step) is not int or back.step != ROUNDS:
        raise AssertionError(f"restored step {back.step!r}")
    half = checkpoint.restore_pytree(root, HANDOFF_HALF, state, check_crc=True)
    empty = empty_forest(CFG.n_trees, CFG.learner.depth, device=state.f.device)
    k = HANDOFF_HALF
    for name in ("feature", "threshold", "leaf_value"):
        got, done, rest = (getattr(half.forest, name), getattr(state.forest, name),
                           getattr(empty, name))
        if not (torch.equal(got[:k], done[:k]) and torch.equal(got[k:], rest[k:])):
            raise AssertionError(f"round-{k} checkpoint: forest.{name} is not the run's "
                                 f"first {k} slots")
    if int(half.forest.n_trees) != k or half.step != k:
        raise AssertionError(f"round-{k} checkpoint holds {int(half.forest.n_trees)} trees")
    manifest = checkpoint.leaf_manifest(root, ROUNDS)
    layout = [(p, e["dtype"]) for p, e in manifest.items()]
    if layout != REF_LAYOUT:
        raise AssertionError(f"manifest layout {layout} is not the reference's {REF_LAYOUT}")
    shapes = {p: e["shape"] for p, e in manifest.items()}
    forest = load_forest_checkpoint(root, ROUNDS, like=state.forest, device=state.f.device)
    same_tensors("load_forest_checkpoint", forest, state.forest)
    return {"steps": checkpoint.steps(root), "restore_ms": restore_ms, "shapes": shapes,
            "bytes": sum((p.stat().st_size for p in checkpoint.step_dir(root, ROUNDS).iterdir()))}


def check_swap(run: dict, forest8, reqs: list) -> dict:
    """Hot swap: a server on the round-8 forest answers ``reqs`` (each
    result labelled 8), gets the checkpoint root, reloads round 16 (timed,
    ``latest_step`` to install) and answers them again, every result
    bitwise a fresh round-16 server's. Then each form (f32, int8, fp16)
    reloads RELOAD_REPS times on fresh round-8 servers, timed, the last
    one's answers bitwise a fresh server's of that form."""
    root, state, edges = run["ckpt_root"], run["runs"]["again"], run["data"].bin_edges
    dev = edges.device

    def server(forest, step, quantize=None, ckpt_root=None):
        return ForestServer(forest, edges, ckpt_root=ckpt_root, max_rows=WAVE_ROWS,
                            model_step=step, objective="logistic", quantize=quantize,
                            device=dev)

    def same_answers(tag, got, want):
        for a, b in zip(got, want):
            if a.uid != b.uid or {a.model_step, b.model_step} != {ROUNDS} \
                    or not np.array_equal(a.scores, b.scores):
                raise AssertionError(f"{tag}: request {a.uid} differs from a fresh "
                                     "round-16 server's answer")

    live = server(forest8, HANDOFF_HALF)
    before = live.run(reqs)
    if {r.model_step for r in before} != {HANDOFF_HALF}:
        raise AssertionError("a request before the swap was not labelled "
                             f"{HANDOFF_HALF}")
    live.ckpt_root = root
    t0 = time.perf_counter()
    swapped = live.maybe_reload()
    first_ms = 1e3 * (time.perf_counter() - t0)
    if not swapped or live.model_step != ROUNDS:
        raise AssertionError(f"maybe_reload left the server at step {live.model_step}")
    after = live.run(reqs)
    same_answers("hot swap", after, server(state.forest, ROUNDS).run(reqs))
    changed = sum(not np.array_equal(a.scores, b.scores) for a, b in zip(before, after))
    reload_ms = {}
    for mode in (None, "int8", "fp16"):
        times = []
        for _ in range(RELOAD_REPS):
            fresh = server(forest8, HANDOFF_HALF, mode, root)
            t0 = time.perf_counter()
            fresh.maybe_reload()
            times.append(1e3 * (time.perf_counter() - t0))
            if fresh.model_step != ROUNDS:
                raise AssertionError(f"{mode or 'f32'} reload left step {fresh.model_step}")
        same_answers(f"{mode or 'f32'} reload", fresh.run(reqs),
                     server(state.forest, ROUNDS, mode).run(reqs))
        reload_ms[mode or "f32"] = times
    return {"live": live, "first_reload_ms": first_ms, "reload_ms": reload_ms,
            "requests_changed_by_the_swap": changed, "waves": live.waves_served}


def check_poller(run: dict, live) -> dict:
    """An idle server (the swapped one) with its poller running picks up a
    newly written step (the round-16 state saved as step 17) within
    POLL_BOUND_S, serving no wave meanwhile."""
    root, state = run["ckpt_root"], run["runs"]["again"]
    waves = live.waves_served
    live.start_reload_poller(interval_s=POLL_S)
    try:
        checkpoint.save_pytree(root, ROUNDS + 1, state)
        saved = time.perf_counter()
        while time.perf_counter() - saved < POLL_BOUND_S:
            with live._lock:
                step = live.model_step
            if step == ROUNDS + 1:
                break
            time.sleep(0.005)
        lag_ms = 1e3 * (time.perf_counter() - saved)
    finally:
        live.stop_reload_poller()
    if step != ROUNDS + 1 or live.waves_served != waves:
        raise AssertionError(f"idle poller: step {step} after {lag_ms:.0f} ms "
                             f"(bound {POLL_BOUND_S} s)")
    return {"pickup_ms": lag_ms, "interval_s": POLL_S, "bound_s": POLL_BOUND_S}


def check_engine(run: dict, forest8, forest16, reqs: list) -> dict:
    """``ForestEngine`` on the card, run by its background thread: "half"
    (the round-8 forest, f32) and "full" (round 16, int8, weight 3).
    Requests arrive ENGINE_GAP_S apart. Each is served by the version
    ``route_hash`` picks and labelled with its step; "half" answers are
    link(forest_predict) within 1e-6, "full" answers within
    ``quantization_atol`` + 1e-6 of the f32 round-16 forest's (the logistic
    link, sigmoid(2F), moves less than its margin does)."""
    edges = run["data"].bin_edges
    steps = {"half": HANDOFF_HALF, "full": ROUNDS}
    eng = ForestEngine(edges, max_rows=WAVE_ROWS, slo_s=ENGINE_SLO_S, device=edges.device)
    eng.add_version("half", forest8, model_step=steps["half"], objective="logistic")
    eng.add_version("full", forest16, model_step=steps["full"], objective="logistic",
                    quantize="int8", weight=3.0)
    eng.start(interval_s=0.001)
    got = []
    try:
        for r in reqs:
            eng.submit(r)
            time.sleep(ENGINE_GAP_S)
        deadline = time.perf_counter() + 30.0
        while len(got) < len(reqs) and time.perf_counter() < deadline:
            got.extend(eng.poll())
            time.sleep(0.002)
    finally:
        eng.stop()
    got = sorted(got + eng.poll(), key=lambda r: r.uid)
    if [r.uid for r in got] != [r.uid for r in reqs]:
        raise AssertionError("continuous engine: not every request answered once")
    q8 = forest16.quantize("int8")
    atol = quantization_atol(forest16, q8)
    bins = [apply_bins(torch.from_numpy(r.x).to(edges.device), edges) for r in reqs]
    err = {"half": 0.0, "full": 0.0}
    for r, b in zip(got, bins):
        want = "half" if route_hash(r.uid) < 0.25 else "full"
        if r.version != want or r.model_step != steps[want]:
            raise AssertionError(f"request {r.uid}: version {r.version} step {r.model_step}, "
                                 f"route_hash picks {want} (step {steps[want]})")
        ref = CFG.obj.link(forest_predict(forest8 if want == "half" else forest16, b))
        diff = float(np.abs(r.scores - ref.cpu().numpy()).max())
        err[want] = max(err[want], diff)
        if diff > (1e-6 if want == "half" else atol + 1e-6):
            raise AssertionError(f"request {r.uid} ({want}): off by {diff} (int8 bound {atol})")
    split = {v: sum(r.version == v for r in got) for v in steps}
    return {"latency": percentile_latencies(got), "split": split, "max_abs_err": err,
            "quantization_atol": atol, "requests": len(got), "slo_s": ENGINE_SLO_S,
            "gap_s": ENGINE_GAP_S}


def run_clis(train_clis: dict | None = None, serve_clis: dict | None = None) -> dict:
    """The train and serve CLIs as a user runs them (on the card; by default
    ``TRAIN_CLIS`` and ``SERVE_CLIS``): each must exit clean with its own
    asserts, a train run with the objective's K trees a round; their output
    is kept, not printed."""
    train_clis = TRAIN_CLIS if train_clis is None else train_clis
    serve_clis = SERVE_CLIS if serve_clis is None else serve_clis
    out = {}
    for tag, argv in train_clis.items():
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            state = train_cli.main(argv)
        k = (get_objective(argv[argv.index("--objective") + 1]).n_outputs
             if "--objective" in argv else 1)
        steps = int(argv[argv.index("--steps") + 1])
        if int(state.forest.n_trees) != steps * k or not torch.isfinite(state.f).all():
            raise AssertionError(f"train CLI ({tag}): {int(state.forest.n_trees)} trees")
        out[f"train {tag}"] = {"s": time.perf_counter() - t0,
                               "tail": buf.getvalue().splitlines()[-2:]}
    for tag, argv in serve_clis.items():
        root = HANDOFF_DIR / f"serve_{tag.replace(' ', '_')}"
        shutil.rmtree(root, ignore_errors=True)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            results = serve_cli.main(argv + ["--ckpt-dir", str(root)])
        if not results or not all(np.isfinite(r.scores).all() for r in results):
            raise AssertionError(f"serve CLI ({tag}) returned no finite results")
        out[f"serve {tag}"] = {"s": time.perf_counter() - t0,
                               "lines": buf.getvalue().splitlines()[1:3]}
    return out


def drive_handoff(run: dict, report: dict) -> None:
    """The handoff phase, after the realsim drive, with its own launch
    counts (reset just before, read just after): checkpoint restore, hot
    swap with the reload timed in every form, the idle poller, the
    continuous engine and the train and serve CLIs. Every gate raises."""
    state, x = run["runs"]["again"], run["x"]
    dev = state.f.device
    card = report.get("nvidia_smi", "card not queried")
    rng = np.random.default_rng(SEED + 7)
    reset_counts()
    t0 = time.perf_counter()
    restored = check_restore(run)
    forest8 = load_forest_checkpoint(run["ckpt_root"], HANDOFF_HALF, like=state.forest,
                                     device=dev)
    forest16 = load_forest_checkpoint(run["ckpt_root"], ROUNDS, like=state.forest, device=dev)
    swap = check_swap(run, forest8, draw_requests(x, rng, 8))
    poller = check_poller(run, swap.pop("live"))
    engine = check_engine(run, forest8, forest16, draw_requests(x, rng, ENGINE_REQUESTS))
    clis = run_clis()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    counts = gbdt_counts()
    wall_s = time.perf_counter() - t0
    need = ("histogram", "split_gain", "level_build", "histogram_sparse", "f32", "int8", "fp16")
    if any(counts[k] <= 0 for k in need):
        raise AssertionError(f"handoff: a kernel of the path never launched: {counts}")
    report["handoff"] = {"restore": restored, "swap": swap, "poller": poller,
                         "engine": engine, "cli": clis, "launches": counts, "wall_s": wall_s}
    med = {k: float(np.median(v)) for k, v in swap["reload_ms"].items()}
    lat = engine["latency"]
    print(f"handoff: round-{ROUNDS} TrainState restored bitwise on the card (CRC checked; "
          f"first {restored['restore_ms'][0]:.1f} ms, median of {RELOAD_REPS} "
          f"{float(np.median(restored['restore_ms'])):.1f}), round {HANDOFF_HALF} its first "
          "slots, manifest in "
          "the reference's layout, load_forest_checkpoint bitwise; hot swap "
          f"{HANDOFF_HALF} -> {ROUNDS}, every answer bitwise a fresh round-{ROUNDS} server's "
          f"({swap['requests_changed_by_the_swap']} of 8 requests changed)", flush=True)
    print("handoff reload ms (latest_step to install, median of "
          f"{RELOAD_REPS}; first swap {swap['first_reload_ms']:.2f}): "
          + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
          + f"; idle poller picked up step {ROUNDS + 1} in {poller['pickup_ms']:.1f} ms "
          f"(every {POLL_S} s, bound {POLL_BOUND_S} s) [{card}]", flush=True)
    print(f"handoff engine ({engine['requests']} requests {ENGINE_GAP_S * 1e3:g} ms apart, "
          f"split {engine['split']}, int8 within {engine['max_abs_err']['full']:.3g} of "
          f"f32, bound {engine['quantization_atol']:.3g}): p50/p99 ms queue "
          f"{lat['queue_p50_ms']:.3f}/{lat['queue_p99_ms']:.3f}, compute "
          f"{lat['compute_p50_ms']:.3f}/{lat['compute_p99_ms']:.3f}, end-to-end "
          f"{lat['latency_p50_ms']:.3f}/{lat['latency_p99_ms']:.3f} [{card}]", flush=True)
    print("handoff CLIs exit clean: " + "; ".join(f"{k} {v['s']:.1f} s"
                                                  for k, v in clis.items()), flush=True)
    print("handoff launches: " + json.dumps({k: counts[k] for k in need})
          + f"; phase wall {wall_s:.1f} s", flush=True)


@contextlib.contextmanager
def recorded_scales():
    """The scale of every server-side deflation (``engine.scale_push``) made
    under it, in fold order (0-d f32 tensors)."""
    seen: list = []
    push = ps_engine.scale_push

    def record(cfg, data, tree, scale):
        seen.append(scale)
        return push(cfg, data, tree, scale)

    ps_engine.scale_push = record
    try:
        yield seen
    finally:
        ps_engine.scale_push = push


def drive_e2006(dev: torch.device, realsim: dict) -> dict:
    """The e2006 and step-rules phase, after the handoff phase, with its own
    launch counts (set to 0 just before, read just after; its e2006 part's
    read on their own too): efficiency-e2006 trained 16 rounds at W = 4
    staged (twice), fused and on the sparse layout (twice), its forest
    served f32, int8 and fp16 with the identity link; then, on realsim's
    data, Newton leaves staged and fused, the adaptive step beside the fixed
    one under W = 1, and under W = 4 (beside ``drive``'s staged run), each
    fold's scale recorded; then the train and serve CLIs of the regression
    and ranking objectives. Every run comes before any kernel check (see
    ``drive``). Returns what the checks need."""
    cfg, data = gbdt_configs.get(E2006, device=dev)
    if cfg != E2006_CFG:
        raise AssertionError(f"configs.gbdt.get({E2006!r}) returned another config")
    x, y, mult = synthetic.raw(gbdt_configs.EXPERIMENTS[E2006].dataset)
    sparse = bin_dataset(x, y, n_bins=64, multiplicity=mult, device=dev, sparse=True)
    rs = realsim["data"]
    rng = np.random.default_rng(SEED + 11)
    stamps: dict = {"staged": [], "fused": [], "sparse": [], "newton": [], "newton_fused": []}
    fused_per_round: dict = {"e2006": [], "newton": []}
    reset_counts()
    t0 = time.perf_counter()
    runs = {"staged": train(data, E2006_CFG, stamps["staged"]), "again": train(data, E2006_CFG),
            "fused": train(data, E2006_CFG_FUSED, stamps["fused"], fused_per_round["e2006"]),
            "sparse": train(sparse, E2006_CFG, stamps["sparse"]),
            "sparse_again": train(sparse, E2006_CFG)}
    served = {mode: serve(runs["staged"].forest, x, data.bin_edges, rng, objective="mse",
                          quantize=mode) for mode in QUANT_MODES}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    e2006_counts, e2006_s = gbdt_counts(), time.perf_counter() - t0
    with recorded_scales() as scales:
        runs["newton"] = train(rs, NEWTON_CFG, stamps["newton"])
        runs["newton_fused"] = train(rs, NEWTON_CFG_FUSED, stamps["newton_fused"],
                                     fused_per_round["newton"])
        runs["fixed_w1"] = train(rs, CFG, workers=1)
        runs["adaptive_w1"] = train(rs, ADAPTIVE_CFG, workers=1)
        runs["adaptive_w4"] = train(rs, ADAPTIVE_CFG)
    clis = run_clis(OBJECTIVE_TRAIN_CLIS, OBJECTIVE_SERVE_CLIS)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"data": data, "sparse": sparse, "x": x, "runs": runs, "stamps": stamps,
            "fused_per_round": fused_per_round, "served": served, "scales": scales,
            "fixed_w4": realsim["runs"]["staged"], "realsim": rs,
            "realsim_sparse": realsim["sparse"], "clis": clis, "e2006_counts": e2006_counts,
            "counts": gbdt_counts(), "e2006_s": e2006_s, "wall_s": time.perf_counter() - t0}


def first_tree(data, cfg):
    """Round 0's tree of a run of ``cfg`` on ``data``, rebuilt outside the
    engine: ticket 0's draws (``round_draws``: Bernoulli weights, then the
    feature mask), the gradient at the initial F, the hessian weights of
    ``cfg.step_kind`` (m' h for Newton, m' for the gradient step), the
    leaves scaled by v."""
    dev, lc = data.bins.device, cfg.learner
    m, _, mask = ps_engine.round_draws(cfg, data, SEED, 0)
    g, h = cfg.obj.grad_hess(data.labels, init_state(cfg, data).f, qid=data.qid)
    tree = build_tree(lc, data.bins, m * g, m * h if cfg.step_kind == "newton" else m, mask)
    v = torch.tensor(cfg.step_length, dtype=torch.float32, device=dev)
    return tree._replace(leaf_value=v * tree.leaf_value)


def loss_fell(tag: str, cfg, data, state) -> tuple[float, float]:
    """(start, end) train loss; the end must be finite and below the start;
    the forest must predict the trained F (1e-5)."""
    loss0 = float(train_loss(cfg, data, init_state(cfg, data)))
    loss = float(train_loss(cfg, data, state))
    if not (np.isfinite(loss) and loss < loss0):
        raise AssertionError(f"{tag}: training loss did not fall ({loss0} -> {loss})")
    torch.testing.assert_close(forest_predict(state.forest, data.bins), state.f,
                               rtol=1e-5, atol=1e-6)
    return loss0, loss


def check_newton(data, newton, fused, fused_per_round: list, gradient) -> dict:
    """Newton leaves on realsim's data: the fused run bitwise the staged one
    (levels that fuse as a fused level in every tree), the loss falling,
    round 0's tree bitwise the one rebuilt with the hessian weights m' h,
    and the forest not the gradient step's."""
    want = fused_levels(*data.bins.shape)
    if fused_per_round != [len(want)] * ROUNDS:
        raise AssertionError(f"newton: fused levels per tree {fused_per_round}, expected "
                             f"{len(want)}")
    same_forest("newton: fused run vs staged run", fused, newton)
    loss0, loss = loss_fell("newton", NEWTON_CFG, data, newton)
    tree = first_tree(data, NEWTON_CFG)
    for name in ("feature", "threshold", "leaf_value"):
        if not torch.equal(getattr(tree, name), getattr(newton.forest, name)[0]):
            raise AssertionError(f"newton: round 0's {name} is not the build on the hessian "
                                 "weights m' h")
    if torch.equal(newton.forest.leaf_value, gradient.forest.leaf_value):
        raise AssertionError("newton: the forest is the gradient step's")
    return {"loss": {"start": loss0, "newton": loss}, "fused_levels": want}


def check_adaptive(data, runs: dict, fixed_w4, scales: list) -> dict:
    """The staleness-adaptive step (rho ``STEP_RHO``) on realsim's data:
    under W = 1 every scale is 1.0 and the forest and F are the fixed
    step's bit for bit; under W = 4 the scales applied are
    ``schedules.staleness_scales`` bit for bit, the forest is not the fixed
    step's, rounds 0-3 (built from F^0 in both runs) are the fixed run's
    trees with their leaf tables times the fold's scale, bit for bit, and
    the forest predicts F."""
    dev = data.bins.device
    same_forest("adaptive step under W = 1 vs the fixed step", runs["adaptive_w1"],
                runs["fixed_w1"])
    want = {w: staleness_scales(resolve_schedule(("round_robin", w), CFG.n_trees)[:ROUNDS],
                                STEP_RHO) for w in (1, WORKERS)}
    got = np.array([s.item() for s in scales], np.float32)
    expect = np.concatenate([want[1], want[WORKERS]])
    if got.shape != expect.shape or not np.array_equal(got.view(np.int32),
                                                       expect.view(np.int32)):
        raise AssertionError(f"adaptive step: scales applied {got.tolist()}, "
                             f"staleness_scales {expect.tolist()}")
    ada = runs["adaptive_w4"]
    if torch.equal(ada.forest.leaf_value, fixed_w4.forest.leaf_value):
        raise AssertionError("adaptive step under W = 4: the forest is the fixed step's")
    for j in range(WORKERS):
        s = torch.tensor(want[WORKERS][j], device=dev)
        for name in ("feature", "threshold"):
            if not torch.equal(getattr(ada.forest, name)[j], getattr(fixed_w4.forest, name)[j]):
                raise AssertionError(f"adaptive step: round {j}'s {name} is not the fixed "
                                     "run's")
        if not torch.equal(ada.forest.leaf_value[j], s * fixed_w4.forest.leaf_value[j]):
            raise AssertionError(f"adaptive step: round {j}'s leaves are not the fixed run's "
                                 f"times its scale {float(s)}")
    loss0, loss = loss_fell("adaptive step under W = 4", ADAPTIVE_CFG, data, ada)
    return {"scales_w4": want[WORKERS].tolist(), "loss": {"start": loss0, "adaptive_w4": loss,
            "fixed_w4": float(train_loss(CFG, data, fixed_w4))}}


def check_e2006(run: dict, report: dict) -> None:
    """The gates of ``drive_e2006``'s runs: e2006 staged twice bitwise, the
    fused run bitwise the staged one (the levels that fuse at F 2000 fused in
    every tree), the sparse run twice bitwise and its loss within 1e-3 of
    the dense run's, the loss falling; the served answers and quantized
    margins (``check_serving_modes``); the step rules (``check_newton``,
    ``check_adaptive``); the CLIs ran in ``drive_e2006``. Prints the phase."""
    data, runs = run["data"], run["runs"]
    card = report.get("nvidia_smi", "card not queried")
    state = runs["staged"]
    same_forest("e2006: second staged run", state, runs["again"])
    loss0, loss = loss_fell("e2006", E2006_CFG, data, state)
    want = fused_levels(*data.bins.shape)
    if run["fused_per_round"]["e2006"] != [len(want)] * ROUNDS:
        raise AssertionError(f"e2006: fused levels per tree {run['fused_per_round']['e2006']}, "
                             f"expected {len(want)}")
    same_forest("e2006: fused run vs staged run", runs["fused"], state)
    same_forest("e2006: second sparse run", runs["sparse"], runs["sparse_again"])
    _, loss_sp = loss_fell("e2006 sparse", E2006_CFG, data, runs["sparse"])
    if abs(loss_sp - loss) > 1e-3:
        raise AssertionError(f"e2006: sparse loss {loss_sp} vs dense {loss}")
    serve_stats = check_serving_modes("e2006", state.forest, run["x"], data.bin_edges,
                                      run["served"], card)
    newton = check_newton(run["realsim"], runs["newton"], runs["newton_fused"],
                          run["fused_per_round"]["newton"], run["fixed_w4"])
    adaptive = check_adaptive(run["realsim"], runs, run["fixed_w4"], run["scales"])
    round_ms = {k: [1e3 * (b - a) for a, b in zip(v, v[1:])] for k, v in run["stamps"].items()}
    median_ms = {k: float(np.median(v[1:])) for k, v in round_ms.items()}
    counts = run["counts"]
    need = ("histogram", "split_gain", "level_build", "histogram_sparse", "f32", "int8", "fp16")
    if any(run["e2006_counts"][k] <= 0 for k in need):
        raise AssertionError(f"e2006: a kernel of the path never launched: {run['e2006_counts']}")
    report["e2006"] = {
        "config": {"dataset": vars(gbdt_configs.EXPERIMENTS[E2006].dataset),
                   "depth": E2006_CFG.learner.depth, "slots": E2006_CFG.n_trees,
                   "rounds": ROUNDS, "workers": WORKERS},
        "loss": {"start": loss0, "staged": loss, "sparse": loss_sp}, "fused_levels": want,
        "round_ms": round_ms, "median_round_ms": median_ms, "serve": serve_stats,
        "newton": newton, "adaptive": adaptive, "cli": run["clis"],
        "launches": counts, "e2006_launches": run["e2006_counts"],
        "e2006_s": run["e2006_s"], "wall_s": run["wall_s"],
    }
    for k, v in round_ms.items():
        print(f"e2006 phase round ms ({k}): " + " ".join(f"{t:.1f}" for t in v), flush=True)
    print(f"e2006: train loss {loss0:.6f} -> {loss:.6f} after {ROUNDS} rounds (sparse "
          f"{loss_sp:.6f}, |diff| {abs(loss_sp - loss):.2e}); second staged run, fused run "
          f"(levels {want} of {E2006_CFG.learner.depth} fused at F {data.n_features}) and "
          "second sparse run bitwise equal to the first; median round ms (rounds 2-16) "
          + ", ".join(f"{k} {v:.2f}" for k, v in median_ms.items()) + f" [{card}]", flush=True)
    print(f"newton (realsim): loss {newton['loss']['start']:.6f} -> "
          f"{newton['loss']['newton']:.6f} (gradient step "
          f"{adaptive['loss']['fixed_w4']:.6f}); fused bitwise staged; round 0 bitwise the "
          "build on m' h", flush=True)
    print(f"adaptive step rho {STEP_RHO} (realsim): W = 1 bitwise the fixed step; W = 4 scales "
          f"{[round(v, 6) for v in adaptive['scales_w4'][:WORKERS]]}... bitwise "
          f"staleness_scales, rounds 0-{WORKERS - 1} the fixed trees times their scale; loss "
          f"{adaptive['loss']['adaptive_w4']:.6f} (fixed {adaptive['loss']['fixed_w4']:.6f})",
          flush=True)
    print("e2006 phase CLIs exit clean: " + "; ".join(f"{k} {v['s']:.1f} s"
                                            for k, v in run["clis"].items()), flush=True)
    print("e2006 phase launches (e2006 part / whole phase): " + json.dumps(
        {k: [run["e2006_counts"][k], counts[k]] for k in need})
        + f"; phase wall {run['wall_s']:.1f} s (e2006 part {run['e2006_s']:.1f} s)",
        flush=True)


def round_inputs(data, cfg, f: torch.Tensor, seed: int) -> tuple:
    """A round's (g, h) on ``data`` at F = ``f`` under ``cfg``'s objective
    and step rule (h = m' h for Newton, m' otherwise; m' from a generator
    seeded ``seed``), a seeded level-8 node assignment (samples with h = 0
    on node -1), its smaller children, and the generator."""
    dev = data.bins.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    m, _ = bernoulli_weights(gen, cfg.sampling_rate, data.multiplicity)
    g0, h0 = cfg.obj.grad_hess(data.labels, f, qid=data.qid)
    g = (m * g0).contiguous()
    h = (m * h0 if cfg.step_kind == "newton" else m).contiguous()
    node8 = torch.randint(0, 256, (data.n_samples,), generator=gen, device=dev,
                          dtype=torch.int32)
    node8 = torch.where(h > 0, node8, torch.full_like(node8, -1))
    return g, h, node8, _smaller_children(node8, h, 256), gen


def check_e2006_kernels(run: dict, report: dict) -> dict:
    """Every GBDT kernel of the e2006 and step-rules phase against its plain
    version: at e2006's shapes (N 3000, F 2000) with e2006's gradients at
    its trained F (h = m'), and at realsim's with the Newton run's (h = m'
    4p(1 - p) at its trained F). The histogram at level 0 and at the level-8
    subset and the sparse histogram at both (``histogram_case``,
    ``check_histogram_sparse``: 1e-5 x max|cell|, two launches bitwise), the
    split gain's decision form at L = 256 (``split_gain_case``, the atol
    scaled by the terms; the decision bitwise the plain chain's), the fused
    level at every level that fuses (``level_build_case``: bitwise the
    staged level); then the traversal's f32, int8 and fp16 forms on a
    seeded full 400-slot depth-9 forest over F 2000 at 3000 rows and at the
    256-row wave, bitwise. Returns the stats by kernel and shape (device
    times pending)."""
    lc = CFG.learner
    shapes: dict = {k: {} for k in ("histogram", "split_gain", "level_build",
                                    "histogram_sparse")}
    for tag, data, sp, cfg, f in (
            ("e2006", run["data"], run["sparse"].bins, E2006_CFG, run["runs"]["staged"].f),
            ("newton", run["realsim"], run["realsim_sparse"].bins, NEWTON_CFG,
             run["runs"]["newton"].f)):
        g, h, node8, active, gen = round_inputs(data, cfg, f, SEED + 12)
        parts = {"histogram": check_histogram(data, g, h, node8, active, report,
                                              key=f"histogram_{tag}")}
        hist = histogram.histogram(data.bins, node8, g, h, 256, lc.n_bins)
        mask = torch.rand(data.n_features, generator=gen, device=data.bins.device) \
            < lc.feature_fraction
        parts["split_gain"] = {"L=256": split_gain_case(hist, lc.lam, lc.min_child_hess,
                                                        scale_by="terms", mask=mask)}
        parts["level_build"] = check_level_build(data, g, h, gen, report,
                                                 key=f"level_build_{tag}")
        parts["histogram_sparse"] = check_histogram_sparse(sp, node8, active, g, h, report,
                                                           key=f"histogram_sparse_{tag}")
        for name, per in parts.items():
            shapes[name].update({f"{tag} {t}": st for t, st in per.items()})
    bins = run["data"].bins
    forest = seeded_forest(np.random.default_rng(SEED + 13), bins.shape[1], 0.0, bins.device)
    for name, (_, form) in E2006_LINE.items():
        if not name.startswith("forest_traverse"):
            continue
        fo = forest if form == "f32" else forest.quantize(form)
        shapes[name] = {tag: traversal_case(f"{name} {tag}", bins[:rows].contiguous(), fo,
                                            fo.feature.shape[0])
                        for tag, rows in (("full", bins.shape[0]), ("wave", WAVE_ROWS))}
    report["e2006_phase_kernel_shapes"] = shapes
    return shapes


def e2006_line(run: dict, shapes: dict, report: dict) -> list:
    """Once every device time is taken: the phase's kernel checks printed
    (event / device / bound ms), a profiled round of each e2006 run and of
    the Newton run, and the ``kernels`` line's entries of the e2006 path,
    each with its launches on that path (each must have run there)."""
    card = report.get("nvidia_smi", "card not queried")
    deep = max((t for t in shapes["level_build"] if t.startswith("e2006")),
               key=lambda t: int(t.rsplit("level", 1)[1]))
    main = {"histogram": "e2006 level8_subset", "split_gain": "e2006 L=256",
            "level_build": deep, "histogram_sparse": "e2006 level8_subset"}
    drop = ("surface_ms", "staged_ms", "samples_hit", "entries_hit", "plan", "rows", "live",
            "bin_cells_read")
    kstats = {}
    for name, (kernel, _) in E2006_LINE.items():
        per = shapes[name] if kernel == "forest_traverse" else shapes[kernel]
        kstats[name] = line_stats(per, "full" if kernel == "forest_traverse" else main[kernel],
                                  drop=drop)
    for name in ("histogram", "split_gain", "level_build", "histogram_sparse"):
        print(f"{name} at the e2006 phase's shapes, event / device / bound ms: " + "; ".join(
            f"{t} {st['ms']:.4f} / {st['device_ms']:.4f} / {st['bound_ms']:.4f}"
            for t, st in shapes[name].items()) + f" [{card}]", flush=True)
    for name, per in shapes.items():
        if name.startswith("forest_traverse"):
            print(f"{name} bitwise equal to the plain version, 3000 x 400 and the wave (event / "
                  f"device / bound ms): {traversal_times(per)} [{card}]", flush=True)
    info = report["e2006"]
    info["profile"] = {}
    if run["data"].bins.device.type == "cuda":
        for tag, data, cfg in (("staged", run["data"], E2006_CFG),
                               ("fused", run["data"], E2006_CFG_FUSED),
                               ("sparse", run["sparse"], E2006_CFG),
                               ("newton", run["realsim"], NEWTON_CFG)):
            prof = info["profile"][tag] = profile_rounds(data, cfg)
            prof["device_busy_share"] = busy(prof, prof["device_ms_per_round"],
                                             info["median_round_ms"][tag])
            check_no_chain(f"e2006 phase {tag}", prof)
            print(f"profile (e2006 phase {tag}): device {prof['device_ms_per_round']:.4f} ms per round "
                  f"({prof['device_ms_by']}), busy {pct(prof['device_busy_share'])} of a "
                  f"round's wall time; split kernel {prof['split_kernel_calls']:g} launches a "
                  f"round [{card}]", flush=True)
    line = []
    for name, (kernel, count) in E2006_LINE.items():
        launches = run["e2006_counts"][count]
        if launches <= 0:
            raise AssertionError(f"{name}: no launch on the e2006 path")
        _, source, replaces = KERNELS[kernel]
        line.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches, **kstats[name]})
    return line


def drive_threads(dev: torch.device, realsim: dict) -> dict:
    """The threads phase, after the e2006 and step-rules phase, with its own
    launch counts (set to 0 just before, read just after): the host-async
    runtime (``ps.runtime.AsyncRuntime``, W = 4 worker threads, each on a
    CUDA stream of its own) trains efficiency-realsim uncut (all 400
    trees) on ``drive``'s data; the same 400 rounds run in the loop form
    at W = 4 for its wall time; the forest is served for 8 requests. Then the 32-tree runs: faults, halt and resume, sharded
    pulls, the adaptive step, ``train_worker_parallel`` beside the loop,
    and the train CLI
    under ``--runtime threads``. The fused backend under W = 4 runs in a
    child process under a time limit (``THREADS_FUSED_TIMEOUT_S``): a
    cooperative launch that could not queue behind another stream's would
    hang there, not here. Every run comes before any kernel check (see
    ``drive``). Returns what the checks need."""
    data, x = realsim["data"], realsim["x"]
    rng = np.random.default_rng(SEED + 21)
    shutil.rmtree(THREADS_DIR, ignore_errors=True)
    short = THREADS_CFG
    reset_counts()
    t0 = time.perf_counter()
    rt = AsyncRuntime(CFG, data, WORKERS)
    state, trace = rt.run(seed=SEED)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    loop = Trainer(CFG, device=dev).train(data, ("round_robin", WORKERS), seed=SEED)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t1
    served = serve(state.forest, x, data.bin_edges, rng)
    runs = {}
    fault_rt = AsyncRuntime(short, data, WORKERS, faults=FaultPlan(**THREADS_FAULTS))
    runs["faults"] = (fault_rt, *fault_rt.run(seed=SEED))
    ck, prefix_path = THREADS_DIR / "ck", THREADS_DIR / "prefix.json"
    _, prefix = AsyncRuntime(short, data, WORKERS).run(
        seed=SEED, checkpoint_dir=ck, checkpoint_every=THREADS_CKPT_EVERY,
        halt_at_fold=THREADS_HALT, trace_path=prefix_path)
    resume_rt = AsyncRuntime(short, data, THREADS_RESUME_WORKERS)
    runs["resume"] = (resume_rt, *resume_rt.resume(RunTrace.load(prefix_path), ck))
    shard_rt = AsyncRuntime(short, data, WORKERS, shard_pulls=THREADS_SHARDS)
    runs["shards"] = (shard_rt, *shard_rt.run(seed=SEED))
    adaptive_rt = AsyncRuntime(short._replace(adaptive_step=STEP_RHO), data, WORKERS)
    runs["adaptive"] = (adaptive_rt, *adaptive_rt.run(seed=SEED))
    parallel = train_worker_parallel(short, data, WORKERS, seed=SEED)
    parallel_loop = Trainer(short, device=dev).train(data, ("round_robin", WORKERS),
                                                     seed=SEED)
    buf = io.StringIO()
    t2 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli_state, cli_trace = train_cli.main(THREADS_CLI)
    cli = {"s": time.perf_counter() - t2, "out": buf.getvalue().splitlines(),
           "trees": int(cli_state.forest.n_trees), "trace_trees": cli_trace.n_trees}
    torch.cuda.synchronize()
    counts, wall_s = gbdt_counts(), time.perf_counter() - t0
    fused = threads_fused()
    return {"data": data, "rt": rt, "state": state, "trace": trace, "run_s": run_s,
            "loop": loop, "loop_s": loop_s, "served": served, "runs": runs, "prefix": prefix,
            "parallel": parallel, "parallel_loop": parallel_loop, "cli": cli,
            "counts": counts, "fused": fused, "wall_s": wall_s}


def threads_fused() -> dict:
    """The fused backend under W = 4 threads, in a child process
    (``threads_fused_child``) killed after ``THREADS_FUSED_TIMEOUT_S``;
    returns its JSON line. No fallback: a timeout or a failed child fails
    the phase."""
    cmd = [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
           "import chip_smoke; chip_smoke.threads_fused_child()", str(ROOT)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=THREADS_FUSED_TIMEOUT_S, cwd=ROOT)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"fused backend under {WORKERS} threads: no end within "
                             f"{THREADS_FUSED_TIMEOUT_S} s (cooperative launches across "
                             "streams did not queue)") from e
    if proc.returncode:
        raise AssertionError(f"fused backend under {WORKERS} threads failed "
                             f"(exit {proc.returncode}):\n{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["process_s"] = time.perf_counter() - t0
    return out


def threads_fused_child(device: str = "cuda") -> None:
    """The child of ``threads_fused``: efficiency-realsim 32 trees with the
    fused level (``backend="fused"``) under W = 4 threads on the card, its
    launch counts set to 0 just before and read just after; the trace
    replayed fused and staged (the fused level is the staged chain's bits),
    each bitwise the threaded forest. Prints one JSON line."""
    dev = torch.device(device)
    _, data = gbdt_configs.get(REALSIM, device=dev)
    cfg = CFG_FUSED._replace(n_trees=THREADS_SHORT)
    reset_counts()
    t0 = time.perf_counter()
    state, trace = AsyncRuntime(cfg, data, WORKERS).run(seed=SEED)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = gbdt_counts()
    same_forest("fused under threads vs its replay", state, replay_trace(cfg, data, trace)[0])
    staged = cfg._replace(learner=cfg.learner._replace(backend="staged"))
    same_forest("fused under threads vs the staged replay", state,
                replay_trace(staged, data, trace)[0])
    per_tree = len(fused_levels(*data.bins.shape))
    if counts["level_build"] != per_tree * (THREADS_SHORT + 1):  # + the warm-up's tree
        raise AssertionError(f"fused under threads: {counts['level_build']} fused levels, "
                             f"expected {per_tree} a tree")
    print(json.dumps({"run_s": run_s, "summary": trace.summary(),
                      "staleness_histogram": trace.staleness_histogram(),
                      "launches": counts, "fused_levels_per_tree": per_tree}),
          flush=True)


def check_threads(run: dict, report: dict) -> dict:
    """The gates of ``drive_threads``' runs. The 400-tree run: the realized
    k(j) a valid causal schedule and the tickets a permutation (the runtime
    also checks both), its replay bitwise (``feature``, ``threshold``,
    ``leaf_value``, ``f``), the loss falling, the 8 served answers
    link(forest_predict). Each 32-tree run replays bitwise; the faults'
    events and epochs are the plan's; the resumed trace has its seam and
    rebuilds from the checkpoint; every pull's bytes are a host recount
    from its ticket's sample; every step scale is ``staleness_scales``'
    bits; ``train_worker_parallel`` is the loop's forest; the fused child
    passed; the CLI printed both identities. Then the kernels under
    concurrent streams (``check_threads_kernels``). Prints the phase."""
    data, trace, state = run["data"], run["trace"], run["state"]
    card = report.get("nvidia_smi", "card not queried")
    resolve_schedule(trace.schedule, CFG.n_trees)
    if sorted(trace.key_index.tolist()) != list(range(CFG.n_trees)):
        raise AssertionError("threads: the tickets are not a permutation")
    t1 = time.perf_counter()
    replayed, losses = run["rt"].replay(trace)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t1
    same_forest("threads: 400-tree run vs its replay", state, replayed)
    loss0, loss = loss_fell("threads", CFG, data, state)
    if float(losses[-1]) != float(train_loss(CFG, data, state)):
        raise AssertionError("threads: the replay's last loss is not the run's")
    served = check_served("threads forest", *run["served"])
    s = trace.summary()
    concurrency = float(trace.t_build.sum()) / trace.makespan
    short = {}
    for tag, (rt, st, tr) in run["runs"].items():
        same_forest(f"threads {tag}: run vs its replay", st, rt.replay(tr)[0])
        short[tag] = {"summary": tr.summary(), "events": list(tr.events)}
    _, _, ft = run["runs"]["faults"]
    kinds = {e["kind"]: e for e in ft.events}
    (crash,), (leave,) = THREADS_FAULTS["crash_tickets"], THREADS_FAULTS["leave_tickets"]
    ((joiner, join_fold),) = THREADS_FAULTS["join_at"].items()
    if (set(kinds) != {"crash", "leave", "join"} or kinds["crash"]["ticket"] != crash
            or kinds["leave"]["ticket"] != leave or kinds["join"]["worker"] != joiner
            or kinds["join"]["fold"] < join_fold or ft.n_epochs != 4
            or joiner not in set(ft.worker.tolist())):
        raise AssertionError(f"threads faults: events {ft.events}, {ft.n_epochs} epochs")
    rrt, rst, rtr = run["runs"]["resume"]
    if (rtr.n_trees != THREADS_SHORT or rtr.events[-1]["kind"] != "resume"
            or rtr.events[-1]["fold"] != THREADS_HALT
            or not np.array_equal(rtr.key_index[:THREADS_HALT], run["prefix"].key_index)):
        raise AssertionError(f"threads resume: {rtr.events}")
    same_forest("threads resume: live vs checkpoint + suffix", rst,
                rrt.replay_from_checkpoint(THREADS_DIR / "ck", rtr))
    srt, _, stra = run["runs"]["shards"]
    n, parts = data.n_samples, THREADS_SHARDS
    sizes = np.full(parts, n // parts)
    sizes[: n % parts] += 1
    part = np.repeat(np.arange(parts), sizes)
    for j, i in enumerate(stra.key_index.tolist()):
        q_any = ps_engine.round_draws(THREADS_CFG, data, SEED, i)[1].cpu().numpy()
        touched = np.zeros(parts, bool)
        touched[part[q_any]] = True
        if stra.pull_bytes[j] != 4 * sizes[touched].sum() + (parts + 7) // 8:
            raise AssertionError(f"threads shards: fold {j} pulled {stra.pull_bytes[j]} B")
    _, _, atr = run["runs"]["adaptive"]
    want = staleness_scales(atr.schedule, STEP_RHO)
    if not np.array_equal(atr.step_scale.view(np.int32), want.view(np.int32)):
        raise AssertionError("threads adaptive: step scales are not staleness_scales' bits")
    same_forest("train_worker_parallel vs the loop", run["parallel"], run["parallel_loop"])
    cli = run["cli"]
    for line in ("record-and-replay identical forest: True",
                 "checkpoint + trace-suffix replay identical: True"):
        if line not in cli["out"]:
            raise AssertionError(f"threads CLI: {line!r} not printed")
    steps = int(THREADS_CLI[THREADS_CLI.index("--steps") + 1])
    if not cli["trees"] == cli["trace_trees"] == steps:
        raise AssertionError(f"threads CLI: {cli['trees']} trees")
    fused = run["fused"]
    kernels = check_threads_kernels(run, report)
    hist = {int(k): v for k, v in trace.staleness_histogram().items()}
    report["threads"] = {
        "config": {"trees": CFG.n_trees, "workers": WORKERS, "short_trees": THREADS_SHORT},
        "summary": s, "staleness_histogram": hist, "concurrency": concurrency,
        "run_s": run["run_s"], "replay_s": replay_s, "loop_s": run["loop_s"],
        "loss": {"start": loss0, "threads": loss,
                 "loop": float(train_loss(CFG, data, run["loop"]))},
        "serve": served, "short": short, "fused": fused,
        "cli": {"s": cli["s"], "tail": cli["out"][-3:]}, "launches": run["counts"],
        "kernels_concurrent": kernels, "wall_s": run["wall_s"],
    }
    print(f"threads: efficiency-realsim {CFG.n_trees} trees, W = {WORKERS} threads (a stream "
          f"each): makespan {trace.makespan:.3f} s, mean t_build "
          f"{1e3 * s['t_build_mean_s']:.2f} ms, t_queue {1e3 * s['t_queue_mean_s']:.3f} ms, "
          f"t_fold {1e3 * s['t_fold_mean_s']:.3f} ms; concurrency (sum t_build / makespan) "
          f"{concurrency:.3f}; staleness mean {s['mean_staleness']:.3f} max "
          f"{s['max_staleness']}, histogram {hist}; loop form {CFG.n_trees} rounds at W = "
          f"{WORKERS} {run['loop_s']:.3f} s (makespan / loop "
          f"{trace.makespan / run['loop_s']:.3f}); replay {replay_s:.3f} s [{card}]",
          flush=True)
    print(f"threads: replay bitwise (feature, threshold, leaf_value, f); loss {loss0:.6f} -> "
          f"{loss:.6f} (loop form {report['threads']['loss']['loop']:.6f}); served "
          f"{served['requests']} requests, p50 {served['latency_p50_ms']:.3f} ms", flush=True)
    print(f"threads, {THREADS_SHORT} trees: faults "
          + ", ".join(f"{e['kind']} w{e['worker']}@fold{e['fold']}" for e in ft.events)
          + f" ({ft.n_epochs} epochs); halt at {THREADS_HALT} + resume on "
          f"{THREADS_RESUME_WORKERS} workers, checkpoint replay bitwise; shards P={parts} "
          f"pull reduction {short['shards']['summary']['pull_reduction']:.4f} (bytes "
          f"recounted); adaptive rho {STEP_RHO} scales bitwise; worker_parallel bitwise the "
          f"loop; each run's replay bitwise", flush=True)
    print(f"threads, fused backend under W = {WORKERS} (child process, limit "
          f"{THREADS_FUSED_TIMEOUT_S} s): {THREADS_SHORT} trees in {fused['run_s']:.3f} s, "
          f"{fused['launches']['level_build']} cooperative launches, bitwise its fused and "
          f"staged replays; process {fused['process_s']:.1f} s [{card}]", flush=True)
    print(f"threads CLI exits clean in {cli['s']:.1f} s: " + "; ".join(cli["out"][-2:]),
          flush=True)
    print(f"threads launches: {json.dumps(run['counts'])}; phase wall {run['wall_s']:.1f} s",
          flush=True)
    return kernels


def concurrent_launches(tag: str, fn, inputs: list, reps: int) -> list:
    """``fn(*inputs[s])`` launched ``reps`` times from one thread a stream,
    ``len(inputs)`` streams at once, every result bitwise the one launch of
    the same inputs on this thread's stream; returns the single-stream
    results. Its launches are counted apart: the count must rise by exactly
    the launches made."""
    want = [fn(*args) for args in inputs]
    torch.cuda.synchronize()
    bad: list = []
    errors: list = []

    def body(s):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                for _ in range(reps):
                    got = fn(*inputs[s])
                    got = got if isinstance(got, tuple) else (got,)
                    ref_ = want[s] if isinstance(want[s], tuple) else (want[s],)
                    if not all(torch.equal(a, b) for a, b in zip(got, ref_)):
                        bad.append(s)
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=body, args=(s,)) for s in range(len(inputs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if any(t.is_alive() for t in threads) or errors:
        raise AssertionError(f"{tag}: concurrent launches did not finish") from (
            errors[0] if errors else None)
    if bad:
        raise AssertionError(f"{tag}: streams {sorted(set(bad))} differ from one stream")
    return want


def check_threads_kernels(run: dict, report: dict) -> dict:
    """The phase's kernels under concurrent streams at its shapes, each
    stream on its own inputs: ``THREADS_STREAMS`` streams each launch
    ``split_gain_decide`` ``THREADS_SPLIT_REPS`` times at L = 256 (realsim's
    level 8), the staged histogram (the level-8 subset), the fused level
    (level 0) and the traversal (4000 rows, the trained 400 trees, 400, 300,
    200 and 100 live)
    ``THREADS_REPS`` times; every result bitwise the single-stream one, each
    count up by exactly the launches made, and the single-stream results
    against the plain versions (histograms 1e-5 x max|cell| of the plain
    version's f64 sums, as ``histogram_case``; the decision bitwise the
    plain chain's on the kernel's surface, the traversal
    bitwise). Returns each kernel's largest error."""
    data, dev = run["data"], run["data"].bins.device
    lc = CFG.learner
    cases = [round_inputs(data, CFG, run["state"].f, SEED + 30 + s)
             for s in range(THREADS_STREAMS)]
    out = {}
    # The split decision, the satellite gate: L = 256, 200 launches a stream.
    inputs = []
    for g, h, node8, _, gen in cases:
        hist = histogram.histogram(data.bins, node8, g, h, 256, lc.n_bins)
        mask = (torch.rand(data.n_features, generator=gen, device=dev)
                < lc.feature_fraction).to(torch.int32)
        inputs.append((hist, lc.lam, lc.min_child_hess, mask))
    before = split_scan.launches
    want = concurrent_launches("split_gain_decide", split_scan.split_gain_decide, inputs,
                               THREADS_SPLIT_REPS)
    made = THREADS_STREAMS * (THREADS_SPLIT_REPS + 1)
    if split_scan.launches - before != made:
        raise AssertionError(f"split_gain_decide: {split_scan.launches - before} launches "
                             f"counted, {made} made")
    err = 0.0
    for (hist, lam, mch, mask), (gain, best, idx) in zip(inputs, want):
        scale = float(hist.abs().max())
        err = max(err, close("split_gain_decide threads", gain,
                             split_scan.split_gain_plain(hist, lam, mch), 1e-5, 1e-5 * scale))
        flat = gain.masked_fill((mask == 0)[None, :, None], float("-inf")).reshape(256, -1)
        chain = torch.argmax(flat, dim=-1)
        if not (torch.equal(idx, chain) and torch.equal(best, flat.gather(1, chain[:, None])[:, 0])):
            raise AssertionError("split_gain_decide threads: not the plain chain's decision")
    out["split_gain"] = {"max_abs_err": err, "streams": THREADS_STREAMS,
                         "reps": THREADS_SPLIT_REPS}
    del inputs, want
    # The staged histogram at the level-8 subset.
    inputs = [(data.bins, node8, g, h, 256, lc.n_bins, active)
              for g, h, node8, active, _ in cases]
    before = histogram.launches
    want = concurrent_launches("histogram", histogram.histogram, inputs, THREADS_REPS)
    if histogram.launches - before != THREADS_STREAMS * (THREADS_REPS + 1):
        raise AssertionError("histogram: launches miscounted under streams")
    err = 0.0
    for (bins, node, g, h, *rest), got in zip(inputs, want):
        plain = histogram.histogram_plain(bins, node, g.double(), h.double(), *rest)
        err = max(err, close("histogram threads", got.double(), plain, 1e-5,
                             1e-5 * float(plain.abs().max())))
    out["histogram"] = {"max_abs_err": err, "streams": THREADS_STREAMS, "reps": THREADS_REPS}
    del inputs, want
    # The fused level at level 0.
    inputs = []
    for g, h, _, _, gen in cases:
        node0 = torch.where(h > 0, 0, -1).to(torch.int32)
        mask = (torch.rand(data.n_features, generator=gen, device=dev)
                < lc.feature_fraction).to(torch.int32)
        inputs.append((data.bins, node0, g, h, torch.zeros(1, dtype=torch.int32, device=dev),
                       None, mask, lc.lam, lc.min_child_hess, 1, lc.n_bins))
    before = level_build.launches
    want = concurrent_launches("level_build", level_build.level_build, inputs, THREADS_REPS)
    if level_build.launches - before != THREADS_STREAMS * (THREADS_REPS + 1):
        raise AssertionError("level_build: launches miscounted under streams")
    err = 0.0
    for (bins, node, g, h, *rest), got in zip(inputs, want):
        plain = level_build.level_build_plain(bins, node, g.double(), h.double(), *rest)
        err = max(err, close("level_build threads", got[0].double(), plain[0], 1e-5,
                             1e-5 * float(plain[0].abs().max())))
    out["level_build"] = {"max_abs_err": err, "streams": THREADS_STREAMS, "reps": THREADS_REPS}
    del inputs, want
    # The traversal of the trained forest.
    fo = run["state"].forest
    slots = fo.feature.shape[0]
    inputs = [(data.bins, fo.feature, fo.threshold, fo.leaf_value,
               torch.tensor(slots * (THREADS_STREAMS - s) // THREADS_STREAMS,
                            dtype=torch.int32, device=dev), fo.depth)
              for s in range(THREADS_STREAMS)]
    before = forest_traversal.form_launches["f32"]
    want = concurrent_launches("forest_traverse", forest_traversal.forest_traverse, inputs,
                               THREADS_REPS)
    if forest_traversal.form_launches["f32"] - before != THREADS_STREAMS * (THREADS_REPS + 1):
        raise AssertionError("forest_traverse: launches miscounted under streams")
    for args, got in zip(inputs, want):
        if not torch.equal(got, forest_traversal.forest_traverse_plain(*args)):
            raise AssertionError("forest_traverse threads: differs from the plain version")
    out["forest_traverse"] = {"max_abs_err": 0.0, "streams": THREADS_STREAMS,
                              "reps": THREADS_REPS}
    print(f"threads kernels on {THREADS_STREAMS} streams at once, each on its own inputs, "
          f"bitwise one stream's with exact launch counts: split_gain_decide x "
          f"{THREADS_SPLIT_REPS} at L = 256, histogram (level-8 subset), level_build (level "
          f"0), forest_traverse (4000 x 400) x {THREADS_REPS}; max abs error against the "
          f"plain versions " + json.dumps({k: v["max_abs_err"] for k, v in out.items()}),
          flush=True)
    return out


def threads_line(run: dict, checked: dict, report: dict) -> list:
    """The ``kernels`` line's ``*_threads`` entries, once every device time is
    taken: each kernel's launches in the threads phase (the fused level's
    in its child process), its largest error under concurrent streams and
    at realsim's shapes, and its times at those shapes (``check_kernels``;
    the fused level's at level 0)."""
    line = []
    for name, kernel in THREADS_LINE.items():
        counts = run["fused"]["launches"] if kernel == "level_build" else run["counts"]
        launches = counts[kernel]
        if launches <= 0:
            raise AssertionError(f"{name}: no launch in the threads phase")
        if kernel == "level_build":
            st = line_stats(report["level_build_shapes"], "level0",
                            drop=("staged_ms", "samples_hit"))
        else:
            st = dict(report["kernels"][kernel])
        st["max_abs_err"] = max(st["max_abs_err"], checked[kernel]["max_abs_err"])
        _, source, replaces = KERNELS[kernel]
        line.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches, **st})
    return line


# ------------------------------------------------------------- mesh phase
def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_all_reduce(into: list, dev: torch.device):
    """A stand-in for ``torch.distributed.all_reduce`` that adds each call's
    host time, between two device synchronizations, to ``into`` (the
    collective's ms, waits for the other ranks included)."""
    orig = torch.distributed.all_reduce

    def timed(tensor, *args, **kwargs):
        _sync(dev)
        t0 = time.perf_counter()
        out = orig(tensor, *args, **kwargs)
        _sync(dev)
        into.append(1e3 * (time.perf_counter() - t0))
        return out

    return orig, timed


def mesh_train(data, mesh, feature_axis, rounds: int = ROUNDS, count: bool = True,
               cfg=CFG) -> dict:
    """One form of the mesh phase on this rank: ``rounds`` rounds of ``cfg``
    (efficiency-realsim's) at W = ``WORKERS`` through ``Trainer(mesh=)``, with
    every collective recorded (``collectives.ByteRecorder``) and timed
    (``_timed_all_reduce``) and the host time stamped after each round;
    with ``count``, the collective bytes of one build counted apart
    (``Trainer.collective_bytes``); each kernel's launches."""
    trainer = Trainer(cfg, mesh=mesh, feature_axis=feature_axis)
    rec, coll_ms, stamps, coll_marks = collectives.ByteRecorder(), [], [], [0.0]
    before = gbdt_counts()

    def tick(state, j):
        _sync(mesh.device)
        stamps.append(time.perf_counter())
        coll_marks.append(sum(coll_ms))

    orig, timed = _timed_all_reduce(coll_ms, mesh.device)
    torch.distributed.all_reduce = timed
    try:
        with collectives.recording(rec):
            _sync(mesh.device)
            stamps.append(time.perf_counter())
            state = trainer.train(data, ("round_robin", WORKERS), seed=SEED, rounds=rounds,
                                  eval_every=1, eval_fn=tick)
    finally:
        torch.distributed.all_reduce = orig
    after = gbdt_counts()
    round_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    return {
        "forest": [t.cpu() for t in state.forest], "f": state.f.cpu(),
        "loss": float(train_loss(cfg, data, state)),
        "round_ms": round_ms, "rounds": rounds,
        "collective_ms": [b - a for a, b in zip(coll_marks, coll_marks[1:])],
        "bytes": rec.summary(), "counted": trainer.collective_bytes(data) if count else None,
        "launches": {k: after[k] - before[k] for k in ("histogram", "split_gain",
                                                       "histogram_sparse", "level_build")},
        "trainer": trainer,
    }


def decisive_data(n: int, f: int, dev: torch.device) -> BinnedData:
    """A set of realsim's shape (``n`` x ``f``, 64 bins) on which every split
    is decisive: column k < ``DECISIVE_BITS`` is bit k of the sample's
    index, in bins 0 and 1; every other column is constant (bin 0, as most
    of realsim's columns are for most samples); the label is
    sum_k 4 ``DECISIVE_DECAY``^k bit_k (no noise). A column in bins 0 and 1
    has one threshold that splits a node, so no two thresholds share a
    partition (on quantile bins with empty bins between the values, every
    threshold in a gap splits the samples alike: an exact tie, which the
    card's scan breaks by rounding). The bits are a full factorial, so on
    a node, a box of the bit grid, no two free bits cut the samples alike;
    and their weights differ, so their gains differ far above f32
    rounding. Deterministic: every rank makes the same set."""
    bins = np.zeros((n, f), np.int32)
    bins[:, :DECISIVE_BITS] = (np.arange(n)[:, None] >> np.arange(DECISIVE_BITS)) & 1
    y = bins[:, :DECISIVE_BITS] @ (4.0 * DECISIVE_DECAY ** np.arange(DECISIVE_BITS))
    edges = np.full((f, CFG.learner.n_bins - 1), np.inf, np.float32)
    edges[:DECISIVE_BITS, 0] = 0.5  # a raw 0 or 1 bins as itself
    return BinnedData(torch.from_numpy(bins).to(dev), torch.from_numpy(edges).to(dev),
                      torch.from_numpy(y.astype(np.float32)).to(dev),
                      torch.ones(n, device=dev), CFG.learner.n_bins)


def mesh_device_ms(trainer, data) -> tuple[float | None, str]:
    """The device time of one more round of ``trainer`` on this rank: the
    profiler's sum of its kernels where it records device time, else None
    (a CUDA-event span would hold the waits on the other ranks)."""
    if data.bins.device.type != "cuda" or not profiler_sees_device():
        return None, "not measured"
    rows = device_trace(lambda: trainer.train(data, ("round_robin", WORKERS), seed=SEED,
                                              rounds=1), 1)
    return (sum(ms for _, ms, _ in rows), "profiler") if rows else (None, "not measured")


def count_plain_calls() -> None:
    """For a rehearsal on the CPU, where no kernel launches: count each call
    of the mesh phase's kernels' plain versions as a launch."""
    for mod, name in ((histogram, "histogram_plain"), (split_scan, "split_gain_decide_plain"),
                      (histogram_sparse, "histogram_sparse_plain")):
        def counted(*args, _mod=mod, _fn=getattr(mod, name), **kwargs):
            _mod.launches += 1
            return _fn(*args, **kwargs)
        setattr(mod, name, counted)


def mesh_rank(rank: int, dev: torch.device, out_dir: str, spec, rounds: int,
              backend: str) -> None:
    """One of the ``MESH_RANKS`` rank processes of the mesh phase: the data
    of ``spec`` (realsim's ``DatasetSpec``), its sparse layout and the
    decisive set of its shape on ``dev``, the meshes (1-D x4, (1, 4),
    (2, 2)) over ``backend``, and
    ``MESH_FORMS`` trained in turn (``mesh_train``); then one profiled round
    a form (``mesh_device_ms``), after every timed round. Writes the
    results to ``out_dir/rank{rank}.pt``."""
    from repro_torch.launch.mesh import make_gbdt_mesh

    if dev.type == "cpu":  # a rehearsal: each plain call counts as a launch
        count_plain_calls()
    # The ranks share the host's cores: no rank's thread pool takes them all.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // MESH_RANKS))
    x, y, mult = synthetic.raw(spec)
    data = bin_dataset(x, y, n_bins=64, multiplicity=mult, device=dev)
    sets = {"dense": data,
            "sparse": bin_dataset(x, y, n_bins=64, multiplicity=mult, device=dev, sparse=True),
            "decisive": decisive_data(*data.bins.shape, dev)}
    meshes = {"x4": make_gbdt_mesh(4, 1, device=dev, backend=backend, feature_axis=False),
              "1x4": make_gbdt_mesh(1, 4, device=dev, backend=backend),
              "2x2": make_gbdt_mesh(2, 2, device=dev, backend=backend)}
    reset_counts()
    out = {}
    for tag, (mesh, fax, kind) in MESH_FORMS.items():
        # The count depends on shapes alone: rank 0's serves every rank.
        out[tag] = mesh_train(sets[kind], meshes[mesh], fax, rounds, count=rank == 0,
                              cfg=DECISIVE_CFG if kind == "decisive" else CFG)
    for tag, (_, _, kind) in MESH_FORMS.items():
        trainer = out[tag].pop("trainer")
        out[tag]["device_ms"], out[tag]["device_ms_by"] = mesh_device_ms(trainer, sets[kind])
    out["backend"] = meshes["x4"].backend
    out["coords"] = {k: [a.index for a in m.axes] for k, m in meshes.items()}
    torch.save(out, pathlib.Path(out_dir) / f"rank{rank}.pt")


def drive_mesh(dev: torch.device, realsim: dict, spec=None, rounds: int = ROUNDS,
               clis: dict | None = None, one_rank_backend: str = "nccl") -> dict:
    """The mesh phase, with its own launch counts: (a) the (1, 1) mesh, one
    rank over NCCL in this process (its counts reset just before and read
    just after), whose collectives span one rank and issue no all-reduce,
    so one all-reduce is issued on its group apart, to check NCCL; the
    unmeshed run of the decisive set (``decisive_data``), to hold the 1-D
    x4 decisive form to; (b)-(d) ``MESH_RANKS`` rank processes sharing the card
    over ``MESH_BACKEND`` (``mesh_rank``; each counts its own launches from
    its start); (e) the mesh train CLIs (``MESH_CLIS`` unless given), each
    starting its own ranks. ``spec`` is the data's ``DatasetSpec``
    (realsim's unless given; ``realsim["data"]`` must be its binning). The
    CLIs run at once; each one's seconds run from their common start.
    Returns what ``check_mesh`` needs."""
    from repro_torch.launch import mesh as launch_mesh

    spec = gbdt_configs.EXPERIMENTS[REALSIM].dataset if spec is None else spec
    clis = MESH_CLIS if clis is None else clis
    data = realsim["data"]
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    launch_mesh.init_ranks(0, 1, f"tcp://127.0.0.1:{launch_mesh.free_port()}",
                           one_rank_backend, dev)
    try:
        host = launch_mesh.make_gbdt_mesh(1, 1, device=dev, backend=one_rank_backend)
        reset_counts()
        nccl = mesh_train(data, host, "feature", rounds)
        nccl["counts"] = gbdt_counts()
        nccl["backend"] = host.backend
        del nccl["trainer"]
        probe = torch.arange(8, dtype=torch.float32, device=dev)
        torch.distributed.all_reduce(probe, group=host.axis("data").group)
        if not torch.equal(probe.cpu(), torch.arange(8, dtype=torch.float32)):
            raise AssertionError(f"mesh (1, 1): {one_rank_backend} all_reduce gave {probe}")
        nccl["all_reduce_checked"] = True
    finally:
        torch.distributed.destroy_process_group()
    dec = decisive_data(*data.bins.shape, dev)
    dec_state = Trainer(DECISIVE_CFG, device=dev).train(dec, ("round_robin", WORKERS),
                                                        seed=SEED, rounds=rounds)
    decisive = {"forest": [t.cpu() for t in dec_state.forest], "f": dec_state.f.cpu()}
    t0 = time.perf_counter()
    launch_mesh.spawn(mesh_rank, MESH_RANKS, (str(MESH_DIR), spec, rounds, MESH_BACKEND),
                      backend=MESH_BACKEND, device=dev)
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(MESH_DIR / f"rank{r}.pt", weights_only=False)
             for r in range(MESH_RANKS)]
    # The CLIs run side by side: each spends most of its time starting its
    # ranks, and they share the card as the rank processes above do.
    t0, cli_out = time.perf_counter(), {}
    procs = {tag: subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *argv],
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                   cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
             for tag, argv in clis.items()}
    for tag, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"mesh CLI ({tag}) exited {proc.returncode}:\n{err[-3000:]}")
        cli_out[tag] = {"s": time.perf_counter() - t0, "out": out}
    return {"nccl": nccl, "decisive": decisive, "ranks": ranks, "ranks_s": ranks_s,
            "clis": cli_out}


def first_tree_departures(tag: str, data, got, want) -> dict:
    """The nodes where ``got``'s first tree (a (forest, f) pair) splits
    otherwise than ``want``'s (a state), below agreeing ancestors, over all
    of the tree's levels. Both trees are built from round 0's draws on the
    same F, so each such node holds the same samples in both, and each
    departure must be a tie: under the node's histogram summed in f64 the
    two splits' gains agree within 1e-5 of the larger (a pass-through node
    counts 0). Returns the counts; raises on a departure that is no tie."""
    dev, b, lc = data.bins.device, CFG.learner.n_bins, CFG.learner
    m, _, mask = ps_engine.round_draws(CFG, data, SEED, 0)
    g0, _ = CFG.obj.grad_hess(data.labels, init_state(CFG, data).f)
    fw, tw = want.forest.feature[0], want.forest.threshold[0]
    fg, tg = got[0][0][0].to(dev), got[0][1][0].to(dev)
    heap = torch.zeros(data.n_samples, dtype=torch.int64, device=dev)
    agree, compared, ties, gaps = {0}, 0, 0, []
    for i in range((1 << lc.depth) - 1):
        if i > 0 and (i & (i + 1)) == 0:  # a new level: route every sample one step down
            right = gather_feature_bins(data.bins, fw.long()[heap]) > tw[heap]
            heap = 2 * heap + 1 + right.long()
        if i not in agree:
            continue
        compared += 1
        if (fw[i], tw[i]) == (fg[i], tg[i]):
            agree |= {2 * i + 1, 2 * i + 2}
            continue
        on = torch.where(heap == i, 0, -1).to(torch.int32)
        hist = histogram.histogram_plain(data.bins, on, (m * g0).double(), m.double(), 1, b)
        gain = split_scan.split_gain_plain(hist, lc.lam, lc.min_child_hess)
        gain = gain.masked_fill(~mask[None, :, None], float("-inf")).reshape(-1)

        def split_gain(f, t):
            passes = int(f) == 0 and int(t) == b - 1
            return 0.0 if passes else max(float(gain[f * b + t]), 0.0)
        gw, gg = split_gain(fw[i], tw[i]), split_gain(fg[i], tg[i])
        gaps.append(abs(gw - gg) / max(gw, gg, 1e-30))
        if abs(gw - gg) > 1e-5 * max(gw, gg):
            raise AssertionError(f"{tag}: first tree's node {i} splits otherwise without a "
                                 f"tie (f64 gains {gw} vs {gg})")
        ties += 1
    return {"nodes_compared": compared, "ties": ties,
            "largest_relative_gap": max(gaps, default=0.0)}


def forest_agreement(got, want) -> dict:
    """Figures, not gates: the share of live nodes two forests split alike,
    whether every tree's heap prefix (levels 0-3) agrees, and F's RMS drift
    over the reference's RMS."""
    live = int(want.forest.n_trees)
    same = ((got[0][0][:live] == want.forest.feature[:live].cpu())
            & (got[0][1][:live] == want.forest.threshold[:live].cpu()))
    f_got, f_want = got[1], want.f.cpu()
    return {"nodes_identical": float(same.float().mean()),
            "prefix_bitwise": bool(same[:, :15].all()),
            "f_rms_drift": float(torch.sqrt(((f_got - f_want) ** 2).mean())
                                 / torch.sqrt((f_want ** 2).mean()))}


def decisive_agreement(got: tuple, want: tuple) -> dict:
    """The 1-D x4 forest on the decisive set (a (forest, f) pair) against the
    unmeshed one: the same trees, every feature and threshold equal, the
    leaves within ``DECISIVE_LEAF_ATOL``, and every level of the forest
    split somewhere (so the deep levels are held too). Returns the
    figures; raises on a departure."""
    tag = "mesh 1d x4 decisive vs the unmeshed run"
    for name, i in (("feature", 0), ("threshold", 1), ("n_trees", 3)):
        if not torch.equal(got[0][i], want[0][i]):
            raise AssertionError(f"{tag}: {name} differs")
    leaf_err = float((got[0][2] - want[0][2]).abs().max())
    if not leaf_err <= DECISIVE_LEAF_ATOL:
        raise AssertionError(f"{tag}: leaves {leaf_err} apart (tolerance {DECISIVE_LEAF_ATOL})")
    live, b = int(want[0][3]), CFG.learner.n_bins
    split = ((want[0][0][:live] != 0) | (want[0][1][:live] != b - 1)).cpu()
    by_level = [int(split[:, (1 << lv) - 1:(1 << (lv + 1)) - 1].sum())
                for lv in range(CFG.learner.depth)]
    if min(by_level) == 0:
        raise AssertionError(f"{tag}: a level never splits (splits by level {by_level})")
    return {"trees": live, "splits_by_level": by_level, "leaf_max_abs_diff": leaf_err,
            "f_max_abs_diff": float((got[1] - want[1]).abs().max())}


def _same_state(tag: str, a: tuple, b: tuple) -> None:
    for x, y, name in zip((*a[0], a[1]), (*b[0], b[1]),
                          ("feature", "threshold", "leaf_value", "n_trees", "base_score", "f")):
        if not torch.equal(x, y):
            raise AssertionError(f"{tag}: {name} differs")


def check_mesh(run: dict, realsim: dict, report: dict) -> dict:
    """The mesh phase's gates: (a) bitwise the unmeshed staged forest with
    no realized byte, and one NCCL all-reduce right; every form's forest
    the same on every rank; the 1-D x4 run twice bitwise, its loss
    falling, and every split where its first tree departs from the
    unmeshed run's a tie (``first_tree_departures``; after one the forests
    part ways, so the later trees are compared by figures alone,
    ``forest_agreement``); on the decisive set, the 1-D x4 forest split for
    split the unmeshed one, leaves within 1e-5 (``decisive_agreement``); (1, 4)
    dense and sparse bitwise the unmeshed staged and sparse forests; (2, 2)
    bitwise its P_d = 2 1-D twin; each form's measured bytes a round equal
    to ``collective_bytes``'s count of one build, by kind; each kernel of
    the form launched on every rank; the CLIs' rank agreement and bytes.
    Prints each form's round wall ms, device and collective ms and bytes
    a round by rank. Returns the launches by kernel, summed over the ranks
    (and the NCCL rank)."""
    staged, sparse = realsim["runs"]["staged"], realsim["runs"]["sparse"]
    unmeshed = ([t.cpu() for t in staged.forest], staged.f.cpu())
    nccl, ranks = run["nccl"], run["ranks"]
    _same_state("mesh (1, 1) nccl vs the unmeshed staged run",
                (nccl["forest"], nccl["f"]), unmeshed)
    if nccl["bytes"]["realized_bytes"] or nccl["counted"]["realized_bytes"]:
        raise AssertionError(f"mesh (1, 1): realized bytes {nccl['bytes']}")
    if not nccl.get("all_reduce_checked"):
        raise AssertionError("mesh (1, 1): the NCCL all_reduce was not checked")
    summary = {"nccl_1x1": {"backend": nccl["backend"], "round_ms": nccl["round_ms"],
                            "collective_ms": nccl["collective_ms"],
                            "payload_bytes_per_round":
                                nccl["bytes"]["payload_bytes"] / nccl["rounds"],
                            "launches": nccl["launches"]}}
    print(f"mesh (1, 1) over {nccl['backend']}, one rank: bitwise the unmeshed staged "
          f"forest, 0 B realized; round wall ms {np.mean(nccl['round_ms'][1:]):.2f} (round 0 "
          f"{nccl['round_ms'][0]:.2f}), collective ms a round "
          f"{np.mean(nccl['collective_ms'][1:]):.2f} (round 0 {nccl['collective_ms'][0]:.2f})",
          flush=True)
    for tag in MESH_FORMS:
        for r, rk in enumerate(ranks[1:], 1):
            _same_state(f"mesh {tag}: rank {r} vs rank 0", (rk[tag]["forest"], rk[tag]["f"]),
                        (ranks[0][tag]["forest"], ranks[0][tag]["f"]))
    first = ranks[0]
    _same_state("mesh 1d x4: two runs", (first["1d_x4"]["forest"], first["1d_x4"]["f"]),
                (first["1d_x4_again"]["forest"], first["1d_x4_again"]["f"]))
    got = (first["1d_x4"]["forest"], first["1d_x4"]["f"])
    summary["1d_x4_vs_unmeshed"] = {
        **first_tree_departures("mesh 1d x4 vs the unmeshed staged run", realsim["data"],
                                got, staged),
        **forest_agreement(got, staged)}
    print("mesh 1d x4 vs the unmeshed staged run: the first tree's departures all ties "
          + json.dumps(summary["1d_x4_vs_unmeshed"]), flush=True)
    loss0 = float(train_loss(CFG, realsim["data"], init_state(CFG, realsim["data"])))
    if not first["1d_x4"]["loss"] < loss0:
        raise AssertionError(f"mesh 1d x4: loss {first['1d_x4']['loss']} from {loss0}")
    summary["1d_x4_decisive_vs_unmeshed"] = decisive_agreement(
        (first["1d_x4_decisive"]["forest"], first["1d_x4_decisive"]["f"]),
        (run["decisive"]["forest"], run["decisive"]["f"]))
    print("mesh 1d x4 on the decisive set: every tree splits as the unmeshed run's, leaves "
          "within 1e-5 " + json.dumps(summary["1d_x4_decisive_vs_unmeshed"]), flush=True)
    _same_state("mesh (1, 4) dense vs the unmeshed staged run",
                (first["2d_1x4"]["forest"], first["2d_1x4"]["f"]), unmeshed)
    _same_state("mesh (1, 4) sparse vs the unmeshed sparse run",
                (first["2d_1x4_sparse"]["forest"], first["2d_1x4_sparse"]["f"]),
                ([t.cpu() for t in sparse.forest], sparse.f.cpu()))
    _same_state("mesh (2, 2) vs its P_d = 2 1-D twin",
                (first["2d_2x2"]["forest"], first["2d_2x2"]["f"]),
                (first["1d_x2_on_2x2"]["forest"], first["1d_x2_on_2x2"]["f"]))
    launches = {k: nccl["launches"][k] for k in MESH_LINE.values()}
    by_rank = {}
    for tag, (_, _, kind) in MESH_FORMS.items():
        row = {"backend": first["backend"], "round_ms_by_rank": [], "device_ms_by_rank": [],
               "collective_ms_by_rank": []}
        for r, rk in enumerate(ranks):
            form = rk[tag]
            measured, counted = form["bytes"], first[tag]["counted"]
            rounds = form["rounds"]
            per_round = {k: v / rounds for k, v in measured["realized_by_kind"].items()}
            if (measured["realized_bytes"] != rounds * counted["realized_bytes"]
                    or per_round != counted["realized_by_kind"]):
                raise AssertionError(f"mesh {tag} rank {r}: measured bytes {measured} are not "
                                     f"{rounds} x the count {counted}")
            need = ("histogram_sparse", "split_gain") if kind == "sparse" else (
                "histogram", "split_gain")
            if any(form["launches"][k] <= 0 for k in need) or form["launches"]["level_build"]:
                raise AssertionError(f"mesh {tag} rank {r}: launches {form['launches']}")
            row["round_ms_by_rank"].append(float(np.mean(form["round_ms"][1:])))
            row["device_ms_by_rank"].append(form["device_ms"])
            row["collective_ms_by_rank"].append(float(np.mean(form["collective_ms"][1:])))
        row["bytes_per_round"] = first[tag]["counted"]["realized_by_kind"]
        row["realized_bytes_per_round"] = first[tag]["counted"]["realized_bytes"]
        row["device_ms_by"] = first[tag]["device_ms_by"]
        row["launches_by_rank"] = [rk[tag]["launches"] for rk in ranks]
        summary[tag] = row
        dev_ms = ", ".join("not measured" if d is None else f"{d:.2f}"
                           for d in row["device_ms_by_rank"])
        print(f"mesh {tag} over {first['backend']} x{MESH_RANKS} ranks: round wall ms (mean "
              f"of rounds 2-{first[tag]['rounds']}) by rank {', '.join(f'{v:.2f}' for v in row['round_ms_by_rank'])}; device ms "
              f"a round by rank ({row['device_ms_by']}, one more round) {dev_ms}; collective "
              f"ms a round (rounds 2-{first[tag]['rounds']}) by rank {', '.join(f'{v:.2f}' for v in row['collective_ms_by_rank'])}; "
              f"bytes a round {row['realized_bytes_per_round']:,} realized "
              f"{json.dumps(row['bytes_per_round'])} (= collective_bytes)", flush=True)
    for k in MESH_LINE.values():
        by_rank[k] = [sum(rk[tag]["launches"][k] for tag in MESH_FORMS) for rk in ranks]
        launches[k] += sum(by_rank[k])
    if not run["clis"]:
        raise AssertionError("mesh phase: no mesh CLI ran")
    for tag, cli in run["clis"].items():
        out = cli["out"]
        if "every rank's forest identical: True" not in out or \
                "collective bytes/round:" not in out or "mesh: " not in out:
            raise AssertionError(f"mesh CLI ({tag}): {out[-2000:]}")
        summary[f"cli {tag}"] = {"s": cli["s"], "lines": [ln for ln in out.splitlines()
                                                          if ln.startswith(("mesh:",
                                                                            "collective",
                                                                            "final",
                                                                            "every"))]}
        print(f"mesh CLI {tag}: exit 0 in {cli['s']:.1f} s; " +
              "; ".join(summary[f"cli {tag}"]["lines"]), flush=True)
    summary["ranks_s"] = run["ranks_s"]
    summary["launches_by_rank"] = by_rank
    report["mesh"] = summary
    print(f"mesh phase: {MESH_RANKS} rank processes in {run['ranks_s']:.1f} s; launches by "
          f"rank {json.dumps(by_rank)}, the (1, 1) rank "
          f"{json.dumps({k: nccl['launches'][k] for k in MESH_LINE.values()})}", flush=True)
    return {"launches": launches, "by_rank": by_rank}


def check_mesh_kernels(realsim: dict, report: dict) -> dict:
    """The mesh phase's kernels at its shards' shapes: the histogram with the
    global F's launch plan (``plan_features``, as the (1, 4) build launches
    it) at F_loc = F / 4 = 375 (rank 0's and rank 3's blocks), level 0 and
    the level-8 subset, bitwise the same columns of the unsharded
    histogram; the histogram at level 0 and the level-8 subset on rank 0's
    block of every form, (1, 4), 1-D x4, (2, 2) and its P_d = 2 twin,
    against its plain version (``histogram_case``); the split gain's
    decision at L = 256 on the (1, 4) and (2, 2) blocks' histograms under
    the block's mask (``split_gain_case``); the sparse
    histogram on the shard's feature-major store
    (``check_histogram_sparse``). Records whether the shard's own plan
    would sum in another order. Device times pending. Returns the stats
    by kernel."""
    data, sp = realsim["data"], realsim["sparse"].bins
    n, f = data.bins.shape
    f_loc, b = f // MESH_RANKS, CFG.learner.n_bins
    g, h, node8, active, gen = kernel_inputs(data)
    node0 = torch.zeros(n, dtype=torch.int32, device=data.bins.device)
    order = {}
    for shard in (0, MESH_RANKS - 1):
        cols = slice(shard * f_loc, (shard + 1) * f_loc)
        block = data.bins[:, cols].contiguous()
        for tag, node, n_nodes, act in (("level0", node0, 1, None),
                                        ("level8_subset", node8, 256, active)):
            full = histogram.histogram(data.bins, node, g, h, n_nodes, b, act)
            mine = histogram.histogram(block, node, g, h, n_nodes, b, act, plan_features=f)
            own = histogram.histogram(block, node, g, h, n_nodes, b, act)
            if not torch.equal(mine, full[:, :, cols]):
                raise AssertionError(f"histogram_mesh shard {shard} {tag}: the global plan's "
                                     "sums differ from the unsharded histogram's columns")
            order[f"shard{shard}_{tag}"] = {
                "own_plan_same_bits": bool(torch.equal(own, mine)),
                "own_plan": histogram.launch_plan(block, n_nodes, b, act)._asdict(),
                "global_plan": histogram.launch_plan(block, n_nodes, b, act, f)._asdict()}
    report["histogram_mesh_plan_order"] = order
    print("histogram_mesh: a shard's histogram under the global F's plan is bitwise the "
          "unsharded histogram's columns; under its own plan the bits are "
          + json.dumps({k: "the same" if v["own_plan_same_bits"] else "different"
                        for k, v in order.items()}), flush=True)
    # Rank 0's block of every form: (1, 4) (all rows, F / 4 columns under
    # the global F's plan; untagged), 1-D x4 (N / 4 rows, F), (2, 2) (N / 2
    # rows, F / 2 columns under the global F's plan) and its P_d = 2 twin
    # (N / 2 rows, F). The plan takes its warps and splits from the rows
    # too, so each block's launch is checked on its own.
    hist_shapes, blocks = {}, {}
    for form, n_rows, f_cols in (("", n, f_loc), ("x4_", n // 4, f),
                                 ("2x2_", n // 2, f // 2), ("x2_", n // 2, f)):
        bins_b = data.bins[:n_rows, :f_cols].contiguous()
        g_b, h_b = g[:n_rows].contiguous(), h[:n_rows].contiguous()
        node0_b, node8_b = node0[:n_rows].contiguous(), node8[:n_rows].contiguous()
        blocks[form] = (bins_b, g_b, h_b, node8_b)
        for tag, node, n_nodes, act in (("level0", node0_b, 1, None),
                                        ("level8_subset", node8_b, 256, active)):
            hist_shapes[form + tag] = histogram_case(
                bins_b, g_b, h_b, node, n_nodes, act, b, form + tag, report,
                key="histogram_mesh", plan_features=f if f_cols < f else None)
    report["histogram_mesh_shapes"] = hist_shapes
    mask = torch.rand(f, generator=gen, device=data.bins.device) < CFG.learner.feature_fraction
    gain_shapes = {}
    for tag, form, f_cols in (("L=256", "", f_loc), ("2x2_L=256", "2x2_", f // 2)):
        bins_b, g_b, h_b, node8_b = blocks[form]
        hist = histogram.histogram(bins_b, node8_b, g_b, h_b, 256, b, plan_features=f)
        gain_shapes[tag] = split_gain_case(hist, CFG.learner.lam, CFG.learner.min_child_hess,
                                           mask=mask[:f_cols])
    report["split_gain_mesh_shapes"] = gain_shapes
    shard = sp._replace(feat_rows=sp.feat_rows[:f_loc].contiguous(),
                        feat_codes=sp.feat_codes[:f_loc].contiguous(),
                        zero_bin=sp.zero_bin[:f_loc].contiguous())
    sp_shapes = check_histogram_sparse(shard, node8, active, g, h, report,
                                       key="histogram_sparse_mesh")
    return {"histogram": hist_shapes, "split_gain": gain_shapes,
            "histogram_sparse": sp_shapes}


def mesh_line(checked: dict, shapes: dict) -> list:
    """The ``kernels`` line's ``*_mesh`` entries, once every device time is
    taken: each kernel's launches in the mesh phase (summed over the rank
    processes and the NCCL rank; by rank in ``launches_by_rank``), its
    error and times at the feature shard's shapes (``check_mesh_kernels``)."""
    line = []
    for name, kernel in MESH_LINE.items():
        launches = checked["launches"][kernel]
        if launches <= 0:
            raise AssertionError(f"{name}: no launch in the mesh phase")
        tag = "L=256" if kernel == "split_gain" else "level8_subset"
        drop = ("surface_ms",) if kernel == "split_gain" else (
            ("entries_hit",) if kernel == "histogram_sparse" else ())
        st = line_stats(shapes[kernel], tag, drop=drop)
        _, source, replaces = KERNELS[kernel]
        line.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches, "launches_by_rank": checked["by_rank"][kernel],
                     **st})
    return line


def seeded_multiclass_forest(rng: np.random.Generator, dev) -> object:
    """A full 2000-slot (400 rounds x 5) depth-6 forest of valid random trees
    over the multiclass set's 60 features and 64 bins."""
    lc = MC_CFG.learner
    slots, n_int = MC_CFG.n_trees * MC_SHAPE[2], (1 << lc.depth) - 1
    return forest_from_numpy(
        rng.integers(0, MC_SHAPE[1], (slots, n_int)),
        rng.integers(0, lc.n_bins, (slots, n_int)),
        0.01 * rng.standard_normal((slots, 1 << lc.depth)),
        slots, 0.1 * rng.standard_normal(MC_SHAPE[2]), device=dev,
    )


def traversal_args(fo, live: int | None = None) -> tuple:
    """The traversal's arguments after the bins, for forest ``fo`` (f32 or
    quantized); ``live`` overrides its live-slot count."""
    nt = fo.n_trees if live is None else torch.tensor(live, dtype=torch.int32,
                                                       device=fo.feature.device)
    return (fo.feature, fo.threshold, fo.leaf_value, nt, fo.depth, fo.n_outputs,
            getattr(fo, "leaf_scale", None))


def traversal_bound(bins: torch.Tensor, fo, live: int) -> tuple[float, str, int]:
    """The least time for one traversal: the bin cells the walks read, each
    live tree's arrays in their packed types (and an int8 tree's scale), the
    live count and the output, over the memory rate; depth compares and
    index steps a (sample, tree) pair (and the int8 product), over the f32
    rate. Returns (ms, bound_by, cells read)."""
    n = bins.shape[0]
    n_int, n_leaf = fo.feature.shape[1], fo.leaf_value.shape[1]
    per_tree = (4 * n_int + fo.threshold.element_size() * n_int
                + fo.leaf_value.element_size() * n_leaf
                + (4 if fo.leaf_value.dtype == torch.int8 else 0))
    cells = touched_bins(bins, fo, live)
    nbytes = 4 * cells + live * per_tree + 4 + 4 * n * fo.n_outputs
    ops_per_pair = 3 * fo.depth + 1 + (1 if fo.leaf_value.dtype == torch.int8 else 0)
    ms, by = bound(nbytes, n * live * ops_per_pair)
    return ms, by, cells


def traversal_plan_of(bins: torch.Tensor, fo) -> dict:
    """The launch plan the traversal takes for ``bins`` and forest ``fo``
    (``kernels/traversal_plan.py``), with its walk grid."""
    n, f = bins.shape
    slots = fo.feature.shape[0]
    sms = forest_traversal._sms(bins.device) if bins.is_cuda else 132
    p = traversal_plan.plan(n, f, slots, fo.depth, fo.leaf_value.element_size(), sms)
    return {**p._asdict(), "grid": p.grid(min(n, p.slab), slots)}


def traversal_times(shapes: dict) -> str:
    """Each timed traversal shape: event / device / bound ms and its plan
    (S rows a block, t threads, g slots a group, the walk grid)."""
    return "; ".join(
        f"{tag} {st['ms']:.4f} / {st['device_ms']:.4f} / {st['bound_ms']:.4f} (S{pl['samples']} "
        f"t{pl['threads']} g{pl['group']} grid {pl['grid'][0]}x{pl['grid'][1]})"
        for tag, st in shapes.items() if "ms" in st for pl in (st["plan"],))


# A fused level's kernels by the phases they run, by the profiler's names:
# the earlier chain of launches (A the histogram's row_count / row_place /
# hist_kernel, B level_decide_kernel, C level_route_kernel) and the one
# launch that replaced it (level_kernel: all three phases, which
# tools/level_build_variants.py's cut-out builds split).
LEVEL_PHASES = (("row_count_kernel", "A"), ("row_place_kernel", "A"), ("hist_kernel", "A"),
                ("level_decide_kernel", "B"), ("level_route_kernel", "C"),
                ("level_kernel", "A+B+C"))


def level_phases(device_kernels: dict) -> dict:
    """A fused level's device ms by phase (``LEVEL_PHASES``; a kernel of no
    phase under "other")."""
    out: dict = {}
    for name, ms in device_kernels.items():
        phase = next((p for k, p in LEVEL_PHASES if k in name), "other")
        out[phase] = out.get(phase, 0.0) + ms
    return out


def level_launches(stats: dict) -> float:
    """A fused level's kernel launches a call, by the profiler's count."""
    return sum((stats.get("device_launches") or {}).values())


def check_traversal_forms(realsim_bins, mc_bins, rng, report: dict) -> dict:
    """Each new traversal form against its plain version, every output bit
    equal: int8 and fp16 on a seeded full realsim forest (4000 x 400, depth
    9, F 1500), K = 5 in f32, int8 and fp16 on a seeded full multiclass
    forest (4000 x 2000, depth 6, F 60); then a ragged case for every form
    (the first 1001 rows, live slots 237 of 400 and 1233 of 2000, not a
    multiple of 16 or of K, dead slots holding stale trees with huge
    leaves), and the serving wave (the first ``WAVE_ROWS`` rows, every slot
    live). Event ms, device ms, plain ms and the bound at the full shapes
    and the wave; each shape's launch plan. Returns each kernels-line
    entry's stats (device times pending)."""
    dev = realsim_bins.device
    base = {"realsim": (realsim_bins, seeded_forest(rng, realsim_bins.shape[1], 0.0, dev)),
            "multiclass": (mc_bins, seeded_multiclass_forest(rng, dev))}
    cases = {"forest_traverse_int8": ("realsim", "int8"), "forest_traverse_fp16": ("realsim", "fp16"),
             "forest_traverse_k5": ("multiclass", None),
             "forest_traverse_k5_int8": ("multiclass", "int8"),
             "forest_traverse_k5_fp16": ("multiclass", "fp16")}
    shapes, stats = {}, {}
    for name, (which, mode) in cases.items():
        bins, f32 = base[which]
        fo = f32.quantize(mode) if mode else f32
        slots = fo.feature.shape[0]
        per = {}
        for tag, rows, live in (("full", bins.shape[0], slots), ("wave", WAVE_ROWS, slots),
                                ("ragged", RAGGED_ROWS, RAGGED_LIVE[which])):
            if tag == "ragged":  # stale trees past the live count
                fo = fo._replace(leaf_value=fo.leaf_value.clone())
                fo.leaf_value[live:] = 100 if mode == "int8" else 1e4
            per[tag] = traversal_case(f"{name} {tag}", bins[:rows].contiguous(), fo, live,
                                      timed=tag != "ragged")
        shapes[name] = per
        stats[name] = per["full"]
    report["forest_traverse_form_shapes"] = shapes
    return stats


def traversal_case(tag: str, b: torch.Tensor, fo, live: int, timed: bool = True) -> dict:
    """One traversal form (that of forest ``fo``) on bins ``b`` with ``live``
    slots: every output bit equal to the plain version's; its launch plan;
    when ``timed``, event ms, device ms (pending), plain ms and the bound."""
    args = traversal_args(fo, live)
    got = forest_traversal.forest_traverse(b, *args)
    want, plain_ms = timed_once(lambda: forest_traversal.forest_traverse_plain(b, *args),
                                b.device)
    if got.shape != want.shape or not torch.equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"{tag}: {bad} outputs differ from the plain version")
    out = {"rows": b.shape[0], "live": live, "max_abs_err": 0.0,
           "plan": traversal_plan_of(b, fo)}
    if timed:
        bms, by, cells = traversal_bound(b, fo, live)
        event_times(lambda: forest_traversal.forest_traverse(b, *args), out)
        out.update({
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None, "bin_cells_read": cells,
        })
    return out


def drive_multiclass(dev: torch.device, realsim: dict) -> dict:
    """The multiclass path and quantized serving, the second main path
    (only its launches are counted; it too runs before any kernel check):
    multiclass:5 trained 16 rounds at W = 4 staged (twice) and fused; then
    the realsim forest of ``drive``'s run and the multiclass forest served
    f32, int8 and fp16. Returns what the checks need."""
    x, y = synthetic.multiclass_xy(*MC_SHAPE, seed=0)
    data = bin_dataset(x, y, n_bins=64, device=dev)
    rng = np.random.default_rng(SEED + 3)
    reset_counts()
    stamps: dict = {"staged": [], "fused": []}
    fused_per_round: list = []
    runs = {"staged": train(data, MC_CFG, stamps["staged"]), "again": train(data, MC_CFG),
            "fused": train(data, MC_CFG_FUSED, stamps["fused"], fused_per_round)}
    servings = (("realsim", realsim["forest"], realsim["x"], realsim["data"].bin_edges,
                 "logistic"),
                ("multiclass", runs["staged"].forest, x, data.bin_edges, MC_CFG.objective))
    served = {(tag, mode): serve(forest, xs, edges, rng, objective=obj, quantize=mode)
              for tag, forest, xs, edges, obj in servings for mode in QUANT_MODES}
    torch.cuda.synchronize()
    return {"data": data, "y": y, "rng": rng, "runs": runs, "stamps": stamps,
            "fused_per_round": fused_per_round, "servings": servings, "served": served,
            "counts": gbdt_counts()}


def check_multiclass_kernels(data, state, report: dict) -> dict:
    """The histogram, the split gain and the fused level against their plain
    versions on the multiclass path's data (N 4000, F 60, 64 bins), at each
    of a tree's six levels on the staged learner's nodes: lane 0's (g, h)
    of the round after the run (its draws from a seeded generator, the
    gradient at the trained F, h = m'), the level's smaller children in
    subtract mode. Tolerances as at realsim, but the split gain's atol
    scales with its terms (``split_gain_case``, which also holds its
    decision form bitwise to the plain chain under the tree's mask).
    Returns the stats by
    kernel and level (device times pending)."""
    dev = data.bins.device
    lc = MC_CFG.learner
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    m, _ = bernoulli_weights(gen, MC_CFG.sampling_rate, data.multiplicity)
    mask = torch.rand(data.n_features, generator=gen, device=dev) < lc.feature_fraction
    g0, _ = MC_CFG.obj.grad_hess(data.labels, state.f)
    g, h = (m * g0[:, 0]).contiguous(), m.contiguous()
    node = torch.zeros(data.n_samples, dtype=torch.int32, device=dev)
    parent = None
    shapes: dict = {"histogram": {}, "split_gain": {}, "level_build": {}}
    for level in range(lc.depth):
        n_nodes, tag = 1 << level, f"level{level}"
        act = None if level == 0 else _smaller_children(node, h, n_nodes)
        shapes["histogram"][tag] = histogram_case(
            data.bins, g, h, node, n_nodes, act, lc.n_bins, tag, report,
            key="multiclass_histogram")
        shapes["level_build"][tag] = level_build_case(
            lc, data.bins, node, g, h, mask, level, parent, tag, report,
            key="multiclass_level_build")
        parent, _, _, node = _staged_level(lc, data.bins, node, g, h, mask, level, parent)
        shapes["split_gain"][tag] = split_gain_case(parent, lc.lam, lc.min_child_hess,
                                                    scale_by="terms", mask=mask)
    report["multiclass_kernel_shapes"] = shapes
    return shapes


def check_multiclass(mc: dict, realsim: dict, report: dict) -> dict:
    """The checks of ``drive_multiclass``'s run, and its kernels against
    their plain versions at its shapes (the traversal's new forms, then the
    histogram, split gain and fused level on the multiclass data). Returns
    the traversal forms' kernels-line stats and the other kernels' stats by
    level (device times pending)."""
    data, y, runs = mc["data"], mc["y"], mc["runs"]
    state = runs["staged"]
    card = report.get("nvidia_smi", "card not queried")
    forms = check_traversal_forms(realsim["data"].bins, data.bins, mc["rng"], report)
    levels = check_multiclass_kernels(data, state, report)

    round_ms = {k: [1e3 * (b - a) for a, b in zip(v, v[1:])] for k, v in mc["stamps"].items()}
    for k, v in round_ms.items():
        print(f"multiclass:5 round ms ({k}): " + " ".join(f"{t:.1f}" for t in v)
              + f"; median (rounds 2-{ROUNDS}) {float(np.median(v[1:])):.2f} [{card}]",
              flush=True)
    same_forest("multiclass: second staged run", state, runs["again"])
    want = [lv for lv in range(MC_CFG.learner.depth) if level_build.fused_level_fits(
        MC_SHAPE[0], 1 << lv, max(1, (1 << lv) // 2), MC_SHAPE[1], MC_CFG.learner.n_bins)]
    fused_per_round = mc["fused_per_round"]
    per_tree = [n // MC_SHAPE[2] for n in fused_per_round]
    if per_tree != [len(want)] * ROUNDS or any(n % MC_SHAPE[2] for n in fused_per_round):
        raise AssertionError(f"multiclass fused launches per round {fused_per_round}, "
                             f"expected {len(want)} per tree")
    same_forest("multiclass: fused run vs staged run", runs["fused"], state)
    loss0 = float(MC_CFG.obj.loss(data.labels, init_state(MC_CFG, data).f, data.multiplicity))
    met = train_metrics(MC_CFG, data, state)
    loss, acc = float(met["loss"]), float(met["accuracy"])
    prior = float(np.bincount(y.astype(np.int64), minlength=MC_SHAPE[2]).max() / len(y))
    if not (np.isfinite(loss) and loss < loss0):
        raise AssertionError(f"multiclass loss did not fall: {loss0} -> {loss}")
    if not acc > prior:
        raise AssertionError(f"multiclass accuracy {acc} not above the largest prior {prior}")
    if int(state.forest.n_trees) != ROUNDS * MC_SHAPE[2] or state.f.shape != (MC_SHAPE[0], 5):
        raise AssertionError("multiclass forest or F of the wrong size")
    torch.testing.assert_close(forest_predict(state.forest, data.bins), state.f,
                               rtol=1e-5, atol=1e-6)
    print(f"multiclass:5 train loss {loss0:.6f} -> {loss:.6f}, accuracy {acc:.4f} (largest "
          f"class prior {prior:.4f}) after {ROUNDS} rounds; second staged run and fused run "
          f"(levels {want} fused) bitwise equal to the first", flush=True)

    serve_stats = {}
    for tag, f32, xs, edges, obj in mc["servings"]:
        serve_stats.update(check_serving_modes(
            tag, f32, xs, edges, {mode: mc["served"][tag, mode] for mode in QUANT_MODES}, card))
    report["multiclass"] = {
        "config": {"shape": MC_SHAPE, "objective": MC_CFG.objective, "depth": MC_CFG.learner.depth,
                   "slots": MC_CFG.n_trees * MC_SHAPE[2], "rounds": ROUNDS, "workers": WORKERS},
        "round_ms": round_ms, "fused_levels": want, "fused_launches_per_round": fused_per_round,
        "loss": {"start": loss0, "staged": loss}, "accuracy": acc, "largest_prior": prior,
        "serve": serve_stats, "launches": mc["counts"],
    }
    return forms, levels


def check_serving_modes(tag: str, f32, xs: np.ndarray, edges, served: dict, card: str) -> dict:
    """The f32 forest ``f32`` served in each of ``QUANT_MODES`` (``served``:
    mode -> ``serve``'s (server, requests, results)): every answer
    link(forest_predict) on the installed forest (``check_served``); a
    K = 5 forest's rows softmax rows; a quantized server holds that form,
    every margin within ``quantization_atol`` + 1e-6 of the f32 forest's.
    Returns the stats by "tag form"."""
    bins_all = apply_bins(torch.from_numpy(xs).to(edges.device), edges)
    margin32 = forest_predict(f32, bins_all)
    stats = {}
    for mode in QUANT_MODES:
        server, reqs, results = served[mode]
        key = f"{tag} {mode or 'f32'}"
        st = stats[key] = check_served(key, server, reqs, results)
        if MC_SHAPE[2] == f32.n_outputs:
            rows = np.concatenate([r.scores for r in results])
            st["softmax_row_sum_err"] = float(np.abs(rows.sum(1) - 1.0).max())
            if st["softmax_row_sum_err"] > 1e-5:
                raise AssertionError(f"{key}: a served row is no softmax row")
        if mode:
            if not isinstance(server.forest, QuantizedForest) or server.forest.mode != mode:
                raise AssertionError(f"{key}: the server did not install a {mode} forest")
            atol = quantization_atol(f32, server.forest)
            diff = float((forest_predict(server.forest, bins_all) - margin32).abs().max())
            st.update(margin_max_abs_diff=diff, quantization_atol=atol)
            if not diff <= atol + 1e-6:
                raise AssertionError(f"{key}: a margin moved {diff}, over the bound {atol}")
        print(f"serve {key}: {st['requests']} requests over {st['waves']} waves, latency "
              f"p50 {st['latency_p50_ms']:.3f} ms p99 {st['latency_p99_ms']:.3f} ms"
              + (f"; margins within {st['margin_max_abs_diff']:.3g} of f32 (bound "
                 f"{st['quantization_atol']:.3g})" if mode else "") + f" [{card}]", flush=True)
    return stats


def multiclass_line(mc: dict, checked: tuple, report: dict) -> list:
    """Once every device time is taken: the multiclass kernel checks'
    times (``check_multiclass``'s stats; the histogram, split gain and
    fused level at the deepest level, with the largest error of all six),
    a profiled round of each multiclass run, and the ``kernels`` line's
    entries of the multiclass path (each must have run on it)."""
    card = report.get("nvidia_smi", "card not queried")
    forms, levels = checked
    deep = f"level{MC_CFG.learner.depth - 1}"
    kstats = {**forms, **{f"{name}_multiclass": line_stats(per, deep,
                                                          drop=("staged_ms", "samples_hit",
                                                                "surface_ms"))
                          for name, per in levels.items()}}
    for name, per in report["forest_traverse_form_shapes"].items():
        print(f"{name} bitwise equal to the plain version, full, wave and ragged (event / "
              f"device / bound ms): {traversal_times(per)} [{card}]", flush=True)
    phases = report.setdefault("level_build_phases", {})
    for tag in ("level0", deep):
        phases[f"multiclass {tag}"] = level_phases(levels["level_build"][tag].get(
            "device_kernels") or {})
    print("level_build device ms by phase (one launch: A+B+C): " + "; ".join(
        f"{tag} " + " ".join(f"{k} {v:.4f}" for k, v in ph.items())
        for tag, ph in phases.items()) + f" [{card}]", flush=True)
    per_level = {**{f"realsim {t}": st for t, st in report["level_build_shapes"].items()},
                 **{f"multiclass {t}": st for t, st in levels["level_build"].items()}}
    report["level_build_launches_per_call"] = {t: level_launches(st)
                                               for t, st in per_level.items()}
    print("level_build launches a fused level (profiler): " + "; ".join(
        f"{t} {n:g}" for t, n in report["level_build_launches_per_call"].items())
        + " (the earlier chain: 4 at one row, 5 above)", flush=True)
    print("split_gain_decide multiclass, device ms per level (bound ms), the decision bitwise "
          "the plain chain's on the kernel's surface at every level: " + "; ".join(
              f"{t} {st['device_ms']:.4f} ({st['bound_ms']:.5f})"
              for t, st in levels["split_gain"].items()) + f" [{card}]", flush=True)
    print("multiclass path kernels (traversal forms bitwise equal to the plain version, full "
          "and ragged; the rest at levels 0-5): " + json.dumps(
              {k: {"ms": v["ms"], "device_ms": v["device_ms"], "bound_ms": v["bound_ms"],
                   "plain_ms": v["plain_ms"], "max_abs_err": v["max_abs_err"]}
               for k, v in kstats.items()}) + f" [{card}]", flush=True)
    info = report["multiclass"]
    info["profile"] = {}
    if mc["data"].bins.device.type == "cuda":
        for tag, cfg in (("staged", MC_CFG), ("fused", MC_CFG_FUSED)):
            prof = info["profile"][tag] = profile_rounds(mc["data"], cfg)
            prof["device_busy_share"] = busy(prof, prof["device_ms_per_round"],
                                             float(np.median(info["round_ms"][tag][1:])))
            check_no_chain(f"multiclass:5 {tag}", prof)
            print(f"profile (multiclass:5 {tag}): device {prof['device_ms_per_round']:.4f} ms "
                  f"per round ({prof['device_ms_by']}), busy "
                  f"{pct(prof['device_busy_share'])} of a round's wall time; split kernel "
                  f"{prof['split_kernel_calls']:g} launches a round [{card}]",
                  flush=True)
        fused_ms = {"realsim": report["profile"]["fused"]["device_ms_per_round"],
                    "multiclass": info["profile"]["fused"]["device_ms_per_round"]}
        report["fused_round_device_ms"] = fused_ms
        print(f"fused round device ms ({report['profile']['fused']['device_ms_by']}, a round "
              "after a warm-up): " + ", ".join(f"{k} {v:.4f}" for k, v in fused_ms.items())
              + f" [{card}]", flush=True)
    counts = mc["counts"]
    entries = [(name, "src/repro_torch/csrc/forest_traversal.cu",
                "src/repro/kernels/forest_traversal.py:107", key)
               for name, key in TRAV_FORMS.items()]
    entries += [(f"{name}_multiclass", source, replaces, name)
                for name, (_, source, replaces) in KERNELS.items()
                if f"{name}_multiclass" in kstats]
    line = []
    for name, source, replaces, key in entries:
        if counts[key] <= 0:
            raise AssertionError(f"{name}: no launch on the multiclass and quantized path")
        line.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": counts[key],
                     **{k: v for k, v in kstats[name].items()
                        if k not in ("rows", "live", "plan")}})
    return line


def sdpa_backend(fn) -> dict:
    """Which of SDPA's backends one call of ``fn`` ran: the names of the
    kernels it launched (``torch.profiler``) matched to ``SDPA_BACKENDS``."""
    from torch.profiler import ProfilerActivity, profile

    if not profiler_sees_device():
        return {"backend": "not traced", "kernels": []}
    names = []
    for _ in range(3):  # a trace that caught no kernel is taken again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({k[:120] for k, _, _ in device_rows(prof)})
        if names:
            break
    backend = next((b for key, b in SDPA_BACKENDS if any(key in n.lower() for n in names)),
                   "math or other")
    return {"backend": backend, "kernels": names}


def flash_tag(b, sq, sk, h, kv, d, causal, dtype, seq_k) -> str:
    return (f"{b}x{sq}x{sk} h{h}/{kv} d{d} {'causal' if causal else 'full'} "
            + str(dtype).split(".")[-1] + ("" if seq_k is None else f" seq_k {seq_k}"))


def flash_planted_faults(q, k, v, lse, got) -> dict:
    """Wrong outs that the element-wise limit lets through, each made from
    the kernel's own ``got`` on its later half of rows: there the p . v of
    the last 128-key tile every such row sees takes the tile before's V
    ("v_stage"), or is dropped ("tile_dropped"), or the rows are 3% off
    ("rescale"). The relative L2 limit must reject each."""
    sq, d = q.shape[2], q.shape[3]
    half, group = sq // 2, q.shape[1] // k.shape[1]
    t0 = half - 128
    kf, vf = (x[:, :, t0 - 128:half].float().repeat_interleave(group, dim=1) for x in (k, v))
    p = torch.exp(q[:, :, half:].float() @ kf[:, :, 128:].transpose(-1, -2) / d ** 0.5
                  - lse[:, :, half:, None])
    pv, prev = p @ vf[:, :, 128:], p @ vf[:, :, :128]
    late = got[:, :, half:].float()
    faults = {}
    for name, bad in (("v_stage", late - pv + prev), ("tile_dropped", late - pv),
                      ("rescale", late * 0.97)):
        out = got.clone()
        out[:, :, half:] = bad.to(got.dtype)
        faults[name] = out
    return faults


def flash_rel_l2(got, want) -> dict:
    """The relative L2 error of a flash out, whole and on its later half of rows."""
    half = got.shape[2] // 2
    return {"whole": rel_l2(got, want), "later_rows": rel_l2(got[:, :, half:], want[:, :, half:])}


def check_flash(dev, report: dict, arch: str = LM_ARCH, ragged: list = FLASH_RAGGED,
                suffix: str = "", shape: tuple = (LM_SLOTS, LM_PROMPTS[0])) -> dict:
    """The flash kernel against its plain version (the f32 softmax) at the
    serving prefill's shape and at the ragged shapes, two launches bitwise,
    each shape's route (``flash_plan.route``) reported. Tolerances: bf16
    out atol/rtol 2e-2 (the kernel rounds p to bf16 before p . v, as the
    TPU kernel does; the plain version keeps p in f32) and lse 1e-3; f32
    1e-4 for both. A bf16 out is also held to a relative L2 error of
    ``FLASH_OUT_REL_L2``, over the whole tensor and over its later half
    of rows (past 1024 at the prefill), where |out| is small beside the
    element-wise limit (about sqrt(e / n) for randn rows that see n keys).
    Times at the prefill's shape, beside
    ``scaled_dot_product_attention`` on the same inputs (contiguous), whose
    backend is named. ``arch`` gives the prefill's heads and ``shape`` its
    (batch, length); the planted faults need a length of 512 or more. The
    report's keys take ``suffix``."""
    cfg = lm_configs.get(arch)
    b, s = shape
    cases = [(b, s, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, True, torch.bfloat16, None)]
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    shapes, out = {}, None
    for bq, sq, sk, h, kv, d, causal, dtype, seq_k in cases + ragged:
        # Model layout (B, S, H, d), read by the kernel in place.
        q, k, v = (torch.randn(shape, generator=gen).to(dev, dtype).transpose(1, 2)
                   for shape in ((bq, sq, h, d), (bq, sk, kv, d), (bq, sk, kv, d)))

        def run(q=q, k=k, v=v, causal=causal, seq_k=seq_k):
            return flash_attention.flash_attention(q, k, v, causal, seq_k)
        (o1, l1), (o2, l2) = run(), run()
        torch.cuda.synchronize()
        tag = flash_tag(bq, sq, sk, h, kv, d, causal, dtype, seq_k)
        if not (torch.equal(o1, o2) and torch.equal(l1, l2)):
            raise AssertionError(f"flash_attention {tag}: two launches differ")
        want, want_lse = flash_attention.flash_attention_plain(q, k, v, causal, seq_k)
        bf16 = dtype == torch.bfloat16
        err = close(f"flash_attention {tag} out", o1.float(), want.float(),
                    2e-2 if bf16 else 1e-4, 2e-2 if bf16 else 1e-4)
        err_lse = close(f"flash_attention {tag} lse", l1, want_lse,
                        1e-3 if bf16 else 1e-4, 1e-3 if bf16 else 1e-4)
        rel = flash_rel_l2(o1, want)
        if bf16 and max(rel.values()) > FLASH_OUT_REL_L2:
            raise AssertionError(f"flash_attention {tag} out: relative L2 error {rel} over "
                                 f"{FLASH_OUT_REL_L2}")
        shapes[tag] = {"max_abs_err": err, "max_abs_err_lse": err_lse, "rel_l2_err": rel,
                       "route": flash_plan.route(dtype, d)}
        if out is None:  # the prefill's shape: the planted faults, times and bound
            planted = {}
            for name, bad in (flash_planted_faults(q, k, v, l1, o1) if sq >= 512
                              else {}).items():
                r = flash_rel_l2(bad, want)
                if max(r.values()) <= FLASH_OUT_REL_L2:
                    raise AssertionError(f"flash_attention: the planted fault {name} passes "
                                         f"the relative L2 limit: {r}")
                diff = (bad.float() - want.float()).abs()
                planted[name] = {"rel_l2_err": r, "passes_elementwise": bool(
                    (diff <= 2e-2 + 2e-2 * want.float().abs()).all())}
            shapes[tag]["planted_faults"] = planted
            bad = diff = None
            el = q.element_size()
            # Bytes: q, k, v read once, out written once, lse; operations:
            # two products of 2d flops for every (query, key) pair the mask
            # keeps (causal: key <= query), in the bf16 tensor cores.
            pairs = bq * h * (sq * (sq + 1) // 2 if causal else sq * sk)
            nbytes = el * (2 * bq * h * sq * d + 2 * bq * kv * sk * d) + 4 * bq * h * sq
            bms, by = bound(nbytes, 4.0 * d * pairs, PEAK_BF16_S)
            qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
            # SDPA's event and device times (``library_ms``, ``library_device_ms``),
            # the latter filled with the kernel's own by ``kernel_times``.
            def sdpa(qc=qc, kc=kc, vc=vc):
                return torch.nn.functional.scaled_dot_product_attention(
                    qc, kc, vc, is_causal=True, enable_gqa=True)
            lib = event_times(sdpa, key="library_")
            out = {
                "max_abs_err": err, **kernel_times(run),
                "plain_ms": cuda_ms(lambda q=q, k=k, v=v: flash_attention.flash_attention_plain(
                    q, k, v, True), reps=5),
                "bound_ms": bms, "bound_by": by, **lib,
            }
            # The exponentials' own floor: one ex2 a kept pair.
            shapes[tag].update(out, bytes=nbytes, flops=4.0 * d * pairs, pairs=pairs,
                               ex2_bound_ms=pairs / PEAK_EX2_S * 1e3,
                               library_backend=sdpa_backend(sdpa))
    report["flash_attention_shapes" + suffix] = shapes
    out["max_abs_err"] = max(v["max_abs_err"] for v in shapes.values())
    return out


def to_f32(tree: dict) -> dict:
    """The tree's float leaves in f32 (integer leaves, a batch's tokens, kept)."""
    return {k: to_f32(v) if isinstance(v, dict) else v.float() if v.is_floating_point() else v
            for k, v in tree.items()}


def count_params(tree: dict) -> int:
    return sum(count_params(v) if isinstance(v, dict) else v.numel() for v in tree.values())


def media_of(cfg, uid: int) -> np.ndarray:
    """Request ``uid``'s seeded media (M, D): unit normals in f32."""
    return np.random.default_rng(SEED + 1000 + uid).standard_normal(
        (cfg.n_media_tokens, cfg.d_model), dtype=np.float32)


def lm_requests(cfg, rng, slots: int | None = None, prompts: tuple | None = None,
                new: int | None = None, media: bool = False) -> list:
    """``slots`` seeded requests for each prompt length of ``prompts``, each
    of ``new`` tokens (LM_SLOTS, LM_PROMPTS and LM_NEW by default), with
    its own ``media_of`` where ``media``."""
    slots, prompts, new = slots or LM_SLOTS, prompts or LM_PROMPTS, new or LM_NEW
    out = []
    for i, plen in enumerate(prompts):
        for j in range(slots):
            uid = i * slots + j
            out.append(Request(uid=uid,
                               prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
                               max_new_tokens=new, media=media_of(cfg, uid) if media else None))
    return out


def wave_batch(cfg, requests: list, dev) -> dict:
    """The prefill batch of one wave of requests: tokens, and their media
    in the model's dtype where they have any."""
    batch = {"tokens": torch.as_tensor(np.stack([r.prompt for r in requests]), device=dev)}
    if requests[0].media is not None:
        batch["media"] = torch.as_tensor(np.stack([r.media for r in requests]),
                                         device=dev).to(getattr(torch, cfg.dtype))
    return batch


def serve_lm(engine, requests) -> tuple:
    """One wave a ``run`` call (the engine's slots filled by same-length
    requests); returns (completions, flash launches of each wave)."""
    outs, per_wave = [], []
    for i in range(0, len(requests), engine.slots):
        before = flash_attention.launches
        outs += engine.run(requests[i:i + engine.slots])
        per_wave.append(flash_attention.launches - before)
    return outs, per_wave


def profile_lm(engine, requests, steps: int = 8) -> dict:
    """Where a wave's device time goes: ``torch.profiler`` over one prefill
    of the longest prompts and ``steps`` decode steps, by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    cfg, dev = engine.cfg, engine.device
    longest = max(len(r.prompt) for r in requests)
    batch = wave_batch(cfg, [r for r in requests if len(r.prompt) == longest][:engine.slots],
                       dev)
    prefill_step = make_prefill_step(cfg, max_len=engine.max_len)
    decode = make_decode_step(cfg)
    res = {}
    for phase in ("prefill", "decode"):
        tok, _, cache = prefill_step(engine.params, batch)
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
        with op_ranges(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            start.record()
            if phase == "prefill":
                tok, _, cache = prefill_step(engine.params, batch)
            else:
                for _ in range(steps):
                    tok, cache = decode(engine.params, tok[:, None], cache)
            stop.record()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        n = 1 if phase == "prefill" else steps
        rows = device_rows(prof) if profiler_sees_device() else []
        rows.sort(key=lambda r: -r[1])
        dev_ms = (sum(r[1] for r in rows) if rows else start.elapsed_time(stop)) / n
        groups = {k: v / n for k, v in device_groups(prof).items()} if rows else {}
        res[phase] = {"calls": n, "device_ms": dev_ms,
                      "device_ms_by": "profiler" if rows else "events",
                      "wall_ms_profiled": wall / n, "by_group_ms": groups,
                      "range_spans_ms": {k: v / n for k, v in range_spans(prof).items()},
                      "range_host_ms": {k: v / n
                                        for k, v in range_spans(prof, host=True).items()},
                      "groups_over_device": groups_cover(f"{cfg.name} {phase}", groups, dev_ms)
                      if rows else None}
        res[phase].update({"device_busy_share": busy(res[phase], dev_ms, wall / n),
                           "top": [{"name": k[:80], "device_ms": ms / n, "calls": c}
                                   for k, ms, c in rows[:12]]})
    return res


# The share of rows (prefill) or of (row, step) pairs (decode) whose MoE
# routing must agree across the paths a numeric gate compares
# (``route_agreement``).
ROUTE_AGREEMENT = 0.75


@contextlib.contextmanager
def recorded_routes():
    """While it is open, the expert ids of every ``layers._router`` call
    (sorted within each token's k) are appended to the yielded list."""
    calls, inner = [], lm_layers._router

    def spy(p, xf, cfg):
        out = inner(p, xf, cfg)
        calls.append(out[1].detach().sort(dim=-1).values.cpu())
        return out
    lm_layers._router = spy
    try:
        yield calls
    finally:
        lm_layers._router = inner


def route_agreement(tag: str, routes: list, shape: tuple) -> torch.Tensor:
    """Where the paths' MoE routings agree: ``routes`` holds, for each path,
    a tensor (..., layers, k) of ids, or None (no router: a dense or hybrid
    model); returns a bool mask of ``shape``, True where every path routed
    every layer alike, and fails if it covers less than ROUTE_AGREEMENT of
    the entries. A numeric gate compares logits only where the routing
    agrees: a near-tied router logit that rounds the other way in one path
    swaps an expert, a discrete change no tolerance on rounding covers."""
    routes = [r for r in routes if r is not None]
    agree = torch.ones(shape, dtype=torch.bool)
    for r in routes[1:]:
        agree &= (r == routes[0]).flatten(-2).all(-1)
    if float(agree.float().mean()) < ROUTE_AGREEMENT:
        raise AssertionError(f"{tag}: the routings agree on {int(agree.sum())} of "
                             f"{agree.numel()} entries, under {ROUTE_AGREEMENT}")
    return agree


def last_routes(calls: list, batch: int) -> torch.Tensor | None:
    """The last position's ids (B, layers, k) of a prefill's router calls."""
    if not calls:
        return None
    return torch.stack([c.reshape(batch, -1, c.shape[-1])[:, -1] for c in calls], dim=1)


def prefill_against_f32(cfg, params: dict, batch: dict, max_len: int | None = None,
                        other: dict | None = None) -> dict:
    """Flash against chunked on one wave: last-position prefill logits, same
    weights. Tolerance: twice what bf16 costs the chunked path itself,
    measured against the chunked path in f32 (the same weights upcast; no
    TF32): if the flash path is as accurate, the two bf16 paths differ by
    at most that. Where the top-2 margin of a row exceeds the tolerance,
    both paths must pick the same first token. For an MoE model only the
    rows whose last position the three paths route alike are compared
    (``route_agreement``). A batch's media are cast to each path's dtype;
    ``max_len`` is LM_MAX_LEN unless given. ``other`` names the config
    changes of the compared ("chunked") path, ``attn_impl="chunked"``
    unless given (a model without attention takes another SSM chunk: the
    same sums grouped otherwise). Returns the figures."""
    max_len = max_len or LM_MAX_LEN
    flash_step = make_prefill_step(cfg, max_len=max_len)
    b = batch["tokens"].shape[0]
    with recorded_routes() as rf:
        tok_f, lf, _ = flash_step(params, batch)
    _, lf2, _ = flash_step(params, batch)
    chunked = dataclasses.replace(cfg, **(other or {"attn_impl": "chunked"}))
    with recorded_routes() as rc:
        tok_c, lc, _ = make_prefill_step(chunked, max_len=max_len)(params, batch)
    params32 = to_f32(params)
    with recorded_routes() as rr:
        _, lr, _ = make_prefill_step(dataclasses.replace(chunked, dtype="float32"),
                                     max_len=max_len)(params32, to_f32(batch))
    del params32
    rows = route_agreement(f"{cfg.name} prefill", [last_routes(r, b) for r in (rf, rc, rr)],
                           (b,)).to(lf.device)
    vocab = slice(0, cfg.vocab_size)
    bitwise = bool(torch.equal(lf, lf2))
    lf, lc, lr = (x[rows, vocab].float() for x in (lf, lc, lr))
    tok_f, tok_c = tok_f[rows], tok_c[rows]
    if not all(torch.isfinite(x).all() for x in (lf, lc, lr)):
        raise AssertionError(f"{cfg.name}: non-finite prefill logits")
    err_c, err_f = float((lc - lr).abs().max()), float((lf - lr).abs().max())
    tol = 2 * err_c
    diff = float((lf - lc).abs().max())
    if diff > tol:
        raise AssertionError(f"{cfg.name}: flash vs chunked prefill logits: max |diff| {diff} "
                             f"> {tol}")
    top2 = lf.topk(2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > tol
    if not torch.equal(tok_f[decisive], tok_c[decisive]):
        raise AssertionError(f"{cfg.name}: flash and chunked pick other first tokens where the "
                             "top-2 margin exceeds the tolerance")
    return {"max_abs_diff": diff, "tolerance": tol, "logit_scale": float(lr.abs().max()),
            "chunked_vs_f32": err_c, "flash_vs_f32": err_f,
            "decisive_rows": int(decisive.sum()), "rows_compared": int(rows.sum()),
            "first_tokens_equal": bool(torch.equal(tok_f, tok_c)),
            "bitwise_across_runs": bitwise}


def drive_lm(dev: torch.device, report: dict) -> dict:
    """The LM zoo's serving path; returns its kernel's ``kernels`` entry."""
    kstats = check_flash(dev, report)
    fs = report["flash_attention_shapes"]
    print("flash_attention check (max abs error, relative L2 whole and later rows, route): "
          + json.dumps({k: [v["max_abs_err"], v["rel_l2_err"]["whole"],
                            v["rel_l2_err"]["later_rows"], v["route"]]
                        for k, v in fs.items()}), flush=True)
    prefill = next(iter(fs.values()))
    print(f"flash_attention planted faults at the prefill (relative L2 later rows, passes "
          f"element-wise), limit {FLASH_OUT_REL_L2}: " + json.dumps(
              {k: [v["rel_l2_err"]["later_rows"], v["passes_elementwise"]]
               for k, v in prefill["planted_faults"].items()}), flush=True)
    print(f"flash_attention at {LM_SLOTS} x {LM_PROMPTS[0]} ({prefill['route']}): "
          f"{kstats['ms']:.4f} ms, device {kstats['device_ms']:.4f} (bound "
          f"{kstats['bound_ms']:.4f}, ex2 {prefill['ex2_bound_ms']:.4f}); SDPA "
          f"({prefill['library_backend']['backend']}) {kstats['library_ms']:.4f} ms, device "
          f"{kstats['library_device_ms']:.4f} "
          f"[{report.get('nvidia_smi', 'card not queried')}]", flush=True)
    cfg = dataclasses.replace(lm_configs.get(LM_ARCH), attn_impl="flash")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, device=dev)
    n_params = count_params(params)
    # ModelConfig.param_count counts the weight matrices, not the norm scales.
    if n_params != cfg.param_count() + (2 * cfg.n_layers + 1) * cfg.d_model:
        raise AssertionError(f"{n_params} parameters, the config counts {cfg.param_count()}")
    engine = ServingEngine(cfg, params, slots=LM_SLOTS, max_len=LM_MAX_LEN, device=dev)
    requests = lm_requests(cfg, np.random.default_rng(SEED))

    # The main path: two waves, twice; only these launches are counted.
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    runs = [serve_lm(engine, requests) for _ in range(2)]
    torch.cuda.synchronize()
    counts = {name: mod.launches for name, (mod, _, _) in LM_KERNELS.items()}
    routes = dict(flash_attention.route_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if routes["wgmma"] != counts["flash_attention"]:
        raise AssertionError(f"flash launches by route {routes}: the prefill's "
                             f"{counts['flash_attention']} must all be the wgmma kernel's")

    check_lm_waves(LM_ARCH, cfg, runs, requests, cfg.n_layers)  # one flash launch a layer

    batch = {"tokens": torch.as_tensor(np.stack([r.prompt for r in requests[:LM_SLOTS]]),
                                       device=dev)}
    vs = prefill_against_f32(cfg, params, batch)
    diff, tol, err_c, err_f, scale = (vs[k] for k in ("max_abs_diff", "tolerance",
                                                      "chunked_vs_f32", "flash_vs_f32",
                                                      "logit_scale"))
    waves = lm_wave_stats(runs)
    prefill_ms, decode_ms_tok, tok_s = (waves[k] for k in (
        "prefill_ms_per_wave", "decode_ms_per_token", "tokens_per_s_per_wave"))
    lm = {
        "config": {"arch": LM_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                   "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                   "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
                   "dtype": cfg.dtype, "attn_impl": cfg.attn_impl, "params": n_params},
        "waves": [f"{LM_SLOTS} x {p}" for p in LM_PROMPTS], "new_tokens": LM_NEW,
        "prefill_ms_per_wave": prefill_ms, "decode_ms_per_token": decode_ms_tok,
        "tokens_per_s_per_wave": tok_s, "peak_mem_gb": peak_gb, "launches": counts,
        "launches_by_route": routes,
        "flash_launches_per_wave": [w for _, pw in runs for w in pw],
        "flash_vs_chunked": {k: v for k, v in vs.items() if k != "bitwise_across_runs"},
        "prefill_logits_bitwise_across_runs": vs["bitwise_across_runs"],
        "tokens_equal_across_runs": True,
    }
    lm["profile"] = profile_lm(engine, requests, steps=2)
    report["lm_serving"] = lm
    card = report.get("nvidia_smi", "card not queried")
    for i, p in enumerate(LM_PROMPTS):
        print(f"serve {LM_ARCH} ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype}, "
              f"{cfg.attn_impl}) wave {LM_SLOTS} x {p}: prefill "
              + " / ".join(f"{prefill_ms[r * len(LM_PROMPTS) + i]:.1f}" for r in range(2))
              + " ms, decode " + " / ".join(
                  f"{decode_ms_tok[r * len(LM_PROMPTS) + i]:.2f}" for r in range(2))
              + " ms a token, " + " / ".join(
                  f"{tok_s[r * len(LM_PROMPTS) + i]:.1f}" for r in range(2))
              + f" generated tokens/s (two runs) [{card}]", flush=True)
    print(f"serve {LM_ARCH}: flash launches by route {routes}; tokens equal across two runs; "
          f"prefill logits bitwise equal "
          f"across runs: {lm['prefill_logits_bitwise_across_runs']}; flash vs chunked max "
          f"|diff| {diff:.4g} (tolerance {tol:.4g}; against f32: chunked {err_c:.4g}, flash "
          f"{err_f:.4g}; logit scale {scale:.4g}); peak device "
          f"memory {peak_gb:.2f} GB [{card}]", flush=True)
    for phase, prof in lm["profile"].items():
        print(f"profile ({LM_ARCH} {phase}): device {prof['device_ms']:.2f} ms a "
              f"{'wave' if phase == 'prefill' else 'step'} ({prof['device_ms_by']}), busy "
              f"{pct(prof['device_busy_share'])} [{card}]", flush=True)

    name, (_, source, replaces) = next(iter(LM_KERNELS.items()))
    if counts[name] <= 0:
        raise AssertionError(f"{name}: no launch on the LM serving path")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], **kstats}


def bwd_close(tag: str, got, want, mag, dtype, one_key: bool = False) -> dict:
    """dq, dk and dv against the plain version's, each held on its own: a
    relative L2 error of at most 1e-2 (bf16) or 1e-4 (f32), and every
    element within e (mag + |want|) + 1e-4 x the largest rms of the three,
    where mag is the sum of |term| behind the element
    (``flash_attention_bwd_magnitudes``). The kernels round p and ds to
    bf16 before their products as the TPU kernels do, the plain version
    only the result: that costs at most 2^-8 mag, and the two outputs'
    roundings 2^-8 |want| each, so bf16 takes e = 2^-7; f32 sums in another
    order, e = 3e-5. The floor covers gradients that are zero in exact
    arithmetic (a query that sees one key: ds = p (dp - delta) = 0), which
    both versions return as f32 noise; where every query sees one key
    (``one_key``) dq and dk are such noise and are held by no relative
    error. Returns each tensor's max abs and relative L2 error."""
    e, rel_tol = (2.0 ** -7, 1e-2) if dtype == torch.bfloat16 else (3e-5, 1e-4)
    floor = 1e-4 * max(float(w.float().square().mean().sqrt()) for w in want)
    errs = {}
    for name, g, w, m in zip(("dq", "dk", "dv"), got, want, mag):
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"flash_attention_bwd {tag} {name}: non-finite values")
        err = (g - w).abs()
        rel = float((g - w).norm() / w.norm()) if w.norm() > 0 else float(g.norm() > 0)
        limit = e * (m + w.abs()) + floor
        if bool((err > limit).any()):
            i = int((err - limit).argmax())
            raise AssertionError(
                f"flash_attention_bwd {tag} {name}: |error| {float(err.flatten()[i])} over "
                f"{float(limit.flatten()[i])} (want {float(w.flatten()[i])}, sum of |term| "
                f"{float(m.flatten()[i])})")
        if not (one_key and name != "dv") and rel > rel_tol:
            raise AssertionError(f"flash_attention_bwd {tag} {name}: relative L2 error {rel} "
                                 f"over {rel_tol}")
        errs[name] = {"max_abs_err": float(err.max()), "rel_l2_err": rel,
                      "err_over_limit": float((err / limit).max())}
    return errs


def check_flash_bwd(dev, report: dict, arch: str = LM_ARCH, ragged: list = FLASH_RAGGED,
                    suffix: str = "", shape: tuple = (LM_SLOTS, LM_PROMPTS[0])) -> dict:
    """The backward kernels (delta, dq, dk/dv) against their plain version
    (the f32 formulas) at the training shape and the ragged shapes, held by
    ``bwd_close``; two launches bitwise; each shape's route
    (``flash_plan.route``) reported; the gradient reaching wq through
    ``ops.flash_attention`` on the card. Times at the training shape, each
    as a CUDA-event mean and as device time: the whole backward (what the
    plain version and the backward alone of
    ``scaled_dot_product_attention``, on the same inputs made contiguous,
    compute), and each kernel alone beside a bound from its own products
    and bytes and beside the ``ex2`` floor of its p. Returns each kernel's
    stats for the kernels line. ``arch`` gives the training shape's heads
    and ``shape`` its (batch, length); the report's keys take ``suffix``."""
    cfg = lm_configs.get(arch)
    b, s = shape
    cases = [(b, s, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, True, torch.bfloat16, None)]
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    shapes, out = {}, None
    for bq, sq, sk, h, kv, d, causal, dtype, seq_k in cases + ragged:
        q, k, v, do = (torch.randn(shape, generator=gen).to(dev, dtype).transpose(1, 2)
                       for shape in ((bq, sq, h, d), (bq, sk, kv, d), (bq, sk, kv, d),
                                     (bq, sq, h, d)))
        o, lse = flash_attention.flash_attention(q, k, v, causal, seq_k)
        args = (q, k, v, o, lse, do, causal, seq_k)
        g1 = flash_attention.flash_attention_bwd(*args)
        g2 = flash_attention.flash_attention_bwd(*args)
        torch.cuda.synchronize()
        tag = flash_tag(bq, sq, sk, h, kv, d, causal, dtype, seq_k)
        if not all(torch.equal(x, y) for x, y in zip(g1, g2)):
            raise AssertionError(f"flash_attention_bwd {tag}: two launches differ")
        want = flash_attention.flash_attention_bwd_plain(*args)
        mag = flash_attention.flash_attention_bwd_magnitudes(*args)
        errs = bwd_close(tag, g1, want, mag, dtype, one_key=causal and sq == 1)
        shapes[tag] = {key: {n: e[key] for n, e in errs.items()}
                       for key in ("max_abs_err", "rel_l2_err", "err_over_limit")}
        shapes[tag]["route"] = flash_plan.route(dtype, d)
        del want, mag, g1, g2
        if out is None:  # the training shape: times and bounds
            el = q.element_size()
            # Bytes: each input read once, each output written once (q, do,
            # out, dq: B H Sq d; k, v, dk, dv: B KV Sk d; lse, delta: B H Sq
            # f32). Operations: 2d flops a product for every kept (query,
            # key) pair (causal: key <= query), in the bf16 tensor cores. The
            # whole backward needs five products (s, dp, dq, dk, dv); the dq
            # kernel (with the delta pre-pass, which reads out) three (s, dp,
            # ds . k) and the dk/dv kernel four (s^T, dp^T, p^T . do,
            # ds^T . q), taking delta as an input. The delta kernel alone
            # reads out, do and lse and writes delta and lse2 (B H Sq f32
            # each): bound by bytes. Each of dq and dk/dv also recomputes p,
            # one ex2 a kept pair (``ex2_bound_ms``).
            pairs = bq * h * (sq * (sq + 1) // 2 if causal else sq * sk)
            qb, kb, rb = el * bq * h * sq * d, el * bq * kv * sk * d, 4 * bq * h * sq
            work = {"whole": (4 * qb + 4 * kb + rb, 5), "dq": (4 * qb + 2 * kb + rb, 3),
                    "dkv": (2 * qb + 4 * kb + 2 * rb, 4), "delta": (2 * qb + 3 * rb, 0)}
            bounds = {kern: bound(nb, n * 2.0 * d * pairs, PEAK_BF16_S)
                      for kern, (nb, n) in work.items()}
            operands = flash_attention._bwd_operands(q, k, v, o, lse, do, causal, None)
            alone = {kern: event_times(lambda k=kern: flash_attention._launch_bwd(k, operands))
                     for kern in flash_attention.BWD_KERNELS}
            qc, kc, vc = (t.detach().contiguous().requires_grad_() for t in (q, k, v))
            lib_out = torch.nn.functional.scaled_dot_product_attention(
                qc, kc, vc, is_causal=True, enable_gqa=True)
            doc = do.contiguous()
            whole_ms, whole_by = bounds["whole"]
            # SDPA's backward alone, event and device times (the latter
            # filled with the kernels' own by ``kernel_times``).
            lib = event_times(lambda: torch.autograd.grad(
                lib_out, (qc, kc, vc), doc, retain_graph=True), key="library_")
            out = {
                **kernel_times(lambda: flash_attention.flash_attention_bwd(*args)),
                "plain_ms": cuda_ms(lambda: flash_attention.flash_attention_bwd_plain(*args),
                                    reps=3, warmup=1),
                "bound_ms": whole_ms, "bound_by": whole_by, **lib,
                # Each kernel alone (event and device ms, filled above by
                # ``kernel_times``), beside its own bound.
                "kernel_ms": {kern: t["ms"] for kern, t in alone.items()},
                "kernel_device_ms": {kern: t["device_ms"] for kern, t in alone.items()},
                "kernel_bound_ms": {kern: bounds[kern][0] for kern in alone},
                "kernel_bound_by": {kern: bounds[kern][1] for kern in alone},
                "ex2_bound_ms": pairs / PEAK_EX2_S * 1e3,
            }
            shapes[tag].update(out, bytes=work["whole"][0], flops=5 * 2.0 * d * pairs)
            del operands, lib_out, qc, kc, vc
    report["flash_attention_bwd_shapes" + suffix] = shapes

    # The repaired fault: the gradient reaches wq through the flash kernel.
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    x = torch.randn((1, 256, cfg.d_model), generator=g).to(torch.bfloat16)
    ws = [(torch.randn((cfg.d_model, n), generator=g) * cfg.d_model ** -0.5).to(torch.bfloat16)
          for n in (cfg.q_dim, cfg.kv_dim, cfg.kv_dim)]
    grads = []
    for device in ("cpu", dev):
        wq, wk, wv = (w.to(device).requires_grad_() for w in ws)
        xd = x.to(device)
        a = ops.flash_attention((xd @ wq).view(1, 256, cfg.n_heads, cfg.head_dim),
                                (xd @ wk).view(1, 256, cfg.n_kv_heads, cfg.head_dim),
                                (xd @ wv).view(1, 256, cfg.n_kv_heads, cfg.head_dim))
        grads.append(torch.autograd.grad(a.float().square().sum(), wq)[0].float().cpu())
    rel = rel_l2(grads[1], grads[0])
    if not (grads[1].abs().max() > 0 and rel <= 5e-2):
        raise AssertionError(f"wq gradient through the flash kernel: relative L2 error {rel} "
                             "against the CPU route (tolerance 5e-2, bf16)")
    report["flash_wq_grad_rel_err" + suffix] = rel

    # The kernels line: each entry is the whole backward (delta, dq and
    # dk/dv, launched together by every call), so ms, bound, plain and
    # library are one function's; each entry adds its kernel alone (the dq
    # entry's with the delta pre-pass) beside its own bound.
    stats = {}
    outputs = {"dq": ("dq",), "dkv": ("dk", "dv")}
    for name, (kern, _, _) in TRAIN_KERNELS.items():
        pre = ("delta",) if kern == "dq" else ()
        stats[name] = {
            "max_abs_err": max(v["max_abs_err"][o] for v in shapes.values()
                               for o in outputs[kern]),
            **{key: out[key] for key in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "library_device_ms")},
            "kernel_ms": sum(out["kernel_ms"][k] for k in pre + (kern,)),
            "kernel_device_ms": sum(out["kernel_device_ms"][k] for k in pre + (kern,)),
            "kernel_bound_ms": out["kernel_bound_ms"][kern],
            "kernel_bound_by": out["kernel_bound_by"][kern],
            "ex2_bound_ms": out["ex2_bound_ms"]}
    report["flash_attention_bwd" + suffix] = out
    return stats


def param_copy(params: dict) -> list:
    """The parameters' bits on the host, leaf by leaf."""
    return [p.detach().to("cpu", copy=True) for p in tree_leaves(params)]


def same_params(tag: str, params: dict, copy: list) -> None:
    for i, (p, c) in enumerate(zip(tree_leaves(params), copy)):
        if not torch.equal(p.detach().cpu(), c):
            raise AssertionError(f"{tag}: parameter leaf {i} differs")


def train_lm(cfg, opt, batches, accum: int, sample: float, dev, warm_up: int = 0,
             on_step=None, init=None) -> tuple:
    """Seeded weights, then one ``make_train_step`` step a batch; returns
    losses, router aux losses, step ms (host clock after ``synchronize``),
    flash launches a step, peak memory, the parameters, the optimizer
    state, the step and the generator. With ``warm_up`` > 0 the parameters
    after that many steps must be bitwise the initial ones; ``on_step(i,
    params)`` is called after step i. ``init(cfg, gen, device=)`` makes the
    weights (``init_params`` by default)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = (init or init_params)(cfg, gen, device=dev)
    initial = param_copy(params) if warm_up else None
    state = opt.init(params)
    step = make_train_step(cfg, opt, accum=accum, sampling_rate=sample)
    res = {"loss": [], "aux": [], "step_ms": [], "fwd_launches": [], "bwd_launches": []}
    for i, batch in enumerate(batches):
        fwd, bwd = flash_attention.launches, flash_attention.bwd_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch, gen)
        torch.cuda.synchronize()
        res["step_ms"].append(1e3 * (time.perf_counter() - t0))
        res["loss"].append(float(m["loss"]))
        res["aux"].append(float(m["aux"]))
        res["fwd_launches"].append(flash_attention.launches - fwd)
        res["bwd_launches"].append(flash_attention.bwd_launches - bwd)
        if i + 1 == warm_up:
            same_params(f"the parameters after {warm_up} warm-up steps", params, initial)
            res["warm_up_bitwise"] = True
        if on_step is not None:
            on_step(i, params)
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    return res, params, state, step, gen


# The profiler ranges of ``op_ranges``: the SSD chunk loop, the MoE FFN,
# and the chunked attention of whisper's encoder and of the cross layers.
SSD_RANGE = "ssd_scan"
SSD_GROUP = "SSD scan (einsums, exp, cumsum)"
MLSTM_RANGE = "mlstm_chunk_scan"
MLSTM_GROUP = "mLSTM (chunk scan; decode step with its projections)"
SLSTM_RANGE = "slstm_scan"
SLSTM_GROUP = "sLSTM (a step a position; decode step with its projections)"
MOE_RANGE = "moe_ffn"
MOE_GROUP = "router, dispatch and combine"
CHUNKED_RANGE = "chunked_attention"
CHUNKED_GROUP = "chunked attention (encoder, cross)"
REST_GROUP = "elementwise, reductions and copies"
RANGES = (SSD_RANGE, MLSTM_RANGE, SLSTM_RANGE, MOE_RANGE, CHUNKED_RANGE)
# The ranges whose every kernel, GEMMs included, is their group's.
WHOLE_RANGES = {SSD_RANGE: SSD_GROUP, MLSTM_RANGE: MLSTM_GROUP, SLSTM_RANGE: SLSTM_GROUP}
# The host ops of a range's projections (x @ W, and their backward's
# products), whose GEMMs stay in the GEMM group.
PROJECTION_OPS = ("aten::mm", "aten::addmm")


@contextlib.contextmanager
def op_ranges():
    """While it is open, each call of ``models.ssm.ssd_scan`` (the SSD chunk
    loop and its cumsum) runs inside a ``record_function`` range named
    ``SSD_RANGE``, each call of ``models.xlstm._mlstm_chunk_scan`` or
    ``mlstm_decode`` inside one named ``MLSTM_RANGE``, each of
    ``models.xlstm.slstm_scan`` (the sLSTM's loop over positions) or
    ``slstm_decode`` inside one named ``SLSTM_RANGE``, each call of
    ``models.layers.moe_ffn`` (the router, the experts' dispatch, products
    and combine) inside one named ``MOE_RANGE``, and each call of
    ``layers.encoder_attention`` and ``layers.cross_attention`` (plain
    chunked attention, as in the reference) inside one named
    ``CHUNKED_RANGE``; training's recompute included."""
    inner = {(lm_ssm, "ssd_scan"): lm_ssm.ssd_scan,
             (lm_xlstm, "_mlstm_chunk_scan"): lm_xlstm._mlstm_chunk_scan,
             (lm_xlstm, "mlstm_decode"): lm_xlstm.mlstm_decode,
             (lm_xlstm, "slstm_scan"): lm_xlstm.slstm_scan,
             (lm_xlstm, "slstm_decode"): lm_xlstm.slstm_decode,
             (lm_layers, "moe_ffn"): lm_layers.moe_ffn,
             (lm_layers, "encoder_attention"): lm_layers.encoder_attention,
             (lm_layers, "cross_attention"): lm_layers.cross_attention}
    names = {"ssd_scan": SSD_RANGE, "_mlstm_chunk_scan": MLSTM_RANGE,
             "mlstm_decode": MLSTM_RANGE, "slstm_scan": SLSTM_RANGE,
             "slstm_decode": SLSTM_RANGE, "moe_ffn": MOE_RANGE,
             "encoder_attention": CHUNKED_RANGE, "cross_attention": CHUNKED_RANGE}

    def ranged(fn, name):
        def call(*args, **kw):
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return call
    for (mod, attr), fn in inner.items():
        setattr(mod, attr, ranged(fn, names[attr]))
    try:
        yield
    finally:
        for (mod, attr), fn in inner.items():
            setattr(mod, attr, fn)


def kernel_group(name: str) -> str:
    for key in ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_delta", "flash_fwd"):
        if key in name:
            return key
    if any(t in name for t in ("gemm", "nvjet", "cutlass", "sm90_xmma", "cublas")):
        return "cuBLAS GEMMs"
    return REST_GROUP


def range_events(events: list, name: str) -> set:
    """The ids of a trace's host ops (``prof.events()``) that belong to the
    range ``name``: ops inside such a range, and ops under the backward of
    an autograd node whose forward op ran inside one (matched by the node's
    forward thread and sequence number)."""
    def chain(e):
        while e is not None:
            yield e
            e = e.cpu_parent
    forward = {(e.thread, e.sequence_nr) for e in events if e.sequence_nr >= 0
               and e.scope != 1 and any(p.name == name for p in chain(e))}
    return {id(e) for e in events  # scope 1: an autograd node's backward
            if any(p.name == name or (p.scope == 1 and (p.fwd_thread, p.sequence_nr)
                                      in forward) for p in chain(e))}


def device_kernels(prof) -> list:
    """Each device activity of a finished trace once, as (kernel name,
    device ms, the innermost host op that launched it, or None): the
    activities ``device_rows`` sums, each filed under a host op that lists
    it among its kernels. Two kinds of entry in those lists are not
    kernels of the op: a ``record_function`` range lists its own span on
    the device (the ``op_ranges`` ranges are left out), and a kernel an op
    lists beside one of its descendants is that descendant's (the
    innermost op keeps it). An op claims a kernel only while the trace
    holds an activity of that name and duration not yet claimed, so no
    activity is counted twice; what no op claims stays unfiled."""
    cpu = torch.autograd.DeviceType.CPU
    events = list(prof.events())
    left = collections.Counter(
        (k.name, k.self_device_time_total) for k in events
        if k.device_type != cpu and not getattr(k, "is_user_annotation", False)
        and k.name not in RANGES and k.self_device_time_total > 0)

    def depth(e):
        n = 0
        while e.cpu_parent is not None:
            e, n = e.cpu_parent, n + 1
        return n
    out, below = [], {}
    for e in sorted((e for e in events if e.device_type == cpu), key=depth, reverse=True):
        inner = sum((below.get(id(c), collections.Counter()) for c in e.cpu_children),
                    collections.Counter())
        own = collections.Counter(
            (k.name, k.duration) for k in e.kernels if k.name not in RANGES) - inner
        for key, n in own.items():
            n = min(n, left[key])
            left[key] -= n
            out += [(key[0], key[1] / 1e3, e)] * n
        below[id(e)] = inner + own
    return out + [(name, ms / 1e3, None) for (name, ms), n in left.items() for _ in range(n)]


def device_groups(prof) -> dict:
    """Device ms by group of a finished trace, each kernel counted once,
    under the innermost host op that launched it (``device_kernels``): the
    flash kernels by name; then every kernel an op of the SSD range, the
    mLSTM chunk scan's or the sLSTM scan's launched, as its group
    (``WHOLE_RANGES``); then every kernel an op of the chunked
    attention's range launched, as ``CHUNKED_GROUP``, except its
    projections' GEMMs (``PROJECTION_OPS``); then cuBLAS GEMMs by name (the
    experts' and the router's products among them); then every other
    kernel an op of the MoE range launched, as ``MOE_GROUP``; the rest.
    The groups sum to the trace's device total (``device_rows``)."""
    cpu = torch.autograd.DeviceType.CPU
    host = [e for e in prof.events() if e.device_type == cpu]
    whole = {g: range_events(host, r) for r, g in WHOLE_RANGES.items()
             if any(e.name == r for e in host)}
    moe, chunked = (range_events(host, r) for r in (MOE_RANGE, CHUNKED_RANGE))
    groups: dict = {}
    for name, ms, owner in device_kernels(prof):
        g = kernel_group(name)
        where = id(owner) if owner is not None else None
        if not g.startswith("flash"):
            inside = next((w for w, ids in whole.items() if where in ids), None)
            if inside is not None:
                g = inside
            elif where in chunked and owner.name not in PROJECTION_OPS:
                g = CHUNKED_GROUP
            elif where in moe and g == REST_GROUP:
                g = MOE_GROUP
        groups[g] = groups.get(g, 0.0) + ms
    return groups


def range_spans(prof, host: bool = False) -> dict:
    """The spans of the ``op_ranges`` ranges in a finished trace, ms by
    range: on the device (what a sum over the host ops' kernel lists would
    add), or with ``host`` on the host (a checkpointed range counts its
    forward and its recompute)."""
    cpu = torch.autograd.DeviceType.CPU
    out: dict = {}
    for e in prof.events():
        if (e.device_type == cpu) == host and e.name in RANGES:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def groups_cover(tag: str, groups: dict, device_ms: float) -> float:
    """The groups' sum over the profiled device total; fails outside 1%."""
    share = sum(groups.values()) / device_ms
    if abs(share - 1) > 0.01:
        raise AssertionError(f"{tag}: the device groups sum to {sum(groups.values())} ms "
                             f"against a device total of {device_ms} ms")
    return share


def profile_train_step(step, params, state, batch, gen) -> dict:
    """Where a training step's device time goes: ``torch.profiler`` over
    one more step, by kernel name and by group (``device_groups``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with op_ranges(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        step(params, state, batch, gen)
        stop.record()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = device_rows(prof) if profiler_sees_device() else []
    rows.sort(key=lambda r: -r[1])
    dev_ms = sum(r[1] for r in rows) if rows else start.elapsed_time(stop)
    groups = device_groups(prof) if rows else {}
    return {"device_ms": dev_ms, "device_ms_by": "profiler" if rows else "events",
            "wall_ms_profiled": wall, "by_group_ms": groups, "range_spans_ms": range_spans(prof),
            "range_host_ms": range_spans(prof, host=True),
            "groups_over_device": groups_cover("train step", groups, dev_ms) if rows else None,
            "top": [{"name": k[:80], "device_ms": ms, "calls": c} for k, ms, c in rows[:15]]}


# The granite train step's profiles take a step of LM_PROFILE_LAYERS of its
# layers (``profile_cut_step``): the trace's parse grows with its events
# (28.6 s for a whole "dots" step, PERF.md §6) and every layer's are alike.
LM_PROFILE_LAYERS = 4


def profile_cut_step(cfg, recipe, batch, dev, layers: int = LM_PROFILE_LAYERS) -> dict:
    """``profile_step_on`` a step of ``cfg`` cut to ``layers`` layers, with
    seeded weights and a fresh state of ``recipe``, on ``batch``."""
    one = dataclasses.replace(cfg, n_layers=layers)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(one, gen, device=dev)
    state = recipe.init(params)
    prof = profile_step_on(make_train_step(one, recipe, accum=TRAIN_ACCUM), params, state,
                           batch, gen)
    del params, state
    torch.cuda.empty_cache()
    return prof


def profile_step_on(step, params, state, batch, gen) -> dict:
    """``profile_train_step`` on ``batch``, after one unprofiled step on it,
    whose wall time is the busy share's denominator
    (``unprofiled_wall_ms``)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, state, batch, gen)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    profile = profile_train_step(step, params, state, batch, gen)
    profile["device_busy_share"] = busy(profile, profile["device_ms"], wall_ms)
    profile["unprofiled_wall_ms"] = wall_ms
    return profile


def dense_grad_picks(cfg) -> list:
    """The dense gradients ``check_train_grads`` holds: wq, wk, wv and wo over
    all layers, and each MLP leaf of the first and the last layer."""
    last = cfg.n_layers - 1
    return ([(f"attn.{n}", ("layers", "attn", n), ()) for n in ("wq", "wk", "wv", "wo")]
            + [(f"mlp.{n}[{i}]", ("layers", "mlp", n), (i,)) for n in ("wg", "wu", "wd")
               for i in (0, last)])


def hybrid_grad_picks(cfg) -> list:
    """The hybrid gradients ``check_train_grads`` holds: the shared block's
    wq, wk, wv and wo (summed over its calls), and in_proj and out_proj of
    the first and the last Mamba2 layer."""
    g, every, tail = TT.hybrid_layout(cfg)
    last = (("tail",), (tail - 1,)) if tail else (("groups", "mamba"), (g - 1, every - 1))
    return ([(f"shared.attn.{n}", ("shared", "attn", n), ()) for n in ("wq", "wk", "wv", "wo")]
            + [(f"mamba[{i}].{n}", where + (n,), idx) for n in ("in_proj", "out_proj")
               for i, (where, idx) in ((0, (("groups", "mamba"), (0, 0))),
                                       (cfg.n_layers - 1, last))])


def _with_leaves(tree: dict, subs: dict, path: tuple = ()) -> dict:
    """A copy of a nested dict with the leaves at ``subs``' paths replaced."""
    return {k: _with_leaves(v, subs, path + (k,)) if isinstance(v, dict)
            else subs.get(path + (k,), v) for k, v in tree.items()}


def check_train_grads(cfg, batch: dict, dev, picks: list | None = None,
                      other: dict | None = None) -> dict:
    """One full-width microbatch's loss and gradients from the seeded
    initial weights, flash against chunked, of the leaves ``picks`` names
    ((name, path, index) each; ``dense_grad_picks`` by default). Tolerance,
    as for the prefill logits: twice what bf16 costs the chunked path,
    measured against the chunked path in f32 (the same weights upcast; no
    TF32), by relative L2 a leaf; the loss within twice the chunked path's
    own error or twice one bf16 rounding of a token's loss averaged over the
    microbatch's tokens (2^-8 |loss| / sqrt(tokens)), whichever is larger,
    since one number's error may land near zero by chance. ``other`` names
    the config changes of the compared ("chunked") path, as
    ``prefill_against_f32`` takes them."""
    picks = dense_grad_picks(cfg) if picks is None else picks
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, device=dev)
    chunked = dataclasses.replace(cfg, **(other or {"attn_impl": "chunked"}))
    routes = {"flash": cfg, "chunked": chunked,
              "chunked_f32": dataclasses.replace(chunked, dtype="float32")}
    paths = sorted({path for _, path, _ in picks})
    out = {}
    for route, c in routes.items():
        base = to_f32(params) if c.dtype == "float32" else params
        want = {}
        for path in paths:
            t = base
            for k in path:
                t = t[k]
            want[path] = t.detach().requires_grad_()
        loss, _ = forward_train(_with_leaves(base, want), c, batch)
        grads = dict(zip(paths, torch.autograd.grad(loss, [want[x] for x in paths])))
        kept = {name: grads[path][idx].clone() if idx else grads[path]
                for name, path, idx in picks}
        if not (torch.isfinite(loss) and all(torch.isfinite(g).all() for g in kept.values())):
            raise AssertionError(f"train gradients ({route}): non-finite values")
        out[route] = (float(loss.detach()), kept)
        del grads, loss, want, base
    del params
    torch.cuda.empty_cache()
    (lf, gf), (lc, gc), (lr, gr) = out["flash"], out["chunked"], out["chunked_f32"]
    res = {"loss": {"flash": lf, "chunked": lc, "chunked_f32": lr}, "leaves": {}}
    loss_tol = 2 * max(abs(lc - lr), 2.0 ** -8 * abs(lr) / batch["tokens"].numel() ** 0.5)
    if abs(lf - lc) > loss_tol:
        raise AssertionError(f"flash vs chunked training loss: {lf} against {lc}, |diff| over "
                             f"{loss_tol}")
    res["loss"]["tolerance"] = loss_tol
    for name in gf:
        err_c, err_f, diff = rel_l2(gc[name], gr[name]), rel_l2(gf[name], gr[name]), \
            rel_l2(gf[name], gc[name])
        res["leaves"][name] = {"flash_vs_chunked": diff, "tolerance": 2 * err_c,
                               "chunked_vs_f32": err_c, "flash_vs_f32": err_f}
        if not (float(gf[name].abs().max()) > 0 and diff <= 2 * err_c):
            raise AssertionError(f"flash vs chunked gradient of {name}: relative L2 {diff}, "
                                 f"tolerance {2 * err_c} (chunked vs f32 {err_c}, flash vs "
                                 f"f32 {err_f})")
    return res


def check_dots_run(res: dict, full: dict, params: dict, full_params: list, counts: dict,
                   accum: int, n_layers: int) -> None:
    """The gates of a run under remat_policy="dots" against the same run
    under "full": losses and every parameter bitwise, 2 x ``n_layers``
    forward and ``n_layers`` backward flash launches a microbatch (forward
    and recompute), every one on the wgmma routes."""
    if res["loss"] != full["loss"]:
        raise AssertionError(f'remat_policy="dots": losses {res["loss"]} differ from '
                             f'"full"\'s {full["loss"]}')
    same_params('remat_policy="dots" against "full"', params, full_params)
    steps = len(res["loss"])
    want = ([accum * 2 * n_layers] * steps, [accum * n_layers] * steps)
    if (res["fwd_launches"], res["bwd_launches"]) != want:
        raise AssertionError(f'remat_policy="dots": flash launches a step '
                             f"{res['fwd_launches']} forward, {res['bwd_launches']} backward; "
                             f"expected {want[0][0]} and {want[1][0]}")
    if counts["fwd_routes"].get("wgmma") != counts["flash_attention_fwd"] or \
            counts["bwd_routes"].get("wgmma") != counts["flash_attention_bwd"]:
        raise AssertionError(f'remat_policy="dots": flash launches by route {counts}: all '
                             "must be the wgmma kernels'")


def drive_lm_train(dev: torch.device, report: dict) -> list:
    """The LM zoo's training path; returns the backward kernels' entries."""
    t_part, parts = time.perf_counter(), {}

    def lap(name: str) -> None:  # seconds since the last lap, by part
        nonlocal t_part
        parts[name], t_part = time.perf_counter() - t_part, time.perf_counter()
    kstats = check_flash_bwd(dev, report)
    lap("kernel checks")
    print("flash_attention_bwd check (max abs, relative L2 error): " + json.dumps(
        {k: {n: [v["max_abs_err"][n], v["rel_l2_err"][n]] for n in v["max_abs_err"]}
         for k, v in report["flash_attention_bwd_shapes"].items()}), flush=True)
    bw = report["flash_attention_bwd"]
    print(f"flash_attention_bwd at {LM_SLOTS} x {LM_PROMPTS[0]}: whole {bw['ms']:.4f} ms, "
          f"device {bw['device_ms']:.4f} (bound {bw['bound_ms']:.4f}, plain "
          f"{bw['plain_ms']:.1f}, SDPA backward {bw['library_ms']:.4f}, device "
          f"{bw['library_device_ms']:.4f}); alone (event / device ms): " + ", ".join(
              f"{kern} {bw['kernel_ms'][kern]:.4f} / {bw['kernel_device_ms'][kern]:.4f} "
              f"(bound "
              f"{bw['kernel_bound_ms'][kern]:.4f}, {bw['kernel_bound_by'][kern]})"
              for kern in flash_attention.BWD_KERNELS)
          + f"; ex2 {bw['ex2_bound_ms']:.4f} a kernel; routes "
          + json.dumps({tag: v["route"]
                        for tag, v in report["flash_attention_bwd_shapes"].items()})
          + f" [{report.get('nvidia_smi', 'card not queried')}]", flush=True)
    cfg = dataclasses.replace(lm_configs.get(LM_ARCH), attn_impl="flash")
    if not (cfg.remat and cfg.remat_policy == "full"):
        raise AssertionError("the training path runs with per-layer remat")
    b, s = LM_SLOTS, LM_PROMPTS[0]
    batches = list(synthetic_batches(cfg, b, s, TRAIN_STEPS, seed=SEED, device=dev))
    recipe = adamw(cosine_schedule(TRAIN_LR, max(TRAIN_STEPS // 20, 1), TRAIN_STEPS),
                   weight_decay=0.01, max_grad_norm=1.0)
    lr_b = TRAIN_LR * staleness_step_scale(TRAIN_DELAY, TRAIN_RHO)
    delayed = delayed_gradient(adamw(cosine_schedule(lr_b, max(TRAIN_STEPS // 20, 1),
                                                     TRAIN_STEPS),
                                     weight_decay=0.01, max_grad_norm=1.0), TRAIN_DELAY)

    # The main path: run A twice, then run B; only these launches are counted.
    reset_counts()
    runs, copies = [], []
    for _ in range(2):
        res, params, state, step, gen = train_lm(cfg, recipe, batches, TRAIN_ACCUM, 0.0, dev)
        runs.append(res)
        copies.append(param_copy(params))
        if len(runs) == 1:
            del params, state, step, gen
    lap("run A twice")
    del params, state, step, gen
    profile = profile_cut_step(cfg, recipe, batches[-1], dev)
    lap("profile")
    res_b, params, state, _, _ = train_lm(cfg, delayed, batches, 1, TRAIN_SAMPLE, dev,
                                          warm_up=TRAIN_DELAY)
    lap("run B")
    torch.cuda.synchronize()
    counts = {"flash_attention_fwd": flash_attention.launches,
              "flash_attention_bwd": flash_attention.bwd_launches}
    routes = dict(flash_attention.route_launches)
    bwd_routes = dict(flash_attention.bwd_route_launches)
    if routes["wgmma"] != counts["flash_attention_fwd"]:
        raise AssertionError(f"flash forward launches by route {routes}: the training steps' "
                             f"{counts['flash_attention_fwd']} must all be the wgmma kernel's")
    if bwd_routes["wgmma"] != counts["flash_attention_bwd"]:
        raise AssertionError(f"flash backward launches by route {bwd_routes}: the training "
                             f"steps' {counts['flash_attention_bwd']} must all be the wgmma "
                             "kernels'")
    del params, state
    torch.cuda.empty_cache()
    per_mb = {"fwd": 2 * cfg.n_layers, "bwd": cfg.n_layers}  # forward + remat recompute
    # Run A once more under remat_policy="dots", with its own counts: the
    # same kernels in the same order, the layers' mm outputs kept.
    reset_counts()
    res_dots, params, state, step, gen = train_lm(
        dataclasses.replace(cfg, remat_policy="dots"), recipe, batches, TRAIN_ACCUM, 0.0, dev)
    torch.cuda.synchronize()
    dots_counts = {"flash_attention_fwd": flash_attention.launches,
                   "flash_attention_bwd": flash_attention.bwd_launches,
                   "fwd_routes": dict(flash_attention.route_launches),
                   "bwd_routes": dict(flash_attention.bwd_route_launches)}
    check_dots_run(res_dots, runs[0], params, copies[0], dots_counts, TRAIN_ACCUM,
                   cfg.n_layers)
    lap("dots")
    del params, state, step, gen
    dots_profile = profile_cut_step(dataclasses.replace(cfg, remat_policy="dots"), recipe,
                                    batches[-1], dev)
    lap("dots profile")
    # Flash against chunked at full width (after the counts are read): one
    # microbatch of run A, from the initial weights.
    grads = check_train_grads(
        cfg, {k: v[:b // TRAIN_ACCUM] for k, v in batches[0].items()}, dev)
    lap("gradients")

    card = report.get("nvidia_smi", "card not queried")
    tokens = b * s
    summary = {}
    a1, a2 = runs
    for tag, res in (("A", a1), ("A again", a2), ("B", res_b), ("A dots", res_dots)):
        med = float(np.median(res["step_ms"][1:]))
        summary[tag] = {"median_step_ms": med, "tokens_per_s": tokens / med * 1e3,
                        "peak_mem_gb": res["peak_mem_gb"]}
        print(f"train {LM_ARCH} run {tag}: losses " + " ".join(f"{x:.4f}" for x in res["loss"])
              + "; step ms " + " ".join(f"{x:.1f}" for x in res["step_ms"])
              + f"; median (steps 2-{TRAIN_STEPS}) {med:.1f} ms, {tokens / med * 1e3:.0f} "
              f"tokens/s; peak device memory {res['peak_mem_gb']:.2f} GB [{card}]", flush=True)
    # The checks of the main path (after the counts are read).
    if a1["loss"] != a2["loss"]:
        raise AssertionError(f"run A's losses differ across two runs: {a1['loss']}, "
                             f"{a2['loss']}")
    for i, (x, y) in enumerate(zip(*copies)):
        if not torch.equal(x, y):
            raise AssertionError(f"run A's parameter leaf {i} differs across two runs")
    for tag, res in (("run A", a1), ("run B", res_b)):
        loss = res["loss"]
        if not (np.isfinite(loss[-1]) and loss[-1] < loss[0]):
            raise AssertionError(f"{tag}: the loss did not fall: {loss}")
    if not res_b.get("warm_up_bitwise"):
        raise AssertionError("run B's warm-up check did not run")
    for tag, res, accum in (("run A", a1, TRAIN_ACCUM), ("run A again", a2, TRAIN_ACCUM),
                            ("run B", res_b, 1)):
        if res["fwd_launches"] != [accum * per_mb["fwd"]] * TRAIN_STEPS or \
                res["bwd_launches"] != [accum * per_mb["bwd"]] * TRAIN_STEPS:
            raise AssertionError(f"{tag}: flash launches a step {res['fwd_launches']} "
                                 "forward, "
                                 f"{res['bwd_launches']} backward; expected "
                                 f"{accum * per_mb['fwd']} and {accum * per_mb['bwd']}")
    print(f"train {LM_ARCH}: run A bitwise equal across two runs (losses and every "
          f"parameter); run B's parameters after its {TRAIN_DELAY} warm-up steps bitwise the "
          "initial ones; "
          f"flash launches a step: {2 * cfg.n_layers} forward and {cfg.n_layers} backward a "
          f"microbatch; launches by route: forward {routes}, backward {bwd_routes}",
          flush=True)
    worst = max(grads["leaves"].items(), key=lambda kv: kv[1]["flash_vs_chunked"]
                / kv[1]["tolerance"])
    print(f"train {LM_ARCH}: flash vs chunked on one {b // TRAIN_ACCUM} x {s} microbatch: "
          f"loss {grads['loss']['flash']:.6f} / {grads['loss']['chunked']:.6f} (f32 "
          f"{grads['loss']['chunked_f32']:.6f}); gradients of {len(grads['leaves'])} leaves "
          f"within twice the chunked path's own error, closest {worst[0]}: relative L2 "
          f"{worst[1]['flash_vs_chunked']:.4g} against {worst[1]['tolerance']:.4g}",
          flush=True)
    for tag, prof in (("run A", profile), ('run A, remat_policy="dots"', dots_profile)):
        print(f"profile ({LM_ARCH} train step of {LM_PROFILE_LAYERS} of its {cfg.n_layers} "
              f"layers, {tag}): device {prof['device_ms']:.1f} ms "
              f"({prof['device_ms_by']}), busy "
              f"{pct(prof['device_busy_share'])} of an unprofiled step's wall time;"
              " " + ", ".join(f"{k} {v:.1f}" for k, v in prof["by_group_ms"].items())
              + f" [{card}]", flush=True)
    full, dots = summary["A again"], summary["A dots"]
    print(f'train {LM_ARCH} remat_policy="dots" against "full" (run A, accum {TRAIN_ACCUM}): '
          "losses and every parameter bitwise; flash launches a microbatch "
          f"{per_mb['fwd']} forward, {per_mb['bwd']} backward, all wgmma; median step "
          f"{dots['median_step_ms']:.1f} / {full['median_step_ms']:.1f} ms, "
          f"{dots['tokens_per_s']:.0f} / {full['tokens_per_s']:.0f} tokens/s, peak device "
          f"memory {dots['peak_mem_gb']:.2f} / {full['peak_mem_gb']:.2f} GB, profiled device "
          f"{dots_profile['device_ms']:.1f} / {profile['device_ms']:.1f} ms [{card}]",
          flush=True)
    report["lm_train"] = {
        "phase_s_by_part": parts,
        "config": {"arch": LM_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                   "dtype": cfg.dtype, "attn_impl": cfg.attn_impl, "remat": cfg.remat,
                   "batch": b, "seq": s, "steps": TRAIN_STEPS, "lr": TRAIN_LR,
                   "accum_run_a": TRAIN_ACCUM, "delay_run_b": TRAIN_DELAY,
                   "lr_run_b": lr_b, "sample_run_b": TRAIN_SAMPLE},
        "run_a": a1, "run_a_again": a2, "run_b": res_b, "run_a_dots": res_dots,
        "summary": summary, "dots_launches": dots_counts, "dots_profile": dots_profile,
        "launches": counts, "launches_by_route": routes, "bwd_launches_by_route": bwd_routes,
        "profile": profile,
        "flash_vs_chunked": grads,
    }
    line = []
    for name, (_, source, replaces) in TRAIN_KERNELS.items():
        if counts["flash_attention_bwd"] <= 0:
            raise AssertionError(f"{name}: no launch on the LM training path")
        line.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": counts["flash_attention_bwd"], **kstats[name]})
    return line


def markov_documents(vocab: int, lengths, rng: np.random.Generator) -> list:
    """Documents of the given lengths from one seeded bigram chain (four
    likely successors a token, 10% noise, tokens 1..vocab-1: 0 is the pad),
    so the loss has something to learn, as ``synthetic_batches``' has."""
    nxt = rng.integers(1, vocab, size=(vocab, 4))
    docs = []
    for n in lengths:
        doc = np.empty(n, np.int64)
        doc[0] = rng.integers(1, vocab)
        choice, noise = rng.integers(0, 4, n), rng.integers(1, vocab, n)
        mix = rng.random(n) < 0.1
        for t in range(1, n):
            doc[t] = noise[t] if mix[t] else nxt[doc[t - 1], choice[t]]
        docs.append(doc)
    return docs


def packed_batches(vocab: int, batch: int, seq: int, steps: int, dev) -> tuple:
    """``steps`` batches of ``batch`` packed rows of ``seq`` tokens from
    ``TokenPipeline`` (seed SEED), over exactly ``batch * steps`` rows
    packed by ``pack_documents`` from seeded documents with lengths uniform
    on PACKED_DOC_LEN x seq: the last document is cut so that the last row
    keeps a pad tail of PACKED_PAD x seq. Returns (batches on ``dev``,
    {"documents", "lengths", "rows", "pad_tokens", "split_documents"})."""
    rng = np.random.default_rng(SEED)
    lo, hi = (int(f * seq) for f in PACKED_DOC_LEN)
    room = batch * steps * (seq + 1) - int(PACKED_PAD * seq)
    lengths = []
    while sum(lengths) < room:
        lengths.append(int(rng.integers(lo, hi + 1)))
    lengths[-1] -= sum(lengths) - room
    tokens, segments = pack_documents(markov_documents(vocab, lengths, rng), seq + 1)
    if tokens.shape[0] != batch * steps:
        raise AssertionError(f"packed {tokens.shape[0]} rows, expected {batch * steps}")
    pipe = TokenPipeline(tokens, batch_size=batch, seed=SEED, segments=segments)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in pipe.batch_at(i).items()}
               for i in range(steps)]
    # a document that runs on into the next row starts that row as segment 1
    split = int(sum(1 for r in range(1, len(segments))
                    if segments[r - 1, -1] > 0 and segments[r, 0] == 1))
    return batches, {"documents": len(lengths), "lengths": [min(lengths), max(lengths)],
                     "rows": int(tokens.shape[0]), "split_documents": split,
                     "pad_tokens": int((segments[:, :-1] == 0).sum())}


def check_packed_runs(runs: list, counts: dict, falls: bool = True) -> None:
    """The gates of the packed runs: losses bitwise across the two (their
    parameters are compared as they are made), every loss finite, the loss
    falling (unless not ``falls``), and no flash launch in any packed step."""
    first, second = runs
    if first["loss"] != second["loss"]:
        raise AssertionError(f"packed runs: losses differ across two runs: {first['loss']}, "
                             f"{second['loss']}")
    loss = first["loss"]
    if not (all(np.isfinite(loss)) and (loss[-1] < loss[0] or not falls)):
        raise AssertionError(f"packed runs: the loss did not fall or is not finite: {loss}")
    launched = [(r["fwd_launches"], r["bwd_launches"]) for r in runs]
    if any(n for fwd, bwd in launched for n in fwd + bwd) or any(counts.values()):
        raise AssertionError(f"packed runs launched flash ({counts}; forward, backward a "
                             f"step: {launched}): packed rows take the chunked attention")


def check_packed_grads(cfg, params: dict, batch: dict) -> dict:
    """Loss and every gradient of one packed microbatch that holds a pad
    tail must be finite (a pad query's softmax row is all -inf)."""
    if not bool((batch["segments"] == 0).any()):
        raise AssertionError("the packed microbatch checked holds no pad tail")
    tree = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(tree)
    loss, _ = forward_train(tree, cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    bad = [i for i, g in enumerate(grads) if not bool(torch.isfinite(g).all())]
    if not bool(torch.isfinite(loss)) or bad:
        raise AssertionError(f"packed microbatch with a pad tail: loss {float(loss)}, "
                             f"non-finite gradients in leaves {bad}")
    return {"loss": float(loss.detach()), "leaves": len(grads),
            "pad_tokens": int((batch["segments"] == 0).sum())}


def check_packed_isolation(cfg, params: dict, docs: tuple, dev) -> dict:
    """Two documents packed in one row (segments 1 and 2) against each in a
    row of its own: each document's logits (bf16, chunked attention, the
    route of packed rows) packed and alone, both against the f32 forward of
    it alone (the same weights upcast). The packed error must be within
    twice the lone row's own bf16 error, by relative L2 over the vocab."""
    chunked = dataclasses.replace(cfg, attn_impl="chunked", remat=False)
    f32 = dataclasses.replace(chunked, dtype="float32")
    d1, d2 = (torch.as_tensor(d, device=dev) for d in docs)
    row = torch.cat([d1, d2])[None]
    segments = torch.cat([torch.ones_like(d1), torch.full_like(d2, 2)])[None].int()

    @torch.no_grad()
    def logits(c, p, tokens, segs=None):
        x = p["embed"][tokens.long()]
        h, _ = TT.backbone_train(p, c, x, segs)
        return TT._logits(p, c, h)[0, :, :c.vocab_size].float()

    packed = logits(chunked, params, row, segments)
    alone = [logits(chunked, params, d[None]) for d in (d1, d2)]
    ref = to_f32(params)
    want = [logits(f32, ref, d[None]) for d in (d1, d2)]
    del ref
    out = {}
    for k, (part, own, w) in enumerate(zip((packed[:d1.numel()], packed[d1.numel():]),
                                           alone, want), 1):
        err_packed, err_alone = rel_l2(part, w), rel_l2(own, w)
        out[f"document {k}"] = {"tokens": int(w.shape[0]), "packed_vs_f32": err_packed,
                                "alone_vs_f32": err_alone, "tolerance": 2 * err_alone}
        if not err_packed <= 2 * err_alone:
            raise AssertionError(f"packed isolation, document {k}: relative L2 {err_packed} "
                                 f"against the f32 lone row, over twice the lone bf16 row's "
                                 f"{err_alone}")
    return out


def drive_lm_packed(dev: torch.device, report: dict, cfg=None, seq: int = LM_PROMPTS[0],
                    batch: int = LM_SLOTS) -> dict:
    """Packed documents through ``data.pipeline`` and ``make_train_step``:
    granite-3-2b at full width (``attn_impl="flash"``), ``batch`` rows of
    ``seq`` tokens a step, the reference recipe at TRAIN_ACCUM, PACKED_STEPS
    steps, twice, with their own launch counts (none may be flash's); then
    a microbatch with a pad tail (``check_packed_grads``) and one row of
    two documents (``check_packed_isolation``)."""
    cfg = cfg or dataclasses.replace(lm_configs.get(LM_ARCH), attn_impl="flash")
    batches, info = packed_batches(cfg.vocab_size, batch, seq, PACKED_STEPS, dev)
    recipe = adamw(cosine_schedule(TRAIN_LR, max(PACKED_STEPS // 20, 1), PACKED_STEPS),
                   weight_decay=0.01, max_grad_norm=1.0)
    # The packed path: two runs; only these launches are counted.
    reset_counts()
    runs, first = [], None
    for _ in range(2):
        res, params, state, _, _ = train_lm(cfg, recipe, batches, TRAIN_ACCUM, 0.0, dev)
        runs.append(res)
        if first is None:
            first = param_copy(params)
        else:
            same_params("packed runs: the second run's parameters", params, first)
        del params, state
    torch.cuda.synchronize()
    counts = {"flash_attention_fwd": flash_attention.launches,
              "flash_attention_bwd": flash_attention.bwd_launches}
    del first
    torch.cuda.empty_cache()
    check_packed_runs(runs, counts)
    # The checks (after the counts are read), from the seeded initial weights.
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    mb = batch // TRAIN_ACCUM
    pad_mb = next({k: v[i:i + mb] for k, v in b.items()} for b in batches
                  for i in range(0, batch, mb) if bool((b["segments"][i:i + mb] == 0).any()))
    grads = check_packed_grads(cfg, params, pad_mb)
    n1 = int(seq * 11 / 32)
    docs = markov_documents(cfg.vocab_size, (n1, seq - n1), np.random.default_rng(SEED + 1))
    isolation = check_packed_isolation(cfg, params, tuple(docs), dev)
    del params
    torch.cuda.empty_cache()
    card = report.get("nvidia_smi", "card not queried")
    tokens = batch * seq
    med = float(np.median(runs[0]["step_ms"][1:]))
    summary = {"median_step_ms": med, "tokens_per_s": tokens / med * 1e3,
               "peak_mem_gb": runs[0]["peak_mem_gb"]}
    print(f"train {LM_ARCH} on packed documents ({info['documents']} documents of "
          f"{info['lengths'][0]}-{info['lengths'][1]} tokens in {info['rows']} rows of "
          f"{seq + 1}, {info['split_documents']} split across rows, {info['pad_tokens']} pad "
          f"tokens; {PACKED_STEPS} steps of {batch} x {seq} at accum {TRAIN_ACCUM}, "
          f"attn_impl flash): losses " + " ".join(f"{x:.4f}" for x in runs[0]["loss"])
          + ", bitwise equal across two runs; step ms "
          + " ".join(f"{x:.1f}" for x in runs[0]["step_ms"])
          + f"; median {med:.1f} ms, {tokens / med * 1e3:.0f} tokens/s; peak device memory "
          f"{runs[0]['peak_mem_gb']:.2f} GB; flash launches {counts} (the chunked attention "
          f"by the reference's rule) [{card}]", flush=True)
    print(f"train {LM_ARCH} packed: a microbatch with {grads['pad_tokens']} pad tokens gives "
          f"a finite loss {grads['loss']:.4f} and {grads['leaves']} finite gradients; "
          "isolation (relative L2 against the f32 lone row, packed / lone bf16): " + ", ".join(
              f"{k} ({v['tokens']} tokens) {v['packed_vs_f32']:.4g} / {v['alone_vs_f32']:.4g}"
              for k, v in isolation.items()), flush=True)
    report["lm_packed"] = {
        "config": {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                   "dtype": cfg.dtype, "attn_impl": cfg.attn_impl, "batch": batch,
                   "seq": seq, "steps": PACKED_STEPS, "accum": TRAIN_ACCUM, "lr": TRAIN_LR},
        "data": info, "runs": runs, "summary": summary, "launches": counts,
        "pad_microbatch": grads, "isolation": isolation,
    }
    return report["lm_packed"]


def decode_drift(cfg, params: dict, prompts: np.ndarray, served: np.ndarray | None,
                 dev, media: torch.Tensor | None = None, new: int | None = None,
                 max_len: int | None = None) -> dict:
    """One wave's greedy decode with each step's logits (the engine's path:
    the flash prefill, then the caches written in place a step: the ring,
    and a hybrid model's SSM and conv states), held against the f32
    teacher-forced forward of the same tokens at each position: a step's
    largest |logit error| must stay within twice that of the bf16
    teacher-forced forward (chunked attention) at that position, which
    catches a drift of the caches. The tokens must be the engine's
    (``served``, unless None). A hybrid model's teacher-forced forwards take
    the largest SSM chunk up to ``cfg.ssm_chunk`` that divides their length
    (prompt + new tokens - 1). For an MoE model each step's error is taken
    over the rows that the decode and the f32 forward route alike at that
    position (``route_agreement``). A VLM or audio model reads ``media``
    (B, M, D), cast to each path's dtype. An xLSTM model's decode rounds
    its carries (C, n, c, h) to bf16 every token and the chunked forward
    once a chunk, so their errors at a step are independent draws of bf16
    noise (the reference's decode parts from its forward the same way);
    its steps are held to twice the bf16 forward's largest error over the
    steps, far below what a carry left unwritten costs. ``new`` and
    ``max_len`` are LM_NEW and LM_MAX_LEN unless given."""
    new, max_len = new or LM_NEW, max_len or LM_MAX_LEN
    toks = torch.as_tensor(prompts, device=dev)
    b, plen = toks.shape
    batch = {"tokens": toks} if media is None else {"tokens": toks, "media": media}
    with recorded_routes() as calls:
        tok, logits, cache = make_prefill_step(cfg, max_len=max_len)(params, batch)
        routes = [last_routes(calls, b)]
        steps, gen = [logits], [tok]
        for _ in range(new - 1):
            calls.clear()
            logits, cache = TT.decode_step(params, cfg, tok[:, None], cache)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            steps.append(logits)
            gen.append(tok)
            routes.append(last_routes(calls, b))
    gen = torch.stack(gen, dim=1)
    if served is not None and not np.array_equal(gen.cpu().numpy(), served):
        raise AssertionError(f"{cfg.name}: the stepped decode serves other tokens than the engine")
    del cache
    full = torch.cat([toks, gen[:, :-1]], dim=1)
    n = full.shape[1]
    chunk = max(c for c in range(1, cfg.ssm_chunk + 1) if n % c == 0)
    vocab = slice(0, cfg.vocab_size)
    tf = {}
    for name, dtype in (("bf16", cfg.dtype), ("f32", "float32")):
        c = dataclasses.replace(cfg, attn_impl="chunked", ssm_chunk=chunk, dtype=dtype,
                                remat=False)
        p = params if dtype == cfg.dtype else to_f32(params)
        m = None if media is None else media.to(getattr(torch, dtype))
        with torch.inference_mode(), recorded_routes() as calls:
            h, _ = TT.backbone_train(p, c, p["embed"][full.long()], media=m)
            tf[name] = TT._logits(p, c, h[:, plen - 1:])[..., vocab].float()
        del p, h
    tf_routes = (torch.stack([x.reshape(b, n, -1)[:, plen - 1:] for x in calls], dim=2)
                 if calls else None)  # (B, steps, layers, k)
    dec_routes = torch.stack(routes, dim=1) if routes[0] is not None else None
    pairs = route_agreement(f"{cfg.name} decode", [dec_routes, tf_routes],
                            (b, new)).to(dev)
    dec = torch.stack(steps, dim=1)[..., vocab].float()
    if not all(torch.isfinite(x).all() for x in (dec, *tf.values())):
        raise AssertionError(f"{cfg.name}: non-finite decode or teacher-forced logits")
    # Errors by step over the rows routed alike (0 where none is).
    err_dec = torch.where(pairs, (dec - tf["f32"]).abs().amax(dim=2), 0).amax(dim=0)
    err_bf16 = torch.where(pairs, (tf["bf16"] - tf["f32"]).abs().amax(dim=2), 0).amax(dim=0)
    scale = err_bf16.amax().expand_as(err_bf16) if cfg.family == "ssm" else err_bf16
    over = (err_dec > 2 * scale).nonzero().flatten().tolist()
    if over:
        raise AssertionError(
            f"{cfg.name}: decode logits drift from the f32 teacher-forced forward at steps "
            f"{over}: {[float(err_dec[i]) for i in over]} against twice the bf16 forward's "
            f"{[2 * float(scale[i]) for i in over]}")
    kept = pairs.any(dim=0)
    return {"steps": new, "teacher_forced_ssm_chunk": chunk,
            "decode_vs_f32": err_dec.tolist(), "bf16_forward_vs_f32": err_bf16.tolist(),
            "pairs_compared": int(pairs.sum()), "pairs": pairs.numel(),
            "limit_by": "largest over the steps" if cfg.family == "ssm" else "step",
            "worst_ratio": float((err_dec[kept] / scale[kept]).max()),
            "worst_step_ratio": float((err_dec[kept] / err_bf16[kept]).max())}


def f32_leaves(params: dict) -> list:
    """The paths of a hybrid tree's a_log and dt_bias leaves that are not f32."""
    trees = {"groups.mamba": params["groups"]["mamba"], "tail": params.get("tail", {})}
    return [f"{k}.{n}" for k, t in trees.items() for n in ("a_log", "dt_bias")
            if n in t and t[n].dtype != torch.float32]


def drive_hybrid(dev: torch.device, report: dict) -> list:
    """The hybrid family's serving and training paths (zamba2-1.2b at full
    width); returns its kernels' entries (the flash kernels at the shared
    block's shape)."""
    t_phase = time.perf_counter()
    parts: dict = {}

    def lap(name: str) -> None:  # seconds since the last lap, by part
        parts[name] = time.perf_counter() - t_phase - sum(parts.values())
    card = report.get("nvidia_smi", "card not queried")
    fwd = check_flash(dev, report, HYBRID_ARCH, [], "_zamba2")
    bwd = check_flash_bwd(dev, report, HYBRID_ARCH, [], "_zamba2")
    lap("kernel checks")
    fs = next(iter(report["flash_attention_shapes_zamba2"].values()))
    bw = report["flash_attention_bwd_zamba2"]
    print(f"flash_attention at zamba2's {LM_SLOTS} x {LM_PROMPTS[0]} h32/32 ({fs['route']}): "
          f"max abs error {fs['max_abs_err']:.4g}, relative L2 {fs['rel_l2_err']}; "
          f"{fwd['ms']:.4f} ms, device {fwd['device_ms']:.4f} (bound {fwd['bound_ms']:.4f}); "
          f"SDPA ({fs['library_backend']['backend']}) {fwd['library_ms']:.4f} ms, device "
          f"{fwd['library_device_ms']:.4f}; backward whole {bw['ms']:.4f} ms, device "
          f"{bw['device_ms']:.4f} (bound {bw['bound_ms']:.4f}, SDPA backward "
          f"{bw['library_ms']:.4f}, device {bw['library_device_ms']:.4f}); alone (event / "
          "device ms): " + ", ".join(
              f"{k} {bw['kernel_ms'][k]:.4f} / {bw['kernel_device_ms'][k]:.4f} (bound "
              f"{bw['kernel_bound_ms'][k]:.4f})" for k in flash_attention.BWD_KERNELS)
          + f"; errors " + json.dumps({k: {n: [v["max_abs_err"][n], v["rel_l2_err"][n]]
                                          for n in v["max_abs_err"]}
                                      for k, v in report[
                                          "flash_attention_bwd_shapes_zamba2"].items()})
          + f" [{card}]", flush=True)

    # Serving: two waves, twice; only these launches are counted.
    cfg = dataclasses.replace(lm_configs.get(HYBRID_ARCH), attn_impl="flash")
    g, every, tail = TT.hybrid_layout(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, device=dev)
    n_params = count_params(params)
    if f32_leaves(params):
        raise AssertionError(f"{HYBRID_ARCH}: leaves not f32 at init: {f32_leaves(params)}")
    engine = ServingEngine(cfg, params, slots=LM_SLOTS, max_len=LM_MAX_LEN, device=dev)
    requests = lm_requests(cfg, np.random.default_rng(SEED))
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    runs = [serve_lm(engine, requests) for _ in range(2)]
    torch.cuda.synchronize()
    serve_launches = flash_attention.launches
    routes = dict(flash_attention.route_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if routes["wgmma"] != serve_launches:
        raise AssertionError(f"{HYBRID_ARCH}: flash launches by route {routes}: all "
                             f"{serve_launches} must be the wgmma kernel's")
    check_lm_waves(HYBRID_ARCH, cfg, runs, requests, g)  # one a call of the shared block
    lap("serve")
    prompts = np.stack([r.prompt for r in requests[:LM_SLOTS]])
    vs = prefill_against_f32(cfg, params, {"tokens": torch.as_tensor(prompts, device=dev)})
    drift = decode_drift(cfg, params, prompts,
                         np.stack([c.tokens for c in runs[0][0][:LM_SLOTS]]), dev)
    waves = lm_wave_stats(runs)
    prefill_ms, decode_ms_tok, tok_s = (waves[k] for k in (
        "prefill_ms_per_wave", "decode_ms_per_token", "tokens_per_s_per_wave"))
    lap("serve checks")
    serve_profile = profile_lm(engine, requests, steps=2)
    lap("serve profile")
    del engine, params
    torch.cuda.empty_cache()
    for i, p in enumerate(LM_PROMPTS):
        print(f"serve {HYBRID_ARCH} ({cfg.n_layers} Mamba2 layers, {g} shared-block calls, "
              f"d_model {cfg.d_model}, {cfg.dtype}, {cfg.attn_impl}, {n_params / 1e9:.3f} B "
              f"parameters) wave {LM_SLOTS} x {p}: prefill "
              + " / ".join(f"{prefill_ms[r * len(LM_PROMPTS) + i]:.1f}" for r in range(2))
              + " ms, decode " + " / ".join(
                  f"{decode_ms_tok[r * len(LM_PROMPTS) + i]:.2f}" for r in range(2))
              + " ms a token, " + " / ".join(
                  f"{tok_s[r * len(LM_PROMPTS) + i]:.1f}" for r in range(2))
              + f" generated tokens/s (two runs) [{card}]", flush=True)
    print(f"serve {HYBRID_ARCH}: flash launches {serve_launches} ({g} a wave, by route {routes}); "
          f"tokens equal across two runs; prefill logits bitwise across runs: "
          f"{vs['bitwise_across_runs']}; flash vs chunked max |diff| {vs['max_abs_diff']:.4g} "
          f"(tolerance {vs['tolerance']:.4g}; against f32: chunked {vs['chunked_vs_f32']:.4g}, "
          f"flash {vs['flash_vs_f32']:.4g}); decode vs the f32 teacher-forced forward over "
          f"{LM_NEW} steps: worst {drift['worst_ratio']:.3f} of the bf16 forward's own error "
          f"(limit 2; teacher-forced SSM chunk {drift['teacher_forced_ssm_chunk']}); peak "
          f"device memory {peak_gb:.2f} GB [{card}]", flush=True)
    for phase, prof in serve_profile.items():
        print(f"profile ({HYBRID_ARCH} {phase}): device {prof['device_ms']:.2f} ms a "
              f"{'wave' if phase == 'prefill' else 'step'} ({prof['device_ms_by']}), busy "
              f"{pct(prof['device_busy_share'])}; " + ", ".join(
                  f"{k} {v:.2f}" for k, v in prof["by_group_ms"].items()) + f" [{card}]",
              flush=True)

    # Training: run A's recipe twice; only these launches are counted.
    b, s = LM_SLOTS, LM_PROMPTS[0]
    batches = list(synthetic_batches(cfg, b, s, TRAIN_STEPS, seed=SEED, device=dev))
    recipe = adamw(cosine_schedule(TRAIN_LR, max(TRAIN_STEPS // 20, 1), TRAIN_STEPS),
                   weight_decay=0.01, max_grad_norm=1.0)
    reset_counts()
    trains, copies = [], []
    for _ in range(2):
        res, params, state, step, gen = train_lm(cfg, recipe, batches, TRAIN_ACCUM, 0.0, dev)
        trains.append(res)
        copies.append(param_copy(params))
        if len(trains) == 1:
            del params, state, step, gen
    torch.cuda.synchronize()
    lap("train")
    train_counts = {"fwd": flash_attention.launches, "bwd": flash_attention.bwd_launches}
    train_routes = {"fwd": dict(flash_attention.route_launches),
                    "bwd": dict(flash_attention.bwd_route_launches)}
    if f32_leaves(params):
        raise AssertionError(f"{HYBRID_ARCH}: leaves not f32 after training: "
                             f"{f32_leaves(params)}")
    bad_moments = [i for i, m in enumerate(tree_leaves(state[-1].mu))
                   if m.dtype != torch.float32] if hasattr(state[-1], "mu") else []
    del params, state, step, gen
    torch.cuda.empty_cache()
    # The profile: one group's step (its Mamba2 layers and the shared
    # block) on the last batch's rows cut to HYBRID_PROFILE_SEQ tokens.
    one = dataclasses.replace(cfg, n_layers=every)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(one, gen, device=dev)
    state = recipe.init(params)
    profile = profile_step_on(make_train_step(one, recipe, accum=TRAIN_ACCUM), params, state,
                              {k: v[:, :HYBRID_PROFILE_SEQ] for k, v in batches[-1].items()},
                              gen)
    lap("train profile")
    del params, state, gen
    torch.cuda.empty_cache()
    a1, a2 = trains
    per_mb = {"fwd": 2 * g, "bwd": g}  # forward + the group's remat recompute
    check_lm_runs(f"{HYBRID_ARCH} run A", trains, copies, g, TRAIN_ACCUM, aux_max=0)
    if bad_moments:
        raise AssertionError(f"{HYBRID_ARCH}: AdamW moments not f32: leaves {bad_moments}")
    for kind in ("fwd", "bwd"):
        if train_routes[kind]["wgmma"] != train_counts[kind]:
            raise AssertionError(f"{HYBRID_ARCH}: flash {kind} launches by route "
                                 f"{train_routes[kind]}: all must be the wgmma kernels'")
    grads = check_train_grads(cfg, {k: v[:b // TRAIN_ACCUM] for k, v in batches[0].items()},
                              dev, hybrid_grad_picks(cfg))
    lap("train gradients")
    del copies
    torch.cuda.empty_cache()
    tokens = b * s
    summary = {}
    for tag, res in (("A", a1), ("A again", a2)):
        med = float(np.median(res["step_ms"][1:]))
        summary[tag] = {"median_step_ms": med, "tokens_per_s": tokens / med * 1e3,
                        "peak_mem_gb": res["peak_mem_gb"]}
        print(f"train {HYBRID_ARCH} run {tag}: losses " + " ".join(
            f"{x:.4f}" for x in res["loss"]) + "; step ms " + " ".join(
            f"{x:.1f}" for x in res["step_ms"]) + f"; median (steps 2-{TRAIN_STEPS}) "
            f"{med:.1f} ms, {tokens / med * 1e3:.0f} tokens/s; peak device memory "
            f"{res['peak_mem_gb']:.2f} GB [{card}]", flush=True)
    worst = max(grads["leaves"].items(), key=lambda kv: kv[1]["flash_vs_chunked"]
                / kv[1]["tolerance"])
    phase_s = time.perf_counter() - t_phase
    print(f"train {HYBRID_ARCH}: bitwise equal across two runs (losses and every parameter); "
          f"a_log and dt_bias f32 after the steps; flash launches a microbatch: "
          f"{per_mb['fwd']} forward and {per_mb['bwd']} backward (routes {train_routes}); "
          f"flash vs chunked on one {b // TRAIN_ACCUM} x {s} microbatch: loss "
          f"{grads['loss']['flash']:.6f} / {grads['loss']['chunked']:.6f} (f32 "
          f"{grads['loss']['chunked_f32']:.6f}); {len(grads['leaves'])} gradients within "
          f"twice the chunked path's own error, closest {worst[0]}: relative L2 "
          f"{worst[1]['flash_vs_chunked']:.4g} against {worst[1]['tolerance']:.4g}", flush=True)
    print(f"profile ({HYBRID_ARCH} train step of one group, {every} Mamba2 layers and the "
          f"shared block, {b} x {HYBRID_PROFILE_SEQ}): device "
          f"{profile['device_ms']:.1f} ms ({profile['device_ms_by']}), busy "
          f"{pct(profile['device_busy_share'])} of an unprofiled step's wall time "
          f"({profile['unprofiled_wall_ms']:.1f} ms); " + ", ".join(
              f"{k} {v:.1f}" for k, v in profile["by_group_ms"].items())
          + f"; the hybrid phase took {phase_s:.1f} s (" + ", ".join(
              f"{k} {v:.1f}" for k, v in parts.items()) + f") [{card}]", flush=True)
    report["hybrid"] = {
        "config": {"arch": HYBRID_ARCH, "n_layers": cfg.n_layers, "groups": g,
                   "every": every, "tail": tail, "d_model": cfg.d_model,
                   "ssm_heads": cfg.ssm_heads, "ssm_state": cfg.ssm_state,
                   "ssm_chunk": cfg.ssm_chunk, "n_heads": cfg.n_heads,
                   "n_kv_heads": cfg.n_kv_heads, "dtype": cfg.dtype,
                   "attn_impl": cfg.attn_impl, "params": n_params, "batch": b, "seq": s,
                   "steps": TRAIN_STEPS, "accum": TRAIN_ACCUM, "lr": TRAIN_LR},
        "serve": {"waves": [f"{LM_SLOTS} x {p}" for p in LM_PROMPTS], "new_tokens": LM_NEW,
                  "prefill_ms_per_wave": prefill_ms, "decode_ms_per_token": decode_ms_tok,
                  "tokens_per_s_per_wave": tok_s, "peak_mem_gb": peak_gb,
                  "flash_launches": serve_launches, "launches_by_route": routes,
                  "flash_vs_chunked": vs, "decode_drift": drift, "profile": serve_profile},
        "train": {"run_a": a1, "run_a_again": a2, "summary": summary,
                  "launches": train_counts, "launches_by_route": train_routes,
                  "profile": profile, "flash_vs_chunked": grads},
        "phase_s": phase_s, "phase_s_by_part": parts,
    }
    launches = {"flash_attention_zamba2": serve_launches,
                "flash_attention_bwd_dq_zamba2": train_counts["bwd"],
                "flash_attention_bwd_dkv_zamba2": train_counts["bwd"]}
    stats = {"flash_attention_zamba2": fwd,
             "flash_attention_bwd_dq_zamba2": bwd["flash_attention_bwd_dq"],
             "flash_attention_bwd_dkv_zamba2": bwd["flash_attention_bwd_dkv"]}
    return family_line(HYBRID_KERNELS, launches, stats, "hybrid")


def lm_wave_stats(runs: list, slots: int | None = None, prompts: tuple | None = None,
                  new: int | None = None) -> dict:
    """Prefill ms a wave, decode ms a token and generated tokens/s of each
    wave of ``serve_lm``'s runs, in run order (waves of LM_SLOTS requests,
    LM_PROMPTS' lengths, LM_NEW tokens, unless given)."""
    slots, prompts, new = slots or LM_SLOTS, prompts or LM_PROMPTS, new or LM_NEW
    firsts = [outs[i * slots] for outs, _ in runs for i in range(len(prompts))]
    return {"prefill_ms_per_wave": [1e3 * c.prefill_s for c in firsts],
            "decode_ms_per_token": [1e3 * c.decode_s / (new - 1) for c in firsts],
            "tokens_per_s_per_wave": [slots * new / (c.prefill_s + c.decode_s)
                                      for c in firsts]}


def check_lm_waves(tag: str, cfg, runs: list, requests: list, per_wave: int) -> None:
    """The gates of ``serve_lm``'s runs: ``per_wave`` flash launches a
    wave's prefill, every request answered with its budget of in-vocab
    tokens, and the second run's tokens the first's."""
    waves = len({len(r.prompt) for r in requests})
    for outs, launched in runs:
        if launched != [per_wave] * waves:
            raise AssertionError(f"{tag}: flash launches per wave {launched}, expected "
                                 f"{per_wave}")
        if [c.uid for c in outs] != [r.uid for r in requests]:
            raise AssertionError(f"{tag}: not every request was answered")
        for c, r in zip(outs, requests):
            if c.tokens.shape != (r.max_new_tokens,) or not (
                    (c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all():
                raise AssertionError(f"{tag} request {c.uid}: tokens {c.tokens}")
    for a, b in zip(*(outs for outs, _ in runs)):
        if not np.array_equal(a.tokens, b.tokens):
            raise AssertionError(f"{tag} request {a.uid}: the second run served other tokens")


def check_lm_runs(tag: str, runs: list, copies: list, n_attn: int, accum: int,
                  aux_max: float) -> None:
    """The gates of two LM training runs from the same seed: losses and
    every parameter bitwise across the two, the loss falling, each step's
    router aux finite and in (0, aux_max] (0 itself where ``aux_max`` is 0:
    no router), and 2 x ``n_attn`` forward (forward and remat recompute)
    and ``n_attn`` backward flash launches a microbatch."""
    first, second = runs
    if first["loss"] != second["loss"]:
        raise AssertionError(f"{tag}: losses differ across two runs: {first['loss']}, "
                             f"{second['loss']}")
    for i, (x, y) in enumerate(zip(*copies)):
        if not torch.equal(x, y):
            raise AssertionError(f"{tag}: parameter leaf {i} differs across two runs")
    loss = first["loss"]
    if not (np.isfinite(loss[-1]) and loss[-1] < loss[0]):
        raise AssertionError(f"{tag}: the loss did not fall: {loss}")
    if not all(a == 0 if aux_max == 0 else np.isfinite(a) and 0 < a <= aux_max
               for a in first["aux"]):
        raise AssertionError(f"{tag}: router aux {first['aux']} outside (0, {aux_max}]")
    steps = len(loss)
    want = ([accum * 2 * n_attn] * steps, [accum * n_attn] * steps)
    for res in runs:
        if (res["fwd_launches"], res["bwd_launches"]) != want:
            raise AssertionError(f"{tag}: flash launches a step {res['fwd_launches']} forward, "
                                 f"{res['bwd_launches']} backward; expected {want[0][0]} and "
                                 f"{want[1][0]}")


def check_router_grads(cfg, params: dict, batch: dict) -> dict:
    """One microbatch's loss and router gradient from ``params``: every
    layer's wr gets a finite, non-zero gradient (through the combine
    weights and the aux loss)."""
    tree = tree_map(lambda p: p.detach(), params)
    wr = tree["layers"]["moe"]["wr"].requires_grad_()
    loss, m = forward_train(tree, cfg, batch)
    g = torch.autograd.grad(loss, [wr], allow_unused=True)[0] if loss.requires_grad else None
    g = torch.zeros_like(wr) if g is None else g
    norms = [float(g[i].float().norm()) for i in range(cfg.n_layers)]
    if not (bool(torch.isfinite(g).all()) and all(n > 0 for n in norms)):
        raise AssertionError(f"router gradients: per-layer norms {norms}, finite "
                             f"{bool(torch.isfinite(g).all())}")
    return {"loss": float(loss.detach()), "aux": float(m["aux"].detach()),
            "wr_grad_norm_by_layer": norms}


def moe_inputs(cfg, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Layer 0's FFN input (B x S, D) for ``tokens``: the embedded tokens
    after layer 0's attention, normed, as ``_moe_block`` makes it."""
    p = TT.layer(params["layers"], 0)
    with torch.inference_mode():
        x = params["embed"][tokens.long()]
        x = x + lm_layers.self_attention_train(p["attn"], lm_layers.rms_norm(x, p["ln1"]), cfg,
                                               tokens.shape[1])
        return lm_layers.rms_norm(x, p["ln2"]).reshape(-1, cfg.d_model)


def check_moe_dispatch(cfg, ids: torch.Tensor, weights: torch.Tensor, capacity: int,
                       dev) -> dict:
    """Every expert's dispatch (``layers.expert_dispatch``, what
    ``moe_ffn`` runs) and combine weights from the same ids and weights on
    ``dev`` and on the CPU, bit for bit; returns the tokens each expert
    kept and dropped."""
    got = lm_layers.expert_dispatch(ids.to(dev), weights.to(dev), cfg.n_experts, capacity)
    want = lm_layers.expert_dispatch(ids.cpu(), weights.cpu(), cfg.n_experts, capacity)
    kept, dropped = [], []
    for e in range(cfg.n_experts):
        for name, g, w in zip(("dispatch", "combine weights"), got, want):
            if not torch.equal(g[e].cpu(), w[e]):
                raise AssertionError(f"expert {e}: the {name} on {dev} differ from the CPU's")
        kept.append(int((want[0][e] < ids.shape[0]).sum()))
        dropped.append(int((ids.cpu() == e).any(1).sum()) - kept[-1])
    return {"capacity": capacity, "tokens": int(ids.shape[0]), "kept": kept,
            "dropped": dropped}


def drive_moe(dev: torch.device, report: dict) -> list:
    """The MoE family's serving and training paths (phi3.5-moe-42b at full
    width); returns its kernels' entries (the flash kernels at its shape)."""
    t_phase = time.perf_counter()
    parts: dict = {}

    def lap(name: str) -> None:  # seconds since the last lap, by part
        parts[name] = time.perf_counter() - t_phase - sum(parts.values())
    card = report.get("nvidia_smi", "card not queried")
    fwd = check_flash(dev, report, MOE_ARCH, [], "_phi35")
    bwd = check_flash_bwd(dev, report, MOE_ARCH, [], "_phi35")
    lap("kernel checks")
    fs = next(iter(report["flash_attention_shapes_phi35"].values()))
    bw = report["flash_attention_bwd_phi35"]
    print(f"flash_attention at phi3.5-moe's {LM_SLOTS} x {LM_PROMPTS[0]} h32/8 d128 "
          f"({fs['route']}): max abs error {fs['max_abs_err']:.4g}, relative L2 "
          f"{fs['rel_l2_err']}; {fwd['ms']:.4f} ms, device {fwd['device_ms']:.4f} (bound "
          f"{fwd['bound_ms']:.4f}, ex2 {fs['ex2_bound_ms']:.4f}); SDPA "
          f"({fs['library_backend']['backend']}) {fwd['library_ms']:.4f} ms, device "
          f"{fwd['library_device_ms']:.4f}; backward whole {bw['ms']:.4f} ms, device "
          f"{bw['device_ms']:.4f} (bound {bw['bound_ms']:.4f}, SDPA backward "
          f"{bw['library_ms']:.4f}, device {bw['library_device_ms']:.4f}); alone (event / "
          "device ms): " + ", ".join(
              f"{k} {bw['kernel_ms'][k]:.4f} / {bw['kernel_device_ms'][k]:.4f} (bound "
              f"{bw['kernel_bound_ms'][k]:.4f})" for k in flash_attention.BWD_KERNELS)
          + " [" + card + "]", flush=True)

    # Serving at MOE_SERVE_LAYERS layers: two waves, twice; only these
    # launches are counted.
    base = lm_configs.get(MOE_ARCH)
    cfg = dataclasses.replace(base, n_layers=MOE_SERVE_LAYERS, attn_impl="flash")
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    n_params = count_params(params)
    # ModelConfig.param_count counts the weight matrices, not the norm scales.
    if n_params != cfg.param_count() + (2 * cfg.n_layers + 1) * cfg.d_model:
        raise AssertionError(f"{MOE_ARCH}: {n_params} parameters, the config counts "
                             f"{cfg.param_count()}")
    engine = ServingEngine(cfg, params, slots=LM_SLOTS, max_len=LM_MAX_LEN, device=dev)
    requests = lm_requests(cfg, np.random.default_rng(SEED))
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    runs = [serve_lm(engine, requests) for _ in range(2)]
    torch.cuda.synchronize()
    serve_launches = flash_attention.launches
    routes = dict(flash_attention.route_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if routes["wgmma"] != serve_launches:
        raise AssertionError(f"{MOE_ARCH}: flash launches by route {routes}: all "
                             f"{serve_launches} must be the wgmma kernel's")
    check_lm_waves(MOE_ARCH, cfg, runs, requests, cfg.n_layers)
    lap("serve")
    batch = {"tokens": torch.as_tensor(np.stack([r.prompt for r in requests[:LM_SLOTS]]),
                                       device=dev)}
    _, _, cache = make_prefill_step(cfg, max_len=LM_MAX_LEN)(params, batch)
    ring = cache["self"]
    ring_bytes = sum(t.numel() * t.element_size() for t in ring.values())
    want_ring = (2 * cfg.n_layers * LM_SLOTS * LM_MAX_LEN * cfg.kv_dim * 2
                 + 4 * cfg.n_layers * LM_MAX_LEN)
    if ring_bytes != want_ring or ring["k"].shape != (cfg.n_layers, LM_SLOTS, LM_MAX_LEN,
                                                        cfg.n_kv_heads, cfg.head_dim):
        raise AssertionError(f"{MOE_ARCH}: the KV ring holds {ring_bytes} bytes "
                             f"{tuple(ring['k'].shape)}, expected {want_ring}")
    del cache, ring
    waves = lm_wave_stats(runs)
    serve_profile = profile_lm(engine, requests, steps=2)
    lap("serve profile")
    del engine, params
    torch.cuda.empty_cache()
    for i, plen in enumerate(LM_PROMPTS):
        print(f"serve {MOE_ARCH} ({cfg.n_layers} of {base.n_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k} of d_ff {cfg.d_ff}, "
              f"{cfg.dtype}, {cfg.attn_impl}, {n_params / 1e9:.3f} B parameters) wave "
              f"{LM_SLOTS} x {plen}: prefill " + " / ".join(
                  f"{waves['prefill_ms_per_wave'][r * len(LM_PROMPTS) + i]:.1f}"
                  for r in range(2)) + " ms, decode " + " / ".join(
                  f"{waves['decode_ms_per_token'][r * len(LM_PROMPTS) + i]:.2f}"
                  for r in range(2)) + " ms a token, " + " / ".join(
                  f"{waves['tokens_per_s_per_wave'][r * len(LM_PROMPTS) + i]:.1f}"
                  for r in range(2)) + f" generated tokens/s (two runs) [{card}]", flush=True)
    print(f"serve {MOE_ARCH}: flash launches {serve_launches} ({cfg.n_layers} a wave, by route "
          f"{routes}); tokens in the vocab and equal across two runs; KV ring "
          f"{ring_bytes / 1e9:.3f} GB; peak device memory {peak_gb:.2f} GB [{card}]",
          flush=True)
    for phase, prof in serve_profile.items():
        print(f"profile ({MOE_ARCH} {phase}, {cfg.n_layers} layers): device "
              f"{prof['device_ms']:.2f} ms a {'wave' if phase == 'prefill' else 'step'} "
              f"({prof['device_ms_by']}), busy {pct(prof['device_busy_share'])}; " + ", ".join(
                  f"{k} {v:.2f}" for k, v in prof["by_group_ms"].items()) + f" [{card}]",
              flush=True)

    # Training at MOE_TRAIN_LAYERS layers: run A's recipe twice, then
    # "dots" and packed rows; only these launches are counted.
    cfg = dataclasses.replace(base, n_layers=MOE_TRAIN_LAYERS, attn_impl="flash")
    n_train = cfg.param_count() + (2 * cfg.n_layers + 1) * cfg.d_model
    b, s = LM_SLOTS, LM_PROMPTS[0]
    batches = list(synthetic_batches(cfg, b, s, TRAIN_STEPS, seed=SEED, device=dev))
    recipe = adamw(cosine_schedule(TRAIN_LR, max(TRAIN_STEPS // 20, 1), TRAIN_STEPS),
                   weight_decay=0.01, max_grad_norm=1.0)
    reset_counts()
    trains, copies, early = [], [], {}

    def keep_early(i, p):  # run A's parameters after the "dots" run's steps
        if i + 1 == MOE_EXTRA_STEPS and not early:
            early["params"] = param_copy(p)
    for _ in range(2):
        res, params, state, step, gen = train_lm(cfg, recipe, batches, TRAIN_ACCUM, 0.0, dev,
                                                 on_step=keep_early)
        trains.append(res)
        copies.append(param_copy(params))
        if len(trains) == 1:
            del params, state, step, gen
    torch.cuda.synchronize()
    train_counts = {"fwd": flash_attention.launches, "bwd": flash_attention.bwd_launches}
    train_routes = {"fwd": dict(flash_attention.route_launches),
                    "bwd": dict(flash_attention.bwd_route_launches)}
    lap("train")
    profile = profile_train_step(step, params, state, batches[-1], gen)
    profile["device_busy_share"] = busy(profile, profile["device_ms"],
                                        float(np.median(trains[1]["step_ms"][1:])))
    lap("train profile")
    del params, state, step, gen
    torch.cuda.empty_cache()
    # A layer's aux, E mean(f_e P_e) = sum_e f_e P_e, lies in (0, 1].
    check_lm_runs(f"{MOE_ARCH} run A", trains, copies, cfg.n_layers, TRAIN_ACCUM,
                  aux_max=cfg.n_layers)
    del copies
    for kind in ("fwd", "bwd"):
        if train_routes[kind]["wgmma"] != train_counts[kind]:
            raise AssertionError(f"{MOE_ARCH}: flash {kind} launches by route "
                                 f"{train_routes[kind]}: all must be the wgmma kernels'")
    reset_counts()
    res_dots, params, state, _, _ = train_lm(dataclasses.replace(cfg, remat_policy="dots"),
                                             recipe, batches[:MOE_EXTRA_STEPS], TRAIN_ACCUM,
                                             0.0, dev)
    torch.cuda.synchronize()
    dots_counts = {"flash_attention_fwd": flash_attention.launches,
                   "flash_attention_bwd": flash_attention.bwd_launches,
                   "fwd_routes": dict(flash_attention.route_launches),
                   "bwd_routes": dict(flash_attention.bwd_route_launches)}
    check_dots_run(res_dots, {"loss": trains[0]["loss"][:MOE_EXTRA_STEPS]}, params,
                   early.pop("params"), dots_counts, TRAIN_ACCUM, cfg.n_layers)
    del params, state
    torch.cuda.empty_cache()
    lap("dots")
    packed, info = packed_batches(cfg.vocab_size, b, s, MOE_EXTRA_STEPS, dev)
    packed_recipe = adamw(cosine_schedule(TRAIN_LR, 1, MOE_EXTRA_STEPS), weight_decay=0.01,
                          max_grad_norm=1.0)
    reset_counts()
    packed_runs, first = [], None
    for _ in range(2):
        res, params, state, _, _ = train_lm(cfg, packed_recipe, packed, TRAIN_ACCUM, 0.0, dev)
        packed_runs.append(res)
        if first is None:
            first = param_copy(params)
        else:
            same_params(f"{MOE_ARCH} packed runs: the second run's parameters", params, first)
        del params, state
    torch.cuda.synchronize()
    packed_counts = {"flash_attention_fwd": flash_attention.launches,
                     "flash_attention_bwd": flash_attention.bwd_launches}
    del first
    torch.cuda.empty_cache()
    check_packed_runs(packed_runs, packed_counts, falls=False)
    lap("packed")

    # The checks at MOE_TRAIN_LAYERS layers (after the counts are read),
    # from the seeded initial weights.
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    mb = b // TRAIN_ACCUM
    router = check_router_grads(cfg, params, {k: v[:mb] for k, v in batches[0].items()})
    pad_mb = next({k: v[i:i + mb] for k, v in pb.items()} for pb in packed
                  for i in range(0, b, mb) if bool((pb["segments"][i:i + mb] == 0).any()))
    packed_grads = check_packed_grads(cfg, params, pad_mb)
    tokens = batches[0]["tokens"][:mb]
    xin = moe_inputs(cfg, params, tokens)
    with torch.inference_mode():
        weights, ids, _ = lm_layers._router(TT.layer(params["layers"], 0)["moe"], xin, cfg)
    dispatch = check_moe_dispatch(cfg, ids, weights, lm_layers.moe_capacity(cfg, ids.shape[0]),
                                  dev)
    prompts = np.stack([r.prompt for r in requests[:LM_SLOTS]])
    vs = prefill_against_f32(cfg, params, {"tokens": torch.as_tensor(prompts, device=dev)})
    # Decode against the teacher-forced forward with every token kept (the
    # capacity lossless in prefill and in the forward), so both route the
    # same function.
    lossless = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    drift = decode_drift(lossless, params, prompts, None, dev)
    del params
    torch.cuda.empty_cache()
    lap("accuracy")
    cli = io.StringIO()
    with contextlib.redirect_stdout(cli):
        cli_tokens = serve_cli.main(["--arch", MOE_ARCH, "--reduced"])
    lap("serve CLI")
    phase_s = time.perf_counter() - t_phase

    a1, a2 = trains
    summary = {}
    for tag, res in (("A", a1), ("A again", a2), ("A dots", res_dots),
                     ("packed", packed_runs[0])):
        med = float(np.median(res["step_ms"][1:]))
        summary[tag] = {"median_step_ms": med, "tokens_per_s": b * s / med * 1e3,
                        "peak_mem_gb": res["peak_mem_gb"]}
        print(f"train {MOE_ARCH} ({cfg.n_layers} layers, {n_train / 1e9:.3f} B parameters) "
              f"run {tag}: losses " + " ".join(f"{x:.4f}" for x in res["loss"])
              + "; aux " + " ".join(f"{x:.4f}" for x in res["aux"]) + "; step ms "
              + " ".join(f"{x:.1f}" for x in res["step_ms"]) + f"; median {med:.1f} ms, "
              f"{b * s / med * 1e3:.0f} tokens/s; peak device memory "
              f"{res['peak_mem_gb']:.2f} GB [{card}]", flush=True)
    print(f"train {MOE_ARCH}: run A bitwise equal across two runs (losses and every "
          f"parameter), the loss falling, aux in (0, {cfg.n_layers}]; flash launches a "
          f"microbatch {2 * cfg.n_layers} forward and {cfg.n_layers} backward (routes "
          f"{train_routes}); \"dots\" bitwise \"full\" over {MOE_EXTRA_STEPS} steps; packed "
          f"rows ({info['documents']} documents, {info['pad_tokens']} pad tokens) bitwise "
          f"across two runs with flash launches {packed_counts}; a pad-tail microbatch's "
          f"{packed_grads['leaves']} gradients finite; wr gradient norms by layer "
          f"{router['wr_grad_norm_by_layer']}", flush=True)
    print(f"{MOE_ARCH} at {cfg.n_layers} layers: flash vs chunked prefill logits max |diff| "
          f"{vs['max_abs_diff']:.4g} (tolerance {vs['tolerance']:.4g}; against f32: chunked "
          f"{vs['chunked_vs_f32']:.4g}, flash {vs['flash_vs_f32']:.4g}); decode vs the f32 "
          f"teacher-forced forward over {LM_NEW} steps: worst {drift['worst_ratio']:.3f} of "
          f"the bf16 forward's own error (limit 2); dispatch on the card bitwise the CPU's "
          f"at capacity {dispatch['capacity']} of {dispatch['tokens']} tokens (kept "
          f"{dispatch['kept']}, dropped {dispatch['dropped']})", flush=True)
    print(f"profile ({MOE_ARCH} train step, {cfg.n_layers} layers): device "
          f"{profile['device_ms']:.1f} ms ({profile['device_ms_by']}), busy "
          f"{pct(profile['device_busy_share'])} of an unprofiled step's wall time; " + ", ".join(
              f"{k} {v:.1f}" for k, v in profile["by_group_ms"].items())
          + f"; serve CLI ({MOE_ARCH} --reduced) served {cli_tokens.shape} tokens; the MoE "
          f"phase took {phase_s:.1f} s (" + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
          + f") [{card}]", flush=True)
    report["moe"] = {
        "config": {"arch": MOE_ARCH, "serve_layers": MOE_SERVE_LAYERS,
                   "train_layers": MOE_TRAIN_LAYERS, "d_model": cfg.d_model,
                   "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                   "head_dim": cfg.head_dim, "n_experts": cfg.n_experts, "top_k": cfg.top_k,
                   "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
                   "attn_impl": cfg.attn_impl, "serve_params": n_params,
                   "train_params": n_train, "batch": b, "seq": s, "steps": TRAIN_STEPS,
                   "accum": TRAIN_ACCUM, "lr": TRAIN_LR},
        "serve": {"waves": [f"{LM_SLOTS} x {p}" for p in LM_PROMPTS], "new_tokens": LM_NEW,
                  **waves, "peak_mem_gb": peak_gb, "kv_ring_bytes": ring_bytes,
                  "flash_launches": serve_launches, "launches_by_route": routes,
                  "profile": serve_profile},
        "train": {"run_a": a1, "run_a_again": a2, "run_a_dots": res_dots,
                  "packed": {"runs": packed_runs, "data": info, "launches": packed_counts,
                             "pad_microbatch": packed_grads},
                  "summary": summary, "launches": train_counts,
                  "launches_by_route": train_routes, "dots_launches": dots_counts,
                  "profile": profile, "router_gradients": router},
        "accuracy": {"flash_vs_chunked": vs, "decode_drift": drift, "dispatch": dispatch},
        "serve_cli": cli.getvalue(), "phase_s": phase_s, "phase_s_by_part": parts,
    }
    launches = {"flash_attention_phi35": serve_launches,
                "flash_attention_bwd_dq_phi35": train_counts["bwd"],
                "flash_attention_bwd_dkv_phi35": train_counts["bwd"]}
    stats = {"flash_attention_phi35": fwd,
             "flash_attention_bwd_dq_phi35": bwd["flash_attention_bwd_dq"],
             "flash_attention_bwd_dkv_phi35": bwd["flash_attention_bwd_dkv"]}
    return family_line(MOE_KERNELS, launches, stats, "MoE")


def media_flash_checks(dev, report: dict, arch: str, suffix: str, shape: tuple,
                       ragged: list) -> tuple:
    """The flash forward and backward at a media family's shape (and the
    forward at ``ragged``), printed; returns their kernels-line stats."""
    fwd = check_flash(dev, report, arch, ragged, suffix, shape)
    bwd = check_flash_bwd(dev, report, arch, [], suffix, shape)
    fs = report["flash_attention_shapes" + suffix]
    main = next(iter(fs.values()))
    bw = report["flash_attention_bwd" + suffix]
    print(f"flash_attention at {arch}'s {next(iter(fs))} ({main['route']}): max abs error "
          f"{main['max_abs_err']:.4g}, relative L2 {main['rel_l2_err']}; {fwd['ms']:.4f} ms, "
          f"device {fwd['device_ms']:.4f} (bound {fwd['bound_ms']:.4f}, ex2 "
          f"{main['ex2_bound_ms']:.4f}); SDPA ({main['library_backend']['backend']}) "
          f"{fwd['library_ms']:.4f} ms, device {fwd['library_device_ms']:.4f}; backward whole "
          f"{bw['ms']:.4f} ms, device {bw['device_ms']:.4f} (bound {bw['bound_ms']:.4f}, SDPA "
          f"backward {bw['library_ms']:.4f}, device {bw['library_device_ms']:.4f}); alone "
          "(event / device ms): " + ", ".join(
              f"{k} {bw['kernel_ms'][k]:.4f} / {bw['kernel_device_ms'][k]:.4f} (bound "
              f"{bw['kernel_bound_ms'][k]:.4f})" for k in flash_attention.BWD_KERNELS)
          + "; other shapes (max abs error, relative L2, route): " + json.dumps(
              {k: [v["max_abs_err"], v["rel_l2_err"]["whole"], v["route"]]
               for k, v in list(fs.items())[1:]})
          + f" [{report.get('nvidia_smi', 'card not queried')}]", flush=True)
    return fwd, bwd


def media_params(cfg, gen=None, device=None) -> dict:
    """Seeded weights (from ``gen``, else a generator seeded with SEED); a
    VLM's gates at VLM_GATES."""
    gen = gen or torch.Generator(device=device).manual_seed(SEED)
    params = init_params(cfg, gen, device=device)
    if cfg.family == "vlm":
        with torch.no_grad():
            for name, value in VLM_GATES.items():
                params["groups"]["cross"][name].fill_(value)
    return params


def media_changes_logits(cfg, params: dict, prompt: np.ndarray, max_len: int, dev) -> dict:
    """One prompt twice in a batch, with two requests' media: the two rows'
    prefill logits must differ (the media reach the logits)."""
    batch = wave_batch(cfg, [Request(uid=i, prompt=prompt, media=media_of(cfg, 500 + i))
                             for i in range(2)], dev)
    _, logits, _ = make_prefill_step(cfg, max_len=max_len)(params, batch)
    diff = float((logits[0, :cfg.vocab_size] - logits[1, :cfg.vocab_size]).float().abs().max())
    if not diff > 0:
        raise AssertionError(f"{cfg.name}: two media give the same prefill logits")
    return {"max_abs_diff": diff,
            "logit_scale": float(logits[:, :cfg.vocab_size].float().abs().max())}


def media_cache_bytes(cfg, cache: dict, n_self: int, n_media: int, slots: int,
                      max_len: int) -> dict:
    """The ring's and the media caches' bytes of a prefill's cache, held to
    their layout: (n_self, slots, max_len, KV, hd) K and V in bf16 and
    (n_self, max_len) slot positions; (n_media, slots, M, KV, hd) media K
    and V."""
    ring = sum(t.numel() * t.element_size() for t in cache["self"].values())
    media = sum(cache[k].numel() * cache[k].element_size() for k in ("media_k", "media_v"))
    want_ring = 2 * n_self * slots * max_len * cfg.kv_dim * 2 + 4 * n_self * max_len
    want_media = 2 * n_media * slots * cfg.n_media_tokens * cfg.kv_dim * 2
    shape = (n_media, slots, cfg.n_media_tokens, cfg.n_kv_heads, cfg.head_dim)
    if (ring, media) != (want_ring, want_media) or tuple(cache["media_k"].shape) != shape:
        raise AssertionError(f"{cfg.name}: the ring holds {ring} bytes and the media caches "
                             f"{media} {tuple(cache['media_k'].shape)}, expected {want_ring} "
                             f"and {want_media} {shape}")
    return {"ring_bytes": ring, "media_bytes": media}


def leaf_grads(cfg, params: dict, batch: dict, picks: list) -> dict:
    """One microbatch's loss and the gradients of the leaves ``picks`` names
    ((name, path, index) each), every one finite and non-zero; returns
    their norms."""
    tree = tree_map(lambda p: p.detach(), params)
    paths = sorted({path for _, path, _ in picks})
    want = {}
    for path in paths:
        t = tree
        for k in path:
            t = t[k]
        want[path] = t.requires_grad_()
    loss, _ = forward_train(_with_leaves(tree, want), cfg, batch)
    grads = dict(zip(paths, torch.autograd.grad(loss, [want[p] for p in paths],
                                                allow_unused=True)))
    norms = {}
    for name, path, idx in picks:
        g = torch.zeros_like(want[path]) if grads[path] is None else grads[path]
        g = g[idx] if idx else g
        norms[name] = float(g.float().norm())
        if not (bool(torch.isfinite(g).all()) and norms[name] > 0):
            raise AssertionError(f"{cfg.name}: the gradient of {name} is not finite and "
                                 f"non-zero (norm {norms[name]})")
    return {"loss": float(loss.detach()), "grad_norms": norms}


def vlm_grad_picks(cfg) -> list:
    """Every cross layer's projections and gates."""
    g, _ = TT.vlm_layout(cfg)
    return ([(f"cross[{i}].xattn.{n}", ("groups", "cross", "xattn", n), (i,))
             for i in range(g) for n in ("wq", "wk", "wv", "wo")]
            + [(f"cross[{i}].{n}", ("groups", "cross", n), (i,))
               for i in range(g) for n in VLM_GATES])


def audio_grad_picks(cfg) -> list:
    """The encoder's first and last wq, every decoder layer's cross
    projections."""
    return ([(f"encoder[{i}].attn.wq", ("encoder", "attn", "wq"), (i,))
             for i in (0, cfg.encoder_layers - 1)]
            + [(f"decoder[{i}].xattn.{n}", ("decoder", "xattn", n), (i,))
               for i in range(cfg.n_layers) for n in ("wq", "wk", "wv", "wo")])


def serve_media(cfg, dev, slots: int, prompts: tuple, new: int, max_len: int,
                per_wave: int) -> dict:
    """Seeded weights served through ``ServingEngine`` in one wave of
    ``slots`` requests (each with its own media) a prompt length, twice;
    only these flash launches are counted, each on the wgmma route."""
    params = media_params(cfg, device=dev)
    engine = ServingEngine(cfg, params, slots=slots, max_len=max_len, device=dev)
    requests = lm_requests(cfg, np.random.default_rng(SEED), slots, prompts, new, media=True)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    runs = [serve_lm(engine, requests) for _ in range(2)]
    torch.cuda.synchronize()
    launches, routes = flash_attention.launches, dict(flash_attention.route_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if routes["wgmma"] != launches:
        raise AssertionError(f"{cfg.name}: flash launches by route {routes}: all {launches} "
                             "must be the wgmma kernel's")
    check_lm_waves(cfg.name, cfg, runs, requests, per_wave)
    return {"params": params, "engine": engine, "requests": requests, "runs": runs,
            "launches": launches, "routes": routes, "peak_mem_gb": peak_gb,
            "waves": lm_wave_stats(runs, slots, prompts, new)}


def train_media(cfg, opt, batches: list, accum: int, dev, n_attn: int) -> dict:
    """``train_lm`` twice from the same seed (a VLM's gates set first, after
    the seeded draw), its gates (``check_lm_runs``: bitwise, the loss
    falling, ``n_attn`` flash layers a microbatch, every launch on the
    wgmma routes) and one more step profiled."""
    reset_counts()
    trains, copies = [], []
    for _ in range(2):
        res, params, state, step, gen = train_lm(cfg, opt, batches, accum, 0.0, dev,
                                                 init=media_params)
        trains.append(res)
        copies.append(param_copy(params))
        if len(trains) == 1:
            del params, state, step, gen
    torch.cuda.synchronize()
    counts = {"fwd": flash_attention.launches, "bwd": flash_attention.bwd_launches}
    routes = {"fwd": dict(flash_attention.route_launches),
              "bwd": dict(flash_attention.bwd_route_launches)}
    check_lm_runs(f"{cfg.name} training", trains, copies, n_attn, accum, aux_max=0)
    del copies
    for kind in ("fwd", "bwd"):
        if routes[kind]["wgmma"] != counts[kind]:
            raise AssertionError(f"{cfg.name}: flash {kind} launches by route {routes[kind]}: "
                                 "all must be the wgmma kernels'")
    profile = profile_train_step(step, params, state, batches[-1], gen)
    profile["device_busy_share"] = busy(profile, profile["device_ms"],
                                        float(np.median(trains[1]["step_ms"][1:])))
    del params, state, step, gen
    torch.cuda.empty_cache()
    return {"runs": trains, "launches": counts, "launches_by_route": routes,
            "profile": profile}


def print_media(tag: str, cfg, served: dict, cache: dict, changed: dict, trained: dict,
                tokens: int, card: str) -> None:
    waves = served["waves"]
    n = len(waves["prefill_ms_per_wave"]) // 2
    for i in range(n):
        print(f"serve {tag} wave {i}: prefill " + " / ".join(
            f"{waves['prefill_ms_per_wave'][r * n + i]:.1f}" for r in range(2)) + " ms, decode "
            + " / ".join(f"{waves['decode_ms_per_token'][r * n + i]:.2f}" for r in range(2))
            + " ms a token, " + " / ".join(
                f"{waves['tokens_per_s_per_wave'][r * n + i]:.1f}" for r in range(2))
            + f" generated tokens/s (two runs) [{card}]", flush=True)
    print(f"serve {tag}: flash launches {served['launches']} (by route {served['routes']}); "
          f"tokens in the vocab and equal across two runs; KV ring "
          f"{cache['ring_bytes'] / 1e9:.4f} GB, media caches {cache['media_bytes'] / 1e9:.4f} "
          f"GB; two media, one prompt: logits max |diff| {changed['max_abs_diff']:.4g} (scale "
          f"{changed['logit_scale']:.4g}); peak device memory {served['peak_mem_gb']:.2f} GB "
          f"[{card}]", flush=True)
    for phase, prof in served["profile"].items():
        print(f"profile ({tag} {phase}): device {prof['device_ms']:.2f} ms a "
              f"{'wave' if phase == 'prefill' else 'step'} ({prof['device_ms_by']}), wall "
              f"{prof['wall_ms_profiled']:.2f} ms profiled, busy "
              f"{pct(prof['device_busy_share'])}; " + ", ".join(
                  f"{k} {v:.2f}" for k, v in prof["by_group_ms"].items()) + f" [{card}]",
              flush=True)
    for i, res in enumerate(trained["runs"]):
        med = float(np.median(res["step_ms"][1:]))
        print(f"train {tag} run {i + 1}: losses " + " ".join(f"{x:.4f}" for x in res["loss"])
              + "; step ms " + " ".join(f"{x:.1f}" for x in res["step_ms"])
              + f"; median {med:.1f} ms, {tokens / med * 1e3:.0f} tokens/s; peak device "
              f"memory {res['peak_mem_gb']:.2f} GB [{card}]", flush=True)
    prof = trained["profile"]
    print(f"profile ({tag} train step): device {prof['device_ms']:.1f} ms "
          f"({prof['device_ms_by']}), wall {prof['wall_ms_profiled']:.1f} ms profiled, busy "
          f"{pct(prof['device_busy_share'])} of an unprofiled step's wall time; " + ", ".join(
              f"{k} {v:.1f}" for k, v in prof["by_group_ms"].items()) + f" [{card}]",
          flush=True)


def family_line(names: dict, launches: dict, stats: dict, tag: str) -> list:
    """A model family's ``kernels``-line entries: each of ``names`` (source,
    replaces) with its launches on the family's path, which must be some,
    and its stats."""
    line = []
    for name, (source, replaces) in names.items():
        if launches[name] <= 0:
            raise AssertionError(f"{name}: no launch on the {tag} path")
        line.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], **stats[name]})
    return line


def drive_vlm(dev: torch.device, report: dict) -> list:
    """The VLM family's serving and training paths (llama-3.2-vision-90b at
    full width); returns its kernels' entries."""
    t_phase = time.perf_counter()
    parts: dict = {}

    def lap(name: str) -> None:  # seconds since the last lap, by part
        parts[name] = time.perf_counter() - t_phase - sum(parts.values())
    card = report.get("nvidia_smi", "card not queried")
    fwd, bwd = media_flash_checks(dev, report, VLM_ARCH, "_vlm", (LM_SLOTS, LM_PROMPTS[0]), [])
    lap("kernel checks")

    base = lm_configs.get(VLM_ARCH)
    cfg = dataclasses.replace(base, n_layers=VLM_SERVE_LAYERS, attn_impl="flash")
    g, spg = TT.vlm_layout(cfg)
    torch.cuda.empty_cache()
    served = serve_media(cfg, dev, LM_SLOTS, LM_PROMPTS, LM_NEW, LM_MAX_LEN, g * spg)
    params, requests = served["params"], served["requests"]
    n_params = count_params(params)
    # ModelConfig.param_count counts the weight matrices, not the norm scales
    # or the gates.
    if n_params != cfg.param_count() + (2 * cfg.n_layers + 1) * cfg.d_model + 2 * g:
        raise AssertionError(f"{VLM_ARCH}: {n_params} parameters, the config counts "
                             f"{cfg.param_count()}")
    lap("serve")
    wave = requests[:LM_SLOTS]
    _, _, cache = make_prefill_step(cfg, max_len=LM_MAX_LEN)(params,
                                                             wave_batch(cfg, wave, dev))
    cache_bytes = media_cache_bytes(cfg, cache, g * spg, g, LM_SLOTS, LM_MAX_LEN)
    del cache
    changed = media_changes_logits(cfg, params, wave[0].prompt, LM_MAX_LEN, dev)
    served["profile"] = profile_lm(served.pop("engine"), requests, steps=2)
    lap("serve checks and profile")
    del params
    served.pop("params")
    torch.cuda.empty_cache()

    # One group: the accuracy gates (an f32 copy fits), then training.
    cfg = dataclasses.replace(base, n_layers=VLM_TRAIN_LAYERS, attn_impl="flash")
    params = media_params(cfg, device=dev)
    batch = wave_batch(cfg, wave, dev)
    vs = prefill_against_f32(cfg, params, batch)
    drift = decode_drift(cfg, params, batch["tokens"].cpu().numpy(), None, dev,
                         media=batch["media"])
    del params, batch
    torch.cuda.empty_cache()
    lap("accuracy")
    b, s = VLM_TRAIN_BATCH, LM_PROMPTS[0]
    fresh = list(synthetic_batches(cfg, b, s, 2, seed=SEED, device=dev))
    batches = [fresh[i % 2] for i in range(VLM_TRAIN_STEPS)]
    trained = train_media(cfg, sgd(VLM_SGD_LR), batches, TRAIN_ACCUM, dev, spg)
    loss = trained["runs"][0]["loss"]
    if not all(loss[i + 2] < loss[i] for i in range(VLM_TRAIN_STEPS - 2)):
        raise AssertionError(f"{VLM_ARCH}: a batch's loss did not fall the second time it was "
                             f"seen: {loss}")
    lap("train")
    params = media_params(cfg, device=dev)
    mb = {k: v[:b // TRAIN_ACCUM] for k, v in fresh[0].items()}
    grads = leaf_grads(cfg, params, mb, vlm_grad_picks(cfg))
    del params
    torch.cuda.empty_cache()
    lap("train gradients")
    phase_s = time.perf_counter() - t_phase
    tag = (f"{VLM_ARCH} ({VLM_SERVE_LAYERS} of {base.n_layers} layers served, "
           f"{VLM_TRAIN_LAYERS} trained; d_model {cfg.d_model}, {cfg.dtype}, {cfg.attn_impl}, "
           f"gates {VLM_GATES})")
    print_media(tag, cfg, served, cache_bytes, changed, trained, b * s, card)
    print(f"{VLM_ARCH} at one group: flash vs chunked prefill logits max |diff| "
          f"{vs['max_abs_diff']:.4g} (tolerance {vs['tolerance']:.4g}; against f32: chunked "
          f"{vs['chunked_vs_f32']:.4g}, flash {vs['flash_vs_f32']:.4g}); decode vs the f32 "
          f"teacher-forced forward over {drift['steps']} steps: worst "
          f"{drift['worst_ratio']:.3f} of the bf16 forward's own error (limit 2); gradients "
          f"finite and non-zero: {json.dumps(grads['grad_norms'])}; the VLM phase took "
          f"{phase_s:.1f} s (" + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
          + f") [{card}]", flush=True)
    report["vlm"] = {
        "config": {"arch": VLM_ARCH, "serve_layers": VLM_SERVE_LAYERS,
                   "train_layers": VLM_TRAIN_LAYERS, "d_model": cfg.d_model,
                   "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                   "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
                   "media_tokens": cfg.n_media_tokens, "dtype": cfg.dtype,
                   "serve_params": n_params, "gates": VLM_GATES, "sgd_lr": VLM_SGD_LR,
                   "train_batch": b, "seq": s, "steps": VLM_TRAIN_STEPS,
                   "accum": TRAIN_ACCUM},
        "serve": {k: v for k, v in served.items() if k not in ("requests", "runs")},
        "cache": cache_bytes, "media_changes_logits": changed, "train": trained,
        "accuracy": {"flash_vs_chunked": vs, "decode_drift": drift},
        "gradients": grads, "phase_s": phase_s, "phase_s_by_part": parts,
    }
    launches = {"flash_attention_vlm": served["launches"],
                "flash_attention_bwd_dq_vlm": trained["launches"]["bwd"],
                "flash_attention_bwd_dkv_vlm": trained["launches"]["bwd"]}
    stats = {"flash_attention_vlm": fwd,
             "flash_attention_bwd_dq_vlm": bwd["flash_attention_bwd_dq"],
             "flash_attention_bwd_dkv_vlm": bwd["flash_attention_bwd_dkv"]}
    return family_line(VLM_KERNELS, launches, stats, "VLM")


def drive_audio(dev: torch.device, report: dict) -> list:
    """The audio family's serving and training paths (whisper-small whole);
    returns its kernels' entries."""
    t_phase = time.perf_counter()
    parts: dict = {}

    def lap(name: str) -> None:  # seconds since the last lap, by part
        parts[name] = time.perf_counter() - t_phase - sum(parts.values())
    card = report.get("nvidia_smi", "card not queried")
    rows, seq = AUDIO_TRAIN
    fwd, bwd = media_flash_checks(dev, report, AUDIO_ARCH, "_whisper",
                                  (rows // TRAIN_ACCUM, seq), AUDIO_FLASH_SERVE)
    lap("kernel checks")
    cfg = dataclasses.replace(lm_configs.get(AUDIO_ARCH), attn_impl="flash")
    served = serve_media(cfg, dev, AUDIO_SLOTS, AUDIO_PROMPTS, AUDIO_NEW, AUDIO_MAX_LEN,
                         cfg.n_layers)
    params, requests = served["params"], served["requests"]
    n_params = count_params(params)
    if n_params != cfg.param_count() + (3 * cfg.n_layers + 2 * cfg.encoder_layers + 2) * \
            cfg.d_model:
        raise AssertionError(f"{AUDIO_ARCH}: {n_params} parameters, the config counts "
                             f"{cfg.param_count()}")
    lap("serve")
    wave = requests[-AUDIO_SLOTS:]  # the longest prompts
    batch = wave_batch(cfg, wave, dev)
    _, _, cache = make_prefill_step(cfg, max_len=AUDIO_MAX_LEN)(params, batch)
    cache_bytes = media_cache_bytes(cfg, cache, cfg.n_layers, cfg.n_layers, AUDIO_SLOTS,
                                    AUDIO_MAX_LEN)
    del cache
    changed = media_changes_logits(cfg, params, wave[0].prompt, AUDIO_MAX_LEN, dev)
    vs = prefill_against_f32(cfg, params, batch, AUDIO_MAX_LEN)
    drift = decode_drift(cfg, params, batch["tokens"].cpu().numpy(),
                         np.stack([c.tokens for c in served["runs"][0][0][-AUDIO_SLOTS:]]),
                         dev, media=batch["media"], new=AUDIO_NEW, max_len=AUDIO_MAX_LEN)
    served["profile"] = profile_lm(served.pop("engine"), requests, steps=2)
    del params, batch
    served.pop("params")
    lap("serve checks and profile")
    batches = list(synthetic_batches(cfg, rows, seq, TRAIN_STEPS, seed=SEED, device=dev))
    recipe = adamw(cosine_schedule(TRAIN_LR, max(TRAIN_STEPS // 20, 1), TRAIN_STEPS),
                   weight_decay=0.01, max_grad_norm=1.0)
    trained = train_media(cfg, recipe, batches, TRAIN_ACCUM, dev, cfg.n_layers)
    lap("train")
    params = media_params(cfg, device=dev)
    grads = leaf_grads(cfg, params, {k: v[:rows // TRAIN_ACCUM] for k, v in batches[0].items()},
                       audio_grad_picks(cfg))
    del params
    lap("train gradients")
    cli = io.StringIO()
    with contextlib.redirect_stdout(cli):
        for arch in (VLM_ARCH, AUDIO_ARCH):
            train_cli.main(["--arch", arch, "--steps", "2", "--batch", "2", "--seq", "64",
                            "--log-every", "1", "--accum", "2"])
            serve_cli.main(["--arch", arch, "--batch", "2", "--prompt-len", "32", "--gen", "8"])
    lap("CLIs")
    phase_s = time.perf_counter() - t_phase
    tag = (f"{AUDIO_ARCH} ({cfg.encoder_layers} + {cfg.n_layers} layers, d_model "
           f"{cfg.d_model}, {cfg.dtype}, {cfg.attn_impl}, {n_params / 1e6:.1f} M parameters)")
    print_media(tag, cfg, served, cache_bytes, changed, trained, rows * seq, card)
    print(f"{AUDIO_ARCH}: flash vs chunked prefill logits max |diff| {vs['max_abs_diff']:.4g} "
          f"(tolerance {vs['tolerance']:.4g}; against f32: chunked {vs['chunked_vs_f32']:.4g}, "
          f"flash {vs['flash_vs_f32']:.4g}); decode vs the f32 teacher-forced forward over "
          f"{drift['steps']} steps: worst {drift['worst_ratio']:.3f} of the bf16 forward's own "
          f"error (limit 2); gradients finite and non-zero ({len(grads['grad_norms'])} "
          f"leaves); the train and serve CLIs ran for {VLM_ARCH} and {AUDIO_ARCH} (reduced); "
          f"the audio phase took {phase_s:.1f} s (" + ", ".join(
              f"{k} {v:.1f}" for k, v in parts.items()) + f") [{card}]", flush=True)
    report["audio"] = {
        "config": {"arch": AUDIO_ARCH, "encoder_layers": cfg.encoder_layers,
                   "n_layers": cfg.n_layers, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                   "head_dim": cfg.head_dim, "media_tokens": cfg.n_media_tokens,
                   "dtype": cfg.dtype, "params": n_params, "slots": AUDIO_SLOTS,
                   "prompts": AUDIO_PROMPTS, "new_tokens": AUDIO_NEW,
                   "max_len": AUDIO_MAX_LEN, "train": AUDIO_TRAIN, "steps": TRAIN_STEPS,
                   "accum": TRAIN_ACCUM, "lr": TRAIN_LR},
        "serve": {k: v for k, v in served.items() if k not in ("requests", "runs")},
        "cache": cache_bytes, "media_changes_logits": changed, "train": trained,
        "accuracy": {"flash_vs_chunked": vs, "decode_drift": drift}, "gradients": grads,
        "clis": cli.getvalue(), "phase_s": phase_s, "phase_s_by_part": parts,
    }
    launches = {"flash_attention_whisper": served["launches"],
                "flash_attention_bwd_dq_whisper": trained["launches"]["bwd"],
                "flash_attention_bwd_dkv_whisper": trained["launches"]["bwd"]}
    stats = {"flash_attention_whisper": fwd,
             "flash_attention_bwd_dq_whisper": bwd["flash_attention_bwd_dq"],
             "flash_attention_bwd_dkv_whisper": bwd["flash_attention_bwd_dkv"]}
    return family_line(AUDIO_KERNELS, launches, stats, "audio")


def drive_media(dev: torch.device, report: dict) -> list:
    """The media families (the VLM, then whisper); their kernels' entries."""
    return drive_vlm(dev, report) + drive_audio(dev, report)


class CountOps(TorchDispatchMode):
    """While it is open, counts each aten op dispatched (views included),
    by name: the host ops of the code it wraps."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def slstm_ops_per_position(cfg, dev, positions: int = 64, batch: int = LM_SLOTS) -> dict:
    """The host ops a position of ``models.xlstm.slstm_scan`` dispatches at
    the model's width, in inference and under autograd (the forward and its
    backward), over ``positions`` seeded positions."""
    h, hd, dt = cfg.n_heads, cfg.head_dim, getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pre = torch.randn((batch, positions, 4, h, hd), generator=gen, device=dev).to(dt)
    r = (torch.randn((h, 4, hd, hd), generator=gen, device=dev) / hd ** 0.5).to(dt)
    with torch.inference_mode(), CountOps() as fwd:
        lm_xlstm.slstm_scan(pre, r)
    pre, r = pre.clone().requires_grad_(), r.clone().requires_grad_()
    with CountOps() as train:
        y, _ = lm_xlstm.slstm_scan(pre, r)
        torch.autograd.grad(y.float().sum(), [pre, r])
    return {"inference": sum(fwd.ops.values()) / positions,
            "forward_and_backward": sum(train.ops.values()) / positions,
            "inference_by_op": {k: v / positions for k, v in fwd.ops.most_common()}}


def xlstm_cache_bytes(cfg, batch: int) -> int:
    """The bytes of an xLSTM decode cache, reckoned from the layout: each
    mLSTM layer's C (H, hd, hd) and n (H, hd) in the model's dtype and m
    (H,) f32, each sLSTM layer's c, n, h (H, hd) in it and m (H, hd) f32,
    a row each; ``pos`` int32. It does not depend on the context."""
    g, mpg = TT.xlstm_layout(cfg)
    e = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    h, hd = cfg.n_heads, cfg.head_dim
    return g * batch * h * (mpg * ((hd * hd + hd) * e + 4) + hd * (3 * e + 4)) + 4


def xlstm_grad_picks(cfg) -> list:
    """The xLSTM gradients ``check_train_grads`` holds: wq, w_if and b_if of
    the first and the last mLSTM layer, w_gates and r_gates of the first
    and the last sLSTM layer."""
    g, mpg = TT.xlstm_layout(cfg)
    return ([(f"mlstm[{i}].{n}", ("groups", "mlstm", n), idx) for n in ("wq", "w_if", "b_if")
             for i, idx in ((0, (0, 0)), (g * mpg - 1, (g - 1, mpg - 1)))]
            + [(f"slstm[{i}].{n}", ("groups", "slstm", n), (i,))
               for n in ("w_gates", "r_gates") for i in (0, g - 1)])


def check_xlstm_cache(cfg, params: dict, batch: dict) -> dict:
    """One prefill's cache: every leaf of ``init_cache``'s shape and dtype
    (C, n, c, h in the model's dtype, m f32), finite, and its bytes the
    reckoning's (``xlstm_cache_bytes``)."""
    _, _, cache = make_prefill_step(cfg, max_len=LM_MAX_LEN)(params, batch)
    b = batch["tokens"].shape[0]
    blank = init_cache(cfg, b, LM_MAX_LEN, device="meta")
    leaves = {f"{k}.{n}": t for k in ("mlstm", "slstm") for n, t in cache[k].items()}
    for name, t in leaves.items():
        want = blank[name.split(".")[0]][name.split(".")[1]]
        if (t.shape, t.dtype) != (want.shape, want.dtype) or not torch.isfinite(t).all():
            raise AssertionError(f"{cfg.name} cache {name}: {tuple(t.shape)} {t.dtype}, "
                                 f"expected {tuple(want.shape)} {want.dtype}, finite")
    nbytes = sum(t.numel() * t.element_size() for t in [cache["pos"], *leaves.values()])
    if nbytes != xlstm_cache_bytes(cfg, b):
        raise AssertionError(f"{cfg.name}: the cache holds {nbytes} bytes, the reckoning "
                             f"{xlstm_cache_bytes(cfg, b)}")
    return {"bytes": nbytes, "matrix_memory_bytes": leaves["mlstm.c"].numel()
            * leaves["mlstm.c"].element_size(), "pos": int(cache["pos"])}


def drive_xlstm(dev: torch.device, report: dict) -> None:
    """The xLSTM family's serving and training paths (xlstm-1.3b whole).
    No kernel of the port is on them, so it adds no entry to the kernels
    line; it fails if any launches."""
    t_phase = time.perf_counter()
    parts: dict = {}

    def lap(name: str) -> None:  # seconds since the last lap, by part
        parts[name] = time.perf_counter() - t_phase - sum(parts.values())

    def none_launched(where: str) -> None:  # since the last reset_counts
        launched = {name: count for name, count in gbdt_counts().items() if count}
        if flash_attention.launches or flash_attention.bwd_launches or launched:
            raise AssertionError(f"{XLSTM_ARCH} {where}: kernels launched on a path that has "
                                 f"none: flash {flash_attention.launches} forward, "
                                 f"{flash_attention.bwd_launches} backward, {launched}")
    card = report.get("nvidia_smi", "card not queried")
    cfg = lm_configs.get(XLSTM_ARCH)
    g, mpg = TT.xlstm_layout(cfg)
    for n in (XLSTM_CHECK_LEN, XLSTM_TRAIN[1]):  # else a gate compares a path with itself
        if min(cfg.ssm_chunk, n) == min(XLSTM_OTHER["ssm_chunk"], n):
            raise AssertionError(f"{XLSTM_ARCH}: at {n} tokens the compared path's chunk is "
                                 "the served path's")
    ops = slstm_ops_per_position(cfg, dev)

    # Serving: two waves, twice; no kernel launches.
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, device=dev)
    n_params = count_params(params)
    if n_params != XLSTM_PARAMS:
        raise AssertionError(f"{XLSTM_ARCH}: {n_params} parameters, expected {XLSTM_PARAMS}")
    engine = ServingEngine(cfg, params, slots=LM_SLOTS, max_len=LM_MAX_LEN, device=dev)
    requests = lm_requests(cfg, np.random.default_rng(SEED))
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    runs = [serve_lm(engine, requests) for _ in range(2)]
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check_lm_waves(XLSTM_ARCH, cfg, runs, requests, 0)
    waves = lm_wave_stats(runs)
    lap("serve")
    check = [r for r in requests if len(r.prompt) == XLSTM_CHECK_PROMPT]
    prompts = np.stack([r.prompt for r in check])
    batch = {"tokens": torch.as_tensor(prompts[:, :XLSTM_CHECK_LEN], device=dev)}
    cache = check_xlstm_cache(cfg, params, batch)
    vs = prefill_against_f32(cfg, params, batch, other=XLSTM_OTHER)
    served = {c.uid: c.tokens for c in runs[0][0]}
    drift = decode_drift(cfg, params, prompts, np.stack([served[r.uid] for r in check]), dev)
    lap("serve checks")
    serve_profile = profile_lm(engine, [dataclasses.replace(
        r, prompt=r.prompt[:XLSTM_PROFILE["prefill"]]) for r in check], steps=1)
    lap("serve profile")
    none_launched("serving")
    del engine, params
    torch.cuda.empty_cache()

    # Training: run A's recipe twice (bitwise, the loss falling, no kernel
    # launched), then one
    # unprofiled step on fewer positions, then one group's step profiled.
    b, s = XLSTM_TRAIN
    batches = list(synthetic_batches(cfg, b, s, XLSTM_TRAIN_STEPS, seed=SEED, device=dev))
    recipe = adamw(cosine_schedule(TRAIN_LR, max(XLSTM_TRAIN_STEPS // 20, 1),
                                   XLSTM_TRAIN_STEPS), weight_decay=0.01, max_grad_norm=1.0)
    reset_counts()
    trains, copies = [], []
    for _ in range(2):
        res, params, state, step, gen = train_lm(cfg, recipe, batches, XLSTM_ACCUM, 0.0, dev)
        trains.append(res)
        copies.append(param_copy(params))
        if len(trains) == 1:
            del params, state, step, gen
    check_lm_runs(f"{XLSTM_ARCH} run A", trains, copies, 0, XLSTM_ACCUM, aux_max=0)
    del copies
    bad_moments = [i for i, m in enumerate(tree_leaves(state[-1].mu))
                   if m.dtype != torch.float32]
    if bad_moments:
        raise AssertionError(f"{XLSTM_ARCH}: AdamW moments not f32: leaves {bad_moments}")
    short = next(synthetic_batches(cfg, *XLSTM_PROFILE["positions"], 1, seed=SEED + 1,
                                   device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, state, short, gen)
    torch.cuda.synchronize()
    short_ms = 1e3 * (time.perf_counter() - t0)
    del params, state, step, gen
    torch.cuda.empty_cache()
    lap("train")
    one = dataclasses.replace(cfg, n_layers=cfg.slstm_every)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(one, gen, device=dev)
    state = recipe.init(params)
    train_profile = profile_step_on(
        make_train_step(one, recipe, accum=XLSTM_ACCUM), params, state,
        next(synthetic_batches(one, *XLSTM_PROFILE["train"], 1, seed=SEED + 2, device=dev)),
        gen)
    del params, state, gen
    torch.cuda.empty_cache()
    lap("train profile")
    grads = check_train_grads(cfg, {k: v[:XLSTM_GRAD_ROWS] for k, v in batches[0].items()},
                              dev, xlstm_grad_picks(cfg), other=XLSTM_OTHER)
    lap("train gradients")
    none_launched("training")

    # The sLSTM loop's shares: of the device time (its group; where the
    # profiler sees the device) and of the profiled host time (its ranges'
    # host spans: its forward and recompute; its backward runs outside).
    def shares(prof: dict) -> dict:
        seen = prof["device_ms_by"] == "profiler"
        return {"device": prof["by_group_ms"].get(SLSTM_GROUP, 0.0) / prof["device_ms"]
                if seen else None,
                "host": prof["range_host_ms"].get(SLSTM_RANGE, 0.0) / prof["wall_ms_profiled"]}
    profiles = {"prefill": serve_profile["prefill"], "decode": serve_profile["decode"],
                "train step": train_profile}
    slstm_share = {k: shares(p) for k, p in profiles.items()}
    # The share of a run's step that grows with the positions: against the
    # unprofiled step on fewer positions (the mLSTM's work a chunk and the
    # optimizer's do not grow with them; the sLSTM's loop does).
    step_ms = float(np.median(trains[1]["step_ms"][1:]))
    positions_share = 1 - short_ms / step_ms
    phase_s = time.perf_counter() - t_phase
    prefill_ms, decode_ms_tok, tok_s = (waves[k] for k in (
        "prefill_ms_per_wave", "decode_ms_per_token", "tokens_per_s_per_wave"))
    print(f"xlstm sLSTM host ops a position ({cfg.n_heads} heads of {cfg.head_dim}, "
          f"{LM_SLOTS} rows): {ops['inference']:.2f} in inference, "
          f"{ops['forward_and_backward']:.2f} forward and backward; by op "
          + json.dumps(ops["inference_by_op"]) + f" [{card}]", flush=True)
    for i, p in enumerate(LM_PROMPTS):
        print(f"serve {XLSTM_ARCH} ({g} groups of {mpg} mLSTM + 1 sLSTM layers, d_model "
              f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, {cfg.dtype}, "
              f"{n_params / 1e9:.3f} B parameters) wave {LM_SLOTS} x {p}: prefill "
              + " / ".join(f"{prefill_ms[r * len(LM_PROMPTS) + i]:.1f}" for r in range(2))
              + " ms, decode " + " / ".join(
                  f"{decode_ms_tok[r * len(LM_PROMPTS) + i]:.2f}" for r in range(2))
              + " ms a token, " + " / ".join(
                  f"{tok_s[r * len(LM_PROMPTS) + i]:.1f}" for r in range(2))
              + f" generated tokens/s (two runs) [{card}]", flush=True)
    print(f"serve {XLSTM_ARCH}: no kernel launched; tokens equal across two runs; cache "
          f"{cache['bytes']} bytes at {LM_SLOTS} rows = the reckoning (C "
          f"{cache['matrix_memory_bytes']}); prefill logits bitwise across runs: "
          f"{vs['bitwise_across_runs']}; against ssm_chunk {XLSTM_OTHER['ssm_chunk']} on the "
          f"{LM_SLOTS} x {XLSTM_CHECK_PROMPT} wave's first {XLSTM_CHECK_LEN} tokens max "
          f"|diff| {vs['max_abs_diff']:.4g} "
          f"(tolerance {vs['tolerance']:.4g}; against f32: ssm_chunk "
          f"{XLSTM_OTHER['ssm_chunk']} {vs['chunked_vs_f32']:.4g}, served "
          f"{vs['flash_vs_f32']:.4g}); decode vs the f32 teacher-forced forward over "
          f"{LM_NEW} steps on that wave: worst {drift['worst_ratio']:.3f} of the bf16 "
          f"forward's largest error (limit 2; a step's own: {drift['worst_step_ratio']:.3f}; "
          f"teacher-forced chunk {drift['teacher_forced_ssm_chunk']}); peak device memory "
          f"{peak_gb:.2f} GB [{card}]", flush=True)
    for phase, prof in serve_profile.items():
        share, per = slstm_share[phase], "wave" if phase == "prefill" else "token"
        print(f"profile ({XLSTM_ARCH} {phase}, {LM_SLOTS} x {XLSTM_PROFILE['prefill']}): "
              f"device {prof['device_ms']:.2f} ms a {per} ({prof['device_ms_by']}), wall "
              f"{prof['wall_ms_profiled']:.2f} ms profiled, busy "
              f"{pct(prof['device_busy_share'])}; sLSTM loop {pct(share['device'])} of the "
              f"device time, {pct(share['host'])} of the host's; " + ", ".join(
                  f"{k} {v:.2f}" for k, v in prof["by_group_ms"].items()) + f" [{card}]",
              flush=True)
    tokens = b * s
    for i, res in enumerate(trains):
        med = float(np.median(res["step_ms"][1:]))
        print(f"train {XLSTM_ARCH} run A{' again' if i else ''} ({b} x {s} a step, accum "
              f"{XLSTM_ACCUM}): losses " + " ".join(f"{x:.4f}" for x in res["loss"])
              + "; step ms " + " ".join(f"{x:.1f}" for x in res["step_ms"])
              + f"; median {med:.1f} ms, {tokens / med * 1e3:.0f} tokens/s; peak device "
              f"memory {res['peak_mem_gb']:.2f} GB [{card}]", flush=True)
    worst = max(grads["leaves"].items(), key=lambda kv: kv[1]["flash_vs_chunked"]
                / kv[1]["tolerance"])
    prof, (pb, ps), (qb, qs) = (train_profile, XLSTM_PROFILE["train"],
                                XLSTM_PROFILE["positions"])
    print(f"train {XLSTM_ARCH}: bitwise equal across two runs (losses and every parameter); "
          f"the loss falls; AdamW moments f32; against ssm_chunk {XLSTM_OTHER['ssm_chunk']} "
          f"on one {XLSTM_GRAD_ROWS} x {s} microbatch: loss "
          f"{grads['loss']['flash']:.6f} / {grads['loss']['chunked']:.6f} (f32 "
          f"{grads['loss']['chunked_f32']:.6f}); "
          f"{len(grads['leaves'])} gradients within twice that path's own error, closest "
          f"{worst[0]}: relative L2 {worst[1]['flash_vs_chunked']:.4g} against "
          f"{worst[1]['tolerance']:.4g}", flush=True)
    print(f"profile ({XLSTM_ARCH} train step, one group of {cfg.slstm_every} layers, {pb} x "
          f"{ps}): device {prof['device_ms']:.1f} ms ({prof['device_ms_by']}), wall "
          f"{prof['wall_ms_profiled']:.1f} ms profiled, {prof['unprofiled_wall_ms']:.1f} "
          "unprofiled, busy "
          f"{pct(prof['device_busy_share'])} of the unprofiled step's wall time; sLSTM loop "
          f"{pct(slstm_share['train step']['device'])} of the device time, "
          f"{pct(slstm_share['train step']['host'])} of the host's; " + ", ".join(
              f"{k} {v:.1f}" for k, v in prof["by_group_ms"].items())
          + f"; the positions' share of a {b} x {s} step's wall time "
          f"{pct(positions_share)} (its median {step_ms:.1f} ms against {short_ms:.1f} at "
          f"{qb} x {qs})"
          + f"; the xLSTM phase took {phase_s:.1f} s (" + ", ".join(
              f"{k} {v:.1f}" for k, v in parts.items()) + f") [{card}]", flush=True)
    report["xlstm"] = {
        "config": {"arch": XLSTM_ARCH, "n_layers": cfg.n_layers, "groups": g,
                   "mlstm_per_group": mpg, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                   "head_dim": cfg.head_dim, "ssm_chunk": cfg.ssm_chunk, "dtype": cfg.dtype,
                   "params": n_params, "train": [b, s], "steps": XLSTM_TRAIN_STEPS,
                   "accum": XLSTM_ACCUM, "lr": TRAIN_LR, "other": XLSTM_OTHER,
                   "profile": XLSTM_PROFILE},
        "slstm_ops_per_position": ops,
        "serve": {"waves": [f"{LM_SLOTS} x {p}" for p in LM_PROMPTS], "new_tokens": LM_NEW,
                  "prefill_ms_per_wave": prefill_ms, "decode_ms_per_token": decode_ms_tok,
                  "tokens_per_s_per_wave": tok_s, "peak_mem_gb": peak_gb, "cache": cache,
                  "against_other_chunk": vs, "decode_drift": drift, "profile": serve_profile},
        "train": {"runs": trains, "profile_one_group": train_profile,
                  "step_ms_at_positions": short_ms, "against_other_chunk": grads},
        "slstm_share": slstm_share, "positions_share_of_step": positions_share,
        "phase_s": phase_s, "phase_s_by_part": parts,
    }


# The sharded LM phase: phi3.5-moe-42b at full width over a (data 2, model
# 2) mesh of four rank processes sharing the card over gloo (NCCL refuses
# two ranks on one card). LM_MESH_TRAIN_LAYERS layers are trained with the
# recipe of the reference's distributed test (AdamW 1e-3, clipped at 1.0;
# 4 x 512 tokens a step, 2 rows a data rank) and LM_MESH_LAYERS served.
# Two trained layers fit (14.7-16.1 GB a rank) but took 13-16 s a step,
# 12-15 s of it gloo on 'data' (PERF.md §6), so one is trained.
LM_MESH_SHAPE = (2, 2)  # (data, model)
LM_MESH_LAYERS, LM_MESH_TRAIN_LAYERS = 2, 1
LM_MESH_ROWS, LM_MESH_SEQ, LM_MESH_STEPS, LM_MESH_LR = 4, 512, 3, 1e-3
LM_MESH_PROMPT, LM_MESH_NEW = 512, 8
LM_MESH_DIR = ROOT / "build" / "lm_mesh"
LM_MESH_BOUND = 5e-2  # the reference's bound on loss and parameters
MOE_WEIGHTS = ("wg", "wu", "wd")  # the expert weights


def lm_mesh_cfg(layers: int = LM_MESH_LAYERS):
    return dataclasses.replace(lm_configs.get(MOE_ARCH), n_layers=layers, attn_impl="flash")


def cpu_rehearsal() -> None:
    """For a rehearsal of a rank program on the CPU, where no kernel
    launches and no card is: each plain flash forward and backward counts
    as a wgmma launch, and the card's memory calls answer nothing."""
    fwd, bwd = ops.flash_attention, flash_attention.flash_attention_bwd

    def fwd_counted(*args, **kw):
        flash_attention.launches += 1
        flash_attention.route_launches["wgmma"] += 1
        return fwd(*args, **kw)

    def bwd_counted(*args, **kw):
        flash_attention.bwd_launches += 1
        flash_attention.bwd_route_launches["wgmma"] += 1
        return bwd(*args, **kw)

    ops.flash_attention, flash_attention.flash_attention_bwd = fwd_counted, bwd_counted
    for name, value in (("empty_cache", None), ("reset_peak_memory_stats", None),
                        ("max_memory_allocated", 0)):
        setattr(torch.cuda, name, lambda *a, _v=value, **k: _v)


def lm_mesh_requests(cfg) -> list:
    """LM_MESH_ROWS seeded requests of LM_MESH_PROMPT tokens, LM_MESH_NEW new."""
    return lm_requests(cfg, np.random.default_rng(SEED + 32), slots=LM_MESH_ROWS,
                       prompts=(LM_MESH_PROMPT,), new=LM_MESH_NEW)


def param_paths(cfg) -> list:
    """Each parameter's dotted path, in ``tree_leaves`` order."""
    return tree_leaves(TT.map_schema(lambda path, e: ".".join(path), TT.param_schema(cfg)))


def model_axis_bytes(by_tag: dict) -> dict:
    """A step's realized bytes on the 'model' axis (``ByteRecorder.by_tag``:
    (kind, tag) -> bytes) by what they carry: the expert weights' gathers,
    any gradient's reduction, the MoE activations (the output's psum and
    its input's gradient), the router's share (the combine weights'
    gradient, which carries wr's), the dense weights' gathers, the rest."""
    out = dict.fromkeys(("expert weights", "gradients", "moe activations", "router",
                         "dense weights", "other"), 0)
    for (_, tag), n in by_tag.items():
        path = tag.split(":", 1)[-1].split(".")
        if tag.startswith("param:") and path[-2:-1] == ["moe"] and path[-1] in MOE_WEIGHTS:
            out["expert weights"] += n
        elif tag.startswith("grad:"):
            out["gradients"] += n
        elif tag in ("moe.out", "moe.x.grad"):
            out["moe activations"] += n
        elif tag == "moe.weights.grad":
            out["router"] += n
        elif tag.startswith("param:"):
            out["dense weights"] += n
        else:
            out["other"] += n
    return out


def check_model_axis(tag: str, by_tag: dict, activations: int) -> dict:
    """No expert weight and no gradient on 'model', and ``activations``
    bytes of MoE activations (one psum a layer each way)."""
    got = model_axis_bytes(by_tag)
    if got["expert weights"] or got["gradients"]:
        raise AssertionError(f"{tag}: expert weights or gradients crossed 'model': {got}")
    if got["moe activations"] != activations:
        raise AssertionError(f"{tag}: MoE activations on 'model' {got['moe activations']} "
                             f"B, expected {activations}")
    return got


def gap_filtered_tokens(tag: str, got: np.ndarray, want: np.ndarray, gaps: np.ndarray,
                        err: float) -> dict:
    """Greedy tokens (rows, steps) against the reference's where its top-2
    logit gap ``gaps`` exceeds ``err``: each row is compared up to its first
    step whose gap is ``err`` or less (there the paths may pick apart, and
    every later step follows its pick). Fails on a compared token that
    differs; how many were compared is a figure, not a gate (at random
    weights the gaps may all lie within the error)."""
    compared = 0
    for r in range(want.shape[0]):
        for t in range(want.shape[1]):
            if gaps[r, t] <= err:
                break
            if got[r, t] != want[r, t]:
                raise AssertionError(f"{tag}: row {r} step {t}: token {got[r, t]}, the "
                                     f"reference's {want[r, t]} (top-2 gap {gaps[r, t]:.4g} "
                                     f"> {err:.4g})")
            compared += 1
    return {"compared": compared, "tokens": int(want.size), "err": err}


@contextlib.contextmanager
def decode_logits_into(out: list):
    """Inside the block, each decode that the serving steps of
    ``launch.steps`` run appends its logits (f32, on the host) to ``out``:
    the engine's own decode steps, observed as they run."""
    from repro_torch.launch import steps

    orig = steps.decode_step

    def kept(*args, **kwargs):
        logits, cache = orig(*args, **kwargs)
        out.append(logits.float().cpu())
        return logits, cache

    steps.decode_step = kept
    try:
        yield out
    finally:
        steps.decode_step = orig


def top2_gap(logits: torch.Tensor) -> torch.Tensor:
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def lm_mesh_single(dev: torch.device, train_cfg, cfg) -> dict:
    """The single-device results on the card, on the ranks' weights and
    batches: run A's steps at ``train_cfg`` (losses; the final parameters
    on the host, by path); serving at ``cfg`` with each data shard's rows
    as one wave of the single-device engine (the sharded prefill gives
    each shard its own expert capacity, as the reference's does): the
    engine's tokens, each wave's bf16 prefill logits and the f32 chunked
    path's, their last position's routes, and each greedy step's logits
    and top-2 gap."""
    batches = list(synthetic_batches(train_cfg, LM_MESH_ROWS, LM_MESH_SEQ, LM_MESH_STEPS, SEED,
                                     dev))
    res, params, state, _, _ = train_lm(train_cfg, adamw(LM_MESH_LR, max_grad_norm=1.0),
                                        batches, 1, 0.0, dev)
    out = {"loss": res["loss"], "step_ms": res["step_ms"], "peak_gb": res["peak_mem_gb"],
           "params": dict(zip(param_paths(train_cfg), param_copy(params)))}
    del params, state
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    requests = lm_mesh_requests(cfg)
    half = LM_MESH_ROWS // LM_MESH_SHAPE[0]
    engine = ServingEngine(cfg, params, slots=half, max_len=LM_MESH_PROMPT + LM_MESH_NEW,
                           device=dev)
    out["tokens"] = np.stack([c.tokens for c in engine.run(requests)])
    prefill = make_prefill_step(cfg, max_len=engine.max_len)
    waves = [wave_batch(cfg, requests[i:i + half], dev) for i in range(0, LM_MESH_ROWS, half)]
    l16, r16, gaps, toks, decoded = [], [], [], [], []
    for batch in waves:
        with recorded_routes() as rr:
            tok, logits, cache = prefill(params, batch)
        l16.append(logits.float().cpu())
        r16.append(last_routes(rr, half))
        steps, step_logits = [tok], [logits.float().cpu()]
        for _ in range(LM_MESH_NEW - 1):
            logits, cache = TT.decode_step(params, cfg, steps[-1][:, None], cache)
            steps.append(torch.argmax(logits, dim=-1).to(torch.int32))
            step_logits.append(logits.float().cpu())
        toks.append(torch.stack(steps, 1).cpu())
        decoded.append(torch.stack(step_logits, 1))
        gaps.append(top2_gap(decoded[-1]))
    if not np.array_equal(torch.cat(toks).numpy(), out["tokens"]):
        raise AssertionError("lm mesh: the single-device steps' tokens are not its engine's")
    params32 = to_f32(params)
    del params, engine
    f32 = dataclasses.replace(cfg, dtype="float32", attn_impl="chunked")
    l32, r32 = [], []
    for batch in waves:
        with recorded_routes() as rr:
            _, logits, _ = make_prefill_step(f32, max_len=LM_MESH_PROMPT + LM_MESH_NEW)(
                params32, to_f32(batch))
        l32.append(logits.float().cpu())
        r32.append(last_routes(rr, half))
    del params32
    torch.cuda.empty_cache()
    out.update(l16=torch.cat(l16), l32=torch.cat(l32), gaps=torch.cat(gaps).numpy(),
               routes=[torch.cat(r16), torch.cat(r32)], decoded=torch.cat(decoded))
    return out


def lm_mesh_rank(rank: int, dev: torch.device, out_dir: str, train_cfg, cfg,
                 tokens: np.ndarray) -> None:
    """``lm_mesh_ranked``, its traceback written to ``out_dir/rank{rank}.err``
    if it raises (a rank that fails first closes its peers' connections,
    and the peers' errors would hide its own)."""
    try:
        lm_mesh_ranked(rank, dev, out_dir, train_cfg, cfg, tokens)
    except BaseException:
        import traceback

        (pathlib.Path(out_dir) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def lm_mesh_ranked(rank: int, dev: torch.device, out_dir: str, train_cfg, cfg,
                   tokens: np.ndarray) -> None:
    """One of the four rank processes of the sharded LM phase, on the (data,
    model) mesh over gloo: run A twice at ``train_cfg`` from the seeded
    weights, sharded by ``param_specs`` (each step's wall ms, collective ms
    by axis, bytes by axis and kind, and the 'model' axis's bytes by tag;
    flash launches by route; peak memory; the second run's last step
    profiled for its device time); whether the two runs' losses and
    parameter shards are bitwise equal and every holder of a block holds
    the same bits; the first run's final shards to
    ``out_dir/rank{rank}_params.pt``; then ``ServingEngine`` on the mesh at
    ``cfg`` under ``serving_rules`` placement on the LM_MESH_ROWS requests
    (its tokens), and its prefill and decode steps teacher-forced on the
    single device's ``tokens`` (each step's logits). Writes the results to
    ``out_dir/rank{rank}.pt``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.sharding import map_specs, named, param_specs, serving_rules
    from repro_torch.sharding.rules import entry_axes

    if dev.type == "cpu":
        cpu_rehearsal()
    # Four ranks share the host's cores: no rank's thread pool takes them all.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (LM_MESH_SHAPE[0] * LM_MESH_SHAPE[1])))
    mesh = make_lm_mesh(*LM_MESH_SHAPE, backend="gloo", device=dev)
    groups = {id(a.group): a.name for a in mesh.axes}
    out: dict = {"rank": rank, "coords": [a.index for a in mesh.axes]}

    def shards_of(cfg, specs: dict) -> dict:
        full = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        shards = map_specs(lambda s, w: named(mesh, s).shard(w), specs, full)
        del full
        torch.cuda.empty_cache()
        return shards

    def replicas_agree(spec, x) -> bool:
        ok = True
        for a in mesh.axes:
            if a.size > 1 and all(a.name not in entry_axes(spec, d) for d in range(len(spec))):
                every = collectives.gather(x[None], a, 0)
                ok &= all(torch.equal(every[i], x) for i in range(a.size))
        return ok

    specs = param_specs(train_cfg, mesh)
    batches = list(synthetic_batches(train_cfg, LM_MESH_ROWS, LM_MESH_SEQ, LM_MESH_STEPS, SEED,
                                     dev))
    orig, calls = torch.distributed.all_reduce, []

    def timed(tensor, *args, group=None, **kwargs):
        _sync(dev)
        t0 = time.perf_counter()
        res = orig(tensor, *args, group=group, **kwargs)
        _sync(dev)
        calls.append((groups.get(id(group), "world"), 1e3 * (time.perf_counter() - t0)))
        return res

    runs, first = [], None
    for run in range(2):
        shards = shards_of(train_cfg, specs)
        opt = adamw(LM_MESH_LR, max_grad_norm=1.0)
        state = opt.init(shards)
        step = make_train_step(train_cfg, opt, mesh, ("data",), grad_specs=specs)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        steps = []
        torch.distributed.all_reduce = timed
        try:
            for i, b in enumerate(batches):
                rec, n0 = collectives.ByteRecorder(), len(calls)
                # The second run's last step under the profiler, for its device
                # time; every rank traces the same step, once, and only the
                # device (the trace's parse grows with its events).
                traced = run == 1 and i == len(batches) - 1 and dev.type == "cuda"
                _sync(dev)
                t0 = time.perf_counter()
                with collectives.recording(rec), (
                        profile(activities=[ProfilerActivity.CUDA]) if traced
                        else contextlib.nullcontext()) as prof:
                    shards, state, m = step(shards, state, b)
                    _sync(dev)
                wall = 1e3 * (time.perf_counter() - t0)
                if traced:
                    rows = device_rows(prof)
                    out["device_ms"] = sum(ms for _, ms, _ in rows) if rows else None
                nbytes, coll = collections.Counter(), collections.Counter()
                for e in rec.events:
                    if e.axis_size > 1:
                        nbytes[f"{e.axis} {e.kind}"] += e.bytes
                for axis, ms in calls[n0:]:
                    coll[axis] += ms
                if rank == 0:
                    print(f"lm mesh rank 0, run {run} step {len(steps)}: {wall:.0f} ms, "
                          f"collectives {dict(coll)} ms, peak "
                          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GB", flush=True)
                steps.append({"loss": float(m["loss"]), "ce": float(m["ce"]),
                              "aux": float(m["aux"]), "wall_ms": wall,
                              "collective_ms": dict(coll), "bytes": dict(nbytes),
                              "model_by_tag": rec.by_tag("model")})
        finally:
            torch.distributed.all_reduce = orig
        runs.append({"steps": steps, "fwd": dict(flash_attention.route_launches),
                     "bwd": dict(flash_attention.bwd_route_launches),
                     "peak_gb": torch.cuda.max_memory_allocated() / 2**30})
        leaves = [t.detach() for t in tree_leaves(shards)]
        if run == 0:
            first = [t.clone() for t in leaves]
            torch.save(dict(zip(param_paths(train_cfg), [t.cpu() for t in leaves])),
                       pathlib.Path(out_dir) / f"rank{rank}_params.pt")
        else:
            out["bitwise"] = (all(torch.equal(a, b) for a, b in zip(first, leaves))
                              and [s["loss"] for s in runs[0]["steps"]]
                              == [s["loss"] for s in steps])
            agree: list = []
            map_specs(lambda s, w: agree.append(replicas_agree(s, w.detach())), specs, shards)
            out["replicas_agree"] = all(agree)
            del first
        del shards, state, step, leaves
        torch.cuda.empty_cache()
    out["runs"] = runs
    out.setdefault("device_ms", None)
    sspecs = param_specs(cfg, mesh, serving_rules())
    shards = shards_of(cfg, sspecs)
    requests = lm_mesh_requests(cfg)
    engine = ServingEngine(cfg, shards, slots=LM_MESH_ROWS,
                           max_len=LM_MESH_PROMPT + LM_MESH_NEW, device=dev, mesh=mesh,
                           specs=sspecs)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    done = engine.run(requests)
    out["serve"] = {"tokens": np.stack([c.tokens for c in done]),
                    "prefill_ms": 1e3 * done[0].prefill_s,
                    "decode_ms": 1e3 * done[0].decode_s / (LM_MESH_NEW - 1),
                    "fwd": dict(flash_attention.route_launches),
                    "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
    # Teacher-forced on the single device's tokens, through the engine's own
    # prefill and decode steps (their working sets are gathered already);
    # each decode's logits are taken as it runs.
    _, logits, cache = engine._prefill(shards, wave_batch(cfg, requests, dev))
    steps = [logits.float().cpu()]
    fed = torch.as_tensor(tokens, device=dev)
    with decode_logits_into(steps):
        for t in range(LM_MESH_NEW - 1):
            _, cache = engine._decode(shards, fed[:, t:t + 1], cache)
    out["serve"]["logits"] = logits.float().cpu()
    out["serve"]["decoded"] = torch.stack(steps, 1)
    torch.save(out, pathlib.Path(out_dir) / f"rank{rank}.pt")


def lm_mesh_param_gap(cfg, ranks: list, single: dict, dev) -> float:
    """The largest |difference| of any parameter element between the ranks'
    shards (``rank{r}_params.pt``) and the single device's, each rank's
    block of it cut by the rank's coordinates and ``param_specs``."""
    from repro_torch.launch.mesh import Mesh, MeshAxis
    from repro_torch.sharding import map_specs, param_specs
    from repro_torch.sharding.rules import P, reshard

    worst = 0.0
    for rk in ranks:
        held = torch.load(LM_MESH_DIR / f"rank{rk['rank']}_params.pt", mmap=True)
        view = Mesh(tuple(MeshAxis(name, size, i, None, dry=True) for name, size, i in
                          zip(("data", "model"), LM_MESH_SHAPE, rk["coords"])), dev, None)
        specs: list = []
        map_specs(specs.append, param_specs(cfg, view))
        for path, spec in zip(param_paths(cfg), specs):
            want = reshard(single["params"][path], view, P(), spec)
            diff = (held[path].to(dev).float() - want.to(dev).float()).abs().max()
            worst = max(worst, float(diff))
    return worst


def drive_lm_mesh(dev: torch.device, report: dict, cfg=None) -> None:
    """The sharded LM phase: the single-device results first
    (``lm_mesh_single``, on the same card, freed before the ranks start),
    then the four rank processes (``lm_mesh_rank``), then the gates, none
    caught: both sharded runs bitwise on every rank; every holder of a
    block the same bits; losses and every parameter within LM_MESH_BOUND
    of the single device's; on 'model' no expert weight and no gradient,
    the MoE activations one psum a layer each way; 2L forward and L
    backward flash launches a microbatch on every rank, all on the wgmma
    routes; the sharded prefill logits within twice the single device's
    bf16 error against f32 on the rows the two route alike; greedy tokens
    over LM_MESH_NEW steps equal where the single device's top-2 gap
    exceeds that bound (``gap_filtered_tokens``). Prints step, collective,
    memory and serving figures by rank. ``cfg`` is ``lm_mesh_cfg()``'s
    unless given."""
    from repro_torch.launch import mesh as launch_mesh

    t_phase = time.perf_counter()
    card = report.get("nvidia_smi", "card not queried")
    cfg = cfg or lm_mesh_cfg()
    train_cfg = dataclasses.replace(cfg, n_layers=LM_MESH_TRAIN_LAYERS)
    tag = (f"lm mesh ({cfg.name}, {train_cfg.n_layers} layers trained, {cfg.n_layers} served; "
           f"(data, model) {LM_MESH_SHAPE})")
    single = lm_mesh_single(dev, train_cfg, cfg)
    single_s = time.perf_counter() - t_phase
    shutil.rmtree(LM_MESH_DIR, ignore_errors=True)
    LM_MESH_DIR.mkdir(parents=True)
    world = LM_MESH_SHAPE[0] * LM_MESH_SHAPE[1]
    t0 = time.perf_counter()
    try:
        launch_mesh.spawn(lm_mesh_rank, world, (str(LM_MESH_DIR), train_cfg, cfg,
                                                 single["tokens"]), backend="gloo", device=dev)
    except Exception:
        for err in sorted(LM_MESH_DIR.glob("rank*.err")):
            print(f"{err.name}:\n{err.read_text()}", file=sys.stderr, flush=True)
        raise
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(LM_MESH_DIR / f"rank{r}.pt", weights_only=False) for r in range(world)]
    for rk in ranks:
        if not (rk["bitwise"] and rk["replicas_agree"]):
            raise AssertionError(f"{tag}: rank {rk['rank']}: two runs bitwise "
                                 f"{rk['bitwise']}, every holder of a block the same bits "
                                 f"{rk['replicas_agree']}")
    losses = [s["loss"] for s in ranks[0]["runs"][0]["steps"]]
    if any([s["loss"] for s in rk["runs"][0]["steps"]] != losses for rk in ranks):
        raise AssertionError(f"{tag}: the ranks report other losses")
    loss_gap = max(abs(a - b) for a, b in zip(losses, single["loss"]))
    param_gap = lm_mesh_param_gap(train_cfg, ranks, single, dev)
    if not (loss_gap < LM_MESH_BOUND and param_gap < LM_MESH_BOUND):
        raise AssertionError(f"{tag}: against the single device: loss gap {loss_gap}, "
                             f"parameter gap {param_gap} (bound {LM_MESH_BOUND})")
    # One psum a layer each way of a data shard's tokens in bf16.
    rows = LM_MESH_ROWS // LM_MESH_SHAPE[0]
    activations = 2 * train_cfg.n_layers * rows * LM_MESH_SEQ * cfg.d_model * 2
    model_bytes = [check_model_axis(f"{tag}: rank {rk['rank']} step {i}", s["model_by_tag"],
                                    activations)
                   for rk in ranks for i, s in enumerate(rk["runs"][0]["steps"])]
    micro = LM_MESH_STEPS
    for rk in ranks:
        run = rk["runs"][0]
        want = ({"wgmma": 2 * train_cfg.n_layers * micro},
                {"wgmma": train_cfg.n_layers * micro})
        got = ({k: v for k, v in run["fwd"].items() if v}, {k: v for k, v in run["bwd"].items()
                                                            if v})
        if got != want:
            raise AssertionError(f"{tag}: rank {rk['rank']}: flash launches (forward, "
                                 f"backward) by route {got}, expected {want}")
    # Serving: the sharded prefill's logits against each shard's single wave.
    agree = route_agreement(f"{tag} prefill", single["routes"], (LM_MESH_ROWS,))
    v = cfg.vocab_size
    err = float((single["l16"] - single["l32"])[:, :v].abs().amax(-1)[agree].max())
    gaps_seen = {"prefill": 0.0, "decoded": 0.0}
    for rk in ranks:
        got = rk["serve"]["logits"]
        gap = float((got - single["l16"])[:, :v].abs().amax(-1)[agree].max())
        gaps_seen["prefill"] = max(gaps_seen["prefill"], gap)
        if not gap <= 2 * err:
            raise AssertionError(f"{tag}: rank {rk['rank']}: prefill logits {gap:.4g} from "
                                 f"the single device's, over twice its bf16 error {err:.4g}")
        tokens = gap_filtered_tokens(f"{tag}: rank {rk['rank']} decode", rk["serve"]["tokens"],
                                     single["tokens"], single["gaps"], 2 * err)
        decoded = float((rk["serve"]["decoded"] - single["decoded"])[..., :v].abs().amax(-1)
                        [agree].max())
        gaps_seen["decoded"] = max(gaps_seen["decoded"], decoded)
        if not decoded <= 2 * err:
            raise AssertionError(f"{tag}: rank {rk['rank']}: teacher-forced decode logits "
                                 f"{decoded:.4g} from the single device's, over twice its bf16 "
                                 f"error {err:.4g}")
    phase_s = time.perf_counter() - t_phase
    step_ms = [[s["wall_ms"] for s in rk["runs"][0]["steps"]] for rk in ranks]
    coll = [{axis: round(np.median([s["collective_ms"].get(axis, 0.0)
                                    for s in rk["runs"][0]["steps"][1:]]), 1)
             for axis in ("data", "model")} for rk in ranks]
    summary = {
        "config": {"arch": cfg.name, "layers": cfg.n_layers,
                   "train_layers": train_cfg.n_layers, "mesh": LM_MESH_SHAPE,
                   "tokens_a_step": [LM_MESH_ROWS, LM_MESH_SEQ], "steps": LM_MESH_STEPS,
                   "serve": [LM_MESH_ROWS, LM_MESH_PROMPT, LM_MESH_NEW]},
        "losses": losses, "single_losses": single["loss"], "loss_gap": loss_gap,
        "param_gap": param_gap, "step_ms_by_rank": step_ms,
        "device_ms_by_rank": [rk["device_ms"] for rk in ranks],
        "collective_ms_by_rank": coll,
        "bytes_a_step": ranks[0]["runs"][0]["steps"][-1]["bytes"],
        "model_axis_bytes": model_bytes[0], "peak_gb_by_rank": [
            max(r["peak_gb"] for r in rk["runs"]) for rk in ranks],
        "serve_peak_gb_by_rank": [rk["serve"]["peak_gb"] for rk in ranks],
        "prefill_ms_by_rank": [rk["serve"]["prefill_ms"] for rk in ranks],
        "decode_ms_by_rank": [rk["serve"]["decode_ms"] for rk in ranks],
        "single": {"step_ms": single["step_ms"], "peak_gb": single["peak_gb"]},
        "prefill_err": err, "tokens": tokens, "rows_routed_alike": int(agree.sum()),
        "prefill_gap": gaps_seen["prefill"], "decoded_gap": gaps_seen["decoded"],
        "single_s": single_s, "ranks_s": ranks_s, "phase_s": phase_s,
    }
    report["lm_mesh"] = summary
    print(f"{tag}: two runs bitwise on every rank, every block's holders the same bits; "
          f"losses {' '.join(f'{x:.4f}' for x in losses)} (single device "
          f"{' '.join(f'{x:.4f}' for x in single['loss'])}; gap {loss_gap:.3g}), parameters "
          f"within {param_gap:.3g} (bound {LM_MESH_BOUND}); flash launches a microbatch "
          f"{2 * train_cfg.n_layers} forward, {train_cfg.n_layers} backward on every rank "
          "(wgmma)",
          flush=True)
    print(f"{tag}: step ms by rank {step_ms}; device ms a step by rank "
          f"{summary['device_ms_by_rank']}; collective ms a step (median of steps 2-"
          f"{LM_MESH_STEPS}) by rank {coll}; bytes a step by axis and kind "
          f"{summary['bytes_a_step']}; on 'model' {model_bytes[0]}; peak GB by rank "
          f"{[round(x, 2) for x in summary['peak_gb_by_rank']]} [{card}]", flush=True)
    print(f"{tag}: serving under serving_rules: prefill {LM_MESH_ROWS} x {LM_MESH_PROMPT} "
          f"ms by rank {[round(x, 1) for x in summary['prefill_ms_by_rank']]}, decode ms a "
          f"token {[round(x, 2) for x in summary['decode_ms_by_rank']]}; prefill logits "
          f"within twice the single device's bf16 error {err:.4g} on "
          f"{summary['rows_routed_alike']} of {LM_MESH_ROWS} rows, teacher-forced decode "
          f"logits within {summary['decoded_gap']:.4g}; greedy tokens equal on "
          f"{tokens['compared']} of {tokens['tokens']} (top-2 gap above {2 * err:.4g}); single "
          f"device {single_s:.1f} s, ranks {ranks_s:.1f} s, phase {phase_s:.1f} s [{card}]",
          flush=True)


def ptxas_kernels(lines: list) -> list:
    """Each kernel of a ``-Xptxas -v`` log (its lines holding "registers",
    "spill" or "wgmma"): the function, its registers, its spill bytes and
    whether a notice says its wgmma instructions were serialized."""
    out, fn = [], None
    serialized = [ln for ln in lines if "wgmma" in ln and "serialized" in ln]
    for ln in lines:
        if "Function properties for" in ln:
            fn = {"function": ln.split("for", 1)[1].strip(), "registers": None,
                  "spill_stores": 0, "spill_loads": 0, "serialized": False}
            out.append(fn)
        elif fn is not None and "spill stores" in ln:
            parts = ln.replace(",", " ").split()
            fn["spill_stores"] = int(parts[parts.index("spill") - 2])
            fn["spill_loads"] = int(parts[len(parts) - 4])
        elif fn is not None and "Used" in ln and "registers" in ln:
            fn["registers"] = int(ln.split("Used")[1].split()[0])
            fn = None
    for k in out:
        k["serialized"] = any(k["function"] in ln for ln in serialized)
    return out


def trav_label(fn: str) -> str:
    """A traversal kernel's name with its mangled template arguments, as
    ``walk_staged<ifLi2>``."""
    name = re.search(r"narrow_kernel|walk_staged|walk_global|sum_kernel", fn).group(0)
    args = re.search(name + r"I(\w+?)E+v", fn)
    return name + (f"<{args.group(1)}>" if args else "")


def split_label(fn: str) -> str:
    """A split-gain kernel's name with its template arguments, as
    ``split_kernel<2, decide>``."""
    m = re.search(r"split_kernelILi(\d+)ELb([01])E", fn)
    return (f"split_kernel<{m.group(1)}, {'decide' if m.group(2) == '1' else 'surface'}>"
            if m else fn[:40])


PHASE_S: dict = {}  # each phase of ``main``: its wall seconds


def phase(name: str, fn, *args):
    """``fn(*args)``, its wall seconds kept in ``PHASE_S[name]`` and printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[name] = time.perf_counter() - t0
    print(f"phase {name}: {PHASE_S[name]:.1f} s", flush=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # f32 products in full f32 (the smoke's f32 reference), never TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report: dict = {"nvidia_smi": smi, "torch": torch.__version__,
                    "cuda": torch.version.cuda,
                    "l2_bytes": torch.cuda.get_device_properties(0).L2_cache_size}

    # Phase 1: build.
    libs = phase("build", _build.build_all)
    report["build_s"] = PHASE_S["build"]
    print(f"build: {len(libs)} kernel libraries in {report['build_s']:.1f} s", flush=True)
    for name, lib in libs.items():
        log = (lib.parent / f"{name}.log").read_text()
        report[f"ptxas_{name}"] = [ln for ln in log.splitlines() if "registers" in ln
                                   or "spill" in ln or "wgmma" in ln
                                   or "Function properties" in ln]
    for lib, names in (("flash_attention", ("flash_fwd_wgmma",)),
                       ("flash_attention_bwd", ("flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma"))):
        for kname in names:
            wgmma = [k for k in ptxas_kernels(report[f"ptxas_{lib}"])
                     if kname in k["function"]]
            print(f"ptxas, {kname}<D>: " + "; ".join(
                "<" + ", ".join(re.findall(r"L[ib](\d+)E", k["function"])) + f"> "
                f"{k['registers']} registers, spills {k['spill_stores']}/{k['spill_loads']} "
                "bytes" for k in wgmma), flush=True)
            bad = [k for k in wgmma
                   if k["spill_stores"] or k["spill_loads"] or k["serialized"]]
            if len(wgmma) != 2 or bad:
                raise AssertionError(f"{kname}: two instances expected (d 64, 128); ptxas "
                                     f"spilled or serialized the wgmma: {bad or wgmma}")
    # The fused level's one kernel and the staged histogram's chain.
    for lib, names in (("level_build", ("level_kernel",)),
                       ("histogram", ("count_kernel", "place_kernel", "tile_kernel"))):
        every = ptxas_kernels(report[f"ptxas_{lib}"])  # kernels and device functions
        ks = [k for k in every if k["registers"] is not None]
        print(f"ptxas, {lib}: " + "; ".join(
            f"{next((n for n in names if n in k['function']), k['function'][:40])} "
            f"{k['registers']} registers, spills {k['spill_stores']}/{k['spill_loads']} bytes"
            for k in ks), flush=True)
        bad = [k for k in every if k["spill_stores"] or k["spill_loads"]]
        if sorted(n for k in ks for n in names if n in k["function"]) != sorted(names) or bad:
            raise AssertionError(f"{lib}: kernels {names} expected, none spilling: "
                                 f"{bad or ks}")
    split = ptxas_kernels(report["ptxas_split_scan"])
    print("ptxas, split_scan <bins a lane, form>: " + "; ".join(
        f"{split_label(k['function'])} {k['registers']} registers, spills "
        f"{k['spill_stores']}/{k['spill_loads']} bytes" for k in split), flush=True)
    bad = [k for k in split if k["spill_stores"] or k["spill_loads"]]
    if len(split) != SPLIT_INSTANCES or bad:
        raise AssertionError(f"split_scan: {SPLIT_INSTANCES} instances expected, none "
                             f"spilling: {bad or split}")
    trav = ptxas_kernels(report["ptxas_forest_traversal"])
    print("ptxas, forest_traversal (template arguments mangled): " + "; ".join(
        f"{trav_label(k['function'])} {k['registers']} registers, spills "
        f"{k['spill_stores']}/{k['spill_loads']} bytes"
        for k in trav), flush=True)
    bad = [k for k in trav if k["spill_stores"] or k["spill_loads"]]
    if len(trav) != TRAV_INSTANCES or bad:
        raise AssertionError(f"forest_traversal: {TRAV_INSTANCES} instances expected, none "
                             f"spilling: {bad or trav}")
    # Both GBDT main paths run before any kernel check (see ``drive``); the
    # realsim checks take every pending device time, the multiclass
    # checks' too.
    cuda = torch.device("cuda")
    gbdt = phase("drive", drive, cuda)
    phase("handoff", drive_handoff, gbdt, report)
    e2006 = phase("e2006", drive_e2006, cuda, gbdt)
    phase("check_e2006", check_e2006, e2006, report)
    threads = phase("threads", drive_threads, cuda, gbdt)
    threads_checked = phase("check_threads", check_threads, threads, report)
    mesh = phase("mesh", drive_mesh, cuda, gbdt)
    mesh_checked = phase("check_mesh", check_mesh, mesh, gbdt, report)
    multi = phase("multiclass", drive_multiclass, cuda, gbdt)
    checked = phase("check_multiclass", check_multiclass, multi, gbdt, report)
    e2006_shapes = phase("check_e2006_kernels", check_e2006_kernels, e2006, report)
    mesh_shapes = phase("check_mesh_kernels", check_mesh_kernels, gbdt, report)
    line = phase("check_drive", check_drive, gbdt, report)
    line += multiclass_line(multi, checked, report)
    line += e2006_line(e2006, e2006_shapes, report)
    line += threads_line(threads, threads_checked, report)
    line += mesh_line(mesh_checked, mesh_shapes)
    del gbdt, multi, e2006, threads
    line.append(phase("lm", drive_lm, cuda, report))
    line += phase("lm_train", drive_lm_train, cuda, report)
    phase("lm_packed", drive_lm_packed, cuda, report)
    line += phase("hybrid", drive_hybrid, cuda, report)
    line += phase("moe", drive_moe, cuda, report)
    line += phase("media", drive_media, cuda, report)
    phase("xlstm", drive_xlstm, cuda, report)
    phase("lm_mesh", drive_lm_mesh, cuda, report)
    report["phase_s"] = PHASE_S
    print("phase seconds: " + json.dumps({k: round(v, 1) for k, v in PHASE_S.items()}),
          flush=True)
    report["profiler_sees_device"] = _PROFILER.get("sees_device")
    report["profiler_traces_taken_again"] = _PROFILER.get("traces_taken_again", 0)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
