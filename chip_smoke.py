#!/usr/bin/env python3
"""Drive the PyTorch port (``unite_torch``) on one CUDA card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one NVIDIA H100 and the CUDA
toolkit. In order:

1. card: ``nvidia-smi`` name and power limit, CUDA version; TF32 off;
2. build: every kernel under ``unite_torch/csrc`` compiled by ``nvcc`` for
   sm_90a into ``build/unite_torch_kernels/`` (one process per source, in
   parallel), with each kernel's ptxas line (registers, spills); the
   wgmma kernels of the K3/K6 forward (csrc/flash_fwd_wgmma.cu), the
   K4/K6 backward (csrc/flash_bwd_wgmma.cu), the short forward K1/K5
   (csrc/short_attn_wgmma.cu), the short backward K2/K5
   (csrc/short_bwd_wgmma.cu) and K7 (csrc/blocked_matmul_wgmma.cu) must
   not spill, and a serialized product is reported;
3. kernels against their plain versions at the main-path shapes: K1 (fused
   qkv attention forward, csrc/short_attn_wgmma.cu) at the teacher's
   [512, 197, 2304] and the student's [64, 320, 2304], with and without the
   lse, timed beside SDPA and the K3/K6 forward on the same lanes, K2 (its
   backward, csrc/short_bwd_wgmma.cu) at [64, 320, 2304], each of
   ``BWD_REPEATS`` repeats equal bit for bit, timed beside SDPA's backward
   alone (and forward plus backward) and the K4 backward on the same
   lanes; K3
   (packed flash forward) at the stage-2 train step's [8, 1568, 2304] with
   lse and the eval step's [32, 1568, 2304] without, K4's dQ and dK/dV
   kernels at [8, 1568, 2304]; K6 (the [B, H, S, D] flash forward, dQ and
   dK/dV kernels) at the stage-3 CLS shapes [5, 12, 1569, 64] and (forward)
   [32, 12, 1569, 64] and the clip_l14_336 teacher's [40, 16, 577, 64], on
   contiguous tensors and on strided qkv views; K5 (the grouped forward, dQ
   and dK/dV kernels) at the stage-1 mask-0.75 student's [64, 12, 392, 64]
   (both layouts, backward repeats equal bit for bit), [64, 12, 512, 64] and [5, 12, 393, 64]; error, median
   time, the plain version's time, the bound, and one PyTorch call
   (``scaled_dot_product_attention``) as a yardstick, and for K2, the
   K4/K6 backward and K5's backward also the device time of back-to-back
   launches beside SDPA's backward queued the same way; the K3/K6 forward
   at every length of ``SWEEP_LENGTHS`` (around its 128-row tiles) at 2
   and 12 heads, on contiguous tensors, strided qkv views and the packed
   lanes, with and without the lse; the K4/K6 backward at the same lengths
   and heads on the packed lanes, strided views and contiguous tensors,
   each repeat equal bit for bit; the short forward (K1 and K5's
   forward) at every length of ``SHORT_LENGTHS`` at 2, 12 and 16 heads
   (K1 on packed lanes, K5 on views and contiguous tensors, with and
   without statistics, bit for bit on repeats) and with k = -q; the
   short backward (K2 and K5's backward) at the same lengths, K2 also at
   768 (2, 12 and 16 heads on the packed lanes; K5 at 2 and 12 heads on
   views and contiguous tensors), each repeat equal bit for bit;
   then K7 (csrc/blocked_matmul_wgmma.cu) at every shape of
   ``MATMUL_SWEEP`` and every tile shape (K7a, the int8 blocked matmul, bit
   for bit, also with -128s at K = 131040; K7b, bf16, within
   ``bf16_tolerance`` and equal on small integers); K7a bit for bit
   against its plain version at the probe's 38400x768x3072, the int8
   clip_l14 teacher's four dense shapes at M = 37824 and two ragged shapes,
   K7b within one bf16 ulp at the probe and ragged shapes, timed (single
   launches, and device time at every tile shape) beside ``torch._int_mm``
   and ``torch.matmul``; the probe
   (``unite_torch.tools.quant_kernel_probe``); K1 at 16 heads at the
   clip_l14 teacher's [192, 197, 3072] and K1/K2 at the ViT-L student's
   [24, 320, 3072]; the int8 clip_l14 against the bf16 one (B=2, 196^2):
   tap cosine > 0.98, CLS-row total variation < 0.05; one ViT-L/14 stage-1
   step with the int8 teacher (full widths, depth 4) on the card in bf16
   against the CPU in fp32; the cells ``stage1-l14-b24`` and
   ``stage1-l14-int8-b24`` (``bench.py::bench_large``'s geometry, B=24, 2
   warm-up and 5 timed steps, 48 K1 + 24 K2 a step, plus 96 K7a with the
   int8 teacher, and a profiled step);
4. one stage-1 step on the card in bf16 against the same step on the CPU in
   fp32 (B=2, same weights, same batch, injected visible tokens);
5. the stage-1 path ``stage1-b16-b64``: the train step at full ViT-B/16
   width and ``bench.py::main``'s geometry (B=64, 8 x 224^2, mask 0.8 ->
   320 visible tokens, clip_b16 teacher with taps 6-11, AdamW from
   configs/stage1_config.yaml), 2 warm-up and 5 timed steps, with the
   kernel launch counts read around it;
6. phase 4 at mask 0.75 (392 visible tokens: the card's student runs K5),
   then ``stage1-m075-b16-b64``: phase 5 at mask 0.75 (12 K1 + 12 K5
   forward + 12 K5 dQ + 12 K5 dK/dV a step, no K2); then
   ``stage1-remat-b64``: phase 5's step at drop path 0.1 from the same
   weights, batch and generator seeds, plain and with every student block
   recomputed in the backward (--use_checkpoint): losses and every
   parameter bit-equal after 3 steps, K1 by shape exact (the student's 12
   a step become 24), both step times and peak memories;
6b. the pretraining families: K1 at the masked CLIP teacher's
   [512, 41, 2304] and K1/K2 at the VideoMAE encoder's [32, 160, 2304],
   K3 (with lse), K4a and K4b at the VideoMAE decoder's [32, 1568, 1152]
   with 6 heads (each of ``BWD_REPEATS`` backwards bit-equal to the
   first), against their plain versions with timings beside SDPA's; one
   VideoMAE step on the card in bf16 against the CPU in fp32 (B=2, full
   width; the CPU step's operations counted by FlopCounterMode); then
   ``videomae-b16-b32``: ``pretrain_videomae_base_patch16_224`` over 16
   frames of 224^2, tubelet 2, per-clip tube masks of 0.9 (160 visible,
   1408 masked), B=32, AdamW (betas 0.9, 0.95, wd 0.05, no clip), 2
   warm-up and 5 timed steps of 12 K1 + 12 K2 + 8 K3 + 8 K4a + 8 K4b,
   with clips/s, MFU and a profiled step; ``umt-pretrain-b64``:
   ``pretrain_umt_base_patch16_224`` at 8 frames, tubelet 1, tube mask
   0.8, taps 6-11, card against CPU at B=2, then forward and backward at
   B=64 (12 K1 + 12 K2 at [64, 320] a pass); ``clip-masked``:
   ``clip_b16`` with ``return_cls`` on the same masks, card against CPU at
   B=2, then B=64 (12 K1 at [512, 41] a call);
6c. head dim 80: K1/K2 at the huge VideoMAE encoder's [16, 160, 3840] (16
   heads of 80 lanes) and K3 (with lse), K4a and K4b at its decoder's
   [16, 1568, 1920] (8 heads of 80), K5 at the encoder's [16, 16, 392, 80]
   (mask 0.75) and K6 at [2, 16, 632, 80] (mask 0.6) and
   [2, 16, 1569, 80], on views and contiguous tensors, each of
   ``BWD_REPEATS`` backwards bit-equal to the first, with timings beside
   SDPA's; the short forward and backward sweeps (K1/K5 and K2/K5 up to
   512) and the K3/K6 and K4/K6 sweeps over ``SWEEP_LENGTHS``, every
   layout, at 2 and 8 heads; one step of
   ``pretrain_videomae_huge_patch16_224`` at full widths cut to 4 encoder
   and 2 decoder blocks on the card in bf16 against the CPU in fp32 (B=2)
   at tube mask 0.9; then ``videomae-h16-b16``: the huge model at full
   width and depth (32 x 1280 encoder, 8 x 640 decoder) on the base cell's
   clips and masks at B=16, 2 warm-up and 3 timed steps of 32 K1 + 32 K2
   at [16, 160] and 8 K3 + 8 K4a + 8 K4b at [16, 1568], exact by shape,
   with clips/s, MFU, peak memory and a profiled step; the cut step again
   at masks 0.75 (4 of each K5 kernel) and 0.6 (4 of each K6 kernel); then
   ``videomae-h16-m075-b16``: the full model at tube mask 0.75, 392
   visible tokens, 32 of each K5 kernel and 8 of each decoder kernel a
   step, no K1/K2;
6a. ``native-decode``: the port's native decoder
   (unite_torch/native/videodec.cpp, g++, into build/unite_torch_native/)
   on 16 mp4v clips of 64 frames at 340x256 and a 16-frame JPEG folder
   written with OpenCV, held to OpenCV's decode within the JAX package's
   bars (plain equal; short side 224 and 224x224 sized within a mean of 4
   levels; JPEG within a mean of 2), with decode rates in frames/s at 8
   frames a clip; without FFmpeg's headers on the machine it says so and
   the recipe phase reads through OpenCV;
7. ``stage1-entry-b32x2``: ``unite_torch.train.run_stage1.main`` with no
   --config (``STAGE1_ARGS``: stage1_config.yaml and stage1.sh) on
   synthetic clips at mask 0.75, 2 x 32 clips a step, uint8 clips
   normalized on the card: one epoch of 4 steps with its checkpoint, then a
   second call that auto-resumes and is preempted after 2 steps; exact
   launch counts, and the entry's clips/s beside the step's;
8. one stage-2 step on the card in bf16 against the same step on the CPU in
   fp32 (B=2, 1568 tokens, same weights and batch, drop path 0);
9. the stage-2 path: the finetune train step of ``vit_base_patch16_224``
   over 8 frames of 224^2 with tubelet 1 (1568 tokens) at
   ``bench.py::bench_stage2``'s B=8, configured as
   configs/stage2_config.yaml (12 classes, drop path 0.1, AdamW with layer
   decay 0.65, blocks 0-6 frozen), 2 warm-up and 10 timed steps, with the
   launch counts and a profiled step;
10. the stage-2 eval step at the config's batch_size_val of 32, 2 warm-up
   and 10 timed calls, with the launch counts and a profiled call;
10a. ``optim-card-vs-cpu``: one bf16 train step at B=2 of the stage-2 ViT
   cut to 4 blocks (4 K3 with lse, 4 K4a, 4 K4b), then 8 steps of every
   --opt name of ``create_optimizer``, ``OPT_ALIASES`` and the bf16 first
   moment of ``OPT_BF16_MU`` from its gradients on the card and on the
   CPU: each tensor's update within ``OPT_RTOL`` of its norm;
10b. ``stage2-opt-b8``: phase 9's step under each of ``STAGE2_OPTS`` in
   turn, 2 warm-up and 5 timed steps, 12 K3, K4a and K4b a step: step ms,
   a profiled step, the optimizer's own device ms and kernels, peak
   memory;
11. ``stage2-entry-b7``: K3, K4a and K4b against their plain versions at
   the stage-2 entry's [7, 1568, 2304], then
   ``unite_torch.train.run_stage2.main`` with no --config
   (``STAGE2_ARGS``: stage2_config.yaml and stage2.sh) chained from the
   checkpoint that phase 7 left: 4 steps of 7 synthetic clips, validation
   (40 clips), a preemption after 2 steps of epoch 1; an auto-resumed call
   that finishes the epoch, validates, reloads checkpoint-best and runs
   the 12-view test (96 views) and its merge; an --eval call whose merged
   accuracies must equal it; 96 steps of one epoch for the steady rate,
   waited for only at steps 1, 16 and 96; exact launch counts, the
   checkpoints' epochs and steps, the entry's clips/s and views/s beside
   the bare step's and the host data path's items/s;
11a. ``stage2-recipe-b7``: the bare B=7 step plain and with the finetune
   recipe (``RECIPE``: mixup 0.8 and cutmix 1.0, smoothing 0.1, dropout
   0.1, the head's dropout 0.5, --use_checkpoint, --mu_dtype bfloat16),
   timed in turns (plain, recipe, recipe, plain; 24 K3 a step under
   remat); a train-mode forward and backward at --attn_drop_rate 0.1 that
   launches no K3 (JAX's routing to the plain attention) and its eval
   forward that launches 12; then ``run_stage2.main`` with the recipe,
   chained from phase 7's checkpoint, reading phase 6a's clips through
   ``default_reader``: 4 steps of 7, validation, a preemption after 2
   steps of epoch 1, and a resumed call that loads the bf16 first moments
   bit for bit, validates and runs the 12-view test; exact launches (24
   K3 a step and 12 an eval call, 12 K4a and 12 K4b a step), every
   decode through the expected reader and none failed, the checkpoints'
   epochs and steps, the entry's clips/s, first-step latency and peak
   memory beside the plain stage-2 entry's;
12. one stage-3 step on the card in bf16 against the CPU in fp32, without
   and with the CLS token (B=2, same weights and batch, injected teacher
   attention and CLIP similarities): loss, grad norm and the full and
   grad-member logits, with the selection agreement reported apart;
13. the stage-3 path ``stage3-b16-b5``: configs/stage3_config.yaml with
   stage3.sh's batch of 5 (adaptation_umt_base_patch16_224 over 8 x 224^2
   with tubelet 1, clip_b16 teacher, mask 0.8, committee 2,
   clip_matchORconf, AdamW), each step after the zero-shot similarities of
   its batch (text features from a seed), 2 warm-up and 10 timed steps,
   with exact launch counts (K1, K2, K3, K4; no K6) and a profiled step;
14. ``stage3-cls-b16-b5``: the same with ``use_cls_token``, whose full
   passes run 1569 tokens through K6 (no K3/K4);
15. ``stage3-cls-eval-b16-b32``: its eval step at batch_size_val 32, K6
   forward only;
16. ``stage3-entry-b5``: K1/K2 at the stage-3 entry's teacher and
   committee shapes ([40, 197, 2304], [5, 320, 2304]) and K3, K4a and K4b
   at its train shape [5, 1568, 2304] against their plain versions, then
   ``unite_torch.train.run_stage3.main`` with no --config
   (``STAGE3_ARGS``: stage3_config.yaml and stage3.sh, --epochs 2
   --warmup_epochs 0) chained from the checkpoint-best that phase 11 left
   (its blocks and head loaded bit for bit), the zero-shot teacher from
   seeded text features: the initial validation and the kNN probe, 4 steps
   of 5 source and 5 target synthetic clips (the target repeated x2),
   validation (40 clips), a preemption after 2 steps of epoch 1; an
   auto-resumed call that finishes the epoch, validates, reloads
   checkpoint-best and runs the 15-view test (120 views) and its merge; an
   --eval call that loads every weight of the combined checkpoint bit for
   bit and whose merged accuracies must equal it; 96 steps of a 97-step
   epoch for the steady rate, waited for only at steps 1, 16 and 96;
   exact launch counts, in all and K1's and K3's by shape, the
   checkpoints' epochs and steps, the entry's clips/s beside the bare
   step's, val and test views/s and the host data path's items/s;
16a. ``tool-classify``: K3 at one clip's [1, 1568, 2304] without lse
   against its plain version, and on a B=1 view with another batch stride
   bit-equal to its copy; ``unite_torch.tools.classify`` (vit_base, 8 x
   224^2, --synthetic) on phase 11's checkpoint-best and phase 16's
   combined one, exactly 12 K3 at (1, 1568) a call, its probabilities
   within ``STEP_RTOL`` of the same call with --cpu; then
   ``unite_torch.tools.export_torch`` on both, each export loaded
   strictly into the entries' models;
16b. ``tool-record-losses``: K1 at [32, 197, 2304] and K1/K2 at
   [4, 314, 2304] against their plain versions; step 0 of
   ``unite_torch.tools.record_losses`` at --batch 1 on the card against
   the CPU (loss and grad norm within ``STEP_RTOL``); the tool at its
   defaults for ``TOOL_STEPS`` steps, each exactly 12 K1 at (32, 197),
   12 K1 at (4, 314) and 12 K2, one finite JSON line a step;
17. ``scaleout-nccl-w{N}`` (N = the cards on the machine): the three
   entries launched by ``python -m torch.distributed.run --standalone
   --nproc_per_node N`` over NCCL, each rank running this script as
   ``--rank-entries`` (seven calls of the entries' own parsers and
   ``main``, the launch counters read around each): stage 1
   (``STAGE1_ARGS``, an epoch of 2 steps of 32 + 32 clips a rank) under
   DDP, --zero1 and --fsdp; stage 2
   chained from the DDP checkpoint and stage 3 from stage 2's
   checkpoint-best, each under DDP and --fsdp, with validation and the
   multi-view test; every rank's launches held to the single-process
   entries' counts, any rank's non-zero exit fails, and every checkpoint
   restored into one process bit for bit;
18. ``scaleout-step-b64``: phase 5's step at world 1 over NCCL, plain,
   under DDP and under FSDP from the same weights, 3 steps in turns (DDP
   bit-equal to the plain step, FSDP within ``STEP_RTOL``), then timed
   in turns: step ms, peak memory, DDP's and FSDP's overhead;
19. ``scaleout-gloo-2on1``: two ranks on the one card over gloo (CUDA
   tensors), the full-width stage-1 step on 2 x 8 clips under DDP and
   --zero1 against the one-process step on the 16: losses, grad norms and
   the 3 steps' update within ``STEP_RTOL``, ZeRO-1's moment bytes a
   rank at most 0.6 of DDP's. With two cards or more, --fsdp and --tp 2
   over NCCL at world N against world 1 the same way (on one card it
   says that this check needs two and goes on);
19a. ``scaleout-gloo-2on1-lamb``: phase 19 under --zero1 with
   --opt lamb on both sides (the trust ratio's norms summed over the
   slices);
20. one JSON line of every kernel's numbers, the card line again, and the
   last line ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero. With no CUDA device,
or run outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from functools import partial
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s
PEAK_BF16 = 989e12     # H100 SXM dense bf16 tensor-core flop/s
PEAK_INT8 = 1979e12    # H100 SXM dense int8 tensor-core op/s
HEADS, SCALE = 12, 64 ** -0.5
FWD_TOL = 1e-2         # a few bf16 ulps of |o| <= 1
BWD_TOL = 2e-2         # times max |dqkv| of the plain version
STEP_RTOL = 2e-2       # bf16 card step against the fp32 CPU step
# tool-classify, card against --cpu (bf16 on both): each block's attention
# output and the pooled features, norm of the difference over the CPU's.
# On an H100 they differ by at most 2.4e-3 and 1.3e-3; the phase checks
# that attention whose last TOOL_FAULT_KEYS keys and values are read from
# the first ones lands above both
TOOL_ATTN_RTOL, TOOL_FEAT_RTOL = 1e-2, 5e-3
TOOL_FAULT_KEYS = 32
# optim-card-vs-cpu: every --opt name of create_optimizer (its OPT_NAMES),
# these aliases and lookahead, and the bf16 first moment where JAX applies
# it, 8 steps each on the card and on the CPU from one bf16 step's gradients
# of the stage-2 ViT cut to OPT_BLOCKS blocks; each tensor's update within
# OPT_RTOL of its norm
OPT_ALIASES = ("fusedadam", "fusedlamb", "fusednovograd", "fused_sgd",
               "fusedmomentum", "lookahead_adamw", "lookahead_sgd")
OPT_BF16_MU = ("adamw", "lamb", "nadam")
OPT_BLOCKS, OPT_STEPS, OPT_RTOL = 4, 8, 1e-4
# the learning rate: the stage-2 table, times this where a step at it moves
# the weights by about one fp32 ulp (Adadelta, an lr-1 method; NovoGrad,
# whose step is g/||g|| of a tensor), so that the check compares the card's
# arithmetic and not the weights' rounding (``step_ulps`` reports it); lr
# ~1 and ~1e-2 are their usual scales
OPT_LR_SCALE = {"adadelta": 4e4, "novograd": 400.0, "nvnovograd": 400.0}
# stage2-opt-b8: the stage-2 step under these optimizers, in turns
STAGE2_OPTS = ("adamw", "lamb", "adafactor", "adamp", "lookahead_adamw")
# launches of K2 and K5's backward at the main-path shapes that must each
# equal the first bit for bit: persistent blocks there walk many tiles across
# heads, where a race between a ring slot's reads and its next TMA write shows
BWD_REPEATS = 5
STAGE2_TOKENS = 1568   # 8 frames x 196 patches, tubelet 1
STAGE3_CLS_TOKENS = STAGE2_TOKENS + 1  # the same with the CLS token
# the K3/K6 forward's lengths: around its 128-row tiles, and the paths' own
SWEEP_LENGTHS = (1, 7, 64, 127, 128, 129, 577, 1568, 1569, 2048)
# the short forward's lengths (K1 and K5, csrc/short_attn_wgmma.cu): around
# its 64-row q tiles and 64-key chunks, one sweep up to 320 keys and two
# above, and the paths' own (197, 320, 392)
SHORT_LENGTHS = (1, 7, 8, 9, 63, 64, 65, 127, 128, 129, 196, 197, 208, 255,
                 256, 257, 314, 320, 384, 385, 392, 511, 512)
M075_TOKENS = 8 * 49   # stage 1 at mask 0.75: 49 of 196 patches a frame
# bench.py::bench_large: the ViT-L student and the clip_l14 teacher at 196^2
# (a 14x14 grid, 197 tokens a frame), taps 18-23, B=24 over 8 frames
L14_RET = (18, 19, 20, 21, 22, 23)
L14_B = 24
L14_M = L14_B * 8 * 197  # the teacher's rows: 37824
# K7a's (M, K, N) in the int8 teacher's four dense layers, and the probe's
L14_DENSE = {"in_proj": (L14_M, 1024, 3072), "out_proj": (L14_M, 1024, 1024),
             "mlp_c_fc": (L14_M, 1024, 4096), "mlp_c_proj": (L14_M, 4096, 1024)}
PROBE_SHAPE = (38400, 768, 3072)
RAGGED_MM = ((394, 768, 2304), (1, 1024, 1024))
# K7's sweep (tests/test_torch_port_cuda.py's shapes): ragged M and N (N % 4
# and N % 8 != 0 take the direct store), K of 32, 96 and 800 (not a multiple
# of the 128-byte box), one row, M below and above one wave of 128-row
# tiles, and the teacher's four dense layers at a small M
MATMUL_SWEEP = ((1, 32, 8), (130, 96, 257), (394, 768, 2304),
                (300, 4096, 1024), (129, 32, 7), (257, 96, 12), (200, 800, 20),
                (1, 800, 4), (1, 1024, 1), (128 * 60, 64, 256),
                (128 * 70 + 3, 64, 256), (200, 1024, 3072),
                (200, 1024, 1024), (200, 1024, 4096), (200, 4096, 1024))
COS_MIN, TV_MAX = 0.98, 0.05  # int8 teacher bounds, tests/test_quant.py:68-72
# configs/stage1_config.yaml key for key, with stage1.sh's overrides (the
# dataset mapping, output dir and published weights left out): the stage-1
# entry's command line without --config
STAGE1_ARGS = [
    "--model", "adaptation_umt_base_patch16_224", "--batch_size", "64",
    "--batch_size_val", "32", "--epochs", "100", "--warmup_epochs", "10",
    "--lr", "0.00015", "--min_lr", "1e-05", "--warmup_lr", "1e-06",
    "--weight_decay", "0.05", "--opt", "adamw", "--opt_eps", "1e-08",
    "--opt_betas", "0.9", "0.95", "--layer_decay", "1.0",
    "--mask_type", "attention", "--mask_ratio", "0.8",
    "--clip_teacher", "clip_b16", "--clip_input_resolution", "224",
    "--clip_loss_type", "l2", "--clip_loss_data", "source",
    "--clip_loss_ratio", "1.0", "--clip_decoder_embed_dim", "768",
    "--clip_output_dim", "512", "--clip_norm_type", "l2",
    "--clip_return_layers", "6", "7", "8", "9", "10", "11",
    "--clip_return_attn", "true", "--use_cls_token", "false",
    "--num_frames", "8", "--num_segments", "8", "--tubelet_size", "1",
    "--input_size", "224", "--short_side_size", "224",
    "--data_set", "Kinetics_sparse", "--split", ",", "--drop_path", "0.1",
    "--num_sample", "1", "--sampling_rate", "0", "--train_fraction", "1.0",
    "--train_interpolation", "bicubic", "--test_num_segment", "5",
    "--test_num_crop", "3", "--nb_classes", "12", "--color_jitter", "0.0",
    "--flip", "true", "--num_workers", "10", "--seed", "0",
    "--log_freq", "10", "--save_ckpt_freq", "50",
    "--checkpoints_enabled", "true", "--auto_resume", "false",
    "--model_key", "model|module", "--student_prefix", "", "--prefix", "",
    "--val_interval", "100", "--initial_validation", "false",
    "--test_best", "true", "--disable_wandb", "true"]
ENTRY_BATCH = 32       # a stream: 64 clips a step, the bench geometry
ENTRY_STEPS = 4        # an epoch of the entry run
# configs/stage2_config.yaml key for key (clip_grad: null left at its
# default), with stage2.sh's overrides at its EPOCHS=50 (the dataset
# mapping, output dir and --finetune left out): the stage-2 entry's command
# line without --config
STAGE2_ARGS = [
    "--model", "vit_base_patch16_224", "--batch_size", "7",
    "--batch_size_val", "32", "--epochs", "50", "--warmup_epochs", "10",
    "--lr", "2.5e-05", "--min_lr", "1e-06", "--warmup_lr", "1e-06",
    "--weight_decay", "0.05", "--layer_decay", "0.65", "--opt", "adamw",
    "--opt_eps", "1e-08", "--opt_betas", "0.9", "0.999",
    "--frozen_layers", "", "--train_head_only", "false",
    "--freeze_patch_embedding", "false", "--use_mean_pooling", "true",
    "--init_scale", "0.001", "--head_type", "linear",
    "--head_hidden_dim", "256", "--delete_head", "true",
    "--model_key", "model|module", "--model_prefix", "",
    "--aa", "rand-m7-n4-mstd0.5-inc1", "--smoothing", "0.0",
    "--reprob", "0.25", "--remode", "pixel", "--recount", "1",
    "--mixup", "0.0", "--cutmix", "0.0", "--mixup_prob", "0.0",
    "--mixup_switch_prob", "0.5", "--mixup_mode", "batch",
    "--model_ema", "false", "--model_ema_decay", "0.9999",
    "--update_freq", "1", "--drop", "0.0", "--attn_drop_rate", "0.0",
    "--fc_drop_rate", "0.0", "--drop_path", "0.1", "--num_frames", "8",
    "--num_segments", "1", "--tubelet_size", "1", "--input_size", "224",
    "--short_side_size", "224", "--data_set", "Kinetics_sparse",
    "--split", ",", "--num_sample", "1", "--train_fraction", "1.0",
    "--train_interpolation", "bicubic", "--test_num_segment", "4",
    "--test_num_crop", "3", "--nb_classes", "12", "--num_workers", "12",
    "--seed", "0", "--log_freq", "10", "--save_ckpt_freq", "100",
    "--save_ckpt", "true", "--auto_resume", "true", "--eval", "false",
    "--eval_freq", "5", "--test_best", "true",
    "--disable_eval_during_finetuning", "false", "--disable_wandb", "true"]
# the stage-2 entry phase: 28 train clips (4 steps of 7), 40 val clips (a
# full batch of 32 and one of 8 padded to 32), 8 test videos (x 4 segments
# x 3 crops = 96 views, 3 calls of 32)
S2_TRAIN, S2_VAL, S2_TEST = 28, 40, 8
# its steady-state call: 96 steps of 7, the rate timed over steps 17-96,
# after the batches the loader's window (max(4, --num_workers 12)) and the
# device prefetch (2) filled while the model was built have been consumed;
# each loader thread builds a whole batch, so batches come in waves of up
# to 12, and the 80 timed steps span several
S2_STEADY, S2_STEADY_FROM = 7 * 96, 16
# configs/stage3_config.yaml key for key (clip_grad: null left at its
# default), with stage3.sh's overrides (the dataset mapping, output dir and
# --student_init left out) and --epochs 2 --warmup_epochs 0 (stage3.sh's
# warmup is EPOCHS / 5): the stage-3 entry's command line without --config
STAGE3_ARGS = [
    "--model", "adaptation_umt_base_patch16_224", "--batch_size", "5",
    "--batch_size_val", "32", "--epochs", "2", "--warmup_epochs", "0",
    "--lr", "1e-05", "--min_lr", "1e-05", "--warmup_lr", "1e-06",
    "--weight_decay", "0.05", "--opt", "adamw", "--opt_eps", "1e-08",
    "--opt_betas", "0.9", "0.95", "--mask_type", "attention",
    "--masking_type", "clip_attention", "--mask_ratio", "0.8",
    "--clip_teacher", "clip_b16", "--clip_input_resolution", "224",
    "--clip_loss_type", "l2", "--clip_loss_data", "target",
    "--clip_return_layers", "6", "--clip_return_attn", "true",
    "--clip_output_dim", "512", "--clip_decoder_embed_dim", "768",
    "--clip_norm_type", "l2", "--use_cls_token", "false",
    "--selection_strategy", "clip_matchORconf", "--clip_threshold", "0.1",
    "--conf_weighted_loss", "true", "--train_masked", "true",
    "--class_loss_src_ratio_pl", "1.0", "--class_loss_tgt_ratio", "1.0",
    "--full_oracle", "false", "--return_aug_for_val", "true",
    "--src_classifier_type", "linear", "--aa", "rand-m7-n4-mstd0.5-inc1",
    "--reprob", "0.25", "--remode", "pixel", "--recount", "1",
    "--num_frames", "8", "--num_segments", "8", "--tubelet_size", "1",
    "--input_size", "224", "--short_side_size", "224",
    "--data_set", "Kinetics_sparse", "--split", ",", "--drop_path", "0.1",
    "--num_sample", "1", "--train_fraction", "1.0",
    "--train_interpolation", "bicubic", "--test_num_segment", "5",
    "--test_num_crop", "3", "--nb_classes", "12", "--num_workers", "6",
    "--seed", "0", "--log_freq", "10", "--save_ckpt_freq", "10",
    "--checkpoints_enabled", "true", "--auto_resume", "false",
    "--model_key", "model|module", "--student_prefix", "",
    "--initial_validation", "true", "--test_best", "true",
    "--disable_wandb", "true"]
# the stage-3 entry phase: 20 source clips (4 steps of 5) and 10 target
# clips (repeated x2 to match), 40 val clips (a batch of 32 and one of 8
# padded), 8 test videos (x 5 segments x 3 crops = 120 views, 4 calls of
# 32); its steady call stops after 96 steps of a 97-step epoch (before the
# epoch's validation), the rate taken over steps 17-96
S3_SRC, S3_TGT, S3_VAL, S3_TEST = 20, 10, 40, 8
S3_STEADY, S3_STEADY_FROM = 96, 16
# the tools' phases: classify's one clip (B=1, 1568 tokens, forward only)
# and record_losses at its defaults: B=4, 8 frames, mask 0.8 drawn
# uniformly, 1568 - int(1568 * 0.8) = 314 visible tokens, 3 steps
TOOL_B, TOOL_STEPS = 4, 3
TOOL_VISIBLE = STAGE2_TOKENS - int(STAGE2_TOKENS * 0.8)
# the native-decode phase's real video: 16 mp4v clips of 64 frames at
# 340x256 (the new_width x new_height of the reference's dataset), written
# with OpenCV
DECODE_CLIPS, DECODE_FRAMES, DECODE_RASTER = 16, 64, (340, 256)
# the finetune recipe's switches, on top of STAGE2_ARGS, for the
# stage2-recipe-b7 phase: mixup and cutmix, dropout, the head's dropout,
# every block recomputed in the backward, a bf16 first moment; attention
# dropout stays 0, so attention keeps its kernels
RECIPE = ["--mixup", "0.8", "--cutmix", "1.0", "--mixup_prob", "1.0",
          "--smoothing", "0.1", "--drop", "0.1", "--fc_drop_rate", "0.5",
          "--attn_drop_rate", "0.0", "--use_checkpoint", "true",
          "--mu_dtype", "bfloat16"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean time of ``iters`` launches queued back to back between two CUDA
    events: the device's time, with the wrapper's host time hidden behind
    the launches before it (``median_ms`` times single launches, host time
    inside)."""
    import torch

    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def bound(nbytes: float, flops: float, peak: float = PEAK_BF16):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def counters(A) -> dict:
    """Every kernel wrapper of the port, by kernel id."""
    from unite_torch.ops import matmul as MM

    return {"K1": A.fused_qkv_fwd, "K2": A.fused_qkv_bwd,
            "K3": A.packed_flash_fwd, "K4a": A.packed_flash_dq,
            "K4b": A.packed_flash_dkv, "K5": A.grouped_fwd,
            "K5dq": A.grouped_dq, "K5dkv": A.grouped_dkv, "K6": A.flash_fwd,
            "K6dq": A.flash_dq, "K6dkv": A.flash_dkv,
            "K7a": MM.int8_matmul, "K7b": MM.bf16_matmul}


def lse_counters(A) -> dict:
    """The forward wrappers' launches that also wrote the lse."""
    return {"K3+lse": A.packed_flash_fwd, "K6+lse": A.flash_fwd}


def shape_counters(A) -> dict:
    """The wrappers that also count their launches by shape (``.by_shape``:
    K1 and K3 by (B, S), K7a by (M, K, N))."""
    c = counters(A)
    return {k: c[k] for k in ("K1", "K3", "K7a")}


def reset_counts(A) -> None:
    for fn in counters(A).values():
        fn.launches = 0
    for fn in lse_counters(A).values():
        fn.lse_launches = 0
    for fn in shape_counters(A).values():
        fn.by_shape.clear()


def read_counts(A) -> dict:
    return dict({k: fn.launches for k, fn in counters(A).items()},
                **{k: fn.lse_launches for k, fn in lse_counters(A).items()})


def read_shapes(A) -> dict:
    """K1's and K3's launches since ``reset_counts`` by (B, S)."""
    return {k: dict(fn.by_shape) for k, fn in shape_counters(A).items()
            if k != "K7a"}


def expect_counts(counts: dict, want: dict, what: str) -> None:
    """Raise unless every kernel ran exactly as often as ``want`` says
    (kernels not named there not at all)."""
    full = {k: want.get(k, 0) for k in counts}
    if counts != full:
        raise AssertionError(f"{what}: launches {counts}, expected {full}")


def check_kernels(torch, A, heads: int = HEADS, batches=(512, 64),
                  tag: str = "", lengths=(197, 320), head_dim: int = 64):
    """Phase 3: K1 at the teacher's [B, 197, 3*H*D] (forward only) and K1
    and K2 at the student's [B, 320, 3*H*D] against their plain versions,
    with timings; K2's repeats equal bit for bit. ViT-B/16 (12 heads of
    64) by default; ``tag`` "/l14" at the ViT-L/14 path's 16 heads and
    batches (192 frames, 24 clips); ``tag`` "/masked" at the masked CLIP
    teacher's 41 tokens of 512 frames and the VideoMAE encoder's 160 tokens
    of 32 clips (``lengths``); ``tag`` "/d80" at the huge VideoMAE
    encoder's 16 heads of ``head_dim`` 80, [16, 160, 3840]. The softmax
    scale is head_dim^-0.5."""
    import torch.nn.functional as F

    SCALE = head_dim ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for label, (b, s) in (("teacher", (batches[0], lengths[0])),
                          ("student", (batches[1], lengths[1]))):
        qkv = torch.randn((b, s, 3 * heads * head_dim), generator=gen,
                          device="cuda").to(torch.bfloat16)
        with_lse = label == "student"  # the student trains, the teacher not
        out, lse = A.fused_qkv_fwd(qkv, heads, SCALE, with_lse=with_lse)
        # the other variant too: the same output, and the lse where asked
        other, other_lse = A.fused_qkv_fwd(qkv, heads, SCALE,
                                           with_lse=not with_lse)
        torch.cuda.synchronize()
        ref, ref_lse = A.qkv_attention_reference(qkv, heads, SCALE)
        err = (out.float() - ref.float()).abs()
        if not bool(torch.isfinite(out).all()) or err.max().item() > FWD_TOL \
                or not torch.equal(other, out):
            raise AssertionError(f"K1 {label}{tag}: max abs err "
                                 f"{err.max().item()} > {FWD_TOL}, or the "
                                 "outputs with and without lse differ")
        lse_err = (next(x for x in (lse, other_lse) if x is not None)
                   - ref_lse).abs().max().item()
        if lse_err > 1e-3:
            raise AssertionError(f"K1 {label}{tag} lse err {lse_err}")
        del other, other_lse
        run = partial(A.fused_qkv_fwd, qkv, heads, SCALE, with_lse)
        ms = median_ms(run)
        dev_ms = device_ms(run)
        plain_ms = median_ms(lambda: A.qkv_attention_reference(qkv, heads,
                                                               SCALE))
        q, k, v = (t.contiguous() for t in A._split_heads(qkv, heads))
        sdpa = partial(F.scaled_dot_product_attention, q, k, v, scale=SCALE)
        lib_ms = median_ms(sdpa)
        lib_dev_ms = device_ms(sdpa)
        # the K3/K6 forward (csrc/flash_fwd_wgmma.cu) on the same lanes: the
        # yardstick of the short forward's design
        flash = partial(A.packed_flash_fwd, qkv, heads, SCALE, with_lse)
        flash_ms, flash_dev_ms = median_ms(flash), device_ms(flash)
        nbytes = b * s * 4 * heads * head_dim * 2 + (
            b * heads * s * 4 if with_lse else 0)
        bms, by = bound(nbytes, 4.0 * b * heads * s * s * head_dim)
        key = f"K1/{label}{tag}"
        results[key] = dict(
            shape=[b, s, 3 * heads * head_dim], max_abs_err=err.max().item(),
            mean_abs_err=err.mean().item(), lse_err=lse_err, ms=ms,
            device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=lib_ms, library_device_ms=lib_dev_ms,
            flash_fwd_ms=flash_ms, flash_fwd_device_ms=flash_dev_ms)
        print(f"K1 fused_qkv_fwd {label}{tag} {results[key]}", flush=True)
        del q, k, v, ref, ref_lse
        if not with_lse:
            del qkv, out, lse
            torch.cuda.empty_cache()

    # K2 at the student shape, from the student forward above
    do = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    dqkv = A.fused_qkv_bwd(qkv, out, lse, do, heads, SCALE)
    torch.cuda.synchronize()
    ref = A.qkv_attention_reference_bwd(qkv, do, heads, SCALE).float()
    err = (dqkv.float() - ref).abs()
    tol = BWD_TOL * ref.abs().max().item()
    if not bool(torch.isfinite(dqkv).all()) or err.max().item() > tol:
        raise AssertionError(f"K2{tag}: max abs err {err.max().item()} > "
                             f"{tol}")
    run = partial(A.fused_qkv_bwd, qkv, out, lse, do, heads, SCALE)
    for i in range(BWD_REPEATS):
        if not torch.equal(run(), dqkv):
            raise AssertionError(f"K2{tag}: repeat {i + 1} of "
                                 f"{BWD_REPEATS} differs from the first")
    ms, dev_ms = median_ms(run), device_ms(run)
    plain_ms = median_ms(lambda: A.qkv_attention_reference_bwd(
        qkv, do, heads, SCALE))
    # the K4 backward (csrc/flash_bwd_wgmma.cu) on the same lanes: the
    # yardstick of the short backward's design (its rounding points differ,
    # so time only)
    flash = partial(A.packed_flash_bwd, qkv, out, lse, do, heads, SCALE)
    flash_ms, flash_dev_ms = median_ms(flash), device_ms(flash)
    q, k, v = (t.detach().contiguous().requires_grad_(True)
               for t in A._split_heads(qkv, heads))
    do_h = do.reshape(b, s, heads, head_dim).transpose(1, 2).contiguous()

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(q, k, v, scale=SCALE).backward(do_h)

    fwd_bwd_ms = median_ms(sdpa_fwd_bwd)
    o_lib = F.scaled_dot_product_attention(q, k, v, scale=SCALE)

    def sdpa_bwd():
        torch.autograd.grad(o_lib, (q, k, v), do_h, retain_graph=True)

    lib_ms, lib_dev_ms = median_ms(sdpa_bwd), device_ms(sdpa_bwd)
    # reads qkv, o, do and lse2, writes dqkv (and delta, read back): the
    # function's 10 S^2*D flops a head (the kernels do 7: s and dp twice)
    nbytes = (b * s * (3 + 1 + 1 + 3) * heads * head_dim * 2
              + b * heads * s * 4)
    bms, by = bound(nbytes, 10.0 * b * heads * s * s * head_dim)
    key = f"K2/student{tag}"
    results[key] = dict(
        shape=[b, s, 3 * heads * head_dim], max_abs_err=err.max().item(),
        mean_abs_err=err.mean().item(), tol=tol, ms=ms, device_ms=dev_ms,
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
        library_device_ms=lib_dev_ms,
        library="scaled_dot_product_attention backward (dq, dk, dv)",
        library_fwd_bwd_ms=fwd_bwd_ms, flash_bwd_ms=flash_ms,
        flash_bwd_device_ms=flash_dev_ms)
    print(f"K2 fused_qkv_bwd student{tag} {results[key]}", flush=True)
    del q, k, v, do_h, o_lib, dqkv, ref
    return results


def check_grouped_kernels(torch, A, heads: int = HEADS, head_dim: int = 64,
                          shapes=(("m075", 64, M075_TOKENS), ("edge", 64, 512),
                                  ("ragged", 5, M075_TOKENS + 1)),
                          tag: str = ""):
    """Phase 3, stage 1 at mask 0.75: K5 against its plain version at the
    student's [64, 12, 392, 64] (contiguous tensors and the strided views of
    a qkv projection that the models pass), the route's edge
    [64, 12, 512, 64] and a ragged [5, 12, 393, 64], forward and backward,
    the backward's repeats at 392 equal bit for bit; times on the views at
    392. ``tag`` "/d80": the huge VideoMAE encoder at mask 0.75,
    [16, 16, 392, 80] (``heads``, ``head_dim``, ``shapes``: the first
    shape is timed). The softmax scale is head_dim^-0.5."""
    import torch.nn.functional as F

    SCALE = head_dim ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(21)
    results, errs = {}, {}
    for label, b, s in shapes:
        qkv = torch.randn((b, s, 3 * heads * head_dim), generator=gen,
                          device="cuda").to(torch.bfloat16)
        views = A._split_heads(qkv, heads)
        dense = [t.contiguous() for t in views]
        ref, ref_m, ref_l = A.grouped_reference(*dense, scale=SCALE)
        do = torch.randn(ref.shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        refs = A.grouped_reference_bwd(*dense, do, scale=SCALE)
        first = label == shapes[0][0]
        layouts = ((("contiguous", dense), ("views", views))
                   if first else (("views", views),))
        for layout, qkv_t in layouts:
            out, (m, l) = A.grouped_fwd(*qkv_t, SCALE, with_stats=True)
            grads = A.grouped_bwd(*qkv_t, do, m, l, SCALE)
            torch.cuda.synchronize()
            e = (out.float() - ref.float()).abs().max().item()
            stat = max((m - ref_m).abs().max().item(),
                       ((l - ref_l).abs() / ref_l).max().item())
            if not bool(torch.isfinite(out).all()) or e > FWD_TOL \
                    or stat > 1e-3:
                raise AssertionError(f"K5 {label} {layout}: max abs err {e} "
                                     f"> {FWD_TOL} or m/l err {stat}")
            errs[f"fwd/{label}/{layout}"] = e
            for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
                e = (a.float() - r.float()).abs().max().item()
                tol = BWD_TOL * r.float().abs().max().item()
                if not bool(torch.isfinite(a).all()) or e > tol:
                    raise AssertionError(f"K5 {label} {layout} {name}: max "
                                         f"abs err {e} > {tol}")
                errs[f"{name}/{label}/{layout}"] = (e, tol)
            for i in range(BWD_REPEATS if first else 0):
                again = A.grouped_bwd(*qkv_t, do, m, l, SCALE)
                if not all(torch.equal(a, a2) for a, a2 in zip(grads, again)):
                    raise AssertionError(
                        f"K5 {label}{tag} {layout} backward: repeat {i + 1} "
                        f"of {BWD_REPEATS} differs from the first")
        print(f"K5 {label}{tag} [{b}, {heads}, {s}, {head_dim}] agrees with "
              "its plain version", flush=True)
        del ref, refs, out, grads
        if first:
            timed = (qkv, views, dense, do, m, l)
        torch.cuda.empty_cache()

    qkv, (q, k, v), dense, do, m, l = timed
    b, h, s, _ = q.shape
    run = partial(A.grouped_fwd, q, k, v, SCALE, True)
    ms, dev_ms = median_ms(run), device_ms(run)
    plain_ms = median_ms(lambda: A.grouped_reference(q, k, v, scale=SCALE))
    sdpa = partial(F.scaled_dot_product_attention, *dense, scale=SCALE)
    lib_ms, lib_dev_ms = median_ms(sdpa), device_ms(sdpa)
    dq, dk, dv = (A._empty_like_rows(t) for t in (q, k, v))
    delta = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
    ms_dq = median_ms(lambda: A.grouped_dq(q, k, v, do, m, l, dq, delta,
                                           SCALE))
    ms_dkv = median_ms(lambda: A.grouped_dkv(q, k, v, do, m, l, delta, dk, dv,
                                             SCALE))
    plain_dq = median_ms(lambda: A._grouped_dq_reference(q, k, v, do, m, l,
                                                         SCALE))
    plain_dkv = median_ms(lambda: A._grouped_dkv_reference(q, k, v, do, m, l,
                                                           delta, SCALE))
    dev_dq = device_ms(lambda: A.grouped_dq(q, k, v, do, m, l, dq, delta,
                                            SCALE))
    dev_dkv = device_ms(lambda: A.grouped_dkv(q, k, v, do, m, l, delta, dk,
                                              dv, SCALE))
    leaves = [t.detach().requires_grad_(True) for t in dense]
    o_lib = F.scaled_dot_product_attention(*leaves, scale=SCALE)

    def sdpa_bwd():
        torch.autograd.grad(o_lib, leaves, do, retain_graph=True)

    bwd_ms, bwd_dev_ms = median_ms(sdpa_bwd), device_ms(sdpa_bwd)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(*leaves, scale=SCALE).backward(do)

    fwd_bwd_ms = median_ms(sdpa_fwd_bwd)
    tok = b * h * s * head_dim * 2  # bytes of one [B, H, S, D] bf16 tensor
    stat = b * h * s * 4      # one fp32 row statistic
    by_shape = {k: v for k, v in errs.items()}
    bms, by = bound(4 * tok + 2 * stat, 4.0 * b * h * s * s * head_dim)
    label = shapes[0][0] + tag
    results[f"K5/{label}"] = dict(
        shape=[b, h, s, head_dim], max_abs_err=max(
            v for k, v in errs.items() if k.startswith("fwd/")),
        errors_by_shape=by_shape, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=lib_ms,
        library_device_ms=lib_dev_ms,
        library="scaled_dot_product_attention forward")
    print(f"K5 grouped_fwd {label} {results[f'K5/{label}']}", flush=True)
    # dq reads q, k, v, do, m, l and writes dq and delta; dkv reads q, k, v,
    # do, m, l, delta and writes dk and dv: the function's 6 and 8 S^2*D
    # flops a head (the convention of K4 and K6)
    for key, ms_k, dev, plain, nbytes, flops, parts in (
            ("K5dq", ms_dq, dev_dq, plain_dq, 5 * tok + 3 * stat, 6.0,
             ("dq",)),
            ("K5dkv", ms_dkv, dev_dkv, plain_dkv, 6 * tok + 3 * stat, 8.0,
             ("dk", "dv"))):
        e, tol = max(v for k, v in errs.items()
                     if k.split("/")[0] in parts)
        bms, by = bound(nbytes, flops * b * h * s * s * head_dim)
        results[f"{key}/{label}"] = dict(
            shape=[b, h, s, head_dim], max_abs_err=e, tol=tol, ms=ms_k,
            device_ms=dev, plain_ms=plain, bound_ms=bms, bound_by=by,
            library_ms=bwd_ms, library_device_ms=bwd_dev_ms,
            library="scaled_dot_product_attention backward (dq, dk, dv: the "
                    "dq and dk/dv kernels together)",
            library_fwd_bwd_ms=fwd_bwd_ms)
        print(f"K5 {key} {label} {results[f'{key}/{label}']}", flush=True)
    del (qkv, q, k, v, dense, do, m, l, dq, dk, dv, delta, leaves, o_lib,
         timed)
    torch.cuda.empty_cache()
    return results


def tile_name(tile) -> str:
    return "default" if tile is None else f"{tile[0]}x{tile[1]}"


def check_matmul_sweep(torch):
    """K7 (csrc/blocked_matmul_wgmma.cu) at every shape of ``MATMUL_SWEEP``
    and every tile shape (and the default): K7a bit for bit, K7b within
    ``bf16_tolerance`` and equal on small integers; -128 everywhere at the
    largest K the card takes (131040), on both store routes; repeats
    equal."""
    from unite_torch.ops import matmul as MM

    gen = torch.Generator(device="cuda").manual_seed(37)
    worst = 0.0
    for m, k, n in MATMUL_SWEEP:
        x8 = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                           dtype=torch.int8)
        w8 = torch.randint(-128, 128, (n, k), generator=gen, device="cuda",
                           dtype=torch.int8)
        x = torch.randn((m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = torch.randn((n, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        xi, wi = ((t.to(torch.int32) // 16).to(torch.bfloat16)
                  for t in (x8, w8))
        ref8 = MM.int8_matmul_reference(x8, w8)
        ref = MM.bf16_matmul_reference(x, w)
        tol = MM.bf16_tolerance(x, w, ref)
        refi = MM.bf16_matmul_reference(xi, wi)
        for tile in (None,) + MM.TILES:
            what = f"[{m}x{k}x{n}] tile {tile_name(tile)}"
            if not torch.equal(MM.int8_matmul(x8, w8, tile=tile), ref8):
                raise AssertionError(f"K7a {what}: not bit-equal")
            out = MM.bf16_matmul(x, w, tile=tile)
            ratio = ((out.float() - ref.float()).abs() / tol).max().item()
            if not ratio <= 1.0:
                raise AssertionError(f"K7b {what}: error {ratio} x its bound")
            if not torch.equal(MM.bf16_matmul(xi, wi, tile=tile), refi):
                raise AssertionError(f"K7b {what}: not equal on integers")
            worst = max(worst, ratio)
    k = MM.INT8_MAX_K // 32 * 32
    for n in (12, 5):  # the TMA store and the direct store
        x8 = torch.full((3, k), -128, dtype=torch.int8, device="cuda")
        w8 = torch.full((n, k), -128, dtype=torch.int8, device="cuda")
        out = MM.int8_matmul(x8, w8)
        if not (torch.equal(out, MM.int8_matmul_reference(x8, w8))
                and bool(out.eq(k * 128 * 128).all())):
            raise AssertionError(f"K7a: -128s at K = {k}, N = {n} not exact")
    x8, w8 = x8[:, :768].contiguous(), w8[:, :768].contiguous()
    if not torch.equal(MM.int8_matmul(x8, w8), MM.int8_matmul(x8, w8)):
        raise AssertionError("K7a: two calls differ")
    res = dict(shapes=len(MATMUL_SWEEP), tiles=len(MM.TILES) + 1,
               k7b_max_err_over_bound=worst, largest_k=k,
               stores={"K7a": dict(MM.int8_matmul.stores),
                       "K7b": dict(MM.bf16_matmul.stores)})
    print(f"K7 sweep: {res}", flush=True)
    return res


def check_matmul_kernels(torch):
    """K7a and K7b against their plain versions: K7a at the probe shape,
    the four dense layers of the int8 clip_l14 teacher at M = 37824 and two
    ragged shapes, bit for bit; K7b at the probe and the ragged shapes,
    within one bf16 ulp of |plain| (plus the fp32 summation-order term that
    matters near zero, ``bf16_tolerance``). Times at the probe and teacher
    shapes: single launches, device time (back-to-back launches) at the
    default tile and at every tile shape, with ``torch._int_mm``
    (cuBLASLt) and ``torch.matmul`` (cuBLAS) as the yardsticks."""
    from unite_torch.ops import matmul as MM
    from unite_torch.tools.quant_kernel_probe import int_mm_operand

    gen = torch.Generator(device="cuda").manual_seed(31)
    results = {}
    shapes = ([("probe", PROBE_SHAPE)] + list(L14_DENSE.items())
              + [(f"ragged{m}x{k}x{n}", (m, k, n)) for m, k, n in RAGGED_MM])
    for label, (m, k, n) in shapes:
        x8 = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                           dtype=torch.int8)
        w8 = torch.randint(-128, 128, (n, k), generator=gen, device="cuda",
                           dtype=torch.int8)
        out = MM.int8_matmul(x8, w8)
        torch.cuda.synchronize()
        ref = MM.int8_matmul_reference(x8, w8)
        err = (out.double() - ref.double()).abs().max().item()
        if not torch.equal(out, ref):
            raise AssertionError(f"K7a {label} [{m}x{k}x{n}]: not bit-equal to"
                                 f" its plain version, max abs err {err}")
        res = dict(shape=[m, k, n], max_abs_err=err, bit_equal=True)
        if not label.startswith("ragged"):
            w_lib = int_mm_operand(x8, w8)
            res.update(
                ms=median_ms(lambda: MM.int8_matmul(x8, w8)),
                device_ms=device_ms(lambda: MM.int8_matmul(x8, w8)),
                tiles_device_ms={tile_name(t): device_ms(
                    partial(MM.int8_matmul, x8, w8, tile=t))
                    for t in MM.TILES},
                plain_ms=median_ms(lambda: MM.int8_matmul_reference(x8, w8),
                                   iters=5),
                library_ms=median_ms(lambda: torch._int_mm(x8, w_lib)),
                library_device_ms=device_ms(lambda: torch._int_mm(x8, w_lib)),
                library="torch._int_mm (cuBLASLt)",
                library_equal=bool(torch.equal(torch._int_mm(x8, w_lib), ref)))
            res["bound_ms"], res["bound_by"] = bound(
                m * k + n * k + 4 * m * n, 2.0 * m * k * n, PEAK_INT8)
        results[f"K7a/{label}"] = res
        print(f"K7a int8_matmul {label} {res}", flush=True)
        del x8, w8, out, ref
        torch.cuda.empty_cache()

    for label, (m, k, n) in ([("probe", PROBE_SHAPE)]
                             + [(f"ragged{m}x{k}x{n}", (m, k, n))
                                for m, k, n in RAGGED_MM]):
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randn((n, k), generator=gen, device="cuda").to(torch.bfloat16)
        out = MM.bf16_matmul(x, w)
        torch.cuda.synchronize()
        ref = MM.bf16_matmul_reference(x, w)
        err = (out.float() - ref.float()).abs()
        tol = MM.bf16_tolerance(x, w, ref)
        mag = ref.float().abs().clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        if not bool(torch.isfinite(out).all()) or bool((err > tol).any()):
            raise AssertionError(f"K7b {label} [{m}x{k}x{n}]: max abs err "
                                 f"{err.max().item()}, over its bound at "
                                 f"{int((err > tol).sum())} elements")
        res = dict(shape=[m, k, n], max_abs_err=err.max().item(),
                   max_err_over_bound=(err / tol).max().item(),
                   share_within_one_ulp=(err <= ulp).float().mean().item())
        if label == "probe":
            res.update(
                ms=median_ms(lambda: MM.bf16_matmul(x, w)),
                device_ms=device_ms(lambda: MM.bf16_matmul(x, w)),
                tiles_device_ms={tile_name(t): device_ms(
                    partial(MM.bf16_matmul, x, w, tile=t))
                    for t in MM.TILES},
                plain_ms=median_ms(lambda: MM.bf16_matmul_reference(x, w)),
                library_ms=median_ms(lambda: torch.matmul(x, w.t())),
                library_device_ms=device_ms(lambda: torch.matmul(x, w.t())),
                library="torch.matmul (cuBLAS)")
            res["bound_ms"], res["bound_by"] = bound(
                2 * (m * k + n * k + m * n), 2.0 * m * k * n)
        results[f"K7b/{label}"] = res
        print(f"K7b bf16_matmul {label} {res}", flush=True)
        del x, w, out, ref, err, tol, mag, ulp
        torch.cuda.empty_cache()
    return results


def run_probe(torch, A):
    """The probe entry (``python -m unite_torch.tools.quant_kernel_probe``)
    with the launch counts read around it: it must run K7b and K7a."""
    from unite_torch.tools import quant_kernel_probe

    reset_counts(A)
    lines = quant_kernel_probe.main()
    counts = read_counts(A)
    if counts["K7a"] == 0 or counts["K7b"] == 0 or any(
            v for key, v in counts.items() if key not in ("K7a", "K7b")):
        raise AssertionError(f"probe launches {counts}")
    return dict(lines=lines, launches=counts)


def l14_models(torch, dtype, device: str, depth=None):
    """``bench.py::bench_large``'s models: adaptation_umt_large_patch16_224
    (8 frames, tubelet 1, taps 18-23 decoded at 1024 to 768) and clip_l14
    at 196^2 with the CLS attention row and the same taps. With ``depth``
    both are cut to that many blocks at full width, tapping the last two."""
    from unite_torch import create_model
    from unite_torch.models.adaptation import AdaptationVisionTransformer
    from unite_torch.models.clip import CLIPVisionTransformer

    skw = dict(num_frames=8, tubelet_size=1, clip_decoder_embed_dim=1024,
               clip_output_dim=768, clip_norm_type="l2", dtype=dtype)
    tkw = dict(input_resolution=196, clip_norm_type="l2", return_attn=True,
               dtype=dtype)
    if depth is None:
        return (create_model("adaptation_umt_large_patch16_224", device=device,
                             clip_return_layers=L14_RET, **skw),
                create_model("clip_l14", device=device, return_index=L14_RET,
                             **tkw))
    ret = (depth - 2, depth - 1)
    student = AdaptationVisionTransformer(
        img_size=224, patch_size=16, encoder_embed_dim=1024,
        encoder_depth=depth, encoder_num_heads=16, clip_return_layers=ret,
        **skw)
    teacher = CLIPVisionTransformer(patch_size=14, width=1024, layers=depth,
                                   heads=16, output_dim=768, return_index=ret,
                                   **tkw)
    return student.to(device), teacher.to(device)


def build_l14_step(torch, b: int, dtype, device: str, int8: bool,
                   depth=None, states=None):
    """The stage-1 step at ``bench.py::bench_large``'s configuration: mask
    0.8 (320 visible tokens), AdamW lr 1.5e-4, wd 0.05, source_batch_size 0,
    loss on the target rows, no clipping, teacher input 196. ``int8``: the
    teacher's dense layers made int8 by ``quantize_clip_`` from its fp32
    weights (``states``: the student's and the fp32 teacher's)."""
    from unite_torch.engines.pretrain_umt import make_pretrain_train_step
    from unite_torch.ops.quant import quantize_clip_
    from unite_torch.optim.factory import create_optimizer
    from unite_torch.train.train_state import TrainState

    student, teacher = l14_models(torch, dtype, device, depth)
    if states is not None:
        student.load_state_dict(states[0])
        teacher.load_state_dict(states[1])
    if int8:
        quantize_clip_(teacher)
    tx, _ = create_optimizer("adamw", 1.5e-4, student, weight_decay=0.05,
                             device=device)
    step = make_pretrain_train_step(
        student, teacher, num_patches=8 * 196, frames=8, mask_ratio=0.8,
        source_batch_size=0, clip_loss_data="target", clip_grad=None,
        clip_input_resolution=196, device=device)
    return TrainState(student, tx), teacher, step


def int8_teacher_vs_bf16(torch):
    """The full-size int8 clip_l14 against the bf16 one with the same
    random weights, B=2 over 8 frames of 196^2: the L2-normed taps' cosine
    and the CLS attention row's total variation, within
    tests/test_quant.py's bounds."""
    import numpy as np

    from unite_torch import create_model
    from unite_torch.ops.normalize import normalize_videos
    from unite_torch.ops.quant import quantize_clip_

    torch.manual_seed(41)
    kw = dict(device="cuda", dtype=torch.bfloat16, input_resolution=196,
              return_attn=True, return_index=L14_RET)
    bf16 = create_model("clip_l14", **kw).eval()
    int8 = create_model("clip_l14", **kw).eval()
    int8.load_state_dict(bf16.state_dict())
    quantize_clip_(int8)
    vids = np.random.default_rng(42).integers(0, 256, (2, 8, 196, 196, 3),
                                              dtype=np.uint8)
    x = normalize_videos(torch.from_numpy(vids).cuda())
    with torch.no_grad():
        z, attn = bf16(x)
        zq, attnq = int8(x)
    cos = (z.float() * zq.float()).sum(-1)
    tv = 0.5 * (attn.float() - attnq.float()).abs().sum(-1)
    res = dict(cos_min=cos.min().item(), cos_mean=cos.mean().item(),
               tv_max=tv.max().item(), tv_mean=tv.mean().item(),
               shape=list(zq.shape))
    print(f"int8 clip_l14 vs bf16 clip_l14 (B=2, 196^2): {res}", flush=True)
    if not (bool(torch.isfinite(zq).all()) and res["cos_min"] > COS_MIN
            and res["tv_max"] < TV_MAX):
        raise AssertionError(f"int8 teacher outside cos > {COS_MIN}, tv < "
                             f"{TV_MAX}: {res}")
    del bf16, int8
    torch.cuda.empty_cache()
    return res


def l14_card_vs_cpu(torch, depth: int = 4):
    """One stage-1 step with the int8 teacher on the card in bf16 against
    the CPU in fp32: the large student and clip_l14 at full width (1024, 16
    heads, patch 14 at 196^2) cut to ``depth`` blocks each, B=2, the same
    weights and batch, injected visible tokens."""
    torch.manual_seed(43)
    states = tuple(m.state_dict() for m in l14_models(
        torch, torch.float32, "cpu", depth))
    cpu_state, cpu_teacher, cpu_step = build_l14_step(
        torch, 2, torch.float32, "cpu", True, depth=depth, states=states)
    gpu_state, gpu_teacher, gpu_step = build_l14_step(
        torch, 2, torch.bfloat16, "cuda", True, depth=depth, states=states)
    for k, v in cpu_teacher.state_dict().items():
        if not torch.equal(v, gpu_teacher.state_dict()[k].cpu()):
            raise AssertionError(f"int8 teacher weights differ: {k}")
    batch = random_batch(torch, 2, 44, with_vis_idx=True)
    m_gpu = {k: v.item() for k, v in gpu_step(gpu_state, batch).items()}
    m_cpu = {k: v.item() for k, v in cpu_step(cpu_state, batch).items()}
    rel = {k: abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k])
           for k in ("loss", "grad_norm")}
    print(f"l14 step, int8 teacher, depth {depth} (card bf16 vs cpu fp32): "
          f"card {m_gpu} cpu {m_cpu} rel {rel}", flush=True)
    check_finite([(m_gpu["loss"], m_gpu["grad_norm"])])
    if not all(r <= STEP_RTOL for r in rel.values()):
        raise AssertionError(f"l14 int8 card step disagrees with the CPU: "
                             f"{rel}")
    return rel


def l14_path(torch, A, int8: bool, warmup: int = 2, timed: int = 5):
    """``stage1-l14-b24`` (bf16 teacher) or ``stage1-l14-int8-b24`` (int8
    teacher): bench_large's step at full size, B=24; exact launch counts
    (48 K1 + 24 K2 a step, and 96 K7a, 24 at each dense shape, with the
    int8 teacher), clips/s, MFU, peak memory and a profiled step."""
    from unite_torch.ops import matmul as MM

    name = "stage1-l14-int8-b24" if int8 else "stage1-l14-b24"
    torch.manual_seed(51)
    state, teacher, step = build_l14_step(torch, L14_B, torch.bfloat16,
                                          "cuda", int8)
    gen = torch.Generator(device="cuda").manual_seed(52)
    batch = random_batch(torch, L14_B, 53, with_vis_idx=False)
    batch["videos"] = batch["videos"].pin_memory()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(A)
    losses = [step(state, batch, gen) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        losses.append(step(state, batch, gen))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts(A)
    by_shape = dict(MM.int8_matmul.by_shape)
    n = warmup + timed
    vals = [(m["loss"].item(), m["grad_norm"].item()) for m in losses]
    print(f"{name} losses/grad norms: {vals}", flush=True)
    check_finite(vals)
    want = {"K1": 48 * n, "K2": 24 * n}
    if int8:
        want["K7a"] = 96 * n
    expect_counts(counts, want, f"{name}, {n} steps")
    want_shapes = {s: 24 * n for s in L14_DENSE.values()} if int8 else {}
    if by_shape != want_shapes:
        raise AssertionError(f"{name}: K7a launches by shape {by_shape}, "
                             f"expected {want_shapes}")
    k1_teacher = expect_k1_shapes(
        A, {(8 * L14_B, 197): 24 * n, (L14_B, 320): 24 * n}, name)
    flops = step_flops(L14_B, width=1024, layers=24, out_dim=768,
                       t_width=1024, t_layers=24, t_patch=14, t_out_dim=768)
    res = dict(clips_per_s=L14_B * timed / dt, step_ms=dt / timed * 1e3,
               model_tflop_per_step=flops / 1e12,
               model_flops_util=flops * timed / dt / PEAK_BF16,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               steps=n, launches=counts,
               k7a_by_shape={"x".join(map(str, s)): c
                             for s, c in by_shape.items()},
               k1_teacher=k1_teacher, k1_student=counts["K1"] - k1_teacher,
               k2_launches=counts["K2"])
    print(f"{name} B={L14_B}: {res} on {card_line()}", flush=True)
    res["profile"] = profile_step(torch, lambda: step(state, batch, gen),
                                  f"chip_smoke_profile_{name}.json")
    res["device_share_of_timed_step"] = (res["profile"]["device_ms"]
                                         / res["step_ms"])
    del state, teacher, step, batch, losses
    torch.cuda.empty_cache()
    return res


def step_flops(b: int, frames: int = 8, width: int = 768, layers: int = 12,
               grid: int = 196, visible: int = 320, taps: int = 6,
               out_dim: int = 512, t_width=None, t_layers=None,
               t_patch: int = 16, t_out_dim=None) -> float:
    """Model operations of one stage-1 step, from the shapes: the teacher's
    forward (no gradient) at its own width, depth and patch, the tap
    projection at the visible tokens, and the student's forward and
    backward (three times its forward). Matrix products and attention only;
    K2's recomputed scores are not counted. An int8 teacher's products
    count the same operations as bf16 ones. The teacher defaults to the
    student's geometry (clip_b16 with a ViT-B/16 student)."""
    t_width, t_layers = t_width or width, t_layers or layers
    t_out_dim = t_out_dim or out_dim

    def layer(tokens, seq, w):  # qkv, proj, fc1, fc2 (12 w^2) + q.k^T, p.v
        return tokens * (2 * 12 * w * w + 4 * seq * w)

    teacher = (t_layers * layer(b * frames * (grid + 1), grid + 1, t_width)
               + b * frames * grid * 2 * 3 * t_patch * t_patch * t_width
               + taps * b * visible * 2 * t_width * t_out_dim)
    student = (layers * layer(b * visible, visible, width)
               + b * visible * 2 * 3 * 16 * 16 * width
               + taps * b * visible * 2 * width * out_dim)
    return float(teacher + 3 * student)


def build_step(torch, b: int, dtype, device: str, drop_path: float,
               state_dict=None, teacher_state=None, mask_ratio: float = 0.8,
               remat: bool = False, layout=None, opt: str = "adamw"):
    """The stage-1 step as run_stage1.main builds it, with the
    configs/stage1_config.yaml values (``remat``: --use_checkpoint;
    ``layout``: (--tp, --zero1, --fsdp) of ``parallel.mesh.state_layout``
    on the process group set up, applied before the optimizer; ``opt``:
    --opt)."""
    from unite_torch import create_model
    from unite_torch.engines.pretrain_umt import make_pretrain_train_step
    from unite_torch.optim.factory import create_optimizer
    from unite_torch.parallel import mesh as pm
    from unite_torch.train.train_state import TrainState
    from unite_torch.utils.schedules import cosine_scheduler, scaled_lr

    frames, ret = 8, (6, 7, 8, 9, 10, 11)
    student = create_model(
        "adaptation_umt_base_patch16_224", device=device, dtype=dtype,
        num_frames=frames, tubelet_size=1, drop_path_rate=drop_path,
        clip_decoder_embed_dim=768, clip_output_dim=512,
        clip_norm_type="l2", clip_return_layers=ret, remat=remat)
    teacher = create_model("clip_b16", device=device, dtype=dtype,
                           input_resolution=224, clip_norm_type="l2",
                           return_attn=True, return_index=ret)
    if state_dict is not None:
        student.load_state_dict(state_dict)
        teacher.load_state_dict(teacher_state)
    niter, epochs = 100, 20
    lr_tab = cosine_scheduler(scaled_lr(1.5e-4, b), scaled_lr(1e-5, b),
                              epochs, niter, start_warmup_value=scaled_lr(
                                  1e-6, b))
    wd_tab = cosine_scheduler(0.05, 0.05, epochs, niter)
    lay = None
    if layout is not None:
        tp, zero1, fsdp = layout
        lay = pm.state_layout(student, tp=tp, zero1=zero1, fsdp=fsdp)
    tx, _ = create_optimizer(opt, lr_tab, student, weight_decay=wd_tab,
                             betas=(0.9, 0.95), eps=1e-8, device=device)
    step = make_pretrain_train_step(
        student, teacher, num_patches=frames * 196, frames=frames,
        mask_ratio=mask_ratio, source_batch_size=b, clip_loss_data="mixed",
        clip_grad=None, clip_input_resolution=224, device=device)
    return TrainState(student, tx, layout=lay), teacher, step


def random_batch(torch, b: int, seed: int, with_vis_idx: bool,
                 per_frame: int = 40):
    import numpy as np

    rng = np.random.default_rng(seed)
    batch = {"videos": torch.from_numpy(
        rng.integers(0, 256, (b, 8, 224, 224, 3), dtype=np.uint8))}
    if with_vis_idx:
        vis = [np.sort(np.concatenate([f * 196 + rng.choice(196, per_frame,
                                                            False)
                                       for f in range(8)]))
               for _ in range(b)]
        batch["vis_idx"] = torch.from_numpy(np.stack(vis))
    return batch


def card_vs_cpu(torch, mask_ratio: float = 0.8):
    """Phase 4: one step on the card (bf16) against the CPU (fp32), with
    injected visible tokens (320 at mask 0.8, 392 at 0.75, where the card's
    student runs K5)."""
    torch.manual_seed(0)
    cpu_state, cpu_teacher, cpu_step = build_step(
        torch, 2, torch.float32, "cpu", 0.0, mask_ratio=mask_ratio)
    sd = {k: v.clone() for k, v in cpu_state.model.state_dict().items()}
    td = cpu_teacher.state_dict()
    gpu_state, gpu_teacher, gpu_step = build_step(
        torch, 2, torch.bfloat16, "cuda", 0.0, sd, td, mask_ratio=mask_ratio)
    batch = random_batch(torch, 2, 1, with_vis_idx=True,
                         per_frame=196 - int(196 * mask_ratio))
    from unite_torch.ops.normalize import normalize_videos

    with torch.no_grad():
        vids = normalize_videos(batch["videos"])
        x_cpu = cpu_state.model.eval()(vids, batch["vis_idx"], clip_only=True)
        x_gpu = gpu_state.model.eval()(vids.cuda(), batch["vis_idx"].cuda(),
                                       clip_only=True)
    out_err = (x_gpu.float().cpu() - x_cpu).abs().max().item()
    m_gpu = {k: v.item() for k, v in gpu_step(gpu_state, batch).items()}
    m_cpu = {k: v.item() for k, v in cpu_step(cpu_state, batch).items()}
    rel = {k: abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k])
           for k in ("loss", "grad_norm")}
    print(f"step (mask {mask_ratio}) card bf16 vs cpu fp32: card {m_gpu} cpu "
          f"{m_cpu} rel {rel} student x_clip max abs err {out_err}",
          flush=True)
    if not all(r <= STEP_RTOL for r in rel.values()) or out_err > 5e-2:
        raise AssertionError(f"card step (mask {mask_ratio}) disagrees with "
                             f"the CPU: {rel}, x_clip err {out_err}")
    return dict(rel, x_clip_max_abs_err=out_err)


def main_path(torch, A, b: int = 64, warmup: int = 2, timed: int = 5,
              mask_ratio: float = 0.8):
    """Phase 5: the full stage-1 step; returns counts and timings. At mask
    0.8 the student runs 320 tokens on K1/K2; at 0.75, 392 on K5."""
    torch.manual_seed(1)
    state, _, step = build_step(torch, b, torch.bfloat16, "cuda", 0.1,
                                      mask_ratio=mask_ratio)
    gen = torch.Generator(device="cuda").manual_seed(2)
    batch = random_batch(torch, b, 3, with_vis_idx=False)
    batch["videos"] = batch["videos"].pin_memory()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(A)
    losses = []
    for _ in range(warmup):
        losses.append(step(state, batch, gen))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        losses.append(step(state, batch, gen))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts(A)
    k1, k2 = counts["K1"], counts["K2"]
    n = warmup + timed
    vals = [(m["loss"].item(), m["grad_norm"].item()) for m in losses]
    name = "stage1-b16-b64" if mask_ratio == 0.8 else "stage1-m075-b16-b64"
    print(f"{name} losses/grad norms: {vals}", flush=True)
    check_finite(vals)
    if mask_ratio == 0.8:  # 320 tokens: K1/K2
        want = {"K1": 24 * n, "K2": 12 * n}
    else:  # 392 tokens in training: K5, and no K2
        want = {"K1": 12 * n, "K5": 12 * n, "K5dq": 12 * n, "K5dkv": 12 * n}
    expect_counts(counts, want, f"{name}, {n} steps")
    k1_teacher = expect_k1_shapes(
        A, {(8 * b, 197): 12 * n, (b, 320): 12 * n if mask_ratio == 0.8
            else 0}, name)
    visible = 8 * (196 - int(196 * mask_ratio))
    flops = step_flops(b, visible=visible)
    res = dict(clips_per_s=b * timed / dt, step_ms=dt / timed * 1e3,
               model_tflop_per_step=flops / 1e12,
               model_flops_util=flops * timed / dt / PEAK_BF16,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               steps=n, visible_tokens=visible, launches=counts,
               k1_launches=k1, k1_teacher=k1_teacher,
               k1_student=k1 - k1_teacher, k2_launches=k2)
    print(f"{name} B={b}: {res} on {card_line()}", flush=True)
    res["profile"] = profile_step(
        torch, lambda: step(state, batch, gen),
        "chip_smoke_profile.json" if mask_ratio == 0.8
        else "chip_smoke_profile_stage1_m075.json")
    res["device_share_of_timed_step"] = (res["profile"]["device_ms"]
                                         / res["step_ms"])
    return res


def expect_k1_shapes(A, want: dict, what: str) -> int:
    """Raise unless K1 ran at exactly the (B, S) counts of ``want`` since
    ``reset_counts`` (zero counts left out); the teacher's, at S = 197."""
    want = {k: v for k, v in want.items() if v}
    got = read_shapes(A)["K1"]
    if got != want:
        raise AssertionError(f"{what}: K1 launches by (B, S) {got}, "
                             f"expected {want}")
    return sum(v for (_, s), v in got.items() if s == 197)


def check_finite(vals) -> None:
    if not all(x == x and abs(x) < float("inf") for v in vals for x in v):
        raise AssertionError(f"non-finite loss or grad norm: {vals}")


def profile_step(torch, run_step, dest_name: str) -> dict:
    """One more step under torch.profiler: device time by kernel class and
    the device's busy share of the step's wall time. The full kernel table
    goes to the file ``dest_name`` of the script's output directory."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # a user annotation (such as the optimizer's step) spans kernels that
    # have rows of their own: kept out of the sums, listed apart
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    rows, annotations = [], []
    for e in events:
        (annotations if getattr(e, "is_user_annotation", False) else rows
         ).append((e.key, e.self_device_time_total / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    classes = {"attention (K1-K6)": 0.0, "blocked matmul (K7)": 0.0,
               "matmul (cuBLAS)": 0.0,
               "other (elementwise, norms, reductions, copies)": 0.0}
    for name, ms, _ in rows:
        low = name.lower()
        if any(k in low for k in ("fused_qkv", "flash_", "grouped_",
                                  "short_attn")):
            classes["attention (K1-K6)"] += ms
        elif "blocked_matmul" in low:
            classes["blocked matmul (K7)"] += ms
        elif any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet",
                                    "cublas")):
            classes["matmul (cuBLAS)"] += ms
        else:
            classes["other (elementwise, norms, reductions, copies)"] += ms
    device_ms = sum(classes.values())
    out = dict(wall_ms=wall_ms, device_ms=device_ms,
               busy_share=device_ms / wall_ms, classes_ms=classes,
               top=[(n[:80], ms, c) for n, ms, c in rows[:12]])
    print(f"profile of one step (profiler on): {json.dumps(out)}", flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / dest_name).write_text(json.dumps(
        dict(out, kernels=rows, annotations=annotations, card=card_line()),
        indent=1))
    return {k: out[k] for k in ("wall_ms", "device_ms", "busy_share",
                                "classes_ms")}


def check_packed_kernels(torch, A, shapes=(("train", 8, True),
                                           ("eval", 32, False)), tag="",
                         heads: int = HEADS, repeats: int = 0,
                         head_dim: int = 64):
    """Phase 3, stage 2: K3 and K4 against their plain versions at the
    stage-2 shapes, with timings: ``shapes`` holds (label, batch, with lse);
    K4 runs at the "train" one, where there is one (the tool-classify
    phase passes only a forward, B=1). The stage-2 entry's phase passes its
    B=7 with ``tag`` "/b7"; the VideoMAE decoder's, 6 ``heads`` at B=32 with
    ``tag`` "/h6", and the huge VideoMAE decoder's 8 heads of ``head_dim``
    80 at B=16 with ``tag`` "/d80", where each of ``repeats`` K4 backwards
    must equal the first bit for bit. The softmax scale is
    head_dim^-0.5."""
    import torch.nn.functional as F

    SCALE = head_dim ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(4)
    s, hd = STAGE2_TOKENS, heads * head_dim
    results, train = {}, None
    for label, b, with_lse in shapes:
        qkv = torch.randn((b, s, 3 * hd), generator=gen,
                          device="cuda").to(torch.bfloat16)
        out, lse = A.packed_flash_fwd(qkv, heads, SCALE, with_lse=with_lse)
        torch.cuda.synchronize()
        ref, ref_lse = A.packed_flash_reference(qkv, heads, SCALE)
        err = (out.float() - ref.float()).abs()
        if not bool(torch.isfinite(out).all()) or err.max().item() > FWD_TOL:
            raise AssertionError(f"K3 {label}: max abs err {err.max().item()}"
                                 f" > {FWD_TOL}")
        if with_lse:
            lse_err = (lse - ref_lse).abs().max().item()
            if lse_err > 1e-3:
                raise AssertionError(f"K3 lse err {lse_err}")
            train = (qkv, out, lse)
        del ref, ref_lse
        run = partial(A.packed_flash_fwd, qkv, heads, SCALE, with_lse)
        ms, dev_ms = median_ms(run), device_ms(run)
        plain_ms = median_ms(lambda: A.packed_flash_reference(qkv, heads,
                                                              SCALE))
        q, k, v = (t.contiguous() for t in A._split_heads(qkv, heads))
        sdpa = partial(F.scaled_dot_product_attention, q, k, v, scale=SCALE)
        lib_ms, lib_dev_ms = median_ms(sdpa), device_ms(sdpa)
        nbytes = b * s * 4 * hd * 2 + (b * heads * s * 4 if with_lse else 0)
        bms, by = bound(nbytes, 4.0 * b * heads * s * s * head_dim)
        results[f"K3/{label}{tag}"] = dict(
            shape=[b, s, 3 * hd], max_abs_err=err.max().item(),
            mean_abs_err=err.mean().item(), ms=ms, device_ms=dev_ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
            library_device_ms=lib_dev_ms,
            library="scaled_dot_product_attention forward")
        print(f"K3 packed_flash_fwd {label}{tag} "
              f"{results[f'K3/{label}{tag}']}", flush=True)
        del qkv, out, lse, q, k, v, err
        torch.cuda.empty_cache()

    if train is None:
        return results
    # K4 at the train shape, from the train forward above
    qkv, out, lse = train
    b = qkv.shape[0]
    do = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    dqkv = A.packed_flash_bwd(qkv, out, lse, do, heads, SCALE)
    torch.cuda.synchronize()
    ref = A.packed_flash_reference_bwd(qkv, out, lse, do, heads, SCALE).float()
    errs = {}
    for i, part in enumerate(("dq", "dk", "dv")):
        sl = slice(i * hd, (i + 1) * hd)
        e = (dqkv[..., sl].float() - ref[..., sl]).abs().max().item()
        tol = BWD_TOL * ref[..., sl].abs().max().item()
        if not bool(torch.isfinite(dqkv[..., sl]).all()) or e > tol:
            raise AssertionError(f"K4 {part}: max abs err {e} > {tol}")
        errs[part] = (e, tol)
    del ref
    for i in range(repeats):
        if not torch.equal(A.packed_flash_bwd(qkv, out, lse, do, heads,
                                              SCALE), dqkv):
            raise AssertionError(f"K4{tag}: repeat {i + 1} of {repeats} "
                                 "differs from the first")
    buf = torch.empty_like(qkv)
    delta = torch.empty((b, heads, s), dtype=torch.float32, device="cuda")
    ms_dq = median_ms(lambda: A.packed_flash_dq(qkv, out, lse, do, buf, delta,
                                                heads, SCALE))
    ms_dkv = median_ms(lambda: A.packed_flash_dkv(qkv, do, lse, delta, buf,
                                                  heads, SCALE))
    plain_dq = median_ms(lambda: A._packed_dq_reference(qkv, out, lse, do,
                                                        heads, SCALE))
    plain_dkv = median_ms(lambda: A._packed_dkv_reference(qkv, lse, delta, do,
                                                          heads, SCALE))
    q, k, v = (t.detach().contiguous().requires_grad_(True)
               for t in A._split_heads(qkv, heads))
    do_h = do.reshape(b, s, heads, head_dim).transpose(1, 2).contiguous()

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(q, k, v, scale=SCALE).backward(do_h)

    fwd_bwd_ms = median_ms(sdpa_fwd_bwd)
    o_lib = F.scaled_dot_product_attention(q, k, v, scale=SCALE)

    def sdpa_bwd():
        torch.autograd.grad(o_lib, (q, k, v), do_h, retain_graph=True)

    bwd_ms, bwd_dev_ms = median_ms(sdpa_bwd), device_ms(sdpa_bwd)
    dev_dq = device_ms(lambda: A.packed_flash_dq(qkv, out, lse, do, buf, delta,
                                                 heads, SCALE))
    dev_dkv = device_ms(lambda: A.packed_flash_dkv(qkv, do, lse, delta, buf,
                                                   heads, SCALE))
    tok = b * s * hd * 2  # bytes of one [B, S, H*D] bf16 tensor
    stat = b * heads * s * 4  # one fp32 row statistic
    # K4a reads qkv, o, do, lse and writes dq, delta: 3 products (s, dp,
    # dq); K4b reads qkv, do, lse, delta and writes dk, dv: 4 products
    for key, name, ms, dev, plain, nbytes, flops, e in (
            ("K4a", "dq", ms_dq, dev_dq, plain_dq, 6 * tok + 2 * stat, 6.0,
             errs["dq"]),
            ("K4b", "dkv", ms_dkv, dev_dkv, plain_dkv, 6 * tok + 2 * stat, 8.0,
             max(errs["dk"], errs["dv"]))):
        bms, by = bound(nbytes, flops * b * heads * s * s * head_dim)
        results[key + tag] = dict(
            shape=[b, s, 3 * hd], max_abs_err=e[0], tol=e[1], ms=ms,
            device_ms=dev, plain_ms=plain, bound_ms=bms, bound_by=by,
            library_ms=bwd_ms, library_device_ms=bwd_dev_ms,
            library="scaled_dot_product_attention backward (dq, dk, dv: "
                    "K4a and K4b together)",
            library_fwd_bwd_ms=fwd_bwd_ms)
        print(f"K4 packed_flash_{name}{tag} {results[key + tag]}", flush=True)
    del qkv, out, lse, do, dqkv, buf, delta, q, k, v, do_h, o_lib, train
    torch.cuda.empty_cache()
    return results


def stage2_clip_flops(frames: int = 8, img: int = 224, depth: int = 12,
                      dim: int = 768) -> float:
    """Model operations of one clip's stage-2 train step, the formula of
    ``bench.py::bench_stage2`` (matrix products and attention; forward and
    backward as three forwards). A third of it is the eval forward."""
    n = frames * (img // 16) ** 2
    block = (2 * n * dim * (3 * dim) + 2 * n * dim * dim
             + 2 * (2 * n * dim * 4 * dim) + 2 * 2 * n * n * dim)
    return float(3 * (depth * block + 2 * n * (16 * 16 * 3) * dim))


def build_stage2(torch, dtype_name: str, device: str, drop_path: float,
                 state_dict=None, recipe: bool = False,
                 attn_drop: float = 0.0, opt: str = "adamw"):
    """The stage-2 model, optimizer and steps as run_stage2.main builds
    them from configs/stage2_config.yaml (no lr batch scaling in stage 2,
    warmup 0, layer decay 0.65, blocks 0-6 frozen, no EMA, no clip); with
    ``recipe``, ``RECIPE``'s switches (mixup 0.8 and cutmix 1.0 with
    smoothing 0.1, dropout 0.1, the head's 0.5, remat, a bf16 first
    moment); ``attn_drop`` the attention dropout rate; ``opt`` --opt."""
    from unite_torch.engines.finetune import (make_eval_step,
                                              make_finetune_train_step)
    from unite_torch.optim.factory import create_optimizer
    from unite_torch.train.common import mu_dtype_for
    from unite_torch.train.run_stage2 import (build_mixup, build_model,
                                              trainable_mask)
    from unite_torch.train.train_state import TrainState
    from unite_torch.utils.schedules import cosine_scheduler

    args = SimpleNamespace(
        model="vit_base_patch16_224", nb_classes=12, num_frames=8,
        tubelet_size=1, fc_drop_rate=0.5 if recipe else 0.0,
        drop=0.1 if recipe else 0.0, attn_drop_rate=attn_drop,
        drop_path=drop_path, use_learnable_pos_emb=False,
        use_mean_pooling=True, init_scale=0.001, head_type="linear",
        head_hidden_dim=256, compute_dtype=dtype_name,
        frozen_layers="0,1,2,3,4,5,6", train_head_only=False,
        freeze_patch_embedding=False, use_checkpoint=recipe,
        mu_dtype="bfloat16" if recipe else None,
        mixup=0.8 if recipe else 0.0, cutmix=1.0 if recipe else 0.0,
        mixup_prob=1.0, mixup_switch_prob=0.5, mixup_mode="batch",
        smoothing=0.1 if recipe else 0.0)
    model = build_model(args, device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    niter, epochs = 100, 20
    lr_tab = cosine_scheduler(2.5e-5, 1e-6, epochs, niter,
                              start_warmup_value=1e-6)
    wd_tab = cosine_scheduler(0.05, 0.05, epochs, niter)
    mask = trainable_mask(args, model)
    tx, _ = create_optimizer(opt, lr_tab, model, weight_decay=wd_tab,
                             betas=(0.9, 0.999), eps=1e-8,
                             trainable=mask.__getitem__,
                             num_layers=model.depth, layer_decay=0.65,
                             mu_dtype=mu_dtype_for(args), device=device)
    return (TrainState(model, tx),
            make_finetune_train_step(model, mixup=build_mixup(args),
                                     label_smoothing=args.smoothing,
                                     device=device),
            make_eval_step(model, device=device))


def stage2_batch(torch, b: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"videos": torch.from_numpy(
                rng.integers(0, 256, (b, 8, 224, 224, 3), dtype=np.uint8)),
            "labels": torch.from_numpy(rng.integers(0, 12, (b,)))}


def stage2_card_vs_cpu(torch):
    """Phase 6: one stage-2 step on the card (bf16) against the CPU (fp32)."""
    from unite_torch.ops.normalize import normalize_videos

    torch.manual_seed(5)
    cpu_state, cpu_step, _ = build_stage2(torch, "float32", "cpu", 0.0)
    sd = {k: v.clone() for k, v in cpu_state.model.state_dict().items()}
    gpu_state, gpu_step, _ = build_stage2(torch, "bfloat16", "cuda", 0.0, sd)
    batch = stage2_batch(torch, 2, 6)
    with torch.no_grad():
        vids = normalize_videos(batch["videos"])
        l_cpu = cpu_state.model.eval()(vids)
        l_gpu = gpu_state.model.eval()(vids.cuda()).float().cpu()
    logit_rel = ((l_gpu - l_cpu).abs().max() / l_cpu.abs().max()).item()
    m_gpu = {k: v.item() for k, v in gpu_step(gpu_state, batch).items()}
    m_cpu = {k: v.item() for k, v in cpu_step(cpu_state, batch).items()}
    rel = {k: abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k])
           for k in ("loss", "grad_norm")}
    rel["logits"] = logit_rel
    print(f"stage-2 step card bf16 vs cpu fp32: card {m_gpu} cpu {m_cpu} "
          f"rel {rel}", flush=True)
    if not all(r <= STEP_RTOL for r in rel.values()):
        raise AssertionError(f"stage-2 card step disagrees with the CPU: "
                             f"{rel}")
    return rel


def stage2_path(torch, A, b: int = 8, warmup: int = 2, timed: int = 10):
    """Phase 7: the stage-2 finetune train step; returns its numbers and
    the trained state with its eval step."""
    torch.manual_seed(7)
    state, step, eval_step = build_stage2(torch, "bfloat16", "cuda", 0.1)
    gen = torch.Generator(device="cuda").manual_seed(8)
    batch = stage2_batch(torch, b, 9)
    batch["videos"] = batch["videos"].pin_memory()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(A)
    metrics = [step(state, batch, gen) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        metrics.append(step(state, batch, gen))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts(A)
    n = warmup + timed
    vals = [(m["loss"].item(), m["grad_norm"].item()) for m in metrics]
    print(f"stage-2 path losses/grad norms: {vals}", flush=True)
    check_finite(vals)
    # all 12 blocks run K3 forward and K4 backward, the frozen ones too
    expect_counts(counts, {"K3": 12 * n, "K3+lse": 12 * n, "K4a": 12 * n,
                           "K4b": 12 * n}, f"stage-2 path, {n} steps")
    flops = b * stage2_clip_flops()
    res = dict(clips_per_s=b * timed / dt, step_ms=dt / timed * 1e3,
               model_tflop_per_step=flops / 1e12,
               model_flops_util=flops * timed / dt / PEAK_BF16,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               steps=n, k3_launches=counts["K3"],
               k4_dq_launches=counts["K4a"], k4_dkv_launches=counts["K4b"])
    print(f"stage-2 path B={b}: {res} on {card_line()}", flush=True)
    res["profile"] = profile_step(torch, lambda: step(state, batch, gen),
                                  "chip_smoke_profile_stage2.json")
    # the profiler slows the host, so the timed steps' busy share is the
    # profiled device time over the timed step
    res["device_share_of_timed_step"] = (res["profile"]["device_ms"]
                                         / res["step_ms"])
    return res, state, eval_step


def stage2_eval(torch, A, state, eval_step, b: int = 32, warmup: int = 2,
                timed: int = 10):
    """Phase 8: the stage-2 eval step (softmax, top-1/5, loss) over views."""
    batch = stage2_batch(torch, b, 10)
    batch["videos"] = batch["videos"].pin_memory()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(A)
    outs = [eval_step(state, batch) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        outs.append(eval_step(state, batch))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts(A)
    n = warmup + timed
    expect_counts(counts, {"K3": 12 * n}, f"stage-2 eval, {n} calls")
    probs = outs[-1]["probs"]
    sums = probs.sum(-1)
    if (probs.shape != (b, 12) or not bool(torch.isfinite(probs).all())
            or (sums - 1).abs().max().item() > 1e-4):
        raise AssertionError(f"eval probs: shape {tuple(probs.shape)}, row "
                             f"sums {sums.tolist()}")
    flops = b * stage2_clip_flops() / 3
    res = dict(views_per_s=b * timed / dt, call_ms=dt / timed * 1e3,
               model_flops_util=flops * timed / dt / PEAK_BF16,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               calls=n, k3_launches=counts["K3"],
               acc1=outs[-1]["acc1"].item(), loss=outs[-1]["loss"].item())
    print(f"stage-2 eval B={b}: {res} on {card_line()}", flush=True)
    res["profile"] = profile_step(torch, lambda: eval_step(state, batch),
                                  "chip_smoke_profile_eval.json")
    res["device_share_of_timed_call"] = (res["profile"]["device_ms"]
                                         / res["call_ms"])
    return res


def optim_vit(torch, device: str):
    """The stage-2 ViT-B/16 (8 frames) at full width, cut to OPT_BLOCKS
    blocks, computing in bf16 (its parameters fp32)."""
    from unite_torch.models.vit import VisionTransformer

    return VisionTransformer(
        patch_size=16, embed_dim=768, depth=OPT_BLOCKS, num_heads=12,
        mlp_ratio=4, qkv_bias=True, norm_eps=1e-6, num_classes=12,
        all_frames=8, tubelet_size=1, use_mean_pooling=True,
        init_scale=0.001, dtype=torch.bfloat16).to(device)


def optim_card_vs_cpu(torch, A, card: str = "cuda") -> dict:
    """Phase optim-card-vs-cpu: one bf16 train step at B=2 of the cut
    stage-2 ViT on the card (4 K3 with lse, 4 K4a, 4 K4b, exact), its
    gradients and parameters in fp32, then for each --opt name, alias,
    lookahead and bf16 first moment (every parameter trainable, layer decay 0.65, the stage-2 tables) 8
    optimizer steps from them on the card and on the CPU (at
    ``OPT_LR_SCALE`` times the tables' lr where that gives): each tensor's
    update on the card within ``OPT_RTOL`` of its norm of the CPU's. An
    alias's CPU run is its name's without ``fused`` (the same optimizer).
    Reports the worst tensor and the card's ms a step (8 steps, host clock
    around work that ends in a synchronize)."""
    import torch.nn.functional as F

    from unite_torch.ops.normalize import normalize_videos
    from unite_torch.optim.factory import OPT_NAMES, create_optimizer
    from unite_torch.utils.schedules import cosine_scheduler

    cases = ([(n, None) for n in OPT_NAMES + OPT_ALIASES]
             + [(n, "bfloat16") for n in OPT_BF16_MU])
    torch.manual_seed(41)
    model = optim_vit(torch, card)
    batch = stage2_batch(torch, 2, 42)
    model.train()
    reset_counts(A)
    loss = F.cross_entropy(
        model(normalize_videos(batch["videos"].to(card))).float(),
        batch["labels"].to(card))
    loss.backward()
    torch.cuda.synchronize()
    expect_counts(read_counts(A), {"K3": OPT_BLOCKS, "K3+lse": OPT_BLOCKS,
                                   "K4a": OPT_BLOCKS, "K4b": OPT_BLOCKS},
                  "optim-card-vs-cpu step")
    params = {n: p.detach().float().cpu().clone() for n, p in
              model.named_parameters()}
    grads = {n: p.grad.float().cpu().clone()
             for n, p in model.named_parameters()}
    models = {"cpu": (optim_vit(torch, "cpu"), "cpu"), "card": (model, card)}
    lr_tab = cosine_scheduler(2.5e-5, 1e-6, 20, 100, start_warmup_value=1e-6)
    wd_tab = cosine_scheduler(0.05, 0.05, 20, 100)
    cpu_runs, res, worst = {}, {}, 0.0
    t0 = time.perf_counter()
    for opt, mu in cases:
        base = (opt.lower().replace("fused", "").strip("_"), mu)
        lr = OPT_LR_SCALE.get(base[0].replace("lookahead_", ""), 1.0) * lr_tab
        upd = {}
        for side, (m, dev) in models.items():
            if side == "cpu" and base in cpu_runs:
                upd[side] = cpu_runs[base]
                continue
            named = dict(m.named_parameters())
            with torch.no_grad():
                for n, p in named.items():
                    p.copy_(params[n])
                    p.grad = grads[n].to(dev)
            tx, _ = create_optimizer(
                opt, lr, m, weight_decay=wd_tab, momentum=0.9,
                num_layers=OPT_BLOCKS, layer_decay=0.65,
                mu_dtype=getattr(torch, mu) if mu else None, device=dev)
            if side == "card":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(OPT_STEPS):
                tx.step()
            if side == "card":
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t1) / OPT_STEPS * 1e3
            upd[side] = {n: p.detach().cpu() - params[n]
                         for n, p in named.items()}
            if side == "cpu":
                cpu_runs[base] = upd[side]
        rel = {}
        for n, d_cpu in upd["cpu"].items():
            diff = (upd["card"][n] - d_cpu).norm().item()
            norm = d_cpu.norm().item()
            rel[n] = diff / norm if norm > 0 else (0.0 if diff == 0
                                                   else float("inf"))
        name = opt + (f"+mu_{mu}" if mu else "")
        k = max(rel, key=rel.get)
        # the median step of a weight in its fp32 ulps, on the CPU
        ulps = torch.cat([(d.abs() / (params[n].abs() * 2.0 ** -23)).flatten()
                          for n, d in upd["cpu"].items()]) / OPT_STEPS
        res[name] = dict(update_rel=rel[k], worst=k, card_step_ms=step_ms,
                         step_ulps=ulps.nan_to_num(posinf=0.0).median().item())
        worst = max(worst, rel[k])
    for p in model.parameters():
        p.grad = None
    out = dict(cases=res, worst_update_rel=worst, loss=loss.item(),
               seconds=time.perf_counter() - t0, card=card_line())
    print(f"optim-card-vs-cpu: {json.dumps(out)}", flush=True)
    bad = {n: r for n, r in res.items() if not r["update_rel"] <= OPT_RTOL}
    if bad:
        raise AssertionError(f"optim-card-vs-cpu: updates off the CPU's by "
                             f"more than {OPT_RTOL} of their norm: {bad}")
    return out


def profile_optimizer(torch, tx) -> dict:
    """One ``tx.step()`` under torch.profiler: the device time and the
    number of kernels it launched, and its wall time to a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tx.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    return dict(device_ms=sum(e.self_device_time_total for e in rows) / 1e3,
                kernels=sum(e.count for e in rows), wall_ms=wall_ms)


def stage2_opt_path(torch, A, b: int = 8, warmup: int = 2,
                    timed: int = 5) -> dict:
    """Phase stage2-opt-b8: the stage-2 finetune train step (B=8, blocks
    0-6 frozen) under each of ``STAGE2_OPTS`` in turn, 2 warm-up and 5
    timed steps, 12 K3 (with lse), 12 K4a and 12 K4b a step, exact; the
    step's ms, one profiled step's device ms, the optimizer's own (one more
    ``step()`` from the last gradients, profiled: device ms, kernels, wall
    ms) and the peak memory of each."""
    res, launches = {}, {"K3": 0, "K4a": 0, "K4b": 0}
    batch = stage2_batch(torch, b, 9)
    batch["videos"] = batch["videos"].pin_memory()
    for opt in STAGE2_OPTS:
        torch.manual_seed(7)
        state, step, _ = build_stage2(torch, "bfloat16", "cuda", 0.1,
                                      opt=opt)
        gen = torch.Generator(device="cuda").manual_seed(8)
        torch.cuda.reset_peak_memory_stats()
        reset_counts(A)
        metrics = [step(state, batch, gen) for _ in range(warmup)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            metrics.append(step(state, batch, gen))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts(A)
        n = warmup + timed
        vals = [(m["loss"].item(), m["grad_norm"].item()) for m in metrics]
        check_finite(vals)
        expect_counts(counts, {"K3": 12 * n, "K3+lse": 12 * n,
                               "K4a": 12 * n, "K4b": 12 * n},
                      f"stage2-opt-b8 {opt}, {n} steps")
        for k in launches:
            launches[k] += counts[k]
        r = dict(step_ms=dt / timed * 1e3, clips_per_s=b * timed / dt,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 losses=[v[0] for v in vals])
        r["profile"] = profile_step(
            torch, lambda: step(state, batch, gen),
            f"chip_smoke_profile_stage2_{opt}.json")
        r["optimizer"] = profile_optimizer(torch, state.optimizer)
        check_finite([[p.float().abs().max().item()
                       for p in state.model.parameters()]])
        print(f"stage2-opt-b8 {opt}: {json.dumps(r)} on {card_line()}",
              flush=True)
        res[opt] = r
        del state, step, metrics
        torch.cuda.empty_cache()
    res["launches"] = launches
    return res


# the wgmma sources: none may spill; a serialized product is reported
WGMMA_SOURCES = ("flash_fwd_wgmma", "flash_bwd_wgmma", "short_attn_wgmma",
                 "short_bwd_wgmma", "blocked_matmul_wgmma")


def check_ptxas(paths) -> dict:
    """Print each kernel's ptxas lines (registers, spills, and any product
    that ptxas serialized) and return, for each wgmma source, its kernels'
    registers, spilled bytes and whether any product was serialized; raise
    if a kernel of a wgmma source spills or has no report."""
    import re

    lines = {name: [] for name in WGMMA_SOURCES}
    for name, path in paths.items():
        log = path.with_suffix(".log")
        if not log.exists():
            continue
        for line in log.read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "serialized")):
                print(f"  ptxas {path.name}: {line.strip()}")
                if name in lines:
                    lines[name].append(line.strip())
    report = {}
    for name, found in lines.items():
        text = " ".join(found)
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill", text)]
        if not regs or not spills or any(spills):
            raise AssertionError(f"{name} ptxas: {text or 'no report'}")
        report[name] = {"registers": max(regs), "kernels": len(regs),
                        "spill_bytes": sum(spills),
                        "serialized": "serialized" in text}
        if report[name]["serialized"]:
            print(f"  ptxas {name}: a wgmma product is serialized", flush=True)
    return report


def check_flash_lengths(torch, A, head_dim: int = 64, heads=(2, HEADS)):
    """Phase 3: the K3/K6 forward (csrc/flash_fwd_wgmma.cu) against its
    plain version at every length of ``SWEEP_LENGTHS`` (B=2, 2 and 12
    heads), on contiguous [B, H, S, D] tensors and strided qkv views (K6)
    and on the packed lanes of qkv (K3), with and without the lse; the two
    outputs must be equal. ``head_dim`` 80 at ``heads`` 2 and 8. Returns the
    largest errors by length."""
    SCALE = head_dim ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(12)
    worst = {}
    for s in SWEEP_LENGTHS:
        for h in heads:
            qkv = torch.randn((2, s, 3 * h * head_dim), generator=gen,
                              device="cuda").to(torch.bfloat16)
            views = A._split_heads(qkv, h)
            dense = [t.contiguous() for t in views]
            ref, ref_lse = A.flash_reference(*dense, scale=SCALE)
            runs = {layout: (lambda lse, x=x: A.flash_fwd(*x, SCALE, lse))
                    for layout, x in (("contiguous", dense), ("views", views))}
            runs["packed"] = lambda lse: A.packed_flash_fwd(qkv, h, SCALE, lse)
            for layout, run in runs.items():
                out, lse = run(True)
                out_nl, _ = run(False)
                torch.cuda.synchronize()
                want = ref if layout != "packed" else A._merge_heads(ref)
                e = (out.float() - want.float()).abs().max().item()
                le = (lse - ref_lse).abs().max().item()
                if (not bool(torch.isfinite(out).all()) or e > FWD_TOL
                        or le > 1e-3 or not torch.equal(out_nl, out)):
                    raise AssertionError(
                        f"K3/K6 forward S={s} H={h} D={head_dim} {layout}: "
                        f"max abs err {e}"
                        f" (tol {FWD_TOL}), lse err {le}, equal without lse "
                        f"{torch.equal(out_nl, out)}")
                w = worst.setdefault(s, {"max_abs_err": 0.0, "lse_err": 0.0})
                w["max_abs_err"] = max(w["max_abs_err"], e)
                w["lse_err"] = max(w["lse_err"], le)
            del qkv, views, dense, ref, ref_lse, out, lse, out_nl
    print(f"K3/K6 forward at head dim {head_dim}: lengths "
          f"{list(SWEEP_LENGTHS)} x heads {tuple(heads)} x "
          f"(contiguous, views, packed) x lse: {worst}", flush=True)
    return worst


def check_flash_bwd_lengths(torch, A, head_dim: int = 64,
                            heads=(2, HEADS)):
    """Phase 3: the flash backward (csrc/flash_bwd_wgmma.cu: K4a/K4b and
    K6's dq and dk/dv) against its plain versions at every length of
    ``SWEEP_LENGTHS`` (B=2, 2 and 12 heads), on the packed lane slices of
    qkv (K4), strided qkv views with o and do laid out as the models lay
    them out, and contiguous tensors (K6), from the plain forward's o and
    lse2, within ``BWD_TOL`` times the largest |dq|, |dk| or |dv| of the
    plain version (at S = 1, dq and dk are 0 up to rounding noise, so no
    tolerance relative to them alone holds); a repeat must be equal bit for
    bit (no atomics). ``head_dim`` 80 at ``heads`` 2 and 8. Returns the
    largest errors over that scale, by length."""
    SCALE = head_dim ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(14)
    worst = {}
    for s in SWEEP_LENGTHS:
        for h in heads:
            qkv = torch.randn((2, s, 3 * h * head_dim), generator=gen,
                              device="cuda").to(torch.bfloat16)
            views = A._split_heads(qkv, h)
            dense = [t.contiguous() for t in views]
            o, lse = A.flash_reference(*dense, scale=SCALE)
            do = torch.randn(o.shape, generator=gen, device="cuda").to(
                torch.bfloat16)
            refs = A.flash_reference_bwd(*dense, o, lse, do, scale=SCALE)
            o_rows, do_rows = (A._empty_like_rows(views[0]).copy_(x)
                               for x in (o, do))
            runs = {"contiguous": lambda: A.flash_bwd(*dense, o, lse, do,
                                                      SCALE),
                    "views": lambda: A.flash_bwd(*views, o_rows, lse,
                                                 do_rows, SCALE)}
            out_p, do_p = A._merge_heads(o), A._merge_heads(do)
            runs["packed"] = lambda: [
                A._heads_of(x, h) for x in A.packed_flash_bwd(
                    qkv, out_p, lse, do_p, h, SCALE).chunk(3, dim=-1)]
            top = max(r.float().abs().max().item() for r in refs)
            tol = BWD_TOL * top
            for layout, run in runs.items():
                got, again = run(), run()
                torch.cuda.synchronize()
                for name, a, r, a2 in zip(("dq", "dk", "dv"), got, refs,
                                          again):
                    e = (a.float() - r.float()).abs().max().item()
                    if (not bool(torch.isfinite(a).all()) or e > tol
                            or not torch.equal(a, a2)):
                        raise AssertionError(
                            f"flash backward S={s} H={h} D={head_dim} "
                            f"{layout} {name}: max "
                            f"abs err {e} (tol {tol}), repeat equal "
                            f"{torch.equal(a, a2)}")
                    w = worst.setdefault(s, {})
                    w[name] = max(w.get(name, 0.0), e / top)
            del qkv, views, dense, o, lse, do, refs, o_rows, do_rows, got
    print(f"flash backward at head dim {head_dim}: lengths "
          f"{list(SWEEP_LENGTHS)} x heads {tuple(heads)} x (packed, views, "
          f"contiguous): max abs err / max |ref| {worst}", flush=True)
    return worst


def check_short_lengths(torch, A, head_dim: int = 64,
                        heads=(2, HEADS, 16)):
    """Phase 3: the short forward (csrc/short_attn_wgmma.cu) against its
    plain versions at every length of ``SHORT_LENGTHS`` (B=2; 2, 12 and 16
    heads): K1 on the packed lanes of qkv with and without the lse, K5 on
    strided qkv views and contiguous tensors with and without m and l; each
    repeated launch equal bit for bit. Then k = -q at 197, 320, 392 (K1 and
    K5) and 768 (K1), where every real score is negative, so a zero-filled
    key past S entering the row max would show. ``head_dim`` 80 at
    ``heads`` 2 and 8, k = -q up to K1's guard of 512. Returns the largest
    errors by length."""
    SCALE = head_dim ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(13)
    worst = {}

    def note(s, **errs):
        w = worst.setdefault(s, dict.fromkeys(errs, 0.0))
        for k, e in errs.items():
            w[k] = max(w.get(k, 0.0), e)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    def k1(qkv, h, s):
        ref, ref_lse = A.qkv_attention_reference(qkv, h, SCALE)
        out, lse = A.fused_qkv_fwd(qkv, h, SCALE, with_lse=True)
        again, _ = A.fused_qkv_fwd(qkv, h, SCALE, with_lse=True)
        out_nl, none = A.fused_qkv_fwd(qkv, h, SCALE)
        torch.cuda.synchronize()
        e, le = err(out, ref), err(lse, ref_lse)
        if (not bool(torch.isfinite(out).all()) or e > FWD_TOL or le > 1e-3
                or none is not None or not torch.equal(again, out)
                or not torch.equal(out_nl, out)):
            raise AssertionError(f"K1 S={s} H={h}: max abs err {e} (tol "
                                 f"{FWD_TOL}), lse err {le}, repeats equal "
                                 f"{torch.equal(again, out)}, without lse "
                                 f"{torch.equal(out_nl, out)}")
        note(s, k1_err=e, k1_lse_err=le)

    def k5(q, k, v, s, layout):
        ref, ref_m, ref_l = A.grouped_reference(q, k, v, scale=SCALE)
        out, (m, l) = A.grouped_fwd(q, k, v, SCALE, with_stats=True)
        again, (m2, l2) = A.grouped_fwd(q, k, v, SCALE, with_stats=True)
        out_ns, none = A.grouped_fwd(q, k, v, SCALE)
        torch.cuda.synchronize()
        e, me = err(out, ref), err(m, ref_m)
        lr = ((l - ref_l).abs() / ref_l).max().item()
        same = (torch.equal(again, out) and torch.equal(out_ns, out)
                and torch.equal(m2, m) and torch.equal(l2, l))
        if (not bool(torch.isfinite(out).all()) or e > FWD_TOL or me > 1e-3
                or lr > 1e-4 or none is not None or not same):
            raise AssertionError(f"K5 S={s} {layout}: max abs err {e} (tol "
                                 f"{FWD_TOL}), m err {me}, l rel err {lr}, "
                                 f"repeats equal {same}")
        note(s, k5_err=e, k5_m_err=me, k5_l_rel_err=lr)

    for s in SHORT_LENGTHS:
        for h in heads:
            qkv = torch.randn((2, s, 3 * h * head_dim), generator=gen,
                              device="cuda").to(torch.bfloat16)
            k1(qkv, h, s)
            views = A._split_heads(qkv, h)
            k5(*views, s, "views")
            k5(*(t.contiguous() for t in views), s, "contiguous")
            del qkv, views
    for s in (197, 320, M075_TOKENS, A.RESIDENT_MAX_SEQ[head_dim]):
        q = torch.randn((2, s, 2, head_dim), generator=gen,
                        device="cuda").abs()
        v = torch.randn((2, s, 2, head_dim), generator=gen, device="cuda")
        qkv = torch.cat([q, -q, v], dim=2).reshape(2, s, 6 * head_dim).to(
            torch.bfloat16)
        k1(qkv, 2, f"{s} k=-q")
        if s <= A.GROUPED_MAX_SEQ:
            k5(*(t.contiguous() for t in A._split_heads(qkv, 2)),
               f"{s} k=-q", "contiguous")
    print(f"short forward at head dim {head_dim}: lengths "
          f"{list(SHORT_LENGTHS)} x heads {tuple(heads)} x (K1 packed, K5 "
          f"views, K5 contiguous) x statistics, and k = -q: {worst}",
          flush=True)
    return worst


def check_short_bwd_lengths(torch, A, head_dim: int = 64,
                            heads=(2, HEADS, 16)):
    """Phase 3: the short backward (csrc/short_bwd_wgmma.cu) against its
    plain versions at every length of ``SHORT_LENGTHS`` (B=2): K2 on the
    packed lanes of qkv from K1's out and lse2 (2, 12 and 16 heads, and at
    ``FUSED_QKV_MAX_SEQ``, its shared-memory guard), K5's backward on strided
    qkv views (do laid out as the models lay it out) and contiguous tensors
    from the K5 forward's m and l (2 and 12 heads); within ``BWD_TOL``
    times the largest |dq|, |dk| or |dv| of the plain version, and each
    repeat equal bit for bit. ``head_dim`` 80 at ``heads`` 2 and 8, K2 up
    to its guard of 512. Returns the largest errors over that scale, by
    length."""
    SCALE = head_dim ** -0.5
    guard = A.RESIDENT_MAX_SEQ[head_dim]
    gen = torch.Generator(device="cuda").manual_seed(15)
    worst = {}

    def check(what, s, got, again, refs):
        top = max(r.float().abs().max().item() for r in refs)
        w = worst.setdefault(s, {})
        for name, a, a2, r in zip(("dq", "dk", "dv"), got, again, refs):
            e = (a.float() - r.float()).abs().max().item()
            if (not bool(torch.isfinite(a).all()) or e > BWD_TOL * top
                    or not torch.equal(a, a2)):
                raise AssertionError(
                    f"short backward {what} S={s} {name}: max abs err {e} "
                    f"(tol {BWD_TOL * top}), repeat equal "
                    f"{torch.equal(a, a2)}")
            w[f"{what.split()[0]}_{name}"] = max(
                w.get(f"{what.split()[0]}_{name}", 0.0), e / top)

    for s in SHORT_LENGTHS + ((guard,) if guard not in SHORT_LENGTHS
                              else ()):
        for h in heads:
            qkv = torch.randn((2, s, 3 * h * head_dim), generator=gen,
                              device="cuda").to(torch.bfloat16)
            out, lse = A.fused_qkv_fwd(qkv, h, SCALE, with_lse=True)
            do = torch.randn(out.shape, generator=gen, device="cuda").to(
                torch.bfloat16)

            def k2():
                return [A._heads_of(x, h) for x in A.fused_qkv_bwd(
                    qkv, out, lse, do, h, SCALE).chunk(3, dim=-1)]

            got, again = k2(), k2()
            torch.cuda.synchronize()
            refs = [A._heads_of(x, h) for x in A.qkv_attention_reference_bwd(
                qkv, do, h, SCALE).chunk(3, dim=-1)]
            check(f"K2 H={h} D={head_dim}", s, got, again, refs)
            if s > A.GROUPED_MAX_SEQ or h == 16:
                continue
            views = A._split_heads(qkv, h)
            dense = [x.contiguous() for x in views]
            g = A._heads_of(do, h)
            refs = A.grouped_reference_bwd(*dense, g, scale=SCALE)
            for layout, x, gl in (("views", views, g),
                                  ("contiguous", dense, g.contiguous())):
                _, (m, l) = A.grouped_fwd(*x, SCALE, with_stats=True)
                got = A.grouped_bwd(*x, gl, m, l, SCALE)
                again = A.grouped_bwd(*x, gl, m, l, SCALE)
                torch.cuda.synchronize()
                check(f"K5 H={h} {layout}", s, got, again, refs)
    print(f"short backward at head dim {head_dim}: lengths "
          f"{list(SHORT_LENGTHS)} (K2 also {guard}) x heads {tuple(heads)} "
          f"(16 for K2 only) x (K2 packed, K5 views, K5 contiguous): max "
          f"abs err / max |ref| {worst}", flush=True)
    return worst


def check_flash_kernels(torch, A, head_dim: int = 64,
                        shapes=(("train", 5, HEADS, STAGE3_CLS_TOKENS, True),
                                ("l14", 40, 16, 577, True),
                                ("eval", 32, HEADS, STAGE3_CLS_TOKENS, False)),
                        tag: str = "", repeats: int = 0):
    """Phase 3, stage 3: K6 against its plain version at the stage-3 CLS
    train shape [5, 12, 1569, 64], the CLS eval shape [32, 12, 1569, 64]
    (forward only) and the clip_l14_336 teacher's [40, 16, 577, 64], on
    contiguous tensors and on the strided views of a qkv projection output
    that the models pass; times on the views. ``tag`` "/d80": the huge
    VideoMAE encoder at mask 0.6, [2, 16, 632, 80], and with a CLS token,
    [2, 16, 1569, 80] (``head_dim``, ``shapes``), each of ``repeats``
    backwards equal to the first bit for bit. The softmax scale is
    head_dim^-0.5."""
    import torch.nn.functional as F

    SCALE = head_dim ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(11)
    results = {}
    for label, b, h, s, train in shapes:
        label += tag
        qkv = torch.randn((b, s, 3 * h * head_dim), generator=gen,
                          device="cuda").to(torch.bfloat16)
        views = A._split_heads(qkv, h)
        dense = [t.contiguous() for t in views]
        ref, ref_lse = A.flash_reference(*dense, scale=SCALE)
        errs = {}
        for layout, (q, k, v) in (("contiguous", dense), ("views", views)):
            out, lse = A.flash_fwd(q, k, v, SCALE, with_lse=train)
            torch.cuda.synchronize()
            e = (out.float() - ref.float()).abs().max().item()
            if not bool(torch.isfinite(out).all()) or e > FWD_TOL:
                raise AssertionError(f"K6 {label} {layout}: max abs err {e} "
                                     f"> {FWD_TOL}")
            if train and (lse - ref_lse).abs().max().item() > 1e-3:
                raise AssertionError(f"K6 {label} {layout}: lse err")
            errs[layout] = e
        q, k, v = views
        out_nl, none = A.flash_fwd(q, k, v, SCALE)
        if none is not None or not torch.equal(out_nl, out):
            raise AssertionError(f"K6 {label}: the forward without lse differs")
        run = partial(A.flash_fwd, q, k, v, SCALE, train)
        ms, dev_ms = median_ms(run), device_ms(run)
        plain_ms = median_ms(lambda: A.flash_reference(q, k, v, scale=SCALE))
        sdpa = partial(F.scaled_dot_product_attention, *dense, scale=SCALE)
        lib_ms, lib_dev_ms = median_ms(sdpa), device_ms(sdpa)
        tok = b * h * s * head_dim * 2  # bytes of one [B, H, S, D] tensor
        stat = b * h * s * 4      # one fp32 row statistic
        bms, by = bound(4 * tok + (stat if train else 0),
                        4.0 * b * h * s * s * head_dim)
        results[f"K6/{label}"] = dict(
            shape=[b, h, s, head_dim], max_abs_err=max(errs.values()),
            max_abs_err_by_layout=errs, ms=ms, device_ms=dev_ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
            library_device_ms=lib_dev_ms,
            library="scaled_dot_product_attention forward")
        print(f"K6 flash_fwd {label} {results[f'K6/{label}']}", flush=True)
        del ref, ref_lse, out_nl
        if not train:
            del qkv, views, dense, q, k, v, out, lse
            torch.cuda.empty_cache()
            continue

        # dq and dk/dv from the forward above, on both layouts
        do = torch.randn(out.shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        refs = A.flash_reference_bwd(*dense, out, lse, do, scale=SCALE)
        berr = {}
        for layout, qkv_t in (("contiguous", dense), ("views", views)):
            got = A.flash_bwd(*qkv_t, out, lse, do, SCALE)
            torch.cuda.synchronize()
            for name, a, r in zip(("dq", "dk", "dv"), got, refs):
                e = (a.float() - r.float()).abs().max().item()
                tol = BWD_TOL * r.float().abs().max().item()
                if not bool(torch.isfinite(a).all()) or e > tol:
                    raise AssertionError(f"K6 {label} {layout} {name}: max "
                                         f"abs err {e} > {tol}")
                berr[name] = max(berr.get(name, (0.0, tol)), (e, tol))
            for i in range(repeats):
                again = A.flash_bwd(*qkv_t, out, lse, do, SCALE)
                if not all(torch.equal(a, a2) for a, a2 in zip(got, again)):
                    raise AssertionError(
                        f"K6 {label} {layout} backward: repeat {i + 1} of "
                        f"{repeats} differs from the first")
        del refs, got
        dq, dk, dv = (A._empty_like_rows(t) for t in views)
        delta = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
        ms_dq = median_ms(lambda: A.flash_dq(q, k, v, out, do, lse, dq, delta,
                                             SCALE))
        ms_dkv = median_ms(lambda: A.flash_dkv(q, k, v, do, lse, delta, dk, dv,
                                               SCALE))
        plain_dq = median_ms(lambda: A._flash_dq_reference(q, k, v, out, do,
                                                           lse, SCALE))
        plain_dkv = median_ms(lambda: A._flash_dkv_reference(q, k, v, do, lse,
                                                             delta, SCALE))
        dev_dq = device_ms(lambda: A.flash_dq(q, k, v, out, do, lse, dq,
                                              delta, SCALE))
        dev_dkv = device_ms(lambda: A.flash_dkv(q, k, v, do, lse, delta, dk,
                                                dv, SCALE))
        leaves = [t.detach().requires_grad_(True) for t in dense]
        o_lib = F.scaled_dot_product_attention(*leaves, scale=SCALE)

        def sdpa_bwd():
            torch.autograd.grad(o_lib, leaves, do, retain_graph=True)

        bwd_ms, bwd_dev_ms = median_ms(sdpa_bwd), device_ms(sdpa_bwd)

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(*leaves, scale=SCALE).backward(do)

        fwd_bwd_ms = median_ms(sdpa_fwd_bwd)
        for key, ms_k, dev, plain, nbytes, flops, e in (
                ("dq", ms_dq, dev_dq, plain_dq, 6 * tok + 2 * stat, 6.0,
                 berr["dq"]),
                ("dkv", ms_dkv, dev_dkv, plain_dkv, 6 * tok + 2 * stat, 8.0,
                 max(berr["dk"], berr["dv"]))):
            bms, by = bound(nbytes, flops * b * h * s * s * head_dim)
            results[f"K6{key}/{label}"] = dict(
                shape=[b, h, s, head_dim], max_abs_err=e[0], tol=e[1],
                ms=ms_k,
                device_ms=dev, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=bwd_ms, library_device_ms=bwd_dev_ms,
                library="scaled_dot_product_attention backward (dq, dk, dv: "
                        "the dq and dk/dv kernels together)",
                library_fwd_bwd_ms=fwd_bwd_ms)
            print(f"K6 flash_{key} {label} {results[f'K6{key}/{label}']}",
                  flush=True)
        del (qkv, views, dense, q, k, v, out, lse, do, dq, dk, dv, delta,
             leaves, o_lib)
        torch.cuda.empty_cache()
    return results


def stage3_step_flops(b: int, cls: bool, frames: int = 8, width: int = 768,
                      layers: int = 12, grid: int = 196,
                      visible: int = 320) -> float:
    """Model operations of one stage-3 step at B_s = B_t = b, from the
    shapes (matrix products and attention; a backward counts as two
    forwards): the zero-shot and the attention teacher passes over b*8
    frames of 197 tokens, the source full pass forward and backward, the
    target full pass forward, and the committee's grad member forward and
    backward at the visible tokens (the CLS student embeds every patch
    before its gather). The kernels' recomputed scores are not counted."""
    def layer(tokens, seq):  # qkv, proj, fc1, fc2 (12 w^2) + q.k^T and p.v
        return tokens * (2 * 12 * width * width + 4 * seq * width)

    patch = 2 * 3 * 16 * 16 * width  # per patch
    n, nv = frames * grid + cls, visible + cls
    teacher = layers * layer(b * frames * (grid + 1), grid + 1) \
        + b * frames * grid * patch
    full = layers * layer(b * n, n) + b * frames * grid * patch
    grad = layers * layer(b * nv, nv) + b * (frames * grid if cls
                                             else visible) * patch
    return float(2 * teacher + 3 * full + full + 3 * grad)


def build_stage3(torch, dtype, device: str, drop_path: float, cls: bool,
                 b: int, model_state=None):
    """The stage-3 student, teacher, classifier, optimizer, steps and
    zero-shot function of configs/stage3_config.yaml with stage3.sh's run
    values (epochs 20, warmup 4, lr 1e-5 scaled by the batch, AdamW (0.9,
    0.95) eps 1e-8, wd 0.05, mask 0.8, committee 2, clip_matchORconf at
    0.1, conf-weighted, train_masked, taps [6], 12 classes), and text
    features for the zero-shot teacher made from a seed."""
    import numpy as np

    from unite_torch import create_model
    from unite_torch.engines.selftrain import (make_selftrain_eval_step,
                                               make_selftrain_step)
    from unite_torch.models.clip_text import build_zero_shot_fn
    from unite_torch.train import run_stage3
    from unite_torch.train.train_state import TrainState
    from unite_torch.utils.schedules import cosine_scheduler, scaled_lr

    args = SimpleNamespace(opt="adamw", opt_betas=[0.9, 0.95], opt_eps=1e-8,
                           nb_classes=12, freeze_clip_decoders=False,
                           src_classifier_type="linear",
                           clip_input_resolution=224)
    student = create_model(
        "adaptation_umt_base_patch16_224", device=device, dtype=dtype,
        num_frames=8, tubelet_size=1, drop_path_rate=drop_path,
        use_cls_token=cls, clip_decoder_embed_dim=768, clip_output_dim=512,
        clip_norm_type="l2", clip_return_layers=(6,))
    teacher = create_model("clip_b16", device=device, dtype=dtype,
                           input_resolution=224, clip_norm_type="l2",
                           return_attn=True, return_index=(6,))
    classifier = run_stage3.build_classifier(args, 768, device)
    model = run_stage3.combine(student, classifier)
    if model_state is not None:
        model.load_state_dict(model_state)
    niter, epochs = 100, 20
    lr_tab = cosine_scheduler(scaled_lr(1e-5, b), scaled_lr(1e-5, b), epochs,
                              niter, warmup_epochs=4,
                              start_warmup_value=scaled_lr(1e-6, b))
    tx, _ = run_stage3.build_optimizer(args, model, lr_tab, 0.05, device)
    kw = dict(num_patches=1568, frames=8, mask_ratio=0.8, committee_size=2,
              selection_strategy="clip_matchORconf", clip_threshold=0.1,
              conf_weighted_loss=True, train_masked=True, use_cls_token=cls,
              clip_input_resolution=224, nb_classes=12, device=device)
    step = make_selftrain_step(student, classifier, teacher, **kw)
    eval_step = make_selftrain_eval_step(student, classifier, cls,
                                         device=device)
    feats = ROOT / "build" / "chip_smoke_text_features.npy"
    feats.parent.mkdir(exist_ok=True)
    np.save(feats, np.random.default_rng(12).standard_normal(
        (12, 512)).astype(np.float32))
    args.clip_text_features = str(feats)
    zero_shot = build_zero_shot_fn(args, teacher)
    return TrainState(model, tx), step, eval_step, zero_shot


def stage3_batch(torch, b: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)

    def vids():
        return torch.from_numpy(
            rng.integers(0, 256, (b, 8, 224, 224, 3), dtype=np.uint8))

    return {"videos_s": vids(), "labels_s": torch.from_numpy(
                rng.integers(0, 12, (b,))),
            "videos_t": vids(), "videos_t_aug": vids(),
            "labels_t": torch.from_numpy(rng.integers(0, 12, (b,)))}


def stage3_card_vs_cpu(torch, cls: bool, card: str = "cuda"):
    """Phase 9: one stage-3 step on the card (bf16) against the CPU (fp32),
    B=2, with the same weights, batch, injected teacher attention and an
    injected clip_sim that agrees with the CPU's full-target predictions,
    so that every row matches CLIP on the CPU; the selection agreement of
    the card is reported apart (a discontinuous function of the logits)."""
    import numpy as np

    from unite_torch.engines.selftrain import pool_outputs
    from unite_torch.ops.masking import greedy_committee_masks, visible_indices
    from unite_torch.ops.normalize import normalize_videos

    torch.manual_seed(13)
    cpu_state, cpu_step, _, _ = build_stage3(torch, torch.float32, "cpu", 0.0,
                                             cls, 2)
    sd = {k: v.clone() for k, v in cpu_state.model.state_dict().items()}
    gpu_state, gpu_step, _, _ = build_stage3(torch, torch.bfloat16, card,
                                             0.0, cls, 2, sd)
    batch = stage3_batch(torch, 2, 14)
    rng = np.random.default_rng(15)
    batch["attn"] = torch.from_numpy(rng.dirichlet(
        np.ones(196), size=16).astype(np.float32))
    vis = visible_indices(greedy_committee_masks(batch["attn"], 0.8, 2)[-1]
                          .reshape(2, -1), 320)

    def logits(model, dev):
        student, head = model.model.eval(), model.classifier
        with torch.no_grad():
            full = head(pool_outputs(student.encoder(normalize_videos(
                batch["videos_t"].to(dev)))[0], cls)).float().cpu()
            grad = head(pool_outputs(student.encoder(normalize_videos(
                batch["videos_t_aug"].to(dev)), vis.to(dev))[0], cls)
                ).float().cpu()
        return full, grad

    l_cpu, l_gpu = logits(cpu_state.model, "cpu"), logits(gpu_state.model,
                                                           card)
    sim = torch.full((2, 12), 0.1 / 11)
    sim[torch.arange(2), l_cpu[0].argmax(-1)] = 0.9
    batch["clip_sim"] = sim
    rel = {name: ((g - c).abs().max() / c.abs().max()).item()
           for name, g, c in zip(("full_logits", "grad_logits"), l_gpu, l_cpu)}
    m_gpu = gpu_step(gpu_state, batch)
    m_cpu = cpu_step(cpu_state, batch)
    for k in ("loss", "grad_norm"):
        rel[k] = abs(m_gpu[k].item() - m_cpu[k].item()) / abs(m_cpu[k].item())
    agree = {k: (m_gpu[k].cpu().tolist(), m_cpu[k].tolist())
             for k in ("preds_t", "sel_ratio", "match_select_rate")}
    print(f"stage-3 step card bf16 vs cpu fp32 (cls={cls}): rel {rel}; "
          f"selection card/cpu {agree}; loss card {m_gpu['loss'].item()} "
          f"cpu {m_cpu['loss'].item()}", flush=True)
    check_finite([(m_gpu["loss"].item(), m_gpu["grad_norm"].item())])
    if not all(r <= STEP_RTOL for r in rel.values()):
        raise AssertionError(f"stage-3 card step (cls={cls}) disagrees with "
                             f"the CPU: {rel}")
    return dict(rel, selection_agrees=all(a == b for a, b in agree.values()))


def stage3_path(torch, A, cls: bool, b: int = 5, warmup: int = 2,
                timed: int = 10, device: str = "cuda"):
    """Phases 10 and 11: the stage-3 train step with the zero-shot
    similarities of each batch, as the stage-3 loop runs them; returns its
    numbers and the trained state with its eval step."""
    torch.manual_seed(16)
    state, step, eval_step, zero_shot = build_stage3(
        torch, torch.bfloat16, device, 0.1, cls, b)
    gen = torch.Generator(device=device).manual_seed(17)
    batch = {k: v.pin_memory() if device == "cuda" else v
             for k, v in stage3_batch(torch, b, 18).items()}

    def run():
        batch["clip_sim"] = zero_shot(batch["videos_t"])
        return step(state, batch, gen)

    torch.cuda.reset_peak_memory_stats()
    reset_counts(A)
    metrics = [run() for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        metrics.append(run())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts(A)
    n = warmup + timed
    vals = [(m["loss"].item(), m["grad_norm"].item()) for m in metrics]
    name = "stage3-cls-b16-b5" if cls else "stage3-b16-b5"
    print(f"{name} losses/grad norms: {vals}", flush=True)
    check_finite(vals)
    # K1: the zero-shot teacher, the attention teacher and the committee's
    # grad member forward (12 layers each); K2: its backward. The full
    # passes: the source forward with lse and backward, the target forward
    # without lse, on K3/K4 at 1568 tokens or K6 at 1569.
    want = {"K1": 36 * n, "K2": 12 * n}
    if cls:
        want.update({"K6": 24 * n, "K6+lse": 12 * n, "K6dq": 12 * n,
                     "K6dkv": 12 * n})
    else:
        want.update({"K3": 24 * n, "K3+lse": 12 * n, "K4a": 12 * n,
                     "K4b": 12 * n})
    expect_counts(counts, want, f"{name}, {n} steps")
    flops = stage3_step_flops(b, cls)
    sel = [m["sel_ratio"].item() for m in metrics]
    res = dict(clips_per_s=b * timed / dt, step_ms=dt / timed * 1e3,
               model_tflop_per_step=flops / 1e12,
               model_flops_util=flops * timed / dt / PEAK_BF16,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               steps=n, launches=counts, sel_ratio=sel[-1])
    print(f"{name} B={b}: {res} on {card_line()}", flush=True)
    res["profile"] = profile_step(torch, run,
                                  f"chip_smoke_profile_{name}.json")
    res["device_share_of_timed_step"] = (res["profile"]["device_ms"]
                                         / res["step_ms"])
    return res, state, eval_step


def stage3_eval(torch, A, state, eval_step, b: int = 32, warmup: int = 2,
                timed: int = 10, device: str = "cuda"):
    """Phase 12: the stage-3 eval step of the CLS student (softmax, top-1/5,
    loss) at the config's batch_size_val, on K6 forward only."""
    batch = {k: v.pin_memory() if device == "cuda" else v
             for k, v in stage2_batch(torch, b, 19).items()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts(A)
    outs = [eval_step(state, batch) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        outs.append(eval_step(state, batch))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts(A)
    n = warmup + timed
    expect_counts(counts, {"K6": 12 * n}, f"stage-3 CLS eval, {n} calls")
    probs = outs[-1]["probs"]
    sums = probs.sum(-1)
    if (probs.shape != (b, 12) or not bool(torch.isfinite(probs).all())
            or (sums - 1).abs().max().item() > 1e-4):
        raise AssertionError(f"stage-3 eval probs: shape {tuple(probs.shape)},"
                             f" row sums {sums.tolist()}")
    # the full forward of the CLS student (matrix products and attention)
    n_tok = STAGE3_CLS_TOKENS
    fwd = b * (12 * n_tok * (2 * 12 * 768 * 768 + 4 * n_tok * 768)
               + 8 * 196 * 2 * 3 * 16 * 16 * 768)
    res = dict(views_per_s=b * timed / dt, call_ms=dt / timed * 1e3,
               model_tflop_per_call=fwd / 1e12,
               model_flops_util=fwd * timed / dt / PEAK_BF16,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               calls=n, k6_launches=counts["K6"],
               acc1=outs[-1]["acc1"].item(), loss=outs[-1]["loss"].item())
    print(f"stage3-cls-eval-b16-b32 B={b}: {res} on {card_line()}",
          flush=True)
    res["profile"] = profile_step(torch, lambda: eval_step(state, batch),
                                  "chip_smoke_profile_stage3_cls_eval.json")
    res["device_share_of_timed_call"] = (res["profile"]["device_ms"]
                                         / res["call_ms"])
    return res


def entry_run(torch, A, argv, rec: dict) -> dict:
    """One call of ``run_stage1.main`` on the card with the launch counts
    read around it."""
    from unite_torch.config import parse_with_config
    from unite_torch.train import run_stage1
    from unite_torch.train.args import stage1_parser

    rec["steps"] = []

    def want():
        n = len(rec["steps"])
        return {"K1": 12 * n, "K5": 12 * n, "K5dq": 12 * n, "K5dkv": 12 * n}

    got = entry_call(torch, A, run_stage1.main,
                     parse_with_config(stage1_parser(), STAGE1_ARGS + argv),
                     want, "stage-1 entry")
    vals = step_values(rec["steps"], ("loss", "grad_norm"))
    check_finite(vals)
    ts = [r["t"] for r in rec["steps"]]
    n = len(ts)
    return dict(steps=n, wall_s=got["wall_s"], first_step_s=ts[0] - got["t0"],
                clips_per_s=2 * ENTRY_BATCH * (n - 1) / (ts[-1] - ts[0]),
                steps_seen=[r["step"] for r in rec["steps"]],
                losses=[v[0] for v in vals], launches=got["launches"])


def stage1_entry(torch, A, m075: dict, workdir: Path) -> dict:
    """Phase: ``stage1-entry-b32x2``. ``unite_torch.train.run_stage1.main``
    on the card with no --config: ``STAGE1_ARGS`` (stage1_config.yaml and
    stage1.sh) and synthetic source and target annotation files of 128
    clips each, uint8 clips normalized on the card, mask 0.75, 32 clips a
    stream. Call 1 trains epoch 0 (4 steps) and checkpoints at its end;
    call 2 auto-resumes at epoch 1 and is preempted after 2 steps
    (``--stop_after_steps``), writing a mid-epoch checkpoint. Each step is
    timed after a synchronize, so the entry's clips/s sits beside the bare
    step's (``m075``) and the data path's share shows. Its output directory
    is ``workdir``/stage1/run: the stage-2 entry's phase starts from the
    checkpoint it leaves there."""
    import unite_torch.train.run_stage1 as R
    from unite_torch.utils.checkpoint import load_checkpoint

    rec = {"steps": []}
    tmp = workdir / "stage1"
    tmp.mkdir()
    write_annotations(tmp, {"source": ENTRY_BATCH * ENTRY_STEPS,
                            "target": ENTRY_BATCH * ENTRY_STEPS})
    out = tmp / "run"
    base = ["--synthetic_data", "true", "--device_normalize", "true",
            "--mask_ratio", "0.75", "--batch_size", str(ENTRY_BATCH),
            "--ann_file_train", str(tmp / "source.csv"),
            "--ann_file_train_target", str(tmp / "target.csv"),
            "--output_dir", str(out)]
    with patched((R, "make_pretrain_train_step", timed_steps(
            torch, R.make_pretrain_train_step, rec, ("loss", "grad_norm")))):
        first = entry_run(torch, A, base + [
            "--stop_after_steps", str(ENTRY_STEPS)], rec)
        stats = entry_log(out)
        saved = load_checkpoint(out / "checkpoint-latest.pth")
        if (first["steps_seen"] != list(range(1, ENTRY_STEPS + 1))
                or len(stats) != 1 or stats[0]["epoch"] != 0
                or not all(abs(stats[0][k]) < float("inf") and
                           stats[0][k] == stats[0][k]
                           for k in ("train_loss", "train_grad_norm"))
                or saved["epoch"] != 0
                or saved["extra"]["step"] != ENTRY_STEPS):
            raise AssertionError(f"entry call 1: steps "
                                 f"{first['steps_seen']}, log {stats}, "
                                 f"checkpoint epoch {saved['epoch']} "
                                 f"extra {saved.get('extra')}")
        second = entry_run(torch, A, base + [
            "--auto_resume", "true", "--stop_after_steps", "2"], rec)
        saved = load_checkpoint(out / "checkpoint-latest.pth")
        if (second["steps_seen"] != [ENTRY_STEPS + 1, ENTRY_STEPS + 2]
                or saved["epoch"] != 1
                or saved["extra"]["epoch_step"] != 2
                or saved["extra"]["step"] != ENTRY_STEPS + 2):
            raise AssertionError(f"entry call 2 did not resume at epoch "
                                 f"1 step 0: steps {second['steps_seen']},"
                                 f" checkpoint epoch {saved['epoch']} "
                                 f"extra {saved.get('extra')}")
    res = dict(first=first, resumed=second, epoch0_log=stats[0],
               step_clips_per_s=m075["clips_per_s"],
               entry_share_of_step_rate=first["clips_per_s"]
               / m075["clips_per_s"])
    print(f"stage1-entry-b32x2: entry {first['clips_per_s']:.2f} clips/s "
          f"(resumed call {second['clips_per_s']:.2f}) beside the step's "
          f"{m075['clips_per_s']:.2f}; {json.dumps(res)} on {card_line()}",
          flush=True)
    return res


@contextlib.contextmanager
def patched(*subs):
    """Each ``(owner, name, value)`` of ``subs`` set for the block and put
    back after it, whatever happens in it."""
    old = [(o, n, getattr(o, n)) for o, n, _ in subs]
    for o, n, v in subs:
        setattr(o, n, v)
    try:
        yield
    finally:
        for o, n, v in old:
            setattr(o, n, v)


def entry_call(torch, A, main, args, want, what: str) -> dict:
    """One call of an entry's ``main(args)`` on the card, its launch counts
    read around it (in all, and K1's and K3's by (B, S)) and the totals held
    to ``want()``, which is asked after the call, and its peak device
    memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(A)
    t0 = time.perf_counter()
    main(args)
    wall = time.perf_counter() - t0
    counts = read_counts(A)
    expect_counts(counts, want(), what)
    return dict(t0=t0, wall_s=wall, launches=counts, by_shape=read_shapes(A),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def timed_steps(torch, build, rec: dict, keys, before=None):
    """``build`` (an entry's step builder) with each step it makes recorded
    in ``rec["steps"]``: the step counter after it, the time it ended and
    its 0-d metrics ``keys``, kept as device tensors (``step_values`` reads
    them once the call is over). A step waits for the card first where
    ``rec["sync"]`` (a set of step counters, or None: every step) names it;
    the others' times are when the host got the step back, so a rate
    between two synchronized steps keeps the entry's own overlap of host
    and card. ``before`` sees the builder's arguments."""
    def make(*a, **k):
        if before is not None:
            before(*a)
        step = build(*a, **k)

        def timed(state, batch, gen=None):
            out = step(state, batch, gen)
            sync = rec.get("sync")
            if sync is None or state.step in sync:
                torch.cuda.synchronize()
            rec["steps"].append(dict(t=time.perf_counter(), step=state.step,
                                     **{k: out[k].detach() for k in keys}))
            return out

        return timed

    return make


def step_values(steps, keys) -> list:
    """The recorded steps' metrics ``keys``, a tuple of floats a step."""
    return [tuple(float(r[k]) for k in keys) for r in steps]


def steady_rate(times, clips: int, first: int, last: int) -> dict:
    """An entry's steady clips/s from its steps' end times (``times[i]`` of
    step i + 1), between steps ``first`` and ``last``, both synchronized."""
    ts = times[first - 1:last]
    return dict(steady_clips_per_s=clips * (len(ts) - 1) / (ts[-1] - ts[0]),
                steady_step_host_s=[b - a for a, b in zip(ts, ts[1:])])


def write_annotations(tmp: Path, files: dict) -> None:
    """``{name}.csv`` under ``tmp`` for each ``name: clips`` of ``files``,
    synthetic clips of 12 classes."""
    for name, n in files.items():
        (tmp / f"{name}.csv").write_text("".join(
            f"{name}/clip_{i:04d}.mp4,{i % 12}\n" for i in range(n)))


def entry_log(d: Path) -> list:
    return [json.loads(x) for x in (d / "log.txt").read_text().splitlines()]


def same_merged_test(log_train: list, log_eval: list, what: str) -> dict:
    """The merged test accuracies of an entry's training call and of its
    --eval call (each log's last record): equal, and in [0, 100]."""
    got = [{k: log[-1][k] for k in ("test_acc1", "test_acc5")}
           for log in (log_train, log_eval)]
    if got[0] != got[1] or not all(0.0 <= v <= 100.0
                                   for v in got[0].values()):
        raise AssertionError(f"{what} test: training call {got[0]}, --eval "
                             f"call {got[1]}")
    return got[0]


def loader_rates(args, tmp: Path, streams) -> dict:
    """Items/s of an entry's host data path alone (decode, augmentation,
    collation; the entry's --num_workers threads), nothing on the card:
    what the entry's steps and eval calls wait for once the loaders'
    prefetch runs dry. ``streams`` holds (name, dataset mode, annotation
    file under ``tmp``, train, (first, last) batch of the rate or None for
    the whole pass, return_aug_for_val, loader seed offset); a train stream
    takes full shuffled batches of --batch_size, the others
    --batch_size_val."""
    import copy

    from unite_torch.data.build import build_dataset
    from unite_torch.train import common as C

    rates = {}
    for name, mode, anno, train, window, aug, seed_offset in streams:
        a = copy.copy(args)
        a.return_aug_for_val = aug
        ds, _ = build_dataset(mode, a, anno_path=str(tmp / anno),
                              reader=C.reader_for(a, not train))
        batch = a.batch_size if train else a.batch_size_val
        loader = C.make_loader(ds, a, batch, shuffle=train, drop_last=train,
                               seed=a.seed + seed_offset)
        t0 = time.perf_counter()
        ts, n = [t0], [0]
        for b in loader:
            ts.append(time.perf_counter())
            n.append(n[-1] + len(b[0]))
        i, j = window or (0, len(ts) - 1)
        rates[name] = (n[j] - n[i]) / (ts[j] - ts[i])
    return rates


def timed_calls(fn, times: list, outs=None):
    """``fn`` with each call's seconds appended to ``times`` (and its result
    to ``outs``)."""
    def run(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        times.append(time.perf_counter() - t0)
        if outs is not None:
            outs.append(out)
        return out
    return run


def check_eval_rows(torch, out, what: str, width=None) -> None:
    """Raise unless an entry's eval call gave 32 rows of 12 probabilities
    (and, with ``width``, finite features of that width)."""
    probs, feats = out["probs"], out.get("feats")
    sums = probs.sum(-1)
    if (probs.shape != (32, 12) or not bool(torch.isfinite(probs).all())
            or bool((probs < 0).any()) or (sums - 1).abs().max().item() > 1e-4
            or (feats is not None and (
                feats.shape != (32, width)
                or not bool(torch.isfinite(feats).all())))):
        raise AssertionError(
            f"{what} eval: probs {tuple(probs.shape)}, row sums "
            f"{sums.tolist()}, feats {None if feats is None else feats.shape}")


def checked_eval_step(torch, build_eval, what: str, rec=None):
    """``build_eval`` (an entry's eval-step builder) with each call's rows
    held by ``check_eval_rows`` and counted in ``rec["calls"]``."""
    def make(*a, **k):
        step = build_eval(*a, **k)

        def checked(state, batch):
            out = step(state, batch)
            check_eval_rows(torch, out, what)
            if rec is not None:
                rec["calls"] += 1
            return out

        return checked

    return make


def stage2_entry(torch, A, finetune: Path, s2: dict, ev: dict,
                 workdir: Path):
    """Phase: ``stage2-entry-b7``. ``unite_torch.train.run_stage2.main`` on
    the card with no --config: ``STAGE2_ARGS`` (stage2_config.yaml and
    stage2.sh) on synthetic clips, uint8 clips normalized on the card,
    --eval_freq 1 and --epochs 2 (stage2.sh's warmup of EPOCHS / 5: 0),
    --finetune the stage-1 entry's checkpoint-latest. K3, K4a and K4b are
    first held to their plain versions at its train shape [7, 1568, 2304].
    Call 1 trains epoch 0 (4 steps of 7), validates (40 clips: 2 calls of
    32), writes checkpoint-best and -latest, and is preempted after 2 steps
    of epoch 1; call 2 auto-resumes there, finishes the epoch, validates,
    reloads checkpoint-best and runs the 12-view test (96 views, 3 calls)
    and its merge; call 3 (--eval, --finetune checkpoint-best) runs only
    the test, whose merged accuracies must equal call 2's; call 4 trains
    one epoch of 96 steps with no validation, whose steps 17-96 give the
    entry's steady clips/s (steps 2-4 of call 1 run on batches the loader
    prefetched while the model was built), and runs the test. Launch counts
    are exact: 12 K4a and K4b a step, 12 K3 a step and an eval call. Calls
    1-3 wait for the card after every step; call 4 only after steps 1, 16
    and 96, so that its steady rate keeps the entry's overlap of host and
    card. Each eval call is timed after a synchronize."""
    import unite_torch.train.run_stage2 as R
    from unite_torch.config import parse_with_config
    from unite_torch.train import common as C
    from unite_torch.train.args import stage2_parser
    from unite_torch.utils.checkpoint import load_checkpoint

    rec = {"steps": [], "calls": 0, "val_s": [], "test_s": [], "sync": None}
    # before timing anything: the kernels at the train step's shape
    kr = check_packed_kernels(torch, A, shapes=(("train", 7, True),),
                              tag="/b7")
    tmp = workdir / "stage2"
    tmp.mkdir()
    write_annotations(tmp, {"train": S2_TRAIN, "val": S2_VAL,
                            "test": S2_TEST, "steady": S2_STEADY})
    out, out_eval, out_steady = tmp / "run", tmp / "eval", tmp / "steady"
    base = ["--synthetic_data", "true", "--device_normalize", "true",
            "--eval_freq", "1", "--epochs", "2", "--warmup_epochs", "0",
            "--ann_file_train", str(tmp / "train.csv"),
            "--ann_file_val", str(tmp / "val.csv"),
            "--ann_file_test", str(tmp / "test.csv")]
    steps_per_epoch = S2_TRAIN // 7
    n_steady = S2_STEADY // 7
    val_calls, test_calls = -(-S2_VAL // 32), -(-S2_TEST * 12 // 32)

    def call(argv, steps, evals, what):
        rec["steps"] = []
        got = entry_call(
            torch, A, R.main,
            parse_with_config(stage2_parser(), STAGE2_ARGS + base + argv),
            lambda: {"K3": 12 * (steps + evals), "K3+lse": 12 * steps,
                     "K4a": 12 * steps, "K4b": 12 * steps}, what)
        return dict(got, records=rec["steps"],
                    steps_seen=[r["step"] for r in rec["steps"]])

    with patched((R, "make_finetune_train_step", timed_steps(
                      torch, R.make_finetune_train_step, rec,
                      ("loss", "grad_norm"))),
                 (R, "make_eval_step", checked_eval_step(
                     torch, R.make_eval_step, "stage-2 entry", rec)),
                 (C, "run_validation", timed_calls(C.run_validation,
                                                   rec["val_s"])),
                 (C, "run_final_test", timed_calls(C.run_final_test,
                                                   rec["test_s"]))):
        first = call(["--output_dir", str(out), "--finetune", str(finetune),
                      "--stop_after_steps", "6"], 6, val_calls,
                     "stage-2 entry call 1")
        best = load_checkpoint(out / "checkpoint-best.pth")
        mid = load_checkpoint(out / "checkpoint-latest.pth")
        log1 = entry_log(out)
        if (first["steps_seen"] != list(range(1, 7))
                or best["epoch"] != 0 or best["extra"]["step"] != 4
                or mid["epoch"] != 1 or mid["extra"]["epoch_step"] != 2
                or mid["extra"]["step"] != 6 or len(log1) != 1
                or log1[0]["epoch"] != 0 or "val_acc1" not in log1[0]):
            raise AssertionError(
                f"stage-2 entry call 1: steps {first['steps_seen']}, "
                f"best {best['epoch']} {best['extra']}, latest "
                f"{mid['epoch']} {mid['extra']}, log {log1}")
        second = call(["--output_dir", str(out), "--finetune", str(finetune),
                       "--auto_resume", "true"], 2, val_calls + test_calls,
                      "stage-2 entry call 2")
        last = load_checkpoint(out / "checkpoint-latest.pth")
        log2 = entry_log(out)
        if (second["steps_seen"] != [7, 8] or last["epoch"] != 1
                or last["extra"]["step"] != 2 * steps_per_epoch
                or "epoch_step" in last["extra"]
                or [r["epoch"] for r in log2] != [0, 1, 2]):
            raise AssertionError(
                f"stage-2 entry call 2 did not resume at epoch 1 step 2: "
                f"steps {second['steps_seen']}, latest {last['epoch']} "
                f"{last['extra']}, log {log2}")
        third = call(["--output_dir", str(out_eval), "--finetune",
                      str(out / "checkpoint-best.pth"), "--eval", "true"],
                     0, test_calls, "stage-2 entry call 3 (--eval)")
        rec["sync"] = {1, S2_STEADY_FROM, n_steady}
        steady = call(["--output_dir", str(out_steady), "--finetune",
                       str(finetune), "--epochs", "1",
                       "--ann_file_train", str(tmp / "steady.csv"),
                       "--disable_eval_during_finetuning", "true",
                       "--save_ckpt", "false"], n_steady, test_calls,
                      "stage-2 entry call 4 (steady)")
        if steady["steps_seen"] != list(range(1, n_steady + 1)):
            raise AssertionError(f"stage-2 entry call 4: steps "
                                 f"{steady['steps_seen']}")
    keys = ("loss", "grad_norm")
    vals = {c: step_values(x["records"], keys) for c, x in (
        ("first", first), ("second", second), ("steady", steady))}
    check_finite(vals["first"] + vals["second"] + vals["steady"])
    host = loader_rates(
        parse_with_config(stage2_parser(), STAGE2_ARGS + base), tmp,
        (("train", "train", "steady.csv", True, (S2_STEADY_FROM, n_steady),
          False, 0),
         ("validation", "validation", "val.csv", False, None, False, 0),
         ("test", "test", "test.csv", False, None, False, 0)))
    test2 = same_merged_test(log2, entry_log(out_eval), "stage-2 entry")
    ts = [r["t"] for r in first["records"]]
    calls = [first, second, third, steady]
    launches = {k: sum(c["launches"][k] for c in calls)
                for k in first["launches"]}
    res = dict(
        steady_rate([r["t"] for r in steady["records"]], 7, S2_STEADY_FROM,
                    n_steady),
        prefetched_clips_per_s=7 * 3 / (ts[3] - ts[0]),
        first_step_s=ts[0] - first["t0"],
        step_s=[b - a for a, b in zip(ts, ts[1:])],
        bare_step_clips_per_s_b8=s2["clips_per_s"],
        val_views_per_s=[S2_VAL / s for s in rec["val_s"]],
        test_views_per_s=[S2_TEST * 12 / s for s in rec["test_s"]],
        bare_eval_views_per_s_b32=ev["views_per_s"],
        host_items_per_s=host,
        walls_s=[c["wall_s"] for c in calls],
        peak_mem_gb=[c["peak_mem_gb"] for c in calls],
        losses=[v[0] for v in vals["first"] + vals["second"]],
        epoch_logs=log2, test=test2, eval_calls=rec["calls"],
        launches=launches, calls=[c["launches"] for c in calls])
    print(f"stage2-entry-b7: entry {res['steady_clips_per_s']:.2f} clips/s "
          f"over steps {S2_STEADY_FROM + 1}-{n_steady} of call 4 (no wait "
          f"for the card between steps {S2_STEADY_FROM} and {n_steady}) "
          f"({res['prefetched_clips_per_s']:.2f} over steps 2-4 of call 1, "
          f"on prefetched batches, each step waited for) beside the bare "
          f"step's {s2['clips_per_s']:.2f} (B=8); first step after "
          f"{res['first_step_s']:.2f} s; val views/s "
          f"{[round(x, 2) for x in res['val_views_per_s']]}, test views/s "
          f"{[round(x, 2) for x in res['test_views_per_s']]} (bare eval "
          f"{ev['views_per_s']:.2f}); the host data path alone, items/s: "
          f"{host}; launches {launches}; "
          f"{json.dumps(res)} on {card_line()}", flush=True)
    return res, kr


def stage3_entry(torch, A, student_init: Path, s3: dict, workdir: Path):
    """Phase: ``stage3-entry-b5``. ``unite_torch.train.run_stage3.main`` on
    the card with no --config (``python -m unite_torch.train.run_stage3``'s
    parser, with --clip_init): ``STAGE3_ARGS`` (stage3_config.yaml and
    stage3.sh, --epochs 2 --warmup_epochs 0) on synthetic clips, the
    zero-shot teacher from a seeded [12, 512] --clip_text_features,
    --student_init the stage-2 entry's checkpoint-best. K1/K2 at the
    entry's teacher and committee shapes and K3/K4 at its train shape
    [5, 1568, 2304] are first held to their plain versions. Call 1 loads
    the student and the classifier (each held bit for bit to the stage-2
    checkpoint's blocks and head), validates (40 clips: 2 calls of 32) and
    runs the kNN probe (--knn_eval, 20 source and 40 val clips: 3 calls of
    the feature step), trains epoch 0 (4 steps of 5 source and 5 target
    clips), validates, writes checkpoint-best and -latest, and is
    preempted after 2 steps of epoch 1; call 2 auto-resumes there,
    finishes the epoch, validates, reloads checkpoint-best and runs the
    15-view test (120 views, 4 calls) and its merge; call 3 (--eval,
    --student_init checkpoint-best) loads every weight of that combined
    checkpoint bit for bit, runs only the test and must repeat call 2's
    merged accuracies; call 4 trains 96 steps of a 97-step epoch (stopped
    before the epoch's validation) whose steps 17-96 give the entry's
    steady clips/s. Calls 1-3 wait for the card after every step; call 4
    only after steps 1, 16 and 96, so that its steady rate keeps the
    entry's overlap of host and card. The device's share of those steps
    is derived, not traced: the bare step's profiled device time over
    their mean time (a profiler inside the entry's steps slows them by a
    quarter, and its stop holds the loop for seconds). Launch counts are
    exact, in all and by shape: a step 12 K1 at the attention teacher's
    [40, 197] and 12 at the committee's grad member's [5, 320], 12 K2, 24
    K3 at [5, 1568] (12 with lse), 12 K4a and 12 K4b; a zero-shot call 12
    K1 at [40, 197]; an eval call 12 K3 at [32, 1568]."""
    import numpy as np

    import unite_torch.train.run_stage3 as R
    from unite_torch.config import parse_with_config
    from unite_torch.train import common as C
    from unite_torch.train.args import stage3_parser
    from unite_torch.utils.checkpoint import load_checkpoint

    kr = check_kernels(torch, A, batches=(5 * 8, 5), tag="/s3")
    kr.update(check_packed_kernels(torch, A, shapes=(("train", 5, True),),
                                   tag="/b5"))
    rec = {"steps": [], "eval_calls": 0, "zs_calls": 0, "val_s": [],
           "test_s": [], "knn": [], "knn_stats": [], "heads": [],
           "expect": None, "loaded": [], "sync": None}
    build_eval, build_zs = R.make_selftrain_eval_step, R.build_zero_shot_fn
    load_head = R.load_classifier_head

    def loaded_state(student, classifier, *_):
        """The weights the step starts from against ``rec["expect"]``
        (name -> tensor), bit for bit."""
        want, rec["expect"] = rec["expect"], None
        if want is None:
            return
        got = dict({f"model.{k}": v for k, v in student.state_dict().items()},
                   **{f"classifier.{k}": v
                      for k, v in classifier.state_dict().items()})
        bad = [k for k, v in want.items()
               if k not in got or not torch.equal(got[k].float().cpu(),
                                                  v.float())]
        rec["loaded"].append(dict(compared=len(want), differ=bad))
        if bad or not want:
            raise AssertionError(f"stage-3 entry: loaded weights differ from "
                                 f"the checkpoint at {bad[:5]}")

    def checked_eval(student, classifier, *a, **k):
        step = build_eval(student, classifier, *a, **k)

        def checked(state, batch):
            out = step(state, batch)
            check_eval_rows(torch, out, "stage-3 entry",
                            classifier.weight.shape[1])
            rec["eval_calls"] += 1
            return out

        return checked

    def counted_zero_shot(*a, **k):
        fn = build_zs(*a, **k)

        def call(videos, *x, **y):
            rec["zs_calls"] += 1  # the batch generator's thread only
            return fn(videos, *x, **y)

        return None if fn is None else call

    def recorded_head(args, classifier):
        path = load_head(args, classifier)
        rec["heads"].append(path)
        return path

    tmp = workdir / "stage3"
    tmp.mkdir()
    n_steady = 5 * (S3_STEADY + 1)
    write_annotations(tmp, {"source": S3_SRC, "target": S3_TGT,
                            "val": S3_VAL, "test": S3_TEST,
                            "steady_src": n_steady, "steady_tgt": n_steady})
    feats = tmp / "text_features.npy"
    np.save(feats, np.random.default_rng(12).standard_normal(
        (12, 512)).astype(np.float32))
    out, out_eval, out_steady = tmp / "run", tmp / "eval", tmp / "steady"
    base = ["--synthetic_data", "true", "--device_normalize", "true",
            "--clip_text_features", str(feats),
            "--ann_file_train", str(tmp / "source.csv"),
            "--ann_file_train_target", str(tmp / "target.csv"),
            "--ann_file_val", str(tmp / "val.csv"),
            "--ann_file_test", str(tmp / "test.csv")]
    steps_per_epoch = S3_SRC // 5
    val_calls = -(-S3_VAL // 32)
    test_calls = -(-S3_TEST * 15 // 32)
    knn_calls = -(-S3_SRC // 32) + val_calls
    keys = ("loss", "grad_norm", "sel_ratio")

    def call(argv, what: str) -> dict:
        """One call of the entry, its launches held to the steps, eval
        calls and zero-shot calls it made: in all and by shape."""
        rec.update(steps=[], eval_calls=0, zs_calls=0)
        parser = stage3_parser()
        parser.add_argument("--clip_init", default="")

        def want():
            steps, zs = len(rec["steps"]), rec["zs_calls"]
            # the batch generator computes a batch's zero-shot
            # similarities when it builds the batch, so a preempted call
            # has built up to 3 (the device prefetch's 2 and the one in
            # hand) that no step took
            if not steps <= zs <= steps + 3:
                raise AssertionError(f"{what}: {zs} zero-shot calls for "
                                     f"{steps} steps")
            evals = rec["eval_calls"]
            return {"K1": 12 * (2 * steps + zs), "K2": 12 * steps,
                    "K3": 12 * (2 * steps + evals), "K3+lse": 12 * steps,
                    "K4a": 12 * steps, "K4b": 12 * steps}

        got = entry_call(torch, A, R.main,
                         parse_with_config(parser, STAGE3_ARGS + base + argv),
                         want, what)
        steps, zs = len(rec["steps"]), rec["zs_calls"]
        shapes = {"K1": {(40, 197): 12 * (steps + zs), (5, 320): 12 * steps},
                  "K3": {(5, 1568): 24 * steps,
                         (32, 1568): 12 * rec["eval_calls"]}}
        shapes = {k: {s: n for s, n in v.items() if n}
                  for k, v in shapes.items()}
        if got["by_shape"] != shapes:
            raise AssertionError(f"{what}: launches by (B, S) "
                                 f"{got['by_shape']}, expected {shapes}")
        return dict(got, records=rec["steps"], steps=steps,
                    eval_calls=rec["eval_calls"], zero_shot_calls=zs,
                    steps_seen=[r["step"] for r in rec["steps"]],
                    by_shape={k: {f"{b}x{s}": n for (b, s), n in v.items()}
                              for k, v in got["by_shape"].items()})

    s2 = load_checkpoint(student_init)["model"]
    with patched((R, "make_selftrain_step", timed_steps(
                      torch, R.make_selftrain_step, rec, keys,
                      before=loaded_state)),
                 (R, "make_selftrain_eval_step", checked_eval),
                 (R, "build_zero_shot_fn", counted_zero_shot),
                 (R, "load_classifier_head", recorded_head),
                 (C, "run_validation", timed_calls(C.run_validation,
                                                   rec["val_s"])),
                 (C, "run_final_test", timed_calls(C.run_final_test,
                                                   rec["test_s"])),
                 (C, "run_knn_probe", timed_calls(C.run_knn_probe,
                                                  rec["knn"],
                                                  rec["knn_stats"]))):
        # call 1: the stage-2 checkpoint's blocks and head, bit for bit
        rec["expect"] = dict(
            {f"model.encoder.{k}": v for k, v in s2.items()
             if k.startswith("blocks.")},
            **{f"classifier.{k}": s2[f"head.{k}"] for k in ("weight",
                                                           "bias")})
        first = call(["--output_dir", str(out), "--student_init",
                      str(student_init), "--knn_eval", "true",
                      "--knn_max_videos", "40", "--stop_after_steps", "6"],
                     "stage-3 entry call 1")
        if first["eval_calls"] != 2 * val_calls + knn_calls:
            raise AssertionError(f"stage-3 entry call 1: "
                                 f"{first['eval_calls']} eval calls")
        best = load_checkpoint(out / "checkpoint-best.pth")
        mid = load_checkpoint(out / "checkpoint-latest.pth")
        log1 = entry_log(out)
        diag = ("train_loss", "train_grad_norm", "train_sel_ratio",
                "train_match_select_rate", "train_conf_select_rate",
                "train_match_error_rate", "train_conf_error_rate",
                "train_correct_precision", "train_correct_recall",
                "cmp_student_acc", "cmp_clip_acc",
                "cmp_student_or_clip_correct", "cmp_student_clip_agree",
                "cmp_student_clip_disagree", "val_acc1", "val_loss")
        if (first["steps_seen"] != list(range(1, 7))
                or rec["heads"] != [str(student_init)]
                or best["epoch"] != 0 or best["extra"]["step"] != 4
                or mid["epoch"] != 1 or mid["extra"]["epoch_step"] != 2
                or mid["extra"]["step"] != 6 or len(log1) != 1
                or log1[0]["epoch"] != 0
                or not all(k in log1[0] and np.isfinite(log1[0][k])
                           for k in diag)
                or not rec["knn_stats"] or not rec["knn_stats"][0]):
            raise AssertionError(
                f"stage-3 entry call 1: steps {first['steps_seen']}, heads "
                f"{rec['heads']}, best {best['epoch']} {best['extra']}, "
                f"latest {mid['epoch']} {mid['extra']}, log {log1}, kNN "
                f"{rec['knn_stats']}")
        second = call(["--output_dir", str(out), "--student_init",
                       str(student_init), "--auto_resume", "true"],
                      "stage-3 entry call 2")
        last = load_checkpoint(out / "checkpoint-latest.pth")
        log2 = entry_log(out)
        if (second["steps_seen"] != [7, 8] or second["zero_shot_calls"] != 2
                or second["eval_calls"] != val_calls + test_calls
                or last["epoch"] != 1
                or last["extra"]["step"] != 2 * steps_per_epoch
                or "epoch_step" in last["extra"]
                or [r["epoch"] for r in log2] != [0, 1, 2]
                or not all(k in log2[1] for k in diag)):
            raise AssertionError(
                f"stage-3 entry call 2 did not resume at epoch 1 step 2: "
                f"steps {second['steps_seen']}, latest {last['epoch']} "
                f"{last['extra']}, log {log2}")
        # call 3: every weight of the combined checkpoint, bit for bit
        rec["expect"] = dict(load_checkpoint(
            out / "checkpoint-best.pth")["model"])
        del best, mid, last
        third = call(["--output_dir", str(out_eval), "--student_init",
                      str(out / "checkpoint-best.pth"), "--eval", "true"],
                     "stage-3 entry call 3 (--eval)")
        log3 = entry_log(out_eval)
        if (rec["heads"][-1] != str(out / "checkpoint-best.pth")
                or third["eval_calls"] != test_calls or len(log3) != 1):
            raise AssertionError(f"stage-3 entry call 3: heads "
                                 f"{rec['heads']}, eval calls "
                                 f"{third['eval_calls']}, log {log3}")
        rec["sync"] = {1, S3_STEADY_FROM, S3_STEADY}
        steady = call(["--output_dir", str(out_steady), "--student_init",
                       str(student_init), "--epochs", "1",
                       "--initial_validation", "false",
                       "--checkpoints_enabled", "false",
                       "--ann_file_train", str(tmp / "steady_src.csv"),
                       "--ann_file_train_target", str(tmp / "steady_tgt.csv"),
                       "--stop_after_steps", str(S3_STEADY)],
                      "stage-3 entry call 4 (steady)")
        if (steady["steps_seen"] != list(range(1, S3_STEADY + 1))
                or steady["eval_calls"] != 0):
            raise AssertionError(f"stage-3 entry call 4: steps "
                                 f"{steady['steps_seen']}, eval calls "
                                 f"{steady['eval_calls']}")
    del s2
    calls = [first, second, third, steady]
    vals = [step_values(c["records"], keys) for c in calls]
    check_finite([v[:2] for c in vals for v in c])
    window = (S3_STEADY_FROM, S3_STEADY)
    host = loader_rates(
        parse_with_config(stage3_parser(), STAGE3_ARGS + base), tmp,
        (("source", "train", "steady_src.csv", True, window, False, 0),
         ("target", "validation", "steady_tgt.csv", True, window, True, 7),
         ("validation", "validation", "val.csv", False, None, False, 0),
         ("test", "test", "test.csv", False, None, False, 0)))
    test2 = same_merged_test(log2, log3, "stage-3 entry")
    ts = [r["t"] for r in steady["records"]]
    launches = {k: sum(c["launches"][k] for c in calls)
                for k in first["launches"]}
    by_shape = {k: {s: sum(c["by_shape"][k].get(s, 0) for c in calls)
                    for s in {s for c in calls for s in c["by_shape"][k]}}
                for k in ("K1", "K3")}
    res = dict(steady_rate(ts, 5, S3_STEADY_FROM, S3_STEADY),
               first_step_s=ts[0] - steady["t0"],
               first_step_s_call1=first["records"][0]["t"] - first["t0"])
    res.update(
        derived_busy_share=s3["profile"]["device_ms"] / (
            5e3 / res["steady_clips_per_s"]),
        bare_step_clips_per_s_b5=s3["clips_per_s"],
        val_views_per_s=[S3_VAL / s for s in rec["val_s"]],
        test_views_per_s=[S3_TEST * 15 / s for s in rec["test_s"]],
        knn_s=rec["knn"], knn=rec["knn_stats"][0], host_items_per_s=host,
        loaded=rec["loaded"], walls_s=[c["wall_s"] for c in calls],
        losses=[v[:2] for v in vals[0] + vals[1]],
        sel_ratio=[v[2] for v in vals[0] + vals[1]],
        epoch_logs=log2, test=test2,
        steps=sum(c["steps"] for c in calls),
        zero_shot_calls=sum(c["zero_shot_calls"] for c in calls),
        eval_calls=sum(c["eval_calls"] for c in calls), launches=launches,
        by_shape=by_shape,
        calls=[{k: c[k] for k in ("launches", "by_shape", "steps",
                                  "eval_calls", "zero_shot_calls")}
               for c in calls])
    print(f"stage3-entry-b5: entry {res['steady_clips_per_s']:.2f} clips/s "
          f"(B_s = B_t = 5, 5 a step) over steps {S3_STEADY_FROM + 1}-"
          f"{S3_STEADY} of call 4 (no wait for the card between steps "
          f"{S3_STEADY_FROM} and {S3_STEADY}) beside the bare step's "
          f"{s3['clips_per_s']:.2f}; first step after "
          f"{res['first_step_s']:.2f} s ({res['first_step_s_call1']:.2f} s "
          f"in call 1, after the initial validation and the kNN probe); "
          f"device busy share, derived: {res['derived_busy_share']:.3f} (the "
          f"bare step's {s3['profile']['device_ms']:.2f} device ms a step "
          f"over the entry's step time); val views/s "
          f"{[round(x, 2) for x in res['val_views_per_s']]}, test views/s "
          f"{[round(x, 2) for x in res['test_views_per_s']]}; the host data "
          f"path alone, items/s: {host}; launches {launches}, by shape "
          f"{by_shape}; {json.dumps(res)} on {card_line()}", flush=True)
    return res, kr


def tool_classify(torch, A, workdir: Path):
    """Phase: ``tool-classify``. K3 against its plain version at one
    clip's [1, 1568, 2304] without lse, and on a [1, 1568, 2304] view whose
    batch stride is 2304 (PyTorch lets a dimension of size 1 take any
    stride and still calls the tensor contiguous), bit-equal to a fresh
    copy; then ``unite_torch.tools.classify.main`` (vit_base_patch16_224,
    8 frames of 224^2, --synthetic) on the stage-2 entry's checkpoint-best
    and on the stage-3 entry's combined one: each call exactly 12 K3 at
    (1, 1568), none with lse, no other kernel. Against the same call with
    --cpu (bf16 on both): the probabilities within ``STEP_RTOL``, and, as
    the entries' heads spread the classes little, what the attention
    makes: each block's attention output within ``TOOL_ATTN_RTOL`` and the
    pooled features (the head's input) within ``TOOL_FEAT_RTOL``, as norms
    of the difference over the CPU's norm; and the stage-2 call once more
    with each block's last ``TOOL_FAULT_KEYS`` keys and values read from
    its first ones (as a K3 that misread its tail tile would) must land
    outside both. Then
    ``unite_torch.tools.export_torch`` writes each as a reference .pth,
    which loads strictly into the entries' own models: the stage-2 ViT, the
    stage-3 student and, from ``src_classifier``, its classifier."""
    from unite_torch.config import parse_with_config
    from unite_torch.models import layers
    from unite_torch.tools import classify, export_torch
    from unite_torch.train import run_stage1, run_stage2, run_stage3
    from unite_torch.train.args import stage2_parser, stage3_parser

    t_phase = time.perf_counter()
    kr = check_packed_kernels(torch, A, shapes=(("classify", 1, False),))
    gen = torch.Generator(device="cuda").manual_seed(5)
    view = torch.randn((STAGE2_TOKENS, 1, 3 * HEADS * 64), generator=gen,
                       device="cuda").to(torch.bfloat16).transpose(0, 1)
    fresh = torch.empty(view.shape, dtype=view.dtype, device="cuda")
    fresh.copy_(view)
    if not view.is_contiguous() or view.stride() == fresh.stride():
        raise AssertionError(f"tool-classify: the B=1 view has strides "
                             f"{view.stride()}, not another layout")
    if not torch.equal(A.packed_flash_fwd(view, HEADS, SCALE)[0],
                       A.packed_flash_fwd(fresh, HEADS, SCALE)[0]):
        raise AssertionError("K3 at B=1: a view with batch stride "
                             f"{view.stride(0)} differs from its copy")
    del view, fresh
    ckpts = {"stage2": workdir / "stage2" / "run" / "checkpoint-best.pth",
             "stage3": workdir / "stage3" / "run" / "checkpoint-best.pth"}
    res, taps = {}, {}

    def keep(key):
        def hook(module, args, out=None):
            taps[key] = (args[0] if out is None else out).float().cpu()
        return hook

    def create_model(*args, **kwargs):
        model = make_model(*args, **kwargs)
        model.head.register_forward_pre_hook(keep("features"))
        for j, blk in enumerate(model.blocks):
            blk.attn.register_forward_hook(keep(j))
        return model

    def misread_tail(qkv, *args, **kwargs):
        qkv, c = qkv.clone(), qkv.shape[-1] // 3
        qkv[:, -TOOL_FAULT_KEYS:, c:] = qkv[:, :TOOL_FAULT_KEYS, c:]
        return attention(qkv, *args, **kwargs)

    make_model, classify.create_model = classify.create_model, create_model
    attention = layers.self_attention
    try:
        cpu_taps = {}
        for kind, path in ckpts.items():
            res[kind], cpu_taps[kind] = tool_classify_call(
                torch, A, classify, kind, path, taps)
        layers.self_attention = misread_tail
        classify.main([str(ckpts["stage2"]), "fake.mp4", "--synthetic"])
        attn, feat = taps_rel(taps, cpu_taps["stage2"])
        if max(attn) <= TOOL_ATTN_RTOL or feat <= TOOL_FEAT_RTOL:
            raise AssertionError(
                f"tool-classify: a misread tail of {TOOL_FAULT_KEYS} keys "
                f"moves the attention outputs by {attn} and the features "
                f"by {feat}, inside the gates")
        res["misread_tail"] = dict(attn_rel_vs_cpu=attn,
                                   features_rel_vs_cpu=feat)
    finally:
        classify.create_model = make_model
        layers.self_attention = attention
    # the exports, loaded strictly into models built on "meta" (no weights
    # to initialize: the load assigns every one)
    args2 = parse_with_config(stage2_parser(), STAGE2_ARGS)
    args3 = parse_with_config(stage3_parser(), STAGE3_ARGS)
    for kind, path in ckpts.items():
        dst = workdir / f"export_{kind}.pth"
        export_torch.main([str(path), str(dst)])
        out = torch.load(dst, weights_only=True)
        if kind == "stage2":
            parts = {"model": run_stage2.build_model(args2, "meta")}
        else:
            parts = {"model": run_stage1.build_student(args3, "meta"),
                     "src_classifier": run_stage3.build_classifier(
                         args3, 768, device="meta")}
        if set(out) != {"epoch", *parts}:
            raise AssertionError(f"export of {kind}: keys {sorted(out)}")
        for part, model in parts.items():
            model.load_state_dict(out[part], strict=True, assign=True)
        res[kind]["export_epoch"] = out["epoch"]
    res.update(launches=sum(res[kind]["launches"] for kind in ckpts),
               seconds=time.perf_counter() - t_phase)
    print(f"tool-classify: {json.dumps(res)} on {card_line()}", flush=True)
    return res, kr


def taps_rel(card: dict, cpu: dict):
    """Each block's attention output and the pooled features, card
    against CPU: the norm of the difference over the CPU's."""
    def rel(key) -> float:
        return float((card[key] - cpu[key]).norm() / cpu[key].norm())

    return [rel(j) for j in range(12)], rel("features")


def tool_classify_call(torch, A, classify, kind: str, path: Path,
                       taps: dict):
    """One checkpoint of ``tool-classify``: the call on the card, its
    launches, and the call with --cpu; ``taps`` is filled by the hooks that
    ``tool_classify`` puts on the model. Returns the results and the CPU
    call's taps."""
    import numpy as np

    argv = [str(path), "fake.mp4", "--synthetic"]
    torch.cuda.synchronize()
    reset_counts(A)
    t0 = time.perf_counter()
    probs = classify.main(argv)
    wall = time.perf_counter() - t0
    counts, shapes = read_counts(A), read_shapes(A)
    card = dict(taps)
    expect_counts(counts, {"K3": 12}, f"tool-classify {kind}")
    if shapes["K3"] != {(1, STAGE2_TOKENS): 12}:
        raise AssertionError(f"tool-classify {kind}: K3 by shape "
                             f"{shapes['K3']}")
    taps.clear()
    t0 = time.perf_counter()
    cpu = classify.main(argv + ["--cpu"])
    cpu_wall = time.perf_counter() - t0
    diff = float(np.abs(probs - cpu).max())
    if (not np.isfinite(probs).all() or abs(probs.sum() - 1.0) > 1e-3
            or diff > STEP_RTOL):
        raise AssertionError(f"tool-classify {kind}: card {probs} "
                             f"against the CPU's {cpu}")
    attn, feat = taps_rel(card, taps)
    if max(attn) > TOOL_ATTN_RTOL or feat > TOOL_FEAT_RTOL:
        raise AssertionError(f"tool-classify {kind}: against the CPU, the "
                             f"blocks' attention outputs differ by {attn}, "
                             f"the features by {feat}")
    cpu_taps = dict(taps)
    taps.clear()
    return dict(wall_s=wall, cpu_wall_s=cpu_wall, max_abs_diff_vs_cpu=diff,
                attn_rel_vs_cpu=attn, features_rel_vs_cpu=feat,
                prob_spread=float(cpu.max() - cpu.min()),
                launches=shapes["K3"][(1, STAGE2_TOKENS)],
                top5=classify.top_lines(probs)), cpu_taps


def tool_record_losses(torch, A, workdir: Path):
    """Phase: ``tool-record-losses``. K1 at the teacher's [32, 197, 2304]
    and K1/K2 at the student's [4, 314, 2304] against their plain versions;
    step 0 of ``unite_torch.tools.record_losses`` at --batch 1 on the card
    against the same step on the CPU (both bf16, the same seeded weights,
    videos and masks): loss and grad norm within ``STEP_RTOL``; then the
    tool at its defaults (adaptation_umt_base_patch16_224 against clip_b16,
    B=4, 8 frames of 224^2, 314 visible tokens) for ``TOOL_STEPS`` steps:
    each step exactly 12 K1 at (32, 197), 12 K1 at (4, 314) and 12 K2,
    finite losses, one JSON line a step."""
    from unite_torch.tools import record_losses

    t_phase = time.perf_counter()
    kr = check_kernels(torch, A, batches=(8 * TOOL_B, TOOL_B),
                       lengths=(197, TOOL_VISIBLE), tag="/tools")
    one = ["--steps", "1", "--batch", "1"]
    t0 = time.perf_counter()
    card = record_losses.main([str(workdir / "losses_b1_card.jsonl"), *one])
    t1 = time.perf_counter()
    cpu = record_losses.main([str(workdir / "losses_b1_cpu.jsonl"), *one],
                             device="cpu")
    t2 = time.perf_counter()
    check_finite([(r["loss"], r["grad_norm"]) for r in card + cpu])
    rel = {k: abs(card[0][k] - cpu[0][k]) / abs(cpu[0][k])
           for k in ("loss", "grad_norm")}
    if max(rel.values()) > STEP_RTOL:
        raise AssertionError(f"tool-record-losses: step 0 at B=1 on the card "
                             f"{card} against the CPU's {cpu}")
    out = workdir / "losses.jsonl"
    torch.cuda.synchronize()
    reset_counts(A)
    t3 = time.perf_counter()
    recs = record_losses.main([str(out), "--steps", str(TOOL_STEPS)])
    wall = time.perf_counter() - t3
    n = TOOL_STEPS
    counts, shapes = read_counts(A), read_shapes(A)
    expect_counts(counts, {"K1": 24 * n, "K2": 12 * n}, "tool-record-losses")
    want = {(8 * TOOL_B, 197): 12 * n, (TOOL_B, TOOL_VISIBLE): 12 * n}
    if shapes["K1"] != want:
        raise AssertionError(f"tool-record-losses: K1 by shape "
                             f"{shapes['K1']}, expected {want}")
    check_finite([(r["loss"], r["grad_norm"]) for r in recs])
    if [json.loads(line) for line in out.read_text().splitlines()] != recs:
        raise AssertionError(f"tool-record-losses: {out} does not hold the "
                             f"{n} records {recs}")
    res = dict(b1_card=card[0], b1_cpu=cpu[0], b1_rel=rel,
               b1_card_wall_s=t1 - t0, b1_cpu_wall_s=t2 - t1, steps=recs,
               wall_s=wall, launches=counts,
               k1_teacher=shapes["K1"][(8 * TOOL_B, 197)],
               k1_student=shapes["K1"][(TOOL_B, TOOL_VISIBLE)],
               seconds=time.perf_counter() - t_phase)
    print(f"tool-record-losses: {json.dumps(res)} on {card_line()}",
          flush=True)
    return res, kr


def ffmpeg_headers() -> list:
    """The FFmpeg development headers the native decoder's build needs
    (libavformat's directory), where the machine has them."""
    import glob

    return sorted(glob.glob("/usr/include/libavformat")
                  + glob.glob("/usr/include/*/libavformat")
                  + glob.glob("/usr/local/include/libavformat"))


def write_clips(d: Path, n: int, frames: int, raster) -> list:
    """``n`` mp4v clips of ``frames`` frames at ``raster`` (w, h), written
    with OpenCV: smooth gradients that move from frame to frame and a
    bright box, a little different in each clip."""
    import cv2
    import numpy as np

    w, h = raster
    yy, xx = np.mgrid[0:h, 0:w]
    paths = []
    for c in range(n):
        path = str(d / f"clip_{c:02d}.mp4")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25,
                             (w, h))
        for i in range(frames):
            f = np.stack([(xx + 3 * i + 11 * c) % 256,
                          (yy * 2 + i) % 256,
                          (xx // 2 + yy // 2 + 5 * c) % 256], -1)
            f = f.astype(np.uint8)
            y0, x0 = (8 * i) % (h - 40), (5 * i + 9 * c) % (w - 60)
            f[y0:y0 + 40, x0:x0 + 60] = (40 + 13 * c) % 256
            vw.write(f)
        vw.release()
        paths.append(path)
    return paths


def write_jpeg_folder(d: Path, frames: int, raster) -> str:
    """A frame folder (img_00001.jpg, ...) of smooth frames and a
    saturated box, JPEG quality 95."""
    import cv2
    import numpy as np

    w, h = raster
    d.mkdir()
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(1, frames + 1):
        img = np.stack([(yy // 2 + xx // 3 + 10 * i) % 200,
                        (xx // 2 + 20 * i) % 200,
                        (yy // 2 + 5 * i) % 200], -1).astype(np.uint8)
        img[20:60, 30:90] = (255, 0, 0)
        cv2.imwrite(str(d / f"img_{i:05}.jpg"), img,
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
    return str(d)


def sparse_indices(frames: int, k: int = 8) -> list:
    """k indices spread over a clip, as the sparse sampler takes them."""
    return [int(round(i * (frames - 1) / (k - 1))) for i in range(k)]


def decode_rate(reader, clips: list, frames: int) -> float:
    """Frames/s of ``reader`` decoding 8 frames of each clip, one thread."""
    idx = sparse_indices(frames)
    t0 = time.perf_counter()
    for path in clips:
        reader.get_batch(path, idx)
    return 8 * len(clips) / (time.perf_counter() - t0)


def native_decode(torch, workdir: Path) -> dict:
    """Phase ``native-decode``: the port's native decoder built from
    unite_torch/native/videodec.cpp with g++ (into
    build/unite_torch_native/), 16 mp4v clips of 64 frames at 340x256 and
    a 16-frame JPEG folder written with OpenCV, and the decoder held to
    OpenCV's decode within the JAX package's own bars
    (tests/test_native_decoder.py): the plain decode equal, the short-side
    224 decode within a mean of 4 levels (95% within 16) and the 224x224
    sized decode within a mean of 4 of OpenCV's decode resized by
    ``resize_clip``, the ``jd_*`` JPEG decode within a mean of 2 levels
    (under 5% beyond 10) of ``cv2.imread``. Prints the decode rates in
    frames/s at 8 frames a clip (native plain and short-side 224, OpenCV
    beside them). Where the machine has no FFmpeg headers the decoder does
    not build: the phase says so and the recipe phase reads through
    ``CV2VideoReader``, what JAX's ``default_reader`` takes without its
    library; a build or decode error where the headers are present fails
    the smoke."""
    import numpy as np

    from unite_torch.data import video_reader as VR
    from unite_torch.data.datasets_extra import RawFrameReader
    from unite_torch.data.transforms import resize_clip
    from unite_torch.native import _build

    d = workdir / "video"
    d.mkdir()
    t0 = time.perf_counter()
    clips = write_clips(d, DECODE_CLIPS, DECODE_FRAMES, DECODE_RASTER)
    folder = write_jpeg_folder(d / "frames", 16, DECODE_RASTER)
    res = dict(clips=len(clips), frames=DECODE_FRAMES,
               raster=list(DECODE_RASTER),
               write_s=time.perf_counter() - t0, headers=ffmpeg_headers())
    cv = VR.CV2VideoReader()
    res["cv2_frames_per_s"] = decode_rate(cv, clips, DECODE_FRAMES)
    if not res["headers"]:
        res["built"] = False
        print("native-decode: no FFmpeg development headers on this "
              "machine (no libavformat under /usr/include): the native "
              "decoder does not build here; the recipe phase reads the "
              "clips through CV2VideoReader, the reader JAX's "
              "default_reader takes without its library, and the CPU tests "
              f"hold the decoder; OpenCV decodes {res['cv2_frames_per_s']:.1f}"
              " frames/s at 8 frames a clip", flush=True)
        return res, clips
    t0 = time.perf_counter()
    lib_path = _build.build()
    res.update(built=True, build_s=time.perf_counter() - t0,
               library=str(lib_path.relative_to(ROOT)))
    idx = sparse_indices(DECODE_FRAMES)
    native = VR.NativeVideoReader()
    diffs = {"plain": 0.0, "short_side_224_mean": 0.0,
             "short_side_224_q95": 0.0, "size_224_mean": 0.0}
    for path in clips[:4]:
        if native.num_frames(path) != DECODE_FRAMES:
            raise AssertionError(f"native frame count of {path}: "
                                 f"{native.num_frames(path)}")
        ref = cv.get_batch(path, idx)
        got = native.get_batch(path, idx)
        if got.shape != ref.shape or not np.array_equal(got, ref):
            raise AssertionError(
                f"native plain decode of {path} differs from OpenCV's: "
                f"{got.shape} {ref.shape}, max "
                f"{np.abs(got.astype(int) - ref).max()}")
        scaled = VR.NativeVideoReader(short_side=224).get_batch(path, idx)
        host = resize_clip(ref, 224)
        if scaled.shape != host.shape or scaled.shape[1:3] != (224, 297):
            raise AssertionError(f"scaled decode {scaled.shape}, host "
                                 f"resize {host.shape}")
        diff = np.abs(scaled.astype(np.int16) - host.astype(np.int16))
        diffs["short_side_224_mean"] = max(diffs["short_side_224_mean"],
                                           float(diff.mean()))
        diffs["short_side_224_q95"] = max(diffs["short_side_224_q95"],
                                          float(np.quantile(diff, 0.95)))
        sized = VR.NativeVideoReader(size=(224, 224)).get_batch(path, idx)
        host = resize_clip(ref, (224, 224))
        if sized.shape != host.shape:
            raise AssertionError(f"sized decode {sized.shape}")
        diff = np.abs(sized.astype(np.int16) - host.astype(np.int16))
        diffs["size_224_mean"] = max(diffs["size_224_mean"],
                                     float(diff.mean()))
    if (diffs["short_side_224_mean"] >= 4.0
            or diffs["short_side_224_q95"] > 16
            or diffs["size_224_mean"] >= 4.0):
        raise AssertionError(f"native scaled decodes off OpenCV's: {diffs}")
    jidx = list(range(16))
    a = RawFrameReader(use_native=True).get_batch(folder, jidx)
    b = RawFrameReader().get_batch(folder, jidx)
    jdiff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    diffs.update(jpeg_mean=float(jdiff.mean()),
                 jpeg_over_10=float((jdiff > 10).mean()))
    if a.shape != b.shape or jdiff.mean() >= 2.0 or (jdiff > 10).mean() \
            >= 0.05:
        raise AssertionError(f"native JPEG decode off OpenCV's: {diffs}")
    res.update(diffs=diffs,
               native_frames_per_s=decode_rate(native, clips, DECODE_FRAMES),
               native_224_frames_per_s=decode_rate(
                   VR.NativeVideoReader(short_side=224), clips,
                   DECODE_FRAMES),
               cv2_frames_per_s_again=decode_rate(cv, clips, DECODE_FRAMES))
    print(f"native-decode: built {res['library']} in {res['build_s']:.1f} s;"
          f" {DECODE_CLIPS} clips {DECODE_RASTER[0]}x{DECODE_RASTER[1]}x"
          f"{DECODE_FRAMES}; against OpenCV {diffs}; decode at 8 frames a "
          f"clip, frames/s: native {res['native_frames_per_s']:.1f}, native "
          f"short side 224 {res['native_224_frames_per_s']:.1f}, OpenCV "
          f"{res['cv2_frames_per_s']:.1f} / "
          f"{res['cv2_frames_per_s_again']:.1f}; on {card_line()}",
          flush=True)
    return res, clips


def stage1_remat(torch, A, b: int = 64, steps: int = 3):
    """Phase ``stage1-remat-b64``: the stage-1 step at the main path's
    geometry (B=64, mask 0.8, ViT-B/16 student, drop path 0.1) from the
    same weights, batch and generator seeds, plain and with every student
    block recomputed in the backward (``--use_checkpoint``): ``steps``
    steps each, the losses and every parameter after them bit-equal. K1
    runs 12 times a step at the teacher's [8B, 197] either way, and at the
    student's [B, 320] 12 times plain and 24 times recomputed (each block's
    forward again in the backward); K2 12 times. Both steps' times (steps 2
    on, each waited for) and peak memories are reported."""
    torch.manual_seed(11)
    plain, teacher, step = build_step(torch, b, torch.bfloat16, "cuda", 0.1)
    sd = {k: v.clone() for k, v in plain.model.state_dict().items()}
    td = teacher.state_dict()
    batch = random_batch(torch, b, 12, with_vis_idx=False)
    batch["videos"] = batch["videos"].pin_memory()
    runs = {}

    def run(state, step, remat):
        gen = torch.Generator(device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(A)
        losses, times = [], []
        for i in range(steps):
            gen.manual_seed(100 + i)
            t0 = time.perf_counter()
            m = step(state, batch, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(m["loss"].detach().clone())
        counts, shapes = read_counts(A), read_shapes(A)["K1"]
        n = 24 if remat else 12
        what = f"stage1-remat-b64 ({'remat' if remat else 'plain'})"
        expect_counts(counts, {"K1": (12 + n) * steps, "K2": 12 * steps},
                      what)
        want = {(8 * b, 197): 12 * steps, (b, 320): n * steps}
        if shapes != want:
            raise AssertionError(f"{what}: K1 by (B, S) {shapes}, expected "
                                 f"{want}")
        return dict(losses=losses, step_ms=[t * 1e3 for t in times],
                    peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                    launches=counts, k1_student=shapes[(b, 320)])

    runs["plain"] = run(plain, step, False)
    params = {k: v.detach().clone() for k, v in
              plain.model.named_parameters()}
    del plain, teacher, step
    torch.cuda.empty_cache()
    remat, _, step = build_step(torch, b, torch.bfloat16, "cuda", 0.1, sd, td,
                                remat=True)
    runs["remat"] = run(remat, step, True)
    same_loss = all(torch.equal(x, y) for x, y in zip(
        runs["plain"]["losses"], runs["remat"]["losses"]))
    named = dict(remat.model.named_parameters())
    differ = [k for k, v in params.items() if not torch.equal(v, named[k])]
    if not same_loss or differ:
        raise AssertionError(
            f"stage1-remat-b64: the recomputed step is not the plain one: "
            f"losses {[x.item() for x in runs['plain']['losses']]} / "
            f"{[x.item() for x in runs['remat']['losses']]}, parameters "
            f"that differ {differ[:5]} ({len(differ)})")
    check_finite([[x.item()] for x in runs["plain"]["losses"]])
    res = {k: dict(v, losses=[x.item() for x in v["losses"]],
                   steady_step_ms=statistics.mean(v["step_ms"][1:]))
           for k, v in runs.items()}
    res["bit_equal_parameters"] = len(params)
    print(f"stage1-remat-b64: {steps} steps plain and recomputed bit-equal "
          f"(losses and all {len(params)} parameters); step ms plain "
          f"{res['plain']['steady_step_ms']:.2f}, remat "
          f"{res['remat']['steady_step_ms']:.2f}; peak memory plain "
          f"{res['plain']['peak_mem_gb']:.2f} GB, remat "
          f"{res['remat']['peak_mem_gb']:.2f} GB; {json.dumps(res)} on "
          f"{card_line()}", flush=True)
    return res


def stage2_recipe_steps(torch, A, b: int = 7, warmup: int = 2,
                        timed: int = 5) -> dict:
    """The bare B=7 stage-2 step, plain (stage2_config.yaml) and with the
    recipe (``RECIPE``: mixup and cutmix, dropout 0.1, the head's dropout
    0.5, every block recomputed, a bf16 first moment), from the same
    weights and batch, each timed in turn (plain, recipe, recipe, plain):
    clips/s, step ms and peak memory, with exact launches (12 K3 a step
    plain, 24 with remat; 12 K4a and 12 K4b), and one profiled step of the
    first plain and the first recipe run after their timed steps."""
    torch.manual_seed(13)
    res, sd = {}, None
    batch = stage2_batch(torch, b, 14)
    batch["videos"] = batch["videos"].pin_memory()
    for name in ("plain", "recipe", "recipe_again", "plain_again"):
        recipe = name.startswith("recipe")
        state, step, _ = build_stage2(torch, "bfloat16", "cuda", 0.1, sd,
                                      recipe=recipe)
        if sd is None:
            sd = {k: v.clone() for k, v in state.model.state_dict().items()}
        gen = torch.Generator(device="cuda").manual_seed(15)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(A)
        metrics = [step(state, batch, gen) for _ in range(warmup)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics += [step(state, batch, gen) for _ in range(timed)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = warmup + timed
        k3 = 24 if recipe else 12
        expect_counts(read_counts(A), {"K3": k3 * n, "K3+lse": k3 * n,
                                       "K4a": 12 * n, "K4b": 12 * n},
                      f"stage-2 B={b} step ({name}), {n} steps")
        vals = [(m["loss"].item(), m["grad_norm"].item()) for m in metrics]
        check_finite(vals)
        if recipe and "class_acc" in metrics[-1]:
            raise AssertionError("the mixup step logged class_acc")
        res[name] = dict(clips_per_s=b * timed / dt, step_ms=dt / timed * 1e3,
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                         losses=[v[0] for v in vals])
        if name in ("plain", "recipe"):
            res[name]["profile"] = profile_step(
                torch, lambda: step(state, batch, gen),
                f"chip_smoke_profile_stage2_b7_{name}.json")
        if recipe:
            mus = {s["mu"].dtype for s in state.optimizer.state.values()}
            if mus != {torch.bfloat16}:
                raise AssertionError(f"recipe step's first moments: {mus}")
        del state, step, metrics
        torch.cuda.empty_cache()
    print(f"stage-2 B={b} bare step, plain / recipe / recipe / plain: "
          f"clips/s {[round(r['clips_per_s'], 2) for r in res.values()]}, "
          f"step ms {[round(r['step_ms'], 2) for r in res.values()]}, peak "
          f"GB {[round(r['peak_mem_gb'], 2) for r in res.values()]} on "
          f"{card_line()}", flush=True)
    return res


def attn_dropout_route(torch, A, b: int = 7) -> dict:
    """A train-mode forward and backward of the stage-2 ViT with
    --attn_drop_rate 0.1 launches no K3 (no K4): JAX sends attention
    dropout to its XLA path, the port to the plain attention. Its eval
    forward launches K3, 12 times."""
    from unite_torch.ops.normalize import normalize_videos

    torch.manual_seed(16)
    state, _, _ = build_stage2(torch, "bfloat16", "cuda", 0.1,
                               attn_drop=0.1)
    model = state.model
    x = normalize_videos(stage2_batch(torch, b, 17)["videos"].cuda())
    gen = torch.Generator(device="cuda").manual_seed(18)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(A)
    model.train()
    loss = model(x, gen).float().square().mean()
    loss.backward()
    torch.cuda.synchronize()
    train = read_counts(A)
    expect_counts(train, {}, "train-mode forward/backward, attn_drop 0.1")
    peak = torch.cuda.max_memory_allocated() / 1e9
    reset_counts(A)
    with torch.no_grad():
        logits = model.eval()(x)
    torch.cuda.synchronize()
    evals = read_counts(A)
    expect_counts(evals, {"K3": 12}, "eval forward, attn_drop 0.1")
    check_finite([[loss.item()], [float(logits.float().abs().max())]])
    res = dict(train_launches=train, eval_launches=evals,
               train_peak_mem_gb=peak, loss=loss.item())
    print(f"attention dropout 0.1: training launched {train['K3']} K3 (the "
          f"plain attention, JAX's routing), evaluation {evals['K3']}; "
          f"train peak memory {peak:.2f} GB", flush=True)
    return res


def stage2_recipe_entry(torch, A, finetune: Path, clips: list,
                        native: bool, workdir: Path, entry2: dict):
    """Phase ``stage2-recipe-b7``. ``unite_torch.train.run_stage2.main`` on
    the card with ``STAGE2_ARGS`` and the recipe's flags (``RECIPE``:
    --mixup 0.8 --cutmix 1.0 --mixup_prob 1.0 --smoothing 0.1 --drop 0.1
    --fc_drop_rate 0.5 --use_checkpoint true --mu_dtype bfloat16,
    --attn_drop_rate 0 so attention stays on the kernels), chained from the
    stage-1 entry's checkpoint, reading the native-decode phase's 340x256
    clips through ``default_reader`` (the native decoder where it built,
    else OpenCV), 7 clips a step, validated each epoch. Call 1 trains
    epoch 0 (4 steps), validates, writes checkpoint-best and -latest and
    is preempted after 2 steps of epoch 1; call 2 auto-resumes there (the
    bf16 first moments loaded bit for bit from the mid-epoch checkpoint),
    finishes the epoch, validates and runs the 12-view test. Launches are
    exact: 24 K3 a step (each block's forward again in the backward) and 12
    an eval call, 12 K4a and 12 K4b a step. Every decode goes through the
    expected reader, and none fails. Before it: the bare B=7 steps, plain
    and recipe (``stage2_recipe_steps``), and the attention-dropout route
    (``attn_dropout_route``)."""
    import numpy as np

    import unite_torch.train.run_stage2 as R
    from unite_torch.config import parse_with_config
    from unite_torch.data import video_reader as VR
    from unite_torch.train import common as C
    from unite_torch.train.args import stage2_parser
    from unite_torch.utils import checkpoint as CK

    bare = stage2_recipe_steps(torch, A)
    route = attn_dropout_route(torch, A)
    tmp = workdir / "recipe"
    tmp.mkdir()
    n_train, n_val, n_test = 28, 16, 4
    for name, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        (tmp / f"{name}.csv").write_text("".join(
            f"{clips[i % len(clips)]},{i % 12}\n" for i in range(n)))
    out = tmp / "run"
    base = ["--device_normalize", "true", "--eval_freq", "1", "--epochs",
            "2", "--warmup_epochs", "0", "--output_dir", str(out),
            "--finetune", str(finetune),
            "--ann_file_train", str(tmp / "train.csv"),
            "--ann_file_val", str(tmp / "val.csv"),
            "--ann_file_test", str(tmp / "test.csv"), *RECIPE]
    rec = {"steps": [], "restored": [], "decoded": {}, "errors": []}
    want_reader = VR.NativeVideoReader if native else VR.CV2VideoReader

    def counting(cls):
        decode = cls.get_batch

        def get_batch(self, path, indices):
            try:
                out = decode(self, path, indices)
            except Exception as e:
                rec["errors"].append(f"{cls.__name__} {path}: {e!r}")
                raise
            key = cls.__name__
            rec["decoded"][key] = rec["decoded"].get(key, 0) + len(out)
            return out

        return get_batch

    restore = CK.restore_train_state

    def restoring(state, payload, **kw):
        out = restore(state, payload, **kw)
        names = {id(p): n for n, p in state.model.named_parameters()}
        moments = payload["optimizer"]["moments"]
        bad = [n for p, s in state.optimizer.state.items()
               for n in [names[id(p)]]
               if s["mu"].dtype != torch.bfloat16
               or not torch.equal(s["mu"].cpu(), moments[n]["mu"])
               or not torch.equal(s["nu"].cpu(), moments[n]["nu"])]
        rec["restored"].append(dict(tensors=len(state.optimizer.state),
                                    differ=bad))
        return out

    steps_per_epoch = n_train // 7
    val_calls, test_calls = -(-n_val // 32), -(-n_test * 12 // 32)

    def call(argv, steps, evals, what):
        rec["steps"] = []
        got = entry_call(
            torch, A, R.main,
            parse_with_config(stage2_parser(), STAGE2_ARGS + base + argv),
            lambda: {"K3": 24 * steps + 12 * evals, "K3+lse": 24 * steps,
                     "K4a": 12 * steps, "K4b": 12 * steps}, what)
        return dict(got, records=rec["steps"],
                    steps_seen=[r["step"] for r in rec["steps"]])

    with patched((R, "make_finetune_train_step", timed_steps(
                      torch, R.make_finetune_train_step, rec,
                      ("loss", "grad_norm"))),
                 (R, "make_eval_step", checked_eval_step(
                     torch, R.make_eval_step, "stage-2 recipe entry")),
                 (CK, "restore_train_state", restoring),
                 (VR.NativeVideoReader, "get_batch",
                  counting(VR.NativeVideoReader)),
                 (VR.CV2VideoReader, "get_batch",
                  counting(VR.CV2VideoReader))):
        first = call(["--stop_after_steps", "6"], 6, val_calls,
                     "stage-2 recipe entry call 1")
        best = CK.load_checkpoint(out / "checkpoint-best.pth")
        mid = CK.load_checkpoint(out / "checkpoint-latest.pth")
        mus = {m["mu"].dtype for m in mid["optimizer"]["moments"].values()}
        if (first["steps_seen"] != list(range(1, 7))
                or best["epoch"] != 0 or best["extra"]["step"] != 4
                or mid["epoch"] != 1 or mid["extra"]["epoch_step"] != 2
                or mid["extra"]["step"] != 6 or mus != {torch.bfloat16}):
            raise AssertionError(
                f"stage-2 recipe call 1: steps {first['steps_seen']}, best "
                f"{best['epoch']} {best['extra']}, latest {mid['epoch']} "
                f"{mid['extra']}, first moments {mus}")
        second = call(["--auto_resume", "true"], 2, val_calls + test_calls,
                      "stage-2 recipe entry call 2")
        last = CK.load_checkpoint(out / "checkpoint-latest.pth")
        log = entry_log(out)
        if (second["steps_seen"] != [7, 8] or last["epoch"] != 1
                or last["extra"]["step"] != 2 * steps_per_epoch
                or [r["epoch"] for r in log] != [0, 1, 2]
                or any("class_acc" in r or "train_class_acc" in r
                       for r in log)):
            raise AssertionError(
                f"stage-2 recipe call 2: steps {second['steps_seen']}, "
                f"latest {last['epoch']} {last['extra']}, log {log}")
    if (len(rec["restored"]) != 1 or rec["restored"][0]["differ"]
            or rec["errors"] or not rec["decoded"].get(want_reader.__name__)
            or set(rec["decoded"]) != {want_reader.__name__}):
        raise AssertionError(
            f"stage-2 recipe entry: restored {rec['restored']}, decode "
            f"errors {rec['errors']}, frames decoded by reader "
            f"{rec['decoded']} (expected {want_reader.__name__})")
    vals = step_values(first["records"] + second["records"],
                       ("loss", "grad_norm"))
    check_finite(vals)
    test = {k: log[-1][k] for k in ("test_acc1", "test_acc5")}
    if not all(0.0 <= v <= 100.0 for v in test.values()):
        raise AssertionError(f"stage-2 recipe test: {test}")
    ts = [r["t"] for r in first["records"]]
    launches = {k: first["launches"][k] + second["launches"][k]
                for k in first["launches"]}
    res = dict(
        first_step_s=ts[0] - first["t0"],
        clips_per_s_steps_2_4=7 * 3 / (ts[3] - ts[0]),
        plain_entry_first_step_s=entry2["first_step_s"],
        plain_entry_clips_per_s_steps_2_4=entry2["prefetched_clips_per_s"],
        peak_mem_gb=[first["peak_mem_gb"], second["peak_mem_gb"]],
        plain_entry_peak_mem_gb=entry2["peak_mem_gb"],
        bare_steps=bare, attn_dropout=route, reader=want_reader.__name__,
        frames_decoded=rec["decoded"], restored_moments=rec["restored"][0][
            "tensors"], losses=[v[0] for v in vals], epoch_logs=log,
        test=test, walls_s=[first["wall_s"], second["wall_s"]],
        launches=launches)
    print(f"stage2-recipe-b7: entry {res['clips_per_s_steps_2_4']:.2f} "
          f"clips/s over steps 2-4 of call 1 (each waited for; the plain "
          f"stage2-entry-b7: {res['plain_entry_clips_per_s_steps_2_4']:.2f}),"
          f" first step after {res['first_step_s']:.2f} s (plain "
          f"{res['plain_entry_first_step_s']:.2f} s), peak memory "
          f"{max(res['peak_mem_gb']):.2f} GB (plain "
          f"{max(res['plain_entry_peak_mem_gb']):.2f} GB); bare B=7 step "
          f"plain {bare['plain']['clips_per_s']:.2f} / recipe "
          f"{bare['recipe']['clips_per_s']:.2f} clips/s; "
          f"{res['restored_moments']} bf16 moments restored bit for bit; "
          f"frames decoded {rec['decoded']}; launches {launches}; "
          f"{json.dumps(res)} on {card_line()}", flush=True)
    return res


# ------------------------------------------------------------- scale-out
# (--tp, --zero1, --fsdp) of each layout the scale-out phases run
# the VideoMAE pretraining cell (VideoMAE's ViT-B Kinetics recipe: 16
# frames of 224^2, tubelet 2, tube mask 0.9, batch 32 a GPU, AdamW with
# betas (0.9, 0.95) and weight decay 0.05, no gradient clip): 8 x 196
# patches, 176 of each frame's 196 masked, so 160 visible tokens run the
# encoder (K1/K2) and 1568 the 384-wide, 6-head decoder (K3/K4)
MAE_FRAMES, MAE_TUBELET, MAE_MASK = 16, 2, 0.9
MAE_GRID = (MAE_FRAMES // MAE_TUBELET, 14, 14)


def mae_visible(ratio: float) -> int:
    """The encoder's tokens of a clip at tube-mask ``ratio``."""
    return MAE_GRID[0] * (196 - int(ratio * 196))


MAE_VISIBLE = mae_visible(MAE_MASK)  # 160
MAE_HEADS = 6
# the models' geometry by name: encoder and decoder widths, depths and heads
# (unite_torch/models/pretrain_videomae.py); base has 64-lane heads, huge
# 80-lane ones in both towers
MAE_BASE = SimpleNamespace(
    name="pretrain_videomae_base_patch16_224", tag="videomae-b16-b32",
    width=768, depth=12, heads=12, dec_width=384, dec_depth=8, dec_heads=6)
MAE_HUGE = SimpleNamespace(
    name="pretrain_videomae_huge_patch16_224", tag="videomae-h16-b16",
    width=1280, depth=32, heads=16, dec_width=640, dec_depth=8, dec_heads=8)
# the same model at ImageMAE's tube mask of 0.75, VideoMAE's ablation of
# its 0.9: 392 visible tokens, whose training route is K5 (above K2's 384)
MAE_HUGE_M075 = SimpleNamespace(**dict(vars(MAE_HUGE),
                                       tag="videomae-h16-m075-b16"))
M075_MASK, M06_MASK = 0.75, 0.6  # 392 encoder tokens (K5), 632 (K6)
HUGE_B = 16             # the huge cell's batch
HUGE_CHECK_DEPTH = (4, 2)  # its card-vs-CPU step: encoder and decoder blocks
D80_HEADS = (2, 8)      # the head-dim-80 length sweeps
# the UMT pretrain student and the masked CLIP teacher: 8 frames of 224^2,
# tubelet 1, tube mask 0.8 (40 of 196 patches a frame), six taps (6-11)
UMT_MASK, UMT_TAPS = 0.8, 6
UMT_VISIBLE = 8 * (196 - int(UMT_MASK * 196))  # 320


def tube_batch(torch, b: int, seed: int, frames: int, grid, ratio: float):
    """Seeded uint8 clips [b, frames, 224, 224, 3] and per-clip tube masks
    as (vis_idx, mask_idx) (``engines.pretrain_videomae.mask_indices``)."""
    import numpy as np

    from unite_torch.engines.pretrain_videomae import mask_indices
    from unite_torch.ops.masking import TubeMaskingGenerator

    rng = np.random.default_rng(seed)
    videos = rng.integers(0, 256, (b, frames, 224, 224, 3), dtype=np.uint8)
    gen = TubeMaskingGenerator(grid, ratio)
    vis, msk = mask_indices(np.stack([gen(rng) for _ in range(b)]))
    return {"videos": torch.from_numpy(videos),
            "vis_idx": torch.from_numpy(vis),
            "mask_idx": torch.from_numpy(msk)}


def videomae_clip_flops(cfg=MAE_BASE, ratio: float = MAE_MASK) -> float:
    """Model operations of one clip's VideoMAE train step (forward and
    backward as three forwards; matrix products and attention): the patch
    embedding of all 1568 patches, the encoder's blocks at the visible
    tokens (160 at tube-mask ``ratio`` 0.9, 392 at 0.75), the map to the
    decoder's width, the decoder's blocks at 1568 tokens and the head at
    the masked ones, at ``cfg``'s widths and depths."""
    from unite_torch.utils.flops import vit_block_flops

    n, vis = MAE_GRID[0] * 196, mae_visible(ratio)
    fwd = (2 * n * (MAE_TUBELET * 16 * 16 * 3) * cfg.width
           + cfg.depth * vit_block_flops(vis, cfg.width)
           + 2 * vis * cfg.width * cfg.dec_width
           + cfg.dec_depth * vit_block_flops(n, cfg.dec_width)
           + 2 * (n - vis) * cfg.dec_width * 1536)
    return 3.0 * fwd


def mae_launches(A, cfg, ratio: float, enc: int, dec: int) -> dict:
    """The kernel launches of one VideoMAE train step with ``enc`` encoder
    and ``dec`` decoder blocks at tube-mask ``ratio``: the encoder's
    visible tokens on the route ``self_attention`` takes there (K1/K2, K5
    or K6), the decoder's 1568 on K3 with lse, K4a and K4b."""
    s = mae_visible(ratio)
    if s <= A.FUSED_QKV_FWD_MAX_SEQ and A.use_fused_qkv(s, False, cfg.width):
        want = {"K1": enc, "K2": enc}
    elif s <= A.GROUPED_MAX_SEQ:
        want = {"K5": enc, "K5dq": enc, "K5dkv": enc}
    elif not A.use_fused_qkv(s, False, cfg.width):
        want = {"K6": enc, "K6+lse": enc, "K6dq": enc, "K6dkv": enc}
    else:
        raise ValueError(f"{s} encoder tokens take K3/K4: no case here")
    return dict(want, **{"K3": dec, "K3+lse": dec, "K4a": dec, "K4b": dec})


def videomae_model(torch, cfg, dtype, device: str, depths=None):
    """``cfg``'s model from the registry, or at full widths with
    ``depths`` (encoder, decoder) blocks: the registry's huge factory fixes
    its encoder depth, so a cut model is built from its widths."""
    from unite_torch import create_model
    from unite_torch.models.pretrain_videomae import PretrainVideoMAE

    if depths is None:
        model = create_model(cfg.name, device=device, dtype=dtype,
                             num_frames=MAE_FRAMES, tubelet_size=MAE_TUBELET)
        if (len(model.encoder.blocks), len(model.decoder.blocks)) != (
                cfg.depth, cfg.dec_depth):
            raise AssertionError(f"{cfg.name}: depths differ from {cfg}")
        return model
    return PretrainVideoMAE(
        img_size=224, patch_size=16, encoder_embed_dim=cfg.width,
        encoder_depth=depths[0], encoder_num_heads=cfg.heads,
        decoder_num_classes=1536, decoder_embed_dim=cfg.dec_width,
        decoder_depth=depths[1], decoder_num_heads=cfg.dec_heads,
        mlp_ratio=4, qkv_bias=True, norm_eps=1e-6, num_frames=MAE_FRAMES,
        tubelet_size=MAE_TUBELET, dtype=dtype).to(device)


def build_videomae(torch, b: int, dtype, device: str, state_dict=None,
                   cfg=MAE_BASE, depths=None):
    """``cfg``'s VideoMAE (``pretrain_videomae_base_patch16_224`` by
    default; ``depths`` cuts it) with its optimizer and step (the VideoMAE
    recipe above; lr 1.5e-4 scaled by the batch, cosine)."""
    from unite_torch.engines.pretrain_videomae import make_videomae_train_step
    from unite_torch.optim.factory import create_optimizer
    from unite_torch.train.train_state import TrainState
    from unite_torch.utils.schedules import cosine_scheduler, scaled_lr

    model = videomae_model(torch, cfg, dtype, device, depths)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    lr_tab = cosine_scheduler(scaled_lr(1.5e-4, b), scaled_lr(1e-5, b), 20,
                              100, start_warmup_value=scaled_lr(1e-6, b))
    tx, _ = create_optimizer("adamw", lr_tab, model, weight_decay=0.05,
                             betas=(0.9, 0.95), eps=1e-8, device=device)
    step = make_videomae_train_step(model, patch_size=16,
                                    tubelet_size=MAE_TUBELET, clip_grad=None,
                                    device=device)
    return TrainState(model, tx), step


def videomae_card_vs_cpu(torch, cfg=MAE_BASE, depths=None,
                         count: bool = True, ratio: float = MAE_MASK):
    """One VideoMAE step on the card (bf16) against the CPU (fp32) at B=2,
    full width (``depths`` blocks where given): the same weights, clips and
    masks at tube-mask ``ratio``; the card step's launches must be those of
    ``mae_launches``. With ``count``, the CPU step's operations are counted
    by ``utils.flops.count_flops`` (FlopCounterMode; there the attention
    runs its plain versions)."""
    import unite_torch.ops.attention as A
    from unite_torch.utils.flops import count_flops

    torch.manual_seed(13)
    cpu_state, cpu_step = build_videomae(torch, 2, torch.float32, "cpu",
                                         cfg=cfg, depths=depths)
    sd = {k: v.clone() for k, v in cpu_state.model.state_dict().items()}
    gpu_state, gpu_step = build_videomae(torch, 2, torch.bfloat16, "cuda", sd,
                                         cfg=cfg, depths=depths)
    batch = tube_batch(torch, 2, 14, MAE_FRAMES, MAE_GRID, ratio)
    from unite_torch.ops.normalize import normalize_videos

    with torch.no_grad():
        vids = normalize_videos(batch["videos"])
        p_cpu = cpu_state.model.eval()(vids, batch["vis_idx"],
                                       batch["mask_idx"])
        p_gpu = gpu_state.model.eval()(
            vids.cuda(), batch["vis_idx"].cuda(),
            batch["mask_idx"].cuda()).float().cpu()
    pred_rel = ((p_gpu - p_cpu).abs().max() / p_cpu.abs().max()).item()
    torch.cuda.synchronize()
    reset_counts(A)
    m_gpu = {k: v.item() for k, v in gpu_step(gpu_state, batch).items()}
    launches = read_counts(A)
    m_cpu = {}

    def cpu_run():
        m_cpu.update({k: v.item() for k, v in cpu_step(cpu_state,
                                                       batch).items()})

    counted = count_flops(cpu_run) if count else cpu_run()
    rel = {k: abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k])
           for k in ("loss", "grad_norm")}
    rel["predictions"] = pred_rel
    what = (f"{cfg.name}" + (f" at depths {depths}" if depths else "")
            + f" at mask {ratio}")
    print(f"videomae step card bf16 vs cpu fp32 (B=2, {what}): card {m_gpu} "
          f"cpu {m_cpu} rel {rel}; card step launches {launches}; CPU step "
          f"counted {counted} flop", flush=True)
    if not all(r <= STEP_RTOL for r in rel.values()):
        raise AssertionError(f"videomae card step ({what}) disagrees with "
                             f"the CPU: {rel}")
    enc, dec = depths or (cfg.depth, cfg.dec_depth)
    expect_counts(launches, mae_launches(A, cfg, ratio, enc, dec),
                  f"videomae card step ({what})")
    return dict(rel, counted_flop_per_clip=None if counted is None
                else counted / 2, launches=launches,
                visible_tokens=mae_visible(ratio))


def videomae_path(torch, A, counted_per_clip, b: int = 32,
                  warmup: int = 2, timed: int = 5, cfg=MAE_BASE,
                  profile_name: str = "chip_smoke_profile_videomae.json",
                  ratio: float = MAE_MASK):
    """Phase ``videomae-b16-b32``: the VideoMAE pixel-reconstruction step
    at B=32 on pinned seeded uint8 clips (normalized on the card), each
    step 12 K1 + 12 K2 at the encoder's [32, 160] and 8 K3 (with lse) + 8
    K4a + 8 K4b at the decoder's [32, 1568] with 6 heads; a profiled
    step. With ``cfg`` MAE_HUGE, ``videomae-h16-b16``: the huge model at
    B=16, 32 K1 + 32 K2 at [16, 160] (16 heads of 80 lanes) and 8 of each
    decoder kernel at [16, 1568] (8 heads of 80). With MAE_HUGE_M075 and
    ``ratio`` 0.75, ``videomae-h16-m075-b16``: the huge model's encoder at
    392 tokens on K5, 32 of each of its kernels a step, and no K1/K2
    (``mae_launches``). Its model FLOP utilization comes from the closed
    form (``videomae_clip_flops``) and from ``counted_per_clip``, the CPU
    step's count (None where it could not be taken)."""
    torch.manual_seed(15)
    state, step = build_videomae(torch, b, torch.bfloat16, "cuda", cfg=cfg)
    gen = torch.Generator(device="cuda").manual_seed(16)
    batch = tube_batch(torch, b, 17, MAE_FRAMES, MAE_GRID, ratio)
    batch["videos"] = batch["videos"].pin_memory()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(A)
    metrics = [step(state, batch, gen) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        metrics.append(step(state, batch, gen))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, shapes = read_counts(A), read_shapes(A)
    n = warmup + timed
    vals = [(m["loss"].item(), m["grad_norm"].item()) for m in metrics]
    tag = cfg.tag
    print(f"{tag} losses/grad norms: {vals}", flush=True)
    check_finite(vals)
    enc, dec = cfg.depth * n, cfg.dec_depth * n
    route = mae_launches(A, cfg, ratio, enc, dec)
    expect_counts(counts, route, f"{tag}, {n} steps")
    vis = mae_visible(ratio)
    want = {"K1": {(b, vis): enc} if "K1" in route else {},
            "K3": {(b, 1568): dec}}
    if shapes != want:
        raise AssertionError(f"{tag}: launches by (B, S) {shapes}, "
                             f"expected {want}")
    flops = b * videomae_clip_flops(cfg, ratio)
    counted = None if counted_per_clip is None else b * counted_per_clip
    res = dict(clips_per_s=b * timed / dt, step_ms=dt / timed * 1e3,
               model_tflop_per_step=flops / 1e12,
               model_flops_util=flops * timed / dt / PEAK_BF16,
               counted_tflop_per_step=counted and counted / 1e12,
               counted_flops_util=counted and counted * timed / dt / PEAK_BF16,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               steps=n, visible_tokens=vis, mask_ratio=ratio, launches=counts,
               launches_by_shape={k: {f"{x}x{y}": c for (x, y), c in
                                      v.items()} for k, v in shapes.items()},
               head_dim=cfg.width // cfg.heads)
    print(f"{tag} B={b}: {res} on {card_line()}", flush=True)
    res["profile"] = profile_step(torch, lambda: step(state, batch, gen),
                                  profile_name)
    res["device_share_of_timed_step"] = (res["profile"]["device_ms"]
                                         / res["step_ms"])
    return res


def umt_pretrain_model(torch, dtype, device: str, state_dict=None):
    from unite_torch import create_model

    model = create_model("pretrain_umt_base_patch16_224", device=device,
                         dtype=dtype, num_frames=8, tubelet_size=1,
                         clip_return_layer=UMT_TAPS,
                         clip_student_return_interval=1)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model.train()


def umt_pass(torch, model, batch, targets, device: str):
    """Forward and the gradient of sum((out - t)^2) against seeded targets
    (sum(out^2) alone is constant under the decoders' L2 norm): the
    loss, the gradients' global norm and the outputs."""
    from unite_torch.ops.normalize import normalize_videos
    from unite_torch.train.train_state import global_grad_norm

    model.zero_grad(set_to_none=True)
    out = model(normalize_videos(batch["videos"].to(device)),
                batch["vis_idx"].to(device))
    loss = torch.sum((out.float() - targets.to(device)) ** 2)
    loss.backward()
    norm = global_grad_norm([p.grad for p in model.parameters()])
    return loss.detach(), norm, out.detach()


def umt_pretrain(torch, A, b: int = 64, timed: int = 3):
    """Phase ``umt-pretrain-b64``: ``pretrain_umt_base_patch16_224`` at 8
    frames, tubelet 1, tube mask 0.8 (320 visible tokens), taps 6-11: its
    forward and backward at B=64 (12 K1 + 12 K2 at [64, 320] a pass,
    finite outputs), and at B=2 on the card (bf16) against the CPU (fp32)
    from the same weights, clips and masks."""
    torch.manual_seed(18)
    cpu = umt_pretrain_model(torch, torch.float32, "cpu")
    sd = {k: v.clone() for k, v in cpu.state_dict().items()}
    gpu = umt_pretrain_model(torch, torch.bfloat16, "cuda", sd)
    small = tube_batch(torch, 2, 19, 8, (8, 14, 14), UMT_MASK)
    gen = torch.Generator().manual_seed(20)
    t_small = torch.randn((UMT_TAPS, 2, UMT_VISIBLE, 512), generator=gen)
    l_cpu, n_cpu, o_cpu = umt_pass(torch, cpu, small, t_small, "cpu")
    l_gpu, n_gpu, o_gpu = umt_pass(torch, gpu, small, t_small, "cuda")
    rel = {"loss": abs(l_gpu.item() - l_cpu.item()) / abs(l_cpu.item()),
           "grad_norm": abs(n_gpu.item() - n_cpu.item()) / abs(n_cpu.item())}
    out_err = (o_gpu.float().cpu() - o_cpu).abs().max().item()
    print(f"umt-pretrain card bf16 vs cpu fp32 (B=2): loss {l_gpu.item()} / "
          f"{l_cpu.item()}, grad norm {n_gpu.item()} / {n_cpu.item()}, rel "
          f"{rel}, x_clip max abs err {out_err}", flush=True)
    if not all(r <= STEP_RTOL for r in rel.values()) or out_err > 5e-2:
        raise AssertionError(f"umt-pretrain card pass disagrees with the "
                             f"CPU: {rel}, x_clip err {out_err}")
    del cpu
    batch = tube_batch(torch, b, 21, 8, (8, 14, 14), UMT_MASK)
    batch["videos"] = batch["videos"].pin_memory()
    targets = torch.randn((UMT_TAPS, b, UMT_VISIBLE, 512), generator=gen,
                          device="cpu").cuda()
    umt_pass(torch, gpu, batch, targets, "cuda")  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(A)
    t0 = time.perf_counter()
    outs = [umt_pass(torch, gpu, batch, targets, "cuda")
            for _ in range(timed)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, shapes = read_counts(A), read_shapes(A)["K1"]
    expect_counts(counts, {"K1": 12 * timed, "K2": 12 * timed},
                  f"umt-pretrain-b64, {timed} passes")
    if shapes != {(b, UMT_VISIBLE): 12 * timed}:
        raise AssertionError(f"umt-pretrain-b64: K1 by (B, S) {shapes}")
    out = outs[-1][2]
    if out.shape != (UMT_TAPS, b, UMT_VISIBLE, 512) or not bool(
            torch.isfinite(out).all()):
        raise AssertionError(f"umt-pretrain-b64: output {tuple(out.shape)} "
                             "not finite or of the wrong shape")
    check_finite([(l.item(), g.item()) for l, g, _ in outs])
    res = dict(card_vs_cpu_rel=rel, x_clip_max_abs_err=out_err,
               pass_ms=dt / timed * 1e3,
               clips_per_s=b * timed / dt,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               passes=timed, launches=counts)
    print(f"umt-pretrain-b64 B={b}: {res} on {card_line()}", flush=True)
    del gpu, outs, out
    torch.cuda.empty_cache()
    return res


def clip_masked(torch, A, b: int = 64, timed: int = 3):
    """Phase ``clip-masked``: the ``clip_b16`` teacher with ``return_cls``
    on a tube mask of 0.8 over 8 frames of 224^2 (40 of 196 patches a
    frame): at B=64, 12 K1 at [512, 41] a forward, finite features and CLS
    rows; at B=2 on the card (bf16) against the CPU (fp32)."""
    from unite_torch import create_model
    from unite_torch.ops.normalize import normalize_videos

    def teacher(dtype, device, sd=None):
        m = create_model("clip_b16", device=device, dtype=dtype,
                         input_resolution=224, return_cls=True,
                         return_index=tuple(range(6, 12)))
        if sd is not None:
            m.load_state_dict(sd)
        return m.eval()

    def forward(m, batch, device):
        with torch.no_grad():
            return m(normalize_videos(batch["videos"].to(device)),
                     vis_idx=batch["vis_idx"].to(device))

    torch.manual_seed(22)
    cpu = teacher(torch.float32, "cpu")
    gpu = teacher(torch.bfloat16, "cuda", cpu.state_dict())
    small = tube_batch(torch, 2, 23, 8, (8, 14, 14), UMT_MASK)
    (z_c, cls_c), (z_g, cls_g) = (forward(cpu, small, "cpu"),
                                  forward(gpu, small, "cuda"))
    rel = {name: ((g.float().cpu() - c).abs().max() / c.abs().max()).item()
           for name, g, c in (("z", z_g, z_c), ("cls", cls_g, cls_c))}
    print(f"clip-masked card bf16 vs cpu fp32 (B=2): rel {rel}", flush=True)
    if not all(r <= STEP_RTOL for r in rel.values()):
        raise AssertionError(f"clip-masked disagrees with the CPU: {rel}")
    del cpu
    batch = tube_batch(torch, b, 24, 8, (8, 14, 14), UMT_MASK)
    batch["videos"] = batch["videos"].pin_memory()
    forward(gpu, batch, "cuda")  # warm-up
    torch.cuda.synchronize()
    reset_counts(A)
    t0 = time.perf_counter()
    outs = [forward(gpu, batch, "cuda") for _ in range(timed)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts(A)
    expect_counts(counts, {"K1": 12 * timed}, f"clip-masked, {timed} calls")
    expect_k1_shapes(A, {(8 * b, 41): 12 * timed}, "clip-masked")
    z, cls = outs[-1]
    if (z.shape != (UMT_TAPS, b, UMT_VISIBLE, 512) or cls.shape != (8 * b, 768)
            or not bool(torch.isfinite(z).all())
            or not bool(torch.isfinite(cls).all())):
        raise AssertionError(f"clip-masked: z {tuple(z.shape)}, cls "
                             f"{tuple(cls.shape)}, or not finite")
    res = dict(card_vs_cpu_rel=rel, call_ms=dt / timed * 1e3,
               clips_per_s=b * timed / dt, calls=timed, launches=counts)
    print(f"clip-masked B={b}: {res} on {card_line()}", flush=True)
    del gpu, outs, z, cls
    torch.cuda.empty_cache()
    return res


LAYOUT_FLAGS = {"ddp": (1, False, False), "zero1": (1, True, False),
                "fsdp": (1, False, True), "tp2": (2, False, False)}
ENTRY_LAYOUT_ARGS = {"ddp": [], "zero1": ["--zero1", "true"],
                     "fsdp": ["--fsdp", "true"]}
SCALEOUT_STEPS = 2     # each torchrun entry call: an epoch of 2 steps
SCALEOUT_B = 16        # the rank steps' global batch (8 a rank at 2 ranks)
SCALEOUT_TIMEOUT = 300  # seconds a torchrun call may take
# the step builders, eval-step builders and (stage 3) the zero-shot
# teacher the rank entries count calls of
ENTRY_STEP = {"stage1": "make_pretrain_train_step",
              "stage2": "make_finetune_train_step",
              "stage3": "make_selftrain_step"}
ENTRY_EVAL = {"stage2": "make_eval_step", "stage3": "make_selftrain_eval_step"}


def torchrun(nproc: int, argv, log: Path,
             timeout: int = SCALEOUT_TIMEOUT) -> None:
    """``python -m torch.distributed.run --standalone --nproc_per_node
    nproc chip_smoke.py argv`` (torchrun picks a free port), its output to
    ``log``. Any rank's non-zero exit (torchrun's exit code then) or the
    timeout fails; on a timeout the whole process group is killed."""
    import os
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", str(ROOT / "chip_smoke.py"), *argv]
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                cwd=str(ROOT), start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
    if rc != 0:
        raise AssertionError(f"torchrun {' '.join(argv[:2])} on {nproc} "
                             f"ranks: exit {rc}\n{log.read_text()[-4000:]}")


def layout_args(name: str, backend: str):
    tp, zero1, fsdp = LAYOUT_FLAGS[name]
    return SimpleNamespace(tp=tp, zero1=zero1, fsdp=fsdp,
                           dist_backend=backend, dist_url="env://",
                           world_size=1)


def rank_entry(torch, A, stage: str, argv) -> dict:
    """One entry call on a torchrun rank: ``run_STAGE.main`` on the command
    line ``python -m unite_torch.train.run_STAGE ARGS...`` parses, with
    the rank's launches, steps (each waited for), eval calls and zero-shot
    calls counted around it."""
    import importlib

    from unite_torch.config import parse_with_config
    from unite_torch.parallel import mesh as pm
    from unite_torch.train import args as T

    R = importlib.import_module(f"unite_torch.train.run_{stage}")
    parser = getattr(T, f"{stage}_parser")()
    if stage != "stage2":  # as the entries' __main__ adds it
        parser.add_argument("--clip_init", default="")
    rec = {"steps": [], "eval_calls": 0, "zs_calls": 0}

    def counted_step(build):
        def make(*a, **k):
            step = build(*a, **k)

            def run(state, batch, gen=None):
                out = step(state, batch, gen)
                torch.cuda.synchronize()
                rec["steps"].append(time.perf_counter())
                return out

            return run

        return make

    def counted_eval(build):
        def make(*a, **k):
            step = build(*a, **k)

            def run(state, batch):
                rec["eval_calls"] += 1
                return step(state, batch)

            return run

        return make

    def counted_zero_shot(build):
        def make(*a, **k):
            fn = build(*a, **k)

            def call(*x, **y):
                rec["zs_calls"] += 1
                return fn(*x, **y)

            return None if fn is None else call

        return make

    subs = [(R, ENTRY_STEP[stage],
             counted_step(getattr(R, ENTRY_STEP[stage])))]
    if stage in ENTRY_EVAL:
        subs.append((R, ENTRY_EVAL[stage],
                     counted_eval(getattr(R, ENTRY_EVAL[stage]))))
    if stage == "stage3":
        subs.append((R, "build_zero_shot_fn",
                     counted_zero_shot(R.build_zero_shot_fn)))
    args = parse_with_config(parser, argv)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(A)
    t0 = time.perf_counter()
    with patched(*subs):
        R.main(args)
    torch.cuda.synchronize()
    mesh = pm.current()
    ts = rec["steps"]
    return dict(rank=mesh.rank, world=mesh.world, backend=mesh.backend,
                device=str(mesh.device), wall_s=time.perf_counter() - t0,
                steps=len(ts), first_step_s=(ts[0] - t0) if ts else None,
                step_s=[b - a for a, b in zip(ts, ts[1:])],
                eval_calls=rec["eval_calls"], zs_calls=rec["zs_calls"],
                launches=read_counts(A),
                by_shape={k: {f"{b}x{s}": n for (b, s), n in v.items()}
                          for k, v in read_shapes(A).items()},
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def rank_entries(torch, A, spec_path: str) -> None:
    """One rank of a torchrun launch (``chip_smoke.py --rank-entries
    SPEC``): the spec's entry calls in turn in this process, one process
    group for all (as a user's script of several runs would keep it), each
    call's counts written to OUT.rankR.json."""
    import gc

    from unite_torch.parallel import mesh as pm

    spec = json.loads(Path(spec_path).read_text())
    out = {}
    for name, stage, argv in spec["calls"]:
        out[name] = rank_entry(torch, A, stage, argv)
        gc.collect()
        torch.cuda.empty_cache()
    Path(f"{spec['out']}.rank{pm.current().rank}.json").write_text(
        json.dumps(out))
    pm.shutdown()


def single_process_restore(torch, model, path: Path) -> dict:
    """A checkpoint of any layout into one process on the card (no process
    group): ``restore_train_state`` into ``model`` and a fresh AdamW, then
    every parameter and moment held bit for bit to the file."""
    from unite_torch.optim.factory import create_optimizer
    from unite_torch.train.train_state import TrainState
    from unite_torch.utils import checkpoint as ck

    payload = ck.load_checkpoint(path)
    tx, _ = create_optimizer("adamw", 1e-4, model, device="cuda")
    state = TrainState(model, tx)
    ck.restore_train_state(state, payload)
    named = dict(model.named_parameters())
    bad = [k for k, v in model.state_dict().items()
           if not torch.equal(v.cpu(), payload["model"][k])]
    n_mom = 0
    for n, mom in payload["optimizer"]["moments"].items():
        for k, v in mom.items():
            n_mom += 1
            if not torch.equal(tx.state[named[n]][k].cpu(), v):
                bad.append(f"{n}.{k}")
    if bad or not n_mom:
        raise AssertionError(f"{path}: not restored bit for bit into one "
                             f"process: {bad[:5]} ({n_mom} moments)")
    return dict(params=len(payload["model"]), moments=n_mom,
                epoch=payload["epoch"], step=payload["extra"]["step"])


def scaleout_entries(torch, A, workdir: Path, nproc: int) -> dict:
    """Phase ``scaleout-nccl-w{N}``: the stage entries under one launch of
    ``python -m torch.distributed.run --standalone --nproc_per_node N``
    (one rank a card, NCCL), each rank making seven entry calls in turn
    in one process group (``rank_entries``; a launch each would add ~14 s
    of start-up to each): ``run_stage1.main``
    with ``STAGE1_ARGS`` (mask 0.8, 32 + 32 clips a step a rank) on
    synthetic clips, an epoch of 2 steps and its checkpoint, under DDP,
    --zero1 and --fsdp; ``run_stage2.main`` (``STAGE2_ARGS``, --epochs 1,
    --eval_freq 1) chained from the DDP checkpoint under DDP and --fsdp:
    2 steps of 7 a rank, validation (8 clips), checkpoint-best reloaded
    and the 12-view test of 2 videos; ``run_stage3.main`` (``STAGE3_ARGS``,
    --epochs 1) chained from the stage-2 DDP run's checkpoint-best under DDP
    and --fsdp: the initial validation, 2 steps of 5 + 5 clips a rank, the
    zero-shot teacher on each batch, validation and the 15-view test. Each
    rank's launches are held to the single-process entries' counts (a
    stage-1 step 24 K1 + 12 K2; stage 2 12 K3 with lse + 12 K4a + 12 K4b a
    step and 12 K3 an eval call; stage 3 as ``stage3_entry``), and each
    checkpoint is restored into one process bit for bit."""
    import numpy as np

    from unite_torch.train import run_stage1, run_stage2, run_stage3

    tmp = workdir / f"scaleout-w{nproc}"
    tmp.mkdir()
    n1, n2, n3 = (b * SCALEOUT_STEPS * nproc
                  for b in (ENTRY_BATCH, 7, 5))
    write_annotations(tmp, {"s1_source": n1, "s1_target": n1,
                            "s2_train": n2, "s2_val": 8, "s2_test": 2,
                            "s3_source": n3, "s3_target": n3, "s3_val": 8,
                            "s3_test": 2})
    feats = tmp / "text_features.npy"
    np.save(feats, np.random.default_rng(12).standard_normal(
        (12, 512)).astype(np.float32))
    common = ["--synthetic_data", "true", "--device_normalize", "true"]
    calls, wants = [], {}

    def call(stage, name, argv, want, clips_a_step):
        calls.append([name, stage, common + ["--output_dir", str(tmp / name)]
                      + argv])
        wants[name] = (want, clips_a_step)
        return tmp / name

    def s1_want(r):
        n = r["steps"]
        return {"K1": 24 * n, "K2": 12 * n}

    def s2_want(r):
        n = r["steps"]
        return {"K3": 12 * (n + r["eval_calls"]), "K3+lse": 12 * n,
                "K4a": 12 * n, "K4b": 12 * n}

    def s3_want(r):
        n, zs = r["steps"], r["zs_calls"]
        if zs != n:
            raise AssertionError(f"stage 3 rank {r['rank']}: {zs} zero-shot "
                                 f"calls for {n} steps")
        return {"K1": 12 * (2 * n + zs), "K2": 12 * n,
                "K3": 12 * (2 * n + r["eval_calls"]), "K3+lse": 12 * n,
                "K4a": 12 * n, "K4b": 12 * n}

    s1 = ["--batch_size", str(ENTRY_BATCH),
          "--stop_after_steps", str(SCALEOUT_STEPS),
          "--ann_file_train", str(tmp / "s1_source.csv"),
          "--ann_file_train_target", str(tmp / "s1_target.csv")]
    s1_runs = {layout: call("stage1", f"stage1-{layout}",
                            STAGE1_ARGS + s1 + flags, s1_want,
                            2 * ENTRY_BATCH)
               for layout, flags in ENTRY_LAYOUT_ARGS.items()}
    s2 = ["--epochs", "1", "--warmup_epochs", "0", "--eval_freq", "1",
          "--finetune", str(s1_runs["ddp"] / "checkpoint-latest.pth"),
          "--ann_file_train", str(tmp / "s2_train.csv"),
          "--ann_file_val", str(tmp / "s2_val.csv"),
          "--ann_file_test", str(tmp / "s2_test.csv")]
    s2_runs = {layout: call("stage2", f"stage2-{layout}",
                            STAGE2_ARGS + s2 + ENTRY_LAYOUT_ARGS[layout],
                            s2_want, 7)
               for layout in ("ddp", "fsdp")}
    s3 = ["--epochs", "1", "--warmup_epochs", "0",
          "--clip_text_features", str(feats),
          "--student_init", str(s2_runs["ddp"] / "checkpoint-best.pth"),
          "--ann_file_train", str(tmp / "s3_source.csv"),
          "--ann_file_train_target", str(tmp / "s3_target.csv"),
          "--ann_file_val", str(tmp / "s3_val.csv"),
          "--ann_file_test", str(tmp / "s3_test.csv")]
    s3_runs = {layout: call("stage3", f"stage3-{layout}",
                            STAGE3_ARGS + s3 + ENTRY_LAYOUT_ARGS[layout],
                            s3_want, 15)
               for layout in ("ddp", "fsdp")}
    spec = tmp / "entries.json"
    spec.write_text(json.dumps({"calls": calls, "out": str(tmp / "counts")}))
    t0 = time.perf_counter()
    torchrun(nproc, ["--rank-entries", str(spec)], tmp / "entries.log",
             timeout=2 * SCALEOUT_TIMEOUT)
    res = {"torchrun_wall_s": time.perf_counter() - t0}
    ranks = [json.loads(Path(f"{tmp / 'counts'}.rank{r}.json").read_text())
             for r in range(nproc)]
    for name, (want, clips_a_step) in wants.items():
        for r in (x[name] for x in ranks):
            what = f"scaleout-nccl-w{nproc} {name} rank {r['rank']}"
            if (r["backend"], r["world"]) != ("nccl", nproc):
                raise AssertionError(f"{what}: {r['backend']} world "
                                     f"{r['world']}")
            if r["steps"] != SCALEOUT_STEPS:
                raise AssertionError(f"{what}: {r['steps']} steps")
            expect_counts(r["launches"], want(r), what)
        r0 = ranks[0][name]
        res[name] = dict(
            entry_wall_s=r0["wall_s"], first_step_s=r0["first_step_s"],
            clips_per_s=clips_a_step * nproc / r0["step_s"][-1],
            peak_mem_gb=[x[name]["peak_mem_gb"] for x in ranks],
            eval_calls=r0["eval_calls"], zero_shot_calls=r0["zs_calls"],
            launches=r0["launches"], by_shape=r0["by_shape"])
    # every checkpoint into one process, bit for bit
    from unite_torch.config import parse_with_config
    from unite_torch.train.args import stage1_parser, stage2_parser, \
        stage3_parser

    a1 = parse_with_config(stage1_parser(), STAGE1_ARGS)
    a2 = parse_with_config(stage2_parser(), STAGE2_ARGS)
    a3 = parse_with_config(stage3_parser(), STAGE3_ARGS)
    restored = {}
    for layout, out in s1_runs.items():
        restored[f"stage1-{layout}"] = single_process_restore(
            torch, run_stage1.build_student(a1, "cuda"),
            out / "checkpoint-latest.pth")
    for layout, out in s2_runs.items():
        restored[f"stage2-{layout}"] = single_process_restore(
            torch, run_stage2.build_model(a2, "cuda"),
            out / "checkpoint-latest.pth")
    for layout, out in s3_runs.items():
        student = run_stage1.build_student(a3, "cuda")
        model = run_stage3.combine(student, run_stage3.build_classifier(
            a3, student.encoder.norm.weight.shape[0], "cuda"))
        restored[f"stage3-{layout}"] = single_process_restore(
            torch, model, out / "checkpoint-latest.pth")
    # the stage-1 layouts' checkpoints side by side (reported)
    from unite_torch.utils.checkpoint import load_checkpoint

    ref = load_checkpoint(s1_runs["ddp"] / "checkpoint-latest.pth")["model"]
    for layout in ("zero1", "fsdp"):
        got = load_checkpoint(s1_runs[layout] / "checkpoint-latest.pth")[
            "model"]
        res[f"stage1-{layout}"]["max_abs_param_diff_vs_ddp"] = max(
            (got[k] - ref[k]).abs().max().item() for k in ref)
    res["restored_into_one_process"] = restored
    print(f"scaleout-nccl-w{nproc}: {json.dumps(res)} on {card_line()}",
          flush=True)
    return res


def scaleout_step_b64(torch, A, b: int = 64, steps: int = 3,
                      rounds: int = 2) -> dict:
    """Phase ``scaleout-step-b64``: stage1-b16-b64's step (B=64, mask 0.8,
    full ViT-B/16 widths) at world 1 over NCCL, plain (no wrapper), under
    DDP and under FSDP, from the same weights. ``steps`` steps in turns on
    the same batches (injected visible tokens, drop path 0): after each,
    the loss, the gradients (after the first) and every parameter against
    the plain step's. DDP's must be bit-equal; FSDP's backward is not (its
    gradients differ by single bf16 ulps from the first step on), so its
    losses and its update of the whole model are held within
    ``STEP_RTOL`` of the plain step's and the differences reported (the config's clip_grad is null, so FSDP's norm,
    summed in another order, does not reach the parameters). Then
    ``rounds`` rounds
    in turns (plain, DDP, FSDP, FSDP, DDP, plain), each step waited for:
    step ms (median), peak memory, and DDP's and FSDP's overhead against
    the plain step; 24 K1 and 12 K2 a step under each."""
    from unite_torch.parallel import mesh as pm

    mesh = pm.init_distributed(layout_args("fsdp", "nccl"))
    if (mesh.backend, mesh.world) != ("nccl", 1):
        raise AssertionError(f"scaleout-step-b64: {mesh.backend} world "
                             f"{mesh.world}")
    torch.manual_seed(21)
    plain, teacher, step = build_step(torch, b, torch.bfloat16, "cuda", 0.0)
    sd = {k: v.clone() for k, v in plain.model.state_dict().items()}
    td = teacher.state_dict()
    runs = {"plain": (plain, step)}
    for name in ("ddp", "fsdp"):
        st, _, stp = build_step(torch, b, torch.bfloat16, "cuda", 0.0, sd, td,
                                layout=LAYOUT_FLAGS[name])
        runs[name] = (st, stp)
    batches = []
    for i in range(steps):
        batch = random_batch(torch, b, 50 + i, with_vis_idx=True)
        batch["videos"] = batch["videos"].pin_memory()
        batches.append(batch)
    rec = {name: dict(losses=[], norms=[], ms=[], peak=[]) for name in runs}
    total = {"K1": 0, "K2": 0}
    from unite_torch.parallel.mesh import local_tensor

    def whole(name, grads=False):
        """The variant's parameters (or gradients), whole, by name."""
        lay = runs[name][0].layout
        if not grads:
            return lay.full_state_dict()
        return {n: local_tensor(p.grad).clone()
                for n, p in lay.named_parameters() if p.grad is not None}

    def diff(a, b) -> dict:
        bad = [k for k in b if not torch.equal(a[k], b[k])]
        return dict(differ=len(bad), of=len(b), first=bad[:3],
                    max_abs=max([(a[k] - b[k]).abs().max().item()
                                 for k in bad] or [0.0]))

    def one(name, batch, timed):
        state, stp = runs[name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(A)
        t0 = time.perf_counter()
        m = stp(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        expect_counts(read_counts(A), {"K1": 24, "K2": 12},
                      f"scaleout-step-b64 {name}")
        total["K1"] += 24
        total["K2"] += 12
        r = rec[name]
        r["peak"].append(torch.cuda.max_memory_allocated() / 1e9)
        if timed:
            r["ms"].append(dt * 1e3)
        else:
            r["losses"].append(m["loss"].detach().clone())
            r["norms"].append(m["grad_norm"].item())

    # after each step, each wrapper's loss, gradients (after the first)
    # and parameters against the plain step's, bit for bit
    diag = {name: [] for name in ("ddp", "fsdp")}
    for i, batch in enumerate(batches):
        for name in runs:
            one(name, batch, timed=False)
        want = whole("plain")
        grads = whole("plain", grads=True) if i == 0 else None
        for name in diag:
            d = dict(step=i + 1, loss_equal=torch.equal(
                rec[name]["losses"][i], rec["plain"]["losses"][i]),
                params=diff(whole(name), want))
            if grads is not None:
                d["grads"] = diff(whole(name, grads=True), grads)
            diag[name].append(d)
    equal = {name: not any(not x["loss_equal"] or x["params"]["differ"]
                           or x.get("grads", {}).get("differ") for x in d)
             for name, d in diag.items()}
    if not equal["ddp"]:
        raise AssertionError(f"scaleout-step-b64: DDP not bit-equal to the "
                             f"plain step: {json.dumps(diag['ddp'])}")
    # FSDP's backward is not bit-equal at world 1 on the card (its gradients
    # differ from the plain step's by single bf16 ulps from the first step
    # on, its forward and loss do not): held to the plain step as the
    # gloo and multi-card ranks are, within STEP_RTOL
    got = whole("fsdp")
    fsdp_rel = dict(
        loss=max(abs(x.item() - y.item()) / abs(y.item()) for x, y in zip(
            rec["fsdp"]["losses"], rec["plain"]["losses"])),
        params=max(((got[k] - want[k]).norm() / want[k].norm()).item()
                   for k in want))
    # the 3 steps' update against the plain one's, whole model (the
    # largest tensor distance, "params", is reported)
    fsdp_rel["update"] = (sum(((got[k] - want[k]) ** 2).sum() for k in want)
                          / sum(((want[k] - sd[k]) ** 2).sum() for k in want)
                          ).sqrt().item()
    if not equal["fsdp"] and max(fsdp_rel["loss"],
                                 fsdp_rel["update"]) > STEP_RTOL:
        raise AssertionError(f"scaleout-step-b64: FSDP off the plain step: "
                             f"{fsdp_rel}; {json.dumps(diag['fsdp'])}")
    check_finite([[x.item()] for x in rec["plain"]["losses"]])
    for _ in range(rounds):
        for name in ("plain", "ddp", "fsdp", "fsdp", "ddp", "plain"):
            one(name, batches[0], timed=True)
    res = {name: dict(step_ms=statistics.median(r["ms"]),
                      step_ms_all=r["ms"], peak_mem_gb=max(r["peak"]),
                      losses=[x.item() for x in r["losses"]],
                      grad_norms=r["norms"],
                      moment_bytes=sum(v.numel() * v.element_size()
                                       for s in runs[name][0].optimizer
                                       .state.values() for v in s.values()))
           for name, r in rec.items()}
    for name in ("ddp", "fsdp"):
        res[name]["overhead_vs_plain"] = (res[name]["step_ms"]
                                          / res["plain"]["step_ms"] - 1.0)
    res["bit_equal"] = equal
    res["fsdp_rel"] = fsdp_rel
    res["checks"] = diag
    res["launches"] = total
    print(f"scaleout-step-b64: after {steps} steps DDP "
          f"{'bit-equal to' if equal['ddp'] else 'off'} the plain step, FSDP "
          f"{'bit-equal' if equal['fsdp'] else 'within'} ({fsdp_rel}); "
          f"step ms plain "
          f"{res['plain']['step_ms']:.2f}, DDP {res['ddp']['step_ms']:.2f} "
          f"({100 * res['ddp']['overhead_vs_plain']:+.1f}%), FSDP "
          f"{res['fsdp']['step_ms']:.2f} "
          f"({100 * res['fsdp']['overhead_vs_plain']:+.1f}%); "
          f"{json.dumps(res)} on {card_line()}", flush=True)
    del runs, plain, teacher, step, want, got, sd
    pm.shutdown()
    torch.cuda.empty_cache()
    return res


def rank_step(torch, A, spec_path: str) -> None:
    """One rank of ``scaleout_rank_steps`` (``chip_smoke.py --rank-step
    SPEC``): for each layout of the spec, the stage-1 step at full width
    from the spec's weights on this replica's rows of the global batches,
    3 steps; the global loss, the grad norm, launches and time of each
    step, this rank's optimizer-state bytes, and (rank 0) the whole
    parameters against the one-process reference."""
    from unite_torch.parallel import mesh as pm

    spec = json.loads(Path(spec_path).read_text())
    init = torch.load(spec["init"], map_location="cpu")
    ref = torch.load(spec["ref"], map_location="cpu")
    import torch.distributed as dist

    out = {}
    for name in spec["layouts"]:
        mesh = pm.init_distributed(layout_args(name, spec["backend"]))
        per = spec["b"] // mesh.dp
        rows = slice(mesh.dp_rank * per, (mesh.dp_rank + 1) * per)
        # built at the global batch: the lr scales by it, as the entry's
        state, _, step = build_step(torch, spec["b"], torch.bfloat16, "cuda",
                                    0.0, init["student"], init["teacher"],
                                    layout=LAYOUT_FLAGS[name],
                                    opt=spec["opt"])
        metrics = []
        for seed in spec["seeds"]:
            batch = random_batch(torch, spec["b"], seed, with_vis_idx=True)
            batch = {k: v[rows] for k, v in batch.items()}
            torch.cuda.synchronize()
            reset_counts(A)
            t0 = time.perf_counter()
            m = step(state, batch)
            loss = m["loss"].detach().float().clone()
            dist.all_reduce(loss)
            torch.cuda.synchronize()
            metrics.append(dict(loss=loss.item() / mesh.world,
                                grad_norm=m["grad_norm"].item(),
                                ms=(time.perf_counter() - t0) * 1e3,
                                launches=read_counts(A)))
        full = state.layout.full_state_dict()
        res = dict(metrics=metrics, layout=state.layout.name,
                   backend=mesh.backend, world=mesh.world,
                   moment_bytes=sum(v.numel() * v.element_size()
                                    for s in state.optimizer.state.values()
                                    for v in s.values()))
        if mesh.rank == 0:
            p0, p1 = init["student"], ref["params"]
            rel = {k: ((full[k].cpu() - p1[k]).norm() / p1[k].norm()).item()
                   for k in p1}
            res["param_rel_worst"] = max(rel, key=rel.get)
            res["param_rel"] = rel[res["param_rel_worst"]]
            num = sum(((full[k].cpu() - p1[k]) ** 2).sum() for k in p1)
            den = sum(((p1[k] - p0[k]) ** 2).sum() for k in p1)
            res["update_rel"] = (num / den).sqrt().item()
        out[name] = res
        del state, step, full
        torch.cuda.empty_cache()
    Path(f"{spec['out']}.rank{pm.current().rank}.json").write_text(
        json.dumps(out))
    pm.shutdown()


def scaleout_rank_steps(torch, A, workdir: Path, nproc: int, backend: str,
                        layouts, what: str, opt: str = "adamw") -> dict:
    """Phases ``scaleout-gloo-2on1`` (two ranks on the one card over gloo,
    CUDA tensors: DDP and --zero1) and, on two cards or more, the
    multi-card check (NCCL at world N: --fsdp and --tp 2): the stage-1 step
    at full width (ViT-B/16, mask 0.8) on a global batch of ``SCALEOUT_B``
    clips split over the replicas, 3 steps from the same weights, against
    the one-process step on the whole batch in this process. Each step's
    global loss and grad norm, and the 3 steps' update of the whole model
    (its distance from the one-process update over that update's norm),
    within ``STEP_RTOL`` of the one-process step; the largest distance of
    a parameter tensor relative to its norm reported (a tensor that starts
    near 0, a bias, is all update, where Adam turns a gradient's last bits
    into its update's sign); each rank's
    optimizer-state bytes (ZeRO-1's at most 0.6 of DDP's); 24 K1 + 12 K2 a
    step on every rank. ``opt`` is --opt, on both sides (``lamb`` under
    --zero1: its trust ratio sums its norms over the slices)."""
    tmp = workdir / what
    tmp.mkdir()
    torch.manual_seed(31)
    state, teacher, step = build_step(torch, SCALEOUT_B, torch.bfloat16,
                                      "cuda", 0.0, opt=opt)
    init = {"student": {k: v.detach().cpu().clone()
                        for k, v in state.model.state_dict().items()},
            "teacher": {k: v.detach().cpu()
                        for k, v in teacher.state_dict().items()}}
    torch.save(init, tmp / "init.pt")
    seeds = [60, 61, 62]
    ref = []
    for seed in seeds:
        m = step(state, random_batch(torch, SCALEOUT_B, seed,
                                     with_vis_idx=True))
        ref.append({k: m[k].item() for k in ("loss", "grad_norm")})
    torch.save({"params": {k: v.detach().cpu() for k, v in
                           state.model.state_dict().items()},
                "metrics": ref}, tmp / "ref.pt")
    del state, teacher, step, init
    torch.cuda.empty_cache()
    spec = dict(backend=backend, layouts=list(layouts), b=SCALEOUT_B,
                opt=opt, seeds=seeds, init=str(tmp / "init.pt"),
                ref=str(tmp / "ref.pt"), out=str(tmp / "result"))
    (tmp / "spec.json").write_text(json.dumps(spec))
    t0 = time.perf_counter()
    torchrun(nproc, ["--rank-step", str(tmp / "spec.json")],
             tmp / "ranks.log")
    wall = time.perf_counter() - t0
    ranks = [json.loads(Path(f"{spec['out']}.rank{r}.json").read_text())
             for r in range(nproc)]
    res = dict(torchrun_wall_s=wall, reference=ref)
    for name in layouts:
        rs = [r[name] for r in ranks]
        for i, r in enumerate(rs):
            if (r["backend"], r["world"]) != (backend, nproc):
                raise AssertionError(f"{what} {name} rank {i}: "
                                     f"{r['backend']} world {r['world']}")
            for m in r["metrics"]:
                expect_counts(m["launches"], {"K1": 24, "K2": 12},
                              f"{what} {name} rank {i}")
        rel = [{k: abs(m[k] - want[k]) / abs(want[k])
                for k in ("loss", "grad_norm")}
               for m, want in zip(rs[0]["metrics"], ref)]
        worst = max(max(x.values()) for x in rel)
        if worst > STEP_RTOL or rs[0]["update_rel"] > STEP_RTOL:
            raise AssertionError(f"{what} {name}: off the one-process step: "
                                 f"metrics rel {rel}, update "
                                 f"{rs[0]['update_rel']}, parameters "
                                 f"{rs[0]['param_rel']} "
                                 f"({rs[0]['param_rel_worst']})")
        res[name] = dict(layout=rs[0]["layout"], metrics_rel=rel,
                         param_rel=rs[0]["param_rel"],
                         param_rel_worst=rs[0]["param_rel_worst"],
                         update_rel=rs[0]["update_rel"],
                         moment_bytes=[r["moment_bytes"] for r in rs],
                         step_ms=[[m["ms"] for m in r["metrics"]]
                                  for r in rs],
                         losses=[m["loss"] for m in rs[0]["metrics"]])
    if "zero1" in layouts and "ddp" in layouts:
        frac = max(res["zero1"]["moment_bytes"]) / max(
            res["ddp"]["moment_bytes"])
        res["zero1_moment_share_of_ddp"] = frac
        if frac > 0.6:
            raise AssertionError(f"{what}: ZeRO-1 keeps {frac:.2f} of DDP's "
                                 "moment bytes a rank")
    print(f"{what}: {json.dumps(res)} on {card_line()}", flush=True)
    return res


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "unite_torch" / "csrc").is_dir():
        print(f"no unite_torch package beside {__file__}: run from the root "
              "of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import unite_torch.ops.attention as A
    from unite_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the ranks the scale-out phases launch through torchrun
    if sys.argv[1:2] == ["--rank-entries"]:
        rank_entries(torch, A, sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--rank-step"]:
        rank_step(torch, A, sys.argv[2])
        return 0
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}; cuda "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    paths = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    ptxas = check_ptxas(paths)

    def mark(what):
        print(f"[{time.perf_counter() - t0:.0f} s] {what}", flush=True)

    kr = check_kernels(torch, A)
    kr.update(check_packed_kernels(torch, A))
    kr.update(check_flash_kernels(torch, A))
    lengths = check_flash_lengths(torch, A)
    bwd_lengths = check_flash_bwd_lengths(torch, A)
    short_lengths = check_short_lengths(torch, A)
    short_bwd_lengths = check_short_bwd_lengths(torch, A)
    kr.update(check_grouped_kernels(torch, A))
    mark("K1-K6 checked")
    matmul_sweep = check_matmul_sweep(torch)
    kr.update(check_matmul_kernels(torch))
    probe = run_probe(torch, A)
    kr.update(check_kernels(torch, A, heads=16,
                            batches=(L14_M // 197, L14_B), tag="/l14"))
    int8_teacher = int8_teacher_vs_bf16(torch)
    mark("K7, the probe, K1/K2 at 16 heads and the int8 teacher checked")
    l14_rel = l14_card_vs_cpu(torch)
    mark("l14 card vs cpu")
    l14 = l14_path(torch, A, int8=False)
    l14q = l14_path(torch, A, int8=True)
    mark("l14 paths")
    card_vs_cpu(torch)
    mp = main_path(torch, A)
    m075_rel = card_vs_cpu(torch, mask_ratio=0.75)
    m075 = main_path(torch, A, mask_ratio=0.75)
    torch.cuda.empty_cache()
    remat = stage1_remat(torch, A)
    torch.cuda.empty_cache()
    mark("stage-1 paths")
    kr.update(check_kernels(torch, A, batches=(8 * 64, 32),
                            lengths=(41, MAE_VISIBLE), tag="/masked"))
    kr.update(check_packed_kernels(torch, A, shapes=(("train", 32, True),),
                                   tag="/h6", heads=MAE_HEADS,
                                   repeats=BWD_REPEATS))
    mae_rel = videomae_card_vs_cpu(torch)
    mae = videomae_path(torch, A, mae_rel["counted_flop_per_clip"])
    torch.cuda.empty_cache()
    umt = umt_pretrain(torch, A)
    clipm = clip_masked(torch, A)
    mark("videomae-b16-b32, umt-pretrain-b64, clip-masked")
    # head dim 80: K1-K6 at the huge VideoMAE's shapes, the sweeps, its
    # cut step against the CPU, then the full model
    kr.update(check_kernels(torch, A, heads=MAE_HUGE.heads,
                            batches=(HUGE_B, HUGE_B),
                            lengths=(MAE_VISIBLE, MAE_VISIBLE), tag="/d80",
                            head_dim=80))
    kr.update(check_packed_kernels(torch, A, shapes=(("train", HUGE_B, True),),
                                   tag="/d80", heads=MAE_HUGE.dec_heads,
                                   repeats=BWD_REPEATS, head_dim=80))
    # K5 at the huge encoder's [16, 16, 392, 80] (mask 0.75), K6 at its
    # [2, 16, 632, 80] (mask 0.6) and with a CLS token
    kr.update(check_grouped_kernels(
        torch, A, heads=MAE_HUGE.heads, head_dim=80,
        shapes=(("m075", HUGE_B, mae_visible(M075_MASK)),), tag="/d80"))
    kr.update(check_flash_kernels(
        torch, A, head_dim=80,
        shapes=(("m06", 2, MAE_HUGE.heads, mae_visible(M06_MASK), True),
                ("cls", 2, MAE_HUGE.heads, STAGE3_CLS_TOKENS, True)),
        tag="/d80", repeats=BWD_REPEATS))
    d80_lengths = {
        "short_fwd": check_short_lengths(torch, A, 80, D80_HEADS),
        "short_bwd": check_short_bwd_lengths(torch, A, 80, D80_HEADS),
        "flash_fwd": check_flash_lengths(torch, A, 80, D80_HEADS),
        "flash_bwd": check_flash_bwd_lengths(torch, A, 80, D80_HEADS)}
    mark("head dim 80: K1-K6 checked")
    mae_h_rel = videomae_card_vs_cpu(torch, MAE_HUGE, HUGE_CHECK_DEPTH,
                                     count=False)
    mae_h = videomae_path(torch, A, None, b=HUGE_B, timed=3, cfg=MAE_HUGE,
                          profile_name="chip_smoke_profile_videomae_h16.json")
    torch.cuda.empty_cache()
    mark("videomae-h16-b16")
    # the huge model at mask 0.75 (K5) and, cut, at 0.6 (K6)
    mae_h075_rel = videomae_card_vs_cpu(torch, MAE_HUGE, HUGE_CHECK_DEPTH,
                                        count=False, ratio=M075_MASK)
    mae_h06_rel = videomae_card_vs_cpu(torch, MAE_HUGE, HUGE_CHECK_DEPTH,
                                       count=False, ratio=M06_MASK)
    mae_h075 = videomae_path(
        torch, A, None, b=HUGE_B, timed=3, cfg=MAE_HUGE_M075,
        profile_name="chip_smoke_profile_videomae_h16_m075.json",
        ratio=M075_MASK)
    torch.cuda.empty_cache()
    mark("videomae-h16-m075-b16")
    # each entry's output stays until the next stage's entry has read it
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        work = Path(work)
        decode, clips = native_decode(torch, work)
        mark("native decode")
        entry = stage1_entry(torch, A, m075, work)
        torch.cuda.empty_cache()
        mark("stage-1 entry")
        s2_rel = stage2_card_vs_cpu(torch)
        s2, state, eval_step = stage2_path(torch, A)
        ev = stage2_eval(torch, A, state, eval_step)
        del state, eval_step
        torch.cuda.empty_cache()
        mark("stage-2 paths")
        optim = optim_card_vs_cpu(torch, A)
        torch.cuda.empty_cache()
        mark("optim-card-vs-cpu")
        s2opt = stage2_opt_path(torch, A)
        mark("stage2-opt-b8")
        entry2, kr_b7 = stage2_entry(
            torch, A, work / "stage1" / "run" / "checkpoint-latest.pth", s2,
            ev, work)
        kr.update(kr_b7)
        torch.cuda.empty_cache()
        mark("stage-2 entry")
        recipe = stage2_recipe_entry(
            torch, A, work / "stage1" / "run" / "checkpoint-latest.pth",
            clips, decode["built"], work, entry2)
        torch.cuda.empty_cache()
        mark("stage-2 recipe")
        s3_rel = {f"cls={cls}": stage3_card_vs_cpu(torch, cls)
                  for cls in (False, True)}
        s3, state, _ = stage3_path(torch, A, cls=False)
        del state
        torch.cuda.empty_cache()
        s3c, state, eval_step = stage3_path(torch, A, cls=True)
        ev3 = stage3_eval(torch, A, state, eval_step)
        del state, eval_step
        torch.cuda.empty_cache()
        mark("stage-3 paths")
        # the stage-2 entry's output stays until this phase has read it
        entry3, kr_s3 = stage3_entry(
            torch, A, work / "stage2" / "run" / "checkpoint-best.pth", s3,
            work)
        kr.update(kr_s3)
        torch.cuda.empty_cache()
        mark("stage-3 entry")
        # the entries' checkpoints stay until the tools have read them
        tools_c, kr_tc = tool_classify(torch, A, work)
        kr.update(kr_tc)
        mark("tool-classify")
        tools_r, kr_tr = tool_record_losses(torch, A, work)
        kr.update(kr_tr)
        torch.cuda.empty_cache()
        mark("tool-record-losses")
        cards = torch.cuda.device_count()
        scale = scaleout_entries(torch, A, work, cards)
        mark(f"scaleout-nccl-w{cards}")
        scale_b64 = scaleout_step_b64(torch, A)
        mark("scaleout-step-b64")
        gloo = scaleout_rank_steps(torch, A, work, 2, "gloo",
                                   ("ddp", "zero1"), "scaleout-gloo-2on1")
        mark("scaleout-gloo-2on1")
        gloo_lamb = scaleout_rank_steps(torch, A, work, 2, "gloo",
                                        ("zero1",),
                                        "scaleout-gloo-2on1-lamb", opt="lamb")
        mark("scaleout-gloo-2on1 under --zero1 --opt lamb")
        multi = None
        if cards >= 2:
            multi = scaleout_rank_steps(
                torch, A, work, cards, "nccl",
                ("fsdp",) + (("tp2",) if cards % 2 == 0 else ()),
                f"scaleout-nccl-w{cards}-fsdp-tp")
            mark("multi-card --fsdp and --tp 2")
        else:
            print("scaleout: --tp 2 and --fsdp over NCCL at world >= 2 "
                  "against world 1 need two cards; this machine has one, "
                  "so that check does not run here", flush=True)
    torch.cuda.empty_cache()

    kernels = []
    for key, name, src, rep, launches in (
            ("K1/teacher", "fused_qkv_fwd[teacher S=197]",
             "unite_torch/csrc/short_attn_wgmma.cu",
             "unite_tpu/ops/attention.py:678", mp["k1_teacher"]),
            ("K1/student", "fused_qkv_fwd[student S=320]",
             "unite_torch/csrc/short_attn_wgmma.cu",
             "unite_tpu/ops/attention.py:678", mp["k1_student"]),
            ("K2/student", "fused_qkv_bwd[student S=320]",
             "unite_torch/csrc/short_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:773", mp["k2_launches"]),
            ("K1/student", "fused_qkv_fwd[stage1-remat-b64 student S=320, "
             "recomputed in the backward]",
             "unite_torch/csrc/short_attn_wgmma.cu",
             "unite_tpu/ops/attention.py:678", remat["remat"]["k1_student"]),
            ("K2/student", "fused_qkv_bwd[stage1-remat-b64 student S=320]",
             "unite_torch/csrc/short_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:773",
             remat["remat"]["launches"]["K2"]),
            ("K3/train", "packed_flash_fwd[train B=8 S=1568]",
             "unite_torch/csrc/flash_fwd_wgmma.cu",
             "unite_tpu/ops/attention.py:913", s2["k3_launches"]),
            ("K3/eval", "packed_flash_fwd[eval B=32 S=1568]",
             "unite_torch/csrc/flash_fwd_wgmma.cu",
             "unite_tpu/ops/attention.py:913", ev["k3_launches"]),
            ("K3/train", "packed_flash_fwd[stage2-opt-b8 train B=8 S=1568, "
             f"{'/'.join(STAGE2_OPTS)}]",
             "unite_torch/csrc/flash_fwd_wgmma.cu",
             "unite_tpu/ops/attention.py:913", s2opt["launches"]["K3"]),
            ("K4a", "packed_flash_dq[stage2-opt-b8 train B=8 S=1568]",
             "unite_torch/csrc/flash_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:983", s2opt["launches"]["K4a"]),
            ("K4b", "packed_flash_dkv[stage2-opt-b8 train B=8 S=1568]",
             "unite_torch/csrc/flash_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:1014", s2opt["launches"]["K4b"]),
            ("K4a", "packed_flash_dq[train B=8 S=1568]",
             "unite_torch/csrc/flash_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:983", s2["k4_dq_launches"]),
            ("K4b", "packed_flash_dkv[train B=8 S=1568]",
             "unite_torch/csrc/flash_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:1014", s2["k4_dkv_launches"]),
            ("K3/train/b7", "packed_flash_fwd[stage-2 entry train B=7 "
             "S=1568]", "unite_torch/csrc/flash_fwd_wgmma.cu",
             "unite_tpu/ops/attention.py:913", entry2["launches"]["K3+lse"]),
            ("K4a/b7", "packed_flash_dq[stage-2 entry train B=7 S=1568]",
             "unite_torch/csrc/flash_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:983", entry2["launches"]["K4a"]),
            ("K4b/b7", "packed_flash_dkv[stage-2 entry train B=7 S=1568]",
             "unite_torch/csrc/flash_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:1014", entry2["launches"]["K4b"]),
            ("K3/train/b7", "packed_flash_fwd[stage2-recipe-b7 train B=7 "
             "S=1568, recomputed in the backward]",
             "unite_torch/csrc/flash_fwd_wgmma.cu",
             "unite_tpu/ops/attention.py:913",
             recipe["launches"]["K3+lse"]),
            ("K3/eval", "packed_flash_fwd[stage2-recipe-b7 eval B=32 "
             "S=1568]", "unite_torch/csrc/flash_fwd_wgmma.cu",
             "unite_tpu/ops/attention.py:913",
             recipe["launches"]["K3"] - recipe["launches"]["K3+lse"]),
            ("K4a/b7", "packed_flash_dq[stage2-recipe-b7 train B=7 S=1568]",
             "unite_torch/csrc/flash_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:983", recipe["launches"]["K4a"]),
            ("K4b/b7", "packed_flash_dkv[stage2-recipe-b7 train B=7 S=1568]",
             "unite_torch/csrc/flash_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:1014", recipe["launches"]["K4b"]),
            ("K1/teacher/s3", "fused_qkv_fwd[stage-3 entry teachers B=40 "
             "S=197]", "unite_torch/csrc/short_attn_wgmma.cu",
             "unite_tpu/ops/attention.py:678",
             entry3["by_shape"]["K1"]["40x197"]),
            ("K1/student/s3", "fused_qkv_fwd[stage-3 entry grad member B=5 "
             "S=320]", "unite_torch/csrc/short_attn_wgmma.cu",
             "unite_tpu/ops/attention.py:678",
             entry3["by_shape"]["K1"]["5x320"]),
            ("K2/student/s3", "fused_qkv_bwd[stage-3 entry grad member B=5 "
             "S=320]", "unite_torch/csrc/short_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:773", entry3["launches"]["K2"]),
            ("K3/train/b5", "packed_flash_fwd[stage-3 entry train B=5 "
             "S=1568]", "unite_torch/csrc/flash_fwd_wgmma.cu",
             "unite_tpu/ops/attention.py:913",
             entry3["by_shape"]["K3"]["5x1568"]),
            ("K3/eval", "packed_flash_fwd[stage-3 entry eval B=32 S=1568]",
             "unite_torch/csrc/flash_fwd_wgmma.cu",
             "unite_tpu/ops/attention.py:913",
             entry3["by_shape"]["K3"]["32x1568"]),
            ("K4a/b5", "packed_flash_dq[stage-3 entry train B=5 S=1568]",
             "unite_torch/csrc/flash_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:983", entry3["launches"]["K4a"]),
            ("K4b/b5", "packed_flash_dkv[stage-3 entry train B=5 S=1568]",
             "unite_torch/csrc/flash_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:1014", entry3["launches"]["K4b"]),
            ("K6/train", "flash_fwd[stage-3 CLS train B=5 S=1569]",
             "unite_torch/csrc/flash_fwd_wgmma.cu",
             "unite_tpu/ops/attention.py:148", s3c["launches"]["K6"]),
            ("K6/eval", "flash_fwd[stage-3 CLS eval B=32 S=1569]",
             "unite_torch/csrc/flash_fwd_wgmma.cu",
             "unite_tpu/ops/attention.py:148", ev3["k6_launches"]),
            ("K6dq/train", "flash_dq[stage-3 CLS train B=5 S=1569]",
             "unite_torch/csrc/flash_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:231", s3c["launches"]["K6dq"]),
            ("K6dkv/train", "flash_dkv[stage-3 CLS train B=5 S=1569]",
             "unite_torch/csrc/flash_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:270", s3c["launches"]["K6dkv"]),
            ("K5/m075", "grouped_fwd[stage-1 mask 0.75 B=64 S=392]",
             "unite_torch/csrc/short_attn_wgmma.cu",
             "unite_tpu/ops/attention.py:441", m075["launches"]["K5"]),
            ("K5dq/m075", "grouped_dq[stage-1 mask 0.75 B=64 S=392]",
             "unite_torch/csrc/short_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:467", m075["launches"]["K5dq"]),
            ("K5dkv/m075", "grouped_dkv[stage-1 mask 0.75 B=64 S=392]",
             "unite_torch/csrc/short_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:467", m075["launches"]["K5dkv"]),
            ("K1/teacher/l14", "fused_qkv_fwd[clip_l14 teacher B=192 S=197 "
             "H=16]", "unite_torch/csrc/short_attn_wgmma.cu",
             "unite_tpu/ops/attention.py:678", l14["k1_teacher"]),
            ("K1/student/l14", "fused_qkv_fwd[ViT-L student B=24 S=320 H=16]",
             "unite_torch/csrc/short_attn_wgmma.cu",
             "unite_tpu/ops/attention.py:678", l14["k1_student"]),
            ("K2/student/l14", "fused_qkv_bwd[ViT-L student B=24 S=320 H=16]",
             "unite_torch/csrc/short_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:773", l14["k2_launches"]),
            ("K7a/probe", "int8_matmul[probe 38400x768x3072]",
             "unite_torch/csrc/blocked_matmul_wgmma.cu",
             "tools/quant_kernel_probe.py:22", probe["launches"]["K7a"]),
            *((f"K7a/{layer}", f"int8_matmul[int8 clip_l14 {layer} "
               f"{m}x{k}x{n}]", "unite_torch/csrc/blocked_matmul_wgmma.cu",
               "tools/quant_kernel_probe.py:22",
               l14q["k7a_by_shape"][f"{m}x{k}x{n}"])
              for layer, (m, k, n) in L14_DENSE.items()),
            ("K1/student/masked", "fused_qkv_fwd[videomae-b16-b32 encoder "
             f"B=32 S={MAE_VISIBLE}]", "unite_torch/csrc/short_attn_wgmma.cu",
             "unite_tpu/ops/attention.py:678", mae["launches"]["K1"]),
            ("K2/student/masked", "fused_qkv_bwd[videomae-b16-b32 encoder "
             f"B=32 S={MAE_VISIBLE}]", "unite_torch/csrc/short_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:773", mae["launches"]["K2"]),
            ("K3/train/h6", "packed_flash_fwd[videomae-b16-b32 decoder B=32 "
             "S=1568 H=6]", "unite_torch/csrc/flash_fwd_wgmma.cu",
             "unite_tpu/ops/attention.py:913", mae["launches"]["K3+lse"]),
            ("K4a/h6", "packed_flash_dq[videomae-b16-b32 decoder B=32 S=1568 "
             "H=6]", "unite_torch/csrc/flash_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:983", mae["launches"]["K4a"]),
            ("K4b/h6", "packed_flash_dkv[videomae-b16-b32 decoder B=32 "
             "S=1568 H=6]", "unite_torch/csrc/flash_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:1014", mae["launches"]["K4b"]),
            ("K1/student/d80", "fused_qkv_fwd[videomae-h16-b16 encoder "
             f"B={HUGE_B} S={MAE_VISIBLE} H=16 D=80]",
             "unite_torch/csrc/short_attn_wgmma.cu",
             "unite_tpu/ops/attention.py:678", mae_h["launches"]["K1"]),
            ("K2/student/d80", "fused_qkv_bwd[videomae-h16-b16 encoder "
             f"B={HUGE_B} S={MAE_VISIBLE} H=16 D=80]",
             "unite_torch/csrc/short_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:773", mae_h["launches"]["K2"]),
            ("K3/train/d80", "packed_flash_fwd[videomae-h16-b16 decoder "
             f"B={HUGE_B} S=1568 H=8 D=80]",
             "unite_torch/csrc/flash_fwd_wgmma.cu",
             "unite_tpu/ops/attention.py:913", mae_h["launches"]["K3+lse"]),
            ("K4a/d80", "packed_flash_dq[videomae-h16-b16 decoder "
             f"B={HUGE_B} S=1568 H=8 D=80]",
             "unite_torch/csrc/flash_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:983", mae_h["launches"]["K4a"]),
            ("K4b/d80", "packed_flash_dkv[videomae-h16-b16 decoder "
             f"B={HUGE_B} S=1568 H=8 D=80]",
             "unite_torch/csrc/flash_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:1014", mae_h["launches"]["K4b"]),
            ("K5/m075/d80", "grouped_fwd[videomae-h16-m075-b16 encoder "
             f"B={HUGE_B} S={mae_visible(M075_MASK)} H=16 D=80]",
             "unite_torch/csrc/short_attn_wgmma.cu",
             "unite_tpu/ops/attention.py:441", mae_h075["launches"]["K5"]),
            ("K5dq/m075/d80", "grouped_dq[videomae-h16-m075-b16 encoder "
             f"B={HUGE_B} S={mae_visible(M075_MASK)} H=16 D=80]",
             "unite_torch/csrc/short_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:467", mae_h075["launches"]["K5dq"]),
            ("K5dkv/m075/d80", "grouped_dkv[videomae-h16-m075-b16 encoder "
             f"B={HUGE_B} S={mae_visible(M075_MASK)} H=16 D=80]",
             "unite_torch/csrc/short_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:467",
             mae_h075["launches"]["K5dkv"]),
            ("K6/m06/d80", "flash_fwd[videomae-h16 card-vs-CPU step at mask "
             f"0.6, 4 blocks, encoder B=2 S={mae_visible(M06_MASK)} H=16 "
             "D=80]", "unite_torch/csrc/flash_fwd_wgmma.cu",
             "unite_tpu/ops/attention.py:148", mae_h06_rel["launches"]["K6"]),
            ("K6dq/m06/d80", "flash_dq[videomae-h16 card-vs-CPU step at mask "
             f"0.6, 4 blocks, encoder B=2 S={mae_visible(M06_MASK)} H=16 "
             "D=80]", "unite_torch/csrc/flash_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:231",
             mae_h06_rel["launches"]["K6dq"]),
            ("K6dkv/m06/d80", "flash_dkv[videomae-h16 card-vs-CPU step at "
             f"mask 0.6, 4 blocks, encoder B=2 S={mae_visible(M06_MASK)} H=16 "
             "D=80]", "unite_torch/csrc/flash_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:270",
             mae_h06_rel["launches"]["K6dkv"]),
            ("K1/student", "fused_qkv_fwd[umt-pretrain-b64 student B=64 "
             "S=320]", "unite_torch/csrc/short_attn_wgmma.cu",
             "unite_tpu/ops/attention.py:678", umt["launches"]["K1"]),
            ("K2/student", "fused_qkv_bwd[umt-pretrain-b64 student B=64 "
             "S=320]", "unite_torch/csrc/short_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:773", umt["launches"]["K2"]),
            ("K1/teacher/masked", "fused_qkv_fwd[clip-masked teacher B=512 "
             "S=41]", "unite_torch/csrc/short_attn_wgmma.cu",
             "unite_tpu/ops/attention.py:678", clipm["launches"]["K1"]),
            ("K7b/probe", "bf16_matmul[probe 38400x768x3072]",
             "unite_torch/csrc/blocked_matmul_wgmma.cu",
             "tools/quant_kernel_probe.py:53", probe["launches"]["K7b"]),
            ("K1/student", "fused_qkv_fwd[scaleout-step-b64 teacher S=197 "
             "and student S=320, plain, DDP and FSDP at world 1]",
             "unite_torch/csrc/short_attn_wgmma.cu",
             "unite_tpu/ops/attention.py:678", scale_b64["launches"]["K1"]),
            ("K2/student", "fused_qkv_bwd[scaleout-step-b64 student S=320]",
             "unite_torch/csrc/short_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:773", scale_b64["launches"]["K2"]),
            ("K3/classify", "packed_flash_fwd[tool-classify B=1 S=1568, "
             "forward only]", "unite_torch/csrc/flash_fwd_wgmma.cu",
             "unite_tpu/ops/attention.py:913", tools_c["launches"]),
            ("K1/teacher/tools", "fused_qkv_fwd[tool-record-losses teacher "
             f"B={8 * TOOL_B} S=197]", "unite_torch/csrc/short_attn_wgmma.cu",
             "unite_tpu/ops/attention.py:678", tools_r["k1_teacher"]),
            ("K1/student/tools", "fused_qkv_fwd[tool-record-losses student "
             f"B={TOOL_B} S={TOOL_VISIBLE}]",
             "unite_torch/csrc/short_attn_wgmma.cu",
             "unite_tpu/ops/attention.py:678", tools_r["k1_student"]),
            ("K2/student/tools", "fused_qkv_bwd[tool-record-losses student "
             f"B={TOOL_B} S={TOOL_VISIBLE}]",
             "unite_torch/csrc/short_bwd_wgmma.cu",
             "unite_tpu/ops/attention.py:773", tools_r["launches"]["K2"]),
            *((key, f"{name}[scaleout-nccl-w{cards} torchrun entries, "
               "rank 0]", src, rep, sum(
                   r["launches"][k] for r in scale.values()
                   if isinstance(r, dict) and "launches" in r))
              for k, key, name, src, rep in (
                  ("K1", "K1/teacher/s3", "fused_qkv_fwd",
                   "unite_torch/csrc/short_attn_wgmma.cu",
                   "unite_tpu/ops/attention.py:678"),
                  ("K2", "K2/student/s3", "fused_qkv_bwd",
                   "unite_torch/csrc/short_bwd_wgmma.cu",
                   "unite_tpu/ops/attention.py:773"),
                  ("K3", "K3/train/b5", "packed_flash_fwd",
                   "unite_torch/csrc/flash_fwd_wgmma.cu",
                   "unite_tpu/ops/attention.py:913"),
                  ("K4a", "K4a/b5", "packed_flash_dq",
                   "unite_torch/csrc/flash_bwd_wgmma.cu",
                   "unite_tpu/ops/attention.py:983"),
                  ("K4b", "K4b/b5", "packed_flash_dkv",
                   "unite_torch/csrc/flash_bwd_wgmma.cu",
                   "unite_tpu/ops/attention.py:1014")))):
        r = kr[key]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels, "step": mp,
                      "stage1_m075_step": m075,
                      "stage1_m075_card_vs_cpu_rel": m075_rel,
                      "stage1_entry": entry, "stage2_entry": entry2,
                      "native_decode": decode, "stage1_remat": remat,
                      "stage2_recipe": recipe, "videomae_step": mae,
                      "videomae_card_vs_cpu_rel": mae_rel,
                      "videomae_h16_step": mae_h,
                      "videomae_h16_card_vs_cpu_rel": mae_h_rel,
                      "videomae_h16_m075_step": mae_h075,
                      "videomae_h16_m075_card_vs_cpu_rel": mae_h075_rel,
                      "videomae_h16_m06_card_vs_cpu_rel": mae_h06_rel,
                      "head_dim80_lengths": d80_lengths,
                      "umt_pretrain": umt, "clip_masked": clipm,
                      "stage3_entry": entry3, "tool_classify": tools_c,
                      "tool_record_losses": tools_r,
                      "scaleout_nccl": scale, "scaleout_step_b64": scale_b64,
                      "scaleout_gloo_2on1": gloo,
                      "scaleout_gloo_2on1_lamb": gloo_lamb,
                      "optim_card_vs_cpu": optim, "stage2_opt_b8": s2opt,
                      "seconds": time.perf_counter() - t0,
                      "scaleout_multi_card": multi,
                      "stage2_step": s2,
                      "stage2_eval": ev, "stage2_card_vs_cpu_rel": s2_rel,
                      "stage3_step": s3, "stage3_cls_step": s3c,
                      "stage3_cls_eval": ev3, "stage3_card_vs_cpu": s3_rel,
                      "stage1_l14_step": l14, "stage1_l14_int8_step": l14q,
                      "l14_int8_card_vs_cpu_rel": l14_rel,
                      "int8_teacher_vs_bf16": int8_teacher,
                      "probe": probe, "flash_fwd_lengths": lengths,
                      "flash_bwd_lengths": bwd_lengths,
                      "short_fwd_lengths": short_lengths,
                      "short_bwd_lengths": short_bwd_lengths,
                      "wgmma_ptxas": ptxas, "matmul_sweep": matmul_sweep,
                      "matmul_checks": {
                          k: r for k, r in kr.items() if k.startswith("K7")},
                      "yardsticks": {k: {x: r[x] for x in r if x.startswith(
                          ("library", "flash_fwd", "flash_bwd", "device"))}
                          for k, r in kr.items()}}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
