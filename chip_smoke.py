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
   forward + 12 K5 dQ + 12 K5 dK/dV a step, no K2);
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
17. one JSON line of every kernel's numbers, the card line again, and the
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
                  tag: str = ""):
    """Phase 3: K1 at the teacher's [B, 197, 3*H*64] (forward only) and K1
    and K2 at the student's [B, 320, 3*H*64] against their plain versions,
    with timings; K2's repeats equal bit for bit. ViT-B/16 (12 heads) by
    default; ``tag`` "/l14" at the ViT-L/14 path's 16 heads and batches
    (192 frames, 24 clips)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for label, (b, s) in (("teacher", (batches[0], 197)),
                          ("student", (batches[1], 320))):
        qkv = torch.randn((b, s, 3 * heads * 64), generator=gen,
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
        nbytes = b * s * 4 * heads * 64 * 2 + (b * heads * s * 4 if with_lse
                                               else 0)
        bms, by = bound(nbytes, 4.0 * b * heads * s * s * 64)
        key = f"K1/{label}{tag}"
        results[key] = dict(
            shape=[b, s, 3 * heads * 64], max_abs_err=err.max().item(),
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
    do_h = do.reshape(b, s, heads, 64).transpose(1, 2).contiguous()

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(q, k, v, scale=SCALE).backward(do_h)

    fwd_bwd_ms = median_ms(sdpa_fwd_bwd)
    o_lib = F.scaled_dot_product_attention(q, k, v, scale=SCALE)

    def sdpa_bwd():
        torch.autograd.grad(o_lib, (q, k, v), do_h, retain_graph=True)

    lib_ms, lib_dev_ms = median_ms(sdpa_bwd), device_ms(sdpa_bwd)
    # reads qkv, o, do and lse2, writes dqkv (and delta, read back): the
    # function's 10 S^2*D flops a head (the kernels do 7: s and dp twice)
    nbytes = b * s * (3 + 1 + 1 + 3) * heads * 64 * 2 + b * heads * s * 4
    bms, by = bound(nbytes, 10.0 * b * heads * s * s * 64)
    key = f"K2/student{tag}"
    results[key] = dict(
        shape=[b, s, 3 * heads * 64], max_abs_err=err.max().item(),
        mean_abs_err=err.mean().item(), tol=tol, ms=ms, device_ms=dev_ms,
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
        library_device_ms=lib_dev_ms,
        library="scaled_dot_product_attention backward (dq, dk, dv)",
        library_fwd_bwd_ms=fwd_bwd_ms, flash_bwd_ms=flash_ms,
        flash_bwd_device_ms=flash_dev_ms)
    print(f"K2 fused_qkv_bwd student{tag} {results[key]}", flush=True)
    del q, k, v, do_h, o_lib, dqkv, ref
    return results


def check_grouped_kernels(torch, A):
    """Phase 3, stage 1 at mask 0.75: K5 against its plain version at the
    student's [64, 12, 392, 64] (contiguous tensors and the strided views of
    a qkv projection that the models pass), the route's edge
    [64, 12, 512, 64] and a ragged [5, 12, 393, 64], forward and backward,
    the backward's repeats at 392 equal bit for bit; times on the views at
    392."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(21)
    results, errs = {}, {}
    for label, b, s in (("m075", 64, M075_TOKENS), ("edge", 64, 512),
                        ("ragged", 5, M075_TOKENS + 1)):
        qkv = torch.randn((b, s, 3 * HEADS * 64), generator=gen,
                          device="cuda").to(torch.bfloat16)
        views = A._split_heads(qkv, HEADS)
        dense = [t.contiguous() for t in views]
        ref, ref_m, ref_l = A.grouped_reference(*dense, scale=SCALE)
        do = torch.randn(ref.shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        refs = A.grouped_reference_bwd(*dense, do, scale=SCALE)
        layouts = ((("contiguous", dense), ("views", views))
                   if label == "m075" else (("views", views),))
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
            for i in range(BWD_REPEATS if label == "m075" else 0):
                again = A.grouped_bwd(*qkv_t, do, m, l, SCALE)
                if not all(torch.equal(a, a2) for a, a2 in zip(grads, again)):
                    raise AssertionError(
                        f"K5 {label} {layout} backward: repeat {i + 1} of "
                        f"{BWD_REPEATS} differs from the first")
        print(f"K5 {label} [{b}, {HEADS}, {s}, 64] agrees with its plain "
              "version", flush=True)
        del ref, refs, out, grads
        if label == "m075":
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
    tok = b * h * s * 64 * 2  # bytes of one [B, H, S, 64] bf16 tensor
    stat = b * h * s * 4      # one fp32 row statistic
    by_shape = {k: v for k, v in errs.items()}
    bms, by = bound(4 * tok + 2 * stat, 4.0 * b * h * s * s * 64)
    results["K5/m075"] = dict(
        shape=[b, h, s, 64], max_abs_err=max(v for k, v in errs.items()
                                             if k.startswith("fwd/")),
        errors_by_shape=by_shape, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=lib_ms,
        library_device_ms=lib_dev_ms,
        library="scaled_dot_product_attention forward")
    print(f"K5 grouped_fwd m075 {results['K5/m075']}", flush=True)
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
        bms, by = bound(nbytes, flops * b * h * s * s * 64)
        results[f"{key}/m075"] = dict(
            shape=[b, h, s, 64], max_abs_err=e, tol=tol, ms=ms_k,
            device_ms=dev, plain_ms=plain, bound_ms=bms, bound_by=by,
            library_ms=bwd_ms, library_device_ms=bwd_dev_ms,
            library="scaled_dot_product_attention backward (dq, dk, dv: the "
                    "dq and dk/dv kernels together)",
            library_fwd_bwd_ms=fwd_bwd_ms)
        print(f"K5 {key} m075 {results[f'{key}/m075']}", flush=True)
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
               state_dict=None, teacher_state=None, mask_ratio: float = 0.8):
    """The stage-1 step as run_stage1.main builds it, with the
    configs/stage1_config.yaml values."""
    from unite_torch import create_model
    from unite_torch.engines.pretrain_umt import make_pretrain_train_step
    from unite_torch.optim.factory import create_optimizer
    from unite_torch.train.train_state import TrainState
    from unite_torch.utils.schedules import cosine_scheduler, scaled_lr

    frames, ret = 8, (6, 7, 8, 9, 10, 11)
    student = create_model(
        "adaptation_umt_base_patch16_224", device=device, dtype=dtype,
        num_frames=frames, tubelet_size=1, drop_path_rate=drop_path,
        clip_decoder_embed_dim=768, clip_output_dim=512,
        clip_norm_type="l2", clip_return_layers=ret)
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
    tx, _ = create_optimizer("adamw", lr_tab, student, weight_decay=wd_tab,
                             betas=(0.9, 0.95), eps=1e-8, device=device)
    step = make_pretrain_train_step(
        student, teacher, num_patches=frames * 196, frames=frames,
        mask_ratio=mask_ratio, source_batch_size=b, clip_loss_data="mixed",
        clip_grad=None, clip_input_resolution=224, device=device)
    return TrainState(student, tx), teacher, step


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
                                           ("eval", 32, False)), tag=""):
    """Phase 3, stage 2: K3 and K4 against their plain versions at the
    stage-2 shapes, with timings: ``shapes`` holds (label, batch, with lse);
    K4 runs at the "train" one. The stage-2 entry's phase passes its B=7
    with ``tag`` "/b7"."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(4)
    s, hd = STAGE2_TOKENS, HEADS * 64
    results = {}
    for label, b, with_lse in shapes:
        qkv = torch.randn((b, s, 3 * hd), generator=gen,
                          device="cuda").to(torch.bfloat16)
        out, lse = A.packed_flash_fwd(qkv, HEADS, SCALE, with_lse=with_lse)
        torch.cuda.synchronize()
        ref, ref_lse = A.packed_flash_reference(qkv, HEADS, SCALE)
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
        ms = median_ms(lambda: A.packed_flash_fwd(qkv, HEADS, SCALE,
                                                  with_lse))
        plain_ms = median_ms(lambda: A.packed_flash_reference(qkv, HEADS,
                                                              SCALE))
        q, k, v = (t.contiguous() for t in A._split_heads(qkv, HEADS))
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=SCALE))
        nbytes = b * s * 4 * hd * 2 + (b * HEADS * s * 4 if with_lse else 0)
        bms, by = bound(nbytes, 4.0 * b * HEADS * s * s * 64)
        results[f"K3/{label}{tag}"] = dict(
            shape=[b, s, 3 * hd], max_abs_err=err.max().item(),
            mean_abs_err=err.mean().item(), ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=lib_ms,
            library="scaled_dot_product_attention forward")
        print(f"K3 packed_flash_fwd {label}{tag} "
              f"{results[f'K3/{label}{tag}']}", flush=True)
        del qkv, out, lse, q, k, v, err
        torch.cuda.empty_cache()

    # K4 at the train shape, from the train forward above
    qkv, out, lse = train
    b = qkv.shape[0]
    do = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    dqkv = A.packed_flash_bwd(qkv, out, lse, do, HEADS, SCALE)
    torch.cuda.synchronize()
    ref = A.packed_flash_reference_bwd(qkv, out, lse, do, HEADS, SCALE).float()
    errs = {}
    for i, part in enumerate(("dq", "dk", "dv")):
        sl = slice(i * hd, (i + 1) * hd)
        e = (dqkv[..., sl].float() - ref[..., sl]).abs().max().item()
        tol = BWD_TOL * ref[..., sl].abs().max().item()
        if not bool(torch.isfinite(dqkv[..., sl]).all()) or e > tol:
            raise AssertionError(f"K4 {part}: max abs err {e} > {tol}")
        errs[part] = (e, tol)
    del ref
    buf = torch.empty_like(qkv)
    delta = torch.empty((b, HEADS, s), dtype=torch.float32, device="cuda")
    ms_dq = median_ms(lambda: A.packed_flash_dq(qkv, out, lse, do, buf, delta,
                                                HEADS, SCALE))
    ms_dkv = median_ms(lambda: A.packed_flash_dkv(qkv, do, lse, delta, buf,
                                                  HEADS, SCALE))
    plain_dq = median_ms(lambda: A._packed_dq_reference(qkv, out, lse, do,
                                                        HEADS, SCALE))
    plain_dkv = median_ms(lambda: A._packed_dkv_reference(qkv, lse, delta, do,
                                                          HEADS, SCALE))
    q, k, v = (t.detach().contiguous().requires_grad_(True)
               for t in A._split_heads(qkv, HEADS))
    do_h = do.reshape(b, s, HEADS, 64).transpose(1, 2).contiguous()

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(q, k, v, scale=SCALE).backward(do_h)

    fwd_bwd_ms = median_ms(sdpa_fwd_bwd)
    o_lib = F.scaled_dot_product_attention(q, k, v, scale=SCALE)

    def sdpa_bwd():
        torch.autograd.grad(o_lib, (q, k, v), do_h, retain_graph=True)

    bwd_ms, bwd_dev_ms = median_ms(sdpa_bwd), device_ms(sdpa_bwd)
    dev_dq = device_ms(lambda: A.packed_flash_dq(qkv, out, lse, do, buf, delta,
                                                 HEADS, SCALE))
    dev_dkv = device_ms(lambda: A.packed_flash_dkv(qkv, do, lse, delta, buf,
                                                   HEADS, SCALE))
    tok = b * s * hd * 2  # bytes of one [B, S, H*D] bf16 tensor
    stat = b * HEADS * s * 4  # one fp32 row statistic
    # K4a reads qkv, o, do, lse and writes dq, delta: 3 products (s, dp,
    # dq); K4b reads qkv, do, lse, delta and writes dk, dv: 4 products
    for key, name, ms, dev, plain, nbytes, flops, e in (
            ("K4a", "dq", ms_dq, dev_dq, plain_dq, 6 * tok + 2 * stat, 6.0,
             errs["dq"]),
            ("K4b", "dkv", ms_dkv, dev_dkv, plain_dkv, 6 * tok + 2 * stat, 8.0,
             max(errs["dk"], errs["dv"]))):
        bms, by = bound(nbytes, flops * b * HEADS * s * s * 64)
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
                 state_dict=None):
    """The stage-2 model, optimizer and steps as run_stage2.main builds
    them from configs/stage2_config.yaml (no lr batch scaling in stage 2,
    warmup 0, layer decay 0.65, blocks 0-6 frozen, no EMA, no clip)."""
    from unite_torch.engines.finetune import (make_eval_step,
                                              make_finetune_train_step)
    from unite_torch.optim.factory import create_optimizer
    from unite_torch.train.run_stage2 import build_model, trainable_mask
    from unite_torch.train.train_state import TrainState
    from unite_torch.utils.schedules import cosine_scheduler

    args = SimpleNamespace(
        model="vit_base_patch16_224", nb_classes=12, num_frames=8,
        tubelet_size=1, fc_drop_rate=0.0, drop=0.0, attn_drop_rate=0.0,
        drop_path=drop_path, use_learnable_pos_emb=False,
        use_mean_pooling=True, init_scale=0.001, head_type="linear",
        head_hidden_dim=256, compute_dtype=dtype_name,
        frozen_layers="0,1,2,3,4,5,6", train_head_only=False,
        freeze_patch_embedding=False)
    model = build_model(args, device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    niter, epochs = 100, 20
    lr_tab = cosine_scheduler(2.5e-5, 1e-6, epochs, niter,
                              start_warmup_value=1e-6)
    wd_tab = cosine_scheduler(0.05, 0.05, epochs, niter)
    mask = trainable_mask(args, model)
    tx, _ = create_optimizer("adamw", lr_tab, model, weight_decay=wd_tab,
                             betas=(0.9, 0.999), eps=1e-8,
                             trainable=mask.__getitem__,
                             num_layers=model.depth, layer_decay=0.65,
                             device=device)
    return (TrainState(model, tx),
            make_finetune_train_step(model, device=device),
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


def check_flash_lengths(torch, A):
    """Phase 3: the K3/K6 forward (csrc/flash_fwd_wgmma.cu) against its
    plain version at every length of ``SWEEP_LENGTHS`` (B=2, 2 and 12
    heads), on contiguous [B, H, S, 64] tensors and strided qkv views (K6)
    and on the packed lanes of qkv (K3), with and without the lse; the two
    outputs must be equal. Returns the largest errors by length."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    worst = {}
    for s in SWEEP_LENGTHS:
        for h in (2, HEADS):
            qkv = torch.randn((2, s, 3 * h * 64), generator=gen,
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
                        f"K3/K6 forward S={s} H={h} {layout}: max abs err {e}"
                        f" (tol {FWD_TOL}), lse err {le}, equal without lse "
                        f"{torch.equal(out_nl, out)}")
                w = worst.setdefault(s, {"max_abs_err": 0.0, "lse_err": 0.0})
                w["max_abs_err"] = max(w["max_abs_err"], e)
                w["lse_err"] = max(w["lse_err"], le)
            del qkv, views, dense, ref, ref_lse, out, lse, out_nl
    print(f"K3/K6 forward lengths {list(SWEEP_LENGTHS)} x heads (2, {HEADS}) "
          f"x (contiguous, views, packed) x lse: {worst}", flush=True)
    return worst


def check_flash_bwd_lengths(torch, A):
    """Phase 3: the flash backward (csrc/flash_bwd_wgmma.cu: K4a/K4b and
    K6's dq and dk/dv) against its plain versions at every length of
    ``SWEEP_LENGTHS`` (B=2, 2 and 12 heads), on the packed lane slices of
    qkv (K4), strided qkv views with o and do laid out as the models lay
    them out, and contiguous tensors (K6), from the plain forward's o and
    lse2, within ``BWD_TOL`` times the largest |dq|, |dk| or |dv| of the
    plain version (at S = 1, dq and dk are 0 up to rounding noise, so no
    tolerance relative to them alone holds); a repeat must be equal bit for
    bit (no atomics). Returns the largest errors over that scale, by
    length."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    worst = {}
    for s in SWEEP_LENGTHS:
        for h in (2, HEADS):
            qkv = torch.randn((2, s, 3 * h * 64), generator=gen,
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
                            f"flash backward S={s} H={h} {layout} {name}: max "
                            f"abs err {e} (tol {tol}), repeat equal "
                            f"{torch.equal(a, a2)}")
                    w = worst.setdefault(s, {})
                    w[name] = max(w.get(name, 0.0), e / top)
            del qkv, views, dense, o, lse, do, refs, o_rows, do_rows, got
    print(f"flash backward lengths {list(SWEEP_LENGTHS)} x heads (2, "
          f"{HEADS}) x (packed, views, contiguous): max abs err / max |ref| "
          f"{worst}", flush=True)
    return worst


def check_short_lengths(torch, A):
    """Phase 3: the short forward (csrc/short_attn_wgmma.cu) against its
    plain versions at every length of ``SHORT_LENGTHS`` (B=2; 2, 12 and 16
    heads): K1 on the packed lanes of qkv with and without the lse, K5 on
    strided qkv views and contiguous tensors with and without m and l; each
    repeated launch equal bit for bit. Then k = -q at 197, 320, 392 (K1 and
    K5) and 768 (K1), where every real score is negative, so a zero-filled
    key past S entering the row max would show. Returns the largest errors
    by length."""
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
        for h in (2, HEADS, 16):
            qkv = torch.randn((2, s, 3 * h * 64), generator=gen,
                              device="cuda").to(torch.bfloat16)
            k1(qkv, h, s)
            views = A._split_heads(qkv, h)
            k5(*views, s, "views")
            k5(*(t.contiguous() for t in views), s, "contiguous")
            del qkv, views
    for s in (197, 320, M075_TOKENS, A.FUSED_QKV_MAX_SEQ):
        q = torch.randn((2, s, 2, 64), generator=gen, device="cuda").abs()
        v = torch.randn((2, s, 2, 64), generator=gen, device="cuda")
        qkv = torch.cat([q, -q, v], dim=2).reshape(2, s, 6 * 64).to(
            torch.bfloat16)
        k1(qkv, 2, f"{s} k=-q")
        if s <= A.GROUPED_MAX_SEQ:
            k5(*(t.contiguous() for t in A._split_heads(qkv, 2)),
               f"{s} k=-q", "contiguous")
    print(f"short forward lengths {list(SHORT_LENGTHS)} x heads (2, {HEADS}, "
          f"16) x (K1 packed, K5 views, K5 contiguous) x statistics, and "
          f"k = -q: {worst}", flush=True)
    return worst


def check_short_bwd_lengths(torch, A):
    """Phase 3: the short backward (csrc/short_bwd_wgmma.cu) against its
    plain versions at every length of ``SHORT_LENGTHS`` (B=2): K2 on the
    packed lanes of qkv from K1's out and lse2 (2, 12 and 16 heads, and at
    ``FUSED_QKV_MAX_SEQ``, its shared-memory guard), K5's backward on strided
    qkv views (do laid out as the models lay it out) and contiguous tensors
    from the K5 forward's m and l (2 and 12 heads); within ``BWD_TOL``
    times the largest |dq|, |dk| or |dv| of the plain version, and each
    repeat equal bit for bit. Returns the largest errors over that scale,
    by length."""
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

    for s in SHORT_LENGTHS + (A.FUSED_QKV_MAX_SEQ,):
        for h in (2, HEADS, 16):
            qkv = torch.randn((2, s, 3 * h * 64), generator=gen,
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
            check(f"K2 H={h}", s, got, again, refs)
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
    print(f"short backward lengths {list(SHORT_LENGTHS)} (K2 also "
          f"{A.FUSED_QKV_MAX_SEQ}) x heads (2, {HEADS}, 16 for K2) x (K2 "
          f"packed, K5 views, K5 contiguous): max abs err / max |ref| "
          f"{worst}", flush=True)
    return worst


def check_flash_kernels(torch, A):
    """Phase 3, stage 3: K6 against its plain version at the stage-3 CLS
    train shape [5, 12, 1569, 64], the CLS eval shape [32, 12, 1569, 64]
    (forward only) and the clip_l14_336 teacher's [40, 16, 577, 64], on
    contiguous tensors and on the strided views of a qkv projection output
    that the models pass; times on the views."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(11)
    results = {}
    for label, b, h, s, train in (("train", 5, HEADS, STAGE3_CLS_TOKENS, True),
                                  ("l14", 40, 16, 577, True),
                                  ("eval", 32, HEADS, STAGE3_CLS_TOKENS,
                                   False)):
        qkv = torch.randn((b, s, 3 * h * 64), generator=gen,
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
        ms = median_ms(lambda: A.flash_fwd(q, k, v, SCALE, train))
        plain_ms = median_ms(lambda: A.flash_reference(q, k, v, scale=SCALE))
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
            *dense, scale=SCALE))
        tok = b * h * s * 64 * 2  # bytes of one [B, H, S, 64] bf16 tensor
        stat = b * h * s * 4      # one fp32 row statistic
        bms, by = bound(4 * tok + (stat if train else 0),
                        4.0 * b * h * s * s * 64)
        results[f"K6/{label}"] = dict(
            shape=[b, h, s, 64], max_abs_err=max(errs.values()),
            max_abs_err_by_layout=errs, ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=lib_ms,
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
            bms, by = bound(nbytes, flops * b * h * s * s * 64)
            results[f"K6{key}/{label}"] = dict(
                shape=[b, h, s, 64], max_abs_err=e[0], tol=e[1], ms=ms_k,
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
        student, head = model["model"].eval(), model["classifier"]
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
    to ``want()``, which is asked after the call."""
    reset_counts(A)
    t0 = time.perf_counter()
    main(args)
    wall = time.perf_counter() - t0
    counts = read_counts(A)
    expect_counts(counts, want(), what)
    return dict(t0=t0, wall_s=wall, launches=counts, by_shape=read_shapes(A))


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
    build_eval = R.make_eval_step

    def checked_eval(*a, **k):
        step = build_eval(*a, **k)

        def checked(state, batch):
            out = step(state, batch)
            check_eval_rows(torch, out, "stage-2 entry")
            rec["calls"] += 1
            return out

        return checked

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
                 (R, "make_eval_step", checked_eval),
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
    mark("stage-1 paths")
    # each entry's output stays until the next stage's entry has read it
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        work = Path(work)
        entry = stage1_entry(torch, A, m075, work)
        torch.cuda.empty_cache()
        mark("stage-1 entry")
        s2_rel = stage2_card_vs_cpu(torch)
        s2, state, eval_step = stage2_path(torch, A)
        ev = stage2_eval(torch, A, state, eval_step)
        del state, eval_step
        torch.cuda.empty_cache()
        mark("stage-2 paths")
        entry2, kr_b7 = stage2_entry(
            torch, A, work / "stage1" / "run" / "checkpoint-latest.pth", s2,
            ev, work)
        kr.update(kr_b7)
        torch.cuda.empty_cache()
        mark("stage-2 entry")
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
            ("K3/train", "packed_flash_fwd[train B=8 S=1568]",
             "unite_torch/csrc/flash_fwd_wgmma.cu",
             "unite_tpu/ops/attention.py:913", s2["k3_launches"]),
            ("K3/eval", "packed_flash_fwd[eval B=32 S=1568]",
             "unite_torch/csrc/flash_fwd_wgmma.cu",
             "unite_tpu/ops/attention.py:913", ev["k3_launches"]),
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
            ("K7b/probe", "bf16_matmul[probe 38400x768x3072]",
             "unite_torch/csrc/blocked_matmul_wgmma.cu",
             "tools/quant_kernel_probe.py:53", probe["launches"]["K7b"])):
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
                      "stage3_entry": entry3,
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
