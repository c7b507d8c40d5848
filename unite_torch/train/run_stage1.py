"""Stage 1: UMT masked pre-training on target-domain video
(unite_tpu/train/run_stage1.py, the reference's run_stage1.py:604-908).

Source (+ target) pretrain datasets with repetition length-matching, the
adaptation student and the frozen CLIP teacher (with imported weights),
per-step cosine schedules, the train step (teacher forward -> attention
mask -> masked student -> alignment loss -> AdamW), checkpoints every
epoch, auto-resume, and a mid-epoch checkpoint on preemption from which a
resumed run replays the rest of the epoch bitwise.

Run on the card: ``python -m unite_torch.train.run_stage1 --config
configs/stage1_config.yaml --dataset hmdb-arid``; pass ``--device_normalize
true`` to ship uint8 clips, and call ``main(args, device="cpu")`` for the
plain CPU path.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from unite_torch.config import parse_with_config
from unite_torch.data.build import build_pretraining_dataset
from unite_torch.data.loader import (cycle, device_prefetch, echo_batches,
                                     to_device)
from unite_torch.data.sharding import repetitions_to_match
from unite_torch.engines.pretrain_umt import make_pretrain_train_step
from unite_torch.ops.masking import n_visible_total
from unite_torch.optim.factory import create_optimizer
from unite_torch.train import common
from unite_torch.train.args import stage1_parser
from unite_torch.train.train_state import TrainState
from unite_torch.utils import checkpoint as ck
from unite_torch.utils import torch_import as ti
from unite_torch.utils.logging import maybe_tensorboard, maybe_wandb
from unite_torch.utils.registry import create_model


def unused_block_mask(max_ret: int, freeze_clip_decoders: bool = False):
    """``trainable(name)`` freezing the encoder blocks above ``max_ret``
    (they never run under clip_only, so the reference leaves their .grad
    None and AdamW skips them) and, under --freeze_clip_decoders, the CLIP
    decoders (run_stage1.py:596-600)."""
    def trainable(name: str) -> bool:
        parts = name.split(".")
        if parts[:2] == ["encoder", "blocks"] and int(parts[2]) > max_ret:
            return False
        return not (freeze_clip_decoders and parts[0] == "clip_decoder")

    return trainable


def build_student(args, device=None):
    """run_stage1.py:273-292 get_model."""
    if args.use_checkpoint:
        raise NotImplementedError(
            "--use_checkpoint (activation checkpointing) is not ported yet")
    return create_model(
        args.model, device=device, dtype=common.compute_dtype(args),
        num_frames=args.num_frames, tubelet_size=args.tubelet_size,
        drop_path_rate=args.drop_path,
        use_learnable_pos_emb=args.use_learnable_pos_emb,
        use_cls_token=args.use_cls_token,
        clip_decoder_embed_dim=args.clip_decoder_embed_dim,
        clip_output_dim=args.clip_output_dim,
        clip_norm_type=args.clip_norm_type,
        clip_return_layers=tuple(args.clip_return_layers))


def build_teacher(args, device=None):
    """run_stage1.py:782-789: the frozen CLIP teacher with attention output."""
    if not args.clip_return_attn:
        raise ValueError(
            "--clip_return_attn false is incompatible with stage-1: the "
            "engine needs the teacher's CLS-row attention for the masking "
            "path (run_stage1.py:379-387)")
    return create_model(
        args.clip_teacher, device=device, dtype=common.compute_dtype(args),
        input_resolution=args.clip_input_resolution,
        clip_norm_type=args.clip_norm_type, return_attn=args.clip_return_attn,
        return_index=tuple(args.clip_return_layers))


def own_student_state(payload: dict) -> dict:
    """The student's state from one of the port's own checkpoints, as
    unite_tpu's load_student takes its .msgpack files (run_stage1.py:117-124):
    a stage-1 student as it is, a stage-3 tree's student (nested under
    ``model``, or the ``model.`` keys of its module dict) unwrapped, and a
    bare stage-2 ViT nested under ``encoder.``."""
    state = payload["model"]
    if isinstance(state.get("model"), dict):
        state = state["model"]
    elif any(k.startswith("model.") for k in state):
        state = {k[len("model."):]: v for k, v in state.items()
                 if k.startswith("model.")}
    if not any(k.startswith("encoder.") for k in state):
        state = ti.wrap_encoder_prefix(state)
    return state


def load_student(args, student) -> None:
    """run_stage1.py:518-602 import chain. The port's own checkpoints
    (``utils/checkpoint.py``: ``epoch`` and ``optimizer`` beside ``model``)
    load through ``own_student_state`` with nothing else done to them, as
    unite_tpu loads its own; published UMT weights get their keys wrapped
    in ``encoder.`` (``backbone.`` stripped after that), the decoders from
    --clip_decoder_init, and the positional embedding resampled to this
    geometry. Both kinds of file end in .pth, so the payload decides."""
    if not args.student_init:
        return
    payload = ck.load_checkpoint(args.student_init)
    if isinstance(payload, dict) and {"model", "epoch", "optimizer"} <= set(
            payload):
        ti.merge_state(student, own_student_state(payload))
        return
    state = ti.select_state(payload, args.model_key)
    state = ti.wrap_encoder_prefix(state)
    state = ti.strip_prefixes(state, ("backbone.",))
    if args.clip_decoder_init:
        dec = ti.load_torch_state(args.clip_decoder_init, args.model_key)
        state.update({k: v for k, v in dec.items()
                      if k.startswith("clip_decoder.")})
    n_patch = (args.input_size // args.patch_size) ** 2 * (
        args.num_frames // args.tubelet_size)
    state = ti.interpolate_pos_embed(
        state, n_patch, num_extra_tokens=1 if args.use_cls_token else 0,
        new_frames=args.num_frames, tubelet_size=args.tubelet_size,
        key="encoder.pos_embed")
    ti.merge_state(student, state)


def load_clip_teacher(args, teacher) -> None:
    """Overlay extracted OpenAI CLIP visual weights (--clip_init)."""
    clip_path = getattr(args, "clip_init", "") or ""
    if clip_path:
        state = ti.load_torch_state(clip_path, "model|module|state_dict")
        ti.merge_state(teacher, ti.clip_state_for_model(
            state, input_resolution=args.clip_input_resolution,
            patch_size=16 if "b16" in args.clip_teacher else 14))


def main(args, device=None):
    """Train stage 1 on CUDA, or on ``device``."""
    start = time.time()
    dev = common.setup_run(args, device)
    common.check_mu_dtype(args)
    tb = maybe_tensorboard(args)
    wb = maybe_wandb(args)
    reader = common.reader_for(args)

    ds_source = build_pretraining_dataset(
        args, anno_path=args.ann_file_train, reader=reader)
    ds_target = None
    if args.ann_file_train_target:
        ds_target = build_pretraining_dataset(
            args, anno_path=args.ann_file_train_target, reader=reader)

    # length-match the streams by repetition (run_stage1.py:711-752): the
    # SMALLER stream is repeated, the target by ceil(src/tgt), else the
    # SOURCE by ceil(tgt/src) (at equal lengths too, which discards
    # --train_repetitions as the reference's rebuilt sampler does)
    b_s = args.batch_size
    b_t = args.batch_size if ds_target is not None else 0
    src_reps = max(1, getattr(args, "train_repetitions", 1))
    if ds_target is not None and len(ds_target) >= len(ds_source):
        src_reps = repetitions_to_match(len(ds_source), len(ds_target))
    src_loader = common.make_loader(ds_source, args, b_s,
                                    repetitions=src_reps)
    tgt_loader = None
    if ds_target is not None:
        reps = repetitions_to_match(len(ds_target), len(ds_source))
        tgt_loader = common.make_loader(ds_target, args, b_t,
                                        repetitions=reps, seed=args.seed + 7)
    echo_k = max(1, getattr(args, "data_echo", 1) or 1)
    niter_per_ep = len(src_loader) * echo_k

    student = build_student(args, dev)
    teacher = build_teacher(args, dev)
    n_patch = (args.input_size // args.patch_size) ** 2 * (
        args.num_frames // args.tubelet_size)
    nv = n_visible_total(n_patch, args.num_frames // args.tubelet_size,
                         args.mask_ratio, args.mask_type)
    cdtype = common.compute_dtype(args)
    load_student(args, student)
    load_clip_teacher(args, teacher)
    nparams = sum(p.numel() for p in student.parameters())
    print(f"student params: {nparams / 1e6:.1f}M, N_vis {nv}/{n_patch}")

    lr_tab, wd_tab, peak_lr = common.lr_tables(args, niter_per_ep,
                                               args.num_sample)
    print(f"peak lr {peak_lr:.2e}, steps/epoch {niter_per_ep}")
    tx, opt_groups = create_optimizer(
        args.opt, lr_tab, student, weight_decay=wd_tab,
        betas=common.betas_for(args), eps=args.opt_eps,
        trainable=unused_block_mask(
            max(int(i) for i in args.clip_return_layers),
            getattr(args, "freeze_clip_decoders", False)),
        device=dev)
    state = TrainState(student, tx)

    start_epoch, skip0 = args.start_epoch, 0
    if args.auto_resume or args.resume:
        payload = (ck.load_checkpoint(args.resume) if args.resume
                   else ck.auto_load_model(args.output_dir))
        if payload is not None:
            # full resume: model + optimizer + step (utils.py:739-776); a
            # mid-epoch (preempted) checkpoint replays the rest of its epoch
            ck.restore_train_state(state, payload)
            start_epoch, skip0 = common.resume_position(payload)
            common.check_echo_resume(payload, echo_k)
    # fast-forward the cycled target stream past everything already
    # consumed (one target host batch per echo_k steps)
    tgt_iter = (cycle(tgt_loader,
                      (start_epoch * niter_per_ep + skip0) // echo_k)
                if tgt_loader is not None else None)

    step_fn = make_pretrain_train_step(
        student, teacher, num_patches=n_patch,
        frames=args.num_frames // args.tubelet_size,
        mask_ratio=args.mask_ratio, source_batch_size=b_s,
        mask_type=args.mask_type, clip_loss_type=args.clip_loss_type,
        clip_loss_data=(args.clip_loss_data if ds_target is not None
                        else "mixed"),
        clip_grad=args.clip_grad,
        clip_input_resolution=args.clip_input_resolution, device=dev)
    gen = torch.Generator(device=dev)

    def batches(epoch):
        src_loader.set_epoch(epoch)
        if epoch == start_epoch and skip0:
            src_loader.skip_next_batches(skip0 // echo_k)
        for videos, mask, _ in src_loader:
            src_mask = None
            if tgt_iter is not None:
                videos_t, mask_t, _ = next(tgt_iter)
                src_mask = np.concatenate([
                    np.ones(len(videos), np.float32),
                    np.zeros(len(videos_t), np.float32)])
                videos = np.concatenate([videos, videos_t], 0)
                if args.mask_type != "attention":
                    mask = np.concatenate([mask, mask_t], 0)
            batch = {"videos": common.as_video_array(videos)}
            if src_mask is not None:
                batch["src_mask"] = src_mask
            if args.mask_type != "attention":
                # the data-side mask's visible tokens, in order (a stable
                # argsort of the bool mask, as ops.masking.visible_indices)
                bool_mask = np.asarray(mask).astype(bool).reshape(
                    videos.shape[0], -1)
                batch["vis_idx"] = np.argsort(
                    bool_mask.astype(np.int32), axis=-1,
                    kind="stable")[:, :nv].astype(np.int64)
            out = to_device(batch, dev)
            if cdtype == torch.bfloat16 and out["videos"].is_floating_point():
                out["videos"] = out["videos"].to(torch.bfloat16)
            yield out

    def wrapped_step(state, batch):
        gen.manual_seed(common.step_seed(args.seed + 1000, state.step))
        return step_fn(state, batch, gen)

    ckpt_io = ck.AsyncCheckpointer()  # epoch N+1 overlaps epoch N's write
    guard = common.PreemptionGuard(stop_after_steps=args.stop_after_steps)
    for epoch in range(start_epoch, args.epochs):
        state, stats, _ = common.train_one_epoch(
            state, wrapped_step,
            device_prefetch(echo_batches(
                batches(epoch), echo_k,
                skip_echoes=(skip0 % echo_k if epoch == start_epoch else 0)),
                lambda b: b, depth=2),
            epoch, args.log_freq, profile_dir=args.profile_dir or None,
            tb_logger=tb, wandb_logger=wb, preempt_guard=guard,
            sched=common.make_sched(
                lr_tab, wd_tab,
                epoch * niter_per_ep + (skip0 if epoch == start_epoch else 0),
                opt_groups))
        # checkpoints_enabled gates ALL writes (run_stage1.py:880; the
        # reference YAML ships false and stage1.sh re-enables it)
        saving = args.output_dir and args.checkpoints_enabled
        done = (skip0 if epoch == start_epoch else 0) + guard.steps_done
        if common.preempted_mid_epoch(guard, ckpt_io, args, state, epoch,
                                      done, niter_per_ep, saving):
            guard.uninstall()
            return
        tags = ["latest"]
        if (epoch + 1) % args.save_ckpt_freq == 0 or epoch + 1 == args.epochs:
            tags.append(epoch)
        if saving:
            ckpt_io.save_train_state(args.output_dir, epoch, state,
                                     args=vars(args), tags=tags)
        common.save_epoch_stats(
            args, epoch, {**{f"train_{k}": v for k, v in stats.items()},
                          "n_parameters": nparams})  # run_stage1.py:894-898
        if wb is not None:
            wb.log({"epoch": epoch})  # epoch marker (run_stage1.py:901)
        if guard.triggered:  # preempted exactly at an epoch boundary
            ckpt_io.wait()
            guard.uninstall()
            print(f"Preempted after epoch {epoch}; exiting")
            return
    guard.uninstall()  # don't leak the SIGTERM handler into later forks
    ckpt_io.wait()
    common.finish(start, wb)


if __name__ == "__main__":
    parser = stage1_parser()
    parser.add_argument("--clip_init", default="",
                        help="extracted OpenAI CLIP visual .pth for the teacher")
    main(parse_with_config(parser, sys.argv[1:]))
