"""Stage 2: supervised finetune on source-domain video
(unite_tpu/train/run_stage2.py, the reference's run_stage2.py:455-852).

Train / validation / test datasets, the classification ViT imported from a
stage-1 checkpoint of the port or from published weights (head surgery),
freeze policies, per-step schedules without lr batch scaling and with
layer-wise decay, gradient accumulation (--update_freq), EMA; per-epoch
training and validation with best-checkpoint tracking, auto-resume and a
mid-epoch checkpoint on preemption; the final multi-view test and its
merge. The step it runs is ``unite_torch.engines.finetune``: at 1568 tokens
its attention runs through K3 forward and K4 backward on the card.

Run on the card: ``python -m unite_torch.train.run_stage2 --config
configs/stage2_config.yaml --dataset ucf-hmdb --finetune
runs/stage1/.../checkpoint-latest.pth``; call ``main(args, device="cpu")``
for the plain CPU path.
"""

from __future__ import annotations

import copy
import os
import sys
import time
from typing import Dict

import numpy as np
import torch

from unite_torch.config import parse_with_config
from unite_torch.data.build import build_dataset
from unite_torch.data.loader import device_prefetch, echo_batches, to_device
from unite_torch.engines.finetune import (make_eval_step,
                                          make_finetune_train_step)
from unite_torch.ops.eval_transforms import make_device_val_transform
from unite_torch.optim.factory import create_optimizer, set_schedule_count
from unite_torch.train import common
from unite_torch.train.args import stage2_parser
from unite_torch.train.train_state import TrainState
from unite_torch.utils import checkpoint as ck
from unite_torch.utils import torch_import as ti
from unite_torch.utils.logging import maybe_tensorboard, maybe_wandb
from unite_torch.utils.registry import create_model


def build_model(args, device=None):
    """The classification ViT as the stage-2 entry builds it, on ``device``
    (CUDA when None)."""
    if getattr(args, "use_checkpoint", False):
        raise NotImplementedError(
            "activation checkpointing (--use_checkpoint) is not ported yet "
            "(ROADMAP queue 1, item 4)")
    return create_model(
        args.model, device=device, dtype=common.compute_dtype(args),
        num_classes=args.nb_classes, all_frames=args.num_frames,
        tubelet_size=args.tubelet_size, fc_drop_rate=args.fc_drop_rate,
        drop_rate=args.drop, attn_drop_rate=args.attn_drop_rate,
        drop_path_rate=args.drop_path,
        use_learnable_pos_emb=args.use_learnable_pos_emb,
        use_mean_pooling=args.use_mean_pooling, init_scale=args.init_scale,
        classifier_type=args.head_type,
        classifier_hidden_dim=args.head_hidden_dim)


def trainable_mask(args, model: torch.nn.Module,
                   lp_phase: bool = False) -> Dict[str, bool]:
    """Freeze policies (run_stage2.py:711-746): head only, frozen block ids,
    the patch embedding, or LP-FT's first phase (blocks 0-8 and the patch
    embedding). Parameter name -> trainable; frozen parameters keep their
    gradients (they count in the grad norm), only their update is 0."""
    frozen_blocks = set()
    if getattr(args, "frozen_layers", ""):
        frozen_blocks = {int(x) for x in str(args.frozen_layers).split(",")
                         if str(x).strip() != ""}
    if lp_phase:
        frozen_blocks = set(range(9))

    def decide(name: str) -> bool:
        parts = name.split(".")
        if args.train_head_only:
            # head + final norms (reference matches 'head'/'norm.weight')
            return parts[0] in ("head", "fc_norm", "norm")
        if parts[0] == "blocks" and int(parts[1]) in frozen_blocks:
            return False
        if (args.freeze_patch_embedding or lp_phase) and \
                parts[0] == "patch_embed":
            return False
        return True

    return {name: decide(name) for name, _ in model.named_parameters()}


def load_finetune_ckpt(args, model: torch.nn.Module) -> None:
    """--finetune into ``model`` (run_stage2.py:349-438). The payload
    decides, as in ``run_stage1.load_student``: the port's own checkpoints
    (``epoch`` and ``optimizer`` beside ``model``) load as they are, a
    stage-1 one through the encoder its keys nest under ``encoder.`` (its
    CLIP decoders left out), as unite_tpu takes its .msgpack files;
    published weights take the reference's chain: head surgery, the
    ``backbone.`` / ``encoder.`` prefixes stripped, the positional
    embedding resampled to this geometry. Both merge leniently: keys the
    model lacks and shapes that differ are skipped and reported."""
    if not args.finetune:
        return
    payload = ck.load_checkpoint(args.finetune)
    if isinstance(payload, dict) and {"model", "epoch", "optimizer"} <= set(
            payload):
        state = payload["model"]
        if any(k.startswith("encoder.") for k in state):
            state = {k[len("encoder."):]: v for k, v in state.items()
                     if k.startswith("encoder.")}
        ti.merge_state(model, state)
        return
    state = ti.select_state(payload, args.model_key)
    state = ti.surgery_head(state, args.nb_classes, args.delete_head,
                            label_map_path=getattr(args, "label_map_path",
                                                   "") or None)
    state = ti.strip_prefixes(state, ("backbone.", "encoder."))
    n_patch = (args.input_size // args.patch_size) ** 2 * (
        args.num_frames // args.tubelet_size)
    state = ti.interpolate_pos_embed(
        state, n_patch, num_extra_tokens=0 if args.use_mean_pooling else 1,
        new_frames=args.num_frames, tubelet_size=args.tubelet_size)
    ti.merge_state(model, state)


def check_refused(args) -> None:
    """What the stage-2 config leaves off and the port does not have yet
    (``setup_run`` refuses the scale-out flags)."""
    if args.mixup > 0 or args.cutmix > 0:
        raise NotImplementedError(
            f"--mixup {args.mixup} / --cutmix {args.cutmix}: device-side "
            "mixup is not ported yet (ROADMAP queue 1, item 4); the stage-2 "
            "config keeps both at 0")
    common.check_mu_dtype(args)


def main(args, device=None):
    """Finetune on CUDA, or on ``device``."""
    start = time.time()
    check_refused(args)
    dev = common.setup_run(args, device)
    tb = maybe_tensorboard(args)
    wb = maybe_wandb(args)
    reader = common.reader_for(args)

    args.data_path = args.ann_file_train
    ds_train, args.nb_classes = build_dataset(
        "train", args, anno_path=args.ann_file_train, reader=reader)
    eval_reader = common.reader_for(args, for_eval=True)
    ds_val, _ = build_dataset("validation", args,
                              anno_path=args.ann_file_val, reader=eval_reader)
    ds_test, _ = build_dataset("test", args, anno_path=args.ann_file_test,
                               reader=eval_reader)
    reps = max(1, getattr(args, "train_repetitions", 1))
    loader = common.make_loader(ds_train, args, args.batch_size,
                                repetitions=reps)
    val_loader = common.make_loader(ds_val, args, args.batch_size_val,
                                    shuffle=False, drop_last=False)
    echo_k = max(1, getattr(args, "data_echo", 1) or 1)
    niter_per_ep = max(1, len(loader) * echo_k // args.update_freq)

    model = build_model(args, dev)
    cdtype = common.compute_dtype(args)
    load_finetune_ckpt(args, model)
    nparams = sum(p.numel() for p in model.parameters())
    print(f"model: {args.model}, params: {nparams / 1e6:.1f}M")

    # no linear scaling rule in stage 2: the reference takes --lr as it is
    # (run_stage2.py:604), unlike stages 1 and 3
    lr_tab, wd_tab, peak_lr = common.lr_tables(args, niter_per_ep,
                                               args.num_sample,
                                               scale_rule=False)
    print(f"peak lr {peak_lr:.2e}, steps/epoch {niter_per_ep}")
    opt_groups: Dict = {}

    def build_tx(lp_phase: bool):
        mask = trainable_mask(args, model, lp_phase=lp_phase)
        tx, groups = create_optimizer(
            args.opt, lr_tab, model, weight_decay=wd_tab,
            betas=common.betas_for(args), eps=args.opt_eps,
            trainable=mask.__getitem__, num_layers=model.depth,
            layer_decay=args.layer_decay if args.layer_decay < 1.0 else None,
            device=dev)
        opt_groups.clear()
        opt_groups.update(groups)  # the current phase's groups (meters)
        return common.wrap_update_freq(tx, args.update_freq, args.clip_grad)

    # the resume payload comes before the optimizer, so that the LP/FT
    # phase (and the optimizer's groups) match the resumed epoch. Stage 2
    # resumes under --auto_reload (run_stage2.py:702); --auto_resume gates
    # only the numbered checkpoints (utils.py:749); --eval never reloads
    # (its branch exits before the reference's auto_load, :685-702)
    payload = None
    start_epoch, skip0 = args.start_epoch, 0
    if (getattr(args, "auto_reload", False) and not args.eval) or args.resume:
        payload = (ck.load_checkpoint(args.resume) if args.resume
                   else ck.auto_load_model(
                       args.output_dir,
                       include_numbered=getattr(args, "auto_resume", True)))
        if payload is not None:
            # a mid-epoch checkpoint replays the rest of its epoch; skip0
            # counts batches (micro-batches under --update_freq)
            start_epoch, skip0 = common.resume_position(payload)
            common.check_echo_resume(payload, echo_k)

    ema_decay = args.model_ema_decay if args.model_ema else None
    state = TrainState(model, build_tx(start_epoch < args.lp_ft_epochs),
                       ema_decay=ema_decay)
    if payload is not None:
        # sched_every_k maps the batch-counting step onto the tables'
        # optimizer steps in the fallback
        ck.restore_train_state(state, payload,
                               sched_every_k=args.update_freq)

    step_fn = make_finetune_train_step(
        model, label_smoothing=args.smoothing,
        # under accumulation the clip acts on the averaged gradient
        # (wrap_update_freq); the step still logs each pre-clip norm
        clip_grad=args.clip_grad if args.update_freq == 1 else None,
        ema_decay=ema_decay, device=dev)
    eval_tfm = None
    if getattr(args, "device_eval_transforms", False):
        eval_tfm = make_device_val_transform(args.short_side_size,
                                             args.input_size)
    eval_fn = make_eval_step(model, input_transform=eval_tfm, device=dev)
    cast_bf16 = cdtype == torch.bfloat16

    if args.eval:
        # the reference's eval mode runs only the multi-view test and its
        # merge, and records them (run_stage2.py:685-700)
        stats = common.run_final_test(state, eval_fn, ds_test, args,
                                      args.batch_size_val, args.output_dir,
                                      dev, cast_bf16=cast_bf16)
        print(stats)
        common.save_epoch_stats(args, args.epochs, stats)
        if wb is not None and stats:
            wb.log({"test/acc1": stats["test_acc1"],
                    "test/acc5": stats["test_acc5"]})
        common.finish(start, wb)
        return

    def batches(epoch):
        loader.set_epoch(epoch)
        if epoch == start_epoch and skip0:
            loader.skip_next_batches(skip0 // echo_k)
        for clips, labels, _, _ in loader:
            out = to_device({"videos": common.as_video_array(clips),
                             "labels": np.asarray(labels, np.int32)}, dev)
            if cast_bf16 and out["videos"].is_floating_point():
                out["videos"] = out["videos"].to(torch.bfloat16)
            yield out

    gen = torch.Generator(device=dev)

    def wrapped_step(state, batch):
        gen.manual_seed(common.step_seed(args.seed + 1000, state.step))
        return step_fn(state, batch, gen)

    best_acc = common.resume_best_acc(payload)
    ckpt_io = ck.AsyncCheckpointer()  # epoch N+1 overlaps epoch N's write
    guard = common.PreemptionGuard(stop_after_steps=args.stop_after_steps)
    for epoch in range(start_epoch, args.epochs):
        if args.reset_train_dataset and epoch > 0:
            # remake_train_dataloader (run_stage2.py:440-453): a fresh
            # dataset re-draws the train_fraction subset; the epoch-salted
            # seed keeps the run deterministic and resume-consistent
            a2 = copy.copy(args)
            a2.seed = args.seed + 100003 * epoch
            ds_train, _ = build_dataset("train", a2,
                                        anno_path=args.ann_file_train,
                                        reader=reader)
            loader = common.make_loader(ds_train, args, args.batch_size,
                                        repetitions=reps)
            print("Made new train dataloader.")
        if (args.lp_ft_epochs > 0 and epoch == args.lp_ft_epochs
                and not (epoch == start_epoch and skip0)):
            # LP -> FT: a new optimizer with everything unfrozen and fresh
            # moments, its tables continued from this optimizer step; the
            # EMA carries over (timm's ModelEma persists across the
            # requires_grad flip, run_stage2.py:741-747). A run resumed
            # mid-epoch at this epoch already switched before it stopped.
            print(f"LP-FT: unfreezing all layers at epoch {epoch}")
            step_now, ema = state.step, state.ema_params
            state = TrainState(model, build_tx(False), ema_decay=ema_decay)
            state.step = step_now
            set_schedule_count(state.optimizer, step_now // args.update_freq)
            if args.model_ema and ema is not None:
                state.ema_params = ema
        first = epoch == start_epoch
        state, stats, _ = common.train_one_epoch(
            state, wrapped_step,
            device_prefetch(echo_batches(
                batches(epoch), echo_k,
                skip_echoes=(skip0 % echo_k if first else 0)),
                lambda b: b, depth=2),
            epoch, args.log_freq, profile_dir=args.profile_dir or None,
            tb_logger=tb, wandb_logger=wb, preempt_guard=guard,
            sched=common.make_sched(
                lr_tab, wd_tab,
                epoch * niter_per_ep
                + (skip0 // args.update_freq if first else 0),
                opt_groups, every_k=args.update_freq,
                phase=skip0 % args.update_freq if first else 0))
        # done counts batches; gradients accumulated mid-window are part
        # of the optimizer's checkpoint
        done = (skip0 if first else 0) + guard.steps_done
        if common.preempted_mid_epoch(guard, ckpt_io, args, state, epoch,
                                      done, len(loader) * echo_k,
                                      args.save_ckpt,
                                      extra={"best_acc": best_acc}):
            guard.uninstall()
            return
        epoch_stats = {f"train_{k}": v for k, v in stats.items()}
        epoch_stats["n_parameters"] = nparams  # run_stage2.py:806-812
        if wb is not None:
            wb.log({"train/accuracy": stats.get("class_acc"),
                    "train/epoch": epoch})
        if (not args.disable_eval_during_finetuning
                and (epoch + 1) % args.eval_freq == 0):
            val_stats = common.run_validation(
                state, eval_fn, val_loader, args.batch_size_val, dev,
                header=f"Val [{epoch}]", cast_bf16=cast_bf16)
            epoch_stats.update({f"val_{k}": v for k, v in val_stats.items()})
            if wb is not None and val_stats:
                wb.log({f"val/{k}": v for k, v in val_stats.items()})
            if args.save_ckpt and val_stats.get("acc1", -1) > best_acc:
                best_acc = val_stats["acc1"]
                ckpt_io.save_train_state(args.output_dir, epoch, state,
                                         args=vars(args),
                                         extra={"best_acc": best_acc},
                                         tags=("best",))
        if args.save_ckpt:
            tags = ["latest"]
            if ((epoch + 1) % args.save_ckpt_freq == 0
                    or epoch + 1 == args.epochs):
                tags.append(epoch)
            # best_acc rides along, so a resumed run keeps tracking from it
            ckpt_io.save_train_state(args.output_dir, epoch, state,
                                     args=vars(args),
                                     extra={"best_acc": best_acc}, tags=tags)
        common.save_epoch_stats(args, epoch, epoch_stats)
        if guard.triggered:  # preempted exactly at an epoch boundary
            ckpt_io.wait()
            guard.uninstall()
            print(f"Preempted after epoch {epoch}; exiting")
            return
    guard.uninstall()  # don't leak the SIGTERM handler into later forks
    ckpt_io.wait()  # checkpoint-best must be on disk before it is read

    best = os.path.join(args.output_dir, f"checkpoint-best{ck.CKPT_EXT}")
    if args.test_best and os.path.exists(best):
        model.load_state_dict(ck.load_checkpoint(best)["model"])
    test_stats = common.run_final_test(state, eval_fn, ds_test, args,
                                       args.batch_size_val, args.output_dir,
                                       dev, cast_bf16=cast_bf16)
    common.save_epoch_stats(args, args.epochs, test_stats)
    if wb is not None and test_stats:
        wb.log({"test/acc1": test_stats["test_acc1"],
                "test/acc5": test_stats["test_acc5"]})
    common.finish(start, wb)


if __name__ == "__main__":
    main(parse_with_config(stage2_parser(), sys.argv[1:]))
