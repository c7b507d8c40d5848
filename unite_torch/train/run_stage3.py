"""Stage 3: collaborative self-training on source and target video
(unite_tpu/train/run_stage3.py, the reference's run_stage3.py:992-1414).

The source train stream and the target stream (a validation-mode dataset
that returns each clip clean and augmented), length-matched by repetition;
the adaptation student from a stage-2 (or stage-3) checkpoint, the source
classifier head imported beside it and frozen, the frozen CLIP teacher and
its zero-shot similarities from the CLI's text artifacts; pseudo-label
selection (clip_matchORconf by default) with the masked committee
(``unite_torch.engines.selftrain``); per-epoch validation, the
student-vs-CLIP agreement table, best and latest checkpoints of the
combined student and classifier, auto-resume and a mid-epoch checkpoint on
preemption; an optional kNN probe at the initial validation; the final
multi-view test and its merge.

Run on the card: ``python -m unite_torch.train.run_stage3 --config
configs/stage3_config.yaml --dataset arid-hmdb --student_init
runs/stage2/.../checkpoint-best.pth --clip_text_features feats.npy``; call
``main(args, device="cpu")`` for the plain CPU path.
"""

from __future__ import annotations

import copy
import glob
import os
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from unite_torch.config import parse_with_config
from unite_torch.data.build import build_dataset
from unite_torch.data.loader import (cycle, device_prefetch, echo_batches,
                                     to_device)
from unite_torch.data.sharding import repetitions_to_match
from unite_torch.engines.selftrain import (compare_model_predictions,
                                           make_selftrain_eval_step,
                                           make_selftrain_step)
from unite_torch.models.clip_text import build_zero_shot_fn
from unite_torch.models.layers import Linear
from unite_torch.ops.eval_transforms import make_device_val_transform
from unite_torch.optim.factory import create_optimizer
from unite_torch.train import common
from unite_torch.train.args import stage3_parser
from unite_torch.train.run_stage1 import (build_student, build_teacher,
                                          load_clip_teacher, load_student)
from unite_torch.train.train_state import TrainState
from unite_torch.utils import checkpoint as ck
from unite_torch.utils import torch_import as ti
from unite_torch.utils.device import resolve_device
from unite_torch.utils.logging import maybe_tensorboard, maybe_wandb


def build_classifier(args, embed_dim: int, device=None) -> Linear:
    """The source classifier Linear(embed_dim, nb_classes), computing in
    fp32 (run_stage3.py:1191), on ``device`` (CUDA when None)."""
    if getattr(args, "src_classifier_type", "linear") != "linear":
        raise NotImplementedError(args.src_classifier_type)
    return Linear(embed_dim, args.nb_classes, dtype=torch.float32).to(
        resolve_device(device))


def combine(student: nn.Module, classifier: nn.Module) -> nn.ModuleDict:
    """One module over both, the JAX state's {"model", "classifier"} tree:
    parameter names ``model.encoder...`` and ``classifier.weight``."""
    return nn.ModuleDict({"model": student, "classifier": classifier})


def trainable_mask(args, model: nn.ModuleDict) -> Dict[str, bool]:
    """Parameter name -> trainable. The reference registers only the
    encoder with its optimizer, so the classifier is frozen: it keeps its
    gradient (it counts in the grad norm) and is not updated. The whole
    student trains, its CLIP decoders too unless --freeze_clip_decoders."""
    freeze_dec = getattr(args, "freeze_clip_decoders", False)

    def decide(name: str) -> bool:
        parts = name.split(".")
        if parts[0] == "classifier":
            return False
        return not (freeze_dec and parts[1] == "clip_decoder")

    return {name: decide(name) for name, _ in model.named_parameters()}


def build_optimizer(args, model: nn.ModuleDict, lr, weight_decay,
                    device=None):
    """AdamW over the combined module with the stage-3 mask: ``lr`` and
    ``weight_decay`` are per-step tables or constants. Returns (optimizer,
    groups)."""
    mask = trainable_mask(args, model)
    return create_optimizer(args.opt, lr, model, weight_decay=weight_decay,
                            betas=common.betas_for(args), eps=args.opt_eps,
                            trainable=mask.__getitem__, device=device)


def _head_from_file(path: str, model_key: str
                    ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(weight [out, in], bias) of the classifier head a file holds, or
    None. The port's own checkpoints (``epoch`` and ``optimizer`` beside
    ``model``): a stage-3 one's ``classifier.*``, a stage-2 one's
    ``head.*``. Published weights (JAX's ``_head_from_torch``): a stage-2
    ViT's ``head.*`` under ``model_key``, or a bare Linear's ``weight`` and
    ``bias``."""
    payload = ck.load_checkpoint(path)
    if isinstance(payload, dict) and {"model", "epoch", "optimizer"} <= set(
            payload):
        state, prefixes = payload["model"], ("classifier.", "head.")
    else:
        state, prefixes = ti.select_state(payload, model_key), ("head.", "")
    for prefix in prefixes:
        if f"{prefix}weight" in state:
            return (torch.as_tensor(state[f"{prefix}weight"]).float(),
                    torch.as_tensor(state[f"{prefix}bias"]).float())
    return None


def load_classifier_head(args, classifier: Linear) -> Optional[str]:
    """Load the source classifier's head (run_stage3.py:1196-1223) into
    ``classifier``; returns the file it came from, or None.

    The candidates in JAX's order: under --eval the first ``src_classifier*``
    file beside --student_init, then --src_classifier_init, then
    --student_init itself (a stage-2 checkpoint carries ``head.*``). A
    candidate without a head is passed over, and one whose head has
    another shape is skipped with a message, as the reference's non-strict
    load; with no candidate left the initialised head stays."""
    candidates = []
    if getattr(args, "eval", False) and args.student_init:
        candidates += sorted(glob.glob(os.path.join(
            os.path.dirname(args.student_init), "src_classifier*")))[:1]
    if args.src_classifier_init:
        candidates.append(args.src_classifier_init)
    if args.student_init:
        candidates.append(args.student_init)
    for path in candidates:
        got = _head_from_file(path, args.model_key)
        if got is None:
            continue
        weight, bias = got
        if weight.shape != classifier.weight.shape:
            print(f"Skipping classifier head from {path}: shape "
                  f"{tuple(weight.shape)} != {tuple(classifier.weight.shape)}")
            continue
        print(f"Loading source classifier head from {path}")
        with torch.no_grad():
            classifier.weight.copy_(weight)
            classifier.bias.copy_(bias)
        return path
    return None


def check_preconditions(args) -> None:
    """--pseudolabel_threshold's preconditions (run_stage3.py:1225-1229);
    the knob is otherwise dead, in the reference and here."""
    if args.pseudolabel_threshold > 0:
        if not args.ann_file_train_target:
            raise ValueError("pseudolabel_threshold requires a target stream")
        if not args.unmasked_classification:
            raise ValueError(
                "pseudolabel_threshold requires --unmasked_classification")
        print(f"Performing pseudolabeling with threshold: "
              f"{args.pseudolabel_threshold}")


def main(args, device=None):
    """Self-train on CUDA, or on ``device``."""
    start = time.time()
    common.check_mu_dtype(args)
    dev = common.setup_run(args, device)
    tb = maybe_tensorboard(args)
    wb = maybe_wandb(args)
    reader = common.reader_for(args)

    args.return_aug_for_val = True
    ds_source, args.nb_classes = build_dataset(
        "train", args, anno_path=args.ann_file_train, reader=reader)
    # the target stream feeds the train step (a clean clip and its
    # augmented copy), so it keeps the host eval transform even under
    # --device_eval_transforms
    tgt_args = copy.copy(args)
    tgt_args.device_eval_transforms = False
    ds_target, _ = build_dataset("validation", tgt_args,
                                 anno_path=args.ann_file_train_target,
                                 reader=reader)
    eval_reader = common.reader_for(args, for_eval=True)
    ds_val, _ = build_dataset("validation", args, anno_path=args.ann_file_val,
                              reader=eval_reader)
    ds_val.return_aug_for_val = False
    ds_test, _ = build_dataset("test", args, anno_path=args.ann_file_test,
                               reader=eval_reader)

    # stream length-matching (run_stage3.py:1096-1146): a shorter target
    # repeats by ceil(src/tgt); a target at least as long repeats the
    # source, by --train_repetitions when > 0, else ceil(tgt/src)
    src_reps = 1
    if len(ds_target) >= len(ds_source):
        src_reps = (getattr(args, "train_repetitions", 0)
                    or repetitions_to_match(len(ds_source), len(ds_target)))
    src_loader = common.make_loader(ds_source, args, args.batch_size,
                                    repetitions=src_reps)
    reps = repetitions_to_match(len(ds_target), len(ds_source))
    tgt_loader = common.make_loader(ds_target, args, args.batch_size,
                                    repetitions=reps, seed=args.seed + 7)
    val_loader = common.make_loader(ds_val, args, args.batch_size_val,
                                    shuffle=False, drop_last=False)
    echo_k = max(1, getattr(args, "data_echo", 1) or 1)
    niter_per_ep = len(src_loader) * echo_k

    student = build_student(args, dev)
    teacher = build_teacher(args, dev)
    load_student(args, student)
    # the classifier's width is the encoder's (run_stage3.py:1191 reads
    # head.in_features), read off its final norm
    classifier = build_classifier(args, student.encoder.norm.weight.shape[0],
                                  dev)
    load_classifier_head(args, classifier)
    load_clip_teacher(args, teacher)
    model = combine(student, classifier)
    nparams = sum(p.numel() for p in model.parameters())
    print(f"student+classifier params: {nparams / 1e6:.1f}M")
    cdtype = common.compute_dtype(args)
    cast_bf16 = cdtype == torch.bfloat16

    lr_tab, wd_tab, peak_lr = common.lr_tables(args, niter_per_ep,
                                               args.num_sample)
    print(f"peak lr {peak_lr:.2e}, steps/epoch {niter_per_ep}")
    # the whole encoder trains (the full-clip passes run every block), the
    # head stays as loaded (run_stage3.py:1264 never registers it)
    tx, opt_groups = build_optimizer(args, model, lr_tab, wd_tab, dev)
    state = TrainState(model, tx)

    payload = None
    start_epoch, skip0 = args.start_epoch, 0
    # --eval never auto-resumes (the reference's eval exit, :1280, comes
    # before its auto_resume, :1310): it tests the --student_init weights
    if (args.auto_resume and not args.eval) or args.resume:
        payload = (ck.load_checkpoint(args.resume) if args.resume
                   else ck.auto_load_model(args.output_dir))
        if payload is not None:
            # a mid-epoch checkpoint replays the rest of its epoch
            ck.restore_train_state(state, payload)
            start_epoch, skip0 = common.resume_position(payload)
            common.check_echo_resume(payload, echo_k)
    # fast-forward the cycled target stream past the host batches already
    # consumed (one a step, echo_k steps a batch)
    tgt_iter = cycle(tgt_loader,
                     (start_epoch * niter_per_ep + skip0) // echo_k)

    n_patch = (args.input_size // args.patch_size) ** 2 * (
        args.num_frames // args.tubelet_size)
    step_fn = make_selftrain_step(
        student, classifier, teacher, num_patches=n_patch,
        frames=args.num_frames // args.tubelet_size,
        mask_ratio=args.mask_ratio,
        selection_strategy=args.selection_strategy,
        clip_threshold=args.clip_threshold,
        conf_weighted_loss=args.conf_weighted_loss,
        train_masked=args.train_masked, use_cls_token=args.use_cls_token,
        class_loss_src_ratio_pl=(args.class_loss_src_ratio_pl
                                 if args.class_loss_src_ratio_pl > 0
                                 else 1.0),
        class_loss_tgt_ratio=args.class_loss_tgt_ratio,
        full_oracle=args.full_oracle, clip_grad=args.clip_grad,
        clip_input_resolution=args.clip_input_resolution,
        nb_classes=args.nb_classes, device=dev)
    eval_tfm = None
    if getattr(args, "device_eval_transforms", False):
        eval_tfm = make_device_val_transform(args.short_side_size,
                                             args.input_size)
    eval_fn = make_selftrain_eval_step(student, classifier,
                                       args.use_cls_token,
                                       input_transform=eval_tfm, device=dev)

    if args.eval:
        # the multi-view test and its merge only (the intent of the
        # reference's commented-out block, run_stage3.py:1280-1293), with
        # the classifier load_classifier_head found (:1212-1219)
        test_stats = common.run_final_test(state, eval_fn, ds_test, args,
                                           args.batch_size_val,
                                           args.output_dir, dev,
                                           cast_bf16=cast_bf16)
        common.save_epoch_stats(args, args.epochs, test_stats)
        if wb is not None and test_stats:
            wb.log({"test/acc1": test_stats["test_acc1"],
                    "test/acc5": test_stats["test_acc5"]})
        common.finish(start, wb)
        return

    check_preconditions(args)

    # the CLIP zero-shot teacher (utils.py:44-82): uniform similarities
    # would turn clip_matchORconf's match into "the student predicted
    # class 0", another rule, so missing text artifacts are an error
    # unless --allow_uniform_clip
    zero_shot_fn = None
    if args.selection_strategy in ("clip_only", "clip_matchORconf"):
        zero_shot_fn = build_zero_shot_fn(args, teacher)
        if zero_shot_fn is None and not args.allow_uniform_clip:
            raise RuntimeError(
                f"selection_strategy={args.selection_strategy!r} needs the "
                "CLIP zero-shot teacher: pass --clip_text_features (see "
                "tools/extract_clip.py --features-for) or --clip_text_init "
                "+ --clip_bpe_path, or override with --allow_uniform_clip "
                "for smoke tests (NOT a faithful approximation of the "
                "reference, run_stage3.py:556-593).")

    def preds_path(name):
        return (os.path.join(args.save_preds_path, name)
                if args.save_preds_path else None)

    # not on a resume: the weights are no longer the source-only model's,
    # and a preempted run must not repeat the pass
    if args.initial_validation and start_epoch == 0 and skip0 == 0:
        init_stats = common.run_validation(
            state, eval_fn, val_loader, args.batch_size_val, dev,
            header="Initial val", save_preds_path=preds_path("initial"),
            cast_bf16=cast_bf16)
        if wb is not None and init_stats:
            # the source-only model's accuracy (run_stage3.py:1298-1299)
            wb.log({"pre-adaptation/acc1": init_stats["acc1"],
                    "pre-adaptation/acc5": init_stats["acc5"]})
        if args.knn_eval:
            # source-train features classify the val videos; the gallery
            # is --ann_file_train_knn where the dataset mapping has one
            feats_fn = make_selftrain_eval_step(
                student, classifier, args.use_cls_token, with_feats=True,
                input_transform=eval_tfm, device=dev)
            if getattr(args, "ann_file_train_knn", None):
                ds_knn, _ = build_dataset(
                    "validation", args, anno_path=args.ann_file_train_knn,
                    reader=eval_reader)
                ds_knn.return_aug_for_val = False
            else:
                ds_knn = ds_source
            knn_src = common.make_loader(ds_knn, args, args.batch_size_val,
                                         shuffle=False, drop_last=False)
            common.run_knn_probe(state, feats_fn, knn_src, val_loader,
                                 args.batch_size_val, args.nb_classes, dev,
                                 k=args.knn_k,
                                 max_videos=args.knn_max_videos,
                                 cast_bf16=cast_bf16)

    def batches(epoch):
        src_loader.set_epoch(epoch)
        if epoch == start_epoch and skip0:
            src_loader.skip_next_batches(skip0 // echo_k)
        for clips_s, labels_s, _, _ in src_loader:
            clean_t, aug_t, labels_t, _ = next(tgt_iter)
            host = {"videos_s": common.as_video_array(clips_s),
                    "labels_s": np.asarray(labels_s, np.int32),
                    "videos_t": common.as_video_array(clean_t),
                    "videos_t_aug": common.as_video_array(aug_t),
                    "labels_t": np.asarray(labels_t, np.int32),
                    # the shipped reference's zero thresholds (:1303)
                    "classwise_thresholds": np.zeros(args.nb_classes,
                                                     np.float32)}
            if zero_shot_fn is None:
                host["clip_sim"] = np.full(
                    (len(host["videos_t"]), args.nb_classes),
                    1.0 / args.nb_classes, np.float32)
            out = to_device(host, dev)
            for k in ("videos_s", "videos_t", "videos_t_aug"):
                if cast_bf16 and out[k].is_floating_point():
                    out[k] = out[k].to(torch.bfloat16)
            if zero_shot_fn is not None:
                # from the clip already on the device, queued behind the
                # steps before it: no second copy, no read back
                out["clip_sim"] = zero_shot_fn(out["videos_t"])
            yield out

    gen = torch.Generator(device=dev)

    def wrapped_step(state, batch):
        gen.manual_seed(common.step_seed(args.seed + 1000, state.step))
        return step_fn(state, batch, gen)

    best_acc = common.resume_best_acc(payload)
    ckpt_io = ck.AsyncCheckpointer()  # epoch N+1 overlaps epoch N's write
    guard = common.PreemptionGuard(stop_after_steps=args.stop_after_steps)
    # checkpoints_enabled gates every write (run_stage3.py:1359; the YAML
    # ships false and stage3.sh turns it on)
    saving = bool(args.output_dir and args.checkpoints_enabled)
    for epoch in range(start_epoch, args.epochs):
        first = epoch == start_epoch
        arrays: Dict = {}
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
                epoch * niter_per_ep + (skip0 if first else 0), opt_groups),
            array_sink=arrays)
        done = (skip0 if first else 0) + guard.steps_done
        # a mid-epoch preemption skips validation and the table
        if common.preempted_mid_epoch(guard, ckpt_io, args, state, epoch,
                                      done, niter_per_ep, saving,
                                      extra={"best_acc": best_acc}):
            guard.uninstall()
            return
        epoch_stats = {f"train_{k}": v for k, v in stats.items()}
        epoch_stats["n_parameters"] = nparams  # run_stage3.py:1374-1380
        if "clip_preds_t" in arrays:
            # the student-vs-CLIP agreement table (run_stage3.py:789-817)
            cmp = compare_model_predictions(arrays["preds_t"],
                                            arrays["clip_preds_t"],
                                            arrays["labels_t"])
            print(f"compare_model_predictions [{epoch}]: " + " ".join(
                f"{k}={v}" for k, v in cmp.items()))
            epoch_stats.update({f"cmp_{k}": v for k, v in cmp.items()})
        val_stats = common.run_validation(
            state, eval_fn, val_loader, args.batch_size_val, dev,
            header=f"Val [{epoch}]", save_preds_path=preds_path(
                f"epoch{epoch}"), cast_bf16=cast_bf16)
        epoch_stats.update({f"val_{k}": v for k, v in val_stats.items()})
        if wb is not None:
            if val_stats:  # run_stage3.py:1350-1351
                wb.log({"val/acc1": val_stats["acc1"],
                        "val/acc5": val_stats["acc5"]})
            wb.log({"epoch": epoch})  # the epoch marker (:1384)
        if val_stats.get("acc1", -1) > best_acc:
            best_acc = val_stats["acc1"]
            if saving:
                ckpt_io.save_train_state(args.output_dir, epoch, state,
                                         args=vars(args),
                                         extra={"best_acc": best_acc},
                                         tags=("best",))
        if saving:
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
        # the final merged accuracies (run_stage3.py:1412-1413)
        wb.log({"test/acc1": test_stats["test_acc1"],
                "test/acc5": test_stats["test_acc5"]})
    common.finish(start, wb)


if __name__ == "__main__":
    parser = stage3_parser()
    parser.add_argument("--clip_init", default="", help="extracted OpenAI "
                        "CLIP visual .pth for the teacher")
    main(parse_with_config(parser, sys.argv[1:]))
