"""Argument schemas for the three stage entry points, copied from
unite_tpu/train/args.py so that a command line or YAML config means the same
to both packages (the namespaces are equal, defaults included).

argparse defines the schema; ``--config`` YAML overlays defaults;
``--dataset`` pulls annotation paths / nb_classes / student_init from
dataset_mappings.yaml; explicitly-passed CLI flags win
(unite_torch.config.parse_with_config). Flags that name the JAX package's
layouts (``--zero1``, ``--fsdp``, ``--tp``) are part of the schema and
select the port's layouts (``unite_torch.parallel.mesh.state_layout``).
Of the reference's distributed knobs, --dist_backend (NCCL on the card and
gloo on the CPU at its default), --dist_url and --world_size keep their
meaning under torchrun; the rest (deepspeed, ...) are accepted for
config-file compatibility and have no effect.
"""

from __future__ import annotations

import argparse

from unite_torch.config import str2bool


def _allow_bare_booleans(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Accept the reference's bare store_true spellings (``--flag``)
    alongside ``--flag true/false``: every str2bool option takes an
    optional value with const=True. The reference defines these as bare
    ``action='store_true'`` flags (e.g. ``--checkpoints_enabled``,
    run_stage1.py:59, passed bare by its stage1.sh:27) — without this,
    reusing a reference launcher line would be an argparse error."""
    for a in p._actions:
        if a.type is str2bool:
            a.nargs = "?"
            a.const = True
    return p


def common_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(desc, add_help=True)
    # config / dataset indirection
    p.add_argument("--config", default=None, help="YAML config overlay")
    p.add_argument("--dataset", default=None,
                   help="named domain shift from dataset_mappings.yaml")
    p.add_argument("--dataset_mappings", default="configs/dataset_mappings.yaml")
    # run basics
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--batch_size_val", type=int, default=32)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--output_dir", default="runs/exp")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--log_freq", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="tpu", help="accepted for config compat")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--worker_mode", default="thread",
                   choices=("thread", "process"),
                   help="loader workers: threads (native-bound pipelines) "
                        "or forked processes (the reference's DataLoader "
                        "model; for many-core hosts where pure-Python "
                        "__getitem__ work would serialize on the GIL)")
    p.add_argument("--pin_mem", type=str2bool, default=True)
    p.add_argument("--overwrite", default="allow",
                   choices=["allow", "error", "resume"],
                   help="non-interactive experiment-dir collision policy")
    # model geometry
    p.add_argument("--model", default="vit_base_patch16_224")
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--num_frames", type=int, default=8)
    p.add_argument("--num_segments", type=int, default=8)
    p.add_argument("--tubelet_size", type=int, default=1)
    p.add_argument("--drop_path", type=float, default=0.1)
    p.add_argument("--use_learnable_pos_emb", type=str2bool, default=False)
    p.add_argument("--use_checkpoint", type=str2bool, default=False,
                   help="rematerialize transformer blocks (the "
                        "reference's torch.utils.checkpoint)")
    p.add_argument("--checkpoint_num", type=int, default=-1,
                   help="remat only the first N blocks (reference "
                        "modeling_adaptation.py:158 'idx < checkpoint_num'); "
                        "-1 = all blocks. NOTE the reference DEFAULTS this "
                        "to 0, which silently disables --use_checkpoint")
    p.add_argument("--nb_classes", type=int, default=12)
    # data
    p.add_argument("--data_set", default="Kinetics_sparse")
    p.add_argument("--data_path", default="")
    p.add_argument("--ann_file_train", default="")
    p.add_argument("--ann_file_train_target", default="")
    p.add_argument("--ann_file_val", default="")
    p.add_argument("--ann_file_test", default="")
    p.add_argument("--split", default=",", help="annotation CSV delimiter")
    p.add_argument("--short_side_size", type=int, default=224)
    p.add_argument("--train_fraction", type=float, default=1.0)
    p.add_argument("--train_interpolation", default="bicubic")
    p.add_argument("--num_sample", type=int, default=1)
    p.add_argument("--sampling_rate", type=int, default=0)
    p.add_argument("--test_num_segment", type=int, default=5)
    p.add_argument("--test_num_crop", type=int, default=3)
    p.add_argument("--color_jitter", type=float, default=0.0)
    p.add_argument("--flip", type=str2bool, default=True)
    p.add_argument("--synthetic_data", type=str2bool, default=False,
                   help="use the synthetic video reader (tests/benchmarks)")
    p.add_argument("--device_normalize", type=str2bool, default=False,
                   help="ship uint8 clips and fuse /255+mean/std into the "
                        "jitted step (4x fewer H2D bytes; host-normalized "
                        "fp32 is the reference-parity default)")
    p.add_argument("--data_echo", type=int, default=1,
                   help="batch-level data echoing factor (arXiv:1907.05550):"
                        " repeat each device-resident train batch N times so"
                        " an input-bound host can feed the chip at line rate"
                        " (echoed steps cost no decode/H2D; step PRNG still"
                        " advances). 1 = off (reference parity)")
    p.add_argument("--device_eval_transforms", type=str2bool, default=False,
                   help="val/test input path: decode at short_side (native "
                        "decoder swscale), ship raw uint8 frames, and run "
                        "resize+center-crop+normalize fused inside the "
                        "jitted eval step (ops/eval_transforms.py) — host "
                        "eval cost drops to decode-only")
    # optimizer / schedules
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="model compute dtype. bfloat16 (default) is the "
                        "production path (the attention kernels, half the "
                        "device and H2D bytes); float32 exists for CPU "
                        "parity harnesses and numerics debugging")
    p.add_argument("--opt", default="adamw")
    p.add_argument("--mu_dtype", default=None,
                   choices=[None, "float32", "bfloat16"],
                   help="adam-family first-moment storage dtype (fp32 "
                        "state is the reference-parity default; bfloat16 "
                        "stores AdamW's first moment in bf16, optax's "
                        "scale_by_adam(mu_dtype=) order)")
    p.add_argument("--opt_eps", type=float, default=1e-8)
    # default None as in the reference (run_stage2.py:95): betas reach the
    # optimizer only when set (CLI or YAML — every shipped config sets
    # them); unset, each optimizer's own default applies (novograd: .95/.98)
    p.add_argument("--opt_betas", type=float, nargs="+", default=None)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--lr", type=float, default=1.5e-4)
    p.add_argument("--min_lr", type=float, default=1e-5)
    p.add_argument("--warmup_lr", type=float, default=1e-6)
    p.add_argument("--warmup_epochs", type=int, default=0)
    p.add_argument("--warmup_steps", type=int, default=-1)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--weight_decay_end", type=float, default=None)
    p.add_argument("--clip_grad", type=float, default=None)
    p.add_argument("--layer_decay", type=float, default=1.0)
    # checkpointing (parser default True as in the reference run_stageN
    # parsers :set_defaults(auto_resume=True); the stage-1/3 YAMLs override
    # to false, stage-2's to true — key-for-key with the reference configs)
    p.add_argument("--auto_resume", type=str2bool, default=True)
    p.add_argument("--no_auto_resume", action="store_false",
                   dest="auto_resume", help="reference-style complement")
    p.add_argument("--no_pin_mem", action="store_false", dest="pin_mem",
                   help="reference-style complement")
    p.add_argument("--resume", default="")
    p.add_argument("--save_ckpt_freq", type=int, default=1000)
    p.add_argument("--stop_after_steps", type=int, default=0,
                   help="fault injection: simulate SIGTERM preemption after "
                        "N steps of this run (0 = off); a mid-epoch "
                        "checkpoint is written and the run exits cleanly")
    p.add_argument("--model_key", default="model|module")
    p.add_argument("--student_init", default="")
    p.add_argument("--student_prefix", default="")
    p.add_argument("--prefix", default="")
    # eval
    p.add_argument("--val_interval", type=int, default=100)
    p.add_argument("--initial_validation", type=str2bool, default=False)
    p.add_argument("--test_best", type=str2bool, default=True)
    p.add_argument("--zero1", type=str2bool, default=False,
                   help="shard optimizer moments over the data axis "
                        "(ZeRO-1 layout; GSPMD inserts the collectives)")
    p.add_argument("--fsdp", type=str2bool, default=False,
                   help="ZeRO-3/FSDP layout: shard params, EMA and moments "
                        "over the data axis; params all-gather at use, "
                        "grads reduce-scatter (per-chip state memory "
                        "drops ~world-ways)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways: shard the per-block qkv/proj/"
                        "mlp kernels over a 'model' mesh axis (Megatron "
                        "column/row split; batch_size becomes per-REPLICA). "
                        "Beyond-parity option for wide students; must divide "
                        "the local device count and ideally num_heads")
    # (steps between host syncs is log_freq: the train loop is async-
    # dispatched and only reads scalars on log steps — common.py)
    # logging
    p.add_argument("--profile_dir", default="",
                   help="capture a torch.profiler trace of epoch-0 steps "
                        "2-7")
    p.add_argument("--disable_wandb", type=str2bool, default=True)
    p.add_argument("--wandb_group", default=None)
    p.add_argument("--wandb_entity", default=None,
                   help="wandb entity (run_stage1.py:642)")
    p.add_argument("--wandb_project", default=None,
                   help="wandb project (run_stage1.py:643)")
    # accepted-for-compat knobs of the reference's launcher (no effect)
    for flag, default in [
        ("--dist_backend", "ici"), ("--dist_url", "env://"),
        ("--world_size", 1), ("--local_rank", -1), ("--gpu", 0),
        ("--use_decord", True), ("--enable_deepspeed", False),
        ("--imagenet_default_mean_and_std", True), ("--crop_pct", None),
        ("--dist_on_itp", False),
    ]:
        kwargs = {"default": default}
        if isinstance(default, bool):
            kwargs["type"] = str2bool
        elif isinstance(default, int):
            kwargs["type"] = int
        p.add_argument(flag, **kwargs)
    return p


def stage1_parser() -> argparse.ArgumentParser:
    p = common_parser("UNITE stage 1: UMT masked pre-training")
    p.set_defaults(model="adaptation_umt_base_patch16_224", epochs=20,
                   lr=1.5e-4, warmup_epochs=0)
    p.add_argument("--mask_type", default="attention",
                   choices=["attention", "tube", "random", "none"])
    p.add_argument("--mask_ratio", type=float, default=0.8)
    p.add_argument("--clip_teacher", default="clip_b16")
    p.add_argument("--clip_input_resolution", type=int, default=224)
    p.add_argument("--clip_loss_type", default="l2",
                   choices=["l2", "mse", "smooth_l1", "l1"])
    p.add_argument("--clip_loss_data", default="target",
                   choices=["source", "target", "mixed"])
    p.add_argument("--clip_loss_ratio", type=float, default=1.0)
    p.add_argument("--clip_decoder_embed_dim", type=int, default=768)
    p.add_argument("--clip_output_dim", type=int, default=512)
    p.add_argument("--clip_norm_type", default="l2")
    p.add_argument("--clip_return_layers", type=int, nargs="+",
                   default=[6, 7, 8, 9, 10, 11])
    p.add_argument("--clip_return_interval", type=float, default=1.0)
    p.add_argument("--clip_student_return_interval", type=float, default=1.0)
    p.add_argument("--clip_return_attn", type=str2bool, default=True)
    p.add_argument("--clip_decoder_init", default="")
    p.add_argument("--freeze_clip_decoders", type=str2bool, default=False)
    p.add_argument("--no_freeze_clip_decoders", action="store_false",
                   dest="freeze_clip_decoders",
                   help="reference-style complement")
    p.add_argument("--use_cls_token", type=str2bool, default=False)
    p.add_argument("--use_mean_pooling", action="store_false",
                   dest="use_cls_token",
                   help="complement of use_cls_token (run_stage1.py:85)")
    p.add_argument("--train_repetitions", type=int, default=1,
                   help="source-stream sampler repetitions "
                        "(run_stage1.py:170,666; stage 3 default 0 = "
                        "auto-match the target stream, run_stage3.py:192)")
    p.add_argument("--umt_step", type=int, default=1,
                   help="dense-mode temporal stride (new_step) of the "
                        "pretrain dataset (run_stage1.py:183, mae.py:130); "
                        "no effect in sparse mode (num_segments != 1), "
                        "where the reference's skip_length=1 override "
                        "makes any umt_step > 1 yield empty clips")
    p.add_argument("--ann_file_train_knn", default=None,
                   help="gallery annotation split for the --knn_eval "
                        "representation probe (set by the *_sourceonly "
                        "dataset mappings; the reference parses this at "
                        "run_stage1.py:173 but never reads it — here it "
                        "feeds run_stage3's kNN probe gallery loader)")
    p.add_argument("--checkpoints_enabled", type=str2bool, default=True,
                   help="gate ALL checkpoint writes (run_stage1.py:880; "
                        "NOTE the reference YAMLs default this to false and "
                        "only stage1.sh re-enables it)")
    p.add_argument("--checkpoints_disabled", action="store_false",
                   dest="checkpoints_enabled",
                   help="reference-style complement")
    p.add_argument("--decoder_depth", type=int, default=4)
    p.add_argument("--clip_decoder_type", default="SA_Decoder")
    p.add_argument("--normlize_target", type=str2bool, default=True)
    return _allow_bare_booleans(p)


def stage2_parser() -> argparse.ArgumentParser:
    p = common_parser("UNITE stage 2: supervised fine-tuning")
    p.set_defaults(model="vit_base_patch16_224", epochs=50, lr=2.5e-5,
                   warmup_epochs=5, layer_decay=0.65, auto_resume=True)
    p.add_argument("--finetune", default="", help="init checkpoint")
    p.add_argument("--model_prefix", default="")
    p.add_argument("--delete_head", type=str2bool, default=True)
    p.add_argument("--no_delete_head", action="store_false",
                   dest="delete_head", help="reference-style complement")
    p.add_argument("--label_map_path", default="",
                   help="K710 head remap json for nb_classes 600/700 "
                        "(reference reads k710/label_mixto{n}.json, "
                        "run_stage2.py:376-382)")
    p.add_argument("--use_mean_pooling", type=str2bool, default=True)
    p.add_argument("--use_cls", action="store_false", dest="use_mean_pooling",
                   help="complement of use_mean_pooling (run_stage2.py:180)")
    p.add_argument("--lr_schedule", default="cosine",
                   choices=["constant", "cosine", "step"],
                   help="LR schedule family (run_stage2.py:107,651-667)")
    p.add_argument("--step_fraction", type=float, default=0.1,
                   help="multiplicative decay per step-schedule milestone")
    p.add_argument("--lr_step_epochs", type=int, nargs="+", default=None,
                   help="epochs at which the step schedule decays")
    p.add_argument("--auto_reload", type=str2bool, default=True,
                   help="auto-resume from output_dir's latest checkpoint — "
                        "the flag that actually gates stage-2 resume in the "
                        "reference (run_stage2.py:702); auto_resume is "
                        "accepted for config compat")
    p.add_argument("--no_auto_reload", action="store_false",
                   dest="auto_reload", help="reference-style complement")
    p.add_argument("--train_repetitions", type=int, default=1,
                   help="train-sampler repetitions (run_stage2.py:193,505)")
    p.add_argument("--distributed", type=str2bool, default=False,
                   help="accepted for config compat (run_stage2.py:256)")
    p.add_argument("--init_scale", type=float, default=0.001)
    p.add_argument("--head_type", default="linear", choices=["linear", "mlp"])
    p.add_argument("--head_hidden_dim", type=int, default=256)
    p.add_argument("--fc_drop_rate", type=float, default=0.0)
    p.add_argument("--drop", type=float, default=0.0)
    p.add_argument("--attn_drop_rate", type=float, default=0.0)
    # augmentation
    p.add_argument("--aa", default="rand-m7-n4-mstd0.5-inc1")
    p.add_argument("--smoothing", type=float, default=0.0)
    p.add_argument("--reprob", type=float, default=0.25)
    p.add_argument("--remode", default="pixel")
    p.add_argument("--recount", type=int, default=1)
    p.add_argument("--resplit", type=str2bool, default=False)
    # mixup
    p.add_argument("--mixup", type=float, default=0.0)
    p.add_argument("--cutmix", type=float, default=0.0)
    p.add_argument("--cutmix_minmax", type=float, nargs="+", default=None)
    # reference parser default 1.0 (run_stage2.py:160): a bare
    # `--mixup 0.8` must actually mix; the shipped YAMLs still set
    # 0.0 explicitly (key-for-key with the reference configs)
    p.add_argument("--mixup_prob", type=float, default=1.0)
    p.add_argument("--mixup_switch_prob", type=float, default=0.5)
    p.add_argument("--mixup_mode", default="batch")
    # ema / accumulation
    p.add_argument("--model_ema", type=str2bool, default=False)
    p.add_argument("--model_ema_decay", type=float, default=0.9999)
    p.add_argument("--model_ema_force_cpu", type=str2bool, default=False)
    p.add_argument("--update_freq", type=int, default=1)
    # freeze policies
    p.add_argument("--train_head_only", type=str2bool, default=False)
    p.add_argument("--frozen_layers", default="",
                   help="comma list of block ids to freeze, e.g. 0,1,2")
    p.add_argument("--freeze_patch_embedding", type=str2bool, default=False)
    p.add_argument("--lp_ft_epochs", type=int, default=0,
                   help="LP-FT: freeze blocks 0-8 + patch embed for the "
                        "first N epochs, then unfreeze (run_stage2.py:741)")
    # eval
    p.add_argument("--eval", type=str2bool, default=False)
    p.add_argument("--eval_freq", type=int, default=1)
    p.add_argument("--reset_train_dataset", type=str2bool, default=False,
                   help="recreate the train dataset every epoch (re-draws "
                        "the train_fraction subset; ref run_stage2.py:"
                        "440-453,754)")
    p.add_argument("--no_reset_train_dataset", action="store_false",
                   dest="reset_train_dataset",
                   help="reference-style complement")
    p.add_argument("--eval_data_path", default=None)
    p.add_argument("--dist_eval", type=str2bool, default=True)
    p.add_argument("--disable_eval_during_finetuning", type=str2bool,
                   default=False)
    p.add_argument("--save_ckpt", type=str2bool, default=True)
    p.add_argument("--no_save_ckpt", action="store_false", dest="save_ckpt",
                   help="reference-style complement")
    return _allow_bare_booleans(p)


def stage3_parser() -> argparse.ArgumentParser:
    p = stage1_parser()
    p.description = "UNITE stage 3: collaborative self-training"
    p.set_defaults(epochs=20, clip_return_layers=[6], warmup_epochs=0,
                   return_aug_for_val=True, train_repetitions=0)
    p.add_argument("--selection_strategy", default="clip_matchORconf")
    p.add_argument("--clip_threshold", type=float, default=0.1)
    p.add_argument("--conf_weighted_loss", type=str2bool, default=True)
    p.add_argument("--train_masked", type=str2bool, default=True)
    p.add_argument("--masking_type", default="clip_attention")
    p.add_argument("--class_loss_src_ratio_pl", type=float, default=1.0)
    p.add_argument("--class_loss_tgt_ratio", type=float, default=1.0)
    p.add_argument("--class_loss_src_ratio", type=float, default=1.0e-12,
                   help="accepted for config compat (the shipped reference "
                        "config sets 1.0e-12 to dodge the :353 '<= 0 -> "
                        "src_classifier = None' gate, which would crash its "
                        "own loop at :477 — latent defect). Irrelevant "
                        "either way: the reference never registers the "
                        "classifier with any optimizer (:1264), so the "
                        "head is ALWAYS frozen — matched here via the "
                        "trainable mask")
    p.add_argument("--eval", type=str2bool, default=False,
                   help="final multi-view test only, no training — "
                        "implements the intent of the reference's "
                        "commented-out block (run_stage3.py:1280-1293); "
                        "loads the classifier per :1212-1219 when "
                        "src_classifier_init is empty")
    # accepted-for-compat stage-3 research knobs that are dead in the
    # reference (parsed but never read, or read only by an assert/print):
    p.add_argument("--add_cons_constraint", type=str2bool, default=False,
                   help="dead in the reference (run_stage3.py:263; its only "
                        "use site :562 is commented out)")
    p.add_argument("--pseudolabel_threshold", type=float, default=0.0,
                   help="dead in the reference beyond an assert+print "
                        "(run_stage3.py:1225-1229); > 0 requires "
                        "unmasked_classification, enforced here too")
    p.add_argument("--unmasked_classification", type=str2bool, default=False,
                   help="dead in the reference (run_stage3.py:134; only "
                        "read by the :1228 assert)")
    p.add_argument("--target_only_classification", type=str2bool,
                   default=False,
                   help="dead in the reference (run_stage3.py:139; parsed, "
                        "never read)")
    p.add_argument("--full_oracle", type=str2bool, default=False)
    p.add_argument("--return_aug_for_val", type=str2bool, default=True)
    p.add_argument("--src_classifier_type", default="linear")
    p.add_argument("--src_classifier_init", default="",
                   help="stage-2 checkpoint providing the classifier head")
    p.add_argument("--aa", default="rand-m7-n4-mstd0.5-inc1")
    p.add_argument("--reprob", type=float, default=0.25)
    p.add_argument("--remode", default="pixel")
    p.add_argument("--recount", type=int, default=1)
    p.add_argument("--clip_zero_shot", type=str2bool, default=False,
                   help="enable the CLIP text zero-shot teacher (needs "
                        "extracted text weights)")
    p.add_argument("--clip_text_init", default="",
                   help="extracted CLIP text-tower .pth for zero-shot")
    p.add_argument("--clip_text_features", default="",
                   help="precomputed [C, D] text features .npy (skips the "
                        "tokenizer/text tower)")
    p.add_argument("--clip_bpe_path", default="",
                   help="CLIP bpe_simple_vocab merges file (.txt[.gz])")
    p.add_argument("--allow_uniform_clip", type=str2bool, default=False,
                   help="escape hatch for smoke tests ONLY: run clip_* "
                        "selection strategies with uniform zero-shot "
                        "similarities when no text artifacts are available "
                        "(this degrades clip_matchORconf to a biased rule; "
                        "see run_stage3 docs)")
    p.add_argument("--save_preds_path", default="",
                   help="dump per-video preds/labels/probs .npy from each "
                        "validation pass for offline analysis "
                        "(run_stage3.py:1297 save_preds_path intent)")
    p.add_argument("--knn_eval", type=str2bool, default=False,
                   help="run a cosine-kNN representation probe (utils/knn.py)"
                        " at initial validation: source-train features "
                        "classify target-val videos")
    p.add_argument("--knn_k", type=int, default=20)
    p.add_argument("--knn_max_videos", type=int, default=512)
    return _allow_bare_booleans(p)
