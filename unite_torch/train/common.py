"""Shared runtime for the stage entry points (unite_tpu/train/common.py).

The host-side frame around the steps: run setup (seeds, experiment dir,
device), loader construction, the per-step lr / wd tables, gradient
accumulation, resume arithmetic, preemption, the per-epoch train loop with
MetricLogger (and stage 3's per-sample arrays), padded validation (the last
short batch padded to the full batch with its last row, the padding dropped
on the host), the kNN feature probe and the multi-view test with its
merge. The port trains in one process on one
card: ``--zero1``, ``--fsdp``, ``--tp`` > 1 and multi-process launches
raise until scale-out lands (ROADMAP queue 1, item 7: slice E).
"""

from __future__ import annotations

import datetime
import os
import random
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from unite_torch.config import dump_config, log_stats, prepare_output_dir
from unite_torch.data.loader import DataLoader, to_device
from unite_torch.data.sharding import ShardedSampler
from unite_torch.data.video_reader import SyntheticVideoReader, default_reader
from unite_torch.engines.finetune import merge, write_preds_file
from unite_torch.utils.device import resolve_device
from unite_torch.utils.knn import knn_classifier
from unite_torch.utils.metrics import MetricLogger, compute_ece
from unite_torch.utils.schedules import (cosine_scheduler, scaled_lr,
                                         step_scheduler)


def check_single_card(args) -> None:
    """Refuse the scale-out layouts and launches the port does not have."""
    asked = [flag for flag, on in (
        ("--zero1", getattr(args, "zero1", False)),
        ("--fsdp", getattr(args, "fsdp", False)),
        (f"--tp {getattr(args, 'tp', 1)}", int(getattr(args, "tp", 1) or 1) > 1),
        ("a multi-process launch (WORLD_SIZE > 1)",
         int(os.environ.get("WORLD_SIZE", "1") or 1) > 1),
    ) if on]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: the port trains on one card in one process; "
            "data, ZeRO-1, FSDP and tensor parallelism come with scale-out "
            "(ROADMAP queue 1, item 7: slice E)")


def setup_run(args, device=None) -> torch.device:
    """Seeds, experiment dir, resolved-config dump (run_stage1 main preamble
    :604-650); returns the device (CUDA unless ``device`` says otherwise)."""
    check_single_card(args)
    dev = resolve_device(device)
    np.random.seed(args.seed)
    random.seed(args.seed)
    torch.manual_seed(args.seed)
    prepare_output_dir(args.output_dir, args.overwrite)
    dump_config(args, args.output_dir)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})")
    return dev


def reader_for(args, for_eval: bool = False):
    """Decode backend of a dataset: the synthetic reader under
    --synthetic_data (a fixed 256x320 raster), else ``default_reader``.
    ``for_eval`` with --device_eval_transforms resizes the short side to
    --short_side_size after the decode, so every val/test clip arrives at
    one raster; train datasets always get the unscaled reader (their
    augmentation works on the native raster, kinetics_sparse.py:218-281)."""
    scaled = for_eval and getattr(args, "device_eval_transforms", False)
    if getattr(args, "synthetic_data", False):
        return SyntheticVideoReader(256, 320)
    return default_reader(
        short_side=getattr(args, "short_side_size", 256) if scaled else None)


def compute_dtype(args) -> torch.dtype:
    """--compute_dtype: bf16 (the card's path, the default) or fp32 (CPU
    parity harnesses)."""
    name = getattr(args, "compute_dtype", "bfloat16") or "bfloat16"
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def check_mu_dtype(args) -> None:
    """--mu_dtype: the port's AdamW keeps fp32 moments (the reference-parity
    default); a bf16 first moment is not ported."""
    name = getattr(args, "mu_dtype", None)
    if name and name != "float32":
        raise NotImplementedError(
            f"--mu_dtype {name}: the port's AdamW keeps fp32 moments "
            "(ROADMAP queue 1, item 4)")


def betas_for(args):
    """--opt_betas -> create_optimizer betas: None when unset (each
    optimizer's own default then applies), else the explicit pair."""
    b = getattr(args, "opt_betas", None)
    return None if b is None else tuple(b)


def wrap_update_freq(tx, update_freq: int, clip_grad=None):
    """Gradient accumulation (--update_freq), ``optax.MultiSteps``
    semantics: k micro-batches averaged, the averaged gradient clipped once
    to ``clip_grad``, one optimizer step (the reference clips the
    accumulated gradient at the update boundary,
    engine_for_finetuning.py:109-126). The step itself then runs without a
    clip and logs each micro-batch's pre-clip norm."""
    if update_freq > 1:
        tx.every_k, tx.clip_grad = int(update_freq), clip_grad
    return tx


def make_loader(dataset, args, batch_size, shuffle=True, drop_last=True,
                repetitions=1, seed=None):
    """A loader over one shard: shuffled full batches for training,
    ``shuffle=False, drop_last=False`` for evaluation."""
    sampler = ShardedSampler(
        len(dataset), 1, 0, shuffle=shuffle,
        seed=args.seed if seed is None else seed, drop_last=False,
        repetitions=repetitions)
    return DataLoader(dataset, batch_size=int(batch_size), sampler=sampler,
                      num_workers=args.num_workers, drop_last=drop_last,
                      worker_mode=getattr(args, "worker_mode", "thread"))


def lr_tables(args, niter_per_ep: int, num_sample: int = 1,
              scale_rule: bool = True):
    """Per-step LR/WD tables. With ``scale_rule`` (stages 1 and 3,
    run_stage1.py:796-800) the lrs follow lr * batch * num_sample / 256 (one
    card, so the total batch is --batch_size); stage 2 takes --lr as it is
    (run_stage2.py:604). Families: cosine; constant, the step schedule
    without milestones; step, decaying by --step_fraction at
    --lr_step_epochs (run_stage2.py:656-667)."""
    if scale_rule:
        lr, min_lr, warmup_lr = (scaled_lr(x, args.batch_size, num_sample)
                                 for x in (args.lr, args.min_lr,
                                           args.warmup_lr))
    else:
        lr, min_lr, warmup_lr = args.lr, args.min_lr, args.warmup_lr
    family = getattr(args, "lr_schedule", "cosine")
    if family == "cosine":
        lr_tab = cosine_scheduler(
            lr, min_lr, args.epochs, niter_per_ep,
            warmup_epochs=args.warmup_epochs, start_warmup_value=warmup_lr,
            warmup_steps=args.warmup_steps)
    elif family in ("constant", "step"):
        steps = (getattr(args, "lr_step_epochs", None) if family == "step"
                 else None)
        if family == "step" and steps is None:
            raise ValueError("lr_schedule=step requires --lr_step_epochs")
        lr_tab = step_scheduler(
            lr, getattr(args, "step_fraction", 0.1), args.epochs,
            niter_per_ep, warmup_epochs=args.warmup_epochs,
            start_warmup_value=warmup_lr, warmup_steps=args.warmup_steps,
            steps=steps)
    else:
        raise NotImplementedError(
            f"lr_schedule {family}: the families are cosine, constant and "
            "step")
    wd_end = args.weight_decay_end
    if wd_end is None:
        wd_end = args.weight_decay
    wd_tab = cosine_scheduler(args.weight_decay, wd_end, args.epochs,
                              niter_per_ep)
    return lr_tab, wd_tab, lr


def make_sched(lr_tab, wd_tab, offset: int, groups: Dict, every_k: int = 1,
               phase: int = 0):
    """Schedule meters for ``train_one_epoch(sched=...)``: ``offset`` is the
    global optimizer-step index of this epoch's first batch (plus skipped
    steps on a mid-epoch resume); ``every_k`` batches make one optimizer
    step (--update_freq); ``phase`` is the batches already in the current
    accumulation window on a mid-epoch resume (skip0 % every_k), so that
    offset + (phase + step_i) // every_k is the reference's
    start_steps + data_iter_step // update_freq
    (engine_for_finetuning.py:71-74); ``groups`` the create_optimizer group
    table, whose lr scales give the reference's max/min per-group lr
    (run_stage1.py:460-467; frozen scale-0 groups excluded)."""
    scales = [g["lr_scale"] for g in groups.values()
              if g["lr_scale"] > 0] or [1.0]
    return {"lr_tab": np.asarray(lr_tab), "wd_tab": np.asarray(wd_tab),
            "offset": int(offset), "every_k": max(1, int(every_k)),
            "phase": int(phase),
            "max_scale": float(max(scales)), "min_scale": float(min(scales))}


def _sched_values(sched: Dict, step_i: int) -> Dict:
    g = sched["offset"] + (sched["phase"] + step_i) // sched["every_k"]
    base = float(sched["lr_tab"][min(g, len(sched["lr_tab"]) - 1)])
    return {"lr": base * sched["max_scale"],
            "min_lr": base * sched["min_scale"],
            "weight_decay": float(
                sched["wd_tab"][min(g, len(sched["wd_tab"]) - 1)])}


def check_echo_resume(payload, echo_k: int):
    """A mid-epoch checkpoint's ``epoch_step`` counts ECHOED steps; the
    resume arithmetic is exact only under the same --data_echo."""
    if payload is None:
        return
    extra = payload.get("extra", {}) or {}
    if int(extra.get("epoch_step", 0) or 0) <= 0:
        return
    saved = (payload.get("args") or {}).get("data_echo", 1) or 1
    if int(saved) != int(echo_k):
        raise ValueError(
            f"mid-epoch resume with --data_echo {echo_k}, but the "
            f"checkpoint was written under --data_echo {saved}: the "
            "epoch_step replay arithmetic would skip the wrong host "
            "batches. Resume with the original echo factor (or restart "
            "from the last epoch boundary).")


def resume_position(payload):
    """(start_epoch, epoch_step) from a restored checkpoint payload: a
    mid-epoch checkpoint (``extra.epoch_step`` > 0) replays the SAME epoch
    from the step it stopped at; an epoch-boundary one starts the next."""
    epoch_step = int((payload.get("extra") or {}).get("epoch_step", 0) or 0)
    if epoch_step > 0:
        return int(payload["epoch"]), epoch_step
    return int(payload["epoch"]) + 1, 0


def resume_best_acc(payload) -> float:
    """The best val acc1 a resumed checkpoint recorded in ``extra``, so the
    first validation after a resume cannot overwrite checkpoint-best with a
    worse model; -1 without one (a recorded 0.0 survives)."""
    if payload is None:
        return -1.0
    v = (payload.get("extra") or {}).get("best_acc")
    return -1.0 if v is None else float(v)


def step_seed(seed: int, step: int) -> int:
    """The seed of a train step's random draws (drop path, the attention
    mask): a function of (seed, global step), so a resumed run draws what an
    uninterrupted one does."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


class PreemptionGuard:
    """Preemption-safe early stop for the epoch loop.

    Installs a SIGTERM handler; when it fires, ``train_one_epoch`` finishes
    the step in flight and stops, and the entry writes a mid-epoch
    checkpoint carrying ``epoch_step`` so the next run resumes exactly where
    this one stopped. ``stop_after_steps``: fault injection (also the test
    hook) — behave as if SIGTERM arrived after N steps of this run."""

    def __init__(self, stop_after_steps: int = 0):
        import signal as _signal

        self.triggered = False
        self.steps_done = 0  # steps run by the last train_one_epoch call
        self._steps_seen = 0
        self._stop_after = int(stop_after_steps or 0)
        self._prev_handler = None
        try:
            self._prev_handler = _signal.signal(_signal.SIGTERM,
                                                self._on_signal)
        except ValueError:  # not the main thread
            pass

    def uninstall(self):
        """Restore the previous SIGTERM disposition: a handler left behind
        would be inherited by later forks (process-worker loaders) and
        swallow the terminate() their shutdown relies on."""
        import signal as _signal

        if self._prev_handler is not None:
            try:
                _signal.signal(_signal.SIGTERM, self._prev_handler)
            except ValueError:
                pass
            self._prev_handler = None

    def _on_signal(self, signum, frame):
        print(f"PreemptionGuard: caught signal {signum}; "
              "will checkpoint after the current step and exit", flush=True)
        self.triggered = True

    def step(self) -> bool:
        """Advance the per-run step count; True means stop now."""
        self._steps_seen += 1
        if self._stop_after and self._steps_seen >= self._stop_after:
            if not self.triggered:
                print(f"PreemptionGuard: stop_after_steps={self._stop_after} "
                      "reached; simulating preemption", flush=True)
            self.triggered = True
        return self.triggered


def preempted_mid_epoch(guard, ckpt_io, args, state, epoch: int, done: int,
                        niter_per_ep: int, saving: bool,
                        extra: Optional[Dict] = None) -> bool:
    """True = the run was preempted MID-epoch and must exit now; when
    ``saving``, a checkpoint carrying ``epoch_step=done`` (and ``extra``,
    such as stage 2's ``best_acc``) was written and waited on. An
    epoch-boundary preemption returns False: the caller runs its normal
    end-of-epoch saves, then checks ``guard.triggered``."""
    if not (guard.triggered and done < niter_per_ep):
        return False
    if saving:
        ckpt_io.save_train_state(args.output_dir, epoch, state,
                                 args=vars(args),
                                 extra={**(extra or {}), "epoch_step": done},
                                 tags=("latest",))
        ckpt_io.wait()
        print(f"Preempted at epoch {epoch} step {done}; "
              "checkpoint written, exiting")
    else:
        print(f"Preempted at epoch {epoch} step {done}; "
              "checkpointing disabled, exiting")
    return True


def train_one_epoch(state, step_fn: Callable, batches: Iterable, epoch: int,
                    log_freq: int = 10, profile_dir: Optional[str] = None,
                    tb_logger=None,
                    wandb_logger=None,
                    preempt_guard: Optional[PreemptionGuard] = None,
                    sched: Optional[Dict] = None,
                    array_sink: Optional[Dict] = None):
    """Host loop around the step (the engine's train_one_epoch frame).

    ``step_fn(state, batch)`` updates ``state`` in place and returns metric
    tensors. The 0-d ones are read on the host only on log steps (a read
    waits for the card), so the NaN check fires within ``log_freq`` steps.
    Logs a ``clips_per_sec_chip`` meter per window; ``profile_dir`` captures
    a torch.profiler trace of steps 2-7 of epoch 0. ``sched`` (see
    ``make_sched``) adds the lr/min_lr/weight_decay meters.

    ``array_sink``: a dict that collects the other metrics (stage 3's
    per-sample predictions and labels), kept on the device per step and
    moved to the host once, at the epoch's end: one numpy array a key, the
    steps' rows in order. Without a sink they are dropped."""
    logger = MetricLogger()
    header = f"Epoch [{epoch}]:"
    last_metrics = None
    step_i = 0
    window_t0 = time.time()
    window_clips = 0
    prof = None
    metrics = None
    for batch in logger.log_every(batches, log_freq, header):
        if profile_dir and step_i == 2 and epoch == 0:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
            prof = profile(activities=acts)
            prof.__enter__()
        metrics = step_fn(state, batch)
        if array_sink is not None:
            for k, v in metrics.items():
                if getattr(v, "ndim", 0) > 0:
                    # no read here: it would wait for the step
                    array_sink.setdefault(k, []).append(v)
        window_clips += _batch_clips(batch)
        if step_i % log_freq == 0:
            host = _scalar_metrics(metrics)
            if not np.isfinite(host["loss"]):
                raise FloatingPointError(
                    f"Loss is {host['loss']}, stopping training")
            dt = time.time() - window_t0
            if window_clips:
                host["clips_per_sec_chip"] = window_clips / max(dt, 1e-9)
            window_t0 = time.time()
            window_clips = 0
            if sched is not None:
                host.update(_sched_values(sched, step_i))
            logger.update(**host)
            if tb_logger is not None:
                # the global batch index, so epochs do not overwrite
                gstep = (sched["offset"] * sched["every_k"] + sched["phase"]
                         + step_i) if sched else step_i
                tb_logger.update(head="train", step=gstep, **host)
            if wandb_logger is not None:
                wandb_logger.log({f"train/{k}": v for k, v in host.items()})
            last_metrics = host
        if prof is not None and step_i == 7:
            _stop_trace(prof, profile_dir)
            prof = None
        step_i += 1
        if preempt_guard is not None and preempt_guard.step():
            break
    if prof is not None:  # the epoch ended before step 7
        _stop_trace(prof, profile_dir)
    # final read of the epoch's last step, unless it was a log step
    if step_i > 0 and (step_i - 1) % log_freq != 0:
        host = _scalar_metrics(metrics)
        if not np.isfinite(host["loss"]):
            raise FloatingPointError(
                f"Loss is {host['loss']}, stopping training")
        if sched is not None:
            host.update(_sched_values(sched, step_i - 1))
        logger.update(**host)
        last_metrics = host
    if preempt_guard is not None:
        preempt_guard.steps_done = step_i
    if array_sink:
        for k, chunks in array_sink.items():
            array_sink[k] = torch.cat(chunks).cpu().numpy()
    print("Averaged stats:", logger)
    stats = {k: m.global_avg for k, m in logger.meters.items()}
    return state, stats, last_metrics


def _stop_trace(prof, profile_dir: str) -> None:
    prof.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")


def _scalar_metrics(metrics) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()
            if getattr(v, "ndim", 0) == 0}


def as_video_array(x) -> np.ndarray:
    """Host batch dtype policy: uint8 stays uint8 (normalized on the card,
    1 byte a pixel over the host link), everything else ships fp32."""
    x = np.asarray(x)
    if x.dtype == np.uint8:
        return x
    return x.astype(np.float32, copy=False)


def _batch_clips(batch) -> int:
    """Clip count of a batch dict: every video tensor counts (stage 1 ships
    one [src; tgt] concat as 'videos')."""
    if not isinstance(batch, dict):
        return 0
    return sum(int(v.shape[0]) for k, v in batch.items()
               if k.startswith("videos"))


def _pad_batch(batch: Dict, size: int) -> Dict:
    """Pad every array of a host batch to ``size`` rows by repeating its
    last row, so every eval call runs at the full batch."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        n = v.shape[0]
        out[k] = (np.concatenate([v, np.repeat(v[-1:], size - n, axis=0)])
                  if n < size else v)
    return out


def _eval_input(clips, labels, batch_size: int, device,
                cast_bf16: bool) -> Dict:
    host = _pad_batch({"videos": as_video_array(clips),
                       "labels": np.asarray(labels, np.int32)}, batch_size)
    batch = to_device(host, device)
    if cast_bf16 and batch["videos"].is_floating_point():
        batch["videos"] = batch["videos"].to(torch.bfloat16)
    return batch


def _eval_batches(state, eval_step, loader, batch_size: int, device,
                  cast_bf16: bool = False, out_key: str = "probs"):
    """Pad each host batch to ``batch_size``, run ``eval_step`` on
    ``device`` and yield ``(out[out_key], labels, true_n, rest)`` for the
    batch's real rows only; ``rest`` is the batch's fields after the clips
    and labels (the test loader's video ids, chunk and split numbers).
    ``cast_bf16`` ships float videos as bf16, as the train batches of a bf16
    model are."""
    for batch in loader:
        clips, labels = batch[0], batch[1]
        true_n = np.asarray(clips).shape[0]
        out = eval_step(state, _eval_input(clips, labels, batch_size, device,
                                           cast_bf16))
        yield (out[out_key][:true_n].float().cpu().numpy(),
               np.asarray(labels)[:true_n], true_n, batch[2:])


def run_validation(state, eval_step, loader, batch_size: int, device,
                   header: str = "Val", save_preds_path: Optional[str] = None,
                   cast_bf16: bool = False) -> Dict:
    """Padded-batch validation (engine_for_finetuning.py:175-237): acc1,
    acc5, ECE and the mean cross-entropy over the real rows only (the loss
    recomputed on the host from their probabilities: the step's own mean
    would count the padding). ``save_preds_path`` keeps preds.npy,
    labels.npy and probs.npy."""
    all_probs, all_labels = [], []
    loss_sum = n_total = 0.0
    for probs, labels_np, true_n, _ in _eval_batches(
            state, eval_step, loader, batch_size, device,
            cast_bf16=cast_bf16):
        all_probs.append(probs)
        all_labels.append(labels_np)
        nll = -np.log(np.maximum(probs[np.arange(true_n), labels_np], 1e-30))
        loss_sum += float(nll.sum())
        n_total += true_n
    if n_total == 0:
        return {}
    probs = np.concatenate(all_probs)
    labels = np.concatenate(all_labels)
    pred = probs.argmax(-1)
    top1 = 100.0 * (pred == labels).mean()
    order = np.argsort(-probs, axis=-1)[:, :5]
    top5 = 100.0 * (order == labels[:, None]).any(-1).mean()
    ece = compute_ece(probs, labels)
    stats = {"acc1": float(top1), "acc5": float(top5), "ece": float(ece),
             "loss": loss_sum / n_total}
    print(f"{header}: acc1 {top1:.2f} acc5 {top5:.2f} ece {ece:.4f}")
    if save_preds_path:
        os.makedirs(save_preds_path, exist_ok=True)
        np.save(os.path.join(save_preds_path, "preds.npy"), pred)
        np.save(os.path.join(save_preds_path, "labels.npy"), labels)
        np.save(os.path.join(save_preds_path, "probs.npy"), probs)
        print(f"Saved predictions to {save_preds_path}")
    return stats


def collect_features(state, eval_step, loader, batch_size: int, device,
                     max_videos: int = 512, cast_bf16: bool = False):
    """Pooled encoder features [N, width] and labels [N] over a loader, from
    an eval step that returns ``feats``, stopping after the batch that
    reaches ``max_videos``; empty arrays for an empty loader."""
    feats, labels = [], []
    n = 0
    for f, lab, true_n, _ in _eval_batches(state, eval_step, loader,
                                           batch_size, device,
                                           cast_bf16=cast_bf16,
                                           out_key="feats"):
        feats.append(f)
        labels.append(lab)
        n += true_n
        if n >= max_videos:
            break
    if not feats:
        return np.zeros((0, 1), np.float32), np.zeros((0,), np.int64)
    return np.concatenate(feats), np.concatenate(labels)


def run_knn_probe(state, eval_step, train_loader, val_loader,
                  batch_size: int, num_classes: int, device, k: int = 20,
                  max_videos: int = 512, cast_bf16: bool = False) -> Dict:
    """The representation probe: the val features classified by cosine kNN
    against the train features (``utils/knn.py``, the DINO/UMT protocol).
    ``{"knn_top1", "knn_top5"}`` in percent, ``{}`` when a side is empty."""
    tr_f, tr_l = collect_features(state, eval_step, train_loader, batch_size,
                                  device, max_videos, cast_bf16)
    va_f, va_l = collect_features(state, eval_step, val_loader, batch_size,
                                  device, max_videos, cast_bf16)
    if tr_f.shape[0] == 0 or va_f.shape[0] == 0:
        return {}
    top1, top5 = knn_classifier(tr_f, tr_l, va_f, va_l, k=k,
                                num_classes=num_classes)
    print(f"kNN probe (k={k}, {tr_f.shape[0]} train / {va_f.shape[0]} val): "
          f"top1 {top1:.2f} top5 {top5:.2f}")
    return {"knn_top1": top1, "knn_top5": top5}


def run_final_test(state, eval_step, dataset, args, batch_size: int,
                   output_dir: str, device, cast_bf16: bool = False) -> Dict:
    """Multi-view test (engine_for_finetuning.py:241-351): every view's
    probabilities into ``{output_dir}/0.txt`` through ``write_preds_file``,
    then ``merge`` averages each video's views into top-1 / top-5."""
    loader = make_loader(dataset, args, batch_size, shuffle=False,
                         drop_last=False)
    path = os.path.join(output_dir, "0.txt")
    if os.path.exists(path):
        os.remove(path)
    for probs, labels, true_n, (vids, chunk_nb, split_nb) in _eval_batches(
            state, eval_step, loader, batch_size, device,
            cast_bf16=cast_bf16):
        write_preds_file(path, [
            (vids[i], probs[i], int(labels[i]), int(chunk_nb[i]),
             int(split_nb[i])) for i in range(true_n)])
    top1, top5 = merge(output_dir, 1)
    print(f"Final test: top1 {top1:.2f} top5 {top5:.2f}")
    return {"test_acc1": top1, "test_acc5": top5}


def save_epoch_stats(args, epoch: int, stats: Dict):
    log_stats({"epoch": epoch, **stats}, args.output_dir)


def finish(start_time: float, wandb_logger=None):
    if wandb_logger is not None:
        wandb_logger.finish()
    total = time.time() - start_time
    print(f"Training time {datetime.timedelta(seconds=int(total))}")
