"""Shared runtime for the stage entry points (unite_tpu/train/common.py, the
parts stage 1 uses).

The host-side frame around the steps: run setup (seeds, experiment dir,
device), loader construction, the per-step lr / wd tables, resume
arithmetic, preemption, and the per-epoch train loop with MetricLogger.
The port trains in one process on one card: ``--zero1``, ``--fsdp``,
``--tp`` > 1 and multi-process launches raise until scale-out lands
(ROADMAP slice E).
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
from unite_torch.data.loader import DataLoader
from unite_torch.data.sharding import ShardedSampler
from unite_torch.data.video_reader import SyntheticVideoReader, default_reader
from unite_torch.utils.device import resolve_device
from unite_torch.utils.metrics import MetricLogger
from unite_torch.utils.schedules import cosine_scheduler, scaled_lr


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
            "(ROADMAP queue 1, slice E)")


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


def reader_for(args):
    """Decode backend: the synthetic reader under --synthetic_data (a fixed
    256x320 raster), else ``default_reader``."""
    if getattr(args, "synthetic_data", False):
        return SyntheticVideoReader(256, 320)
    return default_reader()


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
            f"--mu_dtype {name}: the port's AdamW keeps fp32 moments")


def betas_for(args):
    """--opt_betas -> create_optimizer betas: None when unset (each
    optimizer's own default then applies), else the explicit pair."""
    b = getattr(args, "opt_betas", None)
    return None if b is None else tuple(b)


def make_loader(dataset, args, batch_size, repetitions=1, seed=None):
    """A shuffled train loader over one shard, full batches only."""
    sampler = ShardedSampler(
        len(dataset), 1, 0, shuffle=True,
        seed=args.seed if seed is None else seed, drop_last=False,
        repetitions=repetitions)
    return DataLoader(dataset, batch_size=int(batch_size), sampler=sampler,
                      num_workers=args.num_workers, drop_last=True,
                      worker_mode=getattr(args, "worker_mode", "thread"))


def lr_tables(args, niter_per_ep: int, num_sample: int = 1):
    """Per-step LR/WD tables, with the linear scaling rule
    lr * batch * num_sample / 256 of stages 1 and 3 (run_stage1.py:796-800;
    one card, so the total batch is --batch_size). Stage 1 takes the cosine
    family; the others come with the stage-2 entry."""
    lr, min_lr, warmup_lr = (scaled_lr(x, args.batch_size, num_sample)
                             for x in (args.lr, args.min_lr, args.warmup_lr))
    family = getattr(args, "lr_schedule", "cosine")
    if family != "cosine":
        raise NotImplementedError(
            f"lr_schedule {family}: the port has the cosine schedule (the "
            "constant and step families come with the stage-2 entry)")
    lr_tab = cosine_scheduler(
        lr, min_lr, args.epochs, niter_per_ep,
        warmup_epochs=args.warmup_epochs, start_warmup_value=warmup_lr,
        warmup_steps=args.warmup_steps)
    wd_end = args.weight_decay_end
    if wd_end is None:
        wd_end = args.weight_decay
    wd_tab = cosine_scheduler(args.weight_decay, wd_end, args.epochs,
                              niter_per_ep)
    return lr_tab, wd_tab, lr


def make_sched(lr_tab, wd_tab, offset: int, groups: Dict):
    """Schedule meters for ``train_one_epoch(sched=...)``: ``offset`` is the
    global optimizer-step index of this epoch's first batch (plus skipped
    steps on a mid-epoch resume); ``groups`` the create_optimizer group
    table, whose lr scales give the reference's max/min per-group lr
    (run_stage1.py:460-467; frozen scale-0 groups excluded)."""
    scales = [g["lr_scale"] for g in groups.values()
              if g["lr_scale"] > 0] or [1.0]
    return {"lr_tab": np.asarray(lr_tab), "wd_tab": np.asarray(wd_tab),
            "offset": int(offset),
            "max_scale": float(max(scales)), "min_scale": float(min(scales))}


def _sched_values(sched: Dict, step_i: int) -> Dict:
    g = sched["offset"] + step_i
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
                        niter_per_ep: int, saving: bool) -> bool:
    """True = the run was preempted MID-epoch and must exit now; when
    ``saving``, a checkpoint carrying ``epoch_step=done`` was written (and
    waited on). An epoch-boundary preemption returns False: the caller runs
    its normal end-of-epoch saves, then checks ``guard.triggered``."""
    if not (guard.triggered and done < niter_per_ep):
        return False
    if saving:
        ckpt_io.save_train_state(args.output_dir, epoch, state,
                                 args=vars(args),
                                 extra={"epoch_step": done},
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
                    sched: Optional[Dict] = None):
    """Host loop around the step (the engine's train_one_epoch frame).

    ``step_fn(state, batch)`` updates ``state`` in place and returns 0-d
    metric tensors. They are read on the host only on log steps (a read
    waits for the card), so the NaN check fires within ``log_freq`` steps.
    Logs a ``clips_per_sec_chip`` meter per window; ``profile_dir`` captures
    a torch.profiler trace of steps 2-7 of epoch 0. ``sched`` (see
    ``make_sched``) adds the lr/min_lr/weight_decay meters."""
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
                gstep = sched["offset"] + step_i if sched else step_i
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


def save_epoch_stats(args, epoch: int, stats: Dict):
    log_stats({"epoch": epoch, **stats}, args.output_dir)


def finish(start_time: float, wandb_logger=None):
    if wandb_logger is not None:
        wandb_logger.finish()
    total = time.time() - start_time
    print(f"Training time {datetime.timedelta(seconds=int(total))}")
