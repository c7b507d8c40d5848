"""Checkpoint save / auto-resume with the reference's artifact semantics
(unite_tpu/utils/checkpoint.py, the reference's utils.py:689-776), on
``torch.save``.

Periodic ``checkpoint-{epoch}`` (the every-``save_ckpt_freq`` policy lives
in the entry scripts, as in run_stage1.py:880-889), rolling
``checkpoint-latest`` every epoch, ``checkpoint-best`` on val improvement;
auto-resume prefers latest, then best, then the highest-numbered periodic
checkpoint.

Payload: ``{model, optimizer, epoch, args, [model_ema], [extra]}`` with CPU
tensors. ``model`` is the model's ``state_dict``; ``optimizer`` holds the
AdamW step count, its schedule count, the moments by parameter name and,
under gradient accumulation, the running mean and its position in the
window (``accumulation``); ``extra`` carries the
global ``step`` and, for a checkpoint written on preemption, the batches
already consumed this epoch (``epoch_step``), from which a resumed run
replays the rest of the epoch bitwise. Writes are atomic (tmp + fsync +
rename), so a crash never corrupts an existing file.
"""

from __future__ import annotations

import glob
import io
import os
import re
import threading
from typing import Any, Dict, Optional

import torch

CKPT_PREFIX = "checkpoint"
CKPT_EXT = ".pth"


def _path(output_dir: str, tag) -> str:
    return os.path.join(output_dir, f"{CKPT_PREFIX}-{tag}{CKPT_EXT}")


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def _atomic_write(path: str, blob: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        # fsync before the rename: without it a crash shortly after
        # os.replace can leave the NEW name truncated, destroying the
        # previous good checkpoint the rename was meant to protect
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_checkpoint(output_dir: str, epoch: int, model_state,
                    optimizer=None, model_ema=None,
                    args: Optional[dict] = None,
                    extra: Optional[Dict[str, Any]] = None,
                    tags=("latest",)) -> None:
    """Serialize once, write under each tag ('latest', 'best', or epoch int)."""
    payload = {"model": _to_cpu(model_state), "optimizer": _to_cpu(optimizer),
               "epoch": int(epoch), "args": dict(args) if args else {}}
    if model_ema is not None:
        payload["model_ema"] = _to_cpu(model_ema)
    if extra:
        payload["extra"] = dict(extra)
    buf = io.BytesIO()
    torch.save(payload, buf)
    os.makedirs(output_dir, exist_ok=True)
    for tag in tags:
        _atomic_write(_path(output_dir, tag), buf.getvalue())


def find_resume_checkpoint(output_dir: str,
                           include_numbered: bool = True) -> Optional[str]:
    """latest > best > highest-numbered (reference utils.py:739-776 order).
    ``include_numbered`` False leaves the numbered checkpoints out: the
    reference gates only their glob on --auto_resume (utils.py:749)."""
    for tag in ("latest", "best"):
        p = _path(output_dir, tag)
        if os.path.exists(p):
            return p
    if not include_numbered:
        return None
    best_epoch, best_path = -1, None
    for p in glob.glob(_path(output_dir, "*")):
        m = re.search(rf"{CKPT_PREFIX}-(\d+){re.escape(CKPT_EXT)}$", p)
        if m and int(m.group(1)) > best_epoch:
            best_epoch, best_path = int(m.group(1)), p
    return best_path


def load_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=False)


def auto_load_model(output_dir: str, include_numbered: bool = True):
    """The restored payload dict, or None if there is nothing to resume."""
    path = find_resume_checkpoint(output_dir, include_numbered)
    if path is None:
        return None
    print(f"Auto resume checkpoint: {path}")
    return load_checkpoint(path)


def _snapshot(state) -> Dict[str, Any]:
    """Copies of the train state's tensors (on their device: a CUDA copy is
    queued on the stream, so later in-place updates cannot reach it): the
    model's state dict, the optimizer's counts, moments by parameter name
    and accumulated gradients, the EMA, and the global step."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    opt = state.optimizer
    optimizer = {"count": int(opt.count),
                 "schedule_count": int(opt.count)
                 + int(getattr(opt, "schedule_offset", 0)),
                 "moments": {names[id(p)]: {k: v.clone()
                                            for k, v in s.items()}
                             for p, s in opt.state.items()}}
    if opt.every_k > 1:
        optimizer["accumulation"] = {
            "mini_step": int(opt.mini_step),
            "grads": {names[id(p)]: g.clone() for p, g in opt.acc.items()}}
    return {
        "model": {k: v.detach().clone()
                  for k, v in state.model.state_dict().items()},
        "optimizer": optimizer,
        "model_ema": (None if state.ema_params is None else
                      {k: v.clone() for k, v in state.ema_params.items()}),
        "step": int(state.step),
    }


def _save_snapshot(output_dir: str, epoch: int, snap, args=None,
                   extra: Optional[Dict[str, Any]] = None,
                   tags=("latest",)) -> None:
    save_checkpoint(output_dir, epoch, snap["model"],
                    optimizer=snap["optimizer"], model_ema=snap["model_ema"],
                    args=args, extra={**(extra or {}), "step": snap["step"]},
                    tags=tags)


def save_train_state(output_dir: str, epoch: int, state, args=None,
                     extra: Optional[Dict[str, Any]] = None,
                     tags=("latest",)) -> None:
    """Full-state checkpoint of a TrainState: model, optimizer, global step
    and EMA (the reference saves {model, optimizer, epoch, scaler, args,
    model_ema}, utils.py:699-717; bf16 training has no scaler)."""
    _save_snapshot(output_dir, epoch, _snapshot(state), args, extra, tags)


class AsyncCheckpointer:
    """Non-blocking full-state saves.

    ``save_train_state`` copies the state on its device (cheap, queued on
    the stream), then a background thread fetches the copy to the host,
    serializes and writes it atomically, so the next epoch overlaps the
    write (the reference blocks its loop inside torch.save).

    One save in flight: a new save (or ``wait()``) joins the previous one
    first and RE-RAISES its failure — a checkpoint that silently failed to
    land would defeat auto-resume. The writer thread is non-daemon: if the
    entry dies on an exception, the interpreter still joins the write."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async checkpoint save failed") from err

    def save_train_state(self, output_dir: str, epoch: int, state, args=None,
                         extra: Optional[Dict[str, Any]] = None,
                         tags=("latest",)) -> None:
        self.wait()
        snap = _snapshot(state)

        def _work():
            try:
                _save_snapshot(output_dir, epoch, snap, args, extra, tags)
            except BaseException as e:  # surfaced by the next wait()
                self._err = e

        self._thread = threading.Thread(
            target=_work, name="unite-ckpt-writer", daemon=False)
        self._thread.start()


def restore_train_state(state, payload: Dict[str, Any],
                        sched_every_k: int = 1):
    """Restore a payload into a TrainState built with the same model and
    optimizer: parameters, the optimizer's moments and counts (so the
    per-step lr/wd tables and the step-seeded random draws continue where
    they left off), gradients accumulated mid-window, the global step, and
    the EMA when both sides keep one. If the saved moments do not name the
    model's parameters, only the schedule continues, at optimizer step
    ``step // sched_every_k`` (``state.step`` counts batches, the tables
    optimizer steps: stage 2 passes its --update_freq), with fresh moments
    (unite_tpu's fallback). Returns ``state``, updated in place."""
    from unite_torch.optim.factory import set_schedule_count

    state.model.load_state_dict(payload["model"])
    step = int((payload.get("extra") or {}).get("step", 0) or 0)
    opt = state.optimizer
    saved = payload.get("optimizer") or {}
    params = dict(state.model.named_parameters())
    moments = saved.get("moments", {})
    acc = saved.get("accumulation") or {}
    if set(moments) <= set(params) and set(acc.get("grads", {})) <= set(
            params):
        opt.state.clear()
        for name, mom in moments.items():
            p = params[name]
            opt.state[p] = {k: v.to(p.device, p.dtype) for k, v in mom.items()}
        opt.count = int(saved.get("count", step))
        set_schedule_count(opt, int(saved.get("schedule_count", opt.count)))
        opt.mini_step = int(acc.get("mini_step", 0))
        opt.acc = {params[n]: g.to(params[n].device)
                   for n, g in acc.get("grads", {}).items()}
    else:
        print("WARNING: optimizer state not restored (parameter names "
              "differ); continuing the schedule only")
        set_schedule_count(opt, step // max(1, int(sched_every_k)))
    if payload.get("model_ema") is not None and state.ema_params is not None:
        state.ema_params = {k: v.to(state.ema_params[k].device)
                            for k, v in payload["model_ema"].items()}
    state.step = step
    return state
