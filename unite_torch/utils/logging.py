"""Host-side observability sinks (unite_tpu/utils/logging.py): tensorboardX
and wandb are imported only when their flags ask for them.

Counterpart of the reference's three sinks (SURVEY §5): stdout MetricLogger
(utils/metrics.py), TensorBoard (this module — reference utils.py:426-447
TensorboardLogger with explicit step management), and the ``log.txt`` jsonl
(config.log_stats). The reference's fourth sink — wandb
(run_stage1.py:634-646) — is covered by ``WandbLogger`` below: it uses the
real wandb package when installed and ``--disable_wandb false``, and
otherwise mirrors the same ``log(dict)`` records to a local
``wandb.jsonl`` (zero-egress environments get the full metric stream
on disk, uploadable later with ``wandb sync``-style tooling).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class TensorboardLogger:
    """Explicit-step scalar writer (utils.py:426-447 API parity)."""

    def __init__(self, log_dir: str):
        from tensorboardX import SummaryWriter

        self.writer = SummaryWriter(logdir=log_dir)
        self.step = 0

    def set_step(self, step: Optional[int] = None):
        if step is not None:
            self.step = step
        else:
            self.step += 1

    def update(self, head: str = "scalar", step: Optional[int] = None, **kwargs):
        for k, v in kwargs.items():
            if v is None:
                continue
            self.writer.add_scalar(
                f"{head}/{k}", float(v), self.step if step is None else step
            )

    def flush(self):
        self.writer.flush()

    def close(self):
        self.writer.close()


class WandbLogger:
    """wandb-API-compatible sink (reference run_stage1.py:634-646 surface).

    Delegates to the real ``wandb`` package when available; otherwise
    appends each ``log()`` dict as one jsonl record to
    ``<output_dir>/wandb.jsonl`` with a wall-clock timestamp and a
    monotonically increasing step."""

    def __init__(self, args):
        self._wandb = None
        self._fh = None
        self._step = 0
        try:
            import wandb  # noqa: F401 (optional)

            if not hasattr(wandb, "__version__"):
                raise ImportError("wandb stub in sys.modules")
            wandb.init(
                entity=getattr(args, "wandb_entity", None),
                project=getattr(args, "wandb_project", None) or "unite_torch",
                group=getattr(args, "wandb_group", None),
                config=vars(args), dir=args.output_dir,
            )
            # only after init succeeds: a package present but unable to
            # init (no API key / zero-egress) must fall to the mirror
            self._wandb = wandb
        except Exception:
            self._wandb = None
            path = os.path.join(args.output_dir, "wandb.jsonl")
            self._fh = open(path, "a", encoding="utf-8")
            print(f"wandb unavailable; mirroring wandb.log to {path}")

    def log(self, metrics: dict, step: Optional[int] = None):
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
            return
        rec = {"_step": self._step if step is None else step,
               "_time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                # keep the mirror alive for non-scalars: lists stay JSON,
                # anything else (ndarray, objects) records as str — a
                # raw ndarray would make json.dumps raise and kill the
                # entry mid-epoch in exactly the zero-egress environment
                # this fallback exists for
                if isinstance(v, (str, bool, int, list, type(None))):
                    rec[k] = v
                elif hasattr(v, "tolist"):
                    try:
                        rec[k] = v.tolist()
                    except Exception:
                        rec[k] = str(v)
                else:
                    rec[k] = str(v)
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        self._step = rec["_step"] + 1

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
        elif self._fh is not None:
            self._fh.close()


def maybe_wandb(args) -> Optional[WandbLogger]:
    """Disabled by --disable_wandb or 'scrap' in output_dir
    (run_stage1.py:634-637 policy); the port runs one process, rank 0."""
    if getattr(args, "disable_wandb", True):
        return None
    if "scrap" in (args.output_dir or ""):
        return None
    return WandbLogger(args)


def maybe_tensorboard(args) -> Optional[TensorboardLogger]:
    log_dir = getattr(args, "log_dir", None)
    if not log_dir:
        return None
    try:
        return TensorboardLogger(log_dir)
    except ImportError:  # pragma: no cover
        print("tensorboardX unavailable; TensorBoard logging disabled")
        return None
