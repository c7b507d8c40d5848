"""Collate-time Mixup/CutMix on uint8 clips (``FastCollateMixup``), host
numpy (unite_tpu/data/collate_mixup.py).

Counterpart of the reference's datasets/mixup.py:241-336
(``FastCollateMixup`` with its ``rand_bbox``/``rand_bbox_minmax``/
``cutmix_bbox_and_lam`` helpers, :50-96): the mix happens on the host at
collate time, on uint8 arrays, so the step receives an already mixed uint8
batch and dense soft targets, and the host-to-card copy stays at one byte a
pixel. The reference never instantiates it (the in-step ``Mixup`` of
ops/mixup.py is what the entries use); it is here for the collate path's
surface. Its draws come from a ``np.random.Generator`` derived from the
seed and the batch's content, so a batch mixes the same way in any worker
and equals the JAX package's bit for bit.

Clips are channels-last ``[T, H, W, C]``; the cutmix box spans H and W on
every frame, as the reference's ``[..., yl:yh, xl:xh]`` slice of its
``[C, T, H, W]`` tensors does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def host_one_hot(labels: np.ndarray, num_classes: int, on_value: float,
                 off_value: float) -> np.ndarray:
    """Dense one-hot with smoothing values (mixup.py:37-40)."""
    out = np.full((len(labels), num_classes), off_value, np.float32)
    out[np.arange(len(labels)), np.asarray(labels, np.int64)] = on_value
    return out


def host_mixup_target(labels: Sequence[int], num_classes: int, lam,
                      smoothing: float = 0.0) -> np.ndarray:
    """lam * y + (1-lam) * y.flip(0), with label smoothing (mixup.py:42-48).

    ``lam`` is a scalar (batch mode) or an ``[B, 1]`` column (elem/pair/half
    modes, matching the reference's ``unsqueeze(1)``).
    """
    labels = np.asarray(labels, np.int64)
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    y1 = host_one_hot(labels, num_classes, on, off)
    y2 = host_one_hot(labels[::-1], num_classes, on, off)
    lam = np.asarray(lam, np.float32)
    return y1 * lam + y2 * (1.0 - lam)


def _rand_bbox(rng: np.random.Generator, h: int, w: int, lam: float):
    """Square box with area ratio ~= 1-lam, center uniform, border-clipped
    (mixup.py:50-72 with the default margin=0)."""
    ratio = float(np.sqrt(1.0 - lam))
    cut_h, cut_w = int(h * ratio), int(w * ratio)
    cy = int(rng.integers(0, h))
    cx = int(rng.integers(0, w))
    yl = int(np.clip(cy - cut_h // 2, 0, h))
    yh = int(np.clip(cy + cut_h // 2, 0, h))
    xl = int(np.clip(cx - cut_w // 2, 0, w))
    xh = int(np.clip(cx + cut_w // 2, 0, w))
    return yl, yh, xl, xh


def _rand_bbox_minmax(rng: np.random.Generator, h: int, w: int, minmax):
    """Rectangular box with each side a uniform fraction of the image in
    [minmax[0], minmax[1]), placed to fit entirely (mixup.py:74-96)."""
    cut_h = int(rng.integers(int(h * minmax[0]), int(h * minmax[1])))
    cut_w = int(rng.integers(int(w * minmax[0]), int(w * minmax[1])))
    yl = int(rng.integers(0, h - cut_h))
    xl = int(rng.integers(0, w - cut_w))
    return yl, yl + cut_h, xl, xl + cut_w


def _cutmix_box_and_lam(rng: np.random.Generator, h: int, w: int, lam: float,
                        ratio_minmax, correct_lam: bool):
    """Box + lambda correction (mixup.py:99-110)."""
    if ratio_minmax is not None:
        box = _rand_bbox_minmax(rng, h, w, ratio_minmax)
    else:
        box = _rand_bbox(rng, h, w, lam)
    if correct_lam or ratio_minmax is not None:
        yl, yh, xl, xh = box
        lam = 1.0 - (yh - yl) * (xh - xl) / float(h * w)
    return box, lam


class FastCollateMixup:
    """Mixup/cutmix applied while collating a list of (uint8 clip, label).

    Modes (mixup.py:320-336 dispatch): ``batch`` (one draw for the whole
    batch), ``elem`` (per-sample draw), ``pair`` (one draw per (i, B-1-i)
    pair, patches swapped both ways), ``half`` (per-sample draw but only the
    first B/2 mixed rows are emitted — the batch is halved).
    """

    def __init__(self, mixup_alpha: float = 1.0, cutmix_alpha: float = 0.0,
                 cutmix_minmax: Optional[Sequence[float]] = None,
                 prob: float = 1.0, switch_prob: float = 0.5,
                 mode: str = "batch", correct_lam: bool = True,
                 label_smoothing: float = 0.1, num_classes: int = 1000,
                 seed: int = 0):
        self.cutmix_minmax = cutmix_minmax
        if cutmix_minmax is not None:
            assert len(cutmix_minmax) == 2
            cutmix_alpha = 1.0  # forced on, lam from box area (mixup.py:131)
            correct_lam = True
        assert mixup_alpha > 0.0 or cutmix_alpha > 0.0 or \
            cutmix_minmax is not None, \
            "one of mixup_alpha, cutmix_alpha, cutmix_minmax must be active"
        self.mixup_alpha = mixup_alpha
        self.cutmix_alpha = cutmix_alpha
        self.prob = prob
        self.switch_prob = switch_prob
        self.mode = mode
        self.correct_lam = correct_lam
        self.label_smoothing = label_smoothing
        self.num_classes = num_classes
        self.seed = int(seed)

    def _batch_rng(self, clips, labels) -> np.random.Generator:
        """One Generator per BATCH, derived from (seed, batch content).

        Collation runs inside pool workers (threads or forked processes,
        data/loader.py): a mutable shared rng would interleave draws
        non-deterministically across threads, and forked workers would
        inherit identical copies (duplicate lam/box draws per worker,
        replayed every re-forked epoch). Clips are already deterministic
        functions of (seed, epoch, index), so a content-derived rng makes
        every mixup draw a pure function of the batch — order-independent,
        worker-independent, and bitwise-equal across pool modes."""
        import zlib

        h = 0
        for c, l in zip(clips, labels):
            c = np.ascontiguousarray(c)
            h = zlib.crc32(c[0].tobytes()[:8192], h)
            h = zlib.crc32(str(int(l)).encode(), h)
        return np.random.default_rng([self.seed, h])

    # -- parameter draws (mixup.py:136-176, rng threaded) ------------------

    def _params_per_elem(self, n: int, rng: np.random.Generator):
        lam = np.ones(n, np.float32)
        use_cutmix = np.zeros(n, bool)
        if self.mixup_alpha > 0.0 and self.cutmix_alpha > 0.0:
            use_cutmix = rng.random(n) < self.switch_prob
            lam_mix = np.where(
                use_cutmix,
                rng.beta(self.cutmix_alpha, self.cutmix_alpha, size=n),
                rng.beta(self.mixup_alpha, self.mixup_alpha, size=n))
        elif self.mixup_alpha > 0.0:
            lam_mix = rng.beta(self.mixup_alpha, self.mixup_alpha, size=n)
        else:
            use_cutmix = np.ones(n, bool)
            lam_mix = rng.beta(self.cutmix_alpha, self.cutmix_alpha, size=n)
        lam = np.where(rng.random(n) < self.prob,
                       lam_mix.astype(np.float32), lam)
        return lam, use_cutmix

    def _params_per_batch(self, rng: np.random.Generator):
        lam, use_cutmix = 1.0, False
        if rng.random() < self.prob:
            if self.mixup_alpha > 0.0 and self.cutmix_alpha > 0.0:
                use_cutmix = rng.random() < self.switch_prob
                a = self.cutmix_alpha if use_cutmix else self.mixup_alpha
                lam = float(rng.beta(a, a))
            elif self.mixup_alpha > 0.0:
                lam = float(rng.beta(self.mixup_alpha, self.mixup_alpha))
            else:
                use_cutmix = True
                lam = float(rng.beta(self.cutmix_alpha, self.cutmix_alpha))
        return lam, use_cutmix

    # -- mode bodies (mixup.py:247-318) ------------------------------------

    def _mix_elem(self, clips: List[np.ndarray], half: bool,
                  rng: np.random.Generator):
        b = len(clips)
        num_elem = b // 2 if half else b
        h, w = clips[0].shape[1:3]
        lam_batch, use_cutmix = self._params_per_elem(num_elem, rng)
        out = []
        for i in range(num_elem):
            j = b - i - 1
            lam = float(lam_batch[i])
            mixed = clips[i]
            if lam != 1.0:
                if use_cutmix[i]:
                    mixed = mixed.copy()
                    (yl, yh, xl, xh), lam = _cutmix_box_and_lam(
                        rng, h, w, lam, self.cutmix_minmax,
                        self.correct_lam)
                    mixed[:, yl:yh, xl:xh] = clips[j][:, yl:yh, xl:xh]
                    lam_batch[i] = lam
                else:
                    mixed = np.rint(
                        clips[i].astype(np.float32) * lam
                        + clips[j].astype(np.float32) * (1.0 - lam))
            out.append(np.asarray(mixed, np.uint8))
        if half:
            lam_batch = np.concatenate(
                [lam_batch, np.ones(num_elem, np.float32)])
        return out, lam_batch[:, None]

    def _mix_pair(self, clips: List[np.ndarray],
                  rng: np.random.Generator):
        b = len(clips)
        h, w = clips[0].shape[1:3]
        lam_batch, use_cutmix = self._params_per_elem(b // 2, rng)
        out = [c for c in clips]
        for i in range(b // 2):
            j = b - i - 1
            lam = float(lam_batch[i])
            if lam < 1.0:
                if use_cutmix[i]:
                    (yl, yh, xl, xh), lam = _cutmix_box_and_lam(
                        rng, h, w, lam, self.cutmix_minmax,
                        self.correct_lam)
                    ci, cj = clips[i].copy(), clips[j].copy()
                    patch = ci[:, yl:yh, xl:xh].copy()
                    ci[:, yl:yh, xl:xh] = cj[:, yl:yh, xl:xh]
                    cj[:, yl:yh, xl:xh] = patch
                    out[i], out[j] = ci, cj
                    lam_batch[i] = lam
                else:
                    fi = clips[i].astype(np.float32)
                    fj = clips[j].astype(np.float32)
                    out[i] = np.rint(fi * lam + fj * (1.0 - lam))
                    out[j] = np.rint(fj * lam + fi * (1.0 - lam))
        out = [np.asarray(c, np.uint8) for c in out]
        # even batch guaranteed by __call__'s assert (timm's FastCollate
        # also requires it; the in-step Mixup in ops/mixup.py handles odd)
        lam_batch = np.concatenate([lam_batch, lam_batch[::-1]])
        return out, lam_batch[:, None]

    def _mix_batch(self, clips: List[np.ndarray],
                   rng: np.random.Generator):
        b = len(clips)
        h, w = clips[0].shape[1:3]
        lam, use_cutmix = self._params_per_batch(rng)
        box = None
        if use_cutmix and lam != 1.0:
            box, lam = _cutmix_box_and_lam(
                rng, h, w, lam, self.cutmix_minmax, self.correct_lam)
        out = []
        for i in range(b):
            j = b - i - 1
            mixed = clips[i]
            if lam != 1.0:
                if use_cutmix:
                    mixed = mixed.copy()
                    yl, yh, xl, xh = box
                    mixed[:, yl:yh, xl:xh] = clips[j][:, yl:yh, xl:xh]
                else:
                    mixed = np.rint(
                        clips[i].astype(np.float32) * lam
                        + clips[j].astype(np.float32) * (1.0 - lam))
            out.append(np.asarray(mixed, np.uint8))
        return out, lam

    def __call__(self, items: List[Tuple]) -> Tuple[np.ndarray, np.ndarray]:
        """items: list of (uint8 clip [T, H, W, C], label, *rest) →
        (uint8 batch [B', T, H, W, C], fp32 soft targets [B', num_classes]);
        B' = B/2 in half mode, B otherwise (mixup.py:320-336)."""
        b = len(items)
        assert b % 2 == 0, "FastCollateMixup needs an even batch"
        clips = [np.asarray(it[0]) for it in items]
        labels = [int(it[1]) for it in items]
        rng = self._batch_rng(clips, labels)
        half = self.mode == "half"
        if self.mode in ("elem", "half"):
            mixed, lam = self._mix_elem(clips, half=half, rng=rng)
        elif self.mode == "pair":
            mixed, lam = self._mix_pair(clips, rng=rng)
        else:
            mixed, lam = self._mix_batch(clips, rng=rng)
        targets = host_mixup_target(
            labels, self.num_classes, lam, self.label_smoothing)
        out_b = b // 2 if half else b
        return np.stack(mixed[:out_b]), targets[:out_b]
