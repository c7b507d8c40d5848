"""Mixup / CutMix on the card, producing soft targets
(unite_tpu/ops/mixup.py; the reference's datasets/mixup.py:37-240).

Videos are normalized [B, T, H, W, C]; the CutMix box spans H and W on
every frame. As in the JAX package, the box is a boolean coordinate mask
and every choice is a ``where``, so a step keeps its shapes whatever is
drawn.

The draws are apart from their application: ``Mixup._sample_lam`` (lam,
use_cutmix, use_mix) and ``Mixup._box`` (the box mask and its corrected
lam) draw from an explicit ``torch.Generator`` on the videos' device, and
``Mixup.apply`` mixes with given draws, in JAX's arithmetic. A test can
then give the port's application the JAX package's draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# gamma candidates drawn per value in ``_gamma``: Marsaglia-Tsang accepts
# one with probability > 0.95, so all of them fail with probability < 1e-40
_GAMMA_TRIES = 32


def one_hot(labels, num_classes: int, on_value: float, off_value: float):
    return (F.one_hot(labels.long(), num_classes).float()
            * (on_value - off_value) + off_value)


def mixup_target(labels, num_classes: int, lam, smoothing: float = 0.0):
    """lam * y + (1 - lam) * y.flip(0), with label smoothing; ``lam`` a
    scalar or one value a row (mixup.py:42-49)."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    y1 = one_hot(labels, num_classes, on, off)
    y2 = one_hot(labels.flip(0), num_classes, on, off)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=y1.device)
    lam = lam.reshape(lam.shape + (1,) * (y1.ndim - lam.ndim))
    return y1 * lam + y2 * (1.0 - lam)


def _gamma(alpha: float, shape, generator, device) -> torch.Tensor:
    """Gamma(alpha, 1) draws from ``generator`` (torch's own gamma sampler
    takes no generator): Marsaglia and Tsang's method on alpha + 1 for
    alpha < 1, boosted by u ** (1 / alpha), over a fixed number of
    candidates, so nothing waits on the card."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = (9.0 * d) ** -0.5
    full = (_GAMMA_TRIES,) + tuple(shape)
    x = torch.randn(full, generator=generator, device=device)
    u = torch.rand(full, generator=generator, device=device)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                    + d * torch.log(v.clamp_min(1e-30)))
    first = ok.float().argmax(0, keepdim=True)
    g = d * v.gather(0, first)[0]
    if alpha < 1.0:
        boost = torch.rand(tuple(shape), generator=generator, device=device)
        g = g * boost ** (1.0 / alpha)
    return g


def _beta(alpha: float, shape, generator, device) -> torch.Tensor:
    """Beta(alpha, alpha) from two gammas."""
    x = _gamma(alpha, shape, generator, device)
    y = _gamma(alpha, shape, generator, device)
    return x / (x + y).clamp_min(1e-30)


def _box_mask(h: int, w: int, y1, y2, x1, x2):
    """Boolean [*count, H, W] mask of rows [y1, y2) and columns [x1, x2)."""
    rows = torch.arange(h, device=y1.device)
    cols = torch.arange(w, device=x1.device)
    rmask = (rows >= y1[..., None]) & (rows < y2[..., None])
    cmask = (cols >= x1[..., None]) & (cols < x2[..., None])
    return rmask[..., :, None] & cmask[..., None, :]


def _uniform_int(generator, count, low, high, device):
    """Integers uniform in [low, high), the bounds tensors or ints."""
    u = torch.rand(count, generator=generator, device=device)
    low = torch.as_tensor(low, device=device)
    high = torch.as_tensor(high, device=device)
    return low + (u * (high - low)).long()


class Mixup:
    """Batch / elem / pair Mixup and CutMix with soft targets (the surface
    of mixup.py:110-240, as unite_tpu's ``Mixup``)."""

    def __init__(self, mixup_alpha=1.0, cutmix_alpha=0.0, cutmix_minmax=None,
                 prob=1.0, switch_prob=0.5, mode="batch", correct_lam=True,
                 label_smoothing=0.1, num_classes=1000):
        self.cutmix_minmax = cutmix_minmax
        if cutmix_minmax is not None:
            # ratio-bounded boxes force cutmix on and corrected lam
            # (mixup.py:131-134)
            assert len(cutmix_minmax) == 2
            cutmix_alpha = 1.0
            correct_lam = True
        if mixup_alpha <= 0.0 and cutmix_alpha <= 0.0:
            raise ValueError(
                "One of mixup_alpha > 0., cutmix_alpha > 0., cutmix_minmax "
                "not None should be true (reference mixup.py:157-158)")
        if mode not in ("batch", "elem", "pair"):
            raise ValueError(f"mixup mode {mode!r}")
        self.mixup_alpha = mixup_alpha
        self.cutmix_alpha = cutmix_alpha
        self.prob = prob
        self.switch_prob = switch_prob
        self.mode = mode
        self.correct_lam = correct_lam
        self.label_smoothing = label_smoothing
        self.num_classes = num_classes

    # -- the draws ----------------------------------------------------------

    def _sample_lam(self, generator, shape=(), device=None):
        """(lam, use_cutmix, use_mix) of ``shape``, honoring prob and
        switch_prob (mixup.py:152-176)."""
        use_mix = torch.rand(shape, generator=generator, device=device) \
            < self.prob
        if self.mixup_alpha > 0.0 and self.cutmix_alpha > 0.0:
            use_cutmix = torch.rand(shape, generator=generator,
                                    device=device) < self.switch_prob
        else:
            use_cutmix = torch.full(shape, self.cutmix_alpha > 0.0,
                                    device=device)
        lam_mix = _beta(max(self.mixup_alpha, 1e-8), shape, generator, device)
        lam_cut = _beta(max(self.cutmix_alpha, 1e-8), shape, generator,
                        device)
        lam = torch.where(use_cutmix, lam_cut, lam_mix)
        lam = torch.where(use_mix, lam, torch.ones_like(lam))
        return lam.float(), use_cutmix, use_mix

    def _box(self, generator, h: int, w: int, lam, count=(), device=None):
        """(box mask [*count, H, W], corrected lam): rand_bbox's square box
        of area ~ 1 - lam, centered uniformly and clipped at the borders
        (mixup.py:50-63), or with ``cutmix_minmax`` a box whose sides are
        uniform fractions of the image, placed to fit (mixup.py:66-96)."""
        if self.cutmix_minmax is not None:
            lo, hi = self.cutmix_minmax
            cut_h = _uniform_int(generator, count, int(h * lo), int(h * hi),
                                 device)
            cut_w = _uniform_int(generator, count, int(w * lo), int(w * hi),
                                 device)
            y1 = _uniform_int(generator, count, 0,
                              torch.clamp(h - cut_h, min=1), device)
            x1 = _uniform_int(generator, count, 0,
                              torch.clamp(w - cut_w, min=1), device)
            mask = _box_mask(h, w, y1, y1 + cut_h, x1, x1 + cut_w)
            return mask, 1.0 - (cut_h * cut_w).float() / float(h * w)
        cy = torch.randint(0, h, count, generator=generator, device=device)
        cx = torch.randint(0, w, count, generator=generator, device=device)
        return self.box_from(h, w, lam, cy, cx)

    @staticmethod
    def box_from(h: int, w: int, lam, cy, cx):
        """rand_bbox's box for a drawn center: half-extents from
        sqrt(1 - lam), clipped at the borders; (mask, corrected lam)."""
        ratio = torch.sqrt(1.0 - torch.as_tensor(lam, dtype=torch.float32))
        cut_h = (h * ratio).int()
        cut_w = (w * ratio).int()
        y1 = torch.clamp(cy - cut_h // 2, 0, h)
        y2 = torch.clamp(cy + cut_h // 2, 0, h)
        x1 = torch.clamp(cx - cut_w // 2, 0, w)
        x2 = torch.clamp(cx + cut_w // 2, 0, w)
        area = ((y2 - y1) * (x2 - x1)).float()
        return _box_mask(h, w, y1, y2, x1, x2), 1.0 - area / float(h * w)

    # -- the application ------------------------------------------------------

    def apply(self, x, labels, lam, use_cutmix, use_mix, box, lam_cut
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mix ``x`` [B, T, H, W, C] with the given draws (as ``_sample_lam``
        and ``_box`` return them: scalars in batch mode, [B] in elem mode,
        [B // 2] in pair mode) -> (mixed x in x's dtype, soft targets)."""
        b = x.shape[0]
        if self.mode == "pair":
            # one draw per pair (i, B-1-i), mirrored onto the partner; an
            # odd batch leaves its middle sample unmixed (mixup.py:178-200)
            def mirror(v, mid):
                parts = [v]
                if b % 2:
                    parts.append(torch.full((1,) + tuple(v.shape[1:]), mid,
                                            dtype=v.dtype, device=v.device))
                parts.append(v.flip(0))
                return torch.cat(parts)

            lam, use_cutmix = mirror(lam, 1.0), mirror(use_cutmix, False)
            use_mix, box = mirror(use_mix, False), mirror(box, False)
            lam_cut = mirror(lam_cut, 1.0)
        lam_cut_final = (torch.where(use_cutmix, lam_cut, lam)
                         if self.correct_lam else lam)
        x_flip = x.flip(0)
        if self.mode == "batch":
            lam_b, box_b, cut_b, mix_b = lam, box[None, None, :, :, None], \
                use_cutmix, use_mix
        else:
            lam_b = lam.reshape(b, 1, 1, 1, 1)
            box_b = box[:, None, :, :, None]
            cut_b = use_cutmix.reshape(b, 1, 1, 1, 1)
            mix_b = use_mix.reshape(b, 1, 1, 1, 1)
        mixed_mix = x.float() * lam_b + x_flip.float() * (1.0 - lam_b)
        mixed_cut = torch.where(box_b, x_flip, x)
        mixed = torch.where(cut_b, mixed_cut.float(), mixed_mix)
        lam_final = torch.where(use_cutmix, lam_cut_final, lam)
        # the prob gate (mixup.py:152-155): samples it excluded stay as
        # they were; the minmax box is drawn independently of lam, so the
        # gate masks it explicitly
        mixed = torch.where(mix_b, mixed, x.float())
        lam_final = torch.where(use_mix, lam_final, torch.ones_like(lam_final))
        targets = mixup_target(labels, self.num_classes, lam_final,
                               self.label_smoothing)
        return mixed.to(x.dtype), targets

    def __call__(self, x, labels, generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, H, W, C], int labels [B] -> (mixed x, soft targets),
        drawn from ``generator``."""
        b, _, h, w, _ = x.shape
        count = {"batch": (), "elem": (b,), "pair": (b // 2,)}[self.mode]
        lam, use_cutmix, use_mix = self._sample_lam(generator, count,
                                                    x.device)
        box, lam_cut = self._box(generator, h, w, lam, count, x.device)
        return self.apply(x, labels, lam, use_cutmix, use_mix, box, lam_cut)
