"""Stage-3 engine: collaborative self-training of the student on source and
target videos with the CLIP teacher (unite_tpu/engines/selftrain.py).

One train step:

* source cross-entropy through the encoder and the classifier;
* the full target clip through the encoder under ``torch.no_grad`` with the
  classifier live (its logits give the pseudo-labels and the confidences);
* k greedy committee masks from the teacher's CLS attention over the
  augmented target clips (or the injected ``attn``), on a teacher grid
  that must be the student's (``check_committee_grid``; without a
  committee, under ``train_masked=False`` and a strategy that casts no
  votes, any teacher serves the zero-shot similarities);
* the selection strategy, ``clip_matchORconf`` by default, on the student's
  full-target predictions and the CLIP zero-shot similarities ``clip_sim``;
* the confidence-weighted pseudo-label CE on committee member k-1 when
  ``train_masked``, as a static masked mean: mean(sel * w * ce) equals the
  reference's mean over the selected rows times the selected share;
* the global grad norm (and optional clip), then AdamW.

Member k-1 is the only committee pass with a gradient; the other members
vote through an argmax and run forward-only, and only for the cons-family
strategies that read the votes. The encoder runs without its CLIP decoders:
the stage-3 loss never reads them. The JAX step still gives them a zero
gradient and optax decays them, so this step gives every live parameter
that got no gradient a zero one before the optimizer, and the decoupled
weight decay reaches them as it does in JAX.

Stochastic depth draws from one ``torch.Generator`` in turn for the source,
full-target, grad-member and vote passes: each pass gets its own draw, as
the four keys JAX splits give it.

With ``use_cls_token`` the pooled feature is the CLS row and the full
passes run N + 1 tokens (1569 at 8 x 224^2, through K6); the committee
runs N_vis + 1 (321).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from unite_torch.engines.losses import accuracy_topk, cross_entropy
from unite_torch.engines.pretrain_umt import resize_for_teacher
from unite_torch.ops.masking import (
    greedy_committee_masks,
    n_visible,
    visible_indices,
)
from unite_torch.ops.normalize import normalize_videos
from unite_torch.train.train_state import TrainState, clip_by_global_norm
from unite_torch.utils.device import resolve_device

STRATEGIES = ("conf", "cons", "consORconf", "consANDconf", "classwise-conf",
              "consORclasswise-conf", "consANDclasswise-conf", "clip_only",
              "clip_matchORconf", "oracle")
VOTING = ("cons", "consORconf", "consANDconf", "consORclasswise-conf",
          "consANDclasswise-conf")


def pool_outputs(x, use_cls_token: bool):
    """The CLS row, or the token mean (an fp32 sum rounded once, as
    jnp.mean on bf16)."""
    if use_cls_token:
        return x[:, 0]
    return x.float().mean(dim=1).to(x.dtype)


def clip_zero_shot_similarities(image_features, text_features):
    """softmax(100 * img . text^T) averaged over frames: image_features
    [B, T, D] and text_features [C, D], both L2-normed -> [B, C] fp32."""
    logits = 100.0 * torch.einsum("btd,cd->btc", image_features.float(),
                                  text_features.float())
    return torch.softmax(logits, dim=-1).mean(dim=1)


def check_committee_grid(teacher_grid: int, patches_per_frame: int) -> None:
    """Raise unless the teacher's patch grid is the student's: the
    committee masks rank the teacher's CLS-row attention and their indices
    gather the student's tokens. unite_tpu's step has no such check, and
    its gather fills the indices past the student's tokens with NaN, so its
    loss is NaN (ROADMAP queue 3, item 8)."""
    if teacher_grid != patches_per_frame:
        raise ValueError(
            f"teacher patch grid ({teacher_grid}/frame) != student grid "
            f"({patches_per_frame}/frame): the committee masks index the "
            f"student's tokens by the teacher's attention; set --train_masked"
            f" false with a selection strategy that casts no votes (none of "
            f"{', '.join(VOTING)}), or clip_input_resolution so "
            f"teacher_res/teacher_patch == student_res/student_patch (196 "
            f"for L/14 teachers)")


def _select(strategy: str, *, sel_cons, msp_t, preds_full_t, labels_t,
            batch, global_threshold: float, clip_threshold: float, diag):
    """The selection mask [B_t] of ``strategy`` (run_stage3.py:508-593)."""
    sel_conf = msp_t >= global_threshold
    if strategy == "conf":
        return sel_conf
    if strategy == "cons":
        return sel_cons
    if strategy == "consORconf":
        return sel_cons | sel_conf
    if strategy == "consANDconf":
        return sel_cons & sel_conf
    if strategy.endswith("classwise-conf"):
        th = batch["classwise_thresholds"].to(msp_t.device)
        sel_cw = msp_t >= th[preds_full_t]
        if strategy == "classwise-conf":
            return sel_cw
        return sel_cw | sel_cons if strategy.startswith("consOR") \
            else sel_cw & sel_cons
    if strategy == "oracle":
        return preds_full_t == labels_t
    clip_sim = batch["clip_sim"].to(msp_t.device)
    if strategy == "clip_only":
        return clip_sim.amax(-1) >= global_threshold
    # clip_matchORconf: the student agrees with CLIP, or exactly one of the
    # two is confident
    match = clip_sim.argmax(-1) == preds_full_t
    conf = ((msp_t >= clip_threshold)
            ^ (clip_sim.amax(-1) >= clip_threshold)) & ~match
    wrong = preds_full_t != labels_t
    diag["match_select_rate"] = match.float().mean()
    diag["conf_select_rate"] = conf.float().mean()
    diag["match_error_rate"] = (match & wrong).float().mean()
    diag["conf_error_rate"] = (conf & wrong).float().mean()
    return conf | match


def make_selftrain_step(
    student: torch.nn.Module,
    classifier: torch.nn.Module,
    teacher: torch.nn.Module,
    *,
    num_patches: int,
    frames: int,
    mask_ratio: float,
    committee_size: int = 2,
    selection_strategy: str = "clip_matchORconf",
    global_threshold: float = 0.5,
    clip_threshold: float = 0.1,
    conf_weighted_loss: bool = True,
    train_masked: bool = True,
    use_cls_token: bool = False,
    class_loss_src_ratio_pl: float = 1.0,
    class_loss_tgt_ratio: float = 1.0,
    full_oracle: bool = False,
    clip_grad: Optional[float] = None,
    clip_input_resolution: int = 224,
    nb_classes: int = 12,
    merge_full_passes: bool = False,
    device=None,
) -> Callable:
    """Build ``train_step(state, batch, generator=None) -> metrics``.

    ``state.model`` holds ``student`` and ``classifier`` (``run_stage3.
    combine``) and is updated in place; the modules and the frozen
    ``teacher`` move to ``device`` (CUDA when None). ``batch``: uint8 (or
    normalized) ``videos_s`` [B_s, T, H, W, C] with ``labels_s``; the clean
    target clips ``videos_t`` (full-video predictions, zero-shot) and the
    augmented ``videos_t_aug`` (teacher attention, committee; defaults to
    ``videos_t``); ``labels_t`` for the diagnostics; ``clip_sim``
    [B_t, nb_classes] for the clip strategies; ``classwise_thresholds``
    [nb_classes] for the classwise ones; optional ``attn`` [B_t*T, HW]
    replaces the teacher's attention (the injection hook). Metrics are
    tensors on the device: ``loss``, the pre-clip ``grad_norm``, the
    diagnostics, and per sample ``preds_t``, ``labels_t`` and, with
    ``clip_sim``, ``clip_preds_t``."""
    if selection_strategy not in STRATEGIES:
        raise ValueError(f"Invalid selection strategy: {selection_strategy}")
    if merge_full_passes and getattr(student, "drop_path_rate", 0.0):
        raise ValueError(
            "merge_full_passes requires drop_path_rate == 0 (the merged "
            "forward shares one DropPath draw across source+target rows; "
            f"student has drop_path_rate={student.drop_path_rate})")
    dev = resolve_device(device)
    student.to(dev)
    classifier.to(dev)
    teacher.to(dev).eval().requires_grad_(False)
    patches_per_frame = num_patches // frames
    n_unmask_frame = n_visible(patches_per_frame, mask_ratio)
    nv_committee = n_unmask_frame * frames
    k = committee_size
    needs_votes = selection_strategy in VOTING
    n_vote = (k - 1 if train_masked else k) if needs_votes else 0
    needs_committee = train_masked or n_vote > 0
    if needs_committee and n_unmask_frame * k > patches_per_frame:
        raise ValueError(
            f"committee of k={k} disjoint masks cannot unmask "
            f"{n_unmask_frame}/{patches_per_frame} patches per frame each "
            f"(k*n_unmask > N); raise mask_ratio to at least "
            f"{1 - patches_per_frame // k / patches_per_frame:.3f} or "
            f"lower committee_size")
    if needs_committee:
        check_committee_grid(
            (clip_input_resolution // teacher.patch_size) ** 2,
            patches_per_frame)

    def committee(videos_t_aug, b_t, batch):
        """Visible indices of the grad member and of the vote members."""
        if "attn" in batch:
            attn = batch["attn"].to(dev)
        else:
            _, attn = teacher(resize_for_teacher(videos_t_aug,
                                                 clip_input_resolution),
                              raw_taps=True)
        check_committee_grid(attn.shape[-1], patches_per_frame)
        masks = greedy_committee_masks(attn, mask_ratio, k)
        grad = (visible_indices(masks[-1].reshape(b_t, -1), nv_committee)
                if train_masked else None)
        vote = (visible_indices(masks[:n_vote].reshape(n_vote * b_t, -1),
                                nv_committee) if n_vote else None)
        return grad, vote

    def train_step(state: TrainState, batch: Dict,
                   generator: Optional[torch.Generator] = None) -> Dict:
        videos_s = normalize_videos(batch["videos_s"].to(dev,
                                                         non_blocking=True))
        labels_s = batch["labels_s"].to(dev)
        videos_t = normalize_videos(batch["videos_t"].to(dev,
                                                         non_blocking=True))
        labels_t = batch["labels_t"].to(dev)
        videos_t_aug = (normalize_videos(batch["videos_t_aug"].to(
            dev, non_blocking=True)) if "videos_t_aug" in batch else videos_t)
        b_t = videos_t.shape[0]
        if "clip_sim" in batch and batch["clip_sim"].shape[-1] != nb_classes:
            raise ValueError(f"clip_sim width {batch['clip_sim'].shape[-1]} "
                             f"!= nb_classes {nb_classes}")
        vis_grad = vis_vote = None
        if needs_committee:
            with torch.no_grad():
                vis_grad, vis_vote = committee(videos_t_aug, b_t, batch)

        student.train()
        classifier.train()

        def encode_pool(videos, vis_idx=None):
            x_vis, _ = student.encoder(videos, vis_idx, False, generator)
            return pool_outputs(x_vis, use_cls_token)

        def passes():
            """Every pass over the student and the classifier, in the order
            of their draws: source, full target, grad member, votes."""
            if merge_full_passes:
                # one [B_s + B_t] pass; the target rows' features are
                # detached, which equals the split passes at drop path 0
                b_s = videos_s.shape[0]
                feats = encode_pool(torch.cat([videos_s, videos_t]))
                logits_full_s = classifier(feats[:b_s])
                logits_full_t = classifier(feats[b_s:].detach())
            else:
                logits_full_s = classifier(encode_pool(videos_s))
                with torch.no_grad():
                    feat_t = encode_pool(videos_t)
                logits_full_t = classifier(feat_t)  # the classifier is live
            logits_grad_t = (classifier(encode_pool(videos_t_aug, vis_grad))
                             if train_masked else None)
            vote_preds = None
            if n_vote:
                with torch.no_grad():
                    videos_tv = (torch.cat([videos_t_aug] * n_vote)
                                 if n_vote > 1 else videos_t_aug)
                    vote_preds = classifier(encode_pool(
                        videos_tv, vis_vote)).reshape(n_vote, b_t, -1
                                                      ).argmax(-1)
            return logits_full_s, logits_full_t, logits_grad_t, vote_preds

        # one call of the step's module (the combined student and
        # classifier, or its DDP wrapper, whose hooks must see every pass)
        logits_full_s, logits_full_t, logits_grad_t, vote_preds = \
            state.net(passes)

        probs_full_t = torch.softmax(logits_full_t.detach().float(), -1)
        msp_t = probs_full_t.amax(-1)
        preds_full_t = probs_full_t.argmax(-1)
        sel_cons = None
        if needs_votes:
            # agreement of all k members with the full-video prediction
            parts = []
            if n_vote:
                parts.append(vote_preds)
            if train_masked:
                parts.append(logits_grad_t.detach().argmax(-1)[None])
            votes = (torch.cat(parts) == preds_full_t[None]).sum(0)
            sel_cons = votes >= k
        diag = {}
        sel = _select(selection_strategy, sel_cons=sel_cons, msp_t=msp_t,
                      preds_full_t=preds_full_t, labels_t=labels_t,
                      batch=batch, global_threshold=global_threshold,
                      clip_threshold=clip_threshold, diag=diag)

        # the pseudo-labels are the student's full-video predictions
        ce_input = logits_grad_t if train_masked else logits_full_t
        conf_w = msp_t if conf_weighted_loss else torch.ones_like(msp_t)
        ce_t = cross_entropy(ce_input, preds_full_t, reduction="none")
        sel_f = sel.float()
        loss_class_t = class_loss_tgt_ratio * (sel_f * conf_w * ce_t).mean()
        if full_oracle:
            loss_class_t = cross_entropy(ce_input, labels_t)
        loss_class_s = cross_entropy(logits_full_s, labels_s)
        loss = class_loss_src_ratio_pl * loss_class_s + loss_class_t

        net = state.model
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in net.parameters():
            if p.requires_grad and p.grad is None:
                p.grad = torch.zeros_like(p)
        grad_norm = clip_by_global_norm(net.parameters(), clip_grad)
        state.apply_gradients()

        correct = (preds_full_t == labels_t).float()
        nsel = sel_f.sum()
        hits = (correct * sel_f).sum()
        metrics = {
            "loss": loss.detach(), "grad_norm": grad_norm, **diag,
            "loss_class": loss_class_s.detach(),
            "loss_class_t": loss_class_t.detach(),
            "sel_ratio": sel_f.mean(),
            "correct_precision": torch.where(
                nsel > 0, hits / nsel.clamp_min(1.0), 0.0),
            "correct_recall": hits / correct.sum().clamp_min(1.0),
            "preds_t": preds_full_t, "labels_t": labels_t,
        }
        if "clip_sim" in batch:
            metrics["clip_preds_t"] = batch["clip_sim"].to(dev).argmax(-1)
        return metrics

    return train_step


def compare_model_predictions(student_logits, clip_similarities, target):
    """Student-vs-CLIP agreement table (run_stage3.py:789-817) from logits
    or similarities [N, C], or predictions [N]; numpy or tensors."""
    def preds(x):
        x = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        return x.argmax(-1) if x.ndim > 1 else x

    student_preds, clip_preds = preds(student_logits), preds(clip_similarities)
    target = preds(target)
    s_ok = student_preds == target
    c_ok = clip_preds == target
    agree = student_preds == clip_preds
    return {
        "student_acc": float(s_ok.mean()),
        "clip_acc": float(c_ok.mean()),
        "student_or_clip_correct": float((s_ok | c_ok).mean()),
        "student_clip_agree": int(agree.sum()),
        "student_clip_agree_correct": int((agree & s_ok).sum()),
        "student_clip_agree_incorrect": int((agree & ~s_ok).sum()),
        "student_clip_disagree": int((~agree).sum()),
        "student_clip_disagree_correct": int((~agree & s_ok).sum()),
        "student_clip_disagree_incorrect": int((~agree & ~s_ok).sum()),
    }


def make_selftrain_eval_step(student: torch.nn.Module,
                             classifier: torch.nn.Module,
                             use_cls_token: bool = False,
                             with_feats: bool = False,
                             input_transform: Optional[Callable] = None,
                             device=None) -> Callable:
    """Validation forward (run_stage3.py:714-787): the full clip through the
    encoder, pooled, through the classifier. ``eval_step(state, batch)`` ->
    fp32 softmax ``probs``, ``labels``, ``acc1`` and ``acc5`` in percent,
    ``loss``, and with ``with_feats`` the pooled fp32 features [B, width]
    for the kNN probe. ``input_transform`` replaces the uint8 normalize. No
    gradient, so the attention kernels write no lse."""
    dev = resolve_device(device)
    student.to(dev)
    classifier.to(dev)
    transform = input_transform or normalize_videos

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict) -> Dict:
        student.eval()
        classifier.eval()
        x = transform(batch["videos"].to(dev, non_blocking=True))

        def passes():
            pooled = pool_outputs(student.encoder(x)[0], use_cls_token)
            return pooled, classifier(pooled)

        # through the combined module (an FSDP root gathers its weights);
        # a caller without a state runs the modules as they are
        pooled, logits = (passes() if state is None
                          else state.model(passes))
        labels = batch["labels"].to(dev)
        acc1, acc5 = accuracy_topk(logits, labels)
        out = {"probs": torch.softmax(logits.float(), dim=-1),
               "labels": labels, "acc1": acc1, "acc5": acc5,
               "loss": cross_entropy(logits, labels)}
        if with_feats:
            out["feats"] = pooled.float()
        return out

    return eval_step
