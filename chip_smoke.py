#!/usr/bin/env python3
"""Drive the PyTorch port (``unite_torch``) on one CUDA card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one NVIDIA H100 and the CUDA
toolkit. In order:

1. card: ``nvidia-smi`` name and power limit, CUDA version; TF32 off;
2. build: every kernel under ``unite_torch/csrc`` compiled by ``nvcc`` for
   sm_90a into ``build/unite_torch_kernels/`` (one process per source, in
   parallel);
3. kernels against their plain versions at the main-path shapes: K1 (fused
   qkv attention forward) at the teacher's [512, 197, 2304] and the
   student's [64, 320, 2304], K2 (its backward) at [64, 320, 2304]; K3
   (packed flash forward) at the stage-2 train step's [8, 1568, 2304] with
   lse and the eval step's [32, 1568, 2304] without, K4's dQ and dK/dV
   kernels at [8, 1568, 2304]; error, median time, the plain version's
   time, the bound, and one PyTorch call (``scaled_dot_product_attention``)
   as a yardstick;
4. one stage-1 step on the card in bf16 against the same step on the CPU in
   fp32 (B=2, same weights, same batch, injected visible tokens);
5. the stage-1 path: the train step at full ViT-B/16 width and
   ``bench.py::main``'s geometry (B=64, 8 x 224^2, mask 0.8 -> 320 visible
   tokens, clip_b16 teacher with taps 6-11, AdamW from
   configs/stage1_config.yaml), 2 warm-up and 5 timed steps, with the kernel
   launch counts read around it;
6. one stage-2 step on the card in bf16 against the same step on the CPU in
   fp32 (B=2, 1568 tokens, same weights and batch, drop path 0);
7. the stage-2 path: the finetune train step of ``vit_base_patch16_224``
   over 8 frames of 224^2 with tubelet 1 (1568 tokens) at
   ``bench.py::bench_stage2``'s B=8, configured as
   configs/stage2_config.yaml (12 classes, drop path 0.1, AdamW with layer
   decay 0.65, blocks 0-6 frozen), 2 warm-up and 10 timed steps, with the
   launch counts and a profiled step;
8. the stage-2 eval step at the config's batch_size_val of 32, 2 warm-up
   and 10 timed calls, with the launch counts and a profiled call;
9. one JSON line of every kernel's numbers, the card line again, and the
   last line ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero. With no CUDA device,
or run outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s
PEAK_BF16 = 989e12     # H100 SXM dense bf16 tensor-core flop/s
HEADS, SCALE = 12, 64 ** -0.5
FWD_TOL = 1e-2         # a few bf16 ulps of |o| <= 1
BWD_TOL = 2e-2         # times max |dqkv| of the plain version
STEP_RTOL = 2e-2       # bf16 card step against the fp32 CPU step
STAGE2_TOKENS = 1568   # 8 frames x 196 patches, tubelet 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def counters(A) -> dict:
    """Every kernel wrapper of the port, by kernel id."""
    return {"K1": A.fused_qkv_fwd, "K2": A.fused_qkv_bwd,
            "K3": A.packed_flash_fwd, "K4a": A.packed_flash_dq,
            "K4b": A.packed_flash_dkv}


def reset_counts(A) -> None:
    for fn in counters(A).values():
        fn.launches = 0


def read_counts(A) -> dict:
    return {k: fn.launches for k, fn in counters(A).items()}


def expect_counts(counts: dict, want: dict, what: str) -> None:
    """Raise unless every kernel ran exactly as often as ``want`` says
    (kernels not named there not at all)."""
    full = {k: want.get(k, 0) for k in counts}
    if counts != full:
        raise AssertionError(f"{what}: launches {counts}, expected {full}")


def check_kernels(torch, A):
    """Phase 3: each kernel against its plain version, with timings."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for label, (b, s) in (("teacher", (512, 197)), ("student", (64, 320))):
        qkv = torch.randn((b, s, 3 * HEADS * 64), generator=gen,
                          device="cuda").to(torch.bfloat16)
        with_lse = label == "student"  # the student trains, the teacher not
        out, lse = A.fused_qkv_fwd(qkv, HEADS, SCALE, with_lse=with_lse)
        torch.cuda.synchronize()
        ref, ref_lse = A.qkv_attention_reference(qkv, HEADS, SCALE)
        err = (out.float() - ref.float()).abs()
        if not bool(torch.isfinite(out).all()) or err.max().item() > FWD_TOL:
            raise AssertionError(f"K1 {label}: max abs err {err.max().item()}"
                                 f" > {FWD_TOL}")
        if with_lse:
            lse_err = (lse - ref_lse).abs().max().item()
            if lse_err > 1e-3:
                raise AssertionError(f"K1 lse err {lse_err}")
        ms = median_ms(lambda: A.fused_qkv_fwd(qkv, HEADS, SCALE, with_lse))
        plain_ms = median_ms(lambda: A.qkv_attention_reference(qkv, HEADS,
                                                               SCALE))
        q, k, v = (t.contiguous() for t in A._split_heads(qkv, HEADS))
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=SCALE))
        nbytes = b * s * 4 * HEADS * 64 * 2 + (b * HEADS * s * 4 if with_lse
                                               else 0)
        bms, by = bound(nbytes, 4.0 * b * HEADS * s * s * 64)
        results[f"K1/{label}"] = dict(
            shape=[b, s, 3 * HEADS * 64], max_abs_err=err.max().item(),
            mean_abs_err=err.mean().item(), ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=lib_ms)
        print(f"K1 fused_qkv_fwd {label} {results[f'K1/{label}']}",
              flush=True)

    # K2 at the student shape, from the student forward above
    do = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    dqkv = A.fused_qkv_bwd(qkv, out, lse, do, HEADS, SCALE)
    torch.cuda.synchronize()
    ref = A.qkv_attention_reference_bwd(qkv, do, HEADS, SCALE).float()
    err = (dqkv.float() - ref).abs()
    tol = BWD_TOL * ref.abs().max().item()
    if not bool(torch.isfinite(dqkv).all()) or err.max().item() > tol:
        raise AssertionError(f"K2: max abs err {err.max().item()} > {tol}")
    ms = median_ms(lambda: A.fused_qkv_bwd(qkv, out, lse, do, HEADS, SCALE))
    plain_ms = median_ms(lambda: A.qkv_attention_reference_bwd(
        qkv, do, HEADS, SCALE))
    q, k, v = (t.detach().contiguous().requires_grad_(True)
               for t in A._split_heads(qkv, HEADS))
    do_h = do.reshape(b, s, HEADS, 64).transpose(1, 2).contiguous()

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(q, k, v, scale=SCALE).backward(do_h)

    lib_ms = median_ms(sdpa_fwd_bwd)
    nbytes = b * s * (3 + 1 + 1 + 3) * HEADS * 64 * 2 + b * HEADS * s * 4
    bms, by = bound(nbytes, 10.0 * b * HEADS * s * s * 64)
    results["K2/student"] = dict(
        shape=[b, s, 3 * HEADS * 64], max_abs_err=err.max().item(),
        mean_abs_err=err.mean().item(), tol=tol, ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=lib_ms)
    print(f"K2 fused_qkv_bwd student {results['K2/student']}", flush=True)
    return results


def step_flops(b: int, frames: int = 8, width: int = 768, layers: int = 12,
               grid: int = 196, visible: int = 320, taps: int = 6,
               out_dim: int = 512) -> float:
    """Model operations of one stage-1 step, from the shapes: the teacher's
    forward (no gradient), the tap projection at the visible tokens, and the
    student's forward and backward (three times its forward). Matrix
    products and attention only; K2's recomputed scores are not counted."""
    def layer(tokens, seq):  # qkv, proj, fc1, fc2 (12 w^2) + q.k^T and p.v
        return tokens * (2 * 12 * width * width + 4 * seq * width)

    patch = 2 * 3 * 16 * 16 * width  # per patch
    teacher_tokens = b * frames * (grid + 1)
    teacher = (layers * layer(teacher_tokens, grid + 1)
               + b * frames * grid * patch
               + taps * b * visible * 2 * width * out_dim)
    student = (layers * layer(b * visible, visible) + b * visible * patch
               + taps * b * visible * 2 * width * out_dim)
    return float(teacher + 3 * student)


def build_step(torch, b: int, dtype, device: str, drop_path: float,
               state_dict=None, teacher_state=None):
    """The stage-1 step as run_stage1.main builds it, with the
    configs/stage1_config.yaml values."""
    from unite_torch import create_model
    from unite_torch.engines.pretrain_umt import make_pretrain_train_step
    from unite_torch.optim.factory import create_optimizer
    from unite_torch.train.train_state import TrainState
    from unite_torch.utils.schedules import cosine_scheduler, scaled_lr

    frames, ret = 8, (6, 7, 8, 9, 10, 11)
    student = create_model(
        "adaptation_umt_base_patch16_224", device=device, dtype=dtype,
        num_frames=frames, tubelet_size=1, drop_path_rate=drop_path,
        clip_decoder_embed_dim=768, clip_output_dim=512,
        clip_norm_type="l2", clip_return_layers=ret)
    teacher = create_model("clip_b16", device=device, dtype=dtype,
                           input_resolution=224, clip_norm_type="l2",
                           return_attn=True, return_index=ret)
    if state_dict is not None:
        student.load_state_dict(state_dict)
        teacher.load_state_dict(teacher_state)
    niter, epochs = 100, 20
    lr_tab = cosine_scheduler(scaled_lr(1.5e-4, b), scaled_lr(1e-5, b),
                              epochs, niter, start_warmup_value=scaled_lr(
                                  1e-6, b))
    wd_tab = cosine_scheduler(0.05, 0.05, epochs, niter)
    tx, _ = create_optimizer("adamw", lr_tab, student, weight_decay=wd_tab,
                             betas=(0.9, 0.95), eps=1e-8, device=device)
    step = make_pretrain_train_step(
        student, teacher, num_patches=frames * 196, frames=frames,
        mask_ratio=0.8, source_batch_size=b, clip_loss_data="mixed",
        clip_grad=None, clip_input_resolution=224, device=device)
    return TrainState(student, tx), teacher, step


def random_batch(torch, b: int, seed: int, with_vis_idx: bool):
    import numpy as np

    rng = np.random.default_rng(seed)
    batch = {"videos": torch.from_numpy(
        rng.integers(0, 256, (b, 8, 224, 224, 3), dtype=np.uint8))}
    if with_vis_idx:
        vis = [np.sort(np.concatenate([f * 196 + rng.choice(196, 40, False)
                                       for f in range(8)]))
               for _ in range(b)]
        batch["vis_idx"] = torch.from_numpy(np.stack(vis))
    return batch


def card_vs_cpu(torch):
    """Phase 4: one step on the card (bf16) against the CPU (fp32)."""
    torch.manual_seed(0)
    cpu_state, cpu_teacher, cpu_step = build_step(torch, 2, torch.float32,
                                                  "cpu", 0.0)
    sd = {k: v.clone() for k, v in cpu_state.model.state_dict().items()}
    td = cpu_teacher.state_dict()
    gpu_state, gpu_teacher, gpu_step = build_step(
        torch, 2, torch.bfloat16, "cuda", 0.0, sd, td)
    batch = random_batch(torch, 2, 1, with_vis_idx=True)
    from unite_torch.ops.normalize import normalize_videos

    with torch.no_grad():
        vids = normalize_videos(batch["videos"])
        x_cpu = cpu_state.model.eval()(vids, batch["vis_idx"], clip_only=True)
        x_gpu = gpu_state.model.eval()(vids.cuda(), batch["vis_idx"].cuda(),
                                       clip_only=True)
    out_err = (x_gpu.float().cpu() - x_cpu).abs().max().item()
    m_gpu = {k: v.item() for k, v in gpu_step(gpu_state, batch).items()}
    m_cpu = {k: v.item() for k, v in cpu_step(cpu_state, batch).items()}
    rel = {k: abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k])
           for k in ("loss", "grad_norm")}
    print(f"step card bf16 vs cpu fp32: card {m_gpu} cpu {m_cpu} rel {rel} "
          f"student x_clip max abs err {out_err}", flush=True)
    if not all(r <= STEP_RTOL for r in rel.values()) or out_err > 5e-2:
        raise AssertionError(f"card step disagrees with the CPU: {rel}, "
                             f"x_clip err {out_err}")


def main_path(torch, A, b: int = 64, warmup: int = 2, timed: int = 5):
    """Phase 5: the full stage-1 step; returns counts and timings."""
    torch.manual_seed(1)
    state, teacher, step = build_step(torch, b, torch.bfloat16, "cuda", 0.1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    batch = random_batch(torch, b, 3, with_vis_idx=False)
    batch["videos"] = batch["videos"].pin_memory()
    teacher_k1 = []
    teacher.register_forward_pre_hook(
        lambda *_: teacher_k1.append(-A.fused_qkv_fwd.launches))
    teacher.register_forward_hook(
        lambda *_: teacher_k1.append(A.fused_qkv_fwd.launches))
    torch.cuda.reset_peak_memory_stats()
    reset_counts(A)
    losses = []
    for _ in range(warmup):
        losses.append(step(state, batch, gen))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        losses.append(step(state, batch, gen))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts(A)
    k1, k2 = counts["K1"], counts["K2"]
    n = warmup + timed
    vals = [(m["loss"].item(), m["grad_norm"].item()) for m in losses]
    print(f"main path losses/grad norms: {vals}", flush=True)
    check_finite(vals)
    expect_counts(counts, {"K1": 24 * n, "K2": 12 * n},
                  f"stage-1 path, {n} steps")
    k1_teacher = sum(teacher_k1)
    flops = step_flops(b)
    res = dict(clips_per_s=b * timed / dt, step_ms=dt / timed * 1e3,
               model_tflop_per_step=flops / 1e12,
               model_flops_util=flops * timed / dt / PEAK_BF16,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               steps=n, k1_launches=k1, k1_teacher=k1_teacher,
               k1_student=k1 - k1_teacher, k2_launches=k2)
    print(f"main path B={b}: {res} on {card_line()}", flush=True)
    res["profile"] = profile_step(torch, lambda: step(state, batch, gen),
                                  "chip_smoke_profile.json")
    res["device_share_of_timed_step"] = (res["profile"]["device_ms"]
                                         / res["step_ms"])
    return res


def check_finite(vals) -> None:
    if not all(x == x and abs(x) < float("inf") for v in vals for x in v):
        raise AssertionError(f"non-finite loss or grad norm: {vals}")


def profile_step(torch, run_step, dest_name: str) -> dict:
    """One more step under torch.profiler: device time by kernel class and
    the device's busy share of the step's wall time. The full kernel table
    goes to the file ``dest_name`` of the script's output directory."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # a user annotation (such as the optimizer's step) spans kernels that
    # have rows of their own: kept out of the sums, listed apart
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    rows, annotations = [], []
    for e in events:
        (annotations if getattr(e, "is_user_annotation", False) else rows
         ).append((e.key, e.self_device_time_total / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    classes = {"attention (K1-K4)": 0.0, "matmul (cuBLAS)": 0.0,
               "other (elementwise, norms, reductions, copies)": 0.0}
    for name, ms, _ in rows:
        low = name.lower()
        if "fused_qkv" in low or "packed_flash" in low:
            classes["attention (K1-K4)"] += ms
        elif any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet",
                                    "cublas")):
            classes["matmul (cuBLAS)"] += ms
        else:
            classes["other (elementwise, norms, reductions, copies)"] += ms
    device_ms = sum(classes.values())
    out = dict(wall_ms=wall_ms, device_ms=device_ms,
               busy_share=device_ms / wall_ms, classes_ms=classes,
               top=[(n[:80], ms, c) for n, ms, c in rows[:12]])
    print(f"profile of one step (profiler on): {json.dumps(out)}", flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / dest_name).write_text(json.dumps(
        dict(out, kernels=rows, annotations=annotations, card=card_line()),
        indent=1))
    return {k: out[k] for k in ("wall_ms", "device_ms", "busy_share",
                                "classes_ms")}


def check_packed_kernels(torch, A):
    """Phase 3, stage 2: K3 and K4 against their plain versions at the
    stage-2 shapes, with timings."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(4)
    s, hd = STAGE2_TOKENS, HEADS * 64
    results = {}
    for label, b, with_lse in (("train", 8, True), ("eval", 32, False)):
        qkv = torch.randn((b, s, 3 * hd), generator=gen,
                          device="cuda").to(torch.bfloat16)
        out, lse = A.packed_flash_fwd(qkv, HEADS, SCALE, with_lse=with_lse)
        torch.cuda.synchronize()
        ref, ref_lse = A.packed_flash_reference(qkv, HEADS, SCALE)
        err = (out.float() - ref.float()).abs()
        if not bool(torch.isfinite(out).all()) or err.max().item() > FWD_TOL:
            raise AssertionError(f"K3 {label}: max abs err {err.max().item()}"
                                 f" > {FWD_TOL}")
        if with_lse:
            lse_err = (lse - ref_lse).abs().max().item()
            if lse_err > 1e-3:
                raise AssertionError(f"K3 lse err {lse_err}")
            train = (qkv, out, lse)
        del ref, ref_lse
        ms = median_ms(lambda: A.packed_flash_fwd(qkv, HEADS, SCALE,
                                                  with_lse))
        plain_ms = median_ms(lambda: A.packed_flash_reference(qkv, HEADS,
                                                              SCALE))
        q, k, v = (t.contiguous() for t in A._split_heads(qkv, HEADS))
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=SCALE))
        nbytes = b * s * 4 * hd * 2 + (b * HEADS * s * 4 if with_lse else 0)
        bms, by = bound(nbytes, 4.0 * b * HEADS * s * s * 64)
        results[f"K3/{label}"] = dict(
            shape=[b, s, 3 * hd], max_abs_err=err.max().item(),
            mean_abs_err=err.mean().item(), ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=lib_ms,
            library="scaled_dot_product_attention forward")
        print(f"K3 packed_flash_fwd {label} {results[f'K3/{label}']}",
              flush=True)
        del qkv, out, lse, q, k, v, err
        torch.cuda.empty_cache()

    # K4 at the train shape, from the train forward above
    qkv, out, lse = train
    b = qkv.shape[0]
    do = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    dqkv = A.packed_flash_bwd(qkv, out, lse, do, HEADS, SCALE)
    torch.cuda.synchronize()
    ref = A.packed_flash_reference_bwd(qkv, out, lse, do, HEADS, SCALE).float()
    errs = {}
    for i, part in enumerate(("dq", "dk", "dv")):
        sl = slice(i * hd, (i + 1) * hd)
        e = (dqkv[..., sl].float() - ref[..., sl]).abs().max().item()
        tol = BWD_TOL * ref[..., sl].abs().max().item()
        if not bool(torch.isfinite(dqkv[..., sl]).all()) or e > tol:
            raise AssertionError(f"K4 {part}: max abs err {e} > {tol}")
        errs[part] = (e, tol)
    del ref
    buf = torch.empty_like(qkv)
    delta = torch.empty((b, HEADS, s), dtype=torch.float32, device="cuda")
    ms_dq = median_ms(lambda: A.packed_flash_dq(qkv, out, lse, do, buf, delta,
                                                HEADS, SCALE))
    ms_dkv = median_ms(lambda: A.packed_flash_dkv(qkv, do, lse, delta, buf,
                                                  HEADS, SCALE))
    plain_dq = median_ms(lambda: A._packed_dq_reference(qkv, out, lse, do,
                                                        HEADS, SCALE))
    plain_dkv = median_ms(lambda: A._packed_dkv_reference(qkv, lse, delta, do,
                                                          HEADS, SCALE))
    q, k, v = (t.detach().contiguous().requires_grad_(True)
               for t in A._split_heads(qkv, HEADS))
    do_h = do.reshape(b, s, HEADS, 64).transpose(1, 2).contiguous()

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(q, k, v, scale=SCALE).backward(do_h)

    fwd_bwd_ms = median_ms(sdpa_fwd_bwd)
    o_lib = F.scaled_dot_product_attention(q, k, v, scale=SCALE)
    bwd_ms = median_ms(lambda: torch.autograd.grad(o_lib, (q, k, v), do_h,
                                                   retain_graph=True))
    tok = b * s * hd * 2  # bytes of one [B, S, H*D] bf16 tensor
    stat = b * HEADS * s * 4  # one fp32 row statistic
    # K4a reads qkv, o, do, lse and writes dq, delta: 3 products (s, dp,
    # dq); K4b reads qkv, do, lse, delta and writes dk, dv: 4 products
    for key, name, ms, plain, nbytes, flops, e in (
            ("K4a", "dq", ms_dq, plain_dq, 6 * tok + 2 * stat, 6.0, errs["dq"]),
            ("K4b", "dkv", ms_dkv, plain_dkv, 6 * tok + 2 * stat, 8.0,
             max(errs["dk"], errs["dv"]))):
        bms, by = bound(nbytes, flops * b * HEADS * s * s * 64)
        results[key] = dict(
            shape=[b, s, 3 * hd], max_abs_err=e[0], tol=e[1], ms=ms,
            plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=bwd_ms,
            library="scaled_dot_product_attention backward (dq, dk, dv: "
                    "K4a and K4b together)",
            library_fwd_bwd_ms=fwd_bwd_ms)
        print(f"K4 packed_flash_{name} {results[key]}", flush=True)
    del qkv, out, lse, do, dqkv, buf, delta, q, k, v, do_h, o_lib, train
    torch.cuda.empty_cache()
    return results


def stage2_clip_flops(frames: int = 8, img: int = 224, depth: int = 12,
                      dim: int = 768) -> float:
    """Model operations of one clip's stage-2 train step, the formula of
    ``bench.py::bench_stage2`` (matrix products and attention; forward and
    backward as three forwards). A third of it is the eval forward."""
    n = frames * (img // 16) ** 2
    block = (2 * n * dim * (3 * dim) + 2 * n * dim * dim
             + 2 * (2 * n * dim * 4 * dim) + 2 * 2 * n * n * dim)
    return float(3 * (depth * block + 2 * n * (16 * 16 * 3) * dim))


def build_stage2(torch, dtype_name: str, device: str, drop_path: float,
                 state_dict=None):
    """The stage-2 model, optimizer and steps as run_stage2.main builds
    them from configs/stage2_config.yaml (no lr batch scaling in stage 2,
    warmup 0, layer decay 0.65, blocks 0-6 frozen, no EMA, no clip)."""
    from unite_torch.engines.finetune import (make_eval_step,
                                              make_finetune_train_step)
    from unite_torch.optim.factory import create_optimizer
    from unite_torch.train.run_stage2 import build_model, trainable_mask
    from unite_torch.train.train_state import TrainState
    from unite_torch.utils.schedules import cosine_scheduler

    args = SimpleNamespace(
        model="vit_base_patch16_224", nb_classes=12, num_frames=8,
        tubelet_size=1, fc_drop_rate=0.0, drop=0.0, attn_drop_rate=0.0,
        drop_path=drop_path, use_learnable_pos_emb=False,
        use_mean_pooling=True, init_scale=0.001, head_type="linear",
        head_hidden_dim=256, compute_dtype=dtype_name,
        frozen_layers="0,1,2,3,4,5,6", train_head_only=False,
        freeze_patch_embedding=False)
    model = build_model(args, device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    niter, epochs = 100, 20
    lr_tab = cosine_scheduler(2.5e-5, 1e-6, epochs, niter,
                              start_warmup_value=1e-6)
    wd_tab = cosine_scheduler(0.05, 0.05, epochs, niter)
    mask = trainable_mask(args, model)
    tx, _ = create_optimizer("adamw", lr_tab, model, weight_decay=wd_tab,
                             betas=(0.9, 0.999), eps=1e-8,
                             trainable=mask.__getitem__,
                             num_layers=model.depth, layer_decay=0.65,
                             device=device)
    return (TrainState(model, tx),
            make_finetune_train_step(model, device=device),
            make_eval_step(model, device=device))


def stage2_batch(torch, b: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"videos": torch.from_numpy(
                rng.integers(0, 256, (b, 8, 224, 224, 3), dtype=np.uint8)),
            "labels": torch.from_numpy(rng.integers(0, 12, (b,)))}


def stage2_card_vs_cpu(torch):
    """Phase 6: one stage-2 step on the card (bf16) against the CPU (fp32)."""
    from unite_torch.ops.normalize import normalize_videos

    torch.manual_seed(5)
    cpu_state, cpu_step, _ = build_stage2(torch, "float32", "cpu", 0.0)
    sd = {k: v.clone() for k, v in cpu_state.model.state_dict().items()}
    gpu_state, gpu_step, _ = build_stage2(torch, "bfloat16", "cuda", 0.0, sd)
    batch = stage2_batch(torch, 2, 6)
    with torch.no_grad():
        vids = normalize_videos(batch["videos"])
        l_cpu = cpu_state.model.eval()(vids)
        l_gpu = gpu_state.model.eval()(vids.cuda()).float().cpu()
    logit_rel = ((l_gpu - l_cpu).abs().max() / l_cpu.abs().max()).item()
    m_gpu = {k: v.item() for k, v in gpu_step(gpu_state, batch).items()}
    m_cpu = {k: v.item() for k, v in cpu_step(cpu_state, batch).items()}
    rel = {k: abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k])
           for k in ("loss", "grad_norm")}
    rel["logits"] = logit_rel
    print(f"stage-2 step card bf16 vs cpu fp32: card {m_gpu} cpu {m_cpu} "
          f"rel {rel}", flush=True)
    if not all(r <= STEP_RTOL for r in rel.values()):
        raise AssertionError(f"stage-2 card step disagrees with the CPU: "
                             f"{rel}")
    return rel


def stage2_path(torch, A, b: int = 8, warmup: int = 2, timed: int = 10):
    """Phase 7: the stage-2 finetune train step; returns its numbers and
    the trained state with its eval step."""
    torch.manual_seed(7)
    state, step, eval_step = build_stage2(torch, "bfloat16", "cuda", 0.1)
    gen = torch.Generator(device="cuda").manual_seed(8)
    batch = stage2_batch(torch, b, 9)
    batch["videos"] = batch["videos"].pin_memory()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(A)
    metrics = [step(state, batch, gen) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        metrics.append(step(state, batch, gen))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts(A)
    n = warmup + timed
    vals = [(m["loss"].item(), m["grad_norm"].item()) for m in metrics]
    print(f"stage-2 path losses/grad norms: {vals}", flush=True)
    check_finite(vals)
    # all 12 blocks run K3 forward and K4 backward, the frozen ones too
    expect_counts(counts, {"K3": 12 * n, "K4a": 12 * n, "K4b": 12 * n},
                  f"stage-2 path, {n} steps")
    flops = b * stage2_clip_flops()
    res = dict(clips_per_s=b * timed / dt, step_ms=dt / timed * 1e3,
               model_tflop_per_step=flops / 1e12,
               model_flops_util=flops * timed / dt / PEAK_BF16,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               steps=n, k3_launches=counts["K3"],
               k4_dq_launches=counts["K4a"], k4_dkv_launches=counts["K4b"])
    print(f"stage-2 path B={b}: {res} on {card_line()}", flush=True)
    res["profile"] = profile_step(torch, lambda: step(state, batch, gen),
                                  "chip_smoke_profile_stage2.json")
    # the profiler slows the host, so the timed steps' busy share is the
    # profiled device time over the timed step
    res["device_share_of_timed_step"] = (res["profile"]["device_ms"]
                                         / res["step_ms"])
    return res, state, eval_step


def stage2_eval(torch, A, state, eval_step, b: int = 32, warmup: int = 2,
                timed: int = 10):
    """Phase 8: the stage-2 eval step (softmax, top-1/5, loss) over views."""
    batch = stage2_batch(torch, b, 10)
    batch["videos"] = batch["videos"].pin_memory()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(A)
    outs = [eval_step(state, batch) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        outs.append(eval_step(state, batch))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts(A)
    n = warmup + timed
    expect_counts(counts, {"K3": 12 * n}, f"stage-2 eval, {n} calls")
    probs = outs[-1]["probs"]
    sums = probs.sum(-1)
    if (probs.shape != (b, 12) or not bool(torch.isfinite(probs).all())
            or (sums - 1).abs().max().item() > 1e-4):
        raise AssertionError(f"eval probs: shape {tuple(probs.shape)}, row "
                             f"sums {sums.tolist()}")
    flops = b * stage2_clip_flops() / 3
    res = dict(views_per_s=b * timed / dt, call_ms=dt / timed * 1e3,
               model_flops_util=flops * timed / dt / PEAK_BF16,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               calls=n, k3_launches=counts["K3"],
               acc1=outs[-1]["acc1"].item(), loss=outs[-1]["loss"].item())
    print(f"stage-2 eval B={b}: {res} on {card_line()}", flush=True)
    res["profile"] = profile_step(torch, lambda: eval_step(state, batch),
                                  "chip_smoke_profile_eval.json")
    res["device_share_of_timed_call"] = (res["profile"]["device_ms"]
                                         / res["call_ms"])
    return res


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "unite_torch" / "csrc").is_dir():
        print(f"no unite_torch package beside {__file__}: run from the root "
              "of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import unite_torch.ops.attention as A
    from unite_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}; cuda "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    paths = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for p in paths.values():
        log = p.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {p.name}: {line.strip()}")

    kr = check_kernels(torch, A)
    kr.update(check_packed_kernels(torch, A))
    card_vs_cpu(torch)
    mp = main_path(torch, A)
    s2_rel = stage2_card_vs_cpu(torch)
    s2, state, eval_step = stage2_path(torch, A)
    ev = stage2_eval(torch, A, state, eval_step)

    kernels = []
    for key, name, src, rep, launches in (
            ("K1/teacher", "fused_qkv_fwd[teacher S=197]",
             "unite_torch/csrc/fused_qkv_fwd.cu",
             "unite_tpu/ops/attention.py:678", mp["k1_teacher"]),
            ("K1/student", "fused_qkv_fwd[student S=320]",
             "unite_torch/csrc/fused_qkv_fwd.cu",
             "unite_tpu/ops/attention.py:678", mp["k1_student"]),
            ("K2/student", "fused_qkv_bwd[student S=320]",
             "unite_torch/csrc/fused_qkv_bwd.cu",
             "unite_tpu/ops/attention.py:773", mp["k2_launches"]),
            ("K3/train", "packed_flash_fwd[train B=8 S=1568]",
             "unite_torch/csrc/packed_flash_fwd.cu",
             "unite_tpu/ops/attention.py:913", s2["k3_launches"]),
            ("K3/eval", "packed_flash_fwd[eval B=32 S=1568]",
             "unite_torch/csrc/packed_flash_fwd.cu",
             "unite_tpu/ops/attention.py:913", ev["k3_launches"]),
            ("K4a", "packed_flash_dq[train B=8 S=1568]",
             "unite_torch/csrc/packed_flash_bwd.cu",
             "unite_tpu/ops/attention.py:983", s2["k4_dq_launches"]),
            ("K4b", "packed_flash_dkv[train B=8 S=1568]",
             "unite_torch/csrc/packed_flash_bwd.cu",
             "unite_tpu/ops/attention.py:1014", s2["k4_dkv_launches"])):
        r = kr[key]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels, "step": mp, "stage2_step": s2,
                      "stage2_eval": ev, "stage2_card_vs_cpu_rel": s2_rel,
                      "yardsticks": {k: {x: r[x] for x in r if x.startswith(
                          "library")} for k, r in kr.items()}}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
