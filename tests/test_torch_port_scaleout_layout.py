"""unite_torch's scale-out layouts (``unite_torch.parallel.mesh``) against
unite_tpu's layout rules, and the harness the scale-out tests launch ranks
with, on the CPU over gloo.

* The rules, leaf by leaf against ``unite_tpu.parallel.mesh`` on the same
  tiny models: which tensors tensor parallelism shards, and on which dim
  (column: the kernel's output dim, the port's weight rows; row: its input
  dim); ZeRO-1's per-rank moment fraction; --fsdp with --tp downgrading to
  ZeRO-1 moments (and saying so); qkv split by heads, each rank's rows the
  [3, H/tp, D] block of every head it holds.
* Ranks launched as torchrun launches them (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_PORT`` a free port chosen at run time), each run
  under its own timeout: the rank's generators draw apart, rank 0 draws what
  one process draws, and ranks of one tensor-parallel group draw alike.

This module imports no JAX at its top: the launched ranks import it for
``worker`` and the jobs below (JAX takes seconds to import), and the tests
import ``unite_tpu`` inside.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

# the tiny configurations of tests/test_torch_port_{step,finetune,selftrain}.py
# at 32^2 (16 tokens): 2 heads of 64, so --tp 2 leaves each rank one head
S1_STUDENT = dict(img_size=32, patch_size=16, encoder_embed_dim=128,
                  encoder_depth=3, encoder_num_heads=2, num_frames=4,
                  tubelet_size=1, clip_decoder_embed_dim=128,
                  clip_output_dim=64, clip_return_layers=(0, 1))
S1_TEACHER = dict(input_resolution=32, patch_size=16, width=128, layers=3,
                  heads=2, output_dim=64, return_attn=True,
                  return_index=(0, 1))
S1_GEOM = dict(num_patches=16, frames=4, mask_ratio=0.5, source_batch_size=1,
               clip_loss_data="target", clip_grad=0.05,
               clip_input_resolution=32)
S2_VIT = dict(img_size=32, patch_size=16, num_classes=12, embed_dim=128,
              depth=2, num_heads=2, all_frames=4, tubelet_size=1,
              init_scale=0.001)
S2_ARGS = SimpleNamespace(frozen_layers="0", train_head_only=False,
                          freeze_patch_embedding=False)
S3_STUDENT = dict(S1_STUDENT, encoder_depth=2, clip_return_layers=(1,))
S3_TEACHER = dict(S1_TEACHER, layers=2, return_index=(1,))
S3_GEOM = dict(num_patches=16, frames=4, mask_ratio=0.5, nb_classes=12,
               clip_input_resolution=32)
S3_ARGS = SimpleNamespace(opt="adamw", opt_betas=[0.9, 0.95], opt_eps=1e-6,
                          nb_classes=12, freeze_clip_decoders=False,
                          src_classifier_type="linear")
EPS = 1e-6  # Adam's eps in the parity gates (see tests/test_torch_port_step)
EMA = 0.9
# each job's layouts: (name, --tp, --zero1, --fsdp); 2 ranks, or 4 for TP
LAYOUTS = {"ddp": (1, False, False), "zero1": (1, True, False),
           "fsdp": (1, False, True), "tp2": (2, False, False),
           "tp2_zero1": (2, True, False)}
WORLD = {"ddp": 2, "zero1": 2, "fsdp": 2, "tp2": 4, "tp2_zero1": 4}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world: int, job: str, tmp: Path, payload=None,
           timeout: float = 180.0,
           module: str = "tests.test_torch_port_scaleout_layout") -> list:
    """Run ``job`` on ``world`` ranks as torchrun would start them (one
    process each, gloo on the CPU) and return each rank's result. Any rank's
    non-zero exit, or the timeout, fails the caller with the ranks' output.
    ``module`` holds the ``worker`` the ranks call with the job's name."""
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(payload, tmp / "in.pt")
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT), os.environ.get("PYTHONPATH", "")]))
        log = open(tmp / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c",
             f"from {module} import worker; "
             f"worker({job!r}, {str(tmp)!r})"],
            env=env, cwd=str(tmp), stdout=log, stderr=subprocess.STDOUT),
            log))
    failed = []
    for rank, (p, log) in enumerate(procs):
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            rc = "timeout"
        log.close()
        if rc != 0:
            failed.append((rank, rc))
    if failed:
        tails = "\n".join(
            f"--- rank {r} ({rc}):\n"
            + (tmp / f"rank{r}.log").read_text()[-3000:] for r, rc in failed)
        raise AssertionError(f"{job} on {world} ranks failed:\n{tails}")
    return [torch.load(tmp / f"out{r}.pt", weights_only=False)
            for r in range(world)]


def worker(job: str, tmp: str) -> None:
    """A launched rank: run ``job`` on the payload, save its result."""
    torch.set_num_threads(1)
    tmp = Path(tmp)
    payload = torch.load(tmp / "in.pt", weights_only=False)
    out = JOBS[job](payload, tmp)
    torch.save(out, tmp / f"out{os.environ['RANK']}.pt")


# ------------------------------------------------------------ rank jobs


def _mesh_args(tp=1, zero1=False, fsdp=False, **kw):
    return SimpleNamespace(tp=tp, zero1=zero1, fsdp=fsdp, seed=0,
                           dist_backend="ici", dist_url="env://",
                           world_size=1, **kw)


def job_generators(payload, tmp):
    """Each rank's step generator, reseeded for steps 0 and 1: the draws."""
    from unite_torch.parallel import mesh as pm
    from unite_torch.train import common

    args = _mesh_args(tp=payload["tp"])
    pm.init_distributed(args, device="cpu")
    draws = []
    step = common.seeded_step(args, torch.device("cpu"),
                              lambda state, batch, g: torch.rand(
                                  8, generator=g))
    for s in range(2):
        draws.append(step(SimpleNamespace(step=s), None))
    mesh = pm.current()
    return {"draws": torch.stack(draws), "dp_rank": mesh.dp_rank,
            "tp_rank": mesh.tp_rank}


def _local_rows(batch: dict, rows: dict, dp: int, r: int) -> dict:
    """Replica ``r``'s part of a global batch: every array of ``rows``
    leading rows a replica is cut, the others (side tables) are kept."""
    out = {}
    for k, v in batch.items():
        n = rows.get(k)
        out[k] = v if n is None else v[r * n:(r + 1) * n]
    return out


def build_stage(stage: str, weights: dict):
    """(model, make_optimizer(model), make_step(), ema_decay) of a stage
    from the payload's weights, on the CPU in fp32."""
    from unite_torch.engines.finetune import make_finetune_train_step
    from unite_torch.engines.pretrain_umt import make_pretrain_train_step
    from unite_torch.engines.selftrain import make_selftrain_step
    from unite_torch.models.adaptation import AdaptationVisionTransformer
    from unite_torch.models.clip import CLIPVisionTransformer
    from unite_torch.models.vit import VisionTransformer
    from unite_torch.optim.factory import create_optimizer
    from unite_torch.train import run_stage1, run_stage2, run_stage3

    lr, wd = weights["lr"], weights["wd"]
    if stage == "stage1":
        sm = AdaptationVisionTransformer(**S1_STUDENT)
        sm.load_state_dict(weights["student"])
        tm = CLIPVisionTransformer(**S1_TEACHER)
        tm.load_state_dict(weights["teacher"])

        def opt(model):
            return create_optimizer(
                "adamw", lr, model, weight_decay=wd, betas=(0.9, 0.95),
                eps=EPS, trainable=run_stage1.unused_block_mask(1),
                device="cpu")[0]

        return sm, opt, lambda: make_pretrain_train_step(
            sm, tm, device="cpu", **S1_GEOM), None
    if stage == "stage2":
        vm = VisionTransformer(**S2_VIT)
        vm.load_state_dict(weights["vit"])
        mask = run_stage2.trainable_mask(S2_ARGS, vm)

        def opt(model):
            return create_optimizer(
                "adamw", lr, model, weight_decay=wd, betas=(0.9, 0.999),
                eps=EPS, trainable=mask.__getitem__, num_layers=2,
                layer_decay=0.65, device="cpu")[0]

        return vm, opt, lambda: make_finetune_train_step(
            vm, ema_decay=EMA, device="cpu"), EMA
    sm = AdaptationVisionTransformer(**S3_STUDENT)
    sm.load_state_dict(weights["student"])
    tm = CLIPVisionTransformer(**S3_TEACHER)
    tm.load_state_dict(weights["teacher"])
    cm = run_stage3.build_classifier(S3_ARGS, 128, device="cpu")
    cm.load_state_dict(weights["classifier"])
    model = run_stage3.combine(sm, cm)

    def opt(model):
        return run_stage3.build_optimizer(S3_ARGS, model, lr, wd,
                                          device="cpu")[0]

    return model, opt, lambda: make_selftrain_step(
        sm, cm, tm, device="cpu", **S3_GEOM), None


def _full_state(state) -> dict:
    """The whole params, moments and EMA of a state (collective)."""
    lay = state.layout
    named = lay.named_parameters()
    moments = {n: {k: lay.full_moment(n, v)
                   for k, v in state.optimizer.state[p].items()}
               for n, p in named if state.optimizer.state.get(p)}
    ema = (None if state.ema_params is None else
           {n: lay.full_param(n, v) for n, v in state.ema_params.items()})
    return {"params": lay.full_state_dict(), "moments": moments, "ema": ema}


def _moment_bytes(state) -> int:
    return sum(v.numel() * v.element_size()
               for s in state.optimizer.state.values() for v in s.values())


def job_steps(payload, tmp):
    """Each layout of ``payload["layouts"]``: the stage's steps on this
    replica's rows of the global batches, then the whole state, a
    checkpoint (rank 0 writes it) and the state restored from it."""
    import torch.distributed as dist

    from unite_torch.parallel import mesh as pm
    from unite_torch.train.train_state import TrainState
    from unite_torch.utils import checkpoint as ck

    stage = payload["stage"]
    results = {}
    for name in payload["layouts"]:
        tp, zero1, fsdp = LAYOUTS[name]
        mesh = pm.init_distributed(_mesh_args(tp, zero1, fsdp), device="cpu")
        model, opt, make_step, ema = build_stage(stage, payload["weights"])
        layout = pm.state_layout(model, tp=tp, zero1=zero1, fsdp=fsdp)
        state = TrainState(model, opt(model), ema_decay=ema, layout=layout)
        step = make_step()
        metrics = []
        for batch in payload["batches"]:
            local = _local_rows(batch, payload["rows"], mesh.dp,
                                mesh.dp_rank)
            m = step(state, {k: torch.from_numpy(np.asarray(v))
                             for k, v in local.items()})
            loss = m["loss"].detach().clone()
            dist.all_reduce(loss)  # the global batch's mean
            metrics.append({"loss": float(loss) / mesh.world,
                            "grad_norm": float(m["grad_norm"])})
        full = _full_state(state)
        out_dir = str(tmp / name)
        ck.save_train_state(out_dir, 0, state, tags=("latest",))
        pm.barrier()
        # the checkpoint back into a fresh state of the same layout
        model2, opt2, _, _ = build_stage(stage, payload["weights"])
        layout2 = pm.state_layout(model2, tp=tp, zero1=zero1, fsdp=fsdp)
        state2 = TrainState(model2, opt2(model2), ema_decay=ema,
                            layout=layout2)
        ck.restore_train_state(
            state2, ck.load_checkpoint(f"{out_dir}/checkpoint-latest.pth"))
        again = _full_state(state2)
        results[name] = {"metrics": metrics, "full": full, "again": again,
                         "moment_bytes": _moment_bytes(state),
                         "layout": layout.name, "ckpt": out_dir}
        pm.barrier()
    return results


def job_loader_split(payload, tmp):
    """The indices this rank's training loader and evaluation loader read
    (``common.make_loader``), and the lr tables' peak."""
    from unite_torch.parallel import mesh as pm
    from unite_torch.train import common

    args = _mesh_args(tp=payload["tp"], num_workers=1, batch_size=2, lr=1e-3,
                      min_lr=1e-5, warmup_lr=1e-6, epochs=2, warmup_epochs=1,
                      warmup_steps=-1, weight_decay=0.05,
                      weight_decay_end=None)
    pm.init_distributed(args, device="cpu")
    ds = list(range(payload["n"]))
    train = common.make_loader(ds, args, 2)
    val = common.make_loader(ds, args, 2, shuffle=False, drop_last=False)
    _, _, peak = common.lr_tables(args, 3, 2)
    return {"train": train.sampler.indices(), "val": val.sampler.indices(),
            "peak_lr": peak}


def _register(models: dict) -> None:
    """Register the tests' tiny models by name in this rank's registry."""
    from unite_torch.models.adaptation import AdaptationVisionTransformer
    from unite_torch.models.clip import CLIPVisionTransformer
    from unite_torch.models.vit import VisionTransformer
    from unite_torch.utils.registry import _MODEL_REGISTRY

    classes = {"vit": VisionTransformer, "clip": CLIPVisionTransformer,
               "adaptation": AdaptationVisionTransformer}
    for name, (kind, cfg) in models.items():
        def build(_cls=classes[kind], _cfg=cfg, **kwargs):
            for k in _cfg:
                kwargs.pop(k, None)
            return _cls(**_cfg, **kwargs)
        _MODEL_REGISTRY.setdefault(name, build)


def job_entries(payload, tmp):
    """The stage entries' ``main`` calls of ``payload["calls"]`` in turn,
    on the CPU: (stage, args namespace)."""
    import copy

    from unite_torch.train import run_stage1, run_stage2, run_stage3

    _register(payload["register"])
    mains = {"stage1": run_stage1.main, "stage2": run_stage2.main,
             "stage3": run_stage3.main}
    for stage, args in payload["calls"]:
        mains[stage](copy.copy(args), device="cpu")
    return {}


JOBS = {"generators": job_generators, "steps": job_steps,
        "loader_split": job_loader_split, "entries": job_entries}


# ------------------------------------------------------------ the tests


def _jax_tp_specs(params, tp: int):
    """unite_tpu's tensor-parallel layout of a flax param tree: port name ->
    (flax path, PartitionSpec)."""
    import jax
    from jax.sharding import Mesh

    from unite_tpu.optim import factory as jfactory
    from unite_tpu.parallel import mesh as jmesh
    from unite_tpu.train.train_state import TrainState as JaxTrainState
    from unite_torch.utils.flax_bridge import flatten, flax_to_state_dict

    mesh = Mesh(np.asarray(jax.devices()[:2 * tp]).reshape(2, tp),
                ("data", "model"))
    tx, _ = jfactory.create_optimizer("adamw", lr=1e-3, params=params,
                                      weight_decay=0.05)
    tree = jmesh.state_layout(JaxTrainState.create(params, tx), mesh, tp=tp)
    by_key = {".".join(str(getattr(k, "key", k)) for k in path):
              tuple(s.spec) for path, s in
              jax.tree_util.tree_flatten_with_path(tree.params)[0]}
    names = list(flax_to_state_dict(params))
    keys = [".".join(k) for k in flatten(params)]
    assert len(keys) == len(names) == len(by_key)
    return {n: (k, by_key[k]) for n, k in zip(names, keys)}


def _port_tp_dims(model, tp: int):
    """name -> the dim of the port's weight that tensor parallelism splits
    (None: replicated), from ``tensor_parallel_`` on one fake rank."""
    from unite_torch.parallel import mesh as pm

    mesh = pm.Mesh(world=tp, rank=0, tp=tp, backend="gloo")
    _, rules, _ = pm.plan_layout(model, mesh, tp=tp)
    dims = {}
    for n, _ in model.named_parameters():
        r = rules.get(n)
        dims[n] = (None if r is None else 0 if isinstance(r, pm.HeadSplit)
                   else r.dim)
    return dims


def _jax_vit_params():
    import jax
    import jax.numpy as jnp

    from unite_tpu.models import vit as jvit

    jm = jvit.VisionTransformer(**S2_VIT)
    x = jnp.zeros((1, 4, 32, 32, 3), jnp.float32)
    return jm.init(jax.random.PRNGKey(0), x)["params"]


def _jax_student_params():
    import jax
    import jax.numpy as jnp

    from unite_tpu.models import adaptation as jad

    sj = jad.AdaptationVisionTransformer(**S1_STUDENT)
    x = jnp.zeros((1, 4, 32, 32, 3), jnp.float32)
    idx = jnp.zeros((1, 8), jnp.int32)
    return sj.init(jax.random.PRNGKey(0), x, idx, False)["params"]


@pytest.mark.parametrize("model", ["vit", "student"])
def test_tensor_parallel_rules_match_jax_leaf_by_leaf(model):
    from unite_torch.models.adaptation import AdaptationVisionTransformer
    from unite_torch.models.vit import VisionTransformer

    params = _jax_vit_params() if model == "vit" else _jax_student_params()
    port = (VisionTransformer(**S2_VIT) if model == "vit"
            else AdaptationVisionTransformer(**S1_STUDENT))
    specs = _jax_tp_specs(params, 2)
    dims = _port_tp_dims(port, 2)
    sharded = 0
    for name, (key, pspec) in specs.items():
        want = None
        if "model" in pspec:
            # a kernel [in, out]: 'model' on dim 1 is a column split (the
            # port's weight [out, in] by rows), on dim 0 a row split
            want = 0 if pspec.index("model") == 1 else 1
            sharded += 1
        assert dims[name] == want, (name, key, pspec, dims[name])
    depth = 2 if model == "vit" else 3
    assert sharded == 4 * depth  # qkv, proj, fc1, fc2 of every block


def test_zero1_moment_fraction_matches_jax_leaf_by_leaf():
    from unite_torch.models.vit import VisionTransformer
    from unite_torch.parallel import mesh as pm

    params = _jax_vit_params()
    import jax
    from jax.sharding import Mesh

    from unite_tpu.parallel import mesh as jmesh

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("data",))
    leaf = jmesh._zero1_leaf_spec(mesh, "data")
    from unite_torch.utils.flax_bridge import flatten, flax_to_state_dict

    port = dict(VisionTransformer(**S2_VIT).named_parameters())
    for name, arr in zip(flax_to_state_dict(params),
                         flatten(params).values()):
        spec = tuple(leaf(arr).spec)
        jax_frac = 1 / 8 if "data" in spec else 1.0
        dim = pm.zero1_dim(port[name].shape, 8)
        port_frac = 1.0 if dim is None else 1 / 8
        assert port_frac == jax_frac, name


def test_fsdp_with_tp_downgrades_to_zero1_moments(capsys):
    import jax
    from jax.sharding import Mesh

    from unite_tpu.parallel import mesh as jmesh
    from unite_tpu.train.train_state import TrainState as JaxTrainState
    from unite_tpu.optim import factory as jfactory

    params = _jax_vit_params()
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    tx, _ = jfactory.create_optimizer("adamw", lr=1e-3, params=params,
                                      weight_decay=0.05)
    state = JaxTrainState.create(params, tx)
    fsdp = jmesh.state_layout(state, mesh, tp=2, fsdp=True)
    z1 = jmesh.state_layout(state, mesh, tp=2, zero1=True)
    jax_msg = capsys.readouterr().out
    assert jax.tree.map(lambda s: s.spec, fsdp) == jax.tree.map(
        lambda s: s.spec, z1)
    # the port at the same request: the same message, the ZeRO-1 layout
    from unite_torch.models.vit import VisionTransformer
    from unite_torch.parallel import mesh as pm

    fake = pm.Mesh(world=4, rank=1, tp=2, backend="gloo")
    name, rules, z1 = pm.plan_layout(VisionTransformer(**S2_VIT), fake, tp=2,
                                     fsdp=True)
    assert name == "tp+zero1"
    assert "downgrades to ZeRO-1" in capsys.readouterr().out
    assert "downgrades to ZeRO-1" in jax_msg
    # TP weights keep the TP rule, the rest split their moments over the
    # data axis, rank 1 of 4 holding the first half (data index 0)
    assert set(z1).isdisjoint(rules)
    assert "blocks.0.attn.qkv.weight" in rules
    assert z1["patch_embed.proj.weight"] == (0, 0, 64)


def test_qkv_splits_by_heads():
    from unite_torch.parallel import mesh as pm

    heads, d, c = 4, 3, 5
    full = torch.arange(3 * heads * d * c, dtype=torch.float32).reshape(
        3 * heads * d, c)
    view = full.reshape(3, heads, d, c)
    for ways in (1, 2, 4):
        for idx in range(ways):
            rule = pm.HeadSplit(ways, None, idx)
            h = heads // ways
            want = view[:, idx * h:(idx + 1) * h].reshape(-1, c)
            torch.testing.assert_close(rule.local(full), want, rtol=0,
                                       atol=0)
    # a rank's rows are the packed [3, H/tp, D] layout of its heads: q of
    # its heads, then k, then v
    rule = pm.HeadSplit(2, None, 1)
    local = rule.local(full).reshape(3, 2, d, c)
    torch.testing.assert_close(local[1, 0], view[1, 2], rtol=0, atol=0)


@pytest.mark.parametrize("world,tp", [(2, 1), (4, 2)])
def test_rank_generators_draw_apart(tmp_path, world, tp):
    out = launch(world, "generators", tmp_path, {"tp": tp}, timeout=120)
    from unite_torch.train import common

    # rank 0 draws what one process draws
    g = torch.Generator().manual_seed(common.step_seed(1000, 0))
    torch.testing.assert_close(out[0]["draws"][0], torch.rand(8, generator=g),
                               rtol=0, atol=0)
    by_dp = {}
    for r in out:
        by_dp.setdefault(r["dp_rank"], []).append(r["draws"])
    firsts = [v[0] for v in by_dp.values()]
    # data-parallel ranks draw different masks, at every step
    for i in range(len(firsts)):
        for j in range(i + 1, len(firsts)):
            for s in range(2):
                assert not torch.equal(firsts[i][s], firsts[j][s])
    # the ranks of a tensor-parallel group draw alike
    for group in by_dp.values():
        for d in group[1:]:
            torch.testing.assert_close(d, group[0], rtol=0, atol=0)
