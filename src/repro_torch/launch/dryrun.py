"""Dry run of the port: every (architecture x input shape) traced on one
rank of the production mesh with no allocation (the reference package's
``launch/dryrun.py``, which lowers and compiles each pair with XLA).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b \\
        --shape decode_32k [--multi-pod] [--out runs/dryrun_torch.jsonl]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Each pair is one call of the port's own step (``make_train_step``,
``model.prefill`` or ``model.decode_step``) on ``meta`` tensors, counted
by ``launch/roofline.py``; the record carries the reference's keys
(``trace_s`` in place of its ``lower_s`` and ``compile_s``), one JSON
line each under ``--out``.

What a rank holds is what the port runs, not the reference's shards:
the port has no SPMD compiler (``partitioning.constrain`` is the
identity), so every rank holds every weight and its optimizer state,
its block of the batch's rows (``attention.batch_spec`` over the
``act_batch`` or ``cache_batch`` axes), and under ``decode_cp`` the
whole batch's activations against its block of the cache
(``model.shard_cache``).  Many records at 16 x 16 therefore need more
than one card's 80 GB: ``peak_mem_gib`` says so, as the port stands.

The mesh is ``launch/mesh.make_production_mesh`` over a process group of
the ``fake`` backend (``torch.testing._internal.distributed.fake_pg``:
collectives do nothing), 512 ranks, made by :func:`main` and never at
import; a caller may pass its own mesh.  Nothing is allocated on any
device: the parameters, optimizer state, caches and inputs are ``meta``
tensors, the hand-written kernels answer through their registered ops'
fake implementations, and no CUDA context is made (on the card,
``torch.cuda.memory_allocated()`` stays 0 in this process).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import multiprocessing
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.attention import batch_spec
from repro_torch.partitioning import mesh_shape, sharding_rules, \
    with_mesh_rules
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.trainer import make_train_step

WORLD = 512        # ranks of the fake group: both production meshes


def _dtype_policy(cfg, kind: str):
    """Params dtype: bf16 for serving; f32 (<10B) / bf16 (>=10B) for train.
    Adam moments: f32 below 100B, bf16 for the 671B MoE (DESIGN.md)."""
    if kind != "train":
        return torch.bfloat16, None
    big = cfg.param_count() >= 10e9
    huge = cfg.param_count() >= 100e9
    return (torch.bfloat16 if big else torch.float32,
            torch.bfloat16 if huge else torch.float32)


def build_rules(cfg, kind: str, mesh, multi_pod: bool,
                overrides: Optional[Dict[str, Any]] = None):
    """The reference's rules for (cfg, kind) on ``mesh``, with the mesh
    under ``"_mesh"``."""
    dims = mesh_shape(mesh)
    dm = dims.get("data", 1) * dims.get("model", 1)
    fsdp = kind == "train" and cfg.param_count() > 8e9
    expert_2d = (cfg.moe is not None and kind != "train"
                 and cfg.moe.num_experts % dm == 0)
    rules = sharding_rules(kind, multi_pod=multi_pod, fsdp=fsdp,
                           expert_2d=expert_2d, overrides=overrides)
    return with_mesh_rules(rules, mesh)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _tree(tree, leaf):
    if isinstance(tree, dict):
        return {k: _tree(v, leaf) for k, v in tree.items()}
    return leaf(tree)


def _rows(mesh, b: int, axes) -> int:
    """This rank's rows of a batch of ``b`` under ``batch_spec``."""
    spec = batch_spec(mesh, b, axes)
    return b // math.prod(mesh_shape(mesh)[a] for a in spec) if spec else b


@functools.lru_cache(maxsize=None)
def _production_mesh(multi_pod: bool):
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def build_dryrun(arch: str, shape_name: str, *, multi_pod: bool = False,
                 mesh=None, overrides: Optional[Dict[str, Any]] = None,
                 variant: Optional[Dict[str, Any]] = None):
    """Returns (fn, args: meta tensors of one rank) or raises ValueError
    for documented skips.  ``overrides`` adjusts sharding rules;
    ``variant`` adjusts ModelConfig fields (perf knobs)."""
    cfg = get_config(arch)
    if variant:
        cfg = dataclasses.replace(cfg, **variant)
    shape = INPUT_SHAPES[shape_name]
    ok, why = M.supports_shape(cfg, shape)
    if not ok:
        raise ValueError(f"SKIP {arch} x {shape_name}: {why}")
    mesh = mesh if mesh is not None else _production_mesh(multi_pod)
    kind = shape.kind
    rules = build_rules(cfg, kind, mesh, multi_pod, overrides)
    p_dtype, m_dtype = _dtype_policy(cfg, kind)
    params = _tree(M.model_spec(cfg, p_dtype),
                   lambda s: _meta(s.shape, s.dtype))
    b = shape.global_batch
    io = M.input_specs(cfg, shape)["specs"]
    if kind in ("train", "prefill"):
        b = _rows(mesh, b, rules["act_batch"])
    elif not M.transformer.context_parallel(
            cfg, mesh, M.decode_cache_len(cfg, shape)):
        b = _rows(mesh, b, rules["cache_batch"])
    batch = {k: _meta((b,) + tuple(s[1:]), dt) for k, (s, dt) in io.items()}

    if kind == "train":
        opt_cfg = opt_lib.AdamWConfig(moment_dtype=m_dtype)
        step_fn = make_train_step(cfg, opt_cfg, rules=rules,
                                  act_dtype=torch.bfloat16)
        opt_state = opt_lib.init(opt_cfg, params)
        return step_fn, (params, opt_state, batch)

    if kind == "prefill":
        cache_len = (min(cfg.sliding_window, shape.seq_len)
                     if cfg.sliding_window else None)

        def prefill_fn(params, batch):
            return M.prefill(params, cfg, batch, rules=rules,
                             act_dtype=torch.bfloat16, cache_len=cache_len)

        return prefill_fn, (params, batch)

    cache_len = M.decode_cache_len(cfg, shape)
    cache_seq = cache_len if cfg.family != "ssm" else 8
    shapes, _ = M.cache_struct(cfg, shape.global_batch, cache_seq,
                               dtype=torch.bfloat16)
    cache = {k: tuple(_meta(s, dt) for s, dt in leaves)
             for k, leaves in shapes.items()}
    local, rules = M.shard_cache(cfg, cache, rules)
    if local is cache:          # not context-parallel: the rank's rows
        local = {k: tuple(_meta((t.shape[0], b) + tuple(t.shape[2:]),
                                t.dtype) for t in leaves)
                 for k, leaves in cache.items()}

    def decode_fn(params, cache, batch):
        return M.decode_step(params, cfg, cache, batch, rules=rules,
                             act_dtype=torch.bfloat16)

    return decode_fn, (params, local, batch)


def memory_floor_bytes(cfg, kind: str, held: float, tokens: float) -> float:
    """The reference's analytic HBM-traffic floor (``dryrun.py:176-186``):
    the rank's parameters, optimizer state and cache (``held`` bytes)
    read once in serving; in training 2.5 times them plus three bf16
    passes over each layer's activations of the rank's ``tokens``."""
    if kind == "train":
        return 2.5 * held + cfg.num_layers * tokens * cfg.d_model * 6
    return held


def static_bytes(args) -> int:
    """Bytes of every tensor in ``args``."""
    leaves, _ = tree_flatten(args)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               verbose: bool = True,
               overrides: Optional[Dict[str, Any]] = None,
               variant: Optional[Dict[str, Any]] = None,
               mesh=None) -> dict:
    """The reference's record for one pair: status ok, skipped (with
    its ``SKIP`` reason) or error (with the traceback's tail),
    ``static_mem_gib`` (the rank's arguments), ``t_memory_lb_s``, the
    roofline's keys, ``trace_s``, ``model_flops_global`` and
    ``useful_flops_frac``."""
    label = ("2x16x16" if multi_pod else "16x16") if mesh is None \
        else "x".join(str(n) for n in mesh.devices.shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": label, "status": "ok"}
    if overrides:
        rec["overrides"] = {k: str(v) for k, v in overrides.items()}
    if variant:
        rec["variant"] = {k: str(v) for k, v in variant.items()}
    t0 = time.time()
    try:
        fn, args = build_dryrun(arch, shape_name, multi_pod=multi_pod,
                                mesh=mesh, overrides=overrides,
                                variant=variant)
        static = static_bytes(args)
        rec["static_mem_gib"] = round(static / 2 ** 30, 3)
        cfg0 = get_config(arch)
        shape = INPUT_SHAPES[shape_name]
        batch = args[-1]
        rank_tokens = batch["tokens"].numel()
        rec["t_memory_lb_s"] = round(memory_floor_bytes(
            cfg0, shape.kind, static, rank_tokens) / rl.HBM_BW, 6)
        roof = rl.analyze(fn, *args)
        rec.update(roof.as_dict())
        rec["trace_s"] = round(time.time() - t0, 1)
        n_dev = (math.prod(mesh.devices.shape) if mesh is not None
                 else (512 if multi_pod else 256))
        tokens = (shape.global_batch * shape.seq_len
                  if shape.kind in ("train", "prefill")
                  else shape.global_batch)
        mult = 6 if shape.kind == "train" else 2
        rec["model_flops_global"] = float(
            mult * cfg0.active_param_count() * tokens)
        per_dev_model = rec["model_flops_global"] / n_dev
        rec["useful_flops_frac"] = (per_dev_model / rec["flops_per_device"]
                                    if rec["flops_per_device"] else None)
    except Exception as e:   # a record per pair: the sweep goes on
        if isinstance(e, ValueError) and str(e).startswith("SKIP"):
            rec["status"], rec["reason"] = "skipped", str(e)
        else:
            rec["status"] = "error"
            rec["error"] = traceback.format_exc()[-2000:]
        if verbose:
            print(rec.get("reason") or rec["error"])
    rec["total_s"] = round(time.time() - t0, 1)
    if verbose and rec["status"] == "ok":
        print(f"--- {arch} x {shape_name} mesh={rec['mesh']}")
        print(json.dumps(rec, default=str))
    return rec


def init_fake_group(world: int = WORLD) -> None:
    """A process group of the ``fake`` backend with ``world`` ranks (this
    process rank 0), unless one exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)


def cuda_footprint() -> Tuple[bool, int]:
    """(whether this process made a CUDA context, the bytes it holds on
    the card), read without making one."""
    made = torch.cuda.is_initialized()
    return made, torch.cuda.memory_allocated() if made else 0


def summary_line(n: int, n_fail: int, footprints) -> str:
    """The launchers' last line: records, errors, and whether any of
    their processes touched the card."""
    return json.dumps({"records": n, "errors": n_fail,
                       "cuda_initialized": any(f[0] for f in footprints),
                       "memory_allocated": max(f[1] for f in footprints)})


def _job(job):
    i, arch, shape, multi_pod = job
    init_fake_group()
    return i, dryrun_one(arch, shape, multi_pod=multi_pod), cuda_footprint()


def _trace_cost(job) -> int:
    """A job's relative trace time: its layers, three passes to train."""
    _, arch, shape, _ = job
    return (get_config(arch).num_layers
            * (3 if INPUT_SHAPES[shape].kind == "train" else 1))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes (records in order)")
    args = ap.parse_args()

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]

    jobs = [(i, a, s, mp) for i, (a, s, mp) in enumerate(
        (a, s, mp) for a in archs for s in shapes for mp in meshes)]
    pool = (multiprocessing.get_context("spawn").Pool(args.jobs)
            if args.jobs > 1 else None)
    # workers take the longest traces first; records are written in order
    results = (pool.imap_unordered(_job, sorted(jobs, key=_trace_cost,
                                                reverse=True))
               if pool else map(_job, jobs))
    n_fail, footprints, done, written = 0, [cuda_footprint()], {}, 0
    for i, rec, fp in results:
        footprints.append(fp)
        n_fail += rec["status"] == "error"
        done[i] = rec
        while written in done:
            ready = done.pop(written)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(ready, default=str) + "\n")
            written += 1
    if pool:
        pool.close()
        pool.join()
    footprints.append(cuda_footprint())
    print(summary_line(len(jobs), n_fail, footprints), flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} dry-run failures")


if __name__ == "__main__":
    main()
