"""The port's dry run and hillclimb (``repro_torch/launch/dryrun.py``,
``hillclimb.py``) against the reference's, on the CPU:

- ``dryrun_one`` for every arch of ``configs/`` (its ``reduced()``
  fields as the ``variant``) and every ``INPUT_SHAPES`` entry, in a
  subprocess over a fake group of 8 ranks as a (data 2, model 4) mesh:
  every key of the reference's record (``trace_s`` for its ``lower_s``
  and ``compile_s``), the status and ``SKIP`` reason of the reference's
  ``supports_shape``, the reference's ``model_flops_global`` (its
  formula on its arch's config, as the reference computes it whatever
  the variant), no error, and no CUDA context made;
- the launcher as the README runs it (smollm-135m x decode_32k at full
  width on meta tensors): a record with every key, no CUDA context;
- the context-parallel decode's collectives on that mesh;
- ``hillclimb.PAIRS``: the reference's pairs, names, archs, shapes,
  overrides and variants (read from its source: importing it would set
  ``XLA_FLAGS`` for the whole test process);
- the facade's ``rules=``: ``make_train_step``, ``model.loss_fn`` and
  ``model.prefill`` give the same values with rules as without.
"""
import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.launch import hillclimb
from repro_torch.models import model as M
from repro_torch.partitioning import sharding_rules, with_mesh_rules
from repro_torch.train import optimizer as O
from repro_torch.train import trainer as TR

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
REF_KEYS = {"arch", "shape", "mesh", "status", "static_mem_gib",
            "t_memory_lb_s", "flops_per_device", "hbm_bytes_per_device",
            "collective_bytes_per_device", "collective_by_op",
            "peak_mem_gib", "t_compute_s", "t_memory_s", "t_collective_s",
            "dominant", "model_flops_global", "useful_flops_frac",
            "total_s"}
PORT_KEYS = REF_KEYS | {"trace_s"}       # the reference's lower_s, compile_s


def _run(script: str) -> list:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(script)],
                         env=ENV, capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


@pytest.fixture(scope="module")
def reduced_records():
    lines = _run("""
        import dataclasses, json, torch
        from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_test_mesh
        dryrun.init_fake_group(8)
        mesh = make_test_mesh((2, 4), device_type="cpu")
        def reduced(arch, **kw):
            cfg = get_config(arch).reduced()
            return {f.name: getattr(cfg, f.name)
                    for f in dataclasses.fields(cfg)} | kw
        for arch in ARCH_IDS:
            for shape in INPUT_SHAPES:
                print(json.dumps(dryrun.dryrun_one(
                    arch, shape, mesh=mesh, verbose=False,
                    variant=reduced(arch)), default=str))
        rec = dryrun.dryrun_one(
            "qwen2.5-14b", "decode_32k", mesh=mesh, verbose=False,
            variant=reduced("qwen2.5-14b", decode_cp=True))
        print(json.dumps(rec, default=str))
        print(torch.cuda.is_initialized())
        """)
    assert lines[-1] == "False"
    return [json.loads(line) for line in lines[-2 - 4 * len(ARCH_IDS):-1]]


def test_reduced_records_match_the_reference(reduced_records):
    recs = reduced_records[:-1]
    assert [(r["arch"], r["shape"]) for r in recs] == [
        (a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    assert list(INPUT_SHAPES) == list(JAX_SHAPES)
    for rec in recs:
        jcfg = jax_config(rec["arch"])
        shape = JAX_SHAPES[rec["shape"]]
        ok, why = JM.supports_shape(jcfg.reduced(), shape)
        if not ok:
            assert rec["status"] == "skipped"
            assert rec["reason"] == (f"SKIP {rec['arch']} x {rec['shape']}: "
                                     f"{why}")
            continue
        assert rec["status"] == "ok", rec.get("error")
        assert PORT_KEYS <= set(rec), PORT_KEYS - set(rec)
        assert rec["mesh"] == "2x4"
        tokens = (shape.global_batch * shape.seq_len
                  if shape.kind in ("train", "prefill")
                  else shape.global_batch)
        mult = 6 if shape.kind == "train" else 2
        assert rec["model_flops_global"] == float(
            mult * jcfg.active_param_count() * tokens)
        assert rec["flops_per_device"] > 0 and rec["peak_mem_gib"] > 0
        assert rec["peak_mem_gib"] >= rec["static_mem_gib"] - 1e-3
        assert rec["collective_bytes_per_device"] == 0


def test_context_parallel_decode_counts_its_merge(reduced_records):
    cp = reduced_records[-1]
    base = next(r for r in reduced_records
                if (r["arch"], r["shape"]) == ("qwen2.5-14b", "decode_32k"))
    assert cp["status"] == "ok", cp.get("error")
    assert cp["collective_by_op"]["all-reduce"] > 0
    assert set(k for k, v in cp["collective_by_op"].items() if v) == {
        "all-reduce"}
    # a quarter of the slots of half the rows: the cache's share of the
    # rank's arguments falls
    assert cp["static_mem_gib"] < base["static_mem_gib"]


def test_launcher_record_at_full_width():
    lines = _run("""
        import runpy, sys, tempfile, os, torch
        out = os.path.join(tempfile.mkdtemp(), "rec.jsonl")
        sys.argv = ["dryrun", "--arch", "smollm-135m", "--shape",
                    "decode_32k", "--out", out]
        runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
        print(open(out).read().strip())
        print(torch.cuda.is_initialized())
        """)
    assert lines[-1] == "False"
    rec = json.loads(lines[-2])
    assert rec["status"] == "ok" and PORT_KEYS <= set(rec)
    assert rec["mesh"] == "16x16"
    cfg = get_config("smollm-135m")
    # every weight in bf16 and 8 of the 128 rows of a 32k bf16 cache
    cache = 2 * cfg.num_layers * 8 * 32768 * cfg.num_kv_heads \
        * cfg.head_dim * 2
    assert rec["static_mem_gib"] == pytest.approx(
        (2 * cfg.param_count() + cache) / 2 ** 30, abs=2e-3)
    assert rec["dominant"] == "memory"


def _ref_pairs():
    path = os.path.join(ROOT, "src", "repro", "launch", "hillclimb.py")
    tree = ast.parse(open(path).read())
    for node in tree.body:
        if isinstance(node, ast.AnnAssign) and node.target.id == "PAIRS":
            return ast.literal_eval(node.value)
    raise AssertionError("no PAIRS in the reference's hillclimb")


def test_hillclimb_pairs_are_the_reference_s():
    ref = _ref_pairs()
    assert list(hillclimb.PAIRS) == list(ref)
    for pair, variants in ref.items():
        port = hillclimb.PAIRS[pair]
        assert [(n, a, s, o, v) for n, a, s, _, o, v in port] == [
            (n, a, s, o, v) for n, a, s, _, o, v in variants]
        for _, _, _, hyp, _, _ in port:
            assert "TPU" not in hyp and "v5e" not in hyp


def test_rules_reach_the_facade_without_changing_values():
    cfg = get_config("smollm-135m").reduced(num_layers=2, d_model=64)
    params = M.init_params(cfg, seed=0, device="cpu")

    class Mesh:
        axis_names = ("data", "model")
        devices = torch.zeros(1, 1)

    rules = with_mesh_rules(sharding_rules("train"), Mesh())
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                           dtype=torch.int32)
    f32 = torch.float32
    plain = M.loss_fn(params, cfg, {"tokens": tokens}, act_dtype=f32)
    ruled = M.loss_fn(params, cfg, {"tokens": tokens}, rules=rules,
                      act_dtype=f32)
    assert torch.equal(plain[0], ruled[0])
    batch = {"tokens": tokens, "lengths": torch.tensor([16, 9])}
    a = M.prefill(params, cfg, batch, act_dtype=f32)
    b = M.prefill(params, cfg, batch, rules=rules, act_dtype=f32)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1]["kv"], b[1]["kv"]))
    opt_cfg = O.AdamWConfig()
    outs = [TR.make_train_step(cfg, opt_cfg, rules=r, act_dtype=f32)(
        params, O.init(opt_cfg, params), {"tokens": tokens})
        for r in (None, rules)]
    assert torch.equal(outs[0][2]["loss"], outs[1][2]["loss"])
    assert all(torch.equal(x, y) for x, y in zip(
        O.tree_leaves(outs[0][0]), O.tree_leaves(outs[1][0])))
