"""The context-parallel decode (``models/attention.py``
``gqa_decode_attention_cp``, the reference's ``shard_map`` flash-decode)
on torch ``DeviceMesh``es of 4 CPU processes over gloo, against the JAX
reference on one device:

- the attention alone, with the reference's shapes (B 4, S 64, Hq 8,
  Hkv 2, D 32, lengths [64, 13, 40, 1]; ``tests/test_partitioning.py``'s
  snippet), against JAX's single-device ``gqa_decode_attention`` at
  1e-5, on a (1, 4) mesh (the sequence over 4 ranks) and a (2, 2) mesh
  (the batch over data, the sequence over model);
- two ``decode_step``s of a reduced ``decode_cp`` chatglm-6b on each
  mesh (the cache placed by ``model.shard_cache``; the second step's
  slot wraps the ring) against JAX's ``decode_step`` with the flag on,
  at 2e-4 of scale (f32), the ranks' blocks reassembled into the
  reference's cache; the same with the whole cache on every rank (no
  ``shard_cache``); and its int8 form against JAX's int8
  ``decode_step`` at the int8 decode's 1e-4 of scale
  (``tests/test_torch_int8_decode.py``), the int8 values within one
  step and the scales within one bf16 step;
- a ``cuda``-marked test of the partial kernel against its plain
  version.

Each mesh's four ranks are one subprocess each (they import torch and
the port only), started once for the module; they are joined with a
timeout and killed on failure, so a hang fails these tests instead of
cutting the suite."""
import dataclasses
import functools
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops, ref

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MESHES = ((1, 4), (2, 2))
B, S, HQ, HKV, D = 4, 64, 8, 2, 32
LENGTHS = (64, 13, 40, 1)
ATTN_TOL = 1e-5       # the reference's own bound (test_partitioning.py)
TOL = 2e-4            # f32 decode_step, of scale
INT8_TOL = 1e-4       # int8 decode_step, of scale (test_torch_int8_decode)
POSITIONS = (63, 12, 39, 0)   # step 2 writes row 0 at 64 % 64 = slot 0
JOIN_S = 120

WORKER = r"""
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, port, d_ext, m_ext, inp, out = sys.argv[1:]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
import dataclasses
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import model as M
from repro_torch.models.attention import batch_spec, gqa_decode_attention_cp
from repro_torch.partitioning import (shard_local, sharding_rules,
                                      with_mesh_rules)
mesh = make_test_mesh((int(d_ext), int(m_ext)), ("data", "model"))
data = dict(np.load(inp))
t = lambda k: torch.from_numpy(data[k])
res = {"coord": np.array([mesh.get_local_rank("data"),
                          mesh.get_local_rank("model")])}

# the attention alone
spec = (batch_spec(mesh, data["k"].shape[0]), "model")
k, v = (shard_local(t(n), spec, mesh).contiguous() for n in ("k", "v"))
ops.reset_counts()
res["attn"] = gqa_decode_attention_cp(t("q"), k, v, t("lengths"),
                                      mesh=mesh).numpy()
res["attn_partial_calls"] = np.array(ops.decode_attention_partial.plain_calls)

# two decode steps of the reduced model, f32 and int8
params = {}
for key in data:
    if key.startswith("p/"):
        node = params
        parts = key[2:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t(key)
base = dataclasses.replace(get_config("chatglm-6b").reduced(),
                           decode_cp=True)
for tag, cfg in (("f32", base),
                 ("int8", dataclasses.replace(base, cache_int8=True))):
    if tag == "f32":
        cache = {"kv": (t("ck"), t("cv"))}
    else:
        cache = {"kv": (t("ck8"), t("cv8"), t("cks").to(torch.bfloat16),
                        t("cvs").to(torch.bfloat16))}
    mrules = with_mesh_rules(sharding_rules("decode"), mesh)
    local, drules = M.shard_cache(cfg, cache, mrules)
    assert drules == dict(mrules, _kv_len=data["ck"].shape[2]), \
        "the cache was not sequence-sharded"
    pos = t("positions")
    ops.reset_counts()
    for step in range(2):
        logits, local = M.decode_step(
            params, cfg, local, {"tokens": t("tokens")[step],
                                 "positions": pos + step},
            rules=drules, act_dtype=torch.float32)
        res[f"{tag}_logits{step}"] = logits.numpy()
    calls = (ops.decode_attention_partial.plain_calls
             + ops.decode_attention_int8_partial.plain_calls)
    res[f"{tag}_partial_calls"] = np.array(calls)
    res[f"{tag}_dense_calls"] = np.array(
        ops.decode_attention.plain_calls
        + ops.decode_attention_int8.plain_calls)
    for i, leaf in enumerate(local["kv"]):
        res[f"{tag}_kv{i}"] = leaf.float().numpy()

# the whole f32 cache on every rank, under the mesh's rules alone
cache = {"kv": (t("ck").clone(), t("cv").clone())}
mrules = with_mesh_rules(sharding_rules("decode"), mesh)
ops.reset_counts()
for step in range(2):
    logits, cache = M.decode_step(
        params, base, cache, {"tokens": t("tokens")[step],
                              "positions": t("positions") + step},
        rules=mrules, act_dtype=torch.float32)
    res[f"whole_logits{step}"] = logits.numpy()
res["whole_partial_calls"] = np.array(ops.decode_attention_partial.plain_calls)
for i, leaf in enumerate(cache["kv"]):
    res[f"whole_kv{i}"] = leaf.numpy()
np.savez(f"{out}/rank{rank}.npz", **res)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@functools.lru_cache(maxsize=None)
def _inputs():
    """Seeded numpy inputs for both parts, and the reference's weights."""
    rng = np.random.default_rng(0)
    jcfg = dataclasses.replace(jax_config("chatglm-6b").reduced(),
                               decode_cp=True)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    kv_shape = (jcfg.num_layers, B, S, jcfg.num_kv_heads, jcfg.head_dim)
    ck, cv = (rng.standard_normal(kv_shape).astype(np.float32)
              for _ in range(2))
    (k8, ks), (v8, vs) = (JT._quant_i8(jnp.asarray(a)) for a in (ck, cv))
    data = {"q": rng.standard_normal((B, 1, HQ, D)).astype(np.float32),
            "k": rng.standard_normal((B, S, HKV, D)).astype(np.float32),
            "v": rng.standard_normal((B, S, HKV, D)).astype(np.float32),
            "lengths": np.array(LENGTHS, np.int32),
            "ck": ck, "cv": cv,
            "ck8": np.asarray(k8), "cv8": np.asarray(v8),
            "cks": np.asarray(ks.astype(jnp.float32)),
            "cvs": np.asarray(vs.astype(jnp.float32)),
            "tokens": rng.integers(3, jcfg.vocab_size,
                                   (2, B)).astype(np.int32),
            "positions": np.array(POSITIONS, np.int32)}
    data.update({f"p{k}": v for k, v in
                 _flat(jax.tree.map(np.asarray, jp)).items()})
    return jcfg, jp, data


@functools.lru_cache(maxsize=None)
def _run(mesh, tmp):
    """Start the four ranks of ``mesh``, join them within ``JOIN_S``
    seconds (killing all of them on any failure) and return each rank's
    results, by rank."""
    _, _, data = _inputs()
    inp = os.path.join(tmp, "inputs.npz")
    if not os.path.exists(inp):
        np.savez(inp, **data)
    out = os.path.join(tmp, f"out{mesh[0]}x{mesh[1]}")
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "4", str(port),
         str(mesh[0]), str(mesh[1]), inp, out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    assert rcs == [0] * 4, f"ranks exited {rcs}:\n" + "\n".join(
        log[-2000:] for log in logs)
    return [dict(np.load(os.path.join(out, f"rank{r}.npz")))
            for r in range(4)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cp"))
    return lambda mesh: _run(mesh, tmp)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("mesh", MESHES, ids=["1x4", "2x2"])
def test_cp_attention_matches_jax_single_device(ranks, mesh):
    """Every rank returns every row, within 1e-5 of JAX's single-device
    decode attention over the whole cache, each from one partial (the
    plain version here)."""
    _, _, data = _inputs()
    want = np.asarray(JA.gqa_decode_attention(
        jnp.asarray(data["q"]), jnp.asarray(data["k"]),
        jnp.asarray(data["v"]), jnp.asarray(data["lengths"])))
    for res in ranks(mesh):
        assert int(res["attn_partial_calls"]) == 1
        assert np.abs(res["attn"] - want).max() < ATTN_TOL


def _reassemble(results, key, mesh):
    """The whole [L, B, S, ...] cache leaf from the ranks' blocks."""
    blocks = {tuple(r["coord"]): r[key] for r in results}
    return np.concatenate(
        [np.concatenate([blocks[(d, m)] for m in range(mesh[1])], axis=2)
         for d in range(mesh[0])], axis=1)


def _jax_steps(jcfg, jp, cache, data):
    logits = []
    for step in range(2):
        lg, cache = JM.decode_step(jp, jcfg, cache, {
            "tokens": jnp.asarray(data["tokens"][step]),
            "positions": jnp.asarray(data["positions"] + step)},
            act_dtype=jnp.float32)
        logits.append(np.asarray(lg))
    return logits, [np.asarray(a, np.float32) for a in cache["kv"]]


@pytest.mark.parametrize("mesh", MESHES, ids=["1x4", "2x2"])
def test_cp_decode_step_matches_jax(ranks, mesh):
    """Two f32 ``decode_step``s on the mesh: every rank's logits at 2e-4
    of scale of JAX's ``decode_step`` (flag on, one device), the cache
    blocks reassembled into JAX's cache after both steps (the new K/V
    written once, by the rank holding its slot), the attention through
    the partial every layer and step, never the dense decode."""
    jcfg, jp, data = _inputs()
    want, jkv = _jax_steps(jcfg, jp, {"kv": (jnp.asarray(data["ck"]),
                                             jnp.asarray(data["cv"]))}, data)
    results = ranks(mesh)
    for res in results:
        for step in range(2):
            _close(res[f"f32_logits{step}"], want[step], TOL)
        assert int(res["f32_partial_calls"]) == 2 * jcfg.num_layers
        assert int(res["f32_dense_calls"]) == 0
    for i in range(2):
        _close(_reassemble(results, f"f32_kv{i}", mesh), jkv[i], TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=["1x4", "2x2"])
def test_cp_decode_step_on_a_whole_cache_matches_jax(ranks, mesh):
    """The same two f32 steps with the whole cache on every rank and the
    mesh's rules as they come from ``with_mesh_rules`` (no
    ``shard_cache``): each rank writes the new K/V into its whole cache
    and attends through its block of it, so every rank's logits and
    whole cache equal JAX's at 2e-4 of scale."""
    jcfg, jp, data = _inputs()
    want, jkv = _jax_steps(jcfg, jp, {"kv": (jnp.asarray(data["ck"]),
                                             jnp.asarray(data["cv"]))}, data)
    for res in ranks(mesh):
        for step in range(2):
            _close(res[f"whole_logits{step}"], want[step], TOL)
        assert int(res["whole_partial_calls"]) == 2 * jcfg.num_layers
        for i in range(2):
            _close(res[f"whole_kv{i}"], jkv[i], TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=["1x4", "2x2"])
def test_cp_int8_decode_step_matches_jax(ranks, mesh):
    """The int8 cache on the mesh: logits within 1e-4 of scale of JAX's
    int8 ``decode_step`` (which dequantises to bf16 before its float
    attention; the port's partial kernel dequantises in f32), the
    reassembled int8 values within one step and the scales within one
    bf16 step."""
    jcfg, jp, data = _inputs()
    jcfg8 = dataclasses.replace(jcfg, cache_int8=True)
    cache = {"kv": (jnp.asarray(data["ck8"]), jnp.asarray(data["cv8"]),
                    jnp.asarray(data["cks"]).astype(jnp.bfloat16),
                    jnp.asarray(data["cvs"]).astype(jnp.bfloat16))}
    want, jkv = _jax_steps(jcfg8, jp, cache, data)
    results = ranks(mesh)
    for res in results:
        for step in range(2):
            _close(res[f"int8_logits{step}"], want[step], INT8_TOL)
        assert int(res["int8_partial_calls"]) == 2 * jcfg.num_layers
        assert int(res["int8_dense_calls"]) == 0
    for i in range(4):
        got = _reassemble(results, f"int8_kv{i}", mesh)
        if i < 2:
            assert np.abs(got - jkv[i]).max() <= 1
        else:
            np.testing.assert_allclose(got, jkv[i], atol=0, rtol=2 ** -7)


def test_partial_plain_version_merges_to_the_dense_oracle():
    """Two shards' partials (m in natural log, an empty shard's m =
    -inf, l = 0, no NaN), merged by max and sums as the ranks merge
    them, equal the dense plain decode over the whole cache; the int8
    form equals the int8 oracle."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, HQ, D, generator=g)
    k, v = (torch.randn(B, S, HKV, D, generator=g) for _ in range(2))
    lengths = torch.tensor((64, 13, 40, 0))
    want = ref.decode_attention_ref(q, k, v, lengths)
    parts = [ref.decode_attention_partial_ref(
        q, k[:, i * 32:(i + 1) * 32], v[:, i * 32:(i + 1) * 32],
        torch.clamp(lengths - i * 32, 0, 32)) for i in range(2)]
    o1, m1, l1 = parts[1]
    assert torch.isneginf(m1[1]).all() and (l1[1] == 0).all()
    assert torch.isfinite(o1).all()
    m = torch.maximum(parts[0][1], parts[1][1])
    corr = [torch.where(torch.isneginf(p[1]), torch.zeros_like(p[1]),
                        torch.exp(p[1] - m)) for p in parts]
    lsum = sum(p[2] * c for p, c in zip(parts, corr))
    osum = sum(p[0] * c[..., None] for p, c in zip(parts, corr))
    got = osum / torch.clamp(lsum[..., None], min=1e-30)
    torch.testing.assert_close(got[:3], want[:3], atol=1e-6, rtol=0)
    assert torch.equal(got[3], torch.zeros_like(got[3]))
    k8 = torch.randint(-127, 128, (B, S, HKV, D), generator=g,
                       dtype=torch.int8)
    sc = torch.rand(B, S, HKV, generator=g).to(torch.bfloat16)
    o, mm, ll = ref.decode_attention_int8_partial_ref(q, k8, k8, sc, sc,
                                                      lengths)
    want8 = ref.decode_attention_int8_ref(q, k8, k8, sc, sc, lengths)
    _close((o / ll[..., None].clamp(min=1e-30))[:3], want8[:3], 1e-6)


@pytest.mark.parametrize("b,s", [(4, 64), (1, 16384)])
def test_partial_launch_plans_no_output(b, s):
    """The partial wrappers' host plan (``kernel.decode_plan`` with
    ``output=False``) allocates no q-dtype output, only the split
    scratch the dense plan would, at the reference's shapes and at a
    decode_32k shard's."""
    from repro_torch.kernels.decode_attention import kernel
    q = torch.zeros(b, 48, 128)
    k = torch.zeros(b, s, 8, 128)
    lengths = torch.full((b,), s, dtype=torch.int32)
    dense = kernel.decode_plan(q, k, lengths, 132)
    splits, out, *scratch = kernel.decode_plan(q, k, lengths, 132,
                                               output=False)
    assert out is None and dense[1].shape == q.shape
    assert splits == dense[0] > 1
    for x, y in zip(scratch, dense[2:]):
        assert (x is None) == (y is None)
        assert x is None or x.shape == y.shape


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1e-3)])
def test_cuda_partial_kernel_matches_plain_version(dtype, tol):
    """The decode kernel's partial mode against its plain version on the
    card, float and int8 shards, one split and many, an empty shard's
    rows (m = -inf, l = 0, o = 0); then poison past the lengths, which
    must change nothing.  m and l against the plain version's at ``tol``
    of their scale, o at ``tol`` of its scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    for b, s, hq, hkv, d in ((4, 64, 8, 2, 32), (2, 16384, 48, 8, 128),
                             (1, 4096, 8, 8, 64)):
        q = torch.randn(b, hq, d, device="cuda", generator=g).to(dtype)
        k, v = (torch.randn(b, s, hkv, d, device="cuda",
                            generator=g).to(dtype) for _ in range(2))
        lengths = torch.randint(0, s + 1, (b,), device="cuda",
                                generator=g, dtype=torch.int32)
        lengths[0] = 0
        for fn, args in (
                (ops.decode_attention_partial, (q, k, v, lengths)),
                (ops.decode_attention_int8_partial,
                 (q, k.float().clamp(-127, 127).to(torch.int8),
                  v.float().clamp(-127, 127).to(torch.int8),
                  torch.rand(b, s, hkv, device="cuda",
                             generator=g).to(torch.bfloat16),
                  torch.rand(b, s, hkv, device="cuda",
                             generator=g).to(torch.bfloat16), lengths))):
            n0 = fn.launches
            got = fn(*args)
            assert fn.launches == n0 + 1
            plain = (ref.decode_attention_partial_ref
                     if fn is ops.decode_attention_partial
                     else ref.decode_attention_int8_partial_ref)
            want = plain(*args)
            torch.cuda.synchronize()
            assert torch.isneginf(got[1][0]).all() and (got[2][0] == 0).all()
            for x, y in zip(got, want):
                live = torch.isfinite(y)
                assert torch.equal(torch.isfinite(x), live)
                if live.any():
                    err = (x[live] - y[live]).abs().max().item()
                    assert err <= tol * max(1.0,
                                            y[live].abs().max().item())
            for i, n in enumerate(lengths.tolist()):
                args[1][i, n:] = float("nan") if args[1].is_floating_point() \
                    else 127
            again = fn(*args)
            assert all(torch.equal(x, y) for x, y in zip(again, got))
