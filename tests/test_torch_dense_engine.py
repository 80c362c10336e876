"""The PyTorch port's padded-batch engines against the JAX reference on
the CPU, with the reference's weights carried across by
``params_from_numpy`` and the same requests:

- ``BatchEngine``: generated streams, ``iterations``, ``batch_length``,
  ``wma``, ``total_tokens``, ``valid_tokens`` and ``host_syncs`` equal
  the JAX engine's (the reference's test_serving.py request-waiting and
  test_fused_decode.py sync-count tests, mirrored);
- ``ContinuousEngine`` run in lockstep with the JAX one: the same tokens
  at every step and the same finish order;
- ``run_engine_backend`` forms the same batches with the same WMA as the
  JAX launcher for ``vs``, ``glp`` and ``magnus`` (only HRRN's order
  depends on measured wall time, so order and rates are not compared);
- the Magnus pipeline end to end on the port's engine (the reference's
  test_system.py, mirrored), and ``main()``'s routing of padded and
  paged strategies.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.types import Batch as JaxBatch
from repro.launch import serve as jax_serve
from repro.models import model as JM
from repro.serving.engine import BatchEngine as JaxBatchEngine
from repro.serving.engine import ContinuousEngine as JaxContinuousEngine
from repro.workload import apps as jax_apps
from repro_torch.configs import get_config
from repro_torch.core.magnus import MagnusConfig, MagnusService
from repro_torch.core.predictor import GenerationLengthPredictor
from repro_torch.core.types import Batch
from repro_torch.core.wma import MemoryModel, batch_wma
from repro_torch.launch import serve
from repro_torch.params import params_from_numpy
from repro_torch.serving.engine import BatchEngine, ContinuousEngine
from repro_torch.workload import apps

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

JCFG = jax_config("smollm-135m").reduced()
CFG = get_config("smollm-135m").reduced()
RESULT_FIELDS = ("iterations", "batch_size", "batch_length", "wma",
                 "total_tokens", "valid_tokens")


@functools.lru_cache(maxsize=None)
def _params():
    jp = JM.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _reqs(mod, n, max_gen=10, seed=0):
    reqs = mod.make_dataset(2, seed=seed)[:n]
    for i, r in enumerate(reqs):
        r.gen_length = 3 + (i * 3) % max_gen
    return reqs


@pytest.mark.parametrize("n,seed,max_gen", [(4, 0, 16), (3, 4, 12),
                                            (1, 1, 8)])
def test_batch_engine_matches_jax(n, seed, max_gen):
    """Same batch, same weights: identical streams and counters; every
    request decodes for G(B) iterations (request waiting) and the WMA is
    the paper's Eqs. 2-4; one readback per power-of-two window."""
    jp, tp = _params()
    jreqs, treqs = _reqs(jax_apps, n, seed=seed), _reqs(apps, n, seed=seed)
    je = JaxBatchEngine(JCFG, params=jp, max_gen=max_gen)
    te = BatchEngine(CFG, params=tp, max_gen=max_gen, device="cpu")
    jres = je.serve_batch(JaxBatch(requests=jreqs))
    tres = te.serve_batch(Batch(requests=treqs))
    for name in RESULT_FIELDS:
        assert getattr(tres, name) == getattr(jres, name), name
    assert [tres.generated[r.req_id] for r in treqs] == \
        [jres.generated[r.req_id] for r in jreqs]
    assert te.host_syncs == je.host_syncs == bin(tres.iterations).count("1")
    bg = max(min(r.gen_length, max_gen) for r in treqs)
    assert tres.iterations == bg
    assert tres.total_tokens == n * bg
    assert tres.wma == batch_wma(
        [min(r.length, tres.batch_length) for r in treqs],
        [min(r.gen_length, max_gen) for r in treqs])
    for r in treqs:
        assert len(tres.generated[r.req_id]) == min(r.gen_length, max_gen)


def test_batch_engine_outputs_match_singleton():
    """Batched (padded) greedy decode matches each request decoded
    alone: the pads never leak into a row."""
    _, tp = _params()
    reqs = _reqs(apps, 3, seed=1)
    eng = BatchEngine(CFG, params=tp, max_gen=8, device="cpu")
    batched = eng.serve_batch(Batch(requests=reqs))
    for r in reqs:
        solo = eng.serve_batch(Batch(requests=[r]))
        assert solo.generated[r.req_id] == batched.generated[r.req_id]


def _lockstep(engine, reqs):
    """Join while there is room, step, repeat; returns one (finished
    requests' indices in ``reqs``, per-slot generated tokens) record per
    step.  (Request ids come from each package's own counter, so
    requests are compared by index.)"""
    index = {r.req_id: i for i, r in enumerate(reqs)}
    queue, trace = list(reqs), []
    while queue or any(engine.active):
        while queue and engine.has_capacity:
            engine.join(queue.pop(0))
        finished = engine.step()
        trace.append(([index[r.req_id] for r in finished],
                      [None if a is None else list(a["generated"])
                       for a in engine.active]))
    return trace


def test_continuous_engine_matches_jax_step_by_step():
    jp, tp = _params()
    kw = dict(slots=3, max_len=128, max_gen=8)
    jtrace = _lockstep(JaxContinuousEngine(JCFG, params=jp, **kw),
                       _reqs(jax_apps, 5, seed=2))
    te = ContinuousEngine(CFG, params=tp, device="cpu", **kw)
    ttrace = _lockstep(te, _reqs(apps, 5, seed=2))
    assert len(ttrace) == len(jtrace)
    for step, (t, j) in enumerate(zip(ttrace, jtrace)):
        assert t == j, f"step {step}"
    assert te.host_syncs == len(ttrace)


def test_continuous_engine_serves_every_request():
    """Three joins fill the slots and every request finishes with its
    target count (the reference's
    test_continuous_engine_matches_batch_outputs; its streams are not
    the padded engine's, since the continuous engine cuts prompts at
    ``max_len`` and these run to 342 tokens)."""
    _, tp = _params()
    reqs = _reqs(apps, 3, seed=2)
    ce = ContinuousEngine(CFG, params=tp, slots=3, max_len=128, max_gen=8,
                          device="cpu")
    streams = {r.req_id: None for r in reqs}
    for r in reqs:
        ce.join(r)
    assert not ce.has_capacity
    done, it = [], 0
    while len(done) < len(reqs) and it < 100:
        gen = {a["req"].req_id: a["generated"] for a in ce.active if a}
        for r in ce.step():
            streams[r.req_id] = gen[r.req_id]
            done.append(r)
        it += 1
    assert len(done) == len(reqs)
    for r in reqs:
        assert len(streams[r.req_id]) == min(r.gen_length, 8)
    assert not any(ce.active) and ce.has_capacity


@pytest.mark.parametrize("strategy", ["vs", "glp", "magnus"])
def test_run_engine_backend_matches_jax(strategy):
    """Every request is queued before the first batch forms, so the
    batches and their WMA do not depend on the engine's speed."""
    jout = jax_serve.run_engine_backend("smollm-135m", 2.0, 4.0, strategy)
    tout = serve.run_engine_backend("smollm-135m", 2.0, 4.0, strategy,
                                    device="cpu")
    for key in ("requests", "batches", "wma_total"):
        assert tout[key] == jout[key], key
    assert tout["requests"] > 0
    results = tout["results"]
    assert tout["host_syncs"] == sum(bin(r.iterations).count("1")
                                     for r in results)
    assert sum(len(g) for r in results for g in r.generated.values()) == \
        sum(r.valid_tokens for r in results)


def test_magnus_pipeline_on_the_port_engine():
    """Requests flow through the full service and the port's engine;
    every request receives exactly its generation length and each batch
    runs G(B) iterations (the reference's
    test_magnus_pipeline_real_engine)."""
    predictor = GenerationLengthPredictor(seed=0).fit(
        apps.make_dataset(40, seed=1))
    memory = MemoryModel(CFG, hbm_bytes=2 * 2 ** 30, max_len=256, max_gen=16)
    svc = MagnusService(memory, MagnusConfig(strategy="magnus"),
                        predictor=predictor)
    _, tp = _params()
    engine = BatchEngine(CFG, params=tp, max_gen=16, device="cpu")
    reqs = apps.make_dataset(2, seed=5)[:6]
    for r in reqs:
        r.gen_length = min(r.gen_length, 12)
        svc.on_request(r, 0.0)
    assert all(r.predicted_gen_length is not None for r in reqs)
    served = []
    while svc.batcher.queue:
        b = svc.next_batch(1.0)
        res = engine.serve_batch(b)
        svc.on_batch_done(b, svc.estimate_time(b), res.wall_time, 10.0)
        served += b.requests
        assert res.iterations == max(min(r.gen_length, 16)
                                     for r in b.requests)
        for r in b.requests:
            assert len(res.generated[r.req_id]) == r.gen_length
    assert {r.req_id for r in served} == {r.req_id for r in reqs}


@pytest.mark.parametrize("strategy,target", [
    ("magnus", "run_engine_backend"), ("vs", "run_engine_backend"),
    ("magnus-paged", "run_paged_engine_backend"),
    ("ccb-paged", "run_paged_engine_backend")])
def test_main_routes_strategies(monkeypatch, capsys, strategy, target):
    """Padded strategies go to the BatchEngine path, ``-paged`` ones to
    the paged engine."""
    calls = []

    def fake(name):
        def run(arch, rate, duration, strat, seed=0, **kw):
            calls.append((name, strat, kw.get("device")))
            return {"requests": 0, "engine": None, "results": []}
        return run

    for name in ("run_engine_backend", "run_paged_engine_backend"):
        monkeypatch.setattr(serve, name, fake(name))
    serve.main(["--arch", "smollm-135m", "--strategy", strategy,
                "--backend", "engine", "--device", "cpu"])
    assert calls == [(target, strategy, "cpu")]
    assert '"requests": 0' in capsys.readouterr().out
