"""The port's ``--backend sim`` (``repro_torch/sim/``,
``repro_torch/serving/cost_model.py``: copies of the reference's numpy
modules) against the reference package on the same inputs.  Each test is
the port's copy of a reference test: it runs both packages and holds
their metrics equal, field by field (``dataclasses.asdict`` of
``Metrics``).

- ``tests/test_serving.py`` ``test_simulator_paper_orderings`` and
  ``test_ccb_simulator_no_invalid_tokens``;
- ``tests/test_system.py`` ``test_end_to_end_sim_headline`` and
  ``test_oom_recovery_preserves_requests``;
- ``tests/test_recovery.py`` ``test_sim_recovery_time_pricing`` and
  ``tests/test_spec_decode.py`` ``test_sim_spec_dispatch_pricing``;
- the launcher with no ``--backend`` runs the simulator and prints the
  reference launcher's JSON for the same arguments.

The workloads and the predictors' training sets are shorter than the
reference tests': the two packages run the same numpy code, so equal
metrics on a short workload show the copy is faithful, and the paper's
orderings, which need a saturated cluster, stay the reference tests' to
assert.  Where the reference test asserts a property of any workload
(every request completes, every price is monotone), the copy asserts
it too.  The orderings copy fits each package's predictor once and gives
each strategy a deep copy of it, where the reference's ``run_all`` fits
one per strategy from the same seed and data: the fit is deterministic,
so the inputs are the same."""
import copy
import dataclasses
import functools
import json
import sys

import pytest

from repro.configs import get_config as jax_config
from repro.core.predictor import GenerationLengthPredictor as JaxPredictor
from repro.launch import serve as jax_serve
from repro.serving import cost_model as jax_cost
from repro.sim import events as jax_events
from repro.sim import runner as jax_runner
from repro.workload import apps as jax_apps
from repro.workload import generator as jax_generator
from repro_torch.configs import get_config
from repro_torch.core.predictor import GenerationLengthPredictor
from repro_torch.launch import serve
from repro_torch.serving import cost_model
from repro_torch.sim import events, runner
from repro_torch.workload import apps, generator

# (config, workload, predictor, dataset, runner, events, cost model)
PORT = (get_config, generator.poisson_workload, GenerationLengthPredictor,
        apps.make_dataset, runner, events, cost_model)
JAX = (jax_config, jax_generator.poisson_workload, JaxPredictor,
       jax_apps.make_dataset, jax_runner, jax_events, jax_cost)
STRATEGIES = ("vs", "vsq", "ccb", "glp", "abp", "magnus")


def _same(port, ref):
    """The two packages' ``Metrics`` field by field."""
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def _orderings(pkg):
    cfg_of, workload, predictor, dataset, run, _, cost = pkg
    cfg = cfg_of("chatglm-6b")
    wl = workload(rate=10.0, duration=10, seed=0)
    fitted = predictor(seed=0).fit(dataset(5, seed=7))
    out = {}
    for s in STRATEGIES:
        pred = copy.deepcopy(fitted) if s in ("glp", "abp", "magnus") \
            else None
        out[s] = run.run_strategy(s, wl, cfg, hw=cost.V100_32G,
                                  predictor=pred, kv_dtype_bytes=4)
        assert out[s].completed == len(wl)
    return out


def test_simulator_paper_orderings():
    """The six padded strategies of the paper's orderings on one
    workload, in both packages with equal metrics."""
    res, ref = _orderings(PORT), _orderings(JAX)
    for s in STRATEGIES:
        _same(res[s], ref[s])


def test_ccb_simulator_no_invalid_tokens():
    out = []
    for cfg_of, workload, _, _, _, ev, cost in (PORT, JAX):
        wl = workload(rate=3.0, duration=30, seed=1)
        m = ev.CCBSimulator(cost.CostModel(cfg_of("chatglm-6b"),
                                           cost.V100_32G),
                            n_instances=2, parallel_limit=4).run(wl)
        assert m.completed == len(wl)
        assert m.total_tokens == m.valid_tokens
        assert all(t is not None and t >= 0 for t in m.response_times)
        out.append(m)
    _same(*out)


def test_end_to_end_sim_headline():
    """Vanilla scheduling and Magnus on one workload, in both packages
    with equal metrics."""
    out = []
    for cfg_of, workload, predictor, dataset, run, _, cost in (PORT, JAX):
        cfg = cfg_of("chatglm-6b")
        wl = workload(rate=10.0, duration=10, seed=3)
        pred = predictor(seed=2).fit(dataset(5, seed=4))
        vs = run.run_strategy("vs", wl, cfg, hw=cost.V100_32G,
                              kv_dtype_bytes=4)
        mg = run.run_strategy("magnus", wl, cfg, hw=cost.V100_32G,
                              kv_dtype_bytes=4, predictor=pred)
        out.append((vs, mg))
    for port, ref in zip(*out):
        _same(port, ref)


def test_oom_recovery_preserves_requests():
    """OOM-split batches requeue all requests; nothing is dropped."""
    out = []
    for cfg_of, workload, predictor, dataset, run, _, cost in (PORT, JAX):
        wl = workload(rate=12.0, duration=10, seed=7)
        pred = predictor(seed=2).fit(dataset(5, seed=4))
        m = run.run_strategy("abp", wl, cfg_of("chatglm-6b"),
                             hw=cost.V100_32G, kv_dtype_bytes=4,
                             predictor=pred)
        assert m.completed == len(wl)
        out.append(m)
    _same(*out)


def test_sim_recovery_time_pricing():
    """recovery_time = one host-link pool transfer + deterministic
    journal replay; monotone in both, and restore of a swap-sized image
    prices exactly like the §15 transfer it reuses.  Every price equals
    the reference's."""
    prices = []
    for cfg_of, _, _, _, run, _, cost in (PORT, JAX):
        base = cost.CostModel(cfg_of("chatglm-6b"), cost.TPU_V5E)
        c = run.HostSyncCost(base, 0.01, "fused")
        assert c.recovery_time(8, 16) == c.swap_transfer_time(8, 16)
        assert c.recovery_time(8, 16, journal_records=1000) \
            > c.recovery_time(8, 16, journal_records=10) \
            > c.recovery_time(8, 16)
        assert c.recovery_time(64, 16) > c.recovery_time(8, 16)
        assert c.recovery_time(64, 16, journal_records=100) \
            < 2 * c.recovery_time(64, 16)
        prices.append([c.recovery_time(n, 16, journal_records=j)
                       for n in (8, 64) for j in (0, 10, 100, 1000)])
    assert prices[0] == prices[1]


def test_sim_spec_dispatch_pricing():
    """HostSyncCost with dispatch="spec": the expected accepted prefix is
    geometric in the acceptance rate (floor 1.0, ceiling draft_k+1), the
    per-emitted-token cost falls monotonically with acceptance, and a
    high-acceptance cheap draft beats the fused engine's per-token cost.
    Every price equals the reference's."""
    prices = []
    for cfg_of, _, _, _, run, _, cost in (PORT, JAX):
        base = cost.CostModel(cfg_of("chatglm-6b"), cost.TPU_V5E)
        selfdraft = run.HostSyncCost(base, 0.01, "spec", acceptance=1.0,
                                     draft_k=4)
        reject = run.HostSyncCost(base, 0.01, "spec", acceptance=0.0,
                                  draft_k=4)
        mid = run.HostSyncCost(base, 0.01, "spec", acceptance=0.8,
                               draft_k=4)
        assert selfdraft.accepted_per_dispatch() == 5.0
        assert reject.accepted_per_dispatch() == 1.0
        assert 1.0 < mid.accepted_per_dispatch() < 5.0
        assert (selfdraft.decode_iter_time(8, 256)
                < mid.decode_iter_time(8, 256)
                < reject.decode_iter_time(8, 256))
        fused = run.HostSyncCost(base, 0.01, "fused")
        assert selfdraft.decode_iter_time(8, 256) \
            < fused.decode_iter_time(8, 256)
        assert selfdraft._syncs(20) == 4 and reject._syncs(20) == 20
        with pytest.raises(ValueError):
            run.HostSyncCost(base, 0.01, "spec", acceptance=1.5)
        with pytest.raises(ValueError):
            run.HostSyncCost(base, 0.01, "warp")
        prices.append([c.decode_iter_time(8, 256)
                       for c in (selfdraft, reject, mid, fused)]
                      + [mid.accepted_per_dispatch()])
    assert prices[0] == prices[1]


def test_launcher_defaults_to_the_simulator(capsys, monkeypatch):
    """``python -m repro_torch.launch.serve`` with no ``--backend`` runs
    the simulator, as the reference's launcher does, and prints the
    reference's JSON for the same arguments (a short workload, and both
    launchers' predictors trained on 5 requests an app where they take
    100); nothing runs on a device, so it needs no ``--device``."""
    for mod in (serve, jax_serve):
        monkeypatch.setattr(mod, "make_dataset", functools.partial(
            lambda real, n, seed: real(5, seed=seed), mod.make_dataset))
    argv = ["--arch", "chatglm-6b", "--rate", "6", "--duration", "8"]
    serve.main(argv)
    port = json.loads(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jax_serve.main()
    ref = json.loads(capsys.readouterr().out)
    assert port == ref
    assert port["completed"] > 0


def test_launcher_sim_flags_reach_the_runner(capsys, monkeypatch):
    """``--hw``, ``--instances`` and ``--prefix-cache`` reach
    ``run_strategy`` as the reference launcher passes them: the priced
    hardware, its cache dtype (f32 on the paper's V100, bf16 on v5e),
    the instance count and the prefix sharing."""
    seen = []

    def fake(strategy, wl, cfg, **kw):
        seen.append((strategy, cfg.name, kw["hw"].name, kw["n_instances"],
                     kw["kv_dtype_bytes"], kw["prefix_sharing"]))
        return events.Metrics()

    monkeypatch.setattr(serve, "run_strategy", fake)
    serve.main(["--arch", "smollm-135m", "--duration", "2"])
    serve.main(["--arch", "smollm-135m", "--duration", "2", "--hw", "v5e",
                "--instances", "3", "--strategy", "magnus-paged",
                "--prefix-cache"])
    capsys.readouterr()
    assert seen == [("magnus", "smollm-135m", "v100-32g", 7, 4, False),
                    ("magnus-paged", "smollm-135m", "tpu-v5e", 3, 2, True)]
