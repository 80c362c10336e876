"""Serving launcher: the Magnus service (predict -> bucket -> HRRN)
against a Poisson workload, on one of two backends, as in the reference
launcher:

  --backend sim    : the roofline-priced cluster simulator at paper scale
                     (``repro_torch.sim``; numpy only, no model runs), the
                     default; ``--hw`` picks the priced hardware (the
                     paper's V100 testbed or a TPU v5e) and
                     ``--instances`` the cluster's LLM instances
  --backend engine : the PyTorch engines on a reduced config

    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm-6b \
        --strategy magnus --rate 8 --duration 60
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --strategy magnus --backend engine --rate 3 --duration 6 \
        --device cpu

On the engine backend the padded strategies (``vs vsq ccb glp abp
magnus``) serve through the paper's padded-batch ``BatchEngine``
(:func:`run_engine_backend`); the ``-paged`` ones through the
``PagedContinuousEngine`` (:func:`run_paged_engine_backend`).  The
padded path serves every family: dense, MoE (``--arch olmoe-1b-7b``;
with MLA, ``--arch deepseek-v3-671b``), SSM (``--arch mamba2-780m``),
hybrid (``--arch hymba-1.5b``), vlm (``--arch internvl2-26b``, zero
patches in front of every prompt) and enc-dec (``--arch
whisper-large-v3``, zero audio frames through the encoder); the paged
one the dense and MoE families without MLA (a paged strategy refuses the
others with the reference's reason).  The engines run on the CUDA card
unless ``--device cpu`` is given.  ``--checkpoint-dir`` turns on the
paged engine's crash-safe serving (a write-ahead journal and a snapshot
every ``--snapshot-every`` windows; a journal left by an earlier process
is recovered first).  Like the reference launcher, the engine backend
serves ``reduced()`` configurations in f32.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import Request
from repro_torch.device import resolve_device
from repro_torch.serving.cost_model import TPU_V5E, V100_32G
from repro_torch.sim.runner import run_strategy
from repro_torch.workload.apps import make_dataset
from repro_torch.workload.generator import poisson_workload

PADDED_STRATEGIES = ("vs", "vsq", "ccb", "glp", "abp", "magnus")
PAGED_STRATEGIES = ("ccb-paged", "magnus-paged")


# the reference launcher's Poisson prompts are capped at 200 tokens,
# inside its memory model's 256
WORKLOAD_MAX_LEN = 200


def run_engine_backend(arch: str, rate: float, duration: float,
                       strategy: str, seed: int = 0, *,
                       reduced: bool = True, device=None,
                       dtype: torch.dtype = torch.float32,
                       hbm_bytes: int = 2 * 2 ** 30, max_len: int = 256,
                       max_gen: int = 32,
                       requests: Optional[List[Request]] = None,
                       params=None) -> dict:
    """Padded-batch serving for real (paper §II-D) of ``arch``:
    :func:`serve_padded` on its config, or on ``cfg.reduced()`` with
    ``reduced`` (the reference launcher always serves that).  The other
    arguments are :func:`serve_padded`'s."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    return serve_padded(cfg, rate, duration, strategy, seed, device=device,
                        dtype=dtype, hbm_bytes=hbm_bytes, max_len=max_len,
                        max_gen=max_gen, requests=requests, params=params)


def serve_padded(cfg: ModelConfig, rate: float, duration: float,
                 strategy: str, seed: int = 0, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 hbm_bytes: int = 2 * 2 ** 30, max_len: int = 256,
                 max_gen: int = 32, requests: Optional[List[Request]] = None,
                 params=None) -> dict:
    """The padded launcher's loop on ``cfg``: MagnusService forms the
    batches (prediction, WMA-directed batching, HRRN) and
    ``BatchEngine.serve_batch`` pads, prefills and decodes each one until
    its longest request finishes.

    ``hbm_bytes``, ``max_len`` and ``max_gen`` size the memory model
    that caps the batches; ``max_gen`` also caps the engine's generation.
    The traffic is a Poisson workload at ``rate`` for ``duration``
    seconds (prompts up to ``min(max_len, 200)`` tokens) unless
    ``requests`` is given; every request is queued before the first
    batch forms.  The weights are random from ``seed`` unless ``params``
    is given.  The result holds the engine under ``"engine"`` and each
    batch's :class:`ServeResult` under ``"results"``."""
    from repro_torch.core.magnus import MagnusConfig, MagnusService
    from repro_torch.core.predictor import GenerationLengthPredictor
    from repro_torch.core.wma import MemoryModel
    from repro_torch.serving.engine import BatchEngine

    if strategy not in PADDED_STRATEGIES:
        raise ValueError(f"strategy {strategy!r}: the padded path serves "
                         f"{PADDED_STRATEGIES}")
    dev = resolve_device(device)
    memory = MemoryModel(cfg, hbm_bytes=hbm_bytes, max_len=max_len,
                         max_gen=max_gen)
    predictor = GenerationLengthPredictor(seed=seed).fit(
        make_dataset(60, seed=seed + 1))
    svc = MagnusService(memory, MagnusConfig(strategy=strategy),
                        predictor=predictor)
    engine = BatchEngine(cfg, params, seed=seed, max_gen=max_gen,
                         dtype=dtype, device=dev)
    wl = requests if requests is not None else poisson_workload(
        rate, duration, seed=seed, max_len=min(max_len, WORKLOAD_MAX_LEN),
        max_gen=max_gen)
    for r in wl:
        svc.on_request(r, r.arrival_time)
    now, served, results = 0.0, 0, []
    while len(svc.batcher.queue) > 0:
        b = svc.next_batch(now)
        if b is None:
            break
        res = engine.serve_batch(b)
        results.append(res)
        served += b.size
        now += res.wall_time
    total_tokens = sum(r.total_tokens for r in results)
    valid = sum(r.valid_tokens for r in results)
    return {"requests": served, "batches": len(results),
            "wall_s": round(now, 2),
            "token_tp": round(total_tokens / max(now, 1e-9), 1),
            "valid_token_tp": round(valid / max(now, 1e-9), 1),
            "wma_total": sum(r.wma for r in results),
            "host_syncs": engine.host_syncs,
            "device": str(dev), "engine": engine, "results": results}


def run_paged_engine_backend(arch: str, rate: float, duration: float,
                             strategy: str, seed: int = 0, *,
                             num_blocks: int = 128, block_tokens: int = 16,
                             max_concurrency: int = 16,
                             prefix_cache: bool = False,
                             ttl_steps: Optional[int] = None,
                             swap_blocks: int = 0,
                             spec_decode: bool = False, draft_k: int = 4,
                             checkpoint_dir: Optional[str] = None,
                             snapshot_every: int = 8,
                             reduced: bool = True, device=None,
                             dtype: torch.dtype = torch.float32,
                             max_len: int = 200, max_gen: int = 32,
                             requests: Optional[List[Request]] = None,
                             params=None) -> dict:
    """Continuous paged serving for real: MagnusService drives admission
    (prediction + block accounting) against the same BlockAllocator the
    engine stores KV pages in (DESIGN.md §8).  The engine admits whole
    scheduler batches as single-dispatch variable-prefix waves
    (``join_many``, §12) and decodes in fused multi-step windows (§9).
    With ``prefix_cache`` the service's LCP-aware footprints and the
    engine's radix-shared pages use ONE RadixPrefixCache (§10-§11); one
    MispredictionEWMA is shared by the batcher's footprints and the
    engine's reservations (§14).  ``ttl_steps`` sets a default
    per-request deadline in scheduler-clock ticks (§14); ``swap_blocks``
    > 0 enables the host-memory KV swap tier (§15), so pool pressure
    suspends victims to host pages (pinned on the card) instead of
    destroying their KV.  ``spec_decode`` turns on speculative decoding
    (§16) with a self-draft proposing ``draft_k`` tokens a window, as
    in the reference; greedy output is unchanged.  ``checkpoint_dir``
    turns on crash-safe serving (§17): every admission is journaled
    write-ahead, a full engine snapshot lands every ``snapshot_every``
    windows, and a journal that a previous process left there is
    recovered first, on a fresh engine of the serving engine's geometry
    that shares its weight tensors (its outstanding requests finish
    before new traffic is served, and the report is under
    ``"recovered_on_start"``).  It does not cover ``spec_decode``.

    ``reduced`` serves ``cfg.reduced()`` (the reference launcher always
    does); ``max_len``, ``max_gen`` and ``num_blocks`` size the engine
    and the pool.  The traffic is a Poisson workload at ``rate`` for
    ``duration`` seconds unless ``requests`` is given; the weights are
    random from ``seed`` unless ``params`` is given.  The result holds
    the engine under ``"engine"``."""
    from repro_torch.core.magnus import MagnusConfig, MagnusService
    from repro_torch.core.predictor import GenerationLengthPredictor
    from repro_torch.core.wma import MemoryModel
    from repro_torch.serving.engine import PagedContinuousEngine, drive_paged
    from repro_torch.serving.paged_cache import (BlockAllocator,
                                                 MispredictionEWMA)

    if strategy not in PAGED_STRATEGIES:
        raise ValueError(f"strategy {strategy!r}: the port serves "
                         f"{PAGED_STRATEGIES}")
    if checkpoint_dir is not None and spec_decode:
        raise ValueError("--checkpoint-dir does not cover speculative "
                         "engines (§16/§17): snapshot() refuses them")
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    memory = MemoryModel(cfg, hbm_bytes=2 * 2 ** 30, max_len=max_len,
                         max_gen=max_gen)
    allocator = BlockAllocator(num_blocks, block_tokens)
    predictor = GenerationLengthPredictor(seed=seed).fit(
        make_dataset(60, seed=seed + 1))
    svc = MagnusService(memory,
                        MagnusConfig(strategy=strategy,
                                     prefix_sharing=prefix_cache),
                        predictor=predictor, allocator=allocator)
    ewma = MispredictionEWMA()
    svc.memory.headroom = ewma
    engine = PagedContinuousEngine(cfg, params, seed=seed,
                                   max_concurrency=max_concurrency,
                                   max_len=max_len, max_gen=max_gen,
                                   dtype=dtype, allocator=allocator,
                                   prefix_cache=svc.prefix_cache or False,
                                   mispredict=ewma, default_ttl=ttl_steps,
                                   swap_blocks=swap_blocks,
                                   spec_decode=spec_decode, draft_k=draft_k,
                                   device=dev)
    wl = requests if requests is not None else poisson_workload(
        rate, duration, seed=seed, max_len=max_len, max_gen=max_gen)
    for r in wl:
        svc.on_request(r, r.arrival_time)   # prediction + Algorithm-1 acct

    recovery = recovered = None
    if checkpoint_dir is not None:
        from repro_torch.serving import snapshot as snaplib

        def fresh_engine():
            # the serving engine's geometry and weight tensors, with an
            # allocator of its own (the service's belongs to THIS run)
            return PagedContinuousEngine(
                cfg, engine.params, max_concurrency=max_concurrency,
                max_len=max_len, max_gen=max_gen, dtype=dtype,
                allocator=BlockAllocator(num_blocks, block_tokens),
                prefix_cache=prefix_cache, default_ttl=ttl_steps,
                swap_blocks=swap_blocks, device=dev)

        wal = os.path.join(checkpoint_dir, snaplib.JOURNAL_NAME)
        if os.path.exists(wal):
            # restore-on-start: bring the previous process's journaled
            # work to completion before serving new traffic
            prev, report = snaplib.recover(fresh_engine, checkpoint_dir,
                                           snapshot_every=snapshot_every)
            prev.assert_drained()
            recovered = {k: report[k] for k in
                         ("journaled", "outstanding", "recovered",
                          "replayed_reprefill_tokens", "restore_s",
                          "torn_records")}
            del prev
            os.remove(wal)   # recovered: this process's WAL starts fresh
        recovery = snaplib.RecoveryManager(checkpoint_dir,
                                           snapshot_every=snapshot_every)

    def refill(steps: int):
        # admission order comes from the service's scheduler (HRRN for
        # magnus-paged, FCFS for ccb-paged)
        nb = svc.next_batch(now=float(steps))
        return nb.requests if nb is not None else None

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    start = time.perf_counter()
    st = drive_paged(engine, [], max_steps=100_000, refill=refill,
                     backlog=lambda: len(svc.batcher.queue) > 0,
                     recovery=recovery)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - start
    if recovery is not None:
        recovery.close()
    util = st["util"]
    total_tokens = sum(len(g) for g in engine.generated.values())
    return {"requests": st["served"], "steps": st["steps"],
            "wall_s": round(wall, 2),
            "token_tp": round(total_tokens / max(wall, 1e-9), 1),
            "generated_tokens": total_tokens,
            "peak_concurrency": st["peak"], "evictions": st["evictions"],
            "prefix_hits": engine.prefix_cache.hits
            if engine.prefix_cache else 0,
            "prefix_misses": engine.prefix_cache.misses
            if engine.prefix_cache else 0,
            "prefill_dispatches": engine.prefill_dispatches,
            "prefill_tokens": engine.prefill_tokens,
            "cow_copies": engine.cow_copies,
            "decode_steps": engine.decode_steps,
            "host_syncs": engine.host_syncs,
            "host_syncs_per_token": round(
                engine.host_syncs / max(total_tokens, 1), 4),
            "mean_block_utilization": round(
                sum(util) / max(len(util), 1), 3),
            # robustness counters (DESIGN.md §14)
            "retries_max": st["retries_max"],
            "deadline_misses": st["deadline_misses"],
            "quarantined": st["quarantined"],
            "shed": len(st["shed"]),
            "requeue_prefix_hits": st["requeue_prefix_hits"],
            # host swap tier (DESIGN.md §15)
            "swap_outs": st["swap_outs"],
            "swap_ins": st["swap_ins"],
            "swapped_blocks": engine.swapped_blocks,
            "swap_reused_blocks": engine.swap_reused_blocks,
            "reprefilled_swapped_tokens": st["reprefilled_swapped_tokens"],
            "swap_in_s": round(engine.swap_in_s, 4),
            # speculative decoding (DESIGN.md §16)
            "spec_windows": st["spec_windows"],
            "accepted_per_dispatch": round(st["accepted_per_dispatch"], 3),
            "acceptance_rate": round(st["acceptance_rate"], 3),
            "draft_quarantined": st["draft_quarantined"],
            "draft_prefill_tokens": st["draft_prefill_tokens"],
            # crash-safe serving (DESIGN.md §17)
            "snapshots_taken": recovery.snapshots_taken
            if recovery is not None else 0,
            "journal_records": recovery.journal.records_written
            if recovery is not None else 0,
            "replayed_reprefill_tokens": st["replayed_reprefill_tokens"],
            "recovered_on_start": recovered,
            "headroom": ewma.snapshot(),
            "device": str(dev), "engine": engine}


def run_sim_backend(arch: str, rate: float, duration: float, strategy: str,
                    seed: int = 0, *, hw: str = "v100", instances: int = 7,
                    prefix_cache: bool = False) -> dict:
    """The reference launcher's default backend: the discrete-event
    cluster simulator (``sim.runner.run_strategy``) on ``arch``'s full
    config, ``instances`` LLM instances priced on ``hw`` ("v100", the
    paper's testbed with an f32 cache, or "v5e"), over a Poisson
    workload at ``rate`` for ``duration`` seconds.  Returns the
    simulator's ``Metrics.summary()``; nothing runs on a device."""
    cfg = get_config(arch)
    wl = poisson_workload(rate, duration, seed=seed)
    spec = V100_32G if hw == "v100" else TPU_V5E
    m = run_strategy(strategy, wl, cfg, hw=spec, n_instances=instances,
                     kv_dtype_bytes=4 if hw == "v100" else 2,
                     train_requests=make_dataset(100, seed=seed + 1),
                     prefix_sharing=prefix_cache, seed=seed)
    return m.summary()


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm-6b")
    ap.add_argument("--strategy", default="magnus",
                    choices=list(PADDED_STRATEGIES + PAGED_STRATEGIES))
    ap.add_argument("--rate", type=float, default=8.0)
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--instances", type=int, default=7,
                    help="sim: LLM instances of the simulated cluster")
    ap.add_argument("--backend", default="sim", choices=["sim", "engine"])
    ap.add_argument("--hw", default="v100", choices=["v100", "v5e"],
                    help="sim: the priced hardware (the paper's V100 "
                         "testbed, or a TPU v5e)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="paged strategies: radix-tree prompt-prefix "
                         "sharing across apps with copy-on-write partial "
                         "tails (engine) / LCP-aware footprints (sim)")
    ap.add_argument("--block-tokens", type=int, default=16,
                    help="paged engine block size; matches shorter than "
                         "one block are misses")
    ap.add_argument("--ttl-steps", type=int, default=None,
                    help="paged engine: default per-request deadline in "
                         "scheduler-clock ticks from admission; expired "
                         "requests are shed and counted (DESIGN.md §14)")
    ap.add_argument("--swap-blocks", type=int, default=0,
                    help="paged engine: host-memory KV swap tier capacity "
                         "in blocks (0 disables); under pool pressure live "
                         "victims suspend to pinned host pages and resume "
                         "without re-prefilling (DESIGN.md §15)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="paged engine: speculative decoding (DESIGN.md "
                         "§16): a self-draft proposes draft-k tokens a "
                         "window, one batched target pass verifies them, "
                         "rollback is block-table truncation; greedy "
                         "output is unchanged")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="speculative tokens proposed a window (the verify "
                         "covers draft-k + 1 positions)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="paged engine: crash-safe serving (DESIGN.md "
                         "§17): a write-ahead admission journal and "
                         "periodic full-engine snapshots in this "
                         "directory; on start a surviving journal is "
                         "recovered first (outstanding requests finished "
                         "as an uncrashed run would)")
    ap.add_argument("--snapshot-every", type=int, default=8,
                    help="windows between full engine snapshots when "
                         "--checkpoint-dir is set")
    ap.add_argument("--device", default=None,
                    help="engine: default the CUDA card (raises without "
                         "one)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.backend == "sim":     # the engine's flags are ignored here
        print(json.dumps(run_sim_backend(
            args.arch, args.rate, args.duration, args.strategy, args.seed,
            hw=args.hw, instances=args.instances,
            prefix_cache=args.prefix_cache), indent=2))
        return
    paged_only = {"--prefix-cache": args.prefix_cache,
                  "--ttl-steps": args.ttl_steps is not None,
                  "--swap-blocks": args.swap_blocks > 0,
                  "--spec-decode": args.spec_decode,
                  "--checkpoint-dir": args.checkpoint_dir is not None}
    for flag, given in paged_only.items():
        if given and args.strategy not in PAGED_STRATEGIES:
            ap.error(f"{flag} needs a -paged strategy")
    if args.checkpoint_dir is not None and args.spec_decode:
        ap.error("--checkpoint-dir does not cover --spec-decode")
    if args.strategy in PAGED_STRATEGIES:
        out = run_paged_engine_backend(
            args.arch, args.rate, args.duration, args.strategy, args.seed,
            block_tokens=args.block_tokens, prefix_cache=args.prefix_cache,
            ttl_steps=args.ttl_steps, swap_blocks=args.swap_blocks,
            spec_decode=args.spec_decode, draft_k=args.draft_k,
            checkpoint_dir=args.checkpoint_dir,
            snapshot_every=args.snapshot_every, device=args.device)
    else:
        out = run_engine_backend(args.arch, args.rate, args.duration,
                                 args.strategy, args.seed,
                                 device=args.device)
        out.pop("results")
    out.pop("engine")
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
