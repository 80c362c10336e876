"""Serving launcher: the Magnus service (predict -> bucket -> HRRN)
drives the PyTorch engines.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --strategy magnus --rate 3 --duration 6 --device cpu

The padded strategies (``vs vsq ccb glp abp magnus``) serve through the
paper's padded-batch ``BatchEngine`` (:func:`run_engine_backend`); the
``-paged`` ones through the ``PagedContinuousEngine``
(:func:`run_paged_engine_backend`).  The padded path serves the dense
and SSM (``--arch mamba2-780m``) families, the paged one the dense
family.  Runs on the CUDA card unless
``--device cpu`` is given.  Like the reference launcher, it serves
``reduced()`` configurations in f32.  The reference's roofline
simulator backend (``--backend sim``) is not ported yet.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.core.types import Request
from repro_torch.device import resolve_device
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
    """Padded-batch serving for real (paper §II-D): MagnusService forms
    the batches (prediction, WMA-directed batching, HRRN) and
    ``BatchEngine.serve_batch`` pads, prefills and decodes each one until
    its longest request finishes.

    ``hbm_bytes``, ``max_len`` and ``max_gen`` size the memory model
    that caps the batches; ``max_gen`` also caps the engine's generation.
    ``reduced`` serves ``cfg.reduced()`` (the reference launcher always
    does).  The traffic is a Poisson workload at ``rate`` for
    ``duration`` seconds (prompts up to ``min(max_len, 200)`` tokens)
    unless ``requests`` is given; every request is queued before the
    first batch forms.  The weights are random from ``seed`` unless
    ``params`` is given.  The result holds the engine under ``"engine"``
    and each batch's :class:`ServeResult` under ``"results"``."""
    from repro_torch.core.magnus import MagnusConfig, MagnusService
    from repro_torch.core.predictor import GenerationLengthPredictor
    from repro_torch.core.wma import MemoryModel
    from repro_torch.serving.engine import BatchEngine

    if strategy not in PADDED_STRATEGIES:
        raise ValueError(f"strategy {strategy!r}: the padded path serves "
                         f"{PADDED_STRATEGIES}")
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
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
    destroying their KV.

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
                                   swap_blocks=swap_blocks, device=dev)
    wl = requests if requests is not None else poisson_workload(
        rate, duration, seed=seed, max_len=max_len, max_gen=max_gen)
    for r in wl:
        svc.on_request(r, r.arrival_time)   # prediction + Algorithm-1 acct

    def refill(steps: int):
        # admission order comes from the service's scheduler (HRRN for
        # magnus-paged, FCFS for ccb-paged)
        nb = svc.next_batch(now=float(steps))
        return nb.requests if nb is not None else None

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    start = time.perf_counter()
    st = drive_paged(engine, [], max_steps=100_000, refill=refill,
                     backlog=lambda: len(svc.batcher.queue) > 0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - start
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
            "headroom": ewma.snapshot(),
            "device": str(dev), "engine": engine}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm-6b")
    ap.add_argument("--strategy", default="magnus",
                    choices=list(PADDED_STRATEGIES + PAGED_STRATEGIES))
    ap.add_argument("--rate", type=float, default=8.0)
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="paged strategies: radix-tree prompt-prefix "
                         "sharing across apps with copy-on-write partial "
                         "tails")
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
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    paged_only = {"--prefix-cache": args.prefix_cache,
                  "--ttl-steps": args.ttl_steps is not None,
                  "--swap-blocks": args.swap_blocks > 0}
    for flag, given in paged_only.items():
        if given and args.strategy not in PAGED_STRATEGIES:
            ap.error(f"{flag} needs a -paged strategy")
    if args.strategy in PAGED_STRATEGIES:
        out = run_paged_engine_backend(
            args.arch, args.rate, args.duration, args.strategy, args.seed,
            block_tokens=args.block_tokens, prefix_cache=args.prefix_cache,
            ttl_steps=args.ttl_steps, swap_blocks=args.swap_blocks,
            device=args.device)
    else:
        out = run_engine_backend(args.arch, args.rate, args.duration,
                                 args.strategy, args.seed,
                                 device=args.device)
        out.pop("results")
    out.pop("engine")
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
