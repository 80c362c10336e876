"""Crash-safe serving: engine snapshot/restore and the write-ahead
admission journal (DESIGN.md §17; the reference package's
``serving/snapshot.py``).

Three layers, composed by :func:`recover`:

* **Snapshot**: the complete engine image (the paged pools' live blocks,
  gathered once on the device and read back, block tables, positions,
  logits rows, the radix prefix tree with refcounts and COW provenance,
  the host swap tier, misprediction EWMAs, scheduler clock, every
  counter) flattened through ``train.checkpoint.flatten_tree`` into one
  ``.npz`` carrying a SHA-256 checksum over every byte it stores.
  Writes go to a temp file and ``os.replace`` in, so a crash
  mid-snapshot leaves the previous snapshot intact.

* **Journal**: an append-only write-ahead log of admission lifecycle
  events (``admit`` / ``finish`` / ``shed`` / ``swap`` / ``snapshot``
  markers), one CRC-framed JSON record per line, fsync'd at window
  boundaries by :class:`RecoveryManager`.  A torn final line (the
  crash interrupted the write) is dropped on read; corruption anywhere
  else is a typed error.

* **Replay**: restore = load the last journal-marked snapshot, then
  re-serve every journaled-but-unfinished request.  Greedy decode and
  the seeded fault planner make the replay exact: the restored engine
  finishes every request with the streams of an uncrashed run, and
  snapshot-covered requests re-prefill zero tokens.

The files are the reference's, byte for byte in layout: the same keys,
meta, checksum and dtype tags, so either package restores the other's
snapshots and replays the other's journals.  Two things differ from the
reference, both at the file's edge:

* *bfloat16 without ml_dtypes.*  numpy has no bfloat16.  A bf16 tensor
  is stored as its 16-bit pattern (``uint16``) under the reference's
  ``"bfloat16"`` tag, and :func:`read_snapshot` gives it back as a
  ``torch.bfloat16`` tensor by a view, never through float.  Every
  other array is a numpy array.
* *The restore writes in place.*  A CUDA engine replays a captured
  decode graph on the addresses it captured (``serving/graphs.py``),
  and an engine built with ``warmup=True`` has captured before it
  restores.  So :func:`load_engine` copies into the engine's tables,
  positions, active mask and logits, scatters exactly the snapshot's
  blocks into its pools (``scatter_pages``: no padding), and writes the
  swap tier's used slots into its existing (pinned, slot-major) store.

Device readbacks happen in ``engine.snapshot()`` (counted sync sites);
this module sees host tensors and numpy arrays only.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.types import Request
from repro_torch.train.checkpoint import flatten_tree

SNAPSHOT_VERSION = 1
JOURNAL_NAME = "journal.wal"

__all__ = [
    "SNAPSHOT_VERSION", "JOURNAL_NAME",
    "SnapshotError", "SnapshotChecksumError", "SnapshotMismatchError",
    "JournalError", "JournalCorruptError", "JournalTornError",
    "req_to_dict", "req_from_dict",
    "write_snapshot", "read_snapshot",
    "snapshot_radix", "restore_radix",
    "snapshot_swap_tier", "restore_swap_tier",
    "save_engine", "load_engine",
    "AdmissionJournal", "RecoveryManager", "recover",
]

Array = Union[np.ndarray, torch.Tensor]


class SnapshotError(RuntimeError):
    """Snapshot could not be taken or applied."""


class SnapshotChecksumError(SnapshotError):
    """Stored checksum disagrees with the recomputed digest: the file
    was corrupted (or tampered with) after it was published."""


class SnapshotMismatchError(SnapshotError):
    """Snapshot geometry (model, pool, slots, dtype) disagrees with the
    engine it is being restored into."""


class JournalError(RuntimeError):
    """Write-ahead journal could not be read or written."""


class JournalCorruptError(JournalError):
    """A journal record failed its CRC or JSON framing mid-file."""


class JournalTornError(JournalCorruptError):
    """Only the FINAL record is corrupt: the classic torn write of a
    crash mid-append.  Recoverable: drop the tail, keep the prefix."""


# --------------------------------------------------------------------
# request (de)serialization
# --------------------------------------------------------------------

_REQ_STR = ("app", "task", "instruction", "user_input")
_REQ_INT = ("length", "user_input_length", "gen_length")
_REQ_OPT_INT = ("predicted_gen_length", "ttl_steps")
_REQ_OPT_FLOAT = ("finish_time",)


def req_to_dict(req: Request) -> Dict[str, Any]:
    d: Dict[str, Any] = {f: getattr(req, f) for f in _REQ_STR}
    d.update({f: int(getattr(req, f)) for f in _REQ_INT})
    for f in _REQ_OPT_INT:
        v = getattr(req, f)
        d[f] = None if v is None else int(v)
    for f in _REQ_OPT_FLOAT:
        v = getattr(req, f)
        d[f] = None if v is None else float(v)
    d["arrival_time"] = float(req.arrival_time)
    d["req_id"] = int(req.req_id)
    return d


def req_from_dict(d: Dict[str, Any]) -> Request:
    return Request(**{k: d[k] for k in
                      (*_REQ_STR, *_REQ_INT, *_REQ_OPT_INT,
                       *_REQ_OPT_FLOAT, "arrival_time", "req_id")})


# --------------------------------------------------------------------
# checksummed npz container
# --------------------------------------------------------------------

def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype (``"float32"``, ``"bfloat16"``):
    the name the reference's files carry."""
    return str(dtype).rsplit(".", 1)[-1]


def _pack_array(arr: Array) -> Tuple[np.ndarray, str]:
    """npz cannot store bfloat16 without pickle: a bf16 tensor is stored
    as its bit pattern (uint16) and its dtype kept in the meta block."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu()
        if arr.dtype == torch.bfloat16:
            return arr.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = arr.numpy()
    return arr, arr.dtype.name


def _unpack_array(arr: np.ndarray, tag: str) -> Array:
    if tag == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    return arr


def _host_tensor(arr: Array) -> torch.Tensor:
    """A host tensor of ``arr``'s values and dtype, sharing its memory
    where it can."""
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.from_numpy(np.ascontiguousarray(arr))


def _digest(meta_blob: bytes, arrays: Dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    h.update(meta_blob)
    for key in sorted(arrays):
        arr = arrays[key]
        h.update(key.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        # the array's bytes in C order, hashed without a copy
        h.update(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    return h.hexdigest()


def _plain_key(key: str) -> str:
    # flatten_tree of a flat {name: array} dict yields keystr "['name']"
    if key.startswith("['") and key.endswith("']"):
        return key[2:-2]
    return key


def write_snapshot(path: str, meta: Dict[str, Any],
                   arrays: Dict[str, Array]) -> str:
    """Publish ``meta`` + ``arrays`` (numpy arrays or host tensors) as one
    checksummed npz.  Atomic: written to a sibling temp file, then
    ``os.replace``'d in."""
    if not path.endswith(".npz"):
        path += ".npz"
    packed: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for key, arr in flatten_tree(arrays).items():
        p, tag = _pack_array(arr)
        packed[key] = p
        dtypes[_plain_key(key)] = tag
    meta = dict(meta)
    meta["array_dtypes"] = dtypes
    blob = json.dumps(meta, sort_keys=True).encode()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path[:-len(".npz")] + ".tmp.npz"
    np.savez(tmp, __meta__=np.frombuffer(blob, np.uint8),
             __checksum__=np.array(_digest(blob, packed)), **packed)
    os.replace(tmp, path)
    return path


def read_snapshot(path: str) -> Tuple[Dict[str, Any], Dict[str, Array]]:
    """Load + verify a snapshot.  Raises :class:`SnapshotChecksumError`
    if any stored byte disagrees with the recorded digest.  A
    ``"bfloat16"`` array comes back as a ``torch.bfloat16`` tensor, every
    other one as a numpy array."""
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as data:
        if "__meta__" not in data.files or "__checksum__" not in data.files:
            raise SnapshotError(f"{path}: not an engine snapshot "
                                "(missing __meta__/__checksum__)")
        blob = data["__meta__"].tobytes()
        stored = str(data["__checksum__"][()])
        packed = {k: data[k] for k in data.files
                  if k not in ("__meta__", "__checksum__")}
    digest = _digest(blob, packed)
    if digest != stored:
        raise SnapshotChecksumError(
            f"{path}: checksum mismatch (stored {stored[:12]}…, "
            f"recomputed {digest[:12]}…)")
    meta = json.loads(blob.decode())
    dtypes = meta.pop("array_dtypes", {})
    arrays = {}
    for key, arr in packed.items():
        name = _plain_key(key)
        arrays[name] = _unpack_array(arr, dtypes.get(name, arr.dtype.name))
    return meta, arrays


# --------------------------------------------------------------------
# radix prefix tree
# --------------------------------------------------------------------

def snapshot_radix(cache) -> Tuple[Dict[str, Any], Dict[int, int]]:
    """Serialize the tree parent-before-child.  Returns the node list
    plus an ``id(node) -> index`` map so active slots can record which
    node they hold pinned."""
    nodes: List[Dict[str, Any]] = []
    index: Dict[int, int] = {id(cache.root): -1}
    stack = [cache.root]
    while stack:
        n = stack.pop()
        for group, partial in ((n.children, False), (n.partials, True)):
            for child in group.values():
                index[id(child)] = len(nodes)
                nodes.append({
                    "parent": index[id(n)],
                    "tokens": [int(t) for t in child.tokens],
                    "block": int(child.block),
                    "pins": int(child.pins),
                    "last_used": int(child.last_used),
                    "partial": partial,
                })
                stack.append(child)
    data = {"nodes": nodes, "clock": int(cache._clock),
            "hits": int(cache.hits), "misses": int(cache.misses),
            "evicted": int(cache.evicted)}
    return data, index


def restore_radix(cache, data: Dict[str, Any]) -> List[Any]:
    """Structural rebuild, node objects only.  Block refcounts are
    restored wholesale on the allocator, so construction here takes NO
    new references.  Returns nodes in serialization order (for mapping
    active slots' ``prefix_node`` indices back to objects)."""
    from repro_torch.serving.paged_cache import RadixNode
    cache.root = RadixNode((), None, None)
    objs: List[Any] = []
    for nd in data["nodes"]:
        parent = cache.root if nd["parent"] < 0 else objs[nd["parent"]]
        tokens = tuple(nd["tokens"])
        node = RadixNode(tokens, nd["block"], parent)
        node.pins = int(nd["pins"])
        node.last_used = int(nd["last_used"])
        (parent.partials if nd["partial"] else parent.children)[tokens] \
            = node
        objs.append(node)
    cache._clock = int(data["clock"])
    cache.hits = int(data["hits"])
    cache.misses = int(data["misses"])
    cache.evicted = int(data["evicted"])
    return objs


# --------------------------------------------------------------------
# host swap tier
# --------------------------------------------------------------------

def snapshot_swap_tier(tier) -> Tuple[Dict[str, Any],
                                      Optional[torch.Tensor]]:
    """Serialize the tier's books plus only the USED host slots of the
    backing store, in the reference's layout ``[P, L, n_used, bt, Hkv,
    D]`` (the port's store is slot-major, ``[slots, P, L, ...]``).
    ``maps`` order is preserved: resume is FIFO."""
    used = sorted(tier.slot_ref)
    meta = {
        "num_slots": int(tier.num_slots),
        "capacity": int(tier.capacity),
        "free": [int(s) for s in tier.free],
        "slot_ref": [[int(s), int(n)] for s, n in sorted(tier.slot_ref.items())],
        "by_block": [[int(b), int(s)] for b, s in sorted(tier.by_block.items())],
        "maps": [[int(k), [int(s) for s in v]] for k, v in tier.maps.items()],
        "copied_slots": int(tier.copied_slots),
        "deduped_blocks": int(tier.deduped_blocks),
        "used": used,
    }
    store = None
    if used:
        store = tier._store[used].movedim(0, 2).contiguous()
    return meta, store


def restore_swap_tier(tier, meta: Dict[str, Any],
                      store: Optional[Array]) -> None:
    """Restore the tier's books, and write the file's used slots
    (``[P, L, n_used, ...]``) into the tier's own store, in place: the
    store stays where it was allocated (pinned on the card)."""
    if int(meta["num_slots"]) != tier.num_slots:
        raise SnapshotMismatchError(
            f"swap tier has {tier.num_slots} slots, snapshot wants "
            f"{meta['num_slots']}")
    used = [int(s) for s in meta["used"]]
    if used:
        if store is None:
            raise SnapshotMismatchError(
                "swap tier has used slots but no swap_store array")
        vals = _host_tensor(store)
        page = tuple(tier._store.shape[1:])
        got = tuple(vals.shape[:2]) + tuple(vals.shape[3:])
        if got != page or vals.shape[2] != len(used) \
                or vals.dtype != tier._store.dtype:
            raise SnapshotMismatchError(
                f"swap_store {tuple(vals.shape)} {vals.dtype}: the tier "
                f"holds pages {page} {tier._store.dtype}")
        tier._store[torch.tensor(used)] = vals.movedim(2, 0)
    tier.capacity = int(meta["capacity"])
    tier.free = [int(s) for s in meta["free"]]
    tier.slot_ref = {int(s): int(n) for s, n in meta["slot_ref"]}
    tier.by_block = {int(b): int(s) for b, s in meta["by_block"]}
    tier.slot_block = {int(s): int(b) for b, s in meta["by_block"]}
    tier.maps = {int(k): [int(s) for s in v] for k, v in meta["maps"]}
    tier.copied_slots = int(meta["copied_slots"])
    tier.deduped_blocks = int(meta["deduped_blocks"])


# --------------------------------------------------------------------
# full-engine image
# --------------------------------------------------------------------

# integer engine counters restored verbatim (the reference's list; spec
# counters excluded, as §16 engines refuse to snapshot).  The port's own
# counters of the process (graph_captures, guard_readbacks, the kernels'
# launch counts) are not in the file: a restored engine starts them at 0
_COUNTERS = (
    "evictions", "host_syncs", "decode_steps", "prefill_tokens",
    "prefill_dispatches", "cow_copies", "clock", "windows",
    "stall_ticks", "deadline_misses", "quarantined",
    "requeue_prefix_hits", "swap_outs", "swap_ins", "swapped_blocks",
    "swap_reused_blocks", "reprefilled_swapped_tokens",
    "swapped_ctx_tokens", "replayed_reprefill_tokens",
)


def _swapped_image_meta(rid: int, img: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "rid": int(rid),
        "req": req_to_dict(img["req"]),
        "generated": [int(t) for t in img["generated"]],
        "target": int(img["target"]),
        "deadline": None if img["deadline"] is None else int(img["deadline"]),
        "reserve_tokens": int(img["reserve_tokens"]),
        "reserve_g": int(img["reserve_g"]),
        "pos": int(img["pos"]),
        "blocks": int(img["blocks"]),
    }


def save_engine(engine, path: str, *, page_blocks: List[int],
                page_values: Optional[Array], logits: Array) -> str:
    """Serialize the full engine image to ``path``.

    Device state arrives already read back (``page_values`` is the
    gathered KV of ``page_blocks``, ``[P, L, n, bt, Hkv, D]``; ``logits``
    the slot logits rows): the counted sync sites live in
    ``engine.snapshot()``, not here."""
    alloc = engine.allocator
    radix_data: Optional[Dict[str, Any]] = None
    node_index: Dict[int, int] = {}
    if engine.prefix_cache is not None:
        radix_data, node_index = snapshot_radix(engine.prefix_cache)

    active: List[Optional[Dict[str, Any]]] = []
    for slot, a in enumerate(engine.active):
        if a is None:
            active.append(None)
            continue
        prefix = a.get("prefix")
        active.append({
            "req": req_to_dict(a["req"]),
            "generated": [int(t) for t in a["generated"]],
            "target": int(a["target"]),
            "deadline": None if a["deadline"] is None
            else int(a["deadline"]),
            "reserve_tokens": int(a["reserve_tokens"]),
            "reserve_g": int(a["reserve_g"]),
            "prefix_node": None if prefix is None else node_index[id(prefix)],
            "pos": int(engine.pos_host[slot]),
        })

    swap_meta = store = None
    if engine.swap is not None:
        swap_meta, store = snapshot_swap_tier(engine.swap)
    swapped = [_swapped_image_meta(rid, img)
               for rid, img in engine._swapped.items()]
    swapped_logits = [img["logits"] for img in engine._swapped.values()]

    faults_state = None
    if engine.faults is not None:
        inj = engine.faults
        faults_state = {
            "idx": int(inj._idx),
            "sidx": int(inj._sidx),
            "skew": [[app, float(f)] for app, f in inj._skew.items()],
            "swap_stall_budget": int(inj._swap_stall_budget),
            "crashed": sorted(int(i) for i in inj._crashed),
        }

    meta: Dict[str, Any] = {
        "version": SNAPSHOT_VERSION,
        "wall_time": time.time(),
        "cfg_name": engine.cfg.name,
        "dtype": dtype_name(engine.dtype),
        "num_blocks": int(alloc.num_blocks),
        "block_tokens": int(alloc.block_tokens),
        "slots": int(engine.slots),
        "max_len": int(engine.max_len),
        "max_gen": int(engine.max_gen),
        "max_blocks": int(engine.max_blocks),
        "null_block": int(engine.null_block),
        "prefix_cache": engine.prefix_cache is not None,
        "swap_slots": int(engine.swap.num_slots)
        if engine.swap is not None else 0,
        "allocator": {
            "free": [int(b) for b in alloc.free],
            "tables": [[int(s), [int(b) for b in t]]
                       for s, t in alloc.tables.items()],
            "refcount": [[int(b), int(n)]
                         for b, n in sorted(alloc.refcount.items())],
        },
        "radix": radix_data,
        "active": active,
        "swap": swap_meta,
        "swapped": swapped,
        "swap_debt": sorted(int(r) for r in engine._swap_debt),
        "page_blocks": [int(b) for b in page_blocks],
        "counters": {name: int(getattr(engine, name))
                     for name in _COUNTERS},
        "swap_in_s": float(engine.swap_in_s),
        "ewma": {
            "alpha": float(engine.mispredict.alpha),
            "max_headroom": float(engine.mispredict.max_headroom),
            "ratio": [[app, float(f)]
                      for app, f in sorted(engine.mispredict.ratio.items())],
            "samples": int(engine.mispredict.samples),
        },
        "retries": [[int(k), int(v)]
                    for k, v in sorted(engine.retries.items())],
        "observed_gen": [[int(k), int(v)]
                        for k, v in sorted(engine._observed_gen.items())],
        "requeued": sorted(int(r) for r in engine._requeued),
        "generated": [[int(r), [int(t) for t in toks]]
                      for r, toks in engine.generated.items()],
        "shed_log": [{"req": req_to_dict(s.req), "reason": s.reason,
                      "clock": int(s.clock)} for s in engine.shed_log],
        "restored_ids": sorted(int(r) for r in engine._restored_ids),
        "faults": faults_state,
    }

    arrays: Dict[str, Array] = {"logits": logits}
    if page_values is not None:
        arrays["page_values"] = page_values
    if store is not None:
        arrays["swap_store"] = store
    if swapped_logits:
        arrays["swapped_logits"] = torch.stack(swapped_logits)
    return write_snapshot(path, meta, arrays)


def _require(meta: Dict[str, Any], key: str, want: Any, path: str) -> None:
    got = meta.get(key)
    if got != want:
        raise SnapshotMismatchError(
            f"{path}: snapshot {key}={got!r}, engine wants {want!r}")


def _require_shape(name: str, got: torch.Tensor, want: Tuple[int, ...],
                   dtype: torch.dtype, path: str) -> None:
    if tuple(got.shape) != tuple(want) or got.dtype != dtype:
        raise SnapshotMismatchError(
            f"{path}: {name} {tuple(got.shape)} {got.dtype}, engine wants "
            f"{tuple(want)} {dtype}")


def load_engine(engine, path: str) -> None:
    """Apply a snapshot to a freshly constructed idle engine (one that
    ``warmup()`` has run on is idle: warmup writes nothing a request
    reads).

    The allocator's books are overwritten wholesale (free-list order
    included: allocation order after restore matches the crashed
    process exactly), exactly the snapshot's blocks are scattered back
    into the pools, the slot tensors are written in place (a captured
    decode graph reads them at their addresses), and the §13 shadow is
    REBUILT from the snapshot and cross-checked against the restored
    books (``check_allocator`` runs unconditionally: recovery is exactly
    when the books are least trusted).  Every device write is enqueued on
    the engine's stream, ahead of any later replay.
    """
    from repro_torch.analysis import sanitizer as _san
    from repro_torch.models import model as M
    from repro_torch.serving.faults import FAULT_SEQ, Shed

    meta, arrays = read_snapshot(path)
    if meta.get("version") != SNAPSHOT_VERSION:
        raise SnapshotMismatchError(
            f"{path}: snapshot version {meta.get('version')!r}, "
            f"reader wants {SNAPSHOT_VERSION}")
    if engine.spec_decode:
        raise SnapshotError(
            "snapshot/restore does not cover speculative engines (§16)")
    alloc = engine.allocator
    _require(meta, "cfg_name", engine.cfg.name, path)
    _require(meta, "dtype", dtype_name(engine.dtype), path)
    _require(meta, "num_blocks", int(alloc.num_blocks), path)
    _require(meta, "block_tokens", int(alloc.block_tokens), path)
    _require(meta, "slots", int(engine.slots), path)
    _require(meta, "max_len", int(engine.max_len), path)
    _require(meta, "max_gen", int(engine.max_gen), path)
    _require(meta, "max_blocks", int(engine.max_blocks), path)
    _require(meta, "null_block", int(engine.null_block), path)
    _require(meta, "prefix_cache", engine.prefix_cache is not None, path)
    _require(meta, "swap_slots",
             int(engine.swap.num_slots) if engine.swap is not None else 0,
             path)
    if engine.num_active or engine._swapped or engine.generated \
            or engine.windows:
        raise SnapshotError(
            "restore requires a freshly constructed idle engine")
    logits = _host_tensor(arrays["logits"])
    _require_shape("logits", logits, tuple(engine.logits.shape),
                   engine.logits.dtype, path)
    blocks = [int(b) for b in meta["page_blocks"]]
    vals = None
    if blocks:
        vals = _host_tensor(arrays["page_values"])
        pool = engine.pages[sorted(engine.pages)[0]]
        _require_shape("page_values", vals,
                       (len(engine.pages), pool.shape[0], len(blocks))
                       + tuple(pool.shape[2:]), pool.dtype, path)

    # 1. allocator books, wholesale (free-list ORDER is semantic:
    #    allocate() pops from the end)
    alloc.free = [int(b) for b in meta["allocator"]["free"]]
    alloc.tables = {int(s): [int(b) for b in t]
                    for s, t in meta["allocator"]["tables"]}
    alloc.refcount = {int(b): int(n)
                      for b, n in meta["allocator"]["refcount"]}
    # a dead process's fault plan does not survive it: without an
    # injector to release them, blocks the crashed run's injector held
    # under FAULT_SEQ are freed here (bookkeeping only, no shadow hooks:
    # the shadow is rebuilt from scratch below)
    if engine.faults is None and alloc.tables.get(FAULT_SEQ):
        for b in alloc.tables.pop(FAULT_SEQ):
            n = alloc.refcount[b] - 1
            if n:
                alloc.refcount[b] = n
            else:
                del alloc.refcount[b]
                alloc.free.append(b)

    # 2. radix prefix tree (structural; refcounts already restored)
    node_objs: List[Any] = []
    if engine.prefix_cache is not None and meta["radix"] is not None:
        node_objs = restore_radix(engine.prefix_cache, meta["radix"])

    # 3. device pools: exactly the snapshot's blocks, scattered in place
    if blocks:
        (blk,) = engine._upload(np.array(blocks, np.int32))
        M.scatter_pages(engine.pages, blk,
                        vals.to(engine.device, non_blocking=True))

    # 4. slot state: tables/positions/mask/logits, in place, + host mirrors
    rows = np.full((engine.slots, engine.max_blocks), engine.null_block,
                   np.int32)
    pos = np.zeros(engine.slots, np.int32)
    mask = np.zeros(engine.slots, np.int32)
    engine.active = [None] * engine.slots
    for slot, a in enumerate(meta["active"]):
        if a is None:
            continue
        table = alloc.tables.get(slot, [])
        rows[slot, :len(table)] = table
        pos[slot] = int(a["pos"])
        mask[slot] = 1
        prefix = (node_objs[a["prefix_node"]]
                  if a["prefix_node"] is not None else None)
        engine.active[slot] = {
            "req": req_from_dict(a["req"]),
            "generated": [int(t) for t in a["generated"]],
            "target": int(a["target"]),
            "prefix": prefix,
            "deadline": a["deadline"],
            "reserve_tokens": int(a["reserve_tokens"]),
            "reserve_g": int(a["reserve_g"]),
        }
    rows_t, pos_t, mask_t = engine._upload(rows, pos, mask)
    engine.tables.copy_(rows_t)
    engine.positions.copy_(pos_t)
    engine.active_mask.copy_(mask_t != 0)
    engine.logits.copy_(logits)
    engine.pos_host = pos.copy()

    # 5. swap tier + suspended images (their logits rows in host memory,
    #    pinned on the card, as a swap-out leaves them)
    if engine.swap is not None and meta["swap"] is not None:
        restore_swap_tier(engine.swap, meta["swap"],
                          arrays.get("swap_store"))
    engine._swapped = {}
    srows = arrays.get("swapped_logits")
    if meta["swapped"]:
        srows = _host_tensor(srows)
        _require_shape("swapped_logits", srows,
                       (len(meta["swapped"]),) + tuple(engine.logits.shape[1:]),
                       engine.logits.dtype, path)
    for i, img in enumerate(meta["swapped"]):
        row = engine.swap.host_empty(engine.logits.shape[1:],
                                     engine.logits.dtype)
        row.copy_(srows[i])
        engine._swapped[int(img["rid"])] = {
            "req": req_from_dict(img["req"]),
            "generated": [int(t) for t in img["generated"]],
            "target": int(img["target"]),
            "deadline": img["deadline"],
            "reserve_tokens": int(img["reserve_tokens"]),
            "reserve_g": int(img["reserve_g"]),
            "pos": int(img["pos"]),
            "blocks": int(img["blocks"]),
            "logits": row,
        }
    engine._swap_debt = set(int(r) for r in meta["swap_debt"])

    # 6. counters / EWMA / lifecycle books
    for name in _COUNTERS:
        setattr(engine, name, int(meta["counters"][name]))
    engine.swap_in_s = float(meta["swap_in_s"])
    ewma = meta["ewma"]
    engine.mispredict.alpha = float(ewma["alpha"])
    engine.mispredict.max_headroom = float(ewma["max_headroom"])
    engine.mispredict.ratio = {app: float(f) for app, f in ewma["ratio"]}
    engine.mispredict.samples = int(ewma["samples"])
    engine.retries = {int(k): int(v) for k, v in meta["retries"]}
    engine._observed_gen = {int(k): int(v)
                            for k, v in meta["observed_gen"]}
    engine._requeued = set(int(r) for r in meta["requeued"])
    engine.generated = {int(r): [int(t) for t in toks]
                        for r, toks in meta["generated"]}
    engine.shed_log = [Shed(req_from_dict(s["req"]), s["reason"],
                            int(s["clock"])) for s in meta["shed_log"]]
    # every request whose progress this snapshot covers: a re-prefill
    # of one after restore is a recovery bug (counted by the engine)
    engine._restored_ids = set(int(r) for r in meta["restored_ids"])
    engine._restored_ids.update(
        a["req"]["req_id"] for a in meta["active"] if a is not None)
    engine._restored_ids.update(engine._swapped)

    # 7. fault-injector cursors (when the restored process injects the
    #    same seeded plan, replay walks the identical schedule)
    if engine.faults is not None and meta["faults"] is not None:
        inj = engine.faults
        fs = meta["faults"]
        inj._idx = int(fs["idx"])
        inj._sidx = int(fs["sidx"])
        inj._skew = {app: float(f) for app, f in fs["skew"]}
        inj._swap_stall_budget = int(fs["swap_stall_budget"])
        inj._crashed = set(int(i) for i in fs["crashed"])
        inj.held_blocks = len(alloc.tables.get(FAULT_SEQ, ()))

    # 8. §13 cross-check: rebuild the shadow from the SNAPSHOT, then
    #    audit it against the restored books.  check_allocator runs
    #    even with the sanitizer off
    shadow = _san.maybe_shadow(alloc)
    if shadow is not None:
        for seq, table in alloc.tables.items():
            for b in table:
                shadow.holders.setdefault(b, []).append(seq)
        if engine.prefix_cache is not None:
            for b in engine.prefix_cache.retained_blocks():
                shadow.holders.setdefault(b, []).append(_san.CACHE_HOLDER)
        if engine.swap is not None:
            for b in engine.swap.device_holds():
                shadow.holders.setdefault(b, []).append(_san.SWAP_HOLDER)
        shadow.materialized = {slot for slot, a in enumerate(engine.active)
                               if a is not None}
        shadow.swapped = set(engine._swapped)
    alloc._shadow = shadow
    _san.check_allocator(alloc, engine.prefix_cache, engine.swap)


# --------------------------------------------------------------------
# write-ahead admission journal
# --------------------------------------------------------------------

class AdmissionJournal:
    """Append-only CRC-framed JSON-lines write-ahead log.

    Record kinds: ``admit`` (req image + admission clock + resolved
    ttl), ``finish`` (req_id + token stream), ``shed`` (req_id + typed
    reason), ``swap`` (req_id + direction), ``snapshot`` (filename
    marker: restore starts from the LAST marker whose file still
    exists).  ``sync()`` flushes and fsyncs; the
    :class:`RecoveryManager` calls it at window boundaries, so at most
    one window of tail records can be lost to a crash, and the final
    line of that tail may be torn, which :meth:`read` tolerates.
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a", encoding="utf-8")
        self.records_written = 0

    def append(self, kind: str, **fields: Any) -> None:
        rec = dict(fields)
        rec["kind"] = kind
        payload = json.dumps(rec, sort_keys=True)
        crc = zlib.crc32(payload.encode())
        self._fh.write(f"{crc:08x} {payload}\n")
        self.records_written += 1

    def sync(self) -> None:
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()

    @staticmethod
    def read(path: str, allow_torn: bool = True
             ) -> Tuple[List[Dict[str, Any]], int]:
        """Parse the journal.  Returns ``(records, torn)`` where
        ``torn`` counts dropped trailing lines (0 or 1).  A corrupt
        record anywhere but the final line always raises
        :class:`JournalCorruptError`; a corrupt FINAL line raises
        :class:`JournalTornError` unless ``allow_torn``."""
        records: List[Dict[str, Any]] = []
        with open(path, "r", encoding="utf-8") as fh:
            lines = fh.read().split("\n")
        if lines and lines[-1] == "":
            lines.pop()
        for i, line in enumerate(lines):
            final = i == len(lines) - 1
            try:
                crc_hex, payload = line.split(" ", 1)
                if int(crc_hex, 16) != zlib.crc32(payload.encode()):
                    raise ValueError("crc mismatch")
                rec = json.loads(payload)
                if not isinstance(rec, dict) or "kind" not in rec:
                    raise ValueError("not a record")
            except (ValueError, json.JSONDecodeError) as e:
                if final:
                    if allow_torn:
                        return records, 1
                    raise JournalTornError(
                        f"{path}: torn final record ({e})") from e
                raise JournalCorruptError(
                    f"{path}: corrupt record at line {i + 1} ({e})") from e
            records.append(rec)
        return records, 0


class RecoveryManager:
    """Wires an engine run to a checkpoint directory: journals the
    admission lifecycle write-ahead, fsyncs at window boundaries, and
    takes a full snapshot every ``snapshot_every`` windows."""

    def __init__(self, checkpoint_dir: str, snapshot_every: int = 8):
        if snapshot_every < 1:
            raise ValueError("snapshot_every must be >= 1")
        self.checkpoint_dir = checkpoint_dir
        self.snapshot_every = snapshot_every
        os.makedirs(checkpoint_dir, exist_ok=True)
        self.journal = AdmissionJournal(
            os.path.join(checkpoint_dir, JOURNAL_NAME))
        self.snapshots_taken = 0
        self.last_snapshot_window = 0
        self._journaled: set = set()     # req_ids with an admit record
        self._finished: set = set()      # req_ids with a finish record
        self._shed_cursor = 0            # engine.shed_log prefix journaled

    # -- serve-loop hooks --------------------------------------------

    def attach(self, engine) -> None:
        engine.journal = self.journal
        self.last_snapshot_window = engine.windows

    def on_admit(self, req: Request, engine) -> None:
        if req.req_id in self._journaled:
            return                        # requeued eviction: already WAL'd
        self._journaled.add(req.req_id)
        ttl = req.ttl_steps if req.ttl_steps is not None \
            else engine.default_ttl
        self.journal.append("admit", rid=int(req.req_id),
                            clock=int(engine.clock),
                            ttl=None if ttl is None else int(ttl),
                            req=req_to_dict(req))

    def after_window(self, engine, finished=None) -> None:
        for req in (finished or []):
            if req.req_id in self._finished:
                continue
            self._finished.add(req.req_id)
            toks = engine.generated.get(req.req_id, [])
            self.journal.append("finish", rid=int(req.req_id),
                                clock=int(engine.clock),
                                tokens=[int(t) for t in toks])
        while self._shed_cursor < len(engine.shed_log):
            s = engine.shed_log[self._shed_cursor]
            self._shed_cursor += 1
            self.journal.append("shed", rid=int(s.req.req_id),
                                reason=s.reason, clock=int(s.clock))
        self.journal.sync()
        if engine.windows - self.last_snapshot_window >= self.snapshot_every:
            self.snapshot(engine)

    def snapshot(self, engine) -> str:
        """Snapshot file FIRST, journal marker after: a crash between
        the two loses only the marker, never references a file that
        does not exist."""
        name = f"snap-{engine.windows:08d}.npz"
        path = os.path.join(self.checkpoint_dir, name)
        t0 = time.perf_counter()
        engine.snapshot(path)
        self.journal.append("snapshot", file=name,
                            clock=int(engine.clock),
                            windows=int(engine.windows),
                            took_s=time.perf_counter() - t0)
        self.journal.sync()
        self.snapshots_taken += 1
        self.last_snapshot_window = engine.windows
        return path

    def close(self) -> None:
        self.journal.close()


# --------------------------------------------------------------------
# recovery: snapshot + journal tail -> finished run
# --------------------------------------------------------------------

def recover(engine_factory, checkpoint_dir: str, *,
            downtime_ticks: int = 0, snapshot_every: int = 8,
            drive_kwargs: Optional[Dict[str, Any]] = None):
    """Bring a crashed run to completion.

    ``engine_factory`` must build a FRESH engine with the same geometry
    (and, for replay determinism, the same params/seed and the same
    seeded fault plan) as the crashed process; it may have been warmed
    (``warmup=True``), which on the card captures its decode graph
    before the restore.  Returns ``(engine, report)`` where the engine
    holds every finished stream and ``report`` carries the recovery
    accounting.
    """
    from repro_torch.serving.engine import drive_paged
    from repro_torch.serving.faults import Shed

    journal_path = os.path.join(checkpoint_dir, JOURNAL_NAME)
    if not os.path.exists(journal_path):
        raise JournalError(f"{checkpoint_dir}: no {JOURNAL_NAME}")
    records, torn = AdmissionJournal.read(journal_path, allow_torn=True)

    engine = engine_factory()
    t0 = time.perf_counter()

    # last journal-marked snapshot whose file survived
    snap_path = None
    for rec in reversed(records):
        if rec["kind"] == "snapshot":
            cand = os.path.join(checkpoint_dir, rec["file"])
            if os.path.exists(cand):
                snap_path = cand
                break
    if snap_path is not None:
        engine.restore(snap_path)
    restore_s = time.perf_counter() - t0

    admits: Dict[int, Dict[str, Any]] = {}
    finish_tokens: Dict[int, List[int]] = {}
    for rec in records:
        if rec["kind"] == "admit":
            admits[int(rec["rid"])] = rec
        elif rec["kind"] == "finish":
            finish_tokens[int(rec["rid"])] = [int(t)
                                              for t in rec["tokens"]]

    # requests already resolved by the restored image (the snapshot is
    # the authority; post-snapshot finish/shed records are re-derived
    # by replay and cross-checked below)
    done = set(engine.generated) \
        | {s.req.req_id for s in engine.shed_log}
    covered = {a["req"].req_id for a in engine.active if a is not None} \
        | set(engine._swapped)

    # downtime: TTLs keep running while the process is dead.  Journaled
    # requests whose deadline elapsed across the gap are typed sheds,
    # not replays
    engine.clock += int(downtime_ticks)
    expired = 0
    if downtime_ticks:
        for slot, a in enumerate(engine.active):
            if a is None or a["deadline"] is None \
                    or engine.clock < a["deadline"]:
                continue
            engine.shed_log.append(Shed(a["req"], "journal_expired",
                                        engine.clock))
            engine._unpin_prefix(slot)
            engine.allocator.free_seq(slot)
            engine._release(slot)
            engine._restored_ids.discard(a["req"].req_id)
            done.add(a["req"].req_id)
            covered.discard(a["req"].req_id)
            expired += 1
        for rid in list(engine._swapped):
            img = engine._swapped[rid]
            if img["deadline"] is not None \
                    and engine.clock >= img["deadline"]:
                engine._drop_swapped(rid, "journal_expired")
                engine._restored_ids.discard(rid)
                done.add(rid)
                covered.discard(rid)
                expired += 1

    # journaled admits not resolved and not resident: replay them.
    # TTL-expired-across-downtime ones are typed sheds up front
    replay: List[Request] = []
    for rid, rec in admits.items():
        if rid in done or rid in covered:
            continue
        req = req_from_dict(rec["req"])
        if downtime_ticks and rec["ttl"] is not None \
                and int(rec["clock"]) + int(rec["ttl"]) <= engine.clock:
            engine.shed_log.append(Shed(req, "journal_expired",
                                        engine.clock))
            expired += 1
            continue
        replay.append(req)

    manager = RecoveryManager(checkpoint_dir,
                              snapshot_every=snapshot_every)
    manager._journaled = set(admits)
    manager._finished = {rid for rid in finish_tokens
                         if rid in engine.generated}
    manager._shed_cursor = len(engine.shed_log)
    manager.attach(engine)

    stats = drive_paged(engine, replay, recovery=manager,
                        **(drive_kwargs or {}))
    manager.close()

    # self-check: streams the crashed process already journaled as
    # finished must re-derive identically
    confirmed = mismatches = 0
    for rid, toks in finish_tokens.items():
        got = engine.generated.get(rid)
        if got is None:
            continue
        if list(got) == toks:
            confirmed += 1
        else:
            mismatches += 1

    shed_after = {s.req.req_id for s in engine.shed_log}
    report = {
        "journaled": len(admits),
        "outstanding": len(replay),
        "expired": expired,
        "recovered": len([r for r in admits
                          if r in engine.generated or r in shed_after]),
        "replayed_reprefill_tokens":
            int(engine.replayed_reprefill_tokens),
        "restore_s": restore_s,
        "torn_records": torn,
        "snapshot_used": snap_path,
        "journal_confirmed": confirmed,
        "journal_mismatches": mismatches,
        "stats": stats,
    }
    return engine, report
