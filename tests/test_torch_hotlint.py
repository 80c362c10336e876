"""The port's hot-path lint (``repro_torch/analysis/hotlint.py``), held as
the reference's ``tests/test_hotlint.py`` holds its own:

- the port's serving/models/kernels tree lints clean (the gate);
- each seeded fixture (``tests/fixtures/torch_hotlint/``: parsed, never
  imported) is caught by exactly its rule;
- the hot set is the call-graph closure of the engine loops;
- the port's counted sync sites equal the reference lint's on
  ``src/repro``, the set both runtime ledgers are checked against;
- the CLI exits 0 on a clean sweep, 1 on a new finding, 0 again once
  the finding is in a baseline;
- on a copy of ``src/repro_torch``, one planted fault per rule is caught
  at its file and function: an ``.item()`` in ``step_window``, a
  rebinding of ``self.logits`` in a ``PagedContinuousEngine`` method,
  an ``argtypes`` one entry short, and a rebinding of the token buffer
  that ``ContinuousEngine``'s captured step reads, in its ``step``;
- the torch triggers of HL001, each on a small snippet, and the host
  values and in-place writes that must stay quiet.
"""
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.analysis import hotlint as jax_hotlint
from repro_torch.analysis import hotlint

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FIXTURES = ROOT / "tests" / "fixtures" / "torch_hotlint"
SEEDS = [
    ("seed_sync.py", "HL001"),
    ("seed_h2d.py", "HL001"),
    ("seed_graph.py", "HL002"),
    ("seed_abi.py", "HL004"),
    ("seed_ledger.py", "HL005"),
]


def test_port_sweep_is_clean():
    """The enforced invariant: the port's serving/models/kernels tree
    carries no unsuppressed hot-path violation, and its ctypes lists
    agree with the CUDA sources."""
    findings = hotlint.lint([str(PORT)])
    assert findings == [], "\n".join(f.render() for f in findings)


LINT_FILES = [PORT / "analysis" / "hotlint.py",
              *sorted((PORT / "analysis" / "rules").glob("*.py")),
              ROOT / "scripts" / "hotlint_torch.py"]


@pytest.mark.parametrize("path", LINT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_lint_is_stdlib_only(path):
    """The lint parses the tree and never imports it: none of its files
    imports torch, jax or the reference package."""
    import ast
    tree = ast.parse(path.read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module or "" for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.level == 0]
    bad = [m for m in mods
           if m.split(".")[0] in ("torch", "jax", "jaxlib", "repro", "numpy")]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("name,rule", SEEDS)
def test_seeded_violation_caught_by_matching_rule(name, rule):
    findings = hotlint.lint([str(FIXTURES / name)])
    assert findings, f"{name}: no findings"
    assert sorted({f.rule for f in findings}) == [rule], \
        [f.render() for f in findings]


def test_abi_rule_reads_every_kernel_source():
    """All ten entry points are declared in ``build.py`` and defined
    in ``csrc/*.cu``; the rule parses each signature (16-27 parameters)."""
    from repro_torch.analysis.rules import ctypes_abi
    project = hotlint.build_project([str(PORT)])
    sigs, errors = ctypes_abi.c_signatures(project.cu_files)
    assert errors == []
    assert set(sigs) == {
        "repro_paged_decode_attention", "repro_paged_prefix_prefill_attention",
        "repro_flash_attention", "repro_flash_attention_bwd",
        "repro_decode_attention", "repro_decode_attention_int8",
        "repro_decode_attention_partial",
        "repro_decode_attention_int8_partial",
        "repro_ssd_scan", "repro_ssd_scan_bwd"}
    assert all(16 <= len(kinds) <= 27 for _, kinds in sigs.values())


def test_hot_set_includes_engine_closure():
    """Hotness propagates from the named seeds through the call graph into
    the model facade, the captured graphs and the kernel launchers."""
    project = hotlint.build_project([str(PORT)])
    hot = {k for k, f in project.func_index.items() if f.hot}
    for full in (
        "repro_torch.serving.engine.PagedContinuousEngine.step_window",
        "repro_torch.serving.engine.PagedContinuousEngine._grow",
        "repro_torch.serving.engine.BatchEngine.serve_batch",
        "repro_torch.models.transformer.decode_multi_paged",
        "repro_torch.serving.graphs.DecodeGraph.window",
        "repro_torch.serving.graphs.CapturedStep.replay",
        "repro_torch.serving.graphs.SpecGraph.run",
        "repro_torch.kernels.decode_attention.kernel."
        "paged_decode_attention_kernel",
    ):
        assert full in hot, f"{full} missing from hot closure"


def test_counted_sync_sites_equal_the_reference_lints():
    """Every engine loop that increments host_syncs carries a counted
    suppression, at the same six (file, function) sites as the
    reference's: the set both runtime ledgers are checked against."""
    sites = hotlint.collect_sync_sites([str(PORT)])
    assert sites == jax_hotlint.collect_sync_sites([str(ROOT / "src" /
                                                        "repro")])
    assert sites == {("engine.py", "serve_batch"),
                     ("engine.py", "step"),
                     ("engine.py", "step_window"),
                     ("engine.py", "_spec_window"),
                     ("engine.py", "_swap_out"),
                     ("engine.py", "snapshot")}


def test_uncounted_barrier_is_a_suppressed_site():
    """The padded batch's decode-time barrier is suppressed uncounted, in
    the function whose readback is counted."""
    sites = hotlint.suppressed_sync_sites([str(PORT)])
    assert sites[("engine.py", "serve_batch")] is True
    assert set(sites) == hotlint.collect_sync_sites([str(PORT)])


def test_cli_exit_codes(tmp_path, monkeypatch):
    """scripts/hotlint_torch.py: clean sweep -> 0; seeded violation -> 1
    with the rule id on stdout; same violation under a baseline -> 0."""
    monkeypatch.chdir(ROOT)   # baseline keys are cwd-relative
    cli = str(ROOT / "scripts" / "hotlint_torch.py")

    def run(*args):
        return subprocess.run([sys.executable, cli, *args], cwd=ROOT,
                              capture_output=True, text=True)

    clean = run("src/repro_torch", "--baseline",
                "scripts/hotlint_torch_baseline.txt")
    assert clean.returncode == 0, clean.stdout + clean.stderr

    seeded = run(str(FIXTURES / "seed_sync.py"))
    assert seeded.returncode == 1
    assert "HL001" in seeded.stdout

    baseline = tmp_path / "baseline.txt"
    keys = {f.baseline_key()
            for f in hotlint.lint([str(FIXTURES / "seed_sync.py")])}
    baseline.write_text("\n".join(sorted(keys)) + "\n")
    accepted = run(str(FIXTURES / "seed_sync.py"),
                   "--baseline", str(baseline))
    assert accepted.returncode == 0, accepted.stdout + accepted.stderr


# ---------------------------------------------------------------------------
# planted faults on a copy of the port
# ---------------------------------------------------------------------------

def _plant(tmp_path, rel, old, new):
    root = tmp_path / "repro_torch"
    shutil.copytree(PORT, root, ignore=shutil.ignore_patterns("__pycache__"))
    path = root / rel
    src = path.read_text()
    assert src.count(old) == 1, old
    path.write_text(src.replace(old, new))
    return root


PLANTS = {
    "item_in_step_window": (
        "serving/engine.py",
        "        self.windows += 1\n        stalled = 0\n",
        "        self.windows += 1\n        stalled = 0\n"
        "        probe = self.logits[0, 0].item()\n",
        "HL001", "engine.py", "PagedContinuousEngine.step_window"),
    "logits_rebound": (
        "serving/engine.py",
        "            self.logits.copy_(logits)\n",
        "            self.logits = logits\n",
        "HL002", "engine.py", "PagedContinuousEngine._decode"),
    "argtypes_short": (
        "kernels/build.py",
        "[p] * 19 + [i] * 7 + [p]",
        "[p] * 18 + [i] * 7 + [p]",
        "HL004", "build.py", "load_library"),
    "continuous_engine_captures": (
        "serving/engine.py",
        "        M.greedy_token_into(self.cfg, self.logits, self.tokens)\n",
        "        self.tokens = torch.argmax(\n"
        "            self.logits[:, :self.cfg.vocab_size], dim=-1).to(\n"
        "            torch.int32)\n",
        "HL002", "engine.py", "ContinuousEngine.step"),
}


@pytest.mark.parametrize("name", sorted(PLANTS))
def test_planted_fault_caught_at_its_site(tmp_path, name):
    rel, old, new, rule, fname, func = PLANTS[name]
    root = _plant(tmp_path, rel, old, new)
    findings = hotlint.lint([str(root)])
    assert findings, f"{name}: no findings"
    assert {f.rule for f in findings} == {rule}, \
        [f.render() for f in findings]
    assert any(Path(f.path).name == fname and f.func == func
               for f in findings), [f.render() for f in findings]


def test_planted_helper_rebinding_caught(tmp_path):
    """A helper that rebinds the engine's logits, called with ``self``
    from a method of a graph-capturing engine, is caught at the call."""
    root = _plant(
        tmp_path, "serving/engine.py",
        "def _upload(device: torch.device, *arrays: np.ndarray\n",
        "def _reset_logits(engine) -> None:\n"
        "    engine.logits = torch.zeros_like(engine.logits)\n\n\n"
        "def _upload(device: torch.device, *arrays: np.ndarray\n")
    path = root / "serving" / "engine.py"
    anchor = "    def _quarantine_draft(self, slot: int) -> None:\n"
    src = path.read_text()
    assert src.count(anchor) == 1
    path.write_text(src.replace(anchor, "    def _wipe(self) -> None:\n"
                                        "        _reset_logits(self)\n\n"
                                + anchor))
    findings = hotlint.lint([str(root)])
    assert {(f.rule, f.func) for f in findings} == {
        ("HL002", "PagedContinuousEngine._wipe")}, \
        [f.render() for f in findings]


# ---------------------------------------------------------------------------
# HL001's torch triggers, one snippet each
# ---------------------------------------------------------------------------

_HEADER = """\
import numpy as np
import torch
from repro_torch.analysis.sanitizer import hot_path


@hot_path
def hot(x: torch.Tensor, mask: torch.Tensor, n: int, dev):
"""

FLAGGED = {
    "item": "return x[0].item()",
    "tolist": "return x.tolist()",
    "cpu": "return x.cpu()",
    "numpy_call": "return np.asarray(x)",
    "to_cpu": "return x.to('cpu')",
    "int": "return int(x.sum())",
    "branch": "if x.sum() > 0:\n    return 1",
    "cuda_synchronize": "torch.cuda.synchronize()",
    "stream_synchronize": "torch.cuda.current_stream(dev).synchronize()",
    "nonzero": "return x.nonzero()",
    "torch_nonzero": "return torch.nonzero(x)",
    "masked_select": "return x.masked_select(mask)",
    "mask_index": "return x[x > 0]",
    "mask_name_index": "m = torch.isfinite(x)\nreturn x[m]",
    "unique": "return torch.unique(x)",
    "where_one_arg": "return torch.where(x > 0)",
    "repeat_interleave_tensor": "return x.repeat_interleave(mask)",
    "copy_to_pinned": ("h = torch.empty(4, pin_memory=True)\n"
                       "h.copy_(x)\nreturn h"),
    "copy_from_host": "h = torch.zeros(4)\nx.copy_(h)",
    "to_device_blocking": "return torch.ones(4).to(dev)",
    "tensor_on_device": "return torch.tensor([1, 2], device=dev)",
    "index_write_scalar": "x[n] = 0",
}

QUIET = {
    "shape": "return x.shape[0] + x.numel() + x.dim()",
    "identity": "if x is None:\n    return 0",
    "fill": "x[n].fill_(0)",
    "index_fill": "x.index_fill_(0, mask, True)",
    "device_write": "x[n] = x[0]",
    "to_device_async": "return torch.ones(4).to(dev, non_blocking=True)",
    "from_numpy_async": ("return torch.from_numpy(np.zeros(4)).to(\n"
                         "    dev, non_blocking=True)"),
    "copy_to_pinned_async": ("h = torch.empty(4, pin_memory=True)\n"
                             "h.copy_(x, non_blocking=True)\nreturn h"),
    "repeat_interleave_int": "return x.repeat_interleave(n)",
    "repeat_interleave_sized": ("return x.repeat_interleave(mask, "
                                "output_size=n)"),
    "host_tensor_read": "h = torch.zeros(4)\nreturn h.tolist()",
    "reduction_on_device": "return torch.isfinite(x).all()",
    "cuda_event_query": "return torch.cuda.current_stream(dev).query()",
}


def _snippet(tmp_path, body):
    path = tmp_path / "snippet.py"
    path.write_text(_HEADER + textwrap.indent(body, "    ") + "\n")
    return hotlint.lint([str(path)])


@pytest.mark.parametrize("name", sorted(FLAGGED))
def test_torch_sync_trigger_flagged(tmp_path, name):
    findings = _snippet(tmp_path, FLAGGED[name])
    assert [f.rule for f in findings] == ["HL001"], \
        [f.render() for f in findings]


@pytest.mark.parametrize("name", sorted(QUIET))
def test_host_values_and_device_writes_stay_quiet(tmp_path, name):
    findings = _snippet(tmp_path, QUIET[name])
    assert findings == [], [f.render() for f in findings]


def test_counted_suppression_needs_an_increment(tmp_path):
    """A counted suppression followed by the increment passes; an
    ``uncounted:`` one passes without it."""
    ok = ("# hotlint: sync(window readback)\n"
          "out = x.cpu()\n"
          "host_syncs = 0\n"
          "host_syncs += 1\n"
          "# hotlint: sync(uncounted: a barrier)\n"
          "torch.cuda.synchronize()\n"
          "return out")
    assert _snippet(tmp_path, ok) == []


# ---------------------------------------------------------------------------
# HL004's checks, one each
# ---------------------------------------------------------------------------

_CU = """\
extern "C" int entry(const float* x, void* y, int n, float scale,
                     cudaStream_t stream) { return 0; }
"""
_ABI = """\
import ctypes


def load_library():
    lib = ctypes.CDLL("libentry.so")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    {decl}
    return lib


def launch(x, y, n):
    {call}
"""
ABI_OK = dict(decl="lib.entry.argtypes = [p, p, i, f, p]\n"
                   "    lib.entry.restype = i",
              call="return load_library().entry(x, y, n, 1.0, 0)")
ABI_FAULTS = {
    "int_for_pointer": dict(ABI_OK, decl="lib.entry.argtypes = [p, i, i, f, p]"
                                         "\n    lib.entry.restype = i"),
    "float_for_int": dict(ABI_OK, decl="lib.entry.argtypes = [p, p, f, f, p]"
                                       "\n    lib.entry.restype = i"),
    "no_restype": dict(ABI_OK, decl="lib.entry.argtypes = [p, p, i, f, p]"),
    "missing_entry_point": dict(
        ABI_OK, decl="lib.entry.argtypes = [p, p, i, f, p]\n"
                     "    lib.entry.restype = i\n"
                     "    lib.gone.argtypes = [p]\n"
                     "    lib.gone.restype = i"),
    "call_one_short": dict(
        ABI_OK, call="return load_library().entry(x, y, n, 0)"),
    "call_without_argtypes": dict(
        ABI_OK, call="return load_library().entry(x, y, n, 1.0, 0) + "
                     "load_library().repro_other(x)"),
}


def _abi(tmp_path, case):
    (tmp_path / "entry.cu").write_text(_CU)
    path = tmp_path / "abi.py"
    path.write_text(_ABI.format(**case))
    return hotlint.lint([str(path)])


def test_abi_agreeing_declaration_passes(tmp_path):
    assert _abi(tmp_path, ABI_OK) == []


@pytest.mark.parametrize("name", sorted(ABI_FAULTS))
def test_abi_fault_caught(tmp_path, name):
    findings = _abi(tmp_path, ABI_FAULTS[name])
    assert [f.rule for f in findings] == ["HL004"], \
        [f.render() for f in findings]
