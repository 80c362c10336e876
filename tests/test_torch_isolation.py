"""Guards of the PyTorch port's boundaries:

- no module of ``src/repro_torch``, not ``chip_smoke.py`` and none of
  the port's scripts imports JAX, anything of the reference package
  ``repro``, or ``ml_dtypes`` (which the reference's bf16 snapshots need
  and the card's machine does not have);
- the entry points default to the CUDA card and raise without one,
  instead of running on the CPU;
- on a CPU tensor the kernel wrappers call the plain version and never
  count a kernel launch.
"""
import ast
import pathlib

import pytest
import torch

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + [
    ROOT / "scripts" / name for name in (
        "eager_step_compare.py", "encdec_phase.py", "encdec_rehearsal.py",
        "f32_invariance.py", "first_swap_out.py",
        "hybrid_phase.py", "hybrid_rehearsal.py", "mla_vlm_phases.py",
        "mla_vlm_rehearsal.py", "moe_rehearsal.py",
        "padded_graph_breakeven.py", "recovery_rehearsal.py",
        "run_cuda_tests.py", "spec_rehearsal.py", "ssd_scan_phases.py",
        "hotlint_torch.py", "sync_compare.py", "sync_phase.py",
        "chip_tools.py", "cp_phase.py", "ssd_scan_bwd_compare.py",
        "ssd_scan_bwd_phases.py", "ssm_train_hold.py", "ssm_train_phase.py",
        "train_phase.py", "roofline_phase.py", "continuous_phase.py")]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")]
    assert not bad, f"{path.name} imports {bad}"


def test_hypothesis_shim_runs_properties():
    """``repro_torch.testing``, the tests' stand-in for ``hypothesis``
    where it is missing, draws each strategy's values and runs a
    property over them, as the reference's shim does."""
    from repro_torch.testing import given, settings
    from repro_torch.testing import strategies as st
    seen = []

    @settings(max_examples=7)
    @given(st.integers(0, 5), st.lists(st.booleans(), min_size=1,
                                       max_size=3),
           st.sampled_from("ab"))
    def prop(n, flags, c):
        seen.append((n, flags, c))
        assert 0 <= n <= 5 and 1 <= len(flags) <= 3 and c in "ab"

    prop()
    assert len(seen) == 7


def test_port_files_found():
    assert len(PORT_FILES) > 20
    assert (ROOT / "src" / "repro_torch" / "csrc"
            / "paged_decode_attention.cu").is_file()
    assert (ROOT / "src" / "repro_torch" / "csrc"
            / "paged_prefix_prefill_attention.cu").is_file()
    for name in ("flash_attention.cu", "decode_attention.cu",
                 "ssd_scan.cu"):
        assert (ROOT / "src" / "repro_torch" / "csrc" / name).is_file()
    # the encoder-decoder family and the simulator backend are among the
    # files the import guard reads
    for rel in ("models/encdec.py", "sim/events.py", "sim/runner.py",
                "serving/cost_model.py"):
        assert ROOT / "src" / "repro_torch" / rel in PORT_FILES, rel


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_without_device_raises_instead_of_using_the_cpu(no_cuda):
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import PagedContinuousEngine
    cfg = get_config("smollm-135m").reduced(num_layers=1, d_model=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedContinuousEngine(cfg, num_blocks=8, max_len=32, max_gen=8)


def test_launcher_and_model_without_device_raise(no_cuda):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_paged_engine_backend
    from repro_torch.models import model as M
    cfg = get_config("smollm-135m").reduced(num_layers=1, d_model=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_paged_engine_backend("smollm-135m", 1.0, 1.0, "magnus-paged")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_paged_cache(cfg, 8, 4)


def test_dense_entry_points_without_device_raise(no_cuda):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_engine_backend
    from repro_torch.models import model as M
    from repro_torch.serving.engine import BatchEngine, ContinuousEngine
    cfg = get_config("smollm-135m").reduced(num_layers=1, d_model=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_engine_backend("smollm-135m", 1.0, 1.0, "magnus")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousEngine(cfg, slots=1, max_len=8, max_gen=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_cache(cfg, 1, 8)
    ssm = get_config("mamba2-780m").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_engine_backend("mamba2-780m", 1.0, 1.0, "magnus")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchEngine(ssm)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_cache(ssm, 1, 8)
    whisper = get_config("whisper-large-v3").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_engine_backend("whisper-large-v3", 1.0, 1.0, "magnus")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchEngine(whisper)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_cache(whisper, 1, 8)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    from repro_torch.kernels.decode_attention import ops
    ops.reset_counts()
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 16, generator=g)
    kp = torch.randn(5, 4, 2, 16, generator=g)
    vp = torch.randn(5, 4, 2, 16, generator=g)
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lens = torch.tensor([7, 3], dtype=torch.int32)
    ops.paged_decode_attention(q, kp, vp, tables, lens)
    qs = torch.randn(2, 3, 4, 16, generator=g)
    ks = torch.randn(2, 3, 2, 16, generator=g)
    ops.paged_prefix_prefill_attention(qs, ks, ks, kp, vp, tables, lens,
                                       torch.tensor([3, 2]))
    assert ops.paged_decode_attention.launches == 0
    assert ops.paged_prefix_prefill_attention.launches == 0
    assert ops.paged_decode_attention.plain_calls == 1
    assert ops.paged_prefix_prefill_attention.plain_calls == 1


def test_kernel_wrappers_refuse_cpu_tensors():
    """The ctypes launchers take CUDA tensors only: a CPU tensor is an
    error, never a silent plain-version call."""
    from repro_torch.kernels.decode_attention import kernel
    q = torch.zeros(1, 2, 16)
    kp = torch.zeros(2, 4, 2, 16)
    tables = torch.zeros(1, 1, dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.paged_decode_attention_kernel(q, kp, kp, tables, lens)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.decode_attention_kernel(q, kp[:1], kp[:1], lens)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.decode_attention_int8_kernel(
            q, kp[:1].to(torch.int8), kp[:1].to(torch.int8),
            kp[:1, :, :, 0].to(torch.bfloat16),
            kp[:1, :, :, 0].to(torch.bfloat16), lens)


def test_flash_kernel_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.flash_attention import kernel, ops
    q = torch.zeros(1, 4, 2, 32)   # a head size the kernels have
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.flash_attention_kernel(q, q, q)
    ops.reset_counts()
    ops.flash_attention(q, q, q)
    assert (ops.flash_attention.launches, ops.flash_attention.plain_calls) \
        == (0, 1)
