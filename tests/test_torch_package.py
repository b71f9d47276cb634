"""Structural rules of the PyTorch port, checked on the CPU.

* No module of ``src/repro_torch``, and neither ``chip_smoke.py`` nor
  the port's ``scripts/torch_*.py``, imports ``jax``, the JAX package
  ``repro`` or its ``benchmarks`` (checked on the source, so a lazy
  import inside a function counts too).
* Entry points resolve ``device=None`` to CUDA and raise without one.
* A tensor that is not on the CPU goes to the kernel or raises: with the
  kernel loader made to fail, the error propagates and no plain version
  runs.
"""

import ast
import ctypes
import pathlib

import pytest
import torch

from repro_torch.core import device as tdevice
from repro_torch.cv import classify as tclassify
from repro_torch.cv import gbdt as tgbdt_cv
from repro_torch.cv import pipeline as tpipeline
from repro_torch.cv.config import PipelineConfig
from repro_torch.kernels import _build, counters
from repro_torch.kernels import attention as tattn
from repro_torch.kernels import bow as tbow
from repro_torch.kernels import gbdt as tgbdt
from repro_torch.kernels import stencil as tstencil
from repro_torch.kernels import unfused as tunfused

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (
    sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    + [ROOT / "chip_smoke.py"]
    + sorted((ROOT / "scripts").glob("torch_*.py"))
)


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            roots |= {a.value.split(".")[0] for a in node.args[:1] if isinstance(a, ast.Constant)}
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_repro(path):
    assert path.exists()
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "benchmarks"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def _c_launchers() -> dict:
    """extern "C" launcher name -> ctypes kind of each parameter, parsed from csrc."""
    import re

    out = {}
    for src in _build.CSRC.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            kinds = []
            for p in filter(None, (q.strip() for q in params.split(","))):
                kinds.append(ctypes.c_void_p if "*" in p else ctypes.c_int)
            out[name] = kinds
    return out


def test_ctypes_signatures_match_the_c_launchers():
    """ctypes passes an int where no argtype says c_void_p, cutting a
    pointer to 32 bits; the arity and kind of every argument must match."""
    from repro_torch.kernels import bow as kbow
    from repro_torch.kernels.stencil import exec_window

    c = _c_launchers()
    assert c["stencil_chain_launch"] == exec_window.LAUNCH_ARGTYPES
    from repro_torch.kernels.stencil import exec_streaming

    assert c["stencil_stream_launch"] == exec_streaming.LAUNCH_ARGTYPES
    from repro_torch.kernels import gbdt as kgbdt
    from repro_torch.kernels import unfused as kunfused

    for name, argtypes in {**kbow.LAUNCH_ARGTYPES, **kgbdt.LAUNCH_ARGTYPES,
                           **kunfused.LAUNCH_ARGTYPES}.items():
        assert c[name] == argtypes, name
    # gbdt_score: the model's pointers, B, F, T, depth, C and the stream;
    # no shared-memory budget or thread count (the kernel stages nothing)
    assert kgbdt.LAUNCH_ARGTYPES["gbdt_score_launch"] == (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    from repro_torch.kernels import attention as kattn

    assert c["flash_attn_launch"] == kattn.LAUNCH_ARGTYPES


def test_every_kernel_has_a_source_and_a_counter():
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == {
        "stencil_chain",
        "stencil_stream",
        "bow",
        "gbdt",
        "flash_attn",
        "unfused",
    }
    assert set(counters.LAUNCHES) == set(counters.PLAIN_CALLS) == set(counters.KERNELS)


def test_device_none_means_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert tdevice.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tdevice.resolve_device(None)
    model = tpipeline.BowSvmModel(torch.zeros((4, 128)), torch.zeros((10, 4)), torch.zeros(10), 10)
    imgs = torch.zeros((2, 32, 32, 3), dtype=torch.uint8)
    for call in (
        lambda: tpipeline.predict(model, imgs),
        lambda: tpipeline.extract_features(imgs),
        lambda: tpipeline.accuracy(model, imgs, torch.zeros(2)),
        lambda: tpipeline.train(imgs, torch.zeros(2)),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert tdevice.resolve_device("cpu").type == "cpu"


def test_train_on_cuda_names_the_roadmap_item(monkeypatch):
    """Training on the card reaches the `bow_assign` kernel: with the loader
    made to fail, the error propagates from k-means and no plain version
    runs (the meta device stands in for the card)."""
    from repro_torch.cv import bow as tbow_cv
    from repro_torch.kernels import bow as kbow

    meta = torch.device("meta")
    feats = {"desc": torch.zeros((2, 4, 8), device=meta), "valid": torch.ones((2, 4), device=meta)}
    monkeypatch.setattr(tpipeline, "resolve_device", lambda device: meta)
    monkeypatch.setattr(tpipeline, "extract_features", lambda *a, **k: feats)
    monkeypatch.setattr(tbow_cv, "_init_indices", lambda w, k, g: torch.arange(k, device=w.device))
    monkeypatch.setattr(_build, "library", _boom)
    kbow._launchers.cache_clear()
    counters.reset()
    with pytest.raises(RuntimeError, match="loader failed for bow"):
        tpipeline.train(torch.zeros((2, 32, 32, 3)), torch.zeros(2), dict_size=3)
    assert sum(counters.PLAIN_CALLS.values()) == 0 and sum(counters.LAUNCHES.values()) == 0


def _boom(name):
    raise RuntimeError(f"loader failed for {name}")


class _CardTensor(torch.Tensor):
    """A meta tensor that reports a CUDA device: the card's stand-in for a
    wrapper whose meta tensors take a route of their own (`flash_attention`
    shapes its output there for the dry run)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _meta_calls():
    """Kernel wrappers fed tensors that are not on the CPU (the meta device
    stands in for the card here; `_CardTensor` where meta has its route)."""
    meta = torch.device("meta")
    chain = (tstencil.gaussian_stage(5), tstencil.erode_stage(1), tstencil.grad_stage())

    def plane():
        return torch.zeros((8, 8), dtype=torch.uint8, device=meta)

    return {
        "stencil_chain": lambda: tstencil.fused_chain(
            torch.zeros((2, 8, 8, 3), device=meta), chain, mode="window"
        ),
        "stencil_stream": lambda: tstencil.fused_chain(
            torch.zeros((2, 8, 8, 3), device=meta), chain
        ),
        "bow_quantize_hist": lambda: tbow.bow_quantize_hist(
            torch.zeros((2, 4, 8), device=meta),
            torch.ones((2, 4), device=meta),
            torch.zeros((3, 8), device=meta),
        ),
        "linear_score": lambda: tbow.linear_score(
            torch.zeros((2, 3), device=meta),
            torch.zeros((4, 3), device=meta),
            torch.zeros(4, device=meta),
        ),
        "bow_assign": lambda: tbow.bow_assign(
            torch.zeros((2, 4, 8), device=meta), torch.zeros((3, 8), device=meta)
        ),
        "gbdt_score": lambda: tgbdt.gbdt_score(
            torch.zeros((2, 5), device=meta),
            torch.zeros((3, 2), dtype=torch.int32, device=meta),
            torch.zeros((3, 2), device=meta),
            torch.zeros((3, 4, 6), device=meta),
            torch.zeros(6, device=meta),
        ),
        "flash_attention": lambda: tattn.flash_attention(
            *(torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16, device=meta)
              .as_subclass(_CardTensor),) * 3
        ),
        "seed_gaussian_blur": lambda: tunfused.seed_gaussian_blur_2d(plane(), 5),
        "seed_erode": lambda: tunfused.seed_erode_2d(plane(), 1),
        "seed_threshold": lambda: tunfused.seed_threshold_2d(plane(), 100.0),
    }


@pytest.mark.parametrize("kernel", counters.KERNELS)
def test_kernel_dispatch_propagates_loader_failure(kernel, monkeypatch):
    from repro_torch.kernels import bow as kbow
    from repro_torch.kernels.stencil import exec_streaming, exec_window

    monkeypatch.setattr(_build, "library", _boom)
    kbow._launchers.cache_clear()
    tgbdt._launcher.cache_clear()
    tattn._launcher.cache_clear()
    exec_window._launcher.cache_clear()
    exec_streaming._launcher.cache_clear()
    tunfused._launchers.cache_clear()
    counters.reset()
    with pytest.raises(RuntimeError, match="loader failed"):
        _meta_calls()[kernel]()
    assert counters.snapshot() == {
        "launches": dict.fromkeys(counters.KERNELS, 0),
        "plain_calls": dict.fromkeys(counters.KERNELS, 0),
        "backward_calls": {"flash_attention": 0},
    }


def test_kernel_dispatch_without_nvcc_raises(monkeypatch, tmp_path):
    """Without the loader patched, a non-CPU tensor tries to build the
    kernels, and a machine with no nvcc says so before it writes anything."""
    from repro_torch.kernels.stencil import exec_window

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "kernels")
    exec_window._launcher.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        _meta_calls()["stencil_chain"]()
    assert not (tmp_path / "kernels").exists()


def test_classify_plan_modes_and_heads():
    model = tpipeline.BowSvmModel(torch.eye(4, 8), torch.ones((3, 4)), torch.zeros(3), 3)
    plan = tclassify.build_plan(model, PipelineConfig(classify_mode="ref"))
    descs = torch.eye(4, 8)[None].repeat(2, 1, 1)
    valids = torch.ones((2, 4), dtype=torch.bool)
    counters.reset()
    out = plan(descs, valids)
    assert out["hist"].shape == (2, 4) and out["label"].shape == (2,)
    assert torch.allclose(out["hist"].sum(1), torch.ones(2))
    assert counters.PLAIN_CALLS["bow_quantize_hist"] == 1
    with pytest.raises(ValueError):
        plan.histograms(descs, valids, mode="bogus")
    gbdt = tgbdt_cv.GbdtModel(
        torch.tensor([[0, 1], [2, 3]]), torch.full((2, 2), 0.1), torch.ones((2, 4, 3)),
        torch.zeros(3), 3,
    )
    gmodel = tpipeline.BowGbdtModel(torch.eye(4, 8), gbdt, 3)
    gplan = tclassify.build_plan(gmodel, PipelineConfig(classify_mode="ref"))
    assert gplan.head == "gbdt" and gplan.gbdt.feat.dtype == torch.int32
    counters.reset()
    gout = gplan(descs, valids)
    assert gout["scores"].shape == (2, 3) and gout["label"].shape == (2,)
    assert torch.equal(gplan.leaf_indices(gout["hist"]), torch.full((2, 2), 3, dtype=torch.int32))
    assert counters.PLAIN_CALLS["gbdt_score"] == 0  # ref mode: the staged oracle
    with pytest.raises(ValueError):
        plan.leaf_indices(out["hist"])


@pytest.mark.parametrize("bad", [{"smem_budget": 300_000}, {"threads": 96}, {"threads": 16}])
def test_launch_config_validation(bad):
    with pytest.raises(ValueError):
        tdevice.LaunchConfig(**bad)


@pytest.mark.parametrize(
    "imgs",
    [
        torch.zeros((4, 4)),
        torch.zeros((1, 4, 4), dtype=torch.int32),
        torch.full((1, 4, 4), float("nan")),
    ],
)
def test_validate_images_rejects_garbage(imgs):
    with pytest.raises(ValueError):
        tpipeline.validate_images(imgs)
