"""PyTorch port, hygiene: the port stands alone and never falls back to
the CPU on its own.

* Importing every ``adlm_tpu_torch`` module in a fresh interpreter loads
  no ``jax``, ``flax``, ``optax``, ``adlm_tpu`` or ``PIL`` module (the
  port writes its PNG files itself).
* The entry points, built without a ``device`` on a host without CUDA,
  raise instead of running on the CPU.
* The kernel sources the build compiles are in the package, and each
  wrapper declares the ``ctypes`` signatures of its launchers as the C
  source defines them.
"""

import ctypes
import importlib
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import adlm_tpu_torch
from adlm_tpu_torch.core.config import DataConfig, ExperimentConfig, PPNetConfig, TrainConfig
from adlm_tpu_torch.interpret import analysis, evaluate, nearest, prune, push
from adlm_tpu_torch.models.ppnet import PPNet
from adlm_tpu_torch.ops import _build
from adlm_tpu_torch.train import protoseg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        adlm_tpu_torch.__path__, "adlm_tpu_torch."))


def test_port_imports_nothing_of_jax():
    mods = _port_modules()
    assert "adlm_tpu_torch.interpret.evaluate" in mods
    assert "adlm_tpu_torch.train.protoseg" in mods
    assert "adlm_tpu_torch.interpret.push" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'adlm_tpu', 'PIL'))\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


_TINY = PPNetConfig(num_prototypes=6, num_classes=3, prototype_channels=8,
                    deeplab_n_features=8, deeplab_n_blocks=(1, 1, 1, 1))
_CFG = ExperimentConfig(name="tiny", model=_TINY,
                        data=DataConfig(window_size=(33, 33)),
                        train=TrainConfig(iter_size=1))


def _tiny_model():
    return PPNet(_TINY)


def _train_step(model, **kw):
    step = protoseg.make_train_step(model, _CFG, 1, 10, **kw)
    state = protoseg.init_protoseg_state(model, _CFG, 1, 10, device="cpu")
    return lambda: step(state, torch.rand(1, 1, 33, 33, 3),
                        torch.randint(0, 4, (1, 1, 33, 33)))[1]


def _images_and_labels(n=2):
    return [(torch.rand(1, 33, 33, 3).numpy(),
             torch.randint(0, 4, (1, 33, 33)).numpy()) for _ in range(n)]


def _push(model, **kw):
    return push.push_prototypes(model, torch.arange(6) // 2, _images_and_labels(), 3,
                                log=lambda *_: None, **kw)


def _eval_step(model, **kw):
    step = protoseg.make_eval_step(model, _CFG, **kw)
    state = protoseg.init_protoseg_state(model, _CFG, 1, 10, device="cpu")
    return lambda: step(state, torch.rand(2, 33, 33, 3),
                        torch.randint(0, 4, (2, 33, 33)), 1)


# entry point → factory(model, **device kw); a factory that returns a
# callable is also run, to show the CPU path works end to end
ENTRY_POINTS = {
    "make_inference_fn": lambda m, **kw: evaluate.make_inference_fn(m, 3, **kw),
    "SegEvaluator": lambda m, **kw: evaluate.SegEvaluator(m, 3, **kw),
    "make_overlay_fn": lambda m, **kw: evaluate.make_overlay_fn(m, **kw),
    "init_protoseg_state": lambda m, **kw: protoseg.init_protoseg_state(
        m, _CFG, 1, 10, **kw),
    "make_train_step": _train_step,
    "make_eval_step": _eval_step,
    "push_prototypes": _push,
    "find_k_nearest_patches": lambda m, **kw: nearest.find_k_nearest_patches(
        m, torch.arange(6) // 2, _images_and_labels(), 3, k=2, **kw),
    "prune_by_purity": lambda m, **kw: prune.prune_by_purity(
        m, torch.arange(6) // 2, _images_and_labels(), 3, k=2, prune_threshold=0,
        log=lambda *_: None, **kw),
    "global_analysis": lambda m, **kw: analysis.global_analysis(
        m, torch.arange(6) // 2, _images_and_labels(), 3, k=2, **kw),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_without_device_raise_on_a_host_without_cuda(
        no_cuda, entry):
    model = _tiny_model()
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[entry](model)
    # asked for explicitly, the CPU runs the plain versions
    out = ENTRY_POINTS[entry](model, device="cpu")
    if entry in ("make_train_step", "make_eval_step"):
        metrics = out()
        assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    assert all(p.device.type == "cpu" for p in model.parameters())


def test_kernel_build_needs_the_card(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        _build.load("prototype_head")


def test_every_kernel_has_its_source_and_a_launch_count():
    for name in _build.KERNELS:
        assert os.path.exists(os.path.join(_build.CSRC, f"{name}.cu"))
    _build.LAUNCHES["prototype_head"] += 3
    _build.reset_launches()
    assert set(_build.LAUNCHES.values()) == {0}


# C type of an extern "C" parameter or result → the ctypes type a
# wrapper must declare (undeclared, ctypes passes a 32-bit int and cuts
# a pointer, and refuses a float)
def _ctype(decl: str):
    decl = re.sub(r"\bconst\b", "", decl).strip()
    if "*" in decl:
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
            "float": ctypes.c_float, "size_t": ctypes.c_size_t}[decl.split()[0]]


def _c_signatures(name):
    """{function: (result ctype, [parameter ctypes])} of the extern "C"
    launchers in csrc/<name>.cu."""
    with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
        src = f.read()
    body = src[src.index('extern "C" {'):]
    sigs = {}
    for ret, fn, params in re.findall(
            r"^(int|size_t)\s+(adlm_\w+)\(([^)]*)\)\s*\{", body, re.M):
        types = [_ctype(p.rsplit(None, 1)[0] + ("*" if "*" in p else ""))
                 for p in params.split(",") if p.strip()]
        sigs[fn] = (_ctype(ret), types)
    return sigs


class _FakeFn:
    def __init__(self):
        self.argtypes = None
        self.restype = ctypes.c_int  # ctypes' default


class _FakeLib:
    def __init__(self):
        self.fns = {}

    def __getattr__(self, fn):
        return self.fns.setdefault(fn, _FakeFn())


@pytest.mark.parametrize("name", _build.KERNELS)
def test_ctypes_signatures_match_the_c_sources(monkeypatch, name):
    """Each wrapper declares every launcher it calls exactly as the C
    source defines it (the kernels themselves run only on the card)."""
    module = importlib.import_module(
        {"prototype_head": "adlm_tpu_torch.ops.prototype",
         "upsample_argmin": "adlm_tpu_torch.ops.upsample_argmin"}[name])
    fake = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda n: fake)
    module._lib()
    sigs = _c_signatures(name)
    assert f"adlm_{name}" in fake.fns
    declared = {fn: f for fn, f in fake.fns.items() if sigs[fn][1]}
    assert f"adlm_{name}" in declared
    for fn, f in declared.items():
        assert f.restype is sigs[fn][0], fn
        assert f.argtypes == sigs[fn][1], fn
    module._lib()  # a second use keeps the declarations
    assert all(f.argtypes == sigs[fn][1] for fn, f in declared.items())
