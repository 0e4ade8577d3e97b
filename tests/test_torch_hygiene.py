"""PyTorch port, hygiene: the port stands alone and never falls back to
the CPU on its own.

* Importing every ``adlm_tpu_torch`` module in a fresh interpreter loads
  no ``jax``, ``flax``, ``optax``, ``adlm_tpu`` or ``PIL`` module (the
  port writes its PNG files and resamples like PIL itself), and
  importing the data modules loads no ``torch`` (the loader's spawned
  workers import them).
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

import numpy as np
import pytest
import torch

import adlm_tpu_torch
from adlm_tpu_torch.core.config import (
    DataConfig,
    ExperimentConfig,
    PPNetConfig,
    TrainConfig,
    UNoiseConfig,
)
from adlm_tpu_torch.data import pipeline
from adlm_tpu_torch.interpret import analysis, evaluate, figures, nearest, prune, push, windowed
from adlm_tpu_torch.models import calibrate
from adlm_tpu_torch.models.ppnet import PPNet
from adlm_tpu_torch.ops import _build
from adlm_tpu_torch.train import classification as cls
from adlm_tpu_torch.train import protoseg, unoise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny convs run op by op.  With a thread pool per op, parallel
    test workers on a busy host wait on each other's threads, and the
    calibration's hundred small forwards take many times longer."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        adlm_tpu_torch.__path__, "adlm_tpu_torch."))


def test_port_imports_nothing_of_jax():
    mods = _port_modules()
    assert "adlm_tpu_torch.interpret.evaluate" in mods
    assert "adlm_tpu_torch.train.protoseg" in mods
    assert "adlm_tpu_torch.interpret.push" in mods
    for m in ("data.constants", "data.dataset", "data.pipeline", "native",
              "models.calibrate", "train.pipeline", "core.checkpoint", "cli",
              "utils.logging", "utils.tensorboard", "utils.profiling",
              "utils.torch_import", "utils.watchdog", "models.unet", "train.unoise",
              "train.unoise_pipeline", "interpret.unoise_vis", "interpret.figures",
              "data.warps", "data.unoise_data", "data.nifti", "data.preprocess",
              "models.backbones", "data.image_folder", "train.classification",
              "train.classification_pipeline", "utils.receptive_field",
              "interpret.windowed"):
        assert f"adlm_tpu_torch.{m}" in mods
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


def test_data_modules_import_no_torch():
    code = (
        "import sys\n"
        "import adlm_tpu_torch.data.pipeline, adlm_tpu_torch.data.dataset\n"
        "import adlm_tpu_torch.data.constants, adlm_tpu_torch.native\n"
        "import adlm_tpu_torch.data.warps, adlm_tpu_torch.data.unoise_data\n"
        "import adlm_tpu_torch.data.nifti, adlm_tpu_torch.data.preprocess\n"
        "import adlm_tpu_torch.data.image_folder\n"
        "print(repr(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'PIL'))))\n")
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


_UNOISE = UNoiseConfig(depth=2, channel_factor=2, util_depth=2, util_channel_factor=2)


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


_CLS = cls.ClassificationConfig(model=PPNetConfig(
    base_architecture="resnet18", img_size=32, num_prototypes=6, prototype_channels=8,
    num_classes=3, add_on_layers_type="regular", patch_classification=False))


def _cls_batches():
    return [(torch.rand(2, 32, 32, 3).numpy(), np.array([0, 2]), 2)]


def _cls_model():
    """A classification PPNet on the CPU (the entry point under test is
    the one that must refuse to run without a device)."""
    return PPNet(_CLS.model)


def _cls_state():
    model = _cls_model()
    return cls.init_classifier_state(model, _CLS, None, device="cpu")


def _cls_train_step(**kw):
    model = _cls_model()
    step = cls.make_cls_train_step(model, _CLS, "joint", **kw)
    state = cls.init_classifier_state(model, _CLS, "joint", device="cpu")
    return lambda: step(state, *_cls_batches()[0][:2])[1]


def _cls_eval_step(**kw):
    model = _cls_model()
    step = cls.make_cls_eval_step(model, _CLS, **kw)
    state = cls.init_classifier_state(model, _CLS, None, device="cpu")
    return lambda: {k: v for k, v in step(state, *_cls_batches()[0][:2]).items()
                    if k != "correct"}


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
    "local_analysis": lambda m, **kw: analysis.local_analysis(
        m, torch.arange(6) // 2, torch.rand(1, 33, 33, 3).numpy(), top_k=2, **kw),
    "make_windowed_inference_fn": lambda m, **kw: windowed.make_windowed_inference_fn(
        m, (33, 33), **kw)(torch.rand(1, 40, 50, 3).numpy()),
    "WindowedSegEvaluator": lambda m, **kw: windowed.WindowedSegEvaluator(
        m, 3, (33, 33), with_stats=True, **kw).update(torch.arange(6) // 2,
                                                      *_images_and_labels(1)[0]),
    "device_prefetch": lambda m, **kw: list(pipeline.device_prefetch(
        iter(_images_and_labels()), **kw)),
    "calibrate_frozen_bn": lambda m, **kw: calibrate.calibrate_frozen_bn(
        m, torch.rand(2, 33, 33, 3).numpy(), max_sweeps=1, **kw),
    "bn_output_moments": lambda m, **kw: calibrate.bn_output_moments(
        m, torch.rand(2, 33, 33, 3).numpy(), **kw),
    "standardize_presigmoid": lambda m, **kw: calibrate.standardize_presigmoid(
        m, torch.rand(2, 33, 33, 3).numpy(), log=lambda *_: None, **kw),
    "init_prototypes_from_data": lambda m, **kw: calibrate.init_prototypes_from_data(
        m, torch.arange(6) // 2, torch.rand(2, 33, 33, 3).numpy(),
        torch.randint(0, 4, (2, 33, 33)).numpy(), log=lambda *_: None, **kw),
    # U-Noise (the PPNet is not theirs; they build their own U-Nets)
    "init_utility_state": lambda m, **kw: unoise.init_utility_state(_UNOISE, **kw),
    "init_noise_state": lambda m, **kw: unoise.init_noise_state(
        _UNOISE, unoise.init_utility_state(_UNOISE, device="cpu").model.state_dict(), **kw),
    # the classifier (its own PPNet, a tiny ResNet-18)
    "build_classifier": lambda m, **kw: cls.build_classifier(_CLS, **kw),
    "init_classifier_state": lambda m, **kw: cls.init_classifier_state(
        _cls_model(), _CLS, "warm", **kw),
    "make_cls_train_step": lambda m, **kw: _cls_train_step(**kw),
    "make_cls_eval_step": lambda m, **kw: _cls_eval_step(**kw),
    "push_classification_prototypes": lambda m, **kw: cls.push_classification_prototypes(
        _cls_state(), _cls_batches(), **kw),
    "find_k_nearest_patches_classification":
        lambda m, **kw: cls.find_k_nearest_patches_classification(
            _cls_state(), _cls_batches(), k=1, **kw),
    "prune_classification_prototypes": lambda m, **kw: cls.prune_classification_prototypes(
        _cls_state(), _cls_batches(), k=1, prune_threshold=0, log=lambda *_: None, **kw),
    "device_threshold_sweep": lambda m, **kw: figures.device_threshold_sweep(
        figures.make_predict(unoise.build_unet(2, 2, torch.device("cpu"))),
        np.random.RandomState(0).rand(2, 8, 8, 1), np.random.RandomState(1).rand(2, 8, 8, 3),
        np.ones((2, 8, 8, 1), np.float32), batch_size=2, **kw),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_without_device_raise_on_a_host_without_cuda(
        no_cuda, entry):
    model = _tiny_model()
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[entry](model)
    # asked for explicitly, the CPU runs the plain versions
    out = ENTRY_POINTS[entry](model, device="cpu")
    if entry in ("make_train_step", "make_eval_step", "make_cls_train_step",
                 "make_cls_eval_step"):
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


# the host C++ functions U-Noise's warps call (native/augment.cc)
_NATIVE = ("remap_bilinear_f32", "remap_nearest_f32", "gaussian_blur_f32")


def _check_native_signature(fn):
    """``native._bind`` declares ``fn`` as augment.cc defines it: each
    ``float*`` an f32 ndpointer, each ``int`` a c_int, each ``float`` a
    c_float, no result."""
    from adlm_tpu_torch import native

    with open(native.SOURCE) as f:
        src = f.read()
    params = re.search(r"void\s+" + fn + r"\(([^)]*)\)", src).group(1)
    fake = _FakeLib()
    native._bind(fake)
    declared = fake.fns[fn]
    assert declared.restype is None
    decls = [p.strip() for p in params.split(",")]
    assert len(declared.argtypes) == len(decls)
    for decl, t in zip(decls, declared.argtypes):
        if "*" in decl:
            assert decl.replace("const", "").split()[0] == "float*", decl
            assert t is np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"), decl
        else:
            assert t is _ctype(decl.rsplit(None, 1)[0]), decl


@pytest.mark.parametrize("name", list(_build.KERNELS) + [f"native.{f}" for f in _NATIVE])
def test_ctypes_signatures_match_the_c_sources(monkeypatch, name):
    """Each wrapper declares every launcher it calls exactly as the C
    source defines it (the kernels themselves run only on the card), and
    the host library's bindings declare U-Noise's functions as
    augment.cc defines them."""
    if name.startswith("native."):
        _check_native_signature(name[len("native."):])
        return
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


# command → argv after ``python -m adlm_tpu_torch.cli`` (a run directory
# named ``run`` under RESULTS_DIR, the tiny experiment below)
_CLI = {
    "train": ["train", "smoke", "run"],
    "eval-valid": ["eval-valid", "{run}", "push", "--stats"],
    "eval-test": ["eval-test", "{run}", "push"],
    "prune": ["prune", "{run}"],
}


@pytest.mark.parametrize("command", list(_CLI))
def test_cli_commands_raise_without_a_card_and_write_nothing(
        no_cuda, tmp_path, monkeypatch, command):
    from adlm_tpu_torch import cli

    results = tmp_path / "results"
    results.mkdir()
    run = results / "run"
    if command != "train":   # an existing run directory, left as it is
        run.mkdir()
        (run / "config.json").write_text("{}")
    before = sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*"))
    monkeypatch.setenv("RESULTS_DIR", str(results))
    argv = [a.format(run=run) for a in _CLI[command]]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)
    assert sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*")) == before
    # with --device cpu the same command gets past the device check
    if command == "train":
        with pytest.raises(FileNotFoundError):   # no dataset at this path
            cli.main(argv + ["--device", "cpu", "--data-path", str(tmp_path / "none")])


def test_run_protoseg_training_raises_without_a_card_and_writes_nothing(no_cuda, tmp_path):
    from adlm_tpu_torch.train.pipeline import run_protoseg_training

    run = tmp_path / "run"
    with pytest.raises(RuntimeError, match="CUDA"):
        run_protoseg_training(_CFG, str(run), data_path=str(tmp_path))
    assert not run.exists()
    with pytest.raises(FileNotFoundError):   # past the device check
        run_protoseg_training(_CFG, str(run), data_path=str(tmp_path), device="cpu")


def test_run_classification_training_raises_without_a_card_and_writes_nothing(
        no_cuda, tmp_path):
    from adlm_tpu_torch.train.classification_pipeline import run_classification_training

    run = tmp_path / "run"
    with pytest.raises(RuntimeError, match="CUDA"):
        run_classification_training(_CLS, str(run), _cls_batches, _cls_batches)
    assert not run.exists()
    state = run_classification_training(_CLS, str(run), _cls_batches, _cls_batches,
                                        num_epochs=1, device="cpu")
    assert state.model.prototypes().device.type == "cpu"


# U-Noise command → argv after ``python -m adlm_tpu_torch.cli`` (slice
# arrays that do not exist, run names under RESULTS_DIR)
_UNOISE_CLI = {
    "unoise-train-util": ["unoise-train-util", "--imgs", "{d}/i.npy", "--masks", "{d}/m.npy",
                          "--run-name", "u"],
    "unoise-train-noise": ["unoise-train-noise", "--imgs", "{d}/i.npy", "--masks",
                           "{d}/m.npy", "--run-name", "n", "--utility-run", "u"],
    "unoise-visualize": ["unoise-visualize", "--imgs", "{d}/i.npy", "--masks", "{d}/m.npy",
                         "--utility-run", "u", "--noise-run", "n"],
    "unoise-figures": ["unoise-figures", "--imgs", "{d}/i.npy", "--masks", "{d}/m.npy",
                       "--utility-run", "u", "--noise-runs", "n"],
    "prepare-unoise": ["prepare-unoise", "{d}/src", "{d}/dst"],
    # the classifier's commands (image folders and checkpoints that do
    # not exist)
    "cls-train": ["cls-train", "c", "--train-dir", "{d}/train", "--test-dir", "{d}/test"],
    "cls-prune": ["cls-prune", "{d}/results/c", "--train-dir", "{d}/train"],
    "import-protopnet": ["import-protopnet", "c", "{d}/model.pth"],
}


@pytest.mark.parametrize("command", list(_UNOISE_CLI))
def test_unoise_commands_raise_without_a_card_and_write_nothing(
        no_cuda, tmp_path, monkeypatch, command):
    from adlm_tpu_torch import cli

    results = tmp_path / "results"
    results.mkdir()
    monkeypatch.setenv("RESULTS_DIR", str(results))
    before = sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*"))
    argv = [a.format(d=tmp_path) for a in _UNOISE_CLI[command]]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)
    assert sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*")) == before
    # with --device cpu the same command gets past the device check
    with pytest.raises(FileNotFoundError):   # no arrays, runs or volumes there
        cli.main(argv + ["--device", "cpu"])
