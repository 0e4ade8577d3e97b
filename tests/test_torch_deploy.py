"""PyTorch port, deployment: exported artifacts against the JAX
package's (``adlm_tpu.deploy.export`` with ``platforms=("cpu",)``).

Both packages export the same weights (numpy seeds through
``state_dict_from_jax``, ``unet_state_dict_from_jax`` and
``cls_state_dict_from_jax``); each artifact is loaded with its
package's ``load_inference_artifact`` and called on the same numpy
batch.  Limits:

* float32 compute: ``grid_logits`` within atol 1e-4; ``pred`` and
  ``nearest_proto`` equal except at near-ties, where the JAX program's
  own scores (upsampled logits, distances) of the two choices lie
  within twice the limit (``assert_same_choice``);
* bfloat16 compute: the same, with ``BF16_REL`` of the largest
  |value| as the limit (two frameworks round bf16 at other places);
* U-Noise: probabilities within ``PROB_ATOL``, the sigmoid's largest
  slope times the U-Net logits' 1e-4 of ``test_torch_unet.py``; the
  mask equal except where the JAX logit is within 1e-4 of 0;
* the classifier: logits and min-distances within rtol/atol 1e-4, the
  activations through the same ``distance_to_similarity``, ``pred``
  under the near-tie rule.

Also: the registered head op on the CPU equals the plain version and
its fake shapes equal its real ones (``torch.library.opcheck`` too);
the exported graph holds the op (so the CUDA artifact launches the
kernel) and the bf16 graph's convolutions are bf16; ``export``,
``cls-export`` and ``unoise-export`` through the port's CLI from run
directories written here; ``cuda`` without a card raises and writes
nothing; ``precompile`` builds once and then reuses (a stand-in
``nvcc``).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adlm_tpu.core.config import PPNetConfig as JaxPPNetConfig
from adlm_tpu.core.config import UNoiseConfig as JaxUNoiseConfig
from adlm_tpu.core.dtypes import tree_cast
from adlm_tpu.deploy import export as jax_export
from adlm_tpu.models.ppnet import PPNet as JaxPPNet
from adlm_tpu.ops.normalize import normalize_in_jit
from adlm_tpu.ops.resize import resize_bilinear as jax_resize
from adlm_tpu.train.unoise import _prep_images as jax_prep_images

from adlm_tpu_torch import cli
from adlm_tpu_torch.core.checkpoint import CheckpointStore
from adlm_tpu_torch.core.config import PPNetConfig, get_experiment
from adlm_tpu_torch.data.image_folder import IMAGENET_MEAN, IMAGENET_STD
from adlm_tpu_torch.deploy import export as port_export
from adlm_tpu_torch.deploy import precompile
from adlm_tpu_torch.models.ppnet import PPNet, default_proto_class
from adlm_tpu_torch.ops import _build
from adlm_tpu_torch.ops import prototype as port_proto
from adlm_tpu_torch.train.classification import ClassificationConfig
from adlm_tpu_torch.train.classification_pipeline import save_cls_config
from adlm_tpu_torch.utils.jax_weights import cls_state_dict_from_jax, unet_state_dict_from_jax

from test_torch_models import TINY, jax_pair
from test_torch_unet import port_unet, random_unet_variables

ATOL = 1e-4
BF16_REL = 2e-2
PROB_ATOL = 0.25 * 1e-4
CLS = dict(rtol=1e-4, atol=1e-4)
P, K = TINY["num_prototypes"], TINY["num_classes"]
B, SEG_HW, UN_HW, CLS_HW = 2, (40, 48), (16, 16), 32
MEAN_STD = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
CLS_MEAN_STD = (IMAGENET_MEAN, IMAGENET_STD)
UN_DEPTH, UN_CF = 2, 3
HEAD = torch.ops.adlm_tpu_torch.prototype_head.default
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# case → (kind, compute dtype, uint8 inputs)
CASES = {
    "seg_uint8": ("seg", "float32", True),
    "seg_f32_inputs": ("seg", "float32", False),
    "seg_bf16": ("seg", "bfloat16", True),
    "unoise_utility": ("utility", "float32", False),
    "unoise_noise": ("noise", "float32", False),
    "cls": ("cls", "float32", True),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cls_cfg(cls):
    return cls(base_architecture="resnet18", img_size=CLS_HW, num_prototypes=6,
               prototype_channels=8, num_classes=3, add_on_layers_type="regular",
               patch_classification=False)


@pytest.fixture(scope="module")
def models():
    """The three model pairs with shared weights: the tiny ProtoSeg PPNet,
    the U-Net, and a ResNet-18 classifier whose variables are
    ``model.init``'s with the BN statistics drawn away from identity."""
    jm, params, constants, tm = jax_pair(seed=31)
    jun, un_params, un_stats = random_unet_variables(UN_DEPTH, UN_CF, seed=5, hw=UN_HW[0])
    jcm = JaxPPNet(cfg=_cls_cfg(JaxPPNetConfig))
    v = jax.jit(lambda k, x: jcm.init(k, x, train=True))(
        jax.random.PRNGKey(2), jnp.zeros((1, CLS_HW, CLS_HW, 3)))
    rng = np.random.RandomState(7)
    cls_params = jax.tree.map(np.asarray, v["params"])
    cls_stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
                             v["batch_stats"])
    tcm = PPNet(_cls_cfg(PPNetConfig))
    tcm.load_state_dict(cls_state_dict_from_jax(cls_params, cls_stats, "resnet18"))
    return {
        "seg": dict(jax=(jm, params, constants), port=tm),
        "unet": dict(jax=(jun, un_params, un_stats),
                     port=port_unet(UN_DEPTH, UN_CF, un_params, un_stats)),
        "cls": dict(jax=(jcm, cls_params, cls_stats), port=tcm.eval()),
    }


def _inputs(case, seed=0):
    kind, _, uint8 = CASES[case]
    rng = np.random.RandomState(seed)
    if kind in ("utility", "noise"):
        return rng.rand(B, *UN_HW, 1).astype(np.float32)
    hw = SEG_HW if kind == "seg" else (CLS_HW, CLS_HW)
    if uint8:
        return rng.randint(0, 256, (B, *hw, 3)).astype(np.uint8)
    return rng.randn(B, *hw, 3).astype(np.float32)


def _export(pkg, case, models, out):
    """Export ``case`` with the JAX package (``pkg="jax"``) or the port."""
    kind, dtype, uint8 = CASES[case]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if kind == "seg":
        jm, params, constants = models["seg"]["jax"]
        norm = MEAN_STD if uint8 else None
        if pkg == "jax":
            return jax_export.export_inference_artifact(
                jm, params, constants, np.asarray(default_proto_class(P, K)), out, B,
                SEG_HW, normalize=norm, platforms=("cpu",), compute_dtype=jdt)
        return port_export.export_inference_artifact(
            models["seg"]["port"], default_proto_class(P, K), out, B, SEG_HW,
            normalize=norm, platforms=("cpu",), compute_dtype=tdt)
    if kind == "cls":
        jcm, params, stats = models["cls"]["jax"]
        if pkg == "jax":
            return jax_export.export_cls_artifact(
                jcm, params, stats, np.arange(6) // 2, out, B, (CLS_HW, CLS_HW),
                normalize=CLS_MEAN_STD, platforms=("cpu",), compute_dtype=jdt)
        return port_export.export_cls_artifact(
            models["cls"]["port"], torch.arange(6) // 2, out, B, (CLS_HW, CLS_HW),
            normalize=CLS_MEAN_STD, platforms=("cpu",), compute_dtype=tdt)
    _, params, stats = models["unet"]["jax"]
    if pkg == "jax":
        cfg = JaxUNoiseConfig(depth=UN_DEPTH, channel_factor=UN_CF, util_depth=UN_DEPTH,
                              util_channel_factor=UN_CF)
        return jax_export.export_unoise_artifact(cfg, params, stats, kind, out, B, UN_HW,
                                                 platforms=("cpu",), compute_dtype=jdt)
    return port_export.export_unoise_artifact(models["unet"]["port"], kind, out, B, UN_HW,
                                              platforms=("cpu",), compute_dtype=tdt)


@pytest.fixture(scope="module")
def jax_runs(models, tmp_path_factory):
    """``run(case)``: the JAX artifact's outputs on ``_inputs(case)`` and
    the JAX program's own scores, each case exported once."""
    root = tmp_path_factory.mktemp("jax_artifacts")
    done = {}

    def run(case):
        if case not in done:
            out = str(root / case)
            manifest = _export("jax", case, models, out)
            call, _ = jax_export.load_inference_artifact(out, "cpu")
            x = _inputs(case)
            got = {k: np.asarray(v) for k, v in call(jnp.asarray(x)).items()}
            done[case] = (got, _jax_scores(case, models, x), manifest)
        return done[case]

    return run


def _jax_scores(case, models, x):
    """What the JAX program chose from: the upsampled logits and the
    distances (ProtoSeg), the logits (U-Noise, classifier)."""
    kind, dtype, uint8 = CASES[case]
    jdt = getattr(jnp, dtype)
    if kind == "seg":
        jm, params, constants = models["seg"]["jax"]
        xi = normalize_in_jit(jnp.asarray(x), MEAN_STD if uint8 else None).astype(jdt)
        logits, d = jax.jit(lambda p, c, a: jm.apply(
            {"params": p, "constants": c}, a, train=False, return_distances=True))(
                tree_cast(params, jdt), constants, xi)
        return {"pred": np.asarray(jax_resize(logits.astype(jnp.float32), SEG_HW)),
                "nearest_proto": -np.asarray(d, np.float32)}
    if kind == "cls":
        jcm, params, stats = models["cls"]["jax"]
        xi = normalize_in_jit(jnp.asarray(x), CLS_MEAN_STD)
        logits, _ = jcm.apply({"params": params, "batch_stats": stats}, xi, train=False)
        return {"pred": np.asarray(logits)}
    jun, params, stats = models["unet"]["jax"]
    logits = jun.apply({"params": params, "batch_stats": stats},
                       jax_prep_images(jnp.asarray(x), True, False), train=False)
    return {"logits": np.asarray(logits)}


def assert_same_choice(got, want, scores, tol):
    """``got`` and ``want`` (int maps) agree, except where the JAX
    scores of the two choices lie within ``tol`` of each other."""
    differ = got != want
    if not differ.any():
        return
    s_want = np.take_along_axis(scores, want[..., None].astype(np.int64), -1)[..., 0]
    s_got = np.take_along_axis(scores, got[..., None].astype(np.int64), -1)[..., 0]
    margin = np.abs(s_want - s_got)[differ]
    assert margin.max() <= tol, (int(differ.sum()), float(margin.max()))


def assert_matches_jax(case, got, want, scores):
    kind, dtype, _ = CASES[case]
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    if kind == "seg":
        tol = ATOL if dtype == "float32" else BF16_REL * np.abs(want["grid_logits"]).max()
        np.testing.assert_allclose(got["grid_logits"], want["grid_logits"], rtol=0, atol=tol)
        assert_same_choice(got["pred"], want["pred"], scores["pred"], 2 * tol)
        d_tol = (ATOL if dtype == "float32"
                 else BF16_REL * np.abs(scores["nearest_proto"]).max())
        assert_same_choice(got["nearest_proto"], want["nearest_proto"],
                           scores["nearest_proto"], 2 * d_tol)
    elif kind == "cls":
        for k in ("logits", "min_distances", "proto_activation"):
            np.testing.assert_allclose(got[k], want[k], **CLS)
        assert_same_choice(got["pred"], want["pred"], scores["pred"], 2 * CLS["atol"])
    else:
        prob = "mask_prob" if kind == "utility" else "importance"
        np.testing.assert_allclose(got[prob], want[prob], rtol=0, atol=PROB_ATOL)
        if kind == "utility":
            differ = got["mask"] != want["mask"]
            assert (np.abs(scores["logits"][differ]) <= ATOL).all()


def _port_outputs(out, x):
    call, manifest = port_export.load_inference_artifact(out, "cpu")
    return {k: v.numpy() for k, v in call(x).items()}, manifest


@pytest.mark.parametrize("case", sorted(CASES))
def test_artifact_matches_jax(case, models, jax_runs, tmp_path):
    want, scores, jax_manifest = jax_runs(case)
    out = str(tmp_path / "port")
    manifest = _export("port", case, models, out)
    assert os.path.exists(os.path.join(out, "inference_cpu.pt2"))
    got, loaded = _port_outputs(out, _inputs(case))
    assert loaded == json.loads(json.dumps(manifest))
    assert manifest["torch_version"] == torch.__version__
    assert set(manifest) == set(jax_manifest) - {"jax_version"} | {"torch_version"}
    for key in set(manifest) - {"torch_version"}:
        assert manifest[key] == jax_manifest[key], key
    assert_matches_jax(case, got, want, scores)


def test_artifact_runs_in_a_process_that_imports_the_ops_alone(models, tmp_path):
    """A fresh interpreter loads the artifact through ``deploy.export``,
    which imports ``adlm_tpu_torch.ops`` (the head's operator) and no
    model code, and gets the same outputs bit for bit."""
    out, x_path, got_path = (str(tmp_path / n) for n in ("a", "x.npy", "got.npz"))
    _export("port", "seg_uint8", models, out)
    x = _inputs("seg_uint8")
    np.save(x_path, x)
    code = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from adlm_tpu_torch.deploy.export import load_inference_artifact\n"
        f"call, _ = load_inference_artifact({out!r}, 'cpu')\n"
        f"got = call(np.load({x_path!r}))\n"
        f"np.savez({got_path!r}, **{{k: v.numpy() for k, v in got.items()}})\n"
        "print(sorted({m.split('.')[1] for m in sys.modules\n"
        "              if m.startswith('adlm_tpu_torch.')}))\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == "['core', 'deploy', 'ops']"
    want, _ = _port_outputs(out, x)
    got = dict(np.load(got_path))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _graph(out):
    return torch.export.load(os.path.join(out, "inference_cpu.pt2")).graph


def test_exported_graphs_hold_the_head_op_and_bf16_convs(models, tmp_path):
    convs = (torch.ops.aten.conv2d.default, torch.ops.aten.convolution.default)
    for case, want_logits in (("seg_uint8", True), ("seg_bf16", True), ("cls", False)):
        out = str(tmp_path / case)
        _export("port", case, models, out)
        graph = _graph(out)
        heads = [n for n in graph.nodes if n.target == HEAD]
        assert len(heads) == 1, case
        assert heads[0].args[6] is want_logits  # return_logits
        dtypes = {n.meta["val"].dtype for n in graph.nodes if n.target in convs}
        want = torch.bfloat16 if case.endswith("bf16") else torch.float32
        assert dtypes == {want}, (case, dtypes)


@pytest.mark.parametrize("request_", [(True, True), (False, True), (True, False)],
                         ids=["logits_and_d", "logits", "d_only"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_op_on_cpu_is_the_plain_version(request_, dtype):
    with_d, with_logits = request_
    rng = np.random.RandomState(3)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(rng.rand(2, 5, 7, 16).astype(np.float32)).to(tdt)
    p = torch.from_numpy(rng.rand(12, 16).astype(np.float32)).to(tdt)
    w = torch.from_numpy(rng.randn(12, 4).astype(np.float32))
    logits, d = HEAD(x, p, w, "log", 1e-4, with_d, with_logits)
    want_logits, want_d = port_proto.prototype_head_reference(x, p, w, "log", 1e-4)
    if with_logits:
        assert torch.equal(logits, want_logits)
    else:
        assert logits.shape == (0,)
        assert torch.equal(d, port_proto.l2_distances(x, p))
    if with_d:
        assert torch.equal(d, want_d)
    else:
        assert d.shape == (0,)
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode() as mode:
        fake = HEAD(*(mode.from_tensor(t) for t in (x, p, w)), "log", 1e-4, with_d,
                    with_logits)
    for f, real in zip(fake, (logits, d)):
        assert f.shape == real.shape and f.dtype == real.dtype == torch.float32
    torch.library.opcheck(HEAD, (x, p, w.requires_grad_(), "log", 1e-4, with_d,
                                 with_logits))


def test_export_asks_for_the_card(models, tmp_path):
    """``cuda`` without a card raises before anything is written, and
    loading defaults to the card."""
    out = str(tmp_path / "a")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_export.export_inference_artifact(
            models["seg"]["port"], default_proto_class(P, K), out, 1, SEG_HW,
            platforms=("cpu", "cuda"))
    assert not os.path.exists(out)
    with pytest.raises(ValueError, match="platforms"):
        port_export.export_inference_artifact(
            models["seg"]["port"], default_proto_class(P, K), out, 1, SEG_HW,
            platforms=("tpu",))
    port_export.export_unoise_artifact(models["unet"]["port"], "noise", out, 1, UN_HW,
                                       platforms=("cpu",))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_export.load_inference_artifact(out)


def _seg_run(models, root):
    cfg = dataclasses.replace(get_experiment("smoke"), model=models["seg"]["port"].cfg)
    store = CheckpointStore(root)
    store.save_config(cfg.to_json())
    store.save("push", "last", {"state_dict": models["seg"]["port"].state_dict(),
                                "proto_class": default_proto_class(P, K), "step": 0})


def _cls_run(models, root):
    save_cls_config(root, ClassificationConfig(model=_cls_cfg(PPNetConfig)))
    CheckpointStore(root).save("push", "best", {
        "state_dict": models["cls"]["port"].state_dict(),
        "proto_class": torch.arange(6) // 2, "step": 0})


def _unoise_run(models, root):
    _, params, stats = models["unet"]["jax"]
    store = CheckpointStore(root)
    for kind in ("utility", "noise"):
        store.save(kind, "best", {"state_dict": unet_state_dict_from_jax(params, stats),
                                  "step": 0})
        store.save_metadata(f"{kind}_config", {"depth": UN_DEPTH, "channel_factor": UN_CF})


# CLI case → (JAX case it equals, run writer, argv after the run dir, artifact dir)
CLI = {
    "export": ("seg_uint8", _seg_run, ["push", "--batch", str(B), "--size", "40,48"],
               f"push_{B}x40x48"),
    "cls-export": ("cls", _cls_run, ["push", "--batch", str(B)], f"push_{B}x32x32"),
    "unoise-export": ("unoise_noise", _unoise_run,
                      ["--model", "noise", "--batch", str(B), "--size", "16,16"],
                      f"noise_{B}x16x16"),
}


@pytest.mark.parametrize("command", sorted(CLI))
def test_cli_export_commands(command, models, jax_runs, tmp_path, capsys):
    case, write_run, argv, name = CLI[command]
    run = str(tmp_path / "run")
    write_run(models, run)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([command, run, *argv, "--f32-compute", "--out", str(tmp_path / "card")])
    assert not os.path.exists(tmp_path / "card")
    cli.main([command, run, *argv, "--platforms", "cpu", "--f32-compute"])
    assert "exported" in capsys.readouterr().out
    out = os.path.join(run, "export", name)
    want, scores, _ = jax_runs(case)
    got, manifest = _port_outputs(out, _inputs(case))
    assert manifest["platforms"] == ["cpu"] and manifest["compute_dtype"] == "float32"
    if command == "export":
        assert manifest["class_names"] is not None
    assert_matches_jax(case, got, want, scores)


def test_precompile_builds_then_reuses(tmp_path, monkeypatch):
    """A stand-in ``nvcc`` writes each library: the first call builds
    both, the second reuses them by their hashed names."""
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'wb').write(b'lib')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    names = _build.KERNELS
    logs = []
    first, _ = precompile.precompile_kernels(log=logs.append)
    assert first == dict.fromkeys(names, True)
    libs = sorted(os.listdir(tmp_path / "build"))
    assert [f.split("-")[0] for f in libs] == ["libprototype_head", "libupsample_argmin"]
    stamps = [os.stat(tmp_path / "build" / f).st_mtime_ns for f in libs]
    second, _ = precompile.precompile_kernels(log=logs.append)
    assert second == dict.fromkeys(names, False)
    assert sorted(os.listdir(tmp_path / "build")) == libs
    assert [os.stat(tmp_path / "build" / f).st_mtime_ns for f in libs] == stamps
    assert sum("reused" in line for line in logs) == 2


def test_precompile_cli_needs_the_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["precompile", "smoke"])
    with pytest.raises(KeyError):
        cli.main(["precompile", "no_such_experiment"])
