"""PyTorch port, the classifier's stems: ``adlm_tpu_torch.models.backbones``
and the classification PPNet against ``adlm_tpu.models.backbones`` and
``adlm_tpu.models.ppnet``, the weight converters and the importers.

Both packages get the same weights: random flax trees (numpy seed, BN
statistics away from identity) go through ``cls_state_dict_from_jax``
into the port, which loads them with ``strict=True`` (so the add-on
stack has the JAX package's input width for every family).
Tolerances (f32; XLA's CPU convs against PyTorch's, sums in other
orders through up to 121 layers):

* logits and min-distances in eval mode: rtol ``RTOL`` = 1e-4, atol
  ``ATOL`` = 1e-4 (logits of order 1–5, distances up to C = 16);
* the same in train mode: rtol ``TRAIN_RTOL`` = 2e-3.  A ResNet's last
  stage is 1x1 at 32x32, so its train-mode BNs normalize over the batch's
  8 values per channel, where ``E[x²] − E[x]²`` cancels: at resnet50 the
  stem's output reads 1.6e-3 (the port) and 5.3e-3 (the JAX package)
  of an f64 forward's (resnet18 at batch 4 of 64x64: 1e-5);
* post-forward running statistics: rtol 1e-4, atol 1e-4 (they take a
  tenth of the batch statistic, whose inputs carry the train-mode error
  above: the batch statistics agree within 1e-3);
* ``conv_info``, ``backbone_out_channels``, the RF info and boxes, the
  converter round trip through the JAX package's own importer
  (``load_protopnet_cls``) and ``load_classification_backbone``: exact.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adlm_tpu.core.config import PPNetConfig as JaxPPNetConfig
from adlm_tpu.models import backbones as jbackbones
from adlm_tpu.models.ppnet import PPNet as JaxPPNet
from adlm_tpu.utils import receptive_field as jrf
from adlm_tpu.utils import torch_import as jimport

from adlm_tpu_torch.core.config import PPNetConfig
from adlm_tpu_torch.models import backbones
from adlm_tpu_torch.models.ppnet import PPNet, add_on_in_channels
from adlm_tpu_torch.utils import receptive_field as rf
from adlm_tpu_torch.utils.jax_weights import cls_state_dict_from_jax
from adlm_tpu_torch.utils.torch_import import load_classification_backbone, load_protopnet_cls

RTOL, ATOL = 1e-4, 1e-4
TRAIN_RTOL = 2e-3
STATS = dict(rtol=1e-4, atol=1e-4)
HW, B = 32, 8
FAMILIES = ("resnet18", "resnet50", "vgg11", "vgg11_bn", "densenet121")
ALL_ARCHS = (tuple(jbackbones._RESNET_SPECS) + tuple(jbackbones._DENSENET_SPECS)
             + tuple(jbackbones._VGG_SPECS) + tuple(a + "_bn" for a in jbackbones._VGG_SPECS))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def cls_cfg(arch, cls=PPNetConfig):
    return cls(base_architecture=arch, img_size=HW, num_prototypes=6,
               prototype_channels=16, num_classes=3, add_on_layers_type="regular",
               patch_classification=False)


@functools.lru_cache(maxsize=None)
def jax_model_and_shapes(arch):
    """The JAX classification PPNet of ``arch`` and its variables'
    shapes (``jax.eval_shape`` of ``model.init``, which traces the whole
    stem: a DenseNet's takes seconds, so each arch's is traced once)."""
    model = JaxPPNet(cfg=cls_cfg(arch, JaxPPNetConfig))
    return model, jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)), train=True))


def nan_template(arch):
    """``adlm_tpu.utils.torch_import.nan_template`` of the JAX model of
    ``arch``, from the cached shapes."""
    return jax.tree.map(lambda s: np.full(s.shape, np.nan, s.dtype),
                        jax_model_and_shapes(arch)[1])


def random_cls_variables(arch, seed):
    """(params, batch_stats) of the JAX classification PPNet from a numpy
    seed: kernels at 1/sqrt(fan_in), BN affine and running statistics
    away from identity, prototypes in [0, 1), the last layer ±1."""
    model, shapes = jax_model_and_shapes(arch)
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "prototype_vectors":
            return rng.rand(*s.shape).astype(np.float32)
        if name == "last_layer":
            return np.sign(rng.randn(*s.shape)).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)   # bias, BN mean

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return model, tree["params"], tree.get("batch_stats", {})


def port_model(arch, params, batch_stats):
    model = PPNet(cls_cfg(arch))
    model.load_state_dict(cls_state_dict_from_jax(params, batch_stats, arch), strict=True)
    return model


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """The JAX model, its variables, its train-mode forward with the
    updated statistics and its eval-mode forward, on one seeded batch."""
    arch = request.param
    model, params, bs = random_cls_variables(arch, FAMILIES.index(arch))
    x = np.random.RandomState(10).randn(B, HW, HW, 3).astype(np.float32)
    variables = {"params": params, "batch_stats": bs}
    (logits, min_d), upd = jax.jit(lambda v, x: model.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    ev_logits, ev_min_d = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, x)
    return dict(arch=arch, params=params, batch_stats=bs, x=x,
                train=(np.asarray(logits), np.asarray(min_d)),
                stats=jax.tree.map(np.asarray, upd["batch_stats"]),
                eval=(np.asarray(ev_logits), np.asarray(ev_min_d)))


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def test_forward_train_mode_and_running_stats(family):
    model = port_model(family["arch"], family["params"], family["batch_stats"]).train()
    with torch.no_grad():
        logits, min_d = model(_nchw(family["x"]))
    np.testing.assert_allclose(logits.numpy(), family["train"][0], rtol=TRAIN_RTOL, atol=ATOL)
    np.testing.assert_allclose(min_d.numpy(), family["train"][1], rtol=TRAIN_RTOL, atol=ATOL)
    want = cls_state_dict_from_jax(family["params"], family["stats"], family["arch"])
    got = model.state_dict()
    running = [k for k in want if "running" in k]
    assert len(running) == 2 * sum(isinstance(m, backbones.FlaxBatchNorm)
                                   for m in model.modules())
    for k in running:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **STATS, err_msg=k)


def test_forward_eval_mode(family):
    model = port_model(family["arch"], family["params"], family["batch_stats"]).eval()
    with torch.no_grad():
        logits, min_d = model(_nchw(family["x"]))
    np.testing.assert_allclose(logits.numpy(), family["eval"][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(min_d.numpy(), family["eval"][1], rtol=RTOL, atol=ATOL)
    # eval mode leaves the running statistics alone
    want = cls_state_dict_from_jax(family["params"], family["batch_stats"], family["arch"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]) or k == "ones", k


def test_add_on_width_is_the_stems(family):
    """The repaired registry: the add-on stack reads the stem's output
    width, as the JAX package's ``backbone_out_channels``."""
    arch = family["arch"]
    width = jbackbones.backbone_out_channels(arch)
    assert add_on_in_channels(cls_cfg(arch)) == width
    assert family["params"]["add_on"]["conv0"]["kernel"].shape[2] == width
    model = PPNet(cls_cfg(arch), generator=torch.Generator().manual_seed(0))
    assert model.add_on_layers[0].weight.shape == (16, width, 1, 1)
    assert type(model.features).__name__ == type(
        jbackbones.build_classification_backbone(arch)).__name__


def test_fresh_classifier_of_each_family_runs():
    for arch in ("resnet34", "vgg13_bn", "densenet121"):
        model = PPNet(cls_cfg(arch), generator=torch.Generator().manual_seed(0)).eval()
        with torch.no_grad():
            logits, min_d = model(torch.rand(1, 3, HW, HW))
        assert logits.shape == (1, 3) and min_d.shape == (1, 6)
        assert bool(torch.isfinite(logits).all())


def test_deeplab_registry_unchanged():
    cfg = PPNetConfig(num_prototypes=6, num_classes=3, prototype_channels=8,
                      deeplab_n_features=8, deeplab_n_blocks=(1, 1, 1, 1))
    model = PPNet(cfg)
    assert add_on_in_channels(cfg) == 8
    assert type(model.features).__name__ == "MSC"
    with pytest.raises(NotImplementedError):
        backbones.build_classification_backbone("resnet7")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_sizes_and_receptive_fields(arch):
    port, jax_stem = (backbones.build_classification_backbone(arch),
                      jbackbones.build_classification_backbone(arch))
    assert port.conv_info() == jax_stem.conv_info()
    assert backbones.backbone_out_channels(arch) == jbackbones.backbone_out_channels(arch)
    info = rf.proto_layer_rf_info(224, *port.conv_info())
    assert info == jrf.proto_layer_rf_info(224, *jax_stem.conv_info())
    for loc in ((0, 0), (3, 5), (info[0] - 1, info[0] - 1)):
        assert rf.rf_box_at((224, 224), loc, info) == jrf.rf_box_at((224, 224), loc, info)
    for pad in ("SAME", "VALID", 1):
        assert rf.propagate_rf((57, 2, 5, 1.5), 3, 2, pad) == jrf.propagate_rf(
            (57, 2, 5, 1.5), 3, 2, pad)


@pytest.mark.parametrize("arch", FAMILIES)
def test_state_dict_round_trip_through_the_jax_importer(arch):
    """The port's state_dict, read by the JAX package's
    ``load_protopnet_cls`` as a reference checkpoint, comes back through
    ``cls_state_dict_from_jax`` unchanged, every leaf written."""
    model = PPNet(cls_cfg(arch), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if "running" in k:
                v.uniform_(0.5, 1.5)
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    template = nan_template(arch)
    # (a stem without BN has no batch_stats; the JAX importer still
    # looks for its ``features`` node)
    params, bs = template["params"], template.get("batch_stats", {"features": {}})
    report = jimport.load_protopnet_cls(params, bs, sd, arch)
    jimport.assert_fully_imported(report, params, bs)
    back = cls_state_dict_from_jax(params, bs, arch)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    # and the port's own importer takes the same file
    target = PPNet(cls_cfg(arch)).state_dict()
    report = load_protopnet_cls(target, sd, arch)
    assert not report["unexpected_keys"] and not report["negative_variance_keys"]
    assert len(report["loaded"]) == len(sd) - 1          # all but ``ones``
    for k, v in target.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def _torchvision_stem(arch, seed):
    """A torchvision-named ImageNet stem state_dict of ``arch``: the
    port's stem keys (torchvision's) with random values, plus what a
    torchvision model carries beside them (``fc``/``classifier``,
    ``num_batches_tracked``)."""
    g = torch.Generator().manual_seed(seed)
    stem = backbones.build_classification_backbone(arch)
    sd = {k: torch.rand(v.shape, generator=g) for k, v in stem.state_dict().items()}
    for k in list(sd):
        if k.endswith("running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    head = "fc" if arch.startswith("resnet") else "classifier"
    sd[f"{head}.weight"] = torch.rand(1000, 8, generator=g)
    sd[f"{head}.bias"] = torch.rand(1000, generator=g)
    return sd


@pytest.mark.parametrize("arch", ("resnet18", "vgg11_bn", "densenet121"))
def test_load_classification_backbone_from_a_torchvision_pth(tmp_path, arch):
    sd = _torchvision_stem(arch, 5)
    path = tmp_path / f"{arch}.pth"
    torch.save(sd, path)
    loaded_sd = torch.load(path, map_location="cpu", weights_only=True)
    model = PPNet(cls_cfg(arch), generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    target = model.state_dict()
    report = load_classification_backbone(target, loaded_sd, arch)
    model.load_state_dict(target, strict=True)
    stem_keys = [k for k in sd if not k.endswith("num_batches_tracked")
                 and not k.startswith(("fc.", "classifier."))]
    assert sorted(report["loaded"]) == sorted(stem_keys)
    assert report["unexpected_keys"] == [] and report["negative_variance_keys"] == []
    for k in stem_keys:
        assert torch.equal(model.state_dict()[f"features.{k}"], sd[k]), k
    for k, v in model.state_dict().items():   # the head is untouched
        if not k.startswith("features."):
            assert torch.equal(v, before[k]), k
    # the JAX package's loader maps the same keys onto its trees
    template = nan_template(arch)
    jreport = jimport.load_classification_backbone(
        template["params"], template["batch_stats"],
        {k: v.numpy() for k, v in sd.items()}, arch)
    assert sorted(jreport["loaded"]) == sorted(report["loaded"])
    if arch.startswith("densenet"):   # a DenseNet stem without its prefix
        bare = {k[len("features."):] if k.startswith("features.") else k: v
                for k, v in sd.items()}
        report = load_classification_backbone(model.state_dict(), bare, arch)
        assert len(report["loaded"]) == len(stem_keys) and not report["unexpected_keys"]
    # a key with no home, a wrong shape and a negative variance are reported
    bad = dict(sd)
    first_var = next(k for k in sd if k.endswith("running_var"))
    bad[first_var] = -sd[first_var]
    bad["layer9.weight"] = torch.zeros(3)
    conv = next(k for k in stem_keys if k.endswith("weight") and sd[k].ndim == 4)
    bad[conv] = torch.zeros(1, 1, 1, 1)
    report = load_classification_backbone(model.state_dict(), bad, arch)
    assert sorted(report["unexpected_keys"]) == sorted(["layer9.weight", conv])
    assert report["negative_variance_keys"] == [first_var]
