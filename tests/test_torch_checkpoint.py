"""PyTorch port, checkpoints: ``adlm_tpu_torch.core.checkpoint`` and the
Adam state carried over from the JAX package.

* ``CheckpointStore`` round trips every stage and kind.  A crash is
  injected at each point of ``save``'s rotation (``torch.save`` or
  ``os.rename`` or ``shutil.rmtree`` raising); after it, ``exists`` and
  ``restore`` give the newest finalized generation and rename nothing,
  and the next ``save`` heals the rotation and removes the staging
  leftovers.  The store differs from the JAX package's on purpose in
  three ways (each has a test here): the heal removes an interrupted
  write's staging directory but never a finalized ``.next``; readers
  never rename (a reader beside a live writer re-resolves once when the
  generation it chose was rotated away); ``save`` has no ``force``.
* ``adam_state_from_jax``: the JAX ``make_train_step`` runs two windows
  of each phase on the tiny model of test_torch_train.py; its
  parameters, constants and optax moments go into the port, and both
  packages run window 3 with the same metrics and parameter updates,
  within test_torch_train.py's tolerances (``METRIC_RTOL``,
  ``UPDATE_RTOL``, ``DRIFT_LRS``).
"""

import inspect
import os
import shutil
from collections.abc import Mapping

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adlm_tpu.models.ppnet import default_proto_class as jax_proto_class
from adlm_tpu.train import protoseg as jtrain

from adlm_tpu_torch.core import checkpoint as ckpt
from adlm_tpu_torch.core.checkpoint import CheckpointStore
from adlm_tpu_torch.train import protoseg as ttrain
from adlm_tpu_torch.train.optimizer import adam_state_by_name, load_adam_state
from adlm_tpu_torch.utils.jax_weights import adam_state_from_jax, state_dict_from_jax

from test_torch_train import (
    DRIFT_LRS,
    UPDATE_RTOL,
    _assert_metrics,
    _configs,
    _named,
    _pair,
    _port_params,
    _rel,
    _windows,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny convs run op by op: one torch thread per test worker."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _payload(seed: int):
    g = torch.Generator().manual_seed(seed)
    return {"state_dict": {"a.weight": torch.randn(3, 4, generator=g),
                           "b.running_var": torch.rand(5, generator=g)},
            "proto_class": torch.arange(6) // 2, "step": seed, "phase": 1,
            "max_steps": None,
            "opt": {"a.weight": {"step": torch.tensor(float(seed)),
                                 "exp_avg": torch.randn(3, 4, generator=g),
                                 "exp_avg_sq": torch.rand(3, 4, generator=g)}}}


def _equal(a, b) -> bool:
    if isinstance(a, Mapping):
        return (isinstance(b, Mapping) and set(a) == set(b)
                and all(_equal(a[k], b[k]) for k in a))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _listing(store):
    return sorted(os.listdir(store.ckpt_dir))


@pytest.mark.parametrize("kind", ckpt.KINDS)
@pytest.mark.parametrize("stage", ckpt.STAGES)
def test_round_trip(tmp_path, stage, kind):
    store = CheckpointStore(str(tmp_path / "run"))
    assert not store.exists(stage, kind)
    with pytest.raises(FileNotFoundError):
        store.restore(stage, kind)
    for seed in (1, 2):  # the second save replaces the first
        path = store.save(stage, kind, _payload(seed))
        assert path == os.path.join(store.ckpt_dir, f"{stage}_{kind}")
        assert store.exists(stage, kind)
        assert _equal(store.restore(stage, kind), _payload(seed))
    assert _listing(store) == [f"{stage}_{kind}"]
    assert os.listdir(path) == [ckpt.PAYLOAD]


def test_save_has_no_force_parameter():
    assert list(inspect.signature(CheckpointStore.save).parameters) == [
        "self", "stage", "kind", "payload"]


def _fail_nth(real, n: int, what: str):
    calls = []

    def fn(*args, **kwargs):
        calls.append(args)
        if len(calls) == n:
            raise OSError(f"injected crash in {what} call {n}")
        return real(*args, **kwargs)
    return fn


def _torch_save_cut(obj, f, *args, **kwargs):
    f.write(b"PK\x03\x04 partial")
    raise OSError("injected crash in torch.save")


# crash point → (what to patch, which call fails, generation readers get)
CRASHES = {
    "writing_staging": ("torch.save", 1, "old"),
    "finalizing_next": ("os.rename", 1, "old"),
    "demoting_path": ("os.rename", 2, "new"),
    "promoting_next": ("os.rename", 3, "new"),
    "removing_old": ("shutil.rmtree", 1, "new"),
}


@pytest.mark.parametrize("crash", list(CRASHES))
def test_crash_at_each_point_of_the_rotation(tmp_path, monkeypatch, crash):
    target, n, newest = CRASHES[crash]
    store = CheckpointStore(str(tmp_path / "run"))
    store.save("nopush", "last", _payload(1))
    with monkeypatch.context() as m:
        if target == "torch.save":
            m.setattr(torch, "save", _torch_save_cut)
        elif target == "os.rename":
            m.setattr(os, "rename", _fail_nth(os.rename, n, target))
        else:
            m.setattr(shutil, "rmtree", _fail_nth(shutil.rmtree, n, target))
        with pytest.raises(OSError, match="injected"):
            store.save("nopush", "last", _payload(2))
    after_crash = _listing(store)
    assert len(after_crash) >= 2, after_crash  # something was left behind

    # readers: the newest finalized generation, and nothing renamed
    want = _payload(2 if newest == "new" else 1)
    for _ in range(2):
        assert store.exists("nopush", "last")
        assert _equal(store.restore("nopush", "last"), want)
        assert _equal(CheckpointStore(store.run_dir).restore("nopush", "last"), want)
    assert _listing(store) == after_crash

    # the next save heals and leaves one generation, no staging leftovers
    store.save("nopush", "last", _payload(3))
    assert _listing(store) == ["nopush_last"]
    assert _equal(store.restore("nopush", "last"), _payload(3))


def test_heal_removes_staging_but_promotes_a_finalized_next(tmp_path):
    """An interrupted write leaves ``<path>.next.tmp-*``: the heal removes
    it.  A finalized ``<path>.next`` is the newest generation: the heal
    promotes it and never deletes it."""
    store = CheckpointStore(str(tmp_path / "run"))
    path = store.save("push", "best", _payload(1))
    nxt = path + ".next"
    os.makedirs(nxt)
    torch.save(_payload(2), os.path.join(nxt, ckpt.PAYLOAD))
    for tag in ("0a1b2c3d", "deadbeef"):
        leftover = nxt + ckpt._STAGING + tag
        os.makedirs(leftover)
        with open(os.path.join(leftover, ckpt.PAYLOAD), "wb") as f:
            f.write(b"partial")
    assert _equal(store.restore("push", "best"), _payload(2))
    store._heal(path)
    assert _listing(store) == ["push_best"]
    assert _equal(store.restore("push", "best"), _payload(2))


def test_reader_re_resolves_when_a_writer_rotates_its_generation(tmp_path, monkeypatch):
    """A reader chose ``.next`` (a rotation cut short); a writer's save
    then heals and rotates it away before the reader opens it.  The
    reader works out the newest generation once more."""
    store = CheckpointStore(str(tmp_path / "run"))
    path = store.save("warmup", "last", _payload(1))
    os.makedirs(path + ".next")
    torch.save(_payload(2), os.path.join(path + ".next", ckpt.PAYLOAD))
    writer = CheckpointStore(store.run_dir)
    real_load = torch.load
    opened = []

    def load(f, *args, **kwargs):
        if not opened:
            writer.save("warmup", "last", _payload(3))
        opened.append(f)
        return real_load(f, *args, **kwargs)

    monkeypatch.setattr(torch, "load", load)
    assert _equal(store.restore("warmup", "last"), _payload(3))
    assert opened[0].endswith(".next/" + ckpt.PAYLOAD)
    assert len(opened) == 2


def test_restore_maps_to_the_asked_device(tmp_path):
    store = CheckpointStore(str(tmp_path / "run"))
    store.save("pruned", "last", _payload(4))
    got = store.restore("pruned", "last", map_location="cpu")
    assert got["state_dict"]["a.weight"].device.type == "cpu"
    with pytest.raises(ValueError, match="unknown checkpoint"):
        store.save("joint", "last", _payload(4))


# ---------------------------------------------------------------------------
# Adam state from the JAX package
# ---------------------------------------------------------------------------

def _nested(tree):
    """An optax state as nested mappings of numpy arrays: named tuples as
    {field: value}, tuples as {"0": ...}, masked-out leaves as {}."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _nested(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, (tuple, list)):
        return {str(i): _nested(v) for i, v in enumerate(tree)}
    if isinstance(tree, Mapping):
        return {k: _nested(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.mark.parametrize("phase", [0, 1, 2])
def test_adam_state_from_jax_steps_like_jax(phase):
    jcfg, tcfg = _configs(grad_clip_norm=10.0) if phase == 1 else _configs()
    jm, params, constants, tm = _pair(jcfg, tcfg, seed=29)
    n_windows = 3
    max_steps = n_windows * jcfg.train.iter_size
    jstate = jtrain.init_protoseg_state(
        jm, jcfg, phase, max_steps, jax.random.PRNGKey(0),
        jnp.zeros((1, 33, 33, 3)), params=params, constants=constants,
        proto_class=jax_proto_class(6, 3))
    jstep = jtrain.make_train_step(jm, jcfg, phase, max_steps)
    windows = _windows(31, n_windows)
    for images, labels in windows[:2]:
        jstate, _ = jstep(jstate, jnp.asarray(images), jnp.asarray(labels))

    # the whole JAX state into the port
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    tm.load_state_dict(state_dict_from_jax(host(jstate.params),
                                           host(jstate.constants)), strict=True)
    tstate = ttrain.init_protoseg_state(tm, tcfg, phase, max_steps, device="cpu")
    by_name = adam_state_from_jax(_nested(jstate.opt_state), tm, tcfg, phase)
    trained = {n for g in tstate.optimizer.param_groups for n, p in tm.named_parameters()
               if any(p is q for q in g["params"])}
    assert set(by_name) == trained
    assert all(float(s["step"]) == 2.0 for s in by_name.values())
    load_adam_state(tstate.optimizer, tm, by_name)
    tstate.step = int(jstate.step)
    # the by-name form round trips through the optimizer
    back = adam_state_by_name(tstate.optimizer, tm)
    assert all(_equal(back[n], by_name[n]) for n in by_name)

    lr_max = max(g["base_lr"] for g in tstate.optimizer.param_groups)
    prev_j, prev_t = _named(jstate.params), _port_params(tm)
    images, labels = windows[2]
    jstate, want = jstep(jstate, jnp.asarray(images), jnp.asarray(labels))
    tstate, got = ttrain.make_train_step(tm, tcfg, phase, max_steps, device="cpu")(
        tstate, images, labels)
    tag = f"phase {phase} window 3"
    _assert_metrics(got, want, tag)
    cur_j, cur_t = _named(jstate.params), _port_params(tm)
    moved = 0
    for n in cur_t:
        dj, dt = cur_j[n] - prev_j[n], cur_t[n] - prev_t[n]
        if not np.any(dj):
            assert not np.any(dt), f"{tag}: {n} moved, JAX kept it"
        else:
            moved += 1
            assert _rel(dt, dj) <= UPDATE_RTOL, f"{tag}: {n} {_rel(dt, dj)}"
        assert np.abs(cur_t[n] - cur_j[n]).max() <= DRIFT_LRS * lr_max, f"{tag}: {n}"
    assert moved == len(trained)
    assert tstate.step == 3
    nxt = adam_state_from_jax(_nested(jstate.opt_state), tm, tcfg, phase)
    for n, s in adam_state_by_name(tstate.optimizer, tm).items():
        assert float(s["step"]) == float(nxt[n]["step"]) == 3.0
        for k in ("exp_avg", "exp_avg_sq"):
            assert _rel(s[k].numpy().astype(np.float64),
                        nxt[n][k].numpy().astype(np.float64)) <= UPDATE_RTOL, (n, k)


def test_adam_state_from_jax_refuses_another_phase():
    jcfg, tcfg = _configs()
    jm, params, constants, tm = _pair(jcfg, tcfg, seed=37)
    jstate = jtrain.init_protoseg_state(
        jm, jcfg, 0, 4, jax.random.PRNGKey(0), jnp.zeros((1, 33, 33, 3)),
        params=params, constants=constants)
    with pytest.raises(ValueError, match="trains"):
        adam_state_from_jax(_nested(jstate.opt_state), tm, tcfg, 1)
    assert len(adam_state_from_jax(_nested(jstate.opt_state), tm, tcfg, 0)) > 0
