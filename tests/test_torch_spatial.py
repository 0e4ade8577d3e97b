"""PyTorch port, spatial eval in one process: the row plan and the row
exchange of ``adlm_tpu_torch.parallel.spatial`` / ``core.mesh``, and the
row windows of the resize and of upsample-argmin's plain version.

* For M = 1..8 ranks and the layer geometry of the flagship (DeepLabV2-
  ResNet101 on 1024 rows) and of the tiny test model (one block per
  layer, on 64 and 65 rows), as ``forward_rows`` fetches it (recorded
  from a forward on a narrow frame): every operator that exchanges
  rows, the logits' resize and the upsampled statistics' kernel window
  take exactly the rows their outputs read, each row from the rank that
  owns it or the fill past the image edge; the exchange itself, M ranks
  simulated by threads whose SUM is a barrier, returns each rank the
  global rows it asked for (zeros or −inf past the edge).  The 8 ranks
  at ASPP's rate 24 fetch from ranks beyond their neighbours.
* ``resize_bilinear_rows`` and ``upsampled_argmin_reference`` on row
  windows of a slab equal the same rows of their whole-frame result bit
  for bit; the resize's whole frame is ``resize_bilinear``'s.
* The MSC trunk (``trunk_rows`` at each scale, ``msc_rows``) on each
  rank's rows equals the same rows of the one-process MSC features bit
  for bit (frames whose pyramid grids have 9 rows at least: on smaller
  maps the CPU's convolutions round a row slab differently from the
  whole map).
* ``prototype_parallel_params`` on an uneven P (7 over 2, 50 over 4,
  and the presets' 190 and 210 over 2) gives blocks that tile the bank
  and the last layer in order, and leaves the module whole; the
  (value, index) combine over the model group (``Mesh.lexmin(...,
  over="model")``) on planted cross-rank ties gives the lowest global
  index, as one argmin over the whole bank does; the plain
  upsample-argmin's value output is the min of the whole-bank blend,
  on a row window too, and its P slices combine to the whole bank's.
* The MSC spatial step and the tensor-parallel head build and run (they
  raised before); a slab that lacks a row its window reads raises.

The spatial eval against the JAX package's spatially sharded eval runs
in tests/test_torch_parallel.py's 2-rank world.
"""

import threading

import numpy as np
import pytest
import torch

from adlm_tpu_torch.core import mesh as mesh_mod
from adlm_tpu_torch.core.config import PPNetConfig
from adlm_tpu_torch.core.mesh import Mesh, row_range, row_sources
from adlm_tpu_torch.models.ppnet import PPNet
from adlm_tpu_torch.ops.resize import (
    bilinear_source_rows,
    resize_bilinear,
    resize_bilinear_rows,
)
from adlm_tpu_torch.ops.upsample_argmin import (
    _src_coords,
    tap_rows,
    upsampled_argmin_reference,
    upsampled_nearest,
)
from adlm_tpu_torch.parallel.sharding import (
    make_sharded_inference_fn,
    prototype_parallel_params,
)
from adlm_tpu_torch.parallel.spatial import (
    Rank,
    forward_rows,
    make_spatial_inference_fn,
    msc_rows,
    row_plan,
    trunk_rows,
)

TINY = dict(num_prototypes=12, num_classes=4, prototype_channels=16,
            deeplab_n_features=16, deeplab_n_blocks=(1, 1, 1, 1))


def _model(flagship: bool) -> PPNet:
    cfg = PPNetConfig() if flagship else PPNetConfig(**TINY)
    return PPNet(cfg, generator=torch.Generator().manual_seed(0))


class _Recorder(Rank):
    """A world of one that records every fetch ``forward_rows`` makes:
    (geometry, input rows, output rows, fill)."""

    def __init__(self):
        super().__init__(Mesh(1, 1, 0, torch.device("cpu")))
        self.ops = []

    def fetch(self, x, n_in, op, n_out, fill=0.0):
        self.ops.append((op, n_in, n_out, fill))
        return super().fetch(x, n_in, op, n_out, fill)


@pytest.fixture(scope="module")
def geometries():
    """(the fetches of a forward, input rows, grid rows) per case, on
    frames 8 pixels wide; the grid rows also from the whole-frame forward."""
    out = {}
    for name, flagship, n in (("flagship", True, 1024), ("tiny64", False, 64),
                              ("tiny65", False, 65)):
        model = _model(flagship).eval()
        rec = _Recorder()
        x = torch.zeros(1, 3, n, 8)
        with torch.no_grad():
            _, _, grid = forward_rows(model, x, rec, False)
            assert grid == model.conv_features(x).shape[2]
        out[name] = (rec.ops, n, grid)
    assert out["flagship"][2] == 129
    return out


class _ThreadWorld:
    """M ranks as threads: ``core.mesh._reduce`` becomes a SUM (or MIN)
    across the threads' tensors behind a barrier."""

    def __init__(self, M: int):
        self.M = M
        self.barrier = threading.Barrier(M)
        self.slots = [None] * M
        self.ranks = {}

    def reduce(self, t, op, group):
        r = self.ranks[threading.get_ident()]
        self.slots[r] = t
        self.barrier.wait()
        if op == "sum":
            total = sum(s.clone() for s in self.slots)
        else:
            total = torch.stack([s.clone() for s in self.slots]).amin(dim=0)
        self.barrier.wait()
        t.copy_(total)
        self.barrier.wait()

    def run(self, fn):
        out, errs = [None] * self.M, []

        def body(r):
            self.ranks[threading.get_ident()] = r
            try:
                out[r] = fn(Mesh(1, self.M, r, torch.device("cpu"), backend="threads",
                                 data_group=mesh_mod._SELF, model_group=None))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errs.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,)) for r in range(self.M)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        return out


def _check_sources(owned, need, n):
    """``row_sources`` covers ``need`` once, in order, each row from its
    owner or (past the edge) the fill."""
    pieces = row_sources(owned, need)
    pos = need[0]
    for lo, hi, src in pieces:
        assert lo == pos and hi > lo, pieces
        if src == -1:
            assert hi <= 0 or lo >= n, pieces
        else:
            assert owned[src][0] <= lo and hi <= owned[src][1], (pieces, owned)
        pos = hi
    assert pos == need[1], pieces


@pytest.mark.parametrize("M", range(1, 9))
@pytest.mark.parametrize("geom", ["flagship", "tiny64", "tiny65"])
def test_row_plan_covers_every_tap_and_the_exchange_moves_them(geometries, geom, M,
                                                                monkeypatch):
    ops, label, grid = geometries[geom]
    world = _ThreadWorld(M)
    monkeypatch.setattr(mesh_mod, "_reduce", world.reduce)
    for op, n, n_out, fill in ops:
        name = f"{op} {n} -> {n_out}"
        owned, outs = row_plan(n, M), row_plan(n_out, M)
        need = [op.reads(r) for r in outs]
        for q in range(M):
            _check_sources(owned, need[q], n)
            lo, hi = outs[q]
            # each output row's taps lie in the fetched rows, and a conv
            # with no H padding over them gives exactly the rank's rows
            taps = [o * op.stride - op.padding + j * op.dilation
                    for o in (lo, hi - 1) for j in (0, op.kernel - 1)]
            assert need[q][0] <= min(taps) and max(taps) < need[q][1], name
            flat = type(op)(op.kernel, op.stride, 0, op.dilation, op.ceil)
            assert flat.out_rows(need[q][1] - need[q][0]) == hi - lo, (name, q)
        full = torch.arange(n, dtype=torch.float32)[None, :, None, None].expand(1, n, 3, 2)

        def fetch(mesh, owned=owned, need=need, full=full, n=n, fill=fill):
            a, b = owned[mesh.model_index]
            return mesh.exchange_rows(full[:, a:b].contiguous(), 1, owned, need, fill)

        got = world.run(fetch)
        for q in range(M):
            lo, hi = need[q]
            rows = torch.arange(lo, hi, dtype=torch.float32)
            want = torch.where((rows >= 0) & (rows < n), rows, torch.tensor(fill))
            assert torch.equal(got[q][0, :, 0, 0], want), (name, q)
    # the logits' resize and the kernel's window over each rank's label rows
    # (the resize's rows: the taps and a row of margin each way)
    t0, t1 = (t.long() for t in _src_coords(label, grid, "cpu")[:2])
    for q, (lo, hi) in enumerate(row_plan(label, M)):
        first, last = tap_rows(label, grid, lo, hi)
        _check_sources(row_plan(grid, M), (first, last), grid)
        assert first == int(t0[lo:hi].min()) and last == int(t1[lo:hi].max()) + 1, q
        wide = bilinear_source_rows(label, grid, lo, hi)
        _check_sources(row_plan(grid, M), wide, grid)
        assert wide == (max(first - 1, 0), min(last + 1, grid)), q


@pytest.mark.parametrize("shape", [(9, 9, 64, 64), (33, 65, 257, 513), (129, 257, 1024, 2048),
                                   (65, 97, 33, 47)], ids=str)
def test_resize_rows_equal_the_whole_frame_rows(shape):
    h, w, H, W = shape
    x = torch.from_numpy(np.random.RandomState(0).randn(2, h, w, 5).astype(np.float32))
    whole = resize_bilinear(x, (H, W))
    assert torch.equal(resize_bilinear_rows(x, (H, W), 0, H), whole)
    for m in (2, 3):
        for lo, hi in row_plan(H, m) + [(H // 3 + 1, H // 3 + 2)]:
            first, last = bilinear_source_rows(H, h, lo, hi)
            got = resize_bilinear_rows(x[:, first:last], (H, W), lo, hi, first_row=first, in_h=h)
            assert torch.equal(got, whole[:, lo:hi]), (lo, hi)
    first, last = bilinear_source_rows(H, h, H // 2, H)
    with pytest.raises(ValueError):
        resize_bilinear_rows(x[:, first + 1:last], (H, W), H // 2, H, first_row=first + 1,
                             in_h=h)


@pytest.mark.parametrize("shape", [(9, 9, 12, 64, 64), (33, 65, 70, 257, 513),
                                   (65, 97, 19, 33, 47), (16, 32, 19, 128, 256)], ids=str)
def test_upsample_argmin_rows_equal_the_whole_frame_rows(shape):
    h, w, P, H, W = shape
    rng = np.random.RandomState(1)
    d = torch.from_numpy(rng.rand(2, h, w, P).astype(np.float32))
    ties = torch.from_numpy(rng.randint(0, 3, (2, h, w, P)).astype(np.float32))
    for dist in (d, ties):
        whole = upsampled_argmin_reference(dist, (H, W), exact=True)
        assert torch.equal(upsampled_nearest(dist, (H, W)), whole)
        for m in (2, 3):
            for lo, hi in row_plan(H, m):
                first, last = tap_rows(H, h, lo, hi)
                slab = dist[:, first:last]
                win = dict(out_rows=(lo, hi - lo), map_rows=(first, h))
                assert torch.equal(upsampled_argmin_reference(slab, (H, W), exact=True, **win),
                                   whole[:, lo:hi])
                assert torch.equal(upsampled_nearest(slab, (H, W), **win), whole[:, lo:hi])
    first, last = tap_rows(H, h, 0, H // 2)
    with pytest.raises(ValueError):
        upsampled_argmin_reference(d[:, first:last - 1], (H, W), out_rows=(0, H // 2),
                                   map_rows=(first, h))


def _msc_model(P: int = 12) -> PPNet:
    cfg = PPNetConfig(**dict(TINY, num_prototypes=P), msc_scales=(0.5, 0.75))
    model = PPNet(cfg, generator=torch.Generator().manual_seed(0)).eval()
    return model.to(memory_format=torch.channels_last)


@pytest.fixture
def one_thread():
    """One intra-op thread: the CPU's convolutions block their work by
    the thread count, so the rows' and the whole map's runs use the same."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("M", [2, 3])
@pytest.mark.parametrize("hw", [(128, 128), (97, 129)], ids=str)
def test_msc_trunk_rows_equal_the_one_process_features(hw, M, monkeypatch, one_thread):
    model = _msc_model()
    x = torch.from_numpy(np.random.RandomState(2).randn(2, hw[0], hw[1], 3).astype(
        np.float32)).permute(0, 3, 1, 2)
    base = model.features.base
    with torch.no_grad():
        whole = model.features(x)
    n = whole.shape[2]
    world = _ThreadWorld(M)
    monkeypatch.setattr(mesh_mod, "_reduce", world.reduce)

    def rows(mesh):
        rank = Rank(mesh)
        with torch.no_grad():
            x1, n1 = trunk_rows(base, x, rank)
            return msc_rows(base, x, rank, x1, n1, model.features.scales), n1

    for q, (got, n1) in enumerate(world.run(rows)):
        lo, hi = row_plan(n, M)[q]
        assert n1 == n
        assert torch.equal(got, whole[:, :, lo:hi]), q


@pytest.mark.parametrize("P,M", [(7, 2), (50, 4), (190, 2), (210, 2)])
def test_prototype_parallel_params_tile_the_bank(P, M):
    model = PPNet(PPNetConfig(**dict(TINY, num_prototypes=P)),
                  generator=torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    parts = [prototype_parallel_params(model, Mesh(1, M, m, torch.device("cpu")))
             for m in range(M)]
    start = 0
    for m, tp in enumerate(parts):
        assert tp.start == start and tp.total == P, m
        assert tp.prototypes.is_contiguous() and tp.last_layer.is_contiguous()
        assert tp.prototypes.shape[0] == tp.last_layer.shape[0] == row_range(m, P, M)[1] - start
        start += tp.prototypes.shape[0]
    assert start == P
    assert torch.equal(torch.cat([tp.prototypes for tp in parts]), model.prototypes())
    assert torch.equal(torch.cat([tp.last_layer for tp in parts]), model.last_layer_pk())
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(ValueError):
        prototype_parallel_params(PPNet(PPNetConfig(**dict(TINY, num_prototypes=4))),
                                  Mesh(1, 8, 0, torch.device("cpu")))


@pytest.mark.parametrize("M", [2, 3])
def test_value_index_combine_takes_the_lowest_global_index(M, monkeypatch):
    # (pixels, P = 7): each row's minimum sits at several prototypes,
    # on both sides of the slices' boundaries
    vals = torch.tensor([[3., 1., 2., 1., 1., 5., 1.],
                         [0., 4., 4., 0., 0., 2., 0.],
                         [5., 5., 5., 5., 5., 5., 2.],
                         [2., 2., 2., 2., 2., 2., 2.],
                         [9., 8., 7., 7., 8., 9., 7.]])
    want_v, want_i = vals.amin(dim=-1), torch.argmin(vals, dim=-1)
    world = _ThreadWorld(M)
    monkeypatch.setattr(mesh_mod, "_reduce", world.reduce)

    def combine(mesh):
        lo, hi = row_range(mesh.model_index, vals.shape[1], M)
        local = vals[:, lo:hi]
        return mesh.lexmin(local.amin(dim=-1), torch.argmin(local, dim=-1) + lo, over="model")

    for q, (v, i) in enumerate(world.run(combine)):
        assert torch.equal(v, want_v) and torch.equal(i, want_i), q


@pytest.mark.parametrize("shape", [(9, 9, 12, 64, 64), (33, 65, 70, 257, 513),
                                   (16, 32, 19, 128, 256), (65, 97, 19, 33, 47)], ids=str)
def test_plain_value_output_is_the_min_of_the_whole_bank_blend(shape):
    h, w, P, H, W = shape
    rng = np.random.RandomState(3)
    d = torch.from_numpy(rng.rand(2, h, w, P).astype(np.float32))
    ties = torch.from_numpy(rng.randint(0, 3, (2, h, w, P)).astype(np.float32))
    y0, y1, wy = _src_coords(H, h, "cpu")
    x0, x1, wx = _src_coords(W, w, "cpu")
    for dist in (d, ties):
        # the exact separable blend of every prototype at once
        fx = dist[:, :, x0, :] * (1.0 - wx[:, None]) + dist[:, :, x1, :] * wx[:, None]
        up = fx[:, y0] * (1.0 - wy[:, None, None]) + fx[:, y1] * wy[:, None, None]
        idx, val = upsampled_argmin_reference(dist, (H, W), exact=True, with_value=True)
        assert torch.equal(val, up.amin(dim=-1)) and val.dtype == torch.float32
        assert torch.equal(idx, upsampled_argmin_reference(dist, (H, W), exact=True))
        assert torch.equal(idx, torch.argmin(up, dim=-1).to(torch.int32))
        # the dispatch (the integer-phase path where it applies) by the same rule
        ni, nv = upsampled_nearest(dist, (H, W), with_value=True)
        assert torch.equal(ni, upsampled_nearest(dist, (H, W)))
        assert torch.equal(nv, torch.gather(up, -1, ni.long()[..., None])[..., 0]) \
            if H % h or W % w else torch.equal(ni, idx)
        lo, hi = row_plan(H, 2)[1]
        first, last = tap_rows(H, h, lo, hi)
        wi, wv = upsampled_argmin_reference(dist[:, first:last], (H, W), exact=True,
                                            out_rows=(lo, hi - lo), map_rows=(first, h),
                                            with_value=True)
        assert torch.equal(wi, idx[:, lo:hi]) and torch.equal(wv, val[:, lo:hi])
        # P in contiguous slices, combined: least value, then the first slice
        for m in (2, 3):
            best_v = best_i = None
            for q in range(m):
                a, b = row_range(q, P, m)
                si, sv = upsampled_argmin_reference(dist[..., a:b], (H, W), exact=True,
                                                    with_value=True)
                if best_v is None:
                    best_v, best_i = sv, si + a
                else:
                    take = sv < best_v
                    best_v = torch.where(take, sv, best_v)
                    best_i = torch.where(take, si + a, best_i)
            assert torch.equal(best_i, idx) and torch.equal(best_v, val), m


def test_msc_spatial_step_and_the_tensor_parallel_head_build_and_run(monkeypatch):
    """The calls that raised before this slice (an MSC model under spatial
    eval, ``prototype_parallel=True``) build, and run on two thread
    ranks: the maps of each rank's rows, the counters of the frame."""
    rng = np.random.RandomState(4)
    images = rng.rand(2, 64, 64, 3).astype(np.float32)
    labels = rng.randint(0, 5, (2, 64, 64))
    pc = torch.arange(12) % 4
    world = _ThreadWorld(2)
    monkeypatch.setattr(mesh_mod, "_reduce", world.reduce)

    def run(mesh):
        msc = make_spatial_inference_fn(_msc_model(), 4, mesh)(pc, images, labels)
        model = _model(False)
        tp = make_sharded_inference_fn(model, 4, mesh, spatial=False, prototype_parallel=True)
        return msc, tp(prototype_parallel_params(model, mesh), pc, images, labels)

    for q, (msc, tp) in enumerate(world.run(run)):
        lo, hi = row_plan(64, 2)[q]
        assert msc["pred"].shape == (2, hi - lo, 64)
        assert tp["pred"].shape == (2, 64, 64)
        for out in (msc, tp):
            assert int(out["total"]) == int((labels > 0).sum())
    assert row_range(1, 9, 2) == (4, 9)
    with pytest.raises(ValueError):
        row_plan(7, 8)                              # a rank would hold no row
