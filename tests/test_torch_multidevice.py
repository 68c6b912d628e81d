"""Port parity for the 2-D ``(slab, element)`` clustered db grid
(``core.deployment.make_clustered_2d``, ``fig_turbulence``'s deployment),
the N-D ``Mesh`` and the grouped collectives it needs.

* ONE reference subprocess with six forced host devices: a session whose
  element-sharded producer (the client mesh's 2 ``space`` ranks) emits
  numpy-made ``[2, 16, 16]`` snapshots into a ring of 8 on
  ``make_clustered_2d(db_fraction=2/3)`` — 4 db ranks as a ``(2, 2)``
  grid (``slab_shards=None``) and as ``(1, 4)`` (``slab_shards=1``,
  ``fig_turbulence``'s setting) — 12 steps in chunks of 4, the ring
  wrapping: the port's tables BYTE-IDENTICAL to the reference's (slab,
  keys, version, ptr, count), ``op_count``, ``staged_transfers`` and the
  plan's entries equal; and the plan of ``tests/test_plan_properties.py``'s
  FD-producer session on both grids.
* Twins of ``tests/test_plan_properties.py:795-870``: exact predictions
  (dispatches, one staged hop a chunk, the drain, fan-in, watermark) on
  the local, co-located, clustered and both 2-D clustered deployments,
  and the 2-D ``ValueError``s, next to the reference's.
* In the port alone: a grid table against a whole one under every verb
  (state byte-identical, reads equal, one grouped ``all_gather`` and one
  grouped ``psum`` a read, a read that skips one column's all-gather
  differing); the 2-D FD ring ``torch.equal`` to the 1-D clustered one;
  ``Mesh`` groups and the grouped collectives.

The reference subprocess's time is recorded as the junit property
``reference_subprocess_s``.
"""

import json
import time

import numpy as np
import pytest

from conftest import run_subprocess
from repro.core import deployment as jdep

N, CAP, STEPS, CHUNK = 16, 8, 12, 4
FD_N = 8
DB_FRACTION = 2 / 3
GRIDS = {"grid": None, "cols": 1}      # slab_shards


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection (every xdist worker collects every test file)."""
    global torch, TS, dep, C, fd, TSession, TProducer, Mesh
    global ElemSharding, GridSharding, space_mesh
    import torch
    from repro_torch.core import deployment as dep
    from repro_torch.core import store as TS
    from repro_torch.insitu import InSituSession as TSession
    from repro_torch.insitu import Producer as TProducer
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import (ElemSharding, GridSharding,
                                               Mesh, space_mesh)
    from repro_torch.sim import distributed as fd
    torch.set_num_threads(1)


def _snaps() -> np.ndarray:
    return np.random.default_rng(5).standard_normal(
        (STEPS, 2, N, N)).astype(np.float32)


_REFERENCE = """
import json, time
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import TableSpec
from repro.core import store as S
from repro.core.deployment import make_clustered_2d
from repro.insitu import InSituSession, Producer
from repro.sim import distributed as fd

snaps = jnp.asarray(np.load({inputs!r})["snaps"])
out, t0 = {{}}, time.perf_counter()


def entries(plan):
    return [[c.name, c.kind, c.tier, c.chunk, [list(d) for d in c.dispatches],
             [list(s) for s in c.staged], c.fan_in] for c in plan.components]


for label, ss in {grids!r}.items():
    dep = make_clustered_2d(P(None, "space", None), db_fraction={frac!r},
                            slab_shards=ss)
    es = NamedSharding(dep.client_mesh, P(None, "space", None))

    def step(c, r, t):
        return c, S.make_key(0, t), snaps[t]

    sess = InSituSession(
        tables=[TableSpec("field", shape=(2, {n}, {n}), capacity={cap})],
        components=[Producer(step, table="field", steps={steps},
                             chunk={chunk}, carry=jnp.zeros(()),
                             elem_sharding=es)],
        deployment=dep)
    plan = sess.plan()
    res = sess.run(plan=plan, sequential=True, max_wall_s=240)
    assert res.ok, {{k: v.error for k, v in res.run.components.items()}}
    st = res.server.checkout("field")
    np.save({result!r} + label + "_slab.npy", np.asarray(st.slab))
    stats = res.server.stats()
    cfg = fd.FDConfig(n={fd_n}, jacobi_iters=8)
    step_fn, s0, fes = fd.make_producer(cfg, dep.client_mesh)
    fd_plan = InSituSession(
        tables=[TableSpec("field", shape=(2, {fd_n}, {fd_n}), capacity=16)],
        components=[Producer(step_fn, table="field", steps=12, chunk=4,
                             carry=s0, elem_sharding=fes)],
        deployment=dep).plan()
    out[label] = {{
        "grid": list(dep.db_mesh.devices.shape),
        "spec": [str(e) for e in st.slab.sharding.spec],
        "keys": np.asarray(st.keys).tolist(),
        "version": np.asarray(st.version).tolist(),
        "ptr": int(st.ptr), "count": int(st.count),
        "op_count": stats["op_count"],
        "staged": stats["staged_transfers"],
        "plan": entries(plan), "fd_plan": entries(fd_plan)}}
out["seconds"] = time.perf_counter() - t0
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grid")
    np.savez(tmp / "inputs.npz", snaps=_snaps())
    t0 = time.perf_counter()
    text = run_subprocess(_REFERENCE.format(
        inputs=str(tmp / "inputs.npz"), result=str(tmp) + "/", grids=GRIDS,
        frac=DB_FRACTION, n=N, cap=CAP, steps=STEPS, chunk=CHUNK,
        fd_n=FD_N), n_devices=6)
    line = [x for x in text.splitlines() if x.startswith("RESULT")][-1]
    out = json.loads(line[len("RESULT"):])
    for label in GRIDS:
        out[label]["slab"] = np.load(tmp / f"{label}_slab.npy")
    return out, time.perf_counter() - t0


def _entries(plan) -> list:
    return [[c.name, c.kind, c.tier, c.chunk, [list(d) for d in c.dispatches],
             [list(s) for s in c.staged], c.fan_in] for c in plan.components]


def _grid_dep(slab_shards, **kw):
    return dep.make_clustered_2d((None, "space", None),
                                 db_fraction=DB_FRACTION,
                                 devices=["cpu"] * 6,
                                 slab_shards=slab_shards, **kw)


def _ring_session(d, snaps):
    layout = ElemSharding(d.client_mesh, (None, "space", None))

    def step(c, r, t):
        return c, TS.make_key(0, t), torch.as_tensor(snaps[t])

    return TSession(
        tables=[TS.TableSpec("field", shape=(2, N, N), capacity=CAP)],
        components=[TProducer(step, table="field", steps=STEPS, chunk=CHUNK,
                              carry=torch.zeros(()), elem_sharding=layout)],
        deployment=d, device="cpu")


@pytest.mark.parametrize("label", list(GRIDS))
def test_ring_matches_reference(reference, label, record_property):
    ref, seconds = reference
    record_property("reference_subprocess_s", seconds)
    want = ref[label]
    d = _grid_dep(GRIDS[label])
    assert list(d.db_mesh.grid) == want["grid"]
    sess = _ring_session(d, _snaps())
    plan = sess.plan()
    assert _entries(plan) == want["plan"]
    res = sess.run(plan=plan, sequential=True, max_wall_s=120)
    assert res.ok, {k: c.error for k, c in res.run.components.items()}
    st = res.server.checkout("field")
    assert type(st.slab) is (TS.GridSlab if label == "grid"
                             else TS.ElemShardedSlab)
    # the reference's slab spec: slots on "slab" only where it has 2 rows
    assert want["spec"][0] == ("slab" if label == "grid" else "None")
    assert TS.whole_slab(st.slab).numpy().tobytes() == want["slab"].tobytes()
    assert st.keys.numpy().astype(np.uint32).tolist() == want["keys"]
    assert st.version.tolist() == want["version"]
    assert (int(st.ptr), int(st.count)) == (want["ptr"], want["count"])
    stats = res.server.stats()
    assert stats["op_count"] == plan.store_dispatches == want["op_count"]
    assert stats["staged_transfers"] == plan.staged_transfers \
        == want["staged"] == -(-STEPS // CHUNK)
    # the shards hold each slot's block once: no byte twice
    assert sum(stats["slab_bytes"]["field"].values()) == CAP * 2 * N * N * 4


@pytest.mark.parametrize("label", list(GRIDS))
def test_fd_plan_matches_reference(reference, label):
    d = _grid_dep(GRIDS[label])
    cfg = fd.FDConfig(n=FD_N, jacobi_iters=8)
    step_fn, s0, es = fd.make_producer(cfg, d.client_mesh)
    sess = TSession(
        tables=[TS.TableSpec("field", shape=(2, FD_N, FD_N), capacity=16)],
        components=[TProducer(step_fn, table="field", steps=12, chunk=4,
                              carry=s0, elem_sharding=es)],
        deployment=d, device="cpu")
    assert _entries(sess.plan()) == reference[0][label]["fd_plan"]


# ---------------------------------------------------------------------------
# Twins of tests/test_plan_properties.py::TestShardedProducerExactness
# ---------------------------------------------------------------------------

def _deployment(kind, spec=(None, "space", None)):
    if kind == "none":
        return None
    if kind == "colocated":
        return dep.Colocated(mesh=space_mesh(1, devices=["cpu"]),
                             elem_spec=spec)
    if kind == "clustered":
        return dep.make_clustered_1d(axis="space", elem_spec=spec,
                                     devices=["cpu"])
    return _grid_dep(GRIDS[kind.split("/")[1]])


@pytest.mark.parametrize("kind", ["none", "colocated", "clustered",
                                  "clustered_2d/grid", "clustered_2d/cols"])
def test_exact_predictions(kind):
    d = _deployment(kind)
    mesh = d.client_mesh if kind.startswith("clustered_2d") \
        else space_mesh(1, devices=["cpu"])
    cfg = fd.FDConfig(n=FD_N, jacobi_iters=8)
    step_fn, s0, es = fd.make_producer(cfg, mesh)
    sess = TSession(
        tables=[TS.TableSpec("field", shape=(2, FD_N, FD_N), capacity=16)],
        components=[TProducer(step_fn, table="field", steps=12, chunk=4,
                              carry=s0, elem_sharding=es)],
        deployment=d, device="cpu")
    plan = sess.plan(hlo=True)
    entry = plan.component("producer")
    assert entry.tier == "capture_scan_sharded"
    entry.check_collectives()
    res = sess.run(plan=plan, sequential=True, max_wall_s=120)
    assert res.ok, {k: v.error for k, v in res.run.components.items()}
    stats = res.server.stats()
    clustered = kind.startswith("clustered")
    expect_ops = 4 if clustered else 3
    assert stats["op_count"] == plan.store_dispatches \
        == entry.store_dispatches == expect_ops
    assert stats["staged_transfers"] == plan.staged_transfers
    if clustered:
        assert entry.staged == (("chunk_stage", 3),)
        assert dict(entry.dispatches) == {"capture": 3, "drain": 1}
        assert entry.explain()["staged_per_chunk"] == 1.0
        assert entry.fan_in == res.server.deployment.fan_in
    else:
        assert plan.staged_transfers == 0
        assert entry.fan_in == 1
    assert res.server.watermark("field") == 12 \
        == res.server.watermark_device("field")


def test_2d_db_mesh_lifts_disjoint_axes():
    d = _grid_dep(None)
    assert d.slab_axis == "slab"
    assert set(d.db_mesh.axis_names) == {"slab", "space"}
    assert d.db_mesh.shape == {"slab": 2, "space": 2}
    spec = TS.TableSpec("field", shape=(2, 8, 8), capacity=16)
    sh = d.slab_sharding(spec)
    assert isinstance(sh, GridSharding) and sh.local_cap == 8
    assert sh.elem.spec == (None, "space", None)
    assert d.gather_shards(spec) == 1
    # odd db pool → one slab row (the reference's default)
    odd = dep.make_clustered_2d((None, "space", None), devices=["cpu"] * 6)
    assert odd.db_mesh.grid == (1, 3)
    assert _grid_dep(1).db_mesh.grid == (1, 4)
    for make, kw in ((jdep.make_clustered_1d, {}),
                     (dep.make_clustered_1d, {"devices": ["cpu"] * 4})):
        with pytest.raises(ValueError, match="disjoint"):
            make(axis="space", elem_spec=(None, "space"), slab_axis="space",
                 **kw)
    for make, kw in ((jdep.make_clustered_2d, {}),
                     (dep.make_clustered_2d, {"devices": ["cpu"] * 4})):
        with pytest.raises(ValueError, match="own axes"):
            make((None, "slab", None), **kw)
    with pytest.raises(ValueError, match="does not divide"):
        jdep.make_clustered_2d((None, "space"), slab_shards=3)
    with pytest.raises(ValueError, match="does not divide"):
        _grid_dep(3)


# ---------------------------------------------------------------------------
# The port alone: the grid table, the 2-D FD ring, meshes and collectives
# ---------------------------------------------------------------------------

def _grid_table(spec):
    return TS.init_table(spec, _grid_dep(None).slab_sharding(spec),
                         device="cpu")


def _same_state(grid, whole):
    assert TS.whole_slab(grid.slab).numpy().tobytes() \
        == whole.slab.numpy().tobytes()
    for field in ("keys", "version", "ptr", "count"):
        assert torch.equal(getattr(grid, field), getattr(whole, field))


def test_grid_table_matches_whole_table():
    spec = TS.TableSpec("t", shape=(2, 4, 6), capacity=6)
    grid, whole = _grid_table(spec), TS.init_table(spec, device="cpu")
    rng = np.random.default_rng(0)
    vals = torch.as_tensor(rng.standard_normal((9, 2, 4, 6)),
                           dtype=torch.float32)
    keys = torch.arange(1, 10)
    with C.counted() as calls:
        for i in range(4):
            grid = TS.put(spec, grid, keys[i], vals[i])
        grid = TS.put_many(spec, grid, keys[4:7], vals[4:7])
        mask = torch.tensor([True, False, True])
        grid = TS.put_masked(spec, grid, keys[6:9], vals[6:9], mask)
    assert calls == {"all_reduce": 0, "all_gather": 0,
                     "collective_permute": 0}         # writes stay local
    for i in range(4):
        whole = TS.put(spec, whole, keys[i], vals[i])
    whole = TS.put_many(spec, whole, keys[4:7], vals[4:7])
    whole = TS.put_masked(spec, whole, keys[6:9], vals[6:9], mask)
    _same_state(grid, whole)
    probe = torch.tensor([1, 5, 7, 9, 42])
    with C.counted() as calls:
        got = TS.get_many(spec, grid, probe)
    assert calls["all_gather"] == 1 and calls["all_reduce"] == 1
    for a, b in zip(got, TS.get_many(spec, whole, probe)):
        assert torch.equal(a, b)
    for a, b in zip(TS.latest(spec, grid, 4), TS.latest(spec, whole, 4)):
        assert torch.equal(a, b)
    for key in (7, 2, 42):
        for a, b in zip(TS.get(spec, grid, key), TS.get(spec, whole, key)):
            assert torch.equal(a, b)
        assert bool(TS.poll(spec, grid, key)) == bool(
            TS.poll(spec, whole, key))
    draw = torch.tensor([0.05, 0.5, 0.95])
    assert torch.equal(TS.sample(spec, grid, draw)[0],
                       TS.sample(spec, whole, draw)[0])
    copy = TS.copy_state(grid)
    grid = TS.put(spec, grid, 99, torch.zeros(2, 4, 6))
    assert not torch.equal(TS.whole_slab(copy.slab),
                           TS.whole_slab(grid.slab))


def test_grid_read_needs_every_column():
    """A control: a grid read whose element-axis all-gather drops one
    column's block (zeros in its place) no longer equals the whole
    table's read."""
    spec = TS.TableSpec("t", shape=(2, 4, 6), capacity=6)
    grid, whole = _grid_table(spec), TS.init_table(spec, device="cpu")
    vals = torch.randn(5, 2, 4, 6, generator=torch.Generator().manual_seed(1))
    grid = TS.put_many(spec, grid, torch.arange(1, 6), vals)
    whole = TS.put_many(spec, whole, torch.arange(1, 6), vals)
    real = C.all_gather

    def skip_one(blocks, mesh, dim=0, axis=None):
        if axis == "space":
            blocks = [torch.zeros_like(b) if mesh.coord(r, "space") == 1
                      else b for r, b in enumerate(blocks)]
        return real(blocks, mesh, dim=dim, axis=axis)

    probe = torch.arange(1, 6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(C, "all_gather", skip_one)
        broken = TS.get_many(spec, grid, probe)[0]
    assert not torch.equal(broken, TS.get_many(spec, whole, probe)[0])
    assert torch.equal(TS.get_many(spec, grid, probe)[0],
                       TS.get_many(spec, whole, probe)[0])


def test_fd_ring_on_the_grid_equals_the_1d_ring():
    """The same FD producer on the client mesh into a ring on the 2-D grid
    and on a 1-D clustered db mesh: the rings equal bit for bit, and
    every stored snapshot equals the solver's own."""
    cfg = fd.FDConfig(n=N, jacobi_iters=8)
    rings = {}
    for kind in ("grid", "1d"):
        d = _grid_dep(None) if kind == "grid" else dep.make_clustered_1d(
            db_fraction=0.5, axis="space", devices=["cpu"] * 4,
            elem_spec=(None, "space", None))
        step_fn, s0, es = fd.make_producer(cfg, d.client_mesh)
        sess = TSession(
            tables=[TS.TableSpec("field", shape=(2, N, N), capacity=CAP)],
            components=[TProducer(step_fn, table="field", steps=STEPS,
                                  chunk=CHUNK, carry=s0, elem_sharding=es)],
            deployment=d, device="cpu")
        res = sess.run(sequential=True, max_wall_s=120)
        assert res.ok, {k: c.error for k, c in res.run.components.items()}
        rings[kind] = res.server.checkout("field")
        if kind == "grid":
            state, snaps = s0, []
            for t in range(STEPS):
                state, _, _ = step_fn(state, 0, t)
                snaps.append(fd.snapshot(state))
    assert torch.equal(TS.whole_slab(rings["grid"].slab),
                       TS.whole_slab(rings["1d"].slab))
    spec = TS.TableSpec("field", shape=(2, N, N), capacity=CAP)
    for t in range(STEPS - CAP, STEPS):
        got, ok = TS.get(spec, rings["grid"], TS.make_key(0, t))
        assert bool(ok) and torch.equal(got, snaps[t])


def test_mesh_groups_and_grouped_collectives():
    cpu = torch.device("cpu")
    m1 = Mesh([cpu] * 3, "data")
    assert (m1.axis, m1.shape, m1.ndim) == ("data", {"data": 3}, 1)
    m2 = Mesh([cpu] * 6, ("slab", "space"), (2, 3))
    with pytest.raises(ValueError, match="name one"):
        m2.axis
    assert m2.groups("space") == [[0, 1, 2], [3, 4, 5]]
    assert m2.groups("slab") == [[0, 3], [1, 4], [2, 5]]
    assert m2.coords(4) == (1, 1) and m2.coord(5, "space") == 2
    with pytest.raises(ValueError):
        Mesh([cpu] * 5, ("slab", "space"), (2, 3))
    vals = [torch.tensor([float(r)]) for r in range(6)]
    with C.counted() as calls:
        sums = C.psum(vals, m2, axis="space")
        cols = C.all_gather(vals, m2, dim=0, axis="slab")
    assert calls["all_reduce"] == 1 and calls["all_gather"] == 1
    assert [float(s) for s in sums] == [3.0] * 3 + [12.0] * 3
    assert [c.tolist() for c in cols] == [[0.0, 3.0], [1.0, 4.0],
                                          [2.0, 5.0]] * 2
    whole = C.psum(vals, m2)
    assert float(whole[cpu]) == 15.0
    layout = ElemSharding(m2, (None, "space"))
    x = torch.arange(12.0).reshape(2, 6)
    blocks = layout.split(x)
    assert [layout.block_of(r) for r in range(6)] == [0, 1, 2] * 2
    assert torch.equal(blocks[4], x[:, 2:4]) and layout.blocks == 3
