"""Port parity for the int8 DDP wire (``parallel/compress.py``) and the
trainer's ``ddp="int8"`` (tiers ``sharded_fused``, ``slab_sharded`` and
``slab_sharded_clustered``).

* In this process, against the reference: ``quantize_int8`` /
  ``dequantize_int8`` at five shapes and two block sizes, payloads and
  scales EXACT; ``compression_ratio``; ``ErrorFeedback`` over 20 steps of
  a two-leaf tree, every payload, scale, dequantized value and residual
  exact.
* From ONE reference subprocess with four forced host devices:
  ``compressed_psum_mean`` and ``compressed_psum_mean_ef`` (three steps,
  each started from the reference's carried residuals) over 2 and 4
  ranks — the means exact at 2 ranks; at 4 the ranks' scales are summed
  in another order, so the means sit within 2 ulp (rtol 2.4e-7); the
  residuals within ``2^-22 (|g + r| + scale)``, because the reference's
  fused epoch scales its residual by ``amax * (1/127)`` where its wire
  divides by 127 — and ``compressed_allreduce`` over 4; the
  reference's ``sharded_fused`` epochs at mesh 2 with ``ddp="int8"``,
  with and without error feedback (2 epochs each, the same numpy-seeded
  weights and table), their draws fed to the port: losses within 1e-5
  relative and every parameter element within the mesh tolerances (rtol
  2e-5, atol 1e-6); the exact psum run as the int8 one, feedback off run
  as feedback on, and a residual never reset between epochs each fail
  that parameter check.
* In the port: the three int8 tiers train alike (``slab_sharded`` and
  ``slab_sharded_clustered`` ``torch.equal`` to ``sharded_fused``),
  feedback changes the params, a rerun is bit-identical, and the epoch
  makes three all-reduce calls a microstep (``plan.ddp_all_reduces``).

The subprocess's time is recorded as the junit property
``reference_subprocess_s``.
"""

import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import (np_autoencoder_params, torch_ae_config,
                           uniforms_for_ranks)
from conftest import run_subprocess
from repro.ml import autoencoder as jae
from repro.parallel import compress as jcp

TESTS = Path(__file__).resolve().parent
# a one-block autoencoder at 64 points: the reference's epochs compile in
# seconds
N, CAP, PUTS, GATHER, BATCH, EPOCHS, SEED = 64, 16, 20, 6, 4, 2, 3
_AE = dict(n_points=N, channels=4, internal=4, latent=4, blocks=1, pool=4,
           mlp_width=8, mlp_depth=2)
# the per-rank gradient trees of the wire tests
_LEAVES = {"a": (33,), "b": (4, 70)}
RANKS = (2, 4)
EF_STEPS = 3


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection (every xdist worker collects every test file)."""
    global torch, CP, C, TS, ttr, tae, topt, tplan, data_mesh, slab_sharding
    global dep, TServer, TClient
    import torch
    from repro_torch.core import Client as TClient
    from repro_torch.core import StoreServer as TServer
    from repro_torch.core import deployment as dep
    from repro_torch.core import store as TS
    from repro_torch.insitu import plan as tplan
    from repro_torch.ml import autoencoder as tae
    from repro_torch.ml import trainer as ttr
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import compress as CP
    from repro_torch.parallel.sharding import data_mesh, slab_sharding
    from repro_torch.train import optimizer as topt
    torch.set_num_threads(1)


def _grads(seed: int, n: int) -> list:
    """``n`` ranks' gradient trees (numpy), magnitudes spread over three
    decades so the blocks' scales differ."""
    rng = np.random.default_rng(seed)
    return [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 1))
             .astype(np.float32) for k, s in _LEAVES.items()}
            for _ in range(n)]


# ---------------------------------------------------------------------------
# The helpers, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [256, 64])
@pytest.mark.parametrize("shape", [(5,), (256,), (300,), (7, 45),
                                   (3, 4, 33)])
def test_quantize_matches_reference(shape, block):
    x = (np.random.default_rng(len(shape) + block).standard_normal(shape)
         * 3.0).astype(np.float32)
    x.flat[0] = 0.0
    want = jax.jit(jcp.quantize_int8, static_argnums=1)(jnp.asarray(x),
                                                         block)
    got = CP.quantize_int8(torch.as_tensor(x), block)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(
        CP.dequantize_int8(got, shape).numpy(),
        np.asarray(jcp.dequantize_int8(want, shape)))
    assert CP.compression_ratio(torch.as_tensor(x), block) \
        == jcp.compression_ratio(jnp.asarray(x), block)


def test_zero_block_and_ratio():
    """An all-zero block keeps the 1e-12 floor (no division by zero), and
    a real gradient leaf compresses more than 3.5x (the reference's
    bound)."""
    qt = CP.quantize_int8(torch.zeros(300))
    assert torch.all(qt.scale == torch.tensor(1e-12))
    assert not torch.any(qt.q)
    assert CP.compression_ratio(torch.zeros(4096)) > 3.5


def test_error_feedback_matches_reference():
    """20 steps of the host-side residual on a two-leaf tree: the payloads,
    the dequantized values and the residual equal the reference's
    exactly, and the residual never exceeds half a quantization step."""
    jef, tef = jcp.ErrorFeedback(), CP.ErrorFeedback()
    for step in range(20):
        g = _grads(100 + step, 1)[0]
        jq, jd = jef.compress({k: jnp.asarray(v) for k, v in g.items()})
        tq, td = tef.compress({k: torch.as_tensor(v) for k, v in g.items()})
        for k in _LEAVES:
            np.testing.assert_array_equal(tq[k].q.numpy(),
                                          np.asarray(jq[k].q))
            np.testing.assert_array_equal(tq[k].scale.numpy(),
                                          np.asarray(jq[k].scale))
            np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
            np.testing.assert_array_equal(tef.residual[k].numpy(),
                                          np.asarray(jef.residual[k]))
            step_size = tq[k].scale.max()
            assert float(tef.residual[k].abs().max()) \
                <= 0.5 * float(step_size) * (1 + 1e-6)


# ---------------------------------------------------------------------------
# The wire and the int8 epochs against the reference (one subprocess)
# ---------------------------------------------------------------------------

_REFERENCE = """
    import sys, time
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    sys.path.insert(0, {tests!r})
    from _torch_parity import np_autoencoder_params
    from repro.core import TableSpec
    from repro.core import store as S
    from repro.ml import autoencoder as ae, trainer as tr
    from repro.parallel import compress as cp
    from repro.train import optimizer as opt

    inputs = dict(np.load({inputs!r}))
    out = {{}}
    t0 = time.perf_counter()
    # the wire over 2 and 4 ranks, the residuals carried for EF_STEPS
    for n in {ranks!r}:
        mesh = Mesh(np.array(jax.devices()[:n]), ("data",))

        def body(g, r, n=n):
            # both forms in one program: one compile a rank count
            g = jax.tree.map(lambda x: x[0], g)
            r = jax.tree.map(lambda x: x[0], r)
            plain = cp.compressed_psum_mean(g, "data", n)
            m, nr = cp.compressed_psum_mean_ef(g, r, "data", n)
            return plain, m, jax.tree.map(lambda x: x[None], nr)

        fn = jax.jit(shard_map(body, mesh=mesh,
                               in_specs=(P("data"), P("data")),
                               out_specs=(P(), P(), P("data")),
                               check_rep=False))
        resid = {{k: jnp.zeros((n, *s)) for k, s in {leaves!r}.items()}}
        for step in range({ef_steps}):
            g = {{k: jnp.asarray(inputs[f"g{{n}}_{{step}}_{{k}}"])
                 for k in {leaves!r}}}
            plain, mean, resid = fn(g, resid)
            for k in {leaves!r}:
                out[f"mean{{n}}_0_{{step}}_{{k}}"] = np.asarray(plain[k])
                out[f"mean{{n}}_1_{{step}}_{{k}}"] = np.asarray(mean[k])
                out[f"resid{{n}}_1_{{step}}_{{k}}"] = np.asarray(resid[k])
    # the standalone wrapper, over the 4 ranks
    stack = {{k: jnp.asarray(inputs[f"g4_0_{{k}}"]) for k in {leaves!r}}}
    red = cp.compressed_allreduce(stack, mesh)
    for k in {leaves!r}:
        out[f"allreduce4_{{k}}"] = np.asarray(red[k])
    out["wire_s"] = np.array(time.perf_counter() - t0)

    # the int8 epochs at mesh 2
    N, CAP, GATHER, EPOCHS = {N}, {CAP}, {GATHER}, {EPOCHS}
    aecfg = ae.AEConfig(**{ae!r})
    levels = ae.coords_pyramid(aecfg, jnp.asarray(inputs["coords"]))
    spec = TableSpec("field", shape=(4, N), capacity=CAP)
    st = S.init_table(spec)
    for i, snap in enumerate(inputs["snaps"]):
        st = S.put(spec, st, S.make_key(0, i), jnp.asarray(snap))
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    tx = opt.adam(1e-3)
    params = jax.tree.map(jnp.asarray, np_autoencoder_params(aecfg, {seed}))
    state0 = tr.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    mu, sd = jnp.asarray(inputs["mu"]), jnp.asarray(inputs["sd"])
    for ef in (False, True):
        cfg = tr.TrainerConfig(ae=aecfg, gather=GATHER, batch_size={batch},
                               lr=1e-3, mesh=mesh, ddp="int8",
                               ddp_error_feedback=ef)
        epoch = tr.make_sharded_fused_epoch(cfg, levels, tx, spec)
        state = state0
        for e in range(EPOCHS):
            state, m = epoch(st, state, jax.random.key(7 + e), mu, sd)
            out[f"ef{{int(ef)}}/metrics{{e}}"] = np.array([float(x)
                                                          for x in m[:3]])
        for i, leaf in enumerate(jax.tree.leaves(state.params)):
            out[f"ef{{int(ef)}}/param{{i}}"] = np.asarray(leaf)
    nvalid = jnp.maximum(jnp.sum((st.version > 0).astype(jnp.int32)), 1)
    out["nvalid"] = np.array(int(nvalid))
    for e in range(EPOCHS):
        k_samp, k_val, k_perm = jax.random.split(jax.random.key(7 + e), 3)
        out[f"ranks{{e}}"] = np.asarray(
            jax.random.randint(k_samp, (GATHER,), 0, nvalid))
        out[f"val_idx{{e}}"] = np.asarray(
            jax.random.randint(k_val, (), 0, GATHER))
        out[f"perm{{e}}"] = np.asarray(
            jax.random.permutation(k_perm, GATHER - 1))
    np.savez({result!r}, **out)
"""


def _snaps() -> np.ndarray:
    return np.random.default_rng(SEED).standard_normal(
        (PUTS, 4, N)).astype(np.float32)


def _coords() -> np.ndarray:
    return np.random.default_rng(1).random((N, 3)).astype(np.float32)


def _mu_sd(snaps):
    return (snaps.mean(axis=(0, 2)).astype(np.float32),
            (snaps.std(axis=(0, 2)) + 1e-6).astype(np.float32))


def _wire_inputs() -> dict:
    """Per step and rank count, the ranks' gradients stacked per leaf."""
    out = {}
    for n in RANKS:
        for step in range(EF_STEPS):
            trees = _grads(10 * n + step, n)
            for k in _LEAVES:
                out[f"g{n}_{step}_{k}"] = np.stack([t[k] for t in trees])
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compress")
    snaps = _snaps()
    mu, sd = _mu_sd(snaps)
    wire = _wire_inputs()
    np.savez(tmp / "inputs.npz", snaps=snaps, coords=_coords(), mu=mu, sd=sd,
             **wire)
    t0 = time.perf_counter()
    run_subprocess(_REFERENCE.format(
        tests=str(TESTS), inputs=str(tmp / "inputs.npz"),
        result=str(tmp / "result.npz"), ranks=RANKS, leaves=_LEAVES,
        ef_steps=EF_STEPS, N=N, CAP=CAP, GATHER=GATHER, EPOCHS=EPOCHS,
        ae=_AE, seed=SEED, batch=BATCH), n_devices=4)
    print("WIRE_S", float(np.load(tmp / "result.npz")["wire_s"]))
    return (dict(np.load(tmp / "result.npz")), time.perf_counter() - t0,
            snaps, mu, sd, wire)


def _tree(stack: dict, rank: int, step: int, n: int) -> dict:
    return {k: torch.as_tensor(stack[f"g{n}_{step}_{k}"][rank])
            for k in _LEAVES}


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("n", RANKS)
def test_wire_matches_reference(reference, n, ef, record_property):
    ref, seconds, *_, wire = reference
    record_property("reference_subprocess_s", seconds)
    mesh = data_mesh(n, devices=["cpu"] * n)
    resid = [{k: torch.zeros(s) for k, s in _LEAVES.items()}
             for _ in range(n)]
    # exact at 2 ranks; at 4 the scales' sum runs in another order
    rtol = 0.0 if n == 2 else 2.4e-7
    for step in range(EF_STEPS):
        grads = [_tree(wire, r, step, n) for r in range(n)]
        if ef and step:
            # each step starts from the reference's carried residuals, so
            # a step's last-bit difference does not feed the next
            resid = [{k: torch.as_tensor(ref[f"resid{n}_1_{step - 1}_{k}"][r])
                      for k in _LEAVES} for r in range(n)]
        prev = resid
        with C.counted() as calls:
            if ef:
                mean, resid = CP.compressed_psum_mean_ef(grads, resid, mesh)
            else:
                mean = CP.compressed_psum_mean(grads, mesh)
        assert calls["all_reduce"] == 2        # payload tree, scale tree
        for k in _LEAVES:
            want = ref[f"mean{n}_{int(ef)}_{step}_{k}"]
            np.testing.assert_allclose(mean[torch.device("cpu")][k].numpy(),
                                       want, rtol=rtol, atol=0)
            if ef:
                # the reference's fused epoch computes the residual's scale
                # as amax * (1/127) where its wire divides by 127: one ulp
                # of the scale times |q| <= (|comp| + scale) * 2^-23
                got = np.stack([r[k].numpy() for r in resid])
                comp = [g[k] + r[k] for g, r in zip(grads, prev)]
                scale = np.stack([np.repeat(
                    CP.quantize_int8(c).scale.numpy().ravel(), 256)[
                        :c.numel()].reshape(c.shape) for c in comp])
                bound = 2.0 ** -22 * (np.abs(np.stack(comp)) + scale)
                np.testing.assert_array_less(
                    np.abs(got - ref[f"resid{n}_1_{step}_{k}"]), bound)
    if n == 4 and not ef:
        stack = {k: torch.as_tensor(wire[f"g{n}_0_{k}"]) for k in _LEAVES}
        red = CP.compressed_allreduce(stack, mesh)[torch.device("cpu")]
        for k in _LEAVES:
            np.testing.assert_allclose(red[k].numpy(),
                                       ref[f"allreduce{n}_{k}"], rtol=rtol)


def _draws(ref) -> list:
    nvalid = int(ref["nvalid"])
    return [ttr.EpochDraws(
        torch.as_tensor(uniforms_for_ranks(ref[f"ranks{e}"], nvalid)),
        torch.as_tensor(ref[f"val_idx{e}"]), torch.as_tensor(ref[f"perm{e}"]))
        for e in range(EPOCHS)]


def _table(spec, snaps, placement=None):
    table = TS.init_table(spec, placement, device="cpu")
    for i, snap in enumerate(snaps):
        table = TS.put(spec, table, TS.make_key(0, i), snap)
    return table


def _port_epochs(tier, ddp, ef, snaps, mu, sd, draws, jcfg, D=2):
    mesh = data_mesh(D, devices=["cpu"] * D)
    spec = TS.TableSpec("field", shape=(4, N), capacity=CAP)
    cfg_ae = torch_ae_config(jcfg)
    slab = tier != "sharded_fused"
    cfg = ttr.TrainerConfig(ae=cfg_ae, gather=GATHER, batch_size=BATCH,
                            lr=1e-3, mesh=mesh, slab_sharded=slab, ddp=ddp,
                            ddp_error_feedback=ef)
    tx = topt.adam(cfg.scaled_lr)
    levels = tae.coords_pyramid(cfg_ae, torch.as_tensor(_coords()))
    state = ttr.train_state_from_numpy(np_autoencoder_params(jcfg, SEED),
                                       device="cpu")
    mu, sd = torch.as_tensor(mu), torch.as_tensor(sd)
    metrics = []
    if tier == "slab_sharded_clustered":
        # a 2 + 2 clustered split: the table slot-cut over the db ranks
        d = dep.make_clustered_1d(db_fraction=0.5, devices=["cpu"] * 4,
                                  slab_axis="data")
        srv = TServer(deployment=d, device="cpu")
        srv.create_table(spec)
        client = TClient(srv)
        for i, snap in enumerate(snaps):
            client.put_kv("field", TS.make_key(0, i), torch.as_tensor(snap))
        cfg = ttr.TrainerConfig(ae=cfg_ae, gather=GATHER, batch_size=BATCH,
                                lr=1e-3, mesh=d.client_mesh,
                                slab_sharded=True, db_mesh=d.db_mesh,
                                db_axis="data", ddp=ddp,
                                ddp_error_feedback=ef)
        epoch = ttr.make_clustered_sharded_epoch(cfg, levels, tx, spec)
        for dr in draws:
            state, m = epoch(client, state, dr, mu, sd)
            metrics.append([float(x) for x in m[:3]])
        return state, metrics
    table = _table(spec, torch.as_tensor(snaps),
                   slab_sharding(spec, mesh) if slab else None)
    epoch = ttr.EPOCH_BUILDERS[tier](cfg, levels, tx, spec)
    for dr in draws:
        with C.counted() as calls:
            state, m = epoch(table, state, dr, mu, sd)
        metrics.append([float(x) for x in m[:3]])
    micro = -(-(GATHER - 1) // BATCH)
    assert calls["all_reduce"] == tplan.ddp_all_reduces(ddp, micro) + slab
    return state, metrics


def _leaves(tree) -> list:
    """Leaves with dict keys sorted (``jax.tree.leaves``' order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _outside(state, ref, ef) -> tuple[int, float]:
    """How many parameter elements lie outside the mesh tolerances of
    ``tests/test_sharded_epoch.py:62-65`` (rtol 2e-5, atol 1e-6) from the
    reference's int8 run with feedback ``ef``, and the largest deviation."""
    n, worst = 0, 0.0
    for i, g in enumerate(_leaves(state.params)):
        want = ref[f"ef{int(ef)}/param{i}"]
        dev = np.abs(g.numpy() - want)
        n += int(np.sum(dev > 1e-6 + 2e-5 * np.abs(want)))
        worst = max(worst, float(dev.max()))
    return n, worst


def _residual_never_reset(mp):
    """Patch the wire so a run's residual is carried into the next epoch
    where the trainer starts it from zeros (a control)."""
    wire = CP.compressed_psum_mean_ef
    carried = []

    def leaky(local, resid, mesh):
        mean, new = wire(local, carried[-1] if carried else resid, mesh)
        carried.append(new)
        return mean, new

    mp.setattr(CP, "compressed_psum_mean_ef", leaky)


@pytest.mark.parametrize("ef", [False, True])
def test_int8_epochs_match_reference(reference, ef, record_property):
    """The port's int8 epochs at mesh 2 against the reference's: losses
    within 1e-5 relative and every parameter element within the mesh
    tolerances.  The same check fails for the exact psum run in place of
    the int8 wire, for the other feedback setting and, with feedback, for
    a residual carried across the epochs."""
    ref, _, snaps, mu, sd, _ = reference
    jcfg = jae.AEConfig(**_AE)
    state, metrics = _port_epochs("sharded_fused", "int8", ef, snaps, mu, sd,
                                  _draws(ref), jcfg)
    worst = 0.0
    for e, m in enumerate(metrics):
        want = ref[f"ef{int(ef)}/metrics{e}"]
        np.testing.assert_allclose(m, want, rtol=1e-5)
        worst = max(worst, float(np.max(np.abs(np.array(m) - want)
                                        / np.abs(want))))
    record_property("max_rel_loss_deviation", worst)
    assert len(_leaves(state.params)) \
        == sum(k.startswith(f"ef{int(ef)}/param") for k in ref)
    n_out, dev = _outside(state, ref, ef)
    record_property("max_abs_param_deviation", dev)
    assert n_out == 0, f"{n_out} parameter elements outside the tolerance"
    assert int(state.step) == EPOCHS * 2
    controls = {"psum": ("psum", ef), "feedback": ("int8", not ef)}
    if ef:
        controls["never_reset"] = ("int8", True)
    for name, (ddp, fb) in controls.items():
        with pytest.MonkeyPatch.context() as mp:
            if name == "never_reset":
                _residual_never_reset(mp)
            wrong, _ = _port_epochs("sharded_fused", ddp, fb, snaps, mu, sd,
                                    _draws(ref), jcfg)
        n_out, dev = _outside(wrong, ref, ef)
        record_property(f"control_{name}_outside", n_out)
        assert n_out > 0, f"control {name} passes the parameter check"


def test_int8_tiers_agree_and_feedback_matters(reference):
    """In the port: ``slab_sharded`` and ``slab_sharded_clustered`` with
    ``ddp="int8"`` equal ``sharded_fused`` bit for bit; feedback changes
    the params; a rerun is bit-identical; the first epoch's loss is within
    2% of the exact psum's (the reference's limit)."""
    ref, _, snaps, mu, sd, _ = reference
    jcfg = jae.AEConfig(**_AE)
    draws = _draws(ref)
    runs = {}
    for key in (("sharded_fused", "int8", True), ("slab_sharded", "int8",
                                                  True),
                ("slab_sharded_clustered", "int8", True),
                ("sharded_fused", "int8", False),
                ("sharded_fused", "psum", False)):
        runs[key] = _port_epochs(*key, snaps, mu, sd, draws, jcfg)
    base = runs[("sharded_fused", "int8", True)]
    again = _port_epochs("sharded_fused", "int8", True, snaps, mu, sd, draws,
                         jcfg)
    for other in (runs[("slab_sharded", "int8", True)],
                  runs[("slab_sharded_clustered", "int8", True)], again):
        assert all(torch.equal(a, b) for a, b in
                   zip(_leaves(base[0].params), _leaves(other[0].params)))
        assert base[1] == other[1]
    assert any(not torch.equal(a, b) for a, b in zip(
        _leaves(base[0].params),
        _leaves(runs[("sharded_fused", "int8", False)][0].params)))
    exact = runs[("sharded_fused", "psum", False)][1][0][0]
    for key in (("sharded_fused", "int8", True),
                ("sharded_fused", "int8", False)):
        assert abs(runs[key][1][0][0] - exact) <= 0.02 * abs(exact)
