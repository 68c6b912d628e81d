"""Port parity for the mesh tiers' collective accounting,
``InSituSession.plan(hlo=True)``.

The reference compiles one epoch of each trainer tier and counts the
collective ops in its HLO; the port counts the ``parallel.collectives``
calls one epoch makes (``collectives.counted``), on a throwaway table
placed like the live one, under the same five op names.  Two sessions,
declared alike in both packages on a 2-rank mesh (the reference in ONE
subprocess with two forced host devices; the port on ``["cpu"] * 2``):

* replicated — a ``sharded_fused``, a ``fused`` and a ``per_verb``
  trainer on a whole table;
* sharded — a ``slab_sharded`` trainer (which splits the table over its
  mesh) and a ``sharded_fused`` trainer on that table.

Checks: every entry's ``explain()["predicted_collectives"]`` equals the
reference's; where the reference's compiled epoch has an op, the port's
epoch makes it too, and where it has none, neither does the port's; every
port entry passes ``check_collectives()`` — ``fused`` and ``per_verb``
make none, ``sharded_fused`` all-reduces (and all-gathers a split
table), ``slab_sharded`` all-reduces and never all-gathers.  As a control
that must fail, ``slab_sharded``'s prediction held against
``sharded_fused``'s measured counts on the split table raises.
"""

import dataclasses
import json
import time

import pytest

from conftest import run_subprocess
from repro.insitu import plan as jplan


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file, and
    torch takes seconds to import."""
    global torch, TS, TSession, TProducer, TTrainer, tae, ttr, tplan, C
    global data_mesh
    import torch
    from repro_torch.core import store as TS
    from repro_torch.insitu import InSituSession as TSession
    from repro_torch.insitu import Producer as TProducer
    from repro_torch.insitu import TrainerConsumer as TTrainer
    from repro_torch.insitu import plan as tplan
    from repro_torch.ml import autoencoder as tae
    from repro_torch.ml import trainer as ttr
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import data_mesh
    torch.set_num_threads(1)


_TINY = dict(n_points=64, channels=4, internal=4, latent=4, blocks=2,
             pool=4, mlp_width=8, mlp_depth=2)
CAP, GATHER, BATCH = 16, 6, 4
#: each session's trainers: (tier, mesh, slab_sharded, fused)
SESSIONS = {
    "replicated": (("sharded_fused", True, False, True),
                   ("fused", False, False, True),
                   ("per_verb", False, False, False)),
    "sharded": (("slab_sharded", True, True, True),
                ("sharded_fused", True, False, True)),
}

_REFERENCE = """
import json
import jax, jax.numpy as jnp
from repro.core import TableSpec
from repro.core import store as S
from repro.insitu import InSituSession, Producer, TrainerConsumer
from repro.ml import autoencoder as ae, trainer as tr
from repro.parallel.sharding import data_mesh

tiny = ae.AEConfig(mode="ref", **{tiny!r})
mesh = data_mesh(2)
out = {{}}
for name, trainers in {sessions!r}.items():
    comps = [Producer(lambda c, r, t: (c, S.make_key(r, t),
                                       jnp.zeros((4, 64))),
                      table="field", steps=4, carry=jnp.zeros(()))]
    for tier, on_mesh, slab, fused in trainers:
        comps.append(TrainerConsumer(
            tr.TrainerConfig(ae=tiny, epochs=1, gather={gather},
                             batch_size={batch}, fused=fused,
                             mesh=mesh if on_mesh else None,
                             slab_sharded=slab),
            jnp.zeros((64, 3)), tier=tier, name=tier))
    sess = InSituSession(tables=[TableSpec("field", shape=(4, 64),
                                           capacity={cap})],
                         components=comps)
    plan = sess.plan(hlo=True)
    out[name] = {{c.name: c.explain() for c in plan.components
                 if c.kind == "trainer"}}
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    t0 = time.perf_counter()
    stdout = run_subprocess(_REFERENCE.format(
        tiny=_TINY, sessions=SESSIONS, gather=GATHER, batch=BATCH, cap=CAP),
        n_devices=2)
    line = [x for x in stdout.splitlines() if x.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):]), time.perf_counter() - t0


def _port_plan(name: str):
    mesh = data_mesh(2, devices=["cpu"] * 2)
    cfg_ae = tae.AEConfig(**_TINY)
    comps = [TProducer(lambda c, r, t: (c, TS.make_key(r, t),
                                        torch.zeros((4, 64))),
                       table="field", steps=4, carry=torch.zeros(()))]
    for tier, on_mesh, slab, fused in SESSIONS[name]:
        comps.append(TTrainer(
            ttr.TrainerConfig(ae=cfg_ae, epochs=1, gather=GATHER,
                              batch_size=BATCH, fused=fused,
                              mesh=mesh if on_mesh else None,
                              slab_sharded=slab),
            torch.zeros((64, 3)), tier=tier, name=tier))
    sess = TSession(tables=[TS.TableSpec("field", shape=(4, 64),
                                         capacity=CAP)],
                    components=comps, device="cpu")
    return sess.plan(hlo=True)


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_collectives_match_reference(reference, name, record_property):
    ref, seconds = reference
    record_property("reference_subprocess_s", seconds)
    plan = _port_plan(name)
    got = {c.name: c for c in plan.components if c.kind == "trainer"}
    assert set(got) == set(ref[name])
    for tier, want in ref[name].items():
        entry = got[tier]
        mine = entry.explain()
        assert mine.get("predicted_collectives") \
            == want.get("predicted_collectives"), tier
        entry.check_collectives()
        for op in tplan.COLLECTIVE_OPS:
            assert bool(dict(entry.collectives)[op]) \
                == bool(want["collectives"][op]), (tier, op, entry.collectives,
                                                    want["collectives"])


def test_trainer_predictions_match_reference():
    """The prediction rule itself, every tier × placement."""
    for tier in ("per_verb", "fused", "sharded_fused", "slab_sharded"):
        for sharded in (False, True):
            assert tplan.trainer_collective_prediction(tier, sharded) \
                == jplan.trainer_collective_prediction(tier, sharded)
    assert tplan.COLLECTIVE_OPS == jplan.COLLECTIVE_OPS
    assert tplan.COLLECTIVE_FREE == jplan.COLLECTIVE_FREE


def test_wrong_prediction_fails_the_check():
    """The control: ``slab_sharded``'s prediction (no all-gather) against
    ``sharded_fused``'s measured counts on the split table raises; and the
    measured counts are the epoch's calls (one all-gather on entry)."""
    plan = _port_plan("sharded")
    slab, sf = plan.component("slab_sharded"), plan.component("sharded_fused")
    assert dict(sf.collectives)["all-gather"] == 1
    assert dict(slab.collectives)["all-gather"] == 0
    n_batches = -(-(GATHER - 1) // BATCH)
    assert dict(slab.collectives)["all-reduce"] == 1 + 2 * n_batches
    with pytest.raises(AssertionError, match="all-gather"):
        dataclasses.replace(slab, collectives=sf.collectives) \
            .check_collectives()
    # plan(hlo=True) measures at plan time and leaves the counters running
    before = dict(C.COUNTS)
    assert _port_plan("replicated").component("per_verb").collectives \
        == tuple((op, 0) for op in tplan.COLLECTIVE_OPS)
    assert C.COUNTS["all_reduce"] > before["all_reduce"]
