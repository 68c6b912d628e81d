"""The port's public signatures and accessors against the reference's.

* ``InSituSession.run``, ``StoreServer.__init__``,
  ``StoreServer.set_model`` and ``launch.train.run`` take the reference's
  parameters in the reference's order; the port's own additions
  (``device``, ``attn_impl``) are keyword-only and come last.
* A ``SessionResult`` has the reference's ``timers``,
  ``straggler_events`` and ``client(rank)``, with the same values after
  the same small session in each package; a server has ``timers`` and
  ``table_lock``.
* The config registry resolves any id the reference's does, a module a
  caller registered in ``sys.modules`` included, and still names A7 for
  the zoo's unported ids.
* ``launch.train``'s CLI takes the reference's ``--full``.
"""

import inspect
import sys
import types

import jax.numpy as jnp
import pytest

from repro.core import StoreServer as JServer
from repro.core import TableSpec as JTableSpec
from repro.core import store as JS
from repro.core.orchestrator import StragglerPolicy as JStraggler
from repro.insitu import InSituSession as JSession
from repro.insitu import Producer as JProducer
from repro.launch import train as jtrain


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file."""
    global torch, TServer, TTableSpec, TS, TStraggler, TSession, TProducer
    global ttrain, tregistry, Timers
    import torch
    from repro_torch.configs import registry as tregistry
    from repro_torch.core import StoreServer as TServer
    from repro_torch.core import TableSpec as TTableSpec
    from repro_torch.core import Timers
    from repro_torch.core import store as TS
    from repro_torch.core.orchestrator import StragglerPolicy as TStraggler
    from repro_torch.insitu import InSituSession as TSession
    from repro_torch.insitu import Producer as TProducer
    from repro_torch.launch import train as ttrain
    torch.set_num_threads(1)


def _positional(fn) -> list[str]:
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD]


def _keyword_only(fn) -> list[str]:
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind is inspect.Parameter.KEYWORD_ONLY]


@pytest.mark.parametrize("which,extra", [
    ("InSituSession.run", []),
    ("StoreServer.__init__", ["device"]),
    ("StoreServer.set_model", []),
    ("launch.train.run", ["device", "attn_impl"]),
])
def test_signatures_follow_the_reference(which, extra):
    ref, port = {
        "InSituSession.run": (JSession.run, lambda: TSession.run),
        "StoreServer.__init__": (JServer.__init__,
                                 lambda: TServer.__init__),
        "StoreServer.set_model": (JServer.set_model,
                                  lambda: TServer.set_model),
        "launch.train.run": (jtrain.run, lambda: ttrain.run),
    }[which]
    port = port()
    assert _positional(port) == _positional(ref)
    assert _keyword_only(port) == extra


def test_server_timers_table_lock_and_jit_compile():
    timers = Timers()
    srv = TServer(None, timers, None, device="cpu")
    assert srv.timers is timers and srv.faults is None
    assert isinstance(TServer(device="cpu").timers, Timers)
    srv.create_table(TTableSpec("t", shape=(2,), capacity=4))
    with srv.table_lock("t"):
        assert srv.table_lock("t") is srv._table_locks["t"]
    srv.set_model("m", lambda p, x: x * p, 2.0, jit_compile=False)
    srv.set_model("m", lambda p, x: x * p, 3.0, True)
    assert srv.model_version("m") == 2
    assert torch.equal(srv.run_model("m", torch.ones(2)),
                       torch.full((2,), 3.0))


def _producer_session(pkg: str):
    """A per-verb producer of 3 steps (every step a straggler at a zero
    deadline) in ``pkg``."""
    if pkg == "jax":
        Session, Spec, Producer, Straggler = (JSession, JTableSpec,
                                              JProducer, JStraggler)
        zeros, key, where = jnp.zeros, JS.make_key, {}
    else:
        Session, Spec, Producer, Straggler = (TSession, TTableSpec,
                                              TProducer, TStraggler)
        zeros, key, where = torch.zeros, TS.make_key, {"device": "cpu"}

    def step(carry, rank, t):
        return carry + 1, key(rank, t), zeros((2,)) + t

    return Session(
        tables=[Spec("field", shape=(2,), capacity=4)],
        components=[Producer(step, table="field", steps=3, carry=zeros(()),
                             traceable=False, warmup=False)],
        straggler=Straggler(max_step_s=0.0), **where)


def test_session_result_members_match_the_reference():
    out = {}
    for pkg in ("jax", "torch"):
        sess = _producer_session(pkg)
        res = sess.run(sess.plan(), 60.0, True, False, None)
        assert res.ok
        client = res.client()
        out[pkg] = (
            {n: s["count"] for n, s in res.timers.summary().items()},
            res.timers is res.run.timers,
            res.straggler_events, client.rank, res.client(rank=3).rank,
            client.get_metadata("sim_done"), client.watermark("field"))
    assert out["torch"] == out["jax"]
    counts, same, stragglers, rank, rank3, done, mark = out["torch"]
    assert same and stragglers == 3 and (rank, rank3) == (99, 3)
    assert counts["equation_solution"] == counts["send"] == 3
    assert done is True and mark == 3


def test_registry_resolves_registered_modules_and_names_a7():
    mod = types.ModuleType("repro_torch.configs.starcoder2_tiny")
    mod.config = lambda: "full"
    mod.smoke_config = lambda: "smoke"
    sys.modules[mod.__name__] = mod
    try:
        assert tregistry.get_config("starcoder2_tiny") == "full"
        assert tregistry.get_smoke_config("starcoder2-tiny") == "smoke"
    finally:
        del sys.modules[mod.__name__]
    assert tregistry.get_config("phi4-mini-3.8b").name \
        == tregistry.get_config("phi4_mini_3_8b").name
    assert tregistry.get_smoke_config("nemotron_4_340b").name \
        == "nemotron-4-smoke"
    with pytest.raises(NotImplementedError, match="A7"):
        tregistry.get_smoke_config("whisper_large_v3")
    with pytest.raises(ModuleNotFoundError):
        tregistry.get_config("no_such_arch")


def test_train_cli_takes_full():
    parse = ttrain.parser().parse_args
    assert parse(["--arch", "phi4_mini_3_8b", "--full"]).smoke is False
    assert parse(["--arch", "phi4_mini_3_8b"]).smoke is False
    assert parse(["--arch", "phi4_mini_3_8b", "--smoke"]).smoke is True
    with pytest.raises(SystemExit):
        parse(["--arch", "phi4_mini_3_8b", "--smoke", "--full"])
    res = ttrain.main(["--arch", "phi4_mini_3_8b", "--smoke", "--steps",
                       "1", "--batch", "2", "--seq-len", "16",
                       "--device", "cpu"])
    assert len(res.losses) == 1
