"""Port parity for checkpoints (``train/checkpoint.py``).

* Durable checkpoints cross the packages both ways: the reference's
  ``save`` of a train state restores in the port's ``restore``, and the
  port's ``save`` restores in the reference's, with every leaf equal —
  for the Phi-4-mini smoke config's LM train state (params, AdamW
  moments, steps; fp32), the Nemotron-4 smoke config's (params,
  Adafactor's row and column moments, steps) and the in-situ
  autoencoder's.  The manifests
  name the same leaves with the same shapes and dtypes.
* bf16 leaves: the port writes them as the reference's numpy does (two-
  byte void records, dtype ``bfloat16``) and reads a bf16 checkpoint the
  reference wrote, bit for bit (the reference cannot read one back: its
  ``jnp.asarray`` has no cast from the void records).
* Retention keeps the ``keep`` newest steps, as the reference's does;
  ``Checkpointer`` saves on its interval from a device copy, so a write
  to the state after ``maybe_save`` never reaches the file.
* ``MemoryCheckpoint`` clones every tensor leaf and moves no store
  counter.
* ``launch.train.run(..., ckpt_dir=..., resume=True)`` on the CPU at the
  smoke config: 4 steps saving every 2, then a run resumed from step 2
  gives steps 3–4 bit for bit (losses, grad norms, every state leaf).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import np_autoencoder_params
from repro.configs import get_smoke_config as jget_smoke
from repro.launch.steps import model_specs as jmodel_specs
from repro.ml import autoencoder as jae
from repro.ml import trainer as jtr
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train.train_state import init_train_state as jinit_train_state
from repro.train.train_state import make_tx as jmake_tx


def setup_module():
    """Import torch and the port when this file's tests start, not at
    collection: every xdist worker collects every test file, and
    torch takes seconds to import."""
    global torch, tckpt, tcfgs, tsteps, tstate, ttrain, ttr, TServer
    global tree_leaves, tree_map
    import torch
    from repro_torch import configs as tcfgs
    from repro_torch.core import StoreServer as TServer
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch import train as ttrain
    from repro_torch.ml import trainer as ttr
    from repro_torch.train import checkpoint as tckpt
    from repro_torch.train import train_state as tstate
    from repro_torch.tree import tree_leaves, tree_map
    torch.set_num_threads(1)


PHI4, NEMOTRON = "phi4_mini_3_8b", "nemotron_4_340b"


def _flat_jax(tree) -> dict:
    flat, _ = jckpt._flatten_with_paths(tree)
    return {k: np.asarray(v) for k, v in flat}


def _flat_torch(tree) -> dict:
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in tckpt._flatten_with_paths(tree)}


def _lm_states(arch=PHI4):
    """The smoke config's LM train state in each package: the reference's
    from its own init (its optimizer state is zeros), the port's as the
    ``like`` tree (a different seed, so a restore has to move every
    leaf)."""
    jcfg = jget_smoke(arch)
    jstate = jinit_train_state(jax.random.key(1), jcfg, jmodel_specs(jcfg),
                               jmake_tx(jcfg, total_steps=10))
    # non-zero moments and step, so every leaf carries information
    jstate = jstate._replace(
        opt_state=jax.tree.map(lambda x: x + 0.25 if x.dtype != jnp.int32
                               else x + 3, jstate.opt_state),
        step=jnp.int32(3))
    tcfg = tcfgs.get_smoke_config(arch)
    tlike = tstate.init_train_state(torch.Generator().manual_seed(2), tcfg,
                                    tsteps.model_specs(tcfg),
                                    tstate.make_tx(tcfg, total_steps=10),
                                    device="cpu")
    return jstate, tlike


def _ae_states():
    jcfg = jae.AEConfig(n_points=32, mode="ref", latent=4, internal=4,
                        blocks=1, mlp_width=8, mlp_depth=2)
    params = np_autoencoder_params(jcfg, seed=4)
    tx = jopt.adam(1e-3)
    p = jax.tree.map(jnp.asarray, params)
    jstate = jtr.TrainState(p, jax.tree.map(
        lambda x: x + 0.5 if x.dtype != jnp.int32 else x + 7, tx.init(p)),
        jnp.int32(7))
    tlike = ttr.train_state_from_numpy(np_autoencoder_params(jcfg, seed=5),
                                       device="cpu")
    return jstate, tlike


STATES = {"lm": _lm_states, "lm_adafactor": lambda: _lm_states(NEMOTRON),
          "autoencoder": _ae_states}


@pytest.mark.parametrize("states", STATES)
def test_reference_save_restores_in_the_port(states, tmp_path):
    jstate, tlike = STATES[states]()
    jckpt.save(tmp_path, 3, jstate)
    got = tckpt.restore(tmp_path, tlike)
    want = _flat_jax(jstate)
    have = _flat_torch(got)
    assert set(have) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(have[k], v, err_msg=k)
    # restored leaves keep the like tree's dtypes: they are the like
    # tree's own tensors, written in place
    for a, b in zip(tree_leaves(got), tree_leaves(tlike)):
        assert a.dtype == b.dtype and a is b


@pytest.mark.parametrize("states", STATES)
def test_port_save_restores_in_the_reference(states, tmp_path):
    jlike, tstate_ = STATES[states]()
    tckpt.save(tmp_path / "t", 5, tstate_)
    jckpt.save(tmp_path / "j", 5, jlike)
    got = jckpt.restore(tmp_path / "t", jlike)
    want = _flat_torch(tstate_)
    have = _flat_jax(got)
    assert set(have) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(have[k], v, err_msg=k)
    # the two packages write the same manifest: the same leaves, in the
    # same files, with the same shapes and dtypes
    import json

    def manifest(root):
        return json.loads((root / "step_0000000005" / "manifest.json")
                          .read_text())
    assert manifest(tmp_path / "t") == manifest(tmp_path / "j")


def test_bf16_leaves_cross_bit_for_bit(tmp_path):
    vals = np.random.default_rng(0).standard_normal(37).astype(np.float32)
    jtree = {"w": jnp.asarray(vals, jnp.bfloat16), "n": jnp.int32(4)}
    jckpt.save(tmp_path / "j", 1, jtree)
    like = {"w": torch.zeros(37, dtype=torch.bfloat16),
            "n": torch.zeros((), dtype=torch.int32)}
    got = tckpt.restore(tmp_path / "j", like)
    assert got["w"].dtype == torch.bfloat16 and int(got["n"]) == 4
    np.testing.assert_array_equal(
        got["w"].view(torch.int16).numpy(),
        np.asarray(jtree["w"]).view(np.int16))
    tckpt.save(tmp_path / "t", 1, got)
    for name in ("leaf_00000.npy", "leaf_00001.npy"):
        a = (tmp_path / "t" / "step_0000000001" / name).read_bytes()
        b = (tmp_path / "j" / "step_0000000001" / name).read_bytes()
        assert a == b, name
    again = tckpt.restore(tmp_path / "t", like)
    assert torch.equal(again["w"], got["w"])


def test_retention_and_latest_step(tmp_path):
    tree = {"x": torch.arange(3.0)}
    for step in range(1, 6):
        tckpt.save(tmp_path / "t", step, tree, keep=2)
        jckpt.save(tmp_path / "j", step, {"x": jnp.arange(3.0)}, keep=2)
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir()) \
        == ["step_0000000004", "step_0000000005"]
    assert tckpt.latest_step(tmp_path / "t") == 5 \
        == jckpt.latest_step(tmp_path / "t")
    assert tckpt.latest_step(tmp_path / "empty") is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore(tmp_path / "empty", tree)
    with pytest.raises(KeyError, match="y"):
        tckpt.restore(tmp_path / "t", {"y": torch.zeros(3)})


def test_checkpointer_saves_a_copy(tmp_path):
    """``maybe_save`` on its interval; an in-place write right after it
    never reaches the file, and ``save_async`` likewise."""
    ck = tckpt.Checkpointer(tmp_path, interval_steps=2, keep=5)
    state = {"w": torch.zeros(1000)}
    saved = []
    for step in range(1, 6):
        if ck.maybe_save(step, state):
            saved.append(step)
        state["w"].add_(1.0)                 # the next step, in place
    ck.maybe_save(6, state, force=True)
    ck.wait()
    assert saved == [2, 4] and ck.saves == 3 and not ck.errors
    for step, value in ((2, 1.0), (4, 3.0), (6, 5.0)):
        got = tckpt.restore(tmp_path, {"w": torch.empty(1000)}, step=step)
        assert torch.equal(got["w"], torch.full((1000,), value)), step
    thread = tckpt.save_async(tmp_path / "a", 1, state)
    state["w"].zero_()
    thread.join()
    got = tckpt.restore(tmp_path / "a", {"w": torch.empty(1000)})
    assert torch.equal(got["w"], torch.full((1000,), 5.0))


def test_memory_checkpoint_clones_and_counts_nothing():
    srv = TServer(device="cpu")
    mem = tckpt.MemoryCheckpoint(srv, key="trainer")
    assert mem.restore() is None
    state = {"state": {"w": torch.ones(4)}, "cursor": 2, "tag": "x"}
    mem.save(1, state)
    state["state"]["w"].mul_(3.0)               # an in-place update
    step, got = mem.restore()
    assert step == 1 and got["cursor"] == 2 and got["tag"] == "x"
    assert torch.equal(got["state"]["w"], torch.ones(4))
    assert srv.stats()["op_count"] == 0
    # namespaced: another key parks its own state
    assert tckpt.MemoryCheckpoint(srv, key="other").restore() is None


def test_launcher_resumes_bit_identically(tmp_path):
    """4 steps saving every 2; then, from step 2 (the step-4 checkpoint
    removed), the resumed steps 3–4 equal the uninterrupted run's."""
    kw = dict(steps=4, batch=2, seq_len=32, smoke=True, device="cpu",
              log_every=100, ckpt_every=2)
    full = ttrain.run(PHI4, ckpt_dir=str(tmp_path), **kw)
    assert tckpt.latest_step(tmp_path) == 4
    import shutil
    shutil.rmtree(tmp_path / "step_0000000004")
    resumed = ttrain.run(PHI4, ckpt_dir=str(tmp_path), resume=True, **kw)
    assert resumed.start == 2 and full.start == 0
    assert resumed.losses == full.losses[2:]
    assert resumed.grad_norms == full.grad_norms[2:]
    assert int(resumed.state.step) == int(full.state.step) == 4
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(full.state), tree_leaves(resumed.state)))
    # the resumed run saved its own step 4: it restores to its state
    # (into zeroed tensors, since a restore writes its like tree in place)
    got = tckpt.restore(tmp_path, tree_map(torch.zeros_like, resumed.state))
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(got), tree_leaves(resumed.state)))


def test_checkpointer_stages_into_reused_host_buffers(tmp_path):
    """A save taken before an in-place update writes the pre-update
    values, from host buffers allocated at the first save and reused by
    the next (a new layout gets new ones); ``restore`` writes into its
    ``like`` tree in place and refuses a leaf of another shape."""
    ck = tckpt.Checkpointer(tmp_path, interval_steps=1, keep=5)
    state = {"w": torch.arange(6.0).reshape(2, 3),
             "m": {"b": torch.ones(4, dtype=torch.bfloat16)},
             "step": torch.zeros((), dtype=torch.int32)}
    ck.maybe_save(1, state)
    stage, arena = ck._stage, ck._stage.arena.data_ptr()
    for leaf in tree_leaves(state):
        leaf.add_(1)                          # the next step, in place
    ck.maybe_save(2, state)
    assert ck._stage is stage and ck._stage.arena.data_ptr() == arena
    state["w"].mul_(10)
    ck.wait()
    like = tree_map(torch.zeros_like, state)
    got = tckpt.restore(tmp_path, like, step=1)
    assert got["w"] is like["w"] and got["m"]["b"] is like["m"]["b"]
    assert torch.equal(like["w"], torch.arange(6.0).reshape(2, 3))
    assert torch.equal(like["m"]["b"], torch.ones(4, dtype=torch.bfloat16))
    tckpt.restore(tmp_path, like, step=2)
    assert torch.equal(like["w"], torch.arange(1.0, 7.0).reshape(2, 3))
    assert int(like["step"]) == 1
    ck.maybe_save(3, {"w": torch.zeros(5)})    # another layout
    assert ck._stage is not stage
    ck.close()
    assert ck._stage is None and ck.saves == 3 and not ck.errors
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(tmp_path, {"w": torch.zeros(6)}, step=3)
