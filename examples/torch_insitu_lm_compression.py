"""The paper's in-situ compression applied to LM hidden states, on the
PyTorch port.

Run:  PYTHONPATH=src python examples/torch_insitu_lm_compression.py \
          [--device cpu]

The twin of ``examples/insitu_lm_compression.py`` on ``repro_torch``.
The paper trains an autoencoder in situ on CFD solution states so the
simulation can store a richer (compressed) time history.  The same
machinery serves LM training telemetry: the TRAINING JOB is the producer
(final hidden states streamed to the store every few steps), and a small
MLP autoencoder is the consumer, learning a compressed representation
online.  Once trained, the registry model compresses later captures at
runtime, the producer never knowing the compressor's structure.  The
consumer's sample draws are inputs (uniforms from a seeded generator), as
everywhere in the port.
"""

import argparse
import time

import torch

from repro_torch.core import Client, InSituDriver, TableSpec
from repro_torch.core.telemetry import block_until_ready
from repro_torch.data.pipeline import TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step, model_specs
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt
from repro_torch.train.train_state import init_train_state, make_tx
from repro_torch.tree import value_and_grad

D_MODEL = 128
CAPTURE_EVERY = 2
LATENT = 16


def lm_config() -> ModelConfig:
    return ModelConfig(
        name="lm-capture-demo", n_layers=4, d_model=D_MODEL, n_heads=4,
        n_kv_heads=2, d_ff=512, vocab=2048,
        pattern=(("attn", "mlp"),), mlp_act="gelu", norm="layernorm",
        attn_chunk=128, remat=False, dtype=torch.float32)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lm-steps", type=int, default=60)
    ap.add_argument("--ae-steps", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = lm_config()
    batch, seq = 4, 64
    driver = InSituDriver(tables=[
        TableSpec("hidden", shape=(batch * seq, D_MODEL), capacity=24,
                  engine="ring"),
    ], device=dev)

    def lm_producer(client: Client, stop):
        """The LM training job doubles as the in-situ data producer."""
        tx = make_tx(cfg, total_steps=args.lm_steps)
        state = init_train_state(torch.Generator(device=dev).manual_seed(0),
                                 cfg, model_specs(cfg), tx, device=dev)
        step_fn = make_train_step(cfg)
        stream = iter(TokenStream(cfg.vocab, batch, seq, seed=1))
        for i in range(args.lm_steps):
            if stop.is_set():
                break
            b = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(stream).items()}
            state, metrics = step_fn(state, b)
            if i % CAPTURE_EVERY == 0:
                with torch.no_grad():
                    h = lm.forward(state.params, cfg, b["tokens"])[0]
                client.send_step("hidden", i, h.reshape(-1, D_MODEL))
            if i % 20 == 0:
                print(f"  [lm] step {i:3d} loss {float(metrics['loss']):.3f}")
        return args.lm_steps

    def ae_consumer(client: Client, stop):
        """A tiny MLP autoencoder learns the hidden-state manifold online."""
        client.wait_for_data("hidden", minimum=2, timeout=60)
        gen = torch.Generator().manual_seed(7)
        params = {
            "enc": (torch.randn((D_MODEL, LATENT), generator=gen)
                    / D_MODEL ** 0.5).to(dev),
            "dec": (torch.randn((LATENT, D_MODEL), generator=gen)
                    / LATENT ** 0.5).to(dev),
        }

        def loss_fn(p, x):
            rec = torch.tanh(x @ p["enc"]) @ p["dec"]
            return torch.mean((rec - x) ** 2) / torch.mean(x ** 2)

        tx = opt.adam(3e-3)
        st = tx.init(params)
        draws = torch.Generator().manual_seed(3)
        first = last = None
        for i in range(args.ae_steps):
            if stop.is_set():
                break
            xs, _, ok = client.sample_batch(
                "hidden", 2, torch.rand(2, generator=draws).to(dev))
            x = xs.reshape(-1, D_MODEL)
            loss, grads = value_and_grad(lambda p: loss_fn(p, x), params)
            updates, st = tx.update(grads, st, params)
            params = opt.apply_updates(params, updates)
            if first is None:
                first = float(loss)
            last = float(loss)
            if i % 50 == 0:
                print(f"  [ae] step {i:3d} rel-mse {last:.4f}")
        print(f"  [ae] rel-mse {first:.4f} -> {last:.4f} "
              f"({D_MODEL / LATENT:.0f}x compression)")
        assert last < first
        client.set_model("h-compressor",
                         lambda p, x: torch.tanh(x @ p["enc"]), params)
        return args.ae_steps

    print("=== in-situ LM hidden-state compression "
          "(paper §4 transplanted) ===")
    res = driver.run({"lm": lm_producer, "compressor": ae_consumer},
                     max_wall_s=900)
    assert res.ok, {k: v.error for k, v in res.components.items()}

    # runtime compression of fresh captures via the registry
    client = driver.client(rank=9)
    xs, _, _ = client.latest_batch("hidden", 1)
    t0 = time.perf_counter()
    z = block_until_ready(client.infer("h-compressor", xs[0]))
    print(f"runtime compression: {tuple(xs[0].shape)} -> {tuple(z.shape)} "
          f"in {(time.perf_counter()-t0)*1e3:.1f} ms")
    print("\n" + res.timers.table("component timers"))


if __name__ == "__main__":
    main()
