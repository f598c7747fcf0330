"""The first Adam steps of the full-width transformer, the JAX package
against the port, on the CPU.

    JAX_PLATFORMS=cpu python scripts/adam_first_steps_compare.py [--steps 3]

Both sides start from the same flax initialisation (the reference's
``model.init``, carried into the port with ``load_flax_weights``), train on
the same windows of seeded synthetic rows (the port's ETL, ``make_windows``)
at dropout 0 with Adam at lr 1e-3 (``DCT_OPTIMIZER=adam``, the trainer's
default chain), f32 compute, and take the same steps on the same batch. The
width is the bench's (``bench.py:216-227``: d_model 512, 8 heads, d_ff 2048,
seq_len 1024); depth and batch are cut (``--layers``, ``--batch``) to keep
the run inside a shared CPU's memory. The reference attends through its
CPU path (blockwise at T=1024), the port through the flash path's plain
version; both are exact attention.

Prints one JSON line: each side's train loss and grad norm per step, the
loss after the last step, the largest relative differences, and the verdict
``port_fault`` (the port parts from the reference by more than ``TOL``) with
``overshoot`` (the loss after the first update rises above the initial
loss on both sides).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

WIDTH = dict(seq_len=1024, d_model=512, n_heads=8, d_ff=2048)
TOL = 1e-3  # relative, on the losses and grad norms of each step


def _windows(batch: int):
    from dct_tpu_torch.data.dataset import load_processed_dataset
    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.data.windows import make_windows
    from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet

    with tempfile.TemporaryDirectory(prefix="adam_steps_") as root:
        raw = os.path.join(root, "weather.csv")
        generate_weather_csv(raw, rows=WIDTH["seq_len"] + 4 * batch, seed=3)
        preprocess_csv_to_parquet(raw, os.path.join(root, "processed"))
        data = make_windows(load_processed_dataset(os.path.join(
            root, "processed")), WIDTH["seq_len"])
    idx = np.arange(batch) * 4
    return (np.asarray(data.take(idx), np.float32),
            np.asarray(data.labels[idx], np.int32),
            np.ones(batch, np.float32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch

    from dct_tpu.config import ModelConfig as JaxModelConfig
    from dct_tpu.models.registry import get_model as jax_get_model
    from dct_tpu.serving.score_gen import _flatten_params
    from dct_tpu.train.state import create_train_state as jax_state
    from dct_tpu.train.steps import make_train_step as jax_step
    from dct_tpu_torch.config import ModelConfig
    from dct_tpu_torch.convert import load_flax_weights
    from dct_tpu_torch.models.registry import get_model
    from dct_tpu_torch.train import steps
    from dct_tpu_torch.train.state import create_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    fields = dict(WIDTH, name="weather_transformer", n_layers=args.layers,
                  dropout=0.0)
    x, y, w = _windows(args.batch)
    f_in = x.shape[-1]

    jmodel = jax_get_model(JaxModelConfig(**fields), input_dim=f_in)
    jst = jax_state(jmodel, input_dim=f_in, lr=args.lr, seed=0,
                    example_shape=(1, WIDTH["seq_len"], f_in))
    init = _flatten_params(jax.device_get(jst.params)["params"])
    jstep = jax_step(donate=False, with_grad_norm=True)
    ref = {"loss": [], "grad_norm": []}
    for _ in range(args.steps):
        jst, m = jstep(jst, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
        ref["loss"].append(float(m["train_loss"]))
        ref["grad_norm"].append(float(m["grad_norm"]))

    model = get_model(ModelConfig(**fields), input_dim=f_in, device="cpu")
    pst = create_train_state(model, input_dim=f_in, lr=args.lr, seed=0)
    load_flax_weights(model, init)
    pstep = steps.make_train_step(with_grad_norm=True)
    port = {"loss": [], "grad_norm": []}
    for _ in range(args.steps):
        pst, m = pstep(pst, x, y, w)
        port["loss"].append(float(m["train_loss"]))
        port["grad_norm"].append(float(m["grad_norm"]))

    # The loss after the last update, evaluated alike (dropout 0).
    from dct_tpu.ops import losses as jax_losses

    logits = jmodel.apply(jst.params, jnp.asarray(x))
    ls, c = jax_losses.masked_cross_entropy(logits, jnp.asarray(y),
                                            jnp.asarray(w))
    ref["loss_after"] = float(ls / c)
    sums = steps.make_eval_step()(pst, x, y, w)
    port["loss_after"] = float(sums[0] / sums[2])

    def rel(a, b):
        return max(abs(p - q) / max(abs(q), 1e-12) for p, q in zip(a, b))

    loss_rel = rel(port["loss"] + [port["loss_after"]],
                   ref["loss"] + [ref["loss_after"]])
    gnorm_rel = rel(port["grad_norm"], ref["grad_norm"])
    rise = lambda r: (r["loss"][1] if len(r["loss"]) > 1  # noqa: E731
                      else r["loss_after"]) > r["loss"][0]
    print(json.dumps({
        "width": fields, "batch": args.batch, "lr": args.lr,
        "reference": ref, "port": port, "loss_max_rel_diff": loss_rel,
        "grad_norm_max_rel_diff": gnorm_rel,
        "port_fault": loss_rel > TOL or gnorm_rel > TOL,
        "overshoot": {"reference": rise(ref), "port": rise(port)},
    }), flush=True)
    return 0 if loss_rel <= TOL and gnorm_rel <= TOL else 1


if __name__ == "__main__":
    sys.exit(main())
