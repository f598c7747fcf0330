"""The port's MoE family against the JAX package's (CPU, one process).

``dct_tpu_torch.models.moe`` is held to ``dct_tpu.models.moe`` on the same
numpy inputs from a flax init carried across with ``load_flax_weights``:
``MoEFFN`` with both engines at top-1 and top-2 in a case with drops
(output and load-balance term within 1e-5, gradients within 1e-4 of each
one's max), ``auto`` on both sides of its threshold, ``WeatherMoE``'s
forward at T=256 (the flash path: the JAX side's Pallas kernel in
interpret mode, the port's plain version) in f32 (1e-5) and bf16 compute
(2e-2), three Adam steps of the train body with the aux term (and one
accumulated step) against ``dct_tpu.train.steps``, and the eval body
without it. The serving side is ``test_torch_moe_serving.py``; two
processes are ``test_torch_moe_dp.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.config import ModelConfig as JaxModelConfig
from dct_tpu.models.moe import MoEFFN as JaxMoEFFN
from dct_tpu.models.registry import get_model as jax_get_model
from dct_tpu.ops import losses as jax_losses
from dct_tpu.serving.score_gen import _flatten_params
from dct_tpu.train import state as jax_state
from dct_tpu.train import steps as jax_steps
from dct_tpu_torch.config import ModelConfig
from dct_tpu_torch.convert import (
    flax_shapes,
    flax_weights,
    init_flax_weights,
    load_flax_weights,
)
from dct_tpu_torch.models.moe import MoEFFN
from dct_tpu_torch.models.registry import get_model
from dct_tpu_torch.train import state as port_state
from dct_tpu_torch.train import steps
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 256
SMALL = dict(name="weather_moe", seq_len=S, d_model=32, n_heads=2,
             n_layers=2, d_ff=64, n_experts=4, capacity_factor=0.5)
F_IN = 5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, ref) -> float:
    got, ref = _np(got), _np(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _ffn_pair(engine, k, capacity_factor=0.5, threshold=1 << 21):
    kw = dict(capacity_factor=capacity_factor, dispatch=engine, top_k=k,
              auto_threshold=threshold)
    jffn = JaxMoEFFN(32, 64, 4, **kw)
    params = {"params": jffn.init(jax.random.PRNGKey(k),
                                  jnp.zeros((2, 24, 32)))["params"]}
    tffn = MoEFFN(32, 64, 4, **kw)
    load_flax_weights(tffn, _flatten_params(params["params"]))
    return jffn, params, tffn


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("engine", ["einsum", "sorted"])
def test_moe_ffn_matches_jax_with_drops(engine, k):
    jffn, params, tffn = _ffn_pair(engine, k)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 24, 32)).astype(np.float32)
    r = rng.standard_normal((2, 24, 32)).astype(np.float32)

    def objective(p, xx):
        out, sown = jffn.apply(p, xx, mutable=["aux_loss"])
        aux = sum(jax.tree.leaves(sown))
        return jnp.sum(out * r) + aux, (out, aux)

    (_, (jout, jaux)), (jg, jgx) = jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tout = tffn(xt)
    assert tffn.last_engine == engine
    loss = (tout * torch.from_numpy(r)).sum() + tffn.last_aux
    loss.backward()
    # The case drops: some expert gets more entries than its capacity.
    with torch.no_grad():
        _, choice, _ = tffn._route(xt.reshape(-1, 32))
    counts = np.bincount(choice.reshape(-1).numpy(), minlength=4)
    assert counts.max() > tffn.capacity(48)
    assert np.abs(_np(tout) - np.asarray(jout)).max() <= 1e-5
    assert float(tffn.last_aux.detach()) == pytest.approx(float(jaux),
                                                        abs=1e-5)
    tgrads = flax_weights(tffn, grads=True)
    jgrads = _flatten_params(jg["params"])
    assert set(tgrads) == set(jgrads)
    for key in jgrads:
        assert _rel(tgrads[key], jgrads[key]) <= 1e-4, key
    assert _rel(xt.grad, jgx) <= 1e-4


def test_engines_agree_and_dropped_tokens_get_no_gradient():
    _, params, einsum = _ffn_pair("einsum", 2)
    _, _, tsorted = _ffn_pair("sorted", 2)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 24, 32)).astype(np.float32))
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    ea, sb = einsum(xa), tsorted(xb)
    torch.testing.assert_close(ea, sb, atol=1e-5, rtol=0)
    ea.sum().backward()
    sb.sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad, atol=1e-5, rtol=0)
    # A token every choice of which was dropped gets a zero output and, the
    # router aside, no gradient through the experts.
    dropped = (ea.abs().sum(-1) == 0).reshape(-1)
    assert dropped.any()


def test_auto_picks_the_reference_engine_on_both_sides_of_the_threshold():
    """``auto`` compares ``k * N * E * C`` with ``auto_threshold``, as the
    reference does (``tests/test_moe_dispatch.py:240``): the reference's
    choice shows in its program (a sort), the port's in ``last_engine``."""
    x = np.random.default_rng(9).standard_normal((2, 24, 32)).astype(
        np.float32)
    n = 48
    for k in (1, 2):
        cap = max(1, int(0.5 * k * n / 4))
        work = k * n * 4 * cap
        for threshold, want in ((work, "sorted"), (work + 1, "einsum")):
            jffn, params, tffn = _ffn_pair("auto", k, threshold=threshold)
            jaxpr = str(jax.make_jaxpr(
                lambda p: jffn.apply(p, jnp.asarray(x),
                                     mutable=["aux_loss"])[0])(params))
            assert ("sort" in jaxpr) == (want == "sorted")
            out = tffn(torch.from_numpy(x))
            assert tffn.last_engine == want == tffn.engine_for(n)
            ref = jffn.apply(params, jnp.asarray(x), mutable=["aux_loss"])[0]
            assert np.abs(_np(out) - np.asarray(ref)).max() <= 1e-5


def test_typo_and_top_k_are_refused():
    with pytest.raises(ValueError, match="moe_dispatch"):
        MoEFFN(16, 32, 4, dispatch="sort")
    with pytest.raises(ValueError, match="top_k"):
        MoEFFN(16, 32, 4, top_k=5)
    with pytest.raises(ValueError, match="top_k"):
        MoEFFN(16, 32, 4, top_k=0)


def _pair(*, compute=None, dropout=0.0, lr=1e-3, seed=0, **extra):
    fields = dict(SMALL, dropout=dropout, **extra)
    t = fields["seq_len"]
    jmodel = jax_get_model(JaxModelConfig(**fields), input_dim=F_IN,
                           compute_dtype=compute and jnp.bfloat16)
    jst = jax_state.create_train_state(
        jmodel, input_dim=F_IN, lr=lr, seed=seed,
        example_shape=(1, t, F_IN))
    tmodel = get_model(ModelConfig(**fields), input_dim=F_IN, device="cpu",
                       compute_dtype=compute and torch.bfloat16)
    tst = port_state.create_train_state(tmodel, input_dim=F_IN, lr=lr,
                                        seed=seed)
    load_flax_weights(tmodel, _flatten_params(jst.params["params"]))
    return jst, tst


def _batch(seed=3, b=2, t=S):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, F_IN)).astype(np.float32)
    y = rng.integers(0, 2, (b,)).astype(np.int32)
    w = np.ones(b, np.float32)
    return x, y, w


@pytest.mark.parametrize("compute,tol", [(None, 1e-5), ("bf16", 2e-2)])
def test_weather_moe_forward_matches_jax(compute, tol, monkeypatch):
    from dct_tpu_torch.ops import flash_attention as fa

    monkeypatch.setenv("DCT_FLASH", "interpret")
    jst, tst = _pair(compute=compute, router_top_k=2)
    x, _, _ = _batch(b=3)
    want = np.asarray(jst.apply_fn(jst.params, jnp.asarray(x), train=False))
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    with torch.no_grad():
        got = tst.model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 2)
    assert np.abs(_np(got) - want).max() <= tol
    assert len(calls) == SMALL["n_layers"]  # every layer on the flash path


def _jax_grads(jst, x, y, w):
    """The reference train body's objective (CE mean plus every sown aux
    term) and its gradients."""
    def loss_fn(params):
        logits, sown = jst.apply_fn(params, x, train=True,
                                    rngs={"dropout": jst.rng},
                                    mutable=["aux_loss"])
        loss_sum, count = jax_losses.masked_cross_entropy(logits, y, w)
        return loss_sum / jnp.maximum(count, 1.0) + sum(
            jax.tree.leaves(sown))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jst.params)
    return float(loss), _flatten_params(grads["params"])


def _port_grads(tst, x, y, w):
    loss, grads = steps.loss_and_grads(tst, x, y, w)
    for p, g in zip(tst.params, grads):
        p.grad = g
    out = flax_weights(tst.model, grads=True)
    for p in tst.params:
        p.grad = None
    return float(loss), out


@pytest.mark.parametrize("engine,t", [("einsum", S), ("sorted", 32)])
def test_three_adam_steps_with_aux_match_jax(engine, t, monkeypatch):
    """The train body's objective with the load-balance terms and its
    gradients (1e-4 of each one's max) at step 1, then three Adam steps:
    losses within 1e-5, gradient norms within 1e-4, parameters within 1e-4
    (a tenth of lr). Adam's first update is about lr * sign(g), so an
    element whose step-1 gradient is rounding noise on both sides (at most
    1e-5 of its leaf's max, e.g. the k bias of every qkv_proj, analytically
    zero without RoPE) may step either way: those are held to 3 lr. The
    einsum case runs at T=256, the flash path (forward and backward)."""
    monkeypatch.setenv("DCT_FLASH", "interpret")
    lr = 1e-3
    jst, tst = _pair(moe_dispatch=engine, lr=lr, seq_len=t,
                     router_top_k=2 if engine == "sorted" else 1)
    x, y, w = _batch(seed=10, t=t)
    jloss, jgrads = _jax_grads(jst, x, y, w)
    tloss, tgrads = _port_grads(tst, x, y, w)
    aux = tst.model.aux_loss()
    assert aux is not None and 0 < float(aux.detach()) < 1
    assert tloss == pytest.approx(jloss, rel=1e-5)
    assert set(tgrads) == set(jgrads)
    for key in jgrads:
        assert _rel(tgrads[key], jgrads[key]) <= 1e-4, key
    jstep = jax_steps.make_train_step(donate=False, with_grad_norm=True)
    tstep = steps.make_train_step(with_grad_norm=True)
    for i in range(3):
        xi, yi, wi = _batch(seed=10 + i, t=t)
        jst, jm = jstep(jst, jnp.asarray(xi), jnp.asarray(yi),
                        jnp.asarray(wi))
        tst, tm = tstep(tst, xi, yi, wi)
        assert float(tm["train_loss"]) == pytest.approx(
            float(jm["train_loss"]), rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
    want = _flatten_params(jst.params["params"])
    for key, value in flax_weights(tst.model).items():
        ref = np.asarray(want[key])
        g, tg = np.asarray(jgrads[key]), np.asarray(tgrads[key])
        scale = np.abs(g).max()
        noise = (np.abs(g) <= 1e-5 * scale) & (np.abs(tg) <= 1e-5 * scale)
        np.testing.assert_allclose(value[noise], ref[noise], atol=3 * lr,
                                   err_msg=key)
        np.testing.assert_allclose(value[~noise], ref[~noise], atol=1e-4,
                                   err_msg=key)


def test_accumulated_step_divides_the_aux_and_eval_leaves_it_out(
        monkeypatch):
    jst, tst = _pair(seq_len=16)
    x, y, w = _batch(seed=21, b=4, t=16)
    w[-1] = 0.0
    jeval = jax_steps.make_eval_step()
    want_sums = jeval(jst, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    got_sums = steps.make_eval_step()(tst, x, y, w)
    for g, e in zip(got_sums, want_sums):
        assert float(g) == pytest.approx(float(e), rel=1e-5, abs=1e-6)
    with torch.no_grad():  # val_loss is pure cross entropy
        logits = tst.model(torch.from_numpy(x))
    ce = jax_losses.masked_cross_entropy(jnp.asarray(_np(logits)), y, w)
    assert float(got_sums[0]) == pytest.approx(float(ce[0]), rel=1e-5)
    jstep = jax_steps.make_train_step(donate=False, accum_steps=2)
    tstep = steps.make_train_step(accum_steps=2)
    jst, jm = jstep(jst, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    tst, tm = tstep(tst, x, y, w)
    assert float(tm["train_loss"]) == pytest.approx(
        float(jm["train_loss"]), rel=1e-5)
    want = _flatten_params(jst.params["params"])
    for key, value in flax_weights(tst.model).items():
        np.testing.assert_allclose(value, np.asarray(want[key]), atol=1e-4,
                                   err_msg=key)


def test_converter_round_trip_and_init_distributions():
    fields = dict(SMALL, seq_len=16)
    jmodel = jax_get_model(JaxModelConfig(**fields), input_dim=F_IN)
    jparams = _flatten_params(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, F_IN)), train=False)["params"])
    model = get_model(ModelConfig(**fields), input_dim=F_IN, device="cpu")
    assert flax_shapes(model) == {k: v.shape for k, v in jparams.items()}
    load_flax_weights(model, jparams)
    back = flax_weights(model)
    for key, value in jparams.items():
        np.testing.assert_array_equal(back[key], np.asarray(value))
    drawn = init_flax_weights(model, 0)
    for leaf, fan_in in (("experts_in_kernel", 32), ("experts_in_bias", 32),
                         ("experts_out_kernel", 64), ("experts_out_bias", 64)):
        v = drawn[f"block_0/moe/{leaf}"]
        assert np.abs(v).max() <= fan_in ** -0.5
        assert v.std() == pytest.approx(fan_in ** -0.5 / np.sqrt(3), rel=0.2)
    assert drawn["block_1/moe/experts_in_kernel"].shape == (4, 32, 64)
    with pytest.raises(KeyError):
        load_flax_weights(model, {k: v for k, v in jparams.items()
                                  if k != "block_0/moe/experts_out_bias"})
