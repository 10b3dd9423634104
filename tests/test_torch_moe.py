"""The port's ``MoEFFN`` on the CPU against the JAX package's (E = 4 experts,
top-2, hidden 32, FFN 64), on the same weights.

* Routing planted so that expert 0 is every token's first choice and
  overflows its capacity C = ⌈2·8·1.25/4⌉ = 5: ``route`` on the JAX
  module's router probabilities gives its dispatch and combine (read from
  its einsums) bit for bit; the port's own probabilities, whose router
  product sums in another order, the same dispatch and the combine within
  2.4e-7 (two ulps of a gate of 1); the output within 1e-5, the Switch aux loss within
  1e-6. Also on unplanted routing.
* E = 1, top-1, capacity factor 1: the dense ReLU FFN.
* The init: the router U(±1/√M), each expert's kernels U(±1/√fan_in).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msla_tpu.nn.moe as jax_moe_module
from msla_tpu.nn.moe import MoEFFN as JaxMoEFFN
from msla_tpu_torch.nn.moe import MoEFFN, route

M, F, E, K, G, S = 32, 64, 4, 2, 3, 8


def _port(params, **kw):
    moe = MoEFFN(M, F, kw.pop("num_experts", E), generator=torch.Generator().manual_seed(0),
                 device="cpu", **kw)
    moe.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    return moe


def _jax_run(moe, params, x, monkeypatch):
    """The JAX module's output, aux and the dispatch and combine tensors its
    einsums were given."""
    seen = {}

    def einsum(spec, *ops, **kw):
        if spec == "gsm,me->gse":
            seen["probs"] = np.asarray(jax.nn.softmax(jnp.einsum(spec, *ops, **kw), axis=-1))
        if spec == "gsec,gsm->egcm":
            seen["dispatch"] = np.asarray(ops[0])
        if spec == "gsec,egcm->gsm":
            seen["combine"] = np.asarray(ops[0])
        return jnp.einsum(spec, *ops, **kw)

    names = {n: getattr(jnp, n) for n in dir(jnp) if not n.startswith("__")}
    monkeypatch.setattr(jax_moe_module, "jnp", types.SimpleNamespace(**{**names,
                                                                       "einsum": einsum}))
    y, aux = moe.apply({"params": params}, jnp.asarray(x), mutable=["losses"])
    (aux,) = jax.tree_util.tree_leaves(aux["losses"])
    return np.asarray(y), float(aux), seen


def _inputs(planted: bool):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((G, S, M)).astype(np.float32)
    moe = JaxMoEFFN(M, F, E, num_selected=K)
    params = jax.device_get(moe.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    if planted:  # every token's first choice: expert 0
        x[..., 0] = 3.0 + np.abs(x[..., 0])
        router = np.array(params["router"])
        router[0, :] = [4.0, 1.0, 0.0, -1.0]
        params = {**params, "router": router}
    return moe, params, x


@pytest.mark.parametrize("planted", [True, False])
def test_moe_matches_jax(planted, monkeypatch):
    moe, params, x = _inputs(planted)
    want, want_aux, seen = _jax_run(moe, params, x, monkeypatch)
    port = _port(params)
    c = port.capacity(S)
    dispatch, combine, first = route(torch.from_numpy(seen["probs"]), K, c)
    np.testing.assert_array_equal(dispatch.numpy(), seen["dispatch"])
    np.testing.assert_array_equal(combine.numpy(), seen["combine"])
    with torch.no_grad():
        own = port.routing(torch.from_numpy(x))
    np.testing.assert_array_equal(own[0].numpy(), seen["dispatch"])
    np.testing.assert_allclose(own[1].numpy(), seen["combine"], rtol=0, atol=2.4e-7)
    assert dispatch.shape == (G, S, E, c) and c == 5
    if planted:  # expert 0 full in every group, and its overflow dropped
        assert (first[..., 0] == 1).all()
        assert (dispatch[:, :, 0].sum(dim=(1, 2)) == c).all()
        assert (dispatch.sum(dim=(2, 3)) < K).any()
    y, aux = port(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux.item(), want_aux, rtol=1e-6, atol=1e-6)


def test_one_expert_top1_is_the_dense_ffn():
    x = np.random.default_rng(2).standard_normal((2, S, M)).astype(np.float32)
    moe = JaxMoEFFN(M, F, 1, num_selected=1, capacity_factor=1.0)
    params = jax.device_get(moe.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"])
    port = _port(params, num_experts=1, num_selected=1, capacity_factor=1.0)
    xt = torch.from_numpy(x)
    y, _ = port(xt)
    dense = torch.relu(xt @ port.w1[0] + port.b1[0]) @ port.w2[0] + port.b2[0]
    np.testing.assert_allclose(y.detach().numpy(), dense.detach().numpy(), rtol=1e-5, atol=1e-6)


def test_init_is_per_expert_torch_linear():
    moe = MoEFFN(64, 128, 8, generator=torch.Generator().manual_seed(4), device="cpu")
    for name, fan_in in (("router", 64), ("w1", 64), ("b1", 64), ("w2", 128), ("b2", 128)):
        top = getattr(moe, name).abs().max().item()
        assert 0.8 / fan_in ** 0.5 < top <= 1 / fan_in ** 0.5, name
    assert tuple(moe.w1.shape) == (8, 64, 128) and tuple(moe.router.shape) == (64, 8)
