"""The model axis's layout rules against the JAX package's, with no process.

For every leaf of configs/model/vqvae.yaml's full-width VQ-VAE,
configs/model/transformer.yaml's net and the MoE preset
(configs/experiment/moe_transformer.yaml: 8 experts, top 2), at the data's
22 kHz × 2 s frames: the trees come from ``jax.eval_shape`` (nothing is
allocated), the layout map of ``utils/jax_compat.py`` names each leaf as the
port holds it, and the port's rule on the port's tensor (``parallel/
sharding.py``) must give JAX's spec on the flax leaf, its axes carried
through the map:

* ``tp_param_spec`` (msla_tpu/parallel/mesh.py:83-109) at mp = 2 and 4;
* ``split_over_data`` (mesh.py:112-128) on that spec at dp = 1, 2 and 4;
* ``make_param_shardings`` with ``fsdp`` and ``make_opt_shardings`` with
  ``zero1`` (mesh.py:131-192), on a (dp, mp) ``AbstractMesh``.

At dp = 1 JAX leaves the data split out (mesh.py:146-147, 184); the port
splits the leaf into one part, which places it as the whole does, so there
"data" on a 1-wide axis counts as whole. The port's runtime names the flax
kernels by module type (``kernel_names``); that set must be the flax
kernels' own.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from msla_tpu.models.transformer import TransformerTask as JaxTransformerTask
from msla_tpu.models.vqvae import VQVAETask as JaxVQVAETask
from msla_tpu.parallel import mesh as jax_mesh
from msla_tpu_torch.models.transformer import TransformerTask
from msla_tpu_torch.models.vqvae import VQVAETask
from msla_tpu_torch.parallel import sharding
from msla_tpu_torch.utils.jax_compat import (transformer_state_dict_from_jax,
                                             vqvae_state_dict_from_jax)

SR, FRAME_S = 22000, 2                    # configs/data/default.yaml
T = SR * FRAME_S
VQVAE = dict(num_hidden=128, num_residual_layer=2, num_residual_hidden=32, num_embedding=512,
             embedding_dim=64, commitment_cost=0.25, learning_rate=1e-4, sample_rate=SR)
TRANSFORMER = dict(sample_rate=SR, frame_length=FRAME_S, learning_rate=1e-4, num_layers=4,
                   num_heads=8, hidden_dim=512)
NETS = {"vqvae": (VQVAE, 0), "transformer": (TRANSFORMER, 0), "moe": (TRANSFORMER, 8)}


def _jax_task(net: str):
    cfg, experts = NETS[net]
    if net == "vqvae":
        return JaxVQVAETask(**cfg, checkpoint_dir="unused", codebook_file="unused/cb.csv")
    return JaxTransformerTask(**cfg, checkpoint_dir="unused", moe_experts=experts,
                              moe_selected=2)


def _to_port(net: str, tree) -> dict[str, torch.Tensor]:
    if net == "vqvae":
        return vqvae_state_dict_from_jax(tree, VQVAE["num_residual_layer"])
    return transformer_state_dict_from_jax(tree, TRANSFORMER["num_layers"])


@lru_cache(maxsize=None)
def _leaves(net: str):
    """(flax params' shapes, and for each port name: the flax path, the flax
    shape, the flax axis of each port axis, whether it is a flax kernel)."""
    task = _jax_task(net)
    if net == "vqvae":
        batch = (jax.ShapeDtypeStruct((1, 4, T), jnp.float32),) * 2
    else:
        batch = (jax.ShapeDtypeStruct((1, VQVAE["embedding_dim"], T // 4), jnp.float32),
                 jax.ShapeDtypeStruct((1, 4, T), jnp.float32))
    params = jax.eval_shape(task.init_variables, jax.random.PRNGKey(0), batch)["params"]
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    primes = (2, 3, 5, 7)
    # the map on 1-element tensors holding each leaf's index pairs the names;
    # on meta tensors of distinct prime sizes it shows where each axis goes
    index = _to_port(net, jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [torch.full((1,) * len(leaf.shape), float(i)) for i, (_, leaf) in enumerate(flat)]))
    axes = _to_port(net, jax.tree_util.tree_map(
        lambda leaf: torch.empty(primes[:len(leaf.shape)], device="meta"), params))
    out = {}
    for name, t in index.items():
        path, leaf = flat[int(t.reshape(-1)[0])]
        sizes = tuple(axes[name].shape)
        out[name] = (path, tuple(leaf.shape), tuple(primes.index(n) for n in sizes),
                     getattr(path[-1], "key", None) == "kernel")
    return params, out


def _carried(spec: P, ndim: int, axes: tuple) -> tuple:
    """JAX's spec on the flax leaf, on the port's axes."""
    full = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(full[a] for a in axes)


def _placed(spec: tuple, dp: int) -> tuple:
    """A spec as a placement: "data" on a 1-wide axis is whole."""
    return tuple(None if (a == "data" and dp == 1) else a for a in spec)


def _small_port_net(net: str):
    """The port's net with the config's layer counts at small widths (its
    names are the full width's)."""
    if net == "vqvae":
        return VQVAETask(**{**VQVAE, "num_hidden": 8, "num_residual_hidden": 4,
                            "num_embedding": 8, "embedding_dim": 4},
                         checkpoint_dir="unused", codebook_file="unused/cb.csv",
                         device="cpu").net
    return TransformerTask(sample_rate=16, frame_length=1, learning_rate=1e-4,
                           checkpoint_dir="unused", num_layers=TRANSFORMER["num_layers"],
                           num_heads=2, hidden_dim=8, moe_experts=NETS[net][1],
                           latent_channels=4, device="cpu").net


@pytest.mark.parametrize("net", list(NETS))
def test_the_port_names_the_flax_kernels(net):
    _, leaves = _leaves(net)
    flax_kernels = {name for name, (_, _, _, kernel) in leaves.items() if kernel}
    assert sharding.kernel_names(_small_port_net(net)) & set(leaves) == flax_kernels
    assert flax_kernels


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
@pytest.mark.parametrize("dp", [1, 2, 4])
@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("net", list(NETS))
def test_the_layouts_equal_jax(net, mp, dp, mode):
    params, leaves = _leaves(net)
    zero1, fsdp = mode == "zero1", mode == "fsdp"
    mesh = AbstractMesh((dp, mp), (jax_mesh.DATA_AXIS, jax_mesh.MODEL_AXIS))
    param_sh = jax_mesh.make_param_shardings(mesh, params, fsdp=fsdp)
    tx = _jax_task(net).configure_optimizer()
    opt_sh = jax_mesh.make_opt_shardings(mesh, tx, params, param_sh, zero1=zero1)
    mu = {tuple(str(k) for k in path): sh for path, sh in
          jax.tree_util.tree_flatten_with_path(opt_sh)[0] if "mu" in str(path)}
    by_path = {tuple(str(k) for k in path): sh for path, sh in
               jax.tree_util.tree_flatten_with_path(param_sh)[0]}
    fired = 0
    for name, (path, shape, axes, kernel) in leaves.items():
        nd = len(shape)
        port_shape = tuple(shape[a] for a in axes)
        tp = jax_mesh.tp_param_spec(path, jax.ShapeDtypeStruct(shape, jnp.float32), mp)
        got_tp = sharding.tp_param_spec(name, port_shape, kernel, mp)
        assert got_tp == _carried(tp, nd, axes), name
        assert sharding.split_over_data(got_tp, port_shape, dp, kernel) == _carried(
            jax_mesh.split_over_data(tp, shape, dp), nd, axes), name
        got = sharding.param_spec(name, port_shape, kernel, mp, dp, fsdp)
        key = tuple(str(k) for k in path)
        assert _placed(got, dp) == _carried(by_path[key].spec, nd, axes), name
        moments = [sh for p, sh in mu.items() if p[-len(key):] == key]
        assert len(moments) == 1, name
        got_opt = sharding.opt_spec(got, port_shape, kernel, dp, zero1)
        assert _placed(got_opt, dp) == _carried(moments[0].spec, nd, axes), name
        fired += "model" in got_tp
    assert fired >= (4 if net != "transformer" else 8)
