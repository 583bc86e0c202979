"""Gradients of a vision model through the port's schedule replay, held
against `jax.grad` of the JAX package's on the same weights.

``vit_edge``'s cross-entropy loss through `vit.forward` (the fused
schedule: embed, one ``layer`` phase per block, head; on the card every
layer is kernel 1 through `ops._KernelGrad`, here its plain version) and
its gradient for every leaf: the loss within 1e-5 of its value, each
gradient within 1e-5 of its leaf's scale (max |g_jax|)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import vision_registry as j_reg
from repro.models import vit as j_vit
from repro_torch import tree as tree_lib
from repro_torch.convert import params_from_numpy
from repro_torch.models import vision_registry as t_reg
from repro_torch.models import vit as t_vit


def _jax_loss(params, images, labels, cfg):
    logits = j_vit.forward(params, j_vit.extract_patches(images, cfg.patch),
                           cfg)
    return -jnp.mean(jnp.take_along_axis(
        jax.nn.log_softmax(logits), labels[:, None], 1))


def _torch_loss(params, images, labels, cfg):
    logits = t_vit.forward(params, t_vit.extract_patches(images, cfg.patch),
                           cfg)
    return -torch.mean(torch.gather(torch.log_softmax(logits, -1), 1,
                                    labels[:, None]))


def test_vit_edge_gradients_match_jax():
    cfg_j, cfg_t = j_reg.build_cfg("vit_edge"), t_reg.build_cfg("vit_edge")
    params = j_reg.init_params(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.default_rng(3)
    images = rng.standard_normal((4, cfg_j.image, cfg_j.image, 3)
                                 ).astype(np.float32)
    labels = rng.integers(0, cfg_j.n_classes, 4).astype(np.int32)

    loss_j, grads_j = jax.value_and_grad(_jax_loss)(
        params, jnp.asarray(images), jnp.asarray(labels), cfg_j)

    tparams = params_from_numpy(params)
    flat = tree_lib.leaves(tparams)
    live = [t.detach().requires_grad_() for t in flat]
    loss_t = _torch_loss(tree_lib.unflatten(tparams, live),
                         torch.from_numpy(images),
                         torch.from_numpy(labels).long(), cfg_t)
    grads_t = torch.autograd.grad(loss_t, live)

    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, grads_j))
    paths = [p for p, _ in tree_lib.leaves_with_path(tparams)]
    assert len(paths) == len(tree_lib.leaves(want)) == len(grads_t)
    for path, g_t in zip(paths, grads_t):
        g_j = tree_lib.at(want, path)
        scale = float(g_j.abs().max())
        err = float((g_t - g_j).abs().max())
        assert err <= 1e-5 * max(scale, 1e-12), (tree_lib.path_key(path),
                                                  err, scale)
