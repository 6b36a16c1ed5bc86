"""Shared helpers for the PyTorch port's parity tests (``test_torch_*.py``).

Parameters are made with numpy from a seed in the JAX package's tree layout,
then converted with the port's ``from_jax_params``, so both sides compute
with the same weights. Every leaf gets nonzero values, including the layers
the reference initializes to zero, so that no path is hidden behind a zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

# each xdist worker runs one file at a time; keep torch from taking every core
torch.set_num_threads(2)


def fill_params(tree, seed: int):
    """A copy of a flax parameter tree (numpy or abstract leaves) with
    seeded values: LeCun-normal kernels, scales near 1, small biases and
    embeddings."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        shape = tuple(leaf.shape)
        name = path[-1]
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1])) if len(shape) == 4 else shape[-2]
            return (rng.normal(size=shape) * fan_in ** -0.5).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return fill(path, node)

    return walk(tree, ())


def init_like(module, seed: int, *args, **kwargs):
    """Seeded numpy parameters with the structure of ``module.init``."""
    return fill_params(
        jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs)), seed)


def jax_system_params(js, F: int, H: int, W: int):
    """Seeded numpy parameters for every component of a JAX ``CamAnimate``
    ``js``, shaped for F frames at H x W."""
    c = js.config
    h8, w8 = H // 8, W // 8
    ctx = jnp.zeros((1, 1, c.reference_unet.cross_attention_dim))
    t = jnp.zeros((1,))
    ref_lat = jnp.zeros((1, h8, w8, 4))
    pref = init_like(js.reference_unet, 20, ref_lat, t, ctx, collect_ref_features=True)
    _, feats = jax.eval_shape(lambda: js.reference_unet.apply(
        pref, ref_lat, t, ctx, collect_ref_features=True))
    feats = [jnp.zeros(f.shape) for f in feats]
    return {
        "reference_unet": pref,
        "denoising_unet": init_like(js.denoising_unet, 21, jnp.zeros((F, h8, w8, 4)), t, ctx,
                                    ref_features=feats, frames=F),
        "pose_guider": init_like(js.pose_guider, 22, jnp.zeros((1, H, W, 3))),
        "camera_encoder": init_like(js.camera_encoder, 23, jnp.zeros((F, H, W, 6)), F),
        "vae_encoder": init_like(js.vae_encoder, 24, jnp.zeros((1, H, W, 3))),
        "vae_decoder": init_like(js.vae_decoder, 25, jnp.zeros((1, h8, w8, 4))),
        "clip": init_like(js.clip, 26, jnp.zeros((1, 28, 28, 3))),
    }


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x, np.float32), -1, 1)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return np.moveaxis(x.detach().float().numpy(), 1, -1)


def sub_state_dict(sd, prefix: str):
    """Keys under ``prefix`` with the prefix removed."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def test_fill_params_leaves_no_zero_leaf():
    tree = {"params": {"a": {"kernel": np.zeros((3, 3, 4, 5)), "bias": np.zeros(5)},
                       "n": {"scale": np.zeros(5)}}}
    filled = fill_params(tree, 0)
    for leaf in jax.tree_util.tree_leaves(filled):
        assert np.all(leaf != 0)
    k = filled["params"]["a"]["kernel"]
    assert abs(k.std() - 36 ** -0.5) < 0.05
