"""Actor-critic network for Minigrid observations, in plain JAX.

The reference ships no model code at all (SURVEY.md §0) — this network
exists because the framework's north star includes feeding sharded env
batches to a learner (BASELINE.json config 5).  Its parameters are a dict
of float32 arrays built by :func:`init_params`; :func:`apply` runs it:

* the symbolic (view, view, 3) uint8 image is embedded per plane
  (object/color/state ids -> learned vectors) as one-hot bf16 matrix
  products (:func:`_onehot_embed`) instead of row gathers, so the backward
  pass is another matrix product rather than a scatter-add;
* convolutions and matrix products run in bfloat16 (parameters stay f32);
  the two heads run in float32;
* the BabyAI mission is consumed directly as the 48-int instruction code
  vector (core/state.py MISSION_SLOTS) through an embedding-bag — no string
  processing anywhere near the device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from minigrid_dynamicprogramming_tpu.core.constants import NUM_ACTIONS
from minigrid_dynamicprogramming_tpu.core.state import MISSION_SLOTS

__all__ = ["init_params", "apply"]

COMPUTE_DTYPE = jnp.bfloat16
EMBED_DIM = 8
PLANE_VOCABS = (16, 8, 4)  # object / color / state ids
CONV_FEATURES = (32, 64, 64)
DIR_DIM = 16
MISSION_VOCAB = 64  # instruction codes are small ints (< 48)
MISSION_DIM = 32
HIDDEN = 256

_embed_init = jax.nn.initializers.variance_scaling(
    1.0, "fan_in", "normal", out_axis=0
)
_kernel_init = jax.nn.initializers.lecun_normal()
_pos_init = jax.nn.initializers.normal(0.02)


def _dense_params(key, n_in, n_out):
    return {
        "kernel": _kernel_init(key, (n_in, n_out), jnp.float32),
        "bias": jnp.zeros((n_out,), jnp.float32),
    }


def _flat_features(view: int) -> int:
    """Width of the flattened conv output: SAME convs keep the spatial
    size, and every conv but the last is followed by a 2x2 VALID pool."""
    for _ in CONV_FEATURES[:-1]:
        view //= 2
    return view * view * CONV_FEATURES[-1]


def init_params(
    key: jax.Array, view: int = 7, num_actions: int = NUM_ACTIONS
) -> dict:
    """Initial parameters for a ``view`` x ``view`` egocentric image."""
    keys = iter(jax.random.split(key, 16))
    params = {}
    for c, vocab in enumerate(PLANE_VOCABS):
        params[f"plane_embed_{c}"] = _embed_init(
            next(keys), (vocab, EMBED_DIM), jnp.float32
        )
    n_in = EMBED_DIM * len(PLANE_VOCABS)
    for i, feat in enumerate(CONV_FEATURES):
        params[f"conv_{i}"] = {
            "kernel": _kernel_init(
                next(keys), (3, 3, n_in, feat), jnp.float32
            ),
            "bias": jnp.zeros((feat,), jnp.float32),
        }
        n_in = feat
    params["dir_embed"] = _embed_init(next(keys), (4, DIR_DIM), jnp.float32)
    params["code_embed"] = _embed_init(
        next(keys), (MISSION_VOCAB, MISSION_DIM), jnp.float32
    )
    params["code_pos"] = _pos_init(
        next(keys), (MISSION_SLOTS, MISSION_DIM), jnp.float32
    )
    trunk_in = _flat_features(view) + DIR_DIM + MISSION_DIM
    params["trunk"] = _dense_params(next(keys), trunk_in, HIDDEN)
    params["policy_head"] = _dense_params(next(keys), HIDDEN, num_actions)
    params["value_head"] = _dense_params(next(keys), HIDDEN, 1)
    return params


def _onehot_embed(table, ids):
    """Embedding lookup as a one-hot matrix product (same math as a
    gather; its gradient is a matrix product, not a scatter-add)."""
    oh = jax.nn.one_hot(ids, table.shape[0], dtype=COMPUTE_DTYPE)
    return oh @ table.astype(COMPUTE_DTYPE)


def _dense(p, x, dtype):
    kernel, bias = p["kernel"].astype(dtype), p["bias"].astype(dtype)
    return x.astype(dtype) @ kernel + bias


def _conv3x3(p, x):
    """SAME 3x3 convolution over (..., H, W, C) in the compute dtype."""
    lead = x.shape[:-3]
    y = jax.lax.conv_general_dilated(
        x.reshape((-1,) + x.shape[-3:]).astype(COMPUTE_DTYPE),
        p["kernel"].astype(COMPUTE_DTYPE),
        window_strides=(1, 1),
        padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    y = y + p["bias"].astype(COMPUTE_DTYPE)
    return y.reshape(lead + y.shape[1:])


def _max_pool2x2(x):
    window = (1,) * (x.ndim - 3) + (2, 2, 1)
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, window, window, "VALID"
    )


def apply(params: dict, obs) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(logits, value) for an observation dict with any leading batch
    axes: ``image`` (..., V, V, 3), ``direction`` (...,), ``mission``
    (..., MISSION_SLOTS)."""
    img = obs["image"].astype(jnp.int32)
    x = jnp.concatenate(
        [
            _onehot_embed(
                params[f"plane_embed_{c}"],
                jnp.clip(img[..., c], 0, vocab - 1),
            )
            for c, vocab in enumerate(PLANE_VOCABS)
        ],
        axis=-1,
    )
    for i in range(len(CONV_FEATURES)):
        x = jax.nn.relu(_conv3x3(params[f"conv_{i}"], x))
        if i < len(CONV_FEATURES) - 1:
            x = _max_pool2x2(x)
    x = x.reshape(*x.shape[:-3], -1)  # flatten spatial

    d = _onehot_embed(params["dir_embed"], obs["direction"].astype(jnp.int32))

    # Mission embedding-bag: position-tagged code embeddings, summed.
    codes = jnp.clip(obs["mission"].astype(jnp.int32), 0, MISSION_VOCAB - 1)
    tok = _onehot_embed(params["code_embed"], codes)
    m = (tok * params["code_pos"].astype(COMPUTE_DTYPE)).sum(axis=-2)

    h = jnp.concatenate([x, d, m], axis=-1)
    h = jax.nn.relu(_dense(params["trunk"], h, COMPUTE_DTYPE))
    logits = _dense(params["policy_head"], h, jnp.float32)
    value = _dense(params["value_head"], h, jnp.float32)
    return logits, value.squeeze(-1)
