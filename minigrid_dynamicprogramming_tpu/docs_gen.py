"""Documentation and GIF generators.

Framework counterpart of the reference's docs pipeline
(/root/reference/docs/_scripts/gen_env_docs.py — one markdown page per env
family with attributes + docstring; gen_gifs.py — one random-policy episode
GIF per family).  Differences are deliberate: pages are built from the
functional API (``EnvParams``/hooks, not gym spaces), frames come from the
batched tile-LUT renderer, and the random policy steps on device.

Run::

    python -m minigrid_dynamicprogramming_tpu.docs_gen --out docs \
        [--gifs] [--length 60] [--tile-size 16]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

import jax
import jax.numpy as jnp

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.registry import family
from minigrid_dynamicprogramming_tpu.render import render_frame


def _one_id_per_family(ids) -> dict:
    """First id of each family — the reference documents one env per class
    (gen_env_docs.py envs_completed dedupe)."""
    picked = {}
    for env_id in ids:
        fam = family(env_id)
        picked.setdefault(fam, env_id)
    return picked


def _env_page(env_id: str) -> str:
    env = mgtpu.make(env_id)
    p = env.params
    _, state = jax.jit(env.reset)(jax.random.PRNGKey(0))
    mission = env.mission_text(np.asarray(state.mission))
    fam = family(env_id)
    siblings = [i for i in mgtpu.registered_ids() if family(i) == fam]
    view = p.agent_view_size
    lines = [
        "---",
        "autogenerated:",
        f"title: {fam}",
        "---",
        "",
        f"# {fam}",
        "",
        f"![{fam}](../_static/gifs/{fam}.gif)",
        "",
        "|   |   |",
        "|---|---|",
        f"| Action Space | `Discrete({env.action_dim})` |",
        f"| Observation | `image (uint8 {view}x{view}x3)`, `direction`, `mission` |",
        f"| Grid Size | `{p.width} x {p.height}` |",
        f"| Max Steps | `{p.max_steps}` |",
        f"| Reward Range | `{env.reward_range}` |",
        f"| Creation | `minigrid_dynamicprogramming_tpu.make(\"{env_id}\")` |",
        "",
        f"Example mission: *{mission}*",
        "",
        "## Registered configurations",
        "",
    ]
    lines += [f"- `{i}`" for i in siblings]
    lines.append("")
    return "\n".join(lines)


def gen_env_docs(out_dir: str, ids=None) -> list:
    """One markdown page per env family under ``out_dir/environments/``."""
    written = []
    targets = (
        {family(i): i for i in ids}
        if ids
        else _one_id_per_family(mgtpu.registered_ids())
    )
    for fam, env_id in targets.items():
        group = "babyai" if env_id.startswith("BabyAI-") else "minigrid"
        d = os.path.join(out_dir, "environments", group)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{fam}.md")
        with open(path, "w", encoding="utf-8") as f:
            f.write(_env_page(env_id))
        written.append(path)
    return written


def episode_frames(
    env, seed: int = 0, length: int = 60, tile_size: int = 16
) -> list:
    """Random-policy frames (gen_gifs.py:44-66), stepped and rendered on
    device; resets on episode end."""
    render = jax.jit(lambda s: render_frame(env.params, s, tile_size))
    reset_fn = jax.jit(env.reset)
    step_fn = jax.jit(env.step)
    key = jax.random.PRNGKey(seed)
    _, state = reset_fn(key)
    frames = []
    for t in range(length):
        frames.append(np.asarray(render(state)))
        key, k1, k2 = jax.random.split(key, 3)
        a = jax.random.randint(k1, (), 0, env.action_dim)
        _, state, _, term, trunc, _ = step_fn(k2, state, a)
        if bool(term) or bool(trunc):
            key, k = jax.random.split(key)
            _, state = reset_fn(k)
    return frames


def gen_gifs(
    out_dir: str, length: int = 60, tile_size: int = 16, ids=None
) -> list:
    """One GIF per env family under ``out_dir/_static/gifs/``."""
    from PIL import Image

    d = os.path.join(out_dir, "_static", "gifs")
    os.makedirs(d, exist_ok=True)
    written = []
    targets = (
        {family(i): i for i in ids}
        if ids
        else _one_id_per_family(mgtpu.registered_ids())
    )
    for fam, env_id in targets.items():
        env = mgtpu.make(env_id)
        frames = [
            Image.fromarray(f)
            for f in episode_frames(env, length=length, tile_size=tile_size)
        ]
        path = os.path.join(d, f"{fam}.gif")
        frames[0].save(
            path,
            save_all=True,
            append_images=frames[1:],
            duration=100,
            loop=0,
        )
        written.append(path)
    return written


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="docs")
    ap.add_argument("--gifs", action="store_true", help="also render GIFs")
    ap.add_argument("--length", type=int, default=60)
    ap.add_argument("--tile-size", type=int, default=16)
    ap.add_argument("--env-id", default=None, help="restrict to one id")
    args = ap.parse_args()
    ids = [args.env_id] if args.env_id else None
    pages = gen_env_docs(args.out) if not ids else []
    print(f"wrote {len(pages)} pages")
    if args.gifs:
        gifs = gen_gifs(args.out, args.length, args.tile_size, ids)
        print(f"wrote {len(gifs)} gifs")


if __name__ == "__main__":
    main()
