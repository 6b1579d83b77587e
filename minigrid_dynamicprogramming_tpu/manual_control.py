"""Interactive keyboard control of one environment.

Counterpart of the reference's pygame REPL
(/root/reference/minigrid/manual_control.py:14-80) for the functional env
API.  Uses a pygame window when a display is available, otherwise a
terminal loop with the ASCII grid printer — so it also works over ssh onto
accelerator hosts, which rarely have a display.

Run: ``python -m minigrid_dynamicprogramming_tpu.manual_control --env-id ...``
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.core.constants import (
    ACT_DONE,
    ACT_DROP,
    ACT_FORWARD,
    ACT_LEFT,
    ACT_PICKUP,
    ACT_RIGHT,
    ACT_TOGGLE,
)
from minigrid_dynamicprogramming_tpu.utils.debug import pprint_state

# Same bindings as the reference key_handler (manual_control.py:50-80),
# plus single-letter aliases for the terminal mode.
KEY_TO_ACTION = {
    "left": ACT_LEFT,
    "right": ACT_RIGHT,
    "up": ACT_FORWARD,
    "space": ACT_TOGGLE,
    "pageup": ACT_PICKUP,
    "pagedown": ACT_DROP,
    "tab": ACT_PICKUP,
    "left shift": ACT_DROP,
    "enter": ACT_DONE,
    "return": ACT_DONE,
    # terminal aliases
    "a": ACT_LEFT,
    "d": ACT_RIGHT,
    "w": ACT_FORWARD,
    "t": ACT_TOGGLE,
    "p": ACT_PICKUP,
    "o": ACT_DROP,
    "e": ACT_DONE,
}


class ManualControl:
    """Step one env from keyboard input; resets on episode end or 'r'."""

    def __init__(self, env, seed: int = 0, screen_size: int = 640):
        self.env = env
        self.seed = seed
        self.screen_size = screen_size
        self._reset_fn = jax.jit(env.reset)
        self._step_fn = jax.jit(env.step)
        self.state = None
        self.key = jax.random.PRNGKey(seed + 1)

    def reset(self):
        _, self.state = self._reset_fn(jax.random.PRNGKey(self.seed))
        self.seed += 1

    def step(self, action: int):
        self.key, k = jax.random.split(self.key)
        _, self.state, reward, term, trunc, _ = self._step_fn(
            k, self.state, jnp.asarray(action)
        )
        return float(reward), bool(term), bool(trunc)

    def handle_key(self, name: str):
        """Returns (reward, terminated, truncated) or None for non-actions."""
        if name in ("escape", "q"):
            raise SystemExit
        if name in ("backspace", "r"):
            self.reset()
            return None
        action = KEY_TO_ACTION.get(name)
        if action is None:
            return None
        return self.step(int(action))

    # -- frontends ---------------------------------------------------------
    def run_terminal(self):
        self.reset()
        print(self.describe())
        while True:
            try:
                line = input("action [w/a/d fwd/turn, p pick, o drop, t toggle, e done, r reset, q quit] > ")
            except EOFError:
                return
            out = self.handle_key(line.strip().lower() or "w")
            if out is not None:
                reward, term, trunc = out
                print(f"reward={reward:.3f} terminated={term} truncated={trunc}")
                if term or trunc:
                    print("episode over — resetting")
                    self.reset()
            print(self.describe())

    def describe(self) -> str:
        mission = self.env.mission_text(np.asarray(self.state.mission))
        header = f"[{self.env.env_id}] mission: {mission}" if mission else f"[{self.env.env_id}]"
        return header + "\n" + pprint_state(self.state)

    def run_pygame(self):
        import pygame
        from minigrid_dynamicprogramming_tpu.render import render_frame_np

        pygame.init()
        screen = pygame.display.set_mode((self.screen_size, self.screen_size))
        pygame.display.set_caption(self.env.env_id)
        clock = pygame.time.Clock()
        self.reset()
        running = True
        while running:
            frame = render_frame_np(self.env, self.state)
            surf = pygame.surfarray.make_surface(frame.swapaxes(0, 1))
            surf = pygame.transform.scale(surf, (self.screen_size, self.screen_size))
            screen.blit(surf, (0, 0))
            pygame.display.flip()
            for event in pygame.event.get():
                if event.type == pygame.QUIT:
                    running = False
                elif event.type == pygame.KEYDOWN:
                    name = pygame.key.name(int(event.key))
                    if event.mod & pygame.KMOD_SHIFT and name == "left shift":
                        name = "left shift"
                    try:
                        out = self.handle_key(name)
                    except SystemExit:
                        running = False
                        break
                    if out is not None and (out[1] or out[2]):
                        self.reset()
            clock.tick(30)
        pygame.quit()

    def run(self):
        try:
            import pygame  # noqa: F401
            import os

            if os.environ.get("SDL_VIDEODRIVER") == "dummy":
                raise ImportError("headless")
            self.run_pygame()
        except Exception:
            self.run_terminal()


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env-id", default="MiniGrid-MultiRoom-N6-v0")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--screen-size", type=int, default=640)
    p.add_argument("--terminal", action="store_true", help="force ASCII mode")
    args = p.parse_args()
    mc = ManualControl(mgtpu.make(args.env_id), args.seed, args.screen_size)
    if args.terminal:
        mc.run_terminal()
    else:
        mc.run()


if __name__ == "__main__":
    main()
