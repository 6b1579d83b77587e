from minigrid_dynamicprogramming_tpu.models.nets import apply, init_params
from minigrid_dynamicprogramming_tpu.models.ppo import (
    PPO,
    PPOConfig,
    TrainState,
    train,
)

__all__ = [
    "apply",
    "init_params",
    "PPO",
    "PPOConfig",
    "TrainState",
    "train",
]
